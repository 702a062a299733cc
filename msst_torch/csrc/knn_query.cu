// Hash-grid k-NN query of the knn scan-to-map Gauss-Newton loop, for Hopper
// (sm_90a).
//
// Replaces msst_tpu's Pallas kernel knn_pallas.query_pallas (_query_kernel)
// and implements the contract of knn.query.  For each query point: the 27
// neighbour cells of floor(q / cell), each hashed into the bucket table; a
// probe whose bucket equals an earlier probe's contributes nothing; up to C
// candidates per bucket (the first C points of the bucket in the grid's
// sorted order); the k smallest squared distances, ascending, with the
// candidates' indices mapped through orig_idx; valid = finite & <=
// max_sqdist.
//
// What bounds it: at the scan-to-map shapes (k = 5, C = 24, H = 32768,
// 2048 queries on 16384 map corners, 8192 on 49152 map surfs) a query
// reads 27 x 2 bucket words and up to 27 x C points of 12 B, found by
// hashing, and does ~10 operations per candidate: almost no arithmetic per
// byte, and every address depends on a loaded value.  The tables (590 KB of
// points, 2 x 128 KB of buckets) fit the 50 MB L2 many times over, so the
// limit is the latency of dependent L2 reads, not DRAM bandwidth.  The TPU
// kernel pins the grid in VMEM and streams 512-query tiles over it; here a
// thread gathers directly.  The design is the simple one: one thread per
// query, the 27 bucket heads loaded up front (independent loads, all in
// flight together), each bucket's points read as one contiguous run (the
// grid is sorted by bucket), and the k best kept in a sorted per-thread
// list with static indexing (registers for small k).  A warp per query,
// both maps in one launch and fusion with the residuals are the next steps.
//
// Every discrete result matches msst_tpu bit for bit:
//  * cell: floorf(q / cell) with IEEE division (built without
//    --use_fast_math, explicit _rn intrinsics);
//  * hash: int32 multiplies wrap (done in uint32), abs(INT32_MIN) stays
//    INT32_MIN, then floor-mod (CUDA's % truncates: add H to a negative
//    remainder);
//  * probe order dx outermost, dz innermost; lanes 0..C-1 within a probe;
//  * ties: a candidate enters the list before the first strictly greater
//    entry, so equal distances stay in ascending (probe, lane) order, as k
//    passes of argmin give them;
//  * a slot without a neighbour holds +inf and the index of lane 0: the
//    first point of probe 0's bucket, or point N-1 when that bucket is
//    empty, mapped through orig_idx like every other index;
//  * distance: (dx*dx + dy*dy) + dz*dz, each operation rounded on its own
//    (--fmad=false and _rn intrinsics).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kProbes = 27;
constexpr int kThreads = 64;

__device__ __forceinline__ int wrap_mul(int a, unsigned int p) {
  return static_cast<int>(static_cast<unsigned int>(a) * p);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) +
                          static_cast<unsigned int>(b));
}

// the same arithmetic as voxel_lookup.cu's hash3
__device__ __forceinline__ int hash3(int cx, int cy, int cz, int table) {
  const int h = wrap_mul(cx, 73856093u) ^ wrap_mul(cy, 19349663u) ^
                wrap_mul(cz, 83492791u);
  const long long a = (h == INT_MIN) ? static_cast<long long>(h)
                                     : static_cast<long long>(h < 0 ? -h : h);
  long long r = a % table;
  if (r < 0) r += table;
  return static_cast<int>(r);
}

__device__ __forceinline__ int cell_coord(float q, float cell) {
  return static_cast<int>(floorf(__fdiv_rn(q, cell)));
}

// KCap: compile-time size of the sorted list (k <= KCap at run time).
template <int KCap>
__global__ void knn_query_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ q_mask, int n_q,
    const float* __restrict__ pts, const int* __restrict__ orig_idx,
    int n_points, const int* __restrict__ bucket_start,
    const int* __restrict__ bucket_count, int table,
    const float* __restrict__ cell_size, int k, int cand_per_cell,
    float max_sqdist, float* __restrict__ out_d, int* __restrict__ out_i,
    uint8_t* __restrict__ out_valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const float inf = __int_as_float(0x7f800000);
  const float cell = __ldg(cell_size);
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  const bool qm = q_mask[i] != 0;
  const int bx = cell_coord(qx, cell);
  const int by = cell_coord(qy, cell);
  const int bz = cell_coord(qz, cell);

  // bucket of each probe; a masked query only needs probe 0 (its fill index)
  int hb[kProbes];
  int start[kProbes];
  int count[kProbes];
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
    if (!qm && p > 0) {
      hb[p] = -1;
      start[p] = 0;
      count[p] = 0;
      continue;
    }
    const int cx = wrap_add(bx, p / 9 - 1);
    const int cy = wrap_add(by, (p / 3) % 3 - 1);
    const int cz = wrap_add(bz, p % 3 - 1);
    hb[p] = hash3(cx, cy, cz, table);
    start[p] = __ldg(bucket_start + hb[p]);
    count[p] = __ldg(bucket_count + hb[p]);
  }
  // lane 0 of the candidate row, before any suppression
  const int fill = count[0] > 0 ? start[0] : n_points - 1;

  float best_d[KCap];
  int best_i[KCap];
#pragma unroll
  for (int j = 0; j < KCap; ++j) {
    best_d[j] = inf;
    best_i[j] = fill;
  }

  if (qm) {
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      bool first = true;
#pragma unroll
      for (int e = 0; e < p; ++e) first = first && (hb[e] != hb[p]);
      if (!first) continue;
      const int n_c = count[p] < cand_per_cell ? count[p] : cand_per_cell;
      const float* row = pts + 3 * static_cast<size_t>(start[p]);
      for (int c = 0; c < n_c; ++c) {
        const float dx = __fsub_rn(__ldg(row + 3 * c), qx);
        const float dy = __fsub_rn(__ldg(row + 3 * c + 1), qy);
        const float dz = __fsub_rn(__ldg(row + 3 * c + 2), qz);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        if (!(d < best_d[KCap - 1]) && k == KCap) continue;  // cannot enter
        // sorted insertion: from the first strictly greater entry on, every
        // entry moves one slot down and the last falls off
        int ci = start[p] + c;
        bool ins = false;
#pragma unroll
        for (int j = 0; j < KCap; ++j) {
          if (j < k) {
            ins = ins || (d < best_d[j]);
            if (ins) {
              const float td = best_d[j];
              const int ti = best_i[j];
              best_d[j] = d;
              best_i[j] = ci;
              d = td;
              ci = ti;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < KCap; ++j) {
    if (j < k) {
      const float d = best_d[j];
      const size_t o = static_cast<size_t>(i) * k + j;
      out_d[o] = d;
      out_i[o] = __ldg(orig_idx + best_i[j]);
      out_valid[o] = (d < inf && d <= max_sqdist) ? 1 : 0;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched; 1 =
// cudaErrorInvalidValue for a k this file has no list size for).  All
// pointers are device pointers; cell_size points at one float on the device.
extern "C" int knn_query(
    const float* q, const uint8_t* q_mask, int n_q, const float* pts,
    const int* orig_idx, int n_points, const int* bucket_start,
    const int* bucket_count, int table, const float* cell_size, int k,
    int cand_per_cell, float max_sqdist, float* out_d, int* out_i,
    uint8_t* out_valid, void* stream) {
  const int blocks = (n_q + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSST_KNN_LAUNCH(KCAP)                                                \
  knn_query_kernel<KCAP><<<blocks, kThreads, 0, s>>>(                        \
      q, q_mask, n_q, pts, orig_idx, n_points, bucket_start, bucket_count,   \
      table, cell_size, k, cand_per_cell, max_sqdist, out_d, out_i, out_valid)
  if (k < 1 || k > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 1) {
    MSST_KNN_LAUNCH(1);
  } else if (k <= 5) {
    MSST_KNN_LAUNCH(5);
  } else if (k <= 16) {
    MSST_KNN_LAUNCH(16);
  } else {
    MSST_KNN_LAUNCH(64);
  }
#undef MSST_KNN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
