// Hash-grid k-NN query of the knn scan-to-map Gauss-Newton loop, for Hopper
// (sm_90a).
//
// Replaces msst_tpu's Pallas kernel knn_pallas.query_pallas (_query_kernel)
// and implements the contract of knn.query, for two grids in one launch
// (knn.query_cat: queries [0, n_a) probe grid a, the rest grid b; knn.query
// passes one grid twice).  For each query point: the 27 neighbour cells of
// floor(q / cell), each hashed into the bucket table; a probe whose bucket
// equals an earlier probe's contributes nothing; up to C candidates per
// bucket (the first C points of the bucket in the grid's sorted order); the
// k smallest squared distances, ascending, with the candidates' indices
// mapped through orig_idx; valid = finite & <= max_sqdist.
//
// What bounds it: at the scan-to-map shapes (k = 5, C = 24, H = 32768,
// 2048 queries on 16384 map corners and 8192 on 49152 map surfs, one
// launch) a query reads 27 bucket entries of 8 B and a few dozen points of
// 12 B, found by hashing, and does ~10 operations per candidate: almost no
// arithmetic per byte, and every address depends on a loaded value.  The
// distinct bytes all queries need are ~2 MB, which the 50 MB L2 holds many
// times over, so the limit is the latency of three dependent levels of
// reads (query, bucket entries, points) and the per-query work between
// them, not DRAM bandwidth.
//
// The design answers latency with parallelism inside a query: a group of
// kGroup = 16 lanes takes one query (16 was the fastest of 8, 16 and 32 at
// the path's shapes on the H100; PERF.md keeps the times).
//  * lane p loads probe p's bucket entry (lanes take probes p, p+16, ...),
//    so the 27 loads are in flight together;
//  * a probe whose bucket equals an earlier probe's is suppressed by
//    comparing each lane's buckets with the 26 earlier probes' buckets,
//    broadcast by __shfl_sync;
//  * the surviving probes' candidate counts are prefix-summed across the
//    group (__shfl_up_sync) into offsets in shared memory, and the lanes
//    stride over the flattened candidate list t = offset[p] + c: one
//    bucket's points are contiguous in the sorted grid, so neighbouring
//    lanes read neighbouring 12-byte points;
//  * each lane keeps a sorted list of its own k best keyed by (d, t), in
//    registers with static indexing (list size KCap = 1, 5, 16 or 64);
//  * k rounds of a group-wide minimum of the lanes' list heads
//    (__shfl_xor_sync on the (d, t) pair) merge the lists; the winning lane
//    (t mod 16) pops its head and lane j mod 16 writes slot j.
// Fusing the neighbour covariance, the 3x3 eigen-solve and the line/plane
// coefficients into this launch is the next step.
//
// Every discrete result matches msst_tpu bit for bit:
//  * cell: floorf(q / cell) with IEEE division (built without
//    --use_fast_math, explicit _rn intrinsics);
//  * hash: int32 multiplies wrap (done in uint32), abs(INT32_MIN) stays
//    INT32_MIN, then floor-mod (CUDA's % truncates: add H to a negative
//    remainder);
//  * probe order dx outermost, dz innermost; lanes 0..C-1 within a probe;
//  * ties: t grows with the (probe, lane) ordinal, each lane inserts a
//    candidate before its first strictly greater entry and the merge takes
//    the smaller t among equal distances, so equal distances come out in
//    ascending (probe, lane) order, as k passes of argmin give them (not in
//    point-index order: the probes do not visit buckets in hash order);
//  * a slot without a neighbour holds +inf and the index of lane 0: the
//    first point of probe 0's bucket (taken before suppression), or point
//    N-1 when that bucket is empty, mapped through orig_idx like every
//    other index; a masked query loads only probe 0;
//  * distance: (dx*dx + dy*dy) + dz*dz, each operation rounded on its own
//    (--fmad=false and _rn intrinsics).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kProbes = 27;
constexpr int kThreads = 128;
constexpr int kGroup = 16;  // lanes per query
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap_mul(int a, unsigned int p) {
  return static_cast<int>(static_cast<unsigned int>(a) * p);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) +
                          static_cast<unsigned int>(b));
}

// the same arithmetic as voxel_lookup.cu's hash3: abs(h) floor-mod table
// with abs(INT32_MIN) = INT32_MIN, in 32-bit unsigned arithmetic.  For h !=
// INT32_MIN, |h| < 2^31 and the remainder is |h| % table.  For INT32_MIN
// the signed remainder is -(2^31 % table), which floor-mod lifts by table
// unless it is 0.
__device__ __forceinline__ int hash3(int cx, int cy, int cz, int table) {
  const int h = wrap_mul(cx, 73856093u) ^ wrap_mul(cy, 19349663u) ^
                wrap_mul(cz, 83492791u);
  const unsigned int u = h < 0 ? 0u - static_cast<unsigned int>(h)
                               : static_cast<unsigned int>(h);
  unsigned int r = u % static_cast<unsigned int>(table);
  if (h == INT_MIN && r != 0u) r = static_cast<unsigned int>(table) - r;
  return static_cast<int>(r);
}

__device__ __forceinline__ int cell_coord(float q, float cell) {
  return static_cast<int>(floorf(__fdiv_rn(q, cell)));
}

// One hash grid (knn.HashGrid) as device pointers.
struct Grid {
  const float* pts;           // (N, 3) points sorted by bucket
  const int* orig_idx;        // (N,)
  const int* bucket_start;    // (H,)
  const int* bucket_count;    // (H,)
  const float* cell_size;     // one float
  int n_points;
  int table;
};

// KCap: compile-time size of each lane's sorted list (k <= KCap at run
// time).  Every thread of a block runs to the end (the shuffles take the
// full warp); a group past n_q works on the last query and stores nothing.
template <int KCap>
__global__ void __launch_bounds__(kThreads) knn_query_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ q_mask, int n_q,
    int n_a, Grid ga, Grid gb, int k, int cand_per_cell, float max_sqdist,
    float* __restrict__ out_d, int* __restrict__ out_i,
    uint8_t* __restrict__ out_valid) {
  constexpr int kGroups = kThreads / kGroup;
  constexpr int kRows = (kProbes + kGroup - 1) / kGroup;  // probes per lane
  __shared__ int s_off[kGroups][kProbes + 1];
  __shared__ int s_start[kGroups][kProbes];

  const int lane = threadIdx.x % kGroup;
  const int grp = threadIdx.x / kGroup;
  const int i = blockIdx.x * kGroups + grp;
  const bool live = i < n_q;
  const int qi = live ? i : n_q - 1;
  const bool is_a = qi < n_a;
  const float* __restrict__ pts = is_a ? ga.pts : gb.pts;
  const int* __restrict__ orig_idx = is_a ? ga.orig_idx : gb.orig_idx;
  const int* __restrict__ bucket_start =
      is_a ? ga.bucket_start : gb.bucket_start;
  const int* __restrict__ bucket_count =
      is_a ? ga.bucket_count : gb.bucket_count;
  const int n_points = is_a ? ga.n_points : gb.n_points;
  const int table = is_a ? ga.table : gb.table;
  const float cell = __ldg(is_a ? ga.cell_size : gb.cell_size);

  const float inf = __int_as_float(0x7f800000);
  const float qx = __ldg(q + 3 * qi), qy = __ldg(q + 3 * qi + 1),
              qz = __ldg(q + 3 * qi + 2);
  const bool qm = __ldg(q_mask + qi) != 0;
  const int bx = cell_coord(qx, cell);
  const int by = cell_coord(qy, cell);
  const int bz = cell_coord(qz, cell);

  // this lane's probes p = lane + r*kGroup; a masked query only needs
  // probe 0 (its fill index)
  int hb[kRows], start[kRows], count[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int p = lane + r * kGroup;
    hb[r] = -1;
    start[r] = 0;
    count[r] = 0;
    if (p < kProbes && (qm || p == 0)) {
      const int cx = wrap_add(bx, p / 9 - 1);
      const int cy = wrap_add(by, (p / 3) % 3 - 1);
      const int cz = wrap_add(bz, p % 3 - 1);
      hb[r] = hash3(cx, cy, cz, table);
      start[r] = __ldg(bucket_start + hb[r]);
      count[r] = __ldg(bucket_count + hb[r]);
    }
  }

  // a probe whose bucket an earlier probe already visited contributes
  // nothing
  bool dup[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dup[r] = false;
#pragma unroll
  for (int e = 0; e < kProbes - 1; ++e) {
    const int he = __shfl_sync(kFull, hb[e / kGroup], e % kGroup, kGroup);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = lane + r * kGroup;
      dup[r] = dup[r] || (p > e && p < kProbes && hb[r] == he);
    }
  }

  // offsets of each probe's candidates in the flattened list
  int carry = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int p = lane + r * kGroup;
    const int n = (qm && p < kProbes && !dup[r])
                      ? min(count[r], cand_per_cell) : 0;
    int v = n;
#pragma unroll
    for (int o = 1; o < kGroup; o <<= 1) {
      const int u = __shfl_up_sync(kFull, v, o, kGroup);
      if (lane >= o) v += u;
    }
    if (p < kProbes) {
      s_off[grp][p] = carry + v - n;
      s_start[grp][p] = start[r];
    }
    carry += __shfl_sync(kFull, v, kGroup - 1, kGroup);
  }
  const int total = carry;
  if (lane == 0) s_off[grp][kProbes] = total;
  // lane 0 of the candidate row, before any suppression
  const int fill =
      __shfl_sync(kFull, count[0] > 0 ? start[0] : n_points - 1, 0, kGroup);
  __syncwarp();

  // this lane's candidates t = lane, lane + kGroup, ...: its k best by
  // (d, t)
  float best_d[KCap];
  int best_t[KCap];
  int best_p[KCap];
#pragma unroll
  for (int j = 0; j < KCap; ++j) {
    best_d[j] = inf;
    best_t[j] = INT_MAX;
    best_p[j] = 0;
  }
  int p = 0;
  for (int t = lane; t < total; t += kGroup) {
    while (s_off[grp][p + 1] <= t) ++p;
    const int pi = s_start[grp][p] + (t - s_off[grp][p]);
    const float* pt = pts + 3 * static_cast<size_t>(pi);
    const float dx = __fsub_rn(__ldg(pt), qx);
    const float dy = __fsub_rn(__ldg(pt + 1), qy);
    const float dz = __fsub_rn(__ldg(pt + 2), qz);
    float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        __fmul_rn(dz, dz));
    if (!(d < best_d[KCap - 1])) continue;  // cannot enter
    // sorted insertion: from the first strictly greater entry on, every
    // entry moves one slot down and the last falls off (t only grows, so
    // equal distances stay in t order)
    int ct = t, cp = pi;
    bool ins = false;
#pragma unroll
    for (int j = 0; j < KCap; ++j) {
      ins = ins || (d < best_d[j]);
      if (ins) {
        const float td = best_d[j];
        const int tt = best_t[j], tp = best_p[j];
        best_d[j] = d;
        best_t[j] = ct;
        best_p[j] = cp;
        d = td;
        ct = tt;
        cp = tp;
      }
    }
  }

  // merge: slot j is the smallest (d, t) among the lanes' heads
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    float md = best_d[0];
    int mt = best_t[0];
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(kFull, md, o, kGroup);
      const int ot = __shfl_xor_sync(kFull, mt, o, kGroup);
      if (od < md || (od == md && ot < mt)) {
        md = od;
        mt = ot;
      }
    }
    const bool found = md < inf;
    const int win =
        __shfl_sync(kFull, best_p[0], found ? mt % kGroup : 0, kGroup);
    if (found && best_t[0] == mt) {  // this lane's head won: pop it
#pragma unroll
      for (int m = 0; m + 1 < KCap; ++m) {
        best_d[m] = best_d[m + 1];
        best_t[m] = best_t[m + 1];
        best_p[m] = best_p[m + 1];
      }
      best_d[KCap - 1] = inf;
      best_t[KCap - 1] = INT_MAX;
      best_p[KCap - 1] = 0;
    }
    if (live && lane == j % kGroup) {
      const size_t o = static_cast<size_t>(i) * k + j;
      out_d[o] = md;
      out_i[o] = __ldg(orig_idx + (found ? win : fill));
      out_valid[o] = (found && md <= max_sqdist) ? 1 : 0;
    }
  }
}

template <int KCap>
cudaError_t launch_k(const float* q, const uint8_t* q_mask, int n_q, int n_a,
                     const Grid& ga, const Grid& gb, int k, int cand_per_cell,
                     float max_sqdist, float* out_d, int* out_i,
                     uint8_t* out_valid, cudaStream_t s) {
  constexpr int per_block = kThreads / kGroup;
  const int blocks = (n_q + per_block - 1) / per_block;
  knn_query_kernel<KCap><<<blocks, kThreads, 0, s>>>(
      q, q_mask, n_q, n_a, ga, gb, k, cand_per_cell, max_sqdist, out_d,
      out_i, out_valid);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched; 1 =
// cudaErrorInvalidValue for a k outside 1..64).  Queries [0, n_a) probe
// grid a, queries [n_a, n_q) grid b.  All pointers are device pointers;
// each cell size points at one float on the device.  n_q >= 1.
extern "C" int knn_query_cat(
    const float* q, const uint8_t* q_mask, int n_q, int n_a,
    const float* pts_a, const int* orig_idx_a, int n_points_a,
    const int* bucket_start_a, const int* bucket_count_a, int table_a,
    const float* cell_size_a, const float* pts_b, const int* orig_idx_b,
    int n_points_b, const int* bucket_start_b, const int* bucket_count_b,
    int table_b, const float* cell_size_b, int k, int cand_per_cell,
    float max_sqdist, float* out_d, int* out_i, uint8_t* out_valid,
    void* stream) {
  const Grid ga{pts_a, orig_idx_a, bucket_start_a, bucket_count_a,
                cell_size_a, n_points_a, table_a};
  const Grid gb{pts_b, orig_idx_b, bucket_start_b, bucket_count_b,
                cell_size_b, n_points_b, table_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (k <= 1) {
    err = launch_k<1>(q, q_mask, n_q, n_a, ga, gb, k, cand_per_cell,
                      max_sqdist, out_d, out_i, out_valid, s);
  } else if (k <= 5) {
    err = launch_k<5>(q, q_mask, n_q, n_a, ga, gb, k, cand_per_cell,
                      max_sqdist, out_d, out_i, out_valid, s);
  } else if (k <= 16) {
    err = launch_k<16>(q, q_mask, n_q, n_a, ga, gb, k, cand_per_cell,
                       max_sqdist, out_d, out_i, out_valid, s);
  } else {
    err = launch_k<64>(q, q_mask, n_q, n_a, ga, gb, k, cand_per_cell,
                       max_sqdist, out_d, out_i, out_valid, s);
  }
  return static_cast<int>(err);
}
