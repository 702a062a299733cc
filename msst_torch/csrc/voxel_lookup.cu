// Voxel-feature lookup of the scan-to-map Gauss-Newton loop, for Hopper
// (sm_90a).
//
// Replaces msst_tpu's Pallas kernel voxelmap_pallas.lookup_pallas
// (_lookup_kernel) and implements the contract of voxelmap.lookup_cat: both
// feature maps (corner rows [0, n_a), surf rows after) in one launch.  For
// each query point: hash the voxel that holds it and the 7 octant
// neighbours toward its in-cell offset, read each bucket's probe row
// (3 candidates x [coord key bits, mean3, dir3, d] = 24 floats, 96 B), keep
// candidates whose packed coord key matches, and return the one whose mean
// is nearest: (idx, found, mean, direction, d).
//
// What bounds it: 8 dependent-address row reads per query (10240 queries at
// the slice's shapes) and ~60 integer/float ops per row — almost no
// arithmetic per byte, and the addresses are hash-random.  The two probe
// tables (16384 + 32768 rows x 96 B = 4.7 MB) fit the 50 MB L2 many times,
// so the limit is L2 random-read latency, not DRAM bandwidth.  The design
// answers that simply: one thread per query, each row read as 6 aligned
// float4 loads (whole 32 B sectors, no wasted bytes), the 8 octants
// independent so loads of different rows can be in flight at once, the
// best candidate kept in registers, and small blocks so every SM holds
// several blocks' worth of outstanding loads.  Fusing the residual,
// Jacobian and JtJ/Jtr reduction into this pass is the next step.
//
// Every discrete result matches msst_tpu bit for bit:
//  * hash: int32 multiplies wrap (done in uint32), abs(INT32_MIN) stays
//    INT32_MIN, then floor-mod (CUDA's % truncates: add H to a negative
//    remainder);
//  * coord key: out-of-domain cells give the sentinel 2^30, which the query
//    side maps to -1 so it never matches an invalid slot;
//  * cell: floorf((q - origin) / leaf) with IEEE subtraction and division
//    (built without --use_fast_math, and with explicit _rn intrinsics);
//  * key column: compared as int32 bits, never as a float (keys below 2^23
//    are float denormals);
//  * tie-break: the first minimum in (octant, lane) order, strict `<`, as
//    argmin; with no match idx = 0 and the stats are candidate 0's row.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kProbeC = 3;
constexpr int kRowFloat4 = kProbeC * 2;  // 24 floats = 6 float4
constexpr int kSentinelKey = 1 << 30;

__constant__ int kCombos[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1},
    {1, 1, 0}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};

__device__ __forceinline__ int wrap_mul(int a, unsigned int p) {
  return static_cast<int>(static_cast<unsigned int>(a) * p);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) +
                          static_cast<unsigned int>(b));
}

__device__ __forceinline__ int hash3(int cx, int cy, int cz, int table) {
  const int h = wrap_mul(cx, 73856093u) ^ wrap_mul(cy, 19349663u) ^
                wrap_mul(cz, 83492791u);
  const long long a = (h == INT_MIN) ? static_cast<long long>(h)
                                     : static_cast<long long>(h < 0 ? -h : h);
  long long r = a % table;
  if (r < 0) r += table;
  return static_cast<int>(r);
}

__device__ __forceinline__ int expected_key(int cx, int cy, int cz) {
  const int sx = wrap_add(cx, 512), sy = wrap_add(cy, 512),
            sz = wrap_add(cz, 512);
  const bool ok = sx >= 0 && sx < 1024 && sy >= 0 && sy < 1024 && sz >= 0 &&
                  sz < 1024;
  // the sentinel is remapped to -1: it must never match an invalid slot
  return ok ? ((sx << 20) | (sy << 10) | sz) : -1;
}

__device__ __forceinline__ int cell_coord(float q, float o, float leaf,
                                          float* frac) {
  const float g = __fdiv_rn(__fsub_rn(q, o), leaf);
  const int base = static_cast<int>(floorf(g));
  *frac = __fsub_rn(g, static_cast<float>(base));
  return base;
}

__global__ void voxel_lookup_cat_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ q_mask, int n_q,
    int n_a, const float* __restrict__ probe_a, int table_a,
    const float* __restrict__ probe_b, int table_b,
    const float* __restrict__ leaf_a, const float* __restrict__ origin_a,
    const float* __restrict__ leaf_b, const float* __restrict__ origin_b,
    int* __restrict__ out_idx, uint8_t* __restrict__ out_found,
    float* __restrict__ out_mean, float* __restrict__ out_dir,
    float* __restrict__ out_d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const bool is_a = i < n_a;
  const float* probe = is_a ? probe_a : probe_b;
  const int table = is_a ? table_a : table_b;
  const float leaf = __ldg(is_a ? leaf_a : leaf_b);
  const float* origin = is_a ? origin_a : origin_b;

  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  const bool qm = q_mask[i] != 0;
  float fx, fy, fz;
  const int bx = cell_coord(qx, __ldg(origin), leaf, &fx);
  const int by = cell_coord(qy, __ldg(origin + 1), leaf, &fy);
  const int bz = cell_coord(qz, __ldg(origin + 2), leaf, &fz);
  const int sx = fx >= 0.5f ? 1 : -1;
  const int sy = fy >= 0.5f ? 1 : -1;
  const int sz = fz >= 0.5f ? 1 : -1;

  float best = __int_as_float(0x7f800000);  // +inf
  int best_k = 0;
  float4 win_a = make_float4(0.f, 0.f, 0.f, 0.f);  // key, mean3
  float4 win_b = make_float4(0.f, 0.f, 0.f, 0.f);  // dir3, d

#pragma unroll
  for (int o = 0; o < 8; ++o) {
    // a masked query matches nothing: only candidate 0's row is needed
    if (!qm && o > 0) break;
    const int cx = wrap_add(bx, kCombos[o][0] * sx);
    const int cy = wrap_add(by, kCombos[o][1] * sy);
    const int cz = wrap_add(bz, kCombos[o][2] * sz);
    const int expect = expected_key(cx, cy, cz);
    const float4* row = reinterpret_cast<const float4*>(
        probe + static_cast<size_t>(hash3(cx, cy, cz, table)) * (kProbeC * 8));
    float4 r[kRowFloat4];
#pragma unroll
    for (int k = 0; k < kRowFloat4; ++k) r[k] = __ldg(row + k);
    if (o == 0) {
      win_a = r[0];
      win_b = r[1];
    }
#pragma unroll
    for (int c = 0; c < kProbeC; ++c) {
      const float4 a = r[2 * c];
      if (!qm || __float_as_int(a.x) != expect) continue;
      const float dx = __fsub_rn(a.y, qx);
      const float dy = __fsub_rn(a.z, qy);
      const float dz = __fsub_rn(a.w, qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < best) {
        best = d2;
        best_k = o * kProbeC + c;
        win_a = a;
        win_b = r[2 * c + 1];
      }
    }
  }

  out_idx[i] = best_k;
  out_found[i] = best < __int_as_float(0x7f800000) ? 1 : 0;
  out_mean[3 * i] = win_a.y;
  out_mean[3 * i + 1] = win_a.z;
  out_mean[3 * i + 2] = win_a.w;
  out_dir[3 * i] = win_b.x;
  out_dir[3 * i + 1] = win_b.y;
  out_dir[3 * i + 2] = win_b.z;
  out_d[i] = win_b.w;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).  All
// pointers are device pointers; the probe tables must be 16-byte aligned.
extern "C" int voxel_lookup_cat(
    const float* q, const uint8_t* q_mask, int n_q, int n_a,
    const float* probe_a, int table_a, const float* probe_b, int table_b,
    const float* leaf_a, const float* origin_a, const float* leaf_b,
    const float* origin_b, int* out_idx, uint8_t* out_found, float* out_mean,
    float* out_dir, float* out_d, void* stream) {
  constexpr int kThreads = 64;
  const int blocks = (n_q + kThreads - 1) / kThreads;
  voxel_lookup_cat_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      q, q_mask, n_q, n_a, probe_a, table_a, probe_b, table_b, leaf_a,
      origin_a, leaf_b, origin_b, out_idx, out_found, out_mean, out_dir,
      out_d);
  return static_cast<int>(cudaGetLastError());
}
