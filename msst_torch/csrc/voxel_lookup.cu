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
// What bounds it: 8 hash-random row reads per query (10240 queries at the
// slice's shapes) and ~60 integer and float operations per row: almost no
// arithmetic per byte.  The distinct rows the queries hash to (a few MB at
// most) sit in the 50 MB L2, so the limit is the latency of two dependent
// reads (the query, then its rows) and the launch itself, not DRAM
// bandwidth.
//
// The design spreads a query over a group of 8 lanes, one per octant, four
// queries to a warp: lane o hashes octant o and loads its 96-byte row as 6
// aligned float4 (whole 32 B sectors, no wasted bytes), so a query's 8 rows
// are in flight together and a warp has 32 rows outstanding.  Each lane
// scores its 3 candidates; the group's best (d2, o*3+c) comes out of 3
// __shfl_xor_sync steps that keep the strict first minimum, and the lane
// that holds the winning row writes the query's outputs (no shuffle of the
// row).  Fusing the residual, Jacobian and JtJ/Jtr reduction into this pass
// is the next step.
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
//    argmin; with no match idx = 0 and the stats are candidate 0's row;
//  * a masked query matches nothing, so only octant 0 loads its row;
//  * maps a and b are chosen per query, so one warp may hold both.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kProbeC = 3;
constexpr int kRowFloat4 = kProbeC * 2;  // 24 floats = 6 float4
constexpr int kLanes = 8;                 // one lane per octant
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// msst_tpu's octant combos (0,0,0), (1,0,0), (0,1,0), (0,0,1), (1,1,0),
// (1,0,1), (0,1,1), (1,1,1) as one bit per octant for each axis
constexpr unsigned kComboX = 0xB2u;  // octants 1, 4, 5, 7
constexpr unsigned kComboY = 0xD4u;  // octants 2, 4, 6, 7
constexpr unsigned kComboZ = 0xE8u;  // octants 3, 5, 6, 7

__device__ __forceinline__ int wrap_mul(int a, unsigned int p) {
  return static_cast<int>(static_cast<unsigned int>(a) * p);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) +
                          static_cast<unsigned int>(b));
}

// abs(h) floor-mod table with abs(INT32_MIN) = INT32_MIN, in 32-bit
// unsigned arithmetic: for h != INT32_MIN, |h| < 2^31 and the remainder is
// |h| % table; for INT32_MIN the signed remainder is -(2^31 % table), which
// floor-mod lifts by table unless it is 0
__device__ __forceinline__ int hash3(int cx, int cy, int cz, int table) {
  const int h = wrap_mul(cx, 73856093u) ^ wrap_mul(cy, 19349663u) ^
                wrap_mul(cz, 83492791u);
  const unsigned int u = h < 0 ? 0u - static_cast<unsigned int>(h)
                               : static_cast<unsigned int>(h);
  unsigned int r = u % static_cast<unsigned int>(table);
  if (h == INT_MIN && r != 0u) r = static_cast<unsigned int>(table) - r;
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

__global__ void __launch_bounds__(kThreads) voxel_lookup_cat_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ q_mask, int n_q,
    int n_a, const float* __restrict__ probe_a, int table_a,
    const float* __restrict__ probe_b, int table_b,
    const float* __restrict__ leaf_a, const float* __restrict__ origin_a,
    const float* __restrict__ leaf_b, const float* __restrict__ origin_b,
    int* __restrict__ out_idx, uint8_t* __restrict__ out_found,
    float* __restrict__ out_mean, float* __restrict__ out_dir,
    float* __restrict__ out_d) {
  // every thread runs to the end (the shuffles take the full warp); a group
  // past n_q works on the last query and stores nothing
  const int o = threadIdx.x % kLanes;  // this lane's octant
  const int i = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const bool live = i < n_q;
  const int qi = live ? i : n_q - 1;
  const bool is_a = qi < n_a;
  const float* __restrict__ probe = is_a ? probe_a : probe_b;
  const int table = is_a ? table_a : table_b;
  const float leaf = __ldg(is_a ? leaf_a : leaf_b);
  const float* __restrict__ origin = is_a ? origin_a : origin_b;

  const float qx = __ldg(q + 3 * qi), qy = __ldg(q + 3 * qi + 1),
              qz = __ldg(q + 3 * qi + 2);
  const bool qm = __ldg(q_mask + qi) != 0;
  float fx, fy, fz;
  const int bx = cell_coord(qx, __ldg(origin), leaf, &fx);
  const int by = cell_coord(qy, __ldg(origin + 1), leaf, &fy);
  const int bz = cell_coord(qz, __ldg(origin + 2), leaf, &fz);
  const int cx = wrap_add(bx, ((kComboX >> o) & 1u) ? (fx >= 0.5f ? 1 : -1) : 0);
  const int cy = wrap_add(by, ((kComboY >> o) & 1u) ? (fy >= 0.5f ? 1 : -1) : 0);
  const int cz = wrap_add(bz, ((kComboZ >> o) & 1u) ? (fz >= 0.5f ? 1 : -1) : 0);

  // a masked query matches nothing: only octant 0's row (candidate 0, the
  // no-match output) is needed
  const bool load = qm || o == 0;
  float4 r[kRowFloat4];
  if (load) {
    const float4* row = reinterpret_cast<const float4*>(
        probe + static_cast<size_t>(hash3(cx, cy, cz, table)) * (kProbeC * 8));
#pragma unroll
    for (int k = 0; k < kRowFloat4; ++k) r[k] = __ldg(row + k);
  } else {
#pragma unroll
    for (int k = 0; k < kRowFloat4; ++k) r[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // this lane's first minimum; (inf, o*3) where nothing matches, so that
  // with no match anywhere octant 0's candidate 0 wins
  const float inf = __int_as_float(0x7f800000);
  const int expect = expected_key(cx, cy, cz);
  float best = inf;
  int best_c = 0;
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
      best_c = c;
    }
  }
  // the group's first minimum in (octant, lane) order
  float gd = best;
  int gk = o * kProbeC + best_c;
#pragma unroll
  for (int s = kLanes / 2; s > 0; s >>= 1) {
    const float od = __shfl_xor_sync(kFull, gd, s, kLanes);
    const int ok = __shfl_xor_sync(kFull, gk, s, kLanes);
    if (od < gd || (od == gd && ok < gk)) {
      gd = od;
      gk = ok;
    }
  }

  if (live && gk / kProbeC == o) {  // this lane holds the winning row
    const int c = gk - o * kProbeC;
    const float4 a = c == 0 ? r[0] : (c == 1 ? r[2] : r[4]);  // key, mean3
    const float4 b = c == 0 ? r[1] : (c == 1 ? r[3] : r[5]);  // dir3, d
    out_idx[i] = gk;
    out_found[i] = gd < inf ? 1 : 0;
    out_mean[3 * i] = a.y;
    out_mean[3 * i + 1] = a.z;
    out_mean[3 * i + 2] = a.w;
    out_dir[3 * i] = b.x;
    out_dir[3 * i + 1] = b.y;
    out_dir[3 * i + 2] = b.z;
    out_d[i] = b.w;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).  All
// pointers are device pointers; the probe tables must be 16-byte aligned.
// n_q >= 1.
extern "C" int voxel_lookup_cat(
    const float* q, const uint8_t* q_mask, int n_q, int n_a,
    const float* probe_a, int table_a, const float* probe_b, int table_b,
    const float* leaf_a, const float* origin_a, const float* leaf_b,
    const float* origin_b, int* out_idx, uint8_t* out_found, float* out_mean,
    float* out_dir, float* out_d, void* stream) {
  const long long threads = static_cast<long long>(n_q) * kLanes;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  voxel_lookup_cat_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      q, q_mask, n_q, n_a, probe_a, table_a, probe_b, table_b, leaf_a,
      origin_a, leaf_b, origin_b, out_idx, out_found, out_mean, out_dir,
      out_d);
  return static_cast<int>(cudaGetLastError());
}
