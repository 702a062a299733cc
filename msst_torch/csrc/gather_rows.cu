// Row gather out[n] = table[clamp(idx[n], 0, H-1)] over an (H, W) float32
// table, for Hopper (sm_90a).
//
// Replaces msst_tpu's Pallas kernel gather_pallas.onehot_gather_rows
// (_kernel), which wrote the gather as a one-hot x table matmul because
// Mosaic could not gather on the TPU.  Here it is a direct indexed load;
// the one-hot form is not carried over.  The contract is that function's
// docstring, table[idx], with every index clamped to [0, H-1] as its
// wrapper clamps them (negative ones included).  On a table holding inf or
// NaN the one-hot matmul smears them over a whole H-chunk (0 * inf); this
// kernel copies the addressed row and nothing else.
//
// What bounds it: bytes.  Each output float is one float read and one
// float written, with no arithmetic; each row adds one 4-byte index read.
// The design: a block holds `rows` rows of `cols` threads (rows * cols =
// 256, cols the smallest power of two >= the row's vector count, at most
// 256); the first `rows` threads read the block's indices once into shared
// memory and clamp them; each thread then copies one 16-byte vector (W a
// multiple of 4 and both pointers 16-byte aligned) or one float, and
// gridDim.y tiles rows wider than 256 vectors.  Neighbouring threads copy
// neighbouring addresses of one row, so a wide row streams as whole
// sectors; a narrow row (24 floats = 6 vectors) leaves 2 of 8 lanes idle.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table, int n_rows,
                                   int row_len, const int* __restrict__ idx,
                                   int n_out, T* __restrict__ out) {
  __shared__ int s_row[kThreads];
  const int rows = blockDim.y;
  const int first = blockIdx.x * rows;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < rows && first + tid < n_out) {
    const int r = idx[first + tid];
    s_row[tid] = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  }
  __syncthreads();
  const int n = first + threadIdx.y;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= n_out || c >= row_len) return;
  out[static_cast<size_t>(n) * row_len + c] =
      __ldg(table + static_cast<size_t>(s_row[threadIdx.y]) * row_len + c);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).  All
// pointers are device pointers.  vec = 1 copies float4 vectors (the caller
// checks W % 4 == 0 and 16-byte alignment), vec = 0 single floats.
extern "C" int gather_rows(const float* table, int n_rows, int width,
                           const int* idx, int n_out, float* out, int vec,
                           void* stream) {
  const int row_len = vec ? width / 4 : width;
  int cols = 1;
  while (cols < row_len && cols < kThreads) cols *= 2;
  const dim3 block(cols, kThreads / cols);
  const dim3 grid((n_out + block.y - 1) / block.y,
                  (row_len + cols - 1) / cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    gather_rows_kernel<float4><<<grid, block, 0, s>>>(
        reinterpret_cast<const float4*>(table), n_rows, row_len, idx, n_out,
        reinterpret_cast<float4*>(out));
  } else {
    gather_rows_kernel<float><<<grid, block, 0, s>>>(table, n_rows, row_len,
                                                     idx, n_out, out);
  }
  return static_cast<int>(cudaGetLastError());
}
