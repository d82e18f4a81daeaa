// Batched Cholesky + explicit lower-triangular inverse of 128x128 f32
// blocks, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel cholesky_tpu/numeric/pallas_kernels.py::
// _chol_inv_lanes_kernel (launched by chol_inv_lanes). It computes the same
// thing: for every SPD block A, L = chol(A) (column j scaled by rsqrt of its
// pivot, then a rank-1 update of the trailing part) and inv(L) by forward
// substitution by rows. Both outputs are lower with zeros above the
// diagonal. Only the lower triangle of A is read.
//
// Layout: the TPU kernel puts 128 blocks side by side in the vector lanes.
// Here one CTA owns one block and keeps it in shared memory: A (overwritten
// by L) and inv(L), each 128 x 129 floats (the row stride is padded by one
// so that a column walk touches 32 distinct banks) -- 132,096 bytes of
// dynamic shared memory, above the 48 KB default, so the launcher raises
// the kernel's limit first. That leaves one CTA per SM.
//
// What bounds it: the 128-step column recurrence and the 128-row
// substitution are sequential, with a block-wide barrier per column step;
// the block moves 192 KiB through device memory and does ~N^3/2 FMAs, so
// it is latency-bound, not bandwidth- or FLOP-bound. The design keeps every
// intermediate in shared memory (no device-memory traffic inside the
// recurrence) and puts 512 threads on the rank-1 updates. Tensor cores,
// TMA and a multi-CTA blocked variant are left for later work.
//
// C interface (bound with ctypes): chol_inv_f32 launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int N = 128;                 // block size
constexpr int LD = N + 1;              // shared-memory row stride
constexpr int THREADS = 512;
constexpr int ROW_GROUPS = THREADS / N;
constexpr int SMEM_BYTES = 2 * N * LD * static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(THREADS)
chol_inv_kernel(const float* __restrict__ a, float* __restrict__ l,
                float* __restrict__ m) {
  extern __shared__ float smem[];
  float* A = smem;                     // [N][LD]; lower triangle becomes L
  float* M = smem + N * LD;            // [N][LD]; inv(L)
  const size_t base = static_cast<size_t>(blockIdx.x) * N * N;
  const int tid = threadIdx.x;

  for (int e = tid; e < N * N; e += THREADS) {
    A[(e / N) * LD + (e % N)] = a[base + e];
  }
  __syncthreads();

  // Right-looking unblocked Cholesky. Thread (rg, k) updates column k on
  // rows j+1+rg, j+1+rg+ROW_GROUPS, ... of the lower trailing part.
  const int k = tid % N;
  const int rg = tid / N;
  for (int j = 0; j < N; ++j) {
    const float r = rsqrtf(A[j * LD + j]);
    __syncthreads();                   // pivot read by all before it changes
    for (int i = j + tid; i < N; i += THREADS) {
      A[i * LD + j] *= r;
    }
    __syncthreads();
    if (k > j) {
      const float lk = A[k * LD + j];
      for (int i = j + 1 + rg; i < N; i += ROW_GROUPS) {
        if (i >= k) {
          A[i * LD + k] -= A[i * LD + j] * lk;
        }
      }
    }
    __syncthreads();
  }

  // inv(L) by forward substitution by rows,
  //   M[i, c] = (e_i[c] - sum_{q < i} L[i, q] M[q, c]) / L[i, i],
  // one thread per column c. Columns are independent, so no barrier is
  // needed inside the loop. The loops start at the warp's first column
  // (M[q, c] = 0 for q < c), so all threads of a warp walk the same (i, q):
  // L[i, q] is a broadcast and M[q, c] a conflict-free row access.
  if (tid < N) {
    const int c = tid;
    const int q0 = c & ~31;
    for (int i = q0; i < N; ++i) {
      float acc = (i == c) ? 1.0f : 0.0f;
      for (int q = q0; q < i; ++q) {
        acc -= A[i * LD + q] * M[q * LD + c];
      }
      M[i * LD + c] = (i >= c) ? acc / A[i * LD + i] : 0.0f;
    }
  }
  __syncthreads();

  for (int e = tid; e < N * N; e += THREADS) {
    const int row = e / N;
    const int col = e % N;
    const bool lower = col <= row;
    l[base + e] = lower ? A[row * LD + col] : 0.0f;
    m[base + e] = lower ? M[row * LD + col] : 0.0f;
  }
}

}  // namespace

extern "C" int chol_inv_f32(const float* a, float* l, float* m,
                            long long batch, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (batch <= 0) {
    return 0;
  }
  chol_inv_kernel<<<static_cast<unsigned int>(batch), THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(a, l, m);
  return static_cast<int>(cudaGetLastError());
}
