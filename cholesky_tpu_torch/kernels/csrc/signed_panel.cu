// One panel of the blocked signed Cholesky of a level's quasi-definite
// fronts (A = L~ S L~^T, S = diag(s), s = +-1), for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs this algorithm through XLA
// (cholesky_tpu/numeric/ldlt.py:52-104, a lax.scan over the columns); the
// port ran it in PyTorch: per column of a panel about five launches on the
// [B, w, w] diagonal block, then a cuBLAS triangular solve of the panel
// below, its sign scale and a copy back. A factorization of the benchmark's
// hybrid u-p elasticity has 16,320 padded pivot columns in 513 panels, so
// that was ~85,700 launches of a few kflop each, and the card sat idle for
// most of the factorization while the host issued them. This kernel does
// the whole panel step of every front of a level in one launch. For front
// b, with w = c1 - c0 <= 32 and m = W - c1 rows below the panel:
//
//   1. the diagonal block D = work[b, c0:c1, c0:c1]: per column j,
//      l_jj = sqrt(s_j d_jj); below it u = col / l_jj and l = u s_j, the
//      column of L~; the trailing block loses u l^T. That is the order of
//      operations of the column loop (`hopper_kernels.signed_panel_ref`),
//      with IEEE division and square root. A signature violation
//      (s_j d_jj < 0) gives NaN, which carries on into the panel and the
//      later levels as it did before.
//   2. the panel below: X = work[b, c1:, c0:c1] L~11^-T, row by row by
//      forward substitution against L~11;
//   3. L~21 = X S written over the panel, and X into xbuf [b, :m, :w]
//      (contiguous [B, m, w]), which the caller's trailing update reads.
//
// The lower triangle of the diagonal block becomes L~11; its strict upper
// triangle is left as it was (the caller zeroes it with tril_).
//
// What bounds it: per front the panel ((m + w) x w) is read once and written
// once and X written once, against about w^2 m + w^3 / 3 flops: under 3
// flops a byte, so bytes would bound it at scale. At the level shapes of the
// solver a panel is at most a few MB, and what a launch takes is the latency
// of its two chains of 32 dependent steps (the diagonal block's columns,
// then each row's substitution), each with a division.
//
// The design: grid (B, row tiles of ROWS rows). Every CTA factors the
// diagonal block itself (w^3 / 3 flops, ~11 kflop at w = 32) instead of
// waiting for another CTA, which saves a second launch and a grid-wide
// dependency. Warp 0 reads the block's lower triangle (row by row, lanes on
// consecutive columns) and factors it, one lane a row, the pivot and the
// column of L~ broadcast by shuffles, while warps 1-3 stage the CTA's rows
// of the panel in shared memory with 16-byte loads where the strides allow
// (a warp covers four 128-byte rows); then every thread solves one row from
// shared memory against L~11 (broadcast reads), and the tile goes back
// through shared memory the same way, L~21 into the panel and X into xbuf.
//
// The diagonal block is overwritten with L~11 while other CTAs of the same
// front may not have read it yet. So a CTA takes a ticket (`tickets[b]`, an
// atomic count) once its warp 0 has read the block; the CTA that draws the
// last ticket of its front writes L~11 back and resets the count to 0 for the
// next launch, so the caller zeroes the tickets once and they stay zero
// between launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int PANEL = 32;        // widest panel: one lane a row of the block
constexpr int ROWS = 128;        // rows of the panel below a CTA solves
constexpr int THREADS = 128;     // one row a thread
constexpr int PAD = PANEL + 1;   // shared rows padded against bank conflicts
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// T: float or double. V: elements a global access of the row tile (16 bytes
// where the strides allow, else 1). work [B, W, W] by its strides (last 1),
// s [B, W] by its row stride, xbuf contiguous [B, m, w].
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
signed_panel_kernel(T* __restrict__ work, long long sb, long long sr,
                    const T* __restrict__ s, long long ss,
                    T* __restrict__ xbuf, unsigned int* __restrict__ tickets,
                    int c0, int w, int m) {
  __shared__ T diag[PANEL][PAD];
  __shared__ T tile[ROWS][PAD];
  __shared__ T sig[PANEL];
  __shared__ int writer;

  const long long b = blockIdx.x;
  const unsigned int tiles = gridDim.y;
  const int r0 = blockIdx.y * ROWS;
  const int rows = max(0, min(ROWS, m - r0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c1 = c0 + w;
  const int vecs = w / V;              // accesses a row of the tile
  T* front = work + b * sb;

  if (warp == 0) {
    if (lane < w) sig[lane] = s[b * ss + c0 + lane];
    for (int i = 0; i < PANEL; ++i)
      diag[i][lane] = (i < w && lane <= i)
                          ? front[(c0 + i) * sr + c0 + lane]
                          : T(0);
    __syncwarp();
    if (lane == 0) {
      int last = 1;
      if (tiles > 1) {
        __threadfence();
        last = atomicAdd(tickets + b, 1u) == tiles - 1;
        if (last) tickets[b] = 0;
      }
      writer = last;
    }
    T d[PANEL];
#pragma unroll
    for (int k = 0; k < PANEL; ++k) d[k] = diag[lane][k];
#pragma unroll
    for (int j = 0; j < PANEL; ++j) {
      if (j < w) {
        const T sj = sig[j];
        const T ljj = root(__shfl_sync(FULL, d[j], j) * sj);
        const T u = d[j] / ljj;                       // s_j l
        const T l = u * sj;                           // the column of L~
        if (lane == j) d[j] = ljj;
        else if (lane > j) d[j] = l;
#pragma unroll
        for (int k = j + 1; k < PANEL; ++k)
          d[k] -= u * __shfl_sync(FULL, l, k);
      }
    }
#pragma unroll
    for (int k = 0; k < PANEL; ++k) diag[lane][k] = d[k];
  } else {
#pragma unroll 4
    for (int e = threadIdx.x - 32; e < rows * vecs; e += THREADS - 32) {
      const int i = e / vecs, k = (e - i * vecs) * V;
      const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(
          front + (c1 + r0 + i) * sr + c0 + k);
#pragma unroll
      for (int q = 0; q < V; ++q) tile[i][k + q] = a.v[q];
    }
  }
  __syncthreads();

  if (writer && warp == 0)
    for (int i = 0; i < w; ++i)
      if (lane <= i) front[(c0 + i) * sr + c0 + lane] = diag[i][lane];

  const int t = threadIdx.x;
  if (t < rows) {
    T x[PANEL];
#pragma unroll
    for (int j = 0; j < PANEL; ++j) {
      if (j < w) {
        T acc = tile[t][j];
#pragma unroll
        for (int k = 0; k < j; ++k) acc -= x[k] * diag[j][k];
        x[j] = acc / diag[j][j];
      }
    }
#pragma unroll
    for (int j = 0; j < PANEL; ++j)
      if (j < w) tile[t][j] = x[j];
  }
  __syncthreads();

  T* xrows = xbuf + (b * m + r0) * static_cast<long long>(w);
  for (int e = threadIdx.x; e < rows * vecs; e += THREADS) {
    const int i = e / vecs, k = (e - i * vecs) * V;
    Vec<T, V> xv, lv;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      xv.v[q] = tile[i][k + q];
      lv.v[q] = xv.v[q] * sig[k + q];                 // L~21 = X S
    }
    *reinterpret_cast<Vec<T, V>*>(front + (c1 + r0 + i) * sr + c0 + k) = lv;
    *reinterpret_cast<Vec<T, V>*>(xrows + i * w + k) = xv;
  }
}

template <typename T, int V>
cudaError_t launch(dim3 grid, cudaStream_t st, void* work, long long sb,
                   long long sr, const void* s, long long ss, void* xbuf,
                   unsigned int* tickets, int c0, int w, int m) {
  signed_panel_kernel<T, V><<<grid, THREADS, 0, st>>>(
      static_cast<T*>(work), sb, sr, static_cast<const T*>(s), ss,
      static_cast<T*>(xbuf), tickets, c0, w, m);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t dispatch(dim3 grid, cudaStream_t st, void* work, long long sb,
                     long long sr, const void* s, long long ss, void* xbuf,
                     unsigned int* tickets, int c0, int w, int m) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = sb % V == 0 && sr % V == 0 && c0 % V == 0 && w % V == 0 &&
                   aligned16(work) && aligned16(xbuf);
  return vec ? launch<T, V>(grid, st, work, sb, sr, s, ss, xbuf, tickets, c0,
                            w, m)
             : launch<T, 1>(grid, st, work, sb, sr, s, ss, xbuf, tickets, c0,
                            w, m);
}

}  // namespace

// t_code: 0 float32, 1 float64 (work, s and xbuf alike). work [batch, W, W]
// with strides (sb, sr, 1); s [batch, W] with row stride ss; xbuf contiguous
// [batch, W - c0 - w, w]; tickets [batch] zero on entry, zero again on exit.
// The panel is columns c0 .. c0 + w - 1, 0 < w <= 32.
extern "C" int signed_panel(void* work, long long sb, long long sr,
                            const void* s, long long ss, void* xbuf,
                            unsigned int* tickets, long long batch, int W,
                            int c0, int w, int t_code, void* stream) {
  if (batch < 0 || batch > 0x7fffffffLL || w <= 0 || w > PANEL || c0 < 0 ||
      c0 + w > W || t_code < 0 || t_code > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int m = W - c0 - w;
  const long long tiles = m > 0 ? (m + ROWS - 1) / ROWS : 1;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(batch),
                  static_cast<unsigned int>(tiles));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      t_code == 0 ? dispatch<float>(grid, st, work, sb, sr, s, ss, xbuf,
                                    tickets, c0, w, m)
                  : dispatch<double>(grid, st, work, sb, sr, s, ss, xbuf,
                                     tickets, c0, w, m);
  return static_cast<int>(err);
}
