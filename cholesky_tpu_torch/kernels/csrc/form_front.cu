// The square fronts of a level of the multifrontal factorization, formed in
// one pass: each parent's pivot slab and both children's Schur updates,
// for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package forms these fronts with XLA's
// gather and scatter-add (cholesky_tpu/numeric/frontal.py::
// _apply_child_updates_fused); the port did the same with torch indexing:
// a zero-filled [B, F + 1, F] buffer, the pivot slab copied in, then per
// chunk of child rows a gather of the columns, a mask, a negation and an
// accumulating index_put_, which torch runs as a sort and a scatter
// because siblings share a batch index. That reached ~8% of the card's
// memory rate. This kernel computes the same function:
//
//   out[b, f, g] = (g < W ? piv[b, f, g] : 0)
//                  - U[2b,   inv[2b,   f], inv[2b,   g]]   (both < Kc)
//                  - U[2b+1, inv[2b+1, f], inv[2b+1, g]]   (both < Kc)
//
// for f, g < F, with row F (the sentinel row of the level's layout)
// written as zeros. inv[c, f] is the row of child c's update that lands on
// parent row f, or Kc where none does. The siblings are subtracted in this
// order, in the front's type, so the result is the same on every run and
// equal to `hopper_kernels.form_front_ref`'s.
//
// What bounds it: it does no arithmetic to speak of, so bytes do. A
// launch reads each child update entry that lands in the front once, the
// pivot slab once and the maps, and writes each front element once:
// 4 (2 Kc^2 + F W + F (F + 1)) B per front in f32 at the most.
//
// The design is output-stationary: each thread owns one parent column g of
// a tile and writes every element of it exactly once, so there are no
// atomics, no sort and no temporary. A CTA of 8 warps covers 32 columns by
// a range of rows; the columns' child indices inv[2b + s, g] stay in
// registers, the range's row indices are staged in shared memory, and each
// warp walks its rows four at a time with every load of the four issued
// before any store. A child's columns map to increasing parent columns, so
// a warp's 32 reads of an update row fall on one or two cache lines where
// they land; its stores of a front row are one line. The tile's row range
// is chosen from the shapes (B, F): 256 rows where there are enough CTAs to
// fill the card twice over, halved down to 32 where there are not (one
// wide front), then evened out over the front's rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int COLS = 32;                 // columns of a tile: one warp
constexpr int WARPS = 8;                 // rows walked side by side
constexpr int THREADS = COLS * WARPS;
constexpr int UNROLL = 4;                // rows a warp loads before storing
constexpr int MAX_ROWS = 256;            // rows of a tile
constexpr int MIN_ROWS = WARPS * UNROLL;
constexpr int BLOCKS_PER_SM = 2048 / THREADS;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// T: the front's type (float, double); U: the updates' (float, double,
// __nv_bfloat16). Strides in elements. grid.x = batch * column tiles,
// grid.y = row tiles of `rows` rows over the F + 1 rows.
template <typename T, typename U>
__global__ void __launch_bounds__(THREADS)
form_front_kernel(T* __restrict__ out, const T* __restrict__ piv,
                  long long pb, long long pr, long long pc,
                  const U* __restrict__ u, long long ub, long long ur,
                  long long uc, const long long* __restrict__ inv,
                  long long ib, long long ic, int F, int W, int Kc,
                  int col_tiles, int rows) {
  __shared__ int row_map[2][MAX_ROWS];
  const long long b = blockIdx.x / col_tiles;
  const int g = (blockIdx.x % col_tiles) * COLS + threadIdx.x;
  const int f0 = blockIdx.y * rows;
  const int f1 = min(f0 + rows, F + 1);
  const long long c0 = 2 * b, c1 = 2 * b + 1;   // the two children

  int col0 = Kc, col1 = Kc;
  if (Kc > 0) {
    for (int i = threadIdx.y * COLS + threadIdx.x; i < f1 - f0;
         i += THREADS) {
      const int f = f0 + i;
      row_map[0][i] = f < F ? static_cast<int>(inv[c0 * ib + f * ic]) : Kc;
      row_map[1][i] = f < F ? static_cast<int>(inv[c1 * ib + f * ic]) : Kc;
    }
    if (g < F) {
      col0 = static_cast<int>(inv[c0 * ib + g * ic]);
      col1 = static_cast<int>(inv[c1 * ib + g * ic]);
    }
    __syncthreads();
  }
  if (g >= F) return;

  const bool pivot_col = g < W;
  const T* prow = piv + b * pb + g * pc;
  const U* u0 = u + c0 * ub + static_cast<long long>(col0) * uc;
  const U* u1 = u + c1 * ub + static_cast<long long>(col1) * uc;
  T* orow = out + b * (static_cast<long long>(F) + 1) * F + g;

  for (int base = f0 + threadIdx.y; base < f1; base += WARPS * UNROLL) {
    T p[UNROLL], a[UNROLL], s[UNROLL];
    bool in[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int f = base + k * WARPS;
      in[k] = f < f1;
      const bool row = in[k] && f < F;
      p[k] = (row && pivot_col) ? prow[f * pr] : T(0);
      a[k] = T(0);
      s[k] = T(0);
      if (row && Kc > 0) {
        const int r0 = row_map[0][f - f0], r1 = row_map[1][f - f0];
        if (r0 < Kc && col0 < Kc) a[k] = static_cast<T>(widen(u0[r0 * ur]));
        if (r1 < Kc && col1 < Kc) s[k] = static_cast<T>(widen(u1[r1 * ur]));
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int f = base + k * WARPS;
      if (in[k]) orow[static_cast<long long>(f) * F] = (p[k] - a[k]) - s[k];
    }
  }
}

constexpr int MAX_DEVICES = 64;
std::atomic<int> sm_count[MAX_DEVICES];

cudaError_t sms_of_device(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  *sms = sm_count[dev].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) sm_count[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

template <typename T, typename U>
cudaError_t launch(dim3 grid, cudaStream_t s, void* out, const void* piv,
                   long long pb, long long pr, long long pc, const void* u,
                   long long ub, long long ur, long long uc,
                   const long long* inv, long long ib, long long ic, int F,
                   int W, int Kc, int col_tiles, int rows) {
  form_front_kernel<T, U><<<grid, dim3(COLS, WARPS), 0, s>>>(
      static_cast<T*>(out), static_cast<const T*>(piv), pb, pr, pc,
      static_cast<const U*>(u), ub, ur, uc, inv, ib, ic, F, W, Kc, col_tiles,
      rows);
  return cudaGetLastError();
}

// The rows of a tile for `batch` fronts of width F on a card of `sms` SMs.
int tile_rows(long long batch, int F, int sms) {
  const long long col_tiles = (F + COLS - 1) / COLS;
  const long long want = 2LL * sms * BLOCKS_PER_SM;
  int rows = MAX_ROWS;
  while (rows > MIN_ROWS &&
         batch * col_tiles * ((F + rows) / rows) < want)
    rows /= 2;
  const int tiles = (F + rows) / rows;       // ceil((F + 1) / rows)
  return (F + tiles) / tiles;                // even: ceil((F + 1) / tiles)
}

}  // namespace

// t_code: the front's type, 0 float32, 1 float64. u_code: the updates',
// 0 float32, 1 float64, 2 bfloat16. With Kc == 0, u and inv are not read.
// out is contiguous [batch, F + 1, F]; piv [batch, F, W] and u
// [2 batch, Kc, Kc] by their strides, inv [2 batch, F] int64 likewise.
extern "C" int form_front(void* out, const void* piv, long long pb,
                          long long pr, long long pc, const void* u,
                          long long ub, long long ur, long long uc,
                          const long long* inv, long long ib, long long ic,
                          long long batch, int F, int W, int Kc, int t_code,
                          int u_code, void* stream) {
  if (F <= 0 || W < 0 || W > F || Kc < 0 || batch < 0 || t_code < 0 ||
      t_code > 1 || u_code < 0 || u_code > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  int sms = 0;
  const cudaError_t attr = sms_of_device(&sms);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int col_tiles = (F + COLS - 1) / COLS;
  const int rows = tile_rows(batch, F, sms);
  const long long row_tiles = (F + rows) / rows;
  if (batch * col_tiles > 0x7fffffffLL || row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(batch * col_tiles),
                  static_cast<unsigned int>(row_tiles));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define FORM_FRONT_LAUNCH(T, U)                                            \
  err = launch<T, U>(grid, s, out, piv, pb, pr, pc, u, ub, ur, uc, inv, ib, \
                     ic, F, W, Kc, col_tiles, rows)
  if (t_code == 0 && u_code == 0) FORM_FRONT_LAUNCH(float, float);
  else if (t_code == 0 && u_code == 1) FORM_FRONT_LAUNCH(float, double);
  else if (t_code == 0) FORM_FRONT_LAUNCH(float, __nv_bfloat16);
  else if (u_code == 0) FORM_FRONT_LAUNCH(double, float);
  else if (u_code == 1) FORM_FRONT_LAUNCH(double, double);
  else FORM_FRONT_LAUNCH(double, __nv_bfloat16);
#undef FORM_FRONT_LAUNCH
  return static_cast<int>(err);
}
