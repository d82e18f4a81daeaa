// The Schur update of a level's fronts, only where the fronts need it, for
// NVIDIA Hopper (sm_90a): per front b of a batch,
//
//   U[b][:m, :m] = X[b][:m, :p] X[b][:m, :p]^T + s E[b][:m, :m]
//
// with m = m_b the front's own boundary rows and p = p_b its own pivots
// (the level pads every front to its widest, K rows and W columns), s in
// {-1, +1}, or no E at all. X is the front's solved boundary strip, E its
// trailing block (symmetric, as the front is: only its lower tiles are
// read); U is what the front hands its parent.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA
// (cholesky_tpu/numeric/frontal.py::_schur_update_cast), and the port left
// it to cuBLAS as one padded baddbmm per level, the full [K, K] product of
// every front over all W columns. Both triangles of it, and the padding to
// the level's widest front, are 2.6x the symmetric work at the widest
// configuration's levels; baddbmm also copies a strided E into its output
// before the product. This kernel computes the 128 x 128 output tiles
// (i, j) with j <= i and 128 i < m_b of each front, contracted over its
// own p_b columns rounded up to 32 (X's columns from p_b on read as zeros),
// and stores each off-diagonal tile twice: at (i, j) and, through shared
// memory, transposed at (j, i). So within a front's extent U is the full
// symmetric matrix; beyond it nothing is computed or written. U may be E
// itself (in place): a CTA reads E only in its own lower tile, all of it
// before it writes anything, and the upper tiles it mirrors into are read
// by no CTA.
//
// What bounds it: a tile does 2 * 128^2 * p flops against 2 * 128 * p + 2
// * 128^2 values of X, E and U, so the FFMA pipe (67 TFLOP/s in IEEE f32)
// bounds the wide levels (p in the hundreds and thousands) and E's and U's
// bytes the narrow ones (p of a few dozen, tiles mostly padding). The
// product is the core of factor_slab.cu: one CTA of 8 warps per output
// tile, its 128 x 128 product accumulated in registers (8 x 8 a thread,
// IEEE f32 FFMA with f32 accumulation) over K chunks of 32 that cp.async
// brings into a 4-stage shared-memory ring. No split-K and no atomics:
// every element is summed in one order, so the result is the same on
// every run. What the narrow levels pay for is latency, not flops: E's
// tile comes into a shared-memory region of its own with the first K
// chunk, so its reads hide behind the product, and the tile is stored from
// registers; a warp whose 32 x 64 block lies beyond the front's extent
// skips the products. The tiles of a front are numbered row by row through
// its lower triangle and run next to each other, so the 128-row panels of
// X that they share come from device memory once and from L2 after; a
// tile beyond its front's extent exits before it loads anything. One CTA
// fits an SM (254 registers a thread, 212 KB of shared memory), so a
// tile's loads and stores do not overlap another tile's products: at the
// widest levels the kernel reaches ~61% of the FFMA peak (PERF.md).
//
// Layout: X [B, K, W] and E [B, K, K] are read in place through their batch
// and row strides (the strided views fac[:, W:, :] of the level's factor
// and full[:, W:F, W:] of its fronts); U [B, K, K] likewise. Their last
// stride is 1. Where X's and E's strides and bases are 16-byte aligned (a
// level padded to multiples of 4, as the default pad of 8 pads it) their
// rows come in 16-byte copies; otherwise in copies of 4 bytes, the same
// kernel instantiated for any row alignment. ext [B, 2] int64 holds (m_b,
// p_b); null means (K, W) for all.
//
// C interface (bound with ctypes): schur_syrk_f32 launches on the caller's
// stream, allocates nothing and returns the launch's CUDA error.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int BS = 128;                    // output tile side
constexpr int BK = 32;                     // K chunk of one ring stage
constexpr int STAGES = 4;
constexpr int LDK = BK + 4;                // ring row stride (floats)
constexpr int LDE = BS + 8;                // E tile and mirror row stride
constexpr int THREADS = 256;
constexpr int STAGE_FLOATS = 2 * BS * LDK;             // X_i and X_j chunks
constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
constexpr int TILE_FLOATS = BS * LDE;
constexpr int SMEM = (RING_FLOATS + TILE_FLOATS) * 4;  // 217,088 B
static_assert(TILE_FLOATS <= RING_FLOATS, "the mirror fits in the ring");

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// 16 bytes into shared memory, of which the first `bytes` (0, 4, .. 16)
// come from device memory and the rest are zeros: one 16-byte copy from a
// 16-byte aligned source (VEC), else four of 4 bytes.
template <bool VEC>
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = bytes > 4 * q ? 4 : 0;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       s + 4 * q),
                   "l"(n ? src + q : src), "r"(n));
    }
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc += A B^T on a 128 x 128 tile, A and B row-major in shared memory
// (rows of BK values). Warp w owns the 32 x 64 block of rows 32 (w / 2) ..
// and columns 64 (w % 2) ..; its lane (ly, lx) = (lane / 8, lane % 8) the
// rows ly + 4 i and columns lx + 8 j of it (i, j < 8). A float4 read of A
// is then 4 broadcast rows and one of B 8 rows, on distinct banks (LDK %
// 32 == 4): one wavefront each. A warp whose block holds nothing the tile
// needs skips the products (`busy`).
struct Core {
  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  __device__ __forceinline__ void run(const float* A, const float* B,
                                      int tid) {
    const float* ab = A + row(tid, 0) * LDK;
    const float* bb = B + col(tid, 0) * LDK;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(ab + 4 * i * LDK + k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(bb + 8 * j * LDK + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(comp(a[i], q), comp(b[j], q), acc[i][j]);
    }
  }

  // the tile row of acc[i][.] and column of acc[.][j]
  static __device__ __forceinline__ int row(int tid, int i) {
    return 32 * (tid >> 6) + ((tid >> 3) & 3) + 4 * i;
  }
  static __device__ __forceinline__ int col(int tid, int j) {
    return 64 * ((tid >> 5) & 1) + (tid & 7) + 8 * j;
  }

  // whether the warp's block holds a row < ni and a column < nj
  static __device__ __forceinline__ bool busy(int tid, int ni, int nj) {
    return 32 * (tid >> 6) < ni && 64 * ((tid >> 5) & 1) < nj;
  }
};

// One ring stage: columns k0 .. k0 + BK of the rows of panel i (ni of them
// real) and of panel j (nj real), row stride xr; rows past the real ones
// and columns from p on are zeros.
template <bool VEC>
__device__ __forceinline__ void load_stage(float* st, const float* Xi, int ni,
                                           const float* Xj, int nj,
                                           long long xr, int k0, int p,
                                           int tid) {
#pragma unroll
  for (int n = 0; n < 2 * BS * BK / 4 / THREADS; ++n) {
    const int e = tid + n * THREADS;
    const int y = e / (BS * BK / 4);
    const int r = (e / (BK / 4)) % BS, q = e % (BK / 4);
    const int k = k0 + 4 * q;
    const float* src = y ? Xj : Xi;
    const int left = 4 * (p - k);
    const int bytes = r < (y ? nj : ni) ? (left < 0 ? 0 : left > 16 ? 16 : left)
                                        : 0;
    cp_async16<VEC>(st + y * BS * LDK + r * LDK + 4 * q,
                    bytes ? src + r * xr + k : src, bytes);
  }
}

// Grid B * tiles (tiles = the lower tiles of the padded K): CTA (b, t)
// owns lower tile t of front b, numbered row by row. HAS_E: the epilogue
// adds s E. VEC: X's and E's rows are 16-byte aligned.
template <bool HAS_E, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
schur_syrk_kernel(const float* __restrict__ X, long long xb, long long xr,
                  const float* E, long long eb, long long er, float* U,
                  long long ub, long long ur,
                  const long long* __restrict__ ext, int K, int W, int tiles,
                  float s) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const long long b = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x - b * tiles);
  int i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  const int j = t - i * (i + 1) / 2;
  const int m = ext ? min(static_cast<int>(ext[2 * b]), K) : K;
  const int p = ext ? min(static_cast<int>(ext[2 * b + 1]), W) : W;
  const int r0 = BS * i, c0 = BS * j;
  if (r0 >= m) return;
  const int ni = min(BS, m - r0), nj = min(BS, m - c0);
  const float* Xb = X + b * xb;
  const float* Xi = Xb + r0 * xr;
  const float* Xj = Xb + c0 * xr;

  Core core;
  core.zero();
  const bool busy = Core::busy(tid, ni, nj);
  const int nk = (p + BK - 1) / BK;
  float* Es = ring + RING_FLOATS;
  if (HAS_E) {                              // E's tile, beside the ring
    const float* eb0 = E + b * eb + r0 * er + c0;
    for (int e = tid; e < BS * BS / 4; e += THREADS) {
      const int r = e / (BS / 4), c = 4 * (e % (BS / 4));
      const int left = 4 * (nj - c);
      const int bytes = r < ni ? (left < 0 ? 0 : left > 16 ? 16 : left) : 0;
      cp_async16<VEC>(Es + r * LDE + c, bytes ? eb0 + r * er + c : eb0, bytes);
    }
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      load_stage<VEC>(ring + st * STAGE_FLOATS, Xi, ni, Xj, nj, xr, st * BK,
                      p, tid);
    cp_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage<VEC>(ring + (nxt % STAGES) * STAGE_FLOATS, Xi, ni, Xj, nj,
                      xr, nxt * BK, p, tid);
    cp_commit();
    const float* stage = ring + (kt % STAGES) * STAGE_FLOATS;
    if (busy) core.run(stage, stage + BS * LDK, tid);
  }
  cp_wait<0>();
  __syncthreads();

  // the tile stored from registers at (i, j), s E added from shared
  // memory; an off-diagonal tile also into the free ring transposed, then
  // from there row by row at (j, i). LDE % 32 == 8: a warp's 4 x 8 block
  // of E reads on distinct banks, and its transposed writes two to a bank.
  float* Ub = U + b * ub;
  float* Vt = ring;
  const bool diag = i == j;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int r = Core::row(tid, a), col = Core::col(tid, c);
      float v = core.acc[a][c];
      if (HAS_E) v = fmaf(s, Es[r * LDE + col], v);
      if (r < ni && col < nj) Ub[(r0 + r) * ur + c0 + col] = v;
      if (!diag) Vt[col * LDE + r] = v;
    }
  if (diag) return;
  __syncthreads();
  for (int e = tid; e < BS * BS; e += THREADS) {
    const int c = e / BS, r = e % BS;
    if (r < ni && c < nj) Ub[(c0 + c) * ur + r0 + r] = Vt[c * LDE + r];
  }
}

// The shared-memory limit is an attribute of each kernel on each device:
// it is raised once for every device the kernel is launched on.
constexpr int MAX_DEVICES = 64;
std::atomic<bool> configured[MAX_DEVICES];

cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (configured[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(schur_syrk_kernel<false, true>, attr,
                                  SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(schur_syrk_kernel<true, true>, attr,
                                  SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(schur_syrk_kernel<false, false>, attr,
                                  SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(schur_syrk_kernel<true, false>, attr,
                                  SMEM)) != cudaSuccess)
    return err;
  configured[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

// U = X X^T + s E (E null: X X^T) on the lower tiles of each front's extent
// and their mirrors; strides in elements. ext null: every front is K x W.
// Rows at any 4-byte alignment; 16-byte aligned ones are copied 16 bytes at
// a time.
extern "C" int schur_syrk_f32(const float* X, long long xb, long long xr,
                              const float* E, long long eb, long long er,
                              float* U, long long ub, long long ur,
                              const long long* ext, long long batch, int K,
                              int W, float s, void* stream) {
  if (batch < 0 || K < 0 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || K == 0) return 0;
  const cudaError_t attr = configure();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long rows = (K + BS - 1) / BS;
  const long long tiles = rows * (rows + 1) / 2;
  if (batch * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(batch * tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const float* base, long long sb, long long sr) {
    return reinterpret_cast<std::uintptr_t>(base) % 16 == 0 && sb % 4 == 0 &&
           sr % 4 == 0;
  };
  const bool vec = aligned(X, xb, xr) && (E == nullptr || aligned(E, eb, er));
  const int nt = static_cast<int>(tiles);
  if (E != nullptr && vec)
    schur_syrk_kernel<true, true><<<grid, THREADS, SMEM, st>>>(
        X, xb, xr, E, eb, er, U, ub, ur, ext, K, W, nt, s);
  else if (E != nullptr)
    schur_syrk_kernel<true, false><<<grid, THREADS, SMEM, st>>>(
        X, xb, xr, E, eb, er, U, ub, ur, ext, K, W, nt, s);
  else if (vec)
    schur_syrk_kernel<false, true><<<grid, THREADS, SMEM, st>>>(
        X, xb, xr, nullptr, 0, 0, U, ub, ur, ext, K, W, nt, s);
  else
    schur_syrk_kernel<false, false><<<grid, THREADS, SMEM, st>>>(
        X, xb, xr, nullptr, 0, 0, U, ub, ur, ext, K, W, nt, s);
  return static_cast<int>(cudaGetLastError());
}
