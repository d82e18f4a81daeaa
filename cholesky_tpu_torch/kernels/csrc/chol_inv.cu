// Batched Cholesky + explicit lower-triangular inverse of 128x128 f32
// blocks, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel cholesky_tpu/numeric/pallas_kernels.py::
// _chol_inv_lanes_kernel (launched by chol_inv_lanes). Same function: for
// every SPD block A, L = chol(A) and inv(L), both lower with exact zeros
// above the diagonal. Only the lower triangle of A is read.
//
// What bounds it: a launch moves 164,096 B per block (A's lower triangle,
// N(N+1)/2 floats, read; L and inv(L), 2 N^2 floats, written) and does
// ~2N^3/3 flops per block, so at [128, 128, 128] the card needs 6.3 us for
// the bytes and 2.7 us for the fp32 flops: bytes bound it. (The kernel reads
// the 10 lower 32x32 tiles, 40 KiB, a little more than the triangle.) What
// keeps a block's time above that is latency: the Cholesky's 128
// pivots one after the other, each a shuffle and an rsqrt away from the
// next. The design keeps that chain on one warp, with its SM sub-partition
// to itself, and moves all other work off it.
//
// One CTA of 12 warps per block. A (becoming L) and inv(L) live in shared
// memory, rows padded to 132 floats so that float4 rows of eight
// neighbouring rows fall on distinct banks. Blocked right-looking Cholesky
// over 32-wide panels; per panel step p (tiles are 32x32):
//   1. Warp 0 factors diagonal tile (p, p) in registers: lane i holds row
//      i, column j is broadcast with __shfl_sync; no barrier inside.
//   2. Warps 0-2 solve the tiles below, L[i,p] = A[i,p] inv(L_pp)^T, by
//      forward substitution (lane r owns row r); warp 3 forms inv(L_pp)
//      the same way (lane c owns column c).
//   3. Warps 0-3 update diagonal tile (p+1, p+1) -= L[p+1,p] L[p+1,p]^T,
//      then warp 0 goes on to factor it (step 1 of the next panel) while
//      warps on the other three sub-partitions update the other trailing
//      lower tiles, store the finished tiles of L and inv(L), and form the
//      products of inv(L) whose inputs are ready.
// Off the diagonal, inv(L) comes from the 2x2 block formula (see
// side_job); after the last factorization only inv(L_33) and three
// rounds of four-warp products remain.
// Products are 32x32x32 "jobs" with register tiles (8x4 per thread for a
// one-warp job, 2x4 for a four-warp job); 16-byte loads and stores; only
// the 10 lower tiles of A are read; the upper tiles of L and inv(L) are
// written as zeros from registers. Full fp32 on the CUDA cores (no TF32).
// The device functions are not inlined: each is one copy of straight-line
// code, which keeps the kernel within 168 registers without spills.
//
// C interface (bound with ctypes): chol_inv_f32 launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int N = 128;                 // block size
constexpr int T = 32;                  // panel and tile width
constexpr int NT = N / T;              // tiles per side
constexpr int WARPS = 12;
constexpr int THREADS = 32 * WARPS;
constexpr int LD = N + 4;              // shared-memory row stride (floats)
constexpr int SMEM_BYTES = 2 * N * LD * static_cast<int>(sizeof(float));
constexpr int LOWER = NT * (NT + 1) / 2;     // 10 lower tiles
constexpr int CHUNKS = T * T / 4;            // float4 chunks in a tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4& f4(float* p) {
  return *reinterpret_cast<float4*>(p);
}

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Tile (i, j) of a [N][LD] shared-memory matrix.
__device__ __forceinline__ float* tile(float* S, int i, int j) {
  return S + T * i * LD + T * j;
}

// A job, a 32x32 output, is shared by W warps (1 or 4). Lane (ri, cj) =
// (lane / 8, lane % 8) of warp w holds rows (32/W) w + ri + 4a
// (a < 8/W), so the eight lanes of a quarter warp share a row (broadcast
// reads), and columns cj + 8b (X * Y^T: rows of Y read as float4) or
// 4cj + b (X * Y: rows of Y read as float4), b < 4. The next step's
// operands are loaded before the current step's FMAs.
template <int W>
__device__ __forceinline__ int job_row(int w, int lane, int a) {
  return (T / W) * w + (lane >> 3) + 4 * a;
}

// D -= X * Y^T
template <int W>
__device__ __noinline__ void job_syrk(float* D, const float* X,
                                      const float* Y, int w, int lane) {
  constexpr int R = 8 / W;
  const int cj = lane & 7;
  float acc[R][4] = {};
  float4 x[R], y[4];
#pragma unroll
  for (int a = 0; a < R; ++a) x[a] = f4(X + job_row<W>(w, lane, a) * LD);
#pragma unroll
  for (int b = 0; b < 4; ++b) y[b] = f4(Y + (cj + 8 * b) * LD);
#pragma unroll
  for (int k = 0; k < T; k += 4) {
    float4 xn[R], yn[4];
    if (k + 4 < T) {
#pragma unroll
      for (int a = 0; a < R; ++a)
        xn[a] = f4(X + job_row<W>(w, lane, a) * LD + k + 4);
#pragma unroll
      for (int b = 0; b < 4; ++b) yn[b] = f4(Y + (cj + 8 * b) * LD + k + 4);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] = fmaf(comp(x[a], q), comp(y[b], q), acc[a][b]);
    if (k + 4 < T) {
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = xn[a];
#pragma unroll
      for (int b = 0; b < 4; ++b) y[b] = yn[b];
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      D[job_row<W>(w, lane, a) * LD + cj + 8 * b] -= acc[a][b];
  __syncwarp();
}

// acc[a][b] += sum_t X[row a][t] * Y[t][4cj + b]
template <int W>
__device__ __forceinline__ void mma_nn(const float* X, const float* Y, int w,
                                       int lane, float (&acc)[8 / W][4]) {
  constexpr int R = 8 / W;
  const int c0 = 4 * (lane & 7);
  float4 x[R], y[4];
#pragma unroll
  for (int a = 0; a < R; ++a) x[a] = f4(X + job_row<W>(w, lane, a) * LD);
#pragma unroll
  for (int q = 0; q < 4; ++q) y[q] = f4(Y + q * LD + c0);
#pragma unroll
  for (int t = 0; t < T; t += 4) {
    float4 xn[R], yn[4];
    if (t + 4 < T) {
#pragma unroll
      for (int a = 0; a < R; ++a)
        xn[a] = f4(X + job_row<W>(w, lane, a) * LD + t + 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) yn[q] = f4(Y + (t + 4 + q) * LD + c0);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] = fmaf(comp(x[a], q), comp(y[q], b), acc[a][b]);
    if (t + 4 < T) {
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = xn[a];
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = yn[q];
    }
  }
}

// D = scale * (X1 * Y1 [+ X2 * Y2]) [+ D]; X2 == nullptr for one product.
template <int W>
__device__ __noinline__ void job_nn(float* D, const float* X1,
                                    const float* Y1, const float* X2,
                                    const float* Y2, float scale, bool add,
                                    int w, int lane) {
  constexpr int R = 8 / W;
  float acc[R][4] = {};
  mma_nn<W>(X1, Y1, w, lane, acc);
  if (X2 != nullptr) mma_nn<W>(X2, Y2, w, lane, acc);
  const int c0 = 4 * (lane & 7);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    float4& d = f4(D + job_row<W>(w, lane, a) * LD + c0);
    float4 v = add ? d : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v.x += scale * acc[a][0];
    v.y += scale * acc[a][1];
    v.z += scale * acc[a][2];
    v.w += scale * acc[a][3];
    d = v;
  }
  __syncwarp();
}

// One warp: Cholesky of the 32x32 tile D in shared memory, in place (lower;
// zeros above the diagonal), in registers. Only the lower triangle of D is
// used. rsqrt of pivot j goes to rd[j * LD]. Lane i holds row i:
//   a_i[k] -= a_i[j] a_k[j] / d_j   for k > j   (d_j = a_j[j]),
// then column j is scaled by rsqrt(d_j). The pivot chain per column is one
// shuffle, one rsqrt and a few multiplies; the shuffles of a_k[j] do not
// wait on it. Entries above the diagonal only ever feed entries above the
// diagonal of the same row, which are written as zeros.
__device__ __noinline__ void factor_diag(float* D, float* rd, int lane) {
  float a[T];
#pragma unroll
  for (int q = 0; q < T; q += 4) {
    const float4 v = f4(D + lane * LD + q);
    a[q] = v.x; a[q + 1] = v.y; a[q + 2] = v.z; a[q + 3] = v.w;
  }
  float myr = 0.0f;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float r = rsqrtf(__shfl_sync(FULL, a[j], j));
    const float t = a[j] * (r * r);
#pragma unroll
    for (int k = j + 1; k < T; ++k)
      a[k] = fmaf(-t, __shfl_sync(FULL, a[j], k), a[k]);
    a[j] *= r;
    if (lane == j) myr = r;
  }
#pragma unroll
  for (int q = 0; q < T; q += 4) {
    float4 v;
    v.x = q <= lane ? a[q] : 0.0f;
    v.y = q + 1 <= lane ? a[q + 1] : 0.0f;
    v.z = q + 2 <= lane ? a[q + 2] : 0.0f;
    v.w = q + 3 <= lane ? a[q + 3] : 0.0f;
    f4(D + lane * LD + q) = v;
  }
  rd[lane * LD] = myr;
  __syncwarp();
}

// One warp: forward substitution with the factored 32x32 tile Ld
// (rd[i * LD] = 1 / Ld[i][i]). With rows, X <- X inv(Ld)^T: lane r solves
// Ld x = X[r, :]^T and writes x back to row r. Otherwise X <- inv(Ld): lane
// c solves Ld x = e_c and writes column c (exact zeros above the diagonal).
// Rows of Ld are broadcast reads; four partial sums per row keep the
// dependent chain short.
__device__ __noinline__ void solve_lower(const float* Ld, const float* rd,
                                         float* X, bool rows, int lane) {
  float m[T];
  if (rows) {
#pragma unroll
    for (int q = 0; q < T; q += 4) {
      const float4 v = f4(X + lane * LD + q);
      m[q] = v.x; m[q + 1] = v.y; m[q + 2] = v.z; m[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) m[i] = lane == i ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    float part[4] = {m[i], 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < i; q += 4) {
      const float4 l4 = f4(Ld + i * LD + q);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (q + e < i) part[e] = fmaf(-comp(l4, e), m[q + e], part[e]);
    }
    m[i] = ((part[0] + part[1]) + (part[2] + part[3])) * rd[i * LD];
  }
  if (rows) {
#pragma unroll
    for (int q = 0; q < T; q += 4)
      f4(X + lane * LD + q) = make_float4(m[q], m[q + 1], m[q + 2], m[q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) X[i * LD + lane] = m[i];
  }
  __syncwarp();
}

// The s-th lower tile in row-major order over i >= j.
__device__ __forceinline__ void lower_tile(int s, int& i, int& j) {
  i = 0;
  while (s > i) { s -= i + 1; ++i; }
  j = s;
}

// Offsets of float4 chunk w of tile (i, j) in a block in device memory and
// inside a shared-memory tile.
__device__ __forceinline__ size_t gofs(int i, int j, int w) {
  return static_cast<size_t>(T * i + (w >> 3)) * N + T * j + 4 * (w & 7);
}
__device__ __forceinline__ int sofs(int w) { return (w >> 3) * LD + 4 * (w & 7); }

// One warp copies shared tile (i, j) of S to device memory.
__device__ __forceinline__ void store_tile(float* dst, float* S, int i, int j,
                                           int lane) {
  for (int w = lane; w < CHUNKS; w += 32)
    f4(dst + gofs(i, j, w)) = f4(tile(S, i, j) + sofs(w));
}

// Work tiles for inv(L): A's upper tiles, unused once A is loaded.
__device__ __forceinline__ float* work(float* A, int s) {
  return s == 0 ? tile(A, 0, 1) : s == 1 ? tile(A, 0, 2)
       : s == 2 ? tile(A, 0, 3) : s == 3 ? tile(A, 1, 2)
       : s == 4 ? tile(A, 1, 3) : tile(A, 2, 3);
}

// inv(L) off the diagonal tiles comes from L and the diagonal tiles'
// inverses Mii by the 2x2 block formula
//   inv([[P, 0], [C, Q]]) = [[inv P, 0], [-inv Q * C * inv P, inv Q]],
// on the 64x64 halves' own 2x2 tiles and then on the halves:
//   S0 = L10 M00  S1 = L32 M22  S2 = L20 M00  S3 = L30 M00
//   S4 = L21 M11  S5 = L31 M11  (S4, S5 = X21, X31)
//   M10 = -M11 S0   M21 = -M22 S4   M32 = -M33 S1
//   S2 += L21 M10  S3 += L31 M10  (= X20, X30)
//   M20 = -M22 S2   M30 = -(M32 S2 + M33 S3)   M31 = -(M32 S4 + M33 S5)
// (the last two are formed as -M33 (S3 - S1 S2) and -M33 (S5 - S1 S4)).
// Job n of the side work of panel step p: the trailing update of the lower
// tiles other than (p+1, p+1), then the inv(L) products whose inputs are
// ready (L's block column p and M_pp are, by then).
__device__ __forceinline__ int side_jobs(int p) { return p == 0 ? 5 : p == 1 ? 7 : 3; }

__device__ __forceinline__ void side_job(int p, int n, float* A, float* M,
                                         int lane) {
  const int ntrail = (NT - 1 - p) * (NT - p) / 2 - 1;
  if (n < ntrail) {
    int i, j;
    lower_tile(n + 1, i, j);
    i += p + 1;
    j += p + 1;
    job_syrk<1>(tile(A, i, j), tile(A, i, p), tile(A, j, p), 0, lane);
    return;
  }
  n -= ntrail;
  if (p == 1) {                                // S0, S2, S3, S4, S5
    const int s = n == 0 ? 0 : n + 1;
    const int i = s == 0 ? 1 : s == 2 ? 2 : s == 3 ? 3 : s == 4 ? 2 : 3;
    const int k = s < 4 ? 0 : 1;
    job_nn<1>(work(A, s), tile(A, i, k), tile(M, k, k), nullptr, nullptr,
              1.0f, false, 0, lane);
  } else if (n == 0) {                         // p == 2: M10, M21, S1
    job_nn<1>(tile(M, 1, 0), tile(M, 1, 1), work(A, 0), nullptr, nullptr,
              -1.0f, false, 0, lane);
  } else if (n == 1) {
    job_nn<1>(tile(M, 2, 1), tile(M, 2, 2), work(A, 4), nullptr, nullptr,
              -1.0f, false, 0, lane);
  } else {
    job_nn<1>(work(A, 1), tile(A, 3, 2), tile(M, 2, 2), nullptr, nullptr,
              1.0f, false, 0, lane);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
chol_inv_kernel(const float* __restrict__ a, float* __restrict__ l,
                float* __restrict__ m) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);
  float* M = A + N * LD;
  const size_t base = static_cast<size_t>(blockIdx.x) * N * N;
  a += base; l += base; m += base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the 10 lower tiles of A, all loads in flight together; above the
  // diagonal of the diagonal tiles -> 0
  constexpr int PER = (LOWER * CHUNKS + THREADS - 1) / THREADS;
  float4 v[PER];
#pragma unroll
  for (int n = 0; n < PER; ++n) {
    const int e = tid + n * THREADS;
    if (e < LOWER * CHUNKS) {
      int i, j;
      lower_tile(e / CHUNKS, i, j);
      v[n] = __ldg(reinterpret_cast<const float4*>(a + gofs(i, j, e % CHUNKS)));
    }
  }
#pragma unroll
  for (int n = 0; n < PER; ++n) {
    const int e = tid + n * THREADS;
    if (e >= LOWER * CHUNKS) break;
    const int w4 = e % CHUNKS;
    int i, j;
    lower_tile(e / CHUNKS, i, j);
    if (i == j) {
      const int r = w4 >> 3, q = 4 * (w4 & 7);
      v[n].x = q <= r ? v[n].x : 0.0f;
      v[n].y = q + 1 <= r ? v[n].y : 0.0f;
      v[n].z = q + 2 <= r ? v[n].z : 0.0f;
      v[n].w = q + 3 <= r ? v[n].w : 0.0f;
    }
    f4(tile(A, i, j) + sofs(w4)) = v[n];
  }
  // tile (0, 0) came in through warps 0-7: warp 0 starts on it at once
  if (warp < CHUNKS / 32) asm volatile("bar.sync 1, 256;" ::: "memory");
  if (warp == 0) {
    factor_diag(tile(A, 0, 0), A + N, lane);
  } else {
    // the upper tiles of L and inv(L) are zero
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e = tid - 32; e < (LOWER - NT) * CHUNKS; e += THREADS - 32) {
      int i, j;
      lower_tile(e / CHUNKS, i, j);            // (i, j) lower -> (j, i+1)
      f4(l + gofs(j, i + 1, e % CHUNKS)) = z;
      f4(m + gofs(j, i + 1, e % CHUNKS)) = z;
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int p = 0; p < NT - 1; ++p) {
    float* rd = A + T * p * LD + N;            // row padding: rsqrt(d)
    if (warp < 4) {
      // the panel below (warps 0-2) and inv(L_pp) (warp 3)
      if (warp < NT - 1 - p)
        solve_lower(tile(A, p, p), rd, tile(A, p + 1 + warp, p), true, lane);
      else if (warp == 3)
        solve_lower(tile(A, p, p), rd, tile(M, p, p), false, lane);
      asm volatile("bar.sync 1, 128;" ::: "memory");
      // update of diagonal tile p+1 on warps 0-3, then warp 0 factors it;
      // the side work starts after the update, which it would slow down
      job_syrk<4>(tile(A, p + 1, p + 1), tile(A, p + 1, p),
                  tile(A, p + 1, p), warp, lane);
      asm volatile("bar.sync 1, 128;" ::: "memory");
      asm volatile("bar.arrive 2, 384;" ::: "memory");
      if (warp == 0) {
        factor_diag(tile(A, p + 1, p + 1), rd + T * LD, lane);
      } else if (warp == 1) {
        // L's block column p and inv(L)'s tile (p, p) are final
        for (int i = p; i < NT; ++i) store_tile(l, A, i, p, lane);
        store_tile(m, M, p, p, lane);
      } else if (warp + 4 < side_jobs(p)) {       // warps 2, 3 -> 6, 7
        side_job(p, warp + 4, A, M, lane);
      }
    } else {
      // the side work waits for the panel, inv(L_pp) and the update of
      // tile (p+1, p+1); warps 4 and 8 share warp 0's sub-partition and
      // stay idle
      asm volatile("bar.sync 2, 384;" ::: "memory");
      const int n = warp < 8 ? warp - 5 : warp - 6;   // 5-7, 9-11 -> 0-5
      if ((warp & 3) != 0 && n < side_jobs(p)) side_job(p, n, A, M, lane);
    }
    __syncthreads();
  }

  // the last products of inv(L). With M32 = -M33 S1,
  //   M30 = -M33 (X30 - S1 X20),   M31 = -M33 (X31 - S1 X21),
  // so only one product per tile waits for M33:
  //   M33 beside X20 = S2 + L21 M10, X30 = S3 + L31 M10, S5 -= S1 S4;
  //   then M32, M20 = -M22 X20 and S3 -= S1 X20; then M30, M31.
  const int quad = warp >> 2, w = warp & 3;
  if (warp == 3)
    solve_lower(tile(A, 3, 3), A + 3 * T * LD + N, tile(M, 3, 3), false,
                lane);
  else if (quad > 0)
    job_nn<4>(work(A, quad + 1), tile(A, quad + 1, 1), tile(M, 1, 0),
              nullptr, nullptr, 1.0f, true, w, lane);
  if (quad == 1)
    job_nn<4>(work(A, 5), work(A, 1), work(A, 4), nullptr, nullptr,
              -1.0f, true, w, lane);
  __syncthreads();
  if (quad == 0)
    job_nn<4>(tile(M, 3, 2), tile(M, 3, 3), work(A, 1), nullptr, nullptr,
              -1.0f, false, w, lane);
  else if (quad == 1)
    job_nn<4>(tile(M, 2, 0), tile(M, 2, 2), work(A, 2), nullptr, nullptr,
              -1.0f, false, w, lane);
  else
    job_nn<4>(work(A, 3), work(A, 1), work(A, 2), nullptr, nullptr,
              -1.0f, true, w, lane);
  __syncthreads();
  if (quad < 2)
    job_nn<4>(tile(M, 3, quad), tile(M, 3, 3), work(A, quad == 0 ? 3 : 5),
              nullptr, nullptr, -1.0f, false, w, lane);
  __syncthreads();

  // what is not stored yet: L33, M33 and inv(L) below the diagonal tiles
  for (int e = tid; e < 8 * CHUNKS; e += THREADS) {
    const int s = e / CHUNKS, w4 = e % CHUNKS;
    if (s == 0) {
      f4(l + gofs(3, 3, w4)) = f4(tile(A, 3, 3) + sofs(w4));
    } else {
      int i, j;
      lower_tile(s == 1 ? 9 : s == 2 ? 1 : s == 3 ? 3 : s == 4 ? 4
                 : s == 5 ? 6 : s == 6 ? 7 : 8, i, j);
      f4(m + gofs(i, j, w4)) = f4(tile(M, i, j) + sofs(w4));
    }
  }
}

// The shared-memory limit is an attribute of the kernel on each device: it
// is raised once for every device the kernel is launched on.
constexpr int MAX_DEVICES = 64;
std::atomic<bool> configured[MAX_DEVICES];

cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (configured[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(chol_inv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err == cudaSuccess) configured[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" int chol_inv_f32(const float* a, float* l, float* m,
                            long long batch, void* stream) {
  const cudaError_t attr = configure();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (batch <= 0) return 0;
  chol_inv_kernel<<<static_cast<unsigned int>(batch), THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(a, l, m);
  return static_cast<int>(cudaGetLastError());
}
