// Left-looking blocked partial factorization of pivot slabs [B, F, W] f32,
// for NVIDIA Hopper (sm_90a): the two kernels that run around chol_inv on
// each 128-wide panel.
//
// Replaces the TPU kernel cholesky_tpu/numeric/pallas_kernels.py::
// factor_slab_lanes. Same function: rows [:W] of the result are the
// Cholesky factor of the slab's pivot block (exact zeros above the
// diagonal), rows [W:] the boundary strip solved against it, X L^-T. Per
// panel k (c0 = 128 k, w = min(128, W - c0)), with L the columns of the
// result already written:
//   slab_diag:  D = A[c0:c0+w, c0:c0+w] - L[c0:c0+w, :c0] L[c0:c0+w, :c0]^T
//               into a [B, 128, 128] scratch, identity outside w (the tail
//               panel's padding: chol(blockdiag(D, I)) = blockdiag(chol D, I));
//   chol_inv:   L_kk and inv(L_kk) of the scratch (chol_inv.cu, unchanged);
//   slab_panel: out[r, c0:c0+w] = (A[r, c0:c0+w] - L[r, :c0] L[c0:c0+w, :c0]^T)
//               inv(L_kk)^T for every row r below the block, and L_kk with
//               zeros to its right into rows c0..c0+w.
// Every element of the result is written exactly once; the update of a
// panel never goes to device memory.
//
// What bounds it: the function reads the slab once and writes the result
// once (8 B F W bytes) and needs B (W^3/3 + (F - W) W^2) flops. At the
// routed shapes that is 10-70 flops a byte. The card's fp32 ratio is 20
// (67 TFLOP/s over 3.35 TB/s): at IEEE f32 the CUDA cores bound the
// classes above it and the bytes the others. Its TF32 ratio is 148: at
// TF32 the bytes bound them all. The left-looking schedule re-reads L's
// past columns once per panel (~W / 256 times the slab, from L2 where it
// fits), multiplies by inv(L_kk) as a dense matrix, forms the whole
// diagonal tile and pads row tiles and tail panels: it executes 1.4-2.5x
// the bound's flops (`hopper_kernels.factor_slab_flops`).
//
// The design: one CTA of 8 warps owns a 128 x 128 output tile and
// accumulates its product in registers over K chunks of 32 that cp.async
// brings into a 4-stage shared-memory ring. In slab_panel the tile of A
// comes in beside the ring, inv(L_kk) into the ring once the loop is done
// (from L2: every tile of a batch entry reads it), the update is
// subtracted in shared memory, and the product with inv(L_kk)^T reads both
// from there: a panel costs one pass of reads and one of writes. The
// product core has two versions: scalar FFMA with 8 x 8 register tiles
// (IEEE rung) and mma.sync.m16n8k8 TF32 with f32 accumulation, fragments
// by ldmatrix (TF32 rung: the operands rounded to TF32 with cvt.rna). A
// tail panel of at most 32 columns computes only those. slab_diag has only
// B tiles per panel: below one wave it splits K over a cluster of S CTAs,
// each keeps its partial in shared memory, and rank 0 sums them through
// distributed shared memory in rank order (no atomics: the result is the
// same on every run); panel 0's tile is a plain copy. The row tiles of a
// batch entry run next to each other, so the rows of L they share are read
// from device memory once.
//
// Where it stands (PERF.md has the numbers): at IEEE the FFMA pipe and the
// shared-memory reads that feed it bound the panel; at TF32 the device
// memory traffic of the left-looking schedule (each panel re-reads its
// rows' past columns) does. One CTA fits an SM (215 KB of shared memory),
// so a tile's loads, products and stores do not overlap another tile's.
// wgmma, a TMA ring and persistent CTAs are the next steps.
//
// Layout: A is read in place through its batch and row strides (the
// strided view [:, :F, :W] of a larger front); the caller checks that the
// last stride is 1 and the strides and base are 16-byte aligned. The
// result is contiguous [B, F, W] with W % 4 == 0.
//
// C interface (bound with ctypes): factor_slab_diag_f32 and
// factor_slab_panel_f32 launch on the caller's stream, allocate nothing
// and return the launch's CUDA error (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BS = 128;                    // panel width, output tile side
constexpr int BK = 32;                     // K chunk of one ring stage
constexpr int STAGES = 4;
constexpr int LDK = BK + 4;                // ring row stride (floats)
constexpr int LDT = BS + 4;                // tile row stride (floats)
constexpr int THREADS = 256;
constexpr int STAGE_FLOATS = 2 * BS * LDK;             // X and Y chunks
constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
constexpr int TILE_FLOATS = BS * LDT;
constexpr int DIAG_SMEM = RING_FLOATS * 4;                     // 147,456 B
constexpr int PANEL_SMEM = (RING_FLOATS + TILE_FLOATS) * 4;     // 215,040 B
constexpr int MAX_SPLITS = 8;              // portable cluster size
constexpr int NARROW = 32;                 // columns of a narrow tail panel
constexpr int GROUP = 16;                  // batch entries run side by side
static_assert(TILE_FLOATS <= RING_FLOATS, "a tile fits in the ring");

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4& f4(float* p) {
  return *reinterpret_cast<float4*>(p);
}

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes from device memory into shared memory, or 16 zero bytes.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The product core: acc += X Y^T on a 128 x 128 tile, X and Y row-major in
// shared memory (rows of K values), for KN values of K (KN % 8 == 0). Only
// the first NC columns (128 or 32: a narrow tail panel) are computed; the
// others keep their value.
template <bool TF32>
struct Core;

// IEEE f32: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i,
// j < 8); a warp is 4 x 8 threads (ty = 4 (warp / 2) + lane / 8, tx =
// 8 (warp % 2) + lane % 8), so a float4 read of X is 4 broadcast rows and
// one of Y 8 rows on distinct banks (LD % 32 == 4): one wavefront each.
template <>
struct Core<false> {
  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  template <int LDX, int LDY, int KN, int NC>
  __device__ __forceinline__ void run(const float* X, const float* Y,
                                      int tid) {
    constexpr int NJ = NC / 16;
    const float* xb = X + ty(tid) * LDX;
    const float* yb = Y + tx(tid) * LDY;
#pragma unroll
    for (int k = 0; k < KN; k += 4) {
      float4 x[8], y[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = f4(xb + 16 * i * LDX + k);
#pragma unroll
      for (int j = 0; j < NJ; ++j) y[j] = f4(yb + 16 * j * LDY + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            acc[i][j] = fmaf(comp(x[i], q), comp(y[j], q), acc[i][j]);
    }
  }

  template <class Fn>
  __device__ __forceinline__ void each(int tid, Fn fn) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        fn(ty(tid) + 16 * i, tx(tid) + 16 * j, acc[i][j]);
  }

  static __device__ __forceinline__ int ty(int tid) {
    return 4 * (tid >> 6) + ((tid >> 3) & 3);
  }
  static __device__ __forceinline__ int tx(int tid) {
    return 8 * ((tid >> 5) & 1) + (tid & 7);
  }
};

// Round f32 bits to TF32 (nearest, ties away), as cuBLAS's TF32 math does.
__device__ __forceinline__ uint32_t to_tf32(uint32_t x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(x)));
  return r;
}

// Four 8 x 4 f32 matrices from shared memory (ldmatrix on b16 pairs): lane
// l gives the address of row l % 8 of matrix l / 8 and receives, from each
// matrix, the word l % 4 of its row l / 4.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TF32 tensor cores: warp w owns rows 32 (w % 4) .. + 32 (two m16 tiles)
// and columns 64 (w / 4) .. + 64 (eight n8 tiles). Lane (g, t) = (lane / 4,
// lane % 4) holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4] of an
// m16 tile and B[g][t], B[g][t + 4] of an n8 tile, each fragment set one
// ldmatrix.x4 (eight rows of 16 bytes on distinct banks: LD % 32 == 4).
template <>
struct Core<true> {
  float acc[2][8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
  }

  template <int LDX, int LDY, int KN, int NC>
  __device__ __forceinline__ void run(const float* X, const float* Y,
                                      int tid) {
    constexpr int NT = NC >= 64 ? 8 : NC / 8;      // n8 tiles of a warp
    const int lane = tid & 31, w = tid >> 5;
    if (NC <= 64 && w >= 4) return;                // columns 64.. idle
    const int i = lane >> 3, j = lane & 7;
    // A: matrix i = rows + 8 (i % 2), k + 4 (i / 2); B: matrix i = n8 tile
    // + i / 2, k + 4 (i % 2)
    const float* xb = X + (32 * (w & 3) + j + 8 * (i & 1)) * LDX + 4 * (i >> 1);
    const float* yb = Y + (64 * (w >> 2) + j + 8 * (i >> 1)) * LDY + 4 * (i & 1);
#pragma unroll
    for (int k = 0; k < KN; k += 8) {
      uint32_t a[2][4], b[NT / 2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) ldsm4(a[m], xb + 16 * m * LDX + k);
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) ldsm4(b[n], yb + 16 * n * LDY + k);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[m][e] = to_tf32(a[m][e]);
#pragma unroll
      for (int n = 0; n < NT / 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) b[n][e] = to_tf32(b[n][e]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT / 2; ++n) {
          mma_tf32(acc[m][2 * n], a[m], b[n][0], b[n][1]);
          mma_tf32(acc[m][2 * n + 1], a[m], b[n][2], b[n][3]);
        }
    }
  }

  template <class Fn>
  __device__ __forceinline__ void each(int tid, Fn fn) {
    const int lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fn(32 * (w & 3) + 16 * m + g + 8 * (e >> 1),
             64 * (w >> 2) + 8 * n + 2 * t + (e & 1), acc[m][n][e]);
  }
};

// One ring stage: K values k0 .. k0 + BK of rows 0 .. 127 of X (nx of them
// real, row stride ld) and of Y (ny real); the other rows are zeros.
__device__ __forceinline__ void load_stage(float* st, const float* X,
                                           int nx, const float* Y, int ny,
                                           long long ld, int k0, int tid) {
#pragma unroll
  for (int n = 0; n < 2 * BS * BK / 4 / THREADS; ++n) {
    const int e = tid + n * THREADS;
    const int y = e / (BS * BK / 4);
    const int r = (e / (BK / 4)) % BS, q = e % (BK / 4);
    const float* src = y ? Y : X;
    const bool valid = r < (y ? ny : nx);
    cp_async16(st + y * BS * LDK + r * LDK + 4 * q,
               valid ? src + r * ld + k0 + 4 * q : src, valid);
  }
}

// acc += X[:, kb:ke] Y[:, kb:ke]^T through the ring (kb, ke multiples of
// BK) on the first NC columns; `extra` issues more cp.async copies in the
// last prologue group. Returns with every copy landed and the ring free.
template <bool TF32, int NC, class Extra>
__device__ __forceinline__ void ring_product(Core<TF32>& core, float* ring,
                                             const float* X, int nx,
                                             const float* Y, int ny,
                                             long long ld, int kb, int ke,
                                             int tid, Extra extra) {
  const int nk = (ke - kb) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage(ring + s * STAGE_FLOATS, X, nx, Y, ny, ld, kb + s * BK, tid);
    if (s == STAGES - 2) extra();
    cp_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage(ring + (nxt % STAGES) * STAGE_FLOATS, X, nx, Y, ny, ld,
                 kb + nxt * BK, tid);
    cp_commit();
    const float* st = ring + (kt % STAGES) * STAGE_FLOATS;
    core.template run<LDK, LDK, BK, NC>(st, st + BS * LDK, tid);
  }
  cp_wait<0>();
  __syncthreads();
}

// Grid B * S, clusters of S along x: CTA (b, rank) accumulates the update
// of panel k's diagonal tile over its share of K = c0, rank 0 sums the
// cluster's partials and writes D, identity-padded, to d[b].
template <bool TF32>
__global__ void __launch_bounds__(THREADS, 1)
slab_diag_kernel(const float* __restrict__ a, long long sb, long long sr,
                 const float* __restrict__ out, int F, int W, int c0, int w,
                 int splits, float* __restrict__ d) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / splits;
  const float* Lk = out + b * F * W + static_cast<long long>(c0) * W;

  const int nk = c0 / BK;
  const int kb = BK * (rank * nk / splits);
  const int ke = BK * ((rank + 1) * nk / splits);
  Core<TF32> core;
  core.zero();
  ring_product<TF32, BS>(core, ring, Lk, w, Lk, w, W, kb, ke, tid, [] {});

  float* part = ring;                       // [BS][LDT]
  core.each(tid, [&](int r, int c, float v) { part[r * LDT + c] = v; });
  cluster.sync();
  if (rank == 0) {
    const float* ab = a + b * sb + c0 * sr + c0;
    float* db = d + b * BS * BS;
    for (int e = tid; e < BS * BS / 4; e += THREADS) {
      const int r = e / (BS / 4), c = 4 * (e % (BS / 4));
      float4 o;
      if (r < w && c < w) {
        float4 s = f4(part + r * LDT + c);
        for (int j = 1; j < splits; ++j) {
          const float4 p = f4(cluster.map_shared_rank(part, j) + r * LDT + c);
          s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
        }
        const float4 v = __ldg(reinterpret_cast<const float4*>(ab + r * sr + c));
        o = make_float4(v.x - s.x, v.y - s.y, v.z - s.z, v.w - s.w);
      } else {
        o = make_float4(r == c ? 1.0f : 0.0f, r == c + 1 ? 1.0f : 0.0f,
                        r == c + 2 ? 1.0f : 0.0f, r == c + 3 ? 1.0f : 0.0f);
      }
      f4(db + r * BS + c) = o;
    }
  }
  cluster.sync();                           // partials read: ranks may exit
}

// Panel 0 has no past columns: its diagonal tile is A's block,
// identity-padded, a copy that needs no shared memory and so runs many
// CTAs to an SM.
__global__ void __launch_bounds__(THREADS)
slab_diag_copy_kernel(const float* __restrict__ a, long long sb,
                      long long sr, int w, float* __restrict__ d) {
  const float* ab = a + blockIdx.x * sb;
  float* db = d + static_cast<long long>(blockIdx.x) * BS * BS;
  for (int e = threadIdx.x; e < BS * BS / 4; e += THREADS) {
    const int r = e / (BS / 4), c = 4 * (e % (BS / 4));
    f4(db + r * BS + c) =
        r < w && c < w
            ? __ldg(reinterpret_cast<const float4*>(ab + r * sr + c))
            : make_float4(r == c ? 1.0f : 0.0f, r == c + 1 ? 1.0f : 0.0f,
                          r == c + 2 ? 1.0f : 0.0f, r == c + 3 ? 1.0f : 0.0f);
  }
}

// Grid B T: CTA (b, t) owns rows r0 = c0 + w + 128 t .. r0 + 128 of the
// panel below the diagonal block; tile t = 0 also writes rows c0 .. c0 + w
// from column c0 on (L_kk, then zeros). CTAs run in groups of GROUP batch
// entries, tile by tile: the tiles of an entry start close together, so
// its rows c0 .. c0 + w of L, which they all read, come from device memory
// once and from L2 after. NC = 32 computes only the first
// 32 columns, for a tail panel with w <= 32.
template <bool TF32, int NC>
__global__ void __launch_bounds__(THREADS, 1)
slab_panel_kernel(const float* __restrict__ a, long long sb, long long sr,
                  float* __restrict__ out, int F, int W, int c0, int w,
                  long long batch, int tiles, const float* __restrict__ lkk,
                  const float* __restrict__ minv) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* Cs = ring + RING_FLOATS;           // [BS][LDT]: A's tile, then C
  float* Ms = ring;                         // [BS][LDT]: inv(L_kk), after
  const int tid = threadIdx.x;
  const long long g0 = blockIdx.x / (static_cast<long long>(GROUP) * tiles)
                       * GROUP;             // the group's first entry
  const int gsize = static_cast<int>(batch - g0 < GROUP ? batch - g0 : GROUP);
  const int rem = static_cast<int>(blockIdx.x - g0 * tiles);
  const int t = rem / gsize;
  const long long b = g0 + rem % gsize;
  float* ob = out + b * F * W;

  if (t == 0) {
    const float* lb = lkk + b * BS * BS;
    const int n4 = (W - c0) / 4;
    for (int e = tid; e < w * n4; e += THREADS) {
      const int r = e / n4, c = 4 * (e - (e / n4) * n4);
      f4(ob + static_cast<long long>(c0 + r) * W + c0 + c) =
          c < w ? f4(lb + r * BS + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  const int r0 = c0 + w + BS * t;
  const int nrows = min(BS, F - r0);
  if (nrows <= 0) return;
  const int K2 = (w + 7) & ~7;              // inv(L_kk)'s K, padded to 8

  const float* ab = a + b * sb + r0 * sr + c0;
  const float* mb = minv + b * BS * BS;
  auto tile_a = [&] {
    for (int e = tid; e < BS * BS / 4; e += THREADS) {
      const int r = e / (BS / 4), c = 4 * (e % (BS / 4));
      const bool valid = r < nrows && c < w;
      cp_async16(Cs + r * LDT + c, valid ? ab + r * sr + c : ab, valid);
    }
  };
  Core<TF32> core;
  core.zero();
  ring_product<TF32, NC>(core, ring, ob + static_cast<long long>(r0) * W,
                         nrows, ob + static_cast<long long>(c0) * W, w, W, 0,
                         c0, tid, tile_a);

  // inv(L_kk) into the free ring (from L2: every tile of the batch entry
  // reads it) while the update is subtracted
  for (int e = tid; e < BS * K2 / 4; e += THREADS) {
    const int r = e / (K2 / 4), c = 4 * (e % (K2 / 4));
    cp_async16(Ms + r * LDT + c, mb + r * BS + c, true);
  }
  cp_commit();
  core.each(tid, [&](int r, int c, float v) { Cs[r * LDT + c] -= v; });
  cp_wait<0>();
  __syncthreads();
  core.zero();
#pragma unroll 1
  for (int k = 0; k < K2; k += 8)
    core.template run<LDT, LDT, 8, NC>(Cs + k, Ms + k, tid);
  __syncthreads();
  core.each(tid, [&](int r, int c, float v) { Cs[r * LDT + c] = v; });
  __syncthreads();
  const int w4 = w / 4;
  for (int e = tid; e < nrows * w4; e += THREADS) {
    const int r = e / w4, c = 4 * (e - (e / w4) * w4);
    f4(ob + static_cast<long long>(r0 + r) * W + c0 + c) = f4(Cs + r * LDT + c);
  }
}

// The shared-memory limit is an attribute of each kernel on each device:
// it is raised once for every device the kernels are launched on.
// The SM count of each device is read there too, for slab_diag's split.
constexpr int MAX_DEVICES = 64;
std::atomic<bool> configured[MAX_DEVICES];
std::atomic<int> sm_count[MAX_DEVICES];

cudaError_t configure(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (configured[dev].load(std::memory_order_acquire)) {
    *sms = sm_count[dev].load(std::memory_order_relaxed);
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  sm_count[dev].store(*sms, std::memory_order_relaxed);
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(slab_diag_kernel<false>, attr,
                                  DIAG_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(slab_diag_kernel<true>, attr,
                                  DIAG_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(slab_panel_kernel<false, BS>, attr,
                                  PANEL_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(slab_panel_kernel<true, BS>, attr,
                                  PANEL_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(slab_panel_kernel<false, NARROW>, attr,
                                  PANEL_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(slab_panel_kernel<true, NARROW>, attr,
                                  PANEL_SMEM)) != cudaSuccess)
    return err;
  configured[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

bool bad_panel(int F, int W, int c0, int w) {
  return F < W || W % 4 != 0 || c0 % BS != 0 || c0 < 0 || w < 4 ||
         w > BS || w % 4 != 0 || c0 + w > W;
}

}  // namespace

// Panel k's diagonal tile: d[b] = A[b, c0:c0+w, c0:c0+w] - L L^T (the
// result's rows c0 .. c0 + w, columns :c0), identity outside w. A cluster
// of `splits` CTAs shares each batch entry's K: at most MAX_SPLITS, each
// at least one K chunk, and only until the clusters fill half the SMs (a
// wider cluster costs more in its reduction than it saves). Any size from
// 1 to MAX_SPLITS can result (3 for 20 entries on 132 SMs, 6 for 11).
extern "C" int factor_slab_diag_f32(const float* a, long long sb,
                                    long long sr, const float* out, int F,
                                    int W, int c0, int w, long long batch,
                                    float* d, int tf32, void* stream) {
  int sms = 0;
  const cudaError_t attr = configure(&sms);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (bad_panel(F, W, c0, w)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  long long splits = sms / (2 * batch);
  if (splits > MAX_SPLITS) splits = MAX_SPLITS;
  if (splits > c0 / BK) splits = c0 / BK;
  if (splits < 1) splits = 1;
  if (c0 == 0) {
    slab_diag_copy_kernel<<<static_cast<unsigned int>(batch), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(a, sb, sr, w,
                                                                 d);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(batch * splits), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = DIAG_SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned int>(splits);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err =
      tf32 ? cudaLaunchKernelEx(&cfg, slab_diag_kernel<true>, a, sb, sr, out,
                                F, W, c0, w, static_cast<int>(splits), d)
           : cudaLaunchKernelEx(&cfg, slab_diag_kernel<false>, a, sb, sr, out,
                                F, W, c0, w, static_cast<int>(splits), d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Panel k below its diagonal block, and L_kk (l) into its rows: see
// slab_panel_kernel; m holds inv(L_kk).
extern "C" int factor_slab_panel_f32(const float* a, long long sb,
                                     long long sr, float* out, int F, int W,
                                     int c0, int w, long long batch,
                                     const float* l, const float* m, int tf32,
                                     void* stream) {
  int sms = 0;
  const cudaError_t attr = configure(&sms);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (bad_panel(F, W, c0, w)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const int below = F - c0 - w;
  const int tiles = below > 0 ? (below + BS - 1) / BS : 1;
  if (batch * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(batch * tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = w <= NARROW;
  if (tf32 && narrow)
    slab_panel_kernel<true, NARROW><<<grid, THREADS, PANEL_SMEM, s>>>(
        a, sb, sr, out, F, W, c0, w, batch, tiles, l, m);
  else if (tf32)
    slab_panel_kernel<true, BS><<<grid, THREADS, PANEL_SMEM, s>>>(
        a, sb, sr, out, F, W, c0, w, batch, tiles, l, m);
  else if (narrow)
    slab_panel_kernel<false, NARROW><<<grid, THREADS, PANEL_SMEM, s>>>(
        a, sb, sr, out, F, W, c0, w, batch, tiles, l, m);
  else
    slab_panel_kernel<false, BS><<<grid, THREADS, PANEL_SMEM, s>>>(
        a, sb, sr, out, F, W, c0, w, batch, tiles, l, m);
  return static_cast<int>(cudaGetLastError());
}
