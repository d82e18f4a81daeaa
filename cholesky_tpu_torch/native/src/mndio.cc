// Native host runtime: MatrixMarket parsing/serialization, hashed COO ingest,
// and panel assembly.
//
// TPU-native re-implementation of the reference's native layer:
//   * mmio.c (NIST MatrixMarket reader/writer, mmio.c:96,189,386)
//   * mnd.c  (separator/cluster/matrix/vector readers + open-addressing COO
//     hash ingest with uthash hash functions, mnd.c:152-199,231-271)
//   * uthash.h hash macros (HASH_SAX/HASH_FNV/HASH_JEN..., used via mnd.c)
//
// Where the reference writes directly into Legion physical regions through
// the Legion C accessor API (mnd.c:34-35), this library writes into caller-
// provided host buffers (NumPy arrays via ctypes) that JAX consumes zero-copy
// with device_put.
//
// Build: cc -O3 -shared -fPIC -o libmndio.so mndio.cc   (see build.py)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Hash functions — behavioral equivalents of the uthash macros the reference
// wraps in mnd.c:231-271. Each hashes an 8-byte little-endian key, as the
// reference does (HASH_SAX(&key, sizeof(uint64_t), hashv)).

uint64_t mnd_hash_sax(uint64_t key) {
  // uthash.h HASH_SAX: h = 0; h ^= (h<<5) + (h>>2) + byte
  uint64_t h = 0;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof(uint64_t); ++i)
    h ^= (h << 5) + (h >> 2) + p[i];
  return h;
}

uint64_t mnd_hash_fnv(uint64_t key) {
  // uthash.h HASH_FNV: h = 2166136261; h = (h * 16777619) ^ byte
  uint64_t h = 2166136261u;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof(uint64_t); ++i)
    h = (h * 16777619u) ^ p[i];
  return h;
}

uint64_t mnd_hash_ber(uint64_t key) {
  // uthash.h HASH_BER: h = 0; h = h*33 + byte
  uint64_t h = 0;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof(uint64_t); ++i)
    h = h * 33u + p[i];
  return h;
}

static inline void hash_jen_mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= (c >> 13);
  b -= c; b -= a; b ^= (a << 8);
  c -= a; c -= b; c ^= (b >> 13);
  a -= b; a -= c; a ^= (c >> 12);
  b -= c; b -= a; b ^= (a << 16);
  c -= a; c -= b; c ^= (b >> 5);
  a -= b; a -= c; a ^= (c >> 3);
  b -= c; b -= a; b ^= (a << 10);
  c -= a; c -= b; c ^= (b >> 15);
}

uint64_t mnd_hash_jen(uint64_t key) {
  // uthash.h HASH_JEN (Bob Jenkins lookup2) on the 8-byte key: golden-ratio
  // seeds, initial hashv 0xfeedbeef, tail loads bytes 0-3 into a and 4-7
  // into b, one mix; the 32-bit result is the reference's hash value
  const unsigned char* k = reinterpret_cast<const unsigned char*>(&key);
  uint32_t a = 0x9e3779b9u, b = 0x9e3779b9u, c = 0xfeedbeefu;
  c += 8u;  // keylen
  b += ((uint32_t)k[7] << 24) | ((uint32_t)k[6] << 16) |
       ((uint32_t)k[5] << 8) | (uint32_t)k[4];
  a += ((uint32_t)k[3] << 24) | ((uint32_t)k[2] << 16) |
       ((uint32_t)k[1] << 8) | (uint32_t)k[0];
  hash_jen_mix(a, b, c);
  return c;
}

uint64_t mnd_hash_sfh(uint64_t key) {
  // uthash.h HASH_SFH (Paul Hsieh SuperFastHash) on the 8-byte key:
  // initial 0xcafebabe, two 4-byte rounds (rem 0), final avalanche
  const unsigned char* k = reinterpret_cast<const unsigned char*>(&key);
  uint32_t h = 0xcafebabeu;
  for (int round = 0; round < 2; ++round, k += 4) {
    uint32_t lo = (uint32_t)k[0] | ((uint32_t)k[1] << 8);
    uint32_t hi = (uint32_t)k[2] | ((uint32_t)k[3] << 8);
    h += lo;
    uint32_t tmp = (hi << 11) ^ h;
    h = (h << 16) ^ tmp;
    h += h >> 11;
  }
  h ^= h << 3;
  h += h >> 5;
  h ^= h << 4;
  h += h >> 17;
  h ^= h << 25;
  h += h >> 6;
  return h;
}

uint64_t mnd_hash_oat(uint64_t key) {
  // uthash.h HASH_OAT (one-at-a-time)
  uint64_t h = 0;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof(uint64_t); ++i) {
    h += p[i];
    h += (h << 10);
    h ^= (h >> 6);
  }
  h += (h << 3);
  h ^= (h >> 11);
  h += (h << 15);
  return h;
}

// ---------------------------------------------------------------------------
// MatrixMarket coordinate body reader (banner/size already parsed by Python).
// Returns number of entries read, or -1 on error. Indices converted to
// 0-based (mnd.c:176-177 `i -= 1; j -= 1`).

int64_t mm_read_coo_body(const char* path, int64_t nnz, int64_t* rows,
                         int64_t* cols, double* vals) {
  FILE* fp = std::fopen(path, "r");
  if (!fp) return -1;
  char buf[4096];
  // skip banner + comments; first non-comment line is the size line
  do {
    if (!std::fgets(buf, sizeof buf, fp)) { std::fclose(fp); return -1; }
  } while (buf[0] == '%' || buf[0] == '\n' || buf[0] == '\r');
  int64_t k = 0;
  // line-bounded parse: a raw fscanf "%lg" would skip the newline of a
  // 2-column pattern row and consume the NEXT row's index as the value
  while (k < nnz && std::fgets(buf, sizeof buf, fp)) {
    if (buf[0] == '%' || buf[0] == '\n' || buf[0] == '\r') continue;
    long long i, j;
    double v = 1.0;
    int got = std::sscanf(buf, "%lld %lld %lg", &i, &j, &v);
    if (got < 2) break;
    if (got == 2) v = 1.0;  // pattern files
    rows[k] = i - 1;
    cols[k] = j - 1;
    vals[k] = v;
    ++k;
  }
  std::fclose(fp);
  return k;
}

// Coordinate writer (write_matrix parity, mmat.rg:128-144)
int64_t mm_write_coo(const char* path, const char* banner, int64_t m,
                     int64_t n, int64_t nnz, const int64_t* rows,
                     const int64_t* cols, const double* vals) {
  FILE* fp = std::fopen(path, "w");
  if (!fp) return -1;
  std::fprintf(fp, "%s\n", banner);
  std::fprintf(fp, "%lld %lld %lld\n", (long long)m, (long long)n,
               (long long)nnz);
  for (int64_t k = 0; k < nnz; ++k)
    std::fprintf(fp, "%lld %lld %.17g\n", (long long)rows[k] + 1,
                 (long long)cols[k] + 1, vals[k]);
  std::fclose(fp);
  return nnz;
}

// ---------------------------------------------------------------------------
// Open-addressing hashed COO table — exact semantics of the reference ingest
// (mnd.c:152-199): capacity = ceil(nz/0.75), slot = hash_sax(i*cols+j) % cap,
// linear probing on nonzero values; and the lookup (search, mmat.rg:502-527).

void mnd_build_hash_table(const int64_t* rows, const int64_t* cols,
                          const double* vals, int64_t nnz, uint64_t ncols,
                          int64_t capacity, int64_t* tbl_idx /* [2*cap] */,
                          double* tbl_val /* [cap] */) {
  for (int64_t k = 0; k < capacity; ++k) {
    tbl_idx[2 * k] = -1;
    tbl_idx[2 * k + 1] = -1;
    tbl_val[k] = 0.0;
  }
  for (int64_t k = 0; k < nnz; ++k) {
    uint64_t key = (uint64_t)rows[k] * ncols + (uint64_t)cols[k];
    uint64_t p = mnd_hash_sax(key) % (uint64_t)capacity;
    while (tbl_val[p] != 0.0) p = (p + 1) % (uint64_t)capacity;
    tbl_idx[2 * p] = rows[k];
    tbl_idx[2 * p + 1] = cols[k];
    tbl_val[p] = vals[k];
  }
}

double mnd_hash_lookup(const int64_t* tbl_idx, const double* tbl_val,
                       int64_t capacity, uint64_t ncols, int64_t i,
                       int64_t j) {
  uint64_t key = (uint64_t)i * ncols + (uint64_t)j;
  uint64_t p = mnd_hash_sax(key) % (uint64_t)capacity;
  if (tbl_idx[2 * p] == i && tbl_idx[2 * p + 1] == j) return tbl_val[p];
  while (tbl_val[p] != 0.0) {
    p = (p + 1) % (uint64_t)capacity;
    if (tbl_idx[2 * p] == i && tbl_idx[2 * p + 1] == j) return tbl_val[p];
  }
  return 0.0;
}

// ---------------------------------------------------------------------------
// Panel assembly: route COO entries (lower triangle, original dofs) into the
// per-level panel buffers (fill_block parity, mmat.rg:530-633, including the
// symmetric-entry swap :581-585 and the diagonal tril guard :591).
//
// panels: array of `levels` pointers; panels[L] is [2^L, H(L), S(L)] f64,
// row-major. heap(sep) = nsep - sep + 1; level = floor(log2(heap));
// slot = heap - 2^level.

static inline int ilog2_u64(uint64_t x) { return 63 - __builtin_clzll(x); }

void assemble_panels(const int64_t* rows, const int64_t* cols,
                     const double* vals, int64_t nnz, const int64_t* sep_of,
                     const int64_t* loc_of, int64_t nsep, int64_t levels,
                     const int64_t* row_off /* [levels*levels] */,
                     const int64_t* H, const int64_t* S, double** panels) {
  for (int64_t k = 0; k < nnz; ++k) {
    for (int swap = 0; swap < 2; ++swap) {
      int64_t r = swap ? cols[k] : rows[k];
      int64_t c = swap ? rows[k] : cols[k];
      if (swap && r == c) break;
      int64_t sr = sep_of[r], sc = sep_of[c];
      int64_t lr = loc_of[r], lc = loc_of[c];
      uint64_t hr = (uint64_t)(nsep - sr + 1);
      uint64_t hc = (uint64_t)(nsep - sc + 1);
      int lvl_r = ilog2_u64(hr), lvl_c = ilog2_u64(hc);
      int64_t prow;
      if (sr == sc) {
        if (lr < lc) continue;  // strict upper triangle of diag block
        prow = lr;
      } else if (lvl_r < lvl_c && (hc >> (lvl_c - lvl_r)) == hr) {
        prow = row_off[lvl_c * levels + lvl_r] + lr;
      } else {
        continue;  // non-ancestor coupling: not representable (must be 0)
      }
      int64_t slot = (int64_t)(hc - (1ull << lvl_c));
      double* p = panels[lvl_c];
      p[(slot * H[lvl_c] + prow) * S[lvl_c] + lc] = vals[k];
    }
  }
}

// ---------------------------------------------------------------------------
// Symbolic fill-analysis core — the planning-core equivalent of the
// reference's compute_filled_clusters (mmat.rg:896-1028) + merge_filled_
// clusters (mmat.rg:636-695): interval-scheduled cluster fill propagation
// over the separator tree, with per-label snapshots. This is the
// O(blocks*levels) integer planning work the reference's mapper/symbolic
// layer performs; Python precomputes the flattened tables and reconstructs
// BlockClusters from the snapshot arenas.
//
// Tree conventions (build_separator_tree, mmat.rg:835-849): separators are
// 1..nsep; heap index h holds sep nsep-h+1; level(h)=floor(log2 h);
// parent(h)=h/2. Block ids: for col separator c with tree level Lc, block
// (ancestor at depth d, c) has id base[c]+d, d=0 the diagonal (c,c).
//
// Per tree level lvl (deepest first), at interval t = max(0, levels-2-lvl):
//   * propagation (mmat.rg:944-994): for each sep s at lvl with ancestor
//     chain a_1 (parent) .. a_L (root): filled(gp,s) & filled(par,s) =>
//     filled(gp,par), with j<=i (lower triangle) when gp==par (mmat.rg:959);
//   * snapshot (mmat.rg:1000-1016): copy every live block's flags into the
//     label arena (label = levels-1-lvl);
//   * merge (mmat.rg:1020-1026): OR-coarsen flags to interval t+1's cluster
//     grid; blocks whose separators lack the interval are retired.
//
// Returns 0 on success; -1 if a separator is not fully merged to one cluster
// at its elimination interval (reference invariant, asserted in Python too);
// -2 on allocation failure.

// Interval-0 filled flags from the COO lower triangle (what fill_block
// reports per cluster, mmat.rg:614-616): route each entry — both
// orientations, mirroring the symmetric-entry swap (mmat.rg:581-585) — to
// its (row_sep, col_sep) block when col_sep is an ancestor-or-self of
// row_sep, then to the cluster cell by binary search in the separators'
// interval-0 boundary arrays.
//
// bounds0: concatenated per-sep boundary arrays; b0_off[s] its start,
// b0_len[s] its length. Arena/cur_* as in fill_analyze.

void fill_initial(
    int64_t nsep, int64_t nnz,
    const int64_t* rows, const int64_t* cols, const double* vals,
    const int64_t* sep_of, const int64_t* loc_of,   /* per dof */
    const int64_t* base, const int64_t* bounds0, const int64_t* b0_off,
    const int64_t* b0_len, uint8_t* arena, const int64_t* cur_off,
    const int64_t* cur_nc) {
  auto cluster_of = [&](int64_t s, int64_t loc) {
    const int64_t* b = bounds0 + b0_off[s];
    int64_t lo = 0, hi = b0_len[s] - 1;   // bounds has n_clusters+1 entries
    while (hi - lo > 1) {                  // find i with b[i] <= loc < b[i+1]
      int64_t mid = (lo + hi) >> 1;
      if (b[mid] <= loc) lo = mid; else hi = mid;
    }
    return lo;
  };
  for (int64_t k = 0; k < nnz; ++k) {
    if (vals[k] == 0.0) continue;
    for (int swap = 0; swap < 2; ++swap) {
      int64_t r = swap ? cols[k] : rows[k];
      int64_t c = swap ? rows[k] : cols[k];
      if (swap && r == c) break;
      int64_t sr = sep_of[r], sc = sep_of[c];
      int64_t lr = loc_of[r], lc = loc_of[c];
      uint64_t hr = (uint64_t)(nsep - sr + 1);
      uint64_t hc = (uint64_t)(nsep - sc + 1);
      int lvr = ilog2_u64(hr), lvc = ilog2_u64(hc);
      int64_t bi;
      if (sr == sc) {
        if (lr < lc) continue;            // strict upper triangle of diagonal
        bi = base[sc];
      } else if (lvr < lvc && (hc >> (lvc - lvr)) == hr) {
        // row sep is an ancestor of the col sep: block (sr, sc)
        bi = base[sc] + (lvc - lvr);
      } else {
        continue;                          // non-ancestor coupling
      }
      int64_t ri = cluster_of(sr, lr);
      int64_t ci = cluster_of(sc, lc);
      arena[cur_off[bi] + ri * cur_nc[bi] + ci] = 1;
    }
  }
}

int64_t fill_analyze(
    int64_t levels, int64_t nsep, int64_t nblocks,
    const int64_t* base,      /* [nsep+1] block base id per col separator */
    uint8_t* arena,           /* working flags, interval-0 layout */
    int64_t* cur_off,         /* [nblocks] arena offset per block */
    int64_t* cur_nr,          /* [nblocks] row clusters (updated on merge) */
    int64_t* cur_nc,          /* [nblocks] col clusters (updated on merge) */
    const int64_t* nclus,     /* [(nsep+1)*levels] clusters per (sep,t); -1 absent */
    const int64_t* merge_off, /* [(nsep+1)*levels] offset into merge_data */
    const int64_t* merge_data,/* concatenated interval boundary-index arrays */
    void** snap_arenas,       /* [levels] destination arena per label */
    const int64_t* snap_off   /* [levels*nblocks] dst offset; -1 = absent */) {
  // level of a separator via its heap index
  auto level_of = [&](int64_t s) {
    return ilog2_u64((uint64_t)(nsep - s + 1));
  };
  // block id of (row_sep=a, col_sep=c), a an ancestor of c (or a==c)
  auto blk = [&](int64_t a, int64_t c) {
    return base[c] + (level_of(c) - level_of(a));
  };

  int64_t max_blk = 0;
  for (int64_t bi = 0; bi < nblocks; ++bi) {
    int64_t sz = cur_nr[bi] * cur_nc[bi];
    if (sz > max_blk) max_blk = sz;
  }
  uint8_t* scratch = (uint8_t*)std::malloc((size_t)(max_blk > 0 ? max_blk : 1));
  if (!scratch) return -2;

  int64_t anc[64];
  for (int64_t lvl = levels - 1; lvl >= 0; --lvl) {
    int64_t t = levels - 2 - lvl;
    if (t < 0) t = 0;

    // --- propagation ---
    for (int64_t h = (int64_t)1 << lvl; h < (int64_t)2 << lvl; ++h) {
      int64_t s = nsep - h + 1;
      if (nclus[s * levels + t] != 1) { std::free(scratch); return -1; }
      int64_t na = 0;
      for (int64_t hh = h >> 1; hh >= 1; hh >>= 1) anc[na++] = nsep - hh + 1;
      for (int64_t pi = 0; pi < na; ++pi) {
        int64_t par = anc[pi];
        const uint8_t* B = arena + cur_off[blk(par, s)];   // [npar] strip
        int64_t npar = cur_nr[blk(par, s)];
        for (int64_t gi = pi; gi < na; ++gi) {
          int64_t gp = anc[gi];
          const uint8_t* A = arena + cur_off[blk(gp, s)];  // [ngp] strip
          int64_t ngp = cur_nr[blk(gp, s)];
          int64_t cb = blk(gp, par);
          uint8_t* C = arena + cur_off[cb];                // [ngp, npar]
          if (gp == par) {
            for (int64_t i = 0; i < ngp; ++i) {
              if (!A[i]) continue;
              int64_t jmax = i < npar - 1 ? i : npar - 1;  // j <= i
              for (int64_t j = 0; j <= jmax; ++j) C[i * npar + j] |= B[j];
            }
          } else {
            for (int64_t i = 0; i < ngp; ++i) {
              if (!A[i]) continue;
              for (int64_t j = 0; j < npar; ++j) C[i * npar + j] |= B[j];
            }
          }
        }
      }
    }

    // --- snapshot at label levels-1-lvl ---
    int64_t lbl = levels - 1 - lvl;
    uint8_t* dst = (uint8_t*)snap_arenas[lbl];
    const int64_t* soff = snap_off + lbl * nblocks;
    for (int64_t bi = 0; bi < nblocks; ++bi) {
      if (soff[bi] < 0 || cur_nr[bi] < 0) continue;
      std::memcpy(dst + soff[bi], arena + cur_off[bi],
                  (size_t)(cur_nr[bi] * cur_nc[bi]));
    }

    // --- merge to interval t+1 ---
    if (lvl <= levels - 2 && lvl > 0 && t + 1 < levels) {
      int64_t nt = t + 1;
      // blocks of col sep c occupy ids base[c] .. base[c]+level(c)
      for (int64_t c = 1; c <= nsep; ++c) {
        int64_t Lc = level_of(c);
        int64_t cn = nclus[c * levels + nt];
        for (int64_t d = 0; d <= Lc; ++d) {
          int64_t bi = base[c] + d;
          if (cur_nr[bi] < 0) continue;
          // row separator = ancestor of c at depth d
          int64_t hr = (int64_t)((uint64_t)(nsep - c + 1) >> d);
          int64_t rsep = nsep - hr + 1;
          int64_t rn = nclus[rsep * levels + nt];
          if (rn < 0 || cn < 0) { cur_nr[bi] = -1; continue; }
          const int64_t* rb = merge_data + merge_off[rsep * levels + nt];
          const int64_t* cbnd = merge_data + merge_off[c * levels + nt];
          int64_t onc = cur_nc[bi];
          const uint8_t* old_ = arena + cur_off[bi];
          for (int64_t R = 0; R < rn; ++R)
            for (int64_t Cc = 0; Cc < cn; ++Cc) {
              uint8_t any = 0;
              for (int64_t i = rb[R]; i < rb[R + 1] && !any; ++i)
                for (int64_t j = cbnd[Cc]; j < cbnd[Cc + 1]; ++j)
                  if (old_[i * onc + j]) { any = 1; break; }
              scratch[R * cn + Cc] = any;
            }
          std::memcpy(arena + cur_off[bi], scratch, (size_t)(rn * cn));
          cur_nr[bi] = rn;
          cur_nc[bi] = cn;
        }
      }
    }
  }
  std::free(scratch);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Nested-dissection ordering core (native mirror of symbolic/nd.py).
//
// The reference consumes orderings computed offline (SURVEY.md: ord/clust
// fixture files); the standalone path computes them from the sparsity graph.
// This is the O(E·levels)+FM integer planning core — the third native
// component SURVEY §2 prescribes ("symbolic … schedule construction …
// in the same C++ extension"). The algorithm is a STATEMENT-LEVEL mirror of
// the Python implementation (BFS level cuts from a pseudo-peripheral vertex,
// tightest-balance-window waist selection, frontier separator + trim,
// vertex-separator Fiduccia–Mattheyses with rollback, one-sided cleanup) —
// including iteration orders, heap tie-breaking by insertion sequence, and
// sorted-unique semantics — so tests can require bit-identical output
// (tests/test_nd.py::test_native_nd_matches_python). Keep both in sync.
//
// Threading (nd_order_mt): parts at one tree depth are disjoint subgraphs,
// so their splits run on a thread pool, each worker with a private stamped
// workspace. A worker reads only the shared immutable CSR, its own
// workspace, and its own part's vertex list, and writes disjoint boxes /
// sep_of slices — the output is bit-identical to the serial order for any
// thread count (tests/test_nd.py::test_native_nd_threads_identical).

namespace {

struct NdGraph {
  int64_t n;
  std::vector<int64_t> indptr, indices;
};

// Per-thread stamped workspace (_Workspace) + the split algorithm. The
// lambda bodies inside split_part are the single source of the algorithm;
// they reference the workspace fields and the two CSR aliases only.
struct NdWorker {
  const NdGraph* gp;
  std::vector<int64_t> member, lvl_val, lvl_stamp, lock_stamp;
  std::vector<int8_t> side;
  int64_t node_stamp = 0, bfs_stamp = 0, pass_stamp = 0;

  explicit NdWorker(const NdGraph& g)
      : gp(&g), member(g.n, 0), lvl_val(g.n, 0), lvl_stamp(g.n, 0),
        lock_stamp(g.n, 0), side(g.n, -1) {}

  void split_part(const std::vector<int64_t>& verts_in,
                  std::vector<int64_t>& a_out, std::vector<int64_t>& b_out,
                  std::vector<int64_t>& s_out) {
  const std::vector<int64_t>& indptr = gp->indptr;
  const std::vector<int64_t>& indices = gp->indices;

  auto bfs = [&](int64_t start) -> int64_t {
    int64_t st = ++bfs_stamp;
    lvl_val[start] = 0;
    lvl_stamp[start] = st;
    std::vector<int64_t> frontier{start}, next;
    int64_t d = 0;
    while (!frontier.empty()) {
      ++d;
      next.clear();
      for (int64_t v : frontier)
        for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
          int64_t u = indices[p];
          if (member[u] == node_stamp && lvl_stamp[u] != st) {
            lvl_stamp[u] = st;
            lvl_val[u] = d;
            next.push_back(u);
          }
        }
      frontier.swap(next);
    }
    return st;
  };

  auto far_count = [&](int64_t v, int t) -> int64_t {
    int64_t c = 0;
    for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p)
      c += (side[indices[p]] == (int8_t)(1 - t));
    return c;
  };

  struct Move { int64_t cost, seq, v; int t; };
  struct MoveGt {
    bool operator()(const Move& a, const Move& b) const {
      return a.cost != b.cost ? a.cost > b.cost : a.seq > b.seq;
    }
  };

  // FM refinement (mirror of _fm_refine; a/b/s sorted ascending in+out)
  auto fm_refine = [&](std::vector<int64_t>& a, std::vector<int64_t>& b,
                       std::vector<int64_t>& s) {
    const int rounds = 8;
    const double hi_share = 0.60;
    int64_t total = (int64_t)(a.size() + b.size() + s.size());
    if (s.empty() || total < 8) return;
    for (int64_t v : a) side[v] = 0;
    for (int64_t v : b) side[v] = 1;
    for (int64_t v : s) side[v] = 2;
    int64_t sizes[2] = {(int64_t)a.size(), (int64_t)b.size()};
    double hi = hi_share;
    double start_share = (double)std::max(sizes[0], sizes[1]) / (double)total;
    if (start_share > hi) hi = start_share;

    for (int round = 0; round < rounds; ++round) {
      std::priority_queue<Move, std::vector<Move>, MoveGt> heap;
      int64_t seq = 0;
      int64_t lk = ++pass_stamp;
      for (int64_t v : s) {
        // initial gains: cb-1 toward A (far side B), ca-1 toward B
        int64_t ca = 0, cb = 0;
        for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
          ca += (side[indices[p]] == 0);
          cb += (side[indices[p]] == 1);
        }
        heap.push({cb - 1, seq, v, 0});
        heap.push({ca - 1, seq + 1, v, 1});
        seq += 2;
      }
      struct LogEnt { int64_t v; int t; std::vector<int64_t> pulled; };
      std::vector<LogEnt> log;
      int64_t extra = 0, best_extra = 0;
      size_t best_at = 0;
      int64_t stall = 0;
      int64_t stall_cap = 2 * (int64_t)s.size() + 64;
      while (!heap.empty() && stall < stall_cap) {
        Move mv = heap.top();
        heap.pop();
        int64_t v = mv.v;
        int t = mv.t;
        if (side[v] != 2 || lock_stamp[v] == lk) continue;
        int64_t fc = far_count(v, t);
        if (mv.cost != fc - 1) { heap.push({fc - 1, seq++, v, t}); continue; }
        if ((double)(sizes[t] + 1) / (double)total > hi) continue;
        std::vector<int64_t> pulled;
        for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p)
          if (side[indices[p]] == (int8_t)(1 - t)) pulled.push_back(indices[p]);
        std::sort(pulled.begin(), pulled.end());
        pulled.erase(std::unique(pulled.begin(), pulled.end()), pulled.end());
        side[v] = (int8_t)t;
        sizes[t] += 1;
        sizes[1 - t] -= (int64_t)pulled.size();
        for (int64_t u : pulled) side[u] = 2;
        lock_stamp[v] = lk;
        log.push_back({v, t, pulled});
        extra += (int64_t)pulled.size() - 1;
        for (int64_t u : pulled) {
          for (int tt = 0; tt < 2; ++tt)
            heap.push({far_count(u, tt) - 1, seq++, u, tt});
          for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
            int64_t w = indices[p];
            if (side[w] != 2 || lock_stamp[w] == lk) continue;
            heap.push({far_count(w, t) - 1, seq++, w, t});
          }
        }
        if (extra < best_extra) {
          best_extra = extra;
          best_at = log.size();
          stall = 0;
        } else {
          ++stall;
        }
      }
      for (size_t i = log.size(); i > best_at; --i) {
        const LogEnt& le = log[i - 1];
        for (int64_t u : le.pulled) side[u] = (int8_t)(1 - le.t);
        sizes[1 - le.t] += (int64_t)le.pulled.size();
        side[le.v] = 2;
        sizes[le.t] -= 1;
      }
      std::vector<int64_t> na, nb, ns;
      auto classify = [&](const std::vector<int64_t>& vs) {
        for (int64_t v : vs) {
          if (side[v] == 0) na.push_back(v);
          else if (side[v] == 1) nb.push_back(v);
          else ns.push_back(v);
        }
      };
      classify(a); classify(b); classify(s);
      a.swap(na); b.swap(nb); s.swap(ns);
      if (best_extra >= 0) break;
    }
    // one-sided cleanup: two simultaneous sweeps (no-B-neighbor -> A against
    // current sides, then no-A-neighbor -> B against UPDATED sides)
    if (!s.empty()) {
      for (int target = 0; target < 2; ++target) {
        std::sort(s.begin(), s.end());
        std::vector<int64_t> keep, moved;
        for (int64_t v : s) {
          bool hasfar = false;
          for (int64_t p = indptr[v]; p < indptr[v + 1] && !hasfar; ++p)
            hasfar = (side[indices[p]] == (int8_t)(1 - target));
          (hasfar ? keep : moved).push_back(v);
        }
        if (!moved.empty()) {
          for (int64_t v : moved) side[v] = (int8_t)target;
          auto& dst = (target == 0) ? a : b;
          dst.insert(dst.end(), moved.begin(), moved.end());
          s.swap(keep);
        }
      }
    }
    std::sort(a.begin(), a.end());
    std::sort(b.begin(), b.end());
    std::sort(s.begin(), s.end());
    for (int64_t v : a) side[v] = -1;
    for (int64_t v : b) side[v] = -1;
    for (int64_t v : s) side[v] = -1;
  };

  // _split mirror
  auto split = [&](const std::vector<int64_t>& verts, std::vector<int64_t>& a,
                   std::vector<int64_t>& b, std::vector<int64_t>& s) {
    a.clear(); b.clear(); s.clear();
    if (verts.size() <= 1) { a = verts; return; }
    ++node_stamp;
    for (int64_t v : verts) member[v] = node_stamp;
    // pseudo-peripheral: 3 improvement hops
    int64_t v0 = verts[0];
    int64_t st = bfs(v0);
    for (int hop = 0; hop < 3; ++hop) {
      int64_t far = -1, best = -1;
      for (int64_t v : verts)
        if (lvl_stamp[v] == st && lvl_val[v] > best) { best = lvl_val[v]; far = v; }
      if (far < 0 || lvl_val[far] == 0) break;
      v0 = far;
      st = bfs(v0);
    }
    std::vector<int64_t> reach, unreach;
    for (int64_t v : verts)
      (lvl_stamp[v] == st ? reach : unreach).push_back(v);
    int64_t maxlv = 0;
    for (int64_t v : reach) maxlv = std::max(maxlv, lvl_val[v]);
    std::vector<int64_t> counts(maxlv + 1, 0);
    for (int64_t v : reach) counts[lvl_val[v]]++;
    int64_t total = (int64_t)reach.size();
    int64_t cut_level = -1;
    if (counts.size() > 1) {
      const double windows[3][2] = {{0.45, 0.55}, {0.35, 0.65}, {0.25, 0.75}};
      int64_t cum = 0;
      std::vector<double> fracs(counts.size() - 1);
      std::vector<int64_t> proxy(counts.size() - 1);
      for (size_t t = 0; t + 1 < counts.size(); ++t) {
        cum += counts[t];
        fracs[t] = (double)cum / (double)total;
        proxy[t] = std::min(counts[t], counts[t + 1]);
      }
      for (auto& w : windows) {
        int64_t bestp = -1, besti = -1;
        for (size_t t = 0; t < fracs.size(); ++t)
          if (fracs[t] >= w[0] && fracs[t] <= w[1])
            if (besti < 0 || proxy[t] < bestp) { bestp = proxy[t]; besti = (int64_t)t; }
        if (besti >= 0) { cut_level = besti + 1; break; }
      }
    }
    if (cut_level < 0) {
      // median-vertex fallback: stable sort of reach by level, take the
      // middle vertex's level (reach is ascending, sort is stable)
      std::vector<int64_t> order(reach.size());
      for (size_t i = 0; i < reach.size(); ++i) order[i] = (int64_t)i;
      std::stable_sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
        return lvl_val[reach[x]] < lvl_val[reach[y]];
      });
      size_t cut = reach.size() / 2;
      cut_level = lvl_val[reach[order[std::min(cut, reach.size() - 1)]]];
    }
    std::vector<int64_t> a_side, rest;
    for (int64_t v : reach)
      (lvl_val[v] < cut_level ? a_side : rest).push_back(v);
    if (a_side.empty()) {
      a_side.assign(reach.begin(), reach.begin() + reach.size() / 2);
      rest.assign(reach.begin() + reach.size() / 2, reach.end());
    }
    // frontier masks via side: mark a_side=0, rest=1 temporarily
    for (int64_t v : a_side) side[v] = 0;
    for (int64_t v : rest) side[v] = 1;
    auto count_front = [&](const std::vector<int64_t>& vs, int8_t tagv,
                           std::vector<uint8_t>& out) {
      out.assign(vs.size(), 0);
      int64_t c = 0;
      for (size_t i = 0; i < vs.size(); ++i) {
        for (int64_t p = indptr[vs[i]]; p < indptr[vs[i] + 1]; ++p)
          if (side[indices[p]] == tagv) { out[i] = 1; break; }
        c += out[i];
      }
      return c;
    };
    std::vector<uint8_t> front_r, front_a;
    int64_t nfr = count_front(rest, 0, front_r);
    int64_t nfa = count_front(a_side, 1, front_a);
    std::vector<int64_t> sep;
    if (nfr <= nfa) {
      for (size_t i = 0; i < rest.size(); ++i)
        (front_r[i] ? sep : b).push_back(rest[i]);
      a = a_side;
      if (!sep.empty()) {
        // trim: sep vertices with no B neighbor -> A. Reuse side: clear
        // a_side/rest marks, mark b=1, sep vertices checked against it.
        for (int64_t v : a_side) side[v] = -1;
        for (int64_t v : rest) side[v] = -1;
        for (int64_t v : b) side[v] = 1;
        std::vector<int64_t> keep;
        for (int64_t v : sep) {
          bool has = false;
          for (int64_t p = indptr[v]; p < indptr[v + 1] && !has; ++p)
            has = (side[indices[p]] == 1);
          (has ? keep : a).push_back(v);
        }
        sep.swap(keep);
        for (int64_t v : b) side[v] = -1;
      } else {
        for (int64_t v : a_side) side[v] = -1;
        for (int64_t v : rest) side[v] = -1;
      }
    } else {
      for (size_t i = 0; i < a_side.size(); ++i)
        (front_a[i] ? sep : a).push_back(a_side[i]);
      b = rest;
      if (!sep.empty()) {
        for (int64_t v : a_side) side[v] = -1;
        for (int64_t v : rest) side[v] = -1;
        for (int64_t v : a) side[v] = 0;
        std::vector<int64_t> keep;
        for (int64_t v : sep) {
          bool has = false;
          for (int64_t p = indptr[v]; p < indptr[v + 1] && !has; ++p)
            has = (side[indices[p]] == 0);
          (has ? keep : b).push_back(v);
        }
        sep.swap(keep);
        for (int64_t v : a) side[v] = -1;
      } else {
        for (int64_t v : a_side) side[v] = -1;
        for (int64_t v : rest) side[v] = -1;
      }
    }
    b.insert(b.end(), unreach.begin(), unreach.end());
    std::sort(sep.begin(), sep.end());
    s.swap(sep);
    fm_refine(a, b, s);
    std::sort(a.begin(), a.end());
    std::sort(b.begin(), b.end());
    std::sort(s.begin(), s.end());
  };

  split(verts_in, a_out, b_out, s_out);
  }  // split_part
};

}  // namespace

extern "C" {

int64_t nd_order_mt(int64_t n, int64_t nnz, const int64_t* rows,
                    const int64_t* cols, int64_t levels, int64_t* sep_of,
                    int64_t nthreads) {
  // ---- bounds check first: every value below indexes n-sized arrays
  // (returns -1; the ctypes wrapper raises — mirroring Python's IndexError)
  for (int64_t e = 0; e < nnz; ++e)
    if (rows[e] < 0 || rows[e] >= n || cols[e] < 0 || cols[e] >= n)
      return -1;
  // ---- CSR adjacency, mirroring _build_adjacency (stable sort by row of
  // [rows|cols] concatenated with [cols|rows], self loops dropped).
  NdGraph g;
  g.n = n;
  g.indptr.assign(n + 1, 0);
  int64_t m = 0;
  for (int64_t e = 0; e < nnz; ++e) m += (rows[e] != cols[e]);
  g.indices.resize(2 * m);
  for (int64_t e = 0; e < nnz; ++e)
    if (rows[e] != cols[e]) { g.indptr[rows[e] + 1]++; g.indptr[cols[e] + 1]++; }
  for (int64_t i = 0; i < n; ++i) g.indptr[i + 1] += g.indptr[i];
  {
    std::vector<int64_t> cursor(g.indptr.begin(), g.indptr.end() - 1);
    // first all (rows->cols), then all (cols->rows): matches the
    // concatenation order before numpy's stable argsort by row
    for (int64_t e = 0; e < nnz; ++e)
      if (rows[e] != cols[e]) g.indices[cursor[rows[e]]++] = cols[e];
    for (int64_t e = 0; e < nnz; ++e)
      if (rows[e] != cols[e]) g.indices[cursor[cols[e]]++] = rows[e];
  }

  // heap-ordered recursion, depth-synchronous (the serial h = 1..nsep loop
  // visits exactly depth order; parts within a depth are independent)
  int64_t nsep = ((int64_t)1 << levels) - 1;
  int64_t half = (int64_t)1 << (levels - 1);
  std::vector<std::vector<int64_t>> boxes(2 * nsep + 2);
  boxes[1].resize(n);
  for (int64_t i = 0; i < n; ++i) boxes[1][i] = i;

  if (nthreads < 1) nthreads = 1;
  std::vector<std::unique_ptr<NdWorker>> workers;
  workers.emplace_back(new NdWorker(g));

  for (int64_t h0 = 1; h0 < half; h0 <<= 1) {
    int64_t h1 = std::min(h0 << 1, half);
    int64_t total = 0;
    for (int64_t h = h0; h < h1; ++h) total += (int64_t)boxes[h].size();
    // parallelize a depth only when the work amortizes thread + workspace
    // cost (each worker's stamped arrays are 33n bytes)
    int64_t T = std::min<int64_t>(nthreads, h1 - h0);
    if (T <= 1 || total < (int64_t)1 << 16) {
      NdWorker& W = *workers[0];
      for (int64_t h = h0; h < h1; ++h) {
        std::vector<int64_t> a, b, s;
        W.split_part(boxes[h], a, b, s);
        for (int64_t v : s) sep_of[v] = h;
        boxes[2 * h].swap(a);
        boxes[2 * h + 1].swap(b);
        boxes[h].clear();
        boxes[h].shrink_to_fit();
      }
      continue;
    }
    while ((int64_t)workers.size() < T) workers.emplace_back(new NdWorker(g));
    std::atomic<int64_t> next(h0);
    auto work = [&](int64_t wi) {
      NdWorker& W = *workers[wi];
      for (;;) {
        int64_t h = next.fetch_add(1);
        if (h >= h1) break;
        std::vector<int64_t> a, b, s;
        W.split_part(boxes[h], a, b, s);
        for (int64_t v : s) sep_of[v] = h;   // disjoint across parts
        boxes[2 * h].swap(a);
        boxes[2 * h + 1].swap(b);
        boxes[h].clear();
        boxes[h].shrink_to_fit();
      }
    };
    std::vector<std::thread> pool;
    for (int64_t wi = 1; wi < T; ++wi) pool.emplace_back(work, wi);
    work(0);
    for (auto& t : pool) t.join();
  }
  for (int64_t h = half; h <= nsep; ++h)
    for (int64_t v : boxes[h]) sep_of[v] = h;
  return 0;
}

int64_t nd_order(int64_t n, int64_t nnz, const int64_t* rows,
                 const int64_t* cols, int64_t levels, int64_t* sep_of) {
  return nd_order_mt(n, nnz, rows, cols, levels, sep_of, 1);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Minimum-degree ordering (native mirror of symbolic/mdtree.min_degree_perm).
//
// The hybrid ordering generator (symbolic/nd.py method="auto") lifts a
// minimum-degree ordering to a legal binary separator tree via the
// elimination tree; this is the MD core in C++ — quotient graph
// (variables + elements), aggressive element absorption, edge pruning
// under element coverage, Amestoy-Davis-Duff approximate external degrees
// with the one-sweep |L_e \ L_p| counters, lazy heap, clique-tail cutoff.
// A STATEMENT-LEVEL mirror of the Python implementation: the (deg, v)
// heap with lazy invalidation makes pop order independent of container
// iteration order, so the output permutation is IDENTICAL
// (tests/test_mdtree.py::test_native_md_matches_python). Keep in sync.

extern "C" int64_t md_order(int64_t n, int64_t nnz, const int64_t* rows,
                            const int64_t* cols, int64_t* perm_out) {
  using std::vector;
  vector<vector<int32_t>> adj((size_t)n);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t r = rows[k], c = cols[k];
    if (r == c) continue;
    if (r < 0 || r >= n || c < 0 || c >= n) return 2;
    adj[(size_t)r].push_back((int32_t)c);
    adj[(size_t)c].push_back((int32_t)r);
  }
  for (auto& a : adj) {  // Python set semantics: unique neighbors
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
  }
  vector<vector<int32_t>> elems((size_t)n);  // element ids touching v
  vector<vector<int32_t>> evert;             // element id -> member vars
  vector<char> alive;                        // per element
  vector<int64_t> deg((size_t)n);
  typedef std::pair<int64_t, int64_t> P;     // (deg, v)
  std::priority_queue<P, vector<P>, std::greater<P>> heap;
  for (int64_t v = 0; v < n; ++v) {
    deg[(size_t)v] = (int64_t)adj[(size_t)v].size();
    heap.push({deg[(size_t)v], v});
  }
  vector<char> done((size_t)n, 0);
  vector<int32_t> lv_stamp((size_t)n, 0);
  int32_t stamp = 0;
  vector<int64_t> wval;                      // per element, stamped
  vector<int32_t> wstamp;
  vector<int32_t> Lv, touched, kept;
  int64_t remaining = n, np = 0;
  while (!heap.empty()) {
    P top = heap.top();
    heap.pop();
    int64_t d = top.first, v = top.second;
    if (done[(size_t)v] || d != deg[(size_t)v]) continue;
    if (d >= remaining - 1) {
      // clique tail: one more elimination makes everyone full
      vector<P> tail;
      for (int64_t u = 0; u < n; ++u)
        if (!done[(size_t)u]) tail.push_back({deg[(size_t)u], u});
      std::sort(tail.begin(), tail.end());
      for (auto& t : tail) perm_out[np++] = t.second;
      break;
    }
    // form element L_v = adj(v) u (union of v's live elements), minus v
    ++stamp;
    Lv.clear();
    auto add = [&](int32_t u) {
      if (!done[(size_t)u] && (int64_t)u != v &&
          lv_stamp[(size_t)u] != stamp) {
        lv_stamp[(size_t)u] = stamp;
        Lv.push_back(u);
      }
    };
    for (int32_t u : adj[(size_t)v]) add(u);
    for (int32_t e : elems[(size_t)v])
      if (alive[(size_t)e]) {
        for (int32_t u : evert[(size_t)e]) add(u);
        alive[(size_t)e] = 0;                // absorbed by the pivot
      }
    done[(size_t)v] = 1;
    --remaining;
    perm_out[np++] = v;
    // one sweep: w[e] = |L_e \ L_v| for every live element touching L_v;
    // fully covered elements (w == 0) absorb
    wval.resize(evert.size());
    wstamp.resize(evert.size(), 0);
    touched.clear();
    for (int32_t u : Lv)
      for (int32_t e : elems[(size_t)u])
        if (alive[(size_t)e]) {
          if (wstamp[(size_t)e] != stamp) {
            wstamp[(size_t)e] = stamp;
            wval[(size_t)e] = (int64_t)evert[(size_t)e].size();
            touched.push_back(e);
          }
          --wval[(size_t)e];
        }
    for (int32_t e : touched)
      if (wval[(size_t)e] <= 0) alive[(size_t)e] = 0;
    int32_t eid = (int32_t)evert.size();
    evert.push_back(Lv);
    alive.push_back(1);
    int64_t lsz = (int64_t)Lv.size();
    for (int32_t u : Lv) {
      // adj[u] \ (L_v u {v}): covered by the new element
      kept.clear();
      for (int32_t w : adj[(size_t)u])
        if ((int64_t)w != v && lv_stamp[(size_t)w] != stamp)
          kept.push_back(w);
      adj[(size_t)u].swap(kept);
      // live elements only, plus the new one
      kept.clear();
      for (int32_t e : elems[(size_t)u])
        if (alive[(size_t)e]) kept.push_back(e);
      kept.push_back(eid);
      elems[(size_t)u].swap(kept);
      int64_t ext = 0;
      for (int32_t e : elems[(size_t)u])
        if (e != eid)
          ext += (wstamp[(size_t)e] == stamp)
                     ? wval[(size_t)e]
                     : (int64_t)evert[(size_t)e].size();
      int64_t du = (int64_t)adj[(size_t)u].size() + (lsz - 1) + ext;
      if (du > remaining - 1) du = remaining - 1;
      deg[(size_t)u] = du;
      heap.push({du, (int64_t)u});
    }
  }
  return np == n ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Exact symbolic column counts of the Cholesky factor (Gilbert-Ng-Peyton
// row-subtree leaf counting, O(nnz * alpha(n))): cc[j] = nnz(L[:, j])
// including the diagonal, for the symmetric pattern given by (rows, cols)
// eliminated in NATURAL order (the caller relabels by its candidate
// permutation first). This is the ordering-selection oracle
// (symbolic/quality.fill_flops) at scales where the Python set-merge
// symbolic elimination takes minutes (172 s at n=98k random, nnz(L)=594M
// — this core answers the same query in milliseconds because it never
// materializes L's structure). Implemented from the published algorithm:
// elimination tree by ancestor path compression, postorder, first
// descendants, then per-row leaf detection (first[j] > maxfirst[i]) with
// path-compressed least-common-ancestor sets; cc = subtree sums of the
// leaf/LCA weights. Bit-parity with the Python fill_flops is asserted in
// tests/test_mdtree.py::test_native_col_counts_match_python.

extern "C" int64_t col_counts(int64_t n, int64_t nnz, const int64_t* rows,
                              const int64_t* cols, int64_t* cc) {
  using std::vector;
  if (n <= 0) return 0;
  vector<vector<int32_t>> adj((size_t)n);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t r = rows[k], c = cols[k];
    if (r == c) continue;
    if (r < 0 || r >= n || c < 0 || c >= n) return 2;
    adj[(size_t)r].push_back((int32_t)c);
    adj[(size_t)c].push_back((int32_t)r);
  }
  for (auto& a : adj) {
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
  }
  // elimination tree: walk each below-diagonal entry's partial path to the
  // current root, compressing ancestor pointers as we go
  vector<int32_t> parent((size_t)n, -1), anc((size_t)n, -1);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t k : adj[(size_t)i]) {
      if ((int64_t)k >= i) break;                      // adj sorted
      int32_t r = k;
      while (anc[(size_t)r] != -1 && anc[(size_t)r] != (int32_t)i) {
        int32_t nxt = anc[(size_t)r];
        anc[(size_t)r] = (int32_t)i;
        r = nxt;
      }
      if (anc[(size_t)r] == -1) {
        anc[(size_t)r] = (int32_t)i;
        parent[(size_t)r] = (int32_t)i;
      }
    }
  }
  // postorder (iterative; child visit order is irrelevant to the counts)
  vector<vector<int32_t>> ch((size_t)n);
  for (int64_t v = 0; v < n; ++v)
    if (parent[(size_t)v] != -1)
      ch[(size_t)parent[(size_t)v]].push_back((int32_t)v);
  vector<int32_t> post;
  post.reserve((size_t)n);
  vector<int32_t> stk;
  vector<size_t> six;
  for (int64_t rt = 0; rt < n; ++rt) {
    if (parent[(size_t)rt] != -1) continue;
    stk.push_back((int32_t)rt);
    six.push_back(0);
    while (!stk.empty()) {
      int32_t v = stk.back();
      size_t ix = six.back();
      if (ix < ch[(size_t)v].size()) {
        ++six.back();
        stk.push_back(ch[(size_t)v][ix]);
        six.push_back(0);
      } else {
        post.push_back(v);
        stk.pop_back();
        six.pop_back();
      }
    }
  }
  // first descendants + leaf-of-etree init weights
  vector<int32_t> first((size_t)n, -1);
  vector<int64_t> wt((size_t)n, 0);
  for (int64_t k = 0; k < n; ++k) {
    int32_t j = post[(size_t)k];
    wt[(size_t)j] = (first[(size_t)j] == -1) ? 1 : 0;
    int32_t q = j;
    while (q != -1 && first[(size_t)q] == -1) {
      first[(size_t)q] = (int32_t)k;
      q = parent[(size_t)q];
    }
  }
  // row-subtree leaves: for each below-diagonal entry (i, j) met in
  // postorder of j, j is a new leaf of row i's subtree iff its first
  // descendant postdates every prior leaf of that row; consecutive
  // leaves' LCA (path-compressed set find) gets the canceling -1
  vector<int32_t> maxfirst((size_t)n, -1), prevleaf((size_t)n, -1),
      sete((size_t)n);
  for (int64_t v = 0; v < n; ++v) sete[(size_t)v] = (int32_t)v;
  auto find = [&](int32_t x) {
    int32_t r = x;
    while (sete[(size_t)r] != r) r = sete[(size_t)r];
    while (sete[(size_t)x] != r) {
      int32_t nx = sete[(size_t)x];
      sete[(size_t)x] = r;
      x = nx;
    }
    return r;
  };
  for (int64_t k = 0; k < n; ++k) {
    int32_t j = post[(size_t)k];
    if (parent[(size_t)j] != -1) wt[(size_t)parent[(size_t)j]] -= 1;
    for (int32_t i : adj[(size_t)j]) {
      if ((int64_t)i <= (int64_t)j) continue;
      if (first[(size_t)j] > maxfirst[(size_t)i]) {
        maxfirst[(size_t)i] = first[(size_t)j];
        wt[(size_t)j] += 1;
        int32_t pl = prevleaf[(size_t)i];
        if (pl != -1) wt[(size_t)find(pl)] -= 1;
        prevleaf[(size_t)i] = j;
      }
    }
    if (parent[(size_t)j] != -1) sete[(size_t)j] = parent[(size_t)j];
  }
  for (int64_t k = 0; k < n; ++k) {
    int32_t j = post[(size_t)k];
    if (parent[(size_t)j] != -1)
      wt[(size_t)parent[(size_t)j]] += wt[(size_t)j];
  }
  for (int64_t v = 0; v < n; ++v) cc[(size_t)v] = wt[(size_t)v];
  return 0;
}
