// K1: per-read energy score grids, factored internal-loop tables and band
// masks, in one pass per batch.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): energy/tables.py
// pair_mask_jw / left_pair_cum / hairpin_scores / stack_scores /
// exterior_scores / ml2_scores / mlE_scores (rows A), ops/ep_fast.py
// seq_tables (row B), and the band masks of model/joint.py _band_masks.
//
// Bound on the H100: bytes.  Each (j, w, read) cell does a few dozen
// table gathers and writes 14 outputs (about 88 bytes in f32); the
// tables (one packed buffer, about 1.7 MB in f32, mostly the 5^8 hexaloop
// keys) stay in L2.  The inputs are read-major (seq [B, Lp], bp_ok [B,
// Lp+1, Wp+1], dots_cum [B, Lp+1]), the outputs batch-minor.  Design: a
// block per (band of J diagonals i = j - w, group of G reads: a row of
// the block's reads one 128-byte line of a float plane; J = 1 on the
// host plan ops/kernels.score_plan) first stages its reads' codes as
// bytes [position][read] over the window its cells read (sg()'s and
// tin_at's clamps included), the bp_ok cells of its diagonals and the
// one before (okE reads diagonal i - 1 at w + 2), batch-fastest, and
// dots_cum under fix_rss, all in shared memory.  The left_pair_cum
// running OR along diagonal i is its first pair: each staged pair of the
// block's diagonals lowers that diagonal's minimum w (a shared
// atomicMin), once per (diagonal, read), and a cell's okB is first <= w.
// Then the block's threads walk its cells, the read fastest, so that a
// warp's store is a line of one plane; the pair types sit in shared
// memory (a constant-memory table serialises a warp's different
// indices).  What holds it back (chip_smoke --k1-variants): its stores,
// then the staging of bp_ok's diagonals (a sector per row and read).
#include "common.cuh"

// float tables in one buffer, offsets in energy/tables.py FLOAT_TABLES order
enum TabId {
  T_STACK, T_HAIRPIN, T_BULGE, T_INTERNAL, T_NINIO, T_MIS_H, T_MIS_I,
  T_MIS_1N, T_MIS_23, T_MIS_M, T_MIS_E, T_DANGLE5, T_DANGLE3, T_INT11,
  T_INT21, T_INT22, T_TRI, T_TETRA, T_HEXA, T_TERM_AU, T_MLINTERN,
  T_MLCLOSING, T_LXC, T_COUNT
};

struct ScoreDims {
  int Lp, Wp, B, max_span, turn, no_ene, fix_rss;
  int off[T_COUNT];
};

// pair types: 0 none, 1 CG, 2 GC, 3 GU, 4 UG, 5 AU, 6 UA (alphabet.py BP)
__constant__ int c_bp[25] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0, 1, 0,
                             0, 0, 2, 0, 3, 0, 6, 0, 4, 0};

#define MAXLOOP 30
#define KT 616.3207755

template <typename T>
struct Cell {
  const T* tab;
  const int* off;
  const int* pt;             // the pair types c_bp, in shared memory
  const unsigned char* seq;  // this read's staged codes: position lo + k
  int Lp, lo, G;             // at seq[k * G]
  __device__ __forceinline__ int sg(int idx) const {
    idx = idx < 0 ? 0 : (idx > Lp - 1 ? Lp - 1 : idx);
    return seq[(idx - lo) * G];
  }
  // the little-endian base-5 key of n codes from position start
  __device__ __forceinline__ int key(int start, int n) const {
    int k = 0, pw = 1;
    for (int m = 0; m < n; ++m) {
      k += sg(start + m) * pw;
      pw *= 5;
    }
    return k;
  }
  __device__ __forceinline__ int bp(int a, int b) const {
    return pt[a * 5 + b];
  }
  __device__ __forceinline__ T at(int id, int k) const {
    return tab[off[id] + k];
  }
  // sum_ext_m(ii, jj, ext) (energy_param.hpp:686-708) for the pair type
  // t = bp(sg(ii), sg(jj)), five = sg(ii - 1) (ii - 1 >= 0: five_ok) and
  // three = sg(jj + 1) (jj + 1 < L: three_ok)
  __device__ __forceinline__ T sum_ext_m(int t, int five, int three,
                                         bool five_ok, bool three_ok,
                                         bool ext) const {
    T z;
    if (five_ok && three_ok) {
      z = at(ext ? T_MIS_E : T_MIS_M, (t * 5 + five) * 5 + three);
    } else {
      T d5 = five_ok ? at(T_DANGLE5, t * 5 + five) : (T)0;
      T d3 = three_ok ? at(T_DANGLE3, t * 5 + three) : (T)0;
      z = d5 + d3;
    }
    return z + (t > 2 ? at(T_TERM_AU, 0) : (T)0);
  }
};

static const int kScoreThreads = 256;

// K1's layout (ops/kernels.score_plan): G reads a block (2^lgG), J
// diagonals a block with J + 1 = 2^lgDJ (the staging's lanes along a
// row of bp_ok), ``bands`` x ``groups`` blocks, ``smem`` bytes
struct ScoreGrid {
  int G, lgG, J, lgDJ, bands, groups, smem;
};

static __host__ __device__ __forceinline__ int clampi(int x, int a, int b) {
  return x < a ? a : (x > b ? b : x);
}

// the shared layout of a block: ints first, then bytes
static __host__ __device__ __forceinline__ long long score_smem(int Wp, int G,
                                                                int J) {
  return 4LL * G * (J + (J + Wp)) + (long long)G * (J + Wp + 4) +
         (long long)(J + 1) * (Wp + 1) * G;
}

// the outputs' stores, streaming (evict first): the DP kernels read them
// later, and the table gathers keep L2 (chip_smoke --k1-variants)
template <typename T>
__device__ __forceinline__ void put(T* p, T v) {
  __stcs(p, v);
}
__device__ __forceinline__ void put(bool* p, bool v) {
  __stcs(reinterpret_cast<unsigned char*>(p), static_cast<unsigned char>(v));
}

// 5 blocks of kScoreThreads an SM (48 registers a thread): the grid is
// one wave at the main shape
template <typename T>
__global__ void __launch_bounds__(kScoreThreads, 5) score_tables_kernel(
    ScoreDims p, ScoreGrid gr, const T* __restrict__ tab,
    const int64_t* __restrict__ seq, const int64_t* __restrict__ Lb,
    const bool* __restrict__ bp_ok, const int* __restrict__ dots_cum,
    T* __restrict__ hp_o, T* __restrict__ stk_o, T* __restrict__ ext_o,
    T* __restrict__ ml2_o, T* __restrict__ mlE_o, T* __restrict__ misA_o,
    T* __restrict__ misB_o, T* __restrict__ spec_o, int* __restrict__ tout_o,
    int* __restrict__ tin_o, bool* __restrict__ okP_o,
    bool* __restrict__ okE_o, bool* __restrict__ okM_o,
    bool* __restrict__ okB_o) {
  extern __shared__ int smem[];
  __shared__ int s_pt[25];
  const int Lp = p.Lp, Wp = p.Wp, B = p.B, W1 = Wp + 1;
  const int G = gr.G, lgG = gr.lgG, J = gr.J, DJ = 1 << gr.lgDJ;
  const int t = threadIdx.x;
  const int i0 = -Wp + (int)blockIdx.x * J;  // the block's diagonals
  const int bb = (int)blockIdx.y * G;        // its first read
  int* s_first = smem;                  // [J][G] first pair on diagonal
  int* s_dc = s_first + J * G;          // [J + Wp][G] dots_cum, dlo..dhi
  unsigned char* s_seq =
      reinterpret_cast<unsigned char*>(s_dc + (J + Wp) * G);  // lo..hi
  unsigned char* s_bp = s_seq + (J + Wp + 4) * G;  // [J + 1][W1][G]
  // the window of positions the cells read once clamped (sg(): i - 3 at
  // w = 0 through tin_at(2, 3), up to j + 1 = i + 1 at w = 0 and j), and
  // of dots_cum (max(i, 0) .. j)
  const int lo = clampi(i0 - 3, 0, Lp - 1);
  const int hi = clampi(i0 + J + Wp, 0, Lp - 1);
  const int dlo = clampi(i0, 0, Lp), dhi = clampi(i0 + J - 1 + Wp, 0, Lp);

  if (t < 25) s_pt[t] = c_bp[t];
  for (int e = t; e < J * G; e += kScoreThreads) s_first[e] = W1;
  for (int e = t; e < ((hi - lo + 1) << lgG); e += kScoreThreads) {
    const int g = e & (G - 1), b = bb + g;
    s_seq[e] = b < B ? static_cast<unsigned char>(
                           seq[(long long)b * Lp + lo + (e >> lgG)])
                     : 0;
  }
  if (p.fix_rss) {
    for (int e = t; e < ((dhi - dlo + 1) << lgG); e += kScoreThreads) {
      const int g = e & (G - 1), b = bb + g;
      s_dc[e] = b < B ? dots_cum[(long long)b * (Lp + 1) + dlo + (e >> lgG)]
                      : 0;
    }
  }
  __syncthreads();
  // bp_ok's cells on diagonals i0 - 1 + o, o = 0..J: row rr of the rows
  // i0 - 1 .. i0 + J + Wp - 1 holds them at w = rr - o (J + 1 neighbouring
  // bytes of the read's row, lanes o); a pair on a block diagonal lowers
  // its first pair
  const int nrow = J + Wp + 1;
  for (int e = t; e < (nrow << (gr.lgDJ + lgG)); e += kScoreThreads) {
    const int o = e & (DJ - 1);
    const int g = (e >> gr.lgDJ) & (G - 1), rr = e >> (gr.lgDJ + lgG);
    const int w = rr - o, r = i0 - 1 + rr, b = bb + g;
    if (o > J || w < 0 || w > Wp) continue;
    const bool v = b < B && r >= 0 && r <= Lp &&
                   bp_ok[((long long)b * (Lp + 1) + r) * W1 + w];
    s_bp[(o * W1 + w) * G + g] = v;
    if (v && o > 0) atomicMin(&s_first[(o - 1) * G + g], w);
  }
  __syncthreads();

  // thread: read g of the group, cells (o, w) in turn
  const int g = t & (G - 1), b = bb + g;
  if (b >= B) return;
  const int L = static_cast<int>(Lb[b]);
  const int W = L < p.max_span ? L : p.max_span;
  Cell<T> c{tab, p.off, s_pt, s_seq + g, Lp, lo, G};
  const int* dcg = s_dc + g;
  const unsigned char* bpg = s_bp + g;
  const long long plane = (long long)(Lp + 1) * W1 * B;  // misA/misB/spec
  const T zero = (T)0;
  const int m_min = p.turn == 0 ? 4 : 2 * (2 + p.turn);
  const int step = kScoreThreads >> lgG;  // cells (o, w) walked at once
  int q = t >> lgG;
  int o = q / W1, w = q - o * W1;
  for (; o < J; w += step) {
    while (w >= W1) {
      w -= W1;
      ++o;
    }
    if (o >= J) break;
    const int i = i0 + o, j = i + w;
    if (j < 0 || j > Lp) continue;
    const long long idx = ((long long)j * W1 + w) * B + b;
    // the codes around the pair (sg(): clamped to 0..Lp-1; j - w = i)
    const int s_im1 = c.sg(i - 1), s_i = c.sg(i), s_ip1 = c.sg(i + 1);
    const int s_jm2 = c.sg(j - 2), s_jm1 = c.sg(j - 1), s_j = c.sg(j);

    // ---- hairpin (energy_param.hpp:710-742), E(i, j): pair (i-1, j)
    T hp;
    {
      const int d = w;
      const int t_ = c.bp(s_im1, s_j);
      T base;
      if (d <= MAXLOOP) {
        base = c.at(T_HAIRPIN, d < 0 ? 0 : d);
      } else {
        T ratio = (T)(d > 1 ? d : 1) / (T)MAXLOOP;
        base = c.at(T_HAIRPIN, MAXLOOP) -
               c.at(T_LXC, 0) * lg(ratio) * (T)10.0 / (T)KT;
      }
      const T au = t_ > 2 ? c.at(T_TERM_AU, 0) : zero;
      const T mish = c.at(T_MIS_H, (t_ * 5 + s_i) * 5 + s_jm1);
      // the loop's window i-1 .. j as a key (d + 2 codes)
      if (d == 3) {
        T tri = c.at(T_TRI, c.key(i - 1, 5));
        hp = isfinite(tri) ? tri : base + au;
      } else if (d == 4) {
        T tetra = c.at(T_TETRA, c.key(i - 1, 6));
        hp = isfinite(tetra) ? tetra : base + mish;
      } else if (d == 6) {
        T hexa = c.at(T_HEXA, c.key(i - 1, 8));
        hp = isfinite(hexa) ? hexa : base + mish;
      } else {
        hp = d > 3 ? base + mish : base;
      }
      if (d < 1) hp = ninf<T>();
      if (p.no_ene) hp = zero;
      if (p.fix_rss) {
        int ii = i < 0 ? 0 : i;
        if (dcg[(j - dlo) * G] - dcg[(ii - dlo) * G] != w) hp = ninf<T>();
      }
    }

    // ---- stack, exterior and multiloop closing terms
    T stk = zero, ext = zero, ml2 = zero, mlE = zero;
    if (!p.no_ene) {
      const int t_ = c.bp(s_i, s_jm1);
      const int t2 = c.bp(s_jm2, s_ip1);
      stk = c.at(T_STACK, t_ * 8 + t2);
      // sum_ext_m(i, j - 1, .) and sum_ext_m(j, i - 1, .)
      ext = c.sum_ext_m(t_, s_im1, s_j, i - 1 >= 0, j < L, true);
      ml2 = c.sum_ext_m(t_, s_im1, s_j, i - 1 >= 0, j < L, false) +
            c.at(T_MLINTERN, 0);
      mlE = c.sum_ext_m(c.bp(s_j, s_im1), s_jm1, s_i, j - 1 >= 0, i < L,
                        false) +
            c.at(T_MLCLOSING, 0) + c.at(T_MLINTERN, 0);
    }

    // ---- factored internal-loop tables (ops/ep_fast.py seq_tables)
    T misA[4] = {zero, zero, zero, zero}, misB[4] = {zero, zero, zero, zero};
    T spec[6] = {zero, zero, zero, zero, zero, zero};
    int t_out = 0, t_in = 0;
    if (!p.no_ene) {
      t_out = c.bp(s_im1, s_j);
      const int b_i = s_i, b_jm = s_jm1;
      misA[0] = c.at(T_MIS_1N, (t_out * 5 + b_i) * 5 + b_jm);
      misA[1] = c.at(T_MIS_23, (t_out * 5 + b_i) * 5 + b_jm);
      misA[2] = c.at(T_MIS_I, (t_out * 5 + b_i) * 5 + b_jm);
      misA[3] = t_out > 2 ? c.at(T_TERM_AU, 0) : zero;
      t_in = c.bp(s_jm1, s_i);
      const int b_l = s_j, b_km = s_im1;
      misB[0] = c.at(T_MIS_1N, (t_in * 5 + b_l) * 5 + b_km);
      misB[1] = c.at(T_MIS_23, (t_in * 5 + b_l) * 5 + b_km);
      misB[2] = c.at(T_MIS_I, (t_in * 5 + b_l) * 5 + b_km);
      misB[3] = t_in > 2 ? c.at(T_TERM_AU, 0) : zero;
      // t_in at cell (clip(j-joff, 0, Lp), clip(w-woff, 0, Wp))
      auto tin_at = [&](int joff, int woff) {
        const int jj = clampi(j - joff, 0, Lp), ww = clampi(w - woff, 0, Wp);
        return c.bp(c.sg(jj - 1), c.sg(jj - ww));
      };
      const int b_i1 = s_ip1, b_j2 = s_jm2;
      const T bulge1 = c.at(T_BULGE, 1);
      spec[0] = bulge1 + c.at(T_STACK, t_out * 8 + tin_at(1, 1));
      spec[1] = bulge1 + c.at(T_STACK, t_out * 8 + tin_at(0, 1));
      spec[2] =
          c.at(T_INT11, ((t_out * 8 + tin_at(1, 2)) * 5 + b_i) * 5 + b_jm);
      spec[3] = c.at(T_INT21,
                     (((t_out * 8 + tin_at(2, 3)) * 5 + b_i) * 5 + b_j2) * 5 +
                         b_jm);
      spec[4] = c.at(T_INT21,
                     (((tin_at(1, 3) * 8 + t_out) * 5 + b_jm) * 5 + b_i) * 5 +
                         b_i1);
      spec[5] = c.at(T_INT22,
                     ((((t_out * 8 + tin_at(2, 4)) * 5 + b_i) * 5 + b_i1) * 5 +
                      b_j2) * 5 + b_jm);
    }

    // ---- band masks (energy_model.hpp:203-218, 289-338): okP is cell
    // (j, w) of diagonal i, okE's pair cell (j + 1, w + 2) is on diagonal
    // i - 1, okB = left_pair_cum: a pair (i, i + w' - 1), w' <= w
    const bool okP =
        (i >= 0) && (w > 0) && (w <= W) && bpg[((o + 1) * W1 + w) * G];
    const bool srcE =
        (j + 1 <= Lp) && (w + 2 <= Wp) && bpg[(o * W1 + w + 2) * G];
    const bool okE = (i > 0) && (w + 2 <= W) && srcE;
    const bool okM = (i > 0) && (j < L) && (w <= W) && (w >= m_min);
    const bool okB = (w <= W) && (i >= 0) && s_first[o * G + g] <= w;

    put(hp_o + idx, hp);
    put(stk_o + idx, stk);
    put(ext_o + idx, ext);
    put(ml2_o + idx, ml2);
    put(mlE_o + idx, mlE);
    for (int k = 0; k < 4; ++k) {
      put(misA_o + k * plane + idx, misA[k]);
      put(misB_o + k * plane + idx, misB[k]);
    }
    for (int k = 0; k < 6; ++k) put(spec_o + k * plane + idx, spec[k]);
    put(tout_o + idx, t_out);
    put(tin_o + idx, t_in);
    put(okP_o + idx, okP);
    put(okE_o + idx, okE);
    put(okM_o + idx, okM);
    put(okB_o + idx, okB);
  }
}

// K1 on the host plan's layout (ops/kernels.score_plan), refused unless
// it is the kernel's
template <typename T>
static int launch_score_tables(ScoreDims p, ScoreGrid gr, const T* tab,
                               const int64_t* seq, const int64_t* L,
                               const bool* bp_ok, const int* dots_cum, T* hp,
                               T* stk, T* ext, T* ml2, T* mlE, T* misA,
                               T* misB, T* spec, int* tout, int* tin,
                               bool* okP, bool* okE, bool* okM, bool* okB,
                               cudaStream_t stream) {
  const int bands = (p.Lp + p.Wp + 1 + gr.J - 1) / gr.J;
  const bool ok = p.Lp > 0 && p.Wp >= 0 && gr.lgG >= 0 && gr.lgG <= 5 &&
                  gr.G == (1 << gr.lgG) && gr.lgDJ >= 1 && gr.lgDJ <= 5 &&
                  gr.J == (1 << gr.lgDJ) - 1 && gr.bands == bands &&
                  gr.groups == (p.B + gr.G - 1) / gr.G &&
                  gr.groups <= 65535 &&
                  gr.smem == score_smem(p.Wp, gr.G, gr.J);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = score_tables_kernel<T>;
  const int rc = allow_smem((const void*)kern, gr.smem);
  if (rc != 0) return rc;
  kern<<<dim3(gr.bands, gr.groups), kScoreThreads, gr.smem, stream>>>(
      p, gr, tab, seq, L, bp_ok, dots_cum, hp, stk, ext, ml2, mlE, misA,
      misB, spec, tout, tin, okP, okE, okM, okB);
  return static_cast<int>(cudaGetLastError());
}

#define SCORE_EXPORT(NAME, T)                                                \
  RNAELEM_EXPORT int NAME(ScoreDims p, ScoreGrid gr, const T* tab,           \
                          const int64_t* seq, const int64_t* L,              \
                          const bool* bp_ok, const int* dots_cum, T* hp,     \
                          T* stk, T* ext, T* ml2, T* mlE, T* misA, T* misB,  \
                          T* spec, int* tout, int* tin, bool* okP,           \
                          bool* okE, bool* okM, bool* okB,                   \
                          cudaStream_t stream) {                             \
    return launch_score_tables<T>(p, gr, tab, seq, L, bp_ok, dots_cum, hp,  \
                                  stk, ext, ml2, mlE, misA, misB, spec,      \
                                  tout, tin, okP, okE, okM, okB, stream);    \
  }

SCORE_EXPORT(rnaelem_score_tables_f32, float)
SCORE_EXPORT(rnaelem_score_tables_f64, double)

RNAELEM_EXPORT const char* rnaelem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
