// K1: per-read energy score grids, factored internal-loop tables and band
// masks, in one pass per batch.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): energy/tables.py
// pair_mask_jw / left_pair_cum / hairpin_scores / stack_scores /
// exterior_scores / ml2_scores / mlE_scores (rows A), ops/ep_fast.py
// seq_tables (row B), and the band masks of model/joint.py _band_masks.
//
// Bound on the H100: bytes.  Each (j, w, read) cell does a few dozen
// table gathers and writes 14 outputs (about 80 bytes in f32); the
// tables (one packed buffer, about 1.7 MB in f32, mostly the 5^8 hexaloop
// keys) stay in L2.  Design: one thread per (j, w, b) cell with b the
// fastest index, so every output store is coalesced in the batch-minor
// layout the DP kernels read; sequence reads are tiny and cached.  The
// left_pair_cum running OR over w is a short in-thread loop.
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
  const int64_t* seq;  // this read's [Lp] codes
  int Lp;
  __device__ __forceinline__ int sg(int idx) const {
    idx = idx < 0 ? 0 : (idx > Lp - 1 ? Lp - 1 : idx);
    return static_cast<int>(seq[idx]);
  }
  __device__ __forceinline__ int bp(int a, int b) const {
    return c_bp[a * 5 + b];
  }
  __device__ __forceinline__ T at(int id, int k) const {
    return tab[off[id] + k];
  }
  // sum_ext_m(ii, jj, ext) (energy_param.hpp:686-708)
  __device__ T sum_ext_m(int ii, int jj, int L, bool ext) const {
    int t = bp(sg(ii), sg(jj));
    bool five_ok = ii - 1 >= 0;
    bool three_ok = jj + 1 < L;
    int five = sg(ii - 1), three = sg(jj + 1);
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

template <typename T>
__global__ void score_tables_kernel(
    ScoreDims p, const T* __restrict__ tab, const int64_t* __restrict__ seq,
    const int64_t* __restrict__ Lb, const bool* __restrict__ bp_ok,
    const int* __restrict__ dots_cum, T* hp_o, T* stk_o, T* ext_o, T* ml2_o,
    T* mlE_o, T* misA_o, T* misB_o, T* spec_o, int* tout_o, int* tin_o,
    bool* okP_o, bool* okE_o, bool* okM_o, bool* okB_o) {
  const int Lp = p.Lp, Wp = p.Wp, B = p.B, W1 = Wp + 1;
  const long long n = (long long)(Lp + 1) * W1 * B;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int b = static_cast<int>(idx % B);
  const int w = static_cast<int>((idx / B) % W1);
  const int j = static_cast<int>(idx / ((long long)B * W1));
  const int i = j - w;
  const int L = static_cast<int>(Lb[b]);
  const int W = L < p.max_span ? L : p.max_span;
  Cell<T> c{tab, p.off, seq + (long long)b * Lp, Lp};
  const long long plane = n;  // stride between planes of misA/misB/spec
  const T zero = (T)0;

  // ---- hairpin (energy_param.hpp:710-742), E(i, j): pair (i-1, j)
  T hp;
  {
    const int d = w;
    const int t = c.bp(c.sg(i - 1), c.sg(j));
    T base;
    if (d <= MAXLOOP) {
      base = c.at(T_HAIRPIN, d < 0 ? 0 : d);
    } else {
      T ratio = (T)(d > 1 ? d : 1) / (T)MAXLOOP;
      base = c.at(T_HAIRPIN, MAXLOOP) -
             c.at(T_LXC, 0) * lg(ratio) * (T)10.0 / (T)KT;
    }
    const T au = t > 2 ? c.at(T_TERM_AU, 0) : zero;
    const T mish = c.at(T_MIS_H, (t * 5 + c.sg(i)) * 5 + c.sg(j - 1));
    int key5 = 0, key6 = 0, key8 = 0, pw = 1;
    for (int k = 0; k < 8; ++k) {
      int v = c.sg(i - 1 + k) * pw;
      if (k < 5) key5 += v;
      if (k < 6) key6 += v;
      key8 += v;
      pw *= 5;
    }
    if (d == 3) {
      T tri = c.at(T_TRI, key5);
      hp = isfinite(tri) ? tri : base + au;
    } else if (d == 4) {
      T tetra = c.at(T_TETRA, key6);
      hp = isfinite(tetra) ? tetra : base + mish;
    } else if (d == 6) {
      T hexa = c.at(T_HEXA, key8);
      hp = isfinite(hexa) ? hexa : base + mish;
    } else {
      hp = d > 3 ? base + mish : base;
    }
    if (d < 1) hp = ninf<T>();
    if (p.no_ene) hp = zero;
    if (p.fix_rss) {
      const int* dc = dots_cum + (long long)b * (Lp + 1);
      int ii = i < 0 ? 0 : i;
      if (dc[j] - dc[ii] != w) hp = ninf<T>();
    }
  }

  // ---- stack, exterior and multiloop closing terms
  T stk = zero, ext = zero, ml2 = zero, mlE = zero;
  if (!p.no_ene) {
    const int t = c.bp(c.sg(i), c.sg(j - 1));
    const int t2 = c.bp(c.sg(j - 2), c.sg(i + 1));
    stk = c.at(T_STACK, t * 8 + t2);
    ext = c.sum_ext_m(i, j - 1, L, true);
    ml2 = c.sum_ext_m(i, j - 1, L, false) + c.at(T_MLINTERN, 0);
    mlE = c.sum_ext_m(j, i - 1, L, false) + c.at(T_MLCLOSING, 0) +
          c.at(T_MLINTERN, 0);
  }

  // ---- factored internal-loop tables (ops/ep_fast.py seq_tables)
  T misA[4] = {zero, zero, zero, zero}, misB[4] = {zero, zero, zero, zero};
  T spec[6] = {zero, zero, zero, zero, zero, zero};
  int t_out = 0, t_in = 0;
  if (!p.no_ene) {
    t_out = c.bp(c.sg(i - 1), c.sg(j));
    const int b_i = c.sg(i), b_jm = c.sg(j - 1);
    misA[0] = c.at(T_MIS_1N, (t_out * 5 + b_i) * 5 + b_jm);
    misA[1] = c.at(T_MIS_23, (t_out * 5 + b_i) * 5 + b_jm);
    misA[2] = c.at(T_MIS_I, (t_out * 5 + b_i) * 5 + b_jm);
    misA[3] = t_out > 2 ? c.at(T_TERM_AU, 0) : zero;
    t_in = c.bp(c.sg(j - 1), c.sg(j - w));
    const int b_l = c.sg(j), b_km = c.sg(j - w - 1);
    misB[0] = c.at(T_MIS_1N, (t_in * 5 + b_l) * 5 + b_km);
    misB[1] = c.at(T_MIS_23, (t_in * 5 + b_l) * 5 + b_km);
    misB[2] = c.at(T_MIS_I, (t_in * 5 + b_l) * 5 + b_km);
    misB[3] = t_in > 2 ? c.at(T_TERM_AU, 0) : zero;
    // t_in at cell (clip(j-joff, 0, Lp), clip(w-woff, 0, Wp))
    auto tin_at = [&](int joff, int woff) {
      int jj = j - joff, ww = w - woff;
      jj = jj < 0 ? 0 : (jj > Lp ? Lp : jj);
      ww = ww < 0 ? 0 : (ww > Wp ? Wp : ww);
      return c.bp(c.sg(jj - 1), c.sg(jj - ww));
    };
    const int b_i1 = c.sg(i + 1), b_j2 = c.sg(j - 2);
    const T bulge1 = c.at(T_BULGE, 1);
    spec[0] = bulge1 + c.at(T_STACK, t_out * 8 + tin_at(1, 1));
    spec[1] = bulge1 + c.at(T_STACK, t_out * 8 + tin_at(0, 1));
    spec[2] = c.at(T_INT11, ((t_out * 8 + tin_at(1, 2)) * 5 + b_i) * 5 + b_jm);
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

  // ---- band masks (energy_model.hpp:203-218, 289-338)
  const bool* bpb = bp_ok + (long long)b * (Lp + 1) * W1;
  const bool okP = (i >= 0) && (w > 0) && (w <= W) && bpb[j * W1 + w];
  const bool srcE = (j + 1 <= Lp) && (w + 2 <= Wp) && bpb[(j + 1) * W1 + w + 2];
  const bool okE = (i > 0) && (w + 2 <= W) && srcE;
  const int m_min = p.turn == 0 ? 4 : 2 * (2 + p.turn);
  const bool okM = (i > 0) && (j < L) && (w <= W) && (w >= m_min);
  bool lbp = false;  // left_pair_cum: any pair (i, i+w'-1), w' <= w
  if (i >= 0) {
    for (int w2 = 0; w2 <= w && !lbp; ++w2)
      lbp = (i + w2 <= Lp) && bpb[(i + w2) * W1 + w2];
  }
  const bool okB = (w <= W) && lbp;

  hp_o[idx] = hp;
  stk_o[idx] = stk;
  ext_o[idx] = ext;
  ml2_o[idx] = ml2;
  mlE_o[idx] = mlE;
  for (int g = 0; g < 4; ++g) {
    misA_o[g * plane + idx] = misA[g];
    misB_o[g * plane + idx] = misB[g];
  }
  for (int q = 0; q < 6; ++q) spec_o[q * plane + idx] = spec[q];
  tout_o[idx] = t_out;
  tin_o[idx] = t_in;
  okP_o[idx] = okP;
  okE_o[idx] = okE;
  okM_o[idx] = okM;
  okB_o[idx] = okB;
}

template <typename T>
static int launch_score_tables(ScoreDims p, const T* tab, const int64_t* seq,
                               const int64_t* L, const bool* bp_ok,
                               const int* dots_cum, T* hp, T* stk, T* ext,
                               T* ml2, T* mlE, T* misA, T* misB, T* spec,
                               int* tout, int* tin, bool* okP, bool* okE,
                               bool* okM, bool* okB, cudaStream_t stream) {
  const long long n = (long long)(p.Lp + 1) * (p.Wp + 1) * p.B;
  const int threads = 256;
  score_tables_kernel<T><<<ceil_div(n, threads), threads, 0, stream>>>(
      p, tab, seq, L, bp_ok, dots_cum, hp, stk, ext, ml2, mlE, misA, misB,
      spec, tout, tin, okP, okE, okM, okB);
  return static_cast<int>(cudaGetLastError());
}

#define SCORE_EXPORT(NAME, T)                                                \
  RNAELEM_EXPORT int NAME(ScoreDims p, const T* tab, const int64_t* seq,     \
                          const int64_t* L, const bool* bp_ok,               \
                          const int* dots_cum, T* hp, T* stk, T* ext,        \
                          T* ml2, T* mlE, T* misA, T* misB, T* spec,         \
                          int* tout, int* tin, bool* okP, bool* okE,         \
                          bool* okM, bool* okB, cudaStream_t stream) {       \
    return launch_score_tables<T>(p, tab, seq, L, bp_ok, dots_cum, hp, stk,  \
                                  ext, ml2, mlE, misA, misB, spec, tout, tin,\
                                  okP, okE, okM, okB, stream);               \
  }

SCORE_EXPORT(rnaelem_score_tables_f32, float)
SCORE_EXPORT(rnaelem_score_tables_f64, double)

RNAELEM_EXPORT const char* rnaelem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
