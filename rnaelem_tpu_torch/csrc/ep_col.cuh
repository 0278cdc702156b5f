// Shared pieces of the fused internal-loop kernels K3 (inside_ep.cu,
// forward), K6 (outside_ep.cu, adjoint) and K11 (inside_ep.cu, the CYK
// tables' max, the same chain in log space): one block owns one read and
// a range of the left gap x of column j, walks x, and forms the column's
// chain for one x at a time in shared memory:
//
//   T[dl, ar]   = sum_{p in ar} exP(j-dl, x-dl)[s1p] * exL3(dl)[s3p]
//   W_bu[dl, u1] = [dl + u1 <= C_b] (sum_g mB_bu,g(dl) * eSZg_bu[g, dl, u1]
//                  * mA_bu,g(u1) + the special of (dk = u1, dl), if any)
//   V_bu[u1, ar] = sum_dl W_bu[dl, u1] * T[dl, ar]
//
// for dl <= min(x, Cp) (the inner pair inside the band) and u1 <= min(Cp,
// Wp - x) (the outer pair inside it).  mB is emisB at the P cell (j-dl,
// x-dl), mA emisA at (j, x+u1).  The six base-coupled small loops
// (stack-adjacent bulges, 1x1/1x2/2x1/2x2) are the terms whose left gap
// dk and right gap dl are both <= 2; their target sum is T at the same x
// (tar(ci, w, ar) = T[dl][x = w - dk][ar]) and their energy the weight
// exp(lam_bu * il(ci, w)): they enter W at (dl, u1 = dk), and V then
// carries them as it carries the size classes.  The fix_rss dot gates
// sit on the flanks: the right one (bases j-dl..j-1) on exL3, the left
// one (the u1 bases before j-x) on the LL cell the caller multiplies V
// with.
//
// The range of x a block walks depends on Wp and Cp alone (kEpXSplit
// ranges of about equal work), and every sum over a read's cells runs in
// one fixed order in one block, so a read's outputs do not depend on the
// batch it came in, and two runs give the same bits.
#pragma once

#include "common.cuh"

#define TIDX(r, w, s, b) ((((long long)(r) * W1 + (w)) * S + (s)) * B + (b))

static const int kEpThreads = 256;  // K3's threads per block (one read)
static const int kEpXSplit = 4;     // blocks per read: ranges of x

struct EpIdx {  // the chain's grammar lists (int32)
  const int* p13_s1;   // [n13] inner-pair state of pairs13 entry p
  const int* p13_s3;   // [n13] right-flank state
  const int* ar_off;   // [n_ar+1] CSR of pairs13 by AR
  const int* ar_p;     // [n13]
  const int* k2_s2;    // [n2] left-flank state of K2 entry k
  const int* k2_ar;    // [n2] its AR pair
  const int* k2_bu;    // [n2] lambda bucket of its target
  const int* k2_off;   // [S+1] CSR of K2 entries by target state
  const int* k2_idx;   // [n2]
  const int* p13_ar;   // [n13] AR pair of pairs13 entry p
  const int* k2_tgt;   // [n2] target state
  const int* s1_off;   // [S+1] pairs13 by s1
  const int* s1_k;
  const int* s3_off;   // [S+1] pairs13 by s3
  const int* s3_k;
  const int* k2a_off;  // [n_ar+1] K2 entries by AR pair
  const int* k2a_k;
  const int* k2s_off;  // [S+1] K2 entries by left-flank state
  const int* k2s_k;
};

// the special small loop (ci 0-5: (dk, dl) = (0,1), (1,0), (1,1), (1,2),
// (2,1), (2,2)) of left gap dk and right gap dl, or -1
__device__ __forceinline__ int spec_ci(int dk, int dl) {
  if (dk == 0) return dl == 1 ? 0 : -1;
  if (dk == 1) return dl <= 2 ? 1 + dl : -1;
  if (dk == 2) return dl == 1 ? 4 : (dl == 2 ? 5 : -1);
  return -1;
}

// right-flank dot gate (fix_rss): bases j-dl..j-1 all unpaired
__device__ __forceinline__ bool right_dots(const int* dcum, int j, int dl,
                                           int B, int b) {
  int jl = j - dl < 0 ? 0 : j - dl;
  return dcum[(long long)j * B + b] - dcum[(long long)jl * B + b] == dl;
}

// left-flank dot gate (fix_rss): the u1 bases before row j-x all unpaired
__device__ __forceinline__ bool left_dots(const int* dcum, int j, int x,
                                          int u1, int B, int b) {
  int a = j - x < 0 ? 0 : j - x;
  int c = j - x - u1 < 0 ? 0 : j - x - u1;
  return dcum[(long long)a * B + b] - dcum[(long long)c * B + b] == u1;
}

// Work of one x (the V products and a fixed cost per step); the ranges
// cut the running sum into kEpXSplit parts of about equal work.  The
// launcher computes them on the host and hands them to every block.
static int ep_x_work(int x, int Wp, int Cp) {
  const int dmax = x < Cp ? x : Cp;
  int n = Cp + 1;
  for (int dl = 0; dl <= dmax; ++dl) {
    const int u = (Cp - dl < Wp - x ? Cp - dl : Wp - x) + 1;
    n += u > 0 ? u : 0;
  }
  return n;
}

// n ranges: range k walks x0[k]..x1[k] (empty if x1 < x0)
static void ep_split_x(int Wp, int Cp, int n, int* x0, int* x1) {
  long long tot = 0;
  for (int x = 0; x <= Wp; ++x) tot += ep_x_work(x, Wp, Cp);
  for (int k = 0; k < n; ++k) {
    x0[k] = Wp + 1;
    x1[k] = Wp;
  }
  long long cum = 0;
  for (int x = 0; x <= Wp; ++x) {
    const int k = (int)(cum * n / tot);
    if (x0[k] > x) x0[k] = x;
    x1[k] = x;
    cum += ep_x_work(x, Wp, Cp);
  }
}

struct EpXRanges {  // K3's and K6's kEpXSplit ranges
  int x0[kEpXSplit], x1[kEpXSplit];
};

static EpXRanges ep_x_ranges(int Wp, int Cp) {
  EpXRanges q;
  ep_split_x(Wp, Cp, kEpXSplit, q.x0, q.x1);
  return q;
}

// K11's ranges: their number n follows the batch (ep_max_ranges in
// inside_ep.cu), at most kEpMaxSplit.  Range k keeps its partial rows,
// widths x0[k]..min(x1[k] + Cp, Wp), from row base(k) = x0[k] + k * Cp of
// a buffer of Wp + 1 + n * Cp rows: the rows of range k never reach those
// of range k + 1.
static const int kEpMaxSplit = 16;

struct EpMaxRanges {
  int n;
  int x0[kEpMaxSplit], x1[kEpMaxSplit];
};

// triangle cells (dl, u1) with dl + u1 <= Cp, dl-major
__host__ __device__ __forceinline__ int tri_cells(int C1) {
  return C1 * (C1 + 1) / 2;
}
__host__ __device__ __forceinline__ int tri_index(int C1, int dl, int u1) {
  return dl * C1 - dl * (dl - 1) / 2 + u1;
}

// Shared-memory layouts, in elements, the same on the host (the launch's
// size) and in the kernel (its pointers); ops/kernels.py ep_smem_bytes
// mirrors the totals.  No buffer depends on Wp: what a block keeps per
// width w = x + u1 lives in a ring of C1 rows (row w at slot w % C1), since
// step x touches only the widths x..x+Cp.  K3 (all scalar type T): exP
// [C1][S], exL3 [C1][S], mAB [16][C1] (mA_bu,g rows 0-7, mB_bu,g rows
// 8-15), Tm [C1][n_ar], Wm [2][tri] (W on the triangle dl + u1 <= Cp), Vm
// [2][C1][n_ar], the ring of out rows [C1][S] (the block's partial sums),
// red [4][kEpThreads].  K6: double Am (mAB, Tm, Wm, Vm as K3's, then gW
// [2][tri], the ring of go rows [C1][S], and the block's partial sums gL3
// [C1][S], the ring of gmA rows [8][C1], gsz [8][tri], glam [2][6])
// followed by scalar exP, exL3.
struct EpFwdLayout {
  long long exP, exL3, mAB, Tm, Wm, Vm, out, red, total;
  __host__ __device__ EpFwdLayout(int S, int NA, int C1) {
    exP = 0;
    exL3 = exP + (long long)C1 * S;
    mAB = exL3 + (long long)C1 * S;
    Tm = mAB + 16LL * C1;
    Wm = Tm + (long long)C1 * NA;
    Vm = Wm + 2LL * tri_cells(C1);
    out = Vm + 2LL * C1 * NA;
    red = out + (long long)C1 * S;
    total = red + 4 * kEpThreads;
  }
};

struct EpAdjLayout {
  long long mAB, Tm, Wm, Vm, gW, go, gL3, gmA, gsz, glam, n_a;  // doubles
  long long exP, exL3, n_t;                          // scalar type
  __host__ __device__ EpAdjLayout(int S, int NA, int C1) {
    mAB = 0;
    Tm = mAB + 16LL * C1;
    Wm = Tm + (long long)C1 * NA;
    Vm = Wm + 2LL * tri_cells(C1);
    gW = Vm + 2LL * C1 * NA;
    go = gW + 2LL * tri_cells(C1);
    gL3 = go + (long long)C1 * S;
    gmA = gL3 + (long long)C1 * S;
    gsz = gmA + 8LL * C1;
    glam = gsz + 8LL * tri_cells(C1);
    n_a = glam + 12;
    exP = 0;
    exL3 = exP + (long long)C1 * S;
    n_t = exL3 + (long long)C1 * S;
  }
  __host__ __device__ long long bytes(int itemsize) const {
    return 8 * n_a + itemsize * n_t;
  }
};

// K11 (all scalar type T): L3 [C1][S] (row j, once per block), then
// kEpMaxStages stages of a step's inputs, each Pm [C1][S] (the P cells
// (j-dl, x-dl)), LBm [C1][S] (the LL cells (j-x, u1)), mAB [8][C1] (misA
// by u1 rows 0-3, misB by dl rows 4-7) and il [8] (the six specials'
// energies at width x + dk), then Tm [C1][n_ar], Wm [2][tri], Vm
// [2][C1][n_ar] and the ring of out rows [C1][S].
static const int kEpMaxStages = 2;  // K11: step x+1's inputs load during x

struct EpMaxLayout {  // stage q's Pm at Pm + q * stage, and so on
  long long L3, stage, Pm, LBm, mAB, il, Tm, Wm, Vm, out, total;
  __host__ __device__ EpMaxLayout(int S, int NA, int C1) {
    stage = 2LL * C1 * S + 8LL * C1 + 8;
    L3 = 0;
    Pm = L3 + (long long)C1 * S;
    LBm = Pm + (long long)C1 * S;
    mAB = LBm + (long long)C1 * S;
    il = mAB + 8LL * C1;
    Tm = Pm + kEpMaxStages * stage;
    Wm = Tm + (long long)C1 * NA;
    Vm = Wm + 2LL * tri_cells(C1);
    out = Vm + 2LL * C1 * NA;
    total = out + (long long)C1 * S;
  }
};

// Where a block's layout does not fit in shared memory (a wide grammar or
// a wide -c: ops/kernels.ep_plan decides on the host, from S, n_ar, Cp
// and the type), the same kernel body runs with the layout in a slice of
// a device workspace, one per block, kDev = true: the same arithmetic in
// the same order on the same addresses' values, so it gives the shared
// variant's bits; __syncthreads orders a block's device-memory accesses
// as it orders its shared ones.  Each block's slice starts on a 256-byte
// boundary.
__host__ __device__ __forceinline__ long long ep_ws_stride(long long bytes) {
  return (bytes + 255) / 256 * 256;
}

// the base of a block's layout: its workspace slice (kDev) or the dynamic
// shared memory
template <bool kDev>
__device__ __forceinline__ unsigned char* ep_base(unsigned char* smem,
                                                  unsigned char* ws,
                                                  long long bytes) {
  if constexpr (kDev)
    return ws + ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                    ep_ws_stride(bytes);
  else
    return smem;
}

// the ring slot of width x + u1 (u1 <= Cp), given xs = x % C1
__device__ __forceinline__ int ring_slot(int xs, int u1, int C1) {
  const int s = xs + u1;
  return s >= C1 ? s - C1 : s;
}

// One read's view of column j and the block's shared buffers.  T is the
// tables' type, C the type the chain is formed in (T for K3, double for
// K6).
template <typename T, typename C>
struct EpBlock {
  int S, B, W1, C1, NA, Wp, Cp, Lp, R, j, r, b, cap, ntri;
  bool fix_rss, no_ene;
  T mPF, mL3, mLB;
  T *exP, *exL3;      // [C1][S]
  const T *LL, *szg;  // LL; eSZg [2, 4, C1, C1]
  C *mAB, *Tm, *Wm, *Vm;

  __device__ void init(const DPDims& D, const int* Cb, int b_) {
    S = D.S;
    B = D.B;
    W1 = D.Wp + 1;
    C1 = D.Cp + 1;
    NA = D.n_ar;
    Wp = D.Wp;
    Cp = D.Cp;
    Lp = D.Lp;
    R = D.Lp + 1 + D.PAD;
    j = D.j;
    r = D.j + D.PAD;
    b = b_;
    cap = Cb[b] < Cp ? Cb[b] : Cp;
    fix_rss = D.fix_rss != 0;
    no_ene = D.no_ene != 0;
    ntri = tri_cells(C1);
  }
  // eSZg[q, dl, u1] (q = bucket * 4 + group)
  __device__ T sz(int q, int dl, int u1) const {
    return szg[((long long)q * C1 + dl) * C1 + u1];
  }
  __device__ C mA(int q, int u1) const { return mAB[q * C1 + u1]; }
  __device__ C mB(int q, int dl) const { return mAB[(8 + q) * C1 + dl]; }
  // W on the triangle dl + u1 <= Cp (no cell beyond it is ever live)
  __device__ C& W(int bu, int dl, int u1) const {
    return Wm[bu * ntri + tri_index(C1, dl, u1)];
  }
  __device__ C& V(int bu, int u1, int ar) const {
    return Vm[(bu * C1 + u1) * NA + ar];
  }
  // exp-space LL cell of the left flank (j-x, u1), state s
  __device__ T exB(int x, int u1, int s) const {
    return ex(LL[TIDX(r - x, u1, s, b)] - mLB);
  }
};

// exL3[dl][s] for dl <= Cp, the right-flank dot gate folded in (once per
// block: row j does not depend on x)
template <typename T, typename C>
__device__ void ep_stage_l3(const EpBlock<T, C>& k, const T* LL,
                            const int* dcum) {
  const int S = k.S, B = k.B, W1 = k.W1;
  for (int i = threadIdx.x; i < k.C1 * S; i += blockDim.x) {
    const int dl = i / S, s = i % S;
    const bool ok = !k.fix_rss || right_dots(dcum, k.j, dl, B, k.b);
    k.exL3[i] = ok ? ex(LL[TIDX(k.r, dl, s, k.b)] - k.mL3) : (T)0;
  }
}

// exP[dl][s] (P cell (j-dl, x-dl)), mB and mA of step x
template <typename T, typename C>
__device__ void ep_stage_x(const EpBlock<T, C>& k, int x, const T* P,
                           const T* emisA, const T* emisB) {
  const int S = k.S, B = k.B, W1 = k.W1, C1 = k.C1, b = k.b;
  const int dmax = x < k.Cp ? x : k.Cp;
  const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
  for (int i = threadIdx.x; i < (dmax + 1) * S; i += blockDim.x) {
    const int dl = i / S, s = i % S;
    k.exP[i] = ex(P[TIDX(k.r - dl, x - dl, s, b)] - k.mPF);
  }
  // emisB rows-leading [2, R, W1, 4, B]; emisA [2, 4, Lp+1, W1, B]
  for (int i = threadIdx.x; i < 8 * (dmax + 1); i += blockDim.x) {
    const int q = i / (dmax + 1), dl = i % (dmax + 1);
    k.mAB[(8 + q) * C1 + dl] = (C)emisB[
        ((((long long)(q >> 2) * k.R + (k.r - dl)) * W1 + (x - dl)) * 4 +
         (q & 3)) * B + b];
  }
  for (int i = threadIdx.x; i < 8 * (umax + 1); i += blockDim.x) {
    const int q = i / (umax + 1), u1 = i % (umax + 1);
    k.mAB[q * C1 + u1] = (C)emisA[
        (((long long)q * (k.Lp + 1) + k.j) * W1 + (x + u1)) * B + b];
  }
}

// T and W of step x (exP, mA, mB staged)
template <typename T, typename C>
__device__ void ep_form_tw(const EpBlock<T, C>& k, int x, const EpIdx& ix,
                           const T* spec_il, const T* lam) {
  const int S = k.S, NA = k.NA, C1 = k.C1;
  const int dmax = x < k.Cp ? x : k.Cp;
  const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
  for (int i = threadIdx.x; i < (dmax + 1) * NA; i += blockDim.x) {
    const int dl = i / NA, ar = i % NA;
    C t = (C)0;
    for (int q = ix.ar_off[ar]; q < ix.ar_off[ar + 1]; ++q) {
      const int p = ix.ar_p[q];
      t += (C)k.exP[dl * S + ix.p13_s1[p]] * (C)k.exL3[dl * S + ix.p13_s3[p]];
    }
    k.Tm[i] = t;
  }
  const int nu = umax + 1;
  for (int i = threadIdx.x; i < (dmax + 1) * nu; i += blockDim.x) {
    const int dl = i / nu, u1 = i % nu;
    if (dl + u1 > k.Cp) continue;
    C w[2] = {(C)0, (C)0};
    if (dl + u1 <= k.cap) {
      for (int bu = 0; bu < 2; ++bu)
        for (int g = 0; g < 4; ++g) {
          const int q = bu * 4 + g;
          w[bu] += k.mB(q, dl) * (C)k.sz(q, dl, u1) * k.mA(q, u1);
        }
      const int ci = k.no_ene ? -1 : spec_ci(u1, dl);
      if (ci >= 0) {
        const int W1 = k.W1;
        const T il = spec_il[(((long long)ci * (k.Lp + 1) + k.j) * W1 +
                              (x + u1)) * k.B + k.b];
        for (int bu = 0; bu < 2; ++bu) w[bu] += (C)ex(lam_mul(lam[bu], il));
      }
    }
    k.W(0, dl, u1) = w[0];
    k.W(1, dl, u1) = w[1];
  }
}

// V of step x (T and W formed)
template <typename T, typename C>
__device__ void ep_form_v(const EpBlock<T, C>& k, int x) {
  const int NA = k.NA;
  const int dmax = x < k.Cp ? x : k.Cp;
  const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
  for (int i = threadIdx.x; i < (umax + 1) * NA; i += blockDim.x) {
    const int u1 = i / NA, ar = i % NA;
    C v0 = (C)0, v1 = (C)0;
    const int dend = dmax < k.cap - u1 ? dmax : k.cap - u1;
    for (int dl = 0, t0 = u1; dl <= dend; t0 += k.C1 - dl, ++dl) {
      const C t = k.Tm[dl * NA + ar];   // t0 = tri_index(C1, dl, u1)
      v0 += k.Wm[t0] * t;
      v1 += k.Wm[k.ntri + t0] * t;
    }
    k.V(0, u1, ar) = v0;
    k.V(1, u1, ar) = v1;
  }
}

