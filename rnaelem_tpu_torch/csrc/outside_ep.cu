// K6: the adjoint of K3 for one column j: the TT_E_P internal-loop sum
// and the six base-coupled small loops, sent back to the P rows j..j-Cp,
// the LL rows j..j-Wp (widths <= Cp), the hoisted mismatch and size
// weights (emisA, emisB, eSZg) and lambda's small-loop term.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp program): the ep_col /
// _ep_specials part of ops/dp.py dp_bwd, the custom VJP of dp_parts (row H
// of the kernel table, ops/dp.py:788-946, reverse of ops/dp.py:477-599).
//
// Bound on the H100: bytes.  It reads what K3 reads (the P and LL band
// triangles under each read's cap, the mismatch weights, eSZg) plus the
// cotangents of the same cells, and writes those cotangents: about twice
// K3's traffic (chip_smoke.py counts it for its batch).  Its arithmetic is
// K3's largest cost mirrored: the V contraction's adjoint gives both the
// T cotangent (sum over u1 of gV * W) and the W cotangent (sum over AR of
// gV * T), about twice K3's operations.  Design: K3's forward T and V for
// the column are recomputed first (K3's ep_shift, ep_t, ep_v); the chain
// then runs in reverse: ep_go turns the ep cotangent into exp space (go =
// g_ep / out) and takes lambda's small-loop term; ep_gv gives each
// (x, u1, read) the V cotangent of its cells and the left flank's LL
// cotangent (K2 stage and specials); ep_gtw gives each (dl, x, read) the
// T cotangent and the W cotangent (AR accumulators in registers, as
// ep_v); ep_gmb, ep_gma and ep_gsz spread the W cotangent over emisB (per
// (dl, v, read)), emisA (per (slot, w, read)) and the size weights (per (dl,
// u1, read) partials, summed over reads later); ep_gp and ep_gl3 give the
// inner pair's P cotangent and the right flank's LL cotangent.  Gather
// form, read fastest, one owner per cotangent cell: no atomics.  The
// hazards of K3 are kept: the cap dl + u1 <= C, x + u1 <= Wp, the
// specials' dk + dl <= C and the fix_rss dot gating of both flanks.
//
// Range: go = g_ep / out reaches 1 / FLT_MIN (~1e38) for an output near
// the bottom of f32's range, and a partial product such as go * W can
// then overflow f32 although the whole share (go * term, term <= out)
// is at most g_ep.  So the chain's scratch (go, gV, gT, gW) is double at
// either input type, every share that ends in a cotangent multiplies its
// term out before go, and an output below the least normal number sends
// nothing, as the plain version's safe_log clamp does.
#include "outside.cuh"

#include <cfloat>

#define AR_CHUNK 16

static const int kLanes = 8;    // warps per block splitting a loop (ep_gl3)
static const int kZLanes = 8;   // grid-z cells per block (ep_gp)

typedef double A;  // the chain's scratch type

template <typename T>
__device__ __forceinline__ T least_normal();
template <>
__device__ __forceinline__ float least_normal<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double least_normal<double>() { return DBL_MIN; }

__constant__ int kSpecDk[6] = {0, 1, 1, 1, 2, 2};
__constant__ int kSpecDl[6] = {1, 0, 1, 2, 1, 2};

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

template <typename T>
struct EpCtx {  // one read's view of column j
  DPDims D;
  const int *ar_off, *ar_p, *p13_s1, *p13_s3;  // pairs13 by AR (K3's lists)
  const T *P, *LL, *spec_il, *lam;
  const int *dcum, *Cb;
  int b, r, W1;
  T mPF, mL3, mLB;

  __device__ T exP(int dl, int v, int s) const {
    const int S = D.S, B = D.B;
    return ex(P[TIDX(r - dl, v, s, b)] - mPF);
  }
  __device__ T exL3(int dl, int s) const {
    const int S = D.S, B = D.B;
    return ex(LL[TIDX(r, dl, s, b)] - mL3);
  }
  __device__ T exB(int x, int u1, int s) const {
    const int S = D.S, B = D.B;
    return ex(LL[TIDX(r - x, u1, s, b)] - mLB);
  }
  // special ci applies at width w for this read
  __device__ bool spec_ok(int ci, int w) const {
    const int dk = kSpecDk[ci], dl = kSpecDl[ci];
    if (D.no_ene || dk + dl > Cb[b] || w < dk + dl || w > D.Wp) return false;
    return !D.fix_rss || (left_dots(dcum, D.j, w - dk, dk, D.B, b) &&
                          right_dots(dcum, D.j, dl, D.B, b));
  }
  // tar(ci, w, ar) = sum_{p in ar} P(j-dl, w-dk-dl)[s1p] * L3(dl)[s3p]
  __device__ T tar(int ci, int w, int ar) const {
    const int dk = kSpecDk[ci], dl = kSpecDl[ci];
    T t = (T)0;
    for (int q = ar_off[ar]; q < ar_off[ar + 1]; ++q) {
      const int p = ar_p[q];
      t += exP(dl, w - dk - dl, p13_s1[p]) * exL3(dl, p13_s3[p]);
    }
    return t;
  }
  __device__ T il(int ci, int w) const {
    return spec_il[(((long long)ci * (D.Lp + 1) + D.j) * W1 + w) * D.B + b];
  }
  __device__ T eil(int bu, int ci, int w) const {
    return ex(lam_mul(lam[bu], il(ci, w)));
  }
};

template <typename T>
__device__ __forceinline__ EpCtx<T> make_ctx(
    const DPDims& D, const AdjIdx& ix, const T* P, const T* LL,
    const T* shift, const T* spec_il, const T* lam, const int* dcum,
    const int* Cb, int b) {
  EpCtx<T> c;
  c.D = D;
  c.ar_off = ix.ar_off;
  c.ar_p = ix.ar_p;
  c.p13_s1 = ix.p13_s1;
  c.p13_s3 = ix.p13_s3;
  c.P = P;
  c.LL = LL;
  c.spec_il = spec_il;
  c.lam = lam;
  c.dcum = dcum;
  c.Cb = Cb;
  c.b = b;
  c.r = D.j + D.PAD;
  c.W1 = D.Wp + 1;
  c.mPF = finite_or_zero(shift[b]);
  c.mL3 = finite_or_zero(shift[D.B + b]);
  c.mLB = finite_or_zero(shift[2 * D.B + b]);
  return c;
}

#define EP_CTX_ARGS(T)                                                     \
  const T *P, const T *LL, const T *shift, const T *spec_il, const T *lam, \
      const int *dcum, const int *Cb
#define EP_CTX(b) make_ctx<T>(D, ix, P, LL, shift, spec_il, lam, dcum, Cb, b)

// ---- go = g_ep / out (exp space); lambda's small-loop term
template <typename T>
__global__ void ep_go_kernel(DPDims D, AdjIdx ix, EP_CTX_ARGS(T), const T* EP,
                             const T* gEP, A* GO, T* DL) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j;
  const long long n = (long long)W1 * S * B;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int b = idx % B, t = (idx / B) % S, w = idx / ((long long)B * S);
  const EpCtx<T> c = EP_CTX(b);
  const T g = gEP[idx], v = EP[TIDX(c.r, w, t, b)];
  A go = 0;
  if (g != (T)0 && v > ninf<T>()) {
    const T out = ex(v - (c.mPF + c.mL3 + c.mLB));
    if (out >= least_normal<T>()) go = (A)g / (A)out;
  }
  GO[idx] = go;
  if (go == 0 || D.no_ene) return;
  A acc = 0;
  for (int kk = ix.k2_off[t]; kk < ix.k2_off[t + 1]; ++kk) {
    const int k = ix.k2_idx[kk];
    const int s2 = ix.k2_s2[k], ar = ix.k2_ar[k], bu = ix.k2_bu[k];
    for (int ci = 0; ci < 6; ++ci) {
      if (!c.spec_ok(ci, w)) continue;
      const T il = c.il(ci, w);
      if (!(il > ninf<T>())) continue;
      const int dk = kSpecDk[ci];
      acc += (A)c.exB(w - dk, dk, s2) * c.tar(ci, w, ar) * c.eil(bu, ci, w) *
             il;
    }
  }
  DL[TIDX(j, w, t, b)] += (T)(go * acc);
}

// ---- per (x, u1, read): the V cotangent gV[bu][x][u1][ar] and the left
// flank's LL cotangent at (j - x, u1) (K2 stage and specials)
template <typename T>
__global__ void ep_gv_kernel(DPDims D, AdjIdx ix, EP_CTX_ARGS(T), const T* Vb,
                             const A* GO, A* gV, T* gLL) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1, n_ar = D.n_ar;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int u1 = blockIdx.y, x = blockIdx.z;
  if (b >= B) return;
  auto vidx = [&](int bu, int ar) {
    return ((((long long)bu * W1 + x) * C1 + u1) * n_ar + ar) * B + b;
  };
  for (int q = 0; q < 2 * n_ar; ++q) gV[vidx(q / n_ar, q % n_ar)] = 0;
  const int w = x + u1;
  if (w > D.Wp) return;
  const EpCtx<T> c = EP_CTX(b);
  if (D.fix_rss && !left_dots(dcum, D.j, x, u1, B, b)) return;
  for (int k = 0; k < D.n2; ++k) {
    const int t = ix.k2_tgt[k];
    const A go = GO[((long long)w * S + t) * B + b];
    if (go == 0) continue;
    const int s2 = ix.k2_s2[k], ar = ix.k2_ar[k], bu = ix.k2_bu[k];
    const A e = c.exB(x, u1, s2);
    if (e == 0) continue;
    gV[vidx(bu, ar)] += go * e;
    // the terms of out[w, t] that hold this LL cell
    A term = (A)Vb[vidx(bu, ar)];
    if (u1 <= 2 && !D.no_ene)
      for (int ci = 0; ci < 6; ++ci)
        if (kSpecDk[ci] == u1 && c.spec_ok(ci, w))
          term += (A)c.tar(ci, w, ar) * c.eil(bu, ci, w);
    gLL[TIDX(c.r - x, u1, s2, b)] += (T)(go * (term * e));
  }
}

// ---- per (dl, x, read): gT[dl][x][ar] = sum_{bu,u1} gV * W and
// gW[bu][dl][x][u1] = sum_ar gV * T, W recomputed as in ep_v.  Every dl
// reads the same gV cells of its (x, reads): dl is the fastest grid
// index, so the blocks that share them run together and find them in L2.
template <typename T>
__global__ void ep_gtw_kernel(DPDims D, const T* Tb, const A* gV,
                              const T* emisA, const T* emisB, const T* eSZg,
                              const int* Cb, A* gT, A* gW) {
  const int B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1, n_ar = D.n_ar;
  const int Lp = D.Lp, R = D.Lp + 1 + D.PAD;
  const int b = blockIdx.y * 32 + threadIdx.x;
  const int dl = blockIdx.x, x = blockIdx.z;
  if (b >= B) return;
  const int j = D.j, r = j + D.PAD;
  const bool geo = x >= dl;
  const int cap = Cb[b];
  A mb[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    mb[q] = geo ? (A)emisB[((((long long)(q >> 2) * R + (r - dl)) * W1 +
                          (x - dl)) * 4 + (q & 3)) * B + b]
                : 0;
  auto widx = [&](int bu, int u1) {
    return ((((long long)bu * C1 + dl) * W1 + x) * C1 + u1) * B + b;
  };
  for (int ar0 = 0; ar0 < n_ar; ar0 += AR_CHUNK) {
    const int nq = n_ar - ar0 < AR_CHUNK ? n_ar - ar0 : AR_CHUNK;
    A tv[AR_CHUNK], acc[AR_CHUNK];
#pragma unroll
    for (int q = 0; q < AR_CHUNK; ++q) {
      acc[q] = 0;
      tv[q] = (q < nq && geo)
          ? (A)Tb[(((long long)dl * W1 + x) * n_ar + ar0 + q) * B + b] : 0;
    }
    for (int u1 = 0; u1 < C1; ++u1) {
      const bool live = geo && x + u1 <= D.Wp && dl + u1 <= cap;
      A w0 = 0, w1 = 0;
      if (live) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          w0 += mb[g] * (A)eSZg[((long long)g * C1 + dl) * C1 + u1] *
                emisA[(((long long)g * (Lp + 1) + j) * W1 + x + u1) * B + b];
          w1 += mb[4 + g] *
                (A)eSZg[((long long)(4 + g) * C1 + dl) * C1 + u1] *
                emisA[(((long long)(4 + g) * (Lp + 1) + j) * W1 + x + u1) *
                      B + b];
        }
      }
      A gw0 = 0, gw1 = 0;
      if (live) {
        const A* g0p = gV + ((((long long)x) * C1 + u1) * n_ar + ar0) * B + b;
        const A* g1p = gV + ((((long long)W1 + x) * C1 + u1) * n_ar + ar0) *
                                B + b;
#pragma unroll
        for (int q = 0; q < AR_CHUNK; ++q) {
          if (q < nq) {
            const A g0 = g0p[(long long)q * B], g1 = g1p[(long long)q * B];
            acc[q] += g0 * w0 + g1 * w1;
            gw0 += g0 * tv[q];
            gw1 += g1 * tv[q];
          }
        }
      }
      if (ar0 == 0) {
        gW[widx(0, u1)] = gw0;
        gW[widx(1, u1)] = gw1;
      } else {
        gW[widx(0, u1)] += gw0;
        gW[widx(1, u1)] += gw1;
      }
    }
#pragma unroll
    for (int q = 0; q < AR_CHUNK; ++q)
      if (q < nq)
        gT[(((long long)dl * W1 + x) * n_ar + ar0 + q) * B + b] = acc[q];
  }
}

__device__ __forceinline__ bool w_live(const DPDims& D, int dl, int x,
                                       int u1, int cap) {
  return x >= dl && x + u1 <= D.Wp && dl + u1 <= cap && u1 <= D.Cp &&
         dl <= D.Cp;
}

// ---- emisB's cotangent: per (dl, v, read), rows j - dl
template <typename T>
__global__ void ep_gmb_kernel(DPDims D, const A* gW, const T* emisA,
                              const T* eSZg, const int* Cb, T* gemisB) {
  const int B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1, Lp = D.Lp;
  const int R = D.Lp + 1 + D.PAD;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int v = blockIdx.y, dl = blockIdx.z;
  const int x = v + dl;
  if (b >= B || x > D.Wp) return;
  const int j = D.j, r = j + D.PAD, cap = Cb[b];
  A acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0;
  for (int u1 = 0; u1 < C1; ++u1) {
    if (!w_live(D, dl, x, u1, cap)) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const A gw = gW[((((long long)(q >> 2) * C1 + dl) * W1 + x) * C1 + u1) *
                      B + b];
      acc[q] += gw * ((A)eSZg[((long long)q * C1 + dl) * C1 + u1] *
                      emisA[(((long long)q * (Lp + 1) + j) * W1 + x + u1) * B +
                            b]);
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)
    gemisB[((((long long)(q >> 2) * R + (r - dl)) * W1 + v) * 4 + (q & 3)) *
               B + b] += (T)acc[q];
}

// ---- emisA's cotangent: per (bucket x mismatch group q, w, read), row j
template <typename T>
__global__ void ep_gma_kernel(DPDims D, const A* gW, const T* emisB,
                              const T* eSZg, const int* Cb, T* gemisA) {
  const int B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1, Lp = D.Lp;
  const int R = D.Lp + 1 + D.PAD;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 8 * W1 * B) return;
  const int b = idx % B, w = (idx / B) % W1, q = idx / (B * W1);
  const int bu = q >> 2, g = q & 3;
  const int j = D.j, r = j + D.PAD, cap = Cb[b];
  A acc = 0;
  for (int u1 = 0; u1 <= (w < D.Cp ? w : D.Cp); ++u1) {
    const int x = w - u1;
    for (int dl = 0; dl <= (x < D.Cp ? x : D.Cp); ++dl) {
      if (!w_live(D, dl, x, u1, cap)) continue;
      acc += gW[((((long long)bu * C1 + dl) * W1 + x) * C1 + u1) * B + b] *
             ((A)emisB[((((long long)bu * R + (r - dl)) * W1 + (x - dl)) * 4 +
                        g) * B + b] *
              eSZg[((long long)q * C1 + dl) * C1 + u1]);
    }
  }
  gemisA[(((long long)q * (Lp + 1) + j) * W1 + w) * B + b] += (T)acc;
}

// ---- the size weights' per-read partials GSZ[bu][g][dl][u1][read]
template <typename T>
__global__ void ep_gsz_kernel(DPDims D, const A* gW, const T* emisA,
                              const T* emisB, const int* Cb, T* GSZ) {
  const int B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1, Lp = D.Lp;
  const int R = D.Lp + 1 + D.PAD;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int u1 = blockIdx.y, dl = blockIdx.z;
  if (b >= B) return;
  const int j = D.j, r = j + D.PAD, cap = Cb[b];
  if (dl + u1 > cap) return;
  A acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0;
  for (int x = dl; x + u1 <= D.Wp; ++x) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const A gw = gW[((((long long)(q >> 2) * C1 + dl) * W1 + x) * C1 + u1) *
                      B + b];
      acc[q] += gw *
                ((A)emisB[((((long long)(q >> 2) * R + (r - dl)) * W1 +
                            (x - dl)) * 4 + (q & 3)) * B + b] *
                 emisA[(((long long)q * (Lp + 1) + j) * W1 + x + u1) * B + b]);
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)
    GSZ[(((long long)q * C1 + dl) * C1 + u1) * B + b] += (T)acc[q];
}

// ---- the inner pair's P cotangent: per (dl, v, s1, read), rows j - dl
template <typename T>
__global__ void ep_gp_kernel(DPDims D, AdjIdx ix, EP_CTX_ARGS(T), const A* gT,
                             const A* GO, T* gP) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, n_ar = D.n_ar;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int s1 = blockIdx.y;
  const int z = blockIdx.z * kZLanes + threadIdx.y;
  const int dl = z / W1, v = z % W1;
  const int x = v + dl;
  if (b >= B || dl > D.Cp || x > D.Wp) return;
  const EpCtx<T> c = EP_CTX(b);
  const T p0 = P[TIDX(c.r - dl, v, s1, b)];
  if (!(p0 > ninf<T>())) return;
  const A pe = c.exP(dl, v, s1);
  A acc = 0;
  if (!D.fix_rss || right_dots(dcum, D.j, dl, B, b))
    for (int kk = ix.s1_off[s1]; kk < ix.s1_off[s1 + 1]; ++kk) {
      const int p = ix.s1_k[kk];
      acc += gT[(((long long)dl * W1 + x) * n_ar + ix.p13_ar[p]) * B + b] *
             (c.exL3(dl, ix.p13_s3[p]) * pe);
    }
  if (!D.no_ene)
    for (int ci = 0; ci < 6; ++ci) {
      if (kSpecDl[ci] != dl) continue;
      const int dk = kSpecDk[ci], w = v + dk + dl;
      if (!c.spec_ok(ci, w)) continue;
      for (int kk = ix.s1_off[s1]; kk < ix.s1_off[s1 + 1]; ++kk) {
        const int p = ix.s1_k[kk], ar = ix.p13_ar[p];
        const A l3 = c.exL3(dl, ix.p13_s3[p]) * pe;
        for (int q = ix.k2a_off[ar]; q < ix.k2a_off[ar + 1]; ++q) {
          const int k = ix.k2a_k[q];
          const A go = GO[((long long)w * S + ix.k2_tgt[k]) * B + b];
          if (go == 0) continue;
          acc += go * ((A)c.exB(w - dk, dk, ix.k2_s2[k]) *
                       c.eil(ix.k2_bu[k], ci, w) * l3);
        }
      }
    }
  gP[TIDX(c.r - dl, v, s1, b)] += (T)acc;
}

// ---- the right flank's LL cotangent: per (dl, s3, read), row j.  The
// kLanes warps of a block split the x and w loops (lane y takes every
// kLanes-th value); the partials are summed in shared memory in lane
// order, so the result does not depend on the schedule.
template <typename T>
__global__ void ep_gl3_kernel(DPDims D, AdjIdx ix, EP_CTX_ARGS(T), const A* gT,
                              const A* GO, T* gLL) {
  __shared__ A part[kLanes][32];
  const int S = D.S, B = D.B, W1 = D.Wp + 1, n_ar = D.n_ar;
  const int b = blockIdx.x * 32 + threadIdx.x, lane = threadIdx.y;
  const int s3 = blockIdx.y, dl = blockIdx.z;
  A acc = 0;
  bool live = b < B;
  T l0 = ninf<T>();
  if (live) {
    l0 = LL[TIDX(D.j + D.PAD, dl, s3, b)];
    live = l0 > ninf<T>() && !(D.fix_rss && !right_dots(dcum, D.j, dl, B, b));
  }
  if (live) {
    const EpCtx<T> c = EP_CTX(b);
    const A le = ex(l0 - c.mL3);
    for (int x = dl + lane; x < W1; x += kLanes)
      for (int kk = ix.s3_off[s3]; kk < ix.s3_off[s3 + 1]; ++kk) {
        const int p = ix.s3_k[kk];
        acc += gT[(((long long)dl * W1 + x) * n_ar + ix.p13_ar[p]) * B + b] *
               (c.exP(dl, x - dl, ix.p13_s1[p]) * le);
      }
    if (!D.no_ene)
      for (int ci = 0; ci < 6; ++ci) {
        if (kSpecDl[ci] != dl) continue;
        const int dk = kSpecDk[ci];
        for (int w = dk + dl + lane; w < W1; w += kLanes) {
          if (!c.spec_ok(ci, w)) continue;
          for (int kk = ix.s3_off[s3]; kk < ix.s3_off[s3 + 1]; ++kk) {
            const int p = ix.s3_k[kk], ar = ix.p13_ar[p];
            const A pin = c.exP(dl, w - dk - dl, ix.p13_s1[p]) * le;
            for (int q = ix.k2a_off[ar]; q < ix.k2a_off[ar + 1]; ++q) {
              const int k = ix.k2a_k[q];
              const A go = GO[((long long)w * S + ix.k2_tgt[k]) * B + b];
              if (go == 0) continue;
              acc += go * ((A)c.exB(w - dk, dk, ix.k2_s2[k]) *
                           c.eil(ix.k2_bu[k], ci, w) * pin);
            }
          }
        }
      }
  }
  part[lane][threadIdx.x] = acc;
  __syncthreads();
  if (lane != 0 || !live) return;
  A tot = 0;
  for (int y = 0; y < kLanes; ++y) tot += part[y][threadIdx.x];
  gLL[TIDX(D.j + D.PAD, dl, s3, b)] += (T)tot;
}

#define RC return static_cast<int>(cudaGetLastError())
#define CTX_PASS P, LL, shift, spec_il, lam, dcum, Cb

#define EP_ADJ_EXPORTS(SUF, T)                                               \
  RNAELEM_EXPORT int rnaelem_ep_go_##SUF(DPDims D, AdjIdx ix, EP_CTX_ARGS(T),   \
                                         const T* EP, const T* gEP, A* GO,   \
                                         T* DL, cudaStream_t st) {           \
    const long long n = (long long)(D.Wp + 1) * D.S * D.B;                  \
    ep_go_kernel<T><<<n_blocks(n, kAdjThreads), kAdjThreads, 0, st>>>(      \
        D, ix, CTX_PASS, EP, gEP, GO, DL);                                   \
    RC;                                                                      \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_gv_##SUF(DPDims D, AdjIdx ix, EP_CTX_ARGS(T),   \
                                         const T* Vb, const A* GO, A* gV,    \
                                         T* gLL, cudaStream_t st) {          \
    dim3 grid((D.B + 31) / 32, D.Cp + 1, D.Wp + 1);                          \
    ep_gv_kernel<T><<<grid, 32, 0, st>>>(D, ix, CTX_PASS, Vb, GO, gV, gLL);  \
    RC;                                                                      \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_gtw_##SUF(                                   \
      DPDims D, const T* Tb, const A* gV, const T* emisA, const T* emisB,    \
      const T* eSZg, const int* Cb, A* gT, A* gW, cudaStream_t st) {         \
    dim3 grid(D.Cp + 1, (D.B + 31) / 32, D.Wp + 1);                          \
    ep_gtw_kernel<T><<<grid, 32, 0, st>>>(D, Tb, gV, emisA, emisB, eSZg, Cb, \
                                          gT, gW);                           \
    RC;                                                                      \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_gmb_##SUF(DPDims D, const A* gW,             \
                                          const T* emisA, const T* eSZg,     \
                                          const int* Cb, T* gemisB,          \
                                          cudaStream_t st) {                 \
    dim3 grid((D.B + 31) / 32, D.Wp + 1, D.Cp + 1);                          \
    ep_gmb_kernel<T><<<grid, 32, 0, st>>>(D, gW, emisA, eSZg, Cb, gemisB);   \
    RC;                                                                      \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_gma_##SUF(DPDims D, const A* gW,             \
                                          const T* emisB, const T* eSZg,     \
                                          const int* Cb, T* gemisA,          \
                                          cudaStream_t st) {                 \
    const long long n = 8LL * (D.Wp + 1) * D.B;                             \
    ep_gma_kernel<T><<<n_blocks(n, kAdjThreads), kAdjThreads, 0, st>>>(     \
        D, gW, emisB, eSZg, Cb, gemisA);                                     \
    RC;                                                                      \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_gsz_##SUF(DPDims D, const A* gW,             \
                                          const T* emisA, const T* emisB,    \
                                          const int* Cb, T* GSZ,             \
                                          cudaStream_t st) {                 \
    dim3 grid((D.B + 31) / 32, D.Cp + 1, D.Cp + 1);                          \
    ep_gsz_kernel<T><<<grid, 32, 0, st>>>(D, gW, emisA, emisB, Cb, GSZ);     \
    RC;                                                                      \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_gp_##SUF(DPDims D, AdjIdx ix, EP_CTX_ARGS(T),   \
                                         const A* gT, const A* GO, T* gP,    \
                                         cudaStream_t st) {                  \
    dim3 grid((D.B + 31) / 32, D.S,                                          \
              ceil_div((long long)(D.Cp + 1) * (D.Wp + 1), kZLanes));        \
    ep_gp_kernel<T><<<grid, dim3(32, kZLanes), 0, st>>>(D, ix, CTX_PASS, gT, \
                                                        GO, gP);             \
    RC;                                                                      \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_gl3_##SUF(DPDims D, AdjIdx ix, EP_CTX_ARGS(T),  \
                                          const A* gT, const A* GO, T* gLL,  \
                                          cudaStream_t st) {                 \
    dim3 grid((D.B + 31) / 32, D.S, D.Cp + 1);                               \
    ep_gl3_kernel<T><<<grid, dim3(32, kLanes), 0, st>>>(D, ix, CTX_PASS, gT, \
                                                        GO, gLL);            \
    RC;                                                                      \
  }

EP_ADJ_EXPORTS(f32, float)
EP_ADJ_EXPORTS(f64, double)
