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
// gV * T), about twice K3's operations.
//
// Design (two launches per column): ep_adj gives each (read, range of x)
// a block of kEpAdjThreads threads (ep_col.cuh).  It turns the ep
// cotangent into exp space (go = g_ep / out, with out from ep and K3's
// shifts of the column) for the widths x..x+Cp that step x reads, in a
// ring of Cp+1 rows that takes width x+Cp as width x-1 falls out, and
// walks its x: it
// forms T, W and V as K3 does (K3's functions are not launched), then in
// reverse: the left flank's LL cotangent (exLB * sum_k go * V),
// gV_bu[u1, ar] = sum_k go * exLB, gW_bu[dl, u1] = sum_ar T * gV, gT[dl,
// ar] = sum_bu,u1 W * gV, and from them the cotangents of emisB (cells
// (j-dl, x-dl): this x's own), of the inner pair's P cells (likewise),
// and the block's partial sums of the cotangents that sum across x:
// emisA at w = x + u1 (a ring of Cp+1 widths, each written out once no
// later x reaches it), the per-read size-weight partials GSZ on the
// triangle dl + u1 <= Cp, lambda's small-loop term gW * exp(lam * il) *
// il at the specials' cells and the right flank's LL row j.  T, W, V, gV,
// gW, gT and the partial sums live in shared memory only (W and gW on the
// triangle; no buffer sized by Wp), so that two blocks share an SM where
// they fit: one block
// waits on device memory most of the time.  Every step is a loop over
// cells that all the block's threads share: no thread walks a chain of
// dependent device-memory loads while the others wait.
// ep_adj_red adds the blocks' partials in range order.  One owner per
// cotangent cell and fixed orders: no atomics, the same bits in any
// batch and in every run.  The hazards of K3 are kept: the cap dl + u1
// <= C, x + u1 <= Wp, the specials' dk + dl <= C and the fix_rss dot
// gating of both flanks.
//
// Range: go = g_ep / out reaches 1 / FLT_MIN (~1e38) for an output near
// the bottom of f32's range, and a partial product such as go * W can
// then overflow f32 although the whole share (go * term, term <= out)
// is at most g_ep.  So the chain (go, T, W, V, gV, gW, gT and the
// partial sums in shared memory) is double at either input type, and an
// output below the least normal number sends nothing, as the plain
// version's safe_log clamp does.
#include "ep_col.cuh"

#include <cfloat>

static const int kEpAdjThreads = 512;  // threads per block (one read)

typedef double A;  // the chain's type

template <typename T>
__device__ __forceinline__ T least_normal();
template <>
__device__ __forceinline__ float least_normal<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double least_normal<double>() { return DBL_MIN; }

// kDev: the layout in the block's slice of the workspace ws (ep_col.cuh)
template <typename T, bool kDev>
__global__ void __launch_bounds__(kEpAdjThreads, 2)
ep_adj_kernel(DPDims D, EpXRanges xq, EpIdx ix, const T* P, const T* LL,
              const T* EP, const T* gEP, const T* shift, const T* emisA,
              const T* emisB, const T* eSZg, const T* spec_il, const T* lam,
              const int* dcum, const int* Cb, T* gP, T* gLL, T* gemisB,
              T* gL3p, T* gmAp, T* gszp, T* glamp, unsigned char* ws) {
  extern __shared__ __align__(16) unsigned char ep_smem[];
  EpBlock<T, A> k;
  k.init(D, Cb, blockIdx.x);
  const int xr = blockIdx.y, S = k.S, B = k.B, W1 = k.W1, C1 = k.C1;
  const int NA = k.NA, b = k.b, r = k.r;
  const EpAdjLayout lay(S, NA, C1);
  A* am = reinterpret_cast<A*>(
      ep_base<kDev>(ep_smem, ws, lay.bytes(sizeof(T))));
  T* tm = reinterpret_cast<T*>(am + lay.n_a);
  k.mAB = am + lay.mAB;
  k.Tm = am + lay.Tm;  // T, then gT
  k.Wm = am + lay.Wm;
  k.Vm = am + lay.Vm;  // V, then gV
  A* gW = am + lay.gW;    // [2][tri]
  A* go = am + lay.go;    // ring [C1][S]: width w at slot w % C1
  A* gL3 = am + lay.gL3;  // [C1][S] the right flank's partial
  A* gmA = am + lay.gmA;  // ring [8][C1]: emisA's partial at width w
  A* gsz = am + lay.gsz;  // [8][tri] the size weights' partial
  A* glam = am + lay.glam;  // [2][6] lambda's small-loop partial
  k.exP = tm + lay.exP;
  k.exL3 = tm + lay.exL3;
  k.LL = LL;
  k.szg = eSZg;
  const T* sh = shift + (long long)k.j * 3 * B + b;
  k.mPF = sh[0];
  k.mL3 = sh[B];
  k.mLB = sh[2 * B];
  const int x0 = xq.x0[xr], x1 = xq.x1[xr];
  // the widths this block's x reach are x0..wend
  const int wend = x1 < x0 ? -1 : (x1 + k.Cp < k.Wp ? x1 + k.Cp : k.Wp);

  // go = g_ep / out of widths w..w+nw-1 into the ring
  const T tot = k.mPF + k.mL3 + k.mLB;
  auto load_go = [&](int w, int nw) {
    for (int i = threadIdx.x; i < nw * S; i += blockDim.x) {
      const int ww = w + i / S, t = i % S;
      const T g = gEP[((long long)ww * S + t) * B + b];
      const T v = EP[TIDX(r, ww, t, b)];
      A gv = 0;
      if (g != (T)0 && v > ninf<T>()) {
        const T out = ex(v - tot);
        if (out >= least_normal<T>()) gv = (A)g / (A)out;
      }
      go[(ww % C1) * S + t] = gv;
    }
  };
  // emisA's partial of width w (the ring's row, then zero)
  T* pa = gmAp + (long long)xr * 8 * W1 * B + b;
  auto flush_a = [&](int w) {
    for (int q = threadIdx.x; q < 8; q += blockDim.x) {
      pa[((long long)q * W1 + w) * B] = (T)gmA[q * C1 + w % C1];
      gmA[q * C1 + w % C1] = 0;
    }
  };
  if (x1 >= x0) load_go(x0, (wend < x0 + k.Cp ? wend : x0 + k.Cp) - x0 + 1);
  ep_stage_l3(k, LL, dcum);
  const int ntri = k.ntri;
  for (int i = threadIdx.x; i < C1 * S; i += blockDim.x) gL3[i] = 0;
  for (int i = threadIdx.x; i < 8 * C1; i += blockDim.x) gmA[i] = 0;
  for (int i = threadIdx.x; i < 8 * ntri; i += blockDim.x) gsz[i] = 0;
  for (int i = threadIdx.x; i < 12; i += blockDim.x) glam[i] = 0;
  for (int i = threadIdx.x; i < 8 * W1; i += blockDim.x)
    if (i % W1 < x0 || i % W1 > wend) pa[(long long)i * B] = (T)0;
  __syncthreads();

  for (int x = x0; x <= x1; ++x) {
    const int dmax = x < k.Cp ? x : k.Cp;
    const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
    const int xs = x % C1;
    if (x > x0) {   // width x - 1 is done: its slot takes width x + Cp
      flush_a(x - 1);
      if (x + k.Cp <= k.Wp) load_go(x + k.Cp, 1);
    }
    ep_stage_x(k, x, P, emisA, emisB);
    __syncthreads();
    ep_form_tw(k, x, ix, spec_il, lam);
    __syncthreads();
    ep_form_v(k, x);
    __syncthreads();
    // the left flank: gLL(j-x, u1)[s2] += exLB * sum over K2 entries of
    // s2 of go(x+u1, target) * V (its specials carried in V)
    for (int i = threadIdx.x; i < (umax + 1) * S; i += blockDim.x) {
      const int u1 = i / S, s2 = i % S;
      if (ix.k2s_off[s2] == ix.k2s_off[s2 + 1]) continue;
      if (k.fix_rss && !left_dots(dcum, k.j, x, u1, B, b)) continue;
      A acc = 0;
      for (int kk = ix.k2s_off[s2]; kk < ix.k2s_off[s2 + 1]; ++kk) {
        const int e = ix.k2s_k[kk];
        const A g = go[ring_slot(xs, u1, C1) * S + ix.k2_tgt[e]];
        if (g != 0) acc += g * k.V(ix.k2_bu[e], u1, ix.k2_ar[e]);
      }
      if (acc == 0) continue;
      const A ev = (A)k.exB(x, u1, s2);
      if (ev != 0) gLL[TIDX(r - x, u1, s2, b)] += (T)(acc * ev);
    }
    __syncthreads();
    // gV_bu[u1, ar] = sum over K2 entries of ar of go * exLB (into Vm)
    for (int i = threadIdx.x; i < (umax + 1) * NA; i += blockDim.x) {
      const int u1 = i / NA, ar = i % NA;
      A v0 = 0, v1 = 0;  // per bucket, in registers
      if (!k.fix_rss || left_dots(dcum, k.j, x, u1, B, b))
        for (int q = ix.k2a_off[ar]; q < ix.k2a_off[ar + 1]; ++q) {
          const int e = ix.k2a_k[q];
          const A g = go[ring_slot(xs, u1, C1) * S + ix.k2_tgt[e]];
          if (g == 0) continue;
          const A t = g * (A)k.exB(x, u1, ix.k2_s2[e]);
          if (ix.k2_bu[e]) v1 += t;
          else v0 += t;
        }
      k.V(0, u1, ar) = v0;
      k.V(1, u1, ar) = v1;
    }
    __syncthreads();
    // gW on the live cells of the triangle, the size weights' partial
    // GSZ and, at the cells of the specials, lambda's small-loop term
    // gW * exp(lam * il) * il
    for (int c = threadIdx.x; c < 2 * C1 * C1; c += blockDim.x) {
      const int bu = c / (C1 * C1), dl = (c / C1) % C1, u1 = c % C1;
      if (dl > dmax || u1 > umax || dl + u1 > k.cap) continue;
      const int ci = k.no_ene ? -1 : spec_ci(u1, dl);
      const T il = ci < 0 ? ninf<T>() : spec_il[
          (((long long)ci * (k.Lp + 1) + k.j) * W1 + (x + u1)) * B + b];
      A g = 0;
      for (int ar = 0; ar < NA; ++ar)
        g += k.Tm[dl * NA + ar] * k.V(bu, u1, ar);
      const int t = tri_index(C1, dl, u1);
      gW[bu * ntri + t] = g;
#pragma unroll
      for (int g4 = 0; g4 < 4; ++g4) {
        const int q = bu * 4 + g4;
        gsz[q * ntri + t] += g * (k.mB(q, dl) * k.mA(q, u1));
      }
      if (il > ninf<T>())
        glam[bu * 6 + ci] += g * ((A)ex(lam_mul(lam[bu], il)) * (A)il);
    }
    __syncthreads();
    // gT[dl, ar] = sum_bu,u1 W * gV (into Tm: T is no longer read)
    for (int i = threadIdx.x; i < (dmax + 1) * NA; i += blockDim.x) {
      const int dl = i / NA, ar = i % NA;
      const int uend = umax < k.cap - dl ? umax : k.cap - dl;
      const int t0 = tri_index(C1, dl, 0);
      A g = 0;
      for (int bu = 0; bu < 2; ++bu)
        for (int u1 = 0; u1 <= uend; ++u1)
          g += k.Wm[bu * ntri + t0 + u1] * k.V(bu, u1, ar);
      k.Tm[i] = g;
    }
    // emisB's cotangent at the P cells (j-dl, x-dl)
    for (int i = threadIdx.x; i < 8 * (dmax + 1); i += blockDim.x) {
      const int q = i / (dmax + 1), dl = i % (dmax + 1), bu = q >> 2;
      const int t0 = bu * ntri + tri_index(C1, dl, 0);
      const int uend = umax < k.cap - dl ? umax : k.cap - dl;
      A acc = 0;
#pragma unroll 8
      for (int u1 = 0; u1 <= uend; ++u1)   // eSZg loads overlap
        acc += gW[t0 + u1] * ((A)k.sz(q, dl, u1) * k.mA(q, u1));
      if (acc != 0)
        gemisB[((((long long)bu * k.R + (r - dl)) * W1 + (x - dl)) * 4 +
                (q & 3)) * B + b] += (T)acc;
    }
    // emisA's partial at w = x + u1
    for (int i = threadIdx.x; i < 8 * (umax + 1); i += blockDim.x) {
      const int q = i / (umax + 1), u1 = i % (umax + 1), bu = q >> 2;
      const int dend = dmax < k.cap - u1 ? dmax : k.cap - u1;
      A acc = 0;
#pragma unroll 8
      for (int dl = 0, t = bu * ntri + u1; dl <= dend; t += C1 - dl, ++dl)
        acc += gW[t] * (k.mB(q, dl) * (A)k.sz(q, dl, u1));  // t: tri_index
      gmA[q * C1 + ring_slot(xs, u1, C1)] += acc;
    }
    __syncthreads();
    // the inner pair's P cotangent at (j-dl, x-dl), the right flank's
    // partial at (j, dl)
    for (int i = threadIdx.x; i < (dmax + 1) * S; i += blockDim.x) {
      const int dl = i / S, s = i % S;
      const T pe = k.exP[i];
      if (pe != (T)0) {
        A acc = 0;
        for (int kk = ix.s1_off[s]; kk < ix.s1_off[s + 1]; ++kk) {
          const int p = ix.s1_k[kk];
          acc += k.Tm[dl * NA + ix.p13_ar[p]] *
                 ((A)k.exL3[dl * S + ix.p13_s3[p]] * (A)pe);
        }
        if (acc != 0) gP[TIDX(r - dl, x - dl, s, b)] += (T)acc;
      }
      const T le = k.exL3[i];
      if (le != (T)0) {
        A acc = 0;
        for (int kk = ix.s3_off[s]; kk < ix.s3_off[s + 1]; ++kk) {
          const int p = ix.s3_k[kk];
          acc += k.Tm[dl * NA + ix.p13_ar[p]] *
                 ((A)k.exP[dl * S + ix.p13_s1[p]] * (A)le);
        }
        gL3[i] += acc;
      }
    }
    __syncthreads();
  }

  // the block's partial sums
  for (int w = x1; w <= wend; ++w) flush_a(w);
  for (int i = threadIdx.x; i < C1 * S; i += blockDim.x)
    gL3p[((long long)xr * C1 * S + i) * B + b] = (T)gL3[i];
  for (int i = threadIdx.x; i < 8 * ntri; i += blockDim.x)
    gszp[((long long)xr * 8 * ntri + i) * B + b] = (T)gsz[i];
  for (int i = threadIdx.x; i < 12; i += blockDim.x)
    glamp[((long long)xr * 12 + i) * B + b] = (T)glam[i];
}

// ---- the blocks' partials, added in range order: the right flank's LL
// row j, emisA row j, the size weights' per-read partials GSZ and
// lambda's small-loop term (into lambda's direct cotangent [2, B])
template <typename T>
__global__ void ep_adj_red_kernel(DPDims D, const T* gL3p, const T* gmAp,
                                  const T* gszp, const T* glamp, T* gLL,
                                  T* gemisA, T* GSZ, T* glam) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1;
  const int ntri = tri_cells(C1);
  const long long n1 = (long long)C1 * S * B, n2 = 8LL * W1 * B,
                  n3 = 8LL * ntri * B;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n1) {
    T s = (T)0;
    for (int xr = 0; xr < kEpXSplit; ++xr) s += gL3p[xr * n1 + i];
    const int b = i % B, s3 = (i / B) % S, dl = i / ((long long)S * B);
    if (s != (T)0) gLL[TIDX(D.j + D.PAD, dl, s3, b)] += s;
    return;
  }
  i -= n1;
  if (i < n2) {
    T s = (T)0;
    for (int xr = 0; xr < kEpXSplit; ++xr) s += gmAp[xr * n2 + i];
    const int b = i % B, w = (i / B) % W1, q = i / ((long long)W1 * B);
    gemisA[(((long long)q * (D.Lp + 1) + D.j) * W1 + w) * B + b] += s;
    return;
  }
  i -= n2;
  if (i < n3) {
    T s = (T)0;
    for (int xr = 0; xr < kEpXSplit; ++xr) s += gszp[xr * n3 + i];
    const int b = i % B, q = i / ((long long)ntri * B);
    int tt = (i / B) % ntri, dl = 0;
    while (tt >= C1 - dl) {
      tt -= C1 - dl;
      ++dl;
    }
    GSZ[(((long long)q * C1 + dl) * C1 + tt) * B + b] += s;
    return;
  }
  i -= n3;
  if (i < 2LL * B) {   // lambda's small-loop term, per bucket
    const int b = i % B, bu = i / B;
    T s = (T)0;
    for (int xr = 0; xr < kEpXSplit; ++xr)
      for (int ci = 0; ci < 6; ++ci)
        s += glamp[(((long long)xr * 2 + bu) * 6 + ci) * B + b];
    glam[i] += s;
  }
}

static const int kRedThreads = 256;

template <typename T>
static int ep_adj(DPDims D, EpIdx ix, const T* P, const T* LL, const T* EP,
                  const T* gEP, const T* shift, const T* emisA,
                  const T* emisB, const T* eSZg, const T* spec_il,
                  const T* lam, const int* dcum, const int* Cb, T* gP,
                  T* gLL, T* gemisB, T* gL3p, T* gmAp, T* gszp, T* glamp,
                  unsigned char* ws, cudaStream_t st) {
  const long long smem =
      ws ? 0 : EpAdjLayout(D.S, D.n_ar, D.Cp + 1).bytes(sizeof(T));
  auto kern = ws ? ep_adj_kernel<T, true> : ep_adj_kernel<T, false>;
  int rc = allow_smem((const void*)kern, smem);
  if (rc) return rc;
  dim3 grid(D.B, kEpXSplit);
  kern<<<grid, kEpAdjThreads, smem, st>>>(
      D, ep_x_ranges(D.Wp, D.Cp), ix, P, LL, EP, gEP, shift, emisA, emisB,
      eSZg, spec_il, lam, dcum, Cb, gP, gLL, gemisB, gL3p, gmAp, gszp,
      glamp, ws);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int ep_adj_red(DPDims D, const T* gL3p, const T* gmAp, const T* gszp,
                      const T* glamp, T* gLL, T* gemisA, T* GSZ, T* glam,
                      cudaStream_t st) {
  const long long n = (long long)(D.B) *
      ((long long)(D.Cp + 1) * D.S + 8LL * (D.Wp + 1) +
       8LL * tri_cells(D.Cp + 1) + 2);
  ep_adj_red_kernel<T><<<ceil_div(n, kRedThreads), kRedThreads, 0, st>>>(
      D, gL3p, gmAp, gszp, glamp, gLL, gemisA, GSZ, glam);
  return static_cast<int>(cudaGetLastError());
}

#define EP_ADJ_EXPORTS(SUF, T)                                               \
  RNAELEM_EXPORT int rnaelem_ep_adj_##SUF(                                   \
      DPDims D, EpIdx ix, const T* P, const T* LL, const T* EP,              \
      const T* gEP, const T* shift, const T* emisA, const T* emisB,          \
      const T* eSZg, const T* spec_il, const T* lam, const int* dcum,        \
      const int* Cb, T* gP, T* gLL, T* gemisB, T* gL3p, T* gmAp, T* gszp,    \
      T* glamp, unsigned char* ws, cudaStream_t st) {                        \
    return ep_adj<T>(D, ix, P, LL, EP, gEP, shift, emisA, emisB, eSZg,       \
                     spec_il, lam, dcum, Cb, gP, gLL, gemisB, gL3p, gmAp,    \
                     gszp, glamp, ws, st);                                   \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_adj_red_##SUF(                               \
      DPDims D, const T* gL3p, const T* gmAp, const T* gszp,                 \
      const T* glamp, T* gLL, T* gemisA, T* GSZ, T* glam,                    \
      cudaStream_t st) {                                                     \
    return ep_adj_red<T>(D, gL3p, gmAp, gszp, glamp, gLL, gemisA, GSZ,       \
                         glam, st);                                          \
  }

EP_ADJ_EXPORTS(f32, float)
EP_ADJ_EXPORTS(f64, double)
