// K7: the adjoint of K4 for one column j: the O self-chain (TT_O_O) and
// the O = O * P splits (TT_O_OP) sent back to the O rows j-1..j-Wp, the P
// row j, eR row j-1 and lambda's exterior-energy term.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp program): the o_col / chain1
// part of ops/dp.py dp_bwd, the custom VJP of dp_parts (row H of the
// kernel table, ops/dp.py:788-946, reverse of ops/dp.py:601-618).
//
// Bound on the H100: bytes, and really launch latency: per read and
// column it reads the P column [Wp+1, S], the O window [Wp, S] and the O
// cotangent row [S] once and writes as many cotangent cells (about twice
// K4's traffic, 24 KB per read in f32).  Design: gather form, one thread
// per (w, state, read) with the read fastest; the thread owns the P
// cotangent at (j, w, state), the O cotangent at (j - w, state), the
// lambda partial DL at (j, w, state) and, at w = 0, eR's cotangent at
// (j - 1, state), and walks the sparse split lists by P state, by O state
// and by target.  No atomics: two runs give the same bits.  Under the
// scanner's pin (common.cuh Aux) the O chain skips the vetoed transitions
// emitting base j-1, and its transitions' posteriors go to the class
// partials of that base (cpR slot 0, thread (s, read) the owner).
#include "outside.cuh"

template <typename T>
__global__ void ext_adj_kernel(DPDims D, AdjIdx ix, Aux ax, const T* O,
                               const T* P,
                               const T* eR, const T* gate_O2, const T* ext,
                               const T* lam, T* gO, T* gP, T* geR, T* DL) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j;
  const long long n = (long long)W1 * S * B;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int b = idx % B;
  const int s = (idx / B) % S;
  const int w = idx / ((long long)B * S);
  const int r = j + D.PAD;
  const T* rtw = static_cast<const T*>(ix.rt_w);
  const long long orow = (long long)r * S * B + b;  // O row j, read b
  auto Og = [&](int t) { return gO[orow + (long long)t * B]; };
  auto Ov = [&](int t) { return O[orow + (long long)t * B]; };
  const T gate = gate_O2[(long long)(j - 1) * B + b];
  if (w == 0) {
    // eR[j-1][s]: the O chain of target s
    const int pinR = pin_req(ax, b, j - 1, kAuxR);
    LSE<T> oo;
    for (int k = ix.rt_off[s]; k < ix.rt_off[s + 1]; ++k) {
      if (vetoed(ax, pinR, kAuxR, s, ix.rt_s[k], S)) continue;
      oo.add(rtw[k] + O[((long long)(r - 1) * S + ix.rt_s[k]) * B + b]);
    }
    const T oov = oo.result() + eR[((long long)(j - 1) * S + s) * B + b] +
                  gate;
    geR[((long long)(j - 1) * S + s) * B + b] += share(Og(s), oov, Ov(s));
    return;
  }
  const long long cell = ((long long)j * W1 + w) * B + b;
  const T xe = ext[cell];
  if (!(xe > ninf<T>())) return;  // no split at this width
  // (a) s as the P state of a split at width w
  const T pv = P[TIDX(r, w, s, b)];
  if (pv > ninf<T>()) {
    T acc = (T)0;
    for (int k = ix.opa_off[s]; k < ix.opa_off[s + 1]; ++k) {
      const int t = ix.opa_t[k];
      const T e = lam_mul(lam[ix.bucket[t]], xe);
      acc += share(Og(t), pv + e +
                   O[((long long)(r - w) * S + ix.opa_c[k]) * B + b], Ov(t));
    }
    gP[TIDX(r, w, s, b)] += acc;
  }
  // (b) s as the O state at row j - w (and the chain at w = 1)
  const T ov = O[((long long)(r - w) * S + s) * B + b];
  if (ov > ninf<T>()) {
    T acc = (T)0;
    for (int k = ix.opc_off[s]; k < ix.opc_off[s + 1]; ++k) {
      const int t = ix.opc_t[k];
      const T e = lam_mul(lam[ix.bucket[t]], xe);
      acc += share(Og(t), P[TIDX(r, w, ix.opc_a[k], b)] + e + ov, Ov(t));
    }
    gO[((long long)(r - w) * S + s) * B + b] += acc;
  }
  // (c) s as the target: lambda's exterior term at width w
  {
    const T e = lam_mul(lam[ix.bucket[s]], xe);
    T acc = (T)0;
    for (int k = ix.op_off[s]; k < ix.op_off[s + 1]; ++k)
      acc += share(Og(s), P[TIDX(r, w, ix.op_a[k], b)] + e +
                   O[((long long)(r - w) * S + ix.op_c[k]) * B + b], Ov(s));
    DL[TIDX(j, w, s, b)] += acc * xe;
  }
}

// the chain's sources: O row j-1 (one thread per (state, read))
template <typename T>
__global__ void ext_adj_chain_kernel(DPDims D, AdjIdx ix, Aux ax,
                                     const T* O, const T* eR,
                                     const T* gate_O2, T* gO) {
  const int S = D.S, B = D.B, j = D.j;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * B) return;
  const int b = idx % B, s = idx / B;
  const int r = j + D.PAD;
  const T* rtrw = static_cast<const T*>(ix.rtr_w);
  const T ov = O[((long long)(r - 1) * S + s) * B + b];
  if (!(ov > ninf<T>())) return;
  const T gate = gate_O2[(long long)(j - 1) * B + b];
  const int pinR = pin_req(ax, b, j - 1, kAuxR);
  T acc = (T)0, cls[4] = {0, 0, 0, 0};
  for (int k = ix.rtr_off[s]; k < ix.rtr_off[s + 1]; ++k) {
    const int t = ix.rtr_t[k];
    if (vetoed(ax, pinR, kAuxR, t, s, S)) continue;
    const T x = share(gO[((long long)r * S + t) * B + b],
                      rtrw[k] + ov + eR[((long long)(j - 1) * S + t) * B + b] +
                          gate,
                      O[((long long)r * S + t) * B + b]);
    acc += x;
    if (ax.cpR) add_classes(ax, kAuxR, t, s, S, x, cls);
  }
  gO[((long long)(r - 1) * S + s) * B + b] += acc;
  if (ax.cpR) {
    T* cp = static_cast<T*>(ax.cpR);
    const long long W1S = (long long)(D.Wp + 1) * S;
    for (int c = 0; c < 4; ++c) cp[(c * W1S + s) * B + b] += cls[c];
  }
}

template <typename T>
static int ext_adj(DPDims D, AdjIdx ix, Aux ax, const T* O, const T* P,
                   const T* eR,
                   const T* gate_O2, const T* ext, const T* lam, T* gO, T* gP,
                   T* geR, T* DL, cudaStream_t st) {
  const long long n = (long long)(D.Wp + 1) * D.S * D.B;
  ext_adj_kernel<T><<<n_blocks(n, kAdjThreads), kAdjThreads, 0, st>>>(
      D, ix, ax, O, P, eR, gate_O2, ext, lam, gO, gP, geR, DL);
  return static_cast<int>(cudaGetLastError());
}

// after ext_adj: both add to the O cotangent at row j-1
template <typename T>
static int ext_adj_chain(DPDims D, AdjIdx ix, Aux ax, const T* O, const T* eR,
                         const T* gate_O2, T* gO, cudaStream_t st) {
  ext_adj_chain_kernel<T><<<n_blocks((long long)D.S * D.B, kAdjThreads),
                            kAdjThreads, 0, st>>>(D, ix, ax, O, eR, gate_O2,
                                                  gO);
  return static_cast<int>(cudaGetLastError());
}

#define EXT_ADJ_EXPORT(SUF, T)                                               \
  RNAELEM_EXPORT int rnaelem_ext_adj_##SUF(                                  \
      DPDims D, AdjIdx ix, Aux ax, const T* O, const T* P, const T* eR,      \
      const T* gate_O2, const T* ext, const T* lam, T* gO, T* gP, T* geR,    \
      T* DL, cudaStream_t st) {                                              \
    return ext_adj<T>(D, ix, ax, O, P, eR, gate_O2, ext, lam, gO, gP, geR,   \
                      DL, st);                                               \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ext_adj_chain_##SUF(                            \
      DPDims D, AdjIdx ix, Aux ax, const T* O, const T* eR,                  \
      const T* gate_O2, T* gO, cudaStream_t st) {                            \
    return ext_adj_chain<T>(D, ix, ax, O, eR, gate_O2, gO, st);              \
  }

EXT_ADJ_EXPORT(f32, float)
EXT_ADJ_EXPORT(f64, double)
