// K7: the adjoint of K4 for one column j: the O self-chain (TT_O_O) and
// the O = O * P splits (TT_O_OP) sent back to the O rows j-1..j-Wp, the P
// row j, eR row j-1 and lambda's exterior-energy term.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp program): the o_col / chain1
// part of ops/dp.py dp_bwd, the custom VJP of dp_parts (row H of the
// kernel table, ops/dp.py:788-946, reverse of ops/dp.py:601-618).
//
// Bound on the H100: bytes, and really latency: per read and column it
// reads the P column [Wp+1, S], the O window [Wp, S] and the O cotangent
// row [S] once and writes as many cotangent cells (about twice K4's
// traffic, 24 KB per read in f32), a few microseconds of launch and a
// round trip to device memory at the least.
//
// Design (one launch per column): gather form, one block per (state s,
// group of G reads) of G * kAdjSlices threads, thread (slice k, read g),
// the read fastest; slice k takes the widths w = k, k + kAdjSlices, ...
// (one at the default span).  The thread owns the P cotangent at (j, w,
// s), the O cotangent at (j - w, s) and the lambda partial DL at (j, w,
// s); slice 0 also owns eR's cotangent at (j - 1, s) (the O chain of
// target s), and slice 1, which owns the O cotangent at row j - 1, adds
// the chain's term there after the split terms (s as the chain's
// source), and the chain's class partials (cpR slot 0).  The block first
// stages its state's lists (the splits by P state, by O state and by
// target, the chain by source and by target, with their weights, the
// targets' lambda buckets and the transitions' class codes: one row of
// the table ops/kernels.ext_adj_lists builds on the host) in shared
// memory, so that no cell load waits on an index load; a thread's own
// cells (ext, P(j, w, s), O(j-w, s)) load beside the staging and say
// which lists hold live terms at its width (a pruned band leaves most
// widths without a split: their lists are not loaded); then it issues
// the loads of kAdjOps entries of each live list at a time (Og and Ov of
// the targets, the P and O cells of the splits, and with the first the
// cotangents it adds to: every address valid, predicated, no branch
// between them) before it forms any term.  What bounds it on the card is
// the threads in flight, not the loads in flight per thread: a thread of
// two widths and four entries per batch took 161 registers at f32 (one
// block per SM, 3.5 waves at S = 29, B = 128; 2.4x the parent's time), so
// a thread keeps one width and one entry of each list in flight, and the
// f32 build is held to 64 registers, which puts the main path's grid (S
// x B x kAdjSlices threads) in one wave (chip_smoke.py
// --ext-adj-variants).  G is the largest of kAdjGroupBytes' worth of
// reads, 4, 2 or 1 that gives the grid a block per SM (the masks' S = 1
// at B = 128: 128 blocks of one read).
// No atomics, and every sum over a read's terms keeps the order of the
// state's lists, whatever G and B: two runs give the same bits, and a
// read's cotangents do not depend on its batch.  Under the scanner's pin
// (common.cuh Aux) the O chain skips the vetoed transitions emitting base
// j-1, and its transitions' posteriors go to the class partials of that
// base.
#include "outside.cuh"

static const int kAdjSlices = 32;      // width slices per read
static const int kAdjGroupBytes = 32;  // a row's reads per block at most
static const int kAdjOps = 1;          // list entries whose loads go out
                                       // together
static const int kAdjMinBlocks = 4;    // f32: the largest blocks an SM
                                       // must hold (64 registers)

// The state's lists, one row of ``idx`` [S][stride] (int32) and of ``wt``
// [S][nR + nT] (scalar type) per state s, each list padded to the longest
// over the states (nA, nC, nO, nR, nT; the padding holds state 0):
//   [0..5]  the lists' lengths at s (nA, nC, nO, nR, nT) and bucket[s]
//   opa     the splits (t, a = s, c): t[nA], c[nA], bucket[t][nA]
//   opc     the splits (t, a, c = s): t[nC], a[nC], bucket[t][nC]
//   op      the splits (t = s, a, c): a[nO], c[nO]
//   rtr     the chain t <- s: t[nR], its class code[nR]; wt: weight[nR]
//   rt      the chain s <- u: u[nT], its class code[nT]; wt: weight[nT]
struct ExtAdjLists {
  const int* idx;
  const void* wt;
  int nA, nC, nO, nR, nT;
};

struct ExtAdjRow {  // offsets in a row of idx
  int opa_t, opa_c, opa_b, opc_t, opc_a, opc_b, op_a, op_c, rtr_t, rtr_k,
      rt_s, rt_k, stride;
  __host__ __device__ ExtAdjRow(const ExtAdjLists& x) {
    opa_t = 6;
    opa_c = opa_t + x.nA;
    opa_b = opa_c + x.nA;
    opc_t = opa_b + x.nA;
    opc_a = opc_t + x.nC;
    opc_b = opc_a + x.nC;
    op_a = opc_b + x.nC;
    op_c = op_a + x.nO;
    rtr_t = op_c + x.nO;
    rtr_k = rtr_t + x.nR;
    rt_s = rtr_k + x.nR;
    rt_k = rt_s + x.nT;
    stride = rt_k + x.nT;
  }
};

// the shared memory of a block: the weights, then the row
template <typename T>
static long long ext_adj_smem(const ExtAdjLists& x) {
  return (long long)(x.nR + x.nT) * sizeof(T) +
         (long long)ExtAdjRow(x).stride * 4;
}

// entry q of a list of n (its row width cap): q itself, or the first slot
// for a q past the width (the padding beyond n holds valid states too)
__device__ __forceinline__ int ext_adj_entry(int q, int cap) {
  return q < cap ? q : 0;
}

// a thread's own cells at width w: ext, P(j, w, s), O(j-w, s)
template <typename T>
struct AdjOwn {
  T xe, pv, ov;
};

template <typename T>
__global__ void __launch_bounds__(kAdjSlices * kAdjGroupBytes / 4,
                                  sizeof(T) == 4 ? kAdjMinBlocks : 1)
ext_adj_kernel(DPDims D, ExtAdjLists lx, Aux ax, const T* O, const T* P,
               const T* eR, const T* gate_O2, const T* ext, const T* lam,
               T* gO, T* gP, T* geR, T* DL, int G) {
  extern __shared__ __align__(16) unsigned char adj_smem[];
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j, r = j + D.PAD;
  const int s = blockIdx.y, g = threadIdx.x % G, k = threadIdx.x / G;
  const int b = blockIdx.x * G + g;
  const int bb = b < B ? b : B - 1;   // the loads of a lane past B
  const ExtAdjRow ro(lx);
  auto own = [&](int w) {
    AdjOwn<T> o;
    o.xe = ext[((long long)j * W1 + w) * B + bb];
    o.pv = P[TIDX(r, w, s, bb)];
    o.ov = O[((long long)(r - w) * S + s) * B + bb];
    return o;
  };
  // the loads that need no list go out with the block's staging
  AdjOwn<T> cur = own(k < W1 ? k : 0);
  const long long orow = (long long)r * S * B + bb;  // O row j, read bb
  const T Og_s = gO[orow + (long long)s * B], Ov_s = O[orow + (long long)s * B];
  const T gate = gate_O2[(long long)(j - 1) * B + bb];
  const T lam0 = lam[0], lam1 = lam[1];
  const long long o1 = ((long long)(r - 1) * S + s) * B + bb;  // O(j-1, s)
  const int pinR = pin_req(ax, bb, j - 1, kAuxR);
  T* lw = reinterpret_cast<T*>(adj_smem);            // [nR + nT]
  int* li = reinterpret_cast<int*>(lw + lx.nR + lx.nT);  // [stride]
  for (int i = threadIdx.x; i < ro.stride; i += blockDim.x)
    li[i] = lx.idx[(long long)s * ro.stride + i];
  for (int i = threadIdx.x; i < lx.nR + lx.nT; i += blockDim.x)
    lw[i] = static_cast<const T*>(lx.wt)[(long long)s * (lx.nR + lx.nT) + i];
  __syncthreads();
  const int nA = li[0], nC = li[1], nO = li[2], nR = li[3], nT = li[4];
  const T lam_s = li[5] ? lam1 : lam0;

  // slice 0: eR's cotangent at (j-1, s), the O chain of target s
  if (k == 0) {
    const long long e1 = ((long long)(j - 1) * S + s) * B + bb;
    const T ev = eR[e1], gev = geR[e1];
    LSE<T> oo;
    for (int q0 = 0; q0 < nT; q0 += kAdjOps) {
      T x[kAdjOps];
#pragma unroll
      for (int q = 0; q < kAdjOps; ++q) {
        const int e = ext_adj_entry(q0 + q, lx.nT);
        x[q] = O[((long long)(r - 1) * S + li[ro.rt_s + e]) * B + bb];
      }
#pragma unroll
      for (int q = 0; q < kAdjOps; ++q) {
        const int e = ext_adj_entry(q0 + q, lx.nT), code = li[ro.rt_k + e];
        if (q0 + q < nT && !(pinR != 0 && (code & pinR) != pinR))
          oo.add(lw[lx.nR + e] + x[q]);
      }
    }
    if (b < B) geR[e1] = gev + share(Og_s, oo.result() + ev + gate, Ov_s);
  }
  // slice 1: the chain's term at the O cotangent of row j-1 (s as the
  // source of t <- s), added after the split terms; its class partials
  T chain = (T)0;
  const T ov1 = k == 1 ? O[o1] : ninf<T>();
  if (k == 1 && ov1 > ninf<T>()) {
    T* cp = static_cast<T*>(ax.cpR);
    const long long cp0 = (long long)s * B + bb, W1SB = (long long)W1 * S * B;
    T cls[4] = {0, 0, 0, 0};
    for (int q0 = 0; q0 < nR; q0 += kAdjOps) {
      T gt[kAdjOps], yt[kAdjOps], et[kAdjOps];
#pragma unroll
      for (int q = 0; q < kAdjOps; ++q) {
        const int t = li[ro.rtr_t + ext_adj_entry(q0 + q, lx.nR)];
        gt[q] = gO[orow + (long long)t * B];
        yt[q] = O[orow + (long long)t * B];
        et[q] = eR[((long long)(j - 1) * S + t) * B + bb];
      }
#pragma unroll
      for (int q = 0; q < kAdjOps; ++q) {
        const int e = ext_adj_entry(q0 + q, lx.nR), code = li[ro.rtr_k + e];
        if (q0 + q >= nR || (pinR != 0 && (code & pinR) != pinR)) continue;
        const T x = share(gt[q], lw[e] + ov1 + et[q] + gate, yt[q]);
        chain += x;
        if (cp)
          for (int c = 0; c < 4; ++c)
            if (code & (1 << c)) cls[c] += x;
      }
    }
    if (cp && b < B)
      for (int c = 0; c < 4; ++c) cp[c * W1SB + cp0] += cls[c];
  }

  // the splits at the thread's widths, one at a time: its own cells (the
  // next width's issued before this width's lists) say which lists hold
  // live terms there (a pruned band leaves most widths without a split),
  // and only those lists' cells are loaded, with the cotangents added to
  for (int w = k; w < W1; w += kAdjSlices) {
    const AdjOwn<T> o = cur;
    if (w + kAdjSlices < W1) cur = own(w + kAdjSlices);
    const bool split = w >= 1 && o.xe > ninf<T>();
    const bool liveA = split && o.pv > ninf<T>();
    const bool liveB = split && o.ov > ninf<T>();
    const bool liveO = o.ov > ninf<T>() && (split || w == 1);
    const int na = liveA ? nA : 0, nc = liveB ? nC : 0, no = split ? nO : 0;
    const int nmax = na > nc ? (na > no ? na : no) : (nc > no ? nc : no);
    const T ogP = liveA ? gP[TIDX(r, w, s, bb)] : (T)0;
    const T ogO = liveO ? gO[((long long)(r - w) * S + s) * B + bb] : (T)0;
    const T oDL = split ? DL[TIDX(j, w, s, bb)] : (T)0;
    T accA = (T)0, accB = (T)0, accC = (T)0;
    for (int q0 = 0; q0 < nmax; q0 += kAdjOps) {
      T aG[kAdjOps], aY[kAdjOps], aO[kAdjOps], cG[kAdjOps], cY[kAdjOps],
          cP[kAdjOps], oP[kAdjOps], oO[kAdjOps];
#pragma unroll
      for (int q = 0; q < kAdjOps; ++q) {
        const int ea = ext_adj_entry(q0 + q, lx.nA);
        const int ec = ext_adj_entry(q0 + q, lx.nC);
        const int eo = ext_adj_entry(q0 + q, lx.nO);
        const bool qa = q0 + q < na, qc = q0 + q < nc, qo = q0 + q < no;
        const int ta = li[ro.opa_t + ea], tc = li[ro.opc_t + ec];
        aG[q] = qa ? gO[orow + (long long)ta * B] : (T)0;
        aY[q] = qa ? O[orow + (long long)ta * B] : ninf<T>();
        aO[q] = qa ? O[((long long)(r - w) * S + li[ro.opa_c + ea]) * B + bb]
                   : ninf<T>();
        cG[q] = qc ? gO[orow + (long long)tc * B] : (T)0;
        cY[q] = qc ? O[orow + (long long)tc * B] : ninf<T>();
        cP[q] = qc ? P[TIDX(r, w, li[ro.opc_a + ec], bb)] : ninf<T>();
        oP[q] = qo ? P[TIDX(r, w, li[ro.op_a + eo], bb)] : ninf<T>();
        oO[q] = qo ? O[((long long)(r - w) * S + li[ro.op_c + eo]) * B + bb]
                   : ninf<T>();
      }
#pragma unroll
      for (int q = 0; q < kAdjOps; ++q) {
        const T la = li[ro.opa_b + ext_adj_entry(q0 + q, lx.nA)] ? lam1 : lam0;
        const T lc = li[ro.opc_b + ext_adj_entry(q0 + q, lx.nC)] ? lam1 : lam0;
        // (a) s as the P state of a split at width w
        if (q0 + q < na)
          accA += share(aG[q], o.pv + lam_mul(la, o.xe) + aO[q], aY[q]);
        // (b) s as the O state at row j - w
        if (q0 + q < nc)
          accB += share(cG[q], cP[q] + lam_mul(lc, o.xe) + o.ov, cY[q]);
        // (c) s as the target: lambda's exterior term at width w
        if (q0 + q < no)
          accC += share(Og_s, oP[q] + lam_mul(lam_s, o.xe) + oO[q], Ov_s);
      }
    }
    if (b >= B) continue;
    if (liveA) gP[TIDX(r, w, s, b)] = ogP + accA;
    if (liveO) {
      T v = ogO;
      if (split) v += accB;
      if (w == 1) v += chain;
      gO[((long long)(r - w) * S + s) * B + b] = v;
    }
    if (split) DL[TIDX(j, w, s, b)] = oDL + accC * o.xe;
  }
}

template <typename T>
static int ext_adj(DPDims D, ExtAdjLists lx, Aux ax, const T* O, const T* P,
                   const T* eR, const T* gate_O2, const T* ext, const T* lam,
                   T* gO, T* gP, T* geR, T* DL, cudaStream_t st) {
  if (D.Wp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int G = read_group<T>(D.B, D.S, kAdjGroupBytes);
  const long long smem = ext_adj_smem<T>(lx);
  const int rc = allow_smem((const void*)ext_adj_kernel<T>, smem);
  if (rc) return rc;
  dim3 grid((D.B + G - 1) / G, D.S);
  ext_adj_kernel<T><<<grid, G * kAdjSlices, smem, st>>>(
      D, lx, ax, O, P, eR, gate_O2, ext, lam, gO, gP, geR, DL, G);
  return static_cast<int>(cudaGetLastError());
}

#define EXT_ADJ_EXPORT(SUF, T)                                               \
  RNAELEM_EXPORT int rnaelem_ext_adj_##SUF(                                  \
      DPDims D, ExtAdjLists lx, Aux ax, const T* O, const T* P, const T* eR, \
      const T* gate_O2, const T* ext, const T* lam, T* gO, T* gP, T* geR,    \
      T* DL, cudaStream_t st) {                                              \
    return ext_adj<T>(D, lx, ax, O, P, eR, gate_O2, ext, lam, gO, gP, geR,   \
                      DL, st);                                               \
  }

EXT_ADJ_EXPORT(f32, float)
EXT_ADJ_EXPORT(f64, double)
