// K4 and K12: the exterior O column of one inside DP column j: the O
// self-chain (TT_O_O) and the O = O * P splits (TT_O_OP) weighted by the
// exterior loop energy per lambda bucket.  K4 is the sum DP
// (log-sum-exp), K12 the CYK tables (max): one kernel, a template on the
// semiring policy (common.cuh SumSR / MaxSR).
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): K4 ops/dp.py o_col /
// chain1 (row G of the kernel table, ops/dp.py:364-374, 601-618; the [B,
// 3] parts are then read at row L_b + PAD of each read's ragged length);
// K12 ops/dp_maxb.py o_col / chain1 (row L, :130, :340).
//
// Bound on the H100: bytes, and really latency: per read and column the
// split sum reads at most the P column [Wp+1, S] and the O window [Wp, S]
// once (12 KB per read in f32) and does n_op * Wp log-space terms (71 *
// 50 for pattern (.....)), a few microseconds of launch and one round trip
// to device memory at the least.  Design: one block per (target state t,
// group of G reads) of G * kExtSlices threads, thread (slice k, read g),
// the read fastest; slice k takes the widths w = 1 + k, 1 + k +
// kExtSlices, ... (two at Wp = 50).  Each thread issues all its loads
// (ext, then the P and O cells of kExtW widths x kExtOps splits at a
// time, every address valid, the unused ones masked after the loads, no
// branch between them) before it adds any term, and the slice kExtSlices
// - 1 also loads the O chain's terms (the right transitions' sources, eR,
// gate_O2) beside its widths, so the column is one round trip of loads,
// the terms, and a fixed tree over the slices in shared memory.  G is
// the largest of 32 bytes' worth of reads (8 f32, 4 f64: one sector of a
// row), 4, 2 or 1 that gives the grid at least one block per SM (the
// masks' S = 1 at B = 128: 128 blocks of one read).  Every sum over a
// read's cells keeps one order, given by t and the widths' slices alone:
// a read's O column does not depend on G or on its batch, and two runs
// give the same bits.  The terms keep the plain versions' association,
// (P + O) + ext and (TR + O) + eR + gate, so K12 equals the plain max DP
// bit for bit.  The scanner's pin set (common.cuh Aux) vetoes transitions
// at the pinned bases: the O chain skips the vetoed transitions that emit
// base j-1; the splits carry no aux.
#include "common.cuh"

static const int kExtSlices = 32;      // width slices per read
static const int kExtGroupBytes = 32;  // a row's reads per block at most
static const int kExtW = 2;            // widths whose loads go out together
static const int kExtOps = 2;          // splits (or chain terms) likewise
static const int kExtGMax = kExtGroupBytes / 4;

struct ExtIdx {
  const int* rt_off;   // [S+1] CSR of right transitions by target
  const int* rt_s;     //       source states
  const void* rt_w;    //       log weights (scalar type)
  const int* bucket;   // [S]
  const int* op_off;   // [S+1] CSR of (a = P state, c = O state) by target
  const int* op_a;
  const int* op_c;
};

template <typename T, class SR>
__global__ void __launch_bounds__(kExtSlices * kExtGMax)
ext_col_kernel(DPDims D, ExtIdx ix, Aux ax, T* O, const T* P, const T* eR,
               const T* gate_O2, const T* ext, const T* lam, int G) {
  using Acc = typename SR::Acc;
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j, r = j + D.PAD;
  const int t = blockIdx.y, g = threadIdx.x % G, k = threadIdx.x / G;
  const int b = blockIdx.x * G + g;
  const int bb = b < B ? b : B - 1;   // the loads of a lane past B
  __shared__ T pm[kExtSlices][kExtGMax], ps[kExtSlices][kExtGMax];
  __shared__ T chain[kExtGMax];
  const int o0 = ix.op_off[t], o1 = ix.op_off[t + 1];
  const T lam_t = lam[ix.bucket[t]];
  // the O chain from row j-1 (the last slice): the loads of its pin, its
  // first kExtOps right transitions, eR and gate_O2 go out before the
  // splits'
  const bool has_chain = k == kExtSlices - 1;
  const T* rtw = static_cast<const T*>(ix.rt_w);
  const int c0 = ix.rt_off[t], c1 = ix.rt_off[t + 1];
  T cv[kExtOps], ev = (T)0, gv = (T)0;
  int cs[kExtOps], pinR = 0;
  if (has_chain) {
    pinR = pin_req(ax, bb, j - 1, kAuxR);
#pragma unroll
    for (int q = 0; q < kExtOps; ++q) {
      const int qq = c0 + q < c1 ? c0 + q : c0;
      cs[q] = c0 < c1 ? ix.rt_s[qq] : 0;
      cv[q] = c0 < c1 ? rtw[qq] + O[((long long)(r - 1) * S + cs[q]) * B + bb]
                      : ninf<T>();
    }
    ev = eR[((long long)(j - 1) * S + t) * B + bb];
    gv = gate_O2[(long long)(j - 1) * B + bb];
  }
  // O(j-w) * P(j-w, j) splits with the exterior energy of the pair
  Acc acc;
  for (int wb = 1 + k; wb < W1; wb += kExtW * kExtSlices) {
    T e[kExtW];
#pragma unroll
    for (int i = 0; i < kExtW; ++i) {
      const int w = wb + i * kExtSlices;
      e[i] = ext[((long long)j * W1 + (w < W1 ? w : wb)) * B + bb];
    }
    for (int q0 = o0; q0 < o1; q0 += kExtOps) {
      T pv[kExtW][kExtOps], ov[kExtW][kExtOps];
#pragma unroll
      for (int q = 0; q < kExtOps; ++q) {
        const int qq = q0 + q < o1 ? q0 + q : o0;
        const int a = ix.op_a[qq], c = ix.op_c[qq];
#pragma unroll
        for (int i = 0; i < kExtW; ++i) {
          const int w = wb + i * kExtSlices < W1 ? wb + i * kExtSlices : wb;
          pv[i][q] = P[(((long long)r * W1 + w) * S + a) * B + bb];
          ov[i][q] = O[((long long)(r - w) * S + c) * B + bb];
        }
      }
      T x[kExtW * kExtOps];
#pragma unroll
      for (int i = 0; i < kExtW; ++i) {
        const T ei = wb + i * kExtSlices < W1 ? lam_mul(lam_t, e[i])
                                              : ninf<T>();
#pragma unroll
        for (int q = 0; q < kExtOps; ++q)
          x[i * kExtOps + q] =
              q0 + q < o1 ? (pv[i][q] + ov[i][q]) + ei : ninf<T>();
      }
      acc.add_n(x);
    }
  }
  if (has_chain) {
    Acc oo;
    for (int q0 = c0; q0 < c1; q0 += kExtOps) {
      T x[kExtOps];
#pragma unroll
      for (int q = 0; q < kExtOps; ++q) {
        if (q0 > c0) {   // the chunks past the first, loaded here
          const int qq = q0 + q < c1 ? q0 + q : c0;
          cs[q] = ix.rt_s[qq];
          cv[q] = rtw[qq] + O[((long long)(r - 1) * S + cs[q]) * B + bb];
        }
        x[q] = q0 + q < c1 && !vetoed(ax, pinR, kAuxR, t, cs[q], S)
                   ? cv[q] : ninf<T>();
      }
      oo.add_n(x);
    }
    chain[g] = oo.result() + ev + gv;
  }
  // the slices' partial sums meet in a fixed tree: slice k takes k + h
  pm[k][g] = acc.m;
  ps[k][g] = acc.scale();
  __syncthreads();
  for (int h = kExtSlices / 2; h > 0; h >>= 1) {
    if (k < h) {
      Acc a(pm[k][g], ps[k][g]);
      a.merge(Acc(pm[k + h][g], ps[k + h][g]));
      pm[k][g] = a.m;
      ps[k][g] = a.scale();
    }
    __syncthreads();
  }
  if (k == 0 && b < B)
    O[((long long)r * S + t) * B + b] =
        SR::plus(chain[g], Acc(pm[0][g], ps[0][g]).result());
}

template <typename T, class SR>
static int ext_col(DPDims D, ExtIdx ix, Aux ax, T* O, const T* P, const T* eR,
                   const T* gate_O2, const T* ext, const T* lam,
                   cudaStream_t st) {
  const int G = read_group<T>(D.B, D.S, kExtGroupBytes);
  dim3 grid((D.B + G - 1) / G, D.S);
  ext_col_kernel<T, SR><<<grid, G * kExtSlices, 0, st>>>(
      D, ix, ax, O, P, eR, gate_O2, ext, lam, G);
  return static_cast<int>(cudaGetLastError());
}

// rnaelem_ext_col_<type> (K4, sum) and rnaelem_ext_col_max_<type> (K12)
#define EXT_EXPORT(SUF, T, SR)                                               \
  RNAELEM_EXPORT int rnaelem_ext_col_##SUF(                                  \
      DPDims D, ExtIdx ix, Aux ax, T* O, const T* P, const T* eR,            \
      const T* gate_O2, const T* ext, const T* lam, cudaStream_t st) {       \
    return ext_col<T, SR>(D, ix, ax, O, P, eR, gate_O2, ext, lam, st);       \
  }

EXT_EXPORT(f32, float, SumSR<float>)
EXT_EXPORT(f64, double, SumSR<double>)
EXT_EXPORT(max_f32, float, MaxSR<float>)
EXT_EXPORT(max_f64, double, MaxSR<double>)
