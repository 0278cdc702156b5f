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
// Bound on the H100: bytes, and really launch latency: per read and
// column the split sum reads at most the P column [Wp+1, S] and the O
// window [Wp, S] once (12 KB per read in f32) and does n_op * Wp
// log-space terms (71 * 50 for pattern (.....)).  Design: one block per
// (target state, 32 reads) with the read fastest (coalesced) and eight
// warps splitting w = 1..Wp, each a direct log-space online log-sum-exp
// (a running max for K12) over the target's sparse (a, c) split list,
// merged in shared memory; slot w = 0 is skipped (P at width 0 is masked
// out).  The scanner's pin set (common.cuh Aux) vetoes transitions at the
// pinned bases: the O chain skips the vetoed transitions that emit base
// j-1; the splits carry no aux.
#include "common.cuh"

struct ExtIdx {
  const int* rt_off;   // [S+1] CSR of right transitions by target
  const int* rt_s;     //       source states
  const void* rt_w;    //       log weights (scalar type)
  const int* bucket;   // [S]
  const int* op_off;   // [S+1] CSR of (a = P state, c = O state) by target
  const int* op_a;
  const int* op_c;
};

// one block per (target t, tile of 32 reads): lane = read, the 8 warps
// split w = 1..Wp; partial (max, sum) pairs are merged in shared memory
template <typename T, class SR>
__global__ void ext_col_kernel(DPDims D, ExtIdx ix, Aux ax, T* O, const T* P,
                               const T* eR, const T* gate_O2, const T* ext,
                               const T* lam) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j;
  const int t = blockIdx.y;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int r = j + D.PAD;
  __shared__ T part[8][32];
  typename SR::Acc op;
  if (b < B) {
    // O(j-w) * P(j-w, j) splits with the exterior energy of the pair
    const T lam_t = lam[ix.bucket[t]];
    for (int w = 1 + threadIdx.y; w < W1; w += blockDim.y) {
      const T e = lam_mul(lam_t, ext[((long long)j * W1 + w) * B + b]);
      if (!(e > ninf<T>())) continue;
      for (int k = ix.op_off[t]; k < ix.op_off[t + 1]; ++k) {
        const T pv = P[(((long long)r * W1 + w) * S + ix.op_a[k]) * B + b];
        if (!(pv > ninf<T>())) continue;
        op.add(pv + e + O[((long long)(r - w) * S + ix.op_c[k]) * B + b]);
      }
    }
  }
  part[threadIdx.y][threadIdx.x] = op.result();
  __syncthreads();
  if (threadIdx.y != 0 || b >= B) return;
  typename SR::Acc all;
  for (int y = 0; y < blockDim.y; ++y) all.add(part[y][threadIdx.x]);
  // O chain from row j-1
  const T* rtw = static_cast<const T*>(ix.rt_w);
  const int pinR = pin_req(ax, b, j - 1, kAuxR);
  typename SR::Acc oo;
  for (int k = ix.rt_off[t]; k < ix.rt_off[t + 1]; ++k) {
    if (vetoed(ax, pinR, kAuxR, t, ix.rt_s[k], S)) continue;
    oo.add(rtw[k] + O[((long long)(r - 1) * S + ix.rt_s[k]) * B + b]);
  }
  const T oov = oo.result() + eR[((long long)(j - 1) * S + t) * B + b] +
                gate_O2[(long long)(j - 1) * B + b];
  O[((long long)r * S + t) * B + b] = SR::plus(oov, all.result());
}

template <typename T, class SR>
static int ext_col(DPDims D, ExtIdx ix, Aux ax, T* O, const T* P, const T* eR,
                   const T* gate_O2, const T* ext, const T* lam,
                   cudaStream_t st) {
  dim3 block(32, 8);
  dim3 grid((D.B + 31) / 32, D.S);
  ext_col_kernel<T, SR><<<grid, block, 0, st>>>(D, ix, ax, O, P, eR, gate_O2,
                                                ext, lam);
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
