// The no-rss forward chain over the motif states (K8, linear_fwd.cu) and
// its adjoint (K9, linear_adj.cu): what the two kernels share.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp program): model/joint.py
// _linear_parts_one (row J of the kernel table, joint.py:594-631), the
// lax.scan of a log-space [S, S] transition step over the read's bases,
// and its reverse-mode derivative (jax.grad through the scan).
//
//   o_0[t]     = 0 at end_states[0], -inf elsewhere
//   o_{p+1}[t] = log sum_s exp(o_p[s] + TR[t, s]) + eR[p, t]   (p < L_b)
//   parts[b]   = o_{L_b}[end_states]
//
// TR holds log tau on the tau-transitions, 0 on the others and -inf where
// the grammar has no transition; the kernels walk its finite entries as
// CSR lists (by target for K8, by source for K9), so tau = 0 simply drops
// the tau-transitions and no -inf weight is ever added.
//
// Bound on the H100: neither bytes nor operations but the sequential
// dependence: L_b steps per read, each a barrier-separated S x S sparse
// log-sum-exp (52 transitions among the 28 states of ..*..).  K8 reads
// eR once and writes the chain rows [Lp+1, S, B] (1.4 MB at f32 for
// B = 128 x 100 nt) for K9; K9 reads eR and those rows once and writes
// the cotangent of eR.  Design: one block per read, a thread per state
// (past 1,024 states the block's 1,024 threads stride over them), the
// chain row (K8) or its cotangent (K9) double-buffered in shared memory,
// one barrier per step; no atomics, every sum in a fixed order (each
// state's own transition list), so two runs give identical bits and a
// read's bits do not depend on the block's width.
#pragma once

#include "common.cuh"

struct ChainDims {
  int Lp, S, B;
};

struct ChainIdx {         // the DP's right-transition lists
  const int* rt_off;      // [S+1] CSR of transitions by target
  const int* rt_s;        //       source states
  const void* rt_w;       //       log weights (scalar type)
  const int* rtr_off;     // [S+1] CSR of transitions by source
  const int* rtr_t;       //       target states
  const void* rtr_w;      //       log weights
  const int* end_states;  // [3]
};

// a block's threads: one per state in whole warps, at most 1024
static inline int chain_threads(int S) {
  const int t = ((S + 31) / 32) * 32;
  return t < 1024 ? t : 1024;
}
