// K9: the adjoint of the no-rss chain (chain.cuh states the recursion
// and the design).  Replaces the reverse-mode derivative of
// model/joint.py _linear_parts_one (row J, joint.py:594-631), jax.grad
// through the lax.scan.
#include "chain.cuh"

// One block per read b, thread s = source state.  g holds the
// cotangent of o_{p+1}; the step's derivative sends it back to the
// sources through the softmax weights exp(o_p[s] + TR[t, s] + eR[p, t]
// - o_{p+1}[t]) and, unchanged, to eR[p, t].  Rows p >= L_b of the
// cotangent are zero (the chain stops at the read's end).
template <typename T>
__global__ void chain_adj_kernel(ChainDims D, ChainIdx ix, const T* eR,
                                 const long long* L, const T* Osave,
                                 const T* gparts, T* g_eR) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* g = reinterpret_cast<T*>(smem_raw);  // [S]
  const int Lp = D.Lp, S = D.S, B = D.B;
  const int b = blockIdx.x, s = threadIdx.x;
  const int Lb = L[b] < Lp ? static_cast<int>(L[b]) : Lp;
  const T* w = static_cast<const T*>(ix.rtr_w);
  if (s < S) {
    T v = (T)0;
    for (int k = 0; k < 3; ++k)
      if (ix.end_states[k] == s) v += gparts[(long long)b * 3 + k];
    g[s] = v;
    for (int p = Lb; p < Lp; ++p) g_eR[((long long)p * S + s) * B + b] = 0;
  }
  __syncthreads();
  for (int p = Lb - 1; p >= 0; --p) {
    T gnew = (T)0;
    if (s < S) {
      g_eR[((long long)p * S + s) * B + b] = g[s];
      const T os = Osave[((long long)p * S + s) * B + b];
      if (os > ninf<T>()) {
        for (int k = ix.rtr_off[s]; k < ix.rtr_off[s + 1]; ++k) {
          const int t = ix.rtr_t[k];
          const T gt = g[t];
          if (gt == (T)0) continue;
          const T on = Osave[((long long)(p + 1) * S + t) * B + b];
          if (!(on > ninf<T>())) continue;
          gnew += gt * ex(os + w[k] + eR[((long long)p * S + t) * B + b] - on);
        }
      }
    }
    __syncthreads();
    if (s < S) g[s] = gnew;
    __syncthreads();
  }
}

template <typename T>
static int chain_adj(ChainDims D, ChainIdx ix, const T* eR,
                     const long long* L, const T* Osave, const T* gparts,
                     T* g_eR, cudaStream_t st) {
  chain_adj_kernel<T><<<D.B, chain_threads(D.S), D.S * sizeof(T), st>>>(
      D, ix, eR, L, Osave, gparts, g_eR);
  return static_cast<int>(cudaGetLastError());
}

RNAELEM_EXPORT int rnaelem_chain_adj_f32(ChainDims D, ChainIdx ix,
                                         const float* eR, const long long* L,
                                         const float* Osave,
                                         const float* gparts, float* g_eR,
                                         cudaStream_t st) {
  return chain_adj<float>(D, ix, eR, L, Osave, gparts, g_eR, st);
}

RNAELEM_EXPORT int rnaelem_chain_adj_f64(ChainDims D, ChainIdx ix,
                                         const double* eR, const long long* L,
                                         const double* Osave,
                                         const double* gparts, double* g_eR,
                                         cudaStream_t st) {
  return chain_adj<double>(D, ix, eR, L, Osave, gparts, g_eR, st);
}
