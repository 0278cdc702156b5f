// K9: the adjoint of the no-rss chain (chain.cuh states the recursion
// and the design).  Replaces the reverse-mode derivative of
// model/joint.py _linear_parts_one (row J, joint.py:594-631), jax.grad
// through the lax.scan.  Under the scanner's pin (common.cuh Aux) the
// vetoed transitions of a read's pinned base are skipped; with ax.cpR the
// kernel also writes the class sums [4, Lp, B] of the transition
// posteriors per base (zero beyond the read): each thread's per-class
// sums go to shared memory, and threads 0..3 add them over the states in
// a fixed order between the step's two barriers.  Pin and class sums are
// a template flag chosen at launch: without them the loop is K9's own.
#include "chain.cuh"

// One block per read b, threads striding over the source states s.  g
// (buffer p & 1 of [2][S]) holds the cotangent of o_{p+1}; the step's
// derivative sends it back to the sources through the softmax weights
// exp(o_p[s] + TR[t, s] + eR[p, t] - o_{p+1}[t]) and, unchanged, to
// eR[p, t].  Rows p >= L_b of the cotangent are zero (the chain stops at
// the read's end).
template <typename T, bool kAux>
__global__ void chain_adj_kernel(ChainDims D, ChainIdx ix, Aux ax, const T* eR,
                                 const long long* L, const T* Osave,
                                 const T* gparts, T* g_eR) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gb = reinterpret_cast<T*>(smem_raw);  // [2][S]
  T* part = gb + 2 * D.S;                    // [4, S]
  const int Lp = D.Lp, S = D.S, B = D.B;
  const int b = blockIdx.x;
  const int Lb = L[b] < Lp ? static_cast<int>(L[b]) : Lp;
  const T* w = static_cast<const T*>(ix.rtr_w);
  T* cls = kAux ? static_cast<T*>(ax.cpR) : nullptr;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    T v = (T)0;
    for (int k = 0; k < 3; ++k)
      if (ix.end_states[k] == s) v += gparts[(long long)b * 3 + k];
    gb[(Lb & 1) * S + s] = v;
    for (int p = Lb; p < Lp; ++p) g_eR[((long long)p * S + s) * B + b] = 0;
  }
  if (cls && threadIdx.x < 4)
    for (int p = Lb; p < Lp; ++p)
      cls[((long long)threadIdx.x * Lp + p) * B + b] = 0;
  __syncthreads();
  for (int p = Lb - 1; p >= 0; --p) {
    const T* g = gb + ((p + 1) & 1) * S;   // the cotangent of o_{p+1}
    T* gnext = gb + (p & 1) * S;           // that of o_p
    const int pin = kAux ? pin_req(ax, b, p, kAuxR) : 0;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      T gnew = (T)0, acc[4] = {0, 0, 0, 0};
      g_eR[((long long)p * S + s) * B + b] = g[s];
      const T os = Osave[((long long)p * S + s) * B + b];
      if (os > ninf<T>()) {
        for (int k = ix.rtr_off[s]; k < ix.rtr_off[s + 1]; ++k) {
          const int t = ix.rtr_t[k];
          const T gt = g[t];
          if (gt == (T)0 || vetoed(ax, pin, kAuxR, t, s, S)) continue;
          const T on = Osave[((long long)(p + 1) * S + t) * B + b];
          if (!(on > ninf<T>())) continue;
          const T x =
              gt * ex(os + w[k] + eR[((long long)p * S + t) * B + b] - on);
          gnew += x;
          if (cls) add_classes(ax, kAuxR, t, s, S, x, acc);
        }
      }
      if (cls)
        for (int c = 0; c < 4; ++c) part[c * S + s] = acc[c];
      gnext[s] = gnew;
    }
    __syncthreads();
    if (cls) {
      if (threadIdx.x < 4) {
        T tot = (T)0;
        for (int q = 0; q < S; ++q) tot += part[threadIdx.x * S + q];
        cls[((long long)threadIdx.x * Lp + p) * B + b] = tot;
      }
      __syncthreads();
    }
  }
}

template <typename T>
static int chain_adj(ChainDims D, ChainIdx ix, Aux ax, const T* eR,
                     const long long* L, const T* Osave, const T* gparts,
                     T* g_eR, cudaStream_t st) {
  const bool aux = has_pin(ax) || ax.cpR;
  auto kern = aux ? chain_adj_kernel<T, true> : chain_adj_kernel<T, false>;
  const long long bytes = (aux ? 6LL : 2LL) * D.S * sizeof(T);
  const int rc = allow_smem((const void*)kern, bytes);
  if (rc) return rc;
  kern<<<D.B, chain_threads(D.S), bytes, st>>>(D, ix, ax, eR, L, Osave,
                                               gparts, g_eR);
  return static_cast<int>(cudaGetLastError());
}

RNAELEM_EXPORT int rnaelem_chain_adj_f32(ChainDims D, ChainIdx ix, Aux ax,
                                         const float* eR, const long long* L,
                                         const float* Osave,
                                         const float* gparts, float* g_eR,
                                         cudaStream_t st) {
  return chain_adj<float>(D, ix, ax, eR, L, Osave, gparts, g_eR, st);
}

RNAELEM_EXPORT int rnaelem_chain_adj_f64(ChainDims D, ChainIdx ix, Aux ax,
                                         const double* eR, const long long* L,
                                         const double* Osave,
                                         const double* gparts, double* g_eR,
                                         cudaStream_t st) {
  return chain_adj<double>(D, ix, ax, eR, L, Osave, gparts, g_eR, st);
}
