// K8: the no-rss forward chain (chain.cuh states the recursion and the
// design).  Replaces model/joint.py _linear_parts_one (row J,
// joint.py:594-631), the forward lax.scan.  Under the scanner's pin
// (common.cuh Aux) the step that emits a read's pinned base skips the
// vetoed transitions; the pin test is a template flag chosen at launch.
#include "chain.cuh"

// One block per read b, threads striding over the target states t; the
// chain row o_p lives in buffer p & 1 of o [2][S]
template <typename T, bool kPin>
__global__ void chain_fwd_kernel(ChainDims D, ChainIdx ix, Aux ax, const T* eR,
                                 const long long* L, T* Osave, T* parts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* o = reinterpret_cast<T*>(smem_raw);  // [2][S]
  const int Lp = D.Lp, S = D.S, B = D.B;
  const int b = blockIdx.x;
  const int Lb = L[b] < Lp ? static_cast<int>(L[b]) : Lp;
  const T* w = static_cast<const T*>(ix.rt_w);
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    const T v = t == ix.end_states[0] ? (T)0 : ninf<T>();
    o[t] = v;
    Osave[(long long)t * B + b] = v;
  }
  __syncthreads();
  for (int p = 0; p < Lb; ++p) {
    const T* cur = o + (p & 1) * S;
    T* nxt_row = o + ((p + 1) & 1) * S;
    const int pin = kPin ? pin_req(ax, b, p, kAuxR) : 0;
    for (int t = threadIdx.x; t < S; t += blockDim.x) {
      const T e = eR[((long long)p * S + t) * B + b];
      T m = ninf<T>();
      for (int k = ix.rt_off[t]; k < ix.rt_off[t + 1]; ++k) {
        if (vetoed(ax, pin, kAuxR, t, ix.rt_s[k], S)) continue;
        const T x = cur[ix.rt_s[k]] + w[k];
        m = x > m ? x : m;
      }
      T nxt = ninf<T>();
      if (m > ninf<T>()) {
        T s = (T)0;
        for (int k = ix.rt_off[t]; k < ix.rt_off[t + 1]; ++k) {
          if (vetoed(ax, pin, kAuxR, t, ix.rt_s[k], S)) continue;
          s += ex(cur[ix.rt_s[k]] + w[k] - m);
        }
        nxt = m + lg(s) + e;
      }
      nxt_row[t] = nxt;
      Osave[((long long)(p + 1) * S + t) * B + b] = nxt;
    }
    __syncthreads();
  }
  const T* fin = o + (Lb & 1) * S;
  if (threadIdx.x < 3)
    parts[(long long)b * 3 + threadIdx.x] = fin[ix.end_states[threadIdx.x]];
}

template <typename T>
static int chain_fwd(ChainDims D, ChainIdx ix, Aux ax, const T* eR,
                     const long long* L, T* Osave, T* parts,
                     cudaStream_t st) {
  auto kern = has_pin(ax) ? chain_fwd_kernel<T, true>
                          : chain_fwd_kernel<T, false>;
  const long long bytes = 2LL * D.S * sizeof(T);
  const int rc = allow_smem((const void*)kern, bytes);
  if (rc) return rc;
  kern<<<D.B, chain_threads(D.S), bytes, st>>>(D, ix, ax, eR, L, Osave,
                                               parts);
  return static_cast<int>(cudaGetLastError());
}

RNAELEM_EXPORT int rnaelem_chain_fwd_f32(ChainDims D, ChainIdx ix, Aux ax,
                                         const float* eR, const long long* L,
                                         float* Osave, float* parts,
                                         cudaStream_t st) {
  return chain_fwd<float>(D, ix, ax, eR, L, Osave, parts, st);
}

RNAELEM_EXPORT int rnaelem_chain_fwd_f64(ChainDims D, ChainIdx ix, Aux ax,
                                         const double* eR, const long long* L,
                                         double* Osave, double* parts,
                                         cudaStream_t st) {
  return chain_fwd<double>(D, ix, ax, eR, L, Osave, parts, st);
}
