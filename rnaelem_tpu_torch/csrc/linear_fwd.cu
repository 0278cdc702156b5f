// K8: the no-rss forward chain (chain.cuh states the recursion and the
// design).  Replaces model/joint.py _linear_parts_one (row J,
// joint.py:594-631), the forward lax.scan.  Under the scanner's pin
// (common.cuh Aux) the step that emits a read's pinned base skips the
// vetoed transitions; the pin test is a template flag chosen at launch,
// the pinned bases held in registers.
#include "chain.cuh"

// One block per read, a cell per target state t.  Step p takes its eR
// cells from the ring (copied kChainRing - 1 steps ahead by the thread
// that reads them) and its sources' values from the published row o_p
// (slot p & 1 of o [2][n]) or, in the one-warp block (kWarp: S <= 32),
// from the lanes that hold them, by shuffles, with no row and no barrier
// at all.  Every source value is fetched before any is used: the max and
// the sum run over the cell's list in registers in list order, without a
// branch per entry, then m + log(sum) + eR.  Rows beyond the read's
// length are not written.
template <typename T, int NC, bool kPin, bool kWarp>
__global__ void __launch_bounds__(kChainMaxThreads)
chain_fwd_kernel(ChainDims D, ChainIdx ix, Aux ax, const T* eR,
                 const long long* L, T* Osave, T* parts) {
  static_assert(!kWarp || NC == 1, "a warp holds one cell a lane");
  using List = ChainList<T, ChainSrc<NC>::N>;
  constexpr int N = ChainSrc<NC>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = D.Lp, S = D.S, B = D.B;
  const ChainFwdLayout lay(S, sizeof(T));
  const int n = (int)lay.n;
  T* o = reinterpret_cast<T*>(smem_raw + lay.o);        // [2][n]
  T* ring = reinterpret_cast<T*>(smem_raw + lay.ring);  // [kChainRing][n]
  const int b = blockIdx.x;
  const int Lb = read_len(L, b, Lp);
  const long long SB = (long long)S * B;
  const T* w = static_cast<const T*>(ix.rt_w);
  int cid[NC];
  bool live[NC];
  const T* src[NC];  // the cell's eR value of the next step to copy
  T* dst[NC];        // its chain value of the next step
  T v[NC];           // its chain value (kWarp)
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    cid[k] = threadIdx.x + k * blockDim.x;
    live[k] = cid[k] < S;
    src[k] = eR + (long long)cid[k] * B + b;
    dst[k] = Osave + (long long)cid[k] * B + b;
  }
  int next = 0;  // the next step to copy
  auto issue = [&]() {
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (live[k] && next < Lb)
        cp_async_t(ring + (next & (kChainRing - 1)) * n + cid[k], src[k]);
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < NC; ++k) src[k] += SB;
    ++next;
  };
  for (int p = 0; p < kChainRing - 1; ++p) issue();
  List lst[NC];
  int wide = 0;  // list entries past the registers' (kWarp: the warp's most)
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    lst[k] = chain_list<T, N>(ix.rt_off, ix.rt_s, w, ax.code, cid[k], S,
                              true, live[k], kPin);
    const int more = lst[k].k1 - lst[k].k0 - N;
    wide = more > wide ? more : wide;
    v[k] = cid[k] == ix.end_states[0] ? (T)0 : ninf<T>();
    if (live[k]) {
      if (!kWarp) o[cid[k]] = v[k];
      *dst[k] = v[k];
    }
  }
  if (kWarp) wide = __reduce_max_sync(0xffffffffu, wide);
  PinRegs pr;
  if (kPin) pr = pin_regs(ax, b, kAuxR);
  if (!kWarp) mchain_sync();
  for (int p = 0; p < Lb; ++p) {
    issue();
    const T* cur = o + (p & 1) * n;
    T* nxt_row = o + ((p + 1) & 1) * n;
    const int req = kPin ? pin_req_reg(ax, pr, p) : 0;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      dst[k] += SB;
      if (!kWarp && !live[k]) continue;
      // the value of the source in cell c (the warp's: lane c)
      auto at = [&](int c) -> T {
        if constexpr (kWarp)
          return __shfl_sync(0xffffffffu, v[k], c);
        else
          return cur[c];
      };
      const List& l = lst[k];
      const int t = cid[k];
      T x[N];
      bool on[N];
#pragma unroll
      for (int q = 0; q < N; ++q) {
        x[q] = at(l.cell[q]) + l.w[q];
        on[q] = q < l.nin && !(kPin && vetoed_code(req, l.code[q]));
      }
      T m = ninf<T>();
#pragma unroll
      for (int q = 0; q < N; ++q) m = on[q] && x[q] > m ? x[q] : m;
      const int kw = kWarp ? wide : l.k1 - l.k0 - N;
      for (int j = 0; j < kw; ++j) {
        const int kk = l.k0 + N + j;
        const bool in = kk < l.k1;
        const int sk = in ? ix.rt_s[kk] : 0;
        const T y = at(sk) + (in ? w[kk] : (T)0);
        if (in && !vetoed(ax, req, kAuxR, t, sk, S)) m = y > m ? y : m;
      }
      const bool any = m > ninf<T>();
      const T m0 = any ? m : (T)0;
      T ev[N], s = (T)0;
#pragma unroll
      for (int q = 0; q < N; ++q) ev[q] = ex(x[q] - m0);
#pragma unroll
      for (int q = 0; q < N; ++q)
        if (on[q]) s += ev[q];
      for (int j = 0; j < kw; ++j) {
        const int kk = l.k0 + N + j;
        const bool in = kk < l.k1;
        const int sk = in ? ix.rt_s[kk] : 0;
        const T y = at(sk) + (in ? w[kk] : (T)0);
        if (in && !vetoed(ax, req, kAuxR, t, sk, S)) s += ex(y - m0);
      }
      cp_async_wait<kChainRing - 1>();
      const T e = ring[(p & (kChainRing - 1)) * n + cid[k]];
      const T nxt = any ? m0 + lg(s) + e : ninf<T>();
      if (!live[k]) continue;
      if (kWarp)
        v[k] = nxt;
      else
        nxt_row[cid[k]] = nxt;
      *dst[k] = nxt;
    }
    if (!kWarp) mchain_sync();
  }
  cp_async_wait<0>();
  if (kWarp) {
    const T f0 = __shfl_sync(0xffffffffu, v[0], ix.end_states[0]);
    const T f1 = __shfl_sync(0xffffffffu, v[0], ix.end_states[1]);
    const T f2 = __shfl_sync(0xffffffffu, v[0], ix.end_states[2]);
    if (threadIdx.x < 3)
      parts[(long long)b * 3 + threadIdx.x] =
          threadIdx.x == 0 ? f0 : (threadIdx.x == 1 ? f1 : f2);
    return;
  }
  const T* fin = o + (Lb & 1) * n;
  if (threadIdx.x < 3)
    parts[(long long)b * 3 + threadIdx.x] = fin[ix.end_states[threadIdx.x]];
}

template <typename T>
static int chain_fwd(ChainDims D, ChainIdx ix, Aux ax, ChainGrid pg,
                     const T* eR, const long long* L, T* Osave, T* parts,
                     cudaStream_t st) {
  const ChainFwdLayout lay(D.S, sizeof(T));
  if (pg.R != kChainRing || pg.dev || !chain_grid_ok(D, pg, lay.total, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pin = has_pin(ax);
  const bool warp = chain_threads(D.S, 1) == 32;  // the one-warp block
  return chain_dispatch(pg.NC, [&](auto NC_) {
    constexpr int NC = decltype(NC_)::value;
    constexpr bool kW = NC == 1;
    auto kern = warp ? (pin ? chain_fwd_kernel<T, NC, true, kW>
                            : chain_fwd_kernel<T, NC, false, kW>)
                     : (pin ? chain_fwd_kernel<T, NC, true, false>
                            : chain_fwd_kernel<T, NC, false, false>);
    const int rc = allow_smem((const void*)kern, lay.total);
    if (rc) return rc;
    kern<<<D.B, pg.threads, lay.total, st>>>(D, ix, ax, eR, L, Osave, parts);
    return static_cast<int>(cudaGetLastError());
  });
}

RNAELEM_EXPORT int rnaelem_chain_fwd_f32(ChainDims D, ChainIdx ix, Aux ax,
                                         ChainGrid pg, const float* eR,
                                         const long long* L, float* Osave,
                                         float* parts, cudaStream_t st) {
  return chain_fwd<float>(D, ix, ax, pg, eR, L, Osave, parts, st);
}

RNAELEM_EXPORT int rnaelem_chain_fwd_f64(ChainDims D, ChainIdx ix, Aux ax,
                                         ChainGrid pg, const double* eR,
                                         const long long* L, double* Osave,
                                         double* parts, cudaStream_t st) {
  return chain_fwd<double>(D, ix, ax, pg, eR, L, Osave, parts, st);
}

// the chain kernels' layout bytes (chain.cuh): which 0 = K8 (R unused), 1 =
// K9 with a tile of R steps, 2 = K9 with the class sums' partials
RNAELEM_EXPORT long long rnaelem_chain_smem_bytes(int which, int S, int R,
                                                  int nnz, int itemsize) {
  return which == 0 ? ChainFwdLayout(S, itemsize).total
                    : ChainAdjLayout(S, R, nnz, which == 2, itemsize).total;
}
