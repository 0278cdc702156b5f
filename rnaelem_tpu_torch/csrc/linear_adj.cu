// K9: the adjoint of the no-rss chain (chain.cuh states the recursion
// and the design).  Replaces the reverse-mode derivative of
// model/joint.py _linear_parts_one (row J, joint.py:594-631), jax.grad
// through the lax.scan.  Under the scanner's pin (common.cuh Aux) the
// vetoed transitions of a read's pinned base are skipped; with ax.cpR the
// kernel also writes the class sums [4, Lp, B] of the transition
// posteriors per base (zero beyond the read).  Pin and class sums are a
// template flag chosen at launch (kAux).
#include "chain.cuh"

// x * y + z with its roundings fixed, so that the compiler's contraction
// cannot move a read's bits: one fused multiply-add without kAux; with
// it a rounded product (the posterior, which also feeds the class sums)
// and a rounded sum
template <bool kAux>
__device__ __forceinline__ float chain_madd(float x, float y, float z) {
  return kAux ? __fadd_rn(z, __fmul_rn(x, y)) : __fmaf_rn(x, y, z);
}
template <bool kAux>
__device__ __forceinline__ double chain_madd(double x, double y, double z) {
  return kAux ? __dadd_rn(z, __dmul_rn(x, y)) : __fma_rn(x, y, z);
}
__device__ __forceinline__ float chain_mul(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double chain_mul(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ float chain_add(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double chain_add(double x, double y) {
  return __dadd_rn(x, y);
}

// One block per read, a cell per source state s.  The step p derivative
// sends the cotangent of o_{p+1} back to the sources through the softmax
// weights W[p, k] = exp(o_p[s] + TR[t, s] + eR[p, t] - o_{p+1}[t]) of
// the entries k (t <- s) of s's list and, unchanged, to eR[p, t].  The
// read's steps are taken in tiles of R (from the last): (a) stage the
// tile's chain rows and eR rows, and compute every weight of the tile,
// each cell its own list's, in parallel over the steps (the helpers h = 1
// .. H-1 taking every H-th step beside the walkers); (b) the walkers walk
// the tile's steps backwards, g_p[s] = sum_k g_{p+1}[t_k] W[p, k] in list
// order (entries with a zero cotangent or no weight skipped), one barrier
// a step (none in the one-warp walk, kWarp, whose lanes hold the row and
// shuffle it); (c) with the class sums, each cell adds its list's
// posteriors g_{p+1}[t] W[p, k] per class in the walk (off its dependent
// path), and after the walk each (step, class) adds the cells' partials
// in ascending state order.  Rows p >= L_b of the cotangent and of the
// class sums are zero (the chain stops at the read's end).
template <typename T, int NC, bool kAux, bool kDev, bool kWarp>
__global__ void __launch_bounds__(kChainMaxThreads)
chain_adj_kernel(ChainDims D, ChainIdx ix, Aux ax, ChainGrid pg, const T* eR,
                 const long long* L, const T* Osave, const T* gparts,
                 T* g_eR, unsigned char* ws) {
  static_assert(!kWarp || NC == 1, "a warp holds one cell a lane");
  using List = ChainList<T, ChainSrc<NC>::N>;
  constexpr int N = ChainSrc<NC>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = D.Lp, S = D.S, B = D.B, R = pg.R, nnz = pg.nnz;
  T* cls = kAux ? static_cast<T*>(ax.cpR) : nullptr;
  const ChainAdjLayout lay(S, R, nnz, kAux, sizeof(T));
  unsigned char* base = mchain_base<kDev>(smem_raw, ws, lay.total);
  const int n = (int)lay.n;
  T* W = reinterpret_cast<T*>(base + lay.w);     // [R][nnz]
  T* gr = reinterpret_cast<T*>(base + lay.g);    // [R+1][n], row r % (R+1)
  T* orow = reinterpret_cast<T*>(base + lay.o);  // [R+1][n], rows lo..hi
  T* erow = reinterpret_cast<T*>(base + lay.e);  // [R][n], rows lo..hi-1
  T* part = reinterpret_cast<T*>(base + lay.part);  // [R][4][n]
  // the walkers: the first `walkers` threads own the cells; the block's
  // helpers (the walkers' copies h = 1 .. H-1) share the staging, the
  // weights and the class sums, never the walk
  const int walkers = chain_threads(S, NC), H = blockDim.x / walkers;
  const int h = threadIdx.x / walkers, tw = threadIdx.x - h * walkers;
  const int b = blockIdx.x;
  const int Lb = read_len(L, b, Lp);
  const long long SB = (long long)S * B;
  const T* w = static_cast<const T*>(ix.rtr_w);
  int cid[NC];
  bool live[NC];
  long long cell[NC];
  List lst[NC];
  T gv[NC];      // the cell's cotangent (kWarp: the walk's row)
  int wide = 0;  // list entries past the registers' (kWarp: the warp's most)
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    cid[k] = tw + k * walkers;
    const int s = cid[k];
    live[k] = s < S;
    cell[k] = (long long)s * B + b;
    lst[k] = chain_list<T, N>(ix.rtr_off, ix.rtr_t, w, ax.code, s, S, false,
                              live[k], kAux);
    const int more = lst[k].k1 - lst[k].k0 - N;
    wide = more > wide ? more : wide;
    gv[k] = (T)0;
    if (!live[k] || h) continue;
    for (int e = 0; e < 3; ++e)
      if (ix.end_states[e] == s) gv[k] += gparts[(long long)b * 3 + e];
    if (!kWarp) gr[(Lb % (R + 1)) * n + cid[k]] = gv[k];
    for (int p = Lb; p < Lp; ++p) g_eR[p * SB + cell[k]] = 0;
  }
  if (kWarp) wide = __reduce_max_sync(0xffffffffu, wide);
  if (cls && threadIdx.x < 4)
    for (int p = Lb; p < Lp; ++p)
      cls[((long long)threadIdx.x * Lp + p) * B + b] = 0;
  PinRegs pr;
  if (kAux) pr = pin_regs(ax, b, kAuxR);
  for (int hi = Lb; hi > 0;) {
    const int lo = hi - R > 0 ? hi - R : 0;
    // (a) the tile's chain rows lo..hi and eR rows lo..hi-1, then each
    // cell's weights
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (!live[k]) continue;
      const T* so = Osave + (lo + h) * SB + cell[k];
      const T* se = eR + (lo + h) * SB + cell[k];
      for (int r = h; r <= hi - lo; r += H, so += H * SB)
        mchain_copy<kDev>(orow + r * n + cid[k], so);
      for (int r = h; r < hi - lo; r += H, se += H * SB)
        mchain_copy<kDev>(erow + r * n + cid[k], se);
    }
    mchain_commit<kDev>();
    mchain_wait<kDev, 0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (!live[k]) continue;
      const List& l = lst[k];
      const int s = cid[k];
#pragma unroll 2
      for (int p = lo + h; p < hi; p += H) {
        const int req = kAux ? pin_req_reg(ax, pr, p) : 0;
        const T os = orow[(p - lo) * n + cid[k]];
        const T* on_row = orow + (p + 1 - lo) * n;
        const T* e_row = erow + (p - lo) * n;
        T* Wp = W + (p - lo) * nnz;
        T on[N], ev[N];
#pragma unroll
        for (int q = 0; q < N; ++q) {
          on[q] = on_row[l.cell[q]];
          ev[q] = e_row[l.cell[q]];
        }
#pragma unroll
        for (int q = 0; q < N; ++q) {
          const T v = ex(os + l.w[q] + ev[q] - on[q]);
          const bool take = os > ninf<T>() && on[q] > ninf<T>() &&
                            !(kAux && vetoed_code(req, l.code[q]));
          if (q < l.nin) Wp[l.k[q]] = take ? v : (T)-1;
        }
        for (int kk = l.k0 + N; kk < l.k1; ++kk) {
          const int t = ix.rtr_t[kk];
          T wt = (T)-1;
          if (os > ninf<T>() && !vetoed(ax, req, kAuxR, t, s, S)) {
            const T on1 = on_row[t];
            if (on1 > ninf<T>()) wt = ex(os + w[kk] + e_row[t] - on1);
          }
          Wp[kk] = wt;
        }
      }
    }
    // (b) the walk: the cotangent of o_p from that of o_{p+1}, by the
    // walkers alone (their own barrier)
    __syncthreads();
    int rin = hi % (R + 1);
    T* ge[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) ge[k] = g_eR + (hi - 1) * SB + cell[k];
    for (int p = hi - 1; p >= lo && h == 0; --p) {
      const int rout = rin == 0 ? R : rin - 1;
      const T* gin = gr + rin * n;
      T* gout = gr + rout * n;
      const T* Wp = W + (p - lo) * nnz;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        T* gek = ge[k];
        ge[k] -= SB;
        if (!kWarp && !live[k]) continue;
        // the cotangent at cell c (the warp's: lane c)
        auto at = [&](int c) -> T {
          if constexpr (kWarp)
            return __shfl_sync(0xffffffffu, gv[k], c);
          else
            return gin[c];
        };
        const List& l = lst[k];
        const T gs = kWarp ? gv[k] : gin[cid[k]];
        T gt[N], wt[N];
#pragma unroll
        for (int q = 0; q < N; ++q) {
          gt[q] = at(l.cell[q]);
          wt[q] = Wp[l.k[q]];
        }
        if (live[k]) *gek = gs;
        T gnew = (T)0, acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int q = 0; q < N; ++q) {
          const bool take = q < l.nin && gt[q] != (T)0 && wt[q] >= (T)0;
          if (kAux) {
            // the posterior x feeds the sum and the class partials
            const T x = chain_mul(gt[q], wt[q]);
            if (take) gnew = chain_add(gnew, x);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (take && (l.code[q] >> c & 1)) acc[c] = chain_add(acc[c], x);
          } else if (take) {
            gnew = chain_madd<kAux>(gt[q], wt[q], gnew);
          }
        }
        const int kw = kWarp ? wide : l.k1 - l.k0 - N;
        for (int j = 0; j < kw; ++j) {
          const int kk = l.k0 + N + j;
          const bool in = kk < l.k1;
          const int t = in ? ix.rtr_t[kk] : 0;
          const T g1 = at(t), w1 = in ? Wp[kk] : (T)-1;
          if (g1 == (T)0 || !(w1 >= (T)0)) continue;
          gnew = chain_madd<kAux>(g1, w1, gnew);
          if (kAux) {
            const T x = chain_mul(g1, w1);
            const int code = ax.code[t * S + cid[k]];
            for (int c = 0; c < 4; ++c)
              if (code >> c & 1) acc[c] = chain_add(acc[c], x);
          }
        }
        if (!live[k]) continue;
        if (kWarp)
          gv[k] = gnew;
        else
          gout[cid[k]] = gnew;
        if (cls)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[((p - lo) * 4 + c) * n + cid[k]] = acc[c];
      }
      rin = rout;
      if (!kWarp) chain_walk_sync(walkers);
    }
    // (c) the class sums of the tile's steps: each (step, class) adds the
    // cells' partials (written by the walk) in ascending state order
    if (cls) {
      __syncthreads();
      for (int i = threadIdx.x; i < (hi - lo) * 4; i += blockDim.x) {
        const int c = i % 4, p = lo + i / 4;
        const T* pp = part + ((p - lo) * 4 + c) * n;
        T tot = (T)0;
        for (int q = 0; q < S; ++q) tot = chain_add(tot, pp[q]);
        cls[((long long)c * Lp + p) * B + b] = tot;
      }
    }
    __syncthreads();
    hi = lo;
  }
}

template <typename T>
static int chain_adj(ChainDims D, ChainIdx ix, Aux ax, ChainGrid pg,
                     const T* eR, const long long* L, const T* Osave,
                     const T* gparts, T* g_eR, unsigned char* ws,
                     cudaStream_t st) {
  const bool aux = has_pin(ax) || ax.cpR;
  const bool warp = chain_threads(D.S, 1) == 32;  // the one-warp walk
  const ChainAdjLayout lay(D.S, pg.R, pg.nnz, aux, sizeof(T));
  if (pg.R < 1 || pg.nnz < 0 || !chain_grid_ok(D, pg, lay.total, true) ||
      (pg.dev && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return chain_dispatch(pg.NC, [&](auto NC_) {
    constexpr int NC = decltype(NC_)::value;
    auto pick = [&](auto dev_, auto warp_) {
      constexpr bool kDev = decltype(dev_)::value;
      constexpr bool kWarp = decltype(warp_)::value && NC == 1;
      return aux ? chain_adj_kernel<T, NC, true, kDev, kWarp>
                 : chain_adj_kernel<T, NC, false, kDev, kWarp>;
    };
    using std::false_type;
    using std::true_type;
    auto kern = pg.dev ? (warp ? pick(true_type(), true_type())
                               : pick(true_type(), false_type()))
                       : (warp ? pick(false_type(), true_type())
                               : pick(false_type(), false_type()));
    const long long bytes = pg.dev ? 0 : lay.total;
    const int rc = allow_smem((const void*)kern, bytes);
    if (rc) return rc;
    kern<<<D.B, pg.threads, bytes, st>>>(D, ix, ax, pg, eR, L, Osave, gparts,
                                         g_eR, ws);
    return static_cast<int>(cudaGetLastError());
  });
}

RNAELEM_EXPORT int rnaelem_chain_adj_f32(ChainDims D, ChainIdx ix, Aux ax,
                                         ChainGrid pg, const float* eR,
                                         const long long* L,
                                         const float* Osave,
                                         const float* gparts, float* g_eR,
                                         unsigned char* ws, cudaStream_t st) {
  return chain_adj<float>(D, ix, ax, pg, eR, L, Osave, gparts, g_eR, ws, st);
}

RNAELEM_EXPORT int rnaelem_chain_adj_f64(ChainDims D, ChainIdx ix, Aux ax,
                                         ChainGrid pg, const double* eR,
                                         const long long* L,
                                         const double* Osave,
                                         const double* gparts, double* g_eR,
                                         unsigned char* ws, cudaStream_t st) {
  return chain_adj<double>(D, ix, ax, pg, eR, L, Osave, gparts, g_eR, ws, st);
}
