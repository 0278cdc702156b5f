// K3 and K11: the TT_E_P internal-loop term of one inside DP column j,
// plus the six base-coupled small loops (stack-adjacent bulges,
// 1x1/1x2/2x1/2x2).  K3 is the sum DP, K11 the CYK tables (max).
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): K3 ops/dp.py ep_col
// and _ep_specials (row F of the kernel table, ops/dp.py:477-599); K11
// ops/dp_maxb.py ep_col, _flipB and _ep_specials (row L, :219-338).
//
// Bound on the H100: bytes.  Per column it must read the band cells that
// feed the sum: P (j-dl, v) with dl <= C, dl + v <= Wp and LL (j-x, u1)
// with u1 <= C, x + u1 <= Wp (1,116 of the 31 x 51 cells each at Wp = 50,
// C = 30), the inner-pair mismatch weights on the P cells and the
// read-independent size weights (about 37 MB at B=128 in f32, 11 us at
// 3.35 TB/s; chip_smoke.py counts it for its batch); its arithmetic,
// chain-factored as in the JAX package (pairs13 (inner pair x right
// flank) -> AR pairs -> the fused energy weight W[dl, x, u1] per lambda
// bucket -> K2 (left flank x AR) -> target), is about 0.35 GFLOP per
// column, dominated by the V contraction
// V_bu[x, u1, ar] = sum_dl T[dl, x, ar] * W_bu[dl, x, u1].
//
// K3 design (two launches per column): ep_fwd gives each (read, range
// of x) a block of kEpThreads threads (ep_col.cuh) that takes the read's
// per-(column, read) exp-space shifts as the JAX package does (maxima of
// P rows j-Cp..j, LL row j and LL rows j-Wp..j up to width Cp: the
// per-row maxima of earlier rows are kept in rowmax, the block reduces
// row j itself), walks its x forming T, W and V in shared memory, and
// sums exLB(j-x, u1)[s2k] * V_bu(k)[u1, ar(k)] into its partial out[w =
// x + u1, t] in shared memory (a ring of Cp+1 widths: step x adds to
// widths x..x+Cp, so width x-1 is written out as step x starts); T, W
// and V never reach device memory.  The first block of a read writes
// its row maxima and its shifts (the state's ep_shift [Lp+1, 3, B],
// which K6 reads).  ep_fwd_red sums the blocks' partials in range order
// and writes ep = log(out) + shifts.  Hazards
// kept: the per-read cap dl + u1 <= C, the x + u1 <= Wp geometry, the
// specials' dk + dl <= C, and the fix_rss dot gating of both flanks.
//
// K11 (three launches, the max semiring in log space; no shifts): ep_t
// writes T, one thread per (dl, x, ar, read); ep_v runs one thread per
// (x, u1, read) holding 32 AR accumulators per bucket in registers, with
// T and the inner-pair weights staged per dl in shared memory for the
// block's u1 threads; ep_out gives each (w, target, 32 reads) a block
// whose eight warps split the left gap u1 and the specials.  K11's W is
// the max over the size classes of log energies times lambda: max_c lam
// * E_c = lam * max_c E_c holds for lam >= 0 only, which the caller
// asserts (the JAX max DP makes the same step).
#include "ep_col.cuh"

#define AR_CHUNK 32

// ---- K11's T[dl, x, ar] = max_{p in ar} P(j-dl, x-dl)[s1p] + LL(j,
// dl)[s3p] (log space); grid (32 reads, 8 AR, (dl, x)): no per-thread
// index division
template <typename T>
__global__ void ep_t_max_kernel(DPDims D, EpIdx ix, const T* P, const T* LL,
                                const int* dcum, T* Tb) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, n_ar = D.n_ar;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int ar = blockIdx.y * 8 + threadIdx.y;
  const int dl = blockIdx.z / W1, x = blockIdx.z % W1;
  if (b >= B || ar >= n_ar) return;
  const int j = D.j, r = j + D.PAD;
  T acc = ninf<T>();
  if (x >= dl && (!D.fix_rss || right_dots(dcum, j, dl, B, b))) {
    const int v = x - dl;
    for (int k = ix.ar_off[ar]; k < ix.ar_off[ar + 1]; ++k) {
      const int p = ix.ar_p[k];
      const T t = P[TIDX(r - dl, v, ix.p13_s1[p], b)] +
                  LL[TIDX(r, dl, ix.p13_s3[p], b)];
      if (t > acc) acc = t;
    }
  }
  Tb[(((long long)blockIdx.z) * n_ar + ar) * B + b] = acc;
}

// ---- K11's V_bu[x, u1, ar] = max_dl T[dl, x, ar] + lam_bu * W[dl, x,
// u1] with the log-space W[dl, x, u1] = max_g (misB[g, j-dl, x-dl] +
// SZ[g, dl, u1]) + misA[g, j, x+u1] (SZ: the size classes' log energies,
// max per group), -inf past the cap; misB and misA are [4, Lp+1, W1, B],
// SZ [4, C1, C1].
// One block per (32 reads, 8 u1 values, x); per dl warp y stages rows
// q = y, y+8, ... of T[dl, x, :, reads] and row y = group of misB in
// shared memory, which all the block's u1 threads read; each thread
// keeps AR_CHUNK accumulators per bucket in registers.
template <typename T>
__global__ void ep_v_max_kernel(DPDims D, const T* Tb, const T* mA,
                                const T* mB, const T* sz, const int* Cb,
                                const T* lam, T* Vb) {
  const int B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1, n_ar = D.n_ar;
  const int Lp = D.Lp;
  const int lane = threadIdx.x, ty = threadIdx.y, b = blockIdx.x * 32 + lane;
  const int u1 = blockIdx.y * 8 + ty;
  const int x = blockIdx.z;
  const int j = D.j;
  __shared__ T tsh[AR_CHUNK][32];
  __shared__ T msh[8][32];
  const bool live = b < B && u1 < C1 && x + u1 <= D.Wp;
  const int cap = live ? Cb[b] : -1;
  // the outer-pair weights at (j, x+u1), per group: they do not depend
  // on dl
  T ma[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    ma[q] = live
        ? mA[(((long long)q * (Lp + 1) + j) * W1 + (x + u1)) * B + b]
        : ninf<T>();
  const T lam0 = lam[0], lam1 = lam[1];
  const int dl_end = x < C1 - 1 ? x : C1 - 1;
  for (int ar0 = 0; ar0 < n_ar; ar0 += AR_CHUNK) {
    const int nq = n_ar - ar0 < AR_CHUNK ? n_ar - ar0 : AR_CHUNK;
    T v0[AR_CHUNK], v1[AR_CHUNK];
#pragma unroll
    for (int q = 0; q < AR_CHUNK; ++q) v0[q] = v1[q] = ninf<T>();
    for (int dl = 0; dl <= dl_end; ++dl) {
      __syncthreads();
      for (int q = ty; q < nq; q += 8)
        tsh[q][lane] = b < B
            ? Tb[(((long long)dl * W1 + x) * n_ar + ar0 + q) * B + b]
            : ninf<T>();
      // misB rows before 0 are -inf
      msh[ty][lane] = b < B && ty < 4 && j - dl >= 0
          ? mB[(((long long)ty * (Lp + 1) + (j - dl)) * W1 + (x - dl)) * B +
               b]
          : ninf<T>();
      __syncthreads();
      if (dl + u1 > cap) continue;  // also !live (cap = -1)
      const T* szp = sz + (long long)dl * C1 + u1;  // [4, C1 (dl), C1 (u1)]
      T wr = ninf<T>();
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const T v = msh[g][lane] + szp[(long long)g * C1 * C1] + ma[g];
        wr = v > wr ? v : wr;
      }
      const T w0 = lam_mul(lam0, wr), w1 = lam_mul(lam1, wr);
      if (!(w0 > ninf<T>()) && !(w1 > ninf<T>())) continue;
#pragma unroll
      for (int q = 0; q < AR_CHUNK; ++q) {
        if (q < nq) {
          const T tv = tsh[q][lane];
          const T a0 = tv + w0, a1 = tv + w1;
          if (a0 > v0[q]) v0[q] = a0;
          if (a1 > v1[q]) v1[q] = a1;
        }
      }
    }
    if (b < B && u1 < C1) {
      // V layout [2, W1 (x), C1 (u1), n_ar, B]
#pragma unroll
      for (int q = 0; q < AR_CHUNK; ++q) {
        if (q < nq) {
          Vb[((((long long)x) * C1 + u1) * n_ar + ar0 + q) * B + b] = v0[q];
          Vb[(((long long)(W1 + x) * C1 + u1) * n_ar + ar0 + q) * B + b] =
              v1[q];
        }
      }
    }
  }
}

// ---- K11's ep[w, t] = max over K2 entries k of target t of
//   max_{u1 <= min(Cp, w)} LL(j-w+u1, u1)[s2k] + V_bu(k)[w-u1, u1, ar(k)]
//   and of the six base-coupled specials.
// One block per (32 reads, t, w): warp y takes u1 = y, y+8, ... and the
// special ci = y; the partial maxima meet in shared memory.
template <typename T>
__global__ void ep_out_max_kernel(DPDims D, EpIdx ix, const T* P,
                                  const T* LL, const T* Vb, const int* dcum,
                                  const T* spec_il, const T* lam,
                                  const int* Cb, T* ep) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1, n_ar = D.n_ar;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int t = blockIdx.y, w = blockIdx.z, y = threadIdx.y;
  const int j = D.j, r = j + D.PAD, Lp = D.Lp;
  __shared__ T part[8][32];
  T acc = ninf<T>();
  if (b < B) {
    const int ulim = w < D.Cp ? w : D.Cp;
    const int dks[6] = {0, 1, 1, 1, 2, 2}, dls[6] = {1, 0, 1, 2, 1, 2};
    const bool spec = !D.no_ene && y < 6;
    const int dk = spec ? dks[y] : 0, dl = spec ? dls[y] : 0;
    const bool spec_ok = spec && dk + dl <= Cb[b] && w >= dk + dl &&
        (!D.fix_rss || (left_dots(dcum, j, w - dk, dk, B, b) &&
                        right_dots(dcum, j, dl, B, b)));
    for (int kk = ix.k2_off[t]; kk < ix.k2_off[t + 1]; ++kk) {
      const int k = ix.k2_idx[kk];
      const int s2 = ix.k2_s2[k], ar = ix.k2_ar[k], bu = ix.k2_bu[k];
      for (int u1 = y; u1 <= ulim; u1 += blockDim.y) {
        const int x = w - u1;
        if (D.fix_rss && !left_dots(dcum, j, x, u1, B, b)) continue;
        const T vv = Vb[((((long long)bu * W1 + x) * C1 + u1) * n_ar + ar) *
                            B + b];
        if (!(vv > ninf<T>())) continue;
        const T v = LL[TIDX(r - x, u1, s2, b)] + vv;
        if (v > acc) acc = v;
      }
      if (!spec_ok) continue;
      // lf = LL(j-w+dk, dk); tar = max_{p in ar} P(j-dl, w-dk-dl) + L3(dl)
      const T lf = LL[TIDX(r - (w - dk), dk, s2, b)];
      T tar = ninf<T>();
      for (int q = ix.ar_off[ar]; q < ix.ar_off[ar + 1]; ++q) {
        const int p = ix.ar_p[q];
        const T v = P[TIDX(r - dl, w - dk - dl, ix.p13_s1[p], b)] +
                    LL[TIDX(r, dl, ix.p13_s3[p], b)];
        if (v > tar) tar = v;
      }
      const T il = spec_il[(((long long)y * (Lp + 1) + j) * W1 + w) * B + b];
      const T v = lf + tar + lam_mul(lam[bu], il);
      if (v > acc) acc = v;
    }
  }
  part[y][threadIdx.x] = acc;
  __syncthreads();
  if (y != 0 || b >= B) return;
  T m = ninf<T>();
  for (int q = 0; q < blockDim.y; ++q)
    if (part[q][threadIdx.x] > m) m = part[q][threadIdx.x];
  ep[((long long)w * S + t) * B + b] = m;
}

// ---- K3, fused: one block per (read, range of x) of column j
template <typename T>
__global__ void __launch_bounds__(kEpThreads)
ep_fwd_kernel(DPDims D, EpXRanges xq, EpIdx ix, const T* P, const T* LL,
              const T* emisA, const T* emisB, const T* eSZg,
              const T* spec_il, const T* lam, const int* dcum, const int* Cb,
              T* rowmax, T* shift, T* part) {
  extern __shared__ __align__(16) unsigned char ep_smem[];
  EpBlock<T, T> k;
  k.init(D, Cb, blockIdx.x);
  const int xr = blockIdx.y, S = k.S, B = k.B, W1 = k.W1, b = k.b;
  const int C1 = k.C1;
  const EpFwdLayout lay(S, k.NA, C1);
  T* sm = reinterpret_cast<T*>(ep_smem);
  k.exP = sm + lay.exP;
  k.exL3 = sm + lay.exL3;
  k.LL = LL;
  k.szg = eSZg;
  k.mAB = sm + lay.mAB;
  k.Tm = sm + lay.Tm;
  k.Wm = sm + lay.Wm;
  k.Vm = sm + lay.Vm;
  T* out = sm + lay.out;   // ring [C1][S]: width w at slot w % C1
  T* red = sm + lay.red;   // [4][kEpThreads]

  // row j's maxima of P (all widths) and of LL (widths <= Cp), and the
  // maxima of the earlier rows of the windows (P rows j-Cp..j-1, LL rows
  // j-Wp..j-1: rowmax [2, R, B]), reduced over the block
  T m[4] = {ninf<T>(), ninf<T>(), ninf<T>(), ninf<T>()};
  for (int i = threadIdx.x; i < W1 * S; i += blockDim.x) {
    const int w = i / S, s = i % S;
    m[0] = fmax(m[0], P[TIDX(k.r, w, s, b)]);
    if (w < k.C1) m[1] = fmax(m[1], LL[TIDX(k.r, w, s, b)]);
  }
  for (int d = 1 + threadIdx.x; d <= k.Cp; d += blockDim.x)
    m[2] = fmax(m[2], rowmax[(long long)(k.r - d) * B + b]);
  for (int d = 1 + threadIdx.x; d <= k.Wp; d += blockDim.x)
    m[3] = fmax(m[3], rowmax[((long long)k.R + k.r - d) * B + b]);
  for (int q = 0; q < 4; ++q) red[q * blockDim.x + threadIdx.x] = m[q];
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h)
      for (int q = 0; q < 4; ++q)
        red[q * blockDim.x + threadIdx.x] =
            fmax(red[q * blockDim.x + threadIdx.x],
                 red[q * blockDim.x + threadIdx.x + h]);
    __syncthreads();
  }
  for (int q = 0; q < 4; ++q) m[q] = red[q * blockDim.x];
  __syncthreads();
  const T mp = fmax(m[0], m[2]), ml = fmax(m[1], m[3]);
  k.mPF = finite_or_zero(mp);
  k.mL3 = finite_or_zero(m[1]);
  k.mLB = finite_or_zero(ml);
  if (xr == 0 && threadIdx.x == 0) {
    rowmax[(long long)k.r * B + b] = m[0];
    rowmax[((long long)k.R + k.r) * B + b] = m[1];
    shift[((long long)k.j * 3 + 0) * B + b] = k.mPF;
    shift[((long long)k.j * 3 + 1) * B + b] = k.mL3;
    shift[((long long)k.j * 3 + 2) * B + b] = k.mLB;
  }
  ep_stage_l3(k, LL, dcum);
  for (int i = threadIdx.x; i < C1 * S; i += blockDim.x) out[i] = (T)0;
  // the block's partial of width w (the ring's row, then zero)
  T* pb = part + (long long)xr * W1 * S * B + b;
  auto flush = [&](int w) {
    T* o = out + (w % C1) * S;
    for (int t = threadIdx.x; t < S; t += blockDim.x) {
      pb[((long long)w * S + t) * B] = o[t];
      o[t] = (T)0;
    }
  };
  // the widths this block's x reach are x0..wend; the others hold 0
  const int x0 = xq.x0[xr], x1 = xq.x1[xr];
  const int wend = x1 < x0 ? -1 : (x1 + k.Cp < k.Wp ? x1 + k.Cp : k.Wp);
  for (int i = threadIdx.x; i < W1 * S; i += blockDim.x)
    if (i / S < x0 || i / S > wend) pb[(long long)i * B] = (T)0;
  __syncthreads();
  for (int x = x0; x <= x1; ++x) {
    const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
    const int xs = x % C1;
    if (x > x0) flush(x - 1);   // no later x reaches width x - 1
    ep_stage_x(k, x, P, emisA, emisB);
    __syncthreads();
    ep_form_tw(k, x, ix, spec_il, lam);
    __syncthreads();
    ep_form_v(k, x);
    __syncthreads();
    // out[x + u1, t] += sum over K2 entries k of t of exLB * V
    for (int i = threadIdx.x; i < (umax + 1) * S; i += blockDim.x) {
      const int u1 = i / S, t = i % S;
      if (k.fix_rss && !left_dots(dcum, k.j, x, u1, B, b)) continue;
      T acc = (T)0;
      for (int kk = ix.k2_off[t]; kk < ix.k2_off[t + 1]; ++kk) {
        const int e = ix.k2_idx[kk];
        const T v = k.V(ix.k2_bu[e], u1, ix.k2_ar[e]);
        if (v != (T)0) acc += k.exB(x, u1, ix.k2_s2[e]) * v;
      }
      out[ring_slot(xs, u1, C1) * S + t] += acc;
    }
    __syncthreads();
  }
  for (int w = x1; w <= wend; ++w) flush(w);
}

// ---- K3: ep[j, w, t] = log(sum of the blocks' partials) + shifts
template <typename T>
__global__ void ep_fwd_red_kernel(DPDims D, const T* part, const T* shift,
                                  T* ep) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1;
  const long long n = (long long)W1 * S * B;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int b = idx % B;
  T s = (T)0;
  for (int xr = 0; xr < kEpXSplit; ++xr) s += part[xr * n + idx];
  const T* sh = shift + (long long)D.j * 3 * B + b;
  ep[(long long)(D.j + D.PAD) * n + idx] =
      safe_log_shift(s, sh[0] + sh[B] + sh[2 * B]);
}

static const int kThreads = 256;

template <typename T>
static int ep_fwd(DPDims D, EpIdx ix, const T* P, const T* LL,
                  const T* emisA, const T* emisB, const T* eSZg,
                  const T* spec_il, const T* lam, const int* dcum,
                  const int* Cb, T* rowmax, T* shift, T* part,
                  cudaStream_t st) {
  const long long smem =
      EpFwdLayout(D.S, D.n_ar, D.Cp + 1).total * sizeof(T);
  int rc = allow_smem((const void*)ep_fwd_kernel<T>, smem);
  if (rc) return rc;
  dim3 grid(D.B, kEpXSplit);
  ep_fwd_kernel<T><<<grid, kEpThreads, smem, st>>>(
      D, ep_x_ranges(D.Wp, D.Cp), ix, P, LL, emisA, emisB, eSZg, spec_il,
      lam, dcum, Cb, rowmax, shift, part);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int ep_fwd_red(DPDims D, const T* part, const T* shift, T* ep,
                      cudaStream_t st) {
  const long long n = (long long)(D.Wp + 1) * D.S * D.B;
  ep_fwd_red_kernel<T><<<ceil_div(n, kThreads), kThreads, 0, st>>>(
      D, part, shift, ep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int ep_t_max(DPDims D, EpIdx ix, const T* P, const T* LL,
                    const int* dcum, T* Tb, cudaStream_t st) {
  dim3 block(32, 8);
  dim3 grid((D.B + 31) / 32, (D.n_ar + 7) / 8, (D.Cp + 1) * (D.Wp + 1));
  ep_t_max_kernel<T><<<grid, block, 0, st>>>(D, ix, P, LL, dcum, Tb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int ep_v_max(DPDims D, const T* Tb, const T* mA, const T* mB,
                    const T* sz, const int* Cb, const T* lam, T* Vb,
                    cudaStream_t st) {
  dim3 block(32, 8);
  dim3 grid((D.B + 31) / 32, (D.Cp + 1 + 7) / 8, D.Wp + 1);
  ep_v_max_kernel<T><<<grid, block, 0, st>>>(D, Tb, mA, mB, sz, Cb, lam, Vb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int ep_out_max(DPDims D, EpIdx ix, const T* P, const T* LL,
                      const T* Vb, const int* dcum, const T* spec_il,
                      const T* lam, const int* Cb, T* ep, cudaStream_t st) {
  dim3 block(32, 8);
  dim3 grid((D.B + 31) / 32, D.S, D.Wp + 1);
  ep_out_max_kernel<T><<<grid, block, 0, st>>>(D, ix, P, LL, Vb, dcum,
                                               spec_il, lam, Cb, ep);
  return static_cast<int>(cudaGetLastError());
}

// K3: rnaelem_ep_fwd_<type>, rnaelem_ep_fwd_red_<type>; K11:
// rnaelem_ep_<fn>_max_<type>
#define EP_EXPORTS(SUF, T)                                                   \
  RNAELEM_EXPORT int rnaelem_ep_fwd_##SUF(                                   \
      DPDims D, EpIdx ix, const T* P, const T* LL, const T* emisA,           \
      const T* emisB, const T* eSZg, const T* spec_il, const T* lam,         \
      const int* dcum, const int* Cb, T* rowmax, T* shift, T* part,          \
      cudaStream_t st) {                                                     \
    return ep_fwd<T>(D, ix, P, LL, emisA, emisB, eSZg, spec_il, lam, dcum,  \
                     Cb, rowmax, shift, part, st);                           \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_fwd_red_##SUF(DPDims D, const T* part,       \
                                              const T* shift, T* ep,         \
                                              cudaStream_t st) {             \
    return ep_fwd_red<T>(D, part, shift, ep, st);                            \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_t_max_##SUF(DPDims D, EpIdx ix, const T* P,  \
                                            const T* LL, const int* dcum,    \
                                            T* Tb, cudaStream_t st) {        \
    return ep_t_max<T>(D, ix, P, LL, dcum, Tb, st);                          \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_v_max_##SUF(DPDims D, const T* Tb,          \
                                            const T* misA, const T* misB,    \
                                            const T* SZ, const int* Cb,      \
                                            const T* lam, T* Vb,             \
                                            cudaStream_t st) {               \
    return ep_v_max<T>(D, Tb, misA, misB, SZ, Cb, lam, Vb, st);              \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_out_max_##SUF(                               \
      DPDims D, EpIdx ix, const T* P, const T* LL, const T* Vb,              \
      const int* dcum, const T* spec_il, const T* lam, const int* Cb, T* ep, \
      cudaStream_t st) {                                                     \
    return ep_out_max<T>(D, ix, P, LL, Vb, dcum, spec_il, lam, Cb, ep, st);  \
  }

EP_EXPORTS(f32, float)
EP_EXPORTS(f64, double)

// dynamic shared memory of K3's and K6's fused blocks (ops/kernels.py
// ep_smem_bytes mirrors it): which 0 = K3 (ep_fwd), 1 = K6 (ep_adj)
RNAELEM_EXPORT long long rnaelem_ep_smem_bytes(int which, DPDims D,
                                               int itemsize) {
  if (which == 0)
    return EpFwdLayout(D.S, D.n_ar, D.Cp + 1).total * itemsize;
  return EpAdjLayout(D.S, D.n_ar, D.Cp + 1).bytes(itemsize);
}
