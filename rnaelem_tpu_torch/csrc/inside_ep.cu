// K3 and K11: the TT_E_P internal-loop term of one inside DP column j,
// plus the six base-coupled small loops (stack-adjacent bulges,
// 1x1/1x2/2x1/2x2).  K3 is the sum DP, K11 the CYK tables (max): the
// T, V and out kernels are templates on the policy EpSum / EpMax below,
// so the two DPs share the index maths.
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
// Design: five launches for K3, three for K11 (no shifts), read index
// fastest everywhere (coalesced).
// ep_rowmax / ep_shift take K3's per-read max shifts from per-row maxima
// (each column reduces only its new row, not the 90k-cell windows);
// ep_t writes T, one thread per (dl, x, ar, read); ep_v runs
// one thread per (x, u1, read) holding 32 AR accumulators per bucket in
// registers, with T and the inner-pair weights staged per dl in shared
// memory for the block's u1 threads and W recomputed on the fly from
// read-independent size weights per group (no W tensor in device memory);
// ep_out gives each
// (w, target, 32 reads) a block whose eight warps split the left gap u1
// and the specials and sum the K2 stage and the anti-diagonal w = x + u1.
// K3 works in exp space under the same per-(column, read) shifts as the
// JAX package, so f32 behaves as the reference does; K11 in log space.
// K11's W is the max over the size classes of log energies times lambda:
// max_c lam * E_c = lam * max_c E_c holds for lam >= 0 only, which the
// caller asserts (the JAX max DP makes the same step).  Hazards kept: the
// per-read cap dl + u1 <= C, the x + u1 <= Wp geometry, the specials' dk
// + dl <= C, and the fix_rss dot gating of both flanks.
#include "common.cuh"

#define TIDX(r, w, s, b) ((((long long)(r) * W1 + (w)) * S + (s)) * B + (b))
#define AR_CHUNK 32

struct EpIdx {
  const int* p13_s1;   // [n13] inner-pair state
  const int* p13_s3;   // [n13] right-flank state
  const int* ar_off;   // [n_ar+1] CSR of pairs13 by AR
  const int* ar_p;     // [n13]
  const int* k2_s2;    // [n2] left-flank state
  const int* k2_ar;    // [n2]
  const int* k2_bu;    // [n2] lambda bucket of the K2 target
  const int* k2_off;   // [S+1] CSR of K2 entries by target state
  const int* k2_idx;   // [n2]
};

// The algebra of the T, V and out kernels.  EpSum (K3): exp space under
// per-read shifts, load = exp(x - shift), products and sums.  EpMax
// (K11): log space, load = x, sums and maxima.
template <typename T>
struct EpSum {
  static constexpr bool kMax = false;
  __device__ __forceinline__ static T zero() { return (T)0; }
  __device__ __forceinline__ static T load(T x, T shift) {
    return ex(x - shift);
  }
  __device__ __forceinline__ static T mul(T a, T b) { return a * b; }
  __device__ __forceinline__ static void acc(T& a, T v) { a += v; }
  __device__ __forceinline__ static bool none(T v) { return v == (T)0; }
  __device__ __forceinline__ static T energy(T lam, T e) {
    return ex(lam_mul(lam, e));
  }
  __device__ __forceinline__ static T out(T a, T shift) {
    return safe_log_shift(a, shift);
  }
};

template <typename T>
struct EpMax {
  static constexpr bool kMax = true;
  __device__ __forceinline__ static T zero() { return ninf<T>(); }
  __device__ __forceinline__ static T load(T x, T) { return x; }
  __device__ __forceinline__ static T mul(T a, T b) { return a + b; }
  __device__ __forceinline__ static void acc(T& a, T v) {
    if (v > a) a = v;
  }
  __device__ __forceinline__ static bool none(T v) { return !(v > ninf<T>()); }
  __device__ __forceinline__ static T energy(T lam, T e) {
    return lam_mul(lam, e);
  }
  __device__ __forceinline__ static T out(T a, T) { return a; }
};

// ---- per-read max shifts of PF (P rows j..j-Cp), L3 (LL row j, widths
// 0..Cp) and LB (LL rows j..j-Wp, widths 0..Cp).  The tables' rows do not
// change once their column is done, so per-row maxima are kept in
// rowmax [2 (P, LL up to width Cp), Lp+1+PAD, B]: ep_rowmax reduces the
// new row j (grid: read tiles of 32 x chunks; one atomic max per block,
// table and read) and ep_shift takes the window maxima.
template <typename T>
__global__ void ep_rowmax_kernel(DPDims D, const T* P, const T* LL,
                                 T* rowmax) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1;
  const int R = D.Lp + 1 + D.PAD, r = D.j + D.PAD;
  const int b = blockIdx.x * 32 + threadIdx.x;
  __shared__ T red[2][8][32];
  T m[2] = {ninf<T>(), ninf<T>()};
  if (b < B) {
    const int step = gridDim.y * blockDim.y;
    for (int e = blockIdx.y * blockDim.y + threadIdx.y; e < W1 * S;
         e += step) {  // (w, s) of row j
      m[0] = fmax(m[0], P[TIDX(r, e / S, e % S, b)]);
      if (e < C1 * S) m[1] = fmax(m[1], LL[TIDX(r, e / S, e % S, b)]);
    }
  }
  for (int q = 0; q < 2; ++q) red[q][threadIdx.y][threadIdx.x] = m[q];
  __syncthreads();
  if (threadIdx.y == 0 && b < B) {
    for (int q = 0; q < 2; ++q) {
      T v = red[q][0][threadIdx.x];
      for (int y = 1; y < blockDim.y; ++y) v = fmax(v, red[q][y][threadIdx.x]);
      if (v > ninf<T>())
        atomic_max_t(&rowmax[((long long)q * R + r) * B + b], v);
    }
  }
}

// shift [3, B] = (max P rows j-Cp..j, max LL row j, max LL rows j-Wp..j)
template <typename T>
__global__ void ep_shift_kernel(DPDims D, const T* rowmax, T* shift) {
  const int B = D.B, R = D.Lp + 1 + D.PAD, r = D.j + D.PAD;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T mp = ninf<T>(), ml = ninf<T>();
  for (int k = 0; k <= D.Cp; ++k)
    mp = fmax(mp, rowmax[(long long)(r - k) * B + b]);
  for (int k = 0; k <= D.Wp; ++k)
    ml = fmax(ml, rowmax[((long long)R + r - k) * B + b]);
  shift[b] = mp;
  shift[B + b] = rowmax[((long long)R + r) * B + b];
  shift[2 * B + b] = ml;
}

// right-flank dot gate (fix_rss): bases j-dl..j-1 all unpaired
__device__ __forceinline__ bool right_dots(const int* dcum, int j, int dl,
                                           int B, int b) {
  int jl = j - dl < 0 ? 0 : j - dl;
  return dcum[(long long)j * B + b] - dcum[(long long)jl * B + b] == dl;
}

// left-flank dot gate (fix_rss): the u1 bases before row j-x all unpaired
__device__ __forceinline__ bool left_dots(const int* dcum, int j, int x,
                                          int u1, int B, int b) {
  int a = j - x < 0 ? 0 : j - x;
  int c = j - x - u1 < 0 ? 0 : j - x - u1;
  return dcum[(long long)a * B + b] - dcum[(long long)c * B + b] == u1;
}

// ---- T[dl, x, ar] = sum_{p in ar} exPF[dl][x-dl][s1p] * exL3[dl][s3p]
// (K11: max_p P + L3); grid (32 reads, 8 AR, (dl, x)): no per-thread
// index division
template <typename T, class EP>
__global__ void ep_t_kernel(DPDims D, EpIdx ix, const T* P, const T* LL,
                            const int* dcum, const T* shift, T* Tb) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, n_ar = D.n_ar;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int ar = blockIdx.y * 8 + threadIdx.y;
  const int dl = blockIdx.z / W1, x = blockIdx.z % W1;
  if (b >= B || ar >= n_ar) return;
  const int j = D.j, r = j + D.PAD;
  T acc = EP::zero();
  if (x >= dl && (!D.fix_rss || right_dots(dcum, j, dl, B, b))) {
    const T mPF = EP::kMax ? (T)0 : finite_or_zero(shift[b]);
    const T mL3 = EP::kMax ? (T)0 : finite_or_zero(shift[B + b]);
    const int v = x - dl;
    for (int k = ix.ar_off[ar]; k < ix.ar_off[ar + 1]; ++k) {
      const int p = ix.ar_p[k];
      EP::acc(acc, EP::mul(EP::load(P[TIDX(r - dl, v, ix.p13_s1[p], b)], mPF),
                           EP::load(LL[TIDX(r, dl, ix.p13_s3[p], b)], mL3)));
    }
  }
  Tb[(((long long)blockIdx.z) * n_ar + ar) * B + b] = acc;
}

// ---- V_bu[x, u1, ar] = sum_dl T[dl, x, ar] * W_bu[dl, x, u1], with
// W_bu[dl, x, u1] = [dl + u1 <= C] * sum_g emisB_bu[j-dl, x-dl, g]
//                   * eSZg_bu[g, dl, u1] * emisA_bu[g, j, x+u1]
// (eSZg: the read-independent size weights summed per misA/misB group).
// K11: V_bu = max_dl T + lam_bu * W with the log-space
// W[dl, x, u1] = max_g (misB[g, j-dl, x-dl] + SZ[g, dl, u1]) + misA[g, j,
// x+u1] (SZ: the size classes' log energies, max per group), -inf past
// the cap.  The inner-pair weights mB are emisB [2, R, W1, 4, B] (rows
// leading, zero PAD rows) for K3 and misB [4, Lp+1, W1, B] for K11, the
// outer ones mA emisA [2, 4, Lp+1, W1, B] / misA [4, Lp+1, W1, B], the
// size weights sz eSZg [2, 4, C1, C1] / SZ [4, C1, C1]; lam is read by
// K11 only.
// One block per (32 reads, 8 u1 values, x); per dl warp y stages rows
// q = y, y+8, ... of T[dl, x, :, reads] and row y = (bucket, group) of
// the inner-pair weights in shared memory, which all the block's
// u1 threads read; each thread keeps AR_CHUNK accumulators per bucket in
// registers.
template <typename T, class EP>
__global__ void ep_v_kernel(DPDims D, const T* Tb, const T* mA,
                            const T* mB, const T* sz, const int* Cb,
                            const T* lam, T* Vb) {
  const int B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1, n_ar = D.n_ar;
  const int Lp = D.Lp, R = D.Lp + 1 + D.PAD;
  const int lane = threadIdx.x, ty = threadIdx.y, b = blockIdx.x * 32 + lane;
  const int u1 = blockIdx.y * 8 + ty;
  const int x = blockIdx.z;
  const int j = D.j, r = j + D.PAD;
  __shared__ T tsh[AR_CHUNK][32];
  __shared__ T msh[8][32];
  const bool live = b < B && u1 < C1 && x + u1 <= D.Wp;
  const int cap = live ? Cb[b] : -1;
  // the outer-pair weights at (j, x+u1) do not depend on dl: K3 q =
  // (bucket, group), K11 q = group < 4
  T ma[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    ma[q] = live && (!EP::kMax || q < 4)
        ? mA[(((long long)q * (Lp + 1) + j) * W1 + (x + u1)) * B + b]
        : EP::zero();
  const T lam0 = EP::kMax ? lam[0] : (T)0, lam1 = EP::kMax ? lam[1] : (T)0;
  const int dl_end = x < C1 - 1 ? x : C1 - 1;
  for (int ar0 = 0; ar0 < n_ar; ar0 += AR_CHUNK) {
    const int nq = n_ar - ar0 < AR_CHUNK ? n_ar - ar0 : AR_CHUNK;
    T v0[AR_CHUNK], v1[AR_CHUNK];
#pragma unroll
    for (int q = 0; q < AR_CHUNK; ++q) v0[q] = v1[q] = EP::zero();
    for (int dl = 0; dl <= dl_end; ++dl) {
      __syncthreads();
      for (int q = ty; q < nq; q += 8)
        tsh[q][lane] = b < B
            ? Tb[(((long long)dl * W1 + x) * n_ar + ar0 + q) * B + b]
            : EP::zero();
      if (EP::kMax) {
        // misB [4, Lp+1, W1, B]; rows before 0 are -inf
        msh[ty][lane] = b < B && ty < 4 && j - dl >= 0
            ? mB[(((long long)ty * (Lp + 1) + (j - dl)) * W1 + (x - dl)) * B +
                 b]
            : ninf<T>();
      } else {
        // emisB rows-leading [2, R, W1, 4, B] with zero PAD rows; ty =
        // 4bu+g
        msh[ty][lane] = b < B
            ? mB[((((long long)(ty >> 2) * R + (r - dl)) * W1 + (x - dl)) *
                  4 + (ty & 3)) * B + b]
            : (T)0;
      }
      __syncthreads();
      if (dl + u1 > cap) continue;  // also !live (cap = -1)
      const T* szp = sz + (long long)dl * C1 + u1;  // [.., C1 (dl), C1 (u1)]
      T w0, w1;
      if (EP::kMax) {
        T wr = ninf<T>();
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const T v = msh[g][lane] + szp[(long long)g * C1 * C1] + ma[g];
          wr = v > wr ? v : wr;
        }
        w0 = lam_mul(lam0, wr);
        w1 = lam_mul(lam1, wr);
      } else {
        w0 = w1 = (T)0;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          w0 += msh[g][lane] * szp[(long long)g * C1 * C1] * ma[g];
          w1 += msh[4 + g][lane] * szp[(long long)(4 + g) * C1 * C1] *
                ma[4 + g];
        }
      }
      if (EP::none(w0) && EP::none(w1)) continue;
#pragma unroll
      for (int q = 0; q < AR_CHUNK; ++q) {
        if (q < nq) {
          const T tv = tsh[q][lane];
          EP::acc(v0[q], EP::mul(tv, w0));
          EP::acc(v1[q], EP::mul(tv, w1));
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

// ---- out[w, t] = sum over K2 entries k of target t of
//   sum_{u1 <= min(Cp, w)} exLB[w-u1][u1][s2k] * V_bu(k)[w-u1, u1, ar(k)]
//   + the six base-coupled specials;  ep = log(out) + shifts (K11: the
//   same maxima of log terms).
// One block per (32 reads, t, w): warp y takes u1 = y, y+8, ... and the
// special ci = y; the partial sums meet in shared memory.
template <typename T, class EP>
__global__ void ep_out_kernel(DPDims D, EpIdx ix, const T* P, const T* LL,
                              const T* Vb, const T* shift, const int* dcum,
                              const T* spec_il, const T* lam, const int* Cb,
                              T* ep) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, C1 = D.Cp + 1, n_ar = D.n_ar;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int t = blockIdx.y, w = blockIdx.z, y = threadIdx.y;
  const int j = D.j, r = j + D.PAD, Lp = D.Lp;
  __shared__ T part[8][32];
  T acc = EP::zero(), mPF = (T)0, mL3 = (T)0, mLB = (T)0;
  if (b < B) {
    if (!EP::kMax) {
      mPF = finite_or_zero(shift[b]);
      mL3 = finite_or_zero(shift[B + b]);
      mLB = finite_or_zero(shift[2 * B + b]);
    }
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
        if (EP::none(vv)) continue;
        EP::acc(acc, EP::mul(EP::load(LL[TIDX(r - x, u1, s2, b)], mLB), vv));
      }
      if (!spec_ok) continue;
      // lf = LL(j-w+dk, dk); tar = sum_{p in ar} P(j-dl, w-dk-dl) L3(dl)
      const T lf = EP::load(LL[TIDX(r - (w - dk), dk, s2, b)], mLB);
      T tar = EP::zero();
      for (int q = ix.ar_off[ar]; q < ix.ar_off[ar + 1]; ++q) {
        const int p = ix.ar_p[q];
        EP::acc(tar, EP::mul(
            EP::load(P[TIDX(r - dl, w - dk - dl, ix.p13_s1[p], b)], mPF),
            EP::load(LL[TIDX(r, dl, ix.p13_s3[p], b)], mL3)));
      }
      const T il = spec_il[(((long long)y * (Lp + 1) + j) * W1 + w) * B + b];
      EP::acc(acc, EP::mul(EP::mul(lf, tar), EP::energy(lam[bu], il)));
    }
  }
  part[y][threadIdx.x] = acc;
  __syncthreads();
  if (y != 0 || b >= B) return;
  T sum = EP::zero();
  for (int q = 0; q < blockDim.y; ++q) EP::acc(sum, part[q][threadIdx.x]);
  ep[((long long)w * S + t) * B + b] = EP::out(sum, mPF + mL3 + mLB);
}

static const int kThreads = 256;

template <typename T>
static int ep_rowmax(DPDims D, const T* P, const T* LL, T* rowmax,
                     cudaStream_t st) {
  dim3 block(32, 8);
  dim3 grid((D.B + 31) / 32, 8);
  ep_rowmax_kernel<T><<<grid, block, 0, st>>>(D, P, LL, rowmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int ep_shift(DPDims D, const T* rowmax, T* shift, cudaStream_t st) {
  ep_shift_kernel<T><<<(D.B + 127) / 128, 128, 0, st>>>(D, rowmax, shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class EP>
static int ep_t(DPDims D, EpIdx ix, const T* P, const T* LL, const int* dcum,
                const T* shift, T* Tb, cudaStream_t st) {
  dim3 block(32, 8);
  dim3 grid((D.B + 31) / 32, (D.n_ar + 7) / 8, (D.Cp + 1) * (D.Wp + 1));
  ep_t_kernel<T, EP><<<grid, block, 0, st>>>(D, ix, P, LL, dcum, shift, Tb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class EP>
static int ep_v(DPDims D, const T* Tb, const T* mA, const T* mB, const T* sz,
                const int* Cb, const T* lam, T* Vb, cudaStream_t st) {
  dim3 block(32, 8);
  dim3 grid((D.B + 31) / 32, (D.Cp + 1 + 7) / 8, D.Wp + 1);
  ep_v_kernel<T, EP><<<grid, block, 0, st>>>(D, Tb, mA, mB, sz, Cb, lam, Vb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class EP>
static int ep_out(DPDims D, EpIdx ix, const T* P, const T* LL, const T* Vb,
                  const T* shift, const int* dcum, const T* spec_il,
                  const T* lam, const int* Cb, T* ep, cudaStream_t st) {
  dim3 block(32, 8);
  dim3 grid((D.B + 31) / 32, D.S, D.Wp + 1);
  ep_out_kernel<T, EP><<<grid, block, 0, st>>>(D, ix, P, LL, Vb, shift, dcum,
                                               spec_il, lam, Cb, ep);
  return static_cast<int>(cudaGetLastError());
}

// K3: rnaelem_ep_<fn>_<type>; K11: rnaelem_ep_<fn>_max_<type> (no shifts)
#define EP_EXPORTS(SUF, T)                                                   \
  RNAELEM_EXPORT int rnaelem_ep_rowmax_##SUF(DPDims D, const T* P,          \
                                             const T* LL, T* rowmax,         \
                                             cudaStream_t st) {              \
    return ep_rowmax<T>(D, P, LL, rowmax, st);                               \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_shift_##SUF(DPDims D, const T* rowmax,       \
                                            T* shift, cudaStream_t st) {     \
    return ep_shift<T>(D, rowmax, shift, st);                                \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_t_##SUF(DPDims D, EpIdx ix, const T* P,      \
                                        const T* LL, const int* dcum,        \
                                        const T* shift, T* Tb,               \
                                        cudaStream_t st) {                   \
    return ep_t<T, EpSum<T>>(D, ix, P, LL, dcum, shift, Tb, st);             \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_v_##SUF(DPDims D, const T* Tb,              \
                                        const T* emisA, const T* emisB,      \
                                        const T* eSZg, const int* Cb, T* Vb, \
                                        cudaStream_t st) {                   \
    return ep_v<T, EpSum<T>>(D, Tb, emisA, emisB, eSZg, Cb, nullptr, Vb,    \
                             st);                                            \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_out_##SUF(                                   \
      DPDims D, EpIdx ix, const T* P, const T* LL, const T* Vb,              \
      const T* shift, const int* dcum, const T* spec_il, const T* lam,       \
      const int* Cb, T* ep, cudaStream_t st) {                               \
    return ep_out<T, EpSum<T>>(D, ix, P, LL, Vb, shift, dcum, spec_il, lam, \
                               Cb, ep, st);                                  \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_t_max_##SUF(DPDims D, EpIdx ix, const T* P,  \
                                            const T* LL, const int* dcum,    \
                                            T* Tb, cudaStream_t st) {        \
    return ep_t<T, EpMax<T>>(D, ix, P, LL, dcum, nullptr, Tb, st);           \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_v_max_##SUF(DPDims D, const T* Tb,          \
                                            const T* misA, const T* misB,    \
                                            const T* SZ, const int* Cb,      \
                                            const T* lam, T* Vb,             \
                                            cudaStream_t st) {               \
    return ep_v<T, EpMax<T>>(D, Tb, misA, misB, SZ, Cb, lam, Vb, st);        \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_out_max_##SUF(                               \
      DPDims D, EpIdx ix, const T* P, const T* LL, const T* Vb,              \
      const int* dcum, const T* spec_il, const T* lam, const int* Cb, T* ep, \
      cudaStream_t st) {                                                     \
    return ep_out<T, EpMax<T>>(D, ix, P, LL, Vb, nullptr, dcum, spec_il,    \
                               lam, Cb, ep, st);                             \
  }

EP_EXPORTS(f32, float)
EP_EXPORTS(f64, double)
