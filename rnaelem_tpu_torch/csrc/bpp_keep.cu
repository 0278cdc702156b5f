// K18: the min-BPP masks' candidate pairs and threshold (row I of the
// kernel table).
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): model/joint.py
// _complementary_bp (:250), the candidate pairs by complementarity, band
// and turn (energy/tables.py pair_mask_jw in the port), and
// _effective_bp_mask_batch's threshold and counts (:518-533).
//
// bpp_candidates (one launch): bp0 [B, Lp+1, Wp+1] bool, cell (j, w) the
// pair (i = j - w, j - 1): i >= 0, w >= wmin (1, or turn + 2), j <= L_b,
// w <= W_b = min(L_b, max_span) and bp[seq[i], seq[j-1]] > 0 (the codes
// clamped into the read's row, as pair_mask_jw gathers them).
// bpp_keep (one launch): keep [B, Lp+1, Wp+1] = sel & (post absent, or
// log(max(post, 1e-300)) >= log(min_bpp) in the scalar type, post the
// motif-free pass's alphaP cotangent batch-minor [Lp+1, Wp+1, B] as K5-K7
// leave it), sel the candidates (or fix_rss's given pairs), and eff[b] =
// count(keep) / max(count(bp0), 1) from integer counts: the plain
// composition's bits.
//
// Bound on the H100: bytes (the codes, the posterior once, the masks
// written once: 2.6 MB of posterior at f32 B = 128 x 100 nt -w 50).
// Design: a block per (read, slice of cells), a thread per cell; bpp_keep
// a block per read, its threads striding over the read's cells and adding
// their counts in shared memory (integers: any order).
#include "common.cuh"

struct BppArgs {
  int Lp, Wp, B, max_span, wmin;
  const int* seq;               // [B, Lp] codes
  const int* L;                 // [B]
  const long long* pair;        // [5, 5] pair types (> 0: may pair)
  const unsigned char* bp0;     // [B, Lp+1, Wp+1] candidates
  const unsigned char* sel;     // [B, Lp+1, Wp+1] pairs kept from
  const void* post;             // [Lp+1, Wp+1, B] or null
  double log_min_bpp;
  unsigned char* out;           // bp0 (candidates) or keep
  void* eff;                    // [B] (keep)
};

static const int kBppThreads = 256;

__global__ void __launch_bounds__(kBppThreads)
bpp_candidates_kernel(BppArgs a) {
  const int W1 = a.Wp + 1, n = (a.Lp + 1) * W1, b = blockIdx.y;
  const int cell = blockIdx.x * kBppThreads + threadIdx.x;
  if (cell >= n) return;
  const int j = cell / W1, w = cell - j * W1, i = j - w;
  const int L = a.L[b], W = L < a.max_span ? L : a.max_span;
  const int* seq = a.seq + (long long)b * a.Lp;
  const int ci = i < 0 ? 0 : (i > a.Lp - 1 ? a.Lp - 1 : i);
  const int cj = j - 1 < 0 ? 0 : (j - 1 > a.Lp - 1 ? a.Lp - 1 : j - 1);
  const bool ok = i >= 0 && w >= a.wmin && j <= L && w <= W &&
                  a.pair[seq[ci] * 5 + seq[cj]] > 0;
  a.out[(long long)b * n + cell] = ok;
}

template <typename T>
__global__ void __launch_bounds__(kBppThreads)
bpp_keep_kernel(BppArgs a) {
  __shared__ int cnt[2];
  const int n = (a.Lp + 1) * (a.Wp + 1), b = blockIdx.x;
  if (threadIdx.x < 2) cnt[threadIdx.x] = 0;
  __syncthreads();
  const T* post = static_cast<const T*>(a.post);
  const T lo = (T)1e-300, thr = (T)a.log_min_bpp;
  int nk = 0, nb = 0;
  for (int cell = threadIdx.x; cell < n; cell += kBppThreads) {
    const long long at = (long long)b * n + cell;
    bool k = a.sel[at];
    if (k && post) {
      const T p = post[(long long)cell * a.B + b];
      k = lg(p < lo ? lo : p) >= thr;
    }
    a.out[at] = k;
    nk += k;
    nb += a.bp0[at];
  }
  atomicAdd(&cnt[0], nk);
  atomicAdd(&cnt[1], nb);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int tot = cnt[1] > 1 ? cnt[1] : 1;
    static_cast<T*>(a.eff)[b] = (T)cnt[0] / (T)tot;
  }
}

template <typename T>
static int bpp(BppArgs a, int keep, cudaStream_t st) {
  const long long n = (long long)(a.Lp + 1) * (a.Wp + 1);
  if (a.Lp < 1 || a.Wp < 0 || a.B < 1 || n >= (1LL << 31) ||
      (!keep && (a.B > 65535 || !a.seq || !a.L || !a.pair)) ||
      (keep && (!a.bp0 || !a.sel || !a.eff)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (keep)
    bpp_keep_kernel<T><<<a.B, kBppThreads, 0, st>>>(a);
  else
    bpp_candidates_kernel<<<dim3((n + kBppThreads - 1) / kBppThreads, a.B),
                            kBppThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#define BPP_EXPORTS(SUF, T)                                                 \
  RNAELEM_EXPORT int rnaelem_bpp_candidates_##SUF(BppArgs a,                \
                                                  cudaStream_t st) {        \
    return bpp<T>(a, 0, st);                                                \
  }                                                                         \
  RNAELEM_EXPORT int rnaelem_bpp_keep_##SUF(BppArgs a, cudaStream_t st) {   \
    return bpp<T>(a, 1, st);                                                \
  }

BPP_EXPORTS(f32, float)
BPP_EXPORTS(f64, double)
