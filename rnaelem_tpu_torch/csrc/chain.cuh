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
// dependence: L_b steps per read, each a sparse S x S log-sum-exp (52
// transitions among the 28 states of ..*..).  So nothing but the step's
// own arithmetic may stand on a step's path.  A block holds one read; a
// cell is a state.  The walkers, the block's first threads, own the cells
// tid, tid + walkers, ... (NC of them: one where S <= 1024, else 2 or 4
// states strided by the walkers' count, up to 4,096 states).  At S <= 32
// the walkers are one warp, and a step exchanges its values by warp
// shuffles, with no shared row and no barrier; otherwise through a shared
// row and one barrier a step.  Each cell's transition list (sources or
// targets, log weights, class codes) is read once, before the walk, its
// first ChainSrc<NC>::N entries into registers, and a step fetches every
// entry's values before it uses any, without a branch per entry.  A
// step's inputs are in shared memory before the step: K8 copies eR's rows
// into a ring of kChainRing steps with cp.async while the steps before
// them compute; K9 stages a tile of steps' chain rows and eR rows and
// computes every softmax weight of the tile in parallel (its helpers,
// copies of the walkers, sharing that work), then walks the tile, each
// step a few loads and multiply-adds, the class partials (the scanner's
// probe) formed off the walk's dependent path and summed over the states
// after it in parallel over the steps.  Every sum keeps one order (each
// state's own list, then the states in ascending order), and every value
// is formed by one expression (K9's products and sums with their
// roundings written out: csrc/linear_adj.cu chain_madd), so a read's bits
// do not depend on its tile, its variant or on B.
// ops/kernels.chain_plan picks NC, the tile and the variant on the host
// from S, the type, nnz and Lp.
#pragma once

#include "mchain.cuh"

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

// A launch's layout, from ops/kernels.chain_plan: NC cells a thread, R steps (K8: the ring's stages, kChainRing; K9: the
// steps of a tile), nnz the grammar's transitions, the block's threads,
// dev 1 where K9's layout lies in a slice of ws_stride bytes of a device
// workspace per block (else smem bytes of shared memory).
struct ChainGrid {
  int NC, R, nnz, threads, dev, smem, ws_stride;
};

static const int kChainRing = 4;        // K8's ring of eR rows (steps)
static const int kChainMaxThreads = 1024;
static const int kChainMaxStates = 4096;

// transitions per cell held in registers (every grammar of the repo has
// at most 3 a state; more are walked from the lists themselves)
template <int NC>
struct ChainSrc {
  static const int N = NC == 1 ? 3 : 2;
};

// Layouts in bytes, the same on the host (the launch's size, and
// ops/kernels.chain_smem_bytes) and in the kernels (their pointers); n =
// S cells a row, scalar type.
// K8: the chain row, two slots [2][n], then the ring of eR rows [R][n].
struct ChainFwdLayout {
  long long n, o, ring, total;
  __host__ __device__ ChainFwdLayout(int S, int itemsize) {
    n = S;
    o = 0;
    ring = o + 2 * n * itemsize;
    total = ring + (long long)kChainRing * n * itemsize;
  }
};

// K9, a tile of R steps: the weights W [R][nnz] (-1 where the
// transition takes no part), the cotangent rows g [R+1][n] (row r at slot
// r mod (R+1)), the chain rows o [R+1][n] and eR's rows [R][n] of the
// tile, and in the pin / class-sum instantiation (aux) each cell's class
// partials [R][4][n].
struct ChainAdjLayout {
  long long n, w, g, o, e, part, total;
  __host__ __device__ ChainAdjLayout(int S, int R, int nnz, bool aux,
                                     int itemsize) {
    n = S;
    w = 0;
    g = w + (long long)R * nnz * itemsize;
    o = g + (R + 1LL) * n * itemsize;
    e = o + (R + 1LL) * n * itemsize;
    part = e + (long long)R * n * itemsize;
    total = part + (aux ? 4LL * R * n * itemsize : 0);
  }
};

// threads of a block: S cells, NC a thread, in whole warps
__host__ __device__ __forceinline__ int chain_threads(int S, int NC) {
  return (((S + NC - 1) / NC + 31) / 32) * 32;
}

// K9's block: its walkers (chain_threads) and their copies, the helpers,
// up to kChainAdjThreads threads in all
static const int kChainAdjThreads = 128;
__host__ __device__ __forceinline__ int chain_adj_threads(int S, int NC) {
  const int base = chain_threads(S, NC);
  return base < kChainAdjThreads ? kChainAdjThreads / base * base : base;
}

// the launch's plan is the kernel's: threads, cells and the layout's bytes
static inline bool chain_grid_ok(const ChainDims& D, const ChainGrid& pg,
                                 long long bytes, bool adj) {
  if (D.S < 1 || D.S > kChainMaxStates || D.B < 1 || D.Lp < 0) return false;
  const int base = chain_threads(D.S, pg.NC);
  if (pg.threads != (adj ? chain_adj_threads(D.S, pg.NC) : base) ||
      pg.threads > kChainMaxThreads || (long long)base * pg.NC < D.S)
    return false;
  if (pg.dev) return pg.smem == 0 && pg.ws_stride == mchain_ws_stride(bytes);
  return pg.smem == bytes && bytes <= kSmemLimit;
}

// a cell's transition list: entries k0 .. k1 - 1 of the CSR lists, the
// first ChainSrc<NC>::N of them (nin) in registers as their entry k, the
// other end's state (its cell in the block's rows), the log weight and
// the class code; the slots past nin hold entry 0 and cell 0, which
// the kernels load and never use (the steps take no branch per entry)
template <typename T, int N>
struct ChainList {
  int k0, k1, nin, k[N], cell[N], code[N];
  T w[N];
};

// the list of state s from CSR lists (off, other
// end, weights); the class codes of transition t <- s at code[(0 * S + t)
// * S + s], t the target (kAuxR)
template <typename T, int N>
__device__ __forceinline__ ChainList<T, N> chain_list(
    const int* off, const int* other, const T* w, const int* code, int s,
    int S, bool by_target, bool live, bool codes) {
  ChainList<T, N> l;
  l.k0 = live ? off[s] : 0;
  l.k1 = live ? off[s + 1] : 0;
  l.nin = l.k1 - l.k0 < N ? l.k1 - l.k0 : N;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const bool in = q < l.nin;
    const int o = in ? other[l.k0 + q] : 0;
    l.k[q] = in ? l.k0 + q : 0;
    l.cell[q] = o;
    l.w[q] = in ? w[l.k0 + q] : (T)0;
    l.code[q] = in && codes ? code[by_target ? s * S + o : o * S + s] : 0;
  }
  return l;
}

// the barrier of one step of the walk, among its `walkers` threads (the
// first of the block): a warp's where they are one warp, else a named
// barrier that the helpers never reach
__device__ __forceinline__ void chain_walk_sync(int walkers) {
  if (walkers <= 32)
    __syncwarp();
  else if (walkers == (int)blockDim.x)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;\n" ::"r"(walkers) : "memory");
}

// does a pin requiring the class bits ``req`` veto a transition of class
// code ``code``?  (common.cuh vetoed, on the code itself)
__device__ __forceinline__ bool vetoed_code(int req, int code) {
  return req != 0 && (code & req) != req;
}

// the length of read b, clipped to Lp
__device__ __forceinline__ int read_len(const long long* L, int b, int Lp) {
  return L[b] < Lp ? static_cast<int>(L[b]) : Lp;
}

// launch f(NC) as a compile-time constant for the plan's NC (1, 2 or 4);
// anything else is refused
template <class F>
static int chain_dispatch(int NC, F f) {
  using std::integral_constant;
  switch (NC) {
    case 1: return f(integral_constant<int, 1>());
    case 2: return f(integral_constant<int, 2>());
    case 4: return f(integral_constant<int, 4>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
