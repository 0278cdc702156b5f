// The multiloop M chain's block layout, shared by K2/K10's band_m (the
// chain forwards over w = 0..Wp) and K5's m_adj (its adjoint, backwards).
//
// The chain is Wp+1 dependent steps per (column, read), each a sparse
// log-sum-exp over at most a few left transitions per state: its time is
// the steps' latency, not bytes or operations.  A block holds a group of
// G reads; cell c = s * G + g is (state s, read g of the group), the read
// fastest, so one (w, s) row of the group in the batch-minor tables is G
// consecutive values: one 32-byte sector at G = 8 (f32) or G = 4 (f64).
// Thread tid owns the cells tid, tid + blockDim.x, ... (NC of them): one
// cell where S x G <= 1024, else (G = 1 only) 2 or 4 states strided by
// the block's width.  The inputs of step w (each thread copies the cells
// it owns and reads only those) are staged into a ring of R stages with
// cp.async while the steps before it compute, so no step waits on device
// memory; the only cross-thread exchange is the published row of the
// step, double-buffered so that one barrier per step suffices (a warp
// barrier where the block is one warp).  The ring is sized by S, G and R,
// never by the span Wp.  G, R and NC are template parameters that
// ops/kernels.band_plan picks on the host from S and the type: G = 32
// bytes' worth of reads, else 4, 2 or 1, the first whose S x G cells fit
// 1024 threads (at G = 1, NC cells a thread) and whose layout fits a
// block's shared memory, with R = kMRing, else R = kMRingSmall at G = 1.
// Where not even the G = 1 ring of 2 fits (K5's m_adj at f64 past 1,263
// states), the same kernel body runs with the layout in a slice of a
// device workspace per block (kDev, ring of kMRing; plain loads stage the
// ring there, as cp.async writes only shared memory; __syncthreads orders
// a block's device-memory accesses as it orders its shared ones).  Every
// sum keeps the order of the state's own transition list, so a read's
// result does not depend on its group, its ring, its variant or on B.
#pragma once

#include <type_traits>

#include "common.cuh"

static const int kMRing = 4;       // ring stages (steps in flight)
static const int kMRingSmall = 2;  // the ring of a grammar too wide for 4
static const int kMSrc = 4;        // transitions per state held in registers
static const int kMMaxThreads = 1024;

// threads of a block: S * G cells, NC a thread, rounded up to whole warps
__host__ __device__ __forceinline__ int mchain_threads(int S, int G,
                                                       int NC = 1) {
  return (((S * G + NC - 1) / NC + 31) / 32) * 32;
}

// a block's slice of the device variant's workspace starts on a 256-byte
// boundary (ops/kernels.py EP_WS_ALIGN)
__host__ __device__ __forceinline__ long long mchain_ws_stride(
    long long bytes) {
  return (bytes + 255) / 256 * 256;
}

// the base of a block's layout: its workspace slice (kDev) or the dynamic
// shared memory
template <bool kDev>
__device__ __forceinline__ unsigned char* mchain_base(unsigned char* smem,
                                                      unsigned char* ws,
                                                      long long bytes) {
  if constexpr (kDev)
    return ws + (long long)blockIdx.x * mchain_ws_stride(bytes);
  else
    return smem;
}

// a ring copy: cp.async into shared memory, or a plain load and store
// where the ring lies in the device workspace (kDev)
template <bool kDev, typename T>
__device__ __forceinline__ void mchain_copy(T* dst, const T* src) {
  if constexpr (kDev)
    *dst = *src;
  else
    cp_async_t(dst, src);
}
template <bool kDev>
__device__ __forceinline__ void mchain_copy_word(int* dst, const void* src) {
  if constexpr (kDev)
    *dst = *static_cast<const int*>(src);
  else
    cp_async<4>(dst, src);
}
template <bool kDev>
__device__ __forceinline__ void mchain_commit() {
  if constexpr (!kDev) cp_async_commit();
}
template <bool kDev, int N>
__device__ __forceinline__ void mchain_wait() {
  if constexpr (!kDev) cp_async_wait<N>();
}

// Shared-memory layout of a block, in bytes, the same on the host (the
// launch's size) and in the kernel (its pointers); ops/kernels.py
// band_smem_bytes mirrors it.  n = S * G cells per row; a row buffer of
// two slots [2][nbuf][n] (scalar type) for the published values, then the
// ring [R][nring][n] (scalar type) and its okM words [R][n] (int).
// band_m: nbuf 2 (M(w-1) and eL), nring 3 (Bt, eL, gate_M).  m_adj: nbuf 2
// (the cotangent and value of M(w)), nring 9 (M(w), gM, Bt, M(w-1), eL,
// gate_M, eL's cotangent as it stands, T1 and its cotangent).
struct MLayout {
  long long n, buf, ring, ok, total;
  __host__ __device__ MLayout(int S, int G, int R, int nbuf, int nring,
                              int itemsize) {
    n = (long long)S * G;
    buf = 0;
    ring = buf + 2LL * nbuf * n * itemsize;
    ok = ring + (long long)R * nring * n * itemsize;
    total = ok + (long long)R * n * 4;
  }
};

// the layouts' (nbuf, nring) of the two kernels: which 0 = band_m, 1 = m_adj
__host__ __device__ __forceinline__ MLayout mchain_layout(int which, int S,
                                                          int G, int R,
                                                          int itemsize) {
  return which == 0 ? MLayout(S, G, R, 2, 3, itemsize)
                    : MLayout(S, G, R, 2, 9, itemsize);
}

// launch f(G, R, NC, kDev) as compile-time constants for the plan's
// (G, R, NC, variant) (the combinations ops/kernels.band_plan picks);
// anything else is refused
template <class F>
static int mchain_dispatch(int G, int R, int NC, bool dev, F f) {
  using std::integral_constant;
  using std::false_type;
  using std::true_type;
  using I1 = integral_constant<int, 1>;
  using I2 = integral_constant<int, 2>;
  using I4 = integral_constant<int, 4>;
  using RB = integral_constant<int, kMRing>;
  using RS = integral_constant<int, kMRingSmall>;
  if (dev) {
    if (G != 1 || R != kMRing) return static_cast<int>(cudaErrorInvalidValue);
    switch (NC) {
      case 1: return f(I1(), RB(), I1(), true_type());
      case 2: return f(I1(), RB(), I2(), true_type());
      case 4: return f(I1(), RB(), I4(), true_type());
    }
  } else if (NC == 1 && R == kMRing) {
    switch (G) {
      case 8: return f(integral_constant<int, 8>(), RB(), I1(), false_type());
      case 4: return f(I4(), RB(), I1(), false_type());
      case 2: return f(I2(), RB(), I1(), false_type());
      case 1: return f(I1(), RB(), I1(), false_type());
    }
  } else if (G == 1) {
    const bool big = R == kMRing;
    if (R != kMRing && R != kMRingSmall)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (NC) {
      case 1:
        return big ? f(I1(), RB(), I1(), false_type())
                   : f(I1(), RS(), I1(), false_type());
      case 2:
        return big ? f(I1(), RB(), I2(), false_type())
                   : f(I1(), RS(), I2(), false_type());
      case 4:
        return big ? f(I1(), RB(), I4(), false_type())
                   : f(I1(), RS(), I4(), false_type());
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the plan's block fits: S x G cells in NC a thread, at most 1024 threads
__host__ __forceinline__ bool mchain_fits(int S, int G, int NC) {
  return mchain_threads(S, G, NC) <= kMMaxThreads &&
         (long long)mchain_threads(S, G, NC) * NC >= (long long)S * G;
}

// okM is a bool table: copy the aligned 4-byte word that holds the cell
// (it lies in the same page as the cell) and pick the byte out
__device__ __forceinline__ const void* ok_word(const bool* p) {
  return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) &
                                       ~static_cast<uintptr_t>(3));
}
__device__ __forceinline__ bool ok_byte(int word, const bool* p) {
  const int sh = 8 * static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
  return ((static_cast<unsigned>(word) >> sh) & 0xffu) != 0;
}

// the barrier of one chain step: a warp's where the block is one warp
__device__ __forceinline__ void mchain_sync() {
  if (blockDim.x <= 32)
    __syncwarp();
  else
    __syncthreads();
}

__device__ __forceinline__ int clip_row(int i, int Lp) {
  return i < 0 ? 0 : (i > Lp - 1 ? Lp - 1 : i);
}

// the pin entries that veto kind ``kind`` of read b, as base positions in
// registers (-1: none); pin_req_reg is pin_req on them
struct PinRegs {
  int pos[kMaxPins];
};
__device__ __forceinline__ PinRegs pin_regs(const Aux& a, int b, int kind) {
  PinRegs p;
#pragma unroll
  for (int k = 0; k < kMaxPins; ++k) {
    p.pos[k] = -1;
    if (a.pin[k] != nullptr && ((a.pin_kinds[k] >> kind) & 1))
      p.pos[k] = a.pin[k][b];
  }
  return p;
}
__device__ __forceinline__ int pin_req_reg(const Aux& a, const PinRegs& p,
                                           int base) {
  int req = 0;
#pragma unroll
  for (int k = 0; k < kMaxPins; ++k)
    if (p.pos[k] >= 0 && p.pos[k] == base) req |= a.pin_bit[k];
  return req;
}
