// The multiloop M chain's block layout, shared by K2/K10's band_m (the
// chain forwards over w = 0..Wp) and K5's m_adj (its adjoint, backwards).
//
// The chain is Wp+1 dependent steps per (column, read), each a sparse
// log-sum-exp over at most a few left transitions per state: its time is
// the steps' latency, not bytes or operations.  A block holds a group of
// G reads; thread tid = s * G + g maps (state s, read g of the group), the
// read fastest, so one (w, s) row of the group in the batch-minor tables
// is G consecutive values: one 32-byte sector at G = 8 (f32) or G = 4
// (f64).  The inputs of step w (each thread copies the cells it reads
// itself) are staged into a shared-memory ring of R stages with cp.async
// while the steps before it compute, so no step waits on device memory;
// the only cross-thread exchange is the published row of the step,
// double-buffered so that one barrier per step suffices (a warp barrier
// where the group's threads fit in one warp).  The ring is sized by S, G
// and R, never by the span Wp.  G and R are template parameters that
// ops/kernels.band_plan picks on the host from S and the type: G = 32
// bytes' worth of reads, else 4, 2 or 1, the first with S x G <= 1024
// threads whose layout fits a block's shared memory, with R = kMRing,
// else R = kMRingSmall at G = 1.  Every sum keeps the order of the read's
// own transition lists, so a read's result does not depend on its group,
// its ring or on B.
#pragma once

#include <type_traits>

#include "common.cuh"

static const int kMRing = 4;       // ring stages (steps in flight)
static const int kMRingSmall = 2;  // the ring of a grammar too wide for 4
static const int kMSrc = 4;        // transitions per state held in registers

// threads of a block: S * G, rounded up to whole warps
__host__ __device__ __forceinline__ int mchain_threads(int S, int G) {
  return ((S * G + 31) / 32) * 32;
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

// launch f(G, R) as compile-time constants for the plan's (G, R) (the
// pairs ops/kernels.band_plan picks); anything else is refused
template <class F>
static int mchain_dispatch(int G, int R, F f) {
  using std::integral_constant;
  if (R == kMRing) {
    switch (G) {
      case 8: return f(integral_constant<int, 8>(),
                       integral_constant<int, kMRing>());
      case 4: return f(integral_constant<int, 4>(),
                       integral_constant<int, kMRing>());
      case 2: return f(integral_constant<int, 2>(),
                       integral_constant<int, kMRing>());
      case 1: return f(integral_constant<int, 1>(),
                       integral_constant<int, kMRing>());
    }
  } else if (R == kMRingSmall && G == 1) {
    return f(integral_constant<int, 1>(),
             integral_constant<int, kMRingSmall>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
