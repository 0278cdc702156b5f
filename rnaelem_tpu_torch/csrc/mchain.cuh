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
// itself) are staged into a shared-memory ring of kMRing stages with
// cp.async while the steps before it compute, so no step waits on device
// memory; the only cross-thread exchange is the published row of the
// step, double-buffered so that one barrier per step suffices (a warp
// barrier where the group's threads fit in one warp).  The ring is sized
// by S, G and kMRing, never by the span Wp.  Every sum keeps the order of
// the read's own transition lists, so a read's result does not depend on
// its group or on B.
#pragma once

#include "common.cuh"

static const int kMRing = 4;         // ring stages (steps in flight)
static const int kMGroupBytes = 32;  // a (w, s) row of a block's reads
static const int kMSrc = 4;          // transitions per state held in registers
static_assert((kMRing & (kMRing - 1)) == 0, "the ring's stages: a power of 2");

// reads per block: one 32-byte sector of a (w, s) row
template <typename T>
struct MGroup {
  static const int G = kMGroupBytes / sizeof(T);
};

// threads of a block: S * G, rounded up to whole warps
__host__ __device__ __forceinline__ int mchain_threads(int S, int G) {
  return ((S * G + 31) / 32) * 32;
}

// Shared-memory layout of a block, in bytes, the same on the host (the
// launch's size) and in the kernel (its pointers); ops/kernels.py
// band_smem_bytes mirrors it.  n = S * G cells per row; a row buffer of
// two slots [2][nbuf][n] (scalar type) for the published values, then the
// ring [kMRing][nring][n] (scalar type) and its okM words [kMRing][n]
// (int).  band_m: nbuf 1 (y), nring 3 (Bt, eL, gate_M).  m_adj: nbuf 2
// (the cotangent and value of M(w)), nring 9 (M(w), gM, Bt, M(w-1), eL,
// gate_M, eL's cotangent as it stands, T1 and its cotangent).
struct MLayout {
  long long n, buf, ring, ok, total;
  __host__ __device__ MLayout(int S, int G, int nbuf, int nring,
                              int itemsize) {
    n = (long long)S * G;
    buf = 0;
    ring = buf + 2LL * nbuf * n * itemsize;
    ok = ring + (long long)kMRing * nring * n * itemsize;
    total = ok + (long long)kMRing * n * 4;
  }
};

// the layouts' (nbuf, nring) of the two kernels: which 0 = band_m, 1 = m_adj
__host__ __device__ __forceinline__ MLayout mchain_layout(int which, int S,
                                                          int itemsize) {
  const int G = kMGroupBytes / itemsize;
  return which == 0 ? MLayout(S, G, 1, 3, itemsize)
                    : MLayout(S, G, 2, 9, itemsize);
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
