// Shared helpers of the package's merge kernels (merge.cu, delta.cu).
//
// Storage: every uint32 field of a replica state lives in an int32 tensor
// holding the same bits; the kernels read it as uint32_t.  bool tensors
// are one byte per lane, 0 or 1.  The kernels are templated on the lane
// layout (Layout below); the algebra between load and store is shared.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace crdt {

// Which row of the source batch replica r absorbs.
enum PartnerMode {
  PARTNER_RING = 0,      // (r + offset) mod R, offset already in [0, R)
  PARTNER_GATHER = 1,    // perm[r]
  PARTNER_PAIRWISE = 2,  // row r of a second batch
};

constexpr int kThreads = 256;

__device__ __forceinline__ long long partner_row(long long r, int mode,
                                                 long long offset,
                                                 const long long* perm,
                                                 long long num_r) {
  if (mode == PARTNER_RING) {
    const long long p = r + offset;
    return p >= num_r ? p - num_r : p;
  }
  if (mode == PARTNER_GATHER) return perm[r];
  return r;
}

// HasDot's clock lookup vv[actor], with the id clipped to [0, A) the way
// jnp.take(mode="clip") clips the int32 view of a uint32 id.
__device__ __forceinline__ uint32_t clock_at(const uint32_t* vv,
                                             uint32_t actor, int num_a) {
  int a = static_cast<int>(actor);
  a = a < 0 ? 0 : (a >= num_a ? num_a - 1 : a);
  return vv[a];
}

// One block per replica row, rows strided over the grid.
inline unsigned grid_for(long long num_r) {
  const long long cap = 1LL << 30;
  return static_cast<unsigned>(num_r < cap ? num_r : cap);
}

// Where a kernel keeps the vv rows it stages (smem bytes of dynamic shared
// memory beside static_bytes of static shared memory): in shared memory up
// to the card's opt-in limit per block (227 KB on an H100; the merge and
// δ rows, 2 x A x 4 B, fit to A = 29,056), opting in past the default
// 48 KB; past the limit the kernel reads them from device memory.
// Returns 1 (shared), 0 (device memory) or a cudaError_t negated.
template <typename Kernel>
inline int vv_rows_in_smem(Kernel* kernel, size_t smem,
                           size_t static_bytes = 0) {
  if (smem + static_bytes <= 48 * 1024) return 1;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (smem + static_bytes > static_cast<size_t>(optin)) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

// How a state stores its E-shaped lanes (models/packed.py):
//   LAYOUT_BOOL     membership one byte per lane, dots as two uint32 arrays;
//   LAYOUT_BITS     membership as uint32[R, W], W = ceil(E/32): bit e % 32
//                   of word e / 32, the tail bits past E zero;
//   LAYOUT_DOTWORD  LAYOUT_BITS, and each dot as one word
//                   (actor << 20) | counter.
enum Layout { LAYOUT_BOOL = 0, LAYOUT_BITS = 1, LAYOUT_DOTWORD = 2 };
constexpr unsigned kDotShift = 20;
constexpr uint32_t kDotCMask = (1u << kDotShift) - 1u;

__host__ __device__ __forceinline__ long long words_for(long long num_e) {
  return (num_e + 31) / 32;
}

// The bound of a block's lane loop.  With bit layouts it is E rounded up
// to whole words, so every lane of a warp reaches the ballot in
// store_member; lanes past E are masked, not skipped.
template <int L>
__device__ __forceinline__ long long lane_end(long long num_e) {
  return L == LAYOUT_BOOL ? num_e : words_for(num_e) * 32;
}

// Membership of lane e of row `row`.  Bit layouts: the 32 lanes of a warp
// share one word, so this is one broadcast load.
template <int L>
__device__ __forceinline__ bool load_member(const void* m, long long row,
                                            long long e, long long num_e) {
  if constexpr (L == LAYOUT_BOOL) {
    return static_cast<const uint8_t*>(m)[row * num_e + e] != 0;
  } else {
    const uint32_t w =
        static_cast<const uint32_t*>(m)[row * words_for(num_e) + (e >> 5)];
    return ((w >> (e & 31)) & 1u) != 0;
  }
}

// Store lane e's membership bit.  Bit layouts: the caller's lane loop
// starts at threadIdx.x and steps by blockDim.x (a multiple of 32), so warp
// k of a pass holds the aligned lanes [32k, 32k + 32) of that pass: the
// warp's ballot is exactly word e / 32, and its lane 0 writes it.  Every
// lane of the warp must call this; lanes with valid == false add a 0 bit.
template <int L>
__device__ __forceinline__ void store_member(void* m, long long row,
                                             long long e, bool valid,
                                             bool bit, long long num_e) {
  if constexpr (L == LAYOUT_BOOL) {
    if (valid) static_cast<uint8_t*>(m)[row * num_e + e] = bit;
  } else {
    const uint32_t w = __ballot_sync(0xffffffffu, valid && bit);
    if ((threadIdx.x & 31) == 0) {
      static_cast<uint32_t*>(m)[row * words_for(num_e) + (e >> 5)] = w;
    }
  }
}

// A dot at flat lane index i: from the actor and counter arrays, or from
// the one dot-word array `a` (c unused).
template <int L>
__device__ __forceinline__ void load_dot(const uint32_t* a, const uint32_t* c,
                                         long long i, uint32_t& actor,
                                         uint32_t& counter) {
  if constexpr (L == LAYOUT_DOTWORD) {
    const uint32_t w = a[i];
    actor = w >> kDotShift;
    counter = w & kDotCMask;
  } else {
    actor = a[i];
    counter = c[i];
  }
}

template <int L>
__device__ __forceinline__ void store_dot(uint32_t* a, uint32_t* c,
                                          long long i, uint32_t actor,
                                          uint32_t counter) {
  if constexpr (L == LAYOUT_DOTWORD) {
    a[i] = (actor << kDotShift) | counter;
  } else {
    a[i] = actor;
    c[i] = counter;
  }
}

// A launch a kernel's own limits refuse (no cudaError_t): the batch has
// more rows than the kernel holds in shared memory.
constexpr int kErrTooManyRows = 10000;

}  // namespace crdt

extern "C" const char* crdt_error_string(int err) {
  if (err == crdt::kErrTooManyRows) {
    return "refused: the batch has too many rows for the kernel's shared "
           "memory";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
