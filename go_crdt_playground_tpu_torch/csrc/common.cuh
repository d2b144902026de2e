// Shared helpers of the package's merge kernels (merge.cu, delta.cu).
//
// Storage: every uint32 field of a replica state lives in an int32 tensor
// holding the same bits; the kernels read it as uint32_t.  bool tensors
// are one byte per lane, 0 or 1.
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

}  // namespace crdt

extern "C" const char* crdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
