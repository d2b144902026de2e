// Per-lane digest fingerprints of one replica slice and their group XOR
// fold (net/digestsync.py's summary read).
//
// Replaces the Pallas kernel of go_crdt_playground_tpu/ops/pallas_digest.py:
//   K11 _fused_fingerprints (_digest_kernel), reached through
//   pallas_lane_fingerprints and pallas_state_group_digests.
// For lane e (all arithmetic uint32):
//   h = fmix32(e ^ 0x9E3779B9); then h = fmix32(h ^ v) for
//   v = present != 0, deleted != 0, del_dot_actor, del_dot_counter,
// and group g's digest is the XOR of the lanes [g * gs, (g + 1) * gs).
// Lanes past E in the ragged last group hash as zero lanes at their own
// ids E, E + 1, ... (ops/digest.py group_fold).  Live dots and the vv are
// not read.
//
// Bound: memory.  A lane reads 10 bytes (two bool bytes, two uint32
// words) and a group writes 4: at E = 1,048,576 and gs = 64 that is
// 10,551,296 bytes, 3.15 us at 3.35 TB/s; the mix and the fold are
// about 48 integer operations a lane, 0.75 us at the 67 T/s scalar rate.
// At the serving shapes (E of a few thousand) a launch is latency-bound.
// Design: the TPU kernel left the fold to XLA around it; here it is fused,
// so the fingerprints never reach device memory.  One thread per lane,
// 256 lanes a block, the fingerprint in registers.  A group size that is
// a power of two up to 256 (every rung of the protocol's ladder, 8..128)
// reduces with __shfl_xor_sync inside a warp and, above 32, across the
// block's warps through shared memory; a block then covers whole groups.
// Any other group size takes one warp per group, its lanes striding over
// the group.  Loads are byte and word loads, not vectorized.
#include "common.cuh"

namespace {

constexpr uint32_t kSeed = 0x9E3779B9u;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr int kWarps = crdt::kThreads / 32;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  return h ^ (h >> 16);
}

// The fingerprint of lane e, a zero lane when e >= num_e.
__device__ __forceinline__ uint32_t lane_fp(
    long long e, long long num_e, const uint8_t* __restrict__ present,
    const uint8_t* __restrict__ deleted,
    const uint32_t* __restrict__ del_dot_actor,
    const uint32_t* __restrict__ del_dot_counter) {
  uint32_t p = 0u, d = 0u, xa = 0u, xc = 0u;
  if (e < num_e) {
    p = present[e] != 0;
    d = deleted[e] != 0;
    xa = del_dot_actor[e];
    xc = del_dot_counter[e];
  }
  uint32_t h = fmix32(static_cast<uint32_t>(e) ^ kSeed);
  h = fmix32(h ^ p);
  h = fmix32(h ^ d);
  h = fmix32(h ^ xa);
  return fmix32(h ^ xc);
}

__global__ void lane_fingerprints(const uint8_t* __restrict__ present,
                                  const uint8_t* __restrict__ deleted,
                                  const uint32_t* __restrict__ xa,
                                  const uint32_t* __restrict__ xc,
                                  uint32_t* __restrict__ out,
                                  long long num_e) {
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < num_e; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[e] = lane_fp(e, num_e, present, deleted, xa, xc);
  }
}

// gs a power of two, 1 <= gs <= 256: block b covers lanes
// [256 b, 256 b + 256), i.e. 256 / gs whole groups (groups past the last
// one, num_g, are not written).  Every thread reaches every shuffle.
__global__ void group_digests_pow2(const uint8_t* __restrict__ present,
                                   const uint8_t* __restrict__ deleted,
                                   const uint32_t* __restrict__ xa,
                                   const uint32_t* __restrict__ xc,
                                   uint32_t* __restrict__ out,
                                   long long num_e, long long num_g,
                                   int gs) {
  __shared__ uint32_t warp_x[kWarps];
  const long long padded = num_g * gs;
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t v =
      e < padded ? lane_fp(e, num_e, present, deleted, xa, xc) : 0u;
  const int width = gs < 32 ? gs : 32;
  for (int off = width / 2; off > 0; off /= 2) {
    v ^= __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  if (gs <= 32) {
    if (lane % gs == 0 && e < padded) out[e / gs] = v;
    return;
  }
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_x[warp] = v;
  __syncthreads();
  const int per_group = gs / 32;
  const int groups = crdt::kThreads / gs;
  if (static_cast<int>(threadIdx.x) < groups) {
    const long long g =
        static_cast<long long>(blockIdx.x) * groups + threadIdx.x;
    if (g < num_g) {
      uint32_t x = 0u;
      for (int w = 0; w < per_group; ++w) {
        x ^= warp_x[threadIdx.x * per_group + w];
      }
      out[g] = x;
    }
  }
}

// Any gs: one warp per group, its 32 lanes striding over the group.
__global__ void group_digests_strided(const uint8_t* __restrict__ present,
                                      const uint8_t* __restrict__ deleted,
                                      const uint32_t* __restrict__ xa,
                                      const uint32_t* __restrict__ xc,
                                      uint32_t* __restrict__ out,
                                      long long num_e, long long num_g,
                                      long long gs) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long g = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       g < num_g; g += warps) {
    uint32_t v = 0u;
    for (long long j = lane; j < gs; j += 32) {
      v ^= lane_fp(g * gs + j, num_e, present, deleted, xa, xc);
    }
    for (int off = 16; off > 0; off /= 2) {
      v ^= __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) out[g] = v;
  }
}

inline unsigned blocks_for(long long n, long long per_block) {
  const long long b = (n + per_block - 1) / per_block;
  const long long cap = 1LL << 30;
  return static_cast<unsigned>(b < cap ? b : cap);
}

}  // namespace

// Fingerprints of E lanes into out[E].  bool arrays one byte a lane,
// uint32 arrays any 32-bit storage.  Returns the cudaError_t of the launch.
extern "C" int crdt_lane_fingerprints(const void* present,
                                      const void* deleted,
                                      const void* del_dot_actor,
                                      const void* del_dot_counter, void* out,
                                      long long num_e, void* stream) {
  if (num_e <= 0) return 0;
  lane_fingerprints<<<blocks_for(num_e, crdt::kThreads), crdt::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(present),
      static_cast<const uint8_t*>(deleted),
      static_cast<const uint32_t*>(del_dot_actor),
      static_cast<const uint32_t*>(del_dot_counter),
      static_cast<uint32_t*>(out), num_e);
  return static_cast<int>(cudaGetLastError());
}

// Group digests of E lanes at group size gs >= 1 into out[ceil(E / gs)].
extern "C" int crdt_group_digests(const void* present, const void* deleted,
                                  const void* del_dot_actor,
                                  const void* del_dot_counter, void* out,
                                  long long num_e, long long gs,
                                  void* stream) {
  if (num_e <= 0) return 0;
  if (gs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long num_g = (num_e + gs - 1) / gs;
  const auto* p = static_cast<const uint8_t*>(present);
  const auto* d = static_cast<const uint8_t*>(deleted);
  const auto* xa = static_cast<const uint32_t*>(del_dot_actor);
  const auto* xc = static_cast<const uint32_t*>(del_dot_counter);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (gs <= crdt::kThreads && (gs & (gs - 1)) == 0) {
    group_digests_pow2<<<blocks_for(num_g * gs, crdt::kThreads),
                         crdt::kThreads, 0, s>>>(p, d, xa, xc, o, num_e,
                                                 num_g, static_cast<int>(gs));
  } else {
    group_digests_strided<<<blocks_for(num_g, kWarps), crdt::kThreads, 0,
                            s>>>(p, d, xa, xc, o, num_e, num_g, gs);
  }
  return static_cast<int>(cudaGetLastError());
}
