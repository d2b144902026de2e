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
// not read.  ``lane_base`` is the global id of lane 0 (a lane-sharded
// node's slot hashes lane e as id lane_base + e, padding included; 0 for
// a whole slice).
//
// Bound: memory.  A lane reads 10 bytes (two bool bytes, two uint32
// words) and a group writes 4: at E = 1,048,576 and gs = 64 that is
// 10,551,296 bytes, 3.15 us at 3.35 TB/s; the mix and the fold are
// about 48 integer operations a lane, 0.75 us at the 67 T/s scalar rate.
// At the serving shapes (E of a few thousand) a launch is latency-bound.
// Design: the TPU kernel left the fold to XLA around it; here it is fused,
// so the fingerprints never reach device memory.  A thread hashes a quad
// of 4 consecutive lanes from one 32-bit load of each bool array and one
// 16-byte load of each uint32 array (40 bytes in flight a thread), and
// XORs the quad in registers before the shuffle tree, so a block of 256
// threads covers 1,024 lanes.  A group size that is a power of two up to
// 256 (every rung of the protocol's ladder, 8..128) reduces with
// __shfl_xor_sync over gs / 4 threads and, at 256, across two warps
// through shared memory; the fingerprints entry is the same kernel at
// gs = 1 and writes 16 bytes a thread.  Any other group size takes one
// warp per group, its lanes striding over the group's aligned quads with
// the same vector loads and the ragged ends lane by lane.  Word loads take
// over for a quad that crosses E and for unaligned pointers (a slice that
// starts mid-tensor).
#include "common.cuh"

namespace {

constexpr uint32_t kSeed = 0x9E3779B9u;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr int kWarps = crdt::kThreads / 32;
constexpr long long kQuadsPerBlock = crdt::kThreads;  // 1,024 lanes

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t fp_of(long long e, uint32_t p,
                                          uint32_t d, uint32_t xa,
                                          uint32_t xc) {
  uint32_t h = fmix32(static_cast<uint32_t>(e) ^ kSeed);
  h = fmix32(h ^ p);
  h = fmix32(h ^ d);
  h = fmix32(h ^ xa);
  return fmix32(h ^ xc);
}

struct Lanes {
  const uint8_t* present;
  const uint8_t* deleted;
  const uint32_t* xa;
  const uint32_t* xc;
  long long num_e;
  long long base;  // global id of lane 0
};

// The fingerprint of lane e, a zero lane when e >= num_e.
__device__ __forceinline__ uint32_t lane_fp(const Lanes& s, long long e) {
  if (e >= s.num_e) return fp_of(s.base + e, 0u, 0u, 0u, 0u);
  return fp_of(s.base + e, s.present[e] != 0, s.deleted[e] != 0, s.xa[e],
               s.xc[e]);
}

// The fingerprints of lanes 4q .. 4q + 3: vector loads when the quad lies
// inside E and VEC says the pointers allow them, lane loads otherwise.
template <bool VEC>
__device__ __forceinline__ void quad_fp(const Lanes& s, long long q,
                                        uint32_t f[4]) {
  const long long e0 = 4 * q;
  if (VEC && e0 + 3 < s.num_e) {
    const uint32_t pw = reinterpret_cast<const uint32_t*>(s.present)[q];
    const uint32_t dw = reinterpret_cast<const uint32_t*>(s.deleted)[q];
    const uint4 a = reinterpret_cast<const uint4*>(s.xa)[q];
    const uint4 c = reinterpret_cast<const uint4*>(s.xc)[q];
    const long long id = s.base + e0;
    f[0] = fp_of(id, (pw & 0xffu) != 0, (dw & 0xffu) != 0, a.x, c.x);
    f[1] = fp_of(id + 1, (pw & 0xff00u) != 0, (dw & 0xff00u) != 0, a.y, c.y);
    f[2] = fp_of(id + 2, (pw & 0xff0000u) != 0, (dw & 0xff0000u) != 0, a.z,
                 c.z);
    f[3] = fp_of(id + 3, (pw >> 24) != 0, (dw >> 24) != 0, a.w, c.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = lane_fp(s, e0 + j);
  }
}

// gs a power of two, 1 <= gs <= 256: thread t of block b hashes quad
// q = 1,024 b / 4 + t.  Lanes past the padded end num_g * gs add nothing
// and groups past num_g are not written.  gs = 1 and 2 write one or two
// groups a thread; gs >= 4 XORs the quad and reduces over gs / 4
// threads.  Every thread reaches every shuffle.
template <bool VEC>
__global__ void group_digests_pow2(Lanes s, uint32_t* __restrict__ out,
                                   long long num_g, int gs, bool vec_out) {
  __shared__ uint32_t warp_x[kWarps];
  const long long padded = num_g * gs;
  const long long q =
      static_cast<long long>(blockIdx.x) * kQuadsPerBlock + threadIdx.x;
  const long long e0 = 4 * q;
  uint32_t f[4] = {0u, 0u, 0u, 0u};
  if (e0 < padded) quad_fp<VEC>(s, q, f);
  if (gs == 1) {
    if (vec_out && e0 + 3 < padded) {
      reinterpret_cast<uint4*>(out)[q] = make_uint4(f[0], f[1], f[2], f[3]);
    } else {
      for (int j = 0; j < 4; ++j) {
        if (e0 + j < padded) out[e0 + j] = f[j];
      }
    }
    return;
  }
  if (gs == 2) {
    if (e0 < padded) out[e0 / 2] = f[0] ^ f[1];
    if (e0 + 2 < padded) out[e0 / 2 + 1] = f[2] ^ f[3];
    return;
  }
  uint32_t v = e0 < padded ? f[0] ^ f[1] ^ f[2] ^ f[3] : 0u;
  const int width = gs / 4 < 32 ? gs / 4 : 32;
  for (int off = width / 2; off > 0; off /= 2) {
    v ^= __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  if (gs <= 128) {
    if (lane % width == 0 && e0 < padded) out[e0 / gs] = v;
    return;
  }
  // gs = 256: two warps a group
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_x[warp] = v;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < kWarps / 2) {
    const long long g =
        static_cast<long long>(blockIdx.x) * (kWarps / 2) + threadIdx.x;
    if (g < num_g) {
      out[g] = warp_x[2 * threadIdx.x] ^ warp_x[2 * threadIdx.x + 1];
    }
  }
}

// Any gs: one warp per group.  The group's lanes [start, end) split into
// a head before the first 4-aligned lane, whole aligned quads, and a tail
// (head and tail under 4 lanes each, hashed lane by lane).
template <bool VEC>
__global__ void group_digests_strided(Lanes s, uint32_t* __restrict__ out,
                                      long long num_g, long long gs) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long g = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       g < num_g; g += warps) {
    const long long start = g * gs, end = start + gs;
    const long long a0 = min(end, (start + 3) & ~3LL);
    const long long a1 = max(a0, end & ~3LL);
    uint32_t v = 0u;
    if (lane < a0 - start) v ^= lane_fp(s, start + lane);
    if (lane < end - a1) v ^= lane_fp(s, a1 + lane);
    for (long long q = a0 / 4 + lane; q < a1 / 4; q += 32) {
      uint32_t f[4];
      quad_fp<VEC>(s, q, f);
      v ^= f[0] ^ f[1] ^ f[2] ^ f[3];
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

inline bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

template <bool VEC>
void launch(const Lanes& s, uint32_t* out, long long num_g, long long gs,
            cudaStream_t stream) {
  if (gs <= crdt::kThreads && (gs & (gs - 1)) == 0) {
    const long long padded = num_g * gs;
    group_digests_pow2<VEC><<<blocks_for(padded, 4 * kQuadsPerBlock),
                              crdt::kThreads, 0, stream>>>(
        s, out, num_g, static_cast<int>(gs), aligned(out, 16));
  } else {
    group_digests_strided<VEC>
        <<<blocks_for(num_g, kWarps), crdt::kThreads, 0, stream>>>(
            s, out, num_g, gs);
  }
}

}  // namespace

// Group digests of E lanes at group size gs >= 1 into out[ceil(E / gs)];
// gs = 1 gives the lane fingerprints themselves; lane e hashes as id
// lane_base + e.  bool arrays one byte a lane, uint32 arrays any 32-bit
// storage.  Returns the cudaError_t of the launch.
extern "C" int crdt_group_digests(const void* present, const void* deleted,
                                  const void* del_dot_actor,
                                  const void* del_dot_counter, void* out,
                                  long long num_e, long long gs,
                                  long long lane_base, void* stream) {
  if (num_e <= 0) return 0;
  if (gs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Lanes s{static_cast<const uint8_t*>(present),
                static_cast<const uint8_t*>(deleted),
                static_cast<const uint32_t*>(del_dot_actor),
                static_cast<const uint32_t*>(del_dot_counter), num_e,
                lane_base};
  const long long num_g = (num_e + gs - 1) / gs;
  auto* o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (aligned(present, 4) && aligned(deleted, 4) &&
      aligned(del_dot_actor, 16) && aligned(del_dot_counter, 16)) {
    launch<true>(s, o, num_g, gs, st);
  } else {
    launch<false>(s, o, num_g, gs, st);
  }
  return static_cast<int>(cudaGetLastError());
}
