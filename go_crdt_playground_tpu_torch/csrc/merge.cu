// The full-state AWSet merge round: replica r absorbs one partner row.
//
// Replaces the Pallas kernels of go_crdt_playground_tpu/ops/pallas_merge.py:
//   K1 _fused_rows_ring (_make_ring_kernel, _merge_algebra): partner
//      (r + offset) mod R, read in place;
//   K2 _fused_rows (_rows_kernel): partner perm[r], or row r of an
//      independent src batch (pairwise).
// One kernel serves both: a partner mode picks the source row.  It computes
// what _merge_algebra computes: two HasDot lookups, the two-phase add-wins
// merge, canonical zeroing of absent lanes, the VV max-join.
//
// Bound: memory streaming.  At least one read and one write of the state
// (2 x 3,328 B per row at E = A = 256); this kernel reads the dst row and
// the partner row separately, 3 x 3,328 B x R per round.  The arithmetic
// is a few dozen integer operations per lane, far below the card's rate.
// Design: one block per row, its threads striding over E in one coalesced
// pass; the dst and partner vv rows (2 x A x 4 B, 16 KB at A = 2048) sit in
// shared memory so HasDot is an indexed shared-memory load.  Any R works.
#include "common.cuh"

namespace {

__global__ void merge_rows(
    const uint32_t* __restrict__ dvv, const uint8_t* __restrict__ dp,
    const uint32_t* __restrict__ dda, const uint32_t* __restrict__ ddc,
    const uint32_t* __restrict__ svv, const uint8_t* __restrict__ sp,
    const uint32_t* __restrict__ sda, const uint32_t* __restrict__ sdc,
    const long long* __restrict__ perm, long long offset, int partner_mode,
    uint32_t* __restrict__ ovv, uint8_t* __restrict__ op,
    uint32_t* __restrict__ oda, uint32_t* __restrict__ odc,
    long long num_r, long long num_e, int num_a) {
  extern __shared__ uint32_t smem[];
  uint32_t* dvv_s = smem;
  uint32_t* svv_s = smem + num_a;
  for (long long r = blockIdx.x; r < num_r; r += gridDim.x) {
    const long long p =
        crdt::partner_row(r, partner_mode, offset, perm, num_r);
    for (int a = threadIdx.x; a < num_a; a += blockDim.x) {
      const uint32_t x = dvv[r * num_a + a];
      const uint32_t y = svv[p * num_a + a];
      dvv_s[a] = x;
      svv_s[a] = y;
      ovv[r * num_a + a] = x < y ? y : x;
    }
    __syncthreads();
    const long long d0 = r * num_e, s0 = p * num_e;
    for (long long e = threadIdx.x; e < num_e; e += blockDim.x) {
      const bool dpe = dp[d0 + e] != 0, spe = sp[s0 + e] != 0;
      const uint32_t da = dda[d0 + e], dc = ddc[d0 + e];
      const uint32_t sa = sda[s0 + e], sc = sdc[s0 + e];
      const bool seen_by_dst = sc <= crdt::clock_at(dvv_s, sa, num_a);
      const bool seen_by_src = dc <= crdt::clock_at(svv_s, da, num_a);
      const bool take_src = spe && (dpe || !seen_by_dst);
      const bool present = take_src || (dpe && !spe && !seen_by_src);
      op[d0 + e] = present;
      oda[d0 + e] = present ? (take_src ? sa : da) : 0u;
      odc[d0 + e] = present ? (take_src ? sc : dc) : 0u;
    }
    __syncthreads();  // the next row overwrites the staged vv rows
  }
}

}  // namespace

extern "C" int crdt_merge_round(
    const void* dvv, const void* dp, const void* dda, const void* ddc,
    const void* svv, const void* sp, const void* sda, const void* sdc,
    const void* perm, long long offset, int partner_mode,
    void* ovv, void* op, void* oda, void* odc,
    long long num_r, long long num_e, int num_a, void* stream) {
  if (num_r <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(num_a) * sizeof(uint32_t);
  merge_rows<<<crdt::grid_for(num_r), crdt::kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dvv), static_cast<const uint8_t*>(dp),
      static_cast<const uint32_t*>(dda), static_cast<const uint32_t*>(ddc),
      static_cast<const uint32_t*>(svv), static_cast<const uint8_t*>(sp),
      static_cast<const uint32_t*>(sda), static_cast<const uint32_t*>(sdc),
      static_cast<const long long*>(perm), offset, partner_mode,
      static_cast<uint32_t*>(ovv), static_cast<uint8_t*>(op),
      static_cast<uint32_t*>(oda), static_cast<uint32_t*>(odc),
      num_r, num_e, num_a);
  return static_cast<int>(cudaGetLastError());
}
