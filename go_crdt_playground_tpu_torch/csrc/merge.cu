// The full-state AWSet merge round: replica r absorbs one partner row.
//
// Replaces the Pallas kernels of go_crdt_playground_tpu/ops/pallas_merge.py:
//   K1 _fused_rows_ring (_make_ring_kernel, _merge_algebra), packed_w=0:
//      partner (r + offset) mod R, read in place;
//   K2 _fused_rows (_rows_kernel): partner perm[r], or row r of an
//      independent src batch (pairwise);
//   K3 _fused_round (_round_kernel): the one-row-per-step form of K2, with
//      perm scalar-prefetched; here the same partner modes of this kernel;
//   K6 _fused_rows_ring, packed_w>0: K1 on bitpacked membership;
//   K7 _fused_rows_ring_dotpacked (_make_ring_kernel_dotpacked): K6 with
//      each dot as one word (actor << 20) | counter.
// One kernel serves them all, templated on the lane layout (common.cuh);
// a partner mode picks the source row.  It computes what _merge_algebra
// computes: two HasDot lookups, the two-phase add-wins merge, canonical
// zeroing of absent lanes, the VV join.
//
// Bound: memory streaming.  At least one read and one write of the state,
// per row at E = A = 256: 2 x 3,328 B (bool), 2 x 3,104 B (bits), 2 x
// 2,080 B (dot words); at R = 1,048,576 and 3.35 TB/s that is 2.083, 1.943
// and 1.302 ms.  This kernel reads the dst row and the partner row
// separately, 3 x the state per round.  The arithmetic is a few dozen
// integer operations per lane, far below the card's rate.
// Design: one block per row, its threads striding over E in one coalesced
// pass; the dst and partner vv rows (2 x A x 4 B, 16 KB at A = 2048) sit in
// shared memory so HasDot is an indexed shared-memory load (past 48 KB the
// launch opts in to more; past the card's limit, A > 29,056 on an H100, a
// second instantiation reads them from device memory).  Bit layouts
// read a warp's 32 lanes from one word and write them back with one
// ballot.  Any R works.
//
// K3 (crdt_merge_rows_k3, bool layout): its rounds are small (the gossip
// verb's 64 x 128 moves 181 KB: 54 ns at 3.35 TB/s), so a launch costs a
// few memory latencies, and the wrapper's host path more.  It runs the
// block-per-row kernel (one lane a thread, the fewest latencies in a
// row) on its own entry, which checks every perm[r] itself: a partner
// outside [0, R) prints the row and fails the launch with a device-side
// assert, which the next synchronizing call raises; no range check runs
// on the host or as extra device operations.  perm may be int32 or int64.
#include <assert.h>
#include <stdio.h>

#include "common.cuh"

namespace {

// One batch's E-shaped lanes: membership (bytes or words), and the dot as
// two arrays (a = actor, c = counter) or as one dot-word array a.
struct Lanes {
  const void* present;
  const uint32_t* a;
  const uint32_t* c;
};

struct OutLanes {
  void* present;
  uint32_t* a;
  uint32_t* c;
};

// The partner row of r: perm[r] (int32 or int64) in gather mode, else
// crdt::partner_row.  With kCheck, a gathered row outside [0, R) sets
// ok = false (the caller skips the row); the row's first thread
// (speaker) prints it and fails the launch with a device-side assert.
// Without it (K1, K2, K6, K7: their perm was checked before the launch)
// no check is compiled in.
template <bool kCheck>
__device__ __forceinline__ long long partner_of(long long r, int mode,
                                                long long offset,
                                                const void* perm, int perm32,
                                                long long num_r, bool speaker,
                                                bool& ok) {
  ok = true;
  if (mode != crdt::PARTNER_GATHER) {
    return crdt::partner_row(r, mode, offset, nullptr, num_r);
  }
  const long long p = perm32 ? static_cast<const int*>(perm)[r]
                             : static_cast<const long long*>(perm)[r];
  if (kCheck && (p < 0 || p >= num_r)) {
    ok = false;
    if (speaker) {
      printf("crdt merge: perm[%lld] = %lld outside [0, %lld)\n", r, p,
             num_r);
      assert(false && "perm entries must lie in [0, R)");
    }
  }
  return p;
}

// kSmem: the vv rows staged in shared memory, else read from device
// memory (an actor axis past the shared-memory limit, crdt::vv_rows_in_smem).
template <int L, bool kCheck, bool kSmem>
__global__ void merge_rows(
    const uint32_t* __restrict__ dvv, Lanes d, const uint32_t* __restrict__ svv,
    Lanes s, const void* __restrict__ perm, int perm32, long long offset,
    int partner_mode, uint32_t* __restrict__ ovv, OutLanes o,
    long long num_r, long long num_e, int num_a) {
  extern __shared__ uint32_t smem[];
  const long long e_end = crdt::lane_end<L>(num_e);
  for (long long r = blockIdx.x; r < num_r; r += gridDim.x) {
    bool ok;
    const long long p = partner_of<kCheck>(r, partner_mode, offset, perm,
                                           perm32, num_r, threadIdx.x == 0,
                                           ok);
    if (!ok) continue;  // uniform over the block: every thread read p
    const uint32_t* dvv_s = kSmem ? smem : dvv + r * num_a;
    const uint32_t* svv_s = kSmem ? smem + num_a : svv + p * num_a;
    for (int a = threadIdx.x; a < num_a; a += blockDim.x) {
      const uint32_t x = dvv[r * num_a + a];
      const uint32_t y = svv[p * num_a + a];
      if (kSmem) {
        smem[a] = x;
        smem[num_a + a] = y;
      }
      ovv[r * num_a + a] = x < y ? y : x;
    }
    __syncthreads();
    const long long d0 = r * num_e, s0 = p * num_e;
    for (long long e = threadIdx.x; e < e_end; e += blockDim.x) {
      const bool valid = e < num_e;
      bool present = false;
      if (valid) {
        const bool dpe = crdt::load_member<L>(d.present, r, e, num_e);
        const bool spe = crdt::load_member<L>(s.present, p, e, num_e);
        uint32_t da, dc, sa, sc;
        crdt::load_dot<L>(d.a, d.c, d0 + e, da, dc);
        crdt::load_dot<L>(s.a, s.c, s0 + e, sa, sc);
        const bool seen_by_dst = sc <= crdt::clock_at(dvv_s, sa, num_a);
        const bool seen_by_src = dc <= crdt::clock_at(svv_s, da, num_a);
        const bool take_src = spe && (dpe || !seen_by_dst);
        present = take_src || (dpe && !spe && !seen_by_src);
        crdt::store_dot<L>(o.a, o.c, d0 + e,
                           present ? (take_src ? sa : da) : 0u,
                           present ? (take_src ? sc : dc) : 0u);
      }
      crdt::store_member<L>(o.present, r, e, valid, present, num_e);
    }
    __syncthreads();  // the next row overwrites the staged vv rows
  }
}

template <int L, bool kCheck, bool kSmem>
int launch_rows(const void* dvv, Lanes d, const void* svv, Lanes s,
                const void* perm, int perm32, long long offset,
                int partner_mode, void* ovv, OutLanes o, long long num_r,
                long long num_e, int num_a, size_t smem, void* stream) {
  merge_rows<L, kCheck, kSmem><<<crdt::grid_for(num_r), crdt::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dvv), d, static_cast<const uint32_t*>(svv),
      s, perm, perm32, offset, partner_mode,
      static_cast<uint32_t*>(ovv), o, num_r, num_e, num_a);
  return static_cast<int>(cudaGetLastError());
}

template <int L, bool kCheck = false>
int launch(const void* dvv, Lanes d, const void* svv, Lanes s,
           const void* perm, int perm32, long long offset, int partner_mode,
           void* ovv, OutLanes o, long long num_r, long long num_e,
           int num_a, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(num_a) * sizeof(uint32_t);
  const int staged = crdt::vv_rows_in_smem(merge_rows<L, kCheck, true>, smem);
  if (staged < 0) return -staged;
  if (staged) {
    return launch_rows<L, kCheck, true>(dvv, d, svv, s, perm, perm32, offset,
                                        partner_mode, ovv, o, num_r, num_e,
                                        num_a, smem, stream);
  }
  return launch_rows<L, kCheck, false>(dvv, d, svv, s, perm, perm32, offset,
                                       partner_mode, ovv, o, num_r, num_e,
                                       num_a, 0, stream);
}

}  // namespace

// layout: crdt::Layout.  With LAYOUT_DOTWORD the dot words go in the
// dot_actor slots (da, sda, oda) and the dot_counter slots are unused.
extern "C" int crdt_merge_round(
    const void* dvv, const void* dp, const void* dda, const void* ddc,
    const void* svv, const void* sp, const void* sda, const void* sdc,
    const void* perm, long long offset, int partner_mode,
    void* ovv, void* op, void* oda, void* odc,
    long long num_r, long long num_e, int num_a, int layout, void* stream) {
  if (num_r <= 0) return 0;
  const Lanes d{dp, static_cast<const uint32_t*>(dda),
                static_cast<const uint32_t*>(ddc)};
  const Lanes s{sp, static_cast<const uint32_t*>(sda),
                static_cast<const uint32_t*>(sdc)};
  const OutLanes o{op, static_cast<uint32_t*>(oda),
                   static_cast<uint32_t*>(odc)};
  switch (layout) {
    case crdt::LAYOUT_BOOL:
      return launch<crdt::LAYOUT_BOOL>(dvv, d, svv, s, perm, 0, offset,
                                       partner_mode, ovv, o, num_r, num_e,
                                       num_a, stream);
    case crdt::LAYOUT_BITS:
      return launch<crdt::LAYOUT_BITS>(dvv, d, svv, s, perm, 0, offset,
                                       partner_mode, ovv, o, num_r, num_e,
                                       num_a, stream);
    case crdt::LAYOUT_DOTWORD:
      return launch<crdt::LAYOUT_DOTWORD>(dvv, d, svv, s, perm, 0, offset,
                                          partner_mode, ovv, o, num_r, num_e,
                                          num_a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3: dst row r absorbs src row perm[r] (perm given, int32 or int64 by
// perm32, each entry checked) or row r of src (perm null), bool layout.
extern "C" int crdt_merge_rows_k3(
    const void* dvv, const void* dp, const void* dda, const void* ddc,
    const void* svv, const void* sp, const void* sda, const void* sdc,
    const void* perm, int perm32, void* ovv, void* op, void* oda, void* odc,
    long long num_r, long long num_e, int num_a, void* stream) {
  if (num_r <= 0) return 0;
  const int mode = perm ? crdt::PARTNER_GATHER : crdt::PARTNER_PAIRWISE;
  const Lanes d{dp, static_cast<const uint32_t*>(dda),
                static_cast<const uint32_t*>(ddc)};
  const Lanes s{sp, static_cast<const uint32_t*>(sda),
                static_cast<const uint32_t*>(sdc)};
  const OutLanes o{op, static_cast<uint32_t*>(oda),
                   static_cast<uint32_t*>(odc)};
  return launch<crdt::LAYOUT_BOOL, true>(dvv, d, svv, s, perm, perm32, 0,
                                         mode, ovv, o, num_r, num_e, num_a,
                                         stream);
}
