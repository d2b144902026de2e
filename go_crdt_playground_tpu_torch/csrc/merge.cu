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
// shared memory so HasDot is an indexed shared-memory load.  Bit layouts
// read a warp's 32 lanes from one word and write them back with one
// ballot.  Any R works.
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

template <int L>
__global__ void merge_rows(
    const uint32_t* __restrict__ dvv, Lanes d, const uint32_t* __restrict__ svv,
    Lanes s, const long long* __restrict__ perm, long long offset,
    int partner_mode, uint32_t* __restrict__ ovv, OutLanes o,
    long long num_r, long long num_e, int num_a) {
  extern __shared__ uint32_t smem[];
  uint32_t* dvv_s = smem;
  uint32_t* svv_s = smem + num_a;
  const long long e_end = crdt::lane_end<L>(num_e);
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

template <int L>
int launch(const void* dvv, Lanes d, const void* svv, Lanes s,
           const void* perm, long long offset, int partner_mode, void* ovv,
           OutLanes o, long long num_r, long long num_e, int num_a,
           void* stream) {
  const size_t smem = 2 * static_cast<size_t>(num_a) * sizeof(uint32_t);
  merge_rows<L><<<crdt::grid_for(num_r), crdt::kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dvv), d, static_cast<const uint32_t*>(svv),
      s, static_cast<const long long*>(perm), offset, partner_mode,
      static_cast<uint32_t*>(ovv), o, num_r, num_e, num_a);
  return static_cast<int>(cudaGetLastError());
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
      return launch<crdt::LAYOUT_BOOL>(dvv, d, svv, s, perm, offset,
                                       partner_mode, ovv, o, num_r, num_e,
                                       num_a, stream);
    case crdt::LAYOUT_BITS:
      return launch<crdt::LAYOUT_BITS>(dvv, d, svv, s, perm, offset,
                                       partner_mode, ovv, o, num_r, num_e,
                                       num_a, stream);
    case crdt::LAYOUT_DOTWORD:
      return launch<crdt::LAYOUT_DOTWORD>(dvv, d, svv, s, perm, offset,
                                          partner_mode, ovv, o, num_r, num_e,
                                          num_a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
