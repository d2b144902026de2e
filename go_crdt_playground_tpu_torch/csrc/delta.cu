// The δ-AWSet anti-entropy round: replica r absorbs the δ of one partner.
//
// Replaces the Pallas kernels of go_crdt_playground_tpu/ops/pallas_delta.py:
//   K4 _fused_delta_ring (_make_delta_ring_kernel, _delta_algebra,
//      _strict_vv_epilogue), packed_w=0: partner (r + offset) mod R, read
//      in place;
//   K5 _fused_delta_round (_make_delta_kernel): partner perm[r];
//   K8 _fused_delta_ring, packed_w>0: K4 with present and deleted
//      bitpacked;
//   K9 _fused_delta_ring, dot_packed=True: K8 with both dot pairs as dot
//      words (actor << 20) | counter.
// One kernel serves them all, templated on the lane layout (common.cuh),
// in the three δ modes of _delta_algebra:
//   v2              record-absorbing semantics: first-contact FULL branch
//                   or δ branch per row, (counter, actor)-lexicographic
//                   deletion-record absorb, processed join;
//   reference       strict reference semantics: deletion log, deletion
//                   dots and processed untouched, and the vv join skipped
//                   when the row's δ is empty (and not first contact);
//   reference_loose reference arbitration with an unconditional vv join.
// The strict empty-δ test is a reduction over the whole row; the block
// walks the whole row, so __syncthreads_or finishes it in the block, in
// every layout.
//
// Bound: memory streaming.  At least one read and one write of the state,
// per row at E = A = 256: 2 x 6,656 B (bool), 2 x 6,208 B (bits), 2 x
// 4,160 B (dot words), plus the actor column; at R = 1,048,576 and
// 3.35 TB/s that is 4.168, 3.887 and 2.605 ms.  This kernel reads the dst
// row and the partner row separately, 3 x the state per round.
// Design: one block per row, its threads striding over E in one coalesced
// pass; the dst and partner vv rows sit in shared memory so every HasDot
// is an indexed shared-memory load.  Bit layouts read a warp's 32 lanes
// from one word and write them back with one ballot.  Any R works.
#include "common.cuh"

namespace {

enum Mode { MODE_V2 = 0, MODE_REFERENCE = 1, MODE_REFERENCE_LOOSE = 2 };

// One batch's E-shaped lanes.  Membership is bytes or words; each dot pair
// is two arrays, or one dot-word array in the actor slot.
struct Lanes {
  const void* present;
  const uint32_t* dot_actor;
  const uint32_t* dot_counter;
  const void* deleted;
  const uint32_t* del_dot_actor;
  const uint32_t* del_dot_counter;
};

struct OutLanes {
  void* present;
  uint32_t* dot_actor;
  uint32_t* dot_counter;
  void* deleted;
  uint32_t* del_dot_actor;
  uint32_t* del_dot_counter;
};

template <int L>
__global__ void delta_rows(
    const uint32_t* __restrict__ vv, const uint32_t* __restrict__ proc,
    Lanes in, const uint32_t* __restrict__ actor,
    const long long* __restrict__ perm, long long offset, int partner_mode,
    int mode, uint32_t* __restrict__ ovv, uint32_t* __restrict__ oproc,
    OutLanes out, long long num_r, long long num_e, int num_a) {
  extern __shared__ uint32_t smem[];
  uint32_t* dvv_s = smem;
  uint32_t* svv_s = smem + num_a;
  const long long e_end = crdt::lane_end<L>(num_e);
  for (long long r = blockIdx.x; r < num_r; r += gridDim.x) {
    const long long p =
        crdt::partner_row(r, partner_mode, offset, perm, num_r);
    for (int a = threadIdx.x; a < num_a; a += blockDim.x) {
      dvv_s[a] = vv[r * num_a + a];
      svv_s[a] = vv[p * num_a + a];
    }
    __syncthreads();
    const uint32_t s_actor = actor[p];
    // first contact: the receiver's counter for the sender's actor is 0
    const bool fc = crdt::clock_at(dvv_s, s_actor, num_a) == 0u;
    int nonempty = 0;
    const long long d0 = r * num_e, s0 = p * num_e;
    for (long long e = threadIdx.x; e < e_end; e += blockDim.x) {
      const bool valid = e < num_e;
      bool p_out = false, d_out = false;
      if (valid) {
        const long long i = d0 + e, j = s0 + e;
        const bool dp = crdt::load_member<L>(in.present, r, e, num_e);
        const bool sp = crdt::load_member<L>(in.present, p, e, num_e);
        const bool dd = crdt::load_member<L>(in.deleted, r, e, num_e);
        const bool sd = crdt::load_member<L>(in.deleted, p, e, num_e);
        uint32_t da, dc, sa, sc, dxa, dxc, sxa, sxc;
        crdt::load_dot<L>(in.dot_actor, in.dot_counter, i, da, dc);
        crdt::load_dot<L>(in.dot_actor, in.dot_counter, j, sa, sc);
        crdt::load_dot<L>(in.del_dot_actor, in.del_dot_counter, i, dxa, dxc);
        crdt::load_dot<L>(in.del_dot_actor, in.del_dot_counter, j, sxa, sxc);

        const bool seen_s_by_d = sc <= crdt::clock_at(dvv_s, sa, num_a);
        const bool seen_d_by_s = dc <= crdt::clock_at(svv_s, da, num_a);
        // FULL branch (first contact)
        const bool take_f = sp && (dp || !seen_s_by_d);
        const bool present_f = take_f || (dp && !sp && !seen_d_by_s);
        // δ branch, phase 1
        const bool changed = sp && !seen_s_by_d;
        const bool resurrected = sp && ((sa != sxa) || (sc > sxc));
        const bool deleted_p = sd && !resurrected;
        const bool present1 = dp || changed;
        const uint32_t a1 = changed ? sa : da, c1 = changed ? sc : dc;

        p_out = present_f;
        uint32_t a_out = take_f ? sa : da, c_out = take_f ? sc : dc;
        d_out = dd;
        uint32_t xa_out = dxa, xc_out = dxc;
        if (mode == MODE_V2) {
          const bool rec_newer = (sxc > dxc) || (sxc == dxc && sxa > dxa);
          if (fc) {
            const bool rec = sd && (!dd || rec_newer);
            d_out = dd || sd;
            xa_out = rec ? sxa : dxa;
            xc_out = rec ? sxc : dxc;
          } else {
            // remove iff the SENDER's clock covers the post-phase-1 dot
            const bool remove = deleted_p && present1 &&
                                c1 <= crdt::clock_at(svv_s, a1, num_a);
            p_out = present1 && !remove;
            a_out = a1;
            c_out = c1;
            const bool rec = deleted_p && (!dd || rec_newer);
            d_out = dd || deleted_p;
            xa_out = rec ? sxa : dxa;
            xc_out = rec ? sxc : dxc;
          }
        } else {
          if (!fc) {
            // keep iff OUR clock covers the deletion dot
            const bool remove = deleted_p && present1 &&
                                !(sxc <= crdt::clock_at(dvv_s, sxa, num_a));
            p_out = present1 && !remove;
            a_out = a1;
            c_out = c1;
          }
          nonempty |= (changed || deleted_p);
        }
        crdt::store_dot<L>(out.dot_actor, out.dot_counter, i,
                           p_out ? a_out : 0u, p_out ? c_out : 0u);
        crdt::store_dot<L>(out.del_dot_actor, out.del_dot_counter, i, xa_out,
                           xc_out);
      }
      crdt::store_member<L>(out.present, r, e, valid, p_out, num_e);
      crdt::store_member<L>(out.deleted, r, e, valid, d_out, num_e);
    }
    // the barrier also orders the lane loop before the vv epilogue
    const int any_payload = __syncthreads_or(nonempty);
    const bool join = mode != MODE_REFERENCE || fc || any_payload;
    for (int a = threadIdx.x; a < num_a; a += blockDim.x) {
      const uint32_t x = dvv_s[a], y = svv_s[a];
      ovv[r * num_a + a] = (join && x < y) ? y : x;
      uint32_t pr = proc[r * num_a + a];
      if (mode == MODE_V2) {
        const uint32_t sproc = proc[p * num_a + a];
        pr = pr < sproc ? sproc : pr;
        // the sender's own slot advances to its clock
        if (static_cast<uint32_t>(a) == s_actor && pr < y) pr = y;
      }
      oproc[r * num_a + a] = pr;
    }
    __syncthreads();  // the next row overwrites the staged vv rows
  }
}

template <int L>
int launch(const void* vv, const void* processed, const Lanes& in,
           const void* actor, const void* perm, long long offset,
           int partner_mode, int mode, void* ovv, void* oprocessed,
           const OutLanes& out, long long num_r, long long num_e, int num_a,
           void* stream) {
  const size_t smem = 2 * static_cast<size_t>(num_a) * sizeof(uint32_t);
  delta_rows<L><<<crdt::grid_for(num_r), crdt::kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vv),
      static_cast<const uint32_t*>(processed), in,
      static_cast<const uint32_t*>(actor),
      static_cast<const long long*>(perm), offset, partner_mode, mode,
      static_cast<uint32_t*>(ovv), static_cast<uint32_t*>(oprocessed), out,
      num_r, num_e, num_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// layout: crdt::Layout.  With LAYOUT_DOTWORD the dot words go in the
// dot_actor and del_dot_actor slots and the counter slots are unused.
extern "C" int crdt_delta_round(
    const void* vv, const void* processed, const void* present,
    const void* dot_actor, const void* dot_counter, const void* deleted,
    const void* del_dot_actor, const void* del_dot_counter,
    const void* actor, const void* perm, long long offset, int partner_mode,
    int mode, void* ovv, void* oprocessed, void* opresent,
    void* odot_actor, void* odot_counter, void* odeleted,
    void* odel_dot_actor, void* odel_dot_counter,
    long long num_r, long long num_e, int num_a, int layout, void* stream) {
  if (num_r <= 0) return 0;
  const Lanes in{present,
                 static_cast<const uint32_t*>(dot_actor),
                 static_cast<const uint32_t*>(dot_counter),
                 deleted,
                 static_cast<const uint32_t*>(del_dot_actor),
                 static_cast<const uint32_t*>(del_dot_counter)};
  const OutLanes out{opresent,
                     static_cast<uint32_t*>(odot_actor),
                     static_cast<uint32_t*>(odot_counter),
                     odeleted,
                     static_cast<uint32_t*>(odel_dot_actor),
                     static_cast<uint32_t*>(odel_dot_counter)};
  switch (layout) {
    case crdt::LAYOUT_BOOL:
      return launch<crdt::LAYOUT_BOOL>(vv, processed, in, actor, perm, offset,
                                       partner_mode, mode, ovv, oprocessed,
                                       out, num_r, num_e, num_a, stream);
    case crdt::LAYOUT_BITS:
      return launch<crdt::LAYOUT_BITS>(vv, processed, in, actor, perm, offset,
                                       partner_mode, mode, ovv, oprocessed,
                                       out, num_r, num_e, num_a, stream);
    case crdt::LAYOUT_DOTWORD:
      return launch<crdt::LAYOUT_DOTWORD>(vv, processed, in, actor, perm,
                                          offset, partner_mode, mode, ovv,
                                          oprocessed, out, num_r, num_e,
                                          num_a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
