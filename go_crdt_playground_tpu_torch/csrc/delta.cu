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
// Every kernel here runs the three δ modes of _delta_algebra:
//   v2              record-absorbing semantics: first-contact FULL branch
//                   or δ branch per row, (counter, actor)-lexicographic
//                   deletion-record absorb, processed join;
//   reference       strict reference semantics: deletion log, deletion
//                   dots and processed untouched, and the vv join skipped
//                   when the row's δ is empty (and not first contact);
//   reference_loose reference arbitration with an unconditional vv join.
// The per-lane decision (delta_lane) and the per-slot vv/processed
// epilogue (vv_slot) exist once, below, and both kernels call them.
//
// Bound: memory streaming.  At least one read and one write of the state,
// per row at E = A = 256: 2 x 6,656 B (bool), 2 x 6,208 B (bits), 2 x
// 4,160 B (dot words), plus the actor column; at R = 1,048,576 and
// 3.35 TB/s that is 4.168, 3.887 and 2.605 ms.
//
// delta_rows (K4, K5, K8): one block per row, its threads striding over E
// in one coalesced pass; the dst and partner vv rows sit in shared memory
// so every HasDot is an indexed shared-memory load (past 48 KB the launch
// opts in to more; past the card's limit, A > 29,056 on an H100, a second
// instantiation reads them from device memory).  Bit layouts read a
// warp's 32 lanes from one word and write them back with one ballot; the
// strict empty-δ test is __syncthreads_or over the block.  It reads the
// dst row and the partner row separately (3 x the state per round), and
// each block's three dependent phases (vv rows, lanes, epilogue) leave no
// load in flight between them.
//
// delta_ring_walk (K9): the ring's cycles, walked.  Under r -> (r + o) mod
// R the rows form g = gcd(o, R) cycles of n = R / g rows; position j of
// cycle k is row (k + j o) mod R.  A warp takes a segment of up to L
// consecutive positions c_0 .. c_{len-1} and writes out[c_i] = round(c_i,
// c_{i+1}): the row read as c_{i+1}'s partner is the next step's dst, so
// each row is read once, plus the one row past the segment's end (a
// segment that is its whole cycle reuses c_0 instead).  Reads fall from
// 2 x to (1 + 1/L) x the state at every offset, the large ones that L2
// does not catch included.  The warp keeps a ring of three row buffers in
// shared memory, filled by cp.async: while it computes c_i against
// c_{i+1}, c_{i+2} is arriving.  A thread takes four lanes at a time (a
// 16-byte quad of dot words and one of deletion dot words), builds the
// membership words in registers (warp shuffles) and writes them whole;
// the strict empty-δ test is __any_sync; no block barrier runs.  Rows
// whose three buffers would not fit keep only vv, processed and the actor
// in the ring and read their lanes from device memory ("wide" rows);
// rows or pointers not on 16-byte boundaries copy, load and store word by
// word.  Any R and E; A up to the dot word's 4,096 actors, where a wide
// row's slot (vv, processed, the actor) is 32.8 KB and a warp's three
// slots 98 KB: one warp a block, opted in past 48 KB.
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

// ---------------------------------------------------------------------------
// The algebra, once
// ---------------------------------------------------------------------------

// One lane of the dst row (d*) and of the partner row (s*): membership,
// dot and deletion dot.
struct LaneIn {
  bool dp, sp, dd, sd;
  uint32_t da, dc, sa, sc, dxa, dxc, sxa, sxc;
};

// The lane's outputs: membership, the stored dot (0, 0 when absent), the
// deletion dot, and whether the partner's δ carries the lane (the strict
// empty-δ test).
struct LaneOut {
  bool present, deleted, payload;
  uint32_t a, c, xa, xc;
};

// _delta_algebra for one lane.  dvv, svv: the dst and partner vv rows
// (every HasDot an indexed load); fc: first contact.  x by value: taken by
// reference, delta_rows issued some of its lane loads after the first
// HasDot and ran 4% slower on the bitpacked layout.
__device__ __forceinline__ LaneOut delta_lane(const LaneIn x,
                                              const uint32_t* dvv,
                                              const uint32_t* svv, int num_a,
                                              bool fc, int mode) {
  const bool seen_s_by_d = x.sc <= crdt::clock_at(dvv, x.sa, num_a);
  const bool seen_d_by_s = x.dc <= crdt::clock_at(svv, x.da, num_a);
  // FULL branch (first contact)
  const bool take_f = x.sp && (x.dp || !seen_s_by_d);
  const bool present_f = take_f || (x.dp && !x.sp && !seen_d_by_s);
  // δ branch, phase 1
  const bool changed = x.sp && !seen_s_by_d;
  const bool resurrected = x.sp && ((x.sa != x.sxa) || (x.sc > x.sxc));
  const bool deleted_p = x.sd && !resurrected;
  const bool present1 = x.dp || changed;
  const uint32_t a1 = changed ? x.sa : x.da, c1 = changed ? x.sc : x.dc;

  bool p_out = present_f;
  uint32_t a_out = take_f ? x.sa : x.da, c_out = take_f ? x.sc : x.dc;
  bool d_out = x.dd;
  uint32_t xa_out = x.dxa, xc_out = x.dxc;
  if (mode == MODE_V2) {
    const bool rec_newer =
        (x.sxc > x.dxc) || (x.sxc == x.dxc && x.sxa > x.dxa);
    if (fc) {
      const bool rec = x.sd && (!x.dd || rec_newer);
      d_out = x.dd || x.sd;
      xa_out = rec ? x.sxa : x.dxa;
      xc_out = rec ? x.sxc : x.dxc;
    } else {
      // remove iff the SENDER's clock covers the post-phase-1 dot
      const bool remove = deleted_p && present1 &&
                          c1 <= crdt::clock_at(svv, a1, num_a);
      p_out = present1 && !remove;
      a_out = a1;
      c_out = c1;
      const bool rec = deleted_p && (!x.dd || rec_newer);
      d_out = x.dd || deleted_p;
      xa_out = rec ? x.sxa : x.dxa;
      xc_out = rec ? x.sxc : x.dxc;
    }
  } else if (!fc) {
    // keep iff OUR clock covers the deletion dot
    const bool remove = deleted_p && present1 &&
                        !(x.sxc <= crdt::clock_at(dvv, x.sxa, num_a));
    p_out = present1 && !remove;
    a_out = a1;
    c_out = c1;
  }
  LaneOut o;
  o.present = p_out;
  o.deleted = d_out;
  o.payload = changed || deleted_p;
  o.a = p_out ? a_out : 0u;
  o.c = p_out ? c_out : 0u;
  o.xa = xa_out;
  o.xc = xc_out;
  return o;
}

// _strict_vv_epilogue for one actor slot: x, y the dst and partner clocks,
// dproc, sproc their processed entries (sproc read only in v2).
__device__ __forceinline__ void vv_slot(uint32_t x, uint32_t y,
                                        uint32_t dproc, uint32_t sproc,
                                        bool sender_slot, bool join, int mode,
                                        uint32_t& ovv, uint32_t& oproc) {
  ovv = (join && x < y) ? y : x;
  uint32_t pr = dproc;
  if (mode == MODE_V2) {
    pr = pr < sproc ? sproc : pr;
    // the sender's own slot advances to its clock
    if (sender_slot && pr < y) pr = y;
  }
  oproc = pr;
}

// ---------------------------------------------------------------------------
// delta_rows: a block per row (K4, K5, K8; the dot-word layout stays
// reachable through crdt_delta_round for comparison with K9)
// ---------------------------------------------------------------------------

// kSmem: the vv rows staged in shared memory, else read from device
// memory (an actor axis past the shared-memory limit, crdt::vv_rows_in_smem).
template <int L, bool kSmem>
__global__ void delta_rows(
    const uint32_t* __restrict__ vv, const uint32_t* __restrict__ proc,
    Lanes in, const uint32_t* __restrict__ actor,
    const long long* __restrict__ perm, long long offset, int partner_mode,
    int mode, uint32_t* __restrict__ ovv, uint32_t* __restrict__ oproc,
    OutLanes out, long long num_r, long long num_e, int num_a) {
  extern __shared__ uint32_t smem[];
  const long long e_end = crdt::lane_end<L>(num_e);
  for (long long r = blockIdx.x; r < num_r; r += gridDim.x) {
    const long long p =
        crdt::partner_row(r, partner_mode, offset, perm, num_r);
    const uint32_t* dvv_s = kSmem ? smem : vv + r * num_a;
    const uint32_t* svv_s = kSmem ? smem + num_a : vv + p * num_a;
    if (kSmem) {
      for (int a = threadIdx.x; a < num_a; a += blockDim.x) {
        smem[a] = vv[r * num_a + a];
        smem[num_a + a] = vv[p * num_a + a];
      }
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
        LaneIn x;
        x.dp = crdt::load_member<L>(in.present, r, e, num_e);
        x.sp = crdt::load_member<L>(in.present, p, e, num_e);
        x.dd = crdt::load_member<L>(in.deleted, r, e, num_e);
        x.sd = crdt::load_member<L>(in.deleted, p, e, num_e);
        crdt::load_dot<L>(in.dot_actor, in.dot_counter, i, x.da, x.dc);
        crdt::load_dot<L>(in.dot_actor, in.dot_counter, j, x.sa, x.sc);
        crdt::load_dot<L>(in.del_dot_actor, in.del_dot_counter, i, x.dxa,
                          x.dxc);
        crdt::load_dot<L>(in.del_dot_actor, in.del_dot_counter, j, x.sxa,
                          x.sxc);
        const LaneOut o = delta_lane(x, dvv_s, svv_s, num_a, fc, mode);
        p_out = o.present;
        d_out = o.deleted;
        nonempty |= o.payload;
        crdt::store_dot<L>(out.dot_actor, out.dot_counter, i, o.a, o.c);
        crdt::store_dot<L>(out.del_dot_actor, out.del_dot_counter, i, o.xa,
                           o.xc);
      }
      crdt::store_member<L>(out.present, r, e, valid, p_out, num_e);
      crdt::store_member<L>(out.deleted, r, e, valid, d_out, num_e);
    }
    // the barrier also orders the lane loop before the vv epilogue
    const int any_payload = __syncthreads_or(nonempty);
    const bool join = mode != MODE_REFERENCE || fc || any_payload;
    for (int a = threadIdx.x; a < num_a; a += blockDim.x) {
      const uint32_t sproc = mode == MODE_V2 ? proc[p * num_a + a] : 0u;
      vv_slot(dvv_s[a], svv_s[a], proc[r * num_a + a], sproc,
              static_cast<uint32_t>(a) == s_actor, join, mode,
              ovv[r * num_a + a], oproc[r * num_a + a]);
    }
    __syncthreads();  // the next row overwrites the staged vv rows
  }
}

template <int L, bool kSmem>
int launch_rows(const void* vv, const void* processed, const Lanes& in,
                const void* actor, const void* perm, long long offset,
                int partner_mode, int mode, void* ovv, void* oprocessed,
                const OutLanes& out, long long num_r, long long num_e,
                int num_a, size_t smem, void* stream) {
  delta_rows<L, kSmem><<<crdt::grid_for(num_r), crdt::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vv),
      static_cast<const uint32_t*>(processed), in,
      static_cast<const uint32_t*>(actor),
      static_cast<const long long*>(perm), offset, partner_mode, mode,
      static_cast<uint32_t*>(ovv), static_cast<uint32_t*>(oprocessed), out,
      num_r, num_e, num_a);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch(const void* vv, const void* processed, const Lanes& in,
           const void* actor, const void* perm, long long offset,
           int partner_mode, int mode, void* ovv, void* oprocessed,
           const OutLanes& out, long long num_r, long long num_e, int num_a,
           void* stream) {
  const size_t smem = 2 * static_cast<size_t>(num_a) * sizeof(uint32_t);
  const int staged = crdt::vv_rows_in_smem(delta_rows<L, true>, smem);
  if (staged < 0) return -staged;
  if (staged) {
    return launch_rows<L, true>(vv, processed, in, actor, perm, offset,
                                partner_mode, mode, ovv, oprocessed, out,
                                num_r, num_e, num_a, smem, stream);
  }
  return launch_rows<L, false>(vv, processed, in, actor, perm, offset,
                               partner_mode, mode, ovv, oprocessed, out,
                               num_r, num_e, num_a, 0, stream);
}

// ---------------------------------------------------------------------------
// delta_ring_walk: warps walk segments of the ring's cycles (K9)
// ---------------------------------------------------------------------------

constexpr int kSlots = 3;       // row buffers per warp
constexpr int kMaxWarps = 16;   // warps per block
// Shared memory a block aims at: two blocks fit an SM's 227 KB.
constexpr long long kBlockSmem = 100 * 1024;

// The dot-word state's arrays, and the round's outputs.
struct DotRows {
  const uint32_t* vv;
  const uint32_t* proc;
  const uint32_t* pbits;
  const uint32_t* dots;
  const uint32_t* dbits;
  const uint32_t* xdots;
  const uint32_t* actor;
};

struct DotOut {
  uint32_t* vv;
  uint32_t* proc;
  uint32_t* pbits;
  uint32_t* dots;
  uint32_t* dbits;
  uint32_t* xdots;
};

// The walk: o = offset mod R, n = cycle length, per_cycle = segments a
// cycle (ceil(n / L)), seg_len = L.  Segment q is position t L .. of cycle
// q / per_cycle, t = q % per_cycle.
struct Walk {
  long long offset, cycle_len, per_cycle, num_segments;
  int seg_len;
};

__host__ __device__ __forceinline__ long long round4(long long n) {
  return (n + 3) & ~3LL;
}

// One row buffer's arrays in shared memory, each on a 16-byte boundary:
// vv, processed and the actor, then (staged rows only) the membership
// words and the two dot-word rows.
struct Slot {
  uint32_t* vv;
  uint32_t* proc;
  uint32_t* actor;
  uint32_t* pbits;
  uint32_t* dbits;
  uint32_t* dots;
  uint32_t* xdots;
};

__host__ __device__ __forceinline__ long long slot_words(long long num_e,
                                                         int num_a,
                                                         bool staged) {
  const long long head = 2 * round4(num_a) + 4;
  return staged ? head + 2 * round4(crdt::words_for(num_e)) +
                      2 * round4(num_e)
                : head;
}

__device__ __forceinline__ Slot slot_at(uint32_t* base, long long num_e,
                                        int num_a) {
  Slot s;
  const long long a4 = round4(num_a), w4 = round4(crdt::words_for(num_e));
  s.vv = base;
  s.proc = s.vv + a4;
  s.actor = s.proc + a4;
  s.pbits = s.actor + 4;
  s.dbits = s.pbits + w4;
  s.dots = s.dbits + w4;
  s.xdots = s.dots + round4(num_e);
  return s;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async4(uint32_t* s, const uint32_t* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* s, const uint32_t* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n words into a 16-byte-aligned shared buffer, the warp's lanes
// striding: 16-byte copies where the source row is aligned, words for the
// rest.
__device__ __forceinline__ void copy_words(uint32_t* s, const uint32_t* g,
                                           long long n, int lane) {
  long long done = 0;
  if (aligned16(g)) {
    const long long nq = n >> 2;
    for (long long q = lane; q < nq; q += 32) cp_async16(s + 4 * q, g + 4 * q);
    done = nq << 2;
  }
  for (long long i = done + lane; i < n; i += 32) cp_async4(s + i, g + i);
}

// Start the copy of row r into a slot (wide rows: vv, processed, actor).
__device__ __forceinline__ void fetch_row(const Slot& s, const DotRows& in,
                                          long long r, long long num_e,
                                          int num_a, bool staged, int lane) {
  const long long num_w = crdt::words_for(num_e);
  copy_words(s.vv, in.vv + r * num_a, num_a, lane);
  copy_words(s.proc, in.proc + r * num_a, num_a, lane);
  if (lane == 0) cp_async4(s.actor, in.actor + r);
  if (staged) {
    copy_words(s.pbits, in.pbits + r * num_w, num_w, lane);
    copy_words(s.dbits, in.dbits + r * num_w, num_w, lane);
    copy_words(s.dots, in.dots + r * num_e, num_e, lane);
    copy_words(s.xdots, in.xdots + r * num_e, num_e, lane);
  }
}

// Four consecutive words from lane e0 of a row; words past num_e read 0.
// vec: the row and num_e allow one 16-byte load.
__device__ __forceinline__ uint4 load_quad(const uint32_t* row, long long e0,
                                           long long num_e, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(row + e0);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (e0 < num_e) v.x = row[e0];
  if (e0 + 1 < num_e) v.y = row[e0 + 1];
  if (e0 + 2 < num_e) v.z = row[e0 + 2];
  if (e0 + 3 < num_e) v.w = row[e0 + 3];
  return v;
}

__device__ __forceinline__ void store_quad(uint32_t* row, long long e0,
                                           long long num_e, bool vec,
                                           const uint4& v) {
  if (vec) {
    *reinterpret_cast<uint4*>(row + e0) = v;
    return;
  }
  if (e0 < num_e) row[e0] = v.x;
  if (e0 + 1 < num_e) row[e0 + 1] = v.y;
  if (e0 + 2 < num_e) row[e0 + 2] = v.z;
  if (e0 + 3 < num_e) row[e0 + 3] = v.w;
}

__device__ __forceinline__ uint32_t quad_at(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One step of a walk: row r (slot d) absorbs the δ of row p (slot s).  The
// lanes come from the slots (STAGED) or from device memory.
template <bool STAGED>
__device__ __forceinline__ void ring_step(const Slot& d, const Slot& s,
                                          const DotRows& in,
                                          const DotOut& out, long long r,
                                          long long p, long long num_e,
                                          int num_a, int mode, int lane) {
  const long long num_w = crdt::words_for(num_e);
  const uint32_t s_actor = s.actor[0];
  const bool fc = crdt::clock_at(d.vv, s_actor, num_a) == 0u;
  const uint32_t *dp_w, *sp_w, *dd_w, *sd_w, *d_dots, *s_dots, *d_x, *s_x;
  bool vec_in;
  if constexpr (STAGED) {
    dp_w = d.pbits, sp_w = s.pbits, dd_w = d.dbits, sd_w = s.dbits;
    d_dots = d.dots, s_dots = s.dots, d_x = d.xdots, s_x = s.xdots;
    vec_in = true;  // slot rows are 16-byte aligned and padded to quads
  } else {
    dp_w = in.pbits + r * num_w, sp_w = in.pbits + p * num_w;
    dd_w = in.dbits + r * num_w, sd_w = in.dbits + p * num_w;
    d_dots = in.dots + r * num_e, s_dots = in.dots + p * num_e;
    d_x = in.xdots + r * num_e, s_x = in.xdots + p * num_e;
    vec_in = (num_e & 3) == 0 && aligned16(d_dots) && aligned16(s_dots) &&
             aligned16(d_x) && aligned16(s_x);
  }
  uint32_t* o_dots = out.dots + r * num_e;
  uint32_t* o_x = out.xdots + r * num_e;
  const bool vec_out =
      (num_e & 3) == 0 && aligned16(o_dots) && aligned16(o_x);
  const long long num_q = (num_e + 3) >> 2;
  bool nonempty = false;
  // every lane of the warp runs every pass: the membership words are
  // gathered with shuffles
  for (long long base = 0; base < num_q; base += 32) {
    const long long q = base + lane;
    const bool live = q < num_q;
    const long long e0 = q << 2;
    const long long w = q >> 3;
    const int sh = static_cast<int>(e0 & 31);
    uint4 dq = make_uint4(0u, 0u, 0u, 0u), sq = dq, dxq = dq, sxq = dq;
    uint32_t dpw = 0, spw = 0, ddw = 0, sdw = 0;
    if (live) {
      dq = load_quad(d_dots, e0, num_e, vec_in);
      sq = load_quad(s_dots, e0, num_e, vec_in);
      dxq = load_quad(d_x, e0, num_e, vec_in);
      sxq = load_quad(s_x, e0, num_e, vec_in);
      dpw = dp_w[w] >> sh, spw = sp_w[w] >> sh;
      ddw = dd_w[w] >> sh, sdw = sd_w[w] >> sh;
    }
    uint32_t pn = 0, dn = 0, od[4], ox[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      LaneIn x;
      x.dp = (dpw >> v) & 1u;
      x.sp = (spw >> v) & 1u;
      x.dd = (ddw >> v) & 1u;
      x.sd = (sdw >> v) & 1u;
      const uint32_t dw = quad_at(dq, v), sw = quad_at(sq, v);
      const uint32_t dxw = quad_at(dxq, v), sxw = quad_at(sxq, v);
      x.da = dw >> crdt::kDotShift, x.dc = dw & crdt::kDotCMask;
      x.sa = sw >> crdt::kDotShift, x.sc = sw & crdt::kDotCMask;
      x.dxa = dxw >> crdt::kDotShift, x.dxc = dxw & crdt::kDotCMask;
      x.sxa = sxw >> crdt::kDotShift, x.sxc = sxw & crdt::kDotCMask;
      const LaneOut o = delta_lane(x, d.vv, s.vv, num_a, fc, mode);
      // lanes past E (a ragged last quad, or no quad) add nothing
      const bool valid = e0 + v < num_e;
      pn |= static_cast<uint32_t>(valid && o.present) << v;
      dn |= static_cast<uint32_t>(valid && o.deleted) << v;
      nonempty |= valid && o.payload;
      od[v] = (o.a << crdt::kDotShift) | o.c;
      ox[v] = (o.xa << crdt::kDotShift) | o.xc;
    }
    if (live) {
      store_quad(o_dots, e0, num_e, vec_out,
                 make_uint4(od[0], od[1], od[2], od[3]));
      store_quad(o_x, e0, num_e, vec_out,
                 make_uint4(ox[0], ox[1], ox[2], ox[3]));
    }
    // eight quads make a word: gather their nibbles, the first writes it
    uint32_t pw = pn << sh, dw = dn << sh;
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) {
      pw |= __shfl_xor_sync(0xffffffffu, pw, m);
      dw |= __shfl_xor_sync(0xffffffffu, dw, m);
    }
    if (live && (lane & 7) == 0) {
      out.pbits[r * num_w + w] = pw;
      out.dbits[r * num_w + w] = dw;
    }
  }
  const bool any_payload = __any_sync(0xffffffffu, nonempty);
  const bool join = mode != MODE_REFERENCE || fc || any_payload;
  uint32_t* o_vv = out.vv + r * num_a;
  uint32_t* o_pr = out.proc + r * num_a;
  if ((num_a & 3) == 0 && aligned16(o_vv) && aligned16(o_pr)) {
    for (int a4 = lane; a4 < (num_a >> 2); a4 += 32) {
      const int a0 = a4 << 2;
      const uint4 x = *reinterpret_cast<const uint4*>(d.vv + a0);
      const uint4 y = *reinterpret_cast<const uint4*>(s.vv + a0);
      const uint4 dpr = *reinterpret_cast<const uint4*>(d.proc + a0);
      const uint4 spr = *reinterpret_cast<const uint4*>(s.proc + a0);
      uint32_t ov[4], op[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        vv_slot(quad_at(x, v), quad_at(y, v), quad_at(dpr, v),
                quad_at(spr, v), static_cast<uint32_t>(a0 + v) == s_actor,
                join, mode, ov[v], op[v]);
      }
      *reinterpret_cast<uint4*>(o_vv + a0) =
          make_uint4(ov[0], ov[1], ov[2], ov[3]);
      *reinterpret_cast<uint4*>(o_pr + a0) =
          make_uint4(op[0], op[1], op[2], op[3]);
    }
  } else {
    for (int a = lane; a < num_a; a += 32) {
      vv_slot(d.vv[a], s.vv[a], d.proc[a], s.proc[a],
              static_cast<uint32_t>(a) == s_actor, join, mode, o_vv[a],
              o_pr[a]);
    }
  }
}

// Segment q's rows: c_m = (start + m o) mod R.  Rows c_0 .. c_last are
// fetched in order, row m into slot m % 3, so after step i the slot of
// c_i takes c_{i+3}; the partner of the last step is c_len, or c_0 when
// the segment is its whole cycle.  A whole cycle of four or more rows
// keeps c_0 in slot 0 and turns rows 1.. over the other two slots.
template <bool STAGED>
__global__ void __launch_bounds__(kMaxWarps * 32)
    delta_ring_walk(DotRows in, DotOut out, Walk walk, int mode,
                    long long num_r, long long num_e, int num_a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long words = slot_words(num_e, num_a, STAGED);
  uint32_t* mine = smem + static_cast<long long>(warp) * kSlots * words;
  const long long o = walk.offset, n = walk.cycle_len;
  const bool whole = walk.per_cycle == 1;
  const bool pinned = whole && n >= 4;
  for (long long seg = static_cast<long long>(blockIdx.x) * warps + warp;
       seg < walk.num_segments;
       seg += static_cast<long long>(gridDim.x) * warps) {
    const long long k = seg / walk.per_cycle;
    const long long j0 = (seg % walk.per_cycle) * walk.seg_len;
    const int len = static_cast<int>(
        n - j0 < walk.seg_len ? n - j0 : walk.seg_len);
    const long long start = (k + (j0 * o) % num_r) % num_r;
    const int last = whole ? len - 1 : len;  // the last row fetched
    auto row = [&](int m) { return (start + m * o) % num_r; };
    auto slot = [&](int m) {
      const int b = pinned ? (m == 0 ? 0 : 1 + (m - 1) % 2) : m % kSlots;
      return slot_at(mine + b * words, num_e, num_a);
    };
    for (int m = 0; m < kSlots; ++m) {
      if (m <= last) fetch_row(slot(m), in, row(m), num_e, num_a, STAGED,
                               lane);
      cp_async_commit();
    }
    for (int i = 0; i < len; ++i) {
      // one group a row, committed in row order: all but the newest
      // (c_{i+2}) have landed; a pinned walk fetches one row ahead only
      if (pinned) {
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();
      }
      __syncwarp();
      const int pm = i + 1 > last ? 0 : i + 1;
      ring_step<STAGED>(slot(i), slot(pm), in, out, row(i), row(pm), num_e,
                        num_a, mode, lane);
      __syncwarp();  // every lane is done with slot(i) before it refills
      const int next = pinned ? (i >= 1 ? i + 2 : last + 1) : i + kSlots;
      if (next <= last) fetch_row(slot(i), in, row(next), num_e, num_a,
                                  STAGED, lane);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

template <bool STAGED>
int launch_walk(const DotRows& in, const DotOut& out, const Walk& walk,
                int mode, long long num_r, long long num_e, int num_a,
                long long warp_bytes, void* stream) {
  long long warps = kBlockSmem / warp_bytes;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const long long smem = warps * warp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        delta_ring_walk<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  long long blocks = (walk.num_segments + warps - 1) / warps;
  const long long cap = (1LL << 31) - 1;
  blocks = blocks < cap ? blocks : cap;
  delta_ring_walk<STAGED><<<static_cast<unsigned>(blocks),
                            static_cast<unsigned>(warps * 32),
                            static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      in, out, walk, mode, num_r, num_e, num_a);
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

// K9: the dot-word ring round on delta_ring_walk.  offset is already in
// [0, R); cycle_len, per_cycle and num_segments are the walk's geometry
// (ops/cuda_delta.ring_segments), seg_len its L.
extern "C" int crdt_delta_ring_dotword(
    const void* vv, const void* processed, const void* present_bits,
    const void* dots, const void* deleted_bits, const void* del_dots,
    const void* actor, void* ovv, void* oprocessed, void* opresent_bits,
    void* odots, void* odeleted_bits, void* odel_dots, long long offset,
    long long cycle_len, long long per_cycle, long long num_segments,
    int seg_len, int mode, long long num_r, long long num_e, int num_a,
    void* stream) {
  if (num_r <= 0 || num_segments <= 0) return 0;
  if (seg_len < 1 || per_cycle < 1 || cycle_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const DotRows in{static_cast<const uint32_t*>(vv),
                   static_cast<const uint32_t*>(processed),
                   static_cast<const uint32_t*>(present_bits),
                   static_cast<const uint32_t*>(dots),
                   static_cast<const uint32_t*>(deleted_bits),
                   static_cast<const uint32_t*>(del_dots),
                   static_cast<const uint32_t*>(actor)};
  const DotOut out{static_cast<uint32_t*>(ovv),
                   static_cast<uint32_t*>(oprocessed),
                   static_cast<uint32_t*>(opresent_bits),
                   static_cast<uint32_t*>(odots),
                   static_cast<uint32_t*>(odeleted_bits),
                   static_cast<uint32_t*>(odel_dots)};
  const Walk walk{offset, cycle_len, per_cycle, num_segments, seg_len};
  const long long staged_bytes =
      kSlots * slot_words(num_e, num_a, true) * sizeof(uint32_t);
  if (staged_bytes <= kBlockSmem) {
    return launch_walk<true>(in, out, walk, mode, num_r, num_e, num_a,
                             staged_bytes, stream);
  }
  return launch_walk<false>(
      in, out, walk, mode, num_r, num_e, num_a,
      kSlots * slot_words(num_e, num_a, false) * sizeof(uint32_t), stream);
}
