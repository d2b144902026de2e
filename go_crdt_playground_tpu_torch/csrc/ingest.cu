// Fused ingest+δ for one replica slice, the whole entry in one launch:
// the rows' counter bases, the fold of B client op-rows over the state
// lanes, the batch's δ against the pre-batch vv, the clocks and the
// fixed-K compaction of the δ.
//
// Replaces the Pallas kernel of go_crdt_playground_tpu/ops/pallas_ingest.py:
//   K10 _fused_ingest (_ingest_kernel): the serve tier's write path, which
//   the TPU ran, prefix sums and compaction included, as one program.
// Semantics (ops/cuda_ingest.py's plain version, all counters uint32 and
// wrapping mod 2^32): row b, with the live mask folded in, ticks once per
// added key plus once if its Del selects any key; its add dots count up
// from base[b] = c0 + the steps of rows 0..b-1 in ascending element order
// (lane e gets base[b] + the adds of row b in lanes 0..e), its deletion
// dot is (actor, base[b] + steps[b]).  Per lane, row by row:
//   add:  present = 1, dot = (actor, its add counter);
//   del:  if present: clear it and its dot, log the deletion dot.
// c0 reads the own clock with the actor id clipped to [0, A); the own
// slot of vv (and of processed when B > 0) is set to the final counter,
// and nothing is set for an id outside [0, A).  The δ is taken against
// the pre-batch vv.  With both Ks > 0 the δ's lanes are packed, stable
// and in ascending element order, into the first K slots of each section;
// a section with more lanes sets overflow, which zeroes src_vv and
// src_processed of the compact form (ops/compact.py).
//
// Bound: memory.  Each lane reads its 18 state bytes and 2 bytes a row
// and writes 36 bytes (the merged lanes and the δ lanes): at E = 1,024
// and B = 32 about 121 KB, 0.04 us at 3.35 TB/s, so a launch at the serve
// tier's shapes is latency-bound, and what it saves is the host's work
// and the launches the entry took around the old kernel.
// Design: all outputs are views of one buffer the wrapper allocates
// (ingest_layout below); its head holds the compact form and a copy of
// the pre-batch vv, so the WAL record reaches the host in one copy.  A
// thread owns a quad of 4 lanes (one 32-bit row load, 16-byte lane
// loads and stores where aligned).  Every HasDot of the δ reads the
// pre-batch vv staged in shared memory (A x 4 B; past 48 KB the launch
// opts in to more); past the card's limit (A > 57,920 on an H100, beside
// the 768 B of block-scan buffers) a second instantiation of each kernel
// reads it from device memory, so any A runs in the one launch.
//   E <= 4,096 (the serve shapes): one block, warps owning 128-lane
//   chunks, one pass over the rows (eight rows' loads at a time).  Per
//   row, each warp counts its chunk's adds; each thread folds its lanes'
//   presence with bit operations and keeps, per lane, the row of the
//   last add and of the last effective delete, which is all the final
//   lane needs: its dot counter is that add row's base plus the row's
//   adds up to the lane, its deletion counter that delete row's base
//   plus its steps.  Then a warp per row scans the chunk counts, a block
//   scan gives the rows' bases, and each lane computes its counters.
//   Folding counters row by row instead (a block scan a row, or a warp
//   scan of every row) measured 2.3-2.4 us a four-row step on the H100:
//   one SM walks B rows of dependent work.  The compaction is one block
//   scan.
//   E > 4,096: one cooperative launch, the grid sized by the occupancy of
//   the instantiation launched at its shared memory, so it is resident,
//   warps owning 128-lane chunks, with grid-wide syncs between the
//   phases: per-chunk add counts of every row, their scan along each
//   row, the fold (a warp scan per row), the scan of the per-chunk δ
//   counts, the compaction.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlockLanes = 4096;
constexpr int kChunk = 128;  // lanes of one warp
constexpr int kRows = 8;     // rows whose loads the one-block path batches
constexpr int kGridThreads = crdt::kThreads;
constexpr unsigned kFull = 0xffffffffu;

// The static shared memory of both kernels: block_scan's warp totals and
// ORs, two buffers each.
struct ScanSmem {
  unsigned long long tot[2][32];
  uint32_t ors[2][32];
};

// Regions of the output buffer, in order.  The head (up to VV) goes to
// the host for a WAL record; the rest stays on the device.
// Each part is grouped by type (words, then bools), so the wrapper cuts
// its views with one split per group; ops/cuda_ingest.py names the
// regions in this order.
enum Region {
  PRE_VV, SRC_VV, SRC_PROC, SRC_ACTOR, CH_IDX, CH_DA, CH_DC, DEL_IDX,
  DEL_DA, DEL_DC,                        // head words
  CH_VALID, DEL_VALID, OVERFLOW,         // head bools
  VV, PROC, DA, DC, XA, XC, CHDA, CHDC, DLDA, DLDC,  // words
  PRESENT, DELETED, CHANGED, DMASK,      // bools
  ROWCNT, ROWPRE, RSTEPS, RBASE, CCNT,   // scratch
  END, N_REGIONS
};

// Byte offsets of every region (16-byte aligned) for E lanes, A actors, B
// rows and K slots a section; the chunk counts of the δ (CCNT) exist on
// the cooperative path only.
void ingest_layout(long long e, long long a, long long b, long long kc,
                   long long kd, long long* off) {
  const bool grid = e > kMaxBlockLanes;
  const long long nch = e > 0 ? (e + kChunk - 1) / kChunk : 1;
  const long long bytes[N_REGIONS - 1] = {
      4 * a, 4 * a, 4 * a, 4, 4 * kc, 4 * kc, 4 * kc, 4 * kd, 4 * kd,
      4 * kd,
      kc, kd, 1,
      4 * a, 4 * a, 4 * e, 4 * e, 4 * e, 4 * e, 4 * e, 4 * e, 4 * e, 4 * e,
      e, e, e, e,
      4 * b * nch, grid ? 0 : 4 * b * nch, 4 * b, grid ? 0 : 8 * b,
      grid ? 8 * nch + 8 : 0};
  long long pos = 0;
  for (int r = 0; r < N_REGIONS - 1; ++r) {
    off[r] = pos;
    pos += (bytes[r] + 15) / 16 * 16;
  }
  off[END] = pos;
}

struct Params {
  const uint32_t* vv;
  const uint32_t* processed;
  const uint32_t* actor;
  const uint8_t* present;
  const uint32_t* da;
  const uint32_t* dc;
  const uint8_t* deleted;
  const uint32_t* xa;
  const uint32_t* xc;
  const uint8_t* add_rows;
  const uint8_t* del_rows;
  const uint8_t* live;
  uint8_t* out;
  long long off[N_REGIONS];
  long long num_b, num_e;
  int num_a, kc, kd;
  bool vec_lanes;  // state lane pointers aligned for quad loads
  bool vec_rows;   // E % 4 == 0 and the row pointers 4-byte aligned
};

template <typename T>
__device__ __forceinline__ T* at(const Params& p, int region) {
  return reinterpret_cast<T*>(p.out + p.off[region]);
}

// One quad of lanes: bools as bytes 0/1 of a word (lane j at bit 8 j).
struct Quad {
  uint32_t p, d;
  uint32_t da[4], dc[4], xa[4], xc[4];
};

__device__ __forceinline__ uint32_t bool_word(uint32_t w) {
  return __vcmpne4(w, 0u) & 0x01010101u;
}

__device__ __forceinline__ bool bit(uint32_t w, int j) {
  return (w >> (8 * j)) & 1u;
}

__device__ __forceinline__ uint32_t load_bools(const uint8_t* a,
                                               long long e0, long long n,
                                               bool vec) {
  if (vec && e0 + 3 < n) {
    return bool_word(*reinterpret_cast<const uint32_t*>(a + e0));
  }
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e0 + j < n && a[e0 + j]) w |= 1u << (8 * j);
  }
  return w;
}

__device__ __forceinline__ void load_words(const uint32_t* a, long long e0,
                                           long long n, bool vec,
                                           uint32_t v[4]) {
  if (vec && e0 + 3 < n) {
    const uint4 q = *reinterpret_cast<const uint4*>(a + e0);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = e0 + j < n ? a[e0 + j] : 0u;
}

// Output regions are 16-byte aligned, so a whole quad stores as one word
// or one 16-byte store.
__device__ __forceinline__ void store_bools(uint8_t* a, long long e0,
                                            long long n, uint32_t w) {
  if (e0 + 3 < n) {
    *reinterpret_cast<uint32_t*>(a + e0) = w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e0 + j < n) a[e0 + j] = bit(w, j);
  }
}

__device__ __forceinline__ void store_words(uint32_t* a, long long e0,
                                            long long n,
                                            const uint32_t v[4]) {
  if (e0 + 3 < n) {
    *reinterpret_cast<uint4*>(a + e0) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e0 + j < n) a[e0 + j] = v[j];
  }
}

__device__ __forceinline__ Quad load_quad(const Params& p, long long e0) {
  Quad q;
  const long long n = p.num_e;
  q.p = load_bools(p.present, e0, n, p.vec_lanes);
  q.d = load_bools(p.deleted, e0, n, p.vec_lanes);
  load_words(p.da, e0, n, p.vec_lanes, q.da);
  load_words(p.dc, e0, n, p.vec_lanes, q.dc);
  load_words(p.xa, e0, n, p.vec_lanes, q.xa);
  load_words(p.xc, e0, n, p.vec_lanes, q.xc);
  return q;
}

// A quad's bools (bytes 0/1) as a 4-bit mask, lane j at bit j: the
// multiply moves byte j's bit to bit 24 + j without carries.
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  return (w * 0x01020408u) >> 24 & 0xfu;
}

// A quad of a row's bools through the read-only path (the rows are never
// written by the kernel), so loads of many rows go out together even
// where the loop stores.
__device__ __forceinline__ uint32_t row_bools(const uint8_t* a, long long e0,
                                              long long n, bool vec) {
  if (vec && e0 + 3 < n) {
    return bool_word(__ldg(reinterpret_cast<const unsigned int*>(a + e0)));
  }
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e0 + j < n && __ldg(a + e0 + j)) w |= 1u << (8 * j);
  }
  return w;
}

// Row b's add and del selectors of the quad at e0 as 4-bit masks, the live
// mask folded in.  The three loads do not wait on each other.
__device__ __forceinline__ void load_row(const Params& p, long long b,
                                         long long e0, uint32_t& a4,
                                         uint32_t& d4) {
  const long long o = b * p.num_e;
  const uint32_t live = __ldg(p.live + b) ? 0xfu : 0u;
  a4 = nibble(row_bools(p.add_rows + o, e0, p.num_e, p.vec_rows)) & live;
  d4 = nibble(row_bools(p.del_rows + o, e0, p.num_e, p.vec_rows)) & live;
}

// The raw word of a row's bools for the quad at e0 (bytes 0/1: torch's
// bool storage), zero for lanes past n: with VEC one 32-bit load (E % 4
// == 0, aligned rows), else four byte loads.  Predicated, not branched,
// so the loads of many rows are all in flight before the first is used.
template <bool VEC>
__device__ __forceinline__ uint32_t row_word(const uint8_t* a, long long e0,
                                             long long n) {
  if (VEC) {
    return e0 < n ? __ldg(reinterpret_cast<const unsigned int*>(a + e0))
                  : 0u;
  }
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t x = e0 + j < n ? __ldg(a + e0 + j) : 0u;
    w |= static_cast<uint32_t>(x != 0u) << (8 * j);
  }
  return w;
}

// One row folded into the quad: `pos` counts the row's add dots up to
// the lane, `del_ctr` is the row's deletion dot counter.
__device__ __forceinline__ void fold_row(Quad& q, uint32_t a4, uint32_t d4,
                                         uint32_t pos, uint32_t del_ctr,
                                         uint32_t actor) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if ((a4 >> j) & 1u) {
      ++pos;
      q.p |= 1u << (8 * j);
      q.da[j] = actor;
      q.dc[j] = pos;
    }
    if (((d4 >> j) & 1u) && bit(q.p, j)) {
      q.p &= ~(1u << (8 * j));
      q.da[j] = 0u;
      q.dc[j] = 0u;
      q.d |= 1u << (8 * j);
      q.xa[j] = actor;
      q.xc[j] = del_ctr;
    }
  }
}

// The δ of the quad against the pre-batch vv (ops/delta.delta_extract);
// stores the merged lanes and the δ lanes.  Returns the changed and the
// deletion-mask bits.
__device__ __forceinline__ void finish_quad(const Params& p, const Quad& q,
                                            long long e0,
                                            const uint32_t* vv_s,
                                            uint32_t& chw, uint32_t& dmw) {
  uint32_t cda[4], cdc[4], xda[4], xdc[4];
  chw = dmw = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool pr = bit(q.p, j);
    const bool ch =
        pr && !(q.dc[j] <= crdt::clock_at(vv_s, q.da[j], p.num_a));
    const bool res = pr && (q.da[j] != q.xa[j] || q.dc[j] > q.xc[j]);
    const bool dm = bit(q.d, j) && !res;
    chw |= static_cast<uint32_t>(ch) << (8 * j);
    dmw |= static_cast<uint32_t>(dm) << (8 * j);
    cda[j] = ch ? q.da[j] : 0u;
    cdc[j] = ch ? q.dc[j] : 0u;
    xda[j] = dm ? q.xa[j] : 0u;
    xdc[j] = dm ? q.xc[j] : 0u;
  }
  if (e0 >= p.num_e) return;
  const long long n = p.num_e;
  store_bools(at<uint8_t>(p, PRESENT), e0, n, q.p);
  store_words(at<uint32_t>(p, DA), e0, n, q.da);
  store_words(at<uint32_t>(p, DC), e0, n, q.dc);
  store_bools(at<uint8_t>(p, DELETED), e0, n, q.d);
  store_words(at<uint32_t>(p, XA), e0, n, q.xa);
  store_words(at<uint32_t>(p, XC), e0, n, q.xc);
  store_bools(at<uint8_t>(p, CHANGED), e0, n, chw);
  store_words(at<uint32_t>(p, CHDA), e0, n, cda);
  store_words(at<uint32_t>(p, CHDC), e0, n, cdc);
  store_bools(at<uint8_t>(p, DMASK), e0, n, dmw);
  store_words(at<uint32_t>(p, DLDA), e0, n, xda);
  store_words(at<uint32_t>(p, DLDC), e0, n, xdc);
}

// Write the set lanes of a quad into their compaction slots, starting at
// slot `slot`; lanes past k are dropped.
__device__ __forceinline__ void place(uint32_t w, long long e0,
                                      uint32_t slot, int k,
                                      const uint32_t* va, const uint32_t* vc,
                                      int32_t* idx, uint8_t* valid,
                                      uint32_t* oa, uint32_t* oc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!bit(w, j)) continue;
    if (slot < static_cast<uint32_t>(k)) {
      idx[slot] = static_cast<int32_t>(e0 + j);
      valid[slot] = 1;
      oa[slot] = va[j];
      oc[slot] = vc[j];
    }
    ++slot;
  }
}

// Slots from `used` to k hold nothing (zero index, invalid, zero dot).
__device__ __forceinline__ void clear_slots(uint32_t used, int k,
                                            int32_t* idx, uint8_t* valid,
                                            uint32_t* oa, uint32_t* oc,
                                            long long first, long long step) {
  for (long long s = first; s < k; s += step) {
    if (s < used) continue;
    idx[s] = 0;
    valid[s] = 0;
    oa[s] = 0u;
    oc[s] = 0u;
  }
}

// The clocks: the pre-batch vv copied to the head, vv and processed with
// the own slot at `final`, the compact form's src_vv and src_processed
// (zero on overflow) and its actor.
__device__ __forceinline__ void write_clocks(const Params& p, uint32_t actor,
                                             uint32_t final_ctr,
                                             bool overflow, long long first,
                                             long long step) {
  for (long long a = first; a < p.num_a; a += step) {
    const uint32_t v = p.vv[a];
    const uint32_t pr = p.processed[a];
    const bool own = static_cast<uint32_t>(a) == actor;
    const uint32_t nv = own ? final_ctr : v;
    const uint32_t np = own && p.num_b > 0 ? final_ctr : pr;
    at<uint32_t>(p, PRE_VV)[a] = v;
    at<uint32_t>(p, VV)[a] = nv;
    at<uint32_t>(p, PROC)[a] = np;
    if (p.kc > 0 && p.kd > 0) {
      at<uint32_t>(p, SRC_VV)[a] = overflow ? 0u : nv;
      at<uint32_t>(p, SRC_PROC)[a] = overflow ? 0u : np;
    }
  }
  if (first == 0) {
    *at<uint32_t>(p, SRC_ACTOR) = actor;
    if (p.kc > 0 && p.kd > 0) *at<uint8_t>(p, OVERFLOW) = overflow;
  }
}

template <typename T>
__device__ __forceinline__ T warp_scan(T v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const T n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

// Block-wide scan: per-field sums of v (no field may overflow) and the OR
// of `flags`.  Returns this thread's exclusive prefix; `total` and `any`
// come back the same in every thread.  One __syncthreads: the warp totals
// go through one of two shared buffers, alternated by `parity`, and every
// warp scans them itself.
__device__ __forceinline__ unsigned long long block_scan(
    unsigned long long v, uint32_t flags, int& parity,
    unsigned long long (*s_tot)[32], uint32_t (*s_or)[32],
    unsigned long long& total, uint32_t& any) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned long long incl = warp_scan(v, lane);
  const uint32_t wor = __reduce_or_sync(kFull, flags);
  if (lane == 31) s_tot[parity][warp] = incl;
  if (lane == 0) s_or[parity][warp] = wor;
  __syncthreads();
  const unsigned long long w = lane < nwarps ? s_tot[parity][lane] : 0ull;
  const uint32_t wo = lane < nwarps ? s_or[parity][lane] : 0u;
  parity ^= 1;
  const unsigned long long wincl = warp_scan(w, lane);
  const unsigned long long before =
      __shfl_sync(kFull, wincl, warp > 0 ? warp - 1 : 0);
  total = __shfl_sync(kFull, wincl, nwarps - 1);
  any = __reduce_or_sync(kFull, wo);
  return (warp > 0 ? before : 0ull) + incl - v;
}

__device__ __forceinline__ uint32_t count(uint32_t w) { return __popc(w); }

// Block-wide exclusive scan of n uint64 values in place (per-field sums),
// each thread summing a contiguous run; returns the total.
__device__ unsigned long long scan_in_place(unsigned long long* x,
                                            long long n, int& parity,
                                            unsigned long long (*s_tot)[32],
                                            uint32_t (*s_or)[32]) {
  const long long per = (n + blockDim.x - 1) / blockDim.x;
  const long long lo = min(n, per * threadIdx.x), hi = min(n, lo + per);
  unsigned long long sum = 0ull;
  for (long long i = lo; i < hi; ++i) sum += x[i];
  unsigned long long total;
  uint32_t unused;
  unsigned long long run = block_scan(sum, 0u, parity, s_tot, s_or, total,
                                      unused);
  for (long long i = lo; i < hi; ++i) {
    const unsigned long long v = x[i];
    x[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// E <= 4,096: the whole entry in one block of ceil(E / 4) threads
// (rounded up to whole warps); warp w owns the 128-lane chunk w.
// VEC_ROWS: E % 4 == 0 and the rows 4-byte aligned.  kSmem: the pre-batch
// vv staged in shared memory (A x 4 B), else read from device memory (an
// actor axis past the card's shared-memory limit, crdt::vv_rows_in_smem).
template <bool VEC_ROWS, bool kSmem>
__global__ void __launch_bounds__(1024) ingest_block(Params p) {
  extern __shared__ uint32_t smem[];
  __shared__ ScanSmem scan;
  unsigned long long(*s_tot)[32] = scan.tot;
  uint32_t(*s_or)[32] = scan.ors;
  const uint32_t* vv_s = kSmem ? smem : p.vv;
  if (kSmem) {
    for (int a = threadIdx.x; a < p.num_a; a += blockDim.x) smem[a] = p.vv[a];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long e0 = 4LL * threadIdx.x;
  const uint32_t actor = *p.actor;
  // rowcnt[b * nwarps + w]: row b's adds in chunk w (bit 31: a Del
  // there); rowpre: the adds of row b before chunk w; rsteps[b]: row
  // b's steps; rbase[b]: the steps of the rows before b
  uint32_t* rowcnt = at<uint32_t>(p, ROWCNT);
  uint32_t* rsteps = at<uint32_t>(p, RSTEPS);
  auto* rbase = reinterpret_cast<unsigned long long*>(p.out + p.off[RBASE]);
  int parity = 0;

  // 1. one pass over the rows, kRows rows' loads at a time.  Per four
  // rows one warp scan of their add counts (8-bit fields: a warp holds
  // at most 128 lanes) gives each lane its add's place in the chunk and
  // the chunk's totals; each thread folds its lanes' presence with bit
  // operations and keeps, per lane, the row of the last add (with its
  // place) and of the last effective delete
  uint32_t pres = nibble(load_bools(p.present, e0, p.num_e, p.vec_lanes));
  uint32_t cut = 0u;  // lanes a Del of the batch cleared at least once
  int last_add[4] = {-1, -1, -1, -1}, last_del[4] = {-1, -1, -1, -1};
  uint32_t add_pos[4] = {0u, 0u, 0u, 0u};
  for (long long b0 = 0; b0 < p.num_b; b0 += kRows) {
    uint32_t a4[kRows], d4[kRows], lv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool in = b0 + r < p.num_b;
      const long long o = (in ? b0 + r : 0) * p.num_e;
      a4[r] = in ? row_word<VEC_ROWS>(p.add_rows + o, e0, p.num_e) : 0u;
      d4[r] = in ? row_word<VEC_ROWS>(p.del_rows + o, e0, p.num_e) : 0u;
      lv[r] = in ? __ldg(p.live + b0 + r) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t live = lv[r] ? 0xfu : 0u;
      a4[r] = nibble(a4[r]) & live;
      d4[r] = nibble(d4[r]) & live;
    }
#pragma unroll
    for (int g = 0; g < kRows; g += 4) {
      uint32_t packed = 0u, dflags = 0u;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        packed |= static_cast<uint32_t>(__popc(a4[g + r])) << (8 * r);
        dflags |= (d4[g + r] != 0u) << r;
      }
      const uint32_t incl = warp_scan(packed, lane);
      const uint32_t excl = incl - packed;
      const uint32_t adds = __shfl_sync(kFull, incl, 31);
      const uint32_t dels = __reduce_or_sync(kFull, dflags);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int b = static_cast<int>(b0) + g + r;
        if (b >= p.num_b) break;
        if (lane == 0) {
          rowcnt[b * nwarps + warp] =
              ((adds >> (8 * r)) & 0xffu) | ((dels >> r) & 1u) << 31;
        }
        const uint32_t a = a4[g + r], d = d4[g + r];
        const uint32_t held = pres | a;
        const uint32_t hit = d & held;
        pres = held & ~d;
        cut |= hit;
        if (a | hit) {  // rare in a sparse batch: skip the lane loop
          const uint32_t before = (excl >> (8 * r)) & 0xffu;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((a >> j) & 1u) {
              last_add[j] = b;
              add_pos[j] = before + __popc(a & ((2u << j) - 1u));
            }
            if ((hit >> j) & 1u) last_del[j] = b;
          }
        }
      }
    }
  }
  __syncthreads();

  // 2. a thread per row: the scan along its chunks (into rowpre) and its
  // steps; then the rows' bases, a scan over the rows
  uint32_t* rowpre = at<uint32_t>(p, ROWPRE);
  for (long long b = threadIdx.x; b < p.num_b; b += blockDim.x) {
    uint32_t v[32];
#pragma unroll
    for (int w = 0; w < 32; ++w) {
      v[w] = w < nwarps ? rowcnt[b * nwarps + w] : 0u;
    }
    uint32_t run = 0u, dany = 0u;
#pragma unroll
    for (int w = 0; w < 32; ++w) {
      if (w < nwarps) rowpre[b * nwarps + w] = run;
      run += v[w] & 0x7fffffffu;
      dany |= v[w] >> 31;
    }
    rsteps[b] = run + dany;
    rbase[b] = run + dany;
  }
  __syncthreads();
  const uint32_t c0 = crdt::clock_at(p.vv, actor, p.num_a);
  const uint32_t final_ctr =
      c0 + static_cast<uint32_t>(
               scan_in_place(rbase, p.num_b, parity, s_tot, s_or));

  // 3. each lane from its last add and last delete: the add counter is
  // the row's base, the row's adds in the chunks before, and the add's
  // place in its chunk
  Quad q = load_quad(p, e0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (((pres >> j) & 1u) && last_add[j] >= 0) {
      const long long b = last_add[j];
      q.da[j] = actor;
      q.dc[j] = c0 + static_cast<uint32_t>(rbase[b]) +
                rowpre[b * nwarps + warp] + add_pos[j];
    } else if ((cut >> j) & 1u) {
      q.da[j] = 0u;
      q.dc[j] = 0u;
    }
    if ((cut >> j) & 1u) {
      const long long b = last_del[j];
      q.xa[j] = actor;
      q.xc[j] = c0 + static_cast<uint32_t>(rbase[b]) + rsteps[b];
    }
  }
  q.d |= (cut & 1u) | (cut & 2u) << 7 | (cut & 4u) << 14 | (cut & 8u) << 21;
  q.p = (pres & 1u) | (pres & 2u) << 7 | (pres & 4u) << 14 | (pres & 8u) << 21;
  uint32_t chw, dmw;
  finish_quad(p, q, e0, vv_s, chw, dmw);
  bool overflow = false;
  if (p.kc > 0 && p.kd > 0) {
    const unsigned long long v =
        count(chw) | static_cast<unsigned long long>(count(dmw)) << 32;
    unsigned long long total;
    uint32_t unused;
    const unsigned long long excl =
        block_scan(v, 0u, parity, s_tot, s_or, total, unused);
    const uint32_t n_ch = static_cast<uint32_t>(total);
    const uint32_t n_dl = static_cast<uint32_t>(total >> 32);
    overflow = n_ch > static_cast<uint32_t>(p.kc) ||
               n_dl > static_cast<uint32_t>(p.kd);
    place(chw, e0, static_cast<uint32_t>(excl), p.kc, q.da, q.dc,
          at<int32_t>(p, CH_IDX), at<uint8_t>(p, CH_VALID),
          at<uint32_t>(p, CH_DA), at<uint32_t>(p, CH_DC));
    place(dmw, e0, static_cast<uint32_t>(excl >> 32), p.kd, q.xa, q.xc,
          at<int32_t>(p, DEL_IDX), at<uint8_t>(p, DEL_VALID),
          at<uint32_t>(p, DEL_DA), at<uint32_t>(p, DEL_DC));
    clear_slots(n_ch, p.kc, at<int32_t>(p, CH_IDX), at<uint8_t>(p, CH_VALID),
                at<uint32_t>(p, CH_DA), at<uint32_t>(p, CH_DC), threadIdx.x,
                blockDim.x);
    clear_slots(n_dl, p.kd, at<int32_t>(p, DEL_IDX),
                at<uint8_t>(p, DEL_VALID), at<uint32_t>(p, DEL_DA),
                at<uint32_t>(p, DEL_DC), threadIdx.x, blockDim.x);
  }
  write_clocks(p, actor, final_ctr, overflow, threadIdx.x, blockDim.x);
}

// E > 4,096: one cooperative launch; warps own 128-lane chunks.  kSmem:
// as ingest_block's.
template <bool kSmem>
__global__ void __launch_bounds__(kGridThreads) ingest_grid(Params p) {
  extern __shared__ uint32_t smem[];
  __shared__ ScanSmem scan;
  unsigned long long(*s_tot)[32] = scan.tot;
  uint32_t(*s_or)[32] = scan.ors;
  cg::grid_group grid = cg::this_grid();
  const uint32_t* vv_s = kSmem ? smem : p.vv;
  if (kSmem) {
    for (int a = threadIdx.x; a < p.num_a; a += blockDim.x) smem[a] = p.vv[a];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warps_per_block = blockDim.x >> 5;
  const long long gw = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const long long nw = gridDim.x * warps_per_block;
  const long long nch = (p.num_e + kChunk - 1) / kChunk;
  const uint32_t actor = *p.actor;
  // rowcnt[b * nch + c]: row b's adds in chunk c (bit 31: a Del there);
  // scanned in place to the adds of row b before chunk c
  uint32_t* rowcnt = at<uint32_t>(p, ROWCNT);
  uint32_t* rsteps = at<uint32_t>(p, RSTEPS);
  // per chunk: changed count | deletion-mask count << 32, scanned in place
  auto* ccnt = reinterpret_cast<unsigned long long*>(p.out + p.off[CCNT]);
  int parity = 0;

  // 1. the adds (and whether a Del selects a key) of every row and chunk
  for (long long i = gw; i < p.num_b * nch; i += nw) {
    const long long b = i / nch, c = i % nch;
    uint32_t a4, d4;
    load_row(p, b, c * kChunk + 4 * lane, a4, d4);
    const uint32_t adds = __reduce_add_sync(kFull, __popc(a4));
    const uint32_t dels = __reduce_or_sync(kFull, d4);
    if (lane == 0) rowcnt[i] = adds | (dels != 0u ? 1u << 31 : 0u);
  }
  grid.sync();

  // 2. each row: the scan along its chunks and its steps
  for (long long b = blockIdx.x; b < p.num_b; b += gridDim.x) {
    uint32_t* row = rowcnt + b * nch;
    const long long per = (nch + blockDim.x - 1) / blockDim.x;
    const long long lo = min(nch, per * threadIdx.x);
    const long long hi = min(nch, lo + per);
    unsigned long long sum = 0ull;
    uint32_t dflag = 0u;
    for (long long c = lo; c < hi; ++c) {
      sum += row[c] & 0x7fffffffu;
      dflag |= row[c] >> 31;
    }
    unsigned long long total;
    uint32_t dany;
    unsigned long long run =
        block_scan(sum, dflag, parity, s_tot, s_or, total, dany);
    for (long long c = lo; c < hi; ++c) {
      const uint32_t v = row[c] & 0x7fffffffu;
      row[c] = static_cast<uint32_t>(run);
      run += v;
    }
    if (threadIdx.x == 0) {
      rsteps[b] = static_cast<uint32_t>(total) + (dany & 1u);
    }
    __syncthreads();
  }
  grid.sync();

  // 3. the fold, a warp scan per row and chunk; then the δ
  const uint32_t c0 = crdt::clock_at(p.vv, actor, p.num_a);
  for (long long c = gw; c < nch; c += nw) {
    const long long e0 = c * kChunk + 4 * lane;
    Quad q = load_quad(p, e0);
    uint32_t base = c0;
    for (long long b = 0; b < p.num_b; ++b) {
      uint32_t a4, d4;
      load_row(p, b, e0, a4, d4);
      const uint32_t n = __popc(a4);
      const uint32_t before = warp_scan(n, lane) - n + rowcnt[b * nch + c];
      const uint32_t steps = rsteps[b];
      fold_row(q, a4, d4, base + before, base + steps, actor);
      base += steps;
    }
    uint32_t chw, dmw;
    finish_quad(p, q, e0, vv_s, chw, dmw);
    if (p.kc > 0 && p.kd > 0) {
      const uint32_t nc = __reduce_add_sync(kFull, count(chw));
      const uint32_t nd = __reduce_add_sync(kFull, count(dmw));
      if (lane == 0) ccnt[c] = nc | static_cast<unsigned long long>(nd) << 32;
    }
  }
  uint32_t final_ctr = c0;
  for (long long b = 0; b < p.num_b; ++b) final_ctr += rsteps[b];
  if (p.kc == 0 || p.kd == 0) {
    if (blockIdx.x == 0) {
      write_clocks(p, actor, final_ctr, false, threadIdx.x, blockDim.x);
    }
    return;
  }
  grid.sync();

  // 4. the scan of the chunks' δ counts (one block)
  if (blockIdx.x == 0) {
    const unsigned long long total =
        scan_in_place(ccnt, nch, parity, s_tot, s_or);
    if (threadIdx.x == 0) ccnt[nch] = total;
  }
  grid.sync();

  // 5. the compaction: chunks whose first slot lies below K
  const unsigned long long total = ccnt[nch];
  const uint32_t n_ch = static_cast<uint32_t>(total);
  const uint32_t n_dl = static_cast<uint32_t>(total >> 32);
  for (long long c = gw; c < nch; c += nw) {
    const unsigned long long start = ccnt[c];
    const uint32_t sc = static_cast<uint32_t>(start);
    const uint32_t sd = static_cast<uint32_t>(start >> 32);
    if (sc >= static_cast<uint32_t>(p.kc) &&
        sd >= static_cast<uint32_t>(p.kd)) {
      continue;
    }
    const long long e0 = c * kChunk + 4 * lane;
    const uint32_t chw = load_bools(at<uint8_t>(p, CHANGED), e0, p.num_e,
                                    true);
    const uint32_t dmw = load_bools(at<uint8_t>(p, DMASK), e0, p.num_e,
                                    true);
    uint32_t va[4], vc[4], xa[4], xc[4];
    load_words(at<uint32_t>(p, CHDA), e0, p.num_e, true, va);
    load_words(at<uint32_t>(p, CHDC), e0, p.num_e, true, vc);
    load_words(at<uint32_t>(p, DLDA), e0, p.num_e, true, xa);
    load_words(at<uint32_t>(p, DLDC), e0, p.num_e, true, xc);
    const uint32_t nc = count(chw), nd = count(dmw);
    const uint32_t bc = sc + warp_scan(nc, lane) - nc;
    const uint32_t bd = sd + warp_scan(nd, lane) - nd;
    place(chw, e0, bc, p.kc, va, vc, at<int32_t>(p, CH_IDX),
          at<uint8_t>(p, CH_VALID), at<uint32_t>(p, CH_DA),
          at<uint32_t>(p, CH_DC));
    place(dmw, e0, bd, p.kd, xa, xc, at<int32_t>(p, DEL_IDX),
          at<uint8_t>(p, DEL_VALID), at<uint32_t>(p, DEL_DA),
          at<uint32_t>(p, DEL_DC));
  }
  if (blockIdx.x == 0) {
    const bool overflow = n_ch > static_cast<uint32_t>(p.kc) ||
                          n_dl > static_cast<uint32_t>(p.kd);
    clear_slots(n_ch, p.kc, at<int32_t>(p, CH_IDX), at<uint8_t>(p, CH_VALID),
                at<uint32_t>(p, CH_DA), at<uint32_t>(p, CH_DC), threadIdx.x,
                blockDim.x);
    clear_slots(n_dl, p.kd, at<int32_t>(p, DEL_IDX),
                at<uint8_t>(p, DEL_VALID), at<uint32_t>(p, DEL_DA),
                at<uint32_t>(p, DEL_DC), threadIdx.x, blockDim.x);
    write_clocks(p, actor, final_ctr, overflow, threadIdx.x, blockDim.x);
  }
}

inline bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// Blocks of one ingest_grid instantiation the card holds at once
// (occupancy x SMs) with `smem` bytes of dynamic shared memory, per device;
// the last answer per device and instantiation is kept.
int grid_blocks(const void* kernel, int variant, size_t smem, int* err) {
  struct Cached {
    size_t smem;
    int blocks;
  };
  static Cached cached[64][2];
  int dev = 0;
  *err = static_cast<int>(cudaGetDevice(&dev));
  if (*err) return 0;
  if (dev < 64 && cached[dev][variant].blocks &&
      cached[dev][variant].smem == smem) {
    return cached[dev][variant].blocks;
  }
  int sms = 0, per_sm = 0;
  *err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!*err) {
    *err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kGridThreads, smem));
  }
  if (*err) return 0;
  const int blocks = sms * per_sm;
  if (dev < 64) cached[dev][variant] = Cached{smem, blocks};
  return blocks;
}

// The one-block path: the vv staged where it fits (the launch opts in
// past 48 KB), else read from device memory.
template <bool VEC_ROWS>
int launch_block(const Params& p, unsigned threads, size_t smem,
                 cudaStream_t s) {
  const int staged = crdt::vv_rows_in_smem(ingest_block<VEC_ROWS, true>,
                                           smem, sizeof(ScanSmem));
  if (staged < 0) return -staged;
  if (staged) {
    ingest_block<VEC_ROWS, true><<<1, threads, smem, s>>>(p);
  } else {
    ingest_block<VEC_ROWS, false><<<1, threads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cooperative path: the grid sized by the occupancy of the
// instantiation it launches, at the shared memory it launches with.
int launch_grid(Params& p, size_t smem, cudaStream_t s) {
  const int staged =
      crdt::vv_rows_in_smem(ingest_grid<true>, smem, sizeof(ScanSmem));
  if (staged < 0) return -staged;
  const void* kernel = staged ? reinterpret_cast<const void*>(ingest_grid<true>)
                              : reinterpret_cast<const void*>(ingest_grid<false>);
  const size_t dyn = staged ? smem : 0;
  int err = 0;
  const int resident = grid_blocks(kernel, staged, dyn, &err);
  if (err) return err;
  const long long nch = (p.num_e + kChunk - 1) / kChunk;
  const long long want = (nch + kGridThreads / 32 - 1) / (kGridThreads / 32);
  const int blocks = static_cast<int>(want < resident ? want : resident);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kGridThreads), args, dyn, s));
}

}  // namespace

// Byte offsets of the output buffer's regions (N_REGIONS of them; the
// last is the buffer's size) for E lanes, A actors, B rows and K slots a
// section.  The wrapper reads it once per shape.
extern "C" int crdt_ingest_regions() { return N_REGIONS; }

extern "C" void crdt_ingest_layout(long long num_e, long long num_a,
                                   long long num_b, long long k_changed,
                                   long long k_deleted, long long* off) {
  ingest_layout(num_e, num_a, num_b, k_changed, k_deleted, off);
}

// One launch for a replica slice of E lanes and A actors and a batch of B
// rows into `out`, a buffer of crdt_ingest_layout's size; bool arrays are
// one byte per lane, uint32 arrays any 32-bit storage; k_changed and
// k_deleted both > 0 ask for the compact form.  Returns the cudaError_t
// of the launch.
extern "C" int crdt_ingest(
    const void* vv, const void* processed, const void* actor,
    const void* present, const void* dot_actor, const void* dot_counter,
    const void* deleted, const void* del_dot_actor,
    const void* del_dot_counter, const void* add_rows, const void* del_rows,
    const void* live, void* out, long long num_b, long long num_e,
    int num_a, int k_changed, int k_deleted, void* stream) {
  Params p;
  p.vv = static_cast<const uint32_t*>(vv);
  p.processed = static_cast<const uint32_t*>(processed);
  p.actor = static_cast<const uint32_t*>(actor);
  p.present = static_cast<const uint8_t*>(present);
  p.da = static_cast<const uint32_t*>(dot_actor);
  p.dc = static_cast<const uint32_t*>(dot_counter);
  p.deleted = static_cast<const uint8_t*>(deleted);
  p.xa = static_cast<const uint32_t*>(del_dot_actor);
  p.xc = static_cast<const uint32_t*>(del_dot_counter);
  p.add_rows = static_cast<const uint8_t*>(add_rows);
  p.del_rows = static_cast<const uint8_t*>(del_rows);
  p.live = static_cast<const uint8_t*>(live);
  p.out = static_cast<uint8_t*>(out);
  ingest_layout(num_e, num_a, num_b, k_changed, k_deleted, p.off);
  p.num_b = num_b;
  p.num_e = num_e;
  p.num_a = num_a;
  p.kc = k_changed;
  p.kd = k_deleted;
  p.vec_lanes = aligned(present, 4) && aligned(deleted, 4) &&
                aligned(dot_actor, 16) && aligned(dot_counter, 16) &&
                aligned(del_dot_actor, 16) && aligned(del_dot_counter, 16);
  p.vec_rows = num_e % 4 == 0 && aligned(add_rows, 4) &&
               aligned(del_rows, 4);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(num_a) * sizeof(uint32_t);
  if (num_e <= kMaxBlockLanes) {
    const long long quads = (num_e + 3) / 4;
    const unsigned threads =
        static_cast<unsigned>(quads < 32 ? 32 : (quads + 31) / 32 * 32);
    return p.vec_rows ? launch_block<true>(p, threads, smem, s)
                      : launch_block<false>(p, threads, smem, s);
  }
  return launch_grid(p, smem, s);
}
