// Fused ingest+δ for one replica slice: fold B client op-rows over the
// state lanes, then extract the batch's δ against the pre-batch vv.
//
// Replaces the Pallas kernel of go_crdt_playground_tpu/ops/pallas_ingest.py:
//   K10 _fused_ingest (_ingest_kernel): the serve tier's write path.
// The rows serialize on the replica's clock, but their cross-row
// dependencies are scalar: the wrapper (ops/cuda_ingest.py) computes each
// row's counter bases by prefix sums (add_dc[b, e], the add dot of lane e
// in row b; del_ctr[b], the deletion dot's counter of row b), so the fold
// is a per-lane state machine:
//   for b in 0..B:  add:  present = 1, dot = (actor, add_dc[b, e]);
//                   del:  if present: clear it and its dot, log the
//                         deletion dot (actor, del_ctr[b]).
// add_rows and del_rows are bool bytes with the live mask already folded
// in.  The A-shaped outputs (vv, processed) are closed-form and computed
// by the wrapper.
//
// Bound: memory.  Each lane reads its 18 state bytes and 6 bytes a row
// (two row bytes and the add dot counter) and writes 36 bytes (the merged
// lanes and the δ lanes): at E = 1,024 and B = 32 about 250 KB, 0.07 us at
// 3.35 TB/s, so a launch at the serve tier's shapes is latency-bound.
// Design: one thread per element lane, 256 lanes a block, grid
// ceil(E / 256); the B-row loop runs in registers, each row read
// coalesced across the warp; the pre-batch vv row is staged in shared
// memory for the δ's HasDot.  B = 0 runs the kernel (an empty fold, the δ
// only); neither E nor B is padded.
#include "common.cuh"

namespace {

__global__ void ingest_fold(
    const uint32_t* __restrict__ vv, const uint32_t* __restrict__ actor_p,
    const uint8_t* __restrict__ present,
    const uint32_t* __restrict__ dot_actor,
    const uint32_t* __restrict__ dot_counter,
    const uint8_t* __restrict__ deleted,
    const uint32_t* __restrict__ del_dot_actor,
    const uint32_t* __restrict__ del_dot_counter,
    const uint8_t* __restrict__ add_rows, const uint8_t* __restrict__ del_rows,
    const uint32_t* __restrict__ add_dc, const uint32_t* __restrict__ del_ctr,
    uint8_t* __restrict__ o_present, uint32_t* __restrict__ o_dot_actor,
    uint32_t* __restrict__ o_dot_counter, uint8_t* __restrict__ o_deleted,
    uint32_t* __restrict__ o_del_dot_actor,
    uint32_t* __restrict__ o_del_dot_counter, uint8_t* __restrict__ changed,
    uint32_t* __restrict__ ch_da, uint32_t* __restrict__ ch_dc,
    uint8_t* __restrict__ del_mask, uint32_t* __restrict__ del_da,
    uint32_t* __restrict__ del_dc, long long num_b, long long num_e,
    int num_a) {
  extern __shared__ uint32_t vv_s[];
  for (int a = threadIdx.x; a < num_a; a += blockDim.x) vv_s[a] = vv[a];
  __syncthreads();
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= num_e) return;
  const uint32_t actor = *actor_p;
  bool p = present[e] != 0, d = deleted[e] != 0;
  uint32_t da = dot_actor[e], dc = dot_counter[e];
  uint32_t xa = del_dot_actor[e], xc = del_dot_counter[e];
  for (long long b = 0; b < num_b; ++b) {
    const long long i = b * num_e + e;
    if (add_rows[i]) {
      p = true;
      da = actor;
      dc = add_dc[i];
    }
    if (del_rows[i] && p) {
      p = false;
      da = 0u;
      dc = 0u;
      d = true;
      xa = actor;
      xc = del_ctr[b];
    }
  }
  o_present[e] = p;
  o_dot_actor[e] = da;
  o_dot_counter[e] = dc;
  o_deleted[e] = d;
  o_del_dot_actor[e] = xa;
  o_del_dot_counter[e] = xc;

  // the δ vs the PRE-batch vv (ops/delta.delta_extract on the new lanes)
  const bool ch = p && !(dc <= crdt::clock_at(vv_s, da, num_a));
  changed[e] = ch;
  ch_da[e] = ch ? da : 0u;
  ch_dc[e] = ch ? dc : 0u;
  const bool resurrected = p && (da != xa || dc > xc);
  const bool dm = d && !resurrected;
  del_mask[e] = dm;
  del_da[e] = dm ? xa : 0u;
  del_dc[e] = dm ? xc : 0u;
}

}  // namespace

// One launch for a replica slice of E lanes and A actors and a batch of B
// rows; bool arrays are one byte per lane, uint32 arrays any 32-bit
// storage.  Returns the cudaError_t of the launch.
extern "C" int crdt_ingest_fold(
    const void* vv, const void* actor, const void* present,
    const void* dot_actor, const void* dot_counter, const void* deleted,
    const void* del_dot_actor, const void* del_dot_counter,
    const void* add_rows, const void* del_rows, const void* add_dc,
    const void* del_ctr, void* o_present, void* o_dot_actor,
    void* o_dot_counter, void* o_deleted, void* o_del_dot_actor,
    void* o_del_dot_counter, void* changed, void* ch_da, void* ch_dc,
    void* del_mask, void* del_da, void* del_dc, long long num_b,
    long long num_e, int num_a, void* stream) {
  if (num_e <= 0) return 0;
  const long long blocks = (num_e + crdt::kThreads - 1) / crdt::kThreads;
  const size_t smem = static_cast<size_t>(num_a) * sizeof(uint32_t);
  ingest_fold<<<static_cast<unsigned>(blocks), crdt::kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vv), static_cast<const uint32_t*>(actor),
      static_cast<const uint8_t*>(present),
      static_cast<const uint32_t*>(dot_actor),
      static_cast<const uint32_t*>(dot_counter),
      static_cast<const uint8_t*>(deleted),
      static_cast<const uint32_t*>(del_dot_actor),
      static_cast<const uint32_t*>(del_dot_counter),
      static_cast<const uint8_t*>(add_rows),
      static_cast<const uint8_t*>(del_rows),
      static_cast<const uint32_t*>(add_dc),
      static_cast<const uint32_t*>(del_ctr),
      static_cast<uint8_t*>(o_present), static_cast<uint32_t*>(o_dot_actor),
      static_cast<uint32_t*>(o_dot_counter),
      static_cast<uint8_t*>(o_deleted),
      static_cast<uint32_t*>(o_del_dot_actor),
      static_cast<uint32_t*>(o_del_dot_counter),
      static_cast<uint8_t*>(changed), static_cast<uint32_t*>(ch_da),
      static_cast<uint32_t*>(ch_dc), static_cast<uint8_t*>(del_mask),
      static_cast<uint32_t*>(del_da), static_cast<uint32_t*>(del_dc), num_b,
      num_e, num_a);
  return static_cast<int>(cudaGetLastError());
}
