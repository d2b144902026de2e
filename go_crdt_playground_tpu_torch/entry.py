"""The flagship forward step: one batched full-state AWSet ring round
plus the convergence digest, on the 256 x 256 demo fleet (the
counterpart of ``__graft_entry__.entry()``), and the multi-slot dry run
(the counterpart of ``__graft_entry__.dryrun_multichip``)."""

from __future__ import annotations

import numpy as np
import torch

from go_crdt_playground_tpu_torch import fleet
from go_crdt_playground_tpu_torch.parallel import collectives, gossip


def forward(state, offset):
    """(merged_state, converged_scalar) after one ring round at
    ``offset``; runs the ring kernel on CUDA tensors."""
    merged = gossip.ring_gossip_round(state, offset)
    return merged, collectives.converged(merged.present, merged.vv)


def entry(device="cuda"):
    """Returns (fn, example_args): fn(state, offset) -> (merged_state,
    converged_scalar), with the 256 x 256 demo fleet on ``device``."""
    state = fleet.demo_state(num_replicas=256, num_elements=256,
                             device=device)
    return forward, (state, np.uint32(1))


# ---------------------------------------------------------------------------
# The multi-slot dry run (the counterpart of __graft_entry__.dryrun_multichip)
# ---------------------------------------------------------------------------


def _states_equal(a, b) -> bool:
    from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod

    if isinstance(a, mesh_mod.ShardedState):
        a = mesh_mod.gather_state(a)
    if isinstance(b, mesh_mod.ShardedState):
        b = mesh_mod.gather_state(b)
    return type(a) is type(b) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(a, b))


def _packed_reference_round(ref, off: int, blk: int, round_fn):
    """The unsharded reference of one packed block-ring round: a
    block-aligned offset is the global ring round; an intra offset wraps
    per block, built from the stacked [block; block] form of each block
    on one device with the same single-device kernel."""
    if off % blk == 0:
        return round_fn(ref, off)
    outs = []
    for b in range(ref.vv.shape[0] // blk):
        block = type(ref)(*(x[b * blk:(b + 1) * blk] for x in ref))
        stacked = type(ref)(*(torch.cat([x, x]) for x in block))
        outs.append(type(ref)(*(x[:blk].clone() for x in round_fn(
            stacked, blk + off))))
    return type(ref)(*(torch.cat(xs) for xs in zip(*outs)))


def dryrun_multichip(n_devices: int, device="cuda"):
    """Run the five sharded paths of the JAX package's dry run on an
    ``n_devices``-slot mesh, each driven to convergence and checked
    bitwise against the same rounds on the unsharded state:

      1. delta-default: the sharded δ round (K5 per slot), the
         collective GC frontier and the convergence digest over a
         (replica x element) mesh, a full dissemination schedule;
      2. ep: the EP-layout ring (vv slots sharded per actor);
      3. compact-ring: the fixed-K payload ring;
      4. packed-ring: the bitpacked block ring (K8 per slot);
      5. dotword-ring: the dot-word block ring (K9 per slot).

    The unsharded replay runs the kernels' plain versions
    (``kernel="torch"``), so on a card every round holds the per-slot
    kernels against their plain versions and only the sharded rounds
    launch kernels.  ``device``: the slots' devices
    (``mesh.take_devices``): ``"cuda"`` wants n distinct cards, a named
    device (``"cuda:0"``, ``"cpu"``) holds every slot.  Prints the JAX
    package's lines and raises on any failure.  Returns one dict a path:
    name, converged, bitwise."""
    import functools

    from go_crdt_playground_tpu_torch.models import packed as packed_mod
    from go_crdt_playground_tpu_torch.ops import cuda_delta
    from go_crdt_playground_tpu_torch.ops import delta as delta_ops
    from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod

    devices = mesh_mod.take_devices(n_devices, device)
    dev = devices[0]
    results = []

    # -- path 1: the sharded δ round on a 2-D mesh, full dissemination --
    shape = ((n_devices // 2, 2) if n_devices % 2 == 0 and n_devices >= 4
             else (n_devices, 1))
    mesh = mesh_mod.make_mesh(shape, devices=devices)
    R, E = 4 * shape[0], 16 * shape[1]
    ref = fleet.demo_state(R, E, delta=True, device=dev)
    state = mesh_mod.shard_state(ref, mesh)
    for off in gossip.dissemination_offsets(R):
        perm = gossip.ring_perm(R, off, dev)
        state = gossip.gc_shardmap(
            gossip.delta_gossip_round_shardmap(state, mesh, perm), mesh)
        ref = gossip.delta_gossip_round(ref, perm, delta_semantics="v2",
                                        kernel="torch")
        ref = delta_ops.gc_apply(ref, delta_ops.gc_frontier(ref.processed))
    results.append((f"delta-default{shape}xR{R}",
                    gossip.converged_shardmap(state, mesh),
                    _states_equal(state, ref)))

    # -- path 2: EP-layout ring (one replica a slot block, so the offset-1
    #    slot ring converges in n_r - 1 rounds); the unsharded reference
    #    is the gather round at offset -1 ---------------------------------
    n_r, n_e = shape
    R_ep = n_r
    ep_plain = fleet.demo_state(R_ep, 16 * n_e, device=dev)
    ep_state = mesh_mod.shard_state(ep_plain, mesh, shard_actors=True)
    ep_perm = (np.arange(R_ep) - 1) % R_ep
    for _ in range(max(n_r - 1, 1)):
        ep_state = gossip.ep_ring_round_shardmap(ep_state, mesh)
        ep_plain = gossip.gossip_round(ep_plain, ep_perm, kernel="torch")
    results.append((f"ep{shape}xR{R_ep}",
                    gossip.converged_shardmap(ep_state, mesh),
                    _states_equal(ep_state, ep_plain)))

    # -- paths 3-5 need the element axis unsharded -----------------------
    ring_mesh = (mesh if shape[1] == 1
                 else mesh_mod.make_mesh((n_devices, 1), devices=devices))

    # -- path 3: the compact fixed-K ring; reference: the compact round
    #    at the block-shift permutation ------------------------------------
    R_c = n_devices
    c_plain = fleet.demo_state(R_c, 32, delta=True, device=dev)
    c_state = mesh_mod.shard_state(c_plain, ring_mesh)
    c_perm = (np.arange(R_c) - 1) % R_c
    for _ in range(max(R_c - 1, 1)):
        c_state = gossip.compact_ring_round_shardmap(c_state, ring_mesh)
        c_plain = gossip.compact_delta_gossip_round(c_plain, c_perm)
    results.append((f"compact-ring({n_devices},1)xR{R_c}",
                    gossip.converged_shardmap(c_state, ring_mesh),
                    _states_equal(c_state, c_plain)))

    # -- paths 4 and 5: the packed block rings (intra doublings, then
    #    block doublings: the composed dissemination schedule) ------------
    blk = 64
    R_p = blk * n_devices
    for label, pack, ring in (
            ("packed-ring", packed_mod.pack_awset_delta,
             cuda_delta.delta_ring_round_packed),
            ("dotword-ring", packed_mod.pack_awset_delta_dots,
             cuda_delta.delta_ring_round_dotpacked)):
        ring = functools.partial(ring, kernel="torch")
        p_plain = pack(fleet.demo_state(R_p, 128, delta=True, device=dev))
        p_state = mesh_mod.shard_state(p_plain, ring_mesh)
        off = 1
        while off < R_p:
            p_state = gossip.packed_block_ring_round_shardmap(
                p_state, ring_mesh, off)
            p_plain = _packed_reference_round(p_plain, off, blk, ring)
            off *= 2
        out = mesh_mod.gather_state(p_state)
        if label == "dotword-ring":
            out = packed_mod.unpack_awset_delta_dots(out, 128)
            conv = collectives.converged(out.present, out.vv)
        else:
            conv = collectives.converged_packed(out.present_bits, out.vv)
        results.append((f"{label}({n_devices},1)xR{R_p}", bool(conv),
                        _states_equal(p_state, p_plain)))

    for name, conv_ok, bit_ok in results:
        print(f"dryrun_multichip path {name}: converged={conv_ok} "
              f"bitwise={bit_ok}")
    n_ok = sum(conv_ok and bit_ok for _, conv_ok, bit_ok in results)
    summary = (
        f"dryrun_multichip ok: {n_ok}/{len(results)} sharded paths "
        "converged with bitwise-equal unsharded replay "
        f"({', '.join(name for name, _, _ in results)})")
    if n_ok != len(results):
        raise RuntimeError(summary.replace("ok:", "FAILED:"))
    print(summary)
    return [dict(name=name, converged=c, bitwise=b)
            for name, c, b in results]
