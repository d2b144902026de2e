"""The port's multi-process tier (parallel/multihost.py) over gloo: two
real processes, one slot each, a process group joined through a file in
``tmp_path`` (no fixed port), the sharded rounds of parallel/gossip.py
with their exchanges through ``batch_isend_irecv`` and ``all_reduce``.
Both ranks must print the same fleet digest, equal to a one-process
mesh of two slots running the same rounds (the scenario of
tests/test_multihost.py:148)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from go_crdt_playground_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    from go_crdt_playground_tpu_torch.parallel import multihost
    from tests.test_torch_multihost import run_rounds

    pid = int(sys.argv[1])
    multihost.initialize(sys.argv[2], num_processes=2, process_id=pid,
                         backend="gloo")
    mesh = multihost.global_mesh(local_devices=["cpu"])
    assert multihost.process_count() == 2 and mesh.shape["replica"] == 2
    lo, hi = multihost.process_replica_block(8)
    assert (lo, hi) == (4 * pid, 4 * pid + 4)
    try:
        multihost.process_replica_block(9)
        raise SystemExit("expected ValueError for a ragged replica axis")
    except ValueError:
        pass
    ring, delta, conv = run_rounds(mesh, lo, hi)
    print(f"WORKER_OK pid={{pid}} ring={{ring}} delta={{delta}} "
          f"converged={{conv}}", flush=True)
    torch.distributed.destroy_process_group()
""").format(repo=REPO)


def _rows(lo, hi, E=16, A=8, delta=False):
    """The worker's replica rows [lo, hi): the JAX scenario's builder."""
    from go_crdt_playground_tpu_torch._u32 import from_numpy_u32
    from go_crdt_playground_tpu_torch.models.awset import AWSetState
    from go_crdt_playground_tpu_torch.models.awset_delta import \
        AWSetDeltaState

    e = np.arange(E, dtype=np.uint32)[None, :]
    r = np.arange(lo, hi, dtype=np.uint32)[:, None]
    present = (e % (r % 3 + 2)) == 0
    counter = np.cumsum(present, axis=1, dtype=np.uint32) * present
    vv = np.zeros((hi - lo, A), np.uint32)
    vv[np.arange(hi - lo), np.arange(lo, hi)] = counter.max(axis=1)
    u = lambda a: from_numpy_u32(a, "cpu")  # noqa: E731
    base = AWSetState(vv=u(vv), present=torch.from_numpy(present),
                      dot_actor=u(np.where(present, r, 0)),
                      dot_counter=u(counter),
                      actor=u(np.arange(lo, hi, dtype=np.uint32)))
    if not delta:
        return base
    zero = torch.zeros_like(base.dot_actor)
    return AWSetDeltaState(*base, deleted=torch.zeros_like(base.present),
                           del_dot_actor=zero, del_dot_counter=zero,
                           processed=base.vv.clone())


def _fleet_digest(sh, mesh):
    """The sum mod 2^32 of every replica's state digest, collectively."""
    from go_crdt_playground_tpu_torch.parallel import gossip, shardmap

    d = gossip.state_digest_shardmap(sh, mesh)
    part = shardmap.map_slots(mesh, lambda idx, x: x.sum() & 0xFFFFFFFF, d)
    total = shardmap.psum(mesh, part, "replica")
    return int(total[mesh.local_slots()[0]])


def run_rounds(mesh, lo, hi):
    """One full-state ring round, then δ rounds (v2, collective GC) over
    the dissemination schedule; (ring digest, δ digest, converged)."""
    from go_crdt_playground_tpu_torch.parallel import gossip

    sh = multihost.shard_local_rows(_rows(lo, hi), mesh)
    ring = _fleet_digest(gossip.ring_round_shardmap(sh, mesh), mesh)
    R = 8
    st = multihost.shard_local_rows(_rows(lo, hi, delta=True), mesh)
    for off in gossip.dissemination_offsets(R):
        st = gossip.delta_gossip_round_shardmap(
            st, mesh, gossip.ring_perm(R, off, "cpu"))
        st = gossip.gc_shardmap(st, mesh)
    return ring, _fleet_digest(st, mesh), gossip.converged_shardmap(st,
                                                                   mesh)


def test_process_replica_block_single_process():
    assert multihost.process_count() == 1
    assert multihost.process_replica_block(64) == (0, 64)
    assert "process_replica_block(9)" in _WORKER


def _jax_digests():
    """The same rounds in the JAX package, unsharded: the ring round is
    the gather round at r -> (r - 4) mod 8."""
    import jax.numpy as jnp

    from go_crdt_playground_tpu.models import awset, awset_delta
    from go_crdt_playground_tpu.ops import delta as delta_ops
    from go_crdt_playground_tpu.parallel import collectives, gossip

    def jax_state(delta):
        t = _rows(0, 8, delta=delta)
        mod = awset_delta if delta else awset
        return mod.from_arrays({f: (x.numpy() if x.dtype == torch.bool
                                    else x.numpy().view(np.uint32))
                                for f, x in zip(t._fields, t)})

    def total(st):
        d = np.asarray(collectives.state_digest(st.present, st.vv))
        return int(d.astype(np.uint64).sum() % (1 << 32))

    ring = gossip.gossip_round(jax_state(False),
                               jnp.asarray((np.arange(8) - 4) % 8,
                                           jnp.uint32), kernel="xla")
    st = jax_state(True)
    for off in gossip.dissemination_offsets(8):
        st = gossip.delta_gossip_round(st, gossip.ring_perm(8, off),
                                       delta_semantics="v2", kernel="xla")
        st = delta_ops.gc_apply(st, delta_ops.gc_frontier(st.processed))
    return total(ring), total(st)


def test_two_process_rounds_equal_the_one_process_mesh(tmp_path):
    from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod

    one = mesh_mod.make_mesh((2, 1), devices=["cpu", "cpu"])
    ring, delta, conv = run_rounds(one, 0, 8)
    assert conv
    assert (ring, delta) == _jax_digests()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), init], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
    for pid, (_, out, _) in enumerate(outs):
        assert (f"WORKER_OK pid={pid} ring={ring} delta={delta} "
                f"converged=True") in out, out
