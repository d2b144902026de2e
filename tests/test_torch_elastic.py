"""Elastic recovery on torch nodes (tests/test_elastic.py's scenarios):
a networked replica crashes, is restored from a checkpoint, rejoins, and
anti-entropy heals the gap, checked against the port's spec world
(models/spec.py) and, side by side, against the same scenario on JAX
nodes: ``members()`` and ``vv()`` equal at every check."""

import numpy as np
import pytest

from go_crdt_playground_tpu.net.peer import Node as JaxNode
from go_crdt_playground_tpu_torch.models.spec import (AWSetDelta,
                                                      VersionVector)
from go_crdt_playground_tpu_torch.net.peer import Node
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

E, A = 16, 3


def _spec_world():
    return [AWSetDelta(actor=i, version_vector=VersionVector([0] * A),
                       delta_semantics="v2") for i in range(A)]


class _Fleet:
    """A networked replica fleet of one package."""

    def __init__(self, make, restore):
        self.make, self.restore = make, restore
        self.nodes = [make(i) for i in range(A)]
        self.addrs = [n.serve() for n in self.nodes]

    def close(self):
        for n in self.nodes:
            if n is not None:
                n.close()


FLEETS = {
    "torch": (lambda i, **kw: Node(i, E, A, device="cpu", **kw),
              lambda path: Node.restore(path, device="cpu")),
    "jax": (lambda i, **kw: JaxNode(i, E, A, **kw), JaxNode.restore),
}


def _check(fleets, specs):
    """Every live replica of every fleet holds its spec replica's
    members, and the fleets agree replica by replica on members and vv."""
    for i, s in enumerate(specs):
        live = [f.nodes[i] for f in fleets if f.nodes[i] is not None]
        want = sorted(int(k[1:]) for k in s.entries)
        for n in live:
            np.testing.assert_array_equal(n.members(), want)
        for n in live[1:]:
            np.testing.assert_array_equal(n.members(), live[0].members())
            np.testing.assert_array_equal(n.vv(), live[0].vv())


def _run_crash_restore_resync(fleets, tmp_path):
    """tests/test_elastic.py::test_crash_restore_resync on each fleet in
    lockstep."""
    specs = _spec_world()

    def sync(dst, src):
        for f in fleets:
            f.nodes[dst].sync_with(f.addrs[src])
        # push-pull: the server absorbs the client's payload, then the
        # client absorbs the server's
        specs[src].merge(specs[dst])
        specs[dst].merge(specs[src])

    def each(fn):
        for f in fleets:
            fn(f)

    # phase 1: divergent writes and a partial sync
    each(lambda f: f.nodes[0].add(1, 2))
    specs[0].add("e1", "e2")
    each(lambda f: f.nodes[1].add(3))
    specs[1].add("e3")
    each(lambda f: f.nodes[2].add(4, 5))
    specs[2].add("e4", "e5")
    sync(0, 1)
    sync(2, 0)
    _check(fleets, specs)

    # phase 2: checkpoint node 1, then crash it; its post-checkpoint
    # write is lost with it, so the spec world never sees it
    for k, f in enumerate(fleets):
        f.ck = str(tmp_path / f"node1-{k}.ckpt")
        f.nodes[1].save(f.ck, metadata={"round": 2})
        f.nodes[1].add(6)
        f.nodes[1].close()
        f.nodes[1] = None

    # phase 3: the world moves on without node 1
    each(lambda f: f.nodes[0].delete(2))
    specs[0].del_("e2")
    each(lambda f: f.nodes[2].add(7))
    specs[2].add("e7")
    sync(0, 2)
    _check(fleets, specs)

    # phase 4: restore node 1 from its checkpoint and rejoin
    for f in fleets:
        f.nodes[1] = f.restore(f.ck)
        assert f.nodes[1].actor == 1
        f.addrs[1] = f.nodes[1].serve()
        # the pre-crash checkpoint: e1..e3 seen, e6 gone
        np.testing.assert_array_equal(f.nodes[1].members(), [1, 2, 3])
    # a full mesh of exchanges heals everyone
    for dst, src in ((1, 0), (0, 1), (1, 2), (2, 1), (0, 2)):
        sync(dst, src)
    _check(fleets, specs)
    for f in fleets:
        for n in f.nodes[1:]:
            np.testing.assert_array_equal(n.members(), f.nodes[0].members())
            np.testing.assert_array_equal(n.vv(), f.nodes[0].vv())


@pytest.mark.parametrize("kinds", [("torch",), ("torch", "jax")],
                         ids=["spec", "with_jax"])
def test_crash_restore_resync(tmp_path, kinds):
    """The crash-restore-resync scenario on torch nodes against the spec
    world, alone and beside a JAX fleet driven through the same steps."""
    fleets = []
    try:
        for kind in kinds:
            fleets.append(_Fleet(*FLEETS[kind]))
        _run_crash_restore_resync(fleets, tmp_path)
    finally:
        for f in fleets:
            f.close()


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch")])
def test_restore_preserves_semantics_switches(tmp_path, writer, reader):
    """The δ semantics switches survive a checkpoint restore, within the
    port and across the packages' checkpoints."""
    make, _ = FLEETS[writer]
    n = make(0, delta_semantics="reference",
             strict_reference_semantics=False)
    n.add(3)
    path = n.save(str(tmp_path / "n.ckpt"))
    n.close()
    back = FLEETS[reader][1](path)
    try:
        assert back.delta_semantics == "reference"
        assert back.strict_reference_semantics is False
        np.testing.assert_array_equal(back.members(), [3])
    finally:
        back.close()
