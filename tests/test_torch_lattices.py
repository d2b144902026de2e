"""The port's lattice families (ops/lattices.py), its OR-Map rounds and
its AWSet join registration against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and go through both packages; every
output is compared with ``np.array_equal``, dtype included (uint32
against the port's int32 bits).  The float32 joins are one IEEE operation
a lane and are held bitwise too.  Counters and stamps between 2^31 and
2^32 - 1 go through every join that compares.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.ops import lattices as JL
from go_crdt_playground_tpu.ops import merge as jax_merge  # noqa: F401
from go_crdt_playground_tpu.parallel import gossip as jax_gossip
from go_crdt_playground_tpu.utils import checkpoint as jax_ckpt
from go_crdt_playground_tpu_torch._u32 import from_numpy_u32, host
from go_crdt_playground_tpu_torch.ops import lattices as L
from go_crdt_playground_tpu_torch.ops import merge as port_merge  # noqa
from go_crdt_playground_tpu_torch.parallel import gossip
from go_crdt_playground_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_wire import _load

# uint32 values on both sides of 2^31 and at the top of the range
EDGES = np.array([0, 1, 2, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0x80000001,
                  0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)


def port(jst):
    """A JAX NamedTuple of arrays -> the port's NamedTuple of CPU tensors
    (uint32 as int32 bits; bool and float32 as they are)."""
    cls = getattr(L, type(jst).__name__)
    fields = []
    for x in jst:
        a = np.asarray(x)
        fields.append(from_numpy_u32(a, "cpu") if a.dtype == np.uint32
                      else torch.from_numpy(a.copy()))
    return cls(*fields)


def same(want, got, ctx=""):
    """Every field equal by value and dtype (the port's int32 bits read
    as uint32)."""
    assert type(want).__name__ == type(got).__name__, ctx
    assert want._fields == got._fields, ctx
    for name, w, g in zip(want._fields, want, got):
        w, g = np.asarray(w), host(g)
        assert g.dtype == w.dtype, f"{ctx}:{name} dtype {g.dtype}/{w.dtype}"
        assert g.shape == w.shape, f"{ctx}:{name} shape {g.shape}/{w.shape}"
        assert np.array_equal(g, w), f"{ctx}:{name}"


def u32(rng, shape, edges: bool):
    """Seeded uint32 values; with ``edges`` about half drawn from EDGES."""
    x = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    if edges:
        pick = rng.random(shape) < 0.5
        x = np.where(pick, EDGES[rng.integers(0, len(EDGES), shape)], x)
    return x


def small(rng, shape, hi=6):
    return rng.integers(0, hi, shape).astype(np.uint32)


def random_state(family: str, rng, R: int = 7, E: int = 9, A: int = 5,
                 edges: bool = True):
    """A JAX state of ``family`` with seeded contents (arbitrary bits:
    the joins are total functions of their inputs).  Stamps, counters and
    clocks take values across 2^31 with ``edges``; few distinct values
    make ties (equal stamps, equal counters) common."""
    num = (lambda shape: u32(rng, shape, True)) if edges else \
        (lambda shape: small(rng, shape))
    actor = np.arange(R, dtype=np.uint32) % A
    if family == "gcounter":
        return JL.GCounterState(counts=num((R, A)), actor=actor)
    if family == "pncounter":
        return JL.PNCounterState(p=num((R, A)), n=num((R, A)), actor=actor)
    if family == "twopset":
        return JL.TwoPSetState(added=rng.random((R, E)) < 0.5,
                               removed=rng.random((R, E)) < 0.3)
    if family == "lwwmap":
        return JL.LWWMapState(ts=num((R, E)), wr_actor=num((R, E)),
                              val=u32(rng, (R, E), False),
                              live=rng.random((R, E)) < 0.7, actor=actor)
    if family == "mvregister":
        return JL.MVRegisterState(ctx=num((R, A)),
                                  live=rng.random((R, A)) < 0.5,
                                  cnt=num((R, A)),
                                  val=u32(rng, (R, A), False), actor=actor)
    if family == "ormap":
        present = rng.random((R, E)) < 0.5
        return JL.ORMapState(
            vv=num((R, A)), present=present,
            dot_actor=np.where(present, rng.integers(0, A, (R, E)),
                               0).astype(np.uint32),
            dot_counter=np.where(present, num((R, E)), 0).astype(np.uint32),
            actor=actor, ts=num((R, E)), wr_actor=num((R, E)),
            val=u32(rng, (R, E), False))
    if family in ("tensor_max", "tensor_mean"):
        w = rng.normal(0.0, 1.0, (R, 16)).astype(np.float32)
        w[rng.random((R, 16)) < 0.2] = 0.0
        w[0, 0], w[1, 0] = np.float32(-0.0), np.float32(0.0)
        return JL.TensorMergeState(w=w)
    if family == "weighted_mean":
        return JL.WeightedMergeState(
            acc=rng.normal(0.0, 1.0, (R, 16)).astype(np.float32),
            weight=rng.uniform(0.0, 2.0, (R, 1)).astype(np.float32))
    raise ValueError(family)


JOINS = {
    "gcounter": (JL.gcounter_join, L.gcounter_join),
    "pncounter": (JL.pncounter_join, L.pncounter_join),
    "twopset": (JL.twopset_join, L.twopset_join),
    "lwwmap": (JL.lwwmap_join, L.lwwmap_join),
    "mvregister": (JL.mvregister_join, L.mvregister_join),
    "ormap": (JL.ormap_join, L.ormap_join),
    "tensor_max": (JL.tensor_max_join, L.tensor_max_join),
    "tensor_mean": (JL.tensor_mean_join, L.tensor_mean_join),
    "weighted_mean": (JL.weighted_mean_join, L.weighted_mean_join),
}
COMPARING = ("gcounter", "pncounter", "lwwmap", "mvregister", "ormap")


def _rows(jst, perm):
    return jax.tree.map(lambda x: np.asarray(x)[perm], jst)


# -- joins --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", sorted(JOINS))
def test_join_matches_jax(family, seed):
    """Batched joins and the reference's vmap of the join over rows,
    on states whose counters and stamps cross 2^31 (and on small values
    with many ties)."""
    rng = np.random.default_rng(100 + seed)
    jax_join, port_join = JOINS[family]
    for edges in (True, False):
        dst = random_state(family, rng, edges=edges)
        src = _rows(random_state(family, rng, edges=edges),
                    rng.permutation(7))
        want = JL.join_pairwise(jax_join, dst, src)
        got = L.join_pairwise(port_join, port(dst), port(src))
        same(want, got, f"{family} edges={edges}")
        # the batched call is the per-row join (the reference's OR-Map
        # join is not on a batch: test_jax_ormap_join_on_a_batch_...)
        same(want, port_join(port(dst), port(src)), f"{family} batched")
        if family != "ormap":
            same(jax_join(dst, src), got, f"{family} batched")


def test_jax_ormap_join_on_a_batch_reads_row_0s_clock():
    """The reference's ``ormap_join`` called on a batch (not under vmap,
    as its registry's law pass and ``_sample_ormap``'s ``mix_rows`` call
    it) looks every row's HasDot up in row 0's clock: its ``has_dot``
    ``jnp.take`` flattens vv[R, A].  The port's join is the per-row join
    on a batch too, as the reference's ``gossip_round`` (vmap) is."""
    rng = np.random.default_rng(17)
    dst = random_state("ormap", rng, edges=False)
    src = random_state("ormap", rng, edges=False)
    rowwise = JL.join_pairwise(JL.ormap_join, dst, src)
    batch = JL.ormap_join(dst, src)
    assert not np.array_equal(np.asarray(batch.present),
                              np.asarray(rowwise.present))
    clock0 = dst._replace(vv=np.repeat(np.asarray(dst.vv)[:1], 7, axis=0))
    src0 = src._replace(vv=np.repeat(np.asarray(src.vv)[:1], 7, axis=0))
    quirk = JL.join_pairwise(JL.ormap_join, clock0, src0)
    assert np.array_equal(np.asarray(batch.present),
                          np.asarray(quirk.present))
    same(rowwise, L.ormap_join(port(dst), port(src)))


@pytest.mark.parametrize("family", COMPARING)
def test_join_compares_unsigned(family):
    """A counter or stamp of 2^31 or more beats a small one: the int32
    storage must not compare signed."""
    rng = np.random.default_rng(7)
    dst = random_state(family, rng, edges=False)
    big = random_state(family, rng, edges=False)
    hi = np.uint32(0x80000000)
    bump = {"gcounter": ("counts",), "pncounter": ("p", "n"),
            "lwwmap": ("ts",), "mvregister": ("ctx", "cnt"),
            "ormap": ("vv", "ts")}[family]
    big = big._replace(**{f: np.asarray(getattr(big, f)) + hi
                          for f in bump})
    for a, b in ((dst, big), (big, dst)):
        want = JL.join_pairwise(JOINS[family][0], a, b)
        got = L.join_pairwise(JOINS[family][1], port(a), port(b))
        same(want, got, family)
    got = L.join_pairwise(JOINS[family][1], port(dst), port(big))
    # the joined maxima (an MV-Register's counters are zeroed where no
    # value is live)
    for f in ("ctx",) if family == "mvregister" else bump:
        assert (host(getattr(got, f)) >= hi).all(), f


def test_join_pairwise_one_row():
    """A join of single rows (the reference's vmap body) equals the
    batched join's row."""
    rng = np.random.default_rng(3)
    for family in sorted(JOINS):
        jax_join, port_join = JOINS[family]
        a = random_state(family, rng)
        b = random_state(family, rng)
        batched = port_join(port(a), port(b))
        for r in (0, 4):
            ra = type(port(a))(*(x[r] for x in port(a)))
            rb = type(port(b))(*(x[r] for x in port(b)))
            got = port_join(ra, rb)
            want = jax_join(jax.tree.map(lambda x: np.asarray(x)[r], a),
                            jax.tree.map(lambda x: np.asarray(x)[r], b))
            same(want, got, f"{family} row {r}")
            for g, w in zip(got, batched):
                assert torch.equal(g, w[r]), family


# -- inits and operations -----------------------------------------------------


def test_inits_match_jax():
    same(JL.gcounter_init(4, 6), L.gcounter_init(4, 6, device="cpu"))
    same(JL.gcounter_init(4, 2, actors=[1, 0, 1, 0]),
         L.gcounter_init(4, 2, actors=[1, 0, 1, 0], device="cpu"))
    same(JL.pncounter_init(3, 3), L.pncounter_init(3, 3, device="cpu"))
    same(JL.twopset_init(3, 5), L.twopset_init(3, 5, device="cpu"))
    same(JL.lwwmap_init(3, 5), L.lwwmap_init(3, 5, device="cpu"))
    same(JL.mvregister_init(3, 4), L.mvregister_init(3, 4, device="cpu"))
    same(JL.ormap_init(3, 5, 4), L.ormap_init(3, 5, 4, device="cpu"))
    same(JL.tensormerge_init(3, 8), L.tensormerge_init(3, 8, device="cpu"))
    same(JL.weightedmerge_init(3, 8),
         L.weightedmerge_init(3, 8, device="cpu"))
    for init in (JL.gcounter_init, JL.mvregister_init):
        with pytest.raises(ValueError, match="num_actors >= num_replicas"):
            init(4, 3)
    for init in (L.gcounter_init, L.mvregister_init, L.pncounter_init):
        with pytest.raises(ValueError, match="num_actors >= num_replicas"):
            init(4, 3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            L.gcounter_init(4, 4)


def _op_history(seed: int, R: int = 4, E: int = 6):
    """A seeded list of (family, op, args) over every operation, with
    amounts, stamps and values across 2^31 and counters that wrap."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(40):
        r, e = int(rng.integers(R)), int(rng.integers(E))
        big = int(EDGES[rng.integers(len(EDGES))])
        ops += [
            ("gcounter", "inc", (r, big)),
            ("pncounter", "add", (r, int(rng.choice(
                [-(1 << 31), -5, 0, 3, (1 << 31) - 1])))),
            ("twopset", "add" if rng.random() < 0.6 else "del", (r, e)),
            ("lwwmap", "put", (r, e, big, int(EDGES[rng.integers(
                len(EDGES))]), bool(rng.random() < 0.7))),
            ("mvregister", "write", (r, big)),
            ("ormap", "put" if rng.random() < 0.7 else "delete",
             (r, e, big, int(EDGES[rng.integers(len(EDGES))]))),
        ]
    return ops


def _apply(mod, family, op, state, args):
    if family == "ormap" and op == "delete":
        args = args[:2]
    u = np.uint32
    if mod is JL:  # the reference takes its scalars as dtyped arrays
        if family == "pncounter":
            args = (u(args[0]), np.int32(args[1]))
        elif family == "lwwmap":
            args = (*map(u, args[:4]), np.bool_(args[4]))
        else:
            args = tuple(map(u, args))
    return getattr(mod, f"{family}_{op}")(state, *args)


def test_operations_match_jax():
    """Every operation of the six families over one seeded history,
    state after state: wrapping adds, an int32 -2^31 amount, stamps and
    writers at the top of uint32, MV-Register contexts wrapping past
    2^32 - 1."""
    R, E, A = 4, 6, 4
    jax_states = {"gcounter": JL.gcounter_init(R, A),
                  "pncounter": JL.pncounter_init(R, A),
                  "twopset": JL.twopset_init(R, E),
                  "lwwmap": JL.lwwmap_init(R, E, actors=np.array(
                      [0, 0xFFFFFFFF, 0x80000000, 3], np.uint32)),
                  "mvregister": JL.mvregister_init(R, A),
                  "ormap": JL.ormap_init(R, E, A)}
    # contexts and counts one tick away from wrapping
    top = np.full((R, A), 0xFFFFFFFE, np.uint32)
    jax_states["mvregister"] = jax_states["mvregister"]._replace(ctx=top)
    jax_states["gcounter"] = jax_states["gcounter"]._replace(counts=top)
    states = {k: port(v) for k, v in jax_states.items()}
    for family, op, args in _op_history(11, R, E):
        jax_states[family] = _apply(JL, family, op, jax_states[family], args)
        states[family] = _apply(L, family, op, states[family], args)
        same(jax_states[family], states[family], f"{family}.{op}{args}")
    assert host(states["gcounter"].counts).min() < 0xFFFFFFFE  # wrapped
    assert np.array_equal(L.gcounter_value(states["gcounter"]),
                          JL.gcounter_value(jax_states["gcounter"]))
    assert L.gcounter_value(states["gcounter"]).dtype == np.uint64
    assert np.array_equal(L.pncounter_value(states["pncounter"]),
                          JL.pncounter_value(jax_states["pncounter"]))
    assert L.pncounter_value(states["pncounter"]).dtype == np.int64
    assert np.array_equal(
        host(L.twopset_member(states["twopset"])),
        np.asarray(JL.twopset_member(jax_states["twopset"])))


def test_weighted_mean_value_matches_jax():
    rng = np.random.default_rng(5)
    st = random_state("weighted_mean", rng)
    st = st._replace(weight=np.where(rng.random((7, 1)) < 0.3, 0.0,
                                     st.weight).astype(np.float32))
    want = JL.weighted_mean_value(st)
    got = L.weighted_mean_value(port(st))
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


def _snapshot(state):
    return [x.clone() for x in state]


def test_no_operation_mutates_its_input():
    """Every operation and join returns new tensors and leaves its
    inputs' untouched."""
    rng = np.random.default_rng(9)
    for family, (_, port_join) in JOINS.items():
        a, b = port(random_state(family, rng)), port(random_state(family,
                                                                  rng))
        sa, sb = _snapshot(a), _snapshot(b)
        port_join(a, b)
        L.gossip_round(port_join, a, np.arange(7)[::-1].copy())
        L.mix_rows(port_join, a, np.random.default_rng(1))
        for s, x in zip(sa + sb, list(a) + list(b)):
            assert torch.equal(s, x), family
    R, E, A = 4, 6, 4
    inits = {"gcounter": L.gcounter_init(R, A, device="cpu"),
             "pncounter": L.pncounter_init(R, A, device="cpu"),
             "twopset": L.twopset_init(R, E, device="cpu"),
             "lwwmap": L.lwwmap_init(R, E, device="cpu"),
             "mvregister": L.mvregister_init(R, A, device="cpu"),
             "ormap": L.ormap_init(R, E, A, device="cpu")}
    for family, op, args in _op_history(12, R, E)[:60]:
        st = inits[family]
        snap = _snapshot(st)
        inits[family] = _apply(L, family, op, st, args)
        for s, x in zip(snap, st):
            assert torch.equal(s, x), (family, op)
    st = port(random_state("ormap", rng))
    snap = _snapshot(st)
    gossip.ormap_gossip_round(st, np.arange(7)[::-1].copy())
    gossip.ormap_ring_gossip_round(st, 3)
    for s, x in zip(snap, st):
        assert torch.equal(s, x)


# -- samplers, the registry and the laws --------------------------------------


REGISTERED = sorted(set(JL.JOIN_REGISTRY) | {"awset_merge"})


def test_registries_hold_the_same_joins():
    assert sorted(L.JOIN_REGISTRY) == sorted(JL.JOIN_REGISTRY) == REGISTERED
    for name in REGISTERED:
        p, j = L.JOIN_REGISTRY[name], JL.JOIN_REGISTRY[name]
        assert p.laws == j.laws and p.atol == j.atol, name
    assert L.ALL_LAWS == JL.ALL_LAWS
    spec = L.register_join(L.JOIN_REGISTRY["gcounter"])
    assert L.JOIN_REGISTRY["gcounter"] is spec


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("name", REGISTERED)
def test_sampler_matches_jax(name, seed, monkeypatch):
    """Each ``_sample_*`` at the same seed draws the same states, and the
    projections have the reference's dtypes.  The reference's OR-Map
    sampler mixes rows with its join on a batch (row 0's clock, above);
    it runs here with that join per row."""
    if name == "ormap":  # the reference's sampler, its join per row
        join = JL.ormap_join
        monkeypatch.setattr(JL, "ormap_join", lambda d, s: jax.vmap(join)(
            d, s))
    want = JL.JOIN_REGISTRY[name].sample(np.random.default_rng(seed), 9, 40)
    got = L.JOIN_REGISTRY[name].sample(np.random.default_rng(seed), 9, 40,
                                       device="cpu")
    same(want, got, name)
    pw = JL.JOIN_REGISTRY[name].project(want)
    pg = L.JOIN_REGISTRY[name].project(got)
    assert list(pw) == list(pg)
    for k in pw:
        assert pg[k].dtype == np.asarray(pw[k]).dtype, (name, k)
        assert np.array_equal(pg[k], np.asarray(pw[k])), (name, k)


def _permuted(state, rng):
    perm = torch.from_numpy(rng.permutation(int(state[0].shape[0])))
    return type(state)(*(x[perm] for x in state))


def _diff(pa, pb, atol):
    for field in pa:
        a, b = pa[field], pb[field]
        if atol > 0 and np.issubdtype(a.dtype, np.floating):
            if not np.allclose(a, b, rtol=0.0, atol=atol):
                return field
        elif not np.array_equal(a, b):
            return field
    return None


@pytest.mark.parametrize("name", REGISTERED)
def test_laws_over_the_port_registry(name):
    """The three laws (each family's declared subset) over the port's
    registry, as the reference's lattice-laws pass checks them (seeds 11,
    12, 13; 9 rows, 40 ops); each side equal to the reference's."""
    from go_crdt_playground_tpu.analysis.lattice_laws import check_join_spec

    spec, jspec = L.JOIN_REGISTRY[name], JL.JOIN_REGISTRY[name]
    findings, _ = check_join_spec(jspec, (11, 12, 13))
    assert findings == []
    for seed in (11, 12, 13):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        a = spec.sample(rng, 9, 40, device="cpu")
        b, c = _permuted(a, rng), _permuted(a, rng)
        ja = jspec.sample(jrng, 9, 40)
        if name == "ormap":  # port's rows, drawn as the reference draws
            ja = JL.ORMapState(*(host(x) for x in a))
        jb = _rows(ja, jrng.permutation(9))
        jc = _rows(ja, jrng.permutation(9))
        join, jjoin = spec.join, jspec.join
        if name == "ormap":
            jjoin = functools.partial(JL.join_pairwise, jspec.join)
        cases = {
            "commutativity": ((join(a, b), join(b, a)),
                              (jjoin(ja, jb), jjoin(jb, ja))),
            "associativity": ((join(join(a, b), c), join(a, join(b, c))),
                              (jjoin(jjoin(ja, jb), jc),
                               jjoin(ja, jjoin(jb, jc)))),
            "idempotence": ((join(a, a), a), (jjoin(ja, ja), ja)),
        }
        for law in spec.laws:
            (lhs, rhs), (jl, jr) = cases[law]
            assert _diff(spec.project(lhs), spec.project(rhs),
                         spec.atol) is None, (name, law, seed)
            same(jl, lhs, f"{name} {law} lhs")
            same(jr, rhs, f"{name} {law} rhs")


def test_undeclared_laws_really_fail():
    """The subsets are honest: the weighted mean is not idempotent and
    the pairwise mean not associative, in the port as in the reference."""
    w = L.JOIN_REGISTRY["weighted_mean"]
    a = w.sample(np.random.default_rng(11), 9, 40, device="cpu")
    assert _diff(w.project(w.join(a, a)), w.project(a), w.atol) is not None
    m = L.JOIN_REGISTRY["tensor_mean"]
    rng = np.random.default_rng(11)
    a = m.sample(rng, 9, 40, device="cpu")
    b, c = _permuted(a, rng), _permuted(a, rng)
    assert _diff(m.project(m.join(m.join(a, b), c)),
                 m.project(m.join(a, m.join(b, c))), 0.0) is not None


def test_mix_rows_draws_as_jax():
    rng = np.random.default_rng(4)
    st = random_state("gcounter", rng)
    want = JL.mix_rows(JL.gcounter_join, st, np.random.default_rng(8), 0.3)
    got = L.mix_rows(L.gcounter_join, port(st), np.random.default_rng(8),
                     0.3)
    same(want, got)


# -- rounds --------------------------------------------------------------------


def _ormap_history(seed: int, R: int, E: int, n_ops: int = 60,
                   put_p: float = 0.7):
    """The same puts and deletes on a JAX and a port OR-Map (the
    reference tests' histories)."""
    rng = random.Random(seed)
    jst = JL.ormap_init(R, E, R)
    pst = L.ormap_init(R, E, R, device="cpu")
    ts = 0
    for _ in range(n_ops):
        r, e = rng.randrange(R), rng.randrange(E)
        if rng.random() < put_p:
            ts += 1
            v = rng.randrange(1, 99)
            jst = JL.ormap_put(jst, np.uint32(r), np.uint32(e),
                               np.uint32(v), np.uint32(ts))
            pst = L.ormap_put(pst, r, e, v, ts)
        else:
            jst = JL.ormap_delete(jst, np.uint32(r), np.uint32(e))
            pst = L.ormap_delete(pst, r, e)
    same(jst, pst, "history")
    return jst, pst


def test_ormap_gossip_round_matches_jax():
    """Mirrors tests/test_gossip.py's OR-Map perm round: the port's round
    (the AWSet round for the keys, LWW cells by a row gather) against the
    JAX lattice-join round and the JAX fused round."""
    R, E = 8, 16
    jst, pst = _ormap_history(73, R, E)
    for off in (1, 3):
        perm = np.array(jax_gossip.ring_perm(R, off))
        want = JL.gossip_round(JL.ormap_join, jst, perm)
        same(want, gossip.ormap_gossip_round(pst, perm), f"off {off}")
        same(want, gossip.ormap_gossip_round(pst, torch.from_numpy(perm),
                                             kernel="torch"))
        same(want, L.gossip_round(L.ormap_join, pst, perm))
        same(jax_gossip.ormap_gossip_round(jst, perm, kernel="xla"),
             gossip.ormap_gossip_round(pst, perm))
    with pytest.raises(ValueError, match="perm entries"):
        gossip.ormap_gossip_round(pst, np.arange(R) + 1)


def test_ormap_ring_gossip_round_matches_jax():
    """Mirrors tests/test_gossip.py's ring-round test: the offset form
    against the JAX perm and ring rounds, offsets past R too."""
    R, E = 128, 8
    jst, pst = _ormap_history(31, R, E, put_p=0.6)
    for off in (1, 5, 15, 200):
        want = jax_gossip.ormap_gossip_round(
            jst, jax_gossip.ring_perm(R, off), kernel="xla")
        same(want, gossip.ormap_ring_gossip_round(pst, off), f"{off}")
        same(jax_gossip.ormap_ring_gossip_round(jst, off, kernel="xla"),
             gossip.ormap_ring_gossip_round(pst, off, kernel="torch"))


def test_ormap_rounds_converge_like_jax():
    """A dissemination schedule of OR-Map ring rounds ends converged in
    both packages, state by state."""
    R, E = 16, 8
    jst, pst = _ormap_history(5, R, E, n_ops=80)
    for off in jax_gossip.dissemination_offsets(R):
        jst = jax_gossip.ormap_ring_gossip_round(jst, off, kernel="xla")
        pst = gossip.ormap_ring_gossip_round(pst, off)
        same(jst, pst, f"offset {off}")
    for field in ("present", "ts", "wr_actor", "val", "vv"):
        x = host(getattr(pst, field))
        assert (x == x[:1]).all(), field


@pytest.mark.parametrize("A", [16, 2049])
def test_wide_actor_ormap_and_gcounter_rounds(A):
    """Past the JAX package's fused cap (A > 2,048) the rounds take the
    XLA path there and the plain versions here: equal states."""
    rng = np.random.default_rng(A)
    R, E = 8, 12
    st = random_state("ormap", rng, R=R, E=E, A=A)
    for off in (1, 3):
        same(jax_gossip.ormap_ring_gossip_round(st, off),
             gossip.ormap_ring_gossip_round(port(st), off), f"A={A}")
    g = random_state("gcounter", rng, R=R, A=A)
    perm = np.array(jax_gossip.ring_perm(R, 3))
    same(JL.gossip_round(JL.gcounter_join, g, perm),
         L.gossip_round(L.gcounter_join, port(g), perm))


def test_config2_round_matches_jax():
    """BASELINE config 2's round (``bench.measure_config2``: counts seeded
    from default_rng(0), actors r mod A, dissemination ring offsets) at a
    small R, built by chip_smoke.config2_state."""
    import chip_smoke

    R, A = 100, 32
    pst = chip_smoke.config2_state(R, A, "cpu")
    counts = np.random.default_rng(0).integers(
        0, 1 << 20, (R, A)).astype(np.uint32)
    jst = JL.GCounterState(counts=counts,
                           actor=np.arange(R, dtype=np.uint32) % A)
    same(jst, pst)
    for off in jax_gossip.dissemination_offsets(R):
        perm = np.array(jax_gossip.ring_perm(R, off))
        jst = JL.gossip_round(JL.gcounter_join, jst, perm)
        pst = L.gossip_round(L.gcounter_join, pst, torch.from_numpy(perm))
        same(jst, pst, f"offset {off}")
    assert (np.asarray(jst.counts) == np.asarray(jst.counts)[:1]).all()


def test_ormap_fleet_rounds_match_jax():
    """chip_smoke.py's OR-Map fleet (the full-state fleet with seeded LWW
    planes) at a small R: its ring and butterfly schedules against the
    JAX rounds, converged."""
    import chip_smoke

    R, E, W = 256, 32, 16
    pst = chip_smoke.ormap_fleet(R, E, W, "cpu")
    ts = host(pst.ts)
    assert (ts[host(pst.present)] >= 1).all()
    jst = JL.ORMapState(*(host(x) for x in pst))
    start = (jst, pst)
    for off in jax_gossip.dissemination_offsets(R):
        jst = jax_gossip.ormap_ring_gossip_round(jst, off, kernel="xla")
        pst = gossip.ormap_ring_gossip_round(pst, off)
        same(jst, pst, f"ring {off}")
    ring_final = pst
    jst, pst = start
    for stage in range(R.bit_length() - 1):
        perm = np.array(jax_gossip.butterfly_perm(R, stage))
        jst = jax_gossip.ormap_gossip_round(jst, perm, kernel="xla")
        pst = gossip.ormap_gossip_round(pst, perm)
        same(jst, pst, f"butterfly {stage}")
    for st in (ring_final, pst):
        assert chip_smoke.ormap_converged(st)
    # both schedules end in the same keys, clocks and cells (a key several
    # writers added keeps the dot its last merge gave it)
    for field in ("vv", "present", "ts", "wr_actor", "val"):
        assert torch.equal(getattr(ring_final, field),
                           getattr(pst, field)), field


# -- checkpoints ---------------------------------------------------------------


def _lattice_states():
    """One state of each lattice type the reference restores typed, with
    counters and stamps across 2^31."""
    rng = np.random.default_rng(21)
    return [random_state(f, rng) for f in
            ("gcounter", "pncounter", "twopset", "lwwmap", "mvregister",
             "ormap")]


@pytest.mark.parametrize("i", range(6))
def test_lattice_checkpoints_cross_restore(tmp_path, i):
    """A lattice checkpoint written by either package restores typed in
    the other, byte for byte, and both write the same arrays and
    manifest."""
    jst = _lattice_states()[i]
    pst = port(jst)
    assert type(pst).__name__ in ckpt.STATE_TYPES
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), jst, step=4,
                             metadata={"k": 1}, generation=2)
    ckpt.save_checkpoint(str(tmp_path / "t"), pst, step=4,
                         metadata={"k": 1}, generation=2)
    jm, ja = _load(str(tmp_path / "j"))
    tm, ta = _load(str(tmp_path / "t"))
    assert tm == jm and list(ta) == list(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]), k
    got = ckpt.restore_checkpoint(str(tmp_path / "j"), device="cpu")
    assert type(got.state) is ckpt.STATE_TYPES[type(jst).__name__]
    same(jst, got.state, "jax -> port")
    back = jax_ckpt.restore_checkpoint(str(tmp_path / "t"))
    assert type(back.state).__name__ == type(jst).__name__
    same(back.state, pst, "port -> jax")
