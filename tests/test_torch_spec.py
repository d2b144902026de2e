"""The port's spec model (models/spec.py, models/spec_extra.py) against
the JAX package's: every scenario of tests/test_spec_conformance.py run
on the port's classes, and seeded random histories applied to both
packages' spec objects with equal states after every step."""

import random

import pytest

import tests.test_spec_conformance as conformance
from go_crdt_playground_tpu.models import spec as jax_spec
from go_crdt_playground_tpu.models import spec_extra as jax_extra
from go_crdt_playground_tpu_torch.models import spec, spec_extra

SCENARIOS = sorted(name for name in dir(conformance)
                   if name.startswith("test_"))


def _port_make_pair(cls=spec.AWSet, **kw):
    a = cls(actor=0, version_vector=spec.VersionVector([0, 0]), **kw)
    b = cls(actor=1, version_vector=spec.VersionVector([0, 0]), **kw)
    return a, b


@pytest.fixture
def on_the_port(monkeypatch):
    """tests/test_spec_conformance.py's names bound to the port's spec."""
    for name in ("AWSet", "AWSetDelta", "Dot", "VersionVector"):
        monkeypatch.setattr(conformance, name, getattr(spec, name))
    monkeypatch.setattr(conformance, "make_pair", _port_make_pair)


def test_the_scenarios_run_on_the_port_classes(on_the_port):
    a, b = conformance.make_pair(conformance.AWSetDelta)
    assert type(a) is spec.AWSetDelta and type(b) is spec.AWSetDelta
    assert type(conformance.make_pair()[0]) is spec.AWSet
    assert len(SCENARIOS) >= 25


@pytest.mark.parametrize("name", SCENARIOS)
def test_conformance_scenario_on_the_port(name, on_the_port):
    getattr(conformance, name)()


# -- seeded random histories, both packages side by side ---------------------


def _state(rep):
    out = {"str": str(rep), "values": rep.sorted_values(),
           "vv": list(rep.version_vector.v), "actor": rep.actor,
           "entries": dict(rep.entries)}
    if isinstance(rep, (spec.AWSetDelta, jax_spec.AWSetDelta)):
        out.update(deleted=dict(rep.deleted), processed=dict(rep.processed),
                   peer_acked=dict(rep.peer_acked),
                   peer_processed={a: dict(p) for a, p in
                                   rep.peer_processed.items()})
    return out


def _replicas(mod, kind, n, gc):
    vv = lambda: mod.VersionVector([0] * n)  # noqa: E731
    if kind == "awset":
        return [mod.AWSet(actor=a, version_vector=vv()) for a in range(n)]
    sem, strict = {"v2": ("v2", True), "reference": ("reference", True),
                   "loose": ("reference", False)}[kind]
    return [mod.AWSetDelta(actor=a, version_vector=vv(), delta_semantics=sem,
                           strict_reference_semantics=strict, gc_enabled=gc)
            for a in range(n)]


@pytest.mark.parametrize("kind", ["awset", "v2", "reference", "loose"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_histories_match_the_jax_spec(kind, seed):
    """2-4 actors, adds (several keys a call), deletes, clones and merges
    in any direction, with and without GC: the two packages' replicas
    render, hold and log the same after every step."""
    rng = random.Random(seed * 31 + len(kind))
    n = 2 + seed % 3
    gc = seed % 2 == 1
    ours, theirs = (_replicas(spec, kind, n, gc),
                    _replicas(jax_spec, kind, n, gc))
    keys = [f"k{i}" for i in range(7)] + ["ümlaut", "tab\tkey", "q\"uote"]
    for step in range(150):
        r = rng.randrange(n)
        roll = rng.random()
        if roll < 0.35:
            ks = rng.sample(keys, rng.randint(1, 3))
            ours[r].add(*ks)
            theirs[r].add(*ks)
        elif roll < 0.55:
            ks = rng.sample(keys, rng.randint(1, 2))
            ours[r].del_(*ks)
            theirs[r].del_(*ks)
        elif roll < 0.6:
            ours[r] = ours[r].clone()
            theirs[r] = theirs[r].clone()
        else:
            src = rng.randrange(n)
            ours[r].merge(ours[src])
            theirs[r].merge(theirs[src])
        for a, b in zip(ours, theirs):
            assert _state(a) == _state(b), (step, kind)


def test_go_quote_matches_the_jax_spec():
    samples = ["", "plain", "q\"uote", "back\\slash", "new\nline", "tab\t",
               "\x00\x1f\x7f", "ümlaut", "日本", "​", "\U0001F600",
               "퟿", "\x85\xa0"]
    for s in samples:
        assert spec._go_quote(s) == jax_spec._go_quote(s), repr(s)
    rng = random.Random(5)
    for _ in range(2000):
        s = "".join(chr(rng.choice([rng.randrange(0x80),
                                    rng.randrange(0x80, 0x3000),
                                    rng.randrange(0x10000, 0x10FFFF)]))
                    for _ in range(rng.randint(0, 6)))
        if not 0xD800 <= max(map(ord, s or "a")) < 0xE000:
            assert spec._go_quote(s) == jax_spec._go_quote(s), repr(s)


# -- spec_extra ---------------------------------------------------------------


def _extra_state(obj):
    if isinstance(obj, (spec_extra.ORMap, jax_extra.ORMap)):
        return (str(obj.keys), obj.cells.cells, obj.items())
    if isinstance(obj, (spec_extra.PNCounter, jax_extra.PNCounter)):
        return (obj.p.counts, obj.n.counts, obj.value())
    return {k: v for k, v in vars(obj).items()}


def _extra_op(name, obj, rng, actor):
    roll = rng.random()
    key = f"k{rng.randrange(4)}"
    if name == "GCounter":
        obj.inc(rng.randrange(5))
    elif name == "PNCounter":
        (obj.inc if roll < 0.5 else obj.dec)(rng.randrange(5))
    elif name == "TwoPSet":
        (obj.add if roll < 0.6 else obj.del_)(key)
    elif name == "LWWMap":
        if roll < 0.7:
            obj.put(key, rng.randrange(100), rng.randint(1, 20))
        else:
            obj.delete(key, rng.randint(1, 20))
    elif name == "ORMap":
        if roll < 0.7:
            obj.put(key, rng.randrange(100), rng.randint(1, 20))
        else:
            obj.delete(key)
    else:
        obj.write(rng.randrange(100))


@pytest.mark.parametrize("name", ["GCounter", "PNCounter", "TwoPSet",
                                  "LWWMap", "ORMap", "MVRegister"])
def test_spec_extra_histories_match_the_jax_spec(name):
    n = 3

    def make(mod):
        cls = getattr(mod, name)
        if name == "TwoPSet":
            return [cls() for _ in range(n)]
        if name == "LWWMap":
            return [cls(actor=a) for a in range(n)]
        return [cls(a, n) for a in range(n)]

    ours, theirs = make(spec_extra), make(jax_extra)
    for step in range(200):
        seed = step * 7919
        r = random.Random(seed).randrange(n)
        if random.Random(seed + 1).random() < 0.5:
            _extra_op(name, ours[r], random.Random(seed + 2), r)
            _extra_op(name, theirs[r], random.Random(seed + 2), r)
        else:
            src = random.Random(seed + 3).randrange(n)
            ours[r].merge(ours[src])
            theirs[r].merge(theirs[src])
        for a, b in zip(ours, theirs):
            assert _extra_state(a) == _extra_state(b), (name, step)
