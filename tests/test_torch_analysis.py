"""The port's invariant analyzer suite (go_crdt_playground_tpu_torch/
analysis/), the twin of tests/test_analysis.py.

Semantics pinned here, before any test:

* purity's roots are the kernels' plain versions (every ``*_plain``
  function) and the ctypes launchers (a function calling ``_lib()`` or a
  ``crdt_*`` library entry); the same-module call graph is walked from
  them with the reference's banned prefixes, and a reachable call into
  another scanned module makes the callee a root there; no
  ``jax.debug.*`` allowance;
* the port's transfer names: ``.cpu()``, ``.item()``, ``.tolist()``,
  ``.numpy()``, ``synchronize`` and the host pulls ``to_host`` /
  ``payload_to_host``, with the fixpoint through called helpers;
* the lattice-law pass runs over the port's registry with its per-row
  OR-Map join (the reference's join on a batch reads row 0's clock);
* the protocol models are pinned against the port's own segments
  (tests/test_torch_protomodel.py);
* ``metrics_contract`` adjudicates ``tools/torch_*_soak.py``.

Two halves, as the reference's: the gate is green on the port's tree
(``test_gate_fast`` runs ``--fast --device cpu``), and every pass can
fail on a planted violation.  The source passes shared with the
reference (lock discipline, durability, thread shadowing, epoch order,
fence coverage) are fed the same planted fixtures as the reference's
and must give the same (code, severity, line, symbol); purity and
transfer-under-lock get fixtures in the port's idiom instead."""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from go_crdt_playground_tpu.analysis import durability as jax_durability
from go_crdt_playground_tpu.analysis import epoch_order as jax_epoch_order
from go_crdt_playground_tpu.analysis import \
    fence_coverage as jax_fence_coverage
from go_crdt_playground_tpu.analysis import \
    lockdiscipline as jax_lockdiscipline
from go_crdt_playground_tpu.analysis import \
    thread_shadow as jax_thread_shadow
from go_crdt_playground_tpu.analysis.__main__ import (
    DURABILITY_TARGETS as JAX_DURABILITY_TARGETS)
from go_crdt_playground_tpu.analysis.__main__ import (
    LOCK_TARGETS as JAX_LOCK_TARGETS)
from go_crdt_playground_tpu.analysis.__main__ import (
    PURITY_TARGETS as JAX_PURITY_TARGETS)
from go_crdt_playground_tpu.analysis.__main__ import (
    REGISTERED_PASSES as JAX_REGISTERED_PASSES)
from go_crdt_playground_tpu.analysis.__main__ import (
    TRANSFER_TARGETS as JAX_TRANSFER_TARGETS)
from go_crdt_playground_tpu.analysis.annotations import \
    parse_annotations as jax_parse_annotations
from go_crdt_playground_tpu_torch.analysis import (durability, epoch_order,
                                                   fence_coverage,
                                                   lockdiscipline, purity,
                                                   thread_shadow,
                                                   transfer_lock)
from go_crdt_playground_tpu_torch.analysis import __main__ as gate
from go_crdt_playground_tpu_torch.analysis.annotations import \
    parse_annotations
from go_crdt_playground_tpu_torch.analysis.locksets import RaceDetector
from go_crdt_playground_tpu_torch.analysis.report import Report
from go_crdt_playground_tpu_torch.utils.guards import AlreadyInstalledError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "go_crdt_playground_tpu_torch")


def _key(findings):
    return sorted((f.code, f.severity, f.line, f.symbol) for f in findings)


# ---------------------------------------------------------------------------
# the gate's targets: the reference's, pallas_* -> cuda_*, net/breaker.py
# ---------------------------------------------------------------------------


def test_target_lists_are_the_reference_lists():
    def cuda(paths):
        return [p.replace("/pallas_", "/cuda_") for p in paths]

    assert [p for p in gate.LOCK_TARGETS if p != "net/breaker.py"] == \
        JAX_LOCK_TARGETS
    assert "net/breaker.py" in gate.LOCK_TARGETS
    assert gate.TRANSFER_TARGETS == gate.LOCK_TARGETS + ["net/framing.py"]
    assert [p for p in gate.TRANSFER_TARGETS if p != "net/breaker.py"] == \
        JAX_TRANSFER_TARGETS
    assert gate.PURITY_TARGETS == cuda(JAX_PURITY_TARGETS)
    assert gate.DURABILITY_TARGETS == JAX_DURABILITY_TARGETS
    assert set(gate.REGISTERED_PASSES) == set(JAX_REGISTERED_PASSES)
    for rel in (gate.LOCK_TARGETS + gate.LOCK_ORDER_EXTRA
                + gate.DURABILITY_TARGETS + gate.PURITY_TARGETS):
        assert os.path.exists(os.path.join(PKG, rel)), rel


# ---------------------------------------------------------------------------
# annotation grammar (parsed alike by both packages)
# ---------------------------------------------------------------------------

ANNOTATED = {
    "inline_and_standalone": (
        "class C:\n"
        "    def __init__(self):\n"
        "        self.x = 1  # guarded-by: _lock\n"
        "        # race-ok: owner thread only\n"
        "        self.y = 2\n"),
    "missing_arg": "x = 1  # guarded-by:\n",
    "wrapped_reason": (
        "class C:\n"
        "    def __init__(self):\n"
        "        # race-ok: a reason long enough that the author\n"
        "        # wrapped it onto a second comment line\n"
        "        self.y = 2\n"),
    "blank_line": (
        "class C:\n"
        "    def __init__(self):\n"
        "        # race-ok: reason\n"
        "\n"
        "        self.y = 2\n"),
    "transfer_ok": (
        "def f(t):\n"
        "    # transfer-ok: one bounded pull\n"
        "    return t.cpu()\n"),
}


@pytest.mark.parametrize("name", sorted(ANNOTATED))
def test_annotation_parse_parity(name):
    a = parse_annotations(ANNOTATED[name])
    b = jax_parse_annotations(ANNOTATED[name])
    assert [(x.kind, x.arg, x.line) for x in a.every] == \
        [(x.kind, x.arg, x.line) for x in b.every]
    assert len(a.malformed) == len(b.malformed)


def test_annotation_parse_inline_and_standalone():
    a = parse_annotations(ANNOTATED["inline_and_standalone"])
    assert a.on_lines(3, 3).kind == "guarded-by"
    assert a.on_lines(3, 3).arg == "_lock"
    assert a.on_lines(5, 5).kind == "race-ok"
    assert not a.malformed


def test_annotation_missing_arg_is_malformed_not_silent():
    assert parse_annotations(ANNOTATED["missing_arg"]).malformed


def test_standalone_annotation_skips_continuation_comments():
    got = parse_annotations(ANNOTATED["wrapped_reason"]).on_lines(5, 5)
    assert got is not None and got.kind == "race-ok"


def test_standalone_annotation_skips_blank_line():
    got = parse_annotations(ANNOTATED["blank_line"]).on_lines(5, 5)
    assert got is not None and got.kind == "race-ok"


# ---------------------------------------------------------------------------
# pass 1: lock-discipline lint — the reference's planted fixtures, parity
# ---------------------------------------------------------------------------

LOCK_FIXTURES = {
    "guarded_by": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.x = 0  # guarded-by: _lock\n"
        "    def good(self):\n"
        "        with self._lock:\n"
        "            self.x += 1\n"
        "    def bad(self):\n"
        "        self.x += 1\n"),
    "annassign": (
        "import threading\n"
        "from typing import Optional\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.x: Optional[int] = None  # guarded-by: _lock\n"
        "    def bad(self):\n"
        "        self.x = 5\n"),
    "foreign_name_store": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.x = 0  # guarded-by: _lock\n"
        "    @classmethod\n"
        "    def make(cls):\n"
        "        c = C()\n"
        "        c.x = 5\n"
        "        return c\n"),
    "requires_lock": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.x = 0  # guarded-by: _lock\n"
        "    # requires-lock: _lock\n"
        "    def _mutate(self):\n"
        "        self.x += 1\n"
        "    def good(self):\n"
        "        with self._lock:\n"
        "            self._mutate()\n"
        "    def bad(self):\n"
        "        self._mutate()\n"),
    "order_cycle": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n"
        "    def one(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"
        "    def two(self):\n"
        "        with self._b:\n"
        "            with self._a:\n"
        "                pass\n"),
    "inconsistent": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.n = 0\n"
        "    def locked_bump(self):\n"
        "        with self._lock:\n"
        "            self.n += 1\n"
        "    def bare_bump(self):\n"
        "        self.n += 1\n"),
    "immutable_config": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.cfg = 7\n"
        "        self.n = 0  # guarded-by: _lock\n"
        "    def locked(self):\n"
        "        with self._lock:\n"
        "            self.n = self.cfg\n"
        "    def bare(self):\n"
        "        return self.cfg\n"),
}


def _lint_source(src, module=lockdiscipline, **kw):
    lint = module.LockLint(**kw)
    lint.load_file("<planted>", source=src)
    return lint.run()


@pytest.mark.parametrize("name", sorted(LOCK_FIXTURES))
def test_lockdiscipline_fixture_parity(name):
    got = _lint_source(LOCK_FIXTURES[name])
    want = _lint_source(LOCK_FIXTURES[name], module=jax_lockdiscipline)
    assert _key(got) == _key(want)


def test_guarded_by_violation_detected():
    findings = _lint_source(LOCK_FIXTURES["guarded_by"])
    assert [f for f in findings if f.code == "L001"
            and f.symbol == "C.x" and f.line == 10], findings
    assert not [f for f in findings if f.line == 8]


def test_annotations_attach_to_annassign_statements():
    findings = _lint_source(LOCK_FIXTURES["annassign"])
    assert [f for f in findings if f.code == "L001" and f.line == 8]


def test_foreign_name_store_checked():
    findings = _lint_source(LOCK_FIXTURES["foreign_name_store"])
    assert [f for f in findings if f.code == "L001" and f.line == 9]


def test_requires_lock_call_site_checked():
    bad = [f for f in _lint_source(LOCK_FIXTURES["requires_lock"])
           if f.code == "L001"]
    assert len(bad) == 1 and bad[0].line == 13


def test_lock_order_cycle_detected():
    assert [f for f in _lint_source(LOCK_FIXTURES["order_cycle"])
            if f.code == "L002"]


def test_inconsistently_locked_mutable_field_flagged():
    assert [f for f in _lint_source(LOCK_FIXTURES["inconsistent"])
            if f.code == "L003" and f.symbol == "C.n"]


def test_immutable_config_reads_not_flagged():
    assert not _lint_source(LOCK_FIXTURES["immutable_config"])


def test_same_named_guarded_fields_do_not_collide():
    def run(module):
        lint = module.LockLint(attr_classes={"n": "Node"})
        lint.load_file("<a>", source=(
            "import threading\n"
            "class Node:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._state = 0  # guarded-by: _lock\n"
            "    @classmethod\n"
            "    def restore(cls):\n"
            "        n = cls()\n"
            "        n._state = 1\n"
            "        return n\n"))
        lint.load_file("<b>", source=(
            "import threading\n"
            "class Breaker:\n"
            "    def __init__(self):\n"
            "        self._mu = threading.Lock()\n"
            "        self._state = 'closed'  # guarded-by: _mu\n"
            "    def ok(self):\n"
            "        with self._mu:\n"
            "            self._state = 'open'\n"))
        return lint.run()

    findings = run(lockdiscipline)
    bad = [f for f in findings if f.code == "L001"]
    assert len(bad) == 1 and bad[0].symbol == "Node._state"
    assert "n._lock" in bad[0].message
    assert _key(findings) == _key(run(jax_lockdiscipline))


def test_lock_sweep_covers_the_breaker():
    """net/breaker.py joined the sweep: the port's CircuitBreaker is
    inside it, as the reference's is in net/antientropy.py."""
    lint = lockdiscipline.LockLint(attr_classes=gate.ATTR_CLASSES)
    for rel in gate.LOCK_TARGETS:
        lint.load_file(os.path.join(PKG, rel))
    findings = lint.run()
    assert not [f for f in findings if f.severity == "error"]
    assert "CircuitBreaker" in lint.stats()["classes_by_name"]


# ---------------------------------------------------------------------------
# pass 2: runtime lockset race detector (planted races)
# ---------------------------------------------------------------------------


class _Shared:
    def __init__(self):
        self._lock = threading.Lock()
        self.racy = 0
        self.safe = 0
        self.bag = set()


def _hammer(fn, n_threads=2, iters=300):
    errs = []

    def run():
        try:
            for _ in range(iters):
                fn()
        except BaseException as e:  # pragma: no cover - debug aid
            errs.append(e)

    ts = [threading.Thread(target=run) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs


def test_unlocked_shared_write_reported():
    det = RaceDetector()
    obj = det.instrument(_Shared())

    def work():
        obj.racy += 1
        with obj._lock:
            obj.safe += 1

    _hammer(work)
    symbols = {f.symbol for f in det.findings}
    assert "_Shared.racy" in symbols and "_Shared.safe" not in symbols


def test_container_mutation_via_read_reported():
    det = RaceDetector()
    obj = det.instrument(_Shared())
    _hammer(lambda: obj.bag.add(1))
    assert any(f.symbol == "_Shared.bag" for f in det.findings)


def test_sequential_threads_still_detected():
    det = RaceDetector()
    obj = det.instrument(_Shared())
    for _ in range(2):
        t = threading.Thread(target=lambda: [obj.__setattr__(
            "racy", obj.racy + 1) for _ in range(10)])
        t.start()
        t.join()
    assert any(f.symbol == "_Shared.racy" for f in det.findings)


def test_single_thread_never_reported():
    det = RaceDetector()
    obj = det.instrument(_Shared())
    for _ in range(100):
        obj.racy += 1
        obj.bag.add(1)
    assert not det.findings


def test_double_install_raises_cleanly():
    det = RaceDetector()
    obj = det.instrument(_Shared())
    with pytest.raises(AlreadyInstalledError):
        det.instrument(obj)
    with pytest.raises(AlreadyInstalledError):
        RaceDetector().instrument(obj)
    det.uninstall(obj)
    det.instrument(obj)
    det.uninstall(obj)


def test_uninstall_restores_class_and_locks():
    det = RaceDetector()
    obj = det.instrument(_Shared())
    assert type(obj).__name__ == "Traced_Shared"
    det.uninstall(obj)
    assert type(obj) is _Shared
    assert isinstance(obj._lock, type(threading.Lock()))


def test_unbalanced_uninstall_refuses_without_corrupting():
    det = RaceDetector()
    obj = _Shared()
    with pytest.raises(KeyError):
        det.uninstall(obj)
    assert type(obj) is _Shared


def test_dropped_detector_releases_shim_key():
    import gc

    from go_crdt_playground_tpu_torch.utils.guards import SHIM_GUARD

    det = RaceDetector()
    obj = det.instrument(_Shared())
    key = ("race-detector", id(obj))
    assert SHIM_GUARD.installed(key)
    del det, obj
    gc.collect()
    assert not SHIM_GUARD.installed(key)


def test_property_results_are_not_traced():
    class WithProp:
        def __init__(self):
            self._lock = threading.Lock()
            self._items: list = []  # guarded-by: _lock

        @property
        def items(self):
            with self._lock:
                return list(self._items)

    det = RaceDetector()
    obj = det.instrument(WithProp())
    _hammer(lambda: obj.items)
    assert not det.findings, [f.render() for f in det.findings]


def test_race_ok_annotation_excludes_field():
    class Annotated:
        def __init__(self):
            self._lock = threading.Lock()
            self.noisy = 0  # race-ok: planted benign flag for the test

    det = RaceDetector()
    obj = det.instrument(Annotated())
    _hammer(lambda: setattr(obj, "noisy", obj.noisy + 1))
    assert not det.findings


def test_race_ok_on_annassign_excludes_field_at_runtime():
    from typing import Optional

    from go_crdt_playground_tpu_torch.analysis.locksets import \
        _race_ok_fields

    class AnnAnnotated:
        def __init__(self):
            self._lock = threading.Lock()
            self.flag: Optional[int] = None  # race-ok: planted for test

    assert "flag" in _race_ok_fields(AnnAnnotated)


def test_node_lifecycle_fields_stay_silent_under_detector():
    from go_crdt_playground_tpu_torch.net.peer import Node

    det = RaceDetector()
    node = det.instrument(Node(0, 8, 2, device="cpu"))
    host, port = node.serve()
    s = socket.create_connection((host, port), timeout=2.0)
    time.sleep(0.2)
    s.close()
    node.close()
    assert not det.findings, [f.render() for f in det.findings]


def test_lockset_exercise_drives_ingest_batches():
    """The gate's exercise mutates the node through ``ingest_batch`` as
    well (K10 on the card): the micro-batches land and no race is
    found."""
    report = Report()
    gate.run_lockset_exercise(report, rounds=40, device="cpu")
    stats = report.stats["locksets"]
    assert stats["races"] == 0 and stats["objects_traced"] == 2
    assert not report.findings


# ---------------------------------------------------------------------------
# pass 3a: durability-ordering lint — the reference's fixtures, parity
# ---------------------------------------------------------------------------

DURABILITY_FIXTURES = {
    "unfsynced_rename": (
        "import os\n"
        "def publish(tmp, path):\n"
        "    with open(tmp, 'w') as f:\n"
        "        f.write('data')\n"
        "    os.replace(tmp, path)\n"),
    "fsynced_rename": (
        "import os\n"
        "def publish(tmp, path):\n"
        "    with open(tmp, 'w') as f:\n"
        "        f.write('data')\n"
        "        f.flush()\n"
        "        os.fsync(f.fileno())\n"
        "    os.replace(tmp, path)\n"),
    "durable_on_return": (
        "class W:\n"
        "    # durable-on-return\n"
        "    def append(self, b):\n"
        "        self.f.write(b)\n"
        "        self.f.flush()\n"),
    "helper_fsync": (
        "import os\n"
        "def flush_dir(p):\n"
        "    fd = os.open(p, os.O_RDONLY)\n"
        "    os.fsync(fd)\n"
        "    os.close(fd)\n"
        "def publish(tmp, path):\n"
        "    flush_dir(tmp)\n"
        "    os.replace(tmp, path)\n"),
}


@pytest.mark.parametrize("name", sorted(DURABILITY_FIXTURES))
def test_durability_fixture_parity(name):
    got = durability.analyze_file("<planted>",
                                  source=DURABILITY_FIXTURES[name])
    want = jax_durability.analyze_file("<planted>",
                                       source=DURABILITY_FIXTURES[name])
    assert _key(got[0]) == _key(want[0]) and got[1] == want[1]


def test_unfsynced_rename_detected():
    findings, _ = durability.analyze_file(
        "<planted>", source=DURABILITY_FIXTURES["unfsynced_rename"])
    assert [f for f in findings if f.code == "D001" and f.line == 5]


def test_fsynced_rename_clean():
    findings, _ = durability.analyze_file(
        "<planted>", source=DURABILITY_FIXTURES["fsynced_rename"])
    assert not findings


def test_durable_on_return_without_fsync_detected():
    findings, _ = durability.analyze_file(
        "<planted>", source=DURABILITY_FIXTURES["durable_on_return"])
    assert [f for f in findings if f.code == "D001"
            and f.symbol == "W.append"]


def test_helper_fsync_credited():
    findings, stats = durability.analyze_file(
        "<planted>", source=DURABILITY_FIXTURES["helper_fsync"])
    assert not findings and "flush_dir" in stats["local_fsyncers"]


# ---------------------------------------------------------------------------
# pass 3b: kernel purity — fixtures in the port's idiom
# ---------------------------------------------------------------------------


def test_impure_plain_version_detected():
    findings, stats = purity.analyze_file("<planted>", source=(
        "import time\n"
        "import torch\n"
        "def merge_plain(x):\n"
        "    t = time.time()\n"
        "    return x + t\n"))
    assert [f for f in findings if f.code == "P001" and f.line == 4]
    assert stats["kernel_roots"] == ["merge_plain"]


def test_impurity_in_reachable_helper_detected():
    findings, _ = purity.analyze_file("<planted>", source=(
        "def helper(x):\n"
        "    print(x)\n"
        "    return x\n"
        "def round_plain(x):\n"
        "    return helper(x)\n"))
    assert [f for f in findings if f.code == "P001" and f.symbol == "helper"]


@pytest.mark.parametrize("launch", ["_lib().crdt_merge_round(ptr)",
                                    "lib.crdt_merge_round(ptr)"])
def test_ctypes_launcher_is_a_root(launch):
    findings, stats = purity.analyze_file("<planted>", source=(
        "import random\n"
        "def _launch(ptr, lib):\n"
        "    r = random.random()\n"
        f"    return {launch} + r\n"))
    assert stats["kernel_roots"] == ["_launch"]
    assert [f for f in findings if f.code == "P001"
            and f.symbol == "_launch" and f.line == 3]


def test_global_mutation_in_launcher_detected():
    findings, _ = purity.analyze_file("<planted>", source=(
        "CALLS = 0\n"
        "def _launch(t):\n"
        "    global CALLS\n"
        "    CALLS += 1\n"
        "    return _lib().crdt_x(t)\n"))
    assert [f for f in findings if f.code == "P001" and f.line == 3]


def test_unreachable_impurity_not_flagged():
    findings, stats = purity.analyze_file("<planted>", source=(
        "import time\n"
        "def host_only():\n"
        "    return time.time()\n"
        "def ring_plain(x):\n"
        "    return x * 2\n"))
    assert not findings and stats["reachable_checked"] == 1


def test_wrapper_counts_are_not_roots():
    """An entry's launch count sits in the wrapper, which is neither a
    plain version nor a launcher: counting is host bookkeeping, outside
    what defines the kernel."""
    findings, stats = purity.analyze_file("<planted>", source=(
        "import threading\n"
        "_lock = threading.Lock()\n"
        "def entry(x):\n"
        "    with _lock:\n"
        "        entry.launches += 1\n"
        "    return _launch(x)\n"
        "def _launch(x):\n"
        "    return _lib().crdt_x(x)\n"))
    assert not findings and stats["kernel_roots"] == ["_launch"]


def test_cross_module_callee_becomes_a_root(tmp_path):
    """A plain version built from another scanned module's algebra:
    the callee is a root there, so its impurity is found."""
    ops = tmp_path / "ops"
    ops.mkdir()
    (ops / "algebra.py").write_text(
        "import time\n"
        "def merge_kernel(x):\n"
        "    return x + time.time()\n"
        "def unused(x):\n"
        "    return time.time()\n")
    (ops / "cuda_k.py").write_text(
        "from pkg.ops.algebra import merge_kernel\n"
        "from pkg.ops import algebra as alg\n"
        "def merge_rows_plain(x):\n"
        "    return merge_kernel(x)\n"
        "def other_plain(x):\n"
        "    return alg.merge_kernel(x)\n")
    findings, stats = purity.analyze_files([str(ops / "cuda_k.py"),
                                            str(ops / "algebra.py")])
    assert [(f.symbol, f.line) for f in findings] == [("merge_kernel", 3)]
    assert stats["cross_module_roots"] == 1


def test_port_purity_roots_cover_every_kernel_module():
    findings, stats = purity.analyze_files(
        [os.path.join(PKG, p) for p in gate.PURITY_TARGETS])
    assert not findings, [f.render() for f in findings]
    assert stats["cross_module_roots"] >= 5
    for mod, roots in (("cuda_merge", {"_launch", "_k3_launch",
                                       "merge_rows_plain"}),
                       ("cuda_delta", {"_launch", "_launch_walk",
                                       "delta_round_plain"}),
                       ("cuda_ingest", {"_launch", "ingest_fold_plain"}),
                       ("cuda_digest", {"_launch"})):
        _, s = purity.analyze_file(os.path.join(PKG, "ops", mod + ".py"))
        assert roots <= set(s["kernel_roots"]), (mod, s)


# ---------------------------------------------------------------------------
# pass 4: lattice laws over the port's registry
# ---------------------------------------------------------------------------


def _broken_spec(join_fn, name):
    from go_crdt_playground_tpu_torch.ops import lattices

    base = lattices.JOIN_REGISTRY["gcounter"]
    return lattices.JoinSpec(name, base.sample, join_fn, base.project)


def test_noncommutative_join_detected():
    from go_crdt_playground_tpu_torch.analysis import lattice_laws

    findings, _ = lattice_laws.check_join_spec(
        _broken_spec(lambda dst, src: dst, "left_biased"), seeds=(3,),
        device="cpu")
    assert findings and findings[0].code in ("J001", "J002"), findings


def test_nonidempotent_join_detected():
    from go_crdt_playground_tpu_torch.analysis import lattice_laws

    def summing(dst, src):
        return dst._replace(counts=dst.counts + src.counts)

    findings, _ = lattice_laws.check_join_spec(
        _broken_spec(summing, "summing"), seeds=(3,), device="cpu")
    assert any(f.code == "J003" for f in findings), findings


def test_registry_covers_all_families():
    from go_crdt_playground_tpu_torch.ops import lattices
    from go_crdt_playground_tpu_torch.ops import merge  # noqa: F401

    assert {"gcounter", "pncounter", "twopset", "lwwmap", "mvregister",
            "ormap", "awset_merge"} <= set(lattices.JOIN_REGISTRY)


def test_law_pass_matches_the_reference_registry():
    """Both packages' law passes over their registries: the same
    families, the same declared laws, the same checks, all clean (the
    port's OR-Map join is the per-row join)."""
    from go_crdt_playground_tpu.analysis import \
        lattice_laws as jax_lattice_laws
    from go_crdt_playground_tpu_torch.analysis import lattice_laws

    got, gs = lattice_laws.check_registry((11,), n_ops=24, device="cpu")
    want, ws = jax_lattice_laws.check_registry((11,), n_ops=24)
    assert not got and not want
    assert gs == ws


def test_permuted_indexes_every_field_with_one_permutation():
    import torch

    from go_crdt_playground_tpu_torch.analysis.lattice_laws import _permuted
    from go_crdt_playground_tpu_torch.ops import lattices

    st = lattices.JOIN_REGISTRY["ormap"].sample(
        np.random.default_rng(4), 9, 10, device="cpu")
    perm = np.random.default_rng(8).permutation(9)
    got = _permuted(st, np.random.default_rng(8))
    for x, y in zip(st, got):
        assert torch.equal(x[torch.from_numpy(perm)], y)


def test_awset_join_runs_on_the_pairwise_kernel_entry():
    """The registered AWSet join is K2's entry (``merge_pairwise_rows``):
    on the CPU its plain version, equal to the module's merge."""
    import torch

    from go_crdt_playground_tpu_torch.ops import cuda_merge, lattices
    from go_crdt_playground_tpu_torch.ops import merge

    spec = lattices.JOIN_REGISTRY["awset_merge"]
    st = spec.sample(np.random.default_rng(2), 9, 30, device="cpu")
    src = type(st)(*(x.flip(0) for x in st))
    before = cuda_merge.merge_pairwise_rows.launches
    got = spec.join(st, src)
    want = merge.merge_pairwise(st, src)[0]
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert cuda_merge.merge_pairwise_rows.launches == before  # no card


# ---------------------------------------------------------------------------
# regression tests for the reference's true positives, on the port
# ---------------------------------------------------------------------------


def test_conn_slot_released_when_handler_spawn_fails(monkeypatch):
    from go_crdt_playground_tpu_torch.net import peer as peer_mod

    node = peer_mod.Node(0, 8, 2, max_conns=1, device="cpu")
    host, port = node.serve()
    try:
        real_thread = threading.Thread
        calls = {"n": 0}

        class ExplodingThread:
            def __init__(self, *a, **kw):
                calls["n"] += 1
                raise RuntimeError("planted thread exhaustion")

        monkeypatch.setattr(peer_mod.threading, "Thread", ExplodingThread)
        s = socket.create_connection((host, port), timeout=2.0)
        deadline = time.monotonic() + 5.0
        while calls["n"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        s.close()
        assert calls["n"] > 0
        monkeypatch.setattr(peer_mod.threading, "Thread", real_thread)
        peer = peer_mod.Node(1, 8, 2, device="cpu")
        peer.add(3)
        peer.sync_with((host, port), timeout=5.0)
        assert 3 in node.members()
        peer.close()
    finally:
        node.close()


def test_resync_epoch_fields_are_lock_guarded():
    from go_crdt_playground_tpu_torch.net.peer import Node

    det = RaceDetector()
    node = det.instrument(Node(0, 8, 2, device="cpu"))
    node.full_resync_pending = True

    def toggle():
        for _ in range(100):
            node.clear_full_resync()
            node.full_resync_is_pending()
            node.full_resync_done_for(("127.0.0.1", 1))

    _hammer(toggle)
    assert not [f for f in det.findings if "resync" in (f.symbol or "")]
    det.uninstall(node)


def test_supervisor_round_counter_locked():
    import tempfile

    from go_crdt_playground_tpu_torch.net import Node, SyncSupervisor

    with tempfile.TemporaryDirectory() as d:
        a, b = Node(0, 8, 2, device="cpu"), Node(1, 8, 2, device="cpu")
        with a, b:
            addr = b.serve()
            a.add(1)
            sup = SyncSupervisor(a, [addr], durable_dir=d,
                                 checkpoint_every=1, interval_s=0.0)
            sup.sync_round()
            assert a.generation >= 1
            a.wal.close()


# ---------------------------------------------------------------------------
# T001 and the protocol-verification ladder — the reference's fixtures
# ---------------------------------------------------------------------------

THREAD_BAD = (
    "import threading\n"
    "from threading import Thread\n"
    "class Sampler(Thread):\n"
    "    def __init__(self):\n"
    "        super().__init__(daemon=True)\n"
    "        self._stop = threading.Event()  # breaks join()\n"
    "    def run(self):\n"
    "        pass\n"
    "class Pumper(threading.Thread):\n"
    "    def _bootstrap(self):  # overrides a runtime internal\n"
    "        pass\n"
    "    def start(self):  # shadows start() itself\n"
    "        pass\n")
THREAD_CLEAN = (
    "import threading\n"
    "class Good(threading.Thread):\n"
    "    def __init__(self):\n"
    "        super().__init__()\n"
    "        self._halt = threading.Event()\n"
    "        self.daemon = True\n"
    "        self.name = 'good'\n"
    "    def run(self):\n"
    "        pass\n"
    "class NotAThread:\n"
    "    def __init__(self):\n"
    "        self._stop = 1\n")


def test_thread_shadow_finds_planted_offenders(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "bad.py").write_text(THREAD_BAD)
    (pkg / "clean.py").write_text(THREAD_CLEAN)
    findings, stats = thread_shadow.analyze(str(pkg), extra_dirs=())
    assert stats["thread_subclasses"] == 3
    assert sorted(f.symbol for f in findings) == [
        "Pumper._bootstrap", "Pumper.start", "Sampler._stop"]
    assert all(f.code == "T001" and f.severity == "error"
               for f in findings)
    want, ws = jax_thread_shadow.analyze(str(pkg), extra_dirs=())
    assert _key(findings) == _key(want) and stats == ws
    assert "_stop" in thread_shadow.thread_internal_names()


LADDER_FIXTURES = {
    "epoch_swapped": (
        "epoch_order", "twin.py",
        "class Standby:\n"
        "    def promote(self):\n"
        "        self.announce_epoch()\n"
        "        persist_router_epoch(self.dir, 1, 'sb')\n"
        "        self.serve()\n",
        dict(name="twin", path="twin.py", qualname="Standby.promote",
             before=("persist_router_epoch",),
             after=("announce_epoch", "serve"))),
    "epoch_vanished": (
        "epoch_order", "twin.py", "x = 1\n",
        dict(name="gone", path="twin.py", qualname="Standby.promote",
             before=("persist",), after=("serve",))),
    "fence_unfenced": (
        "fence_coverage", "fe.py",
        "class FE:\n"
        "    def _dispatch(self, t, body):\n"
        "        if t == MSG_OP:\n"
        "            return self._handle_op(body)\n"
        "        if t == MSG_GC:\n"
        "            return self._handle_gc(body)\n"
        "    def _handle_op(self, body):\n"
        "        if self.shard_deposed():\n"
        "            return None\n"
        "        return 1\n"
        "    def _handle_gc(self, body):\n"
        "        return 2\n",
        dict(name="fe", path="fe.py", qualname="FE._dispatch",
             write_verbs=("MSG_OP", "MSG_GC"),
             predicates=("shard_deposed",))),
    "fence_stale_ok": (
        "fence_coverage", "fe.py",
        "class FE:\n"
        "    def _dispatch(self, t, body):\n"
        "        if t == MSG_OP:\n"
        "            return self._handle_op(body)\n"
        "    # fence-ok: stale — the handler fences below\n"
        "    def _handle_op(self, body):\n"
        "        if self.shard_deposed():\n"
        "            return None\n"
        "        return 1\n",
        dict(name="fe", path="fe.py", qualname="FE._dispatch",
             write_verbs=("MSG_OP",), predicates=("shard_deposed",))),
}


def _ladder(name, port=True):
    kind, rel, src, kw = LADDER_FIXTURES[name]
    if kind == "epoch_order":
        mod = epoch_order if port else jax_epoch_order
        spec = mod.OrderSpec(**kw)
    else:
        mod = fence_coverage if port else jax_fence_coverage
        spec = mod.FenceSpec(**kw)
    return mod.analyze("/nowhere", specs=(spec,), sources={rel: src})


@pytest.mark.parametrize("name", sorted(LADDER_FIXTURES))
def test_ladder_fixture_parity(name):
    got, gs = _ladder(name)
    want, ws = _ladder(name, port=False)
    assert _key(got) == _key(want) and gs == ws


def test_epoch_order_swapped_twin_detected():
    f, s = _ladder("epoch_swapped")
    assert len(f) == 1 and f[0].code == "E001"
    assert "announce_epoch" in f[0].symbol and s["ordered_points"] == 2


def test_epoch_order_vanished_function_is_loud():
    f, _ = _ladder("epoch_vanished")
    assert len(f) == 1 and f[0].code == "E001"
    assert "no longer exists" in f[0].message


def test_fence_coverage_unfenced_verb_detected():
    f, s = _ladder("fence_unfenced")
    assert len(f) == 1 and f[0].code == "E002" and "MSG_GC" in f[0].symbol
    assert s["covered"] == 1


def test_fence_coverage_stale_annotation_detected():
    f, _ = _ladder("fence_stale_ok")
    assert len(f) == 1 and f[0].code == "E002"
    assert "stale fence-ok" in f[0].message


# ---------------------------------------------------------------------------
# D002: transfer under lock — fixtures in the port's idiom
# ---------------------------------------------------------------------------

LOCKED_PULL = (
    "import torch\n"
    "class T:\n"
    "    def pull(self):\n"
    "        with self._lock:\n"
    "            x = self._state.cpu()\n"
    "        return x\n")


def test_transfer_under_lock_detected_and_annotation_clears():
    f, s = transfer_lock.analyze_paths(["t.py"],
                                       sources={"t.py": LOCKED_PULL})
    assert len(f) == 1 and f[0].code == "D002" and f[0].line == 5
    assert s["lock_held"] == 1 and s["transfer_ok"] == 0
    ok = LOCKED_PULL.replace(
        "            x = self._state.cpu()",
        "            # transfer-ok: one bounded pull\n"
        "            x = self._state.cpu()")
    f2, s2 = transfer_lock.analyze_paths(["t.py"], sources={"t.py": ok})
    assert not f2 and s2["transfer_ok"] == 1


@pytest.mark.parametrize("call", ["t.item()", "t.tolist()",
                                  "t.cpu().numpy()",
                                  "torch.cuda.synchronize()",
                                  "self._done.synchronize()",
                                  "to_host(self._state)",
                                  "payload_to_host(parts)"])
def test_every_port_transfer_name_is_caught(call):
    src = ("class T:\n"
           "    def pull(self, t, parts):\n"
           "        with self._lock:\n"
           f"            return {call}\n")
    f, s = transfer_lock.analyze_paths(["t.py"], sources={"t.py": src})
    assert f and all(x.code == "D002" and x.line == 4 for x in f)
    assert s["transfer_calls"] == s["lock_held"] == len(f)


def test_transfer_outside_any_lock_is_not_flagged():
    src = ("def f(t):\n"
           "    return t.cpu().item()\n"
           "class T:\n"
           "    def pull(self):\n"
           "        with self._lock:\n"
           "            st = self._state\n"
           "        return st.tolist()\n")
    f, s = transfer_lock.analyze_paths(["t.py"], sources={"t.py": src})
    assert not f and s["transfer_calls"] == 3 and s["lock_held"] == 0


def test_transfer_lock_fixpoint_reaches_called_helper():
    src = ("from go_crdt_playground_tpu_torch._host import to_host\n"
           "def encode(state):\n"
           "    return to_host(state)\n"
           "class T:\n"
           "    def append(self):\n"
           "        with self._lock:\n"
           "            return encode(self._state)\n")
    f, s = transfer_lock.analyze_paths(["t.py"], sources={"t.py": src})
    assert len(f) == 1 and f[0].code == "D002" and f[0].symbol == "encode"
    assert s["lock_context_fns"] >= 1


def test_port_transfers_under_lock_are_all_sanctioned():
    """Every blocking pull the sweep finds under a lock on the port's
    tree carries a transfer-ok; the 2-D planner's pull runs before the
    node lock is taken."""
    f, s = transfer_lock.analyze(PKG, gate.TRANSFER_TARGETS)
    assert not f, [x.render() for x in f]
    assert s["transfer_ok"] == s["lock_held"] >= 15
    assert s["files"] == len(gate.TRANSFER_TARGETS)


# ---------------------------------------------------------------------------
# the gate itself
# ---------------------------------------------------------------------------


def test_source_loader_caches_and_bypasses_for_planted():
    from go_crdt_playground_tpu_torch.analysis.loader import SourceLoader

    loader = SourceLoader()
    p = os.path.join(gate.PKG_ROOT, "utils", "wal.py")
    a = loader.load(p)
    assert loader.load(p).tree is a.tree
    assert loader.stats() == {"files": 1, "hits": 1, "misses": 1}
    assert loader.load(p, "x = 1\n").source == "x = 1\n"
    assert loader.load(p).tree is a.tree
    assert loader.stats()["files"] == 1


def test_gate_needs_a_gpu_by_default(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is served")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        gate.main(["--fast", "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def test_gate_fast(tmp_path):
    """The tier-1 hook: ``--fast --device cpu`` exits 0 on the port's
    tree, covers all 14 passes, and stays under FAST_BUDGET_S."""
    out = str(tmp_path / "ANALYSIS_REPORT_TORCH.json")
    rc = gate.main(["--fast", "--device", "cpu", "--out", out])
    with open(out) as f:
        report = json.load(f)
    assert rc == 0, report
    assert report["ok"] and report["n_errors"] == 0
    assert sorted(report["passes"]) == sorted(gate.REGISTERED_PASSES)
    assert len(report["passes"]) == 14
    meta = report["meta"]
    assert meta["fast"] is True and meta["device"] == "cpu"
    assert 0 < meta["wall_time_s"] < gate.FAST_BUDGET_S, meta
    assert meta["parse_cache"]["hits"] > meta["parse_cache"]["files"]
    stats = {k: v["stats"] for k, v in report["passes"].items()}
    assert stats["locksets"]["fields_tracked"] > 0
    covered = set(stats["lockdiscipline"]["classes_by_name"])
    assert {"AdmissionQueue", "Session", "MicroBatcher", "ServeFrontend",
            "ServeClient", "HashRing", "ShardRouter", "_ShardLink",
            "_Relay", "ShardFleet", "HandoffCoordinator", "RouteState",
            "ConnHost", "CompactionScheduler", "DigestNegotiator",
            "MeshApplyTarget", "Mesh2DApplyTarget", "FleetAutopilot",
            "AutopilotPolicy", "ReshardActuator", "FleetSignals",
            "StandbyPool", "RouterStandby", "ReplicationPublisher",
            "ShardStandby", "DegradeWindow", "ConflictScheduler",
            "CircuitBreaker"} <= covered, covered
    ts = stats["thread_shadow"]
    assert ts["thread_subclasses"] >= 3 and ts["files_scanned"] > 50
    pc = stats["protocol_contract"]
    assert set(pc["dispatchers"]) == {"frontend", "router", "peer",
                                      "serve-client"}
    assert pc["recv_frame_sites"] >= 9 and pc["codes"] >= 9
    cs = stats["codec_symmetry"]
    assert cs["codecs"] >= 29 and cs["codec_functions"] >= 48, cs
    mc = stats["metrics_contract"]
    assert mc["emitted"] >= 60 and mc["referenced"] >= 20, mc
    laws = stats["lattice_laws"]["laws_by_family"]
    assert laws["tensor_mean"] == ["commutativity"]
    assert "awset_merge" in laws and "ormap" in laws
    assert set(stats["report_freshness"]["registered"]) == \
        set(report["passes"])
    assert stats["purity"]["kernel_roots"] >= 10
    fc = stats["fence_coverage"]
    assert fc["write_verbs"] >= 9 and fc["fence_ok"] == 3
    tl = stats["transfer_lock"]
    assert tl["transfer_ok"] == tl["lock_held"] >= 15
    pm = stats["protomodel"]
    assert set(pm["models"]) == {"router_ha", "shard_repl", "handoff"}
    for m in pm["models"].values():
        assert m["complete"] and m["violations"] == 0
    assert pm["fresh"] == pm["mirrored_symbols"] >= 10


def test_committed_report_is_fresh():
    """ANALYSIS_REPORT_TORCH.json at the repo root: the registered pass
    list, clean; ANALYSIS_REPORT.json stays the reference's."""
    with open(os.path.join(REPO, "ANALYSIS_REPORT_TORCH.json")) as f:
        committed = json.load(f)
    assert sorted(committed["passes"]) == sorted(gate.REGISTERED_PASSES)
    assert committed["ok"] and committed["n_errors"] == 0
    assert committed["meta"]["fast"] is False
    report = Report()
    gate.check_report_freshness(
        report, os.path.join(REPO, "ANALYSIS_REPORT_TORCH.json"))
    assert not report.errors()


def test_report_shape_roundtrips(tmp_path):
    from go_crdt_playground_tpu_torch.analysis.report import Finding

    r = Report()
    r.add_stats("demo", files=1)
    r.extend([Finding(analyzer="demo", code="X001", severity="error",
                      message="planted", path="p.py", line=3)])
    out = tmp_path / "r.json"
    r.write_json(str(out))
    d = json.loads(out.read_text())
    assert d["ok"] is False and d["n_errors"] == 1
    assert d["passes"]["demo"]["findings"][0]["line"] == 3
