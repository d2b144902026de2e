"""The port's wire-contract passes (go_crdt_playground_tpu_torch/
analysis: protocol_contract W001/W002/W004, codec_symmetry W003,
metrics_contract M001), the twin of tests/test_protocol_contract.py.

The W003 harness runs over the port's whole codec registry (its payload
codecs on the native and the Python codec, payloads as int32 tensors
holding uint32 bits); every planted violation fires on the port's
passes, and each planted fixture gives the same findings (code,
severity, line, symbol) from both packages' passes."""

import json
import os

import numpy as np
import pytest

from go_crdt_playground_tpu.analysis import \
    metrics_contract as jax_metrics_contract
from go_crdt_playground_tpu.analysis import \
    protocol_contract as jax_protocol_contract
from go_crdt_playground_tpu_torch.analysis import (codec_symmetry,
                                                   metrics_contract,
                                                   protocol_contract)
from go_crdt_playground_tpu_torch.analysis.codec_symmetry import (
    CodecSpec, build_codecs, check_codec)
from go_crdt_playground_tpu_torch.net.framing import ProtocolError
from go_crdt_playground_tpu_torch.serve import protocol
from tests.test_protocol_contract import _PLANTED_DIALECT, _varint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "go_crdt_playground_tpu_torch")


def _key(findings):
    return sorted((f.code, f.severity, f.line, f.symbol) for f in findings)


# ---------------------------------------------------------------------------
# W003 harness, standalone over the port's registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", build_codecs(), ids=lambda s: s.name)
def test_codec_contract(spec):
    rng = np.random.default_rng(1234)
    findings = check_codec(spec, rng, n_samples=3, n_garbles=12)
    assert not findings, [f.render() for f in findings]


def test_registry_covers_every_wire_module_codec():
    findings, stats = codec_symmetry.check_coverage(PKG, build_codecs())
    assert not findings, [f.render() for f in findings]
    assert stats["codec_functions"] >= 40


def test_registry_is_the_reference_plus_the_python_payload_codec():
    from go_crdt_playground_tpu.analysis import \
        codec_symmetry as jax_codec_symmetry

    names = {s.name for s in build_codecs()}
    ref = {s.name for s in jax_codec_symmetry.build_codecs()}
    assert names == ref | {"payload_py"}


def test_payload_codecs_agree_native_and_python():
    from go_crdt_playground_tpu_torch.utils import wire

    rng = np.random.default_rng(5)
    for _ in range(6):
        payload = codec_symmetry._canonical_payload(rng)
        body = wire.encode_payload(payload)
        assert body == wire.encode_payload(payload, prefer_native=False)
        a = wire.decode_payload(body, codec_symmetry.E, codec_symmetry.A)
        b = wire.decode_payload(body, codec_symmetry.E, codec_symmetry.A,
                                prefer_native=False)
        assert codec_symmetry._payload_eq(a, b)


# ---------------------------------------------------------------------------
# Hand-crafted adversarial vectors on the port's decoders
# ---------------------------------------------------------------------------


def test_members_vv_entry_over_uint32_is_typed():
    body = _varint(7) + _varint(0) + _varint(1) + _varint(1 << 32)
    with pytest.raises(ProtocolError):
        protocol.decode_members(body)


def test_frontier_reply_oversized_count_is_typed():
    body = _varint(7) + bytes([0]) + _varint(1 << 40)
    with pytest.raises(ProtocolError):
        protocol.decode_frontier_reply(body)


def test_lane_section_claims_more_lanes_than_universe():
    from go_crdt_playground_tpu_torch.utils import wire

    E, A = 8, 2
    body = (_varint(E) + wire._encode_vv_py(np.zeros(A, np.uint32))
            + _varint(E + 1))
    with pytest.raises(ValueError):
        wire.decode_payload_lanes(body, E, A)


def test_lane_id_outside_universe_is_typed():
    from go_crdt_playground_tpu_torch.utils import wire

    E, A = 8, 2
    body = (_varint(E) + wire._encode_vv_py(np.zeros(A, np.uint32))
            + _varint(1) + _varint(E) + _varint(0) + _varint(1)
            + _varint(0))
    with pytest.raises(ValueError):
        wire.decode_payload_lanes(body, E, A)


def test_summary_digest_count_mismatch_is_typed():
    from go_crdt_playground_tpu_torch.net import digestsync

    E, A, GS = 16, 4, 4
    zeros = np.zeros(A, np.uint32)
    digestsync.decode_summary(digestsync.encode_summary(
        0, E, GS, zeros, zeros, np.zeros(4, np.uint32)), E, A)
    bad = digestsync.encode_summary(0, E, GS, zeros, zeros,
                                    np.zeros(3, np.uint32))
    with pytest.raises(ProtocolError):
        digestsync.decode_summary(bad, E, A)


# ---------------------------------------------------------------------------
# Seeded injections: every pass fires, as the reference's does
# ---------------------------------------------------------------------------


def test_w003_detects_asymmetric_codec():
    spec = CodecSpec(
        name="planted-asym",
        encode=lambda a, b: bytes([a, b]),
        decode=lambda body: (body[0], 0) if len(body) == 2
        else (_ for _ in ()).throw(ValueError("short")),
        gen=lambda rng: (int(rng.integers(1, 100)),
                         int(rng.integers(1, 100))),
        expected=lambda args: args,
        typed_errors=(ValueError,), covers=())
    findings = check_codec(spec, np.random.default_rng(0), n_samples=2,
                           n_garbles=2)
    assert any("roundtrip mismatch" in f.message for f in findings)


def test_w003_detects_untyped_decoder_error():
    spec = CodecSpec(
        name="planted-untyped",
        encode=lambda v: _varint(v) + bytes(2),
        decode=lambda body: (body[0], body[1], body[2]),
        gen=lambda rng: (int(rng.integers(0, 50)),),
        expected=lambda args: None,
        typed_errors=(ValueError,), covers=(),
        compare=lambda got, want: True)
    findings = check_codec(spec, np.random.default_rng(0), n_samples=1,
                           n_garbles=0)
    assert any("UNTYPED IndexError" in f.message for f in findings)


def _plant(tmp_path, source):
    (tmp_path / "planted.py").write_text(source)
    return str(tmp_path), "planted.py"


def _specs(module, rel):
    return (
        module.DispatcherSpec("planted", rel, "D._dispatch", (rel,),
                              "server", "MSG_ERROR"),
        module.DispatcherSpec("planted-client", rel, "D._read_loop",
                              (rel,), "client", "ProtocolError"),
    )


# each W001 fixture: (the planted dialect's edits, spec slice)
W001_FIXTURES = {
    "deleted_arm": ([], slice(None)),
    "annotated_hole": ([("        session.send(framing.MSG_ERROR",
                         "        # protocol-ignore: MSG_B — planted "
                         "exclusion\n        session.send(framing.MSG_ERROR"
                         )], slice(None)),
    "stale_ignore": ([("        if msg_type == MSG_A:",
                       "        # protocol-ignore: MSG_A — planted stale "
                       "ignore\n        if msg_type == MSG_A:")],
                     slice(None)),
    "lost_fallthrough": ([('        session.send(framing.MSG_ERROR, b"?")\n',
                           ""), ("MSG_B = 2\n", "")], slice(0, 1)),
    "reply_needs_client_arm": ([
        ("        if msg_type == MSG_R:\n"
         "            return framing.ProtocolError\n",
         "        del msg_type\n"),
        ("    def _read_loop(self):\n",
         "    def _read_loop(self):\n"
         "        err = framing.ProtocolError\n")], slice(1, None)),
}


def _w001(module, tmp_path, name):
    edits, sl = W001_FIXTURES[name]
    src = _PLANTED_DIALECT.replace("go_crdt_playground_tpu.",
                                   "go_crdt_playground_tpu_torch.")
    for a, b in edits:
        src = src.replace(a, b)
    root, rel = _plant(tmp_path, src)
    return module.check_dispatchers(root, _specs(module, rel)[sl])


@pytest.mark.parametrize("name", sorted(W001_FIXTURES))
def test_w001_fixture_parity(name, tmp_path):
    """The same planted dialect, fed to both packages' W001 pass: the
    same findings."""
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got, _ = _w001(protocol_contract, tmp_path / "port", name)
    want, _ = _w001(jax_protocol_contract, tmp_path / "ref", name)
    assert _key(got) == _key(want)


def test_w001_detects_deleted_dispatch_arm(tmp_path):
    findings, stats = _w001(protocol_contract, tmp_path, "deleted_arm")
    holes = [f for f in findings if "no handler arm" in f.message]
    assert len(holes) == 1 and "MSG_B" in holes[0].symbol
    assert stats["dispatchers"]["planted-client"]["required"] == ["MSG_R"]


def test_w001_annotated_hole_is_clean(tmp_path):
    findings, _ = _w001(protocol_contract, tmp_path, "annotated_hole")
    assert not findings, [f.render() for f in findings]


def test_w001_stale_ignore_is_a_finding(tmp_path):
    findings, _ = _w001(protocol_contract, tmp_path, "stale_ignore")
    assert any("stale protocol-ignore" in f.message for f in findings)


def test_w001_lost_fallthrough_is_a_finding(tmp_path):
    findings, _ = _w001(protocol_contract, tmp_path, "lost_fallthrough")
    assert any("fallthrough" in f.message for f in findings)


def test_w001_reply_constant_needs_client_arm(tmp_path):
    findings, _ = _w001(protocol_contract, tmp_path,
                        "reply_needs_client_arm")
    assert any("MSG_R" in (f.symbol or "") for f in findings)


def test_w002_registry_bijection_holds():
    findings, stats = protocol_contract.check_reject_registry()
    assert not findings, [f.render() for f in findings]
    assert stats["codes"] == stats["constants"] == \
        stats["exception_classes"] >= 6
    assert stats == jax_protocol_contract.check_reject_registry()[1]


PLANTED_CALL_SITES = {
    "reject": (
        "from go_crdt_playground_tpu_torch.serve import protocol\n"
        "def f(session, req_id):\n"
        "    session.send(18, protocol.encode_reject(req_id, 99, 'x'))\n"
        "    session.send(18, protocol.encode_reject(\n"
        "        req_id, protocol.REJECT_BOGUS, 'y'))\n"
        "    return protocol.encode_reject(req_id, code=99, reason='x')\n"),
    "recv": (
        "from go_crdt_playground_tpu_torch.net import framing\n"
        "from ..net import framing as rel_framing\n"
        "from .framing import recv_frame\n"
        "def f(sock):\n"
        "    framing.recv_frame(sock)\n"
        "    framing.recv_frame(sock, timeout=1.0)\n"
        "    framing.recv_frame(sock, 1.0, 4096)\n"
        "    framing.recv_frame(sock, max_body=4096)\n"
        "    rel_framing.recv_frame(sock)\n"
        "    recv_frame(sock)\n"),
    "foreign": ("def recv_frame(sock):\n"
                "    return 0, b''\n"
                "def f(sock):\n"
                "    recv_frame(sock)\n"),
}


@pytest.mark.parametrize("name", sorted(PLANTED_CALL_SITES))
def test_call_site_fixture_parity(name, tmp_path):
    """W002's and W004's call-site lints on the same planted module:
    the same findings and site counts from both packages."""
    mod = tmp_path / f"planted_{name}.py"
    mod.write_text(PLANTED_CALL_SITES[name])
    for check in ("check_reject_call_sites", "check_frame_caps"):
        got = getattr(protocol_contract, check)([str(mod)])
        want = getattr(jax_protocol_contract, check)([str(mod)])
        assert _key(got[0]) == _key(want[0]) and got[1] == want[1], check


def test_w002_detects_unregistered_reject_code(tmp_path):
    mod = tmp_path / "planted_reject.py"
    mod.write_text(PLANTED_CALL_SITES["reject"])
    findings, stats = protocol_contract.check_reject_call_sites([str(mod)])
    msgs = [f.message for f in findings]
    assert sum("bare literal" in m for m in msgs) == 2  # positional, code=
    assert any("REJECT_BOGUS" in m for m in msgs)
    assert stats["reject_sites"] == 3


def test_w004_detects_bare_recv_frame(tmp_path):
    mod = tmp_path / "planted_recv.py"
    mod.write_text(PLANTED_CALL_SITES["recv"])
    findings, stats = protocol_contract.check_frame_caps([str(mod)])
    # two bare absolute reads, and the relative forms are not exempt
    assert len(findings) == 4 and stats["recv_frame_sites"] == 6


def test_w004_ignores_foreign_recv_frame(tmp_path):
    mod = tmp_path / "own_framing.py"
    mod.write_text(PLANTED_CALL_SITES["foreign"])
    findings, stats = protocol_contract.check_frame_caps([str(mod)])
    assert not findings and stats["recv_frame_sites"] == 0


def test_w004_package_has_no_bare_recv_frame():
    py_files = []
    for dirpath, _d, filenames in os.walk(PKG):
        if "__pycache__" in dirpath:
            continue
        py_files.extend(os.path.join(dirpath, fn) for fn in filenames
                        if fn.endswith(".py"))
    findings, stats = protocol_contract.check_frame_caps(py_files)
    assert not findings, [f.render() for f in findings]
    assert stats["recv_frame_sites"] >= 9


M001_FIXTURES = {
    "phantom": ("def f(recorder):\n"
                "    recorder.count('serve.real.metric')\n",
                "def adjudicate(counters):\n"
                "    assert counters.get('serve.phantom.metric', 0) > 0\n"
                "    assert counters.get('serve.real.metric', 0) > 0\n",
                "`serve.real.metric` is documented.\n"),
    "fstring": ("def f(recorder, cls):\n"
                "    recorder.count(f'sync.failures.{cls}')\n",
                "NAME = 'sync.failures.remote'\n",
                "`sync.failures.<class>` per failure class.\n"),
    "undocumented": ("def f(recorder):\n"
                     "    recorder.count('serve.undocumented.metric')\n",
                     None, "nothing here\n"),
    # the port's own emission shape: one literal call a name, no loop
    "wal_replay": ("def replay(self, n):\n"
                   "    if n:\n"
                   "        self.recorder.count('wal.records', n)\n"
                   "    for name, k in (('wal.bad_records', n),):\n"
                   "        self.recorder.count(name, k)\n",
                   "WANT = ('wal.records', 'wal.bad_records')\n",
                   "`wal.records` `wal.bad_records`\n"),
}


def _m001(module, tmp_path, name):
    pkg_src, tool_src, doc_src = M001_FIXTURES[name]
    (tmp_path / "pkg.py").write_text(pkg_src)
    tools = []
    if tool_src is not None:
        (tmp_path / "planted_soak.py").write_text(tool_src)
        tools = [str(tmp_path / "planted_soak.py")]
    (tmp_path / "DESIGN.md").write_text(doc_src)
    return module.check([str(tmp_path / "pkg.py")], tools,
                        [str(tmp_path / "DESIGN.md")])


@pytest.mark.parametrize("name", sorted(M001_FIXTURES))
def test_m001_fixture_parity(name, tmp_path):
    got, gs = _m001(metrics_contract, tmp_path, name)
    want, ws = _m001(jax_metrics_contract, tmp_path, name)
    assert _key(got) == _key(want) and gs == ws


def test_m001_detects_phantom_metric(tmp_path):
    findings, _ = _m001(metrics_contract, tmp_path, "phantom")
    errs = [f for f in findings if f.severity == "error"]
    assert len(errs) == 1 and errs[0].symbol == "serve.phantom.metric"


def test_m001_fstring_pattern_covers_classified_reference(tmp_path):
    findings, _ = _m001(metrics_contract, tmp_path, "fstring")
    assert not findings, [f.render() for f in findings]


def test_m001_undocumented_emission_is_a_warning(tmp_path):
    findings, _ = _m001(metrics_contract, tmp_path, "undocumented")
    assert len(findings) == 1 and findings[0].severity == "warning"
    assert findings[0].symbol == "serve.undocumented.metric"


def test_m001_loop_emission_is_a_phantom(tmp_path):
    """Why the port's WAL replay counters are literal calls: a name
    emitted through a loop variable is invisible to the pass, so a soak
    that adjudicates it reads a phantom."""
    findings, _ = _m001(metrics_contract, tmp_path, "wal_replay")
    assert [f.symbol for f in findings] == ["wal.bad_records"]


def test_m001_port_emits_the_wal_replay_counters():
    from go_crdt_playground_tpu_torch.net import peer

    emitted = metrics_contract.emitted_patterns([peer.__file__])
    for name in ("wal.records", "wal.replayed_compact", "wal.replayed_dense",
                 "wal.bad_records", "wal.future_records"):
        assert name in emitted, name


def test_m001_scopes_the_ports_soaks_only():
    """The port's metrics contract adjudicates tools/torch_*_soak.py,
    and the differential soak is not named *_soak.py (the reference's
    contract globs that pattern)."""
    _, stats = metrics_contract.analyze(PKG)
    assert stats["referenced"] > 0
    import fnmatch

    soaks = [t for t in os.listdir(os.path.join(REPO, "tools"))
             if fnmatch.fnmatch(t, "torch_*_soak.py")]
    assert "torch_serve_soak.py" in soaks
    assert os.path.exists(os.path.join(REPO, "tools",
                                       "torch_soak_differential.py"))
    assert not fnmatch.fnmatch("torch_soak_differential.py", "*_soak.py")


def test_annotation_kinds_do_not_shadow_on_one_statement():
    from go_crdt_playground_tpu_torch.analysis.annotations import (
        KIND_GUARDED_BY, KIND_PROTOCOL_IGNORE, parse_annotations)

    src = ("class C:\n"
           "    def __init__(self):\n"
           "        # guarded-by: _lock\n"
           "        self.x = 1  # protocol-ignore: reply — planted\n")
    a = parse_annotations(src)
    assert a.on_lines(4, 4, KIND_GUARDED_BY).arg == "_lock"
    assert a.on_lines(4, 4, KIND_PROTOCOL_IGNORE).arg.startswith("reply")


def test_report_freshness_regeneration_run_is_clean(tmp_path):
    from go_crdt_playground_tpu_torch.analysis.__main__ import main

    path = tmp_path / "ANALYSIS_REPORT_TORCH.json"
    path.write_text(json.dumps({"passes": {"only": {}}}))
    rc = main(["--fast", "--skip-runtime", "--device", "cpu", "--out",
               str(path), "--committed-report", str(path)])
    assert rc == 0
    fresh = json.loads(path.read_text())
    assert fresh["ok"] and fresh["n_findings"] == 0
    assert fresh["passes"]["report_freshness"]["stats"]["mode"] == \
        "regenerating"


def test_report_freshness_detects_stale_pass_list(tmp_path):
    from go_crdt_playground_tpu_torch.analysis.__main__ import (
        REGISTERED_PASSES, check_report_freshness)
    from go_crdt_playground_tpu_torch.analysis.report import Report

    path = tmp_path / "ANALYSIS_REPORT_TORCH.json"
    path.write_text(json.dumps({"passes": {
        name: {} for name in REGISTERED_PASSES if name != "purity"}}))
    report = Report()
    check_report_freshness(report, str(path))
    assert report.errors() and "stale" in report.errors()[0].message
    assert "go_crdt_playground_tpu_torch.analysis" in \
        report.errors()[0].message
    path.write_text(json.dumps({"passes": {n: {}
                                           for n in REGISTERED_PASSES}}))
    report2 = Report()
    check_report_freshness(report2, str(path))
    assert not report2.errors()


# ---------------------------------------------------------------------------
# The real tree is clean
# ---------------------------------------------------------------------------


def test_real_dispatchers_are_exhaustive():
    findings, stats = protocol_contract.check_dispatchers(PKG)
    assert not findings, [f.render() for f in findings]
    _, ref = jax_protocol_contract.check_dispatchers(
        os.path.join(REPO, "go_crdt_playground_tpu"))
    assert stats["dispatchers"] == ref["dispatchers"]
    assert stats["dialect_constants"] == ref["dialect_constants"]


def test_msg_error_is_consumed_below_dispatch():
    """W001's finding on the port's peer dialect, resolved as the
    reference resolves it: MSG_ERROR carries its protocol-ignore."""
    from go_crdt_playground_tpu_torch.analysis.loader import SourceLoader

    info = protocol_contract._load_dialect(
        os.path.join(PKG, "net", "framing.py"), SourceLoader())
    assert info.ignored["MSG_ERROR"][0] == "internal"
