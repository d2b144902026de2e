"""The tooling half of the port's analysis gate: the repo-root
``tools/torch_analyze.py`` wrapper in lockstep with the module CLI
(``python -m go_crdt_playground_tpu_torch.analysis``), the ``--json``
summary contract, the ``--device`` default, and the ``--fast`` wall-time
envelope — the twin of tests/test_analysis_ci.py."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPER = os.path.join(REPO, "tools", "torch_analyze.py")


def _run(argv, timeout=600):
    return subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def test_wrapper_and_module_cli_write_the_same_report(tmp_path):
    """Same flags, same report (wall times and the report's own path
    aside), through the wrapper and through ``python -m``."""
    reports = []
    for i, head in enumerate(([sys.executable, WRAPPER],
                              [sys.executable, "-m",
                               "go_crdt_playground_tpu_torch.analysis"])):
        out = str(tmp_path / f"r{i}.json")
        proc = _run(head + ["--fast", "--skip-runtime", "--device", "cpu",
                            "--out", out])
        assert proc.returncode == 0, proc.stdout + proc.stderr
        with open(out) as f:
            reports.append(json.load(f))
    for r in reports:
        r["meta"].pop("wall_time_s")
    assert reports[0] == reports[1]
    assert reports[0]["passes"]["locksets"]["stats"]["mode"] == "skipped"


def test_wrapper_defaults_the_report_to_the_repo_root():
    """Without --out the wrapper targets ANALYSIS_REPORT_TORCH.json at
    the repo root (the reference's wrapper targets ANALYSIS_REPORT.json,
    which the port never writes)."""
    src = open(WRAPPER).read()
    assert '"ANALYSIS_REPORT_TORCH.json"' in src
    assert "ANALYSIS_REPORT.json" not in src
    from go_crdt_playground_tpu_torch.analysis import __main__ as gate

    assert "ANALYSIS_REPORT_TORCH.json" in gate.__doc__


def test_gate_json_summary_contract(tmp_path):
    out = str(tmp_path / "rep.json")
    stale = tmp_path / "stale_committed.json"
    stale.write_text(json.dumps({"passes": {"lockdiscipline": {}}}))
    base = [sys.executable, WRAPPER, "--fast", "--skip-runtime",
            "--device", "cpu", "--json", "--out", out]
    ok = _run(base)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    lines = [ln for ln in ok.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, ok.stdout
    summary = json.loads(lines[0])
    assert summary["ok"] is True and summary["errors"] == 0
    assert summary["model_states"] > 0 and summary["device"] == "cpu"
    assert summary["out"] == out and len(summary["passes"]) == 14
    bad = _run(base + ["--committed-report", str(stale)])
    assert bad.returncode == 1, bad.stdout + bad.stderr
    summary = json.loads(bad.stdout.strip().splitlines()[-1])
    assert summary["ok"] is False and summary["errors"] >= 1


def test_gate_defaults_to_cuda_and_raises_without_a_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a GPU is present: the default device is served")
    out = tmp_path / "rep.json"
    proc = _run([sys.executable, WRAPPER, "--fast", "--out", str(out)])
    assert proc.returncode != 0
    assert "no CUDA GPU" in proc.stderr
    assert not out.exists()


def test_gate_fast_stays_under_budget(tmp_path):
    from go_crdt_playground_tpu_torch.analysis.__main__ import (
        FAST_BUDGET_S, main)

    out = str(tmp_path / "rep.json")
    assert main(["--fast", "--device", "cpu", "--out", out]) == 0
    with open(out) as f:
        meta = json.load(f)["meta"]
    assert meta["fast_budget_s"] == FAST_BUDGET_S
    assert meta["wall_time_s"] < FAST_BUDGET_S, meta


def test_reference_report_is_not_touched_by_the_port(tmp_path):
    """The port's gate never writes the reference's committed report."""
    path = os.path.join(REPO, "ANALYSIS_REPORT.json")
    before = os.stat(path).st_mtime_ns, open(path).read()
    proc = _run([sys.executable, WRAPPER, "--fast", "--skip-runtime",
                 "--device", "cpu", "--out", str(tmp_path / "r.json")])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (os.stat(path).st_mtime_ns, open(path).read()) == before
