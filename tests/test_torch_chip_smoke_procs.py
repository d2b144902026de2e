"""chip_smoke.py's process guard on the CPU: the parent run is its
descendants' subreaper, fails a phase that leaves a process alive
(naming each pid and command line), kills and reaps every descendant on
the way out, and prints ``processes: 0 alive`` before the ``kernels``
line.  Each case runs ``main()`` in a child interpreter with the phases
stubbed and a stand-in ``torch`` that reports a card, so no CUDA is
touched and the test process never becomes a subreaper itself."""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# loads chip_smoke.py as a module beside a stand-in torch; PHASES (the
# case's code) defines run_phases and may rebind anything else
HARNESS = """
import ctypes, json, os, subprocess, sys, time, types
cuda = types.SimpleNamespace(is_available=lambda: True,
                             get_device_name=lambda i=0: "stand-in card",
                             device_count=lambda: 1)
sys.modules["torch"] = types.SimpleNamespace(cuda=cuda)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", {path!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs.kernel_entries = lambda counters, errs, timings: []
cs.Counters = lambda: None
SLEEPER = [sys.executable, "-c", "import time; time.sleep(120)",
           "guard-test-sleeper"]
{phases}
sys.argv = ["chip_smoke.py", *{argv!r}]
try:
    rc = cs.main()
    err = None
except BaseException as e:
    rc, err = None, f"{{type(e).__name__}}: {{e}}"
libc = ctypes.CDLL(None, use_errno=True)
flag = ctypes.c_int(-1)
libc.prctl(37, ctypes.byref(flag), 0, 0, 0)  # PR_GET_CHILD_SUBREAPER
print("RESULT " + json.dumps({{
    "rc": rc, "err": err, "subreaper": flag.value,
    "left": cs.load_tool("torch_soak_util").own_children()}}))
"""


def run_main(phases: str, argv=()):
    src = HARNESS.format(path=str(REPO / "chip_smoke.py"),
                         phases=textwrap.dedent(phases), argv=list(argv))
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    lines = proc.stdout.splitlines()
    result = [json.loads(x[7:]) for x in lines if x.startswith("RESULT ")]
    assert result, (proc.stdout[-2000:], proc.stderr[-3000:])
    return result[0], lines


def alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_a_grandchild_left_by_a_phase_fails_it_by_pid_and_command(tmp_path):
    pidfile = tmp_path / "grandchild.pid"
    res, lines = run_main(f"""
        def leaky():
            # a child that starts a grandchild in a session of its own
            # and exits: the grandchild is re-parented to the run
            code = ("import subprocess, sys; p = subprocess.Popen("
                    + repr(SLEEPER) + ", start_new_session=True); "
                    "open({str(pidfile)!r}, 'w').write(str(p.pid))")
            subprocess.run([sys.executable, "-c", code], check=True)

        def run_phases(counters, errs, timings):
            cs.timed_phase({{}}, "leaky", leaky)
            return "stand-in smi"
        cs.run_phases = run_phases
        cs.ProcessGuard.GRACE_S = 1.0
    """)
    pid = int(pidfile.read_text())
    assert res["rc"] is None
    assert res["err"].startswith("AssertionError: phase leaky left 1 "
                                 "process(es) alive: ")
    assert f"pid {pid}: " in res["err"]
    assert "time.sleep(120) guard-test-sleeper" in res["err"]
    assert res["left"] == {}
    assert not alive(pid)
    assert not any(x.startswith("processes:") for x in lines)


def test_the_finally_leaves_no_descendant_after_a_phase_raises(tmp_path):
    pidfile = tmp_path / "child.pid"
    res, _ = run_main(f"""
        def raising():
            p = subprocess.Popen(SLEEPER, start_new_session=True)
            open({str(pidfile)!r}, "w").write(str(p.pid))
            raise RuntimeError("phase failed")

        def run_phases(counters, errs, timings):
            cs.timed_phase({{}}, "raising", raising)
            return "stand-in smi"
        cs.run_phases = run_phases
    """)
    assert res["err"] == "RuntimeError: phase failed"
    assert res["left"] == {}
    assert not alive(int(pidfile.read_text()))


def test_a_clean_run_prints_processes_line_before_kernels():
    res, lines = run_main("""
        def tidy():
            subprocess.run([sys.executable, "-c", "pass"], check=True)

        def run_phases(counters, errs, timings):
            walls = {}
            for name in ("1", "2", "3"):
                cs.timed_phase(walls, name, tidy)
            return "stand-in smi"
        cs.run_phases = run_phases
    """)
    assert res["rc"] == 0 and res["err"] is None
    assert res["subreaper"] == 1
    out = [x for x in lines if not x.startswith("RESULT ")]
    i = out.index("processes: 0 alive after 3 phases (checked after each)")
    assert json.loads(out[i + 1]) == {"kernels": []}
    assert json.loads(out[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "stand-in card", "count": 1}}


def test_child_modes_do_not_set_the_subreaper():
    for argv in (["--serve-child", "dump.pkl", "--device", "cpu"],
                 ["--multihost-worker", "0", "file:///nowhere"]):
        res, _ = run_main("""
            cs.serve_child = lambda dump, argv: 0
            cs.multihost_worker = lambda pid, init: None
        """, argv)
        assert res["rc"] == 0 and res["err"] is None, argv
        assert res["subreaper"] == 0, argv


def test_own_children_walks_the_whole_tree(tmp_path):
    """tools/torch_soak_util.own_children lists a grandchild whose
    parent is alive (no subreaper), with its command line."""
    sys.path.insert(0, str(REPO / "tools"))
    import torch_soak_util as util

    pidfile = tmp_path / "g.pid"
    code = ("import subprocess, sys, time; p = subprocess.Popen([sys.executable,"
            " '-c', 'import time; time.sleep(60)', 'grandchild-marker']); "
            f"open({str(pidfile)!r}, 'w').write(str(p.pid)); time.sleep(60)")
    child = subprocess.Popen([sys.executable, "-c", code],
                             start_new_session=True)
    try:
        for _ in range(200):
            if pidfile.exists() and pidfile.read_text():
                break
            time.sleep(0.05)
        grand = int(pidfile.read_text())
        tree = util.own_children()
        assert child.pid in tree and grand in tree
        assert tree[grand].endswith("grandchild-marker")
    finally:
        os.killpg(child.pid, 9)
        child.wait()

