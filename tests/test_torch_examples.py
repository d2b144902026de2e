"""The port's examples are a switching user's first session on it: they
run as documented (``python examples/<name>.py --device cpu`` from the
repo root, no install), print OK, and tell the same story as the JAX
package's twins (the same rendering, the same bytes on the wire)."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(name, *args):
    return subprocess.run([sys.executable, str(REPO / "examples" / name),
                           *args], capture_output=True, text=True,
                          timeout=240, cwd=str(REPO))


@pytest.mark.parametrize("name,twin", [
    ("torch_quickstart.py", "quickstart.py"),
    ("torch_tcp_sync.py", "tcp_sync.py"),
])
def test_example_runs_verbatim_like_its_twin(name, twin):
    port, ref = _run(name, "--device", "cpu"), _run(twin)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    assert port.stdout.strip().endswith("OK")
    # every line but the device-naming ones is the JAX example's
    keep = [ln for ln in port.stdout.splitlines()
            if "cpu" not in ln and not ln.endswith("OK")]
    want = [ln for ln in ref.stdout.splitlines() if not ln.endswith("OK")
            and not ln.startswith("packed replica 0")]
    assert keep == want


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_tcp_sync.py"])
def test_example_defaults_to_cuda(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is served")
    proc = _run(name)
    assert proc.returncode != 0
    assert "no CUDA GPU" in proc.stderr
