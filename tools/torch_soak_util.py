"""Helpers shared by the port's process soaks (tools/torch_crash_soak.py,
tools/torch_fleet_soak.py, tools/torch_chaos_soak.py), chip_smoke.py and
tools/torch_autopilot_baseline.py: the name of the device a run used, a
warm-up of a worker's δ path before it serves, the host's page-cache
and processes' CPU readings (tools/torch_fleet_serve_soak.py), and the
process's own tree of descendants (made its subreaper, listed, killed
and reaped).  Both are read from ``/proc``; the tree acts on this
process's descendants only (Linux).
"""

from __future__ import annotations

import ctypes
import os
import signal
import subprocess
import time
from typing import Dict, Iterable

_PR_SET_CHILD_SUBREAPER = 36


def device_label(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    the device's name when it is not a GPU.  Raises when ``device`` asks
    for a GPU and there is none."""
    import torch

    from go_crdt_playground_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        line = out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return line or torch.cuda.get_device_name(dev)


def warm_delta_path(n_elements: int, n_actors: int, device: str) -> None:
    """One δ exchange both ways between two scratch nodes on ``device``
    (an add, the payload extraction, the apply, the reply), so a worker's
    first real exchange pays for no first launch or library load inside
    a peer's deadline.  Touches no other node."""
    from go_crdt_playground_tpu_torch.net.peer import Node

    a = Node(0, n_elements, n_actors, device=device)
    b = Node(min(1, n_actors - 1), n_elements, n_actors, device=device)
    try:
        a.add(0)
        a.sync_with(b.serve(), timeout=60.0)
    finally:
        a.close()
        b.close()


_TICK = os.sysconf("SC_CLK_TCK")


def host_reading(pids: Dict[str, int]) -> Dict[str, object]:
    """The host's state from reads of ``/proc`` only: dirty and
    writeback page-cache kB (``/proc/meminfo``) and each named
    process's CPU seconds (``/proc/<pid>/stat``; None once it is
    gone)."""
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("Dirty", "Writeback"):
                mem[key] = int(value.split()[0])
    cpu: Dict[str, object] = {}
    for name, pid in pids.items():
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            cpu[name] = (int(fields[11]) + int(fields[12])) / _TICK
        except OSError:
            cpu[name] = None
    return {"dirty_kb": mem["Dirty"], "writeback_kb": mem["Writeback"],
            "cpu_s": cpu}


def host_window(before: Dict[str, object],
                after: Dict[str, object]) -> Dict[str, object]:
    """What the host did between two ``host_reading``s: the dirty and
    writeback kB at each end and each process's CPU seconds in
    between."""
    return {"dirty_kb": [before["dirty_kb"], after["dirty_kb"]],
            "writeback_kb": [before["writeback_kb"], after["writeback_kb"]],
            "cpu_s": {name: (None if after["cpu_s"][name] is None
                             or before["cpu_s"][name] is None else
                             round(after["cpu_s"][name]
                                   - before["cpu_s"][name], 2))
                      for name in before["cpu_s"]}}


def set_subreaper() -> None:
    """Make this process its descendants' subreaper: a process whose
    parent dies is re-parented to it, so it stays in ``own_children``."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(_PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _stat(pid: str):
    """(state, ppid) of a process from ``/proc/<pid>/stat``, or None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    return fields[0], int(fields[1])


def own_children() -> Dict[int, str]:
    """Every live descendant of this process (children, their children
    and so on; zombies left out) with its command line, from the parent
    links of the processes in ``/proc``."""
    kids: Dict[int, list] = {}
    state = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        st = _stat(name)
        if st is not None:
            state[int(name)] = st[0]
            kids.setdefault(st[1], []).append(int(name))
    out, todo = {}, list(kids.get(os.getpid(), ()))
    while todo:
        pid = todo.pop()
        todo.extend(kids.get(pid, ()))
        if state[pid] == "Z":
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                out[pid] = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()[:200]
        except OSError:
            pass
    return dict(sorted(out.items()))


def reap(pids: Iterable[int]) -> None:
    """SIGKILL each pid and collect the exit of those that are this
    process's children."""
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass


def reap_zombies() -> None:
    """Collect the exit of every child that died unseen (call only when
    no code of this process still waits on a child of its own)."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def settle(grace_s: float) -> Dict[int, str]:
    """The descendants still alive after up to ``grace_s`` seconds of
    reaping the ones that exit (a killed process may take a moment to
    leave: a CUDA context is torn down on exit)."""
    deadline = time.monotonic() + grace_s
    while True:
        reap_zombies()
        alive = own_children()
        if not alive or time.monotonic() >= deadline:
            return alive
        time.sleep(0.05)


def kill_tree(grace_s: float = 30.0) -> Dict[int, str]:
    """Kill and reap every descendant, again until none is left or
    ``grace_s`` has passed (one that forks while it is killed is killed
    in a later pass).  Returns those killed."""
    killed: Dict[int, str] = {}
    deadline = time.monotonic() + grace_s
    while True:
        alive = own_children()
        if not alive or time.monotonic() >= deadline:
            return killed
        killed.update(alive)
        reap(alive)
        reap_zombies()
