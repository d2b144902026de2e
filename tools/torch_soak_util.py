"""Helpers shared by the port's process soaks (tools/torch_crash_soak.py,
tools/torch_fleet_soak.py, tools/torch_chaos_soak.py): the name of the
device a run used, and a warm-up of a worker's δ path before it serves.
"""

from __future__ import annotations

import subprocess


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
