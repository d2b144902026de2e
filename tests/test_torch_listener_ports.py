"""The listener ports the port's soaks hand to the processes they start
(shard/fleet.py ``free_ports``): drawn below the kernel's ephemeral
range, so no outgoing connection is ever given one as its source port.

A port handed out from that range and bound only later (a shard
standby binds its declared port when it promotes) could meanwhile be
any connection's source port, and that connection's TIME_WAIT then
refuses the listener for a minute: with 12b's fleet soak modes side by
side, ``--shard-repl``'s s0 standby kept failing to serve, promoted
again one shard epoch higher after each failed bind, and served after
58.9 s at epoch 408 (ROADMAP queue 3 item 13)."""

import socket
import sys
from pathlib import Path

import pytest

from go_crdt_playground_tpu_torch.shard import fleet

REPO = Path(__file__).resolve().parent.parent


def ephemeral_range():
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        lo, hi = (int(x) for x in f.read().split())
    return lo, hi


def test_a_source_ports_time_wait_refuses_a_listener():
    """The collision, planted: a closed outgoing connection's source
    port refuses a listener (SO_REUSEADDR included) while its TIME_WAIT
    lasts."""
    with socket.create_server(("127.0.0.1", 0)) as srv:
        c = socket.create_connection(srv.getsockname())
        source = c.getsockname()[1]
        a, _ = srv.accept()
        c.close()
        a.close()
    lo, hi = ephemeral_range()
    assert lo <= source <= hi
    with pytest.raises(OSError):
        socket.create_server(("127.0.0.1", source)).close()


def test_listener_ports_are_never_source_ports():
    lo, hi = ephemeral_range()
    ports = fleet.free_ports(64)
    assert len(set(ports)) == 64
    assert all(not lo <= p <= hi for p in ports), ports
    assert all(p in fleet.listener_port_range() for p in ports)
    assert not lo <= fleet.free_port() <= hi
    # a burst of outgoing connections, closed to TIME_WAIT, takes none
    # of them: every port still binds a listener
    with socket.create_server(("127.0.0.1", 0)) as srv:
        for _ in range(200):
            c = socket.create_connection(srv.getsockname())
            assert c.getsockname()[1] not in ports
            a, _ = srv.accept()
            c.close()
            a.close()
    for p in ports[:8]:
        socket.create_server(("127.0.0.1", p)).close()


def test_the_soaks_take_their_listener_ports_from_the_fleet():
    """Every soak caller draws from shard/fleet.py: the serve soak's
    workers, the crash soak's nodes, the fleet soak's shards, standbys
    and routers (taken together, one call a mode)."""
    sys.path.insert(0, str(REPO / "tools"))
    import torch_crash_soak
    import torch_serve_soak

    assert torch_serve_soak.free_port is fleet.free_port
    assert torch_crash_soak._free_port is fleet.free_port
    assert torch_crash_soak.free_ports is fleet.free_ports
    src = (REPO / "tools" / "torch_fleet_serve_soak.py").read_text()
    assert "p0_port, p1_port, sb0_port, sb1_port, router_port = " \
        "free_ports(5)" in src


def test_a_port_is_handed_out_once_in_a_process_tree(tmp_path, monkeypatch):
    """A port handed out and not yet bound (a standby's declared port)
    is never handed out again, in this process or in one it starts: the
    registry (``port_registry``) is named to the child by the
    environment.  Once every port of the range was handed out,
    ``free_ports`` refuses."""
    import json
    import random
    import subprocess

    monkeypatch.setenv(fleet.PORT_REGISTRY_ENV, str(tmp_path))
    whole = fleet.listener_port_range()
    start = random.randrange(whole.start, whole.stop - 24)
    window = range(start, start + 24)
    monkeypatch.setattr(fleet, "listener_port_range", lambda: window)
    mine = fleet.free_ports(8)
    code = ("import json; from go_crdt_playground_tpu_torch.shard import "
            f"fleet; fleet.listener_port_range = lambda: range({start}, "
            f"{start + 24}); print(json.dumps(fleet.free_ports(8)))")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    theirs = json.loads(run.stdout)
    handed = mine + theirs
    with pytest.raises(OSError, match="no free listener port"):
        for _ in range(len(window)):
            handed += fleet.free_ports(1)
    assert len(set(handed)) == len(handed), handed
    assert set(handed) <= set(window)
    assert sorted(int(x.name) for x in tmp_path.iterdir()) == sorted(handed)
