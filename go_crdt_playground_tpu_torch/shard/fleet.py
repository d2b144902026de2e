"""Fleet runner: N shard frontends + one router, as real subprocesses.

The fleet soak (tools/fleet_serve_soak.py) and the slow-marked pytest
wrapper drive REAL ``python -m go_crdt_playground_tpu_torch`` processes — the
same CLI an operator runs — never in-process imports: a shard SIGKILL
must kill a process with its own WAL fds, page cache, and CUDA context,
or the zero-acked-op-loss adjudication proves nothing.  Shards run on
``FleetSpec.device`` (CUDA unless the caller asks for the CPU); the
router and its standby are host-only and take no device.

``ShardFleet`` owns the lifecycle: it pre-allocates every port (so a
killed shard RESTARTS on the address the router was configured with —
the router's links redial through their breakers and the keyspace comes
back without touching the router), launches all shards concurrently
(each costs a torch import, a CUDA context, the kernel load and a
warmup batch; serial launch would dominate the soak), then the router, and tears everything down on ``close()``.

Address handshake: each process prints one ``... listening on H:P``
line on stdout; a pump thread per process keeps draining stdout
afterwards so drain summaries can never block the pipe (the
tools/serve_soak.py lesson).
"""

from __future__ import annotations

import atexit
import os
import random
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Addr = Tuple[str, int]

_ADDR_RE = re.compile(rb"listening on ([\d.]+):(\d+)")


def format_addrs(a) -> str:
    """One ``--shard`` flag value: ``H:P`` for a single (host, port)
    pair, ``H:P,H:P`` for an ordered replication-group roster."""
    if a and not isinstance(a[0], str):
        return ",".join(f"{h}:{p}" for h, p in a)
    return f"{a[0]}:{a[1]}"


def free_port() -> int:
    return free_ports(1)[0]


# where listener ports are drawn when the kernel's ephemeral range cannot
# be read (Linux's default range is 32768-60999)
_EPHEMERAL_DEFAULT = (32768, 60999)
_LISTENER_LOW = 10240


def listener_port_range() -> range:
    """Ports a listener may be handed that no outgoing connection is
    ever given: those below the kernel's ephemeral range
    (``ip_local_port_range``), from which ``connect()`` draws its source
    ports.  A port from that range, handed out and bound only later (a
    standby binds its declared port when it promotes), could meanwhile
    be any connection's source port, and its TIME_WAIT then refuses the
    listener for a minute.  Empty when the range leaves no room."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = (int(x) for x in f.read().split())
    except (OSError, ValueError):
        lo, hi = _EPHEMERAL_DEFAULT
    if lo - _LISTENER_LOW >= 4096:
        return range(_LISTENER_LOW, lo)
    return range(hi + 1, 65536)


# the directory of the ports handed out in this process tree: one empty
# file a port, made by the first process of the tree that hands one out
# and named to every process it starts by this variable
PORT_REGISTRY_ENV = "GO_CRDT_PORT_REGISTRY"


def port_registry() -> str:
    """This process tree's registry of handed-out ports (see
    ``PORT_REGISTRY_ENV``): the inherited one, or a new one that this
    process removes when it exits.  A process that starts others should
    call it first, so that they all share it."""
    d = os.environ.get(PORT_REGISTRY_ENV)
    if d and os.path.isdir(d):
        return d
    d = tempfile.mkdtemp(prefix="go-crdt-ports-")
    os.environ[PORT_REGISTRY_ENV] = d
    owner = os.getpid()
    atexit.register(
        lambda: os.getpid() == owner and shutil.rmtree(d, True))
    return d


def _claim(registry: str, port: int) -> bool:
    """Claim ``port`` for this process tree; False if it was handed out
    before."""
    try:
        os.close(os.open(os.path.join(registry, str(port)),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        return False
    return True


def free_ports(n: int) -> List[int]:
    """``n`` distinct free listener ports (``listener_port_range``),
    none handed out before in this process tree (``port_registry``): a
    port declared to a process that binds it only later (a standby binds
    its declared port when it promotes) is never handed to another.
    Every socket stays bound until all are.  No ``SO_REUSEADDR``: with
    it a port still in TIME_WAIT would pass."""
    ports = listener_port_range()
    registry = port_registry()
    pick = random.SystemRandom()
    socks = []
    try:
        for _ in range(64 * (len(ports) or 1)):
            if len(socks) == n:
                return [s.getsockname()[1] for s in socks]
            s = socket.socket()
            try:
                # a kernel whose ephemeral range leaves none: any free port
                s.bind(("127.0.0.1", pick.choice(ports) if ports else 0))
            except OSError:
                s.close()
                continue
            if not _claim(registry, s.getsockname()[1]):
                s.close()
                continue
            socks.append(s)
        if len(socks) == n:
            return [s.getsockname()[1] for s in socks]
        raise OSError(f"no free listener port left in {ports} that this "
                      f"process tree was not handed before")
    finally:
        for s in socks:
            s.close()


class _Proc:
    """One CLI subprocess with the address-line handshake."""

    def __init__(self, argv: List[str], cwd: str, log_path: str,
                 env: Optional[Dict[str, str]] = None,
                 env_drop: Tuple[str, ...] = ()):
        full_env = dict(os.environ)
        for k in env_drop:
            full_env.pop(k, None)
        if env:
            full_env.update(env)
        self.log = open(log_path, "ab")
        self.proc = subprocess.Popen(
            argv, env=full_env, cwd=cwd, stdout=subprocess.PIPE,
            stderr=self.log)
        self._lines: "list[bytes]" = []
        self._line_cond = threading.Condition()
        threading.Thread(target=self._pump, daemon=True).start()
        self.addr: Optional[Addr] = None

    def _pump(self) -> None:
        while True:
            line = self.proc.stdout.readline()
            with self._line_cond:
                self._lines.append(line)
                self._line_cond.notify_all()
            if not line:
                return

    def await_match(self, regex, timeout_s: float = 120.0):
        """Wait for the first stdout line matching ``regex``; returns
        the match.  The ONE banner-handshake implementation — the
        address handshake and the autopilot soak's engagement banner
        both ride it, so the deadline discipline (enforced on
        NON-matching lines too: a subprocess spamming warnings without
        ever printing its banner must still time out, not pin the soak
        forever) lives once."""
        deadline = time.monotonic() + timeout_s
        seen = 0
        while True:
            with self._line_cond:
                while seen >= len(self._lines):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise RuntimeError(
                            f"no line matching {regex.pattern!r} "
                            f"within {timeout_s}s "
                            f"(argv={self.proc.args[:6]}...)")
                    self._line_cond.wait(timeout=remaining)
                line = self._lines[seen]
                seen += 1
            if not line:
                raise RuntimeError(
                    f"process exited before a line matching "
                    f"{regex.pattern!r} (rc={self.proc.poll()})")
            m = regex.search(line)
            if m:
                return m
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no line matching {regex.pattern!r} within "
                    f"{timeout_s}s; last output line: {line!r}")

    def await_address(self, timeout_s: float = 120.0) -> Addr:
        m = self.await_match(_ADDR_RE, timeout_s)
        self.addr = (m.group(1).decode(), int(m.group(2)))
        return self.addr

    def sigkill(self) -> None:
        if self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait()

    def terminate(self) -> int:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                return self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                return self.proc.wait()
        return self.proc.returncode

    def close(self) -> None:
        self.terminate()
        self.log.close()


@dataclass
class FleetSpec:
    """Shape of one fleet: N shards over a shared element universe."""

    n_shards: int
    elements: int
    actors: int = 0          # 0 = n_shards (one actor lane per shard)
    seed: int = 0
    queue_depth: int = 128
    max_batch: int = 32
    flush_ms: float = 2.0
    # extra `serve --ingest` CLI flags appended verbatim to every shard
    # (the serve soak's seed-comparison / compaction legs ride these)
    extra_args: Tuple[str, ...] = ()
    # extra env for every shard subprocess, as (key, value) pairs (for
    # settings a worker reads only at process start, which must ride
    # the worker env, not the CLI)
    extra_env: Tuple[Tuple[str, str], ...] = ()
    # torch device of every shard replica (`serve --device`); the
    # router and its standby are host-only and take none
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.actors == 0:
            self.actors = max(self.n_shards, 1)
        if self.actors < self.n_shards:
            raise ValueError(
                f"actors={self.actors} < n_shards={self.n_shards}: each "
                "shard replica ticks its own actor lane")


class ShardProc(_Proc):
    """One ``serve --ingest`` shard frontend subprocess.
    ``extra_args`` appends PER-SHARD flags after the fleet-wide
    ``spec.extra_args`` (the replication soak passes ``--shard-id`` /
    ``--shard-epoch`` / ``--announce-to``, which differ per shard)."""

    def __init__(self, repo: str, dirpath: str, spec: FleetSpec,
                 index: int, port: int,
                 crash_after_batches: Optional[int] = None,
                 crash_on_slice: Optional[str] = None,
                 extra_args: Tuple[str, ...] = ()):
        self.index = index
        self.port = port
        self.dirpath = dirpath
        os.makedirs(dirpath, exist_ok=True)
        env = dict(spec.extra_env)
        if crash_after_batches is not None:
            env["CRDT_SERVE_CRASH_AFTER_BATCHES"] = str(crash_after_batches)
        if crash_on_slice is not None:
            # "pull" = die as handoff donor, "push" = die as recipient
            # (serve/frontend.py kill-mid-handoff hook)
            env["CRDT_SERVE_CRASH_ON_SLICE"] = crash_on_slice
        argv = [sys.executable, "-m", "go_crdt_playground_tpu_torch", "serve",
                "--ingest", "--port", str(port),
                "--elements", str(spec.elements),
                "--actors", str(spec.actors), "--actor", str(index),
                "--durable-dir", os.path.join(dirpath, "state"),
                "--queue-depth", str(spec.queue_depth),
                "--max-batch", str(spec.max_batch),
                "--flush-ms", str(spec.flush_ms),
                "--checkpoint-every", "0",
                "--device", spec.device] + list(spec.extra_args) \
            + list(extra_args)
        super().__init__(argv, cwd=repo,
                         log_path=os.path.join(dirpath, "shard.log"),
                         env=env,
                         env_drop=("CRDT_SERVE_CRASH_AFTER_BATCHES",
                                   "CRDT_SERVE_CRASH_ON_SLICE"))


class RouterProc(_Proc):
    """One ``router --serve`` subprocess over a shard map (the INITIAL
    fleet — live resharding grows/shrinks it; with ``state_dir`` the
    committed ring survives router restarts).  ``extra_args`` appends
    verbatim CLI flags (the HA soak passes ``--router-epoch`` /
    ``--router-id``)."""

    def __init__(self, repo: str, dirpath: str, spec: FleetSpec,
                 shard_addrs: Dict[str, Addr], port: int,
                 state_dir: Optional[str] = None,
                 transfer_timeout_s: float = 10.0,
                 extra_args: Tuple[str, ...] = ()):
        os.makedirs(dirpath, exist_ok=True)
        argv = [sys.executable, "-m", "go_crdt_playground_tpu_torch", "router",
                "--serve", "--port", str(port),
                "--elements", str(spec.elements),
                "--seed", str(spec.seed),
                "--transfer-timeout", str(transfer_timeout_s)]
        for sid in sorted(shard_addrs):
            argv += ["--shard", f"{sid}={format_addrs(shard_addrs[sid])}"]
        if state_dir is not None:
            argv += ["--state-dir", state_dir]
        argv += list(extra_args)
        super().__init__(argv, cwd=repo,
                         log_path=os.path.join(dirpath, "router.log"))


_STANDBY_RE = re.compile(rb"Router standby engaged")
_TAILING_RE = re.compile(rb"Router standby tailing primary ring")
_SHARD_STANDBY_RE = re.compile(rb"Shard standby engaged")
_SHARD_TAILING_RE = re.compile(rb"Shard standby tailing primary wal")


class StandbyShardProc(_Proc):
    """One ``serve --ingest --standby-of`` subprocess
    (shard/replica.py as a process): tails the primary shard's WAL,
    promotes on its death under a bumped fenced shard epoch, claims
    the keyspace at the router, and only THEN prints the standard
    ``listening on`` banner — so ``await_address`` doubles as the
    promotion handshake, exactly the router-standby discipline."""

    def __init__(self, repo: str, dirpath: str, spec: FleetSpec,
                 index: int, port: int, primary: Addr, sid: str,
                 announce_to: Optional[Addr] = None,
                 standby_id: Optional[str] = None,
                 poll_interval_s: float = 0.1,
                 failure_threshold: int = 5):
        self.index = index
        self.port = port
        self.dirpath = dirpath
        os.makedirs(dirpath, exist_ok=True)
        argv = [sys.executable, "-m", "go_crdt_playground_tpu_torch", "serve",
                "--ingest", "--port", str(port),
                "--elements", str(spec.elements),
                "--actors", str(spec.actors), "--actor", str(index),
                "--durable-dir", os.path.join(dirpath, "state"),
                "--queue-depth", str(spec.queue_depth),
                "--max-batch", str(spec.max_batch),
                "--flush-ms", str(spec.flush_ms),
                "--checkpoint-every", "0",
                "--device", spec.device,
                "--standby-of", f"{primary[0]}:{primary[1]}",
                "--shard-id", sid,
                "--standby-id", standby_id or f"{sid}-standby",
                "--ha-poll-interval", str(poll_interval_s),
                "--ha-failure-threshold", str(failure_threshold)]
        if announce_to is not None:
            argv += ["--announce-to", f"{announce_to[0]}:{announce_to[1]}"]
        argv += list(spec.extra_args)
        super().__init__(argv, cwd=repo,
                         log_path=os.path.join(dirpath, "standby.log"))

    def await_engaged(self, timeout_s: float = 120.0) -> None:
        self.await_match(_SHARD_STANDBY_RE, timeout_s)

    def await_tailed(self, timeout_s: float = 60.0) -> None:
        """Wait until the standby has tailed the primary at least once
        — only a tailed standby promotes (the epoch-collision /
        empty-replica guard), so a soak must not SIGKILL the primary
        before this handshake."""
        self.await_match(_SHARD_TAILING_RE, timeout_s)


class StandbyRouterProc(_Proc):
    """One ``router --serve --standby-of`` subprocess (shard/ha.py as
    a process): tails the primary, promotes on its death, and only
    THEN prints the standard ``listening on`` banner — so
    ``await_address`` doubles as the promotion handshake.
    ``await_engaged`` is the pre-promotion handshake (the standby is
    tailing)."""

    def __init__(self, repo: str, dirpath: str, spec: FleetSpec,
                 shard_addrs: Dict[str, Addr], port: int,
                 primary: Addr, state_dir: str,
                 standby_id: str = "router-b",
                 poll_interval_s: float = 0.25,
                 failure_threshold: int = 3,
                 transfer_timeout_s: float = 10.0):
        os.makedirs(dirpath, exist_ok=True)
        argv = [sys.executable, "-m", "go_crdt_playground_tpu_torch", "router",
                "--serve", "--port", str(port),
                "--elements", str(spec.elements),
                "--seed", str(spec.seed),
                "--transfer-timeout", str(transfer_timeout_s),
                "--standby-of", f"{primary[0]}:{primary[1]}",
                "--router-id", standby_id,
                "--ha-poll-interval", str(poll_interval_s),
                "--ha-failure-threshold", str(failure_threshold),
                "--state-dir", state_dir]
        for sid in sorted(shard_addrs):
            argv += ["--shard", f"{sid}={format_addrs(shard_addrs[sid])}"]
        super().__init__(argv, cwd=repo,
                         log_path=os.path.join(dirpath, "standby.log"))

    def await_engaged(self, timeout_s: float = 120.0) -> None:
        self.await_match(_STANDBY_RE, timeout_s)

    def await_tailed(self, timeout_s: float = 60.0) -> None:
        """Wait until the standby has tailed the primary at least once
        — only a tailed standby will promote (shard/ha.py's
        epoch-collision guard), so a soak must not SIGKILL the primary
        before this handshake."""
        self.await_match(_TAILING_RE, timeout_s)


@dataclass
class ShardFleet:
    """N shard subprocesses behind one router subprocess.

    Single-owner object: the soak's main thread starts, kills,
    restarts and closes it — nothing here is touched concurrently.
    """

    repo: str
    root: str
    spec: FleetSpec
    shards: List[Optional[ShardProc]] = field(default_factory=list)
    shard_ports: List[int] = field(default_factory=list)
    router: Optional[RouterProc] = None
    # pass a directory to persist committed ring swaps (live resharding)
    router_state_dir: Optional[str] = None
    # extra `router --serve` CLI flags (the HA soak's --router-epoch)
    router_extra_args: Tuple[str, ...] = ()
    # the router's port, fixed at start() so kill/restart reuses it
    router_port: Optional[int] = None

    @staticmethod
    def sid(index: int) -> str:
        return f"s{index}"

    def start(self, extra: Tuple[int, ...] = ()) -> Addr:
        """Launch every shard concurrently, the initial set and the
        ``extra`` shards beyond it (``launch_shard``'s, owning no
        keyspace until a join; ``shard_addr`` gives their addresses),
        then the router; returns the router's client address."""
        n = max((self.spec.n_shards - 1, *extra)) + 1
        *self.shard_ports, router_port = free_ports(n + 1)
        # append-as-launched (never a bulk comprehension): if shard k's
        # constructor raises, the caller's close() must still reach
        # shards 0..k-1 or they outlive the soak holding ports + cores
        self.shards = []
        for i in range(self.spec.n_shards):
            self.shards.append(
                ShardProc(self.repo, os.path.join(self.root, self.sid(i)),
                          self.spec, i, self.shard_ports[i]))
        for i in extra:
            self._spawn_shard(i)
        for s in self.shards:
            if s is not None:
                s.await_address()
        addrs = {self.sid(i): ("127.0.0.1", self.shard_ports[i])
                 for i in range(self.spec.n_shards)}
        self.router_port = router_port
        self.router = RouterProc(self.repo, os.path.join(self.root, "router"),
                                 self.spec, addrs, router_port,
                                 state_dir=self.router_state_dir,
                                 extra_args=self.router_extra_args)
        return self.router.await_address()

    def shard_addr_map(self) -> Dict[str, Addr]:
        """sid -> address of every INITIAL shard (the router/standby
        launch configuration)."""
        return {self.sid(i): ("127.0.0.1", self.shard_ports[i])
                for i in range(self.spec.n_shards)}

    def kill_router(self) -> None:
        """SIGKILL the router subprocess (the HA soak's failover
        trigger); its port and state_dir stay reserved for a
        restart."""
        assert self.router is not None
        self.router.sigkill()
        self.router.log.close()
        self.router = None

    def restart_router(self,
                       extra_args: Optional[Tuple[str, ...]] = None
                       ) -> Addr:
        """Restart a killed router on ITS ORIGINAL port + state_dir —
        the resurrection leg: it adopts its persisted committed ring
        and its OLD persisted router epoch, so a promoted standby's
        fence must contain it."""
        assert self.router is None, "router still running"
        assert self.router_port is not None
        self.router = RouterProc(
            self.repo, os.path.join(self.root, "router"), self.spec,
            self.shard_addr_map(), self.router_port,
            state_dir=self.router_state_dir,
            extra_args=(self.router_extra_args if extra_args is None
                        else extra_args))
        return self.router.await_address()

    def kill_shard(self, index: int) -> None:
        """SIGKILL one shard; its keyspace degrades to typed rejects at
        the router until ``restart_shard``."""
        shard = self.shards[index]
        assert shard is not None
        shard.sigkill()
        shard.log.close()
        self.shards[index] = None

    def restart_shard(self, index: int,
                      crash_on_slice: Optional[str] = None) -> None:
        """Restart a killed shard on ITS ORIGINAL port and durable dir
        (``Node.restore_durable``: checkpoint ⊔ WAL tail) — the router
        config is static, so recovery is invisible to it beyond the
        breaker's probe.  ``crash_on_slice`` re-arms the kill-mid-
        handoff hook (the reshard soak's donor-death leg restarts an
        EXISTING shard armed to die on the next slice pull)."""
        assert self.shards[index] is None, "shard still running"
        self.shards[index] = ShardProc(
            self.repo, os.path.join(self.root, self.sid(index)),
            self.spec, index, self.shard_ports[index],
            crash_on_slice=crash_on_slice)
        self.shards[index].await_address()

    def shard_addr(self, index: int) -> Addr:
        """The serve address of shard ``index`` (initial or beyond)."""
        return ("127.0.0.1", self.shard_ports[index])

    def launch_shard(self, index: int,
                     crash_on_slice: Optional[str] = None) -> Addr:
        """Launch a shard BEYOND the initial set (the reshard joiner):
        allocates its port/slot, starts the subprocess, returns its
        serve address.  It owns no keyspace until a RESHARD join
        commits; ``spec.actors`` must cover its actor lane."""
        return self._spawn_shard(index, crash_on_slice).await_address()

    def _spawn_shard(self, index: int,
                     crash_on_slice: Optional[str] = None) -> ShardProc:
        """Start shard ``index`` beyond the initial set (no wait)."""
        if index < self.spec.n_shards:
            raise ValueError(f"shard {index} is part of the initial "
                             "fleet; use restart_shard")
        if index >= self.spec.actors:
            raise ValueError(f"shard {index} has no actor lane "
                             f"(actors={self.spec.actors})")
        while len(self.shard_ports) <= index:
            self.shard_ports.append(free_port())
        while len(self.shards) <= index:
            self.shards.append(None)
        assert self.shards[index] is None, "shard already running"
        self.shards[index] = ShardProc(
            self.repo, os.path.join(self.root, self.sid(index)),
            self.spec, index, self.shard_ports[index],
            crash_on_slice=crash_on_slice)
        return self.shards[index]

    def owned_elements(self, index: int) -> List[int]:
        """The element ids shard ``index`` owns under the fleet ring
        (client-side ledger for the kill leg)."""
        from go_crdt_playground_tpu_torch.shard.ring import HashRing

        ring = HashRing([self.sid(i) for i in range(self.spec.n_shards)],
                        seed=self.spec.seed)
        owners = ring.owner_map(self.spec.elements)
        want = ring.shards.index(self.sid(index))
        return [int(e) for e in
                (owners == want).nonzero()[0]]

    def close(self) -> None:
        if self.router is not None:
            self.router.close()
            self.router = None
        live = [s for s in self.shards if s is not None]
        # every shard drains at once: SIGTERM them all, then reap each
        for s in live:
            if s.proc.poll() is None:
                s.proc.terminate()
        for s in live:
            s.close()
        self.shards = []
