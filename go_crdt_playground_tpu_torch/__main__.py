"""Command line: a replica fleet converging by anti-entropy gossip, and
the op-ingest serving frontend.

  python -m go_crdt_playground_tpu_torch gossip [--replicas N] [--delta]
      [--schedule dissemination|ring|random|butterfly] [--drop-rate P]
      [--seed S] [--device cuda|cpu]

Every replica adds one element of a 128-element universe, then the
fleet gossips until every replica agrees on (membership, VV); the verb
prints the round count and the digest.

  python -m go_crdt_playground_tpu_torch serve --ingest [--port P]
      [--elements E] [--actors A] [--actor I] [--durable-dir D]
      [--max-batch B] [--flush-ms MS] [--queue-depth N]
      [--sync-mode delta|digest] [--peer HOST:PORT] [--peer-port P]
      [--no-fused-ingest] [--device cuda|cpu] ...

serves client ops (serve/) until SIGTERM, then drains and prints
``drained: N ops acked, ingest p99 ...``; the flags, defaults and banner
are the JAX package's ``serve --ingest``.  ``--mesh-devices``,
``--standby-of`` and ``--sched on`` exit 2: their slices are not ported
yet.  The device defaults to CUDA.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_gossip(num_replicas: int, delta: bool = False,
                drop_rate: float = 0.0, seed: int = 0,
                schedule: str = "dissemination", device="cuda") -> int:
    import numpy as np

    from go_crdt_playground_tpu_torch._u32 import widen
    from go_crdt_playground_tpu_torch.config import Config
    from go_crdt_playground_tpu_torch.models import awset, awset_delta
    from go_crdt_playground_tpu_torch.parallel import collectives, gossip

    cfg = Config(num_replicas=num_replicas, num_elements=128,
                 num_actors=num_replicas)
    R, E = cfg.num_replicas, cfg.num_elements
    mod = awset_delta if delta else awset
    state = (cfg.init_awset_delta(device=device) if delta
             else cfg.init_awset(device=device))
    rng = np.random.default_rng(0)
    for r in range(R):             # every replica adds a private slice
        state = mod.add_element(state, r, rng.integers(E))
    rounds, state = gossip.rounds_to_convergence(
        state, seed=seed, drop_rate=drop_rate, delta=delta,
        schedule=schedule)
    digest = collectives.state_digest(state.present, state.vv)
    kind = "delta" if delta else "full-state"
    drop = f" under {drop_rate:.0%} drop" if drop_rate > 0.0 else ""
    print(f"{R} replicas ({kind} gossip{drop}) converged in {rounds} "
          f"{schedule} rounds; digest={int(widen(digest[0])):#x}")
    return 0


def _ingest_banner(args, host: str, bound: int) -> None:
    """The serving banner, in the JAX verb's form (harnesses parse it:
    ``listening on H:P``, ``mesh=``, ``sched=``)."""
    print(f"Op-ingest frontend listening on {host}:{bound} "
          f"(E={args.elements} A={args.actors} actor={args.actor} "
          f"batch<={args.max_batch} flush={args.flush_ms}ms "
          f"queue={args.queue_depth} "
          f"durable={'yes' if args.durable_dir else 'NO'} "
          f"fused={'yes' if args.fused_ingest else 'NO'} "
          f"sync={args.sync_mode} "
          f"mesh=off "
          f"sched={args.sched} "
          f"shard={args.shard_id or 'off'} "
          f"compaction={args.compact_interval or 'off'})", flush=True)


def _build_frontend(args):
    from go_crdt_playground_tpu_torch.serve import ServeFrontend

    return ServeFrontend(
        args.elements, args.actors, actor=args.actor,
        durable_dir=args.durable_dir, peers=args.peer,
        queue_depth=args.queue_depth, max_batch=args.max_batch,
        flush_ms=args.flush_ms, checkpoint_every=args.checkpoint_every,
        ingest_fused=args.fused_ingest,
        wal_compact_records=args.fused_ingest,
        compact_interval_s=args.compact_interval,
        compact_p99_budget_s=args.compact_p99_budget_ms / 1e3,
        gc_participants=args.gc_participants,
        sync_mode=args.sync_mode,
        shard_id=args.shard_id,
        shard_epoch=args.shard_epoch,
        announce_to=args.announce_to,
        repl_ack_timeout_ms=args.repl_ack_timeout_ms,
        sched=args.sched, device=args.device)


def _not_ported(flag: str, what: str) -> int:
    print(f"error: {flag}: {what} is not part of the port yet (serve one "
          "device with the plain frontend)", file=sys.stderr, flush=True)
    return 2


def _cmd_serve_ingest(args) -> int:
    """The op-ingest frontend as a process: serve client ops until
    SIGTERM/SIGINT, then drain (stop accepting, flush and ack the
    admitted ops, final durable checkpoint) and print the summary."""
    import signal
    import threading

    if args.mesh_devices is not None:
        return _not_ported("--mesh-devices", "the device-mesh replica")
    if args.standby_of is not None:
        return _not_ported("--standby-of", "the warm-standby mode")
    if args.sched == "on":
        return _not_ported("--sched on", "the admission scheduler")
    fe = _build_frontend(args)
    if args.gc_participants is not None and args.compact_interval <= 0:
        print("WARNING: --gc-participants has no effect without "
              "--compact-interval > 0 — no compaction scheduler runs, "
              "deletion records will grow unboundedly", flush=True)
    host, bound = fe.serve(port=args.port, peer_port=args.peer_port)
    _ingest_banner(args, host, bound)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    fe.close()
    snap = fe.recorder.snapshot()
    acked = snap["counters"].get("serve.ops.acked", 0)
    lat = snap["observations"].get("serve.ingest_latency_s")
    p99 = f"{lat['p99'] * 1e3:.2f}ms" if lat else "n/a"
    print(f"drained: {acked} ops acked, ingest p99 {p99}", flush=True)
    return 0


def _peer_addr(text: str):
    host, _, port = text.rpartition(":")
    if not host or not port.isdigit():
        raise argparse.ArgumentTypeError(
            f"peer must be HOST:PORT, got {text!r}")
    return host, int(port)


def _gc_participants(text: str):
    try:
        return tuple(int(a) for a in text.split(",") if a.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--gc-participants wants comma-separated actor ids, "
            f"got {text!r}")


def _add_serve_parser(sub) -> None:
    """The ``serve`` verb's flags and defaults, as the JAX verb has
    them (``--device`` added)."""
    s = sub.add_parser("serve")
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--ingest", action="store_true",
                   help="run the op-ingest frontend (serve/); the Merger "
                        "bridge the JAX verb runs without it is not "
                        "ported yet")
    s.add_argument("--elements", type=int, default=1024,
                   help="element universe E of the served replica")
    s.add_argument("--actors", type=int, default=16,
                   help="actor axis A of the served replica")
    s.add_argument("--actor", type=int, default=0,
                   help="this replica's actor id")
    s.add_argument("--durable-dir", dest="durable_dir", default=None,
                   help="checkpoint+WAL directory: acks become durable "
                        "(fsync-before-ack); omitted = NON-durable "
                        "(benchmarks only)")
    s.add_argument("--peer", action="append", default=[], type=_peer_addr,
                   metavar="HOST:PORT",
                   help="anti-entropy peer to disseminate merged state "
                        "to (repeatable)")
    s.add_argument("--peer-port", dest="peer_port", type=int, default=None,
                   help="also serve anti-entropy exchanges on this port")
    s.add_argument("--max-batch", dest="max_batch", type=int, default=32,
                   help="micro-batch size watermark (ops per packed "
                        "apply)")
    s.add_argument("--flush-ms", dest="flush_ms", type=float, default=2.0,
                   help="micro-batch time watermark")
    s.add_argument("--queue-depth", dest="queue_depth", type=int,
                   default=256,
                   help="admission limit: beyond it ops shed with a "
                        "typed Overloaded reply")
    s.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=50,
                   help="durable checkpoint cadence in supervisor rounds "
                        "(0 = only the final drain checkpoint)")
    s.add_argument("--compact-interval", dest="compact_interval",
                   type=float, default=0.0,
                   help="background compaction cadence in seconds "
                        "(serve/compaction.py; 0 = disabled)")
    s.add_argument("--compact-p99-budget-ms", dest="compact_p99_budget_ms",
                   type=float, default=250.0,
                   help="recent ingest p99 above this means no headroom: "
                        "compaction backs off instead of running")
    s.add_argument("--gc-participants", dest="gc_participants",
                   default=None, type=_gc_participants,
                   metavar="A0,A1,...",
                   help="replica-actor ids participating in deletion-"
                        "record GC (omitted = derived from the peer "
                        "config; takes effect only with "
                        "--compact-interval > 0)")
    s.add_argument("--sync-mode", dest="sync_mode", default="delta",
                   choices=("delta", "digest"),
                   help="anti-entropy regime: 'digest' opens every "
                        "exchange with a per-lane-group digest summary "
                        "(K11 on the card) and ships only mismatched "
                        "lanes")
    s.add_argument("--no-fused-ingest", dest="fused_ingest",
                   action="store_false",
                   help="seed-comparison mode: two steps per batch "
                        "(apply, then the δ extraction for the WAL "
                        "record) and dense WAL records")
    s.add_argument("--sched", dest="sched", default="auto",
                   choices=("auto", "on", "off"),
                   help="admission scheduling; 'auto' and 'off' serve "
                        "FIFO on one device, 'on' is not ported yet")
    s.add_argument("--shard-id", dest="shard_id", default=None,
                   help="this frontend's shard id in its fleet")
    s.add_argument("--shard-epoch", dest="shard_epoch", type=int,
                   default=0,
                   help="this member's shard epoch (0 = fence dormant)")
    s.add_argument("--announce-to", dest="announce_to", action="append",
                   default=None, type=_peer_addr, metavar="HOST:PORT",
                   help="router address(es) to announce this member to "
                        "at startup")
    s.add_argument("--repl-ack-timeout-ms", dest="repl_ack_timeout_ms",
                   type=float, default=250.0,
                   help="semi-synchronous replication ack budget")
    s.add_argument("--standby-of", dest="standby_of", default=None,
                   type=_peer_addr, metavar="HOST:PORT",
                   help="warm-standby mode (not ported yet: exits 2)")
    s.add_argument("--mesh-devices", dest="mesh_devices", default=None,
                   metavar="N|DPxMP",
                   help="device-mesh replica (not ported yet: exits 2)")
    s.add_argument("--device", default="cuda",
                   help="torch device of the served replica (default "
                        "cuda; cpu runs the kernels' plain versions)")


def _rate(text: str) -> float:
    v = float(text)
    if not 0.0 <= v < 1.0:
        raise argparse.ArgumentTypeError(
            f"drop rate must be in [0, 1), got {v} (at 1.0 every "
            "exchange is lost and the fleet can never converge)")
    return v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="go_crdt_playground_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gossip")
    g.add_argument("--replicas", type=int, default=64)
    g.add_argument("--delta", action="store_true",
                   help="payload-compressed delta gossip (v2 semantics)")
    g.add_argument("--drop-rate", type=_rate, default=0.0,
                   help="per-replica exchange loss probability per round")
    g.add_argument("--seed", type=int, default=0,
                   help="seed of the drop masks and random pairings")
    g.add_argument("--schedule", default="dissemination",
                   choices=("dissemination", "ring", "random", "butterfly"),
                   help="anti-entropy pairing schedule per round")
    g.add_argument("--device", default="cuda",
                   help="torch device of the fleet (default cuda; cpu runs "
                        "the kernels' plain versions)")
    _add_serve_parser(sub)
    args = p.parse_args(argv)
    if args.cmd == "serve":
        if not args.ingest:
            return _not_ported("serve without --ingest",
                               "the Merger bridge server")
        return _cmd_serve_ingest(args)
    return _cmd_gossip(args.replicas, args.delta, args.drop_rate,
                       args.seed, args.schedule, args.device)


if __name__ == "__main__":
    sys.exit(main())
