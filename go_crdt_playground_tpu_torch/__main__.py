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
are the JAX package's ``serve --ingest``.  With ``--standby-of H:P`` it
is the warm standby of that shard (shard/replica.py).  ``--mesh-devices
N|DPxMP`` serves a lane-sharded replica (parallel/meshtarget.py,
meshtarget2d.py) and ``--sched`` sets the admission scheduler
(serve/scheduler.py).  The device defaults to CUDA; the mesh slots
follow it (``--device cuda`` wants one card a slot, ``--device cuda:0``
puts every slot on card 0).

  python -m go_crdt_playground_tpu_torch router --serve --shard s0=H:P ...
      [--state-dir D] [--standby-of H:P] [--router-epoch N] ...
  python -m go_crdt_playground_tpu_torch router --shard s0=H:P ...
  python -m go_crdt_playground_tpu_torch reshard --router H:P
      --join s9=H:P | --leave s9
  python -m go_crdt_playground_tpu_torch autopilot --router H:P
      --standby s9=H:P ...

the router tier over N shard frontends (shard/router.py; without
``--serve`` it prints the seeded owner-map digest and exits), live
resharding, and the fleet autopilot (control/).  These verbs are
host-only: they load no torch and take no ``--device``.  Flags, banners
and exit codes are the JAX package's.
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


def _fmt_mesh(spec) -> str:
    """One banner token for any mesh spec: ``off``, ``N`` or ``DPxMP``
    (harnesses parse ``mesh=(\\w+)``)."""
    if spec is None:
        return "off"
    if isinstance(spec, tuple):
        return f"{spec[0]}x{spec[1]}"
    return str(spec)


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
          f"mesh={_fmt_mesh(args.mesh_devices)} "
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
        mesh_devices=args.mesh_devices,
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

    if args.standby_of is not None:
        return _cmd_serve_standby(args)
    fe = _build_frontend(args)
    if args.mesh_devices is not None and not args.fused_ingest:
        print("WARNING: --no-fused-ingest is ignored with "
              "--mesh-devices — the mesh write path is always the "
              "per-slot fused apply + δ (use a plain single-device "
              "worker for the seed two-step comparison)", flush=True)
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


def _cmd_serve_standby(args) -> int:
    """The warm-standby shard frontend (DESIGN.md §23): tail the
    primary's WAL, promote on its death under a bumped fenced shard
    epoch + router keyspace claim, and only THEN print the standard
    ``listening on`` banner — the promotion handshake, exactly the
    router-standby discipline."""
    import signal
    import threading

    from go_crdt_playground_tpu_torch.shard.replica import ShardStandby

    if args.port == 0:
        print("error: --standby-of requires a fixed --port (the "
              "router's ordered shard roster names the standby "
              "address BEFORE promotion)", file=sys.stderr, flush=True)
        return 2
    if args.durable_dir is None:
        print("error: --standby-of requires --durable-dir (the tailed "
              "replica and the fenced shard epoch must persist)",
              file=sys.stderr, flush=True)
        return 2
    if args.shard_id is None:
        print("error: --standby-of requires --shard-id (the keyspace "
              "failover claim names it at the router)",
              file=sys.stderr, flush=True)
        return 2
    fe = _build_frontend(args)
    standby = ShardStandby(
        tuple(args.standby_of), fe, sid=args.shard_id,
        standby_id=args.standby_id or f"{args.shard_id}-standby",
        listen_addr=("127.0.0.1", args.port),
        announce_to=args.announce_to,
        poll_interval_s=args.ha_poll_interval,
        failure_threshold=args.ha_failure_threshold)
    standby.start()
    print(f"Shard standby engaged (primary="
          f"{args.standby_of[0]}:{args.standby_of[1]} "
          f"sid={args.shard_id} port={args.port} "
          f"id={standby.standby_id} poll={args.ha_poll_interval}s "
          f"threshold={args.ha_failure_threshold})", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    promoted = False
    tailing_announced = False
    try:
        while not stop.is_set():
            if not tailing_announced and standby.tailed_ever:
                # the scriptable warm handshake: a standby that never
                # printed this has never tailed and will NOT promote
                # (the empty-replica / epoch-collision guard)
                print(f"Shard standby tailing primary wal "
                      f"(cursor={standby.cursor})", flush=True)
                tailing_announced = True
            if standby.await_promoted(0.2):
                promoted = True
                break
    except KeyboardInterrupt:
        pass
    if promoted:
        _ingest_banner(args, "127.0.0.1", args.port)
        try:
            stop.wait()
        except KeyboardInterrupt:
            pass
        snap = fe.recorder.snapshot()
        acked = snap["counters"].get("serve.ops.acked", 0)
        print(f"drained: {acked} ops acked (promoted standby, "
              f"reason={standby.promote_reason!r})", flush=True)
    standby.close()
    return 0


def _cmd_router(args) -> int:
    """The shard-router tier (DESIGN.md §17): serve the EXISTING client
    dialect over N shard frontends, or — without ``--serve`` — print
    the seeded owner-map digest + per-shard loads and exit, so two
    operators (or a test and a subprocess) can assert they route
    identically before any traffic moves."""
    from go_crdt_playground_tpu_torch.shard.ring import HashRing, load_stats

    sids = [sid for sid, _ in args.shard]
    if len(set(sids)) != len(sids):
        # dict() below would silently keep the LAST addr per id —
        # exactly the operator typo HashRing's duplicate check exists
        # to catch, so refuse before the dict can swallow it
        dupes = sorted({s for s in sids if sids.count(s) > 1})
        print(f"error: duplicate shard id(s) {dupes} in --shard flags",
              file=sys.stderr, flush=True)
        return 2
    shards = dict(args.shard)
    if not args.serve:
        # the dry-run must probe the ring a SERVING router would use:
        # with --state-dir that is the last committed membership, not
        # the flags (else the determinism probe falsely mismatches any
        # router that ever resharded)
        source = "flags"
        if args.state_dir:
            from go_crdt_playground_tpu_torch.shard.handoff import (
                PHASE_COMMITTED, load_ring_file)

            rec = load_ring_file(args.state_dir)
            if rec is not None and rec.get("phase") == PHASE_COMMITTED:
                if (int(rec.get("elements", args.elements))
                        != args.elements
                        or int(rec.get("seed", args.seed)) != args.seed):
                    print("error: persisted ring disagrees with the "
                          "(E, seed) flags — delete ring.json to reset",
                          file=sys.stderr, flush=True)
                    return 2
                shards = {s: (a[0], int(a[1]))
                          for s, a in rec["shards"].items()}
                source = "state-dir"
        ring = HashRing(list(shards), seed=args.seed)
        # ONE owner-map sweep shared by the load split and the digest
        # (it is the dry-run's dominant cost: E x shards blake2b)
        owners = ring.owner_map(args.elements)
        stats = load_stats(owners, len(ring.shards))
        print(f"owner-map digest {ring.digest(args.elements, owners)} "
              f"(shards={list(ring.shards)} seed={args.seed} "
              f"E={args.elements} ring from {source}) "
              f"loads={stats['loads']} "
              f"max/mean={stats['max_over_mean']:.3f}", flush=True)
        return 0

    import signal
    import threading

    if args.standby_of is not None:
        return _cmd_router_standby(args, shards)

    from go_crdt_playground_tpu_torch.shard.router import ShardRouter

    router = ShardRouter(shards, args.elements, seed=args.seed,
                         state_dir=args.state_dir,
                         transfer_timeout_s=args.transfer_timeout,
                         fleet_gc_interval_s=args.fleet_gc_interval,
                         router_epoch=args.router_epoch,
                         router_id=args.router_id)
    # the banner's load split reuses the router's OWN precomputed owner
    # map — recomputing it here would double the O(E x shards) blake2b
    # startup cost for a log line
    stats = load_stats(router._owner, len(router.ring.shards))
    rinfo = router.route().info()
    host, bound = router.serve(port=args.port)
    print(f"Shard router listening on {host}:{bound} "
          f"(E={args.elements} shards={list(router.ring.shards)} "
          f"seed={args.seed} loads={stats['loads']} "
          f"ring gen={rinfo['generation']} digest={rinfo['digest']})",
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    router.close()
    snap = router.recorder.snapshot()
    fwd = snap["counters"].get("router.ops.forwarded", 0)
    acks = snap["counters"].get("router.acks.relayed", 0)
    print(f"drained: {fwd} ops forwarded, {acks} acks relayed", flush=True)
    return 0


def _cmd_router_standby(args, shards) -> int:
    """The warm-standby router (DESIGN.md §22): tail the primary's
    committed ring, promote on its death under a bumped fenced epoch,
    and only THEN print the standard ``listening on`` banner — so the
    operator's (and the fleet runner's) address handshake doubles as
    the promotion signal."""
    import signal
    import threading

    from go_crdt_playground_tpu_torch.shard.ha import RouterStandby

    if args.port == 0:
        print("error: --standby-of requires a fixed --port (clients "
              "carry the standby address in their ordered failover "
              "list BEFORE promotion)", file=sys.stderr, flush=True)
        return 2
    if args.state_dir is None:
        print("error: --standby-of requires --state-dir (the tailed "
              "ring and the fenced router epoch must persist)",
              file=sys.stderr, flush=True)
        return 2
    standby = RouterStandby(
        tuple(args.standby_of), shards, args.elements, seed=args.seed,
        state_dir=args.state_dir,
        standby_id=args.router_id or "router-standby",
        listen_addr=("127.0.0.1", args.port),
        poll_interval_s=args.ha_poll_interval,
        failure_threshold=args.ha_failure_threshold,
        router_kwargs={"transfer_timeout_s": args.transfer_timeout,
                       "fleet_gc_interval_s": args.fleet_gc_interval})
    standby.start()
    print(f"Router standby engaged (primary="
          f"{args.standby_of[0]}:{args.standby_of[1]} "
          f"port={args.port} id={standby.standby_id} "
          f"poll={args.ha_poll_interval}s "
          f"threshold={args.ha_failure_threshold})", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    promoted = False
    tailing_announced = False
    try:
        while not stop.is_set():
            if not tailing_announced:
                rec = standby.last_record
                if rec is not None:
                    # the scriptable warm handshake: a standby that
                    # has never printed this line has never tailed and
                    # will NOT promote (shard/ha.py blocks promotion
                    # without a tailed record — epoch collision risk)
                    print(f"Router standby tailing primary ring "
                          f"(generation={rec.get('generation')} "
                          f"digest={rec.get('digest')} "
                          f"router-epoch={rec.get('router_epoch')})",
                          flush=True)
                    tailing_announced = True
            if standby.await_promoted(0.2):
                promoted = True
                break
    except KeyboardInterrupt:
        pass
    if promoted:
        router = standby.router
        rinfo = router.route().info()
        print(f"Shard router listening on 127.0.0.1:{args.port} "
              f"(E={args.elements} shards={list(router.ring.shards)} "
              f"seed={args.seed} ring gen={rinfo['generation']} "
              f"digest={rinfo['digest']} "
              f"router-epoch={router.router_epoch} "
              f"promoted-after={standby.promotion_s:.2f}s "
              f"reason={standby.promote_reason!r})", flush=True)
        try:
            stop.wait()
        except KeyboardInterrupt:
            pass
        snap = router.recorder.snapshot()
        fwd = snap["counters"].get("router.ops.forwarded", 0)
        acks = snap["counters"].get("router.acks.relayed", 0)
        print(f"drained: {fwd} ops forwarded, {acks} acks relayed",
              flush=True)
    standby.close()
    return 0


def _cmd_reshard(args) -> int:
    """The live-resharding admin verb (DESIGN.md §18), from the shell:
    one RESHARD frame to the router, block for the whole handoff, print
    the accounting JSON.  Exit 0 on commit; nonzero on abort — with the
    old ring still serving, so a failed resize is retryable, not an
    outage."""
    import json

    from go_crdt_playground_tpu_torch.serve import protocol
    from go_crdt_playground_tpu_torch.serve.client import ServeClient

    if args.join is not None:
        from go_crdt_playground_tpu_torch.serve.client import normalize_addrs

        # a roster spec joins by its ACTIVE member (the handoff pushes
        # one slice to one address; the roster shape is router config)
        mode, sid = protocol.RESHARD_JOIN, args.join[0]
        addr = normalize_addrs(args.join[1])[0]
    else:
        mode, sid, addr = protocol.RESHARD_LEAVE, args.leave, None
    with ServeClient(tuple(args.router), timeout=args.timeout) as c:
        ok, detail = c.reshard(mode, sid, addr, timeout=args.timeout)
    verb = "join" if mode == protocol.RESHARD_JOIN else "leave"
    print(json.dumps({"ok": ok, "mode": verb, "sid": sid,
                      "detail": detail}, indent=2), flush=True)
    return 0 if ok else 1


def _cmd_autopilot(args) -> int:
    """The fleet autopilot as a process (DESIGN.md §21): watch one
    router's STATS fan-out, split hot keyspaces onto standby shards /
    drain cold ones, one action in flight, every decision in the JSONL
    log.  SIGTERM/ctrl-C stops the loop; the fleet keeps serving —
    the controller is an OPERATOR, never a dependency."""
    import signal
    import threading

    from go_crdt_playground_tpu_torch.control import (FleetAutopilot,
                                                      PolicyConfig)

    config = PolicyConfig(
        p99_budget_s=args.p99_budget_ms / 1e3,
        queue_watermark=args.queue_watermark,
        hot_windows=args.hot_windows,
        cold_windows=args.cold_windows,
        cooldown_s=args.cooldown,
        abort_cooldown_s=args.abort_cooldown,
        min_shards=args.min_shards,
        max_shards=args.max_shards,
        cold_rate_per_shard=args.cold_rate)
    from go_crdt_playground_tpu_torch.serve.client import normalize_addrs

    routers = [tuple(a) for a in args.router]
    standbys = [(sid, normalize_addrs(a)[0]) for sid, a in args.standby]
    pilot = FleetAutopilot(
        routers, standbys, config=config,
        poll_interval_s=args.poll_interval,
        reshard_timeout_s=args.reshard_timeout,
        decision_log=args.decision_log, seed=args.seed)
    try:
        resumed = pilot.start()
    except ConnectionError as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"Fleet autopilot engaged over router "
          f"{'+'.join(f'{h}:{p}' for h, p in routers)} "
          f"(ring gen={resumed['generation']} "
          f"shards={resumed['shards']} "
          f"standbys={resumed['standbys']} "
          f"adopted={resumed['deployed_adopted']} "
          f"p99-budget={args.p99_budget_ms}ms "
          f"queue-watermark={args.queue_watermark:g} "
          f"poll={args.poll_interval}s "
          f"log={args.decision_log or 'off'})", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    pilot.stop()
    snap = pilot.recorder.snapshot()["counters"]
    print(f"autopilot stopped: {snap.get('control.polls', 0)} polls, "
          f"{snap.get('control.decisions.split', 0)} splits, "
          f"{snap.get('control.decisions.merge', 0)} merges, "
          f"{snap.get('control.actions.committed', 0)} committed, "
          f"{snap.get('control.actions.aborted', 0)} aborted",
          flush=True)
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
                   help="conflict-aware admission scheduling: reorder "
                        "each drained batch across key-runs (per-key "
                        "FIFO kept) and pre-stripe it for the 2-D mesh's "
                        "dp ingest stripes.  'auto' (default) enables it "
                        "exactly when --mesh-devices is DPxMP with dp > "
                        "1; 'off' is the FIFO baseline")
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
                   help="run as the warm standby of the primary shard "
                        "frontend at this address: tail its WAL into "
                        "--durable-dir, promote on its death under a "
                        "bumped fenced shard epoch, claim the keyspace "
                        "at --announce-to, then serve on --port (which "
                        "must be fixed).  Requires --durable-dir and "
                        "--shard-id")
    s.add_argument("--standby-id", dest="standby_id", default=None,
                   help="stable standby identity for epoch records and "
                        "replication logs (default: <shard-id>-standby)")
    s.add_argument("--ha-poll-interval", dest="ha_poll_interval",
                   type=float, default=0.1,
                   help="standby WAL tail/health poll cadence in seconds")
    s.add_argument("--ha-failure-threshold", dest="ha_failure_threshold",
                   type=int, default=5,
                   help="consecutive failed WAL_SYNC polls before the "
                        "standby promotes itself")
    def _mesh_devices_spec(text: str):
        """Typed ``--mesh-devices`` parser: ``N`` or ``DPxMP``; anything
        else exits 2 with a usage line."""
        from go_crdt_playground_tpu_torch.parallel.meshtarget2d import \
            parse_mesh_spec

        try:
            return parse_mesh_spec(text)
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e)) from e

    s.add_argument("--mesh-devices", dest="mesh_devices",
                   type=_mesh_devices_spec, default=None,
                   metavar="N|DPxMP",
                   help="hold the replica state on a mesh of slots.  N = "
                        "1-D lane mesh (parallel/meshtarget.py): slot-"
                        "local batch applies, K11 digest reads a slot, "
                        "lane-gather slice transfers.  DPxMP (e.g. 2x2) = "
                        "2-D mesh (parallel/meshtarget2d.py): lane fields "
                        "cut over MP while DP replicated ingest stripes "
                        "apply up to DP micro-batches a dispatch.  The "
                        "slots follow --device")
    s.add_argument("--device", default="cuda",
                   help="torch device of the served replica (default "
                        "cuda; cpu runs the kernels' plain versions)")


def _shard_spec(text: str):
    """``ID=HOST:PORT`` — or ``ID=HOST:PORT,HOST:PORT`` for an
    ordered replication-group roster (active member first, warm
    standbys behind it; DESIGN.md §23)."""
    sid, _, addr = text.partition("=")
    addrs = []
    for part in addr.split(","):
        host, _, port = part.rpartition(":")
        if not sid or not host or not port.isdigit():
            raise argparse.ArgumentTypeError(
                f"shard must be ID=HOST:PORT[,HOST:PORT...], "
                f"got {text!r}")
        addrs.append((host, int(port)))
    return sid, (addrs[0] if len(addrs) == 1 else addrs)


def _add_fleet_parsers(sub) -> None:
    """The ``router``, ``reshard`` and ``autopilot`` verbs' flags and
    defaults, as the JAX verbs have them."""
    r = sub.add_parser("router")
    r.add_argument("--serve", action="store_true",
                   help="serve the router tier (omit to print the "
                        "seeded owner-map digest and exit)")
    r.add_argument("--port", type=int, default=0)
    r.add_argument("--elements", type=int, default=1024,
                   help="fleet-wide element universe E (must match the "
                        "shards')")
    r.add_argument("--seed", type=int, default=0,
                   help="ring seed: same (shards, seed, E) routes "
                        "identically in ANY process")
    r.add_argument("--shard", action="append", default=[],
                   type=_shard_spec, metavar="ID=HOST:PORT", required=True,
                   help="one shard frontend (repeatable; order does not "
                        "affect routing)")
    r.add_argument("--state-dir", dest="state_dir", default=None,
                   help="persist committed ring swaps here (live "
                        "resharding, DESIGN.md §18): a restarted router "
                        "adopts the last committed ring over --shard "
                        "flags; a kill mid-handoff restarts on the old "
                        "ring")
    r.add_argument("--transfer-timeout", dest="transfer_timeout",
                   type=float, default=30.0,
                   help="keyspace-handoff transfer deadline in seconds "
                        "(size to the slice: past it the handoff aborts "
                        "and the old ring keeps serving)")
    r.add_argument("--fleet-gc-interval", dest="fleet_gc_interval",
                   type=float, default=0.0,
                   help="seconds between fleet-aware deletion-record GC "
                        "rounds (0 = off): the router aggregates every "
                        "shard's provable frontier into the true fleet "
                        "minimum and pushes it back for clamped local GC "
                        "(ROADMAP item c; requires every shard reachable "
                        "per round)")
    r.add_argument("--router-epoch", dest="router_epoch", type=int,
                   default=0,
                   help="router-leadership epoch (DESIGN.md §22, 0 = "
                        "fence dormant): shards adjudicate admin verbs "
                        "against the highest epoch they have seen — an "
                        "HA primary starts at 1, a promoted standby "
                        "persists primary+1.  The persisted record in "
                        "--state-dir wins over a smaller flag")
    r.add_argument("--router-id", dest="router_id", default=None,
                   help="stable router identity for epoch records and "
                        "HA logs (default: router-<pid>)")
    r.add_argument("--standby-of", dest="standby_of", default=None,
                   type=_peer_addr, metavar="HOST:PORT",
                   help="run as the WARM STANDBY of the primary router "
                        "at this address (DESIGN.md §22): tail its "
                        "committed ring into --state-dir, promote on "
                        "its death under a bumped fenced epoch, then "
                        "serve on --port (which must be fixed — "
                        "clients list it as their failover address).  "
                        "Requires --state-dir; --shard flags are the "
                        "fallback fleet if no ring was ever tailed")
    r.add_argument("--ha-poll-interval", dest="ha_poll_interval",
                   type=float, default=0.25,
                   help="standby health/tail poll cadence in seconds")
    r.add_argument("--ha-failure-threshold", dest="ha_failure_threshold",
                   type=int, default=3,
                   help="consecutive failed polls before the standby "
                        "promotes itself")

    rs = sub.add_parser(
        "reshard",
        help="live ring membership change against a running router "
             "(DESIGN.md §18): --join adds a shard (its keyspace slice "
             "is fenced, transferred, then the ring swaps atomically), "
             "--leave drains one out; a failed handoff leaves the old "
             "ring serving and exits nonzero")
    rs.add_argument("--router", required=True, metavar="HOST:PORT",
                    type=_peer_addr, help="the router's client address")
    grp = rs.add_mutually_exclusive_group(required=True)
    grp.add_argument("--join", default=None, type=_shard_spec,
                     metavar="ID=HOST:PORT",
                     help="add this serve --ingest frontend to the ring")
    grp.add_argument("--leave", default=None, metavar="ID",
                     help="remove this shard id from the ring (its "
                          "keyspace transfers to the survivors; the "
                          "shard process itself keeps running)")
    rs.add_argument("--timeout", type=float, default=120.0,
                    help="whole-handoff reply budget in seconds")

    ap_p = sub.add_parser(
        "autopilot",
        help="closed-loop fleet controller (DESIGN.md §21): watch a "
             "router's STATS fan-out and drive reshard --join/--leave "
             "itself — split hot keyspaces onto standby shards, drain "
             "cold ones, one action in flight, typed aborts cool down")
    ap_p.add_argument("--router", required=True, metavar="HOST:PORT",
                      type=_peer_addr, action="append", default=None,
                      help="the router's client address; repeatable as "
                           "an ORDERED failover list (primary first, "
                           "then warm standbys — DESIGN.md §22): the "
                           "controller re-resolves the active router "
                           "through it and rides a failover with only "
                           "a counted poll failure")
    ap_p.add_argument("--standby", action="append", default=[],
                      type=_shard_spec, metavar="ID=HOST:PORT",
                      help="one standby serve --ingest frontend the "
                           "controller may deploy (repeatable; splits "
                           "deploy in roster order, merges drain LIFO; "
                           "the controller never drains the operator's "
                           "initial fleet)")
    ap_p.add_argument("--poll-interval", dest="poll_interval",
                      type=float, default=1.0,
                      help="seconds between STATS polls (the signal "
                           "window unit)")
    ap_p.add_argument("--p99-budget-ms", dest="p99_budget_ms",
                      type=float, default=250.0,
                      help="windowed per-shard ingest p99 above this "
                           "burns the budget (a hot sample)")
    ap_p.add_argument("--queue-watermark", dest="queue_watermark",
                      type=float, default=48.0,
                      help="admission-queue depth at/above this is a "
                           "hot sample")
    ap_p.add_argument("--hot-windows", dest="hot_windows", type=int,
                      default=3,
                      help="consecutive hot polls before a split fires "
                           "(hysteresis)")
    ap_p.add_argument("--cold-windows", dest="cold_windows", type=int,
                      default=8,
                      help="consecutive cold polls before a merge fires")
    ap_p.add_argument("--cooldown", type=float, default=10.0,
                      help="post-commit hold window in seconds")
    ap_p.add_argument("--abort-cooldown", dest="abort_cooldown",
                      type=float, default=20.0,
                      help="post-abort hold window (longer: the fleet "
                           "just proved it was not ready)")
    ap_p.add_argument("--min-shards", dest="min_shards", type=int,
                      default=1)
    ap_p.add_argument("--max-shards", dest="max_shards", type=int,
                      default=8)
    ap_p.add_argument("--cold-rate", dest="cold_rate", type=float,
                      default=100.0,
                      help="fleet offered ops/s per REMAINING shard "
                           "under which a merge is considered")
    ap_p.add_argument("--reshard-timeout", dest="reshard_timeout",
                      type=float, default=120.0,
                      help="whole-handoff budget per action")
    ap_p.add_argument("--decision-log", dest="decision_log",
                      default=None,
                      help="append every decision/outcome as one JSONL "
                           "record here (the replayable audit trail "
                           "CONTROL_CURVE.json adjudicates)")
    ap_p.add_argument("--seed", type=int, default=0,
                      help="policy/actuator seed (decisions are a "
                           "deterministic function of the signal trace "
                           "given config + seed)")


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
    _add_fleet_parsers(sub)
    args = p.parse_args(argv)
    if args.cmd == "serve":
        if not args.ingest:
            return _not_ported("serve without --ingest",
                               "the Merger bridge server")
        return _cmd_serve_ingest(args)
    if args.cmd == "router":
        return _cmd_router(args)
    if args.cmd == "reshard":
        return _cmd_reshard(args)
    if args.cmd == "autopilot":
        return _cmd_autopilot(args)
    return _cmd_gossip(args.replicas, args.delta, args.drop_rate,
                       args.seed, args.schedule, args.device)


if __name__ == "__main__":
    sys.exit(main())
