"""W003 codec symmetry (DESIGN.md §15): every encode has a decode that
inverts it, and every decode fails TYPED on hostile bytes.

The wire surface spans four modules — ``serve/protocol.py``,
``net/framing.py``, ``net/digestsync.py``, ``utils/wire.py`` — and
until now only a handful of hand-written tests pinned individual
codecs (``TruncatedFrame``, a few roundtrips).  This pass declares THE
registry of encode/decode pairs and property-checks each one with
seeded inputs:

* **roundtrip identity** — ``decode(encode(*args))`` must equal the
  declared oracle projection of ``args``;
* **truncation** — every strict prefix of an encoded body must raise
  the module's TYPED error class (``ProtocolError`` for frame
  dialects, ``ValueError`` for the wire layer).  Codecs whose body
  ends in free-form bytes (utf-8 reason, JSON, opaque payload) may
  legitimately decode a truncated tail — for those, prefixes must
  decode-or-raise-typed, never raise untyped;
* **garble** — seeded byte corruption must decode-or-raise-typed.
  The contract under attack is the ERROR TYPE: an ``IndexError`` /
  ``OverflowError`` / ``UnicodeDecodeError`` escaping a decoder
  bypasses the dialect's typed-error mapping and kills the reader
  thread that called it.

The payload codecs run twice, through the native codec
(``native/codec.cpp``, the default) and the Python one
(``prefer_native=False``): the two must be the same function, hostile
bytes included.  Payloads are the port's ``DeltaPayload``: int32
tensors holding uint32 bits.

Registry completeness is itself checked: every public ``encode_*`` /
``decode_*`` name in the four modules must be covered by some spec —
a codec registered nowhere is a codec whose decode can drift from its
encode without any gate noticing (exactly how ``decode_members``
shipped without the uint32 range check every sibling had).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from go_crdt_playground_tpu_torch.analysis.report import (
    CODEC_ASYMMETRY, SEVERITY_ERROR, Finding)

# property-harness universe: small so all-prefix truncation stays cheap
E = 16
A = 4

# the four wire modules whose public codec surface must be covered
WIRE_MODULES = ("serve/protocol.py", "net/framing.py",
                "net/digestsync.py", "utils/wire.py")


class CodecSpec(NamedTuple):
    """One encode/decode pair under property check.

    ``gen(rng)`` returns encoder args; ``encode(*args) -> bytes``;
    ``decode(body)`` is closed over the harness dimensions;
    ``expected(args)`` is the decoded-value oracle; ``compare``
    defaults to recursive equality with array support.
    ``self_delimiting=False`` marks bodies with free-form tails
    (truncation may legally decode).  ``covers`` lists the public
    module functions this spec exercises, for the completeness
    check."""

    name: str
    encode: Callable[..., bytes]
    decode: Callable[[bytes], Any]
    gen: Callable[[np.random.Generator], tuple]
    expected: Callable[[tuple], Any]
    typed_errors: Tuple[type, ...]
    covers: Tuple[str, ...]
    self_delimiting: bool = True
    compare: Optional[Callable[[Any, Any], bool]] = None


def _host(x: Any) -> Any:
    """A tensor as numpy (int32 lanes read back as their uint32 bits)."""
    import torch

    from go_crdt_playground_tpu_torch._u32 import host

    return host(x) if isinstance(x, torch.Tensor) else x


def _eq(a: Any, b: Any) -> bool:
    a, b = _host(a), _host(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).shape == np.asarray(b).shape
                and bool(np.array_equal(np.asarray(a), np.asarray(b))))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return (len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict) and isinstance(b, dict):
        return (set(a) == set(b)
                and all(_eq(a[k], b[k]) for k in a))
    return bool(a == b)


def _payload_eq(got, want) -> bool:
    """DeltaPayload comparison on every shipped field (src_processed
    rides out-of-band for some codecs — the oracle sets what the codec
    promises)."""
    for f in ("src_vv", "changed", "ch_da", "ch_dc", "deleted",
              "del_da", "del_dc", "src_actor", "src_processed"):
        if not _eq(getattr(got, f), getattr(want, f)):
            return False
    return True


# ---------------------------------------------------------------------------
# Seeded generators
# ---------------------------------------------------------------------------


def _rid(rng) -> int:
    return int(rng.integers(0, 1 << 20))


def _vv(rng) -> np.ndarray:
    return rng.integers(0, 50, A).astype(np.uint32)


def _elements(rng, lo: int = 1, hi: int = 5) -> List[int]:
    k = int(rng.integers(lo, hi))
    return [int(e) for e in rng.choice(E, size=k, replace=False)]


def _canonical_payload(rng, *, fresh_deletions_vs=None):
    """A DeltaPayload whose unmasked lanes are zero (the wire form
    round-trips masked lanes only, scattering zeros elsewhere — the
    generator bakes that canonicalization in so equality is exact).
    With ``fresh_deletions_vs`` (a guard vv), some deletion dots are
    deliberately placed BELOW the guard to exercise the WAL record
    deletion filter."""
    from go_crdt_playground_tpu_torch._u32 import from_numpy_u32
    from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload

    def u32(a) -> "torch.Tensor":  # noqa: F821
        return from_numpy_u32(np.asarray(a, np.uint32), "cpu")

    def flags(a) -> "torch.Tensor":  # noqa: F821
        import torch

        return torch.from_numpy(np.asarray(a, bool).copy())

    changed = rng.random(E) < 0.3
    deleted = (rng.random(E) < 0.3) & ~changed
    ch_da = np.where(changed, rng.integers(0, A, E), 0).astype(np.uint32)
    ch_dc = np.where(changed, rng.integers(1, 60, E), 0).astype(np.uint32)
    del_da = np.where(deleted, rng.integers(0, A, E), 0).astype(np.uint32)
    if fresh_deletions_vs is not None:
        # straddle the guard: ~half fresh (> guard), ~half stale
        guard = np.take(np.asarray(fresh_deletions_vs, np.uint32),
                        del_da.astype(np.int64), mode="clip")
        fresh = rng.random(E) < 0.5
        dc = np.where(fresh, guard + 1 + rng.integers(0, 5, E),
                      np.maximum(guard, 1) - rng.integers(0, 1, E))
        del_dc = np.where(deleted, dc, 0).astype(np.uint32)
    else:
        del_dc = np.where(deleted, rng.integers(1, 60, E),
                          0).astype(np.uint32)
    return DeltaPayload(
        src_vv=u32(_vv(rng)),
        changed=flags(changed),
        ch_da=u32(ch_da), ch_dc=u32(ch_dc),
        deleted=flags(deleted),
        del_da=u32(del_da), del_dc=u32(del_dc),
        src_actor=u32(int(rng.integers(0, A))),
        src_processed=u32(_vv(rng)))


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def build_codecs() -> List[CodecSpec]:
    from go_crdt_playground_tpu_torch.net import digestsync, framing
    from go_crdt_playground_tpu_torch.net.framing import ProtocolError
    from go_crdt_playground_tpu_torch.ops.digest import num_groups
    from go_crdt_playground_tpu_torch.serve import protocol as p
    from go_crdt_playground_tpu_torch.utils import wire

    P = (ProtocolError,)
    V = (ValueError,)
    specs: List[CodecSpec] = []

    def add(*args, **kw):
        specs.append(CodecSpec(*args, **kw))

    # -- serve/protocol.py ---------------------------------------------------
    add("op", p.encode_op, p.decode_op,
        lambda rng: (_rid(rng), int(rng.integers(0, 2)), _elements(rng),
                     int(rng.integers(0, 1 << 20))),
        lambda a: (a[0], a[1], list(a[2]), a[3]), P,
        ("encode_op", "decode_op"))
    add("ack", p.encode_ack, p.decode_ack,
        lambda rng: (_rid(rng),), lambda a: a[0], P,
        ("encode_ack", "decode_ack"))
    add("reject", p.encode_reject, p.decode_reject,
        lambda rng: (_rid(rng),
                     int(rng.choice(sorted(p.REJECT_EXCEPTIONS))),
                     "reason-" + str(int(rng.integers(100)))),
        lambda a: (a[0], a[1], a[2]), P,
        ("encode_reject", "decode_reject"), self_delimiting=False)
    add("query", p.encode_query, p.decode_query,
        lambda rng: (_rid(rng),), lambda a: a[0], P,
        ("encode_query", "decode_query"))
    add("stats", p.encode_stats, p.decode_stats,
        lambda rng: (_rid(rng),), lambda a: a[0], P,
        ("encode_stats", "decode_stats"))
    add("stats_reply", p.encode_stats_reply, p.decode_stats_reply,
        lambda rng: (_rid(rng),
                     {"counters": {"x": int(rng.integers(100))}}),
        lambda a: (a[0], a[1]), P,
        ("encode_stats_reply", "decode_stats_reply"),
        self_delimiting=False)
    add("members", p.encode_members,
        lambda body: p.decode_members(body),
        lambda rng: (_rid(rng), _elements(rng, 0, 5), _vv(rng)),
        lambda a: (a[0], list(a[1]), np.asarray(a[2], np.uint32)), P,
        ("encode_members", "decode_members"))
    add("reshard", p.encode_reshard, p.decode_reshard,
        lambda rng: ((_rid(rng), p.RESHARD_JOIN, "s1",
                      ("127.0.0.1", int(rng.integers(1, 1 << 16))))
                     if rng.random() < 0.5
                     else (_rid(rng), p.RESHARD_LEAVE, "s2", None)),
        lambda a: a, P, ("encode_reshard", "decode_reshard"))
    add("reshard_reply", p.encode_reshard_reply, p.decode_reshard_reply,
        lambda rng: (_rid(rng), bool(rng.integers(0, 2)),
                     {"moved": int(rng.integers(100))}),
        lambda a: a, P,
        ("encode_reshard_reply", "decode_reshard_reply"),
        self_delimiting=False)
    add("slice_pull", p.encode_slice_pull, p.decode_slice_pull,
        lambda rng: (_rid(rng), _elements(rng)),
        lambda a: (a[0], list(a[1])), P,
        ("encode_slice_pull", "decode_slice_pull"))
    add("slice_state", p.encode_slice_state, p.decode_slice_state,
        lambda rng: (_rid(rng),
                     rng.integers(0, 256, int(rng.integers(1, 40)))
                     .astype(np.uint8).tobytes()),
        lambda a: a, P, ("encode_slice_state", "decode_slice_state"),
        self_delimiting=False)
    add("slice_push", p.encode_slice_push, p.decode_slice_push,
        lambda rng: (_rid(rng),
                     rng.integers(0, 256, int(rng.integers(1, 40)))
                     .astype(np.uint8).tobytes()),
        lambda a: a, P, ("encode_slice_push", "decode_slice_push"),
        self_delimiting=False)
    add("frontier", p.encode_frontier, p.decode_frontier,
        lambda rng: (_rid(rng),), lambda a: a[0], P,
        ("encode_frontier", "decode_frontier"))
    add("frontier_reply", p.encode_frontier_reply,
        p.decode_frontier_reply,
        lambda rng: (_rid(rng), _vv(rng), _vv(rng),
                     bool(rng.integers(0, 2))),
        lambda a: (a[0], np.asarray(a[1], np.uint32),
                   np.asarray(a[2], np.uint32), a[3]), P,
        ("encode_frontier_reply", "decode_frontier_reply"))
    add("gc", p.encode_gc, p.decode_gc,
        lambda rng: (_rid(rng), _vv(rng)),
        lambda a: (a[0], np.asarray(a[1], np.uint32)), P,
        ("encode_gc", "decode_gc"))
    add("gc_reply", p.encode_gc_reply, p.decode_gc_reply,
        lambda rng: (_rid(rng), int(rng.integers(100)),
                     int(rng.integers(100))),
        lambda a: a, P, ("encode_gc_reply", "decode_gc_reply"))
    add("dsum", p.encode_dsum, p.decode_dsum,
        lambda rng: (_rid(rng),), lambda a: a[0], P,
        ("encode_dsum", "decode_dsum"))
    add("dsum_reply", p.encode_dsum_reply, p.decode_dsum_reply,
        lambda rng: (_rid(rng),
                     rng.integers(0, 256, int(rng.integers(1, 40)))
                     .astype(np.uint8).tobytes()),
        lambda a: a, P, ("encode_dsum_reply", "decode_dsum_reply"),
        self_delimiting=False)
    add("ring_sync", p.encode_ring_sync, p.decode_ring_sync,
        lambda rng: (_rid(rng), int(rng.integers(0, 1 << 16)),
                     "router-" + str(int(rng.integers(100)))),
        lambda a: a, P, ("encode_ring_sync", "decode_ring_sync"))
    add("ring_sync_reply", p.encode_ring_sync_reply,
        p.decode_ring_sync_reply,
        lambda rng: (_rid(rng),
                     {"router_epoch": int(rng.integers(0, 1 << 16)),
                      "generation": int(rng.integers(100))}),
        lambda a: a, P,
        ("encode_ring_sync_reply", "decode_ring_sync_reply"),
        self_delimiting=False)

    def gen_wal_sync(rng):
        catchup = rng.random() < 0.4
        summary = (rng.integers(0, 256, int(rng.integers(1, 60)))
                   .astype(np.uint8).tobytes() if catchup else None)
        return (_rid(rng), int(rng.integers(1, 1 << 20)),
                int(rng.integers(0, 1 << 12)),
                "sb-" + str(int(rng.integers(100))),
                int(rng.integers(0, 2000)), int(rng.integers(0, 512)),
                summary)

    add("wal_sync", p.encode_wal_sync, p.decode_wal_sync,
        gen_wal_sync,
        lambda a: (a[0], a[2], a[3], a[1], a[4], a[5], a[6]), P,
        ("encode_wal_sync", "decode_wal_sync"),
        self_delimiting=False)

    def gen_wal_sync_reply(rng):
        catchup = rng.random() < 0.3
        if catchup:
            records = ()
            payload = (rng.integers(0, 256, int(rng.integers(1, 60)))
                       .astype(np.uint8).tobytes())
        else:
            records = tuple(
                rng.integers(0, 256, int(rng.integers(0, 30)))
                .astype(np.uint8).tobytes()
                for _ in range(int(rng.integers(0, 5))))
            payload = None
        first = int(rng.integers(1, 1 << 16))
        return (_rid(rng), int(rng.integers(0, 2)),
                int(rng.integers(0, 1 << 12)),
                "s" + str(int(rng.integers(10))),
                "%08x" % int(rng.integers(1 << 31)),
                first, first + len(records), first, records, payload)

    def cmp_wal_sync_reply(got, want) -> bool:
        # the encoder ORs WAL_CATCHUP_PAYLOAD into flags when a
        # payload rides along; compare modulo that bit, everything
        # else exactly
        exp_flags = want[1] | (p.WAL_CATCHUP_PAYLOAD
                               if want[9] is not None else 0)
        return (got.req_id, got.flags, got.shard_epoch, got.shard_id,
                got.nonce, got.min_seq, got.next_seq, got.first_seq,
                tuple(got.records), got.payload) == (
            want[0], exp_flags, want[2], want[3], want[4], want[5],
            want[6], want[7], tuple(want[8]), want[9])

    add("wal_sync_reply", p.encode_wal_sync_reply,
        p.decode_wal_sync_reply, gen_wal_sync_reply,
        lambda a: a, P,
        ("encode_wal_sync_reply", "decode_wal_sync_reply"),
        self_delimiting=False, compare=cmp_wal_sync_reply)

    add("shard_failover", p.encode_shard_failover,
        p.decode_shard_failover,
        lambda rng: (_rid(rng), int(rng.integers(1, 1 << 12)),
                     "s" + str(int(rng.integers(10))),
                     "sb-" + str(int(rng.integers(100))),
                     ("127.0.0.1", int(rng.integers(1, 1 << 16)))),
        lambda a: a, P,
        ("encode_shard_failover", "decode_shard_failover"))
    add("shard_failover_reply", p.encode_shard_failover_reply,
        p.decode_shard_failover_reply,
        lambda rng: (_rid(rng),
                     {"sid": "s1", "shard_epoch": int(rng.integers(100)),
                      "swapped": bool(rng.integers(0, 2))}),
        lambda a: a, P,
        ("encode_shard_failover_reply", "decode_shard_failover_reply"),
        self_delimiting=False)

    # -- net/framing.py ------------------------------------------------------
    add("hello", framing.encode_hello,
        lambda body: framing.decode_hello(body, E, A),
        lambda rng: (int(rng.integers(0, A)), E, _vv(rng)),
        lambda a: (a[0], np.asarray(a[2], np.uint32)), P,
        ("encode_hello", "decode_hello"))

    def gen_payload_msg(rng):
        mode = int(rng.choice((framing.MODE_DELTA, framing.MODE_FULL,
                               framing.MODE_SLICE, framing.MODE_DIGEST)))
        payload = _canonical_payload(rng)
        return (mode, int(_host(payload.src_actor)),
                _host(payload.src_processed), payload)

    def cmp_payload_msg(got, want) -> bool:
        return got[0] == want[0] and _payload_eq(got[1], want[1])

    add("payload_msg", framing.encode_payload_msg,
        lambda body: framing.decode_payload_msg(body, E, A),
        gen_payload_msg,
        lambda a: (a[0], a[3]._replace()), P,
        ("encode_payload_msg", "decode_payload_msg"),
        compare=cmp_payload_msg)

    def gen_wal_record(rng):
        pre_vv = _vv(rng)
        payload = _canonical_payload(rng, fresh_deletions_vs=pre_vv)
        return (pre_vv, int(_host(payload.src_actor)), payload,
                None, bool(rng.integers(0, 2)))

    def enc_wal_record(pre_vv, src_actor, payload, compact,
                       compact_records) -> bytes:
        body, _ = framing.encode_delta_wal_record(
            pre_vv, src_actor, payload, compact,
            compact_records=compact_records)
        return body

    def dec_wal_record(body: bytes):
        # the replay-side dispatch (net/peer.Node.replay form): a 0x00
        # lead byte can never open a dense record, so it tags compact
        if body[:1] == bytes([wire.WAL_COMPACT_TAG]):
            return wire.decode_compact_wal_body(body, E, A)
        guard, pos = wire._decode_vv_py(body, 0, A)
        _mode, payload = framing.decode_payload_msg(body[pos:], E, A)
        return guard, payload

    def exp_wal_record(a):
        pre_vv, _src_actor, payload, _c, _cr = a
        # the record contract: deletion dots covered by the guard are
        # filtered (they replay from earlier records), masked-out
        # lanes scatter back as zeros
        del_da, del_dc = _host(payload.del_da), _host(payload.del_dc)
        deleted = _host(payload.deleted) & (
            del_dc > np.take(pre_vv, del_da.astype(np.int64), mode="clip"))
        want = payload._replace(
            deleted=deleted,
            del_da=np.where(deleted, del_da, 0).astype(np.uint32),
            del_dc=np.where(deleted, del_dc, 0).astype(np.uint32))
        return np.asarray(pre_vv, np.uint32), want

    add("delta_wal_record", enc_wal_record, dec_wal_record,
        gen_wal_record, exp_wal_record, P + V,
        ("encode_delta_wal_record",),
        compare=lambda got, want: (_eq(got[0], want[0])
                                   and _payload_eq(got[1], want[1])))

    # -- utils/wire.py -------------------------------------------------------
    def gen_payload(rng):
        return (_canonical_payload(rng),)

    def exp_payload(a):
        # src_processed/src_actor ride out-of-band: decode zeroes them
        return a[0]._replace(src_actor=np.uint32(0),
                             src_processed=np.zeros(A, np.uint32))

    add("payload", wire.encode_payload,
        lambda body: wire.decode_payload(body, E, A),
        gen_payload, exp_payload, V,
        ("encode_payload", "decode_payload", "payload_nbytes_wire"),
        compare=_payload_eq)
    # the same pair on the Python codec: the native one is the default
    # (and silently the Python one where it does not build), so each
    # path is held to the contract on its own
    add("payload_py",
        lambda payload: wire.encode_payload(payload, prefer_native=False),
        lambda body: wire.decode_payload(body, E, A, prefer_native=False),
        gen_payload, exp_payload, V,
        ("encode_payload", "decode_payload"), compare=_payload_eq)
    add("payload_lanes",
        lambda payload: wire.encode_payload_lanes(payload, E),
        lambda body: wire.decode_payload_lanes(body, E, A),
        gen_payload, exp_payload, V,
        ("encode_payload_lanes", "decode_payload_lanes"),
        compare=_payload_eq)

    def gen_compact_wal(rng):
        payload = _canonical_payload(rng)
        ch = np.nonzero(_host(payload.changed))[0]
        dl = np.nonzero(_host(payload.deleted))[0]
        return (_vv(rng), int(_host(payload.src_actor)),
                _host(payload.src_processed), _host(payload.src_vv),
                ch, _host(payload.ch_da)[ch], _host(payload.ch_dc)[ch],
                dl, _host(payload.del_da)[dl], _host(payload.del_dc)[dl],
                E, payload)

    add("compact_wal_body",
        lambda *a: wire.encode_compact_wal_body(*a[:11]),
        lambda body: wire.decode_compact_wal_body(body, E, A),
        gen_compact_wal,
        lambda a: (np.asarray(a[0], np.uint32), a[11]), V,
        ("encode_compact_wal_body", "decode_compact_wal_body"),
        compare=lambda got, want: (_eq(got[0], want[0])
                                   and _payload_eq(got[1], want[1])))

    # -- net/digestsync.py ---------------------------------------------------
    GS = 4

    def gen_summary(rng):
        g = num_groups(E, GS)
        return (int(rng.integers(0, A)), E, GS, _vv(rng), _vv(rng),
                rng.integers(0, 1 << 32, g).astype(np.uint32))

    add("summary", digestsync.encode_summary,
        lambda body: digestsync.decode_summary(body, E, A),
        gen_summary,
        lambda a: (a[0], a[2], np.asarray(a[3], np.uint32),
                   np.asarray(a[4], np.uint32),
                   np.asarray(a[5], np.uint32)), P,
        ("encode_summary", "decode_summary"))
    return specs


# ---------------------------------------------------------------------------
# The property harness
# ---------------------------------------------------------------------------

# error types that may NEVER escape a decoder: they bypass the typed
# mapping and kill the reader thread that called it
_MAX_TRUNC_POSITIONS = 192


def check_codec(spec: CodecSpec, rng: np.random.Generator, *,
                n_samples: int, n_garbles: int) -> List[Finding]:
    findings: List[Finding] = []
    compare = spec.compare if spec.compare is not None else _eq

    def err(msg: str) -> None:
        findings.append(Finding(
            analyzer="codec_symmetry", code=CODEC_ASYMMETRY,
            severity=SEVERITY_ERROR, symbol=spec.name, message=msg))

    for i in range(n_samples):
        args = spec.gen(rng)
        try:
            body = spec.encode(*args)
        except Exception as e:  # noqa: BLE001 — an encoder refusing
            err(f"encode raised on generated args (sample {i}): "
                f"{type(e).__name__}: {e}")
            continue
        # 1. roundtrip identity
        try:
            got = spec.decode(body)
        except Exception as e:  # noqa: BLE001
            err(f"decode raised on its own encode (sample {i}): "
                f"{type(e).__name__}: {e}")
            continue
        if not compare(got, spec.expected(args)):
            err(f"roundtrip mismatch (sample {i}): decode(encode(...)) "
                "differs from the declared oracle — the decode drifted "
                "from its encode")
            continue
        # 2. truncation at every boundary (sampled when the body is
        # large): typed error, or — free-form-tail codecs only — a
        # successful decode of the shorter tail
        if len(body) <= _MAX_TRUNC_POSITIONS:
            cuts = range(len(body))
        else:
            cuts = sorted({0, 1, len(body) - 1} | {
                int(c) for c in rng.integers(
                    0, len(body), _MAX_TRUNC_POSITIONS - 3)})
        for cut in cuts:
            try:
                spec.decode(body[:cut])
            except spec.typed_errors:
                continue
            except Exception as e:  # noqa: BLE001 — the finding
                err(f"UNTYPED {type(e).__name__} on truncation at byte "
                    f"{cut}/{len(body)} (sample {i}): hostile bytes "
                    "must map to the dialect's typed error, not kill "
                    f"the reader thread ({e})")
                break
            else:
                if spec.self_delimiting:
                    err(f"truncated prefix ACCEPTED at byte "
                        f"{cut}/{len(body)} (sample {i}): a torn body "
                        "decoded as a complete frame")
                    break
        # 3. seeded garble: decode-or-typed, never untyped
        for g in range(n_garbles):
            pos = int(rng.integers(0, len(body)))
            flip = int(rng.integers(1, 256))
            garbled = (body[:pos] + bytes([body[pos] ^ flip])
                       + body[pos + 1:])
            try:
                spec.decode(garbled)
            except spec.typed_errors:
                continue
            except Exception as e:  # noqa: BLE001
                err(f"UNTYPED {type(e).__name__} on garbled byte "
                    f"{pos} (sample {i}, xor {flip:#x}): {e}")
                break
        # 4. varint inflation at every byte position: splice in a
        # 5-byte varint decoding to 2^32 — one past uint32 — so any
        # count/dot/clock field missing its range check converts to an
        # OverflowError (or a giant allocation) instead of the typed
        # reject.  Deterministic, because a random byte flip almost
        # never manufactures a >32-bit varint (how decode_members
        # shipped without the range check every sibling had).
        inflate = b"\x80\x80\x80\x80\x10"  # varint(2**32)
        positions = (range(len(body)) if len(body) <= _MAX_TRUNC_POSITIONS
                     else sorted({int(c) for c in rng.integers(
                         0, len(body), _MAX_TRUNC_POSITIONS)}))
        for pos in positions:
            inflated = body[:pos] + inflate + body[pos + 1:]
            try:
                spec.decode(inflated)
            except spec.typed_errors:
                continue
            except Exception as e:  # noqa: BLE001
                err(f"UNTYPED {type(e).__name__} on varint inflation "
                    f"at byte {pos} (sample {i}): a >uint32 field must "
                    f"map to the typed error, got: {e}")
                break
    return findings


def check_coverage(root: str, specs: List[CodecSpec],
                   loader=None) -> Tuple[List[Finding], Dict]:
    """Every public encode_*/decode_* in the wire modules must be
    covered by some spec."""
    import ast as _ast

    from go_crdt_playground_tpu_torch.analysis.loader import ensure_loader
    loader = ensure_loader(loader)
    covered = {name for s in specs for name in s.covers}
    findings: List[Finding] = []
    per_module: Dict[str, List[str]] = {}
    for rel in WIRE_MODULES:
        path = os.path.join(root, rel)
        tree = loader.load(path).tree
        names = [n.name for n in tree.body
                 if isinstance(n, (_ast.FunctionDef,
                                   _ast.AsyncFunctionDef))
                 and (n.name.startswith("encode_")
                      or n.name.startswith("decode_"))]
        per_module[rel] = names
        for name in names:
            if name not in covered:
                findings.append(Finding(
                    analyzer="codec_symmetry", code=CODEC_ASYMMETRY,
                    severity=SEVERITY_ERROR, path=path, symbol=name,
                    message=f"codec function {name} is not covered by "
                            "any CodecSpec in analysis/codec_symmetry "
                            "— its symmetry is unverified (register "
                            "it, or fold it into an existing spec's "
                            "covers tuple)"))
    return findings, {"codec_functions": sum(len(v)
                                             for v in per_module.values())}


def analyze(root: str, *, fast: bool = False, seed: int = 7,
            loader=None) -> Tuple[List[Finding], Dict]:
    specs = build_codecs()
    findings, stats = check_coverage(root, specs, loader=loader)
    n_samples = 2 if fast else 5
    n_garbles = 8 if fast else 24
    rng = np.random.default_rng(seed)
    for spec in specs:
        findings.extend(check_codec(spec, rng, n_samples=n_samples,
                                    n_garbles=n_garbles))
    stats.update(codecs=len(specs), samples_per_codec=n_samples,
                 garbles_per_sample=n_garbles, seed=seed,
                 codec_names=sorted(s.name for s in specs))
    return findings, stats
