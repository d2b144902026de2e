"""The port's Merger bridge (bridge/) against the JAX package's: the hand
codec of bridge/messages.py against protobuf's generated merger_pb2 both
ways, execute_merge's reply bytes over seeded requests (error replies
included), the Go client's T1-T3/T6 byte streams answered by a torch
server with the JAX server's bytes, clients and servers of the two
packages crossed, gRPC serving, and the bridge importing without
protobuf or grpc."""

import random
import socket
import struct
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.test_bridge_client as go_client
from go_crdt_playground_tpu.bridge import convert as jax_convert
from go_crdt_playground_tpu.bridge import merger_pb2 as pb
from go_crdt_playground_tpu.bridge import service as jax_service
from go_crdt_playground_tpu.models import spec as jax_spec
from go_crdt_playground_tpu_torch.bridge import convert, messages
from go_crdt_playground_tpu_torch.bridge import service
from go_crdt_playground_tpu_torch.models import spec

REPO = Path(__file__).resolve().parent.parent
U32, U64 = (1 << 32) - 1, (1 << 64) - 1

# -- the hand codec against protobuf ------------------------------------------

_keys = st.text(max_size=6)
_dot = st.one_of(st.none(), st.tuples(st.integers(0, U32),
                                      st.integers(0, U64)))
_entries = st.lists(st.tuples(_keys, _dot), max_size=3)
_u64s = st.lists(st.one_of(st.integers(0, 3), st.integers(0, U64)),
                 max_size=4)
_replica = st.one_of(st.none(), st.tuples(
    st.integers(0, U32), _u64s, _entries, _entries, _u64s))
_request = st.tuples(_replica, _replica, st.booleans(), _keys,
                     st.booleans())
_response = st.tuples(_replica, st.lists(_keys, max_size=3), _keys, _keys)


def _build(mod, kind, v):
    """One message of ``mod`` (merger_pb2 or messages) from plain values."""
    def dot(d):
        return mod.Dot(actor=d[0], counter=d[1])

    def entry(k, d):
        return (mod.Entry(key=k) if d is None else
                mod.Entry(key=k, dot=dot(d)))

    def replica(r):
        actor, vv, ents, dels, proc = r
        return mod.ReplicaState(
            actor=actor, version_vector=vv,
            entries=[entry(*e) for e in ents],
            deleted=[entry(*e) for e in dels], processed=proc)

    if kind == "request":
        dst, src, delta, sem, strict = v
        kw = dict(delta=delta, delta_semantics=sem,
                  strict_reference_semantics=strict)
        if dst is not None:
            kw["dst"] = replica(dst)
        if src is not None:
            kw["src"] = replica(src)
        return mod.MergeRequest(**kw)
    merged, values, canonical, error = v
    kw = dict(sorted_values=values, canonical=canonical, error=error)
    if merged is not None:
        kw["merged"] = replica(merged)
    return mod.MergeResponse(**kw)


def _plain(msg):
    """A message of either codec as nested plain values, presence kept."""
    out = {}
    for name in ("actor", "counter", "key", "dot", "version_vector",
                 "entries", "deleted", "processed", "dst", "src", "delta",
                 "delta_semantics", "strict_reference_semantics", "merged",
                 "sorted_values", "canonical", "error"):
        try:
            v = getattr(msg, name)
        except AttributeError:
            continue
        if name in ("dot", "dst", "src", "merged"):
            out[name] = _plain(v) if msg.HasField(name) else None
        elif name in ("entries", "deleted"):
            out[name] = [_plain(e) for e in v]
        elif name in ("version_vector", "processed", "sorted_values"):
            out[name] = list(v)
        else:
            out[name] = v
    return out


@settings(max_examples=150, deadline=None)
@given(st.one_of(st.tuples(st.just("request"), _request),
                 st.tuples(st.just("response"), _response)))
def test_messages_serialize_to_protobuf_bytes(case):
    kind, values = case
    ours, theirs = _build(messages, kind, values), _build(pb, kind, values)
    data = theirs.SerializeToString()
    assert ours.SerializeToString() == data
    cls = messages.MergeRequest if kind == "request" else \
        messages.MergeResponse
    pcls = pb.MergeRequest if kind == "request" else pb.MergeResponse
    assert _plain(cls.FromString(data)) == _plain(theirs)
    assert _plain(pcls.FromString(ours.SerializeToString())) == _plain(ours)


def _varint(v):
    return go_client._varint(v)


@settings(max_examples=100, deadline=None)
@given(_u64s.filter(bool), _u64s, st.lists(st.tuples(
    st.integers(6, 2000), st.sampled_from([0, 1, 2, 5]),
    st.binary(max_size=9)), max_size=4), st.integers(0, 8))
def test_unpacked_repeated_and_unknown_fields_parse_alike(vv, proc, unknown,
                                                          where):
    """Repeated uint64 written unpacked (one varint field each), and
    unknown fields of every wire type spliced in between them: both
    codecs read the same message."""
    fields = [go_client._tag(2, 0) + _varint(c) for c in vv]
    fields.append(go_client._len_field(5, b"".join(_varint(c)
                                                    for c in proc)))
    extra = b""
    for number, wire, payload in unknown:
        extra += go_client._tag(number, wire)
        if wire == 0:
            extra += _varint(int.from_bytes(payload, "little") & U64)
        elif wire == 1:
            extra += payload.ljust(8, b"\0")[:8]
        elif wire == 5:
            extra += payload.ljust(4, b"\0")[:4]
        else:
            extra += _varint(len(payload)) + payload
    fields.insert(where % (len(fields) + 1), extra)
    data = b"".join(fields)
    ours = messages.ReplicaState.FromString(data)
    theirs = pb.ReplicaState.FromString(data)
    assert _plain(ours) == _plain(theirs)
    assert list(ours.version_vector) == vv
    wrapped = go_client._len_field(1, data) + extra
    assert _plain(messages.MergeRequest.FromString(wrapped)) == \
        _plain(pb.MergeRequest.FromString(wrapped))


def test_truncated_and_malformed_input_raise_as_protobuf_does():
    req = pb.MergeRequest(dst=jax_convert.replica_to_proto(
        _two(jax_spec)[0]), delta=True, delta_semantics="v2")
    data = req.SerializeToString()
    cases = [data[:n] for n in range(1, len(data))]
    cases += [b"\x0a\x05\x08", b"\x22\x02\xff\xfe", b"\x00", b"\x0c",
              b"\x08" + b"\xff" * 10 + b"\x01", b"\x0b\x10\x01"]
    for bad in cases:
        try:
            pb.MergeRequest.FromString(bad)
        except Exception as exc:  # noqa: BLE001 - protobuf's DecodeError
            with pytest.raises(messages.DecodeError) as ours:
                messages.MergeRequest.FromString(bad)
            assert repr(ours.value) == repr(exc)
            assert isinstance(ours.value, ValueError)
        else:
            assert _plain(messages.MergeRequest.FromString(bad)) == \
                _plain(pb.MergeRequest.FromString(bad))
    with pytest.raises(ValueError, match="out of range"):
        messages.Dot(actor=1 << 32)
    with pytest.raises(ValueError, match="out of range"):
        messages.ReplicaState(version_vector=[-1]).SerializeToString()


# -- execute_merge against the JAX bridge -------------------------------------


def _two(mod, delta=False, sem="reference"):
    cls = mod.AWSetDelta if delta else mod.AWSet
    kw = dict(delta_semantics=sem) if delta else {}
    return tuple(cls(actor=a, version_vector=mod.VersionVector([0, 0]), **kw)
                 for a in (0, 1))


def _random_request(rng):
    """A seeded request over the JAX spec: random histories, counters
    past 2^31, now and then past 2^32 - 1 or an unknown δ mode (the error
    replies)."""
    delta = rng.random() < 0.5
    sem = rng.choice(["", "reference", "v2"])
    actors = rng.randint(1, 4)
    keys = [f"k{i}" for i in range(rng.choice([1, 3, 6]))] + ["ü\"q"]
    reps = []
    for _ in range(2):
        actor = rng.randrange(actors)
        vv = jax_spec.VersionVector([0] * rng.randint(0, actors))
        if delta:
            reps.append(jax_spec.AWSetDelta(actor=actor, version_vector=vv,
                                            delta_semantics=sem or
                                            "reference"))
        else:
            reps.append(jax_spec.AWSet(actor=actor, version_vector=vv))
    for _ in range(rng.randint(0, 10)):
        r = reps[rng.randrange(2)]
        if len(r.version_vector) <= r.actor:
            r.version_vector.v.extend(
                [0] * (r.actor + 1 - len(r.version_vector)))
        roll = rng.random()
        if roll < 0.5:
            r.add(rng.choice(keys))
        elif roll < 0.7:
            r.del_(rng.choice(keys))
        else:
            r.merge(reps[0] if r is reps[1] else reps[0])
    if rng.random() < 0.3:   # counters in int32-bit territory
        for r in reps:
            r.version_vector.v = [c + 0x7FFFFFF0 if c else c
                                  for c in r.version_vector.v]
    req = pb.MergeRequest(
        dst=jax_convert.replica_to_proto(reps[0]),
        src=jax_convert.replica_to_proto(reps[1]),
        delta=delta, delta_semantics=sem,
        strict_reference_semantics=rng.random() < 0.5)
    roll = rng.random()
    if roll < 0.05:
        req.dst.version_vector.append(U32 + 1)
    elif roll < 0.1:
        req.src.entries.add(key="big", dot=pb.Dot(actor=0, counter=1 << 40))
    elif roll < 0.13:
        req.delta, req.delta_semantics = True, "v3"
    return req.SerializeToString()


@pytest.mark.parametrize("block", range(6))
def test_execute_merge_replies_match_jax(block):
    """300 seeded requests in six blocks: the torch bridge's reply bytes
    equal the JAX bridge's, error replies included, and the merged
    replica is the spec merge of the port's spec model."""
    rng = random.Random(1000 + block)
    errors = 0
    for _ in range(50):
        body = _random_request(rng)
        want = jax_service.execute_merge(
            pb.MergeRequest.FromString(body)).SerializeToString()
        req = messages.MergeRequest.FromString(body)
        got = service.execute_merge(req, device="cpu")
        assert got.SerializeToString() == want
        if got.error:
            errors += 1
            continue
        # the spec merge on the packed path's actor axis (zero padding
        # is exact, crdt-misc.go:29-41)
        dst, src = service.request_replicas(req)
        num_a = service._dimensions(dst, src)[1]
        for rep in (dst, src):
            rep.version_vector.v += [0] * (num_a - len(rep.version_vector))
        dst.merge(src)
        assert got.canonical == str(dst)
        assert got.sorted_values == dst.sorted_values()
    assert 0 < errors < 50


def test_uint32_edges_survive_the_round_trip():
    a, b = _two(spec, delta=True, sem="v2")
    a.version_vector.v = [U32, 0x80000000]
    a.entries["x"] = spec.Dot(0, U32)
    a.processed = {0: U32}
    b.version_vector.v = [0x80000001, 0x80000000]
    b.entries["y"] = spec.Dot(1, 0x80000000)
    b.deleted["x"] = spec.Dot(1, 0x7FFFFFFF)
    req = messages.MergeRequest(
        dst=convert.replica_to_proto(a), src=convert.replica_to_proto(b),
        delta=True, delta_semantics="v2")
    body = req.SerializeToString()
    got = service.execute_merge(req, device="cpu")
    assert got.SerializeToString() == jax_service.execute_merge(
        pb.MergeRequest.FromString(body)).SerializeToString()
    assert list(got.merged.version_vector) == [U32, 0x80000000]
    assert got.merged.processed == [U32, 0x80000000]
    over = messages.MergeRequest(dst=messages.ReplicaState(
        processed=[U32 + 1]))
    resp = service.execute_merge(over, device="cpu")
    assert resp.error == ("dst: counter 4294967296 exceeds the packed "
                          "kernels' uint32 range (4294967295)")


# -- servers and clients ------------------------------------------------------


class DualMirror:
    """tests/test_bridge_client.py's Go client, speaking its exact byte
    stream to a JAX and a torch MergerServer at once: every reply frame
    must be byte-identical before the state is installed."""

    def __init__(self):
        self.servers = [jax_service.MergerServer(),
                        service.MergerServer(device="cpu")]
        self.socks = [socket.create_connection(s.serve())
                      for s in self.servers]
        self.frames = 0

    def close(self):
        for s in self.socks + self.servers:
            s.close()

    def _roundtrip(self, method, body):
        replies = []
        for sock in self.socks:
            sock.sendall(struct.pack(">BI", method, len(body)) + body)
            head = service._recv_exact(sock, 5)
            replies.append(head + service._recv_exact(
                sock, struct.unpack(">BI", head)[1]))
        assert replies[0] == replies[1]
        self.frames += 1
        return replies[1][5:]

    def ping(self):
        assert self._roundtrip(service.METHOD_PING, b"") == b""

    def _install(self, dst, body, delta):
        resp = messages.MergeResponse.FromString(
            self._roundtrip(service.METHOD_MERGE, body))
        assert not resp.error, resp.error
        dst.version_vector = jax_spec.VersionVector(
            list(resp.merged.version_vector))
        dst.entries = {e.key: jax_spec.Dot(e.dot.actor, e.dot.counter)
                       for e in resp.merged.entries}
        if delta:
            dst.deleted = {e.key: jax_spec.Dot(e.dot.actor, e.dot.counter)
                           for e in resp.merged.deleted}
        assert str(dst) == resp.canonical
        assert resp.sorted_values == dst.sorted_values()

    def merge(self, dst, src):
        self._install(dst, go_client._enc_merge_request(dst, src), False)

    def delta_merge(self, dst, src):
        self._install(dst, go_client._enc_delta_merge_request(dst, src),
                      True)


@pytest.mark.parametrize("scenario", ["test_t1_awset_xxx_replay",
                                      "test_t2_awset_replay",
                                      "test_t3_concurrent_add_wins_replay",
                                      "test_t6_awset_delta_replay"])
def test_go_client_streams_get_the_jax_servers_bytes(scenario):
    mirror = DualMirror()
    try:
        mirror.ping()
        getattr(go_client, scenario)(mirror)
        assert mirror.frames > 2
    finally:
        mirror.close()


def test_clients_and_servers_of_the_two_packages_cross():
    a, b = _two(spec)
    a.add("Anne", "Bob")
    b.add("Anne")
    a.del_("Bob")
    ja, jb = _two(jax_spec)
    ja.add("Anne", "Bob")
    jb.add("Anne")
    ja.del_("Bob")
    with service.MergerServer(device="cpu") as tsrv, \
            jax_service.MergerServer() as jsrv:
        thost, tport = tsrv.serve()
        jhost, jport = jsrv.serve()
        with jax_service.MergerClient(thost, tport) as jc, \
                service.MergerClient(jhost, jport) as tc:
            assert jc.ping() and tc.ping()
            got_by_jax = jc.merge(ja, jb)
            got_by_port = tc.merge(a, b)
            assert str(got_by_jax) == str(got_by_port)
            for delta_sem in ("reference", "v2"):
                da, db = _two(spec, delta=True, sem=delta_sem)
                jda, jdb = _two(jax_spec, delta=True, sem=delta_sem)
                for x in (da, db, jda, jdb):
                    x.add("k")
                assert str(jc.merge(jda, jdb, delta=True,
                                    delta_semantics=delta_sem)) == \
                    str(tc.merge(da, db, delta=True,
                                 delta_semantics=delta_sem))
            over = messages.MergeRequest(dst=messages.ReplicaState(
                version_vector=[U32 + 1]))
            assert "uint32 range" in tc.merge_raw(over).error
    from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy

    with service.MergerServer(device="cpu") as tsrv:
        with service.MergerClient(*tsrv.serve(), backoff=BackoffPolicy(
                max_retries=2)) as c:
            assert c.ping()


def test_unknown_method_malformed_body_and_capacity():
    with service.MergerServer(device="cpu", max_conns=1) as srv, \
            jax_service.MergerServer() as jsrv:
        host, port = srv.serve()
        jhost, jport = jsrv.serve()
        socks = [socket.create_connection((host, port)),
                 socket.create_connection((jhost, jport))]
        for method, body in ((7, b""), (service.METHOD_MERGE, b"\x0a\x05")):
            replies = []
            for s in socks:
                service.send_frame(s, method, body)
                replies.append(service.recv_frame(s))
            assert replies[0] == replies[1]
        # past max_conns a dial is closed, not queued
        extra = socket.create_connection((host, port))
        extra.settimeout(5)
        assert extra.recv(1) == b""
        for s in socks + [extra]:
            s.close()


def test_serve_grpc_on_the_cpu():
    grpc = pytest.importorskip("grpc")
    server, port = service.serve_grpc(device="cpu")
    try:
        a, b = _two(spec, delta=True, sem="v2")
        a.add("x")
        b.add("y")
        req = messages.MergeRequest(
            dst=convert.replica_to_proto(a), src=convert.replica_to_proto(b),
            delta=True, delta_semantics="v2")
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            call = channel.unary_unary(
                "/crdtbridge.Merger/Merge",
                request_serializer=messages.MergeRequest.SerializeToString,
                response_deserializer=messages.MergeResponse.FromString)
            resp = call(req, timeout=30)
        assert resp == service.execute_merge(req, device="cpu")
        assert resp.sorted_values == ["x", "y"]
    finally:
        server.stop(None)


def test_the_bridge_imports_without_protobuf_grpc_or_jax():
    code = ("import sys\n"
            "for m in ('google', 'google.protobuf', 'grpc', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "from go_crdt_playground_tpu_torch.bridge import (MergerServer,\n"
            "    execute_merge, serve_grpc, messages)\n"
            "from go_crdt_playground_tpu_torch import native\n"
            "r = execute_merge(messages.MergeRequest(), device='cpu')\n"
            "assert r.canonical == '[(A 0)]', r\n"
            "try:\n"
            "    serve_grpc(device='cpu')\n"
            "except ImportError as e:\n"
            "    assert 'grpcio is not installed' in str(e)\n"
            "else:\n"
            "    raise AssertionError('serve_grpc without grpc')\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
