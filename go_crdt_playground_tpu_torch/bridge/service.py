"""Merger bridge service: drive the packed merges from outside.

The counterpart of the JAX package's ``bridge/service.py``: an external
harness (the natural one is the Go client of the reference's own tests,
the JAX package's ``bridge/client/main.go``) submits two replica states
and gets back the merged result plus the conformance oracles
(SortedValues, the canonical String).  For every request the reply's
bytes are the JAX bridge's.

The execution path is the product path: proto -> spec -> pack
(utils/codec.py) -> the device: K3 for a full-state merge
(ops/merge.merge_one_into), K5 for a δ merge (ops/delta.
delta_merge_one_into), one launch each -> unpack -> proto.  The spec
model only carries the host-side (de)serialization.  The server runs on
``device`` ("cuda" unless asked; CPU tensors take the kernels' plain
versions).

Transport (Go-friendly, nothing beyond the standard library):

    frame   = method(1 byte) | length(uint32 big-endian) | body
    request  body = crdtbridge.MergeRequest   (method 0x01)
    response body = crdtbridge.MergeResponse  (same method byte echoed)
    ping          = method 0x02, empty body, echoed empty

One TCP connection carries any number of frames.  When grpcio is
installed the same messages are served as gRPC instead (``serve_grpc``).
The messages are encoded by hand (bridge/messages.py): no protobuf.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional, Tuple

from go_crdt_playground_tpu_torch.bridge import convert
from go_crdt_playground_tpu_torch.bridge import messages as pb

METHOD_MERGE = 0x01
METHOD_PING = 0x02

_MAX_BODY = 64 << 20


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, method: int, body: bytes) -> None:
    if len(body) > _MAX_BODY:
        raise ValueError(f"frame body {len(body)} exceeds {_MAX_BODY}")
    sock.sendall(struct.pack(">BI", method, len(body)) + body)


def recv_frame(sock: socket.socket) -> Tuple[int, bytes]:
    method, length = struct.unpack(">BI", _recv_exact(sock, 5))
    if length > _MAX_BODY:
        raise ValueError(f"frame body {length} exceeds {_MAX_BODY}")
    return method, _recv_exact(sock, length)


# ---------------------------------------------------------------------------
# Merge execution on the packed states
# ---------------------------------------------------------------------------


def _dimensions(*replicas) -> Tuple[int, int]:
    """(E, A) for packing a request's replica pair: E covers every key,
    A covers every VV slot and dot actor (zero-padding beyond is exact,
    crdt-misc.go:29-41)."""
    keys = set()
    num_actors = 1
    for rep in replicas:
        keys.update(rep.entries)
        num_actors = max(num_actors, len(rep.version_vector), rep.actor + 1)
        for d in rep.entries.values():
            num_actors = max(num_actors, d.actor + 1)
        deleted = getattr(rep, "deleted", None)
        if deleted:
            keys.update(deleted)
            for d in deleted.values():
                num_actors = max(num_actors, d.actor + 1)
        processed = getattr(rep, "processed", None)
        if processed:
            num_actors = max(num_actors, max(processed) + 1)
    return max(1, len(keys)), num_actors


def request_replicas(req: pb.MergeRequest):
    """The request's (dst, src) spec replicas, after the uint32 checks."""
    convert.check_uint32(req.dst, "dst")
    convert.check_uint32(req.src, "src")
    semantics = req.delta_semantics or "reference"
    return tuple(convert.replica_from_proto(
        rep, req.delta, semantics, req.strict_reference_semantics)
        for rep in (req.dst, req.src))


def merge_replicas(dst, src, delta: bool, delta_semantics: str,
                   strict_reference_semantics: bool, device):
    """dst absorbs src on the packed path: pack both as rows 0 and 1 of
    one state on ``device``, merge row 1 into row 0 (K3, or K5 for a δ
    merge, on CUDA), unpack row 0."""
    from go_crdt_playground_tpu_torch.models import awset, awset_delta
    from go_crdt_playground_tpu_torch.ops import delta as delta_ops
    from go_crdt_playground_tpu_torch.ops import merge as merge_ops
    from go_crdt_playground_tpu_torch.utils import codec

    E, A = _dimensions(dst, src)
    dictionary = codec.ElementDict(capacity=E)
    if delta:
        arrays = codec.pack_awset_deltas([dst, src], dictionary, A)
        state = awset_delta.from_arrays(arrays, device)
        merged = delta_ops.delta_merge_one_into(
            state, 0, state, 1, delta_semantics, strict_reference_semantics)
        return codec.unpack_awset_deltas(
            awset_delta.to_arrays(_row(merged, 0)), dictionary,
            delta_semantics)[0]
    arrays = codec.pack_awsets([dst, src], dictionary, A)
    state = awset.from_arrays(arrays, device)
    merged, _ = merge_ops.merge_one_into(state, 0, state, 1)
    return codec.unpack_awsets(awset.to_arrays(_row(merged, 0)),
                               dictionary)[0]


def _row(state, r: int):
    """Row r of every field, as a one-row batch (one host copy each)."""
    return type(state)(*(x[r:r + 1] for x in state))


def execute_merge(req: pb.MergeRequest, device="cuda") -> pb.MergeResponse:
    """Run one MergeRequest through the packed merge on ``device``."""
    from go_crdt_playground_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    try:
        dst, src = request_replicas(req)
        merged = merge_replicas(dst, src, req.delta,
                                req.delta_semantics or "reference",
                                req.strict_reference_semantics, dev)
    except (OverflowError, ValueError) as exc:
        return pb.MergeResponse(error=str(exc))
    return pb.MergeResponse(
        merged=convert.replica_to_proto(merged),
        sorted_values=merged.sorted_values(),
        canonical=str(merged),
    )


# ---------------------------------------------------------------------------
# Plain-TCP server / client
# ---------------------------------------------------------------------------


class MergerServer:
    """Serve the Merger service over the Go-friendly TCP framing, merging
    on ``device``.

    Half-open clients must not pin threads forever (``conn_timeout_s``),
    and connection threads are capped (``max_conns``): a dial past the
    cap is closed, not queued."""

    CONN_TIMEOUT_S = 120.0
    MAX_CONNS = 64

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 conn_timeout_s: Optional[float] = None,
                 max_conns: Optional[int] = None, device="cuda"):
        from go_crdt_playground_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.host = host
        self.port = port
        self.conn_timeout_s = (self.CONN_TIMEOUT_S if conn_timeout_s is None
                               else conn_timeout_s)
        self._sock: Optional[socket.socket] = None
        self._closing = threading.Event()
        self._conn_slots = threading.BoundedSemaphore(
            self.MAX_CONNS if max_conns is None else max_conns)

    def serve(self) -> Tuple[str, int]:
        """Bind + start accepting on a daemon thread; returns (host, port)."""
        self._sock = socket.create_server((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self.host, self.port

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._closing.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            if not self._conn_slots.acquire(blocking=False):
                conn.close()  # at capacity: shed load instead of queueing
                continue
            threading.Thread(
                target=self._handle_conn, args=(conn,), daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            self._serve_conn(conn)
        finally:
            self._conn_slots.release()

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(self.conn_timeout_s)
        with conn:
            while True:
                try:
                    method, body = recv_frame(conn)
                except (ConnectionError, OSError, ValueError):
                    # an idle or half-open client, or an oversized frame
                    return
                if method == METHOD_PING:
                    reply = (METHOD_PING, b"")
                elif method == METHOD_MERGE:
                    try:
                        resp = execute_merge(pb.MergeRequest.FromString(body),
                                             self.device)
                    except Exception as exc:  # malformed proto, kernel error
                        resp = pb.MergeResponse(error=repr(exc))
                    reply = (METHOD_MERGE, resp.SerializeToString())
                else:
                    resp = pb.MergeResponse(error=f"unknown method {method}")
                    reply = (method, resp.SerializeToString())
                try:
                    send_frame(conn, *reply)
                except (ConnectionError, OSError):
                    return  # a client that stopped reading

    def close(self) -> None:
        self._closing.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def __enter__(self) -> "MergerServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MergerClient:
    """Client of the TCP transport.  ``backoff``: an optional
    ``utils.backoff.BackoffPolicy``; with one the dial retries transient
    ``OSError`` failures on its jittered schedule, without one it is
    one-shot."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 backoff=None, backoff_seed: int = 0):
        if backoff is None:
            self._sock = socket.create_connection((host, port),
                                                  timeout=timeout)
        else:
            from go_crdt_playground_tpu_torch.utils.backoff import retry_call

            self._sock = retry_call(
                lambda: socket.create_connection((host, port),
                                                 timeout=timeout),
                backoff, retry_on=(OSError,), seed=backoff_seed)

    def ping(self) -> bool:
        send_frame(self._sock, METHOD_PING, b"")
        method, body = recv_frame(self._sock)
        return method == METHOD_PING and body == b""

    def merge_raw(self, req: pb.MergeRequest) -> pb.MergeResponse:
        send_frame(self._sock, METHOD_MERGE, req.SerializeToString())
        _, body = recv_frame(self._sock)
        return pb.MergeResponse.FromString(body)

    def merge(self, dst, src, delta: bool = False,
              delta_semantics: str = "reference",
              strict_reference_semantics: bool = True):
        """Ship two spec replicas, return the merged spec replica (raises
        on a service-reported error)."""
        req = pb.MergeRequest(
            dst=convert.replica_to_proto(dst),
            src=convert.replica_to_proto(src),
            delta=delta,
            delta_semantics=delta_semantics,
            strict_reference_semantics=strict_reference_semantics,
        )
        resp = self.merge_raw(req)
        if resp.error:
            raise RuntimeError(f"merge service error: {resp.error}")
        return convert.replica_from_proto(
            resp.merged, delta, delta_semantics, strict_reference_semantics)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "MergerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# gRPC adapter (optional: grpcio may be absent)
# ---------------------------------------------------------------------------


def serve_grpc(host: str = "127.0.0.1", port: int = 0, device="cuda"):
    """Serve the same Merger service as gRPC when grpcio exists, with the
    hand codec as its serializers.  Returns (server, port); raises
    ImportError with guidance otherwise (``MergerServer`` is the transport
    that is always there)."""
    from go_crdt_playground_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    try:
        import grpc
    except ImportError as exc:
        raise ImportError(
            "grpcio is not installed in this environment; use MergerServer "
            "(plain-TCP transport, same proto messages) or install grpcio "
            "to serve bridge/merger.proto as gRPC"
        ) from exc
    from concurrent import futures

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    rpc = grpc.unary_unary_rpc_method_handler(
        lambda req, ctx: execute_merge(req, dev),
        request_deserializer=pb.MergeRequest.FromString,
        response_serializer=pb.MergeResponse.SerializeToString,
    )
    service = grpc.method_handlers_generic_handler(
        "crdtbridge.Merger", {"Merge": rpc})
    server.add_generic_rpc_handlers((service,))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, bound
