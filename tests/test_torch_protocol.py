"""The port's serve protocol (serve/protocol.py) against the JAX
package's, by bytes: every serve-protocol codec of the reference's
codec registry (analysis/codec_symmetry.build_codecs) run on the port's
functions through the same contract harness (round trip, truncation at
every boundary, seeded garble, varint inflation: typed errors only),
then both packages' encoders fed the same seeded arguments to identical
bytes, each package decoding the other's; plus the hand-crafted
adversarial bodies of tests/test_protocol_contract.py."""

import numpy as np
import pytest

from go_crdt_playground_tpu.analysis.codec_symmetry import (_eq,
                                                            build_codecs,
                                                            check_codec)
from go_crdt_playground_tpu.serve import protocol as jax_protocol
from go_crdt_playground_tpu_torch.net.framing import ProtocolError
from go_crdt_playground_tpu_torch.serve import protocol
from tests.test_protocol_contract import _varint

SPECS = [s for s in build_codecs()
         if s.encode.__module__ == jax_protocol.__name__]


def _port_spec(spec):
    """The registry's spec bound to the port's codec functions."""
    enc, dec = spec.covers
    return spec._replace(encode=getattr(protocol, enc),
                         decode=getattr(protocol, dec),
                         typed_errors=(ProtocolError,))


def test_registry_covers_the_port_protocol():
    names = {n for s in SPECS for n in s.covers}
    codecs = {n for n in vars(protocol)
              if n.startswith(("encode_", "decode_"))}
    assert len(SPECS) == 24 and codecs == names


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_codec_contract_on_the_port(spec):
    findings = check_codec(_port_spec(spec), np.random.default_rng(1234),
                           n_samples=3, n_garbles=12)
    assert not findings, [f.render() for f in findings]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_codec_bytes_equal_across_packages(spec):
    port = _port_spec(spec)
    rng = np.random.default_rng(77)
    for _ in range(8):
        args = spec.gen(rng)
        body = spec.encode(*args)
        assert port.encode(*args) == body
        want = spec.decode(body)
        assert _eq(port.decode(body), want)
        assert _eq(spec.decode(port.encode(*args)), want)


def test_reject_codes_and_exceptions_match_the_reference():
    assert protocol.REJECT_EXCEPTIONS.keys() == \
        jax_protocol.REJECT_EXCEPTIONS.keys()
    for code, exc in protocol.REJECT_EXCEPTIONS.items():
        assert exc.__name__ == jax_protocol.REJECT_EXCEPTIONS[code].__name__
    for name in dir(jax_protocol):
        if name.startswith(("MSG_", "OP_", "REJECT_", "RESHARD_", "WAL_")) \
                and isinstance(getattr(jax_protocol, name), int):
            assert getattr(protocol, name) == getattr(jax_protocol, name)


def test_members_vv_entry_over_uint32_is_typed():
    body = _varint(7) + _varint(0) + _varint(1) + _varint(1 << 32)
    with pytest.raises(ProtocolError):
        protocol.decode_members(body)


def test_members_count_beyond_body_is_typed_not_alloc():
    with pytest.raises(ProtocolError):
        protocol.decode_members(_varint(7) + _varint(0) + _varint(1 << 40))
    with pytest.raises(ProtocolError):
        protocol.decode_members(_varint(7) + _varint(1 << 40))


def test_frontier_reply_oversized_count_is_typed():
    with pytest.raises(ProtocolError):
        protocol.decode_frontier_reply(_varint(7) + bytes([0])
                                       + _varint(1 << 40))


def test_op_oversized_key_count_is_typed():
    body = (_varint(7) + bytes([protocol.OP_ADD]) + _varint(0)
            + _varint(1 << 40))
    with pytest.raises(ProtocolError):
        protocol.decode_op(body)
