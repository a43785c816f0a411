"""The port's BFT wire events (snarkos_tpu_torch/node/events.py) against the
JAX package's (snarkos_tpu/node/events.py): every sample of
tests/test_wire.py's EVENT_SAMPLES crosses both ways byte for byte, the
malformed frames that the JAX codec refuses the port refuses too, and
byte-flipped frames are accepted or refused alike, the accepted ones
re-encoding to the same bytes. The JAX side's modules run on the host and
import no JAX."""

import random

import pytest

import test_wire as jwire
from snarkos_tpu.node import events as jevents, types as jtypes
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.node import events


@pytest.mark.parametrize("i", range(len(jwire.EVENT_SAMPLES)),
                         ids=[type(e).__name__ for e in jwire.EVENT_SAMPLES])
def test_event_bytes_cross_both_ways(i):
    raw = jevents.serialize(jwire.EVENT_SAMPLES[i])
    ported = convert.event(raw)
    assert type(ported).__name__ == type(jwire.EVENT_SAMPLES[i]).__name__
    assert events.serialize(ported) == raw
    back = jevents.deserialize(events.serialize(ported))
    assert back == jwire.EVENT_SAMPLES[i]
    assert events.event_name(ported) == jevents.event_name(back)


def test_event_type_ids_match():
    assert {e.name: e.value for e in events.EventType} == \
        {e.name: e.value for e in jevents.EventType}
    assert {k.value: v.__name__ for k, v in events._TYPES.items()} == \
        {k.value: v.__name__ for k, v in jevents._TYPES.items()}


def _refused(decode, raw) -> bool:
    try:
        decode(raw)
    except Exception:
        return True
    return False


MALFORMED = {
    "empty": b"",
    "unknown type": b"\xff\xff\x00",
    "truncated": jevents.serialize(jevents.CertificateRequest(bytes(32)))[:-1],
    "trailing byte": jevents.serialize(jevents.ValidatorsRequest()) + b"\x00",
    "too many validators": b"\x0e\x00" + (201).to_bytes(4, "little"),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_refused_by_both(name):
    raw = MALFORMED[name]
    assert _refused(jevents.deserialize, raw)
    assert _refused(events.deserialize, raw)


@pytest.mark.parametrize("trial", range(60))
def test_fuzzed_frames_decode_alike(trial):
    """test_wire.py's test_event_codec_fuzz_no_crash inputs (the same seeds):
    both packages accept a frame or both refuse it, and an accepted frame
    re-encodes to the same bytes in both."""
    rng = random.Random(31000 + trial)
    base = bytearray(jevents.serialize(random.Random(3).choice([
        jevents.BlockRequest(1, 3),
        jevents.CertificateRequest(bytes(32)),
        jevents.ValidatorsRequest(),
        jevents.TransmissionRequest(jtypes.TransmissionID(0, bytes(32))),
    ])))
    for _ in range(rng.randrange(1, 4)):
        base[rng.randrange(len(base))] ^= 1 << rng.randrange(8)
    raw = bytes(base)
    try:
        want = jevents.serialize(jevents.deserialize(raw))
    except Exception:
        want = None
    try:
        got = events.serialize(events.deserialize(raw))
    except Exception:
        got = None
    assert got == want
