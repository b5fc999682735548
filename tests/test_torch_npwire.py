"""The port's npwire codec against the JAX package's, byte for byte.

The port copies ``service/npwire.py``; these tests hold the copy to the
same bytes.  For every combination of the optional frame blocks (error,
trace, deadline, tenant, partition, version; the spans tail; plain and
batch frames), with a fixed uuid, both packages must encode the same
bytes and each must decode the other's frames.  Every dtype the wire
carries crosses both ways, 0-d and empty arrays included; a corrupt
frame is a ``WireError`` with the same text in both.  Mirrors
``tests/test_npwire.py``, ``test_npwire_properties.py`` and
``test_tenant_wire.py``.
"""

import itertools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

from pytensor_federated_tpu.service import npwire as jw
from pytensor_federated_torch.service import npwire as tw

UUID = bytes(range(16))
TRACE = b"t" * 16
BLOCKS = ("error", "trace", "deadline", "tenant", "partition", "version")
VALUES = {
    "error": "boom: bad input — café",
    "trace": TRACE,
    "deadline": 0.25,
    "tenant": "acme/eu",
    "partition": (1, 3, 4, 4, 11),
    "version": 7,
}
KWARG = {"trace": "trace_id", "deadline": "deadline_s"}
COMBOS = [c for r in range(len(BLOCKS) + 1) for c in itertools.combinations(BLOCKS, r)]
SPANS = [{"name": "node.evaluate", "trace_id": TRACE.hex(), "span_id": 1, "duration_s": 0.5}]


def _kwargs(combo):
    return {KWARG.get(b, b): VALUES[b] for b in combo}


def _arrays():
    rng = np.random.default_rng(0)
    return [np.float32(1.5), rng.normal(size=(3, 4)), np.arange(5, dtype=np.int64)]


def _assert_arrays_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "+".join(c) or "plain")
def test_frames_are_byte_identical_and_cross_decode(combo):
    kw = _kwargs(combo)
    arrays = _arrays()
    jf = jw.encode_arrays(arrays, uuid=UUID, **kw)
    tf = tw.encode_arrays(arrays, uuid=UUID, **kw)
    assert tf == jf
    assert b"".join(tw.encode_arrays_sg(arrays, uuid=UUID, **kw)) == jf
    assert tw.append_spans(tf, SPANS) == jw.append_spans(jf, SPANS)

    jb = jw.encode_batch([jf, jw.encode_arrays([], uuid=UUID)], uuid=UUID, **kw)
    tb = tw.encode_batch([tf, tw.encode_arrays([], uuid=UUID)], uuid=UUID, **kw)
    assert tb == jb

    for enc, dec in ((jw, tw), (tw, jw)):
        frame = enc.append_spans(enc.encode_arrays(arrays, uuid=UUID, **kw), SPANS)
        out, uid, err, trace, spans, part, ver = dec.decode_arrays_part(frame)
        _assert_arrays_equal(out, arrays)
        assert uid == UUID and err == kw.get("error") and trace == kw.get("trace_id")
        assert spans == SPANS and part == kw.get("partition") and ver == kw.get("version")
        assert dec.peek_deadline(frame) == kw.get("deadline_s")
        assert dec.peek_tenant(frame) == kw.get("tenant")
        assert dec.peek_partition(frame) == kw.get("partition")

        batch = enc.encode_batch([enc.encode_arrays(arrays, uuid=UUID)], uuid=UUID, **kw)
        items, uid, err, trace, spans, part, ver = dec.decode_batch_part(batch)
        assert dec.is_batch_frame(batch) and uid == UUID and err == kw.get("error")
        assert part == kw.get("partition") and ver == kw.get("version")
        _assert_arrays_equal(dec.decode_arrays(items[0])[0], arrays)


DTYPE_CASES = {
    "f2": np.array([1.5, -2.25], dtype=np.float16),
    "f4": np.arange(6, dtype=np.float32).reshape(2, 3),
    "f8": np.random.default_rng(1).normal(size=(4, 5)),
    "c8": np.array([1 + 2j, -3j], dtype=np.complex64),
    "i1": np.array([-128, 127], dtype=np.int8),
    "i2": np.array([-5, 9], dtype=np.int16),
    "i4": np.array([[1, 2], [3, 4]], dtype=np.int32),
    "i8": np.array([1, 2, 3], dtype=np.int64),
    "u1": np.array([0, 255], dtype=np.uint8),
    "u8": np.array([2**63], dtype=np.uint64),
    "bool": np.array([True, False, True]),
    "0-d f4": np.float32(4.5),
    "0-d bool": np.array(True),
    "empty": np.zeros((0, 3), dtype=np.float32),
    "non-contiguous": np.arange(20, dtype=np.float32).reshape(4, 5)[:, ::2],
    "big-endian": np.arange(3, dtype=">f8"),
    "unicode": np.array(["hello", "wire"]),
}


@pytest.mark.parametrize("arr", list(DTYPE_CASES.values()), ids=list(DTYPE_CASES))
def test_every_dtype_crosses_both_ways(arr):
    jf = jw.encode_arrays([arr], uuid=UUID)
    assert tw.encode_arrays([arr], uuid=UUID) == jf
    for enc, dec in ((jw, tw), (tw, jw)):
        (out,), uid, err = dec.decode_arrays(enc.encode_arrays([arr], uuid=UUID))
        assert uid == UUID and err is None
        assert out.dtype == arr.dtype and out.shape == np.shape(arr)
        np.testing.assert_array_equal(out, arr)


def _corrupt_frames():
    good = jw.encode_arrays([np.ones(100)], uuid=UUID)
    bad_dtype = bytearray(jw.encode_arrays([np.zeros(3, np.float32)], uuid=UUID))
    bad_dtype[28:30] = b"\xff\xfe"  # dtype string starts after header + u16 length
    missing_version = bytearray(jw.encode_arrays([], uuid=UUID))
    missing_version[jw._FLAGS_OFF] |= 0x80
    short_tenant = bytearray(jw.encode_arrays([], uuid=UUID, tenant="acme"))
    return {
        "truncated": good[: len(good) // 2],
        "magic": b"XXXX" + good[4:],
        "utf8-dtype": bytes(bad_dtype),
        "missing-version-block": bytes(missing_version),
        "short-tenant": bytes(short_tenant[:-2]),
        "header-only": good[:10],
    }


@pytest.mark.parametrize("name", list(_corrupt_frames()))
def test_a_corrupt_frame_is_a_wire_error_in_both(name):
    frame = _corrupt_frames()[name]
    with pytest.raises(jw.WireError) as je:
        jw.decode_arrays(frame)
    with pytest.raises(tw.WireError) as te:
        tw.decode_arrays(frame)
    assert str(te.value) == str(je.value)
    assert not issubclass(tw.WireError, jw.WireError)  # two packages, two classes


def test_encoder_refusals_match():
    cases = [
        ([], {"uuid": b"short"}),
        ([], {"trace_id": b"x"}),
        ([], {"tenant": ""}),
        ([np.array([object()])], {}),
    ]
    for arrays, kw in cases:
        with pytest.raises(jw.WireError) as je:
            jw.encode_arrays(arrays, **{"uuid": UUID, **kw})
        with pytest.raises(tw.WireError) as te:
            tw.encode_arrays(arrays, **{"uuid": UUID, **kw})
        assert str(te.value) == str(je.value)


_dtypes = st.sampled_from(
    [np.float16, np.float32, np.float64, np.int8, np.int32, np.int64, np.uint16, np.bool_]
)
_arrays_st = _dtypes.flatmap(
    lambda dt: hnp.arrays(dt, hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=4))
)


@settings(max_examples=60, deadline=None)
@given(arrays=st.lists(_arrays_st, max_size=4), tenant=st.none() | st.text(min_size=1, max_size=12))
def test_property_round_trip_and_cross_decode(arrays, tenant):
    jf = jw.encode_arrays(arrays, uuid=UUID, tenant=tenant)
    tf = tw.encode_arrays(arrays, uuid=UUID, tenant=tenant)
    assert tf == jf
    for dec in (jw, tw):
        out, uid, err = dec.decode_arrays(tf)
        assert uid == UUID and err is None and len(out) == len(arrays)
        for o, a in zip(out, arrays):
            assert o.dtype == a.dtype and o.shape == a.shape
            assert o.tobytes() == np.ascontiguousarray(a).tobytes()
        assert dec.peek_tenant(tf) == tenant
