"""The port's npproto codec against the JAX package's, byte for byte.

The reference's protobuf wire (``npproto.ndarray``, ``InputArrays`` /
``OutputArrays``, the batch, deadline, tenant, partition and version
fields, the GetLoad result): each message is encoded by both packages
and the bytes must be identical; each package decodes the other's
bytes to the same arrays; malformed input raises the same error class
with the same text in both.
"""

import numpy as np
import pytest

from pytensor_federated_tpu.service import npproto_codec as J
from pytensor_federated_torch.service import npproto_codec as T

DTYPES = ["float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8", "uint16",
          "uint32", "uint64", "bool", "complex64", "complex128"]
SHAPES = [(), (0,), (5,), (3, 4), (2, 3, 2), (1, 2, 1, 3)]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape)) if shape else 1
    if dtype == "bool":
        return (rng.random(n) < 0.5).reshape(shape)
    if dtype.startswith("complex"):
        return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(dtype).reshape(shape)
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return rng.integers(max(info.min, -1000), min(info.max, 1000), size=n, dtype=dtype,
                            endpoint=True).reshape(shape)
    return rng.normal(size=n).astype(dtype).reshape(shape)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _outcome(fn, buf):
    try:
        return ("ok", fn(buf))
    except Exception as e:
        return (type(e).__name__, str(e))


def _raises_alike(fn_j, fn_t, buf):
    got, want = _outcome(fn_t, buf), _outcome(fn_j, buf)
    assert want[0] != "ok", want
    assert got == want


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ndarray_golden_bytes_both_ways(dtype, shape):
    arr = _array(dtype, shape)
    jb, tb = J.encode_ndarray(arr), T.encode_ndarray(arr)
    assert jb == tb
    _same(T.decode_ndarray(jb), arr)
    _same(J.decode_ndarray(tb), arr)


@pytest.mark.parametrize(
    "arr",
    [np.arange(6, dtype=np.int64).reshape(2, 3).T, np.arange(24.0).reshape(4, 6)[::2, 1::2],
     np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4))],
    ids=["transposed", "strided", "fortran"],
)
def test_non_contiguous_arrays_encode_alike(arr):
    assert J.encode_ndarray(arr) == T.encode_ndarray(arr)
    np.testing.assert_array_equal(T.decode_ndarray(J.encode_ndarray(arr)), arr)


MSG_KW = [
    {},
    {"trace_id": bytes(range(16))},
    {"error": "sigma must be positive"},
    {"deadline_s": 0.25},
    {"tenant": "acme"},
    {"partition": (1, 4, 2, 3, 12)},
    {"version": 7},
    {"trace_id": b"\x01" * 16, "deadline_s": 1.5, "tenant": "t-2", "partition": (0, 2, 0, 5, 10),
     "version": 2**40},
]
MSG_IDS = ["plain", "trace", "error", "deadline", "tenant", "partition", "version", "all"]


def _arrays(seed=0):
    return [np.float32(0.5), _array("float64", (3, 4), seed), _array("int32", (5,), seed + 1),
            _array("bool", (2, 2), seed + 2)]


@pytest.mark.parametrize("kw", MSG_KW, ids=MSG_IDS)
def test_arrays_msg_golden_bytes_and_peeks(kw):
    arrays = _arrays()
    jb = J.encode_arrays_msg(arrays, uuid="u-1", **kw)
    tb = T.encode_arrays_msg(arrays, uuid="u-1", **kw)
    assert jb == tb
    for codec, buf in ((T, jb), (J, tb)):
        out, uuid, err, trace, spans = codec.decode_arrays_msg_full(buf)
        assert uuid == "u-1" and err == kw.get("error") and trace == kw.get("trace_id")
        assert spans is None
        for a, b in zip(out, arrays):
            _same(b, np.asarray(a))
    for peek in ("peek_deadline_msg", "peek_tenant_msg", "peek_partition_msg", "peek_version_msg",
                 "has_batch_items"):
        assert getattr(T, peek)(jb) == getattr(J, peek)(jb)
    assert T.decode_arrays_msg(jb)[1] == J.decode_arrays_msg(jb)[1]
    assert T.decode_arrays_msg_ex(jb)[2] == J.decode_arrays_msg_ex(jb)[2]


@pytest.mark.parametrize("kw", [k for k in MSG_KW if "error" not in k],
                         ids=[i for i, k in zip(MSG_IDS, MSG_KW) if "error" not in k])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_batch_msg_golden_bytes(k, kw):
    items = [J.encode_arrays_msg(_arrays(i), uuid=f"i{i}") for i in range(k)]
    jb = J.encode_batch_msg(items, uuid="w", **kw)
    tb = T.encode_batch_msg(items, uuid="w", **kw)
    assert jb == tb
    assert T.has_batch_items(jb) == J.has_batch_items(jb) == (k > 0)
    titems, tuid, ttrace, tspans = T.decode_batch_msg(jb)
    jitems, juid, jtrace, jspans = J.decode_batch_msg(tb)
    assert titems == jitems == items and tuid == juid == "w"
    assert ttrace == jtrace == kw.get("trace_id") and tspans == jspans
    for peek in ("peek_deadline_msg", "peek_tenant_msg", "peek_partition_msg", "peek_version_msg"):
        assert getattr(T, peek)(jb) == getattr(J, peek)(jb)


def test_append_spans_msg_golden_bytes():
    spans = [{"name": "node.evaluate", "duration_s": 0.00125, "attrs": {"decode_s": 1e-5},
              "children": [{"name": "compute", "duration_s": 0.001}]}]
    base = J.encode_arrays_msg(_arrays(), uuid="u", trace_id=b"\x02" * 16)
    jb, tb = J.append_spans_msg(base, spans), T.append_spans_msg(base, spans)
    assert jb == tb
    assert T.decode_arrays_msg_all(jb)[3] == J.decode_arrays_msg_all(tb)[3] == spans
    batch = J.encode_batch_msg([base], uuid="w")
    assert J.append_spans_msg(batch, spans) == T.append_spans_msg(batch, spans)
    assert T.decode_batch_msg(J.append_spans_msg(batch, spans))[3] == spans


@pytest.mark.parametrize("load", [(0, 0.0, 0.0), (3, 12.5, 50.0), (1000, 99.9, 0.1)])
def test_get_load_result_golden_bytes(load):
    jb, tb = J.encode_get_load_result(*load), T.encode_get_load_result(*load)
    assert jb == tb
    assert T.decode_get_load_result(jb) == J.decode_get_load_result(tb)
    assert T.GETLOAD_PARAMS == J.GETLOAD_PARAMS


@pytest.mark.parametrize(
    "buf",
    [
        bytes.fromhex("0a"),  # truncated length
        bytes.fromhex("0aff"),  # length overruns the buffer
        bytes.fromhex("ffffffffffffffffffff01"),  # overlong varint
        bytes.fromhex("0f"),  # illegal wire type 7
        bytes.fromhex("00"),  # field number 0
        bytes.fromhex("0a04" + "0000803f") + bytes.fromhex("1207" + b"float32".hex())
        + bytes.fromhex("1a01" + "63"),  # shape [99] over 4 bytes
        bytes.fromhex("1205") + b"bogus",  # unknown dtype
    ],
    ids=["truncated", "overrun", "overlong-varint", "wire-type-7", "field-0", "shape", "dtype"],
)
def test_malformed_ndarray_raises_alike(buf):
    _raises_alike(J.decode_ndarray, T.decode_ndarray, buf)


@pytest.mark.parametrize(
    "buf",
    [bytes.fromhex("0a"), bytes.fromhex("12ff"), bytes.fromhex("0a03") + b"abc",
     bytes.fromhex("ffffffffffffffffffff01")],
    ids=["truncated", "uuid-overrun", "bad-item", "overlong-varint"],
)
@pytest.mark.parametrize("decode", ["decode_arrays_msg_full", "decode_batch_msg"])
def test_malformed_message_is_handled_alike(decode, buf):
    """Each package raises the same error with the same text, or (a batch
    message's items are opaque until decoded) returns the same value."""
    assert _outcome(getattr(T, decode), buf) == _outcome(getattr(J, decode), buf)


@pytest.mark.parametrize(
    "arr",
    [np.array([object()]), np.array([(1, 2.0)], dtype=[("a", "<i4"), ("b", "<f8")])],
    ids=["object", "structured"],
)
def test_unencodable_dtype_raises_alike(arr):
    _raises_alike(J.encode_ndarray, T.encode_ndarray, arr)


@pytest.mark.parametrize("bad", [{"version": -1}, {"partition": (0, 1, 2)}],
                         ids=["negative-version", "short-partition"])
def test_bad_fields_raise_alike(bad):
    _raises_alike(lambda kw: J.encode_arrays_msg([], uuid="u", **kw),
                  lambda kw: T.encode_arrays_msg([], uuid="u", **kw), bad)
