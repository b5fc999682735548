"""The port's blocked linear algebra against the JAX package's.

The contract under test mirrors tests/test_linalg.py: tile geometry and
the block-store protocol fail LOUDLY (``BlockError`` ⊂ ``WireError``) on
any mismatch; the blocked Cholesky equals ``np.linalg.cholesky``
(float64 at atol 1e-12, float32 at rtol 1e-4 / atol 1e-5) on the
clientless, multi-replica and recovery lanes; a replica failure
re-ships ONLY the dead replica's tiles, and the recovered factor equals
the uninterrupted one bit for bit on one device; the fed-lane ops (GEMM,
quadratic form, triangular solve) agree with float64 numpy eagerly, on
a 4-slot CPU mesh and over TCP pools (float32 wire: the JAX tests'
tolerances); repeated blocked GEMM over shm/ring moves zero request
payload bytes once the pin cache promotes the panels.

Against the JAX package on the same numpy inputs: header and tile bytes
identical; the JAX driver over the port's store and the port's driver
over the JAX store both equal LAPACK at atol 1e-12 (float64);
``triangular_solve`` without a placement within 1e-12 of the JAX one.
The JAX fed-program ops cannot trace under JAX 0.9.0 (the JAX package's
``fed_map`` needs ``convert_constvars_jaxpr``), so the port's fed ops
are held against float64 numpy, and ``TestAgainstTheJaxPrograms`` holds
them against the JAX ops where the installed JAX can run them.

Everything runs on the CPU (``device="cpu"``), on one intra-op thread.
"""

import os
import select
import signal
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.interpreters import partial_eval as jax_pe

import pytensor_federated_tpu.linalg as jlinalg
from pytensor_federated_tpu.linalg import blocks as jblocks
from pytensor_federated_torch import fed, linalg
from pytensor_federated_torch.linalg import (
    BlockedCholesky,
    BlockedMatmul,
    BlockError,
    BlockLayout,
    LocalBlockClient,
    block_quadratic_form,
    cholesky,
    make_block_store_compute,
    matmul,
    matmul_per_shard,
    quadratic_per_shard,
    triangular_solve,
)
from pytensor_federated_torch.linalg.blocks import (
    OPCODES,
    decode_op_header,
    encode_op_header,
    pack_coords,
    unpack_coords,
)
from pytensor_federated_torch.linalg.ops import triangular_update_per_shard
from pytensor_federated_torch.linalg.service import (
    chol_kernel,
    dot_kernel,
    is_restore_needed,
    trsm_kernel,
)
from pytensor_federated_torch.parallel import make_mesh
from pytensor_federated_torch.service import TcpArraysClient, serve_tcp_once
from pytensor_federated_torch.service.npwire import WireError
from pytensor_federated_torch.telemetry import flightrec, spans

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
JAX_FED = hasattr(jax_pe, "convert_constvars_jaxpr")
TIMEOUT_S = 60.0


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's side on one intra-op thread: its steps are many small
    tile ops, where threads add only their synchronisation."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spd(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, n))
    return (m @ m.T / n + np.eye(n)).astype(dtype)


def _local(layout):
    return LocalBlockClient(layout, device="cpu")


def _start(serve, compute, **kwargs):
    holder = {}
    ready = threading.Event()
    threading.Thread(
        target=serve,
        args=(compute,),
        kwargs=dict(port=0, ready_callback=lambda p: (holder.update(p=p), ready.set()), **kwargs),
        daemon=True,
    ).start()
    assert ready.wait(10)
    return holder["p"]


def _start_tcp(compute):
    return _start(serve_tcp_once, compute, concurrent=True)


def _put_request(lay, tiles, step=0):
    coords = sorted(tiles)
    req = [encode_op_header(OPCODES["PUT"], step, len(coords))]
    for c in coords:
        req.append(lay.encode_tile_header(*c))
        req.append(np.ascontiguousarray(tiles[c]))
    return req


# ---------------------------------------------------------------------------
# wire headers
# ---------------------------------------------------------------------------


class TestHeaders:
    def test_blockerror_is_a_wireerror(self):
        assert issubclass(BlockError, WireError)

    def test_op_header_roundtrip(self):
        hdr = encode_op_header(OPCODES["SYRK_UPDATE"], 3, 7)
        assert hdr.dtype == np.uint8 and hdr.nbytes == 16
        assert decode_op_header(hdr) == (OPCODES["SYRK_UPDATE"], 3, 7)

    def test_unknown_opcode_is_loud_both_ways(self):
        with pytest.raises(BlockError, match="unknown linalg opcode"):
            encode_op_header(99)
        bad = encode_op_header(OPCODES["PUT"]).copy()
        bad[0] = 250
        with pytest.raises(BlockError, match="unknown linalg opcode"):
            decode_op_header(bad)

    def test_reserved_flag_bits_are_loud(self):
        hdr = encode_op_header(OPCODES["GET"]).copy()
        hdr[12] = 1  # flags word
        with pytest.raises(BlockError, match="unknown flag bits"):
            decode_op_header(hdr)

    def test_malformed_op_header_is_loud(self):
        with pytest.raises(BlockError, match="uint8"):
            decode_op_header(np.zeros(16, np.float32))
        with pytest.raises(BlockError, match="uint8"):
            decode_op_header(np.zeros(5, np.uint8))

    def test_tile_header_roundtrip_and_validation(self):
        lay = BlockLayout(10, 10, 4, 4)
        hdr = lay.encode_tile_header(2, 1)
        assert lay.decode_tile_header(hdr) == (2, 1)
        other = BlockLayout(10, 10, 5, 5)
        with pytest.raises(BlockError, match="grid"):
            other.decode_tile_header(hdr)
        with pytest.raises(BlockError, match="uint8"):
            lay.decode_tile_header(hdr[:-1])

    def test_tile_header_shape_claim_checked(self):
        from pytensor_federated_torch.service.wire_registry import LINALG_TILE_STRUCT

        lay = BlockLayout(10, 10, 4, 4)
        forged = np.frombuffer(
            struct.pack(LINALG_TILE_STRUCT, 3, 3, 2, 2, 4, 4), dtype=np.uint8
        ).copy()
        with pytest.raises(BlockError, match="claims shape"):
            lay.decode_tile_header(forged)

    def test_coords_roundtrip(self):
        coords = [(0, 0), (2, 1), (3, 3)]
        arr = pack_coords(coords)
        assert arr.dtype == np.int64 and arr.shape == (3, 2)
        assert unpack_coords(arr) == coords
        assert pack_coords([]).shape == (0, 2)
        with pytest.raises(BlockError, match="int64"):
            unpack_coords(np.zeros((2, 2), np.int32))

    @pytest.mark.parametrize("name", sorted(OPCODES))
    def test_op_header_bytes_equal_the_jax_packages(self, name):
        assert OPCODES == jblocks.OPCODES
        for step, count in ((0, 0), (3, 7), (2**32 - 1, 5)):
            mine = encode_op_header(OPCODES[name], step, count)
            theirs = jblocks.encode_op_header(jblocks.OPCODES[name], step, count)
            assert mine.dtype == theirs.dtype and mine.tobytes() == theirs.tobytes()
            assert decode_op_header(theirs) == jblocks.decode_op_header(mine)

    @pytest.mark.parametrize("shape", [(10, 10, 4, 4), (10, 7, 4, 3), (512, 512, 64, 64)])
    def test_tile_header_bytes_and_geometry_equal_the_jax_packages(self, shape):
        mine, theirs = BlockLayout(*shape), jblocks.BlockLayout(*shape)
        assert (mine.grid_rows, mine.grid_cols) == (theirs.grid_rows, theirs.grid_cols)
        assert list(mine.lower_coords()) == list(theirs.lower_coords())
        for i, j in mine.coords():
            assert mine.encode_tile_header(i, j).tobytes() == theirs.encode_tile_header(i, j).tobytes()
            assert mine.tile_slice(i, j) == theirs.tile_slice(i, j)
            assert mine.owner(i, j, 3) == theirs.owner(i, j, 3)


# ---------------------------------------------------------------------------
# layout geometry
# ---------------------------------------------------------------------------


class TestLayout:
    def test_uneven_edge_tiles_never_padded(self):
        lay = BlockLayout(10, 7, 4, 3)
        assert (lay.grid_rows, lay.grid_cols) == (3, 3)
        assert lay.tile_shape(0, 0) == (4, 3)
        assert lay.tile_shape(2, 2) == (2, 1)
        with pytest.raises(BlockError, match="outside"):
            lay.tile_shape(3, 0)

    def test_bad_layout_params_are_loud(self):
        with pytest.raises(BlockError):
            BlockLayout(0, 4, 1, 1)
        with pytest.raises(BlockError):
            BlockLayout(4, 4, 8, 4)

    def test_for_matrix_clamps_block(self):
        lay = BlockLayout.for_matrix(np.zeros((3, 5)), 64)
        assert (lay.block_rows, lay.block_cols) == (3, 5)
        with pytest.raises(BlockError, match="2-D"):
            BlockLayout.for_matrix(np.zeros(3), 2)

    def test_split_assemble_roundtrip(self):
        a = np.arange(70.0).reshape(10, 7)
        lay = BlockLayout(10, 7, 4, 3)
        tiles = lay.split(a)
        assert all(t.flags["C_CONTIGUOUS"] for t in tiles.values())
        np.testing.assert_array_equal(lay.assemble(tiles), a)

    def test_assemble_missing_and_extra_tiles_are_loud(self):
        a = np.arange(16.0).reshape(4, 4)
        lay = BlockLayout(4, 4, 2, 2)
        tiles = lay.split(a)
        del tiles[(1, 0)]
        with pytest.raises(BlockError, match="missing tiles"):
            lay.assemble(tiles)
        tiles = lay.split(a)
        tiles[(7, 7)] = np.zeros((2, 2))
        with pytest.raises(BlockError, match="unexpected tiles"):
            lay.assemble(tiles)

    def test_assemble_mixed_dtype_and_bad_shape_are_loud(self):
        lay = BlockLayout(4, 4, 2, 2)
        tiles = lay.split(np.zeros((4, 4)))
        tiles[(0, 0)] = tiles[(0, 0)].astype(np.float32)
        with pytest.raises(BlockError, match="mixed dtypes"):
            lay.assemble(tiles)
        tiles = lay.split(np.zeros((4, 4)))
        tiles[(0, 1)] = np.zeros((3, 3))
        with pytest.raises(BlockError, match="shape"):
            lay.assemble(tiles)

    def test_lower_only_assembly(self):
        lay = BlockLayout(4, 4, 2, 2)
        l = np.tril(np.arange(1.0, 17.0).reshape(4, 4))
        tiles = {c: l[lay.tile_slice(*c)].copy() for c in lay.lower_coords()}
        np.testing.assert_array_equal(lay.assemble(tiles, lower_only=True), l)
        with pytest.raises(BlockError, match="unexpected tiles"):
            lay.assemble(lay.split(l), lower_only=True)

    def test_row_cyclic_owner_partitions_rows(self):
        lay = BlockLayout(20, 20, 4, 4)  # 5x5 grid
        for n in (1, 2, 3):
            owned = [lay.rows_owned(p, n) for p in range(n)]
            flat = sorted(i for rows in owned for i in rows)
            assert flat == list(range(lay.grid_rows))
            for i, j in lay.lower_coords():
                assert lay.owner(i, j, n) == i % n
        with pytest.raises(BlockError, match="n_replicas"):
            lay.owner(0, 0, 0)


# ---------------------------------------------------------------------------
# the block store protocol
# ---------------------------------------------------------------------------


class TestBlockStore:
    def test_put_get_stats_reset(self):
        lay = BlockLayout(6, 6, 3, 3)
        a = _spd(6)
        client = _local(lay)
        tiles = {c: a[lay.tile_slice(*c)] for c in lay.lower_coords()}
        (n,) = client.evaluate(*_put_request(lay, tiles))
        assert int(n) == len(tiles)
        got = client.evaluate(encode_op_header(OPCODES["GET"]), pack_coords([(1, 0)]))
        np.testing.assert_array_equal(got[0], tiles[(1, 0)])
        count, nbytes = client.evaluate(encode_op_header(OPCODES["STATS"]))
        assert int(count) == len(tiles)
        assert int(nbytes) == sum(t.nbytes for t in tiles.values())
        client.evaluate(encode_op_header(OPCODES["RESET"]))
        with pytest.raises(BlockError, match="does not hold"):
            client.evaluate(encode_op_header(OPCODES["GET"]), pack_coords([(1, 0)]))

    def test_tiles_live_as_tensors_on_the_stores_device(self):
        lay = BlockLayout(6, 6, 3, 3)
        a = _spd(6)
        client = _local(lay)
        tiles = {c: a[lay.tile_slice(*c)] for c in lay.lower_coords()}
        client.evaluate(*_put_request(lay, tiles))
        assert client.store.device == CPU
        for c, t in client.store.tiles.items():
            assert isinstance(t, torch.Tensor) and t.device == CPU and t.dtype == torch.float64
            # A copy, not a view of the request's array.
            assert t.data_ptr() != tiles[c].__array_interface__["data"][0]

    def test_put_count_mismatch_and_duplicate_are_loud(self):
        lay = BlockLayout(4, 4, 2, 2)
        client = _local(lay)
        hdr = lay.encode_tile_header(0, 0)
        tile = np.zeros((2, 2))
        with pytest.raises(BlockError, match="claims 2 tiles"):
            client.evaluate(encode_op_header(OPCODES["PUT"], 0, 2), hdr, tile)
        with pytest.raises(BlockError, match="twice"):
            client.evaluate(encode_op_header(OPCODES["PUT"], 0, 2), hdr, tile, hdr, tile)

    def test_gemm_panel(self):
        lay = BlockLayout(4, 4, 2, 2)
        client = _local(lay)
        a = np.arange(6.0).reshape(2, 3)
        b = np.arange(12.0).reshape(3, 4)
        (out,) = client.evaluate(encode_op_header(OPCODES["GEMM_PANEL"]), a, b)
        np.testing.assert_allclose(out, a @ b)
        with pytest.raises(BlockError, match="do not contract"):
            client.evaluate(encode_op_header(OPCODES["GEMM_PANEL"]), a, a)

    def test_step_guards(self):
        """The applied_step clock: retried updates are idempotent,
        missed updates and mismatched panel steps are loud."""
        lay = BlockLayout(6, 6, 2, 2)  # 3x3 grid, one replica owns all
        a = _spd(6)
        client = _local(lay)
        tiles = {c: a[lay.tile_slice(*c)] for c in lay.lower_coords()}
        client.evaluate(*_put_request(lay, tiles, step=0))
        with pytest.raises(BlockError, match="trailing updates applied"):
            client.evaluate(encode_op_header(OPCODES["CHOL_PANEL"], 1))
        with pytest.raises(BlockError, match="updates applied"):
            client.evaluate(
                encode_op_header(OPCODES["SYRK_UPDATE"], 1, 0), np.zeros(0, np.int64)
            )
        reply = client.evaluate(encode_op_header(OPCODES["CHOL_PANEL"], 0))
        l_kk, rows = np.asarray(reply[0]), np.asarray(reply[1])
        assert list(rows) == [1, 2]
        panel = list(reply[2:])
        req = [encode_op_header(OPCODES["SYRK_UPDATE"], 0, len(panel)), rows, *panel]
        (updated,) = client.evaluate(*req)
        assert int(updated) == 3  # (1,1), (2,1), (2,2)
        (sentinel,) = client.evaluate(*req)
        assert int(sentinel) == -1
        with pytest.raises(BlockError, match="trailing updates applied"):
            client.evaluate(encode_op_header(OPCODES["TRSM_PANEL"], 0), l_kk)

    def test_syrk_missing_panel_row_is_loud(self):
        lay = BlockLayout(6, 6, 2, 2)
        a = _spd(6)
        client = _local(lay)
        tiles = {c: a[lay.tile_slice(*c)] for c in lay.lower_coords()}
        client.evaluate(*_put_request(lay, tiles, step=0))
        reply = client.evaluate(encode_op_header(OPCODES["CHOL_PANEL"], 0))
        with pytest.raises(BlockError, match="needs panel rows"):
            client.evaluate(
                encode_op_header(OPCODES["SYRK_UPDATE"], 0, 1),
                np.asarray([1], np.int64),
                np.asarray(reply[2]),
            )

    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_chol_refuses_non_pd(self, dtype):
        lay = BlockLayout(2, 2, 2, 2)
        client = _local(lay)
        bad = np.array([[1.0, 2.0], [2.0, 1.0]], dtype)  # indefinite
        client.evaluate(*_put_request(lay, {(0, 0): bad}, step=0))
        with pytest.raises(BlockError, match="positive definite"):
            client.evaluate(encode_op_header(OPCODES["CHOL_PANEL"], 0))

    def test_headerless_request_is_loud(self):
        client = _local(BlockLayout(2, 2, 2, 2))
        with pytest.raises(BlockError, match="op header"):
            client.evaluate()

    def test_no_gpu_is_a_loud_refusal_not_a_cpu_store(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        lay = BlockLayout(4, 4, 2, 2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_block_store_compute(lay)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalBlockClient(lay)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cholesky(_spd(4))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            matmul(np.eye(2), np.eye(2), n_shards=2)


class TestKernels:
    def test_dot_kernel_f64(self):
        rng = np.random.default_rng(1)
        a, b = rng.normal(size=(5, 7)), rng.normal(size=(7, 3))
        out = dot_kernel(torch.tensor(a), torch.tensor(b))
        assert out.dtype == torch.float64
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-13, atol=1e-14)

    @pytest.mark.parametrize("policy", [None, "highest", "split", "strict"])
    def test_dot_kernel_f32_follows_the_policy(self, policy):
        rng = np.random.default_rng(2)
        a, b = rng.normal(size=(16, 32)).astype(np.float32), rng.normal(size=(32, 8)).astype(np.float32)
        out = dot_kernel(torch.tensor(a), torch.tensor(b), policy)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), a.astype(np.float64) @ b, rtol=1e-5, atol=1e-5)

    def test_trsm_kernel_inverts_the_panel_solve(self):
        l = np.linalg.cholesky(_spd(4, seed=2))
        a_ik = np.random.default_rng(3).normal(size=(4, 4))
        x = trsm_kernel(torch.tensor(a_ik), torch.tensor(l)).numpy()
        np.testing.assert_allclose(x @ l.T, a_ik, atol=1e-12)
        np.testing.assert_allclose(x, jlinalg.service.trsm_kernel(a_ik, l), atol=1e-13)

    def test_chol_kernel_matches_numpy(self):
        a = _spd(8, seed=4)
        np.testing.assert_allclose(chol_kernel(torch.tensor(a)).numpy(), np.linalg.cholesky(a), atol=1e-13)
        a32 = _spd(8, np.float32, seed=4)
        l32 = chol_kernel(torch.tensor(a32))
        assert l32.dtype == torch.float32
        np.testing.assert_allclose(l32.numpy(), np.linalg.cholesky(a32.astype(np.float64)), atol=1e-5)


# ---------------------------------------------------------------------------
# blocked Cholesky: equality, distribution accounting, recovery
# ---------------------------------------------------------------------------


class TestCholesky:
    def test_f64_matches_numpy_with_uneven_edge(self):
        a = _spd(10, seed=5)
        l = cholesky(a, block=4, device="cpu")  # 3x3 grid, 2x2 edge tiles
        assert isinstance(l, torch.Tensor) and l.device == CPU and l.dtype == torch.float64
        np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)

    def test_f32_matches_at_strict_tolerance(self):
        a = _spd(24, np.float32, seed=6)
        l = cholesky(a, block=8, device="cpu")
        assert l.dtype == torch.float32
        ref = np.linalg.cholesky(a.astype(np.float64))
        np.testing.assert_allclose(l.numpy(), ref, rtol=1e-4, atol=1e-5)

    def test_a_tensor_stays_where_it_lies(self):
        a = torch.tensor(_spd(9, seed=3))
        l = cholesky(a, block=4)
        assert l.device == a.device
        np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a.numpy()), atol=1e-12)

    def test_multi_replica_matches_and_ships_each_tile_once(self):
        a = _spd(12, seed=7)
        lay = BlockLayout(12, 12, 3, 3)
        clients = [_local(lay) for _ in range(3)]
        bc = BlockedCholesky(lay, clients, device="cpu")
        l = bc.factor(a)
        np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)
        assert sorted(c for _, c in bc.shipped) == sorted(lay.lower_coords())
        assert bc.reshipped == [] and bc.restores == 0
        for p, (i, j) in bc.shipped:
            assert p == lay.owner(i, j, 3)

    def test_single_vs_multi_replica_identical(self):
        a = _spd(12, seed=8)
        lay = BlockLayout(12, 12, 4, 4)
        l1 = BlockedCholesky(lay, [_local(lay)], device="cpu").factor(a)
        l3 = BlockedCholesky(lay, [_local(lay) for _ in range(3)], device="cpu").factor(a)
        np.testing.assert_array_equal(l1.numpy(), l3.numpy())

    def test_geometry_refusals(self):
        with pytest.raises(BlockError, match="square"):
            cholesky(np.zeros((4, 6)), device="cpu")
        with pytest.raises(BlockError, match="square"):
            BlockedCholesky(BlockLayout(8, 8, 4, 2), device="cpu")
        lay = BlockLayout(8, 8, 4, 4)
        with pytest.raises(BlockError, match="does not match layout"):
            BlockedCholesky(lay, device="cpu").factor(np.eye(6))
        with pytest.raises(BlockError):
            BlockedCholesky(lay, [], device="cpu")

    def test_wrong_geometry_store_is_loud_not_retried(self):
        lay = BlockLayout(8, 8, 4, 4)
        other = _local(BlockLayout(8, 8, 2, 2))
        bc = BlockedCholesky(lay, [other], device="cpu")
        with pytest.raises(BlockError, match="grid"):
            bc.factor(_spd(8))
        assert bc.restores == 0

    def test_non_pd_matrix_is_loud(self):
        a = _spd(8, seed=1)
        a[5, 5] = -1.0
        with pytest.raises(BlockError, match="positive definite"):
            cholesky(a, block=4, device="cpu")


class TestAgainstTheJaxPackage:
    """Either package's driver over the other's store, float64, the
    same numpy inputs: both equal LAPACK at atol 1e-12."""

    @pytest.mark.parametrize("width", [1, 2, 3])
    def test_jax_driver_over_the_ports_stores(self, width):
        a = _spd(15, seed=30 + width)
        lay = jblocks.BlockLayout(15, 15, 4, 4)
        stores = [_local(BlockLayout(15, 15, 4, 4)) for _ in range(width)]
        l = jlinalg.BlockedCholesky(lay, stores).factor(a)
        np.testing.assert_allclose(l, np.linalg.cholesky(a), atol=1e-12)

    @pytest.mark.parametrize("width", [1, 2, 3])
    def test_ports_driver_over_the_jax_stores(self, width):
        a = _spd(15, seed=40 + width)
        lay = BlockLayout(15, 15, 4, 4)
        stores = [jlinalg.LocalBlockClient(jblocks.BlockLayout(15, 15, 4, 4)) for _ in range(width)]
        l = BlockedCholesky(lay, stores, device="cpu").factor(a)
        np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)

    def test_mixed_pool_and_jax_driver_over_a_port_tcp_node(self):
        a = _spd(12, seed=50)
        lay = BlockLayout(12, 12, 3, 3)
        port = _start_tcp(make_block_store_compute(lay, device="cpu"))
        tcp = TcpArraysClient("127.0.0.1", port)
        try:
            mixed = [tcp, jlinalg.LocalBlockClient(jblocks.BlockLayout(12, 12, 3, 3))]
            l = BlockedCholesky(lay, mixed, device="cpu").factor(a)
            np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)
            lj = jlinalg.BlockedCholesky(jblocks.BlockLayout(12, 12, 3, 3), [tcp]).factor(a)
            np.testing.assert_allclose(lj, np.linalg.cholesky(a), atol=1e-12)
        finally:
            tcp.close()

    def test_clientless_cholesky_equals_the_jax_one(self):
        a = _spd(21, seed=51)
        np.testing.assert_allclose(
            cholesky(a, block=8, device="cpu").numpy(), jlinalg.cholesky(a, block=8), atol=1e-12
        )

    @pytest.mark.parametrize("trans", [False, True])
    @pytest.mark.parametrize("rhs_cols", [None, 3])
    def test_triangular_solve_equals_the_jax_one(self, trans, rhs_cols):
        l = np.linalg.cholesky(_spd(17, seed=52))
        rng = np.random.default_rng(53)
        b = rng.normal(size=17) if rhs_cols is None else rng.normal(size=(17, rhs_cols))
        mine = triangular_solve(l, b, block=5, trans=trans, device="cpu").numpy()
        theirs = jlinalg.triangular_solve(l, b, block=5, trans=trans)
        assert mine.shape == theirs.shape
        np.testing.assert_allclose(mine, theirs, rtol=1e-12, atol=1e-12)

    def test_restore_marks_are_the_jax_packages(self):
        from pytensor_federated_torch.linalg import service

        assert service._RESTORE_MARKS == jlinalg.service._RESTORE_MARKS
        assert linalg.__all__ == jlinalg.__all__


class _DyingClient:
    """A block-store replica that dies with a transient error at a
    chosen evaluate() call and stays dead until `reconnect` replaces
    it.  ``after=True`` applies the op first (the reply-lost case)."""

    def __init__(self, layout, die_at, after=False):
        self._inner = _local(layout)
        self.die_at = die_at
        self.after = after
        self.calls = 0
        self.dead = False

    def evaluate(self, *arrays):
        if self.dead:
            raise ConnectionError("replica down")
        self.calls += 1
        if self.calls == self.die_at:
            self.dead = True
            if self.after:
                self._inner.evaluate(*arrays)  # applied, reply lost
            raise ConnectionError("replica killed")
        return self._inner.evaluate(*arrays)

    def close(self):
        pass


class TestRecovery:
    def _run(self, die_at, after):
        a = _spd(15, seed=9)
        lay = BlockLayout(15, 15, 3, 3)  # 5x5 grid
        victim = _DyingClient(lay, die_at, after)
        bc = BlockedCholesky(
            lay, [_local(lay), victim], reconnect=lambda p: _local(lay), device="cpu"
        )
        l = bc.factor(a)
        np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)
        clean = BlockedCholesky(lay, [_local(lay), _local(lay)], device="cpu").factor(a)
        return lay, bc, l, clean

    def test_mid_factorization_death_recovers_locally_and_bit_for_bit(self):
        flightrec.clear()
        was = flightrec.set_enabled(True)
        try:
            lay, bc, l, clean = self._run(die_at=4, after=False)
        finally:
            flightrec.set_enabled(was)
        assert bc.restores == 1
        assert bc.reshipped, "recovery must re-ship the victim's tiles"
        victim_rows = set(lay.rows_owned(1, 2))
        for p, (i, j) in bc.reshipped:
            assert p == 1, "only the dead replica re-ships"
            assert i in victim_rows
            assert j >= 1, "finalized columns never re-ship"
        np.testing.assert_array_equal(l.numpy(), clean.numpy())
        kinds = [e["kind"] for e in flightrec.events()]
        assert "linalg.replica_lost" in kinds and "linalg.replica_restored" in kinds

    @pytest.mark.parametrize("die_at", [3, 5, 6])
    def test_reply_lost_after_apply_recovers_bit_for_bit(self, die_at):
        _, bc, l, clean = self._run(die_at=die_at, after=True)
        assert bc.restores >= 1
        np.testing.assert_array_equal(l.numpy(), clean.numpy())

    def test_unreachable_reconnect_is_a_bounded_loud_failure(self):
        a = _spd(6, seed=10)
        lay = BlockLayout(6, 6, 3, 3)
        dead = _DyingClient(lay, die_at=1)

        def reconnect(p):
            raise ConnectionError("still down")

        bc = BlockedCholesky(lay, [dead], reconnect=reconnect, reconnect_timeout_s=0.5, device="cpu")
        with pytest.raises(BlockError, match="could not reconnect"):
            bc.factor(a)


class _ResendingClient:
    """Every panel op is delivered TWICE (a lost reply and a transparent
    re-send) and the caller sees only the second reply: the duplication
    the node's replay cache must absorb."""

    def __init__(self, layout):
        self._inner = _local(layout)
        self.duplicated = 0

    def evaluate(self, *arrays):
        opcode, _, _ = decode_op_header(np.asarray(arrays[0]))
        if opcode in (OPCODES["CHOL_PANEL"], OPCODES["TRSM_PANEL"]):
            self._inner.evaluate(*arrays)
            self.duplicated += 1
        return self._inner.evaluate(*arrays)

    def close(self):
        pass


class _ColdRestartClient:
    """A replica silently REPLACED by a cold restart at call
    ``restart_at``: no transport error reaches the driver; the next
    panel op bounces off the cold store's state guards in-band."""

    def __init__(self, layout, restart_at):
        self.layout = layout
        self._inner = _local(layout)
        self.restart_at = restart_at
        self.calls = 0

    def evaluate(self, *arrays):
        self.calls += 1
        if self.calls == self.restart_at:
            self._inner = _local(self.layout)
        return self._inner.evaluate(*arrays)

    def close(self):
        pass


class TestResendIdempotence:
    def test_chol_panel_replay_returns_cached_reply(self):
        lay = BlockLayout(6, 6, 3, 3)
        a = _spd(6)
        client = _local(lay)
        tiles = {c: a[lay.tile_slice(*c)] for c in lay.lower_coords()}
        client.evaluate(*_put_request(lay, tiles))
        first = client.evaluate(encode_op_header(OPCODES["CHOL_PANEL"], 0))
        replay = client.evaluate(encode_op_header(OPCODES["CHOL_PANEL"], 0))
        assert len(first) == len(replay)
        for x, y in zip(first, replay):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_trsm_panel_replay_returns_cached_reply(self):
        lay = BlockLayout(6, 6, 3, 3)
        a = _spd(6, seed=3)
        client = _local(lay)
        tiles = {c: a[lay.tile_slice(*c)] for c in lay.lower_coords()}
        client.evaluate(*_put_request(lay, tiles))
        l_kk = np.linalg.cholesky(tiles[(0, 0)])
        first = client.evaluate(encode_op_header(OPCODES["TRSM_PANEL"], 0), l_kk)
        replay = client.evaluate(encode_op_header(OPCODES["TRSM_PANEL"], 0), l_kk)
        for x, y in zip(first, replay):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_put_invalidates_the_replay_cache(self):
        lay = BlockLayout(3, 3, 3, 3)
        a = _spd(3, seed=4)
        client = _local(lay)
        client.evaluate(*_put_request(lay, {(0, 0): a}))
        stale = client.evaluate(encode_op_header(OPCODES["CHOL_PANEL"], 0))
        a2 = a + np.eye(3)
        client.evaluate(*_put_request(lay, {(0, 0): a2}))
        fresh = client.evaluate(encode_op_header(OPCODES["CHOL_PANEL"], 0))
        assert not np.allclose(np.asarray(stale[0]), np.asarray(fresh[0]))
        np.testing.assert_allclose(np.asarray(fresh[0]), np.linalg.cholesky(a2), atol=1e-12)

    def test_factor_exact_under_transparent_resends(self):
        a = _spd(15, seed=11)
        lay = BlockLayout(15, 15, 3, 3)
        clients = [_ResendingClient(lay), _ResendingClient(lay)]
        bc = BlockedCholesky(lay, clients, device="cpu")
        l = bc.factor(a)
        assert clients[0].duplicated + clients[1].duplicated > 0
        np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)
        assert bc.restores == 0

    def test_cold_restart_without_transport_error_heals(self):
        a = _spd(15, seed=12)
        lay = BlockLayout(15, 15, 3, 3)
        victim = _ColdRestartClient(lay, restart_at=4)
        bc = BlockedCholesky(lay, [_local(lay), victim], reconnect=lambda p: victim, device="cpu")
        l = bc.factor(a)
        np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)
        assert bc.restores >= 1
        assert all(p == 1 for p, _ in bc.reshipped)

    def test_geometry_refusals_never_classify_as_restorable(self):
        assert is_restore_needed(
            BlockError("tile (1, 1) this store does not hold — a "
                       "restarted replica must be restored with PUT first")
        )
        assert is_restore_needed(
            RuntimeError("CHOL_PANEL step 2 but this store has 0 "
                         "trailing updates applied — the driver must "
                         "restore before retrying")
        )
        assert not is_restore_needed(BlockError("tile header claims grid 4x4 but this layout is 2x2"))
        assert not is_restore_needed(BlockError("diagonal tile is not positive definite: boom"))


# ---------------------------------------------------------------------------
# a block-store node process SIGKILLed mid-factorization
# ---------------------------------------------------------------------------

NODE_SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from pytensor_federated_torch.linalg import BlockLayout, make_block_store_compute
from pytensor_federated_torch.service import serve_tcp_once

serve_tcp_once(make_block_store_compute(BlockLayout({n}, {n}, {b}, {b}), device="cpu"),
               "127.0.0.1", 0, concurrent=True,
               ready_callback=lambda port: print(port, flush=True))
"""


def _spawn_node(n, b):
    proc = subprocess.Popen(
        [sys.executable, "-c", NODE_SCRIPT.format(root=str(ROOT), n=n, b=b)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    ready, _, _ = select.select([proc.stdout], [], [], 120)
    assert ready, "the node did not start"
    return proc, int(proc.stdout.readline())


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=TIMEOUT_S)
    proc.stdout.close()
    proc.stderr.close()


class _KillAt:
    """A TCP client that SIGKILLs its node process just before its
    ``at``-th call goes out (so that call meets a dead node)."""

    def __init__(self, proc, port, at):
        self.proc, self.at, self.calls = proc, at, 0
        self.inner = TcpArraysClient("127.0.0.1", port, timeout_s=TIMEOUT_S, retries=0)

    def evaluate(self, *arrays):
        self.calls += 1
        if self.calls == self.at:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=TIMEOUT_S)
        return self.inner.evaluate(*arrays)

    def close(self):
        self.inner.close()


def test_sigkilled_node_process_recovers_bit_for_bit_with_only_the_victim_reshipping():
    """Two block-store node processes on the CPU; the second is SIGKILLed
    before its CHOL_PANEL(1) (its 4th call: PUT, TRSM_PANEL(0),
    SYRK_UPDATE(0), CHOL_PANEL(1)) and a fresh process takes
    its place.  The factor equals the uninterrupted factor bit for bit;
    only the victim re-ships, and only columns >= the failed step."""
    n, b = 20, 4
    a = _spd(n, seed=60)
    lay = BlockLayout(n, n, b, b)
    procs = [_spawn_node(n, b) for _ in range(2)]
    fresh = []
    clients = []
    try:
        clients = [TcpArraysClient("127.0.0.1", procs[0][1], timeout_s=TIMEOUT_S),
                   _KillAt(procs[1][0], procs[1][1], at=4)]

        def reconnect(p):
            proc, port = _spawn_node(n, b)
            fresh.append(proc)
            return TcpArraysClient("127.0.0.1", port, timeout_s=TIMEOUT_S)

        bc = BlockedCholesky(lay, clients, reconnect=reconnect, device="cpu")
        l = bc.factor(a)
        assert procs[1][0].returncode == -signal.SIGKILL
        assert bc.restores >= 1 and len(fresh) == bc.restores
        assert bc.reshipped and all(p == 1 and i % 2 == 1 and j >= 1 for p, (i, j) in bc.reshipped)
        clean = BlockedCholesky(lay, [_local(lay), _local(lay)], device="cpu").factor(a)
        np.testing.assert_array_equal(l.numpy(), clean.numpy())
        np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)
    finally:
        for c in clients:
            c.close()
        for proc in [p for p, _ in procs] + fresh:
            _stop(proc)


# ---------------------------------------------------------------------------
# fed-lane ops
# ---------------------------------------------------------------------------


def _mesh4():
    return fed.MeshPlacement(make_mesh({"shards": 4}, devices=[CPU] * 4))


class TestFedOps:
    def test_matmul_eager_with_k_padding(self):
        rng = np.random.default_rng(11)
        a = rng.normal(size=(9, 13)).astype(np.float32)
        b = rng.normal(size=(13, 5)).astype(np.float32)
        out = matmul(a, b, n_shards=4, device="cpu")
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), a.astype(np.float64) @ b, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("n_shards", [1, 3, 4, 8, 64])
    def test_matmul_f64_on_a_mesh_equals_numpy(self, n_shards):
        rng = np.random.default_rng(12 + n_shards)
        a, b = rng.normal(size=(16, 30)), rng.normal(size=(30, 7))
        # A mesh needs the shard count (at most k = 30) divisible by its 4 slots.
        out = matmul(a, b, n_shards=n_shards, placement=_mesh4() if n_shards in (4, 8) else None,
                     device="cpu")
        assert out.dtype == torch.float64
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-12, atol=1e-12)

    def test_matmul_refusals(self):
        with pytest.raises(BlockError, match="do not contract"):
            matmul(np.zeros((2, 3)), np.zeros((4, 2)), n_shards=2, device="cpu")
        with pytest.raises(BlockError, match="n_shards"):
            matmul(np.zeros((2, 3)), np.zeros((3, 2)), n_shards=0, device="cpu")

    def test_matmul_over_tcp_pool(self):
        port = _start_tcp(fed.make_node_compute(matmul_per_shard(), grads=False, device="cpu"))
        client = TcpArraysClient("127.0.0.1", port)
        try:
            rng = np.random.default_rng(12)
            a = rng.normal(size=(8, 16)).astype(np.float32)
            b = rng.normal(size=(16, 6)).astype(np.float32)
            out = matmul(a, b, n_shards=4, placement=fed.PoolPlacement(client, window=4),
                         device="cpu")
            np.testing.assert_allclose(out.numpy(), a.astype(np.float64) @ b, rtol=1e-4, atol=1e-5)
        finally:
            client.close()

    def test_quadratic_form_eager(self):
        rng = np.random.default_rng(13)
        a = _spd(11, np.float32, seed=13)
        x = rng.normal(size=11).astype(np.float32)
        out = float(block_quadratic_form(a, x, n_shards=3, device="cpu"))
        ref = float(x.astype(np.float64) @ a.astype(np.float64) @ x)
        np.testing.assert_allclose(out, ref, rtol=1e-4)

    def test_quadratic_form_f64_on_a_mesh(self):
        rng = np.random.default_rng(14)
        a = _spd(22, seed=14)
        x = rng.normal(size=22)
        out = float(block_quadratic_form(a, x, n_shards=4, placement=_mesh4(), device="cpu"))
        np.testing.assert_allclose(out, x @ a @ x, rtol=1e-12)

    def test_quadratic_form_over_reduced_tcp_window(self, telemetry_on):
        per_shard = quadratic_per_shard()

        def node_fn(x, panel, x_rows):
            return per_shard(x, (panel, x_rows))

        port = _start_tcp(fed.make_node_compute(node_fn, device="cpu"))
        client = TcpArraysClient("127.0.0.1", port)
        try:
            rng = np.random.default_rng(14)
            a = _spd(12, np.float32, seed=14)
            x = rng.normal(size=12).astype(np.float32)
            flightrec.clear()
            out = float(block_quadratic_form(
                a, x, n_shards=4, placement=fed.PoolPlacement(client, window=4, reduce=True),
                device="cpu"))
            ref = float(x.astype(np.float64) @ a.astype(np.float64) @ x)
            np.testing.assert_allclose(out, ref, rtol=1e-4)
            kinds = {e["kind"] for e in flightrec.events() if e["kind"].startswith("fed.")}
            assert kinds == {"fed.reduce_window"}, kinds
        finally:
            client.close()

    def test_quadratic_refusals(self):
        with pytest.raises(BlockError, match="do not contract"):
            block_quadratic_form(np.zeros((3, 3)), np.zeros(4), n_shards=2, device="cpu")


class TestTriangularSolve:
    def test_forward_and_backward_f64(self):
        l = np.linalg.cholesky(_spd(13, seed=15))
        b = np.random.default_rng(15).normal(size=13)
        x = triangular_solve(l, b, block=4, device="cpu").numpy()
        np.testing.assert_allclose(l @ x, b, atol=1e-11)
        xt = triangular_solve(l, b, block=4, trans=True, device="cpu").numpy()
        np.testing.assert_allclose(l.T @ xt, b, atol=1e-11)

    def test_matrix_rhs(self):
        l = np.linalg.cholesky(_spd(8, seed=16))
        b = np.random.default_rng(16).normal(size=(8, 3))
        x = triangular_solve(l, b, block=3, device="cpu").numpy()
        np.testing.assert_allclose(l @ x, b, atol=1e-11)

    @pytest.mark.parametrize("trans", [False, True])
    def test_row_updates_on_a_mesh_equal_the_unplaced_solve(self, trans):
        # 28 rows in tiles of 6: every row update has at least 4 rows,
        # which a mesh of 4 slots needs.
        l = np.linalg.cholesky(_spd(28, seed=17))
        b = np.random.default_rng(17).normal(size=(28, 2))
        placed = triangular_solve(l, b, block=6, placement=_mesh4(), n_shards=4, trans=trans,
                                  device="cpu").numpy()
        plain = triangular_solve(l, b, block=6, trans=trans, device="cpu").numpy()
        np.testing.assert_allclose(placed, plain, rtol=1e-12, atol=1e-12)
        ref = np.linalg.solve(l.T if trans else l, b)
        np.testing.assert_allclose(placed, ref, rtol=1e-10, atol=1e-10)

    def test_refusals(self):
        with pytest.raises(BlockError, match="square"):
            triangular_solve(np.zeros((3, 4)), np.zeros(3), device="cpu")
        with pytest.raises(BlockError, match="rows"):
            triangular_solve(np.eye(3), np.zeros(4), device="cpu")

    def test_row_update_over_tcp_pool(self):
        port = _start_tcp(fed.make_node_compute(triangular_update_per_shard(), grads=False,
                                                device="cpu"))
        client = TcpArraysClient("127.0.0.1", port)
        try:
            l = np.linalg.cholesky(_spd(12, np.float32, seed=17))
            b = np.random.default_rng(17).normal(size=12).astype(np.float32)
            x = triangular_solve(l.astype(np.float32), b, block=4,
                                 placement=fed.PoolPlacement(client, window=4), n_shards=2,
                                 device="cpu").numpy()
            ref = np.linalg.solve(np.tril(l).astype(np.float64), b.astype(np.float64))
            np.testing.assert_allclose(x, ref, rtol=1e-3, atol=1e-4)
        finally:
            client.close()


@pytest.mark.skipif(not JAX_FED, reason=(
    "the installed JAX lacks jax.interpreters.partial_eval.convert_constvars_jaxpr "
    "(removed in JAX 0.9.0), which the JAX package's fed_map traces with"))
class TestAgainstTheJaxPrograms:
    """The port's fed ops against the JAX package's, float32, the JAX
    tests' tolerances."""

    def test_matmul(self):
        rng = np.random.default_rng(70)
        a = rng.normal(size=(9, 13)).astype(np.float32)
        b = rng.normal(size=(13, 5)).astype(np.float32)
        np.testing.assert_allclose(matmul(a, b, n_shards=4, device="cpu").numpy(),
                                   np.asarray(jlinalg.matmul(a, b, n_shards=4)),
                                   rtol=1e-5, atol=1e-6)

    def test_quadratic_form(self):
        a = _spd(11, np.float32, seed=71)
        x = np.random.default_rng(71).normal(size=11).astype(np.float32)
        np.testing.assert_allclose(float(block_quadratic_form(a, x, n_shards=3, device="cpu")),
                                   float(jlinalg.block_quadratic_form(a, x, n_shards=3)),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# pin-cache reuse accounting (zero re-ship on shm + ring)
# ---------------------------------------------------------------------------


@pytest.fixture
def telemetry_on():
    """Byte counters and flight events count only with telemetry on."""
    was = spans.set_enabled(True), flightrec.set_enabled(True)
    yield
    spans.set_enabled(was[0])
    flightrec.set_enabled(was[1])


def _arena_write_bytes():
    from pytensor_federated_torch.service.npwire import WIRE_BYTES_COPIED

    return WIRE_BYTES_COPIED.labels(lane="shm", stage="arena_write").value


class TestPinAccounting:
    """Repeated blocked GEMM over a pinned lane stops moving the panels:
    after the pin cache promotes the stable request objects (second
    sighting), per-iteration arena-write growth is flat at the REPLY
    payload."""

    def _measure(self, serve, make_client):
        lay = BlockLayout(4, 4, 2, 2)  # unused by GEMM_PANEL
        port = _start(serve, make_block_store_compute(lay, device="cpu"))
        client = make_client(port)
        try:
            rng = np.random.default_rng(18)
            a = rng.normal(size=(64, 64)).astype(np.float32)
            b = rng.normal(size=(64, 8)).astype(np.float32)
            mm = BlockedMatmul(a, b, client, n_panels=4, window=4, device="cpu")
            req_bytes = sum(arr.nbytes for r in mm._requests for arr in r[1:])
            ref = a.astype(np.float64) @ b
            deltas = []
            for _ in range(4):
                before = _arena_write_bytes()
                out = mm.run()
                deltas.append(_arena_write_bytes() - before)
                np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
            return req_bytes, deltas
        finally:
            client.close()

    def _check(self, req_bytes, deltas):
        assert deltas[0] >= req_bytes
        assert deltas[2] == deltas[3]
        assert deltas[2] < req_bytes // 2

    def test_shm_lane_pins_the_panels(self, telemetry_on):
        from pytensor_federated_torch.service.shm import ShmArraysClient, serve_shm

        self._check(*self._measure(serve_shm, lambda p: ShmArraysClient("127.0.0.1", p, retries=0)))

    def test_ring_lane_pins_the_panels(self, telemetry_on):
        from pytensor_federated_torch.service.ring import RingArraysClient, serve_ring

        self._check(*self._measure(serve_ring, lambda p: RingArraysClient("127.0.0.1", p)))


# ---------------------------------------------------------------------------
# block-store nodes over real transports
# ---------------------------------------------------------------------------


class TestTransportIntegration:
    def test_cholesky_over_tcp_replicas(self):
        a = _spd(12, seed=19)
        lay = BlockLayout(12, 12, 3, 3)
        ports = [_start_tcp(make_block_store_compute(lay, device="cpu")) for _ in range(2)]
        clients = [TcpArraysClient("127.0.0.1", p) for p in ports]
        try:
            l = BlockedCholesky(lay, clients, device="cpu").factor(a)
            np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)
            # In-band node refusals survive the wire as text.
            with pytest.raises(Exception, match="does not hold"):
                clients[0].evaluate(encode_op_header(OPCODES["GET"]), pack_coords([(0, 1)]))
        finally:
            for c in clients:
                c.close()

    def test_cholesky_over_shm(self):
        from pytensor_federated_torch.service.shm import ShmArraysClient, serve_shm

        a = _spd(8, seed=20)
        lay = BlockLayout(8, 8, 4, 4)
        port = _start(serve_shm, make_block_store_compute(lay, device="cpu"))
        client = ShmArraysClient("127.0.0.1", port, retries=0)
        try:
            l = BlockedCholesky(lay, [client], device="cpu").factor(a)
            np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), atol=1e-12)
        finally:
            client.close()
