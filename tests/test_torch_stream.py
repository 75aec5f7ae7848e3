"""distaff_torch's streaming LDE on the CPU against the JAX package's: the
streamed polynomials, leaf digests, slice over D_ev, tree root and query
rows against the JAX package's forced stream (built as tests/
test_streaming.py builds it); kernel K14's plain version (trace_absorb)
against the JAX absorb functions at partial last blocks and at a two-chunk
row; kernel K15's plain version (coeff_wsum) extended by the port's NTT
against the JAX weighted sums of the LDE; the golden proof streamed; the
stream decision; and the bodies of K14 and K15 (csrc/trace_absorb.cuh,
csrc/coeff_wsum.cuh) built with g++ against the plain versions.  Every
check is exact: integer field arithmetic and hashing."""

import ctypes
import hashlib
import os
import subprocess
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from distaff_tpu.crypto.merkle_dev import make_device_tree
from distaff_tpu.math import field_jax as fj
from distaff_tpu.ops import blake3_jax
from distaff_tpu.ops import tiles as jax_tiles
from distaff_tpu.stark.trace_table import TraceTable as JaxTraceTable

import distaff_torch
from distaff_torch import assembly, native, ProgramInputs, ProofOptions
from distaff_torch.math import field
from distaff_torch.math import field_torch as ft
from distaff_torch.ops import blake3_torch as b3
from distaff_torch.ops import deep_kernels as dk
from distaff_torch.ops import tiles
from distaff_torch.ops.hostsync import TransferBatch
from distaff_torch.stark import serde, TraceTable

GOLDEN_SHA256 = "876d9f49cddbe11a3b360c04245d3b29712b6309a1eb446af835b123c729c842"
GOLDEN_LEN = 12926
GOLDEN_SRC = "begin push.3 push.5 add end"
EXT = 16
CSRC = Path(b3.__file__).resolve().parent.parent / "csrc"
TESTS = Path(__file__).resolve().parent          # torch_mma_host.h: the tensor-core emulation


@contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: v for k, v in values.items() if v is not None})
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _registers(src):
    return native.execute_u64(assembly.compile(src), ProgramInputs.none())


@pytest.fixture(scope="module")
def tables():
    """The golden program's trace (19 registers: a partial last block),
    extended by both packages: the JAX package's materialized LDE, then
    the same table forced to stream as tests/test_streaming.py forces it;
    the port's table materialized and streamed (DISTAFF_STREAM_LDE=1), both
    committed with blake3."""
    regs, ctx_depth, loop_depth = _registers(GOLDEN_SRC)
    with _env(DISTAFF_STREAM_LDE=None, DISTAFF_HBM_BUDGET_BYTES=None):
        jax_stream = JaxTraceTable(regs, ctx_depth, loop_depth, EXT)
        jax_stream.extend()
        assert not jax_stream.streaming      # auto mode never streams tiny traces
        port = TraceTable(regs, ctx_depth, loop_depth, EXT)
        port.extend("cpu")
    jax_lde = np.asarray(jax_stream.lde_dev)
    jax_stream.streaming = True
    jax_stream.lde_dev = None
    jax_stream._stream_commit()

    with _env(DISTAFF_STREAM_LDE="1"):
        stream = TraceTable(regs, ctx_depth, loop_depth, EXT)
        stream.extend("cpu")
    assert stream.streaming and stream.lde_dev is None and stream.is_extended()
    trees = port.build_merkle_tree("blake3"), stream.build_merkle_tree("blake3")
    return jax_stream, jax_lde, port, stream, trees


def test_stream_polys_match_jax_stream(tables):
    jax_stream, _, port, stream, _ = tables
    assert np.array_equal(stream.polys_dev.numpy(), np.asarray(jax_stream.polys_dev))
    assert torch.equal(stream.polys_dev, port.polys_dev)


def test_stream_commit_matches_jax_stream(tables):
    jax_stream, jax_lde, port, stream, (port_tree, stream_tree) = tables
    assert np.array_equal(stream._leaf_digests.numpy(), np.asarray(jax_stream._leaf_digests))
    assert np.array_equal(stream.lde_stride_dev.numpy(), np.asarray(jax_stream.lde_stride_dev))
    assert torch.equal(stream.ev_slice(), port.ev_slice())
    assert np.array_equal(port.ev_slice().numpy(), jax_lde[:, ::EXT // 8])
    root = make_device_tree(jax_stream._leaf_digests).root()
    assert stream_tree.root() == root == port_tree.root()


def test_stream_query_rows_match_materialized(tables):
    jax_stream, _, port, stream, _ = tables
    positions = [1, 7, 30, 101, 7, port.domain_size() - 2]
    batch = TransferBatch()
    got = stream.get_register_values_at_async(positions, batch)
    want = port.get_register_values_at_async(positions, batch)
    assert got() == want() == jax_stream.get_register_values_at(positions)


def _jax_absorb(columns):
    """The JAX package's absorb functions over (R, D, 4) columns, driven as
    its _stream_commit drives them: (D, 8) digests."""
    r, d = columns.shape[0], columns.shape[1]
    byte_len = 16 * r
    n_blocks = -(-byte_len // 64)
    n_chunks = -(-n_blocks // 16)
    zero = np.zeros((d, 4), dtype=np.uint32)
    cv, chunk_cvs = blake3_jax.absorb_begin(d), []
    for block in range(n_blocks):
        four = [columns[j] if j < r else zero for j in range(4 * block, 4 * block + 4)]
        last = block == n_blocks - 1
        last_in_chunk = block % 16 == 15 or last
        blen = byte_len - 64 * (n_blocks - 1) if last else 64
        cv = blake3_jax.absorb_block(cv, *four, block % 16 == 0, last_in_chunk,
                                     last and n_chunks == 1, blen, block // 16)
        if last_in_chunk and n_chunks > 1:
            chunk_cvs.append(cv)
            if not last:
                cv = blake3_jax.absorb_begin(d)
    if n_chunks == 1:
        return np.asarray(blake3_jax.absorb_finish(cv))
    return np.asarray(blake3_jax.parent_root(*chunk_cvs).T)


def _port_absorb(columns, shift=2):
    cols = torch.from_numpy(columns)
    sliced = torch.empty((cols.shape[0], cols.shape[1] >> shift, 4), dtype=torch.uint32)
    digests = b3.absorb_rows(lambda lo: cols[lo:lo + 4], cols.shape[0], sliced, shift)
    assert torch.equal(sliced, cols[:, ::1 << shift])
    assert torch.equal(digests, b3.hash_rows_plain(cols.permute(1, 0, 2)))
    return digests.numpy()


def _random_columns(r, d, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(r, d, 4), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("regs", [21, 22, 23])
def test_trace_absorb_plain_partial_block_matches_jax(regs):
    # a last block of 16, 32 and 48 bytes
    columns = _random_columns(regs, 32, regs)
    assert np.array_equal(_port_absorb(columns), _jax_absorb(columns))


def test_trace_absorb_plain_two_chunks_matches_jax():
    # the geometry of tests/test_streaming.py::test_stream_wide_trace_two_chunk_commit:
    # 65 registers, rows of 1040 bytes in two chunks; its trace as the columns
    pushes = " ".join(f"push.{i + 1}" for i in range(31))
    loop3 = ("push.1 while.true push.1 while.true push.1 while.true "
             "push.0 end push.0 end push.0 end")
    regs, _, _ = _registers("begin " + pushes + " " + "block " * 12 + loop3 + " end " * 12
                            + " add end")
    assert regs.shape[0] > 64, f"geometry probe drifted: {regs.shape[0]} registers"
    columns = np.ascontiguousarray(regs).view(np.uint32).reshape(regs.shape[0], -1, 4)
    assert np.array_equal(_port_absorb(columns), _jax_absorb(columns))


def test_absorb_flags_follow_hash_rows():
    # 20 registers: five blocks of one chunk, the last ROOT; 65: chunk 0
    # ends at block 15, block 16 starts chunk 1 and the last one is the parent's
    assert [b3.absorb_flags(b, 320) for b in (0, 1, 4)] == [
        (b3.CHUNK_START, 64, 0, False), (0, 64, 0, False), (b3.CHUNK_END | b3.ROOT, 64, 0, False)]
    assert [b3.absorb_flags(b, 1040) for b in (15, 16)] == [
        (b3.CHUNK_END, 64, 0, False), (b3.CHUNK_START | b3.CHUNK_END, 16, 1, True)]
    with pytest.raises(ValueError):
        b3.absorb_flags(5, 320)


def test_coeff_wsum_plain_extended_matches_jax_lde_sums(tables):
    # the weighted sums of the coefficients, extended, are those of the LDE
    _, jax_lde, port, _, _ = tables
    r, n = port.register_count(), port.domain_size()
    rng = np.random.default_rng(5)
    ws = [[int.from_bytes(rng.bytes(16), "little") % field.M for _ in range(r)] for _ in range(2)]
    w1, w2 = (ft.from_ints(np.array(w, dtype=object), "cpu") for w in ws)
    sums = dk.coeff_wsum(port.polys_dev, w1, w2)
    got = tiles.ntt_batched(sums, field.get_root_of_unity(n), n=n)
    for s, w in enumerate(ws):
        want = jax_tiles.weighted_register_sum(jax_lde, fj.from_ints(np.array(w, dtype=object)))
        assert np.array_equal(got[s].numpy(), np.asarray(want))


def test_golden_proof_streamed_bytes():
    program = assembly.compile(GOLDEN_SRC)
    options = ProofOptions(extension_factor=16, num_queries=10, grinding_factor=2)
    with _env(DISTAFF_STREAM_LDE="1"):
        outputs, proof = distaff_torch.execute(program, ProgramInputs.none(), 1, options,
                                               device="cpu")
    data = serde.serialize(proof)
    assert len(data) == GOLDEN_LEN
    assert hashlib.sha256(data).hexdigest() == GOLDEN_SHA256
    assert distaff_torch.verify(program.hash, [], outputs, proof)


@pytest.mark.parametrize("mode,budget,streams", [
    (None, None, False),       # auto on the CPU with no budget: never
    ("auto", "extend", False),
    ("auto", "below", True),
    ("1", None, True),
    ("1", "extend", True),
    ("0", "extend", False),
    ("0", "below", MemoryError),
])
def test_stream_decision(mode, budget, streams):
    regs, ctx_depth, loop_depth = _registers(GOLDEN_SRC)
    table = TraceTable(regs, ctx_depth, loop_depth, EXT)
    need = table.extend_bytes()
    limit = {None: None, "extend": str(need), "below": str(need - 1)}[budget]
    with _env(DISTAFF_STREAM_LDE=mode, DISTAFF_HBM_BUDGET_BYTES=limit):
        if streams is MemoryError:
            with pytest.raises(MemoryError):
                table.extend("cpu")
            return
        table.extend("cpu")
    assert table.streaming == streams
    assert (table.lde_dev is None) == streams and table.is_extended()


def test_stream_with_sha3_raises_the_jax_assertion():
    jax_table = JaxTraceTable(*_registers(GOLDEN_SRC), EXT)
    jax_table.streaming = True
    with pytest.raises(AssertionError) as want:
        jax_table.build_merkle_tree("sha3")
    options = ProofOptions(extension_factor=16, num_queries=10, grinding_factor=2,
                           hash_fn="sha3")
    with _env(DISTAFF_STREAM_LDE="1"), pytest.raises(AssertionError) as got:
        distaff_torch.execute(assembly.compile(GOLDEN_SRC), ProgramInputs.none(), 1, options,
                              device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------------------------------------
# the kernels' bodies on the CPU
# ------------------------------------------------------------------------------------------------

_HARNESS = r"""
#include "coeff_wsum.cuh"
#include "torch_mma_host.h"
#include "trace_absorb.cuh"

// K14's launch on the CPU: every row in turn (the rows are independent)
extern "C" void trace_absorb_host(const void* regs, long long reg_stride, int n_regs,
                                  long long rows, void* cv, const void* chunk0, void* slice,
                                  long long slice_stride, int slice_shift, unsigned flags,
                                  unsigned block_len, unsigned long long counter) {
    const trace_absorb::Args a{(const uint4*)regs, reg_stride, n_regs, rows, (uint4*)cv,
                               (const uint4*)chunk0, (uint4*)slice, slice_stride, slice_shift,
                               flags, block_len, counter};
    for (long long d = 0; d < rows; ++d) trace_absorb::row(a, d);
}

// K15's launch on the CPU over a grid of `grid` blocks: the ring, product
// and digits of tests/torch_mma_host.h, then each thread's store
extern "C" void coeff_wsum_host(const void* polys, long long reg_stride, int regs, long long n,
                                const void* w1, const void* w2, void* out, long long grid) {
    const coeff_wsum::Args a{{(const uint4*)polys, reg_stride, regs, n, (const uint4*)w1,
                              (const uint4*)w2}, (uint4*)out};
    mma_host::run(
        a.polys, 0, grid,
        [&](long long block, long long k, long long, const uint32_t* digits, uint8_t*) {
            for (int tid = 0; tid < coeff_wsum::kThreads; ++tid)
                coeff_wsum::store(a, block + k * grid, digits, tid);
        },
        [](long long, long long, long long, uint8_t*) {});
}
"""


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    """csrc/trace_absorb.cuh and csrc/coeff_wsum.cuh built with g++ as
    host functions of one launch each."""
    tmp = tmp_path_factory.mktemp("k14_k15")
    (tmp / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(CSRC), "-I",
                    str(TESTS), str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")],
                   check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    vp, ll, i32, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
    lib.trace_absorb_host.argtypes = [vp, ll, i32, ll, vp, vp, vp, ll, i32, u32, u32,
                                      ctypes.c_ulonglong]
    lib.coeff_wsum_host.argtypes = [vp, ll, i32, ll, vp, vp, vp, ll]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("regs,rows,shift", [(20, 64, 2), (22, 48, 1), (70, 32, 2)])
def test_trace_absorb_body_matches_plain(bodies, monkeypatch, regs, rows, shift):
    # five full blocks; a 32-byte last block; two chunks and the parent node
    columns = torch.from_numpy(_random_columns(regs, rows, 100 + regs))

    def launch(group, cv, block, byte_len, chunk0=None, slice_out=None, slice_shift=0):
        flags, block_len, counter, _ = b3.absorb_flags(block, byte_len)
        bodies.trace_absorb_host(_ptr(group), group.stride(0) // 4, group.shape[0],
                                 group.shape[1], _ptr(cv), _ptr(chunk0), _ptr(slice_out),
                                 slice_out.stride(0) // 4, slice_shift, flags, block_len,
                                 counter)
        return cv

    want_slice = torch.empty((regs, rows >> shift, 4), dtype=torch.uint32)
    want = b3.absorb_rows(lambda lo: columns[lo:lo + 4], regs, want_slice, shift)
    got_slice = torch.full_like(want_slice, 0xDEADBEEF)
    monkeypatch.setattr(b3, "trace_absorb", launch)
    got = b3.absorb_rows(lambda lo: columns[lo:lo + 4], regs, got_slice, shift)
    assert torch.equal(got, want) and torch.equal(got_slice, want_slice)


def _wsum_body(lib, polys, w1, w2, grid):
    n = polys.shape[1]
    got = torch.full((2, n, 4), 0xDEADBEEF, dtype=torch.uint32)
    lib.coeff_wsum_host(_ptr(polys), polys.stride(0) // 4, polys.shape[0], n, _ptr(w1), _ptr(w2),
                        _ptr(got), grid)
    return got


def _random_limbs(rng, *shape):
    return ft.from_ints(np.array([int.from_bytes(rng.bytes(16), "little") % field.M
                                  for _ in range(int(np.prod(shape)))],
                                 dtype=object).reshape(shape), "cpu")


@pytest.mark.parametrize("regs,n", [(20, 1000), (1, 512), (128, 24)])
def test_coeff_wsum_body_matches_plain(bodies, regs, n):
    # a ragged last tile, one register, the most registers
    rng = np.random.default_rng(regs)
    polys, w1, w2 = _random_limbs(rng, regs, n), _random_limbs(rng, regs), _random_limbs(rng, regs)
    got = _wsum_body(bodies, polys, w1, w2, 3)
    assert torch.equal(got, dk.coeff_wsum_plain(polys, w1, w2))


@pytest.mark.parametrize("regs,n,values,grid", [
    pytest.param(2, 640, "streamed", 2, id="2-640-streamed"),   # one k-step, weights (1, 0), (0, 1)
    pytest.param(20, 900, "M - 1", 3, id="20-900-M-1"),         # the largest digits, a ragged tile
    pytest.param(33, 300, "random", 1, id="33-300"),            # two register groups of 17
    pytest.param(128, 256, "M - 1", 2, id="128-256-M-1"),       # four groups
])
def test_coeff_wsum_body_at_register_counts(bodies, regs, n, values, grid):
    # the tensor-core sums over one to four register groups, the streamed
    # call's weights and all M - 1, bit for bit the plain version's, and
    # nothing written past n in a larger row
    rng = np.random.default_rng(regs + n)
    if values == "M - 1":
        polys = ft.constant(field.M - 1, "cpu").expand(regs, n + 40, 4).contiguous()
        w1 = w2 = ft.constant(field.M - 1, "cpu").expand(regs, 4).contiguous()
    else:
        polys = _random_limbs(rng, regs, n + 40)
        w1, w2 = _random_limbs(rng, regs), _random_limbs(rng, regs)
    if values == "streamed":
        w1, w2 = (ft.from_ints(np.array(w, dtype=object), "cpu") for w in ([1, 0], [0, 1]))
    got = _wsum_body(bodies, polys[:, :n], w1, w2, grid)
    assert torch.equal(got, dk.coeff_wsum_plain(polys[:, :n], w1, w2))
