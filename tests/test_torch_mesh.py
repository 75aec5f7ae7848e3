"""The port's mesh (distaff_torch/parallel/, crypto/merkle_dev.
TiledDeviceMerkleTree) on the CPU, its slots CPU slots, held against the
JAX package's distaff_tpu/parallel/ on its virtual CPU mesh (tests/
conftest.py forces 8 host devices) where the JAX function takes arrays,
and the slice as a whole: proofs on 4 and 8 slots with the single-device
bytes.

Where a JAX function would cost an XLA compile that this file cannot
afford (the fold's, fri_jax.fold_rows), the port's sharded function is
held against the port's single-device kernel's plain version, which
tests/test_torch_fri.py holds against the JAX one, and against the JAX
package's host arithmetic; the tiled tree against the JAX package's host
Merkle tree.  Kernel bodies that take a slot's offset (K1's first column,
K9's first row) are built with g++ from their headers and run at slot
offsets."""

import ctypes
import hashlib
import os
import random
import subprocess
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from distaff_tpu import verify as jax_verify
from distaff_tpu.crypto.merkle import MerkleTree as JaxMerkleTree
from distaff_tpu.math import field as jax_field
from distaff_tpu.math import field_jax as fj
from distaff_tpu.math import quartic as jax_quartic
from distaff_tpu.parallel import mesh as jax_mesh
from distaff_tpu.parallel import ntt_sharded as jax_ns
from distaff_tpu.stark import serde as jax_serde

import distaff_torch
from distaff_torch import assembly, native, ProgramInputs, ProofOptions
from distaff_torch.crypto.merkle_dev import DeviceMerkleTree, TiledDeviceMerkleTree
from distaff_torch.math import field
from distaff_torch.math import field_torch as ft
from distaff_torch.ops import boundary_kernels as bk
from distaff_torch.ops import deep_kernels as dk
from distaff_torch.ops import field_kernels as fk
from distaff_torch.ops import fri_torch, tiles
from distaff_torch.parallel import mesh as pm
from distaff_torch.parallel import mesh_stages
from distaff_torch.parallel import ntt_sharded as ns
from distaff_torch.parallel.mesh import Sharded
from distaff_torch.stark import serde
from distaff_torch.stark.constraints.device_eval import (
    air_tables, transition_plain, transition_plain_shard)
from distaff_torch.stark.constraints.evaluator import Evaluator
from distaff_torch.stark.trace_table import TraceTable

M = field.M
GOLDEN_SHA256 = "876d9f49cddbe11a3b360c04245d3b29712b6309a1eb446af835b123c729c842"
GOLDEN_LEN = 12926
GOLDEN_SRC = "begin push.3 push.5 add end"
# the JAX package's 8-device program (tests/test_sharded.py), inputs [1, 0],
# and the bytes of its single-device proof at OPTIONS on the port:
# distaff_torch.execute(assembly.compile(EIGHT_SRC), ProgramInputs.from_public([1, 0]), 1,
# ProofOptions(*OPTIONS), device="cpu"), serialized
EIGHT_SRC = "begin repeat.2 swap dup.2 drop add end end"
EIGHT_SHA256 = "1aad51292945354fcc8cc871f9110a4fad04ef8c99d91d06b2bf16807cf66f92"
EIGHT_LEN = 14919
OPTIONS = (16, 10, 2)
CSRC = Path(fk.__file__).resolve().parent.parent / "csrc"


@contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _elements(shape, seed):
    """Field elements below M from a seed, as an object array of `shape`."""
    rng = random.Random(seed)
    return np.array([rng.randrange(M) for _ in range(int(np.prod(shape)))],
                    dtype=object).reshape(shape)


def _cpu_mesh(slots):
    return pm.make_mesh(slots, device="cpu")


def _prove(src, inputs, slots=None, **env):
    program = assembly.compile(src)
    mesh_stages.RECORDED_SHARDINGS.clear()
    with _env(DISTAFF_MESH_DEVICES=None if slots is None else str(slots), **env):
        outputs, proof = distaff_torch.execute(program, inputs, 1, ProofOptions(*OPTIONS),
                                               device="cpu")
    return program, outputs, proof, dict(mesh_stages.RECORDED_SHARDINGS)


# ------------------------------------------------------------------------------------------------
# the four-step transform over the slots against the JAX package's
# ------------------------------------------------------------------------------------------------

@pytest.mark.parametrize("n,slots", [(256, 4), (1024, 8)])
def test_ntt_sharded_matches_jax(n, slots):
    rng = random.Random(n)
    values = [rng.randrange(M) for _ in range(n)]
    mesh = jax_mesh.make_mesh(slots)
    forward = jax_ns.ntt_sharded(fj.from_ints(values), mesh)
    back = jax_ns.intt_sharded(forward, mesh)
    x = ft.from_ints(np.array(values, dtype=object), "cpu")
    got = ns.ntt_sharded(x, _cpu_mesh(slots))
    assert np.array_equal(got.numpy(), np.asarray(forward))
    assert np.array_equal(ns.intt_sharded(got, _cpu_mesh(slots)).numpy(), np.asarray(back))
    assert ns.LAST_SHARDING == ("columns", ("cpu",) * slots)


def test_transform_takes_rows_and_lays_out_rows():
    # a zero-extended batch from the home device and its result split by
    # rows, then transformed again from the rows: K1's transforms' values
    mesh = _cpu_mesh(4)
    n = 1024
    root = field.get_root_of_unity(n)
    x = ft.from_ints(_elements((3, n // 8), 3), "cpu")
    rows = ns.columns_to_rows(ns.transform(x, mesh, root, n), n)
    want = tiles.ntt_batched(x, root, n=n)
    assert torch.equal(torch.cat(rows.parts, dim=1), want)
    again = ns.gather(ns.transform(rows, mesh, root, n), n)
    assert torch.equal(again, tiles.ntt_batched(want, root))


# ------------------------------------------------------------------------------------------------
# parallel/mesh.py against the JAX package's: the LDE, the composition core, dryrun_step
# ------------------------------------------------------------------------------------------------

def test_sharded_lde_and_composition_match_jax():
    # dryrun_step's data (the JAX package's seeds): its register-sharded LDE
    # against the JAX package's; the whole step's row-sharded composition
    # against the JAX package's host arithmetic over that LDE (the JAX
    # sharded_composition's XLA:CPU compile alone would take this file's
    # time)
    rng = np.random.default_rng(0)
    values = rng.integers(0, 2**63, size=(16, 64)).astype(object)
    mesh = _cpu_mesh(4)
    lde = pm.sharded_lde(ft.from_ints(values, "cpu"), 16, mesh)
    assert lde.axis == "registers" and len(lde.parts) == 4
    jax_lde = jax_mesh.sharded_lde(fj.from_ints(values), 16, jax_mesh.make_mesh(4))
    assert np.array_equal(lde.gather().numpy(), np.asarray(jax_lde))

    composed = pm.dryrun_step(4, device="cpu")
    rng = np.random.default_rng(1)
    w1, w2 = (rng.integers(0, 2**63, size=(16,)) for _ in range(2))
    cols = fj.to_ints(np.asarray(jax_lde))
    root = jax_field.get_root_of_unity(cols.shape[1])
    want = []
    for j in range(cols.shape[1]):
        a1 = sum(int(w) * int(v) for w, v in zip(w1, cols[:, j])) % M
        a2 = sum(int(w) * int(v) for w, v in zip(w2, cols[:, j])) % M
        x = jax_field.exp(root, j)
        want.append((a1 * jax_field.inv(jax_field.sub(x, 123456789))
                     + a2 * jax_field.inv(jax_field.sub(x, 987654321))) % M)
    assert [int(v) for v in ft.to_ints(composed)] == want


def test_compose_sharded_matches_jax_wsum_full_and_compose_full():
    # K7's plain version on each slot's points of the domain, and the port's
    # _wsum_full and _compose_full, against the JAX package's _wsum_full and
    # its _compose_full's arithmetic on the host (distaff_tpu.math.field:
    # its XLA:CPU compile alone would take a seventh of this file's time)
    from distaff_tpu.parallel import mesh_stages as jax_stages
    from distaff_torch.stark import utils as stark_utils

    regs, n, trace_length = 5, 512, 32
    lde_ints, c_ints = _elements((regs, n), 5), _elements((n,), 6)
    w1, w2 = _elements((regs,), 7), _elements((regs,), 8)
    z, s1, s2, c_at_z, k1, k2, kc = 0x1234567, 11, 12, 13, 21, 22, 23

    class Coefficients:
        trace1, trace2 = list(w1), list(w2)
        t1_degree, t2_degree, constraints = k1, k2, kc

    root = field.get_root_of_unity(n)
    next_z = field.mul(z, field.get_root_of_unity(trace_length))
    incr = stark_utils.get_incremental_trace_degree(trace_length)
    a = [jax_stages._wsum_full(fj.from_ints(lde_ints), fj.from_ints(w)) for w in (w1, w2)]
    a1, a2 = (fj.to_ints(np.asarray(x)) for x in a)
    want = []
    for j in range(n):
        x = jax_field.exp(root, j)
        u = jax_field.inv(jax_field.sub(x, z))
        v = jax_field.inv(jax_field.sub(x, next_z))
        base = ((int(a1[j]) - s1) * u + (int(a2[j]) - s2) * v) % M
        want.append((base * k1 + base * jax_field.exp(x, incr) * k2
                     + (int(c_ints[j]) - c_at_z) * u * kc) % M)

    lde, c_lde = ft.from_ints(lde_ints, "cpu"), ft.from_ints(c_ints, "cpu")
    sums = [mesh_stages._wsum_full(lde, ft.from_ints(w, "cpu")) for w in (w1, w2)]
    assert all(np.array_equal(s.numpy(), np.asarray(j)) for s, j in zip(sums, a))
    full = mesh_stages._compose_full(*sums, c_lde, root, z, next_z, s1, s2, c_at_z, k1, k2, kc,
                                     field.exp(root, incr))
    assert [int(v) for v in ft.to_ints(full)] == want

    mesh = _cpu_mesh(4)
    rows = Sharded(mesh, [p.contiguous() for p in lde.split(n // 4, dim=1)], 1, "rows")
    split_c = mesh.scatter(c_lde, 0, "rows")
    got = mesh_stages._compose_slots(rows, split_c, w1, w2, z, Coefficients, s1, s2, c_at_z,
                                     trace_length)
    assert torch.equal(got.gather(), full)
    assert mesh_stages.RECORDED_SHARDINGS["composition"] == ("rows", ("cpu",) * 4)


# ------------------------------------------------------------------------------------------------
# the fold and the tiled tree
# ------------------------------------------------------------------------------------------------

def test_fold_sharded_matches_the_whole_layer_and_the_host_interpolation():
    n, slots = 1024, 4
    root = field.get_root_of_unity(n)
    ints = _elements((n,), 9)
    column = ft.from_ints(ints, "cpu")
    special_x = 0xDEADBEEF12345
    mesh = _cpu_mesh(slots)
    split = mesh.scatter(column, 0, "rows")
    q = n // 4
    layout = mesh_stages.fold_layout(split, q)
    assert torch.equal(mesh_stages.layer_rows(layout).gather(),
                       fri_torch.transpose_quartic(column, 1))
    got = mesh_stages.fold_sharded(layout, special_x, root, 1, mesh).gather()
    assert torch.equal(got, fri_torch.fri_fold_plain(column, special_x, root))
    # the JAX package's host fold (its verifier's): interpolate each row at
    # its four nodes, evaluate at special_x
    rows = [[int(ints[i + j * q]) for j in range(4)] for i in range(0, q, 37)]
    xs = [[jax_field.mul(jax_field.exp(root, i), jax_field.exp(root, j * q)) for j in range(4)]
          for i in range(0, q, 37)]
    want = jax_quartic.evaluate_batch(jax_quartic.interpolate_batch(xs, rows), special_x)
    assert [int(v) for v in ft.to_ints(got[::37])] == [int(v) for v in want]


@pytest.mark.parametrize("log_n,slots", [(13, 4), (14, 8)])
def test_tiled_tree_matches_device_and_jax_host_trees(log_n, slots):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    leaves = torch.from_numpy(rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64)
                              .astype(np.uint32))
    mesh = _cpu_mesh(slots)
    tiled = TiledDeviceMerkleTree(mesh.scatter(leaves, 0, "rows"))
    whole = DeviceMerkleTree(leaves)
    host = JaxMerkleTree(leaves.numpy().view(np.uint8).reshape(n, 32), "blake3")
    assert tiled.root() == whole.root() == host.root()
    positions = sorted(set(int(p) for p in rng.integers(0, n, size=40))) + [0, n - 1]
    positions = list(dict.fromkeys(positions))
    got, want = tiled.prove_batch(positions), host.prove_batch(positions)
    assert got.values == want.values and got.nodes == want.nodes and got.depth == want.depth
    assert JaxMerkleTree.verify_batch(host.root(), positions, want, "blake3")


# ------------------------------------------------------------------------------------------------
# the offset plain versions and the 8-row halo at a slot boundary
# ------------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_slice():
    """The golden trace's LDE slice over D_ev (ext 16) and its AirTables."""
    program = assembly.compile(GOLDEN_SRC)
    regs, ctx, loop = native.execute_u64(program, ProgramInputs.none())
    trace = TraceTable(regs, ctx, loop, 16)
    trace.extend("cpu")
    root = trace.build_merkle_tree("blake3").root()
    evaluator = Evaluator.from_trace(trace, root, [], trace.get_last_state().user_stack[:1])
    return trace.ev_slice(), air_tables(evaluator, "cpu"), evaluator


def _shards(lde, tables, slots):
    """transition_plain_shard on each of `slots` equal shares of the slice,
    each with its halo: (the columns, the counts)."""
    share = lde.shape[1] // slots
    out = [transition_plain_shard(lde[:, s * share:(s + 1) * share], tables, s * share,
                                  lde[:, (s + 1) % slots * share:][:, :8].contiguous())
           for s in range(slots)]
    return [c for c, _ in out], [int(b) for _, b in out]


@pytest.mark.parametrize("slots", [2, 4])
def test_transition_halo_at_slot_boundaries(golden_slice, slots):
    lde, tables, _ = golden_slice
    full, bad = transition_plain(lde, tables)
    columns, counts = _shards(lde, tables, slots)
    assert torch.equal(torch.cat(columns), full) and counts == [0] * slots == [int(bad)] * slots


def test_transition_halo_sees_a_bad_step_across_the_boundary(golden_slice):
    # a value altered in the first row of slot 1: slot 0's last step reads
    # it through its halo, and the slots' counts sum to the whole slice's
    lde, tables, _ = golden_slice
    tampered = lde.clone()
    tampered[0, lde.shape[1] // 2] = ft.constant(99, "cpu")
    _, want = transition_plain(tampered, tables)
    _, counts = _shards(tampered, tables, 2)
    assert counts[0] > 0 and sum(counts) == int(want)


def test_offset_plain_versions_at_a_slot_boundary(golden_slice):
    lde, _, evaluator = golden_slice
    n = lde.shape[1]
    half = n // 2
    i_parts, f_parts = evaluator.boundary_weight_vectors(lde.shape[0])
    xb = field.exp(field.get_root_of_unity(n), evaluator.b_degree_adj)
    whole = bk.boundary_columns_plain(lde, i_parts, f_parts, xb)
    part = bk.boundary_columns(lde[:, half:], i_parts, f_parts, xb, half, n)
    assert all(torch.equal(p, w[half:]) for p, w in zip(part, whole))

    regs, domain = 3, 256
    values = ft.from_ints(_elements((regs, domain), 11), "cpu")
    c_lde = ft.from_ints(_elements((domain,), 12), "cpu")
    w = [ft.from_ints(_elements((regs,), s), "cpu") for s in (13, 14)]
    root, scalars = field.get_root_of_unity(domain), [3, 5, 7, 11, 13, 17, 19, 23]
    whole = dk.deep_compose(values, c_lde, *w, root, 8, scalars)
    for first in (0, 64, 192):
        got = dk.deep_compose(values[:, first:first + 64], c_lde[first:first + 64], *w, root, 8,
                              scalars, first, domain)
        assert torch.equal(got, whole[first:first + 64])

    column = ft.from_ints(_elements((4 * 64,), 15), "cpu")
    whole = fri_torch.fri_fold(column, 99, root, 1)
    quarters = column.view(4, 64, 4)
    for first in (0, 16, 48):
        local = quarters[:, first:first + 16].contiguous().view(64, 4)
        got = fri_torch.fri_fold(local, 99, root, 1, first=first, layer_rows=64)
        assert torch.equal(got, whole[first:first + 16])


_HARNESS = r"""
#include <vector>
#include "fri_fold.cuh"
#include "ntt_pass.cuh"

// K1's kernel body a block and a thread at a time (tests/test_torch_ntt.py's
// harness), with the store factors' first column
extern "C" void ntt_pass_host(const void* in, void* out, const void* tw, const void* lo,
                              const void* hi, long long batch, int log_cols, int log_m,
                              long long in_bs, long long in_cs, long long in_ps,
                              long long n_in, long long out_bs, long long out_cs,
                              long long out_ps, int log_lo, long long first) {
    const ntt_pass::Args p = ntt_pass::make_args(in, out, tw, lo, hi, batch, log_cols, log_m,
                                                 in_bs, in_cs, in_ps, n_in, out_bs, out_cs,
                                                 out_ps, log_lo, first);
    std::vector<uint4> tile(ntt_pass::kTilePoints);
    for (long long block = 0; block < ntt_pass::blocks(p); ++block) {
        for (int tid = 0; tid < ntt_pass::kThreads; ++tid)
            ntt_pass::load_tile(p, tile.data(), block, tid);
        for (int rem = log_m; rem > 0;) {
            const int stages = ntt_pass::round_stages(rem);
            rem -= stages;
            for (int tid = 0; tid < ntt_pass::kThreads; ++tid)
                ntt_pass::round_dispatch(p, tile.data(), tid, stages, rem);
        }
        for (int tid = 0; tid < ntt_pass::kThreads; ++tid)
            ntt_pass::store_tile(p, tile.data(), block, tid);
    }
}

// K9's fold a thread at a time on a slot's rows [start, start + q) of a
// layer of layer_q rows, `rows` rows a thread
extern "C" void fri_fold_host(const void* column, long long q, int rows, const void* lo,
                              const void* hi, int log_lo, long long stride,
                              const uint32_t* constants, void* out, long long start,
                              long long layer_q) {
    fri_fold::Args a{(const uint4*)column, q, rows, fri_fold::kLeafRows / rows,
                     (const uint4*)lo, (const uint4*)hi, log_lo, stride, {}, (uint4*)out,
                     nullptr, start, layer_q};
    std::memcpy(&a.k, constants, sizeof(a.k));
    uint32_t words[16];
    for (long long g = 0; g < fri_fold::threads(a); ++g) {
        if (rows == 4)
            fri_fold::fold<4>(a, g, words);
        else
            fri_fold::fold<1>(a, g, *reinterpret_cast<uint32_t(*)[4]>(words));
    }
}
"""


@pytest.fixture(scope="module")
def kernel_bodies(tmp_path_factory):
    """ntt_pass.cuh and fri_fold.cuh built with g++ as host functions with
    their offsets."""
    tmp = tmp_path_factory.mktemp("mesh_bodies")
    (tmp / "harness.cpp").write_text("#include <cstring>\n" + _HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(CSRC),
                    str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")], check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ntt_pass_host.argtypes = [vp, vp, vp, vp, vp, ll, i32, i32] + [ll] * 7 + [i32, ll]
    lib.fri_fold_host.argtypes = [vp, ll, i32, vp, vp, i32, ll, ctypes.POINTER(ctypes.c_uint32),
                                  vp, ll, ll]
    return lib


def test_kernel_bodies_at_slot_offsets(monkeypatch, kernel_bodies):
    # every K1 pass of a sharded transform (step 1 at each slot's first
    # column) run by the kernel's own code against the plain pass
    real = fk.ntt_pass_plain
    firsts = []

    def both(src, dst, tw, batch, cols, ss, ds, n_in, lo=None, hi=None, first=0):
        want = real(src, dst.clone(), tw, batch, cols, ss, ds, n_in, lo, hi, first=first)
        p = lambda t: None if t is None else t.data_ptr()
        m = 2 * tw.shape[0]
        kernel_bodies.ntt_pass_host(p(src), p(dst), p(tw), p(lo), p(hi), batch,
                                    cols.bit_length() - 1, m.bit_length() - 1, *ss, n_in, *ds,
                                    0 if lo is None else lo.shape[0].bit_length() - 1, first)
        assert torch.equal(dst, want), (batch, cols, m, first)
        firsts.append(first)
        return dst

    monkeypatch.setattr(fk, "ntt_pass_plain", both)
    n = 1 << 12
    x = ft.from_ints(_elements((n,), 17), "cpu")
    assert torch.equal(ns.ntt_sharded(x, _cpu_mesh(4)), tiles.ntt(x))
    c = ns._split(n)[0] // 4
    assert sorted(set(firsts)) == [0, c, 2 * c, 3 * c]

    # K9 on each slot's rows of a layer, a thread at a time, 1 and 4 rows a thread
    q, slots, stride = 1024, 4, 4
    root = field.get_root_of_unity(4 * q * stride)
    column = ft.from_ints(_elements((4 * q,), 18), "cpu")
    whole = fri_torch.fri_fold_plain(column, 12345, root, stride)
    lo, hi = tiles._store_factors(4 * q * stride, root, 1, "cpu")
    share = q // slots
    for rows in (1, 4):
        for s in range(slots):
            local = column.view(4, q, 4)[:, s * share:(s + 1) * share].contiguous()
            words = (ctypes.c_uint32 * 32)(*fri_torch.fold_words(12345, root, stride, share))
            out = torch.zeros((share, 4), dtype=torch.uint32)
            kernel_bodies.fri_fold_host(local.data_ptr(), share, rows, lo.data_ptr(),
                                        hi.data_ptr(), tiles._LOG_LO, stride, words,
                                        out.data_ptr(), s * share, q)
            assert torch.equal(out, whole[s * share:(s + 1) * share]), (rows, s)


# ------------------------------------------------------------------------------------------------
# the slice as a whole
# ------------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_single():
    return serde.serialize(_prove(GOLDEN_SRC, ProgramInputs.none())[2])


def test_golden_proof_on_four_cpu_slots(golden_single):
    program, outputs, proof, recorded = _prove(GOLDEN_SRC, ProgramInputs.none(), 4)
    blob = serde.serialize(proof)
    assert len(blob) == GOLDEN_LEN and hashlib.sha256(blob).hexdigest() == GOLDEN_SHA256
    assert blob == golden_single
    assert distaff_torch.verify(program.hash, [], outputs, proof)
    for stage in ("transition", "boundaries", "composition", "fri_fold", "constraint_intt",
                  "constraint_lde", "merkle_subtrees"):
        assert len(recorded[stage][1]) == 4, stage


def test_eight_slot_proof_is_the_single_device_proof():
    inputs = ProgramInputs.from_public([1, 0])
    program, outputs8, proof8, recorded = _prove(EIGHT_SRC, inputs, 8)
    assert outputs8 == [2]
    blob = serde.serialize(proof8)
    assert len(blob) == EIGHT_LEN and hashlib.sha256(blob).hexdigest() == EIGHT_SHA256
    assert jax_verify(program.hash, inputs.get_public_inputs(), outputs8,
                      jax_serde.deserialize(blob))
    for stage in ("transition", "boundaries", "composition", "fri_fold"):
        axis, slots = recorded[stage]
        assert axis == "rows" and slots == ("cpu",) * 8, stage


def test_streamed_mesh_proof_is_the_streamed_proof():
    # the single-device streamed golden proof has the golden bytes
    # (tests/test_torch_stream.py)
    _, _, proof, recorded = _prove(GOLDEN_SRC, ProgramInputs.none(), 4, DISTAFF_STREAM_LDE="1")
    assert hashlib.sha256(serde.serialize(proof)).hexdigest() == GOLDEN_SHA256
    assert len(recorded["stream_ntt"][1]) == 4 and len(recorded["composition"][1]) == 4


def test_stages_that_do_not_split_run_on_the_home_slot(golden_single):
    # 3 slots divide no power of two: no stage splits (ntt_sharded.fits,
    # mesh_stages.transition_fits, fold_fits, subtree_fits), the proof is
    # the single-device one
    _, _, proof, recorded = _prove(GOLDEN_SRC, ProgramInputs.none(), 3)
    assert serde.serialize(proof) == golden_single
    assert recorded == {}


def test_mesh_choice_raises_where_it_cannot_be_had(monkeypatch):
    monkeypatch.setenv("DISTAFF_MESH_DEVICES", "2")
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError):
            pm.configured_mesh("cuda")
    assert [str(s.device) for s in pm.configured_mesh("cpu").slots] == ["cpu", "cpu"]
    monkeypatch.setenv("DISTAFF_MESH_DEVICES", "cpu,cuda:0")
    with pytest.raises(ValueError):
        pm.configured_mesh("cpu")
    with pytest.raises(ValueError):
        pm.Mesh(["cpu", "cuda:0"])
    monkeypatch.setenv("DISTAFF_MESH_DEVICES", "1")
    assert pm.configured_mesh("cpu") is None
    monkeypatch.delenv("DISTAFF_MESH_DEVICES")
    assert pm.configured_mesh("cuda") is None
