"""distaff_torch transition AIR on the CPU: TorchCol and its batched
helpers against Python ints, and K4's plain version (device_eval.
transition_plain) and its per-row evaluator (csrc/air_row.cuh, a template
over the trace's depths, built with g++ at the triples of
csrc/air_row_host.cpp) against the JAX package's host columnar AIR, the
path of distaff_tpu/stark/prover.py's fallback sweep: exact equality,
since this is integer field arithmetic.  No JAX jit compile of the AIR
runs here."""

import numpy as np
import pytest
import torch

from distaff_tpu.math import field as jax_field
from distaff_tpu.stark.constraints.evaluator import Evaluator as JaxEvaluator
from distaff_tpu.stark.trace_state import TraceState as JaxTraceState
from distaff_tpu.stark.trace_table import TraceTable as JaxTraceTable
from distaff_torch import native
from distaff_torch.crypto.ark_constants import SPONGE_MDS, HASHER_MDS
from distaff_torch.interop import limbs_from_numpy
from distaff_torch.math import field_torch as ft
from distaff_torch.math.torch_col import (
    TorchCol, is_col, mul_flag, pow3_all, mds_apply, weighted_sum)
from distaff_torch.ops import air_kernels
from distaff_torch import assembly, ProgramInputs
from distaff_torch.stark.constraints.device_eval import (
    air_tables, degree_adjustments, evaluate_transition_device, transition, transition_plain,
    transition_plain_rows)
from distaff_torch.stark.constraints.evaluator import Evaluator
from distaff_torch.stark.trace_table import TraceTable

M = jax_field.M
STEP_ROWS = 8
ROOT = b"\x11" * 32

# the six programs of tests/test_air.py
PROGRAMS = [
    ("begin add block push.5 mul push.7 end end", ProgramInputs.from_public([1, 2])),
    ("begin read if.true add push.3 else push.7 add push.8 end mul end",
     ProgramInputs([5, 3], [0], [])),
    ("begin mul read while.true dup mul read end end", ProgramInputs([5, 3], [1, 1, 0], [])),
    ("begin push.5 push.3 gt.8 end", ProgramInputs.none()),
    ("begin push.3 push.5 hash.2 end", ProgramInputs.none()),
    ("begin read rc.16 end", ProgramInputs([], [42], [])),
]
# (ctx, loop, stack) depths of the random domains: the smallest, the bench
# program's (a stack shorter than its window of 8), a typical one, the
# largest the kernel takes, and those of the examples that the bench
# program does not share (distaff_torch/examples.py at their defaults:
# collatz, comparison, conditional, merkle, rangecheck)
DEPTHS = [(0, 0, 1), (1, 0, 4), (1, 1, 8), (16, 8, 32),
          (2, 1, 8), (1, 0, 12), (1, 0, 3), (0, 0, 11), (0, 0, 6)]


def _ints(rng, shape):
    return np.array([int.from_bytes(rng.bytes(16), "little") % M
                     for _ in range(int(np.prod(shape)))], dtype=object).reshape(shape)


def _col(values):
    return TorchCol(ft.from_ints(np.asarray(values, dtype=object), "cpu"))


def _values(col):
    return list(ft.to_ints(col.t))


# ------------------------------------------------------------------------------------------------
# TorchCol
# ------------------------------------------------------------------------------------------------

def test_torch_col_operators_match_ints():
    rng = np.random.default_rng(1)
    a, b = list(_ints(rng, 16)), list(_ints(rng, 16))
    a[:3], b[:3] = [0, 1, M - 1], [M - 1, 0, M - 1]
    x, y = _col(a), _col(b)
    assert _values((x + y) % M) == [(u + v) % M for u, v in zip(a, b)]
    assert _values((x - y) % M) == [(u - v) % M for u, v in zip(a, b)]
    assert _values((x * y) % M) == [u * v % M for u, v in zip(a, b)]
    assert _values((1 - x) % M) == [(1 - u) % M for u in a]
    assert _values((x + 5) % M) == [(u + 5) % M for u in a]
    assert _values((7 * x) % M) == [7 * u % M for u in a]
    assert _values((0 + x * 2) % M) == [2 * u % M for u in a]
    assert is_col(3, x) and not is_col(3, 4)


def test_torch_col_batched_helpers_match_ints():
    rng = np.random.default_rng(2)
    n = 16
    flag = list(_ints(rng, n))
    cols = [list(_ints(rng, n)) for _ in range(6)]
    values = [_col(c) for c in cols[:5]] + [0]        # a Python-int pad among the columns
    ints = cols[:5] + [[0] * n]

    for got, c in zip(mul_flag(_col(flag), values), ints):
        assert _values(got) == [f * v % M for f, v in zip(flag, c)]
    for got, c in zip(pow3_all(values), ints):
        assert _values(got) == [pow(v, 3, M) for v in c]
    for width, mds in ((4, SPONGE_MDS), (6, HASHER_MDS)):
        out = mds_apply(values[:width], mds, width)
        for i in range(width):
            assert _values(out[i]) == [
                sum(mds[i * width + j] * ints[j][k] for j in range(width)) % M
                for k in range(n)]
    weights = list(_ints(rng, 6))
    got = weighted_sum(values, ft.from_ints(np.array(weights, dtype=object), "cpu"))
    assert _values(got) == [sum(w * c[k] for w, c in zip(weights, ints)) % M for k in range(n)]


# ------------------------------------------------------------------------------------------------
# transition_plain against the JAX package's host columnar AIR
# ------------------------------------------------------------------------------------------------

def _jax_host_column(evaluator, lde_u32):
    """The JAX package's host columnar sweep over an (R, n, 4) slice
    (distaff_tpu/stark/prover.py, its path without native or device AIR)."""
    n = lde_u32.shape[1]
    obj = lde_u32.astype(object)
    columns = [obj[i, :, 0] | (obj[i, :, 1] << 32) | (obj[i, :, 2] << 64) | (obj[i, :, 3] << 96)
               for i in range(lde_u32.shape[0])]
    depths = (evaluator.ctx_depth, evaluator.loop_depth, evaluator.stack_depth)
    current = JaxTraceState.from_vec(*depths, columns)
    next_state = JaxTraceState.from_vec(*depths, [np.roll(c, -STEP_ROWS) for c in columns])
    root = jax_field.get_root_of_unity(n)
    powers = np.array([pow(root, i, M) for i in range(n)], dtype=object)
    j = np.arange(n, dtype=np.int64)
    column = evaluator.evaluate_transition_columns(
        current, next_state, lambda p: powers[(j * (p % n)) % n])
    return [int(v) % M for v in column]


def _traces(src, inputs, tamper=False):
    """One native VM run in both packages' TraceTable: (port TraceTable,
    extended on the CPU, JAX TraceTable, outputs).  The JAX table is not
    extended: its LDE would equal the port's (tests/test_torch_ntt.py holds
    the NTTs against the JAX package), and the small test tiles make the
    JAX extension take tens of seconds per program."""
    program = assembly.compile(src)
    regs, ctx_depth, loop_depth = native.execute_u64(program, inputs)
    if tamper:
        regs = regs.copy()
        regs[16, 7, 0] += 1                  # one user-stack value mid-trace
    port = TraceTable(regs, ctx_depth, loop_depth, 16)
    port.extend("cpu")
    jax_trace = JaxTraceTable(regs, ctx_depth, loop_depth, 16)
    outputs = port.get_last_state().user_stack[:1]
    assert jax_trace.get_last_state().user_stack[:1] == outputs
    return port, jax_trace, outputs


@pytest.mark.parametrize("src,inputs", PROGRAMS)
def test_transition_plain_matches_jax_host_air_on_programs(src, inputs):
    port, jax_trace, outputs = _traces(src, inputs)
    public = inputs.get_public_inputs()
    evaluator = Evaluator.from_trace(port, ROOT, public, outputs)
    combined, bad = evaluate_transition_device(evaluator, port)

    lde_slice = port.lde_dev[:, ::port.extension_factor // STEP_ROWS].numpy()
    jax_evaluator = JaxEvaluator.from_trace(jax_trace, ROOT, public, outputs)
    assert list(ft.to_ints(combined)) == _jax_host_column(jax_evaluator, lde_slice)
    assert int(bad) == 0


def test_tampered_trace_counts_bad_steps():
    src, inputs = "begin push.3 push.5 add end", ProgramInputs.none()
    port, _, _ = _traces(src, inputs, tamper=True)
    evaluator = Evaluator.from_trace(port, ROOT, [], [8])
    _, bad = evaluate_transition_device(evaluator, port)
    assert int(bad) > 0


def _random_case(depths, n=256, seed=0):
    """An evaluator of a 2^k-step trace with these depths and a random
    (R, n, 4) slice over its evaluation domain."""
    ctx, loop, stack = depths
    rng = np.random.default_rng(seed)
    root = rng.bytes(32)
    port = Evaluator(n // STEP_ROWS, STEP_ROWS, ctx, loop, stack, root, [0, 0], 0, [], [])
    jax = JaxEvaluator(n // STEP_ROWS, STEP_ROWS, ctx, loop, stack, root, [0, 0], 0, [], [])
    lde = _ints(rng, (15 + ctx + loop + stack, n))
    limbs = np.stack([((lde >> (32 * k)) & 0xFFFFFFFF).astype(np.uint32) for k in range(4)], -1)
    return port, jax, limbs


@pytest.mark.parametrize("depths", DEPTHS)
def test_transition_plain_matches_jax_host_air_on_random_domain(depths):
    # random registers set every op flag, so every constraint arm counts
    port, jax, limbs = _random_case(depths, seed=sum(depths))
    combined, bad = transition_plain(limbs_from_numpy(limbs, "cpu"), air_tables(port, "cpu"))
    want = _jax_host_column(jax, limbs)
    assert list(ft.to_ints(combined)) == want
    steps = [v for k, v in enumerate(want) if k % STEP_ROWS == 0][:-1]
    assert int(bad) == sum(1 for v in steps if v)


@pytest.mark.parametrize("depths", DEPTHS)
def test_kernel_row_evaluator_matches_plain_on_random_domain(depths):
    # csrc/air_row.cuh, K4's per-row evaluator, compiles as plain C++
    port, _, limbs = _random_case(depths, seed=10 + sum(depths))
    tables = air_tables(port, "cpu")
    lde = limbs_from_numpy(limbs, "cpu")
    want, _ = transition_plain(lde, tables)
    assert torch.equal(air_kernels.air_rows_host(lde, tables), want)
    # the kernel reads the slice through its strides: a strided view gives the same
    wide = torch.zeros((lde.shape[0], 2 * lde.shape[1], 4), dtype=torch.uint32)
    wide[:, ::2] = lde
    assert torch.equal(air_kernels.air_rows_host(wide[:, ::2], tables), want)


def test_transition_plain_rows_matches_the_whole_slice():
    # the windows of chip_smoke.py's long slices, the last one wrapping
    port, _, limbs = _random_case((1, 0, 4), n=1024, seed=3)
    tables = air_tables(port, "cpu")
    lde = limbs_from_numpy(limbs, "cpu")
    want, _ = transition_plain(lde, tables)
    cycle = tables.dec_ark.shape[1]
    for start, stop in ((0, 2 * cycle), (2 * cycle, 1024), (1024 - cycle, 1024)):
        assert torch.equal(transition_plain_rows(lde, tables, start, stop), want[start:stop])
    with pytest.raises(ValueError):
        transition_plain_rows(lde, tables, 1, cycle + 1)


def test_host_build_instantiates_the_test_triples():
    # every random domain's depths, the bench program's and the golden one's
    assert set(DEPTHS) | {(1, 0, 4), (0, 0, 2)} <= set(air_kernels.host_triples())
    with pytest.raises(ValueError, match="no instantiation"):
        air_kernels.air_ops_per_row((2, 2, 2))


@pytest.mark.parametrize("depths", DEPTHS)
def test_kernel_degree_table_matches_evaluator(depths):
    # air_row.cuh folds each constraint at a coefficient position and into a
    # degree group fixed at compile time by its constexpr degree table
    port, _, _ = _random_case(depths)
    degrees = air_kernels.air_degrees_host(depths)
    assert degrees == port.transition_degrees()
    assert air_kernels.degree_groups(degrees) == air_tables(port, "cpu").groups
    assert air_kernels.degree_groups(degrees) == tuple(
        tuple(cs) for _, cs in port.t_degree_groups)


def test_kernel_library_refuses_depths_out_of_range():
    # raises before any build: no generic kernel stands behind the triples
    for depths in ((17, 0, 4), (1, 9, 4), (1, 0, 33), (-1, 0, 4)):
        with pytest.raises(ValueError, match="out of range"):
            air_kernels.air_lib(depths)


def _ops(depths):
    port, _, _ = _random_case(depths)
    return air_kernels.air_ops_per_row(depths), port


def test_kernel_row_operation_count():
    (muls, adds, subs), port = _ops((1, 1, 8))
    # the combination alone is two multiplies per constraint and one per group
    constraints = 20 + 1 + 1 + 2 + 8
    assert muls > 2 * constraints + len(port.t_degree_groups)
    assert adds > 0 and subs > 0
    assert _ops((1, 1, 8))[0] == (muls, adds, subs)


def test_kernel_row_evaluates_only_the_kept_stack_slots():
    # a stack of 4 has the window of a stack of 8 but keeps half its slots:
    # the evaluator leaves the other slots' terms out
    four, eight = _ops((1, 0, 4))[0], _ops((1, 0, 8))[0]
    assert four[0] < eight[0] and four[1] < eight[1]


def test_wrapper_checks_shapes():
    port, _, limbs = _random_case((1, 1, 8))
    tables = air_tables(port, "cpu")
    for run in (air_kernels.air_transition, transition):
        with pytest.raises(ValueError, match="registers"):
            run(limbs_from_numpy(limbs[1:], "cpu"), tables)
        with pytest.raises(ValueError, match="domain"):
            run(limbs_from_numpy(limbs[:, :128], "cpu"), tables)


def test_kernel_launch_refuses_cpu_tensors_and_wrapper_takes_plain_version():
    port, _, limbs = _random_case((0, 0, 1))
    tables = air_tables(port, "cpu")
    lde = limbs_from_numpy(limbs, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        air_kernels.air_transition(lde, tables)
    got, want = transition(lde, tables), transition_plain(lde, tables)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [256, 4096])
def test_degree_adjustments_from_tables_match_the_series(n):
    # K4 reads each group's x^incr as r^(incr j mod n) from r's two power
    # tables (a hi table above 1024 points), where it read a series of n
    port, _, _ = _random_case((1, 1, 8), n=n)
    tables = air_tables(port, "cpu")
    assert (tables.x_hi is None) == (n <= 1024) and tables.domain() == n
    root = jax_field.get_root_of_unity(n)
    got = degree_adjustments(tables, torch.arange(n))
    assert len(port.t_degree_groups) == got.shape[0] > 1
    for g, (incr, _) in enumerate(port.t_degree_groups):
        assert torch.equal(got[g], ft.power_series(jax_field.exp(root, incr), n, "cpu"))


def test_kernel_row_evaluator_reads_the_hi_table():
    # above 1024 points each group's adjustment takes one more multiply
    port, _, limbs = _random_case((0, 0, 1), n=2048, seed=5)
    tables = air_tables(port, "cpu")
    assert tables.x_hi is not None
    lde = limbs_from_numpy(limbs, "cpu")
    want, _ = transition_plain(lde, tables)
    assert torch.equal(air_kernels.air_rows_host(lde, tables), want)
