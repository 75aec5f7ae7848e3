"""distaff_torch end to end on the CPU: the golden proof bytes pinned by
tests/test_determinism.py (the JAX package's), verification, and the
package's boundaries.  On the CPU every step runs its kernels' plain
versions, step 3's transition constraints included (K4's plain version,
stark/constraints/device_eval.transition_plain), so the golden bytes hold
that path too."""

import hashlib
import logging
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distaff_torch
from distaff_torch import assembly, ProgramInputs, ProofOptions
from distaff_torch.stark import serde

GOLDEN_SHA256 = "876d9f49cddbe11a3b360c04245d3b29712b6309a1eb446af835b123c729c842"
GOLDEN_LEN = 12926
REPO = Path(__file__).resolve().parent.parent


def _golden_case():
    program = assembly.compile("begin push.3 push.5 add end")
    options = ProofOptions(extension_factor=16, num_queries=10, grinding_factor=2)
    return program, ProgramInputs.none(), options


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture(scope="module")
def golden_proof():
    """The golden case proved on the CPU with the prover's DEBUG step log on;
    returns (program, inputs, outputs, proof, log lines)."""
    program, inputs, options = _golden_case()
    steps = _Lines()
    package_log = logging.getLogger("distaff_torch")
    level = package_log.level
    package_log.addHandler(steps)
    package_log.setLevel(logging.DEBUG)
    try:
        outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cpu")
    finally:
        package_log.removeHandler(steps)
        package_log.setLevel(level)
    return program, inputs, outputs, proof, steps.lines


def test_golden_proof_bytes(golden_proof):
    proof = golden_proof[3]
    blob = serde.serialize(proof)
    assert len(blob) == GOLDEN_LEN
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_SHA256


def test_verify_accepts_and_rejects_tampering(golden_proof):
    program, inputs, outputs, proof, _ = golden_proof
    assert outputs == [8]
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof)
    with pytest.raises(ValueError):
        distaff_torch.verify(program.hash, inputs.get_public_inputs(), [9], proof)
    with pytest.raises(ValueError):
        distaff_torch.verify(b"\x00" * 32, inputs.get_public_inputs(), outputs, proof)


def test_serde_roundtrip_verifies(golden_proof):
    program, inputs, outputs, proof, _ = golden_proof
    blob = serde.serialize(proof)
    again = serde.deserialize(blob)
    assert serde.serialize(again) == blob
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, again)


def test_step_log_times_every_step_and_step_three_parts(golden_proof):
    lines = golden_proof[4]
    steps = [line.split(":")[0] for line in lines if line.startswith("step ")]
    assert steps[:5] == ["step 0 execute program", "step 1 part upload",
                         "step 1 part interpolation", "step 1 part LDE", "step 1 extend trace"]
    assert steps[5:8] == ["step 2 trace tree", "step 3 part evaluator (host)",
                          "step 3 part boundary columns"]
    assert steps[8:10] == ["step 3 part transition (K4 tables and launch)",
                           "step 3 evaluate constraints"]
    assert steps[10:12] == ["step 4 constraint polynomial", "step 5 constraint tree"]
    assert steps[12:16] == ["step 6 part coefficients (host)",
                            "step 6 part point evaluations (K8)",
                            "step 6 part composition (K7)", "step 6 DEEP composition"]
    assert steps[16:20] == ["step 7 part layer trees", "step 7 part root draws",
                            "step 7 part folds (K9)", "step 7 FRI layers"]
    assert [s.split()[1] for s in steps[20:]] == ["8", "9"]


# The golden case proved with sha3 by the JAX package: its proof's bytes
# before the options (serde.serialize_body; the reference serializes the
# options of blake3 proofs only).  Produced once, from the repository root:
#   JAX_PLATFORMS=cpu python -c "import hashlib, distaff_tpu as d; \
#     from distaff_tpu.stark import serde; \
#     p = d.assembly.compile('begin push.3 push.5 add end'); \
#     o, proof = d.execute(p, d.ProgramInputs.none(), 1, d.ProofOptions(16, 10, 2, 'sha3')); \
#     proof.options.hash_fn = 'blake3'; b = serde.serialize(proof)[:-4]; \
#     print(len(b), hashlib.sha256(b).hexdigest())"
SHA3_BODY_SHA256 = "73fd09242cd8ffc781def7cd68416ea83fd41c59d63a94c570d15a03340ba74b"
SHA3_BODY_LEN = 13794


def test_sha3_proof_gives_the_jax_packages_bytes(golden_proof):
    # the trace, constraint and FRI trees are hashed on the host with sha3
    program, inputs, options = _golden_case()
    options = ProofOptions(16, 10, 2, "sha3")
    outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cpu")
    body = serde.serialize_body(proof)
    assert len(body) == SHA3_BODY_LEN
    assert hashlib.sha256(body).hexdigest() == SHA3_BODY_SHA256
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof)
    with pytest.raises(ValueError):
        distaff_torch.verify(program.hash, inputs.get_public_inputs(), [9], proof)
    # a blake3 proof's body is its serialization less the options
    blob = serde.serialize(golden_proof[3])
    assert serde.serialize_body(golden_proof[3]) == blob[:-4]


@pytest.mark.parametrize("hash_name", ["poseidon", "rescue", "gmimc"])
def test_arithmetic_hashes_raise_as_the_jax_packages_do(hash_name):
    # they take at most 64 bytes; the golden trace's rows are 17 registers
    # of 16 bytes, so both packages raise when step 2 hashes the first row
    from distaff_tpu.crypto import hashes as jax_hashes

    with pytest.raises(Exception) as jax_error:
        jax_hashes.HASH_FUNCTIONS[hash_name](bytes(17 * 16))
    program, inputs, _ = _golden_case()
    with pytest.raises(jax_error.type, match=f"^{re.escape(str(jax_error.value))}$") as error:
        distaff_torch.execute(program, inputs, 1, ProofOptions(16, 10, 2, hash_name),
                              device="cpu")
    # raised by the hash's input check, as the trace tree's leaves are hashed
    frames = [entry.name for entry in error.traceback]
    assert frames[-3:] == ["hash_leaves", hash_name, "_state_from_bytes"]
    assert "build_merkle_tree" in frames


def test_package_imports_neither_jax_nor_distaff_tpu():
    code = (
        "import pkgutil, sys, distaff_torch\n"
        "for m in pkgutil.walk_packages(distaff_torch.__path__, 'distaff_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'distaff_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_execute_needs_cuda_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    program, inputs, options = _golden_case()
    with pytest.raises(RuntimeError, match="CUDA"):
        distaff_torch.execute(program, inputs, 1, options)


def test_kernel_bench_runs_on_cpu(capsys):
    from distaff_torch.tools import kernel_bench

    rows = kernel_bench.bench([7], device="cpu")
    assert [r["op"] for r in rows] == [
        "tiles.ntt", "ntt_stagewise", "mul", "power_series", "inv_batch", "exp_const",
        "blake3 32x64B", "air_transition", "leaf256", "leaf256 via K1"]
    assert all(r["ms"] > 0 for r in rows)
    assert "2^7   air_transition" in capsys.readouterr().out


# ------------------------------------------------------------------------------------------------
# the JAX package's debug checks (DISTAFF_DEBUG) and precondition errors, in both packages
# ------------------------------------------------------------------------------------------------

def _raised(fn):
    """The exception fn() raises (it must raise one)."""
    with pytest.raises(Exception) as error:
        fn()
    return error.value


def test_debug_checks_pass_an_honest_proof(monkeypatch):
    # tests/test_e2e.py::test_debug_degree_validation on the port: all three
    # checks run and pass on an honest trace
    monkeypatch.setenv("DISTAFF_DEBUG", "1")
    program = assembly.compile("begin push.7 push.11 mul end")
    inputs = ProgramInputs.none()
    options = ProofOptions(extension_factor=16, num_queries=10, grinding_factor=2)
    outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cpu")
    assert outputs == [77]
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof)


def test_debug_misdeclared_degree_caught(monkeypatch):
    # tests/test_e2e.py::test_misdeclared_degree_caught on the port: an
    # under-declared degree fails the per-constraint degree validation
    from distaff_torch.stark.constraints.evaluator import Evaluator

    monkeypatch.setenv("DISTAFF_DEBUG", "1")
    real = Evaluator.transition_degrees
    monkeypatch.setattr(Evaluator, "transition_degrees", lambda self: [0] * len(real(self)))
    program, inputs, options = _golden_case()
    with pytest.raises(AssertionError, match="constraint degrees"):
        distaff_torch.execute(program, inputs, 1, options, device="cpu")


def test_debug_altered_trace_raises_as_the_jax_package_does(monkeypatch):
    # one stack value altered after execution: the port stops at step 3 with
    # AssertionError, and so does the JAX package's check of the same trace
    # (its host sweep, fed the port's LDE as tests/test_torch_air.py does:
    # the JAX extension at the test tiles takes tens of seconds).  That
    # sweep names the bad steps; its device path and the port count them
    # (distaff_tpu/stark/constraints/device_eval.py:319-324)
    from distaff_tpu.stark import prover as jax_prover
    from distaff_tpu.stark.constraints.evaluator import Evaluator as JaxEvaluator
    from distaff_tpu.stark.trace_table import TraceTable as JaxTraceTable
    from distaff_torch import native
    from distaff_torch.config import MAX_CONSTRAINT_DEGREE
    from distaff_torch.stark import TraceTable

    program, inputs, options = _golden_case()
    regs, ctx_depth, loop_depth = native.execute_u64(program, inputs)
    regs = regs.copy()
    regs[15 + ctx_depth + loop_depth, 3, 0] += 1     # the first user-stack register
    monkeypatch.setattr(native, "execute_u64", lambda *_: (regs, ctx_depth, loop_depth))
    monkeypatch.setenv("DISTAFF_DEBUG", "1")
    got = _raised(lambda: distaff_torch.execute(program, inputs, 1, options, device="cpu"))

    port = TraceTable(regs, ctx_depth, loop_depth, options.extension_factor())
    port.extend("cpu")
    jax_trace = JaxTraceTable(regs, ctx_depth, loop_depth, options.extension_factor())
    jax_trace.lde_dev = port.lde_dev.numpy()
    outputs = port.get_last_state().user_stack[:1]
    evaluator = JaxEvaluator.from_trace(jax_trace, bytes(32), [], outputs)
    want = _raised(lambda: jax_prover._native_transition_column(
        evaluator, jax_trace, options.extension_factor() // MAX_CONSTRAINT_DEGREE, True))

    assert type(want) is AssertionError and type(got) is AssertionError
    steps = re.fullmatch(r"transition constraints not satisfied at step \[([0-9 ]+)\]", str(want))
    assert steps, str(want)
    count = len(steps.group(1).split())
    assert count > 0
    assert str(got) == f"transition constraints not satisfied at {count} trace steps"


def _precondition_cases():
    """(name, run(package)) for the three checks of execute() that precede
    the proof: too many outputs, too short a run, a wrong program hash."""

    def too_many_outputs(pkg, monkeypatch):
        program = pkg.assembly.compile("begin push.3 push.5 add end")
        return lambda: pkg.execute(program, pkg.ProgramInputs.none(), pkg.config.MAX_OUTPUTS + 1,
                                   pkg.ProofOptions(16, 10, 2), **_cpu(pkg))

    def too_short(pkg, monkeypatch):
        program = pkg.assembly.compile("begin push.3 push.5 add end")
        monkeypatch.setattr(pkg, "MIN_TRACE_LENGTH", 1 << 20)
        return lambda: pkg.execute(program, pkg.ProgramInputs.none(), 1,
                                   pkg.ProofOptions(16, 10, 2), **_cpu(pkg))

    def wrong_hash(pkg, monkeypatch):
        program = pkg.assembly.compile("begin push.3 push.5 add end")
        program.hash = bytes(32)
        return lambda: pkg.execute(program, pkg.ProgramInputs.none(), 1,
                                   pkg.ProofOptions(16, 10, 2), **_cpu(pkg))

    return {"too_many_outputs": too_many_outputs, "too_short": too_short,
            "wrong_hash": wrong_hash}


def _cpu(pkg):
    return {"device": "cpu"} if pkg is distaff_torch else {}


@pytest.mark.parametrize("case", sorted(_precondition_cases()))
def test_precondition_errors_are_the_jax_packages(monkeypatch, case):
    import distaff_tpu

    run = _precondition_cases()[case]
    want = _raised(run(distaff_tpu, monkeypatch))
    got = _raised(run(distaff_torch, monkeypatch))
    assert type(want) is AssertionError
    assert type(got) is AssertionError and str(got) == str(want)


def test_choose_on_a_non_binary_condition_raises_assertion_error():
    # tests/test_e2e_programs.py::test_selection_operations_panic on the
    # port: the native VM's failure is an AssertionError, as in the JAX package
    from distaff_torch.programs import Program
    from distaff_torch.programs.blocks import Group, Span
    from distaff_torch.programs.opcodes import OpCode

    program = Program(Group([Span([
        OpCode.Begin, OpCode.Choose, OpCode.Choose, OpCode.Noop,
        OpCode.Noop, OpCode.Noop, OpCode.Noop, OpCode.Noop,
        OpCode.Noop, OpCode.Noop, OpCode.Noop, OpCode.Noop,
        OpCode.Noop, OpCode.Noop, OpCode.Noop,
    ], {})]))
    inputs = ProgramInputs.from_public([3, 4, 2, 5, 0, 6, 7, 8])
    with pytest.raises(AssertionError, match="CHOOSE.*non-binary"):
        distaff_torch.execute(program, inputs, 8, ProofOptions(16, 10, 2), device="cpu")


# ------------------------------------------------------------------------------------------------
# the power tables: planned at the proof's start, built in one K12 launch
# ------------------------------------------------------------------------------------------------

class TableLog:
    """Over a proof: the keys that its start plans (the first build_tables
    call), every key that a table user asks for (tiles.tables), and every
    table built after the plan.  On the CPU the plain versions of K7, K9,
    K10 and K11 read no table, so their wrappers here also make the calls
    that ask for the card's tables (compose_args, fold_table_keys,
    boundary_args, syn_div_args) with the proof's own arguments.  A context
    manager around the proof: the table cache is emptied on entry, and the
    keys it holds are kept on exit."""

    def __init__(self, monkeypatch):
        from distaff_torch.ops import (boundary_kernels, deep_kernels, fri_torch,
                                       syndiv_kernels, tiles)

        self.planned, self.asked, self.late = None, set(), []
        build, tables = tiles.build_tables, tiles.tables

        def logged_build(keys):
            built = build(keys)
            if self.planned is None:
                self.planned = list(keys)
            else:
                self.late.extend(built)
            return built

        def logged_tables(keys):
            self.asked.update(keys)
            return tables(keys)

        def asking(module, name, ask):
            real = getattr(module, name)

            def wrapper(*args):
                ask(*args)
                return real(*args)
            monkeypatch.setattr(module, name, wrapper)

        monkeypatch.setattr(tiles, "build_tables", logged_build)
        monkeypatch.setattr(tiles, "tables", logged_tables)
        asking(deep_kernels, "deep_compose", lambda lde, c, w1, w2, root, incr, scalars:
               deep_kernels.compose_args(lde, root, incr, scalars))
        asking(boundary_kernels, "boundary_columns", boundary_kernels.boundary_args)
        asking(syndiv_kernels, "syn_div", lambda polys3, degree, x_last:
               syndiv_kernels.syn_div_args(polys3.shape[1], x_last, polys3.device))
        monkeypatch.setattr(fri_torch, "fri_fold", self._fold(fri_torch, logged_tables))
        self.tiles, self.kept = tiles, None

    def __enter__(self):
        self.tiles._TABLES.clear()
        return self

    def __exit__(self, *exc):
        self.kept = set(self.tiles._TABLES)

    @staticmethod
    def _fold(fri_torch, ask):
        real = fri_torch.fri_fold

        def fold(column, special_x, root, stride=1, digests=False):
            ask(fri_torch.fold_table_keys(column.shape[0], stride, root, column.device))
            return real(column, special_x, root, stride, digests)
        return fold

    def check(self):
        """The proof built its planned tables and no other, and asked for
        every one of them."""
        assert self.planned, "the proof planned no table"
        assert self.late == []
        assert self.kept == set(self.planned)
        assert self.asked == set(self.planned)


def _bench_rung(log2_trace):
    # bench.py's sizing: 3N/64 unrolled iterations pad to exactly 2^k steps
    n_iter = (1 << log2_trace) * 3 // 64
    program = assembly.compile(f"begin repeat.{n_iter} swap dup.2 drop add end end")
    return program, ProgramInputs.from_public([1, 0]), ProofOptions()


@pytest.mark.parametrize("case", ["golden", "bench 2^10", "golden streamed"])
def test_proof_builds_only_its_planned_tables(monkeypatch, case):
    # the golden case, bench.py's smallest rung (its default options: ext
    # 32) and the golden case forced to stream
    program, inputs, options = _bench_rung(10) if case == "bench 2^10" else _golden_case()
    if case == "golden streamed":
        monkeypatch.setenv("DISTAFF_STREAM_LDE", "1")
    with TableLog(monkeypatch) as log:
        outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cpu")
    log.check()
    if case != "bench 2^10":
        assert hashlib.sha256(serde.serialize(proof)).hexdigest() == GOLDEN_SHA256
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof)


@pytest.mark.parametrize("log2_trace,ext,count", [
    (6, 16, 11), (10, 32, 20), (16, 32, 21), (18, 32, 23), (20, 32, 25), (22, 32, 24)])
def test_proof_tables_fit_one_launch(log2_trace, ext, count):
    # the K12 tables a proof plans (a twiddle table or a store-factor lo,
    # and a hi above 1024 points), one launch's worth: 21, 23 and 25 at the
    # bench's 2^16, 2^18 and 2^20 rungs, the launches a first proof made
    # when K12 built a table a launch
    from distaff_torch.ops import tiles
    from distaff_torch.stark.prover import proof_table_keys

    n = 1 << log2_trace
    keys = proof_table_keys(n, n * ext, "cpu")
    assert all(key[1] == "cpu" for key in keys)
    series = [s for key in dict.fromkeys(keys) for s in tiles._series(key)]
    assert len(series) == count <= 64              # kMaxTables
