"""Smoke run of distaff_torch on one NVIDIA H100: builds the kernels, holds
each against its plain PyTorch version at the main path's shapes, proves
and verifies the bench's Fibonacci program on the card, and runs the
kernel bench.

Usage (from the root of the repository, on a machine with the card):

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. build   - all at once: nvcc builds each distaff_torch/csrc/*.cu but
               K4's (K1-K3, K5, K6) in its own call and links them, and K4
               once for each depth triple of AIR_TRIPLES (its library is
               built per geometry); g++ builds native/*.cpp and K4's host
               row evaluator (all into distaff_torch/_build/); prints each
               build's seconds, ptxas' register and spill lines for K1, for
               K4 at each triple and for K6, and the card's name and power
               limit
  2. kernels - K1 ntt_pass at every pass the 2^16 proof launches (its NTTs
               run on random inputs of their shapes, each pass recorded and
               launched again), one row each,
               K2 add/sub/mul/exp_const at 2^21 elements, over every pair of
               edge values (the PTX multiply's carries) and on the broadcast
               operands of the main path, K3 blake3_rows at 2^21 rows of 320
               bytes and a Merkle level of 2^21 -> 2^20 nodes, K4
               air_transition at (20, 2^19) on the stride slice of the 2^16
               Fibonacci LDE (bad steps 0), on a copy with one value altered
               (bad steps > 0) and on random registers, K5 butterfly at 2^19
               pairs, K6 inv_batch at 2^21 elements with zeros and edge
               values and on a ragged length, each equal (tolerance zero:
               integer field arithmetic and hashing) to its plain version on
               the same inputs; times from CUDA events
  3. golden  - `begin push.3 push.5 add end` with ProofOptions(16, 10, 2)
               proved on cuda (step 3 through K4 at depths (0, 0, 2), step 6
               through K6) must serialize to the bytes pinned in
               tests/test_determinism.py
  4. main    - the bench's 2^16 Fibonacci proof (bench.py sizing, inputs
               [1, 0], default ProofOptions) proved on cuda and verified,
               with its time, peak device memory and the launches of every
               kernel: K1-K4 and K6 must launch (K4 and K6 exactly once, K2's
               exp_const never), K1 exactly at the passes phase 2 checked
               and none of two points; then proved with per-step times
               (step 1's and step 3's parts too), and once more without
  5. bench   - the kernel bench (distaff_torch/tools/kernel_bench.py) at
               2^14, 2^18 and 2^20, which holds ntt_stagewise (K5) equal to
               tiles.ntt (K1) at each size; K5, K2's exp_const, K6 and
               K1-K3 must launch

The last two lines are the kernel table as JSON and the contract line
{"ok": true, "device": {...}}.
"""

import hashlib
import json
import logging
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import torch

from distaff_torch.tools.timing import time_ms

GOLDEN_SHA256 = "876d9f49cddbe11a3b360c04245d3b29712b6309a1eb446af835b123c729c842"
GOLDEN_LEN = 12926
MAIN_LOG2_TRACE = 16
SEED = 20261016

# Bounds: the least time the card could take is the larger of the bytes
# moved (each input read once, each output written once) at 3.35 TB/s
# (H100 SXM data sheet) and the 32-bit integer instructions issued at the
# SM's issue width: 4 schedulers x 32 lanes, one instruction per lane per
# cycle, x SM count x maximum SM clock, both read from the card.  (The
# integer-only pipe has 64 lanes per SM, but IMAD and shifts also issue to
# the FMA pipe; the BLAKE3 kernel runs faster than 64 lanes would allow.)
# Instruction counts per operation, from the algorithms at their leanest
# (K1's butterflies and multiplies counted from this run's data, dif_work):
# a modular add or sub is 4 carry-chained adds, 4 trial subtractions and 4
# selects; a modular multiply is 16 wide 32x32->64 multiply-adds with 16
# carry adds, the fold of the high half through the 46-bit R (8 + 8), the
# second fold (4 + 4) and the final conditional subtraction (8); a BLAKE3
# compression is 7 rounds x 8 G x 12 (2 three-input adds, 2 adds, 4 xors,
# 4 rotates) plus the 8 output xors.  K4's field operations per row are
# counted from its own code (air_kernels.air_ops_per_row: the row
# evaluator built for the host counts them at this run's depths).  K6's
# bound: one read and one write of 16 bytes an element (2^21 elements: 67
# MB, 0.020 ms) against 3 multiplies an element, Montgomery's least; its
# floor in practice is the latency of a block's one dependent inversion
# chain.
HBM_BYTES_PER_S = 3.35e12
ISSUE_LANES_PER_SM = 128
ADD_OPS = SUB_OPS = 12
MUL_OPS = 64
COMPRESS_OPS = 7 * 8 * 12 + 8
# a kernel's time is the median of this many means over back-to-back launches
KERNEL_TRIALS = 7
# kernels of each path: the proof launches K1-K4 and K6, the kernel bench
# K5 and K2's exp_const with K1-K3 and K6 (the bench also times K4, on a
# random domain)
MAIN_PATH = ("ntt_pass", "field_ew.add", "field_ew.sub", "field_ew.mul", "inv_batch",
             "blake3_rows", "blake3_rows.parents", "air_transition")
BENCH_PATH = ("ntt_pass", "field_ew.mul", "field_ew.exp_const", "inv_batch", "blake3_rows",
              "butterfly")
BENCH_SIZES = (14, 18, 20)
# K4's geometries on this run's paths: the bench program's (also the kernel
# bench's AIR_DEPTHS) and the golden program's
AIR_TRIPLES = ((1, 0, 4), (0, 0, 2))


def int32_ops_per_s():
    """32-bit instructions the card can issue per second."""
    clock_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_LANES_PER_SM * float(clock_mhz) * 1e6


def max_abs_err(got, want):
    """Largest difference between two tensors, or two tuples of them."""
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_equal(name, shape, kernel, plain):
    """Hold kernel() against plain() (tolerance zero); returns kernel()'s
    result and the largest difference, 0."""
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name} at {shape}: kernel and plain version differ "
                             f"(max abs err {err})")
    return got, err


def check_kernel(name, shape, kernel, plain, reps, plain_reps, bound_bytes, bound_ops,
                 ops_rate, source, replaces):
    """Hold kernel() against plain() (tolerance zero), time both and return
    the kernel's row of the JSON table."""
    _, err = check_equal(name, shape, kernel, plain)
    ms = time_ms(kernel, reps, KERNEL_TRIALS, queued=True)
    plain_ms = time_ms(plain, plain_reps)
    t_bytes = bound_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = bound_ops / ops_rate * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"kernel {name} at {shape}: equal to plain; {ms:.4f} ms (plain {plain_ms:.3f} ms, "
          f"bound {max(t_bytes, t_ops):.4f} ms by {bound_by})", flush=True)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": bound_by, "library_ms": None}


def phase_kernels(ops_rate):
    """Each kernel at the main path's shapes, equal to its plain version.
    K1 gives a row for each of the proof's passes; for the other kernels
    the first check of each entry gives its row of the JSON table, and the
    others hold the broadcast layouts that the 2^16 proof also launches."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import blake3_torch as b3
    from distaff_torch.ops import field_kernels as fk
    from distaff_torch.tools.timing import random_elements

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    k2 = "distaff_torch/csrc/field_ew.cu"
    k3 = "distaff_torch/csrc/blake3_rows.cu"
    rows = check_passes(gen, ops_rate)

    # K2 at the LDE domain of the 2^16 rung: 2^21 elements
    count = 1 << 21
    a = random_elements(gen, (count,))
    c = random_elements(gen, (count,))
    for op, cost, line in (("mul", MUL_OPS, 248), ("add", ADD_OPS, 123), ("sub", SUB_OPS, 137)):
        kern, plain = getattr(fk, op), getattr(fk, op + "_plain")
        rows.append(check_kernel(
            f"field_ew.{op}", f"{count} x {count}", lambda k=kern: k(a, c),
            lambda p=plain: p(a, c), 50, 3, 3 * count * 16, count * cost, ops_rate,
            k2, f"distaff_tpu/math/field_jax.py:{line}"))
    e = hostfield.M - 2                                   # inv_batch's exponent
    chain = (e.bit_length() - 1) + (bin(e).count("1") - 1)
    rows.append(check_kernel(
        "field_ew.exp_const", f"{count}", lambda: fk.exp_const(a, e),
        lambda: fk.exp_const_plain(a, e), 5, 1, 2 * count * 16, count * chain * MUL_OPS,
        ops_rate, k2, "distaff_tpu/math/field_jax.py:279"))

    # the PTX multiply's carries: K2 over every pair of edge values
    x, y = edge_pairs(ft)
    for op in ("mul", "add", "sub"):
        kern, plain = getattr(fk, op), getattr(fk, op + "_plain")
        check_equal(f"field_ew.{op}", f"{x.shape[0]} edge pairs", lambda: kern(x, y),
                    lambda: plain(x, y))
    print(f"kernel field_ew.mul/add/sub over {x.shape[0]} edge pairs: equal to plain",
          flush=True)

    # K6 at 2^21 with every 1000th element zero and the edge values in
    # front, then on a length that leaves its last tile ragged
    z = a.clone()
    z[::1000] = ft.zeros((), "cuda")
    z[1:x.shape[0] + 1] = x
    rows.append(check_kernel(
        "inv_batch", f"{count}, zeros and edge values", lambda: fk.inv_batch(z),
        lambda: fk.inv_batch_plain(z), 50, 1, 2 * count * 16, count * 3 * MUL_OPS, ops_rate,
        "distaff_torch/csrc/inv_batch.cu", "distaff_tpu/math/field_jax.py:338"))
    ragged = z[:count - 2077]
    check_equal("inv_batch", f"{ragged.shape[0]}", lambda: fk.inv_batch(ragged),
                lambda: fk.inv_batch_plain(ragged))
    print(f"kernel inv_batch at {ragged.shape[0]}: equal to plain", flush=True)

    # K2's broadcasts on the main path: a constant operand (tiles.scale and
    # the weighted register sums over the LDE), neg (a zero scalar minus a
    # column), and a register of the LDE's stride-4 slice (step 3's
    # boundary sums) times its weight
    scalar = ft.constant(0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321, "cuda")
    zero = ft.zeros((), "cuda")
    variants = [
        ("mul", f"{count} x (4,)", a, scalar, count, 2 * count + 1),
        ("sub", f"(4,) x {count}", zero, a, count, 2 * count + 1),
    ]
    lde = random_elements(gen, (20, count))
    variants.append(("mul", f"(20, {count})[3, ::4] x (4,)", lde[3, ::4], scalar, count // 4,
                     2 * (count // 4)))
    for op, shape, x, y, n, elements in variants:
        kern, plain = getattr(fk, op), getattr(fk, op + "_plain")
        check_kernel(f"field_ew.{op}", shape, lambda k=kern, x=x, y=y: k(x, y),
                     lambda p=plain, x=x, y=y: p(x, y), 50, 1, elements * 16,
                     n * (MUL_OPS if op == "mul" else ADD_OPS), ops_rate, k2, "")

    # K3: trace rows of the 2^16 rung (20 registers = 320 bytes) hashed in
    # place from the (R, D, 4) LDE, and one Merkle level 2^21 -> 2^20
    regs = 20
    trace_rows = lde.permute(1, 0, 2)
    blocks = (regs * 16 + 63) // 64
    rows.append(check_kernel(
        "blake3_rows", f"{count} rows x {regs * 16} B", lambda: b3.hash_rows(trace_rows),
        lambda: b3.hash_rows_plain(trace_rows), 10, 1, count * (regs * 16 + 32),
        count * blocks * COMPRESS_OPS, ops_rate, k3, "distaff_tpu/ops/blake3_jax.py:95"))
    level = random_elements(gen, (count, 2)).view(count, 8)
    rows.append(check_kernel(
        "blake3_rows.parents", f"{count} -> {count // 2} nodes", lambda: b3.hash_level(level),
        lambda: b3.hash_rows_plain(level.view(count // 2, 4, 4)),
        20, 1, count * 32 + count // 2 * 32, count // 2 * COMPRESS_OPS, ops_rate,
        k3, "distaff_tpu/crypto/merkle_dev.py:34"))
    del lde, trace_rows, level
    rows.append(check_air(gen, ops_rate))
    rows.append(check_butterfly(gen, ops_rate))
    return rows


class PassRecorder:
    """Within its `with`, records the arguments of every K1 pass that
    ops/tiles launches (field_kernels.ntt_pass) and launches it."""

    def __enter__(self):
        from distaff_torch.ops import field_kernels as fk

        self.fk, self.real, self.calls = fk, fk.ntt_pass, []
        fk.ntt_pass = self.record
        return self

    def record(self, *args):
        self.calls.append(args)
        return self.real(*args)

    def __exit__(self, *exc):
        self.fk.ntt_pass = self.real

    def keys(self):
        return [pass_key(*args) for args in self.calls]


def pass_key(src, dst, tw, batch, cols, src_strides, dst_strides, n_in, lo=None, hi=None):
    """A K1 pass's shape: its geometry and which store factors it takes."""
    factors = "" if lo is None else " x lo" if hi is None else " x lo x hi"
    return (f"({batch}, {cols}, {2 * tw.shape[0]}) in {tuple(src_strides)} n_in {n_in} "
            f"out {tuple(dst_strides)}{factors}")


def main_path_transforms(gen):
    """The 2^16 proof's NTTs on random inputs of their shapes: step 1's
    interpolation (20, 2^16) and LDE (20, 2^16 -> 2^21), step 4's
    interpolation (3, 2^19) and step 5's constraint LDE (2^19 -> 2^21)."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import tiles
    from distaff_torch.tools.timing import random_elements

    n, ev, domain = 1 << MAIN_LOG2_TRACE, 1 << (MAIN_LOG2_TRACE + 3), 1 << (MAIN_LOG2_TRACE + 5)
    root = hostfield.get_root_of_unity
    regs, comb, poly = (random_elements(gen, s) for s in ((20, n), (3, ev), (ev,)))
    return [("step 1 interpolation", lambda: tiles.intt_batched(regs, root(n))),
            ("step 1 LDE", lambda: tiles.ntt_batched(regs, root(domain), n=domain)),
            ("step 4 interpolation", lambda: tiles.intt_batched(comb, root(ev))),
            ("step 5 constraint LDE", lambda: tiles.ntt(poly, root(domain), n=domain))]


def dif_work(m, valid):
    """(butterflies, multiplies) of a size-m transform whose first `valid`
    points are nonzero and the rest zero, at the least the data needs: a
    butterfly of two zeros is no work, one with twiddle 1 no multiply (a
    DIF transform; its stage of span h has twiddle 1 at i mod h = 0)."""
    import numpy as np

    nonzero = np.arange(m) < valid
    butterflies = multiplies = 0
    h = m // 2
    while h >= 1:
        pairs = nonzero.reshape(-1, 2, h)
        active = pairs[:, 0] | pairs[:, 1]
        butterflies += int(active.sum())
        multiplies += int(active[:, 1:].sum())
        nonzero = np.stack([active, active], 1).reshape(m)
        h //= 2
    return butterflies, multiplies


def check_passes(gen, ops_rate):
    """K1 at every pass the 2^16 proof launches, one row each: the proof's
    NTTs run on random inputs of their shapes with each pass recorded, then
    each pass is launched again into fresh outputs, held equal to its plain
    version on the same inputs and timed."""
    from distaff_torch.ops import field_kernels as fk

    rows = []
    for what, transform in main_path_transforms(gen):
        with PassRecorder() as rec:
            transform()
        for args in rec.calls:
            src, dst, tw, batch, cols, ss, ds, n_in, lo, hi = (args + (None, None))[:10]
            m = 2 * tw.shape[0]
            outs = [torch.zeros_like(dst) for _ in range(2)]
            pass_args = lambda out: (src, out, tw, batch, cols, ss, ds, n_in, lo, hi)
            in_row = (torch.arange(cols)[:, None] * ss[1] + torch.arange(m)[None, :] * ss[2])
            valid = (in_row < n_in).sum(1).tolist()
            reads = batch * sum(valid)
            points = batch * cols * m
            butterflies = multiplies = 0
            for v, count in Counter(valid).items():
                bf, mul = dif_work(m, v)
                butterflies += batch * count * bf
                multiplies += batch * count * mul
            if lo is not None:
                multiplies += points                 # the four-step twiddle or 1/n
            tables = m // 2 + sum(t.shape[0] for t in (lo, hi) if t is not None)
            row = check_kernel(
                "ntt_pass", f"{what}: {pass_key(*pass_args(dst))}",
                lambda: fk.ntt_pass(*pass_args(outs[0])),
                lambda: fk.ntt_pass_plain(*pass_args(outs[1])), 20, 1,
                (reads + points + tables) * 16,
                butterflies * (ADD_OPS + SUB_OPS) + multiplies * MUL_OPS, ops_rate,
                "distaff_torch/csrc/ntt_pass.cu", "distaff_tpu/ops/field_pallas.py:252")
            row["key"] = pass_key(*args)
            rows.append(row)
            del outs
        del rec
    return rows


def edge_pairs(ft):
    """Every pair of edge values as two (n, 4) limb tensors on the card: 0,
    1, M - 1, M - 2, 2^64 +- 1, limbs of all ones below M, and products
    2^127 y whose first fold lies less than 2^93 below a multiple of 2^128
    (the second fold carries into bit 128; tests/test_torch_field.py's
    interpreter of the PTX multiply takes the same values)."""
    m = ft.M
    values = [0, 1, 2, m - 1, m - 2, m - 3, 2**64 - 1, 2**64, 2**64 + 1, 2**32 - 1,
              2**96 - 1, 2**127 - 1, 2**127, 2**128 - 2**96 - 1, m // 2]
    r_inv = pow((45 << 40) - 1, -1, 1 << 128)
    for bits in range(1, 94, 4):
        y = 2 * ((-(1 << bits) + 1) * r_inv % (1 << 128))
        if y < m:
            values.append(y)
    xs = [v for v in values for _ in values]
    ys = [w for _ in values for w in values]
    return ft.from_ints(xs, "cuda"), ft.from_ints(ys, "cuda")


def check_air(gen, ops_rate):
    """K4 at (20, 2^19): on the stride slice of the 2^16 Fibonacci LDE (no
    bad steps), on a copy with one value altered (bad steps), and on random
    registers, which set every op flag and so reach every constraint arm.
    The first check gives K4's row of the JSON table."""
    from distaff_torch import assembly, native, ProgramInputs
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import air_kernels
    from distaff_torch.stark.constraints.device_eval import air_tables, transition_plain
    from distaff_torch.stark.constraints.evaluator import Evaluator
    from distaff_torch.stark.trace_table import TraceTable
    from distaff_torch.tools.timing import random_elements

    inputs = ProgramInputs.from_public([1, 0])
    regs, ctx, loop = native.execute_u64(fibonacci_program(assembly, MAIN_LOG2_TRACE), inputs)
    trace = TraceTable(regs, ctx, loop, 32)
    trace.extend("cuda")
    root = trace.build_merkle_tree("blake3").root()
    evaluator = Evaluator.from_trace(trace, root, inputs.get_public_inputs(),
                                     trace.get_last_state().user_stack[:1])
    lde = trace.lde_dev[:, ::4]                                  # D_ev = 2^19 rows
    tables = air_tables(evaluator, "cuda")
    r, n = lde.shape[0], lde.shape[1]
    muls, adds, subs = air_kernels.air_ops_per_row(tables.depths())
    print(f"K4 at {r} registers, depths {tables.depths()}: "
          f"{muls} multiplies, {adds} adds, {subs} subtractions a row", flush=True)
    table_bytes = sum(t.numel() * t.element_size() for t in (
        tables.dec_ark, tables.masks, tables.stk_ark, tables.mds, tables.cc))
    bound_bytes = (r + tables.xp.shape[0] + 1) * n * 16 + table_bytes
    bound_ops = n * (muls * MUL_OPS + adds * ADD_OPS + subs * SUB_OPS)
    source = ("distaff_torch/csrc/air_transition.cu",
              "distaff_tpu/stark/constraints/device_eval.py:121")

    def run(x, plain=False):
        f = transition_plain if plain else air_kernels.air_transition
        return lambda: f(x, tables)

    row = check_kernel("air_transition", f"({r}, {n}) Fibonacci LDE slice", run(lde),
                       run(lde, True), 20, 1, bound_bytes, bound_ops, ops_rate, *source)
    bad = [int(run(lde)()[1])]
    tampered = lde.clone()
    tampered[0, 8 * 1000] = ft.constant(12345, "cuda")       # the op counter at step 1000
    noise = random_elements(gen, (r, n))
    for what, x in (("slice with one value altered", tampered), ("random registers", noise)):
        (_, count), _ = check_equal("air_transition", f"({r}, {n}) {what}", run(x), run(x, True))
        print(f"kernel air_transition at ({r}, {n}) {what}: equal to plain", flush=True)
        bad.append(int(count))
    print(f"K4 bad steps: {bad[0]} on the Fibonacci slice, {bad[1]} with one value altered, "
          f"{bad[2]} on random registers", flush=True)
    if bad[0] != 0 or bad[1] == 0:
        raise AssertionError(f"K4 bad-step counts {bad[:2]}: expected 0 and > 0")
    return row


def check_butterfly(gen, ops_rate):
    """K5 at 2^19 pairs: the middle stage of a 2^20-point stagewise NTT."""
    from distaff_torch.ops import field_kernels as fk
    from distaff_torch.tools.timing import random_elements

    pairs = 1 << 19
    a, b, w = (random_elements(gen, (pairs,)) for _ in range(3))
    return check_kernel(
        "butterfly", f"{pairs} pairs", lambda: fk.butterfly_stage(a, b, w),
        lambda: fk.butterfly_stage_plain(a, b, w), 50, 3, pairs * 80,
        pairs * (ADD_OPS + SUB_OPS + MUL_OPS), ops_rate,
        "distaff_torch/csrc/butterfly.cu", "distaff_tpu/ops/field_pallas.py:171")


def phase_golden():
    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.stark import serde

    program = assembly.compile("begin push.3 push.5 add end")
    inputs = ProgramInputs.none()
    options = ProofOptions(extension_factor=16, num_queries=10, grinding_factor=2)
    outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cuda")
    blob = serde.serialize(proof)
    digest = hashlib.sha256(blob).hexdigest()
    if len(blob) != GOLDEN_LEN or digest != GOLDEN_SHA256:
        raise AssertionError(f"golden proof differs: {len(blob)} bytes, sha256 {digest}")
    if not distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof):
        raise AssertionError("golden proof does not verify")
    print(f"golden proof on cuda: {len(blob)} bytes, sha256 {digest}, verified", flush=True)


class _StepLog(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def fibonacci_program(assembly, log2_trace):
    # bench.py's sizing: 3N/64 unrolled iterations pad to exactly 2^k steps
    n_iter = (1 << log2_trace) * 3 // 64
    return assembly.compile(f"begin repeat.{n_iter} swap dup.2 drop add end end")


def timed_execute(program, inputs, options, stepped):
    """One 2^16 proof on cuda and its wall time.  With `stepped`, DEBUG
    step logging is on, which synchronizes the card at each step's end, and
    the step lines come back too."""
    import distaff_torch

    steps = _StepLog()
    package_log = logging.getLogger("distaff_torch")
    if stepped:
        package_log.addHandler(steps)
        package_log.setLevel(logging.DEBUG)
    try:
        t0 = time.perf_counter()
        outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cuda")
        torch.cuda.synchronize()
        return outputs, proof, time.perf_counter() - t0, steps.lines
    finally:
        package_log.removeHandler(steps)
        package_log.setLevel(logging.NOTSET)


def phase_main(pass_keys):
    """The 2^16 proof three times: as a user runs it (no step logging, so
    no synchronize between steps), with the launch counts, K1's passes and
    peak memory read around it; with DEBUG step logging for the per-step
    times; and unstepped again, so that the cost of the step synchronizes
    shows beside the drift from one proof to the next.  K1's passes must be
    exactly `pass_keys`, those phase 2 held and timed, and none a two-point
    transform.  Returns the launches and K1's passes."""
    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.ops import cuda_lib

    program = fibonacci_program(assembly, MAIN_LOG2_TRACE)
    inputs = ProgramInputs.from_public([1, 0])
    options = ProofOptions()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    with PassRecorder() as rec:
        outputs, proof, prove_s, _ = timed_execute(program, inputs, options, stepped=False)
    launches = dict(cuda_lib.LAUNCHES)
    proof_keys = rec.keys()
    peak = torch.cuda.max_memory_allocated()

    if proof.trace_length() != 1 << MAIN_LOG2_TRACE:
        raise AssertionError(f"trace length {proof.trace_length()}")
    t1 = time.perf_counter()
    if not distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof):
        raise AssertionError("2^16 proof does not verify")
    verify_s = time.perf_counter() - t1
    print(f"2^{MAIN_LOG2_TRACE} proof: execute {prove_s:.3f} s, verify {verify_s:.3f} s, "
          f"output {outputs}, peak device memory {peak} bytes", flush=True)
    print(f"2^{MAIN_LOG2_TRACE} launches: {json.dumps(launches)}", flush=True)
    idle = [k for k in MAIN_PATH if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    for name, want in (("air_transition", 1), ("inv_batch", 1), ("field_ew.exp_const", 0),
                       ("ntt_pass", len(pass_keys))):
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times, not {want}")
    for key in proof_keys:
        print(f"2^{MAIN_LOG2_TRACE} K1 pass {key}", flush=True)
    if Counter(proof_keys) != Counter(pass_keys):
        raise AssertionError("the proof's K1 passes are not those phase 2 checked")
    small = [args for args in rec.calls if args[2].shape[0] < 2]
    if small:
        raise AssertionError(f"{len(small)} two-point K1 passes in the proof")
    print(f"2^{MAIN_LOG2_TRACE} K1 launched {launches['ntt_pass']} times, no two-point "
          f"transform; field_ew.mul launched {launches['field_ew.mul']} times", flush=True)

    stepped_outputs, _, stepped_s, lines = timed_execute(program, inputs, options, stepped=True)
    again_outputs, _, again_s, _ = timed_execute(program, inputs, options, stepped=False)
    if stepped_outputs != outputs or again_outputs != outputs:
        raise AssertionError("a repeated 2^16 proof's outputs differ")
    for line in lines:
        print(f"2^{MAIN_LOG2_TRACE} {line}", flush=True)
    print(f"2^{MAIN_LOG2_TRACE} execute: stepped (synchronized at each step's end) "
          f"{stepped_s:.3f} s, then unstepped again {again_s:.3f} s", flush=True)
    return launches, proof_keys


def phase_bench():
    """The kernel bench at BENCH_SIZES; it raises if ntt_stagewise and
    tiles.ntt differ at any size.  Returns the launches of its run."""
    from distaff_torch.ops import cuda_lib
    from distaff_torch.tools import kernel_bench

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    kernel_bench.bench(BENCH_SIZES)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"bench launches: {json.dumps(launches)}", flush=True)
    print(f"bench: ntt_stagewise equal to tiles.ntt at 2^{', 2^'.join(map(str, BENCH_SIZES))}",
          flush=True)
    idle = [k for k in BENCH_PATH if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the bench path: {idle}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from distaff_torch import native
    from distaff_torch.ops import air_kernels, cuda_lib
    from distaff_torch.tools.timing import card_line

    # phase 1: build every library at once (each kernel source in its own
    # nvcc, K4 once per triple), each timed from the start of the phase
    t0 = time.perf_counter()

    def timed(fn, *args):
        fn(*args)
        return time.perf_counter() - t0

    builds = {"kernels K1-K3, K5, K6": (cuda_lib.lib,), "native runtime": (native.lib,),
              "K4 host evaluator": (air_kernels.host_lib,)}
    builds.update({f"K4 at {d}": (air_kernels.air_lib, d) for d in AIR_TRIPLES})
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        done = {name: pool.submit(timed, *job) for name, job in builds.items()}
        seconds = {name: f.result() for name, f in done.items()}
    card = card_line()
    print(f"build: every library in {time.perf_counter() - t0:.1f} s; "
          + ", ".join(f"{name} done at {s:.1f} s" for name, s in seconds.items()), flush=True)
    for d in AIR_TRIPLES:
        for line in air_kernels.ptxas_report(d):
            print(f"K4 {d} {line.strip()}", flush=True)
    for line in cuda_lib.ptxas_report("inv_batch"):
        print(f"K6 {line.strip()}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    for line in cuda_lib.ptxas_report("ntt_pass"):
        print(f"K1 {line.strip()}", flush=True)
    rows = phase_kernels(int32_ops_per_s())
    phase_golden()
    launches, proof_keys = phase_main([row["key"] for row in rows if "key" in row])
    bench_launches = phase_bench()
    for row in rows:
        name = row["name"]
        if "key" in row:
            row["launches"] = proof_keys.count(row.pop("key"))
        else:
            row["launches"] = launches[name] if name in MAIN_PATH else bench_launches[name]

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
