"""STARK prover: the 9-step pipeline (reference src/stark/prover.rs), with
the domain-sized work on the device:

1. trace LDE           - batched NTTs per register (kernel K1)
2. trace Merkle tree   - leaf rows and every level hashed on device (K3)
3. constraint eval     - boundary columns as weighted register sums on
                         device; transition constraints in one launch of
                         the AIR kernel over the LDE slice (K4)
4. constraint poly     - device iNTT + suffix-sum synthetic divisions
5. constraint commit   - device NTT over the LDE domain + device tree
6. DEEP composition    - pointwise over the evaluation domain with one
                         batch inversion (K6, Montgomery's trick)
7. FRI                 - device radix-4 folds + device layer trees
8. PoW + queries       - host grinding and sampling
9. proof assembly      - device gathers, one batched copy to the host

Each step's wall time is logged at DEBUG level ("step <i> <name>: <ms> ms"),
and the parts of steps 1 and 3 as "step <i> part <name>: <ms> ms"; while
that level is enabled every step and part ends with a device synchronize,
so the times are the device's and not the enqueue's.
"""

import logging
import time

import numpy as np
import torch

from ..math import field
from ..math import field_torch as ft
from ..config import MAX_CONSTRAINT_DEGREE
from ..crypto import hashes
from ..interop import limbs_to_numpy
from .constraints.evaluator import Evaluator
from . import utils, fri
from .proof import StarkProof, DeepValues

log = logging.getLogger(__name__)
M = field.M


class _StepClock:
    """Logs each prover step's wall time; synchronizes the device at each
    step's end only while DEBUG logging is on."""

    def __init__(self, device):
        self.device = device
        self.enabled = log.isEnabledFor(logging.DEBUG)
        self.now = self.part_now = time.perf_counter()

    def _synchronized_now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def part(self, index, name):
        """Logs the time since the step's start or its last part."""
        if not self.enabled:
            return
        now = self._synchronized_now()
        log.debug("step %d part %s: %.3f ms", index, name, (now - self.part_now) * 1000)
        self.part_now = now

    def done(self, index, name):
        if not self.enabled:
            return
        now = self._synchronized_now()
        log.debug("step %d %s: %.3f ms", index, name, (now - self.now) * 1000)
        self.now = self.part_now = now


def prove(trace, inputs, outputs, options, device="cuda"):
    """Prove the execution recorded in `trace` on `device` ("cuda" unless the
    caller asks for "cpu")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prove(device='cuda'): no CUDA device is available")
    if options.hash_fn != "blake3":
        raise ValueError(f"the prover commits with blake3 only, not {options.hash_fn}")
    clock = _StepClock(device)

    # 1 ----- extend execution trace -------------------------------------------------------------
    trace.extend(device, part=lambda name: clock.part(1, name))
    domain_size = trace.domain_size()
    lde_root = field.get_root_of_unity(domain_size)
    clock.done(1, "extend trace")

    # 2 ----- commit to the extended trace -------------------------------------------------------
    trace_tree = trace.build_merkle_tree(options.hash_fn)
    clock.done(2, "trace tree")

    # 3 ----- evaluate constraints over the evaluation domain ------------------------------------
    evaluator = Evaluator.from_trace(trace, trace_tree.root(), inputs, outputs)
    clock.part(3, "evaluator (host)")
    i_evals, f_evals, t_evals = _evaluate_constraints_columnar(evaluator, trace, clock)
    clock.done(3, "evaluate constraints")

    # 4 ----- combine into the constraint polynomial ---------------------------------------------
    constraint_poly = _combine_constraint_polys(
        evaluator, i_evals, f_evals, t_evals, trace.unextended_length())
    del i_evals, f_evals, t_evals
    clock.done(4, "constraint polynomial")

    # 5 ----- commit to constraint polynomial evaluations ----------------------------------------
    from ..ops import tiles

    constraint_lde = tiles.ntt(constraint_poly, lde_root, n=domain_size)
    constraint_tree = _build_constraint_tree(constraint_lde)
    clock.done(5, "constraint tree")

    # 6 ----- DEEP composition -------------------------------------------------------------------
    seed = constraint_tree.root()
    z = utils.draw_z(seed)
    cc = utils.CompositionCoefficients(seed)
    composed, deep_values = _build_composition_evaluations(
        trace, constraint_poly, constraint_lde, z, cc)
    clock.done(6, "DEEP composition")

    # 7 ----- FRI --------------------------------------------------------------------------------
    fri_trees, fri_values = fri.reduce(composed, lde_root, options)
    clock.done(7, "FRI layers")

    # 8 ----- proof of work + query positions ----------------------------------------------------
    fri_roots = b"".join(tree.root() for tree in fri_trees)
    hash_fn = hashes.HASH_FUNCTIONS[options.hash_fn]
    seed = hash_fn(fri_roots)
    seed, pow_nonce = utils.find_pow_nonce(seed, options)
    positions = utils.compute_query_positions(seed, domain_size, options)
    clock.done(8, "proof of work and queries")

    # 9 ----- proof object -----------------------------------------------------------------------
    from ..ops.hostsync import TransferBatch

    batch = TransferBatch()  # one device->host copy for all of step 9
    constraint_positions = utils.map_trace_to_constraint_positions(positions)
    trace_opening = trace_tree.prove_batch_async(positions, batch)
    constraint_opening = constraint_tree.prove_batch_async(constraint_positions, batch)
    trace_evaluations = trace.get_register_values_at_async(positions, batch)
    fri_proof = fri.build_proof(fri_trees, fri_values, positions, batch)

    proof = StarkProof(
        trace_tree.root(),
        trace_opening.result(),
        trace_evaluations(),
        constraint_tree.root(),
        constraint_opening.result(),
        deep_values,
        fri_proof,
        pow_nonce,
        trace.get_last_state().op_counter,
        trace.ctx_depth,
        trace.loop_depth,
        trace.stack_depth,
        options,
    )
    clock.done(9, "proof assembly")
    return proof


# ------------------------------------------------------------------------------------------------
# step 3: columnar constraint evaluation
# ------------------------------------------------------------------------------------------------

def _evaluate_constraints_columnar(evaluator, trace, clock):
    """Boundary and transition columns over D_ev, all on the device of the
    LDE: the stride slice is read in place and never leaves it."""
    from .constraints.device_eval import evaluate_transition_device

    stride = trace.extension_factor // MAX_CONSTRAINT_DEGREE
    i_evals, f_evals = _evaluate_boundaries_device(evaluator, trace, stride)
    clock.part(3, "boundary columns")
    t_evals, _ = evaluate_transition_device(evaluator, trace)
    clock.part(3, "transition (K4 tables and launch)")
    return i_evals, f_evals, t_evals


def _evaluate_boundaries_device(evaluator, trace, stride):
    """Boundary constraint columns over D_ev computed on the device.

    The combined first/last-step boundary columns are weighted register sums
    plus transcript constants (evaluator.boundary_weight_vectors), and one
    multiply by the x^b_degree_adj power series - bit-identical to the
    reference's per-step loop (evaluator.rs:181-326)."""
    from ..ops import tiles

    lde = trace.lde_dev[:, ::stride]                         # (R, n_ev, 4)
    device = lde.device
    n_ev = evaluator.domain_size
    r_ev = field.get_root_of_unity(n_ev)
    xp = tiles.power_series(field.exp(r_ev, evaluator.b_degree_adj), n_ev, device)

    i_parts, f_parts = evaluator.boundary_weight_vectors(lde.shape[0])

    def combine(parts):
        w1, w2, c1, c2 = parts
        s1 = tiles.weighted_register_sum(lde, ft.from_ints(np.array(w1, dtype=object), device))
        s2 = tiles.weighted_register_sum(lde, ft.from_ints(np.array(w2, dtype=object), device))
        base = ft.add(s1, ft.constant(c1, device))
        adj = ft.add(s2, ft.constant(c2, device))
        return ft.add(base, ft.mul(xp, adj))

    return combine(i_parts), combine(f_parts)


# ------------------------------------------------------------------------------------------------
# step 4: combine boundary/transition polynomials with their divisors
# ------------------------------------------------------------------------------------------------

def _syn_div_dev(poly, b):
    """Division of a polynomial by (x - b), b a root-of-unity power:
    T_i = b^{-i} * sum_{j >= i} a_j b^j and result[i] = T_{i+1}."""
    from ..ops import tiles

    n = poly.shape[0]
    zero = ft.zeros((1,), poly.device)
    if b == 1:
        s = tiles.suffix_sums(poly)
        return torch.cat([s[1:], zero])
    w = ft.mul(poly, tiles.power_series(b, n, poly.device))
    s_next = torch.cat([tiles.suffix_sums(w)[1:], zero])     # s_{i+1}
    b_inv = field.inv(b)
    pbinv = tiles.scale(tiles.power_series(b_inv, n, poly.device), b_inv)  # b^{-(i+1)}
    return ft.mul(s_next, pbinv)


def _syn_div_expanded_dev(poly, degree, exception):
    """Division by (x^degree - 1) / (x - exception): the quotient by
    (x^degree - 1) is a stride-`degree` suffix sum; the (x - exception)
    factor is restored with one shifted multiply-add."""
    n = poly.shape[0]
    m = n // degree
    r = ft.cumsum(poly.reshape(m, degree, 4).flip(0), axis=0).flip(0).reshape(n, 4)
    zero = ft.zeros((1,), poly.device)
    r_ext = torch.cat([r, zero])                             # length n+1
    r_shift = torch.cat([zero, r])
    prod = ft.add(ft.mul(r_ext, ft.constant(field.neg(exception), poly.device)), r_shift)
    count = n - degree + 1
    out = ft.zeros((n,), poly.device)
    out[:count] = prod[degree : degree + count]
    return out


def _combine_constraint_polys(evaluator, i_evals, f_evals, t_evals, trace_length):
    """iNTT the three combined columns in one batch, divide each by its
    zero-polynomial, and sum.  Returns the constraint polynomial as
    (n_ev, 4) limbs."""
    from ..ops import tiles

    ev_root = field.get_root_of_unity(evaluator.domain_size)
    polys3 = tiles.intt_batched(torch.stack([i_evals, f_evals, t_evals]), ev_root)
    x_last = evaluator.get_x_at_last_step()
    i_div = _syn_div_dev(polys3[0], 1)
    f_div = _syn_div_dev(polys3[1], x_last)
    t_div = _syn_div_expanded_dev(polys3[2], trace_length, x_last)
    return ft.add(ft.add(i_div, f_div), t_div)


# ------------------------------------------------------------------------------------------------
# step 5: constraint commitment
# ------------------------------------------------------------------------------------------------

def _build_constraint_tree(constraint_lde):
    """Two evaluations (32 raw bytes) per leaf - unlike the trace tree, the
    leaves are the evaluation bytes themselves (reference prover.rs:84-86)."""
    from ..crypto.merkle_dev import DeviceMerkleTree

    d = constraint_lde.shape[0]
    return DeviceMerkleTree(constraint_lde.reshape(d // 2, 8))


# ------------------------------------------------------------------------------------------------
# step 6: DEEP composition in the evaluation domain
# ------------------------------------------------------------------------------------------------

def _poly_eval_rows_multi(polys, x_ints):
    """T_r(x_p) for every register row r of (R, n, 4) coefficients and every
    point p, as (P, R) host ints."""
    from ..ops import tiles

    device = polys.device
    length = polys.shape[1]
    ps = torch.stack([tiles.power_series(x, length, device) for x in x_ints])  # (P, n, 4)
    totals = ft.sum_reduce(ft.mul(polys[None], ps[:, None]), axis=2)          # (P, R, 4)
    return [[int(v) for v in row] for row in ft.to_ints(limbs_to_numpy(totals))]


def polynom_eval_dev(poly_dev, x_int):
    """Evaluate an (n, 4) device coefficient vector at a host int."""
    return _poly_eval_rows_multi(poly_dev[None], [x_int])[0][0]


def _compose_tiles_batched(a1, a2, c_t, xs, x_incr, z, nz, s1, s2, c_at_z, k1, k2, kc):
    """The DEEP composition over the domain, pointwise.  (x-z) and (x-zg)
    are inverted through one batch inversion (K6) of their product:
    1/(x-z) = (x-zg) * w and 1/(x-zg) = (x-z) * w with
    w = 1/((x-z)(x-zg))."""
    xz = ft.sub(xs, z)
    xnz = ft.sub(xs, nz)
    w = ft.inv_batch(ft.mul(xz, xnz))
    u = ft.mul(w, xnz)
    v = ft.mul(w, xz)

    t1 = ft.mul(ft.sub(a1, s1), u)
    t2 = ft.mul(ft.sub(a2, s2), v)
    base = ft.add(t1, t2)

    part1 = ft.mul(base, k1)
    part2 = ft.mul(ft.mul(base, x_incr), k2)
    composed = ft.add(part1, part2)

    c_part = ft.mul(ft.mul(ft.sub(c_t, c_at_z), u), kc)
    return ft.add(composed, c_part)


def _build_composition_evaluations(trace, constraint_poly, constraint_lde, z, cc):
    """Step 6, computed pointwise over the evaluation domain (reference
    trace_table.rs:206-261 / constraint_poly.rs:39-52 build the same values
    by coefficient-space synthetic division)."""
    from ..ops import tiles

    device = trace.lde_dev.device
    n = trace.domain_size()
    trace_length = trace.unextended_length()
    g = field.get_root_of_unity(trace_length)
    next_z = field.mul(z, g)

    # weighted register sums A1(x) = sum_i cc1_i T_i(x), A2 likewise
    r_count = trace.register_count()
    w1 = ft.from_ints(np.array(cc.trace1[:r_count], dtype=object), device)
    w2 = ft.from_ints(np.array(cc.trace2[:r_count], dtype=object), device)
    a1 = tiles.weighted_register_sum(trace.lde_dev, w1)
    a2 = tiles.weighted_register_sum(trace.lde_dev, w2)

    # T_i(z), T_i(zg) and the scalar DEEP terms (the proof's DeepValues)
    trace_state1, trace_state2 = _poly_eval_rows_multi(trace.polys_dev, [z, next_z])
    s1 = 0
    s2 = 0
    for i in range(r_count):
        s1 = (s1 + trace_state1[i] * cc.trace1[i]) % M
        s2 = (s2 + trace_state2[i] * cc.trace2[i]) % M
    c_at_z = polynom_eval_dev(constraint_poly, z)

    root = field.get_root_of_unity(n)
    incr = utils.get_incremental_trace_degree(trace_length)
    xs = tiles.power_series(root, n, device)
    x_incr = tiles.power_series(field.exp(root, incr), n, device)

    def const(v):
        return ft.constant(v, device)

    composed = _compose_tiles_batched(
        a1, a2, constraint_lde, xs, x_incr, const(z), const(next_z), const(s1), const(s2),
        const(c_at_z), const(cc.t1_degree), const(cc.t2_degree), const(cc.constraints))
    return composed, DeepValues(trace_state1, trace_state2)
