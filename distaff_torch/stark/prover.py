"""STARK prover: the 9-step pipeline (reference src/stark/prover.rs), with
the domain-sized work on the device:

1. trace LDE           - batched NTTs per register (kernel K1)
2. trace Merkle tree   - leaf rows hashed on device (K3), the tree in one
                         launch (K13, as every blake3 tree);
                         with another hash than blake3 the trees of
                         steps 2, 5 and 7 are hashed on the host
3. constraint eval     - boundary columns in one launch (K10) and
                         transition constraints in one launch of the AIR
                         kernel (K4), both over the LDE's stride slice
4. constraint poly     - device iNTT + suffix-sum synthetic divisions
5. constraint commit   - device NTT over the LDE domain + device tree
6. DEEP composition    - point evaluations (K8) and the composition over
                         the LDE domain in one launch (K7)
7. FRI                 - device radix-4 folds, one launch a layer (K9),
                         + device layer trees
8. PoW + queries       - host grinding and sampling
9. proof assembly      - device gathers, one batched copy to the host

Before step 1, every power table that the kernels of these steps read is
built in one launch of kernel K12 (proof_table_keys, ops/tiles.
build_tables); a process's later proofs of the same geometry find them
cached.

Where the LDE does not fit (stark/trace_table.py's streaming LDE), step 1
only interpolates, step 2 extends the registers four at a time, each group
absorbed into the leaf digests (K14) and its points of D_ev kept for step
3, step 6 extends two weighted sums of the coefficients (K15, then K1) in
place of reading the LDE, and step 9 evaluates the query rows from the
polynomials (K8).

Each step's wall time is logged at DEBUG level ("step <i> <name>: <ms> ms"),
and the parts of steps 1, 3, 6 and 7 as "step <i> part <name>: <ms> ms"
(step 7's each summed over the FRI layers); while
that level is enabled every step and part ends with a device synchronize,
so the times are the device's and not the enqueue's.

With DISTAFF_MESH_DEVICES set (parallel/mesh.py), the stages that the
JAX package shards run split over a mesh of slots, where it places them
(distaff_tpu/stark/prover.py, trace_table.py, fri.py): the LDE by
registers, steps 3, 6 and 7 and the trees by rows, and the transforms of
steps 4 and 5 (and of the streamed LDE and of step 6's sums) as four-step
transforms over the slots; K11 runs on the home slot after step 4's
gather, K8 and the host's steps where they always do.  The proof's bytes
are the single-device proof's.  In a multi-process job (dist_setup.py)
every rank runs this pipeline on the same host values over a mesh of the
ranks, launching on its own slot, and returns the same proof.

With DISTAFF_DEBUG set to anything but "0", the prover runs the JAX
package's three debug checks (the reference's debug_assert!s) and raises
AssertionError where one fails: the transition constraints vanish at every
trace step but the last (K4's count of bad steps, read back), each
transition constraint's degree is at most its declared degree, and the
constraint polynomial's degree is exactly |D_ev| - |D_trace|.  Unset, no
check runs and nothing more is read back.
"""

import logging
import os
import time

import numpy as np
import torch

from ..math import field
from ..math import field_torch as ft
from ..config import MAX_CONSTRAINT_DEGREE
from ..crypto import hashes
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
        self.laps = {}

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

    def lap(self, name):
        """Adds the time since the step's start or its last part to the part
        `name`, whose sum over the step's laps `done` logs."""
        if not self.enabled:
            return
        now = self._synchronized_now()
        self.laps[name] = self.laps.get(name, 0.0) + now - self.part_now
        self.part_now = now

    def done(self, index, name, laps=()):
        """Logs the step's time, after the sum of each part named in `laps`
        (0 for a part that no lap reached)."""
        if not self.enabled:
            return
        for part in laps:
            log.debug("step %d part %s: %.3f ms", index, part, self.laps.get(part, 0.0) * 1000)
        self.laps = {}
        now = self._synchronized_now()
        log.debug("step %d %s: %.3f ms", index, name, (now - self.now) * 1000)
        self.now = self.part_now = now


def prove(trace, inputs, outputs, options, device="cuda"):
    """Prove the execution recorded in `trace` on `device` ("cuda" unless the
    caller asks for "cpu")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prove(device='cuda'): no CUDA device is available")
    from ..ops import tiles
    from ..parallel.mesh import configured_mesh

    mesh = configured_mesh(device)
    if mesh is not None:
        device = mesh.home
    clock = _StepClock(device)
    tiles.build_tables(proof_table_keys(trace.unextended_length(), trace.domain_size(), device,
                                        mesh))

    # 1 ----- extend execution trace -------------------------------------------------------------
    trace.extend(device, part=lambda name: clock.part(1, name), mesh=mesh)
    domain_size = trace.domain_size()
    lde_root = field.get_root_of_unity(domain_size)
    clock.done(1, "extend trace")

    # 2 ----- commit to the extended trace -------------------------------------------------------
    trace_tree = trace.build_merkle_tree(options.hash_fn)
    clock.done(2, "trace tree")

    # 3 ----- evaluate constraints over the evaluation domain ------------------------------------
    evaluator = Evaluator.from_trace(trace, trace_tree.root(), inputs, outputs)
    clock.part(3, "evaluator (host)")
    debug = os.environ.get("DISTAFF_DEBUG", "0") != "0"
    i_evals, f_evals, t_evals = _evaluate_constraints_columnar(evaluator, trace, clock, debug)
    if debug:
        _validate_transition_degrees(evaluator, trace)
    clock.done(3, "evaluate constraints")

    # 4 ----- combine into the constraint polynomial ---------------------------------------------
    constraint_poly = _combine_constraint_polys(
        evaluator, i_evals, f_evals, t_evals, trace.unextended_length(), trace.mesh)
    del i_evals, f_evals, t_evals
    if trace.streaming:
        # the slice over D_ev has no reader past step 4
        trace.lde_stride_dev = None
    if debug:
        _validate_constraint_poly_degree(constraint_poly, trace.unextended_length())
    clock.done(4, "constraint polynomial")

    # 5 ----- commit to constraint polynomial evaluations ----------------------------------------
    constraint_lde = _extend_column_dev(constraint_poly, lde_root, domain_size, trace.mesh,
                                        trace.rows_mesh(), "constraint_lde")
    constraint_tree = _build_constraint_tree(constraint_lde, options.hash_fn)
    clock.done(5, "constraint tree")

    # 6 ----- DEEP composition -------------------------------------------------------------------
    seed = constraint_tree.root()
    z = utils.draw_z(seed)
    cc = utils.CompositionCoefficients(seed)
    clock.part(6, "coefficients (host)")
    composed, deep_values = _build_composition_evaluations(
        trace, constraint_poly, constraint_lde, z, cc, lambda name: clock.part(6, name))
    clock.done(6, "DEEP composition")

    # 7 ----- FRI --------------------------------------------------------------------------------
    fri_trees, fri_values = fri.reduce(composed, lde_root, options, clock.lap)
    clock.done(7, "FRI layers", fri.PARTS)

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


def proof_table_keys(trace_length, domain_size, device, mesh=None):
    """The keys of every power table that a proof's kernels read, from its
    geometry alone (the trace, LDE and D_ev domains and their roots), so
    that one K12 launch builds them all before step 1: step 1's and step
    5's transforms (K1), K10's and K4's (step 3), step 4's inverse
    transform and K11's, K7's (step 6) and K9's (step 7).  The streamed
    path's transforms (the four-register groups of step 2, step 6's two
    sums) go to the LDE domain at its root, as step 1's does: its keys are
    the materialized path's.  On a mesh: those on each distinct device of
    the mesh (one K12 launch a device), and the sharded transforms' (steps
    4 and 5, parallel/ntt_sharded.py)."""
    if mesh is not None:
        from ..parallel import ntt_sharded as ns

        n_ev = trace_length * MAX_CONSTRAINT_DEGREE
        keys = [k for d in mesh.devices() for k in proof_table_keys(trace_length, domain_size, d)]
        for n, keys_of in ((domain_size, ns.ntt_keys), (n_ev, ns.intt_keys)):
            if ns.fits(n, mesh):
                keys += keys_of(n, field.get_root_of_unity(n), mesh)
        return keys
    from ..ops import boundary_kernels, deep_kernels, fri_torch, syndiv_kernels, tiles
    from .constraints import device_eval
    from .constraints.evaluator import get_boundary_constraint_adjustment_degree

    n_ev = trace_length * MAX_CONSTRAINT_DEGREE
    root_n = field.get_root_of_unity(trace_length)
    root = field.get_root_of_unity(domain_size)
    root_ev = field.get_root_of_unity(n_ev)
    xb_root = field.exp(root_ev, get_boundary_constraint_adjustment_degree(trace_length))
    return (tiles.intt_keys(trace_length, root_n, device)
            + tiles.ntt_keys(domain_size, root, device)
            + boundary_kernels.boundary_table_keys(n_ev, xb_root, device)
            + device_eval.air_table_keys(n_ev, device)
            + tiles.intt_keys(n_ev, root_ev, device)
            + syndiv_kernels.syn_div_table_keys(
                n_ev, field.exp(root_n, trace_length - 1), device)
            + deep_kernels.compose_table_keys(
                domain_size, root, utils.get_incremental_trace_degree(trace_length), device)
            + fri_torch.fold_table_keys(domain_size, 1, root, device))


# ------------------------------------------------------------------------------------------------
# step 3: columnar constraint evaluation
# ------------------------------------------------------------------------------------------------

def _evaluate_constraints_columnar(evaluator, trace, clock, debug=False):
    """Boundary and transition columns over D_ev, all on the device of the
    LDE: the stride slice is read in place and never leaves it.  With
    `debug`, K4's count of trace steps whose transition constraints do not
    vanish is read back and must be 0 (distaff_tpu/stark/constraints/
    device_eval.py:319-324)."""
    from .constraints.device_eval import evaluate_transition_device

    mesh = trace.rows_mesh()
    if mesh is not None:
        # each slot's rows of D_ev (parallel/mesh_stages.py)
        from ..parallel import mesh_stages

        i_evals, f_evals = mesh_stages.boundaries_sharded(evaluator, trace, mesh)
        clock.part(3, "boundary columns")
        t_evals, bad = mesh_stages.transition_sharded(evaluator, trace, mesh)
    else:
        i_evals, f_evals = _evaluate_boundaries_device(evaluator, trace)
        clock.part(3, "boundary columns")
        t_evals, bad = evaluate_transition_device(evaluator, trace)
    if debug:
        total = int((bad if mesh is None else bad.gather()).sum())
        assert total == 0, f"transition constraints not satisfied at {total} trace steps"
    clock.part(3, "transition (K4 tables and launch)")
    return i_evals, f_evals, t_evals


def _validate_transition_degrees(evaluator, trace):
    """Debug-mode per-constraint degree validation (reference
    src/stark/constraints/constraint_table.rs:90-112, evaluator.rs:360-380;
    distaff_tpu/stark/prover.py:_validate_transition_degrees): every
    transition constraint evaluated alone over D_ev on the host, each column
    interpolated, and its degree must not exceed the declared degree x
    (trace_length - 1)."""
    from ..math import polynom
    from .trace_state import TraceState

    columns = list(ft.to_ints(trace.ev_slice()))
    depths = (trace.ctx_depth, trace.loop_depth, trace.stack_depth)
    current = TraceState.from_vec(*depths, columns)
    next_state = TraceState.from_vec(
        *depths, [np.roll(c, -MAX_CONSTRAINT_DEGREE) for c in columns])

    evaluations = evaluator.evaluate_transition_individual(current, next_state)
    declared = evaluator.transition_degrees()
    trace_degree = evaluator.trace_length - 1
    n_ev = evaluator.domain_size
    actual = []
    for col in evaluations:
        if isinstance(col, int):
            col = np.full(n_ev, col, dtype=object)
        actual.append(polynom.infer_degree([int(v) for v in col]))
    bad = [(i, declared[i] * trace_degree, actual[i])
           for i in range(len(declared)) if actual[i] > declared[i] * trace_degree]
    assert not bad, (
        "constraint degrees didn't match (constraint, expected_max, actual): "
        f"{bad[:5]}")


def _evaluate_boundaries_device(evaluator, trace):
    """Boundary constraint columns over D_ev computed on the device.

    The combined first/last-step boundary columns are weighted register sums
    plus transcript constants (evaluator.boundary_weight_vectors), and one
    multiply by x^b_degree_adj - bit-identical to the reference's per-step
    loop (evaluator.rs:181-326).  One launch of kernel K10 over the trace's
    slice over D_ev, read in place."""
    from ..ops import boundary_kernels

    lde = trace.ev_slice()                                   # (R, n_ev, 4)
    r_ev = field.get_root_of_unity(evaluator.domain_size)
    i_parts, f_parts = evaluator.boundary_weight_vectors(lde.shape[0])
    return boundary_kernels.boundary_columns(
        lde, i_parts, f_parts, field.exp(r_ev, evaluator.b_degree_adj))


# ------------------------------------------------------------------------------------------------
# step 4: combine boundary/transition polynomials with their divisors
# ------------------------------------------------------------------------------------------------

def _combine_constraint_polys(evaluator, i_evals, f_evals, t_evals, trace_length, mesh=None):
    """iNTT the three combined columns in one batch (K1), then divide each
    by its zero-polynomial and sum, in one call of kernel K11.  Returns the
    constraint polynomial as (n_ev, 4) limbs.  Columns split over a mesh
    take the sharded transform (parallel/ntt_sharded.py), gathered to the
    home slot for K11 (one chained scan); where it does not split, they
    are gathered first."""
    from ..ops import syndiv_kernels, tiles
    from ..parallel.mesh import Sharded

    n_ev = evaluator.domain_size
    ev_root = field.get_root_of_unity(n_ev)
    columns = (i_evals, f_evals, t_evals)
    ntt_mesh = _mesh_for_transform(n_ev, mesh)
    if ntt_mesh is not None:
        from ..parallel import mesh_stages, ntt_sharded as ns

        split = [mesh_stages.rows_of(c, ntt_mesh) for c in columns]
        with ntt_mesh.stage():
            stacked = ntt_mesh.each(lambda slot, *parts: torch.stack(parts),
                                    *(c.parts for c in split))
        transformed = ns.transform(Sharded(ntt_mesh, stacked, 1, "rows"), ntt_mesh,
                                   pow(ev_root, n_ev - 1, M), n_ev, field.inv(n_ev))
        mesh_stages._record("constraint_intt", transformed.axis, ntt_mesh)
        polys3 = ns.gather(transformed, n_ev)
    else:
        columns = [c.gather() if isinstance(c, Sharded) else c for c in columns]
        polys3 = tiles.intt_batched(torch.stack(columns), ev_root)
    return syndiv_kernels.syn_div(polys3, trace_length, evaluator.get_x_at_last_step())


def _mesh_for_transform(n, mesh):
    """The mesh, if a transform of n points splits over it (parallel/
    ntt_sharded.fits); else None."""
    from ..parallel import ntt_sharded as ns

    return mesh if mesh is not None and ns.fits(n, mesh) else None


def _extend_column_dev(values, root_int, n, mesh, rows_mesh, stage):
    """The transform of values ((n_in, 4) coefficients on the home device,
    zero extended) to n points: on a mesh the sharded four-step
    (parallel/ntt_sharded.py, recorded as `stage`), laid out by rows where
    the rows are split (rows_mesh), else gathered; K1 on the home device
    otherwise (scattered by rows where they are split)."""
    from ..ops import tiles
    from ..parallel.mesh import Sharded

    ntt_mesh = _mesh_for_transform(n, mesh)
    if ntt_mesh is not None:
        from ..parallel import mesh_stages, ntt_sharded as ns

        columns = ns.transform(values[None] if values.dim() == 2 else values, ntt_mesh,
                               root_int, n)
        mesh_stages._record(stage, columns.axis, ntt_mesh)
        if rows_mesh is None:
            out = ns.gather(columns, n)
            return out[0] if values.dim() == 2 else out
        rows = ns.columns_to_rows(columns, n)
        if values.dim() == 2:
            return Sharded(ntt_mesh, [p[0] for p in rows.parts], 0, "rows")
        return rows
    if values.dim() == 2:
        out = tiles.ntt(values, root_int, n=n)
        return out if rows_mesh is None else rows_mesh.scatter(out, 0, "rows")
    out = tiles.ntt_batched(values, root_int, n=n)
    return out if rows_mesh is None else rows_mesh.scatter(out, 1, "rows")


def _validate_constraint_poly_degree(constraint_poly, trace_length):
    """Debug-mode degree validation (reference constraint_poly.rs:13-26,
    constraint_table.rs:90-112; distaff_tpu/stark/prover.py:574-588): after
    the zero polynomials are divided out, the constraint polynomial has
    degree exactly |D_ev| - |D_trace|: every higher coefficient vanishes."""
    combined = ft.to_ints(constraint_poly)
    expected = combined.shape[0] - trace_length
    high = np.nonzero(combined[expected + 1:])[0]
    assert len(high) == 0, (
        f"constraint polynomial degree exceeds {expected}: nonzero "
        f"coefficients at {expected + 1 + high[:3]}")
    assert combined[expected] != 0, (
        f"constraint polynomial degree is below the expected {expected}")


# ------------------------------------------------------------------------------------------------
# step 5: constraint commitment
# ------------------------------------------------------------------------------------------------

def _build_constraint_tree(constraint_lde, hash_name):
    """Two evaluations (32 raw bytes) per leaf - unlike the trace tree, the
    leaves are the evaluation bytes themselves (reference prover.rs:84-86)."""
    from ..crypto.merkle_dev import commit

    from ..parallel.mesh import Sharded

    if isinstance(constraint_lde, Sharded):
        return commit(Sharded(constraint_lde.mesh, [p.reshape(-1, 8) for p in constraint_lde.parts],
                              0, "rows"), hash_name, leaves=True)
    d = constraint_lde.shape[0]
    return commit(constraint_lde.reshape(d // 2, 8), hash_name, leaves=True)


# ------------------------------------------------------------------------------------------------
# step 6: DEEP composition in the evaluation domain
# ------------------------------------------------------------------------------------------------

def _build_composition_evaluations(trace, constraint_poly, constraint_lde, z, cc, part):
    """Step 6, computed pointwise over the LDE domain (reference
    trace_table.rs:206-261 / constraint_poly.rs:39-52 build the same values
    by coefficient-space synthetic division): the point evaluations T_i(z),
    T_i(zg) and C(z) (kernel K8, both queued before one copy to the host),
    then the composition in one launch of kernel K7.  Streaming, K7 reads
    A1 and A2 themselves: the weighted sums of the coefficients (K15)
    extended to the LDE domain (K1), weighted (1, 0) and (0, 1), which is
    exact.  `part` is called with the name of each part as it ends."""
    from ..ops import deep_kernels
    from ..ops.hostsync import TransferBatch

    device = trace.polys_dev.device
    trace_length = trace.unextended_length()
    next_z = field.mul(z, field.get_root_of_unity(trace_length))

    # T_i(z), T_i(zg) (the proof's DeepValues) and C(z)
    batch = TransferBatch()
    states = batch.add(deep_kernels.poly_eval(trace.polys_dev, [z, next_z]))
    at_z = batch.add(deep_kernels.poly_eval(constraint_poly[None], [z]))
    trace_state1, trace_state2 = ([int(v) for v in row] for row in ft.to_ints(batch.get(states)))
    c_at_z = int(ft.to_ints(batch.get(at_z))[0, 0])
    part("point evaluations (K8)")

    # the scalar DEEP terms, then A1(x) = sum_i cc1_i T_i(x), A2 likewise,
    # and the composition
    r_count = trace.register_count()
    s1 = sum(v * c for v, c in zip(trace_state1, cc.trace1[:r_count])) % M
    s2 = sum(v * c for v, c in zip(trace_state2, cc.trace2[:r_count])) % M
    w1 = ft.from_ints(np.array(cc.trace1[:r_count], dtype=object), device)
    w2 = ft.from_ints(np.array(cc.trace2[:r_count], dtype=object), device)
    root = field.get_root_of_unity(trace.domain_size())
    mesh = trace.rows_mesh()
    lde = trace.lde_dev
    if trace.streaming:
        sums = deep_kernels.coeff_wsum(trace.polys_dev, w1, w2)
        lde = _extend_column_dev(sums, root, trace.domain_size(), trace.mesh, mesh,
                                 "composition_wsum_lde")                # (2, D, 4)
        del sums
        w1 = ft.from_ints(np.array([1, 0], dtype=object), device)
        w2 = ft.from_ints(np.array([0, 1], dtype=object), device)
        part("A1 and A2 (K15, K1)")
    if mesh is not None:
        # each slot's rows of the LDE domain (parallel/mesh_stages.py)
        from ..parallel import mesh_stages

        composed = (mesh_stages.compose_sharded_from_sums(
            lde, constraint_lde, z, cc, s1, s2, c_at_z, mesh, trace_length) if trace.streaming
                    else mesh_stages.compose_sharded(
                        trace, constraint_lde, z, cc, s1, s2, c_at_z, mesh))
    else:
        composed = deep_kernels.deep_compose(
            lde, constraint_lde, w1, w2, root,
            utils.get_incremental_trace_degree(trace_length),
            (z, next_z, s1, s2, c_at_z, cc.t1_degree, cc.t2_degree, cc.constraints))
    part("composition (K7)")
    return composed, DeepValues(trace_state1, trace_state2)
