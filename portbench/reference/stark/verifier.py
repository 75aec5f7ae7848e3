"""STARK verifier: host-side scalar checks (reference src/stark/verifier.rs),
holding the proof to the options its caller states."""

from ..math import field
from ..config import MIN_TRACE_LENGTH
from ..crypto.merkle import verify_batch
from ..crypto import hashes
from .constraints.evaluator import Evaluator
from . import utils, fri

M = field.M


def verify(program_hash, inputs, outputs, proof, options):
    """True, or raises ValueError (or another error for a malformed proof)
    where the proof does not prove `outputs` of the program whose hash is
    `program_hash` on `inputs` under `options`."""
    if proof.options != options:
        raise ValueError("the proof's options are not the stated options")
    hash_fn = hashes.HASH_FUNCTIONS[options.hash_fn]

    # 1 ----- verify proof of work and determine query positions ---------------------------------
    degree_proof = proof.degree_proof
    fri_roots = b"".join(layer.root for layer in degree_proof.layers) + degree_proof.rem_root
    seed = hash_fn(fri_roots)
    seed = utils.verify_pow_nonce(seed, proof.pow_nonce, options)

    t_positions = utils.compute_query_positions(seed, proof.domain_size(), options)
    c_positions = utils.map_trace_to_constraint_positions(t_positions)

    # 2 ----- verify minimum operation count -----------------------------------------------------
    if proof.op_count() < MIN_TRACE_LENGTH:
        raise ValueError("verification of minimum operation count failed")

    # 3 ----- verify trace and constraint Merkle openings ----------------------------------------
    if not verify_batch(
            proof.trace_root, t_positions, proof.trace_proof(), options.hash_fn):
        raise ValueError("verification of trace Merkle proof failed")
    if not verify_batch(
            proof.constraint_root, c_positions, proof.constraint_proof(), options.hash_fn):
        raise ValueError("verification of constraint Merkle proof failed")

    # 4 ----- evaluate constraints at the DEEP point z -------------------------------------------
    z = utils.draw_z(proof.constraint_seed())
    evaluator = Evaluator.from_proof(proof, program_hash, inputs, outputs)
    constraint_evaluation_at_z = _evaluate_constraints(
        evaluator, proof.get_state_at_z1(), proof.get_state_at_z2(), z)

    # 5 ----- compute composition evaluations at the queried positions --------------------------
    cc = utils.CompositionCoefficients(proof.constraint_seed())
    t_composition = _compose_registers(proof, t_positions, z, cc)
    c_composition = _compose_constraints(
        proof, t_positions, c_positions, z, constraint_evaluation_at_z, cc)
    evaluations = [(t + c) % M for t, c in zip(t_composition, c_composition)]

    # 6 ----- verify the low-degree proof --------------------------------------------------------
    max_degree = utils.get_composition_degree(proof.trace_length())
    try:
        return fri.verify(degree_proof, evaluations, t_positions, max_degree, options)
    except ValueError as e:
        raise ValueError(f"verification of low-degree proof failed: {e}")


def _evaluate_constraints(evaluator, state1, state2, x):
    xp = field.exp(x, evaluator.b_degree_adj)
    i_value, f_value = evaluator.evaluate_boundaries(state1, xp)
    t_value = evaluator.evaluate_transition_at(state1, state2, x)

    # divide out the zero polynomials
    result = field.div(i_value, field.sub(x, 1))
    z_last = field.sub(x, evaluator.get_x_at_last_step())
    result = field.add(result, field.div(f_value, z_last))
    z_trans = field.div(
        field.sub(field.exp(x, evaluator.trace_length), 1), z_last)
    result = field.add(result, field.div(t_value, z_trans))
    return result


def _compose_registers(proof, positions, z, cc):
    lde_root = field.get_root_of_unity(proof.domain_size())
    trace_root = field.get_root_of_unity(proof.trace_length())
    next_z = field.mul(z, trace_root)

    trace_at_z1 = proof.deep_values.trace_at_z1
    trace_at_z2 = proof.deep_values.trace_at_z2
    incremental_degree = utils.get_incremental_trace_degree(proof.trace_length())

    result = []
    for registers, position in zip(proof.trace_evaluations, positions):
        x = field.exp(lde_root, position)
        composition = 0
        inv_xz = field.inv(field.sub(x, z))
        inv_xz2 = field.inv(field.sub(x, next_z))
        for i, value in enumerate(registers):
            t1 = field.mul(field.sub(value, trace_at_z1[i]), inv_xz)
            composition = (composition + t1 * cc.trace1[i]) % M
            t2 = field.mul(field.sub(value, trace_at_z2[i]), inv_xz2)
            composition = (composition + t2 * cc.trace2[i]) % M

        xp = field.exp(x, incremental_degree)
        adj = field.mul(field.mul(composition, xp), cc.t2_degree)
        composition = field.add(field.mul(composition, cc.t1_degree), adj)
        result.append(composition)
    return result


def _compose_constraints(proof, t_positions, c_positions, z, evaluation_at_z, cc):
    # extract queried constraint evaluations from the constraint proof leaves
    leaves = proof.constraint_proof().values
    evaluations = []
    for position in t_positions:
        leaf_idx = c_positions.index(position // 2)
        start = (position % 2) * 16
        evaluations.append(field.from_bytes(leaves[leaf_idx][start : start + 16]))

    lde_root = field.get_root_of_unity(proof.domain_size())
    result = []
    for evaluation, position in zip(evaluations, t_positions):
        x = field.exp(lde_root, position)
        composition = field.div(field.sub(evaluation, evaluation_at_z), field.sub(x, z))
        result.append(field.mul(composition, cc.constraints))
    return result
