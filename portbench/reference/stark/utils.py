"""Transcript utilities: pseudo-random coefficients, query positions, PoW.

Coefficient layouts and draw order must match the reference exactly
(reference src/stark/utils/coefficients.rs, utils/mod.rs, proof_of_work.rs)
because they are part of the Fiat-Shamir transcript.
"""

from ..math import field
from ..utils import rand
from ..crypto import hashes
from ..config import (
    MAX_REGISTER_COUNT, MAX_PUBLIC_INPUTS, SPONGE_WIDTH,
    MAX_CONTEXT_DEPTH, MAX_LOOP_DEPTH, MAX_STACK_DEPTH,
    MIN_CONTEXT_DEPTH, MIN_LOOP_DEPTH, MIN_STACK_DEPTH,
    NUM_CF_OP_BITS, NUM_LD_OP_BITS, NUM_HD_OP_BITS,
    MAX_CONSTRAINT_DEGREE,
)

NUM_OP_BITS = NUM_CF_OP_BITS + NUM_LD_OP_BITS + NUM_HD_OP_BITS
NUM_AUX_STACK_CONSTRAINTS = 2
NUM_STATIC_DECODER_CONSTRAINTS = 15 + 4 + 1  # op bits + sponge + loop image

MAX_USER_STACK_IO_CONSTRAINTS = MAX_PUBLIC_INPUTS
NUM_BOUNDARY_CONSTRAINTS = (
    1 + SPONGE_WIDTH + NUM_OP_BITS + MAX_CONTEXT_DEPTH + MAX_LOOP_DEPTH
    + MAX_USER_STACK_IO_CONSTRAINTS
)
NUM_TRANSITION_CONSTRAINTS = (
    NUM_STATIC_DECODER_CONSTRAINTS + MAX_CONTEXT_DEPTH + MAX_LOOP_DEPTH
    + MAX_STACK_DEPTH + NUM_AUX_STACK_CONSTRAINTS
)
NUM_CONSTRAINTS = NUM_TRANSITION_CONSTRAINTS + 2 * NUM_BOUNDARY_CONSTRAINTS


def get_composition_degree(trace_length):
    return (MAX_CONSTRAINT_DEGREE - 1) * trace_length - 1


def get_incremental_trace_degree(trace_length):
    return get_composition_degree(trace_length) - (trace_length - 2)


class BoundaryCoefficients:
    __slots__ = ("op_counter", "sponge", "op_bits", "ctx_stack", "loop_stack", "user_stack")


class ConstraintCoefficients:
    """Two coefficients per constraint; boundary segments at MAX sizes, and
    transition coefficients sliced so assignment is stable regardless of the
    actual ctx/loop/stack depths (reference coefficients.rs:62-185)."""

    def __init__(self, seed: bytes, ctx_depth, loop_depth, stack_depth):
        coefficients = rand.prng_vector(seed, 2 * NUM_CONSTRAINTS, field.M)
        self.i_boundary, i = _build_boundary(coefficients, 0)
        self.f_boundary, i = _build_boundary(coefficients, i)
        self.transition = _build_transition(coefficients[i:], ctx_depth, loop_depth, stack_depth)


def _build_boundary(coefficients, start):
    b = BoundaryCoefficients()
    i = start
    b.op_counter = coefficients[i : i + 2]; i += 2
    b.sponge = coefficients[i : i + SPONGE_WIDTH * 2]; i += SPONGE_WIDTH * 2
    b.op_bits = coefficients[i : i + NUM_OP_BITS * 2]; i += NUM_OP_BITS * 2
    b.ctx_stack = coefficients[i : i + MAX_CONTEXT_DEPTH * 2]; i += MAX_CONTEXT_DEPTH * 2
    b.loop_stack = coefficients[i : i + MAX_LOOP_DEPTH * 2]; i += MAX_LOOP_DEPTH * 2
    b.user_stack = coefficients[i : i + MAX_USER_STACK_IO_CONSTRAINTS * 2]
    i += MAX_USER_STACK_IO_CONSTRAINTS * 2
    return b, i


def _build_transition(coefficients, ctx_depth, loop_depth, stack_depth):
    ctx_depth = max(ctx_depth, MIN_CONTEXT_DEPTH)
    loop_depth = max(loop_depth, MIN_LOOP_DEPTH)
    stack_depth = max(stack_depth, MIN_STACK_DEPTH)

    result = []
    # source layout: [static | ctx(max) | loop(max) | aux | stack]
    s = 0
    result.extend(coefficients[s : s + NUM_STATIC_DECODER_CONSTRAINTS * 2])
    s += NUM_STATIC_DECODER_CONSTRAINTS * 2
    result.extend(coefficients[s : s + ctx_depth * 2])
    s += MAX_CONTEXT_DEPTH * 2
    result.extend(coefficients[s : s + loop_depth * 2])
    s += MAX_LOOP_DEPTH * 2
    result.extend(coefficients[s : s + NUM_AUX_STACK_CONSTRAINTS * 2])
    s += NUM_AUX_STACK_CONSTRAINTS * 2
    result.extend(coefficients[s : s + stack_depth * 2])
    return result


class CompositionCoefficients:
    """DEEP composition coefficients; the first draw from the seed is
    reserved for the deep point z (reference coefficients.rs:79-104)."""

    def __init__(self, seed: bytes):
        coefficients = rand.prng_vector(seed, 1 + 4 * MAX_REGISTER_COUNT + 3, field.M)
        i = 1
        self.trace1 = coefficients[i : i + 2 * MAX_REGISTER_COUNT]
        i += 2 * MAX_REGISTER_COUNT
        self.trace2 = coefficients[i : i + 2 * MAX_REGISTER_COUNT]
        i += 2 * MAX_REGISTER_COUNT
        self.t1_degree = coefficients[i]
        self.t2_degree = coefficients[i + 1]
        self.constraints = coefficients[i + 2]


def draw_z(seed: bytes):
    """The DEEP point z = first PRNG draw from the constraint-tree root."""
    return rand.prng(seed, field.M)


def compute_query_positions(seed: bytes, domain_size, options):
    """Rejection-sample query positions, skipping positions that coincide
    with unextended trace steps and duplicates (reference utils/mod.rs:25-44)."""
    it = rand.usize_iter(seed, domain_size)
    num_queries = options.num_queries()
    ext = options.extension_factor()
    result = []
    for _ in range(1000):
        value = next(it)
        if value % ext == 0:
            continue
        if value in result:
            continue
        result.append(value)
        if len(result) >= num_queries:
            break
    if len(result) < num_queries:
        raise RuntimeError(
            f"needed {num_queries} query positions but generated only {len(result)}"
        )
    return result


def map_trace_to_constraint_positions(positions):
    result = []
    for position in positions:
        cp = position // 2
        if cp not in result:
            result.append(cp)
    return result


def verify_pow_nonce(seed: bytes, nonce, options):
    hash_fn = hashes.HASH_FUNCTIONS[options.hash_fn]
    data = seed + int(nonce).to_bytes(8, "little") + b"\x00" * 24
    digest = hash_fn(data)
    first = int.from_bytes(digest[:8], "little")
    if _trailing_zeros(first) < options.grinding_factor():
        raise ValueError("seed proof-of-work verification failed")
    return digest


def _trailing_zeros(v):
    if v == 0:
        return 64
    return (v & -v).bit_length() - 1
