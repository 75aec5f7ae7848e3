"""Polymorphic constraint operators and shared stack-shift enforcement.

All functions operate on "values" that are either Python ints (verifier,
out-of-domain evaluation at z) or columns over the whole evaluation domain
(numpy object arrays, or TorchCol limb columns in kernel K4's plain
version).  Plain `% M` arithmetic works identically for all of them, so
the AIR has a single source of truth.
"""

from ...math import field, polynom
from ...config import BASE_CYCLE_LENGTH

M = field.M


def is_zero(v):
    return v


def is_binary(v):
    return (v * v - v) % M


def binary_not(v):
    return (1 - v) % M


def are_equal(v1, v2):
    return (v1 - v2) % M


def agg(result, index, flag, value):
    """result[index] += flag * value (the additive constraint aggregation)."""
    result[index] = (result[index] + flag * value) % M


def _agg_many(result, start, flag, values):
    """agg over consecutive slots."""
    for i, value in enumerate(values):
        agg(result, start + i, flag, value)


def enforce_stack_copy(result, old_stack, new_stack, from_slot, op_flag):
    diffs = [(old_stack[i] - new_stack[i]) % M
             for i in range(from_slot, len(result))]
    _agg_many(result, from_slot, op_flag, diffs)


def enforce_right_shift(result, old_stack, new_stack, num_slots, op_flag):
    diffs = [(old_stack[i - num_slots] - new_stack[i]) % M
             for i in range(num_slots, len(result))]
    _agg_many(result, num_slots, op_flag, diffs)


def enforce_left_shift(result, old_stack, new_stack, from_slot, num_slots, op_flag):
    start_idx = from_slot - num_slots
    remainder_idx = len(result) - num_slots
    shifted = [(old_stack[i + num_slots] - new_stack[i]) % M
               for i in range(start_idx, remainder_idx)]
    _agg_many(result, start_idx, op_flag, shifted)
    tail = [new_stack[i] for i in range(remainder_idx, len(result))]
    _agg_many(result, remainder_idx, op_flag, tail)


def extend_constants(constants, extension_factor):
    """Interpolate each 16-long periodic constant column and evaluate it over
    the extended cycle (reference constraints/utils.rs:87-113).

    Returns (polys, evaluations): polys for out-of-domain evaluation at z,
    evaluations (length 16 * extension_factor) for in-domain lookup.
    """
    root = field.get_root_of_unity(BASE_CYCLE_LENGTH)
    domain_size = BASE_CYCLE_LENGTH * extension_factor
    domain_root = field.get_root_of_unity(domain_size)

    polys = []
    evaluations = []
    for constant in constants:
        poly = polynom.interpolate_fft(list(constant), root)
        polys.append(poly)
        padded = poly + [0] * (domain_size - len(poly))
        evaluations.append(polynom.eval_fft(padded, domain_root))
    return polys, evaluations
