"""Decoder AIR: op-bit, sponge (hacc), flow-control, and ctx/loop stack
transition constraints (reference src/stark/constraints/decoder/).

Constraint layout (indices into the evaluation vector):
  [0..15)   op-bit constraints (binariness, counters, alignment masks)
  [15..19)  sponge/hacc constraints (meet-in-the-middle Rescue round)
  [19]      loop-image constraint slot
  [19+1 ..] ctx-stack then loop-stack constraints
"""

from ...math import field, polynom
from ...config import (
    SPONGE_WIDTH, BASE_CYCLE_LENGTH, MIN_CONTEXT_DEPTH, MIN_LOOP_DEPTH,
)
from ...crypto.ark_constants import SPONGE_MDS, SPONGE_INV_MDS, SPONGE_ARK
from ...programs.opcodes import FlowOps, OpCode
from . import utils
from .utils import agg, is_binary, binary_not, are_equal, is_zero, extend_constants

M = field.M

NUM_OP_CONSTRAINTS = 15
OP_CONSTRAINT_DEGREES = [2] * 10 + [3, 8, 8, 6, 4]
NUM_SPONGE_CONSTRAINTS = 4
SPONGE_CONSTRAINT_DEGREES = [6, 7, 6, 6]
LOOP_IMAGE_CONSTRAINT_DEGREE = 4
STACK_CONSTRAINT_DEGREE = 4

CYCLE_MASK_IDX = 0
PREFIX_MASK_IDX = 1
PUSH_MASK_IDX = 2

# cycle masks: step-alignment gates for control-flow ops (decoder/mod.rs:219-223)
MASKS = [
    [0] + [1] * 15,        # multiples of 16
    [1] * 15 + [0],        # one less than multiple of 16
    [0] + [1] * 7 + [0] + [1] * 7,  # multiples of 8
]

# sponge ARK as 8 rows of 16 cyclic constants
ARK_ROWS = [SPONGE_ARK[r * 16 : (r + 1) * 16] for r in range(2 * SPONGE_WIDTH)]


class Decoder:
    def __init__(self, trace_length, extension_factor, ctx_depth, loop_depth):
        self.ctx_depth = ctx_depth
        self.loop_depth = loop_depth
        self.trace_length = trace_length
        self.cycle_length = BASE_CYCLE_LENGTH * extension_factor

        degrees = list(OP_CONSTRAINT_DEGREES) + list(SPONGE_CONSTRAINT_DEGREES)
        degrees.append(LOOP_IMAGE_CONSTRAINT_DEGREE)
        degrees += [STACK_CONSTRAINT_DEGREE] * (
            max(ctx_depth, MIN_CONTEXT_DEPTH) + max(loop_depth, MIN_LOOP_DEPTH)
        )
        self.constraint_degrees = degrees

        self.ark_polys, ark_evaluations = extend_constants(ARK_ROWS, extension_factor)
        self.ark_rows = ark_evaluations  # row-major [row][cycle] for native eval
        self.ark_values = _transpose(ark_evaluations, self.cycle_length)
        self.mask_polys, mask_evaluations = extend_constants(MASKS, extension_factor)
        self.mask_rows = mask_evaluations
        self.mask_values = _transpose(mask_evaluations, self.cycle_length)

    def constraint_count(self):
        return len(self.constraint_degrees)

    def evaluate_at(self, current, next_state, x, result):
        """Out-of-domain evaluation: periodic columns evaluated at x^num_cycles."""
        num_cycles = self.trace_length // BASE_CYCLE_LENGTH
        x = field.exp(x, num_cycles)
        ark = [polynom.eval(p, x) for p in self.ark_polys]
        masks = [polynom.eval(p, x) for p in self.mask_polys]
        self._evaluate_with_constants(current, next_state, ark, masks, result)

    def _evaluate_with_constants(self, current, next_state, ark, masks, result):
        enforce_op_bits(result, current, next_state, masks)
        rest = ResultSlice(result, NUM_OP_CONSTRAINTS)
        op_flags = current.cf_op_flags()
        enforce_hacc(rest, current, next_state, ark, op_flags[FlowOps.Hacc.op_index()])
        enforce_begin(rest, current, next_state, op_flags[FlowOps.Begin.op_index()])
        enforce_tend(rest, current, next_state, op_flags[FlowOps.Tend.op_index()])
        enforce_fend(rest, current, next_state, op_flags[FlowOps.Fend.op_index()])
        enforce_loop(rest, current, next_state, op_flags[FlowOps.Loop.op_index()])
        enforce_wrap(rest, current, next_state, op_flags[FlowOps.Wrap.op_index()])
        enforce_break(rest, current, next_state, op_flags[FlowOps.Break.op_index()])
        enforce_void(rest, current, next_state, op_flags[FlowOps.Void.op_index()])


class ResultSlice:
    """A view over `result` starting at `offset` (mirrors Rust slice reborrows)."""

    def __init__(self, result, offset, length=None):
        self.result = result
        self.offset = offset
        self.length = length if length is not None else len(result) - offset

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return self.result[self.offset + i]

    def __setitem__(self, i, v):
        self.result[self.offset + i] = v

    def slice(self, start, end):
        return ResultSlice(self.result, self.offset + start, end - start)


def _transpose(evaluations, cycle_length):
    return [[evaluations[j][i] for j in range(len(evaluations))] for i in range(cycle_length)]


# ------------------------------------------------------------------------------------------------
# op-bit constraints (decoder/op_bits.rs)
# ------------------------------------------------------------------------------------------------

def enforce_op_bits(result, current, next_state, masks):
    i = 0
    cf_bit_sum = 0
    for op_bit in current.cf_op_bits:
        result[i] = is_binary(op_bit)
        cf_bit_sum = (cf_bit_sum + op_bit) % M
        i += 1

    ld_bit_prod = 1
    for op_bit in current.ld_op_bits:
        result[i] = is_binary(op_bit)
        ld_bit_prod = (ld_bit_prod * op_bit) % M
        i += 1

    hd_bit_prod = 1
    for op_bit in current.hd_op_bits:
        result[i] = is_binary(op_bit)
        hd_bit_prod = (hd_bit_prod * op_bit) % M
        i += 1

    # op_counter increments by 1 on HACC, stays constant otherwise
    op_counter = current.op_counter
    is_hacc = current.cf_op_flags()[FlowOps.Hacc.op_index()]
    hacc_transition = ((op_counter + 1) * is_hacc) % M
    rest_transition = (op_counter * binary_not(is_hacc)) % M
    result[i] = are_equal((hacc_transition + rest_transition) % M, next_state.op_counter)
    i += 1

    # ld/hd ops cannot be all 0s except at the very first step
    result[i] = (op_counter * binary_not(ld_bit_prod) * binary_not(hd_bit_prod)) % M
    i += 1

    # when cf ops are not all 0s, user ops must be all 1s (NOOP)
    result[i] = (cf_bit_sum * binary_not((ld_bit_prod * hd_bit_prod) % M)) % M
    i += 1

    cf_op_flags = current.cf_op_flags()

    # VOID can be followed only by VOID
    current_void = cf_op_flags[FlowOps.Void.op_index()]
    next_void = next_state.cf_op_flags()[FlowOps.Void.op_index()]
    result[i] = (current_void * binary_not(next_void)) % M
    i += 1

    hd_op_flags = current.hd_op_flags()

    # step-alignment: BEGIN/LOOP/WRAP/BREAK on 15 mod 16; TEND/FEND on 0 mod 16;
    # PUSH on multiples of 8
    prefix_mask = masks[PREFIX_MASK_IDX]
    agg(result, i, cf_op_flags[FlowOps.Begin.op_index()], prefix_mask)
    agg(result, i, cf_op_flags[FlowOps.Loop.op_index()], prefix_mask)
    agg(result, i, cf_op_flags[FlowOps.Wrap.op_index()], prefix_mask)
    agg(result, i, cf_op_flags[FlowOps.Break.op_index()], prefix_mask)
    base_cycle_mask = masks[CYCLE_MASK_IDX]
    agg(result, i, cf_op_flags[FlowOps.Tend.op_index()], base_cycle_mask)
    agg(result, i, cf_op_flags[FlowOps.Fend.op_index()], base_cycle_mask)
    push_mask = masks[PUSH_MASK_IDX]
    agg(result, i, hd_op_flags[OpCode.Push.hd_index()], push_mask)


# ------------------------------------------------------------------------------------------------
# sponge constraint (decoder/sponge.rs): one hacc round, met in the middle
# ------------------------------------------------------------------------------------------------

def _sponge_mds(state, mds):
    out = []
    for i in range(SPONGE_WIDTH):
        acc = 0
        for j in range(SPONGE_WIDTH):
            acc = (acc + mds[i * SPONGE_WIDTH + j] * state[j]) % M
        out.append(acc)
    return out


def _pow3_all(values):
    return [pow_3(v) for v in values]


def enforce_hacc(result, current, next_state, ark, op_flag):
    stack_top = next_state.user_stack[0]
    push_flag = current.hd_op_flags()[OpCode.Push.hd_index()]
    op_value = (stack_top * push_flag) % M

    # forward half-round on the current sponge
    old = [(current.sponge[i] + ark[i]) % M for i in range(SPONGE_WIDTH)]
    old = _pow3_all(old)
    old = _sponge_mds(old, SPONGE_MDS)
    old[0] = (old[0] + current.op_code()) % M
    old[1] = (old[1] + op_value) % M

    # inverse of the second half-round on the next sponge
    new = _sponge_mds(list(next_state.sponge), SPONGE_INV_MDS)
    new = _pow3_all(new)
    new = [(new[i] - ark[SPONGE_WIDTH + i]) % M for i in range(SPONGE_WIDTH)]

    utils._agg_many(result, 0, op_flag,
                    [are_equal(old[i], new[i]) for i in range(SPONGE_WIDTH)])


def pow_3(v):
    return (v * v % M) * v % M


# ------------------------------------------------------------------------------------------------
# flow-control constraints (decoder/flow_ops.rs)
# ------------------------------------------------------------------------------------------------

def _ctx_loop_slices(result, current):
    ctx_start = SPONGE_WIDTH + 1  # +1 for the loop-image constraint slot
    ctx_end = ctx_start + len(current.ctx_stack)
    ctx_result = result.slice(ctx_start, ctx_end)
    loop_result = result.slice(ctx_end, ctx_end + len(current.loop_stack))
    return ctx_result, loop_result


def enforce_begin(result, current, next_state, op_flag):
    new_sponge = next_state.sponge
    utils._agg_many(result, 0, op_flag, [is_zero(new_sponge[i]) for i in range(4)])
    parent_hash = current.sponge[0]
    ctx_result, loop_result = _ctx_loop_slices(result, current)
    agg(ctx_result, 0, op_flag, are_equal(parent_hash, next_state.ctx_stack[0]))
    utils.enforce_right_shift(ctx_result, current.ctx_stack, next_state.ctx_stack, 1, op_flag)
    utils.enforce_stack_copy(loop_result, current.loop_stack, next_state.loop_stack, 0, op_flag)


def enforce_tend(result, current, next_state, op_flag):
    parent_hash = current.ctx_stack[0]
    block_hash = current.sponge[0]
    new_sponge = next_state.sponge
    utils._agg_many(result, 0, op_flag, [
        are_equal(parent_hash, new_sponge[0]),
        are_equal(block_hash, new_sponge[1])])
    # no constraint on sponge[2] (sibling hash)
    agg(result, 3, op_flag, is_zero(new_sponge[3]))
    ctx_result, loop_result = _ctx_loop_slices(result, current)
    utils.enforce_left_shift(ctx_result, current.ctx_stack, next_state.ctx_stack, 1, 1, op_flag)
    utils.enforce_stack_copy(loop_result, current.loop_stack, next_state.loop_stack, 0, op_flag)


def enforce_fend(result, current, next_state, op_flag):
    parent_hash = current.ctx_stack[0]
    block_hash = current.sponge[0]
    new_sponge = next_state.sponge
    agg(result, 0, op_flag, are_equal(parent_hash, new_sponge[0]))
    # no constraint on sponge[1] (sibling hash)
    agg(result, 2, op_flag, are_equal(block_hash, new_sponge[2]))
    agg(result, 3, op_flag, is_zero(new_sponge[3]))
    ctx_result, loop_result = _ctx_loop_slices(result, current)
    utils.enforce_left_shift(ctx_result, current.ctx_stack, next_state.ctx_stack, 1, 1, op_flag)
    utils.enforce_stack_copy(loop_result, current.loop_stack, next_state.loop_stack, 0, op_flag)


def enforce_loop(result, current, next_state, op_flag):
    new_sponge = next_state.sponge
    utils._agg_many(result, 0, op_flag, [is_zero(new_sponge[i]) for i in range(4)])
    parent_hash = current.sponge[0]
    ctx_result, loop_result = _ctx_loop_slices(result, current)
    agg(ctx_result, 0, op_flag, are_equal(parent_hash, next_state.ctx_stack[0]))
    utils.enforce_right_shift(ctx_result, current.ctx_stack, next_state.ctx_stack, 1, op_flag)
    # loop stack shifts right; first item (the loop image) is unconstrained
    utils.enforce_right_shift(loop_result, current.loop_stack, next_state.loop_stack, 1, op_flag)


def enforce_wrap(result, current, next_state, op_flag):
    new_sponge = next_state.sponge
    utils._agg_many(result, 0, op_flag, [is_zero(new_sponge[i]) for i in range(4)])
    loop_image = current.sponge[0]
    agg(result, SPONGE_WIDTH, op_flag, are_equal(loop_image, current.loop_stack[0]))
    ctx_result, loop_result = _ctx_loop_slices(result, current)
    utils.enforce_stack_copy(ctx_result, current.ctx_stack, next_state.ctx_stack, 0, op_flag)
    utils.enforce_stack_copy(loop_result, current.loop_stack, next_state.loop_stack, 0, op_flag)


def enforce_break(result, current, next_state, op_flag):
    old_sponge = current.sponge
    new_sponge = next_state.sponge
    utils._agg_many(result, 0, op_flag, [
        are_equal(old_sponge[i], new_sponge[i]) for i in range(SPONGE_WIDTH)])
    loop_image = old_sponge[0]
    agg(result, SPONGE_WIDTH, op_flag, are_equal(loop_image, current.loop_stack[0]))
    ctx_result, loop_result = _ctx_loop_slices(result, current)
    utils.enforce_stack_copy(ctx_result, current.ctx_stack, next_state.ctx_stack, 0, op_flag)
    utils.enforce_left_shift(loop_result, current.loop_stack, next_state.loop_stack, 1, 1, op_flag)


def enforce_void(result, current, next_state, op_flag):
    old_sponge = current.sponge
    new_sponge = next_state.sponge
    utils._agg_many(result, 0, op_flag, [
        are_equal(old_sponge[i], new_sponge[i]) for i in range(SPONGE_WIDTH)])
    ctx_result, loop_result = _ctx_loop_slices(result, current)
    utils.enforce_stack_copy(ctx_result, current.ctx_stack, next_state.ctx_stack, 0, op_flag)
    utils.enforce_stack_copy(loop_result, current.loop_stack, next_state.loop_stack, 0, op_flag)
