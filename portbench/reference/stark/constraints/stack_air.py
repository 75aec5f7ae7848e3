"""User-stack AIR: 2 aux constraints + one constraint per stack register,
all degree 7, with per-op enforcement gated by op flags and aggregated
additively (reference src/stark/constraints/stack/).
"""

from ...math import field, polynom
from ...config import BASE_CYCLE_LENGTH, HASH_STATE_WIDTH
from ...crypto.ark_constants import HASHER_MDS, HASHER_INV_MDS, HASHER_ARK
from ...programs.opcodes import OpCode
from .utils import (
    agg, _agg_many, is_zero, is_binary, binary_not, are_equal, extend_constants,
    enforce_stack_copy, enforce_left_shift, enforce_right_shift,
)
from .decoder_air import pow_3

M = field.M

NUM_AUX_CONSTRAINTS = 2
AUX_CONSTRAINT_DEGREES = [7, 7]
STACK_TRANSITION_DEGREE = 7

ARK_ROWS = [HASHER_ARK[r * 16 : (r + 1) * 16] for r in range(2 * HASH_STATE_WIDTH)]

# CMP register layout
POW2_IDX, X_BIT_IDX, Y_BIT_IDX, NOT_SET_IDX, GT_IDX, LT_IDX, Y_ACC_IDX, X_ACC_IDX = range(8)


class Stack:
    def __init__(self, trace_length, extension_factor, stack_depth):
        self.trace_length = trace_length
        self.cycle_length = BASE_CYCLE_LENGTH * extension_factor
        self.constraint_degrees = (
            list(AUX_CONSTRAINT_DEGREES) + [STACK_TRANSITION_DEGREE] * stack_depth
        )
        self.ark_polys, ark_evaluations = extend_constants(ARK_ROWS, extension_factor)
        self.ark_rows = ark_evaluations  # row-major [row][cycle] for native eval
        self.ark_values = [
            [ark_evaluations[j][i] for j in range(2 * HASH_STATE_WIDTH)]
            for i in range(self.cycle_length)
        ]

    def constraint_count(self):
        return len(self.constraint_degrees)

    def evaluate_at(self, current, next_state, x, result):
        num_cycles = self.trace_length // BASE_CYCLE_LENGTH
        x = field.exp(x, num_cycles)
        ark = [polynom.eval(p, x) for p in self.ark_polys]
        enforce_constraints(current, next_state, ark, result)

def enforce_constraints(current, next_state, ark, result):
    aux = ResultList([result[0], result[1]])
    old_stack = current.user_stack
    new_stack = next_state.user_stack

    evaluations = ResultList([0] * len(old_stack))

    ld = current.ld_op_flags()

    enforce_assert(evaluations, aux, old_stack, new_stack, ld[OpCode.Assert.ld_index()])
    enforce_asserteq(evaluations, aux, old_stack, new_stack, ld[OpCode.AssertEq.ld_index()])

    enforce_read(evaluations, old_stack, new_stack, ld[OpCode.Read.ld_index()])
    enforce_read2(evaluations, old_stack, new_stack, ld[OpCode.Read2.ld_index()])

    enforce_dup(evaluations, old_stack, new_stack, ld[OpCode.Dup.ld_index()])
    enforce_dup2(evaluations, old_stack, new_stack, ld[OpCode.Dup2.ld_index()])
    enforce_dup4(evaluations, old_stack, new_stack, ld[OpCode.Dup4.ld_index()])
    enforce_pad2(evaluations, old_stack, new_stack, ld[OpCode.Pad2.ld_index()])

    enforce_drop(evaluations, old_stack, new_stack, ld[OpCode.Drop.ld_index()])
    enforce_drop4(evaluations, old_stack, new_stack, ld[OpCode.Drop4.ld_index()])

    enforce_swap(evaluations, old_stack, new_stack, ld[OpCode.Swap.ld_index()])
    enforce_swap2(evaluations, old_stack, new_stack, ld[OpCode.Swap2.ld_index()])
    enforce_swap4(evaluations, old_stack, new_stack, ld[OpCode.Swap4.ld_index()])

    enforce_roll4(evaluations, old_stack, new_stack, ld[OpCode.Roll4.ld_index()])
    enforce_roll8(evaluations, old_stack, new_stack, ld[OpCode.Roll8.ld_index()])

    enforce_add(evaluations, old_stack, new_stack, ld[OpCode.Add.ld_index()])
    enforce_mul(evaluations, old_stack, new_stack, ld[OpCode.Mul.ld_index()])
    enforce_inv(evaluations, old_stack, new_stack, ld[OpCode.Inv.ld_index()])
    enforce_neg(evaluations, old_stack, new_stack, ld[OpCode.Neg.ld_index()])
    enforce_not(evaluations, aux, old_stack, new_stack, ld[OpCode.Not.ld_index()])
    enforce_and(evaluations, aux, old_stack, new_stack, ld[OpCode.And.ld_index()])
    enforce_or(evaluations, aux, old_stack, new_stack, ld[OpCode.Or.ld_index()])

    enforce_eq(evaluations, aux, old_stack, new_stack, ld[OpCode.Eq.ld_index()])
    enforce_binacc(evaluations, old_stack, new_stack, ld[OpCode.BinAcc.ld_index()])

    enforce_choose(evaluations, aux, old_stack, new_stack, ld[OpCode.Choose.ld_index()])
    enforce_choose2(evaluations, aux, old_stack, new_stack, ld[OpCode.Choose2.ld_index()])
    enforce_cswap2(evaluations, aux, old_stack, new_stack, ld[OpCode.CSwap2.ld_index()])

    hd = current.hd_op_flags()
    enforce_push(evaluations, old_stack, new_stack, hd[OpCode.Push.hd_index()])
    enforce_cmp(evaluations, old_stack, new_stack, hd[OpCode.Cmp.hd_index()])
    enforce_rescr(evaluations, old_stack, new_stack, ark, hd[OpCode.RescR.hd_index()])

    # composite BEGIN / NOOP: the stack must not change
    enforce_stack_copy(evaluations, old_stack, new_stack, 0, current.begin_flag())
    enforce_stack_copy(evaluations, old_stack, new_stack, 0, current.noop_flag())

    result[0] = aux[0]
    result[1] = aux[1]
    for i in range(len(result) - NUM_AUX_CONSTRAINTS):
        result[NUM_AUX_CONSTRAINTS + i] = evaluations[i]


class ResultList:
    def __init__(self, values):
        self.values = values

    def __len__(self):
        return len(self.values)

    def __getitem__(self, i):
        return self.values[i]

    def __setitem__(self, i, v):
        self.values[i] = v


# assertions ---------------------------------------------------------------------------------

def enforce_assert(result, aux, old_stack, new_stack, op_flag):
    enforce_left_shift(result, old_stack, new_stack, 1, 1, op_flag)
    agg(aux, 0, op_flag, are_equal(1, old_stack[0]))


def enforce_asserteq(result, aux, old_stack, new_stack, op_flag):
    enforce_left_shift(result, old_stack, new_stack, 2, 2, op_flag)
    agg(aux, 0, op_flag, are_equal(old_stack[0], old_stack[1]))


# input ops ----------------------------------------------------------------------------------

def enforce_push(result, old_stack, new_stack, op_flag):
    # the pushed value itself is constrained by the decoder's sponge injection
    enforce_right_shift(result, old_stack, new_stack, 1, op_flag)


def enforce_read(result, old_stack, new_stack, op_flag):
    enforce_right_shift(result, old_stack, new_stack, 1, op_flag)


def enforce_read2(result, old_stack, new_stack, op_flag):
    enforce_right_shift(result, old_stack, new_stack, 2, op_flag)


# stack manipulation -------------------------------------------------------------------------

def enforce_dup(result, old_stack, new_stack, op_flag):
    agg(result, 0, op_flag, are_equal(new_stack[0], old_stack[0]))
    enforce_right_shift(result, old_stack, new_stack, 1, op_flag)


def enforce_dup2(result, old_stack, new_stack, op_flag):
    agg(result, 0, op_flag, are_equal(new_stack[0], old_stack[0]))
    agg(result, 1, op_flag, are_equal(new_stack[1], old_stack[1]))
    enforce_right_shift(result, old_stack, new_stack, 2, op_flag)


def enforce_dup4(result, old_stack, new_stack, op_flag):
    _agg_many(result, 0, op_flag,
              [are_equal(new_stack[i], old_stack[i]) for i in range(4)])
    enforce_right_shift(result, old_stack, new_stack, 4, op_flag)


def enforce_pad2(result, old_stack, new_stack, op_flag):
    agg(result, 0, op_flag, new_stack[0])
    agg(result, 1, op_flag, new_stack[1])
    enforce_right_shift(result, old_stack, new_stack, 2, op_flag)


def enforce_drop(result, old_stack, new_stack, op_flag):
    enforce_left_shift(result, old_stack, new_stack, 1, 1, op_flag)


def enforce_drop4(result, old_stack, new_stack, op_flag):
    enforce_left_shift(result, old_stack, new_stack, 4, 4, op_flag)


def enforce_swap(result, old_stack, new_stack, op_flag):
    # both swap terms aggregate into slot 0, matching the reference
    # (stack/manipulation.rs:66-67)
    agg(result, 0, op_flag, are_equal(new_stack[0], old_stack[1]))
    agg(result, 0, op_flag, are_equal(new_stack[1], old_stack[0]))
    enforce_stack_copy(result, old_stack, new_stack, 2, op_flag)


def enforce_swap2(result, old_stack, new_stack, op_flag):
    agg(result, 0, op_flag, are_equal(new_stack[0], old_stack[2]))
    agg(result, 1, op_flag, are_equal(new_stack[1], old_stack[3]))
    agg(result, 2, op_flag, are_equal(new_stack[2], old_stack[0]))
    agg(result, 3, op_flag, are_equal(new_stack[3], old_stack[1]))
    enforce_stack_copy(result, old_stack, new_stack, 4, op_flag)


def enforce_swap4(result, old_stack, new_stack, op_flag):
    _agg_many(result, 0, op_flag,
              [are_equal(new_stack[i], old_stack[i + 4]) for i in range(4)]
              + [are_equal(new_stack[i + 4], old_stack[i]) for i in range(4)])
    enforce_stack_copy(result, old_stack, new_stack, 8, op_flag)


def enforce_roll4(result, old_stack, new_stack, op_flag):
    _agg_many(result, 0, op_flag,
              [are_equal(new_stack[0], old_stack[3])]
              + [are_equal(new_stack[i + 1], old_stack[i]) for i in range(3)])
    enforce_stack_copy(result, old_stack, new_stack, 4, op_flag)


def enforce_roll8(result, old_stack, new_stack, op_flag):
    _agg_many(result, 0, op_flag,
              [are_equal(new_stack[0], old_stack[7])]
              + [are_equal(new_stack[i + 1], old_stack[i]) for i in range(7)])
    enforce_stack_copy(result, old_stack, new_stack, 8, op_flag)


# arithmetic / boolean -----------------------------------------------------------------------

def enforce_add(result, old_stack, new_stack, op_flag):
    op_result = (old_stack[0] + old_stack[1]) % M
    agg(result, 0, op_flag, are_equal(new_stack[0], op_result))
    enforce_left_shift(result, old_stack, new_stack, 2, 1, op_flag)


def enforce_mul(result, old_stack, new_stack, op_flag):
    op_result = (old_stack[0] * old_stack[1]) % M
    agg(result, 0, op_flag, are_equal(new_stack[0], op_result))
    enforce_left_shift(result, old_stack, new_stack, 2, 1, op_flag)


def enforce_inv(result, old_stack, new_stack, op_flag):
    agg(result, 0, op_flag, are_equal(1, (new_stack[0] * old_stack[0]) % M))
    enforce_stack_copy(result, old_stack, new_stack, 1, op_flag)


def enforce_neg(result, old_stack, new_stack, op_flag):
    agg(result, 0, op_flag, (new_stack[0] + old_stack[0]) % M)
    enforce_stack_copy(result, old_stack, new_stack, 1, op_flag)


def enforce_not(result, aux, old_stack, new_stack, op_flag):
    agg(result, 0, op_flag, are_equal(new_stack[0], binary_not(old_stack[0])))
    enforce_stack_copy(result, old_stack, new_stack, 1, op_flag)
    agg(aux, 0, op_flag, is_binary(old_stack[0]))


def enforce_and(result, aux, old_stack, new_stack, op_flag):
    op_result = (old_stack[0] * old_stack[1]) % M
    agg(result, 0, op_flag, are_equal(new_stack[0], op_result))
    enforce_left_shift(result, old_stack, new_stack, 2, 1, op_flag)
    agg(aux, 0, op_flag, is_binary(old_stack[0]))
    agg(aux, 1, op_flag, is_binary(old_stack[1]))


def enforce_or(result, aux, old_stack, new_stack, op_flag):
    op_result = binary_not((binary_not(old_stack[0]) * binary_not(old_stack[1])) % M)
    agg(result, 0, op_flag, are_equal(new_stack[0], op_result))
    enforce_left_shift(result, old_stack, new_stack, 2, 1, op_flag)
    agg(aux, 0, op_flag, is_binary(old_stack[0]))
    agg(aux, 1, op_flag, is_binary(old_stack[1]))


# comparisons --------------------------------------------------------------------------------

def enforce_eq(result, aux, old_stack, new_stack, op_flag):
    diff = (old_stack[1] - old_stack[2]) % M
    inv_diff = old_stack[0]
    op_result = binary_not((diff * inv_diff) % M)
    agg(result, 0, op_flag, are_equal(new_stack[0], op_result))
    enforce_left_shift(result, old_stack, new_stack, 3, 2, op_flag)
    agg(aux, 0, op_flag, (new_stack[0] * diff) % M)


def enforce_cmp(result, old_stack, new_stack, op_flag):
    x_bit = new_stack[X_BIT_IDX]
    y_bit = new_stack[Y_BIT_IDX]
    agg(result, 0, op_flag, is_binary(x_bit))
    agg(result, 1, op_flag, is_binary(y_bit))

    not_set = new_stack[NOT_SET_IDX]
    bit_gt = (x_bit * binary_not(y_bit)) % M
    bit_lt = (y_bit * binary_not(x_bit)) % M

    gt = (old_stack[GT_IDX] + bit_gt * not_set) % M
    lt = (old_stack[LT_IDX] + bit_lt * not_set) % M
    agg(result, 2, op_flag, are_equal(new_stack[GT_IDX], gt))
    agg(result, 3, op_flag, are_equal(new_stack[LT_IDX], lt))

    power_of_two = old_stack[POW2_IDX]
    x_acc = (old_stack[X_ACC_IDX] + x_bit * power_of_two) % M
    y_acc = (old_stack[Y_ACC_IDX] + y_bit * power_of_two) % M
    agg(result, 4, op_flag, are_equal(new_stack[Y_ACC_IDX], y_acc))
    agg(result, 5, op_flag, are_equal(new_stack[X_ACC_IDX], x_acc))

    not_set_check = (binary_not(old_stack[LT_IDX]) * binary_not(old_stack[GT_IDX])) % M
    agg(result, 6, op_flag, are_equal(not_set, not_set_check))

    agg(result, 7, op_flag, are_equal((new_stack[POW2_IDX] * 2) % M, power_of_two))

    enforce_stack_copy(result, old_stack, new_stack, 8, op_flag)


def enforce_binacc(result, old_stack, new_stack, op_flag):
    bit = new_stack[0]
    agg(result, 0, op_flag, is_binary(bit))
    agg(result, 1, op_flag, is_zero(new_stack[1]))
    power_of_two = old_stack[2]
    agg(result, 2, op_flag, are_equal(new_stack[2], (power_of_two * 2) % M))
    acc = (old_stack[3] + bit * power_of_two) % M
    agg(result, 3, op_flag, are_equal(new_stack[3], acc))
    enforce_stack_copy(result, old_stack, new_stack, 4, op_flag)


# conditional selection ----------------------------------------------------------------------

def enforce_choose(result, aux, old_stack, new_stack, op_flag):
    condition = old_stack[2]
    not_condition = binary_not(condition)
    op_result = (condition * old_stack[0] + not_condition * old_stack[1]) % M
    agg(result, 0, op_flag, are_equal(new_stack[0], op_result))
    enforce_left_shift(result, old_stack, new_stack, 3, 2, op_flag)
    agg(aux, 0, op_flag, is_binary(condition))


def enforce_choose2(result, aux, old_stack, new_stack, op_flag):
    condition = old_stack[4]
    not_condition = binary_not(condition)
    r1 = (condition * old_stack[0] + not_condition * old_stack[2]) % M
    r2 = (condition * old_stack[1] + not_condition * old_stack[3]) % M
    agg(result, 0, op_flag, are_equal(new_stack[0], r1))
    agg(result, 1, op_flag, are_equal(new_stack[1], r2))
    enforce_left_shift(result, old_stack, new_stack, 6, 4, op_flag)
    agg(aux, 0, op_flag, is_binary(condition))


def enforce_cswap2(result, aux, old_stack, new_stack, op_flag):
    condition = old_stack[4]
    not_condition = binary_not(condition)
    r0 = (condition * old_stack[2] + not_condition * old_stack[0]) % M
    r1 = (condition * old_stack[3] + not_condition * old_stack[1]) % M
    r2 = (condition * old_stack[0] + not_condition * old_stack[2]) % M
    r3 = (condition * old_stack[1] + not_condition * old_stack[3]) % M
    agg(result, 0, op_flag, are_equal(new_stack[0], r0))
    agg(result, 1, op_flag, are_equal(new_stack[1], r1))
    agg(result, 2, op_flag, are_equal(new_stack[2], r2))
    agg(result, 3, op_flag, are_equal(new_stack[3], r3))
    enforce_left_shift(result, old_stack, new_stack, 6, 2, op_flag)
    agg(aux, 0, op_flag, is_binary(condition))


# crypto -------------------------------------------------------------------------------------

def _hasher_mds(state, mds):
    out = []
    for i in range(HASH_STATE_WIDTH):
        acc = 0
        for j in range(HASH_STATE_WIDTH):
            acc = (acc + mds[i * HASH_STATE_WIDTH + j] * state[j]) % M
        out.append(acc)
    return out


def _pow3_all(values):
    return [pow_3(v) for v in values]


def enforce_rescr(result, old_stack, new_stack, ark, op_flag):
    old_state = [(old_stack[i] + ark[i]) % M for i in range(HASH_STATE_WIDTH)]
    old_state = _pow3_all(old_state)
    old_state = _hasher_mds(old_state, HASHER_MDS)

    new_state = _hasher_mds(list(new_stack[:HASH_STATE_WIDTH]), HASHER_INV_MDS)
    new_state = _pow3_all(new_state)
    new_state = [(new_state[i] - ark[HASH_STATE_WIDTH + i]) % M for i in range(HASH_STATE_WIDTH)]

    _agg_many(result, 0, op_flag,
              [are_equal(new_state[i], old_state[i]) for i in range(HASH_STATE_WIDTH)])
    enforce_stack_copy(result, old_stack, new_stack, HASH_STATE_WIDTH, op_flag)
