"""User-stack trace generator with non-deterministic input-tape hints
(reference src/processor/stack/mod.rs).

Secret tapes A/B are consumed FIFO (stored reversed); hint execution pushes
derived witnesses onto the tapes: EqStart pushes inv(x-y), CmpStart pushes
bit decompositions of both comparands, RcStart pushes MSB-first bits,
PmpathStart interlaces index bits into tape A.
"""

from ..math import field
from ..utils import hasher
from ..config import HASH_STATE_WIDTH, MIN_STACK_DEPTH, MAX_STACK_DEPTH
from ..programs.opcodes import OpCode


class Stack:
    def __init__(self, inputs, init_trace_length):
        public_inputs = inputs.get_public_inputs()
        init_stack_depth = max(len(public_inputs), MIN_STACK_DEPTH)
        self.registers = []
        for i in range(init_stack_depth):
            register = [0] * init_trace_length
            if i < len(public_inputs):
                register[0] = public_inputs[i]
            self.registers.append(register)

        secret_a, secret_b = inputs.get_secret_inputs()
        self.tape_a = list(reversed(secret_a))
        self.tape_b = list(reversed(secret_b))
        self.max_depth = len(public_inputs)
        self.depth = len(public_inputs)
        self.step = 0

    def execute(self, op_code, op_hint):
        self._advance_step()
        handler = _DISPATCH[op_code]
        handler(self, op_hint)

    def trace_length(self):
        return len(self.registers[0])

    def get_stack_top(self):
        return self.registers[0][self.step]

    def finalize_trace(self):
        trace_length = self.trace_length()
        for register in self.registers:
            value = register[self.step]
            register[self.step + 1 :] = [value] * (trace_length - self.step - 1)
        self.step = self.trace_length() - 1

    def into_register_traces(self):
        return self.registers[: self.max_depth]

    # flow control --------------------------------------------------------------------------------

    def _op_noop(self, hint):
        self._copy_state(0)

    def _op_assert(self, hint):
        assert self.depth >= 1, f"stack underflow at step {self.step}"
        value = self.registers[0][self.step - 1]
        assert value == 1, f"ASSERT failed at step {self.step}"
        self._shift_left(1, 1)

    def _op_asserteq(self, hint):
        assert self.depth >= 2, f"stack underflow at step {self.step}"
        x = self.registers[0][self.step - 1]
        y = self.registers[1][self.step - 1]
        assert x == y, f"ASSERTEQ failed at step {self.step}"
        self._shift_left(2, 2)

    # input operations ----------------------------------------------------------------------------

    def _op_push(self, hint):
        self._shift_right(0, 1)
        assert hint.kind == "push", f"invalid value for PUSH operation at step {self.step}"
        self.registers[0][self.step] = hint.value

    def _op_read(self, hint):
        if hint.kind == "eq_start":
            assert self.depth >= 2, f"stack underflow at step {self.step}"
            x = self.registers[0][self.step - 1]
            y = self.registers[1][self.step - 1]
            if x == y:
                self.tape_a.append(1)
            else:
                self.tape_a.append(field.inv(field.sub(x, y)))
        elif hint.kind == "none":
            assert self.tape_a, f"attempt to read from empty tape A at step {self.step}"
        else:
            raise ValueError(f"hint {hint.kind} is not valid for READ operation")
        self._shift_right(0, 1)
        self.registers[0][self.step] = self.tape_a.pop()

    def _op_read2(self, hint):
        if hint.kind == "pmpath_start":
            assert self.depth >= 3, f"stack underflow at step {self.step}"
            n = hint.value - 1
            assert len(self.tape_a) >= n, "too few items on tape A for pmpath macro"
            assert len(self.tape_b) >= n, "too few items on tape B for pmpath macro"
            idx = self.registers[2][self.step - 1]
            # interlace binary decomposition of the index with the node values
            v_a = self.tape_a[len(self.tape_a) - n :]
            del self.tape_a[len(self.tape_a) - n :]
            for i in range(n):
                self.tape_a.append((idx >> (n - i - 1)) & 1)  # MSB first
                self.tape_a.append(v_a[i])
        elif hint.kind == "none":
            assert self.tape_a, f"attempt to read from empty tape A at step {self.step}"
            assert self.tape_b, f"attempt to read from empty tape B at step {self.step}"
        else:
            raise ValueError(f"hint {hint.kind} is not valid for READ2 operation")
        self._shift_right(0, 2)
        value_a = self.tape_a.pop()
        value_b = self.tape_b.pop()
        self.registers[0][self.step] = value_b
        self.registers[1][self.step] = value_a

    # stack manipulation --------------------------------------------------------------------------

    def _op_dup(self, hint):
        assert self.depth >= 1, f"stack underflow at step {self.step}"
        self._shift_right(0, 1)
        self.registers[0][self.step] = self.registers[0][self.step - 1]

    def _op_dup2(self, hint):
        assert self.depth >= 2, f"stack underflow at step {self.step}"
        self._shift_right(0, 2)
        for i in range(2):
            self.registers[i][self.step] = self.registers[i][self.step - 1]

    def _op_dup4(self, hint):
        assert self.depth >= 4, f"stack underflow at step {self.step}"
        self._shift_right(0, 4)
        for i in range(4):
            self.registers[i][self.step] = self.registers[i][self.step - 1]

    def _op_pad2(self, hint):
        self._shift_right(0, 2)
        self.registers[0][self.step] = 0
        self.registers[1][self.step] = 0

    def _op_drop(self, hint):
        assert self.depth >= 1, f"stack underflow at step {self.step}"
        self._shift_left(1, 1)

    def _op_drop4(self, hint):
        assert self.depth >= 4, f"stack underflow at step {self.step}"
        self._shift_left(4, 4)

    def _op_swap(self, hint):
        assert self.depth >= 2, f"stack underflow at step {self.step}"
        prev = self.step - 1
        self.registers[0][self.step] = self.registers[1][prev]
        self.registers[1][self.step] = self.registers[0][prev]
        self._copy_state(2)

    def _op_swap2(self, hint):
        assert self.depth >= 4, f"stack underflow at step {self.step}"
        prev = self.step - 1
        for i in range(2):
            self.registers[i][self.step] = self.registers[i + 2][prev]
            self.registers[i + 2][self.step] = self.registers[i][prev]
        self._copy_state(4)

    def _op_swap4(self, hint):
        assert self.depth >= 8, f"stack underflow at step {self.step}"
        prev = self.step - 1
        for i in range(4):
            self.registers[i][self.step] = self.registers[i + 4][prev]
            self.registers[i + 4][self.step] = self.registers[i][prev]
        self._copy_state(8)

    def _op_roll4(self, hint):
        assert self.depth >= 4, f"stack underflow at step {self.step}"
        prev = self.step - 1
        self.registers[0][self.step] = self.registers[3][prev]
        for i in range(3):
            self.registers[i + 1][self.step] = self.registers[i][prev]
        self._copy_state(4)

    def _op_roll8(self, hint):
        assert self.depth >= 8, f"stack underflow at step {self.step}"
        prev = self.step - 1
        self.registers[0][self.step] = self.registers[7][prev]
        for i in range(7):
            self.registers[i + 1][self.step] = self.registers[i][prev]
        self._copy_state(8)

    # selection -----------------------------------------------------------------------------------

    def _op_choose(self, hint):
        assert self.depth >= 3, f"stack underflow at step {self.step}"
        prev = self.step - 1
        condition = self.registers[2][prev]
        if condition == 1:
            self.registers[0][self.step] = self.registers[0][prev]
        elif condition == 0:
            self.registers[0][self.step] = self.registers[1][prev]
        else:
            raise AssertionError(f"CHOOSE on a non-binary condition at step {self.step}")
        self._shift_left(3, 2)

    def _op_choose2(self, hint):
        assert self.depth >= 6, f"stack underflow at step {self.step}"
        prev = self.step - 1
        condition = self.registers[4][prev]
        if condition == 1:
            self.registers[0][self.step] = self.registers[0][prev]
            self.registers[1][self.step] = self.registers[1][prev]
        elif condition == 0:
            self.registers[0][self.step] = self.registers[2][prev]
            self.registers[1][self.step] = self.registers[3][prev]
        else:
            raise AssertionError(f"CHOOSE2 on a non-binary condition at step {self.step}")
        self._shift_left(6, 4)

    def _op_cswap2(self, hint):
        assert self.depth >= 6, f"stack underflow at step {self.step}"
        prev = self.step - 1
        condition = self.registers[4][prev]
        if condition == 0:
            for i in range(4):
                self.registers[i][self.step] = self.registers[i][prev]
        elif condition == 1:
            self.registers[0][self.step] = self.registers[2][prev]
            self.registers[1][self.step] = self.registers[3][prev]
            self.registers[2][self.step] = self.registers[0][prev]
            self.registers[3][self.step] = self.registers[1][prev]
        else:
            raise AssertionError(f"CSWAP2 on a non-binary condition at step {self.step}")
        self._shift_left(6, 2)

    # arithmetic / boolean ------------------------------------------------------------------------

    def _op_add(self, hint):
        assert self.depth >= 2, f"stack underflow at step {self.step}"
        prev = self.step - 1
        x, y = self.registers[0][prev], self.registers[1][prev]
        self.registers[0][self.step] = field.add(x, y)
        self._shift_left(2, 1)

    def _op_mul(self, hint):
        assert self.depth >= 2, f"stack underflow at step {self.step}"
        prev = self.step - 1
        x, y = self.registers[0][prev], self.registers[1][prev]
        self.registers[0][self.step] = field.mul(x, y)
        self._shift_left(2, 1)

    def _op_inv(self, hint):
        assert self.depth >= 1, f"stack underflow at step {self.step}"
        x = self.registers[0][self.step - 1]
        assert x != 0, f"cannot compute INV of 0 at step {self.step}"
        self.registers[0][self.step] = field.inv(x)
        self._copy_state(1)

    def _op_neg(self, hint):
        assert self.depth >= 1, f"stack underflow at step {self.step}"
        self.registers[0][self.step] = field.neg(self.registers[0][self.step - 1])
        self._copy_state(1)

    def _op_not(self, hint):
        assert self.depth >= 1, f"stack underflow at step {self.step}"
        x = self.registers[0][self.step - 1]
        assert x in (0, 1), f"cannot compute NOT of a non-binary value at step {self.step}"
        self.registers[0][self.step] = 1 - x
        self._copy_state(1)

    def _op_and(self, hint):
        assert self.depth >= 2, f"stack underflow at step {self.step}"
        prev = self.step - 1
        x, y = self.registers[0][prev], self.registers[1][prev]
        assert x in (0, 1) and y in (0, 1), (
            f"cannot compute AND for a non-binary value at step {self.step}"
        )
        self.registers[0][self.step] = 1 if (x == 1 and y == 1) else 0
        self._shift_left(2, 1)

    def _op_or(self, hint):
        assert self.depth >= 2, f"stack underflow at step {self.step}"
        prev = self.step - 1
        x, y = self.registers[0][prev], self.registers[1][prev]
        assert x in (0, 1) and y in (0, 1), (
            f"cannot compute OR for a non-binary value at step {self.step}"
        )
        self.registers[0][self.step] = 1 if (x == 1 or y == 1) else 0
        self._shift_left(2, 1)

    # comparisons ---------------------------------------------------------------------------------

    def _op_eq(self, hint):
        assert self.depth >= 3, f"stack underflow at step {self.step}"
        prev = self.step - 1
        aux = self.registers[0][prev]
        x, y = self.registers[1][prev], self.registers[2][prev]
        if x == y:
            self.registers[0][self.step] = 1
        else:
            diff = field.sub(x, y)
            assert aux == field.inv(diff), f"invalid AUX value for EQ at step {self.step}"
            self.registers[0][self.step] = 0
        self._shift_left(3, 2)

    def _op_cmp(self, hint):
        if hint.kind == "cmp_start":
            assert self.depth >= 10, f"stack underflow at step {self.step}"
            a_val = self.registers[8][self.step - 1]
            b_val = self.registers[9][self.step - 1]
            for i in range(hint.value):
                self.tape_a.append((a_val >> i) & 1)
                self.tape_b.append((b_val >> i) & 1)
        elif hint.kind == "none":
            assert self.depth >= 8, f"stack underflow at step {self.step}"
            assert self.tape_a, f"attempt to read from empty tape A at step {self.step}"
            assert self.tape_b, f"attempt to read from empty tape B at step {self.step}"
        else:
            raise ValueError(f"hint {hint.kind} is not valid for CMP operation")

        a_bit = self.tape_a.pop()
        assert a_bit in (0, 1), f"expected binary input at step {self.step}"
        b_bit = self.tape_b.pop()
        assert b_bit in (0, 1), f"expected binary input at step {self.step}"

        bit_gt = a_bit * (1 - b_bit)
        bit_lt = b_bit * (1 - a_bit)

        prev = self.step - 1
        power_of_two = self.registers[0][prev]
        assert power_of_two & (power_of_two - 1) == 0 and power_of_two != 0, (
            f"expected top of the stack at step {self.step} to be a power of 2"
        )
        next_power_of_two = field.div(power_of_two, 2) if power_of_two == 1 else power_of_two >> 1

        gt = self.registers[4][prev]
        lt = self.registers[5][prev]
        not_set = field.mul(field.sub(1, gt), field.sub(1, lt))

        self.registers[0][self.step] = next_power_of_two
        self.registers[1][self.step] = a_bit
        self.registers[2][self.step] = b_bit
        self.registers[3][self.step] = not_set
        self.registers[4][self.step] = field.add(gt, field.mul(bit_gt, not_set))
        self.registers[5][self.step] = field.add(lt, field.mul(bit_lt, not_set))
        self.registers[6][self.step] = field.add(self.registers[6][prev], field.mul(b_bit, power_of_two))
        self.registers[7][self.step] = field.add(self.registers[7][prev], field.mul(a_bit, power_of_two))
        self._copy_state(8)

    def _op_binacc(self, hint):
        if hint.kind == "rc_start":
            assert self.depth >= 5, f"stack underflow at step {self.step}"
            val = self.registers[4][self.step - 1]
            n = hint.value
            for i in range(n):
                self.tape_a.append((val >> (n - i - 1)) & 1)  # MSB first
        elif hint.kind == "none":
            assert self.depth >= 4, f"stack underflow at step {self.step}"
            assert self.tape_a, f"attempt to read from empty tape A at step {self.step}"
        else:
            raise ValueError(f"hint {hint.kind} is not valid for BINACC operation")

        bit = self.tape_a.pop()
        assert bit in (0, 1), f"expected binary input at step {self.step}"

        prev = self.step - 1
        power_of_two = self.registers[2][prev]
        assert power_of_two & (power_of_two - 1) == 0 and power_of_two != 0, (
            f"expected 3rd value from the top at step {self.step} to be a power of 2"
        )
        self.registers[0][self.step] = bit
        self.registers[1][self.step] = 0
        self.registers[2][self.step] = field.mul(power_of_two, 2)
        self.registers[3][self.step] = field.add(self.registers[3][prev], field.mul(bit, power_of_two))
        self._copy_state(4)

    # crypto --------------------------------------------------------------------------------------

    def _op_rescr(self, hint):
        assert self.depth >= HASH_STATE_WIDTH, f"stack underflow at step {self.step}"
        prev = self.step - 1
        state = [self.registers[i][prev] for i in range(HASH_STATE_WIDTH)]
        hasher.apply_round(state, prev)
        for i in range(HASH_STATE_WIDTH):
            self.registers[i][self.step] = state[i]
        self._copy_state(HASH_STATE_WIDTH)

    # register plumbing ---------------------------------------------------------------------------

    def _copy_state(self, start):
        prev = self.step - 1
        for i in range(start, self.depth):
            self.registers[i][self.step] = self.registers[i][prev]

    def _shift_left(self, start, pos_count):
        assert self.depth >= pos_count, f"stack underflow at step {self.step}"
        prev = self.step - 1
        for i in range(start, self.depth):
            self.registers[i - pos_count][self.step] = self.registers[i][prev]
        for i in range(self.depth - pos_count, self.depth):
            self.registers[i][self.step] = 0
        self.depth -= pos_count

    def _shift_right(self, start, pos_count):
        self.depth += pos_count
        assert self.depth <= MAX_STACK_DEPTH, f"stack overflow at step {self.step}"
        if self.depth > self.max_depth:
            self.max_depth += pos_count
            while self.max_depth > len(self.registers):
                self.registers.append([0] * self.trace_length())
        prev = self.step - 1
        for i in range(self.depth - pos_count - 1, start - 1, -1):
            self.registers[i + pos_count][self.step] = self.registers[i][prev]

    def _advance_step(self):
        self.step += 1
        if self.step >= self.trace_length():
            new_length = self.trace_length() * 2
            for register in self.registers:
                register.extend([0] * (new_length - len(register)))


_DISPATCH = {
    OpCode.Begin: Stack._op_noop,
    OpCode.Noop: Stack._op_noop,
    OpCode.Assert: Stack._op_assert,
    OpCode.AssertEq: Stack._op_asserteq,
    OpCode.Push: Stack._op_push,
    OpCode.Read: Stack._op_read,
    OpCode.Read2: Stack._op_read2,
    OpCode.Dup: Stack._op_dup,
    OpCode.Dup2: Stack._op_dup2,
    OpCode.Dup4: Stack._op_dup4,
    OpCode.Pad2: Stack._op_pad2,
    OpCode.Drop: Stack._op_drop,
    OpCode.Drop4: Stack._op_drop4,
    OpCode.Swap: Stack._op_swap,
    OpCode.Swap2: Stack._op_swap2,
    OpCode.Swap4: Stack._op_swap4,
    OpCode.Roll4: Stack._op_roll4,
    OpCode.Roll8: Stack._op_roll8,
    OpCode.Choose: Stack._op_choose,
    OpCode.Choose2: Stack._op_choose2,
    OpCode.CSwap2: Stack._op_cswap2,
    OpCode.Add: Stack._op_add,
    OpCode.Mul: Stack._op_mul,
    OpCode.Inv: Stack._op_inv,
    OpCode.Neg: Stack._op_neg,
    OpCode.Not: Stack._op_not,
    OpCode.And: Stack._op_and,
    OpCode.Or: Stack._op_or,
    OpCode.Eq: Stack._op_eq,
    OpCode.Cmp: Stack._op_cmp,
    OpCode.BinAcc: Stack._op_binacc,
    OpCode.RescR: Stack._op_rescr,
}
