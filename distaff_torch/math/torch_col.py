"""TorchCol: field columns behind int-like operators, plus batched helpers.

The port's counterpart of distaff_tpu/math/jax_col.py.  The polymorphic AIR
(stark/constraints/) is written as plain ``(a*b) % M`` expressions; TorchCol
lets that single source run over whole (n, 4) uint32 limb columns at once.
The structured hot spots (op-flag products, MDS applications, stack shift
checks, linear combinations) go through the stacked helpers below: one
(k, n, 4) multiply instead of k column multiplies, with identical field
values.

Every operation here is a PLAIN version (field_kernels.add_plain, sub_plain,
mul_plain, in int64 lanes): TorchCol is the vehicle of kernel K4's plain
version (stark/constraints/device_eval.transition_plain), and on the card
that version must share no code with any kernel.
"""

import functools

import numpy as np
import torch

from . import field as hostfield
from . import field_torch as ft
from ..ops.field_kernels import add_plain, sub_plain, mul_plain

M = hostfield.M


@functools.lru_cache(maxsize=None)
def _constant(value, device):
    return ft.constant(value, device)


class TorchCol:
    """A column of field elements ((n, 4) uint32 limbs) behind the int-like
    operators the polymorphic AIR expects.  Python-int operands coerce to
    broadcast limb constants; every operation reduces mod M."""

    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t

    def _coerce(self, other):
        if isinstance(other, TorchCol):
            return other.t
        if isinstance(other, (int, np.integer)):
            return _constant(int(other) % M, self.t.device)
        return None

    def __add__(self, other):
        o = self._coerce(other)
        return NotImplemented if o is None else TorchCol(add_plain(self.t, o))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return NotImplemented if o is None else TorchCol(sub_plain(self.t, o))

    def __rsub__(self, other):
        o = self._coerce(other)
        return NotImplemented if o is None else TorchCol(sub_plain(o, self.t))

    def __mul__(self, other):
        o = self._coerce(other)
        return NotImplemented if o is None else TorchCol(mul_plain(self.t, o))

    __rmul__ = __mul__

    def __mod__(self, modulus):
        assert modulus == M
        return self


def is_col(*values):
    """True if any value is a TorchCol (the AIR's batched-path dispatch)."""
    return any(isinstance(v, TorchCol) for v in values)


def _first_col(values):
    for v in values:
        if isinstance(v, TorchCol):
            return v.t
    raise TypeError("no TorchCol operand")


def as_tensor(value, like):
    """TorchCol or Python int -> (n, 4) limbs shaped like the column `like`."""
    if isinstance(value, TorchCol):
        return value.t.expand(like.shape)
    return _constant(int(value) % M, like.device).expand(like.shape)


def stack_cols(values):
    """list of TorchCol/int -> (k, n, 4) limbs."""
    like = _first_col(values)
    return torch.stack([as_tensor(v, like) for v in values])


def unstack(t):
    return [TorchCol(t[i]) for i in range(t.shape[0])]


def sum_plain(t, axis=0):
    """Modular sum along an axis, a log-depth tree of plain adds."""
    x = t.movedim(axis, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        s = add_plain(x[:half], x[half : 2 * half])
        if x.shape[0] % 2:
            s = torch.cat([s, x[2 * half :]])
        x = s
    return x[0]


def mul_flag(flag, values):
    """flag * values[i] for every i with ONE batched multiply -> list[TorchCol]."""
    stacked = stack_cols([flag] + list(values))
    return unstack(mul_plain(stacked[1:], stacked[:1]))


def pow3_all(values):
    """[v^3 for v] with two batched multiplies."""
    s = stack_cols(values)
    return unstack(mul_plain(mul_plain(s, s), s))


def mds_apply(state, mds, width):
    """MDS matrix (Python ints, row-major width x width) times a state vector
    of TorchCol/int -> list[TorchCol]; one batched multiply and a log-depth
    sum."""
    s = stack_cols(state)                                           # (w, n, 4)
    m = _constant_matrix(tuple(mds), width, s.device)               # (w, w, 4)
    return unstack(sum_plain(mul_plain(m[:, :, None, :], s[None]), axis=1))


@functools.lru_cache(maxsize=None)
def _constant_matrix(mds, width, device):
    return ft.from_ints(np.array(mds, dtype=object).reshape(width, width), device)


def weighted_sum(values, weights):
    """sum_i weights[i] * values[i] for (k, 4) limb weights, with one batched
    multiply and a log-depth sum -> TorchCol."""
    s = stack_cols(values)
    return TorchCol(sum_plain(mul_plain(s, weights[:, None, :]), axis=0))
