"""Tensor arithmetic in the 128-bit field M = 2^128 - 45*2^40 + 1.

The port's counterpart of distaff_tpu/math/field_jax.py.  A field element
is four little-endian uint32 limbs in the trailing axis of a
``torch.uint32`` tensor of shape ``(..., 4)``, the layout of the JAX
arrays.  The elementwise arithmetic is kernel K2 (ops/field_kernels.py):
on the card every add, sub, mul and exp_const is one launch, on the CPU
it is the kernel's plain version; the batch inverse is kernel K6 and the
power series kernel K12.  Scans and reductions here are log-depth
sequences of K2 launches plus PyTorch data movement.

Every function returns canonical values (< M), bit-identical to
field_jax on the same inputs.
"""

import numpy as np
import torch

from . import field as hostfield
from ..interop import limbs_from_numpy, limbs_to_numpy
from ..ops import field_kernels as fk

M = hostfield.M


# ------------------------------------------------------------------------------------------------
# conversions
# ------------------------------------------------------------------------------------------------

def from_ints(values, device):
    """Python ints / numpy object array -> (..., 4) uint32 limb tensor."""
    arr = np.asarray(values, dtype=object)
    limbs = [((arr >> (32 * k)) & 0xFFFFFFFF).astype(np.uint32) for k in range(4)]
    return limbs_from_numpy(np.stack(limbs, axis=-1), device)


def to_ints(limbs):
    """(..., 4) uint32 limb tensor or numpy array -> numpy object array of ints."""
    if torch.is_tensor(limbs):
        limbs = limbs_to_numpy(limbs)
    arr = np.asarray(limbs).astype(object)
    return arr[..., 0] | (arr[..., 1] << 32) | (arr[..., 2] << 64) | (arr[..., 3] << 96)


def zeros(shape, device):
    return torch.zeros(tuple(shape) + (4,), dtype=torch.uint32, device=device)


def constant(value, device):
    """One field element as a (4,) limb tensor."""
    v = int(value) % M
    limbs = np.array([(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)], dtype=np.uint32)
    return limbs_from_numpy(limbs, device)


# ------------------------------------------------------------------------------------------------
# elementwise arithmetic: kernel K2
# ------------------------------------------------------------------------------------------------

add = fk.add
sub = fk.sub
mul = fk.mul
exp_const = fk.exp_const


def neg(a):
    return sub(zeros((), a.device), a)


# elementwise inverse, zero to zero: kernel K6 (Montgomery's trick per block)
inv_batch = fk.inv_batch


# ------------------------------------------------------------------------------------------------
# scans and reductions
# ------------------------------------------------------------------------------------------------

def cumsum(a, axis=0):
    """Inclusive modular prefix sums along an axis: log2(n) doubling steps
    (Hillis-Steele), one add launch each."""
    x = a.movedim(axis, 0)
    n, k = x.shape[0], 1
    while k < n:
        x = torch.cat([x[:k], add(x[k:], x[:-k])])
        k <<= 1
    return x.movedim(0, axis)


def sum_reduce(a, axis=0):
    """Modular sum along an axis (log-depth tree of adds)."""
    x = a.movedim(axis, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        s = add(x[:half], x[half : 2 * half])
        if x.shape[0] % 2:
            s = torch.cat([s, x[2 * half :]])
        x = s
    return x[0]


# [c x^0 .. c x^(n-1)] for host ints x and c: kernel K12, one launch
power_series = fk.power_series


def _bitrev_indices(n):
    """Bit-reversal permutation indices, vectorized on host."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    rev = np.zeros_like(idx)
    for _ in range(bits):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev.astype(np.int32)
