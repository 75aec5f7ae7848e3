"""distaff_torch NTTs on the CPU (kernel K1's plain version and the
four-step built on it, kernel K5's plain version and the stage-by-stage
NTT built on it) against the JAX package: exact equality."""

import functools

import numpy as np
import pytest
import torch

from distaff_tpu.math import field as jax_host_field
from distaff_tpu.math import field_jax as fj
from distaff_tpu.math import polynom
from distaff_tpu.ops import field_pallas as fp
from distaff_tpu.ops import tiles as jax_tiles
from distaff_torch.interop import limbs_from_numpy, limbs_to_numpy
from distaff_torch.math import field_torch as ft
from distaff_torch.ops import field_kernels as fk
from distaff_torch.ops import tiles

M = jax_host_field.M
LEAF = 16   # small leaf: transforms above 16 points run the four-step recursion


def _elements(shape, seed):
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, size=tuple(shape) + (4,), dtype=np.uint64)
    limbs[..., 3] %= 0xFFFFFFFF                   # top limb below M's keeps x < M
    return limbs.astype(np.uint32)


def _twiddles(n):
    # from host ints: field_jax.power_series costs an XLA compile per size
    root = jax_host_field.get_root_of_unity(n)
    return limbs_to_numpy(ft.from_ints([pow(root, i, M) for i in range(n // 2)], "cpu"))


def _port(arr):
    return limbs_from_numpy(arr, "cpu")


def test_plain_leaf_matches_pallas_kernel_interpreted():
    n, b = 16, 8
    x, tw = _elements((b, n), 1), _twiddles(n)
    want = fp.leaf_ntt_bm(x, tw, interpret=True)
    got = fk.ntt_leaf(_port(x), _port(tw))
    assert np.array_equal(limbs_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("n,b", [(256, 2), (1024, 1)])
def test_plain_leaf_matches_pease_stages(n, b):
    # the plain reference tests/test_pallas.py holds the Pallas leaf against
    x, tw = _elements((b, n), n), _twiddles(n)
    want = np.asarray(fj._ntt_stages_bm(x, tw))[:, fj._bitrev_indices(n)]
    got = fk.ntt_leaf_plain(_port(x), _port(tw))
    assert np.array_equal(limbs_to_numpy(got), want)


@functools.lru_cache(maxsize=None)
def _jax_tiles_reference(n):
    """Three rows and their forward and inverse transforms by
    distaff_tpu.ops.tiles: one XLA compile per size, shared by the batch
    sizes below."""
    x = _elements((3, n), 100 + n)
    root = jax_host_field.get_root_of_unity(n)
    return x, np.asarray(jax_tiles.ntt_batched(x, root)), np.asarray(jax_tiles.intt_batched(x, root))


@pytest.mark.parametrize("b", [1, 3])
def test_ntt_batched_matches_jax_tiles(b):
    # a two-level four-step (512 = 16 * 32, 32 = 16 * 2) over a batch of b;
    # every size from 2 to 2^12 is held against the host FFT below
    n = 512
    x, fwd, inv = _jax_tiles_reference(n)
    root = jax_host_field.get_root_of_unity(n)
    assert np.array_equal(limbs_to_numpy(tiles.ntt_batched(_port(x[:b]), root, LEAF)), fwd[:b])
    assert np.array_equal(limbs_to_numpy(tiles.intt_batched(_port(x[:b]), root, LEAF)), inv[:b])


@pytest.mark.parametrize("log_n", range(1, 13))
@pytest.mark.parametrize("b", [1, 3])
def test_ntt_batched_matches_host_fft(log_n, b):
    n = 1 << log_n
    x = _elements((b, n), log_n * 7 + b)
    rows = ft.to_ints(x).tolist()
    evals = tiles.ntt_batched(_port(x), jax_host_field.get_root_of_unity(n), LEAF)
    assert ft.to_ints(evals).tolist() == [polynom.eval_fft(r) for r in rows]
    coeffs = tiles.intt_batched(_port(x), None, LEAF)
    assert ft.to_ints(coeffs).tolist() == [polynom.interpolate_fft(r) for r in rows]


def test_butterfly_plain_matches_pallas_kernel_interpreted():
    # kernel K5's plain version against the TPU kernel it replaces
    n = 256
    a, b, w = _elements((n,), 31), _elements((n,), 32), _elements((n,), 33)
    want_even, want_odd = fp.butterfly_stage(a, b, w, interpret=True)
    even, odd = fk.butterfly_stage_plain(_port(a), _port(b), _port(w))
    assert np.array_equal(limbs_to_numpy(even), np.asarray(want_even))
    assert np.array_equal(limbs_to_numpy(odd), np.asarray(want_odd))
    assert all(torch.equal(x, y) for x, y in zip(
        fk.butterfly_stage(_port(a), _port(b), _port(w)), (even, odd)))


@pytest.mark.parametrize("log_n", range(1, 11))
def test_ntt_stagewise_matches_host_fft(log_n):
    n = 1 << log_n
    x = _elements((n,), 200 + log_n)
    got = fk.ntt_stagewise(_port(x))
    assert ft.to_ints(got).tolist() == polynom.eval_fft(ft.to_ints(x).tolist())
