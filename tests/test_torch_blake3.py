"""distaff_torch BLAKE3 rows and device Merkle trees (kernel K3's and
kernel K13's plain versions on the CPU) against the JAX package, and K13's
body (csrc/merkle_tree.cuh) built with g++ and run a block and a level at a
time: exact equality."""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from distaff_tpu.crypto import merkle_dev as jax_merkle_dev
from distaff_tpu.crypto.merkle import MerkleTree
from distaff_tpu.ops import blake3_jax
from distaff_torch.crypto import hashes as torch_hashes
from distaff_torch.crypto import merkle_dev
from distaff_torch.crypto.blake3 import blake3 as spec_blake3
from distaff_torch.crypto.merkle_dev import DeviceMerkleTree
from distaff_torch.interop import limbs_from_numpy, limbs_to_numpy
from distaff_torch.ops import blake3_torch

CSRC = Path(blake3_torch.__file__).resolve().parent.parent / "csrc"

ROWS = 16


def _words(n, width, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, width), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("byte_len", [64, 320, 1040])
def test_hash_rows_matches_blake3_jax(byte_len):
    # 1 block, 5 blocks (a 20-register trace row), and 2 chunks (65 registers)
    words = _words(ROWS, byte_len // 4, byte_len)
    want = np.asarray(blake3_jax.hash_rows_u32(words, byte_len))
    port_words = limbs_from_numpy(words.reshape(ROWS, -1, 4), "cpu").reshape(ROWS, -1)
    got = blake3_torch.hash_rows_u32(port_words, byte_len)
    assert np.array_equal(got.numpy(), want)
    assert got[3].numpy().tobytes() == spec_blake3(words[3].tobytes())


def test_trace_rows_hash_in_place():
    # (R, D, 4) LDE rows hashed through a strided view, no transpose
    lde = _words(20 * ROWS, 4, 1).reshape(20, ROWS, 4)
    got = blake3_torch.hash_trace_rows_dev(limbs_from_numpy(lde, "cpu"))
    rows = np.ascontiguousarray(lde.transpose(1, 0, 2)).reshape(ROWS, 80)
    assert np.array_equal(got.numpy(), np.asarray(blake3_jax.hash_rows_u32(rows, 320)))


def test_spec_vector():
    # BLAKE3 spec test vector: one byte 0x00
    want = "2d3adedff11b61f14c886e35afa036736dcd87a74d27b5c1510225d0f592e213"
    assert torch_hashes.blake3(bytes([0])).hex() == want
    assert spec_blake3(bytes([0])).hex() == want


def _trees(n, seed):
    leaves = _words(n, 8, seed)
    host = MerkleTree(leaves.view(np.uint8).reshape(n, 32), "blake3")
    dev = DeviceMerkleTree(limbs_from_numpy(leaves.reshape(n, 2, 4), "cpu").reshape(n, 8))
    return host, dev


@pytest.mark.parametrize("n", [2, 8, 256])
def test_merkle_root_matches_host_tree(n):
    host, dev = _trees(n, n)
    assert dev.root() == host.root()


@pytest.mark.parametrize("indexes", [
    [2], [0, 1], [3, 8, 9, 60], [4, 5, 6, 7], [1, 63, 64, 65, 255],
])
def test_prove_batch_matches_host_tree(indexes):
    host, dev = _trees(256, 11)
    p_host = host.prove_batch(indexes)
    p_dev = dev.prove_batch(indexes)
    assert p_dev.values == p_host.values
    assert p_dev.nodes == p_host.nodes
    assert p_dev.depth == p_host.depth
    assert MerkleTree.verify_batch(dev.root(), indexes, p_dev, "blake3")


def test_flat_nodes_layout():
    # root at row 1, node i's children at rows 2i and 2i+1
    _, dev = _trees(8, 3)
    nodes = limbs_to_numpy(dev.flat_nodes.reshape(8, 2, 4)).reshape(8, 8)
    leaves = dev.values.numpy()
    for i in range(1, 8):
        kids = (nodes[2 * i], nodes[2 * i + 1]) if i < 4 else (leaves[2 * i - 8], leaves[2 * i - 7])
        assert nodes[i].tobytes() == spec_blake3(kids[0].tobytes() + kids[1].tobytes())


# ------------------------------------------------------------------------------------------------
# K13 merkle_tree: its body built with g++, against the JAX package's device trees
# ------------------------------------------------------------------------------------------------

_HARNESS = r"""
#include <vector>
#include "merkle_tree.cuh"

namespace mt = merkle_tree;

// One launch of K13 on the CPU: block by block, and in each block every
// thread's nodes of a level before any of the next (the kernel's barrier).
extern "C" void merkle_tree_launch_host(const void* in, void* nodes, long long m, int levels) {
    const mt::Args a{(const uint4*)in, (uint4*)nodes, m, levels};
    std::vector<uint4> odd(2 * mt::kBufferA), even(2 * mt::kBufferB);
    const int threads = mt::block_threads(a);
    for (long long b = 0; b < mt::blocks(a); ++b) {
        for (int t = 0; t < threads; ++t) mt::clear_row0(a, b, t);
        for (int level = 1; level <= levels; ++level) {
            const uint4* below = (level & 1) ? even.data() : odd.data();
            uint4* above = (level & 1) ? odd.data() : even.data();
            for (int t = 0; t < threads; ++t)
                for (int p = t; p < mt::level_nodes(a, level); p += threads)
                    mt::node(a, b, level, p, below, above);
        }
    }
}

extern "C" int merkle_tree_slot(int u) { return mt::slot(u); }
"""


@pytest.fixture(scope="module")
def k13_body(tmp_path_factory):
    """csrc/merkle_tree.cuh built with g++ as a host function of one launch."""
    tmp = tmp_path_factory.mktemp("k13")
    (tmp / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(CSRC),
                    str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")], check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    lib.merkle_tree_launch_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_longlong, ctypes.c_int]
    lib.merkle_tree_slot.argtypes = [ctypes.c_int]
    return lib


def _k13(lib, leaves, levels):
    """K13's launches for these (N, 8) leaves at subtrees of 2^levels, each
    run by the host harness, as blake3_torch.merkle_tree runs them."""
    n = leaves.shape[0]
    nodes = torch.full((n, 8), 0xDEADBEEF, dtype=torch.uint32)   # every row must be written
    level = leaves
    for m, launch_levels in blake3_torch.tree_launches(n, levels):
        lib.merkle_tree_launch_host(level.data_ptr(), nodes.data_ptr(), m, launch_levels)
        level = nodes[m >> launch_levels : 2 * (m >> launch_levels)]
    return nodes


@pytest.fixture(scope="module")
def jax_flat_nodes():
    """The JAX package's _build_flat_nodes, one jit a leaf count, on
    numpy-seeded leaves: n -> (leaves as numpy words, the flat nodes)."""
    cache = {}

    def get(n):
        if n not in cache:
            leaves = _words(n, 8, 100 + n)
            cache[n] = leaves, np.asarray(jax_merkle_dev._build_flat_nodes(leaves))
        return cache[n]
    return get


@pytest.mark.parametrize("n,levels,launches", [
    (2, 2, 1), (16, 4, 1), (16, 3, 2), (16, 2, 2), (256, 4, 2), (256, 3, 3), (256, 2, 4),
    (4096, 4, 3), (4096, 3, 4),
])
def test_k13_body_matches_jax_flat_nodes(k13_body, jax_flat_nodes, n, levels, launches):
    assert len(blake3_torch.tree_launches(n, levels)) == launches
    words, want = jax_flat_nodes(n)
    leaves = limbs_from_numpy(words.reshape(n, 2, 4), "cpu").reshape(n, 8)
    got = _k13(k13_body, leaves, levels)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(blake3_torch.merkle_tree(leaves), got)      # the plain version


@pytest.mark.parametrize("levels", [2, 3, 4])
def test_k13_body_matches_jax_subtree_nodes(k13_body, levels):
    # 16 subtrees of 16 leaves hashed by the JAX package's fixed-shape
    # subtree kernel; each node at global flat index i >= 16 of K13's tree
    # (whose first launch at levels = 4 hashes exactly those subtrees) is
    # subtree j's local node, by TiledDeviceMerkleTree._node_split's formula
    sg, subtree = 16, 16
    n = sg * subtree
    words = _words(n, 8, 7)
    local = np.asarray(jax_merkle_dev._build_subtree_nodes(words.reshape(sg, subtree, 8)))
    leaves = limbs_from_numpy(words.reshape(n, 2, 4), "cpu").reshape(n, 8)
    got = _k13(k13_body, leaves, levels).numpy()
    cap_levels = sg.bit_length() - 1
    for i in range(sg, n):
        k = i.bit_length() - 1
        p = i - (1 << k)
        kl = k - cap_levels
        j = p >> kl
        assert np.array_equal(got[i], local[j, (1 << kl) + (p & ((1 << kl) - 1))]), i


@pytest.mark.parametrize("indexes", [[5], [0, 1, 2, 3], [7, 100, 101, 511], [1, 510, 511]])
def test_k13_body_roots_and_openings_match_host_tree(k13_body, monkeypatch, indexes):
    n = 512
    words = _words(n, 8, 21)
    host = MerkleTree(words.view(np.uint8).reshape(n, 32), "blake3")
    monkeypatch.setattr(merkle_dev, "merkle_tree", lambda leaves: _k13(k13_body, leaves, 3))
    dev = DeviceMerkleTree(limbs_from_numpy(words.reshape(n, 2, 4), "cpu").reshape(n, 8))
    assert dev.root() == host.root()
    p_host, p_dev = host.prove_batch(indexes), dev.prove_batch(indexes)
    assert (p_dev.values, p_dev.nodes, p_dev.depth) == (p_host.values, p_host.nodes, p_host.depth)
    assert MerkleTree.verify_batch(dev.root(), indexes, p_dev, "blake3")


def test_k13_shared_buffer_swizzle_is_conflict_free(k13_body):
    # the eight lanes of a 16-byte access phase (consecutive nodes p) reach
    # eight different 16-byte bank groups: reading children (slots 4p + j)
    # and writing a node (slots 2p + h); slots stay in their 128-byte row
    slot = k13_body.merkle_tree_slot
    assert sorted(slot(u) for u in range(2048)) == list(range(2048))
    assert all(slot(u) >> 3 == u >> 3 for u in range(2048))
    for first in range(0, 512, 8):
        for j in range(4):
            assert len({slot(4 * p + j) & 7 for p in range(first, first + 8)}) == 8
        for h in range(2):
            assert len({slot(2 * p + h) & 7 for p in range(first, first + 8)}) == 8


@pytest.mark.parametrize("shape", [(3, 8), (1, 8), (0, 8), (4, 7), (12, 8)])
def test_merkle_tree_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match="power of two"):
        blake3_torch.merkle_tree(torch.zeros(shape, dtype=torch.uint32))
