"""distaff_torch BLAKE3 rows and device Merkle trees (kernel K3's and
kernel K13's plain versions on the CPU) against the JAX package, and K13's
body (csrc/merkle_tree.cuh, on blake3.cuh's compression) built with g++ and
run a block and a level at a time, its blocks in order, reversed and
shuffled: exact equality."""

import ctypes
import subprocess
from pathlib import Path

import jax.numpy as jnp
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

// K13's one launch on the CPU: its blocks one at a time in `order`, each as
// the kernel runs it: its subtree of stage 0 a level at a time (every
// thread's nodes of a level before any of the next: the barrier), then
// thread 0's ticket, and the group's subtree of the next stage where the
// ticket was the last.  Returns the counters left non-zero, or -1 for a
// plan the launch refuses.
extern "C" int merkle_tree_launch_host(const void* leaves, void* nodes, int* counters,
                                       long long n, int stages, const int* levels,
                                       const long long* order) {
    mt::Args a{(const uint4*)leaves, (uint4*)nodes, counters, n, 0, {}, {}, {}};
    if (!mt::set_plan(a, stages, levels)) return -1;
    const int largest = mt::largest_stage(a);
    std::vector<uint4> odd(2 * mt::odd_nodes(largest) + 1), even(2 * mt::even_nodes(largest) + 1);
    const int threads = mt::block_threads(a);
    long long groups = 0;
    for (int s = 1; s < stages; ++s) groups += a.inputs[s] >> a.levels[s];
    for (long long i = 0; i < mt::blocks(a); ++i) {
        long long g = order[i];
        for (int t = 0; t < threads; ++t) mt::clear_row0(a, g, t);
        for (int s = 0;; ++s) {
            const int levels = a.levels[s];
            for (int level = 1; level <= levels; ++level) {
                const uint4* below = (level & 1) ? even.data() : odd.data();
                uint4* above = (level & 1) ? odd.data() : even.data();
                for (int t = 0; t < threads; ++t)
                    for (int p = t; p < mt::level_nodes(levels, level); p += threads)
                        mt::node(a, s, g, level, p, below, above);
            }
            if (s + 1 == stages || !mt::arrive(a, s, g)) break;
            g >>= a.levels[s + 1];
        }
    }
    int left = 0;
    for (long long k = 0; k < groups; ++k) left += counters[k] != 0;
    return left;
}

extern "C" int merkle_tree_slot(int u) { return mt::slot(u); }

// blake3.cuh's compression on the FMA pipe's adds (FmaAdds, with one = 1)
// or the compiler's (AluAdds), and the node hash
extern "C" void compress_host(uint32_t* cv, const uint32_t* m, unsigned long long counter,
                              uint32_t block_len, uint32_t flags, int fma) {
    uint32_t msg[16];
    for (int i = 0; i < 16; ++i) msg[i] = m[i];
    const blake3::AluAdds alu;
    if (fma)
        blake3::compress(cv, msg, counter, block_len, flags);
    else
        blake3::compress(cv, msg, counter, block_len, flags, alu, alu, alu);
}

extern "C" void hash_block_host(uint32_t* cv, const uint32_t* m) {
    uint32_t msg[16];
    for (int i = 0; i < 16; ++i) msg[i] = m[i];
    blake3::hash_block(cv, msg);
}
"""


@pytest.fixture(scope="module")
def k13_body(tmp_path_factory):
    """csrc/merkle_tree.cuh built with g++ as a host function of one launch."""
    tmp = tmp_path_factory.mktemp("k13")
    (tmp / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(CSRC),
                    str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")], check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    lib.merkle_tree_launch_host.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.merkle_tree_slot.argtypes = [ctypes.c_int]
    lib.compress_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
                                  ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
    lib.hash_block_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


# the H100's SMs: tree_plan's plans for it
SMS = 132


def _k13(lib, leaves, plan, order="in order"):
    """K13's launch for these (N, 8) leaves under `plan`, run by the host
    harness with its blocks in order, reversed or in a seeded random order;
    every counter must be back at 0."""
    n = leaves.shape[0]
    nodes = torch.full((n, 8), 0xDEADBEEF, dtype=torch.uint32)   # every row must be written
    counters = torch.zeros(max(blake3_torch.tree_groups(n, plan), 1), dtype=torch.int32)
    blocks = n >> plan[0]
    sequence = {"in order": np.arange(blocks), "reversed": np.arange(blocks)[::-1],
                "random": np.random.default_rng(n + len(plan)).permutation(blocks)}[order]
    sequence = np.ascontiguousarray(sequence, dtype=np.int64)
    left = lib.merkle_tree_launch_host(
        leaves.data_ptr(), nodes.data_ptr(), counters.data_ptr(), n, len(plan),
        (ctypes.c_int * len(plan))(*plan), sequence.ctypes.data)
    assert left == 0, f"{left} counters not back at 0 (or the plan refused)"
    return nodes


def _plan(n, kind):
    """The plan the wrapper picks for the H100, the smallest subtrees (one
    level a stage) or the largest bottom subtrees (2^11 leaves)."""
    return {"planned": blake3_torch.tree_plan(n, SMS),
            "smallest": [1] * (n.bit_length() - 1),
            "largest": blake3_torch.tree_plan(n, SMS, blocks_per_sm=0)}[kind]


def _even_plan(n, levels):
    """Stages of `levels` levels from the leaves up, the rest at the top."""
    total = n.bit_length() - 1
    return [levels] * (total // levels) + ([total % levels] if total % levels else [])


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


@pytest.mark.parametrize("order", ["in order", "reversed", "random"])
@pytest.mark.parametrize("plan", ["planned", "smallest", "largest"])
@pytest.mark.parametrize("n", [2, 1 << 5, 1 << 11, 1 << 12, 1 << 13])
def test_k13_body_matches_jax_flat_nodes(k13_body, jax_flat_nodes, n, plan, order):
    words, want = jax_flat_nodes(n)
    leaves = limbs_from_numpy(words.reshape(n, 2, 4), "cpu").reshape(n, 8)
    got = _k13(k13_body, leaves, _plan(n, plan), order)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(blake3_torch.merkle_tree(leaves), got)      # the plain version


@pytest.mark.parametrize("levels", [2, 3, 4])
def test_k13_body_matches_jax_subtree_nodes(k13_body, levels):
    # 16 subtrees of 16 leaves hashed by the JAX package's fixed-shape
    # subtree kernel; each node at global flat index i >= 16 of K13's tree
    # (whose first two stages at levels = 2, or first at 4, hash exactly
    # those subtrees) is subtree j's local node, by TiledDeviceMerkleTree.
    # _node_split's formula
    sg, subtree = 16, 16
    n = sg * subtree
    words = _words(n, 8, 7)
    local = np.asarray(jax_merkle_dev._build_subtree_nodes(words.reshape(sg, subtree, 8)))
    leaves = limbs_from_numpy(words.reshape(n, 2, 4), "cpu").reshape(n, 8)
    got = _k13(k13_body, leaves, _even_plan(n, levels), "reversed").numpy()
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
    monkeypatch.setattr(merkle_dev, "merkle_tree",
                        lambda leaves: _k13(k13_body, leaves, [3, 3, 3], "random"))
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


def test_k13_body_refuses_plans_that_do_not_cover_the_tree(k13_body):
    leaves = torch.zeros((16, 8), dtype=torch.uint32)
    nodes = torch.zeros((16, 8), dtype=torch.uint32)
    counters = torch.zeros(16, dtype=torch.int32)
    order = np.arange(16, dtype=np.int64)
    for plan in ([3], [2, 3], [12], [0, 4], [5, -1]):
        assert k13_body.merkle_tree_launch_host(
            leaves.data_ptr(), nodes.data_ptr(), counters.data_ptr(), 16, len(plan),
            (ctypes.c_int * len(plan))(*plan), order.ctypes.data) == -1, plan


@pytest.mark.parametrize("log2_n", [1, 5, 7, 9, 10, 11, 13, 15, 17, 19, 20, 21, 23, 25, 27])
def test_tree_plan_covers_the_tree_and_fills_the_card(log2_n):
    # every level once; a tree of up to 2^9 leaves (a node a thread of one
    # block of 256) one stage, else stage 0 at a block an SM or more where
    # the tree has that many nodes, in subtrees of 2^8 to 2^11 leaves; the
    # stages above of at most 11 levels, split evenly
    n = 1 << log2_n
    plan = blake3_torch.tree_plan(n, SMS)
    assert sum(plan) == log2_n and all(1 <= levels <= 11 for levels in plan)
    bottom, upper = plan[0], plan[1:]
    # 2^(log2_n - 8) >= SMS > 2^(log2_n - 9) blocks
    assert bottom == (log2_n if log2_n <= 9 else max(8, min(11, log2_n - 8)))
    assert len(upper) == -(-(log2_n - bottom) // 11)
    assert not upper or max(upper) - min(upper) <= 1
    groups = sum(n >> sum(plan[:s + 1]) for s in range(1, len(plan)))
    assert blake3_torch.tree_groups(n, plan) == groups


@pytest.mark.parametrize("adds", ["compiler's", "FMA pipe's"])
@pytest.mark.parametrize("block_len,flags,counter", [
    (64, 11, 0), (37, 1, 5), (64, 4 | 8, (1 << 33) + 7)])
def test_compression_matches_jax_compress(k13_body, adds, block_len, flags, counter):
    lanes = 8
    cv = _words(8, lanes, block_len + flags)
    m = _words(16, lanes, counter + 1)
    want = np.asarray(blake3_jax._compress(jnp.asarray(cv), jnp.asarray(m), block_len, flags,
                                           counter))
    for lane in range(lanes):
        out = np.ascontiguousarray(cv[:, lane])
        k13_body.compress_host(out.ctypes.data, np.ascontiguousarray(m[:, lane]).ctypes.data,
                               counter, block_len, flags, adds == "FMA pipe's")
        assert np.array_equal(out, want[:, lane]), lane


def test_node_hash_on_the_fma_pipe_matches_the_spec(k13_body):
    # the one-byte spec vector (block length 1 through compress), and the
    # node hash of 64-byte rows against hash_rows_u32 and the spec BLAKE3
    iv = np.array(blake3_torch._IV, dtype=np.uint32)
    cv = iv.copy()
    zeros = np.zeros(16, dtype=np.uint32)
    k13_body.compress_host(cv.ctypes.data, zeros.ctypes.data, 0, 1, 11, 1)
    assert cv.tobytes().hex() == ("2d3adedff11b61f14c886e35afa036736dcd87a74d27b5c1510225d0f592e213")
    rows = _words(ROWS, 16, 5)
    want = np.asarray(blake3_jax.hash_rows_u32(rows, 64))
    for i in range(ROWS):
        cv = np.zeros(8, dtype=np.uint32)
        k13_body.hash_block_host(cv.ctypes.data, np.ascontiguousarray(rows[i]).ctypes.data)
        assert np.array_equal(cv, want[i]) and cv.tobytes() == spec_blake3(rows[i].tobytes())


@pytest.mark.parametrize("shape", [(3, 8), (1, 8), (0, 8), (4, 7), (12, 8)])
def test_merkle_tree_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match="power of two"):
        blake3_torch.merkle_tree(torch.zeros(shape, dtype=torch.uint32))
