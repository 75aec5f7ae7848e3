"""distaff_torch BLAKE3 rows and device Merkle trees (kernel K3's plain
version on the CPU) against the JAX package: exact equality."""

import numpy as np
import pytest

from distaff_tpu.crypto.merkle import MerkleTree
from distaff_tpu.ops import blake3_jax
from distaff_torch.crypto import hashes as torch_hashes
from distaff_torch.crypto.blake3 import blake3 as spec_blake3
from distaff_torch.crypto.merkle_dev import DeviceMerkleTree
from distaff_torch.interop import limbs_from_numpy, limbs_to_numpy
from distaff_torch.ops import blake3_torch

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
