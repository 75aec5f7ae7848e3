"""Merkle trees over 32-byte values with de-duplicated batch openings.

Semantics (tree layout, proof structure, node de-duplication order) are
compatible with the reference (reference src/crypto/merkle.rs) because batch
proofs are serialized into the STARK proof and must round-trip bit-exactly.

Internal nodes live in a flat array with the root at index 1; node i has
children 2i and 2i+1.  Tree construction hashes all sibling pairs of a level
in one batched call (native blake3 / any registered hash), which is the
device-friendly formulation of the reference's sequential loop
(reference src/crypto/merkle.rs:269-294).
"""

import numpy as np

from .blake3 import blake3_batch
from . import hashes as _hashes


def hash_leaves(rows: np.ndarray, hash_name: str) -> np.ndarray:
    """(N, k) byte rows -> (N, 32) leaf digests, one host hash call a row
    (the reference hashes each row with the proof's hash function)."""
    hash_fn = _hashes.HASH_FUNCTIONS[hash_name]
    out = np.empty((rows.shape[0], 32), dtype=np.uint8)
    for i in range(rows.shape[0]):
        out[i] = np.frombuffer(hash_fn(rows[i].tobytes()), dtype=np.uint8)
    return out


def _hash_pairs(level: np.ndarray, hash_name: str) -> np.ndarray:
    """Hash (N, 64) byte rows -> (N/2, 32): parents of a level of nodes."""
    pairs = level.reshape(-1, 64)
    if hash_name == "blake3":
        return blake3_batch(pairs)
    return hash_leaves(pairs, hash_name)


def build_merkle_nodes(leaves: np.ndarray, hash_name: str) -> np.ndarray:
    """Build internal nodes for (N, 32) uint8 leaves; nodes[1] is the root."""
    if hash_name == "blake3":
        from .. import native
        return native.merkle_nodes(leaves)
    n = leaves.shape[0] // 2
    nodes = np.zeros((2 * n, 32), dtype=np.uint8)
    # first row of internal nodes: parents of the leaves
    nodes[n:] = _hash_pairs(leaves, hash_name)
    # remaining levels, bottom-up; each level is one batched hash call
    size = n
    while size > 1:
        size //= 2
        nodes[size : 2 * size] = _hash_pairs(nodes[2 * size : 4 * size], hash_name)
    return nodes


class BatchMerkleProof:
    """Openings for several indexes with shared internal nodes de-duplicated."""

    def __init__(self, values, nodes, depth):
        self.values = values  # list[bytes(32)] - leaf values for requested indexes
        self.nodes = nodes    # list[list[bytes(32)]] - per normalized index
        self.depth = depth

    def __eq__(self, other):
        return (
            self.values == other.values
            and self.nodes == other.nodes
            and self.depth == other.depth
        )


class MerkleTree:
    def __init__(self, leaves, hash_name: str = "blake3"):
        if isinstance(leaves, list):
            leaves = np.array([np.frombuffer(v, dtype=np.uint8) for v in leaves])
        n = leaves.shape[0]
        assert n >= 2 and n & (n - 1) == 0, "number of leaves must be a power of 2, >= 2"
        self.hash_name = hash_name
        self.values = leaves
        self.nodes = build_merkle_nodes(leaves, hash_name)

    def root(self) -> bytes:
        return self.nodes[1].tobytes()

    def leaves(self):
        return self.values

    def leaf(self, index) -> bytes:
        return self.values[index].tobytes()

    # single openings ----------------------------------------------------------------------------

    def prove(self, index):
        proof = [self.leaf(index), self.leaf(index ^ 1)]
        index = (index + len(self.nodes)) >> 1
        while index > 1:
            proof.append(self.nodes[index ^ 1].tobytes())
            index >>= 1
        return proof

    @staticmethod
    def verify(root: bytes, index, proof, hash_name: str = "blake3"):
        hash_fn = _hashes.HASH_FUNCTIONS[hash_name]
        r = index & 1
        v = hash_fn(proof[r] + proof[1 - r])
        index = (index + (1 << (len(proof) - 1))) >> 1
        for node in proof[2:]:
            if index & 1 == 0:
                v = hash_fn(v + node)
            else:
                v = hash_fn(node + v)
            index >>= 1
        return v == root

    # batch openings -----------------------------------------------------------------------------

    def prove_batch_async(self, indexes, batch=None):
        """Host trees have nothing in flight; API parity with the device
        trees' pending-proof protocol (`batch` is ignored - no device
        arrays to transfer)."""
        proof = self.prove_batch(indexes)
        return type("_Ready", (), {"result": lambda _self: proof})()

    def prove_batch(self, indexes) -> BatchMerkleProof:
        n = self.values.shape[0]
        index_map = _map_indexes(indexes, n - 1)
        norm_indexes = _normalize_indexes(indexes)
        values = [b""] * len(index_map)
        nodes = []

        # leaf layer: include requested leaves in `values`, siblings in `nodes`
        next_indexes = []
        for index in norm_indexes:
            v1 = self.leaf(index)
            v2 = self.leaf(index + 1)
            i1 = index_map.get(index)
            i2 = index_map.get(index + 1)
            if i1 is not None:
                if i2 is not None:
                    values[i1] = v1
                    values[i2] = v2
                    nodes.append([])
                else:
                    values[i1] = v1
                    nodes.append([v2])
            else:
                values[i2] = v2
                nodes.append([v1])
            next_indexes.append((index + n) >> 1)

        # internal layers: add sibling nodes unless the sibling is itself on the path
        depth = n.bit_length() - 1
        for _ in range(1, depth):
            indexes, next_indexes = next_indexes, []
            i = 0
            while i < len(indexes):
                sibling_index = indexes[i] ^ 1
                if i + 1 < len(indexes) and indexes[i + 1] == sibling_index:
                    i += 1
                else:
                    nodes[i].append(self.nodes[sibling_index].tobytes())
                next_indexes.append(sibling_index >> 1)
                i += 1

        return BatchMerkleProof(values, nodes, depth)

    @staticmethod
    def verify_batch(root: bytes, indexes, proof: BatchMerkleProof, hash_name: str = "blake3"):
        hash_fn = _hashes.HASH_FUNCTIONS[hash_name]
        v = {}

        offset = 1 << proof.depth
        index_map = _map_indexes(indexes, offset - 1)
        norm_indexes = _normalize_indexes(indexes)
        if len(norm_indexes) != len(proof.nodes):
            return False

        # hash leaf pairs into their parents
        next_indexes = []
        proof_pointers = []
        for i, index in enumerate(norm_indexes):
            i1 = index_map.get(index)
            i2 = index_map.get(index + 1)
            if i1 is not None:
                if len(proof.values) <= i1:
                    return False
                left = proof.values[i1]
                if i2 is not None:
                    if len(proof.values) <= i2:
                        return False
                    right = proof.values[i2]
                    proof_pointers.append(0)
                else:
                    if len(proof.nodes[i]) < 1:
                        return False
                    right = proof.nodes[i][0]
                    proof_pointers.append(1)
            else:
                if len(proof.nodes[i]) < 1:
                    return False
                left = proof.nodes[i][0]
                if i2 is None:
                    return False
                if len(proof.values) <= i2:
                    return False
                right = proof.values[i2]
                proof_pointers.append(1)

            parent = hash_fn(left + right)
            parent_index = (offset + index) >> 1
            v[parent_index] = parent
            next_indexes.append(parent_index)

        # iterate up to the root
        for _ in range(1, proof.depth):
            indexes, next_indexes = next_indexes, []
            i = 0
            while i < len(indexes):
                node_index = indexes[i]
                sibling_index = node_index ^ 1
                if i + 1 < len(indexes) and indexes[i + 1] == sibling_index:
                    sibling = v.get(sibling_index)
                    if sibling is None:
                        return False
                    i += 1
                else:
                    pointer = proof_pointers[i]
                    if len(proof.nodes[i]) <= pointer:
                        return False
                    sibling = proof.nodes[i][pointer]
                    proof_pointers[i] += 1

                node = v.get(node_index)
                if node is None:
                    return False
                if node_index & 1:
                    parent = hash_fn(sibling + node)
                else:
                    parent = hash_fn(node + sibling)

                parent_index = node_index >> 1
                v[parent_index] = parent
                next_indexes.append(parent_index)
                i += 1

        return v.get(1) == root


def _map_indexes(indexes, max_valid):
    index_map = {}
    for i, index in enumerate(indexes):
        index_map[index] = i
        assert index <= max_valid, f"invalid index {index}"
    assert len(indexes) == len(index_map), "repeating indexes detected"
    return index_map


def _normalize_indexes(indexes):
    return sorted({index & ~1 for index in indexes})
