"""Batch Merkle openings over 32-byte values with de-duplicated nodes:
their verification (reference src/crypto/merkle.rs).

Internal nodes are numbered with the root at index 1; node i has children 2i
and 2i+1.
"""

from . import hashes as _hashes

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
