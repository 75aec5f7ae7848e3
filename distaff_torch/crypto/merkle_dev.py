"""Device-resident Merkle trees: every internal node hashed on the card by
kernel K13 in one launch, with only the 32-byte root and the
queried openings crossing to the host.

Semantics (layout, batch-proof node order) are those of
crypto.merkle.MerkleTree and the reference (reference src/crypto/merkle.rs):
internal nodes form a flat array with the root at index 1 and node i's
children at 2i and 2i+1.  Here that array is one (N, 8) uint32 tensor
(ops/blake3_torch.merkle_tree).
"""

import numpy as np

from .merkle import BatchMerkleProof, MerkleTree, _map_indexes, _normalize_indexes, hash_leaves
from ..ops.blake3_torch import hash_rows, merkle_tree
from ..ops.gather import gather_rows_dev
from ..ops.hostsync import TransferBatch


def commit(rows, hash_name, leaves=False):
    """The Merkle tree of one of the prover's commitments, over device
    rows: (N, K, 4) limb rows, each hashed to its leaf, or with `leaves`
    (N, 8) words, the 32-byte leaves themselves.  With blake3 the leaves
    (kernel K3, or K9's digests) and the tree (K13) are hashed on the
    device and stay there; with any other hash
    the rows' bytes (the u128 LE bytes of their limbs) go to the host and
    are hashed there into a crypto.merkle.MerkleTree, as the JAX package
    does (an arithmetic hash takes at most 64 bytes, so it raises on a
    trace row, there as here)."""
    if hash_name == "blake3":
        return DeviceMerkleTree(rows if leaves else hash_rows(rows))
    data = rows.contiguous().cpu().numpy()
    data = data.reshape(data.shape[0], -1).view(np.uint8)
    return MerkleTree(data if leaves else hash_leaves(data, hash_name), hash_name)


class DeviceMerkleTree:
    """blake3 Merkle tree with leaves and internal levels on the device.

    `leaves_u32`: (N, 8) uint32 digest/value rows (32 bytes each, the same
    little-endian u32 word layout the host trees use).
    """

    hash_name = "blake3"

    def __init__(self, leaves_u32):
        n = leaves_u32.shape[0]
        if n < 2 or n & (n - 1):
            raise ValueError("number of leaves must be a power of 2, >= 2")
        self.n = n
        self.values = leaves_u32
        self.flat_nodes = merkle_tree(leaves_u32)
        self._root = self.flat_nodes[1].cpu().numpy().tobytes()

    # interface parity with crypto.merkle.MerkleTree -----------------------------------------------

    def root(self) -> bytes:
        return self._root

    def leaves(self):
        return self.values

    def leaf_count(self):
        return self.n

    def prove_batch_async(self, indexes, batch):
        """Same node-dedup walk as MerkleTree.prove_batch (reference
        merkle.rs:64-124), run over indices only; the 32-byte node values
        come from two device gathers that join the caller's TransferBatch."""
        n = self.n
        index_map = _map_indexes(indexes, n - 1)
        norm_indexes = _normalize_indexes(indexes)

        # leaf layer: which leaves are values and which are sibling nodes
        leaf_fetch = []
        leaf_plan = []
        next_indexes = []
        for index in norm_indexes:
            leaf_fetch.extend((index, index + 1))
            leaf_plan.append((index_map.get(index), index_map.get(index + 1)))
            next_indexes.append((index + n) >> 1)

        # internal layers: record which flat node goes to which proof path
        depth = n.bit_length() - 1
        node_slots = []                               # (norm_i, flat node index)
        walk = next_indexes
        for _ in range(1, depth):
            new_walk = []
            i = 0
            while i < len(walk):
                sibling_index = walk[i] ^ 1
                if i + 1 < len(walk) and walk[i + 1] == sibling_index:
                    i += 1
                else:
                    node_slots.append((i, sibling_index))
                new_walk.append(sibling_index >> 1)
                i += 1
            walk = new_walk

        leaf_ref = batch.add(gather_rows_dev(self.values, leaf_fetch))
        node_ref = (batch.add(gather_rows_dev(self.flat_nodes, [ni for _, ni in node_slots]))
                    if node_slots else None)
        return _PendingBatchProof(batch, index_map, leaf_plan, node_slots,
                                  leaf_ref, node_ref, depth)

    def prove_batch(self, indexes) -> BatchMerkleProof:
        return self.prove_batch_async(indexes, TransferBatch()).result()


def _rows_as_bytes(host_rows):
    return [row.tobytes() for row in host_rows.reshape(-1, 8)]


class _PendingBatchProof:
    """A batch Merkle opening whose rows ride a TransferBatch."""

    def __init__(self, batch, index_map, leaf_plan, node_slots, leaf_ref, node_ref, depth):
        self.batch = batch
        self.index_map = index_map
        self.leaf_plan = leaf_plan
        self.node_slots = node_slots
        self.leaf_ref = leaf_ref
        self.node_ref = node_ref
        self.depth = depth

    def result(self) -> BatchMerkleProof:
        leaf_vals = _rows_as_bytes(self.batch.get(self.leaf_ref))
        values = [b""] * len(self.index_map)
        nodes = []
        for i, (i1, i2) in enumerate(self.leaf_plan):
            v1, v2 = leaf_vals[2 * i], leaf_vals[2 * i + 1]
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

        if self.node_ref is not None:
            fetched = _rows_as_bytes(self.batch.get(self.node_ref))
            for (i, _), value in zip(self.node_slots, fetched):
                nodes[i].append(value)
        return BatchMerkleProof(values, nodes, self.depth)
