"""Device-resident Merkle trees: every internal node hashed on the card by
kernel K13 in one launch, with only the 32-byte root and the
queried openings crossing to the host.

Semantics (layout, batch-proof node order) are those of
crypto.merkle.MerkleTree and the reference (reference src/crypto/merkle.rs):
internal nodes form a flat array with the root at index 1 and node i's
children at 2i and 2i+1.  Here that array is one (N, 8) uint32 tensor
(ops/blake3_torch.merkle_tree), or, for leaves split over a mesh
(TiledDeviceMerkleTree), one subtree a slot and a cap on the host.
"""

import numpy as np
import torch

from .merkle import (BatchMerkleProof, MerkleTree, _map_indexes, _normalize_indexes,
                     build_merkle_nodes, hash_leaves)
from ..ops.blake3_torch import hash_rows, merkle_tree
from ..ops.gather import gather_rows_dev
from ..ops.hostsync import TransferBatch
from ..parallel.mesh import Sharded


def commit(rows, hash_name, leaves=False):
    """The Merkle tree of one of the prover's commitments, over device
    rows: (N, K, 4) limb rows, each hashed to its leaf, or with `leaves`
    (N, 8) words, the 32-byte leaves themselves.  With blake3 the leaves
    (kernel K3, or K9's digests) and the tree (K13) are hashed on the
    device and stay there; with any other hash
    the rows' bytes (the u128 LE bytes of their limbs) go to the host and
    are hashed there into a crypto.merkle.MerkleTree, as the JAX package
    does (an arithmetic hash takes at most 64 bytes, so it raises on a
    trace row, there as here).  Rows split by rows over a mesh (a
    parallel.mesh.Sharded) are hashed on their slots (K3 on each) into a
    TiledDeviceMerkleTree where the leaves make a subtree a slot, else
    gathered first."""
    if isinstance(rows, Sharded):
        from ..parallel import mesh_stages

        mesh = rows.mesh
        if hash_name == "blake3" and mesh_stages.subtree_fits(rows.share() * mesh.size, mesh):
            if not leaves:
                with mesh.stage():
                    rows = Sharded(mesh, mesh.each(lambda slot, part: hash_rows(part), rows.parts),
                                   0, "rows")
            return TiledDeviceMerkleTree(rows)
        rows = rows.gather()
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

    def _leaf_rows(self, indexes):
        """The leaves at these indexes, (len, 8) on the device."""
        return gather_rows_dev(self.values, indexes)

    def _node_rows(self, node_indexes):
        """The internal nodes at these flat indexes, (len, 8) on the device."""
        return gather_rows_dev(self.flat_nodes, node_indexes)

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

        leaf_ref = batch.add(self._leaf_rows(leaf_fetch))
        node_ref = (batch.add(self._node_rows([ni for _, ni in node_slots]))
                    if node_slots else None)
        return _PendingBatchProof(batch, index_map, leaf_plan, node_slots,
                                  leaf_ref, node_ref, depth)

    def prove_batch(self, indexes) -> BatchMerkleProof:
        return self.prove_batch_async(indexes, TransferBatch()).result()


class TiledDeviceMerkleTree(DeviceMerkleTree):
    """A DeviceMerkleTree over leaves split over a mesh (a parallel.mesh.
    Sharded of (N/k, 8) words a slot, k a power of two): each slot hashes
    its contiguous leaves as one subtree, in one K13 launch on that slot
    (mesh_stages.subtree_nodes_sharded), and the cap tree over the k
    subtree roots is hashed on the host (crypto/merkle.build_merkle_nodes,
    BLAKE3).

    Node values are those of a monolithic build, so roots and batch proofs
    are byte for byte DeviceMerkleTree's; only where each node is stored
    differs: flat indexes [1, k) in the cap, the others in the slots'
    subtrees.  In a multi-process job every rank holds its own slot's
    subtree, take() brings the subtree roots to every rank, each hashes the
    same cap, and the openings' leaves and nodes come from their owners."""

    def __init__(self, leaves):
        from ..parallel import mesh_stages

        mesh = leaves.mesh
        k, sub = mesh.size, leaves.share()
        n = k * sub
        if not mesh_stages.subtree_fits(n, mesh) or sub & (sub - 1):
            raise ValueError(f"a tiled tree of {n} leaves over {k} slots")
        self.n = n
        self.mesh = mesh
        self.values = leaves
        self.sub_nodes = mesh_stages.subtree_nodes_sharded(leaves, mesh)
        # the subtree roots, each node 1 of its slot's array
        roots = mesh_stages.take(Sharded(mesh, self.sub_nodes, 0, "rows"),
                                 [s * sub + 1 for s in range(k)])
        roots = roots.cpu().numpy().view(np.uint8).reshape(k, 32)
        # cap flat index i is the tree's flat index i for i < k (the levels
        # above the subtree roots)
        self.cap_levels = k.bit_length() - 1
        self.cap_nodes = build_merkle_nodes(roots, "blake3")
        self._root = self.cap_nodes[1].tobytes()

    def _node_split(self, node_indexes):
        """Split flat node indexes into cap values (host bytes, flat indexes
        [1, k)) and (position, slot, local flat index) of those in the
        subtrees."""
        sub = self.n // self.mesh.size
        cap, subtree = {}, []
        for at, i in enumerate(node_indexes):
            if i < self.mesh.size:
                cap[at] = self.cap_nodes[i]
            else:
                level = i.bit_length() - 1
                p = i - (1 << level)
                kl = level - self.cap_levels        # the level within the subtree
                subtree.append((at, p >> kl, (1 << kl) + (p & ((1 << kl) - 1))))
        return cap, subtree, sub

    def _leaf_rows(self, indexes):
        from ..parallel.mesh_stages import take
        return take(self.values, indexes)

    def _node_rows(self, node_indexes):
        from ..parallel.mesh_stages import take

        cap, subtree, sub = self._node_split(node_indexes)
        rows = torch.zeros((len(node_indexes), 8), dtype=torch.uint32)
        for at, value in cap.items():
            rows[at] = torch.from_numpy(np.ascontiguousarray(value).view(np.uint32))
        rows = rows.to(self.mesh.home)
        if subtree:
            got = take(Sharded(self.mesh, self.sub_nodes, 0, "rows"),
                       [j * sub + local for _, j, local in subtree])
            at = torch.tensor([a for a, _, _ in subtree], dtype=torch.int64).to(self.mesh.home)
            rows = rows.view(torch.int32).index_copy(0, at, got.view(torch.int32)).view(
                torch.uint32)
        return rows


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
