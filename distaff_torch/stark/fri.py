"""Radix-4 FRI (reference src/stark/fri/): device folds (kernel K9, which
with blake3 also hashes each folded layer's leaves) and layer trees (on the
device for blake3, on the host for any other hash) for the prover,
host-side verification.
"""

from ..math import field, quartic, polynom
from ..math import field_torch as ft
from ..utils import rand
from ..crypto.merkle import MerkleTree, BatchMerkleProof
from ..crypto import hashes
from ..ops import fri_torch

MAX_REMAINDER_LENGTH = 256
# the parts of reduce's work, as it reports them to its `part` callback
PARTS = ("layer trees", "root draws", "folds (K9)")


class FriLayer:
    def __init__(self, root, values, nodes, depth):
        self.root = root        # bytes(32)
        self.values = values    # list of [v0, v1, v2, v3] int rows
        self.nodes = nodes      # list[list[bytes(32)]]
        self.depth = depth


class FriProof:
    def __init__(self, layers, rem_root, rem_values):
        self.layers = layers
        self.rem_root = rem_root
        self.rem_values = rem_values


def reduce(evaluations_dev, domain_root, options, part=None):
    """Reduce composition evaluations down to <= 256 remainder values.

    evaluations_dev: (n, 4limbs) device tensor over the LDE domain, whose
    root is domain_root.  Returns (trees, row_values_dev) per layer; the
    Fiat-Shamir fold point of each layer is drawn from that layer's Merkle
    root, and the layer is folded in one launch of kernel K9.  A layer's
    tree commits to its (q, 4, 4limbs) rows, each row's 64 bytes the u128
    LE concatenation that the limb layout already is (crypto.merkle_dev.
    commit: on the device with blake3, else on the host); with blake3 the
    fold's launch also hashes the folded layer's rows, so its tree is
    built from those leaf digests (K3 hashes the first layer's rows alone).
    `part`, if given, is called with the name in PARTS of each piece of
    work as it ends.

    Evaluations split by rows over a mesh (a parallel.mesh.Sharded) fold
    on the mesh (the JAX package's fri.py:92-104): each layer laid out as
    each slot's rows of it (one all-to-all), its tree over the slots'
    rows (K3 on each slot, a tiled tree), and its fold K9 on each slot's
    rows, without the digests, whose leaves hold values of every slot.  A
    layer too small to split (parallel/mesh_stages.fold_fits) and those
    after it fold on the home slot as above.
    """
    from ..crypto.merkle_dev import commit
    from ..parallel.mesh import Sharded

    part = part or (lambda name: None)
    hash_leaves = options.hash_fn == "blake3"
    tree_results = []
    value_results = []

    # layer L's nodes are powers of w^(4^L): K9 reads them from the power
    # tables of the LDE domain's root w at that stride
    stride = 1
    column, leaves = evaluations_dev, None
    while True:
        sharded = isinstance(column, Sharded)
        if sharded:
            from ..parallel import mesh_stages

            q = column.share() * column.mesh.size // 4
            if not mesh_stages.fold_fits(q, column.mesh):
                column, sharded = column.gather(), False
        if sharded:
            layout = mesh_stages.fold_layout(column, q)
            values = mesh_stages.layer_rows(layout)
            tree = commit(values, options.hash_fn)
        else:
            values = fri_torch.transpose_quartic(column, 1)
            q = values.shape[0]
            tree = (commit(leaves, "blake3", leaves=True) if leaves is not None
                    else commit(values, options.hash_fn))
        part("layer trees")
        tree_results.append(tree)
        value_results.append(values)
        if q * 4 <= MAX_REMAINDER_LENGTH:
            break

        special_x = rand.prng(tree.root(), field.M)
        part("root draws")
        if sharded:
            column = mesh_stages.fold_sharded(layout, special_x, domain_root, stride,
                                              layout.mesh)
        else:
            folded = fri_torch.fri_fold(column, special_x, domain_root, stride,
                                        digests=hash_leaves)
            column, leaves = folded if hash_leaves else (folded, None)
        part("folds (K9)")
        stride *= 4
    return tree_results, value_results


def build_proof(trees, values, positions, batch):
    """Openings of every layer at the augmented query positions; the device
    gathers ride the caller's TransferBatch (one copy to the host)."""
    from ..ops.gather import gather_rows_dev
    from ..parallel.mesh import Sharded
    from ..parallel.mesh_stages import take

    positions = list(positions)
    first = values[0]
    domain_size = 4 * (first.share() * first.mesh.size if isinstance(first, Sharded)
                       else first.shape[0])

    pending = []
    for i in range(len(trees) - 1):
        positions = get_augmented_positions(positions, domain_size)
        pending.append(
            (trees[i], trees[i].prove_batch_async(positions, batch),
             batch.add(take(values[i], positions) if isinstance(values[i], Sharded)
                       else gather_rows_dev(values[i], positions)), len(positions)))
        domain_size //= 4
    last = values[-1]
    last_ref = batch.add(last.gather() if isinstance(last, Sharded) else last)

    layers = []
    for tree, pending_proof, rows_ref, n_pos in pending:
        proof = pending_proof.result()
        rows_host = ft.to_ints(batch.get(rows_ref))           # (Q, 4) obj
        queried = [[int(v) for v in rows_host[k]] for k in range(n_pos)]
        layers.append(FriLayer(tree.root(), queried, proof.nodes, proof.depth))

    last_values = ft.to_ints(batch.get(last_ref))             # (q, 4) object
    q = last_values.shape[0]
    remainder = [0] * (q * 4)
    for i in range(q):
        for j in range(4):
            remainder[i + q * j] = int(last_values[i][j])
    return FriProof(layers, trees[-1].root(), remainder)


def verify(proof, evaluations, positions, max_degree, options):
    """Host-side FRI verification (reference src/stark/fri/verifier.rs)."""
    hash_name = options.hash_fn
    hash_fn = hashes.HASH_FUNCTIONS[hash_name]

    domain_size = (2 ** proof.layers[0].depth) * 4
    domain_root = field.get_root_of_unity(domain_size)
    quartic_roots = [
        1,
        field.exp(domain_root, domain_size // 4),
        field.exp(domain_root, domain_size // 2),
        field.exp(domain_root, domain_size * 3 // 4),
    ]

    max_degree_plus_1 = max_degree + 1
    positions = list(positions)
    evaluations = list(evaluations)

    for depth, layer in enumerate(proof.layers):
        augmented_positions = get_augmented_positions(positions, domain_size)
        column_values = _get_column_values(
            layer.values, positions, augmented_positions, domain_size)
        if evaluations != column_values:
            raise ValueError(f"evaluations did not match column value at depth {depth}")

        leaf_hashes = [hash_fn(_row_bytes(row)) for row in layer.values]
        merkle_proof = BatchMerkleProof(leaf_hashes, layer.nodes, layer.depth)
        if not MerkleTree.verify_batch(layer.root, augmented_positions, merkle_proof, hash_name):
            raise ValueError(f"verification of Merkle proof failed at layer {depth}")

        xs = []
        for p in augmented_positions:
            xe = field.exp(domain_root, p)
            xs.append([field.mul(r, xe) for r in quartic_roots])

        row_polys = quartic.interpolate_batch(xs, layer.values)
        special_x = rand.prng(layer.root, field.M)
        evaluations = quartic.evaluate_batch(row_polys, special_x)

        domain_root = field.exp(domain_root, 4)
        max_degree_plus_1 //= 4
        domain_size //= 4
        positions = augmented_positions

    for position, evaluation in zip(positions, evaluations):
        if proof.rem_values[position] != evaluation:
            raise ValueError("remainder values are inconsistent with the last column")

    _verify_remainder(
        proof.rem_values, max_degree_plus_1, domain_root, options.extension_factor())
    return True


def _verify_remainder(remainder, max_degree_plus_1, domain_root, extension_factor):
    if max_degree_plus_1 > len(remainder):
        raise ValueError("remainder degree is greater than number of remainder values")

    positions = [i for i in range(len(remainder)) if i % extension_factor != 0]
    domain = field.get_power_series(domain_root, len(remainder))

    xs = [domain[positions[i]] for i in range(max_degree_plus_1)]
    ys = [remainder[positions[i]] for i in range(max_degree_plus_1)]
    poly = polynom.interpolate(xs, ys)

    for i in range(max_degree_plus_1, len(positions)):
        p = positions[i]
        if polynom.eval(poly, domain[p]) != remainder[p]:
            raise ValueError(
                f"remainder is not a valid degree {max_degree_plus_1 - 1} polynomial")


def get_augmented_positions(positions, column_length):
    row_length = column_length // 4
    result = []
    for p in positions:
        ap = p % row_length
        if ap not in result:
            result.append(ap)
    return result


def _get_column_values(values, positions, augmented_positions, column_length):
    row_length = column_length // 4
    result = []
    for position in positions:
        idx = augmented_positions.index(position % row_length)
        result.append(values[idx][position // row_length])
    return result


def _row_bytes(row):
    return b"".join(field.to_bytes(v) for v in row)
