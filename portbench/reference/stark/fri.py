"""Radix-4 FRI (reference src/stark/fri/): device folds (kernel K9, which
with blake3 also hashes each folded layer's leaves) and layer trees (on the
device for blake3, on the host for any other hash) for the prover,
host-side verification.
"""

from ..math import field, quartic, polynom
from ..utils import rand
from ..crypto.merkle import BatchMerkleProof, verify_batch
from ..crypto import hashes

MAX_REMAINDER_LENGTH = 256


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
        if not verify_batch(layer.root, augmented_positions, merkle_proof, hash_name):
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
