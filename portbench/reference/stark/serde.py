"""Bincode-compatible proof serialization.

Encodes StarkProof exactly as Rust's `bincode::serialize` (bincode 1.x
default configuration: little-endian, fixed-width ints, u64 sequence
lengths) over the reference's struct layout (reference src/stark/proof.rs,
fri/mod.rs, crypto/merkle.rs, options.rs) so proof bytes round-trip with the
reference implementation.  Only blake3 is a serializable hash function
(reference options.rs:97-121).
"""

import struct

from .proof import StarkProof, DeepValues, TraceInfo
from .options import ProofOptions
from .fri import FriProof, FriLayer


class _Writer:
    def __init__(self):
        self.parts = []

    def bytes_fixed(self, b):
        self.parts.append(bytes(b))

    def u8(self, v):
        self.parts.append(struct.pack("<B", v))

    def u32(self, v):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", v))

    def u128(self, v):
        self.parts.append(int(v).to_bytes(16, "little"))

    def seq_len(self, n):
        self.u64(n)

    def getvalue(self):
        return b"".join(self.parts)


class _Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def take(self, n):
        b = self.data[self.pos : self.pos + n]
        assert len(b) == n, "unexpected end of proof data"
        self.pos += n
        return b

    def u8(self):
        return self.take(1)[0]

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]

    def u128(self):
        return int.from_bytes(self.take(16), "little")

    def seq_len(self):
        return self.u64()


def _write_nodes(w, nodes):
    """Vec<Vec<[u8;32]>>"""
    w.seq_len(len(nodes))
    for inner in nodes:
        w.seq_len(len(inner))
        for node in inner:
            w.bytes_fixed(node)


def _read_nodes(r):
    outer = []
    for _ in range(r.seq_len()):
        outer.append([r.take(32) for _ in range(r.seq_len())])
    return outer


def serialize(proof: StarkProof) -> bytes:
    opt = proof.options
    assert opt.hash_fn == "blake3", "only blake3 proofs are serializable"
    return serialize_body(proof) + struct.pack(
        "<BBBB", opt._ext_log2, opt.num_queries(), opt.grinding_factor(), 0)


def serialize_body(proof: StarkProof) -> bytes:
    """Every field of the proof before its options, as `serialize` writes
    them: the bytes by which a proof under a hash other than blake3, which
    has no serialized form, is compared with another."""
    w = _Writer()
    w.bytes_fixed(proof.trace_root)

    ti = proof.trace_info
    w.u8(ti.domain_depth)
    w.u8(ti.ctx_depth)
    w.u8(ti.loop_depth)
    w.u8(ti.stack_depth)
    w.u32(ti.op_count)

    _write_nodes(w, proof.trace_nodes)

    w.seq_len(len(proof.trace_evaluations))
    for row in proof.trace_evaluations:
        w.seq_len(len(row))
        for v in row:
            w.u128(v)

    w.bytes_fixed(proof.constraint_root)

    cp = proof.constraint_proof_obj
    w.seq_len(len(cp.values))
    for v in cp.values:
        w.bytes_fixed(v)
    _write_nodes(w, cp.nodes)
    w.u8(cp.depth)

    dv = proof.deep_values
    w.seq_len(len(dv.trace_at_z1))
    for v in dv.trace_at_z1:
        w.u128(v)
    w.seq_len(len(dv.trace_at_z2))
    for v in dv.trace_at_z2:
        w.u128(v)

    dp = proof.degree_proof
    w.seq_len(len(dp.layers))
    for layer in dp.layers:
        w.bytes_fixed(layer.root)
        w.seq_len(len(layer.values))
        for row in layer.values:
            for v in row:  # [u128; 4] fixed array - no length prefix
                w.u128(v)
        _write_nodes(w, layer.nodes)
        w.u8(layer.depth)
    w.bytes_fixed(dp.rem_root)
    w.seq_len(len(dp.rem_values))
    for v in dp.rem_values:
        w.u128(v)

    w.u64(proof.pow_nonce)
    return w.getvalue()


def deserialize(data: bytes) -> StarkProof:
    r = _Reader(data)

    trace_root = r.take(32)
    domain_depth = r.u8()
    ctx_depth = r.u8()
    loop_depth = r.u8()
    stack_depth = r.u8()
    op_count = r.u32()

    trace_nodes = _read_nodes(r)

    trace_evaluations = []
    for _ in range(r.seq_len()):
        trace_evaluations.append([r.u128() for _ in range(r.seq_len())])

    constraint_root = r.take(32)

    cp_values = [r.take(32) for _ in range(r.seq_len())]
    cp_nodes = _read_nodes(r)
    cp_depth = r.u8()

    trace_at_z1 = [r.u128() for _ in range(r.seq_len())]
    trace_at_z2 = [r.u128() for _ in range(r.seq_len())]

    layers = []
    for _ in range(r.seq_len()):
        root = r.take(32)
        values = []
        for _ in range(r.seq_len()):
            values.append([r.u128() for _ in range(4)])
        nodes = _read_nodes(r)
        depth = r.u8()
        layers.append(FriLayer(root, values, nodes, depth))
    rem_root = r.take(32)
    rem_values = [r.u128() for _ in range(r.seq_len())]
    degree_proof = FriProof(layers, rem_root, rem_values)

    pow_nonce = r.u64()

    ext_log2 = r.u8()
    num_queries = r.u8()
    grinding_factor = r.u8()
    hash_id = r.u8()
    assert hash_id == 0, "unsupported hash function in proof"
    options = ProofOptions(1 << ext_log2, num_queries, grinding_factor, "blake3")

    assert r.pos == len(data), "trailing bytes in proof data"

    from ..crypto.merkle import BatchMerkleProof

    proof = StarkProof.__new__(StarkProof)
    proof.trace_root = trace_root
    proof.trace_info = TraceInfo(domain_depth, ctx_depth, loop_depth, stack_depth, op_count)
    proof.trace_nodes = trace_nodes
    proof.trace_evaluations = trace_evaluations
    proof.constraint_root = constraint_root
    proof.constraint_proof_obj = BatchMerkleProof(cp_values, cp_nodes, cp_depth)
    proof.deep_values = DeepValues(trace_at_z1, trace_at_z2)
    proof.degree_proof = degree_proof
    proof.pow_nonce = pow_nonce
    proof.options = options
    return proof
