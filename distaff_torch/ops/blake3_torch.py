"""BLAKE3 on the card: row hashing (kernel K3, blake3_rows), whole Merkle
trees (kernel K13, merkle_tree) and their plain versions.

K3 (csrc/blake3_rows.cu) replaces the XLA BLAKE3 of
distaff_tpu/ops/blake3_jax.py (_compress, hash_rows_u32, parent_root): N
equal-length rows of up to 2048 bytes (one or two 1024-byte chunks) ->
(N, 8) uint32 digests.  Bound by operations; one thread per row with the
state in registers.

K13 (csrc/merkle_tree.cu + .cuh) replaces the level hashing of
distaff_tpu/crypto/merkle_dev.py (_build_flat_nodes, _build_subtree_nodes):
(N, 8) leaf digests -> the (N, 8) flat node array, in one launch whose
blocks hash subtrees in shared memory, the last block of each group going
on to the group's parent subtree (tree_plan).

K14 (csrc/trace_absorb.cu + .cuh) replaces distaff_tpu/ops/blake3_jax.py's
absorb_begin, absorb_block, absorb_finish and parent_root as the streaming
trace commitment drives them: one 64-byte block (four registers) of every
row absorbed into (D, 8) chaining values, a launch a block, the block's
registers copied into the evaluation domain's stride slice on the way; the
finished values are hash_rows' digests of the whole rows.  Bound by bytes.

Rows are given as (N, K, 4) uint32 views: K 16-byte registers per row,
any row and register strides, limbs contiguous - so a (R, D, 4) trace LDE
is hashed row-wise through `lde.permute(1, 0, 2)` without a copy.  The row
bytes are the registers' little-endian limbs in order, which is the u128 LE
serialization the reference hashes.

On CPU tensors the wrappers run the plain version, in int64 lanes.
"""

import ctypes
import functools

import torch

from ..crypto.blake3 import _IV, _PERM, CHUNK_START, CHUNK_END, ROOT, PARENT
from . import cuda_lib

_MASK32 = 0xFFFFFFFF
MAX_ROW_BYTES = 2048


# ------------------------------------------------------------------------------------------------
# plain version: lists of (N,) int64 lanes holding 32-bit words
# ------------------------------------------------------------------------------------------------

def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _MASK32


def _g(s, a, b, c, d, mx, my):
    s[a] = (s[a] + s[b] + mx) & _MASK32
    s[d] = _rotr(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotr(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b] + my) & _MASK32
    s[d] = _rotr(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotr(s[b] ^ s[c], 7)


def compress_plain(cv, m, counter, block_len, flags):
    """cv: 8 lanes, m: 16 lanes -> the 8 lanes of the new chaining value."""
    s = list(cv) + list(_IV[:4]) + [
        counter & _MASK32, (counter >> 32) & _MASK32, block_len, flags]
    m = list(m)
    for r in range(7):
        _g(s, 0, 4, 8, 12, m[0], m[1])
        _g(s, 1, 5, 9, 13, m[2], m[3])
        _g(s, 2, 6, 10, 14, m[4], m[5])
        _g(s, 3, 7, 11, 15, m[6], m[7])
        _g(s, 0, 5, 10, 15, m[8], m[9])
        _g(s, 1, 6, 11, 12, m[10], m[11])
        _g(s, 2, 7, 8, 13, m[12], m[13])
        _g(s, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in _PERM]
    return [s[i] ^ s[i + 8] for i in range(8)]


def parent_root(cv0, cv1):
    """Root digest of a two-chunk message from its chunk chaining values
    (a BLAKE3 parent node, counter 0, flags PARENT | ROOT)."""
    return compress_plain(list(_IV), list(cv0) + list(cv1), 0, 64, PARENT | ROOT)


def hash_rows_plain(rows):
    """(N, K, 4) uint32 -> (N, 8) uint32 digests, as hash_rows_u32 does."""
    n, k = rows.shape[0], rows.shape[1]
    byte_len = k * 16
    words = rows.reshape(n, 4 * k).to(torch.int64)
    nblocks = max((byte_len + 63) // 64, 1)
    nchunks = (nblocks + 15) // 16
    zero = torch.zeros(n, dtype=torch.int64, device=rows.device)

    def word(w):
        return words[:, w] if w < 4 * k else zero

    chunk_cvs = []
    for c in range(nchunks):
        first, last = c * 16, min((c + 1) * 16, nblocks) - 1
        cv = list(_IV)
        for i in range(first, last + 1):
            flags = CHUNK_START if i == first else 0
            if i == last:
                flags |= CHUNK_END | (ROOT if nchunks == 1 else 0)
            blen = 64 if i < nblocks - 1 else byte_len - 64 * (nblocks - 1)
            cv = compress_plain(cv, [word(16 * i + j) for j in range(16)], c, blen, flags)
        chunk_cvs.append(cv)
    cv = chunk_cvs[0] if nchunks == 1 else parent_root(*chunk_cvs)
    cv = [v if torch.is_tensor(v) else torch.full_like(zero, v) for v in cv]
    return torch.stack(cv, dim=1).to(torch.uint32)


# ------------------------------------------------------------------------------------------------
# K3 wrappers
# ------------------------------------------------------------------------------------------------

def _launch(rows, out, counter):
    n, k = rows.shape[0], rows.shape[1]
    code = cuda_lib.lib().distaff_blake3_rows(
        cuda_lib.ptr(rows), cuda_lib.ptr(out), n, k,
        rows.stride(0) // 4, rows.stride(1) // 4, cuda_lib.stream(rows))
    cuda_lib.check(code, counter)
    cuda_lib.LAUNCHES[counter] += 1
    return out


def _check_rows(rows):
    if rows.dim() != 3 or rows.shape[-1] != 4 or not 1 <= rows.shape[1] <= MAX_ROW_BYTES // 16:
        raise ValueError(
            f"blake3_rows: expected (N, K <= {MAX_ROW_BYTES // 16}, 4) rows, "
            f"got {tuple(rows.shape)}")


def hash_rows(rows, out=None):
    """BLAKE3 digest of every row of an (N, K, 4) uint32 view -> (N, 8)."""
    _check_rows(rows)
    if rows.device.type == "cpu":
        digests = hash_rows_plain(rows)
        return digests if out is None else out.copy_(digests)
    cuda_lib.require_limbs("blake3_rows", rows)
    if out is None:
        out = torch.empty((rows.shape[0], 8), dtype=torch.uint32, device=rows.device)
    return _launch(rows, out, "blake3_rows")


# a K13 stage hashes subtrees of at most 2^TREE_LEVELS input nodes, in
# blocks of at most TREE_THREADS threads (csrc/merkle_tree.cuh's kMaxLevels
# and kThreads)
TREE_LEVELS = 11
TREE_THREADS = 256
# the plan's bottom subtrees leave at least TREE_BLOCKS_PER_SM blocks an SM,
# but have at least 2^TREE_MIN_BOTTOM leaves: the fastest of the plans
# tools/air_probe.py k13 times on the H100
TREE_BLOCKS_PER_SM = 1
TREE_MIN_BOTTOM = 8


def tree_plan(n, sms, blocks_per_sm=TREE_BLOCKS_PER_SM, min_bottom=TREE_MIN_BOTTOM):
    """K13's plan for a tree of n leaves on a card of `sms` SMs: the levels
    that each stage of its one launch hashes, from the leaves up.  A tree
    whose first level is at most a node a thread of one block is one
    stage.  Else stage 0's subtrees, a block each, are the largest (at
    most 2^TREE_LEVELS leaves) that leave blocks_per_sm blocks an SM, and
    no smaller than 2^min_bottom leaves; the levels above split as evenly
    as stages of at most TREE_LEVELS levels allow."""
    total = n.bit_length() - 1
    if n <= 2 * TREE_THREADS:
        return [total]
    bottom = TREE_LEVELS
    while bottom > min_bottom and n >> bottom < blocks_per_sm * sms:
        bottom -= 1
    rest = total - bottom
    stages = -(-rest // TREE_LEVELS)
    return [bottom] + [rest // stages + (i < rest % stages) for i in range(stages)]


def tree_groups(n, plan):
    """The ticket counters a tree of n leaves takes under `plan`: a group
    (a subtree) of every stage above the first."""
    groups, m = 0, n >> plan[0]
    for levels in plan[1:]:
        m >>= levels
        groups += m
    return groups


_TREE_COUNTERS = {}


def _tree_counters(device, groups):
    """K13's int32 ticket counters on `device`: at least `groups` words, all
    0 (the last block of each group sets its counter back to 0).  One
    scratch a device and stream: the trees that share it run one after
    another, on that stream (merkle_tree enqueues every tree on the
    current stream; two slots of a mesh on one card each hash on their own
    stream, parallel/mesh.py)."""
    key = cuda_lib.stream_key(device)
    counters = _TREE_COUNTERS.get(key)
    if counters is None or counters.numel() < groups:
        counters = torch.zeros(max(groups, 1024), dtype=torch.int32, device=device)
        _TREE_COUNTERS[key] = counters
    return counters


@functools.lru_cache(maxsize=None)
def device_sms(index):
    """The SM count of card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_leaves(leaves):
    n = leaves.shape[0]
    if leaves.dim() != 2 or leaves.shape[1] != 8 or n < 2 or n & (n - 1):
        raise ValueError(f"merkle_tree: expected (N, 8) leaf digests, N a power of two >= 2, "
                         f"got {tuple(leaves.shape)}")


def merkle_tree_plain(leaves):
    """(N, 8) uint32 leaf digests -> (N, 8) flat node array: row 0 zero, the
    root at row 1, node i's children at rows 2i and 2i+1 (those of rows N/2
    and up are the leaves), each node the BLAKE3 of its children's 64
    bytes (reference merkle.rs node hash); one level at a time."""
    _check_leaves(leaves)
    n = leaves.shape[0]
    nodes = torch.zeros((n, 8), dtype=torch.uint32, device=leaves.device)
    level = leaves
    for size in (n >> k for k in range(1, n.bit_length())):
        nodes[size : 2 * size] = hash_rows_plain(level.reshape(size, 4, 4))
        level = nodes[size : 2 * size]
    return nodes


def merkle_tree(leaves, plan=None):
    """The flat node array of a BLAKE3 Merkle tree over (N, 8) uint32 leaf
    digests (merkle_tree_plain's): on the card one K13 launch under
    tree_plan(N, the card's SMs), or `plan`, on the current stream."""
    _check_leaves(leaves)
    if leaves.device.type == "cpu":
        return merkle_tree_plain(leaves)
    n = leaves.shape[0]
    leaves = leaves.contiguous()
    cuda_lib.require_limbs("merkle_tree", leaves.view(n, 2, 4))
    if plan is None:
        plan = tree_plan(n, device_sms(leaves.device.index or 0))
    nodes = torch.empty((n, 8), dtype=torch.uint32, device=leaves.device)
    counters = _tree_counters(leaves.device, tree_groups(n, plan))
    code = cuda_lib.lib().distaff_merkle_tree(
        cuda_lib.ptr(leaves), cuda_lib.ptr(nodes), cuda_lib.ptr(counters), n, len(plan),
        (ctypes.c_int * len(plan))(*plan), cuda_lib.stream(nodes))
    cuda_lib.check(code, "merkle_tree")
    cuda_lib.LAUNCHES["merkle_tree"] += 1
    return nodes


# ------------------------------------------------------------------------------------------------
# K14 trace_absorb: a row's BLAKE3 a 64-byte block at a time
# ------------------------------------------------------------------------------------------------

BLOCK_REGISTERS = 4          # 16-byte registers in a 64-byte BLAKE3 block
CHUNK_BLOCKS = 16            # blocks in a 1024-byte chunk


def absorb_flags(block, byte_len):
    """(flags, block length, chunk counter, parent) of 64-byte block `block`
    of rows of byte_len bytes, as hash_rows_plain hashes them: parent is
    whether the block ends a two-chunk row, whose digest is then the parent
    node over the two chunks' chaining values."""
    n_blocks = -(-byte_len // 64)
    n_chunks = -(-n_blocks // CHUNK_BLOCKS)
    if not 0 <= block < n_blocks or n_chunks > 2:
        raise ValueError(f"absorb: block {block} of rows of {byte_len} bytes")
    last = block == n_blocks - 1
    flags = CHUNK_START if block % CHUNK_BLOCKS == 0 else 0
    if last or block % CHUNK_BLOCKS == CHUNK_BLOCKS - 1:
        flags |= CHUNK_END
    if last and n_chunks == 1:
        flags |= ROOT
    block_len = byte_len - 64 * (n_blocks - 1) if last else 64
    return flags, block_len, block // CHUNK_BLOCKS, last and n_chunks == 2


def _check_absorb(group, cv, block, byte_len, chunk0, slice_out, slice_shift):
    k, d = group.shape[0], group.shape[1]
    parent = absorb_flags(block, byte_len)[3]
    want_k = min(BLOCK_REGISTERS, byte_len // 16 - BLOCK_REGISTERS * block)
    bad_slice = slice_out is not None and (
        slice_out.shape[0] != k or slice_out.shape[1] << slice_shift != d)
    if group.dim() != 3 or group.shape[2] != 4 or k != want_k or cv.shape != (d, 8) or \
            (chunk0 is not None) != parent or bad_slice or (
                chunk0 is not None and chunk0.shape != cv.shape):
        shapes = [tuple(t.shape) for t in (group, cv, chunk0, slice_out) if t is not None]
        raise ValueError(
            f"trace_absorb: block {block} of {byte_len}-byte rows takes ({want_k}, D, 4) "
            f"registers, (D, 8) chaining values{', chunk 0 values' if parent else ''} and "
            f"a ({want_k}, D >> {slice_shift}, 4) slice or none, got {shapes}")


def trace_absorb_plain(group, cv, block, byte_len, chunk0=None, slice_out=None, slice_shift=0):
    """trace_absorb's function on plain tensors: compress_plain over the
    block's words in int64 lanes (and parent_root after a two-chunk row's
    last block)."""
    _check_absorb(group, cv, block, byte_len, chunk0, slice_out, slice_shift)
    flags, block_len, counter, parent = absorb_flags(block, byte_len)
    k, d = group.shape[0], group.shape[1]
    if slice_out is not None:
        slice_out.copy_(group[:, ::1 << slice_shift])
    words = group.permute(1, 0, 2).reshape(d, 4 * k).to(torch.int64)
    zero = torch.zeros(d, dtype=torch.int64, device=group.device)
    m = [words[:, w] if w < 4 * k else zero for w in range(16)]
    state = list(_IV) if flags & CHUNK_START else list(cv.to(torch.int64).unbind(1))
    state = compress_plain(state, m, counter, block_len, flags)
    if parent:
        state = parent_root(chunk0.to(torch.int64).unbind(1), state)
    state = [v if torch.is_tensor(v) else torch.full_like(zero, v) for v in state]
    return cv.copy_(torch.stack(state, dim=1))


def trace_absorb(group, cv, block, byte_len, chunk0=None, slice_out=None, slice_shift=0):
    """Absorb 64-byte block `block` of rows of byte_len bytes into the
    chaining values cv (D, 8) uint32, in place: group (k, D, 4) the block's
    k <= 4 registers (the rest of a partial last block zero), chunk0 chunk
    0's finished values where the block ends a two-chunk row (the digest is
    then the parent node), and slice_out, if given, (k, D >> slice_shift, 4)
    receives the registers' points d = e << slice_shift.  After a row's last
    block cv holds hash_rows' digests.  Returns cv."""
    _check_absorb(group, cv, block, byte_len, chunk0, slice_out, slice_shift)
    if group.device.type == "cpu":
        return trace_absorb_plain(group, cv, block, byte_len, chunk0, slice_out, slice_shift)
    flags, block_len, counter, _ = absorb_flags(block, byte_len)
    cuda_lib.require_limbs("trace_absorb", group, cv.view(-1, 2, 4),
                           *(t.view(-1, 2, 4) for t in (chunk0,) if t is not None),
                           *(t for t in (slice_out,) if t is not None))
    if group.stride(1) != 4 or not cv.is_contiguous() or (
            chunk0 is not None and not chunk0.is_contiguous()) or (
            slice_out is not None and slice_out.stride(1) != 4):
        raise ValueError("trace_absorb: each register's points and the chaining values "
                         "must be contiguous")
    nul = ctypes.c_void_p(None)
    code = cuda_lib.lib().distaff_trace_absorb(
        cuda_lib.ptr(group), group.stride(0) // 4, group.shape[0], group.shape[1],
        cuda_lib.ptr(cv), nul if chunk0 is None else cuda_lib.ptr(chunk0),
        nul if slice_out is None else cuda_lib.ptr(slice_out),
        0 if slice_out is None else slice_out.stride(0) // 4, slice_shift, flags, block_len,
        counter, cuda_lib.stream(cv))
    cuda_lib.check(code, "trace_absorb")
    cuda_lib.LAUNCHES["trace_absorb"] += 1
    return cv


def absorb_rows(group_at, regs, slice_out=None, slice_shift=0):
    """The (D, 8) digests of rows of `regs` registers, absorbed a 64-byte
    block at a time (one trace_absorb a block): group_at(lo) makes block
    lo // 4's registers lo, lo + 1, ... as a (k, D, 4) tensor, which is
    dropped after its launch; slice_out (regs, D >> slice_shift, 4), if
    given, receives every register's points d = e << slice_shift.  A
    two-chunk row's chunk 0 values are kept for its last launch, which
    writes the parent node."""
    byte_len = 16 * regs
    cv = chunk0 = None
    for block, lo in enumerate(range(0, regs, BLOCK_REGISTERS)):
        group = group_at(lo)
        if cv is None:
            cv = torch.empty((group.shape[1], 8), dtype=torch.uint32, device=group.device)
        if block == CHUNK_BLOCKS:
            chunk0, cv = cv, torch.empty_like(cv)
        parent = absorb_flags(block, byte_len)[3]
        trace_absorb(group, cv, block, byte_len, chunk0 if parent else None,
                     None if slice_out is None else slice_out[lo:lo + BLOCK_REGISTERS],
                     slice_shift)
        del group
    return cv


def hash_rows_u32(rows_u32, byte_len):
    """(N, W) uint32 message words, byte_len = 4*W a multiple of 16 ->
    (N, 8) digests (the signature of blake3_jax.hash_rows_u32)."""
    n, w = rows_u32.shape
    if w * 4 != byte_len or byte_len % 16:
        raise ValueError(f"hash_rows_u32: {w} words do not make {byte_len} bytes of registers")
    return hash_rows(rows_u32.reshape(n, w // 4, 4))


def hash_trace_rows_dev(lde):
    """(R, D, 4) limb LDE -> (D, 8) uint32 leaf digests: row d is the
    R registers' limbs at domain point d."""
    return hash_rows(lde.permute(1, 0, 2))
