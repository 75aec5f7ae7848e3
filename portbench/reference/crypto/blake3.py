"""BLAKE3 hash, implemented from the public specification.

The reference uses blake3 as its default (and only serializable) proof hash
function (reference src/stark/options.rs:84-92, src/crypto/hash.rs:205-209),
so a bit-exact implementation is required for transcript and Merkle
compatibility.  No blake3 package ships in this environment, so this module
implements the algorithm directly:

- ``blake3(data)``          - scalar hash of one message (any length)

Only the plain (unkeyed) mode is implemented; that is all the protocol uses.
"""

_IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8

_MASK = 0xFFFFFFFF
_CHUNK_LEN = 1024
_BLOCK_LEN = 64


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(s, a, b, c, d, mx, my):
    s[a] = (s[a] + s[b] + mx) & _MASK
    s[d] = _rotr(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotr(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b] + my) & _MASK
    s[d] = _rotr(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotr(s[b] ^ s[c], 7)


def _compress(cv, block_words, counter, block_len, flags):
    s = list(cv) + list(_IV[:4]) + [
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
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


def _words_of(block: bytes):
    return [int.from_bytes(block[i : i + 4], "little") for i in range(0, 64, 4)]


def _chunk_cv(chunk: bytes, chunk_index: int, is_root: bool):
    cv = list(_IV)
    blocks = [chunk[i : i + _BLOCK_LEN] for i in range(0, max(len(chunk), 1), _BLOCK_LEN)]
    if not blocks:
        blocks = [b""]
    for i, block in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END
            if is_root:
                flags |= ROOT
        padded = block + b"\x00" * (_BLOCK_LEN - len(block))
        cv = _compress(cv, _words_of(padded), chunk_index, len(block), flags)
    return cv


def _tree_cv(chunks, first_index, is_root):
    if len(chunks) == 1:
        return _chunk_cv(chunks[0], first_index, is_root)
    # left subtree takes the largest power-of-two chunk count < total
    left_n = 1 << (len(chunks) - 1).bit_length() - 1
    left = _tree_cv(chunks[:left_n], first_index, False)
    right = _tree_cv(chunks[left_n:], first_index + left_n, False)
    flags = PARENT | (ROOT if is_root else 0)
    return _compress(list(_IV), left + right, 0, _BLOCK_LEN, flags)


def blake3(data: bytes) -> bytes:
    """32-byte BLAKE3 digest of `data`."""
    chunks = [data[i : i + _CHUNK_LEN] for i in range(0, max(len(data), 1), _CHUNK_LEN)]
    if not chunks:
        chunks = [b""]
    cv = _tree_cv(chunks, 0, True)
    return b"".join(w.to_bytes(4, "little") for w in cv)
