"""The five proof hash functions exposed by the framework.

All have the reference signature `hash(input_bytes) -> 32-byte digest` over
inputs of at most 64 bytes for the arithmetic hashes (reference
src/crypto/hash.rs).  Arithmetic hashes interpret the input as little-endian
u128 field elements in a 6-wide state and output the first two state elements.
"""

import hashlib

from ..math import field
from .ark_constants import ALPHA, INV_ALPHA, HASH_MDS, HASH_ARK

_STATE_WIDTH = 6


def _state_from_bytes(values: bytes):
    assert len(values) <= 64, "expected 64 or fewer input bytes"
    padded = values + b"\x00" * (96 - len(values))
    return [int.from_bytes(padded[i : i + 16], "little") for i in range(0, 96, 16)]


def _digest_from_state(state):
    return field.to_bytes(state[0]) + field.to_bytes(state[1])


def _add_constants(state, offset):
    for i in range(_STATE_WIDTH):
        state[i] = field.add(state[i], HASH_ARK[offset + i])


def _apply_sbox(state):
    for i in range(_STATE_WIDTH):
        state[i] = field.exp(state[i], ALPHA)


def _apply_inv_sbox(state):
    for i in range(_STATE_WIDTH):
        state[i] = field.exp(state[i], INV_ALPHA)


def _apply_mds(state):
    result = [0] * _STATE_WIDTH
    for i in range(_STATE_WIDTH):
        acc = 0
        for j in range(_STATE_WIDTH):
            acc = field.add(acc, field.mul(HASH_MDS[i * _STATE_WIDTH + j], state[j]))
        result[i] = acc
    state[:] = result


def poseidon(values: bytes) -> bytes:
    """Poseidon over 6-wide state: 91 rounds, full rounds 0-3 and 87-90
    (reference src/crypto/hash.rs:119-147)."""
    state = _state_from_bytes(values)
    for i in range(91):
        _add_constants(state, i * 6)
        if i < 4 or i >= 87:
            _apply_sbox(state)
        else:
            state[5] = field.exp(state[5], ALPHA)
        _apply_mds(state)
    return _digest_from_state(state)


def rescue(values: bytes) -> bytes:
    """Rescue over 6-wide state, 10 rounds (reference src/crypto/hash.rs:151-177)."""
    state = _state_from_bytes(values)
    _add_constants(state, 0)
    for i in range(10):
        _apply_inv_sbox(state)
        _apply_mds(state)
        _add_constants(state, (i * 2 + 1) * 6)
        _apply_sbox(state)
        _apply_mds(state)
        _add_constants(state, (i * 2 + 2) * 6)
    return _digest_from_state(state)


def gmimc(values: bytes) -> bytes:
    """GMiMC_erf over 6-wide state, 166 rounds (reference src/crypto/hash.rs:181-201)."""
    state = _state_from_bytes(values)
    for i in range(166):
        s0 = state[0]
        mask = field.exp(field.add(s0, HASH_ARK[i]), ALPHA)
        for j in range(1, 6):
            state[j - 1] = field.add(mask, state[j])
        state[5] = s0
    return _digest_from_state(state)


def blake3(values: bytes) -> bytes:
    from .. import native
    return native.blake3_single(values)


def sha3(values: bytes) -> bytes:
    return hashlib.sha3_256(values).digest()


# registry keyed by the names used in proof serialization / CLI flags
HASH_FUNCTIONS = {
    "blake3": blake3,
    "sha3": sha3,
    "poseidon": poseidon,
    "rescue": rescue,
    "gmimc": gmimc,
}
