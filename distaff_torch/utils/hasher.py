"""6-wide plain Rescue, the hash of the VM's `hash` and `smpath`/`pmpath`
macros (reference src/utils/hasher.rs), on the host: the examples use it to
compute the Merkle root their program must reach.  Round constants are
cyclic mod 16.
"""

from ..math import field
from ..config import (
    BASE_CYCLE_LENGTH, HASH_STATE_WIDTH, HASH_STATE_RATE, HASH_DIGEST_SIZE, HASH_NUM_ROUNDS,
)
from ..crypto.ark_constants import ALPHA, INV_ALPHA, HASHER_MDS, HASHER_ARK

# ARK[row][step], 12 rows of 16 cyclic constants
ARK = [HASHER_ARK[r * 16 : (r + 1) * 16] for r in range(2 * HASH_STATE_WIDTH)]


def digest(values):
    """Hash up to 4 field elements into a 2-element digest.

    Matches the reference convention of reversing the state before and after
    the permutation (reference src/utils/hasher.rs:12-26).
    """
    assert len(values) <= HASH_STATE_RATE
    state = list(values) + [0] * (HASH_STATE_WIDTH - len(values))
    state.reverse()
    for i in range(HASH_NUM_ROUNDS):
        apply_round(state, i)
    state.reverse()
    return state[:HASH_DIGEST_SIZE]


def apply_round(state, step):
    ark_idx = step % BASE_CYCLE_LENGTH

    _add_constants(state, ark_idx, 0)
    _apply_sbox(state, ALPHA)
    _apply_mds(state)

    _add_constants(state, ark_idx, HASH_STATE_WIDTH)
    _apply_sbox(state, INV_ALPHA)
    _apply_mds(state)


def _add_constants(state, idx, offset):
    for i in range(HASH_STATE_WIDTH):
        state[i] = field.add(state[i], ARK[offset + i][idx])


def _apply_sbox(state, power):
    for i in range(HASH_STATE_WIDTH):
        state[i] = field.exp(state[i], power)


def _apply_mds(state):
    result = [0] * HASH_STATE_WIDTH
    for i in range(HASH_STATE_WIDTH):
        acc = 0
        for j in range(HASH_STATE_WIDTH):
            acc = field.add(acc, field.mul(HASHER_MDS[i * HASH_STATE_WIDTH + j], state[j]))
        result[i] = acc
    state[:] = result
