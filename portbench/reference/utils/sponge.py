"""Op-injecting 4-wide Rescue sponge used for program hashing ("hacc").

A modified Rescue round where (op_code, op_value) are injected between the
two half-rounds (reference src/utils/sponge.rs:13-30).  Round constants are a
cyclic table indexed by `step % 16`.

The half-round pieces (sbox / inv-sbox / mds / inv-mds) are exported for the
decoder AIR, which checks one hacc round by meeting in the middle: forward
half-round applied to the current sponge, inverse second-half applied to the
next sponge (reference src/stark/constraints/decoder/sponge.rs:10-43).  The
batched/vectorized counterparts for the device live in
distaff_torch.stark.constraints.
"""

from ..math import field
from ..config import BASE_CYCLE_LENGTH, SPONGE_WIDTH
from ..crypto.ark_constants import ALPHA, INV_ALPHA, SPONGE_MDS, SPONGE_INV_MDS, SPONGE_ARK

# ARK[row][step], 8 rows of 16 cyclic constants
ARK = [SPONGE_ARK[r * 16 : (r + 1) * 16] for r in range(2 * SPONGE_WIDTH)]


def apply_round(state, op_code, op_value, step):
    ark_idx = step % BASE_CYCLE_LENGTH

    # first half of Rescue round
    add_constants(state, ark_idx, 0)
    apply_sbox(state)
    apply_mds(state)

    # inject operation into the state
    state[0] = field.add(state[0], op_code)
    state[1] = field.add(state[1], op_value)

    # second half of Rescue round
    add_constants(state, ark_idx, SPONGE_WIDTH)
    apply_inv_sbox(state)
    apply_mds(state)


def add_constants(state, idx, offset):
    for i in range(SPONGE_WIDTH):
        state[i] = field.add(state[i], ARK[offset + i][idx])


def apply_sbox(state):
    for i in range(SPONGE_WIDTH):
        state[i] = field.exp(state[i], ALPHA)


def apply_inv_sbox(state):
    for i in range(SPONGE_WIDTH):
        state[i] = field.exp(state[i], INV_ALPHA)


def apply_mds(state):
    result = [0] * SPONGE_WIDTH
    for i in range(SPONGE_WIDTH):
        acc = 0
        for j in range(SPONGE_WIDTH):
            acc = field.add(acc, field.mul(SPONGE_MDS[i * SPONGE_WIDTH + j], state[j]))
        result[i] = acc
    state[:] = result


def apply_inv_mds(state):
    result = [0] * SPONGE_WIDTH
    for i in range(SPONGE_WIDTH):
        acc = 0
        for j in range(SPONGE_WIDTH):
            acc = field.add(acc, field.mul(SPONGE_INV_MDS[i * SPONGE_WIDTH + j], state[j]))
        result[i] = acc
    state[:] = result
