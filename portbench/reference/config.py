"""Global VM geometry constants.

Mirrors the protocol constants of the reference zkVM (reference src/lib.rs:77-139)
so that trace layouts, program hashes, and proofs are compatible.
"""

MAX_CONTEXT_DEPTH = 16
MAX_LOOP_DEPTH = 8
MIN_TRACE_LENGTH = 16
MAX_REGISTER_COUNT = 128
MIN_EXTENSION_FACTOR = 16
BASE_CYCLE_LENGTH = 16

MIN_STACK_DEPTH = 8
MIN_CONTEXT_DEPTH = 1
MIN_LOOP_DEPTH = 1

# PUSH operation may only occur on steps that are multiples of 8
PUSH_OP_ALIGNMENT = 8

# in-VM Rescue hash (the RescR instruction / `hash` macro)
HASH_STATE_RATE = 4
HASH_STATE_CAPACITY = 2
HASH_STATE_WIDTH = HASH_STATE_RATE + HASH_STATE_CAPACITY
HASH_NUM_ROUNDS = 10
HASH_DIGEST_SIZE = 2

# op-injecting sponge used to accumulate the program hash
SPONGE_WIDTH = 4
PROGRAM_DIGEST_SIZE = 2
HACC_NUM_ROUNDS = 14

# decoder register layout:
#   [op_counter | sponge x4 | cf_bits x3 | ld_bits x5 | hd_bits x2 | ctx... | loop...]
NUM_CF_OP_BITS = 3
NUM_LD_OP_BITS = 5
NUM_HD_OP_BITS = 2

NUM_CF_OPS = 8
NUM_LD_OPS = 32
NUM_HD_OPS = 4

OP_COUNTER_IDX = 0
SPONGE_RANGE = range(1, 5)
CF_OP_BITS_RANGE = range(5, 8)
LD_OP_BITS_RANGE = range(8, 13)
HD_OP_BITS_RANGE = range(13, 15)

MAX_PUBLIC_INPUTS = 8
MAX_OUTPUTS = MAX_PUBLIC_INPUTS
MAX_STACK_DEPTH = 32

# STARK parameters
MAX_CONSTRAINT_DEGREE = 8
