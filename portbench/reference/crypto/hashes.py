"""The proof hash functions the reference verifier knows: blake3, the only
serializable one (reference src/stark/options.rs:97-121), in pure Python."""

from .blake3 import blake3

# registry keyed by the names used in proof serialization
HASH_FUNCTIONS = {"blake3": blake3}
