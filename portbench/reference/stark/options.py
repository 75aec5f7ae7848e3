"""Proof options (reference src/stark/options.rs)."""

from ..config import MAX_CONSTRAINT_DEGREE

DEFAULT_EXTENSION_FACTOR = MAX_CONSTRAINT_DEGREE * 4  # 32
DEFAULT_NUM_QUERIES = 50
DEFAULT_GRINDING_FACTOR = 20


class ProofOptions:
    def __init__(self, extension_factor=DEFAULT_EXTENSION_FACTOR,
                 num_queries=DEFAULT_NUM_QUERIES,
                 grinding_factor=DEFAULT_GRINDING_FACTOR,
                 hash_fn="blake3"):
        assert extension_factor & (extension_factor - 1) == 0, "extension_factor must be a power of 2"
        assert 16 <= extension_factor <= 256, "extension_factor must be in [16, 256]"
        assert 0 < num_queries <= 128, "num_queries must be in (0, 128]"
        assert grinding_factor <= 32, "grinding factor cannot be greater than 32"
        self._ext_log2 = extension_factor.bit_length() - 1
        self._num_queries = num_queries
        self._grinding_factor = grinding_factor
        self.hash_fn = hash_fn  # name in crypto.hashes.HASH_FUNCTIONS

    def extension_factor(self):
        return 1 << self._ext_log2

    def num_queries(self):
        return self._num_queries

    def grinding_factor(self):
        return self._grinding_factor

    def security_level(self, optimistic=True):
        one_over_rho = self.extension_factor() // MAX_CONSTRAINT_DEGREE
        security_factor = one_over_rho.bit_length() - 1
        num_queries = self._num_queries if optimistic else self._num_queries // 2
        result = security_factor * num_queries
        if result >= 80:
            result += self._grinding_factor
        return result

    def __eq__(self, other):
        return (
            self._ext_log2 == other._ext_log2
            and self._num_queries == other._num_queries
            and self._grinding_factor == other._grinding_factor
            and self.hash_fn == other.hash_fn
        )
