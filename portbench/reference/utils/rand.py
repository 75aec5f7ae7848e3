"""Bit-compatible reimplementation of the Fiat-Shamir PRNG used by the reference.

The reference draws all transcript randomness (constraint/composition
coefficients, the DEEP point z, FRI fold points, query positions) from Rust's
``StdRng::from_seed(seed)`` with ``rand = "0.7.3"`` (reference Cargo.toml:21,
src/math/field.rs:264-275, src/stark/utils/mod.rs:25-44).  In rand 0.7 StdRng
is ChaCha20Rng (rand_chacha 0.2): a ChaCha20 keystream with the 32-byte seed
as key, 64-bit block counter starting at 0, and zero stream id.  Uniform
integer sampling uses the widening-multiply rejection method.

This module reproduces those semantics exactly so proofs remain verifiable by
the unmodified reference verifier.
"""

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
MASK128 = (1 << 128) - 1

_CHACHA_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _quarter_round(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & MASK32
    s[d] ^= s[a]
    s[d] = ((s[d] << 16) | (s[d] >> 16)) & MASK32
    s[c] = (s[c] + s[d]) & MASK32
    s[b] ^= s[c]
    s[b] = ((s[b] << 12) | (s[b] >> 20)) & MASK32
    s[a] = (s[a] + s[b]) & MASK32
    s[d] ^= s[a]
    s[d] = ((s[d] << 8) | (s[d] >> 24)) & MASK32
    s[c] = (s[c] + s[d]) & MASK32
    s[b] ^= s[c]
    s[b] = ((s[b] << 7) | (s[b] >> 25)) & MASK32


def chacha20_block(key_words, counter, stream=0):
    """One 64-byte ChaCha20 block -> 16 little-endian u32 words.

    Uses the original DJB layout rand_chacha uses: 64-bit block counter in
    words 12-13, 64-bit stream id in words 14-15.
    """
    init = list(_CHACHA_CONSTANTS) + list(key_words) + [
        counter & MASK32,
        (counter >> 32) & MASK32,
        stream & MASK32,
        (stream >> 32) & MASK32,
    ]
    s = list(init)
    for _ in range(10):  # 20 rounds = 10 double rounds
        _quarter_round(s, 0, 4, 8, 12)
        _quarter_round(s, 1, 5, 9, 13)
        _quarter_round(s, 2, 6, 10, 14)
        _quarter_round(s, 3, 7, 11, 15)
        _quarter_round(s, 0, 5, 10, 15)
        _quarter_round(s, 1, 6, 11, 12)
        _quarter_round(s, 2, 7, 8, 13)
        _quarter_round(s, 3, 4, 9, 14)
    return [(s[i] + init[i]) & MASK32 for i in range(16)]


class StdRng:
    """ChaCha20Rng with rand_core's BlockRng buffering (4 blocks per refill)."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[i : i + 4], "little") for i in range(0, 32, 4)]
        self.counter = 0
        self.buf = []
        self.index = 64  # empty buffer -> refill on first use

    def _refill(self):
        out = []
        for _ in range(4):
            out.extend(chacha20_block(self.key, self.counter))
            self.counter += 1
        self.buf = out

    def next_u32(self):
        if self.index >= 64:
            self._refill()
            self.index = 0
        v = self.buf[self.index]
        self.index += 1
        return v

    def next_u64(self):
        # mirrors rand_core BlockRng::next_u64 (straddling the buffer edge
        # reads the last word, refills, then reads the first word)
        if self.index < 63:
            lo = self.buf[self.index] if self.index < len(self.buf) else None
            if lo is None:  # first use
                self._refill()
                self.index = 0
                lo = self.buf[0]
                hi = self.buf[1]
                self.index = 2
                return (hi << 32) | lo
            hi = self.buf[self.index + 1]
            self.index += 2
            return (hi << 32) | lo
        elif self.index >= 64:
            self._refill()
            self.index = 2
            return (self.buf[1] << 32) | self.buf[0]
        else:  # index == 63
            lo = self.buf[63]
            self._refill()
            self.index = 1
            return (self.buf[0] << 32) | lo

    def gen_u128(self):
        lo = self.next_u64()
        hi = self.next_u64()
        return (hi << 64) | lo


class UniformU128:
    """rand 0.7 UniformInt<u128> over [low, high) via widening multiply."""

    def __init__(self, low, high):
        self.low = low
        self.range = (high - low) & MASK128
        if self.range > 0:
            ints_to_reject = ((MASK128 - self.range + 1) % self.range) & MASK128
            self.zone = MASK128 - ints_to_reject
        else:
            self.zone = MASK128

    def sample(self, rng: StdRng):
        if self.range == 0:
            return rng.gen_u128()
        while True:
            v = rng.gen_u128()
            prod = v * self.range
            hi, lo = prod >> 128, prod & MASK128
            if lo <= self.zone:
                return (self.low + hi) & MASK128


class UniformU64:
    """rand 0.7 UniformInt<usize/u64> over [low, high)."""

    def __init__(self, low, high):
        self.low = low
        self.range = (high - low) & MASK64
        if self.range > 0:
            ints_to_reject = ((MASK64 - self.range + 1) % self.range) & MASK64
            self.zone = MASK64 - ints_to_reject
        else:
            self.zone = MASK64

    def sample(self, rng: StdRng):
        if self.range == 0:
            return rng.next_u64()
        while True:
            v = rng.next_u64()
            prod = v * self.range
            hi, lo = prod >> 64, prod & MASK64
            if lo <= self.zone:
                return (self.low + hi) & MASK64


def prng(seed: bytes, modulus: int) -> int:
    """field::prng - one uniform field element from a 32-byte seed."""
    return UniformU128(0, modulus).sample(StdRng(seed))


def prng_vector(seed: bytes, length: int, modulus: int):
    """field::prng_vector - `length` uniform field elements from one seed."""
    rng = StdRng(seed)
    dist = UniformU128(0, modulus)
    return [dist.sample(rng) for _ in range(length)]


def usize_iter(seed: bytes, bound: int):
    """Infinite iterator of uniform usize values in [0, bound) from one seed."""
    rng = StdRng(seed)
    dist = UniformU64(0, bound)
    while True:
        yield dist.sample(rng)
