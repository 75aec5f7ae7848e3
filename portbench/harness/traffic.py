"""The general generator of the benchmark's traffic: the requests of a
traffic file, drawn from the run's seed.

A request is a statement for the cell's program: its public inputs, field
elements drawn uniformly below M.  The same seed gives the same statements
in the same order.  The warm-up's statement is one fixed statement, the
same for every seed, so that set-up does the same work in every run (its
proof of work's search is as long each time) and takes none of the
window's statements.
"""

import numpy as np

M = 340282366920938463463374557953744961537
WARM_SEED = 0


class Traffic:
    def __init__(self, params, config, seed):
        self.params = params
        self.width = config["public_inputs"]
        window, sample = np.random.SeedSequence(int(seed)).spawn(2)
        self._window = np.random.default_rng(window)
        self.sample_rng = np.random.default_rng(sample)

    def warm_request(self):
        return field_elements(np.random.default_rng(WARM_SEED), self.width)

    def requests(self):
        """The window's statements, one after another, without end."""
        while True:
            yield field_elements(self._window, self.width)

    def sample(self, count):
        """The indexes of the requests whose proofs the check verifies: at
        most `checked_proofs` of `count`, drawn from the seed, the last
        request always among them."""
        k = min(count, self.params["checked_proofs"])
        others = self.sample_rng.permutation(count - 1)[:k - 1]
        return sorted(int(i) for i in others) + [count - 1]


def field_elements(rng, count):
    """`count` field elements uniform below M, by rejection from 128 bits."""
    out = []
    while len(out) < count:
        lo, hi = (int(v) for v in rng.integers(0, 2**64, size=2, dtype=np.uint64))
        value = (hi << 64) | lo
        if value < M:
            out.append(value)
    return out
