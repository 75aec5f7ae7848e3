"""One batched device-to-host copy for proof assembly.

Proof assembly (prover step 9) needs ~20 small device tensors on the host:
query-row gathers, Merkle leaf and node openings of every tree, FRI layer
rows.  `TransferBatch` collects them, packs them into one device buffer
and copies that to the host once, instead of one synchronizing copy per
tensor.  Values are untouched: this is transfer scheduling only.
"""

import torch


class TransferBatch:
    """add(tensor) -> ref; after fetch() (idempotent, the first call makes
    the single copy), get(ref) returns the host numpy array."""

    def __init__(self):
        self._items = []
        self._host = None

    def add(self, tensor):
        if self._host is not None:
            raise RuntimeError("batch already fetched")
        self._items.append(tensor)
        return len(self._items) - 1

    def fetch(self):
        if self._host is None:
            flat = [t.contiguous().view(torch.int32).reshape(-1) for t in self._items]
            packed = torch.cat(flat).cpu() if flat else torch.empty(0, dtype=torch.int32)
            self._host = []
            offset = 0
            for t, f in zip(self._items, flat):
                part = packed[offset : offset + f.numel()]
                self._host.append(part.view(t.dtype).reshape(t.shape).numpy())
                offset += f.numel()
        return self._host

    def get(self, ref):
        return self.fetch()[ref]
