"""Execution-trace table with a device-resident low-degree extension.

The trace arrives from the native VM as (R, n, 2) uint64 words; `extend()`
runs the per-register iNTT -> zero-pad -> NTT pipeline on the device (the
dominant cost of proving, reference src/stark/trace/trace_table.rs:143-169)
and keeps the whole (R, n * ext, 4) LDE there.  Row hashing for the Merkle
commitment reads the limb layout directly: uint32 limbs in little-endian
order are exactly the u128 LE bytes the reference hashes.
"""

import numpy as np
import torch

from ..math import field
from ..math import field_torch as ft
from ..config import (
    MAX_CONTEXT_DEPTH, MAX_LOOP_DEPTH, MAX_REGISTER_COUNT, MIN_EXTENSION_FACTOR,
)
from ..interop import limbs_from_numpy
from .trace_state import TraceState, compute_decoder_width

_LDE_RCHUNK = 8


class TraceTable:
    def __init__(self, registers_u64, ctx_depth, loop_depth, extension_factor):
        """`registers_u64`: (R, n, 2) uint64 array of little-endian u128
        halves, as native.execute_u64 returns it."""
        if extension_factor & (extension_factor - 1) or extension_factor < MIN_EXTENSION_FACTOR:
            raise ValueError(f"invalid extension factor {extension_factor}")
        if ctx_depth > MAX_CONTEXT_DEPTH or loop_depth > MAX_LOOP_DEPTH:
            raise ValueError("context or loop depth out of range")
        if registers_u64.ndim != 3 or registers_u64.dtype != np.uint64:
            raise ValueError("expected (R, n, 2) uint64 register words")

        reg_count, self.trace_length = registers_u64.shape[0], registers_u64.shape[1]
        decoder_width = compute_decoder_width(ctx_depth, loop_depth)
        if not decoder_width < reg_count < MAX_REGISTER_COUNT:
            raise ValueError(f"register count {reg_count} out of range")
        if self.trace_length & (self.trace_length - 1):
            raise ValueError("trace length must be a power of two")
        self.stack_depth = reg_count - decoder_width
        self._register_count = reg_count

        self.registers_u64 = registers_u64
        self.ctx_depth = ctx_depth
        self.loop_depth = loop_depth
        self.extension_factor = extension_factor

        self.polys_dev = None               # (R, N, 4) device limb coefficients
        self.lde_dev = None                 # (R, N*ext, 4) device limb evaluations

    # geometry ------------------------------------------------------------------------------------

    def unextended_length(self):
        return self.trace_length

    def domain_size(self):
        return self.trace_length * self.extension_factor

    def register_count(self):
        return self._register_count

    def is_extended(self):
        return self.lde_dev is not None

    # states --------------------------------------------------------------------------------------

    def get_state(self, step):
        row = self.registers_u64[:, step, :]
        values = [int(row[i, 0]) | (int(row[i, 1]) << 64) for i in range(row.shape[0])]
        return TraceState.from_vec(
            self.ctx_depth, self.loop_depth, self.stack_depth, values)

    def get_last_state(self):
        return self.get_state(self.trace_length - 1)

    # low-degree extension ------------------------------------------------------------------------

    def extend(self, device):
        """Interpolate every register and evaluate it over the extended
        domain, on `device`."""
        if self.is_extended():
            raise RuntimeError("trace table has already been extended")
        device = torch.device(device)
        n = self.trace_length
        domain = self.domain_size()
        r_count = self._register_count
        lde_bytes = r_count * domain * 16
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            if lde_bytes > free:
                raise MemoryError(
                    f"the extended trace needs {lde_bytes} bytes of device memory, "
                    f"{free} are free")

        # LE u64 halves are LE u32 limbs: a view, no per-element conversion
        regs = limbs_from_numpy(
            np.ascontiguousarray(self.registers_u64).view(np.uint32).reshape(r_count, n, 4),
            device)
        self.polys_dev, self.lde_dev = self._extend_tiled(regs, n, domain)

    def _extend_tiled(self, regs, n, domain):
        """iNTT of all registers at once, then the domain-sized NTTs
        _LDE_RCHUNK registers at a time, so that the four-step temporaries
        stay a few times one chunk's LDE."""
        from ..ops import tiles

        r_count = regs.shape[0]
        root_n = field.get_root_of_unity(n)
        root_d = field.get_root_of_unity(domain)
        polys = tiles.intt_batched(regs, root_n)
        lde = torch.empty((r_count, domain, 4), dtype=torch.uint32, device=regs.device)
        for lo in range(0, r_count, _LDE_RCHUNK):
            chunk = polys[lo : lo + _LDE_RCHUNK]
            padded = torch.zeros((chunk.shape[0], domain, 4), dtype=torch.uint32,
                                 device=regs.device)
            padded[:, :n] = chunk
            lde[lo : lo + _LDE_RCHUNK] = tiles.ntt_batched(padded, root_d)
        return polys, lde

    def build_merkle_tree(self, hash_name):
        """Leaf digests and every tree level hashed on the device (kernel
        K3); only the root and the eventual openings reach the host."""
        if hash_name != "blake3":
            raise ValueError(f"the device trace commitment is blake3 only, not {hash_name}")
        from ..ops.blake3_torch import hash_trace_rows_dev
        from ..crypto.merkle_dev import DeviceMerkleTree
        return DeviceMerkleTree(hash_trace_rows_dev(self.lde_dev))

    def get_register_values_at_async(self, positions, batch):
        """Enqueue the extended-trace rows at the given positions on the
        caller's TransferBatch; returns a zero-arg closure producing the
        host-int rows."""
        from ..ops.gather import gather_rows_dev
        ref = batch.add(gather_rows_dev(self.lde_dev, positions, axis=1))   # (R, Q, 4)

        def result():
            ints = ft.to_ints(batch.get(ref))
            return [[int(ints[r][q]) for r in range(ints.shape[0])]
                    for q in range(ints.shape[1])]

        return result
