"""Execution-trace table with a device-resident low-degree extension.

The trace arrives from the native VM as (R, n, 2) uint64 words; `extend()`
runs the per-register iNTT -> zero-extended NTT pipeline on the device (the
dominant cost of proving, reference src/stark/trace/trace_table.rs:143-169)
and keeps the whole (R, n * ext, 4) LDE there.  Row hashing for the Merkle
commitment reads the limb layout directly: uint32 limbs in little-endian
order are exactly the u128 LE bytes the reference hashes.

Where the LDE would not fit (the streaming LDE of distaff_tpu/stark/
trace_table.py), only the coefficient polynomials are kept: the trace
commitment computes the LDE again four registers at a time (a 64-byte
BLAKE3 block of each row), absorbing each group into the rows' chaining
values and copying its points of the evaluation domain into a stride slice
(kernel K14), so the whole LDE never exists.  The query rows are then
evaluated from the polynomials (K8) and step 6 extends two weighted sums of
the coefficients (K15) in place of reading the LDE.  DISTAFF_STREAM_LDE
chooses: "1" streams, "0" never does (and raises MemoryError where the LDE
does not fit), "auto" (the default) streams where extend_bytes() exceeds
the budget: DISTAFF_HBM_BUDGET_BYTES where it is set, else the card's free
memory (on the CPU, no budget: auto never streams).

On a mesh (parallel/mesh.py) the budget is a device's, counted once for
each distinct device of the mesh (four slots on one card do not claim four
cards' memory); in a multi-process job the least of the ranks' budgets, so
that every rank makes the same choice.  Materialized, each slot extends its share of the
registers (padded with zero registers to a multiple of the slots), and one
all-to-all lays the LDE out by rows, `lde_rows`, a slot's rows of every
register; where the rows do not split over the slots it is gathered to
the home device instead.  Streaming, each group's transform is split over
the slots (parallel/ntt_sharded.py) and gathered for its absorb.
"""

import os

import numpy as np
import torch

from ..math import field
from ..math import field_torch as ft
from ..config import (
    MAX_CONSTRAINT_DEGREE, MAX_CONTEXT_DEPTH, MAX_LOOP_DEPTH, MAX_REGISTER_COUNT,
    MIN_EXTENSION_FACTOR,
)
from ..interop import limbs_from_numpy
from .trace_state import TraceState, compute_decoder_width

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
        self.mesh = None                    # the mesh the trace was extended on, or None
        self.lde_rows = None                # on a mesh: the LDE split by rows, (R, N*ext/k, 4)
        # streaming: lde_dev stays None, and the commitment writes the
        # evaluation domain's slice and the leaf digests
        self.streaming = False
        self.lde_stride_dev = None          # (R, N*8, 4) the LDE's points of D_ev
        self._leaf_digests = None           # (N*ext, 8) uint32

    # geometry ------------------------------------------------------------------------------------

    def unextended_length(self):
        return self.trace_length

    def domain_size(self):
        return self.trace_length * self.extension_factor

    def register_count(self):
        return self._register_count

    def is_extended(self):
        return self.lde_dev is not None or self.lde_rows is not None or (
            self.streaming and self.polys_dev is not None)

    def rows_mesh(self):
        """The mesh whose slots take the rows of D_ev and of the LDE domain
        (stages 3 to 9), or None: the trace's mesh where its rows split
        (parallel/mesh_stages.transition_fits)."""
        from ..parallel import mesh_stages

        n_ev = self.trace_length * MAX_CONSTRAINT_DEGREE
        mesh = self.mesh
        if mesh is None or mesh.size & (mesh.size - 1) or \
                not mesh_stages.transition_fits(n_ev, mesh):
            return None
        return mesh

    def ev_slice(self):
        """The trace over the evaluation domain D_ev, every (ext / 8)-th
        point of the LDE: a strided view of the LDE, or the slice that the
        streaming commitment wrote (on a mesh, gathered)."""
        if self.streaming:
            return self.lde_stride_dev
        if self.lde_rows is not None:
            from ..parallel import mesh_stages
            return mesh_stages.ev_rows(self, self.mesh).gather()
        return self.lde_dev[:, ::self.extension_factor // MAX_CONSTRAINT_DEGREE]

    # states --------------------------------------------------------------------------------------

    def get_state(self, step):
        row = self.registers_u64[:, step, :]
        values = [int(row[i, 0]) | (int(row[i, 1]) << 64) for i in range(row.shape[0])]
        return TraceState.from_vec(
            self.ctx_depth, self.loop_depth, self.stack_depth, values)

    def get_last_state(self):
        return self.get_state(self.trace_length - 1)

    # low-degree extension ------------------------------------------------------------------------

    def extend_bytes(self):
        """Device bytes the LDE holds at once at its size: the LDE and the
        NTT's scratch buffers of its size (one, and one more for each
        level of recursion above tiles.LEAF^2 points)."""
        from ..ops import tiles
        return self._register_count * self.domain_size() * 16 * tiles.ntt_buffers(
            self.domain_size())

    def _budget(self, device):
        """Device bytes the LDE may take: DISTAFF_HBM_BUDGET_BYTES where it
        is set, else the card's free memory; None (no limit) on the CPU."""
        budget = os.environ.get("DISTAFF_HBM_BUDGET_BYTES")
        if budget is not None:
            return int(budget)
        if device.type == "cuda":
            return torch.cuda.mem_get_info(device)[0]
        return None

    def extend(self, device, part=None, mesh=None):
        """Interpolate every register and evaluate it over the extended
        domain, on `device` (on a mesh, its home device), or when streaming
        only interpolate (the commitment extends the registers a group at
        a time).  `part`, if given, is called with the name of each part as
        it ends (the prover's step-1 part log)."""
        if self.is_extended():
            raise RuntimeError("trace table has already been extended")
        device = torch.device(device) if mesh is None else mesh.home
        self.mesh = mesh
        n = self.trace_length
        domain = self.domain_size()
        r_count = self._register_count
        lde_bytes = self.extend_bytes()
        budget = self._budget(device)
        if budget is not None and mesh is not None:
            # every rank of a job decides alike: the least rank's budget
            budget = mesh.min_over_ranks(budget) * mesh.device_count()
        over = budget is not None and lde_bytes > budget
        mode = os.environ.get("DISTAFF_STREAM_LDE", "auto")
        self.streaming = mode == "1" or (mode == "auto" and over)
        if over and not self.streaming:
            raise MemoryError(
                f"the extended trace needs {lde_bytes} bytes of device memory with the NTT's "
                f"scratch, the budget is {budget} (DISTAFF_STREAM_LDE={mode})")

        # LE u64 halves are LE u32 limbs: a view, no per-element conversion
        regs = limbs_from_numpy(
            np.ascontiguousarray(self.registers_u64).view(np.uint32).reshape(r_count, n, 4),
            device)
        if part:
            part("upload")
        if self.streaming:
            from ..ops import tiles

            self.polys_dev = tiles.intt_batched(regs, field.get_root_of_unity(n))
            if part:
                part("interpolation")
            return
        if mesh is not None:
            self._extend_mesh(regs, n, domain, part)
            return
        self.polys_dev, self.lde_dev = self._extend_tiled(regs, n, domain, part)

    def _extend_mesh(self, regs, n, domain, part=None):
        """The register-split LDE (K1 on each slot's registers), the
        polynomials gathered to the home device, and the LDE laid out by
        rows (one all-to-all) or, where the rows do not split, gathered."""
        from ..parallel import mesh as pm

        r_count = self._register_count
        polys, lde = pm.extend_registers(regs, n, domain, self.mesh)
        self.polys_dev = polys.gather(r_count)
        if part:
            part("LDE (registers on the slots)")
        if self.rows_mesh() is not None:
            self.lde_rows = pm.registers_to_rows(lde, r_count)
        else:
            self.lde_dev = lde.gather(r_count)
        if part:
            part("all-to-all to rows")

    def _extend_tiled(self, regs, n, domain, part=None):
        """iNTT of all registers at once (two K1 passes, 1/n on the first
        one's store), then the domain-sized NTT of all of them, zero
        extended from n points inside K1, its second pass writing the LDE."""
        from ..ops import tiles

        polys = tiles.intt_batched(regs, field.get_root_of_unity(n))
        if part:
            part("interpolation")
        lde = tiles.ntt_batched(polys, field.get_root_of_unity(domain), n=domain)
        if part:
            part("LDE")
        return polys, lde

    def _stream_commit(self):
        """The streaming trace commitment: the LDE of four registers at a
        time (K1, zero-extended from the polynomials), each group absorbed
        as one 64-byte block of every row into the rows' chaining values,
        its points of D_ev copied into the stride slice on the way (one
        K14 launch), and freed before the next group; a two-chunk row's
        chunk 0 values are kept for the parent node that its last launch
        writes.  The finished values are the leaf digests."""
        from ..ops import blake3_torch as b3
        from ..ops import tiles

        r_count, domain = self._register_count, self.domain_size()
        shift = (self.extension_factor // MAX_CONSTRAINT_DEGREE).bit_length() - 1
        root = field.get_root_of_unity(domain)
        self.lde_stride_dev = torch.empty((r_count, domain >> shift, 4), dtype=torch.uint32,
                                          device=self.polys_dev.device)
        self._leaf_digests = b3.absorb_rows(
            lambda lo: self._extend_group(self.polys_dev[lo:lo + b3.BLOCK_REGISTERS], root),
            r_count, self.lde_stride_dev, shift)

    def _extend_group(self, polys, root):
        """A group's LDE for the streaming commitment: K1 on the home device,
        or on a mesh the transform split over the slots (four-step, parallel/
        ntt_sharded.py) and gathered for the absorb."""
        from ..ops import tiles
        from ..parallel import mesh_stages, ntt_sharded as ns

        domain = self.domain_size()
        mesh = self.mesh
        if mesh is not None and ns.fits(domain, mesh):
            columns = ns.transform(polys, mesh, root, domain)
            mesh_stages._record("stream_ntt", columns.axis, mesh)
            return ns.gather(columns, domain)
        return tiles.ntt_batched(polys, root, n=domain)

    def build_merkle_tree(self, hash_name):
        """The trace commitment: a leaf for each point of the LDE, the
        digest of every register's value there (crypto.merkle_dev.commit:
        on the device with blake3, else on the host).  Streaming, the
        leaves are the digests of the streaming pass (blake3 only, as in
        the JAX package)."""
        from ..crypto.merkle_dev import commit
        from ..parallel.mesh import Sharded

        mesh = self.rows_mesh()
        if self.streaming:
            if hash_name != "blake3":
                raise AssertionError("streaming commitment is blake3-only; set "
                                     "DISTAFF_STREAM_LDE=0 for other hash functions")
            if self._leaf_digests is None:
                self._stream_commit()
            leaves = self._leaf_digests
            return commit(leaves if mesh is None else mesh.scatter(leaves, 0, "rows"),
                          hash_name, leaves=True)
        if self.lde_rows is not None:
            return commit(Sharded(self.mesh, [p.permute(1, 0, 2) for p in self.lde_rows.parts],
                                  0, "rows"), hash_name)
        return commit(self.lde_dev.permute(1, 0, 2), hash_name)

    def get_register_values_at_async(self, positions, batch):
        """Enqueue the extended-trace rows at the given positions on the
        caller's TransferBatch (streaming: the polynomials evaluated at x =
        g^p, kernel K8); returns a zero-arg closure producing the host-int
        rows."""
        if self.streaming:
            from ..ops.deep_kernels import poly_eval
            root = field.get_root_of_unity(self.domain_size())
            rows = poly_eval(self.polys_dev, [field.exp(root, int(p)) for p in positions])
        elif self.lde_rows is not None:
            from ..parallel.mesh_stages import take
            rows = take(self.lde_rows, positions).transpose(0, 1)
        else:
            from ..ops.gather import gather_rows_dev
            rows = gather_rows_dev(self.lde_dev, positions, axis=1).transpose(0, 1)
        ref = batch.add(rows)                                      # (Q, R, 4)

        def result():
            return [[int(v) for v in row] for row in ft.to_ints(batch.get(ref))]

        return result
