"""The mesh the prover splits its stages over: the port of
distaff_tpu/parallel/mesh.py.

The prover's two parallel axes map onto the mesh as in the JAX package:
the trace's registers through the LDE (each slot extends its registers,
no communication), and the rows of every pointwise stage after it
(constraint evaluation, DEEP composition, FRI folds), with one all-to-all
between the two layouts.

The JAX package's mesh is single-controller: one process holds a
jax.sharding.Mesh of every device, places arrays with NamedSharding and
lets XLA insert the collectives.  Here one process drives an ordered list
of slots.  A slot is a torch.device and, on a card, a torch.cuda.Stream of
its own, also where several slots share one card, so that a missing wait
between slots shows on one card too.  A value split over the mesh is a
`Sharded`: one tensor a slot and the dimension it is split along.  Every
collective is a copy from one slot to another (Mesh.copy_): the
destination slot's stream waits for the source slot's; between cards it is
a peer copy, on one card a device-local one.  Every kernel launch on a
slot runs under Slot.run(): torch.cuda.device of its card and
torch.cuda.stream of its stream (the kernels' wrappers launch on the
current stream of the tensor's device, ops/cuda_lib.stream).  A stage runs
under Mesh.stage(): at its start the slots' streams wait for what the
caller queued, at its end the caller's streams wait for the slots.

DISTAFF_MESH_DEVICES chooses the prover's mesh (configured_mesh):
- unset, or N <= 1: none, single-device proving;
- N: N slots of the prover's device type: cards 0..N-1, raising where the
  machine has fewer (the JAX package takes its virtual CPU devices there;
  the port proves on the CPU only where the caller asks for it), or N CPU
  slots with device="cpu";
- a comma-separated device list, such as cuda:0,cuda:0,cuda:0,cuda:0:
  exactly those slots, all of the prover's device type.  This is the
  counterpart of make_mesh(devices=...) over the JAX package's virtual
  devices (its tests force 8 on the host): a mesh that names one card
  several times runs every sharded stage, every copy between slots and
  every launch at a slot's rows on that card, but cannot show scaling, peer
  copies between cards or each card's own one-time kernel setup.
Proofs are byte for byte the same with and without a mesh: a mesh only
changes where the same field arithmetic runs.

Each stage runs on the mesh wherever its operand splits over the slots
(ntt_sharded.fits, mesh_stages.transition_fits, fold_fits, subtree_fits),
and whole on the home slot elsewhere.  The JAX package's DISTAFF_MESH_NTT
and DISTAFF_MESH_AIR, which keep its virtual CPU meshes clear of slow
XLA:CPU compiles, have no counterpart: the port compiles nothing there.
"""

import contextlib
import os

import numpy as np
import torch

from ..math import field
from ..math import field_torch as ft


class Slot:
    """One place of the mesh: a device and, on a card, a stream of its own."""

    def __init__(self, index, device):
        self.index = index
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def run(self):
        """The context of a launch on this slot."""
        if self.stream is None:
            return contextlib.nullcontext()
        return _launch_context(self.device, self.stream)


@contextlib.contextmanager
def _launch_context(device, stream):
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


class Mesh:
    """A 1-D mesh: an ordered list of slots, all on the CPU or all on cards."""

    def __init__(self, devices):
        devices = [torch.device(d) for d in devices]
        kinds = {d.type for d in devices}
        if not devices or len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh's slots are all on the CPU or all on cards, got "
                             f"{[str(d) for d in devices]}")
        if "cuda" in kinds:
            if not torch.cuda.is_available():
                raise RuntimeError("a mesh of cards: no CUDA device is available")
            devices = [torch.device("cuda", torch.cuda.current_device() if d.index is None
                                    else d.index) for d in devices]
            count = torch.cuda.device_count()
            missing = sorted({str(d) for d in devices if d.index >= count})
            if missing:
                raise RuntimeError(f"a mesh on {missing}: the machine has {count} card(s)")
        self.slots = [Slot(i, d) for i, d in enumerate(devices)]
        self._depth = 0
        self._callers = None

    @property
    def size(self):
        return len(self.slots)

    @property
    def home(self):
        """Slot 0's device: where the prover keeps what is not split."""
        return self.slots[0].device

    def devices(self):
        """The distinct devices of the slots, in order."""
        return list(dict.fromkeys(s.device for s in self.slots))

    def names(self):
        return tuple(str(s.device) for s in self.slots)

    def splits(self, n):
        """Whether n rows split into equal whole shares, one a slot."""
        return n >= self.size and n % self.size == 0

    @contextlib.contextmanager
    def stage(self):
        """A sharded stage: the slots' streams wait for the callers' streams
        at its start, and the callers' for the slots' at its end (the
        outermost of nested stages does both)."""
        outer = self._depth == 0
        if outer:
            self._fork()
        self._depth += 1
        try:
            yield self
        finally:
            self._depth -= 1
            if outer:
                self._join()

    def _fork(self):
        if self.slots[0].stream is None:
            return
        self._callers = {d: torch.cuda.current_stream(d) for d in self.devices()}
        for s in self.slots:
            s.stream.wait_stream(self._callers[s.device])

    def _join(self):
        if self._callers is None:
            return
        for s in self.slots:
            self._callers[s.device].wait_stream(s.stream)
        self._callers = None

    def copy_(self, dst, dst_slot, src, src_slot):
        """dst (on slot dst_slot's device) <- src (on slot src_slot's), after
        what src_slot queued; returns dst."""
        a, b = self.slots[src_slot], self.slots[dst_slot]
        if b.stream is None:
            return dst.copy_(src)
        if a is not b:
            b.stream.wait_stream(a.stream)
        if a.device == b.device:
            with b.run():
                dst.copy_(src)
            if a is not b:
                src.record_stream(b.stream)
        else:
            # PyTorch's copy between cards runs on the source card's current
            # stream, between waits on both cards' current streams
            with a.run(), b.run():
                dst.copy_(src)
            dst.record_stream(a.stream)
        return dst

    def empty(self, slot, shape):
        """An uninitialized limb tensor on a slot, from its stream's memory."""
        with self.slots[slot].run():
            return torch.empty(shape, dtype=torch.uint32, device=self.slots[slot].device)

    def scatter(self, x, dim, axis, pad_to=None):
        """Split a tensor on the home device into equal shares along `dim`,
        one a slot (after zero padding to `pad_to` along it, where given)."""
        total = x.shape[dim] if pad_to is None else pad_to
        if total % self.size:
            raise ValueError(f"scatter: {total} does not split over {self.size} slots")
        share = total // self.size
        parts = []
        with self.stage():
            for s in range(self.size):
                shape = list(x.shape)
                shape[dim] = share
                part = self.empty(s, shape)
                real = max(0, min(share, x.shape[dim] - s * share))
                if real < share:
                    with self.slots[s].run():
                        part.narrow(dim, real, share - real).zero_()
                if real:
                    self.copy_(part.narrow(dim, 0, real), s, x.narrow(dim, s * share, real), 0)
                parts.append(part)
        return Sharded(self, parts, dim, axis)


class Sharded:
    """A value split over a mesh: parts[s] on slot s, equal shares along
    dimension `dim`; `axis` names what is split ("rows", "registers" or
    "columns", the second axis of a four-step transform's matrix)."""

    def __init__(self, mesh, parts, dim, axis):
        if len(parts) != mesh.size:
            raise ValueError(f"{len(parts)} parts for {mesh.size} slots")
        self.mesh = mesh
        self.parts = list(parts)
        self.dim = dim
        self.axis = axis

    def share(self):
        return self.parts[0].shape[self.dim]

    def gather(self, length=None):
        """The whole value on the home device (its first `length` along the
        split dimension, where given)."""
        mesh = self.mesh
        shape = list(self.parts[0].shape)
        shape[self.dim] = self.share() * mesh.size if length is None else length
        out = mesh.empty(0, shape)
        with mesh.stage():
            for s, part in enumerate(self.parts):
                lo = s * self.share()
                real = min(self.share(), shape[self.dim] - lo)
                if real > 0:
                    mesh.copy_(out.narrow(self.dim, lo, real), 0, part.narrow(self.dim, 0, real),
                               s)
        return out


def configured_mesh(device="cuda"):
    """The mesh the prover runs on, from DISTAFF_MESH_DEVICES (the module's
    docstring), or None; `device` is the prover's."""
    spec = os.environ.get("DISTAFF_MESH_DEVICES", "").strip()
    if not spec:
        return None
    kind = torch.device(device).type
    if spec.isdigit():
        return make_mesh(int(spec), device=kind) if int(spec) > 1 else None
    names = [name.strip() for name in spec.split(",")]
    devices = [torch.device(name) for name in names]
    if any(d.type != kind for d in devices):
        raise ValueError(f"DISTAFF_MESH_DEVICES={spec}: every slot must be on the prover's "
                         f"device type, {kind}")
    return make_mesh(devices=devices) if len(devices) > 1 else None


_MESHES = {}


def make_mesh(n_devices=None, devices=None, device="cuda"):
    """A 1-D mesh over `devices`, or the first n_devices of `device`'s type:
    cards 0..n-1 (raising where there are fewer), or n CPU slots.  Meshes
    are kept by their devices, so that a process's proofs reuse the slots'
    streams."""
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh(device='cuda'): no CUDA device is available")
            count = torch.cuda.device_count()
            n = count if n_devices is None else n_devices
            if count < n:
                raise RuntimeError(f"requested {n} cards but only {count} available")
            devices = [f"cuda:{i}" for i in range(n)]
        else:
            devices = ["cpu"] * (n_devices or 1)
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    key = tuple(str(torch.device(d)) for d in devices)
    if key not in _MESHES:
        _MESHES[key] = Mesh(devices)
    return _MESHES[key]


def registers_to_rows(regs, count):
    """The all-to-all from register shares to row shares: regs splits (R',
    D, 4) over its slots by register, each slot's share of R'/k of them;
    returns the first `count` registers split by rows, (count, D/k, 4) a
    slot."""
    mesh = regs.mesh
    k, share = mesh.size, regs.share()
    rows = regs.parts[0].shape[1] // k
    parts = [mesh.empty(t, (count, rows, 4)) for t in range(k)]
    with mesh.stage():
        for s, part in enumerate(regs.parts):
            real = min(share, count - s * share)
            if real <= 0:
                continue
            for t in range(k):
                mesh.copy_(parts[t][s * share: s * share + real], t,
                           part[:real, t * rows:(t + 1) * rows], s)
    return Sharded(mesh, parts, 1, "rows")


def extend_registers(regs, n, domain, mesh):
    """Each slot's registers interpolated and evaluated over the domain by
    K1: regs (R, n, 4) on the home device, padded with zero registers to a
    multiple of the slots (a zero register extends to zeros).  Returns the
    (polynomials, evaluations) split by register."""
    from ..ops import tiles

    k = mesh.size
    regs = mesh.scatter(regs, 0, "registers", -(-regs.shape[0] // k) * k)
    root_n, root_d = field.get_root_of_unity(n), field.get_root_of_unity(domain)
    polys, lde = [], []
    with mesh.stage():
        for slot, part in zip(mesh.slots, regs.parts):
            with slot.run():
                p = tiles.intt_batched(part, root_n)
                polys.append(p)
                lde.append(tiles.ntt_batched(p, root_d, n=domain))
    return Sharded(mesh, polys, 0, "registers"), Sharded(mesh, lde, 0, "registers")


def sharded_lde(registers_dev, extension_factor, mesh):
    """Low-degree-extend all registers with the register axis sharded.

    registers_dev: (R, N, 4) uint32 limbs on the home device; returns the
    (R', N * ext, 4) evaluations split by register, R' the registers padded
    with zero registers to a multiple of the slots."""
    n = registers_dev.shape[1]
    return extend_registers(registers_dev, n, n * extension_factor, mesh)[1]


def sharded_composition(lde, weights1, weights2, z, next_z, mesh):
    """Pointwise DEEP-composition core with the domain rows sharded: lde
    split by register (sharded_lde's), the weights host ints a register
    and z, next_z host ints.  The layout change from register shares to row
    shares is the all-to-all; then each slot, over its rows x of the
    domain, forms sum_i w1_i lde_i / (x - z) + sum_i w2_i lde_i / (x -
    next_z), the two inverse columns by one launch of kernel K6 and the
    rest on K2.
    Returns the (D, 4) column split by rows."""
    from ..ops import field_kernels as fk

    regs = len(weights1)
    rows = registers_to_rows(lde, regs)
    n = rows.share() * mesh.size
    root = field.get_root_of_unity(n)
    out = []
    with mesh.stage():
        for slot, part in zip(mesh.slots, rows.parts):
            with slot.run():
                device, share = slot.device, part.shape[1]
                first = slot.index * share
                w1 = ft.from_ints(np.array(weights1, dtype=object), device)
                w2 = ft.from_ints(np.array(weights2, dtype=object), device)
                a1 = a2 = None
                for i in range(regs):
                    t1, t2 = fk.mul(part[i], w1[i]), fk.mul(part[i], w2[i])
                    a1 = t1 if a1 is None else fk.add(a1, t1)
                    a2 = t2 if a2 is None else fk.add(a2, t2)
                xs = fk.power_series(root, share, device, field.exp(root, first))
                points = ft.from_ints(np.array([[z], [next_z]], dtype=object), device)
                u, v = fk.inv_batch(fk.sub(xs[None], points))
                out.append(fk.add(fk.mul(a1, u), fk.mul(a2, v)))
    return Sharded(mesh, out, 0, "rows")


def dryrun_step(n_devices, trace_registers=None, devices=None, device="cuda"):
    """One sharded proving step on tiny shapes: one transform split over
    every slot (a four-step NTT with its all-to-all) and back, the
    register-sharded LDE, and the row-sharded composition core with the
    all-to-all between.  The mesh is make_mesh(n_devices, devices, device).
    Returns the composition, (D, 4) on the home device."""
    from . import ntt_sharded as ns

    mesh = make_mesh(n_devices, devices, device)
    k = mesh.size

    # intra-NTT sharding: one transform split across all slots (the slot
    # count must divide the transform's row factor: a power of two)
    if k & (k - 1) == 0:
        rng0 = np.random.default_rng(42)
        size = max(256, 16 * k)
        big = ft.from_ints(rng0.integers(0, 2**63, size=(size,)).astype(object), mesh.home)
        ns.intt_sharded(ns.ntt_sharded(big, mesh), mesh)

    n = 64
    ext = 16
    num_regs = max(16, 2 * k)
    num_regs = ((num_regs + k - 1) // k) * k

    if trace_registers is None:
        rng = np.random.default_rng(0)
        values = rng.integers(0, 2**63, size=(num_regs, n)).astype(object)
        trace_registers = ft.from_ints(values, mesh.home)

    lde = sharded_lde(trace_registers, ext, mesh)

    rng = np.random.default_rng(1)
    w1 = [int(v) for v in rng.integers(0, 2**63, size=(num_regs,))]
    w2 = [int(v) for v in rng.integers(0, 2**63, size=(num_regs,))]
    return sharded_composition(lde, w1, w2, 123456789, 987654321, mesh).gather()
