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

In a multi-process job (dist_setup.py) the mesh is the JAX package's mesh
over every process's devices: DISTAFF_MESH_DEVICES=N takes the first N
ranks, one slot a rank in rank order, and a rank beyond them proves whole
on its own device.  Every rank builds the same Mesh and runs the same
stages on the same host values, but launches only on its own slot (the
local one); another rank's part of a Sharded is a placeholder, a tensor of
the meta device with the part's shape, that no code reads.  Each rank's
home is its own slot, and what the single-process mesh brings to slot 0 a
job brings to every rank's home, since every rank's transcript needs it:
a gather is an all-gather, and a scatter from home moves nothing (each
rank keeps its share of the value it holds whole).  A copy between slots
of two ranks is a send on the one and a receive on the other, over
torch.distributed; the copies of one reshard are posted together
(Mesh.exchange: batch_isend_irecv, waited once), as int32 views of the
limbs (gloo takes no uint32), through pinned host memory where gloo
carries a card's tensors.

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

from .. import dist_setup
from ..math import field
from ..math import field_torch as ft


class Slot:
    """One place of the mesh: a device and, on a card of this process, a
    stream of its own; `rank` is the process that holds it in a job (None
    in a single-process mesh), and `local` whether this process does."""

    def __init__(self, index, device, rank=None):
        self.index = index
        self.device = device
        self.rank = rank
        self.local = _local(rank)
        self.stream = (torch.cuda.Stream(device) if self.local and device.type == "cuda"
                       else None)

    def run(self):
        """The context of a launch on this slot."""
        if self.stream is None:
            return contextlib.nullcontext()
        return _launch_context(self.device, self.stream)


def _local(rank):
    """Whether a slot of this rank (None: of a single-process mesh) is this
    process's."""
    return rank is None or rank == dist_setup.job().rank


@contextlib.contextmanager
def _launch_context(device, stream):
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _placeholder(value):
    """Another rank's counterpart of a local result: meta tensors of its
    shapes."""
    if isinstance(value, (tuple, list)):
        return type(value)(_placeholder(v) for v in value)
    return torch.empty_like(value, device="meta")


class Mesh:
    """A 1-D mesh: an ordered list of slots, all on the CPU or all on cards;
    with `ranks`, slot i held by process ranks[i] of the job."""

    def __init__(self, devices, ranks=None):
        devices = [torch.device(d) for d in devices]
        kinds = {d.type for d in devices}
        if not devices or len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh's slots are all on the CPU or all on cards, got "
                             f"{[str(d) for d in devices]}")
        ranks = [None] * len(devices) if ranks is None else list(ranks)
        local = [_local(r) for r in ranks]
        if not any(local):
            raise ValueError("this process holds no slot of the mesh")
        if "cuda" in kinds:
            if not torch.cuda.is_available():
                raise RuntimeError("a mesh of cards: no CUDA device is available")
            devices = [torch.device("cuda", torch.cuda.current_device())
                       if mine and d.index is None else d for d, mine in zip(devices, local)]
            count = torch.cuda.device_count()
            missing = sorted({str(d) for d, mine in zip(devices, local)
                              if mine and d.index >= count})
            if missing:
                raise RuntimeError(f"a mesh on {missing}: the machine has {count} card(s)")
        self.slots = [Slot(i, d, r) for i, (d, r) in enumerate(zip(devices, ranks))]
        self.in_job = ranks[0] is not None
        self.home_index = local.index(True)
        self._depth = 0
        self._callers = None
        self._exchange = None

    @property
    def size(self):
        return len(self.slots)

    @property
    def home(self):
        """The home slot's device: where the prover keeps what is not split
        (slot 0, or in a job this rank's own slot)."""
        return self.slots[self.home_index].device

    def local_slots(self):
        return [s for s in self.slots if s.local]

    def devices(self):
        """The distinct devices of this process's slots, in order."""
        return list(dict.fromkeys(s.device for s in self.local_slots()))

    def device_count(self):
        """The distinct devices of the mesh, over every process."""
        if self.in_job:
            return len(set(dist_setup.job().places[:self.size]))
        return len(self.devices())

    def names(self):
        if self.in_job:
            return tuple(f"rank{s.rank}:{s.device}" for s in self.slots)
        return tuple(str(s.device) for s in self.slots)

    def splits(self, n):
        """Whether n rows split into equal whole shares, one a slot."""
        return n >= self.size and n % self.size == 0

    def each(self, fn, *per_slot):
        """[fn(slot, its entry of each list in per_slot)] over the slots,
        each under its launch context; another rank's slot gets a
        placeholder of this rank's result."""
        out = [None] * self.size
        for slot in self.local_slots():
            with slot.run():
                out[slot.index] = fn(slot, *(p[slot.index] for p in per_slot))
        if self.in_job:
            fill = _placeholder(out[self.home_index])
            out = [fill if not s.local else v for s, v in zip(self.slots, out)]
        return out

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
        if self.slots[self.home_index].stream is None:
            return
        self._callers = {d: torch.cuda.current_stream(d) for d in self.devices()}
        for s in self.local_slots():
            s.stream.wait_stream(self._callers[s.device])

    def _join(self):
        if self._callers is None:
            return
        for s in self.local_slots():
            self._callers[s.device].wait_stream(s.stream)
        self._callers = None

    @contextlib.contextmanager
    def exchange(self):
        """The copies between slots of two ranks made inside are posted
        together when it ends, and waited for (a reshard's all-to-all);
        outside a job it does nothing."""
        if not self.in_job:
            yield self
            return
        if self._exchange is not None:
            raise RuntimeError("Mesh.exchange() inside another: its copies would land only at "
                               "the outer one's end")
        self._exchange = _Exchange()
        try:
            yield self
            self._exchange.post()
        finally:
            self._exchange = None

    def _remote(self):
        if self._exchange is None:
            raise RuntimeError("a copy between two ranks' slots outside Mesh.exchange()")
        return self._exchange

    def copy_(self, dst, dst_slot, src, src_slot):
        """dst (on slot dst_slot's device) <- src (on slot src_slot's), after
        what src_slot queued; returns dst.  Between two ranks' slots a send
        or a receive of the open exchange; between two other ranks' slots
        nothing."""
        a, b = self.slots[src_slot], self.slots[dst_slot]
        if not (a.local and b.local):
            if a.local:
                self._remote().send(src, a, b.rank)
            elif b.local:
                self._remote().receive(dst, b, a.rank)
            return dst
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

    def from_home(self, dst, dst_slot, src):
        """dst (on slot dst_slot) <- src, a value on the home device; in a
        job every rank holds it there, and each copies it onto its own
        slots only."""
        if self.slots[dst_slot].local:
            self.copy_(dst, dst_slot, src, self.home_index)
        return dst

    def to_home(self, dst, src, src_slot):
        """dst (on the home device) <- src (on slot src_slot's); in a job
        every rank's home: the owner sends src to every other rank of the
        mesh in the open exchange."""
        owner = self.slots[src_slot]
        if not owner.local:
            self._remote().receive(dst, self.slots[self.home_index], owner.rank)
            return dst
        self.copy_(dst, self.home_index, src, src_slot)
        for s in self.slots:
            if not s.local:
                self._remote().send(src, owner, s.rank)
        return dst

    def empty(self, slot, shape, dtype=torch.uint32):
        """An uninitialized tensor on a slot, from its stream's memory (for
        another rank's slot, a placeholder)."""
        if not self.slots[slot].local:
            return torch.empty(shape, dtype=dtype, device="meta")
        with self.slots[slot].run():
            return torch.empty(shape, dtype=dtype, device=self.slots[slot].device)

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
                if real < share and self.slots[s].local:
                    with self.slots[s].run():
                        part.narrow(dim, real, share - real).zero_()
                if real:
                    self.from_home(part.narrow(dim, 0, real), s, x.narrow(dim, s * share, real))
                parts.append(part)
        return Sharded(self, parts, dim, axis)

    def min_over_ranks(self, value):
        """The least of every rank's host int `value` (non-negative, below
        2^64); outside a job, value."""
        if not self.in_job:
            return value
        home = self.slots[self.home_index]
        with home.run():
            words = torch.tensor([[value >> 32, value & 0xFFFFFFFF]], dtype=torch.int64).to(
                torch.uint32).to(home.device)
        parts = [words if s.local else _placeholder(words) for s in self.slots]
        every = Sharded(self, parts, 0, "ranks").gather().cpu().to(torch.int64)
        return min(int(hi) << 32 | int(lo) for hi, lo in every.tolist())


# the exchanges between ranks this process posted, and the bytes it sent
# and received in them (chip_smoke.py phase 11 reads and resets them)
EXCHANGES = {"posts": 0, "sent": 0, "received": 0}


class _Exchange:
    """The sends and receives of one reshard between ranks, posted together
    (torch.distributed.batch_isend_irecv) and waited for once.  The k-th
    message from one rank to another pairs with the k-th receive there:
    every rank makes the copies in the same order, and tags each message
    with its number for its pair of ranks."""

    def __init__(self):
        self.host = dist_setup.job().backend == "gloo"    # gloo carries only host tensors
        self.ops = []                       # (kind, wire tensor, peer, tag, slot)
        self.after = []                     # (slot, dst, wire) of each staged receive
        self.sent, self.got = {}, {}

    def _tag(self, counts, peer):
        counts[peer] = counts.get(peer, 0) + 1
        return counts[peer] - 1

    def send(self, src, slot, peer):
        if src.numel() == 0:
            return
        with slot.run():
            if self.host and src.device.type == "cuda":
                wire = torch.empty(src.shape, dtype=torch.int32, pin_memory=True)
                wire.copy_(src.view(torch.int32), non_blocking=True)
            else:
                wire = src.contiguous().view(torch.int32)
                if slot.stream is not None:
                    wire.record_stream(slot.stream)
        self.ops.append(("send", wire, peer, self._tag(self.sent, peer), slot))

    def receive(self, dst, slot, peer):
        if dst.numel() == 0:
            return
        with slot.run():
            if self.host and dst.device.type == "cuda":
                wire = torch.empty(dst.shape, dtype=torch.int32, pin_memory=True)
            elif dst.is_contiguous():
                wire = dst.view(torch.int32)
            else:
                wire = torch.empty(dst.shape, dtype=torch.int32, device=dst.device)
        self.ops.append(("receive", wire, peer, self._tag(self.got, peer), slot))
        if wire.data_ptr() != dst.data_ptr() or wire.device != dst.device:
            self.after.append((slot, dst, wire))

    def post(self):
        import torch.distributed as dist

        if not self.ops:
            return
        EXCHANGES["posts"] += 1
        for kind, wire, *_ in self.ops:
            EXCHANGES["sent" if kind == "send" else "received"] += wire.numel() * 4
        # every staged send must be on the host (gloo) or queued before the
        # collective's stream (nccl): post on the slots' streams
        slots = {id(slot): slot for *_, slot in self.ops}.values()
        if self.host:
            for slot in slots:
                if slot.stream is not None:
                    slot.stream.synchronize()
        home = next(iter(slots))
        with home.run():
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend if kind == "send" else dist.irecv, wire, peer, tag=tag)
                for kind, wire, peer, tag, _ in self.ops])
            for work in works:
                work.wait()
        for slot, dst, wire in self.after:
            with slot.run():
                dst.view(torch.int32).copy_(wire, non_blocking=True)


class Sharded:
    """A value split over a mesh: parts[s] on slot s, equal shares along
    dimension `dim`; `axis` names what is split ("rows", "registers" or
    "columns", the second axis of a four-step transform's matrix).  In a job
    another rank's part is a placeholder (parallel/mesh.py)."""

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
        split dimension, where given); in a job on every rank's home."""
        mesh = self.mesh
        mine = self.parts[mesh.home_index]
        shape = list(mine.shape)
        shape[self.dim] = self.share() * mesh.size if length is None else length
        out = mesh.empty(mesh.home_index, shape, mine.dtype)
        with mesh.stage(), mesh.exchange():
            for s, part in enumerate(self.parts):
                lo = s * self.share()
                real = min(self.share(), shape[self.dim] - lo)
                if real > 0:
                    mesh.to_home(out.narrow(self.dim, lo, real), part.narrow(self.dim, 0, real),
                                 s)
        return out


def configured_mesh(device="cuda"):
    """The mesh the prover runs on, from DISTAFF_MESH_DEVICES (the module's
    docstring), or None; `device` is the prover's.  In a job, N counts the
    job's ranks (it raises above them), and a rank beyond the first N gets
    None: it proves whole on its own device."""
    spec = os.environ.get("DISTAFF_MESH_DEVICES", "").strip()
    if not spec:
        return None
    kind = torch.device(device).type
    job = dist_setup.job()
    if job is not None:
        if not spec.isdigit():
            raise ValueError(f"DISTAFF_MESH_DEVICES={spec}: in a job, the mesh is a number of "
                             f"its ranks")
        n = int(spec)
        if n > job.world:
            raise RuntimeError(f"DISTAFF_MESH_DEVICES={n}: the job has {job.world} rank(s)")
        job.bind(kind)                  # every rank, also those beyond the mesh
        return make_mesh(n, device=kind) if 1 < n and job.rank < n else None
    if spec.isdigit():
        return make_mesh(int(spec), device=kind) if int(spec) > 1 else None
    names = [name.strip() for name in spec.split(",")]
    devices = [torch.device(name) for name in names]
    if any(d.type != kind for d in devices):
        raise ValueError(f"DISTAFF_MESH_DEVICES={spec}: every slot must be on the prover's "
                         f"device type, {kind}")
    return make_mesh(devices=devices) if len(devices) > 1 else None


# the meshes made so far, by their slots' devices (in a job, by the ranks
# whose slots they hold)
_MESHES = {}


def make_mesh(n_devices=None, devices=None, device="cuda"):
    """A 1-D mesh over `devices`, or the first n_devices of `device`'s type:
    in a job the first n ranks' devices (every rank, where n_devices is
    None), one slot a rank; else cards 0..n-1 (raising where there are
    fewer), or n CPU slots.  Meshes are kept, so that a process's proofs
    reuse the slots' streams."""
    job = dist_setup.job()
    if devices is None and job is not None:
        job.bind(device)
        n = job.world if n_devices is None else n_devices
        if not 0 < n <= job.world or job.rank >= n:
            raise ValueError(f"rank {job.rank} holds no slot of a mesh of the first {n} of "
                             f"{job.world} ranks")
        key = ("job", job.rank, n)
        if key not in _MESHES:
            _MESHES[key] = Mesh(job.devices[:n], ranks=range(n))
        return _MESHES[key]
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
    with mesh.stage(), mesh.exchange():
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

    def extend(slot, part):
        p = tiles.intt_batched(part, root_n)
        return p, tiles.ntt_batched(p, root_d, n=domain)

    with mesh.stage():
        polys, lde = zip(*mesh.each(extend, regs.parts))
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

    def compose(slot, part):
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
        return fk.add(fk.mul(a1, u), fk.mul(a2, v))

    with mesh.stage():
        return Sharded(mesh, mesh.each(compose, rows.parts), 0, "rows")


def dryrun_step(n_devices, trace_registers=None, devices=None, device="cuda"):
    """One sharded proving step on tiny shapes: one transform split over
    every slot (a four-step NTT with its all-to-all) and back, the
    register-sharded LDE, and the row-sharded composition core with the
    all-to-all between.  The mesh is make_mesh(n_devices, devices, device)
    (in a job, over the first n_devices ranks).  Returns the composition,
    (D, 4) on the home device (in a job, on every rank's)."""
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
