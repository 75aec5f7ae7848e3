"""Joining a multi-process proving job: the port of distaff_tpu/jax_setup.py's
initialize_distributed.

Every process of a job runs the same prover on the same host values, and
the mesh (parallel/mesh.py) puts one slot on each process, in rank order.
A process joins when its environment asks for it, in one of two ways, the
JAX package's:

  DISTAFF_COORDINATOR=host:port  DISTAFF_NUM_PROCESSES=N  DISTAFF_PROCESS_ID=K
      an explicit rendezvous at host:port (torch's tcp:// rendezvous; the
      process with id 0 serves it there)
  DISTAFF_DISTRIBUTED=1
      torch's env:// rendezvous: MASTER_ADDR, MASTER_PORT, RANK and
      WORLD_SIZE, as torchrun sets them

initialize_distributed() runs at `import distaff_torch` (as jax_setup.
configure() does at `import distaff_tpu`); without either variable it does
nothing.  The rendezvous waits at most DISTAFF_RENDEZVOUS_TIMEOUT seconds
(default 300) for the other processes, and raises after that; the process
group's collectives and exchanges have the same timeout.

The rendezvous does not yet fix the process's device: the prover's device
does, at the first proof on a mesh (Job.bind, from parallel/mesh.py).  A
rank on the card takes cuda:(LOCAL_RANK if set, else its process id) %
the card count; a rank on the CPU a CPU slot.  Every rank then posts its
placement to the rendezvous's store, and the backend follows from all of
them, the same on every rank:
- nccl where each rank has a card of its own;
- gloo where the ranks are on the CPU;
- gloo through pinned host memory where two ranks name the same card (the
  one-card counterpart of a mesh that names a card several times; NCCL
  refuses two ranks on one card).
A rank asked for the card on a machine without one raises.

jax_setup.configure()'s other work, the persistent XLA compilation cache,
has no counterpart: the port compiles nothing through XLA (its kernels are
built once a source into distaff_torch/_build/, build.py).
"""

import atexit
import datetime
import os
import socket
import sys

import torch

_DISTRIBUTED = False
_JOB = None


class Job:
    """The job this process joined: its rank, the number of ranks and the
    rendezvous's store; after bind(), its device, every rank's device and
    the backend."""

    def __init__(self, store, rank, world, local_rank, timeout):
        self.store = store
        self.rank = rank
        self.world = world
        self.local_rank = local_rank
        self.timeout = timeout
        self.backend = None
        self.device = None              # this rank's torch.device
        self.devices = None             # every rank's device, as a string
        self.places = None              # every rank's device: "cpu", or host/card uuid

    def bind(self, device):
        """Fix this rank's device for a prover on `device` ("cuda" or "cpu")
        and start the process group; later calls must name the same type."""
        import torch.distributed as dist

        kind = torch.device(device).type
        if self.backend is not None:
            if kind != self.device.type:
                raise ValueError(f"rank {self.rank} joined on {self.device}, not on {kind}")
            return self
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {self.rank}: asked for the card, but no CUDA device "
                                   f"is available")
            mine = torch.device("cuda", self.local_rank % torch.cuda.device_count())
            place = f"{socket.gethostname()}/{torch.cuda.get_device_properties(mine).uuid}"
        elif kind == "cpu":
            mine, place = torch.device("cpu"), "cpu"
        else:
            raise ValueError(f"a rank proves on the card or on the CPU, not on {kind}")
        self.store.set(f"distaff/placement/{self.rank}", f"{mine}|{place}")
        placements = [self.store.get(f"distaff/placement/{r}").decode().split("|")
                      for r in range(self.world)]
        kinds = {torch.device(d).type for d, _ in placements}
        if len(kinds) != 1:
            raise ValueError(f"the ranks of a job are all on the CPU or all on cards, got "
                             f"{[d for d, _ in placements]}")
        # NCCL takes one rank a card: two ranks on one card go over gloo
        shared = len({p for _, p in placements}) < self.world
        backend = "nccl" if kind == "cuda" and not shared else "gloo"
        options = {}
        if kind == "cuda":
            torch.cuda.set_device(mine)
            if backend == "nccl":
                options["device_id"] = mine
        dist.init_process_group(backend, store=self.store, rank=self.rank,
                                world_size=self.world, timeout=self.timeout, **options)
        atexit.register(_leave)
        self.backend, self.device = backend, mine
        self.devices = [d for d, _ in placements]
        self.places = [p for _, p in placements]
        print(f"distaff_torch: rank {self.rank} of {self.world} on {mine}, backend "
              f"{self.describe()}", file=sys.stderr, flush=True)
        return self

    def describe(self):
        """The backend, and how it carries a card's tensors."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo through pinned host memory (ranks share a card)"
        return self.backend


def _leave():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def job():
    """The Job this process joined, or None."""
    return _JOB


def initialize_distributed():
    """Join a multi-process job when the environment asks for it (the
    module's docstring).  Returns True when the process has joined."""
    global _DISTRIBUTED, _JOB
    if _DISTRIBUTED:
        return True
    coord = os.environ.get("DISTAFF_COORDINATOR")
    auto = os.environ.get("DISTAFF_DISTRIBUTED") == "1"
    if not coord and not auto:
        return False
    import torch.distributed as dist

    timeout = datetime.timedelta(
        seconds=float(os.environ.get("DISTAFF_RENDEZVOUS_TIMEOUT", "300")))
    if coord:
        nproc = os.environ.get("DISTAFF_NUM_PROCESSES")
        pid = os.environ.get("DISTAFF_PROCESS_ID")
        if nproc is None or pid is None:
            raise RuntimeError(
                "DISTAFF_COORDINATOR is set but DISTAFF_NUM_PROCESSES / "
                "DISTAFF_PROCESS_ID are not; all three are required for an "
                "explicit multi-host rendezvous")
        store, rank, world = next(dist.rendezvous(
            f"tcp://{coord}", rank=int(pid), world_size=int(nproc), timeout=timeout))
    else:
        store, rank, world = next(dist.rendezvous("env://", timeout=timeout))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    # only mark joined once the rendezvous succeeded - a raise above must
    # leave the next call able to retry rather than report success
    _JOB = Job(store, rank, world, local_rank, timeout)
    _DISTRIBUTED = True
    return True
