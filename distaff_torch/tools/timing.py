"""Timing of kernels on the card, and seeded random field elements.

Shared by chip_smoke.py and the kernel bench.  Times come from CUDA events;
a spin kernel can hold the card while the host enqueues the timed
launches, so that the events measure the card and not the host's launch
rate (a K2 launch takes ~30 us on the card, less than the host needs to
launch it through ctypes)."""

import subprocess

import torch

# ~20 ms of spinning at 1.98 GHz: longer than the host takes to enqueue the
# launches of one trial.  A trial whose launches were not all queued before
# the spin ended runs again with half the calls (the stream's launch queue
# holds about a thousand launches: a host that fills it waits for the card),
# and once at one call, with a spin twice as long, up to MAX_SPIN_CYCLES.
QUEUE_AHEAD_CYCLES = 40_000_000
MAX_SPIN_CYCLES = 16 * QUEUE_AHEAD_CYCLES


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps, trials=1, queued=False):
    """Time of one fn() from CUDA events: the mean over `reps` back-to-back
    runs after a warm-up, and the median of `trials` such means.  With
    `queued`, a spin kernel first holds the card while the host enqueues
    the runs, and the card must not have reached the start event before the
    host has enqueued them all (else the trial runs again with fewer runs
    or a longer spin): the time is then the card's alone.  A function that
    waits for the card (a copy to the host, a synchronize) can never be
    queued so, and raises."""
    fn()
    torch.cuda.synchronize()
    means = []
    spin = QUEUE_AHEAD_CYCLES
    while len(means) < trials:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        started_early = queued and start.query()
        torch.cuda.synchronize()
        if started_early:
            if reps > 1:
                reps //= 2
            elif spin < MAX_SPIN_CYCLES:
                spin *= 2
            else:
                raise RuntimeError(f"time_ms: one call of {fn} was not queued within {spin} "
                                   f"cycles of spinning: the function waits for the card")
            continue
        means.append(start.elapsed_time(end) / reps)
    return sorted(means)[len(means) // 2]


def random_elements(gen, shape, device="cuda"):
    """Canonical field elements (< M) as (..., 4) uint32 limbs, from a
    seeded torch.Generator on `device`, with 0, 1, M-2 and M-1 in front."""
    from ..math import field_torch as ft

    limbs = torch.randint(0, 1 << 32, tuple(shape) + (4,), generator=gen,
                          device=device, dtype=torch.int64)
    limbs[..., 3] = limbs[..., 3] % 0xFFFFFFFF      # top limb below M's keeps x < M
    x = limbs.to(torch.uint32)
    flat = x.view(-1, 4)
    for i, v in enumerate((0, 1, ft.M - 2, ft.M - 1)):
        flat[i] = ft.constant(v, device)
    return x
