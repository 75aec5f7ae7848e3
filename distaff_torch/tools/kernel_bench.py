"""Microbenchmark of the port's kernels: the counterpart of the JAX
package's tools/kernel_bench.py.

Usage (from the root of the repository):

    python -m distaff_torch.tools.kernel_bench [--device cpu] [log2_n ...]

(default sizes 14 18 20, on cuda).  At each size n it prints one line per
operation, with its time and the time per butterfly, element or row
(and the rate in Gbutterflies/s for the transforms):

  tiles.ntt        the NTT of n points: one K1 pass up to 2048 points,
                   two above (the four-step, twiddles on the first store)
  ntt_stagewise    the stage-by-stage NTT, one K5 butterfly launch a stage;
                   its result must equal tiles.ntt's
  mul              one K2 multiply of n elements
  power_series     the n powers of the domain root (one K12 launch)
  inv_batch        the batch inverse of n elements (K6, Montgomery's trick:
                   one product a thread, the prefixes through the output,
                   a warp-shuffle tree and one Kaliski inversion a block);
                   its result must equal exp_const's
  exp_const        n elements to the power M - 2 (K2 exp_const, the
                   per-element Fermat inverse: 127 squarings and 12
                   multiplies of its host-built schedule)
  blake3           K3 over n/4 rows of 64 bytes
  air_transition   K4 over a random (20, n, 4) domain (the bench program's
                   20 registers)
  leaf256          min(4096, n / 256) leaves (at least one) of 256 random
                   points through K16, the 256-point NTT as byte-limb
                   products on the int8 tensor cores (ops/mxu_ntt.py; the
                   JAX benchmarks.py's device_mxu_leaf256_Gbutterflies_per_s:
                   4096 leaves of a 2^20-point input); its result must equal
  leaf256 via K1   tiles.ntt_batched's, one K1 pass at the same shape

On cuda the times come from CUDA events around calls queued behind a
spin kernel (median of 3 trials), checked to have been queued in full
before the card reached them: they are the card's times, power-series
set-up included (host constants go up by queued copies) except K1's power
tables, which tiles builds once per size and root and keeps;
with --device cpu they are host-clock times of the plain versions.  Any
failure raises.
"""

import argparse
import time

import numpy as np
import torch

TRIALS = 3
REPS = 5
SEED = 20261016
# the bench program's trace geometry: 20 registers, ctx depth 1, loop depth 0
AIR_DEPTHS = (1, 0, 4)


def _timer(device):
    if device.type == "cuda":
        from .timing import time_ms
        return lambda fn: time_ms(fn, REPS, TRIALS, queued=True)

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    return host_ms


def _air_case(n, gen, device):
    """A random (20, n, 4) domain and the AirTables of an evaluator whose
    evaluation domain it is."""
    from ..stark.constraints.device_eval import air_tables
    from ..stark.constraints.evaluator import Evaluator
    from .timing import random_elements

    ctx, loop, stack = AIR_DEPTHS
    root = bytes(np.random.default_rng(SEED + n).integers(0, 256, 32, dtype=np.uint8))
    evaluator = Evaluator(n // 8, 8, ctx, loop, stack, root, [0, 0], 0, [], [])
    return random_elements(gen, (15 + ctx + loop + stack, n), device), air_tables(evaluator, device)


def bench(log2_sizes, device="cuda"):
    """Run the bench; returns one dict per line printed."""
    from ..math import field as hostfield
    from ..math import field_torch as ft
    from ..ops import blake3_torch, field_kernels, mxu_ntt, tiles
    from ..stark.constraints import device_eval
    from .timing import random_elements

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel_bench: no CUDA device is available")
    timer = _timer(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = []

    def line(log_n, op, ms, count=None, unit=None):
        per = f"{ms / count * 1e6:9.3f} ns/{unit}" if count else ""
        if unit == "butterfly":
            per += f"  {count / ms / 1e6:9.3f} Gbf/s"
        print(f"2^{log_n:<3} {op:<16} {ms:10.4f} ms  {per}", flush=True)
        rows.append({"log2_n": log_n, "op": op, "ms": ms,
                     "ns_per": ms / count * 1e6 if count else None, "per": unit})

    for log_n in log2_sizes:
        n = 1 << log_n
        root = hostfield.get_root_of_unity(n)
        x = random_elements(gen, (n,), device)
        y = random_elements(gen, (n,), device)
        butterflies = n // 2 * log_n

        if not torch.equal(tiles.ntt(x, root), field_kernels.ntt_stagewise(x, root)):
            raise AssertionError(f"2^{log_n}: ntt_stagewise and tiles.ntt differ")
        line(log_n, "tiles.ntt", timer(lambda: tiles.ntt(x, root)), butterflies, "butterfly")
        line(log_n, "ntt_stagewise", timer(lambda: field_kernels.ntt_stagewise(x, root)),
             butterflies, "butterfly")
        line(log_n, "mul", timer(lambda: ft.mul(x, y)), n, "element")
        line(log_n, "power_series", timer(lambda: ft.power_series(root, n, device)),
             n, "element")
        if not torch.equal(ft.inv_batch(x), ft.exp_const(x, ft.M - 2)):
            raise AssertionError(f"2^{log_n}: inv_batch and exp_const(M - 2) differ")
        line(log_n, "inv_batch", timer(lambda: ft.inv_batch(x)), n, "element")
        line(log_n, "exp_const", timer(lambda: ft.exp_const(x, ft.M - 2)), n, "element")
        leaves = x.view(n // 4, 4, 4)
        line(log_n, f"blake3 {n // 4}x64B", timer(lambda: blake3_torch.hash_rows(leaves)),
             n // 4, "row")
        lde, tables = _air_case(n, gen, device)
        line(log_n, "air_transition", timer(lambda: device_eval.transition(lde, tables)),
             n, "row")
        del lde, tables
        leaves = random_elements(gen, (min(4096, max(1, n // 256)), 256), device)
        root256 = hostfield.get_root_of_unity(256)
        if not torch.equal(mxu_ntt.leaf_ntt256(leaves, root256),
                           tiles.ntt_batched(leaves, root256)):
            raise AssertionError(f"2^{log_n}: leaf256 and tiles.ntt_batched differ")
        butterflies = leaves.shape[0] * 128 * 8
        line(log_n, "leaf256", timer(lambda: mxu_ntt.leaf_ntt256(leaves, root256)),
             butterflies, "butterfly")
        line(log_n, "leaf256 via K1", timer(lambda: tiles.ntt_batched(leaves, root256)),
             butterflies, "butterfly")
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sizes", nargs="*", type=int, default=[14, 18, 20],
                        help="log2 of each size n")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.device == "cuda" and torch.cuda.is_available():
        from .timing import card_line
        print(f"device: {torch.cuda.get_device_name(0)} ({card_line()})", flush=True)
    else:
        print(f"device: {args.device}", flush=True)
    bench(args.sizes, args.device)


if __name__ == "__main__":
    main()
