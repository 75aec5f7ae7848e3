"""The control of the check that decides `correct`, and the faults that the
check has to catch, each read through a whole run of the cell
(harness/cli.run) with the port changed underneath.

The control breaks the one guarantee that the configuration states, 120-bit
security (extension factor 32, 2 bits a query; 50 queries; a proof of work
of 20 bits): it proves with the port's own option for a weaker proof of
work, a grinding factor of 19 (119 bits), and the check judges the proofs
against the configuration as it states them.

The faults, planted where the port produces its answers:

- stale_answer: execute() proves each request and returns its first answer;
- output_altered: the first output of the VM plus one;
- nonce_altered: the proof-of-work nonce plus one (the verifier's check of
  the search);
- deep_value_altered: one register's value at the out-of-domain point z,
  where the verifier evaluates the constraints and composes the openings;
- fri_value_altered: one value of the first FRI layer's openings.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--sides <side> ...]

prints one JSON line a seed and side, as it goes: the check's numbers, the
requests, `correct` and the first reason the verifier gave.  Runs on the
card; the tests read it on the CPU.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from harness import cli, spec  # noqa: E402

WEAKER = {"grinding_factor": 19}


def _weaker(options_class):
    def weaker(**kwargs):
        return options_class(**dict(kwargs, **WEAKER))
    return weaker


def _stale(execute):
    first = []

    def stale(*args, **kwargs):
        answer = execute(*args, **kwargs)  # the work is done, its answer dropped
        if not first:
            first.append(answer)
        return first[0]
    return stale


def _output_altered(execute):
    def altered(*args, **kwargs):
        outputs, proof = execute(*args, **kwargs)
        return [outputs[0] + 1] + list(outputs[1:]), proof
    return altered


def _nonce_altered(find_pow_nonce):
    def altered(seed, options):
        digest, nonce = find_pow_nonce(seed, options)
        return digest, nonce + 1
    return altered


def _proof_altered(change):
    def wrap(prove):
        def altered(*args, **kwargs):
            proof = prove(*args, **kwargs)
            change(proof)
            return proof
        return altered
    return wrap


def _flip_deep_value(proof):
    proof.deep_values.trace_at_z1[2] ^= 1


def _flip_fri_value(proof):
    proof.degree_proof.layers[0].values[0][1] ^= 1


# side: the port's attributes it replaces, as (module's name, attribute, wrapper)
SIDES = {
    "program": [],
    "control": [("distaff_torch", "ProofOptions", _weaker)],
    "stale_answer": [("distaff_torch", "execute", _stale)],
    "output_altered": [("distaff_torch", "execute", _output_altered)],
    "nonce_altered": [("distaff_torch.stark.utils", "find_pow_nonce", _nonce_altered)],
    "deep_value_altered": [("distaff_torch.stark", "prove", _proof_altered(_flip_deep_value))],
    "fri_value_altered": [("distaff_torch.stark", "prove", _proof_altered(_flip_fri_value))],
}


@contextlib.contextmanager
def planted(side):
    """The port with `side`'s changes in place inside the block."""
    import importlib

    saved = []
    try:
        for module, name, wrap in SIDES[side]:
            owner = importlib.import_module(module)
            saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, wrap(getattr(owner, name)))
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def reading(cell, seed, seconds, side, device="cuda"):
    """The check's numbers of one run of `cell` with `side` planted."""
    with planted(side):
        result, lines = cli.run(cell, seed, seconds, False, device)
    if result is None:
        raise RuntimeError("\n".join(lines))
    reasons = [line for line in lines if line.startswith("rejected: ")]
    return {**{name: check["value"] for name, check in result["checks"].items()},
            "requests": result["attempted"], "correct": result["correct"],
            "first_reason": reasons[0] if reasons else None}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--sides", nargs="+", choices=list(SIDES), default=list(SIDES))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload)
    for seed in args.seeds:
        for side in args.sides:
            start = time.perf_counter()
            numbers = reading(cell, seed, args.seconds, side)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side, **numbers,
                              "seconds": round(time.perf_counter() - start, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
