"""Multi-process SPMD proving entry point and scaling-efficiency instrument:
the port of the JAX package's tools/multihost_prove.py.

Run the SAME command in every process of a job, one a card (or, on one
card or on the CPU, several):

    DISTAFF_COORDINATOR=host0:9321 DISTAFF_NUM_PROCESSES=2 \
    DISTAFF_PROCESS_ID=<k> python -m distaff_torch.tools.multihost_prove [log2_trace]

or under torchrun, whose env:// variables it reads:

    DISTAFF_DISTRIBUTED=1 torchrun --nproc-per-node=<cards> \
        -m distaff_torch.tools.multihost_prove [log2_trace]

Every process joins the job at `import distaff_torch` (distaff_torch/
dist_setup.py), a mesh spans the first 2^k ranks (the largest power of two
not above them), one slot a rank, and the prover's split stages (trace
LDE, the four-step transforms with their all-to-alls, AIR sweep,
composition, FRI folds, Merkle subtrees) run on each rank's slot, the
reshards exchanged over torch.distributed: NCCL where each rank has a card
of its own, gloo on the CPU or where ranks share a card.  Proof bytes are
identical to single-device proving; process 0 prints them.  A rank beyond
the mesh proves whole on its own device.  On the card unless `--device
cpu` is given.

Measurement mode (--bench): proves twice (warm + steady), captures the
prover's per-step wall times (its "step <i> <name>" DEBUG lines), and
writes one JSON line (plus a file via --out).  Scaling efficiency against
a 1-process run of the same size:

    python -m distaff_torch.tools.multihost_prove 12 --bench --out one.json
    ... N-process job: python -m distaff_torch.tools.multihost_prove 12 \
            --bench --baseline one.json
    -> {"scaling_efficiency": t1 / (N * tN), ...}

Unlike the JAX package's form, whose host fetches of tree roots, openings
and query rows hit shards of other processes, every rank here holds what
its transcript reads (parallel/mesh.py), so the cross-process proof
completes.
"""

import argparse
import hashlib
import json
import logging
import os
import re
import time

import torch

import distaff_torch
from distaff_torch import assembly, dist_setup, ProgramInputs, ProofOptions
from distaff_torch.stark import serde

# prover step -> stage key (the JAX tool's keys, from the port's step log)
_STAGES = {1: "trace_lde", 2: "trace_commit", 3: "constraint_eval", 4: "constraint_poly",
           5: "constraint_commit", 6: "composition", 7: "fri", 8: "queries",
           9: "proof_object"}
_STEP = re.compile(r"step (\d) (?!part )[^:]+: ([0-9.]+) ms$")


class _StageTimes(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.stages = {}

    def emit(self, record):
        m = _STEP.match(record.getMessage())
        if m and int(m.group(1)) in _STAGES:
            self.stages[_STAGES[int(m.group(1))]] = float(m.group(2)) / 1000.0


def _prove_once(program, inputs, options, device):
    t0 = time.time()
    outputs, proof = distaff_torch.execute(program, inputs, 1, options, device=device)
    elapsed = time.time() - t0
    assert distaff_torch.verify(
        program.hash, inputs.get_public_inputs(), outputs, proof)
    return elapsed, proof


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("log2_trace", nargs="?", type=int, default=10)
    parser.add_argument("--bench", action="store_true",
                        help="warm + steady runs, per-stage times, JSON out")
    parser.add_argument("--out", help="write the bench JSON to this path")
    parser.add_argument("--baseline",
                        help="a 1-process bench JSON to compute scaling "
                             "efficiency against")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="prove on the card (the default) or on the CPU")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("multihost_prove: no CUDA device is available (--device cpu "
                           "proves on the CPU)")

    job = dist_setup.job()
    if job is not None:
        job.bind(args.device)
        n_devices, n_proc, pid = job.world, job.world, job.rank
        backend = f", backend {job.describe()} on {job.device}"
    else:
        n_devices = torch.cuda.device_count() if args.device == "cuda" else 1
        n_proc, pid, backend = 1, 0, ""
    print(f"# process {pid}: {n_proc} process(es), {n_devices} global "
          f"device(s){backend}", flush=True)

    # mesh over every device of every process; power-of-two for the NTT splits
    mesh_n = 1 << (n_devices.bit_length() - 1)
    os.environ["DISTAFF_MESH_DEVICES"] = str(mesh_n)

    n_iter = max(1, (1 << args.log2_trace) * 3 // 64)
    program = assembly.compile(
        f"begin repeat.{n_iter} swap dup.2 drop add end end")
    inputs = ProgramInputs.from_public([1, 0])
    options = ProofOptions(extension_factor=16, num_queries=10,
                           grinding_factor=2)

    capture = None
    if args.bench:
        capture = _StageTimes()
        plog = logging.getLogger("distaff_torch.stark.prover")
        plog.setLevel(logging.DEBUG)
        plog.addHandler(capture)

    warm, proof = _prove_once(program, inputs, options, args.device)
    steady = warm
    if args.bench:
        capture.stages.clear()           # keep only the steady run's stages
        steady, proof = _prove_once(program, inputs, options, args.device)

    blob = serde.serialize(proof)
    if pid == 0:
        print(f"# proved + verified 2^{proof.trace_length().bit_length() - 1}"
              f"-step trace on {mesh_n} device(s) in {steady:.1f}s "
              f"(warm {warm:.1f}s)")
        print(f"proof_sha256={hashlib.sha256(blob).hexdigest()}", flush=True)

    if args.bench and pid == 0:
        result = {
            "log2_trace": args.log2_trace,
            "processes": n_proc,
            "mesh_devices": mesh_n,
            "platform": "gpu" if args.device == "cuda" else "cpu",
            "warm_s": round(warm, 3),
            "steady_s": round(steady, 3),
            "stages_s": {k: round(v, 3) for k, v in capture.stages.items()},
            "proof_sha256": hashlib.sha256(blob).hexdigest(),
        }
        if args.baseline:
            with open(args.baseline) as fh:
                base = json.load(fh)
            assert base["log2_trace"] == args.log2_trace, (
                "baseline is for a different trace size")
            speedup = base["steady_s"] / steady
            scale = n_proc / max(base["processes"], 1)
            result["speedup_vs_baseline"] = round(speedup, 4)
            result["scaling_efficiency"] = round(speedup / scale, 4)
            result["proof_matches_baseline"] = (
                base["proof_sha256"] == result["proof_sha256"])
        line = json.dumps(result)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")


if __name__ == "__main__":
    main()
