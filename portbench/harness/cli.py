"""One run of one cell: set-up, the measured window, the check, the result.

The last line of standard output is the result, one JSON object; the lines
before it on standard error say what the run saw, and its last lines there
are the numbers that decided `correct`, each beside its limit.
"""

import argparse
import json
import statistics
import sys
import time

from . import check, spec, trace
from .serve import Request, System, run_window
from .traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "distaff_tpu")


def main(argv, start):
    parser = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", start)
    for line in lines:
        print(line, file=sys.stderr)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


def run(cell, seed, seconds, traced, device, start=None):
    """(result, the lines of standard error) of one run of `cell`, or (None,
    lines) where the run must print no result."""
    import torch

    start = time.perf_counter() if start is None else start
    on_card = device == "cuda"
    synchronize = torch.cuda.synchronize if on_card else (lambda: None)
    lines = []

    # set-up: the CUDA context, the system, one warm proof of the cell's size;
    # each phase's seconds go to standard error
    phases = {"imports": time.perf_counter() - start}
    if on_card:
        torch.zeros(1, device=device)
        synchronize()
    phases["context"] = time.perf_counter() - start
    traffic = Traffic(cell.traffic, cell.config, seed)
    system = System(cell.config, device)
    phases["system"] = time.perf_counter() - start
    spans = trace.StepSpans() if traced else None
    if spans:
        spans.install()
    warm = Request(traffic.warm_request())
    system.prove(warm)
    synchronize()
    setup_s = phases["warm proof"] = time.perf_counter() - start

    # the window
    from distaff_torch.ops import cuda_lib

    launches_before = dict(cuda_lib.LAUNCHES)
    process_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    device_trace = trace.DeviceTrace(on_card) if traced else None
    if device_trace:
        with device_trace:
            requests, window_s = run_window(system, traffic, seconds, synchronize, spans)
    else:
        requests, window_s = run_window(system, traffic, seconds, synchronize, spans)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = {k: v - launches_before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()}
    if spans:
        spans.remove()
    del system
    if on_card:
        torch.cuda.empty_cache()

    # what a reader of the run needs
    proofs = len(requests)
    seconds_each = sorted(r.seconds for r in requests)
    lines.append(f"card: {_card_line() if on_card else device}")
    lines.append(f"requests: {proofs} in {window_s:.6f} s; median {statistics.median(seconds_each):.6f} s, "
                 f"90th percentile {_percentile(seconds_each, 0.9):.6f} s; mean pow_nonce "
                 f"{statistics.fmean(r.pow_nonce for r in requests):.1f}")
    lines.append(f"set-up {setup_s:.6f} s; peak device memory {window_peak} B in the window, "
                 f"{max(process_peak, window_peak)} B in the run")
    marks = list(phases.items())
    lines.append("set-up phases: " + ", ".join(
        f"{name} {at - (marks[i - 1][1] if i else 0):.6f} s" for i, (name, at) in enumerate(marks)))
    if traced:
        per_proof = {k: v / proofs for k, v in launches.items() if v}
        lines.append(f"launches a proof: {json.dumps(per_proof)}")

    run_info = Run(cell, requests, window_s, device_trace, spans, device)
    metrics = {}
    if traced:
        for metric in cell.per_layer:
            value = cell.reader(metric)(run_info)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        measured = {"proof_s": window_s / proofs, "setup_s": setup_s}
        if on_card:
            measured["peak_device_gb"] = window_peak / 1e9
        for metric in cell.end_to_end:
            if metric["name"] in measured:
                metrics[metric["name"]] = {"value": measured[metric["name"]],
                                           "unit": metric["unit"]}

    # the check, once the window has closed and its state is freed
    sample = traffic.sample(proofs)
    check_start = time.perf_counter()
    numbers, reasons = check.judge(cell.config, requests, sample)
    lines += [f"rejected: {why}" for why in reasons]
    lines.append(f"checked the outputs of {proofs} requests and the proofs of requests {sample} "
                 f"in {time.perf_counter() - check_start:.1f} s")
    lines += [f"{name} {numbers[name]} (limit {limit})" for name, limit in check.LIMITS.items()]

    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if loaded:
        return None, lines + [f"the run loaded {', '.join(loaded)}"]

    result = {
        "correct": check.is_correct(numbers),
        "attempted": proofs,
        "failed": numbers["wrong_outputs"] + numbers["rejected"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else device,
            "kind": torch.cuda.get_device_name(0) if on_card else device,
            "count": cell.chips,
            "memory_peak_bytes": max(process_peak, window_peak),
        },
    }
    if device_trace:
        result["device"]["busy_s"] = device_trace.busy_s()
        result["device"]["window_s"] = device_trace.window_s()
        result["breakdown"] = {"device_ops": device_trace.top_operations(),
                               "idle_gaps": device_trace.idle_by_step(spans.names)}
    result["checks"] = {name: {"value": numbers[name], "limit": limit}
                        for name, limit in check.LIMITS.items()}
    return result, lines


class Run:
    """What the per-layer metrics' readers read: the window's requests (their
    step spans in a traced run), its seconds, the device trace, and the
    proof's geometry as its bytes state it."""

    def __init__(self, cell, requests, window_s, device_trace, spans, device):
        import reference

        self.cell = cell
        self.requests = requests
        self.window_s = window_s
        self.trace = device_trace
        self.step_names = spans.names if spans else {}
        self.device = device
        self.kind = None
        if device == "cuda":
            import torch

            self.kind = torch.cuda.get_device_name(0)
        proof = reference.serde.deserialize(requests[-1].proof)
        self.trace_length = proof.trace_length()
        self.extension_factor = proof.options.extension_factor()
        self.registers = len(proof.trace_evaluations[0])


def _percentile(sorted_values, q):
    index = min(len(sorted_values) - 1, max(0, int(round(q * len(sorted_values))) - 1))
    return sorted_values[index]


def _card_line():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0]
