"""prover_ms: the prover's time a proof, the mean sum of the "step 1" to
"step 9" lines (distaff_torch.stark.prover, each step ending in a
synchronize of the device while DEBUG is on), in the traced run."""

STEPS = range(1, 10)


def read(run):
    values = [sum(r.steps[i] for i in STEPS) for r in run.requests
              if all(i in r.steps for i in STEPS)]
    return sum(values) / len(values) if values else None
