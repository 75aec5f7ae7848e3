"""pow_ms: the proof of work's time a proof, the mean of the "step 8 proof
of work and queries" lines (distaff_torch.stark.utils.find_pow_nonce and
the query positions), in the traced run."""


def read(run):
    values = [r.steps[8] for r in run.requests if 8 in r.steps]
    return sum(values) / len(values) if values else None
