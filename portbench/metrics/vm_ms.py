"""vm_ms: the VM's time a proof, the mean of the "step 0 execute program"
lines (distaff_torch.execute, around native.execute_u64 and the trace
table), in the traced run."""


def read(run):
    values = [r.steps[0] for r in run.requests if 0 in r.steps]
    return sum(values) / len(values) if values else None
