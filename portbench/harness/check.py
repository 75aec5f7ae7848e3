"""Whether what the window produced is correct, judged by the plain reference.

Every request's outputs are compared with what the reference's stack machine
gives for its statement; a sample of the requests, drawn from the seed with
the last among them, has its proof's bytes verified by the reference's
verifier against the program's hash, which the reference works out from the
program's text itself, and against the options that the configuration
states.  The numbers compared and their limits:

- wrong_outputs: requests whose outputs differ from the reference's, limit 0;
- rejected: sampled proofs that the reference's verifier rejects, limit 0.

The program's hash is a chain of 2^k sponge rounds in plain Python (about
a minute at 2^18 steps); the first run in a checkout works it out and keeps
it under portbench/_cache/, keyed by the program's text and the reference's
sources, for the runs after it.
"""

import hashlib
import json
import os
from pathlib import Path

LIMITS = {"wrong_outputs": 0, "rejected": 0}
CACHE_DIR = Path(__file__).resolve().parent.parent / "_cache"
REFERENCE_DIR = Path(__file__).resolve().parent.parent / "reference"


def judge(config, requests, sample):
    """({name: value}, [reasons]) for the window's requests; `sample` indexes
    the requests whose proofs are verified."""
    import reference

    options = reference.ProofOptions(**config["options"])
    program_hash = cached_program_hash(config["program"])
    wrong = 0
    for request in requests:
        expected = reference.run_program(config["program"], request.inputs, config["num_outputs"])
        wrong += request.outputs != expected
    reasons = []
    for i in sample:
        request = requests[i]
        why = reference.check_proof(request.proof, program_hash, request.inputs,
                                    request.outputs, options)
        if why is not None:
            reasons.append(f"request {i}: {why}")
    return {"wrong_outputs": wrong, "rejected": len(reasons)}, reasons


def is_correct(numbers):
    return all(numbers[name] <= limit for name, limit in LIMITS.items())


def cached_program_hash(source):
    import reference

    key = hashlib.sha256(source.encode())
    for path in sorted(REFERENCE_DIR.rglob("*.py")):
        key.update(path.read_bytes())
    path = CACHE_DIR / f"program_hash-{key.hexdigest()[:32]}.json"
    if path.exists():
        return bytes.fromhex(json.loads(path.read_text())["hash"])
    value = reference.program_hash(source)
    CACHE_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps({"hash": value.hex()}))
    os.replace(tmp, path)
    return value
