"""CLI mirroring the reference binary (reference src/main.rs):

    python -m distaff_torch [fibonacci|collatz|comparison|conditional|merkle|rangecheck]
                            [n] [ext_factor] [num_queries] [grind_factor] [--device cpu]

It proves on the card unless `--device cpu` asks for the CPU; with no card
and no `--device cpu` it raises, as execute() does.
"""

import logging
import sys
import time

from . import execute, verify, ProofOptions
from . import examples
from .stark import serde


def parse_args(argv):
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        at = argv.index("--device")
        device = argv[at + 1]
        del argv[at : at + 2]
    name = argv[0] if argv else "fibonacci"
    n = int(argv[1]) if len(argv) > 1 else 6
    default = ProofOptions()
    ext = int(argv[2]) if len(argv) > 2 else default.extension_factor()
    queries = int(argv[3]) if len(argv) > 3 else default.num_queries()
    grind = int(argv[4]) if len(argv) > 4 else default.grinding_factor()
    return name, n, ProofOptions(ext, queries, grind), device


def main(argv=None):
    logging.basicConfig(level=logging.DEBUG, format="%(message)s")

    argv = argv if argv is not None else sys.argv[1:]
    name, n, options, device = parse_args(argv)
    example_fn = examples.EXAMPLES.get(name)
    if example_fn is None:
        print(f"unknown example '{name}'; available: {sorted(examples.EXAMPLES)}")
        return 1

    program, inputs, num_outputs, expected = example_fn(n)
    print("--------------------------------")

    now = time.time()
    outputs, proof = execute(program, inputs, num_outputs, options, device=device)
    print("--------------------------------")
    print(f"Executed program with hash {program.hash.hex()} in "
          f"{(time.time() - now) * 1000:.0f} ms")
    print(f"Program output: {outputs}")
    if expected is not None:
        assert outputs == expected, f"expected {expected} but computed {outputs}"

    proof_bytes = serde.serialize(proof)
    print(f"Execution proof size: {len(proof_bytes) // 1024} KB")
    print(f"Execution proof security: {options.security_level(True)} bits")
    print("--------------------------------")

    proof = serde.deserialize(proof_bytes)
    now = time.time()
    try:
        verify(program.hash, inputs.get_public_inputs(), outputs, proof)
        print(f"Execution verified in {(time.time() - now) * 1000:.0f} ms")
    except Exception as e:
        print(f"Failed to verify execution: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
