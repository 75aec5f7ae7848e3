"""Runs one cell of distaff_torch's benchmark once and prints its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and distaff_torch.  It
exits with 2, and prints no result, where the cell's CUDA devices are not
there.  The result is the last line of standard output (see harness/cli.py).
"""

import time

START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
# Python's bytecode, torch's with it, cached inside the checkout: where the
# environment writes none (PYTHONDONTWRITEBYTECODE), every run's set-up would
# compile torch's sources again
sys.dont_write_bytecode = False
sys.pycache_prefix = str(BENCH_DIR / "_cache" / "pycache")
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], START))
