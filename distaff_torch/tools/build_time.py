"""Build time of the port's CUDA kernels, two ways: one nvcc call over every
distaff_torch/csrc/*.cu, and the build cuda_lib.lib() runs, one nvcc per
source, all started at once, then one link.

Usage (from the root of the repository, where nvcc is installed):

    python -m distaff_torch.tools.build_time [rounds]

Each round builds both ways from nothing into a fresh directory under
distaff_torch/_build/ (removed afterwards), in the order single, split,
split, single, so that a drift of the machine falls on both; it prints the
seconds of every build.
"""

import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .. import build
from ..ops import cuda_lib


def _run(command):
    proc = subprocess.run([str(c) for c in command], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(str(c) for c in command)} failed:\n{proc.stderr}")


def build_single(out):
    """One nvcc call compiles and links every source."""
    sources = sorted(cuda_lib.CSRC.glob("*.cu"))
    command = cuda_lib.compile_command(sources[0])
    command = command[:command.index("-c")] + ["-shared", *sources]
    _run(command + ["-o", out / "single.so"])


def build_split(out):
    """One nvcc per source, all at once, then one link (cuda_lib.lib()'s)."""
    sources = sorted(cuda_lib.CSRC.glob("*.cu"))
    objects = [out / f"{src.stem}.o" for src in sources]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(lambda so: _run(cuda_lib.compile_command(so[0]) + ["-o", so[1]]),
                      zip(sources, objects)))
    _run([cuda_lib.nvcc_path(), "-gencode", cuda_lib.ARCH, "-shared", *objects,
          "-o", out / "split.so"])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rounds = int(argv[0]) if argv else 1
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    times = {"single": [], "split": []}
    for _ in range(rounds):
        for name in ("single", "split", "split", "single"):
            out = Path(tempfile.mkdtemp(prefix="build_time-", dir=build.BUILD_DIR))
            try:
                t0 = time.perf_counter()
                (build_single if name == "single" else build_split)(out)
                seconds = time.perf_counter() - t0
            finally:
                shutil.rmtree(out)
            times[name].append(seconds)
            print(f"build_time: {name} {seconds:.2f} s", flush=True)
    for name, values in times.items():
        print(f"build_time: {name} builds {', '.join(f'{v:.2f}' for v in values)} s", flush=True)


if __name__ == "__main__":
    main()
