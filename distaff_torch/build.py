"""Builds the port's shared libraries at first use.

Libraries are compiled from the sources in the checkout into
`distaff_torch/_build/` (listed in .gitignore): the native host runtime
(`native/*.cpp`, with g++), the CUDA kernels (`distaff_torch/csrc/*.cu`,
one nvcc per source, then linked) and the host build of K4's row
evaluator (`distaff_torch/csrc/air_row_host.cpp`, with g++).  Each build is
keyed by a hash of its sources and command, so an edited source rebuilds
and an unchanged one is loaded as it is.  A file lock serializes concurrent
builders of one file (test workers, for instance); a failed build raises
with the compiler's output.
"""

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def shared_library(name, command, inputs):
    """Path of lib<name>-<hash>.so, compiled by `command` (a list, without
    the output argument) when no build of these inputs exists yet.

    `inputs` lists every file the build reads (sources and headers)."""
    return artifact(f"lib{name}", ".so", command, inputs)


def artifact(name, suffix, command, inputs):
    """Path of <name>-<hash><suffix> built by `command` + ["-o", path] when
    no build of these inputs exists yet; the compiler's output is kept
    beside it as <name>-<hash>.log."""
    digest = hashlib.sha256(" ".join(str(c) for c in command).encode())
    for path in sorted(str(p) for p in inputs):
        digest.update(Path(path).read_bytes())
    target = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}{suffix}"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            proc = subprocess.run([str(c) for c in command] + ["-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building {target.name} failed ({proc.returncode}):\n"
                    f"{' '.join(str(c) for c in command)}\n{proc.stdout}{proc.stderr}")
            target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, target)
    return target
