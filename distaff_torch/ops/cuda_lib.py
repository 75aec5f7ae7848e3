"""The port's CUDA kernels: build, load and launch accounting.

Each `distaff_torch/csrc/*.cu` source but K4's compiles in its own nvcc
call for Hopper (`sm_90a`), all started together, with ptxas' register and
spill report kept beside each object (`ptxas_report`); one more nvcc call
links them into a shared library with a plain C interface, loaded with
ctypes.  K4 (`air_transition.cu`) is built for one trace geometry at a
time, into a library of its own (ops/air_kernels.air_lib, on
`build_library`).  Pointers and the stream travel as `c_void_p`; every
entry point returns `cudaGetLastError()` and `check` turns a non-zero code
into an exception.  Nothing here runs at import: the build happens at the
first launch.

`LAUNCHES` counts, per kernel entry, the launches the wrappers made: each
wrapper adds one where it launches its kernel and nowhere else.
"""

import ctypes
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import build

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH = "arch=compute_90a,code=sm_90a"

LAUNCHES = {
    "ntt_pass": 0,
    "field_ew.add": 0,
    "field_ew.sub": 0,
    "field_ew.mul": 0,
    "field_ew.exp_const": 0,
    "blake3_rows": 0,
    "blake3_rows.parents": 0,
    "air_transition": 0,
    "butterfly": 0,
    "inv_batch": 0,
}

_lib = None


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def nvcc_path():
    for candidate in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if candidate and Path(candidate).exists():
            return candidate
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def compile_command(source):
    """nvcc command that compiles one source to an object (without -o)."""
    return [nvcc_path(), "-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-c", str(source)]


def build_library(name, source, defines):
    """Path of a shared library built by one nvcc call from one source with
    these -D definitions (compile and link; ptxas' report kept in its log)."""
    command = compile_command(source)
    command = command[:command.index("-c")] + [f"-D{d}" for d in defines] + ["-shared", str(source)]
    return build.shared_library(name, command, [source, *sorted(CSRC.glob("*.cuh"))])


def _objects():
    """One object per source but K4's, compiled in parallel (cached by
    content)."""
    sources = [s for s in sorted(CSRC.glob("*.cu")) if s.stem != "air_transition"]
    headers = sorted(CSRC.glob("*.cuh"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return list(pool.map(
            lambda src: build.artifact(src.stem, ".o", compile_command(src), [src, *headers]),
            sources))


def ptxas_lines(log):
    """ptxas' lines (registers, stack frame, spills) of a build log."""
    return [line for line in Path(log).read_text().splitlines()
            if "ptxas" in line or "bytes stack frame" in line]


def ptxas_report(stem):
    """ptxas' lines for csrc/<stem>.cu."""
    obj = next(o for o in _objects() if o.name.startswith(stem + "-"))
    return ptxas_lines(obj.with_suffix(".log"))


def lib():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        objects = _objects()
        path = build.shared_library(
            "distaff_kernels", [nvcc_path(), "-gencode", ARCH, "-shared", *objects], objects)
        handle = ctypes.CDLL(str(path))
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        llp = ctypes.POINTER(ctypes.c_longlong)
        handle.distaff_ntt_pass.argtypes = [
            vp, vp, vp, vp, vp, ll, i32, i32, ll, ll, ll, ll, ll, ll, ll, i32, vp]
        handle.distaff_field_binary.argtypes = [
            i32, i32, vp, vp, vp, ll, llp, llp, llp, vp]
        handle.distaff_field_exp.argtypes = [
            vp, vp, ll, ctypes.c_ulonglong, ctypes.c_ulonglong, vp]
        handle.distaff_blake3_rows.argtypes = [vp, vp, ll, i32, ll, ll, vp]
        handle.distaff_butterfly.argtypes = [vp, vp, vp, vp, vp, ll, vp]
        handle.distaff_inv_batch.argtypes = [vp, vp, ll, vp]
        for fn in (handle.distaff_ntt_pass, handle.distaff_field_binary,
                   handle.distaff_field_exp, handle.distaff_blake3_rows,
                   handle.distaff_butterfly, handle.distaff_inv_batch):
            fn.restype = i32
        handle.distaff_cuda_error_string.argtypes = [i32]
        handle.distaff_cuda_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code, what):
    if code != 0:
        msg = lib().distaff_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream(tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def require_limbs(what, *tensors):
    """Raise unless every tensor is a uint32 limb tensor on the first card
    whose limb axis is contiguous and 16-byte aligned (the kernels read
    whole elements as 16-byte vectors)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected a CUDA tensor, got one on {t.device}")
        if t.device.index not in (None, 0):
            raise ValueError(f"{what}: the kernels run on cuda:0 only, got {t.device}")
        if t.dtype != torch.uint32 or t.shape[-1] != 4 or t.stride(-1) != 1:
            raise ValueError(
                f"{what}: expected (..., 4) uint32 limbs, got {t.dtype} {tuple(t.shape)} "
                f"strides {t.stride()}")
        if t.data_ptr() % 16 or any(
                st % 4 for st, sz in zip(t.stride()[:-1], t.shape[:-1]) if sz > 1):
            raise ValueError(f"{what}: limb rows must be 16-byte aligned")
