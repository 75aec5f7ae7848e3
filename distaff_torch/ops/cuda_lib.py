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
import subprocess
from collections import Counter
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
    "air_transition": 0,
    "butterfly": 0,
    "inv_batch": 0,
    "deep_compose": 0,
    "poly_eval": 0,
    "fri_fold": 0,
    "boundary_columns": 0,
    "syn_div": 0,
    "power_series": 0,
    "merkle_tree": 0,
    "trace_absorb": 0,
    "coeff_wsum": 0,
    "leaf256": 0,
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


def _binary_tool(name):
    """Path of a CUDA binary tool: the toolkit's, or the copy that Triton's
    package carries; None where neither is installed."""
    for candidate in (f"/usr/local/cuda/bin/{name}", shutil.which(name)):
        if candidate and Path(candidate).exists():
            return candidate
    try:
        import triton
    except ImportError:
        return None
    bundled = Path(triton.__file__).resolve().parent / "backends" / "nvidia" / "bin" / name
    return str(bundled) if bundled.exists() else None


def sass(stem):
    """The SASS of csrc/<stem>.cu's object (cuobjdump --dump-sass), or None
    where no cuobjdump is installed."""
    return sass_file(next(o for o in _objects() if o.name.startswith(stem + "-")))


# the integer opcodes whose mix shows a kernel's split over the SM's two
# integer pipes: IADD3, LOP3, SHF and PRMT issue to the integer-only pipe,
# IMAD (all its forms) to the FMA pipe; IMMA is the int8 tensor cores'
PIPE_OPCODES = ("IADD3", "IMAD", "LOP3", "SHF", "PRMT", "IMMA")
# the mix of the field multiply's kernels (K2's exp_const, K6): IMAD's
# forms (wide, high half, carry-in, the moves ptxas puts on the FMA pipe)
# beside the integer-only pipe's adds, logic and selects
MULTIPLY_OPCODES = ("IMAD", "IMAD.WIDE", "IMAD.HI", "IMAD.X", "IMAD.MOV", "IADD3", "LOP3",
                    "SHF", "SEL", "ISETP")
# the opcodes of the two pipes, for a per-pipe count: the FMA pipe's IMAD,
# and the integer-only pipe's
FMA_PIPE_OPCODES = ("IMAD",)
ALU_PIPE_OPCODES = ("IADD3", "LOP3", "SHF", "PRMT", "SEL", "ISETP", "LEA", "MOV", "IMNMX",
                    "PLOP3")


def sass_file(path):
    """The SASS of a compiled object or library (cuobjdump --dump-sass), or
    None where no cuobjdump is installed."""
    tool = _binary_tool("cuobjdump")
    if tool is None:
        return None
    return subprocess.run([tool, "--dump-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout


def function_sass(sass_text, name):
    """The SASS of the functions whose (mangled) name contains `name`."""
    keep, lines = False, []
    for line in sass_text.splitlines():
        if "Function :" in line:
            keep = name in line.split("Function :", 1)[1]
        elif keep:
            lines.append(line)
    return "\n".join(lines)


def opcode_mix(sass_text):
    """A Counter of the SASS text's instructions by full mnemonic
    (IMAD.MOV.U32, IMMA.16832.U8.U8 ...), predicated ones included."""
    mix = Counter()
    for line in sass_text.splitlines():
        if "*/" not in line:
            continue
        words = line.split("*/", 1)[1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            mix[words[0].rstrip(";")] += 1
    return mix


def opcode_counts(sass_text, opcodes=PIPE_OPCODES):
    """How many instructions of each opcode the SASS text holds, predicated
    ones included: an opcode without a '.' counts every form of it (IMAD:
    IMAD.WIDE, IMAD.HI ... too), one with a '.' the forms it begins (IMAD.WIDE:
    IMAD.WIDE and IMAD.WIDE.U32)."""
    counts = dict.fromkeys(opcodes, 0)
    for mnemonic, k in opcode_mix(sass_text).items():
        for op in opcodes:
            if mnemonic == op or mnemonic.startswith(op + "."):
                counts[op] += k
    return counts


def pipe_counts(sass_text):
    """(FMA-pipe, integer-only-pipe) instructions of a SASS text."""
    fma = sum(opcode_counts(sass_text, FMA_PIPE_OPCODES).values())
    return fma, sum(opcode_counts(sass_text, ALU_PIPE_OPCODES).values())


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
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int)
        handle.distaff_ntt_pass.argtypes = [
            vp, vp, vp, vp, vp, ll, i32, i32, ll, ll, ll, ll, ll, ll, ll, i32, ll, vp]
        handle.distaff_field_binary.argtypes = [
            i32, i32, vp, vp, vp, ll, llp, llp, llp, vp]
        handle.distaff_field_exp.argtypes = [vp, vp, ll, ctypes.POINTER(ctypes.c_uint16), i32, vp]
        handle.distaff_blake3_rows.argtypes = [vp, vp, ll, i32, ll, ll, vp]
        handle.distaff_butterfly.argtypes = [vp, vp, vp, vp, vp, ll, vp]
        handle.distaff_inv_batch.argtypes = [vp, vp, ll, vp]
        handle.distaff_deep_compose.argtypes = [
            vp, ll, i32, ll, vp, vp, vp, vp, vp, vp, vp, i32, u32p, vp, ll, vp]
        handle.distaff_poly_eval.argtypes = [vp, vp, vp, vp, ll, ll, i32, u32p, vp]
        handle.distaff_fri_fold.argtypes = [
            vp, ll, i32, vp, vp, i32, ll, u32p, vp, vp, ll, ll, vp]
        handle.distaff_boundary_columns.argtypes = [
            vp, ll, ll, i32, ll, u32p, vp, vp, i32, u32p, vp, ll, vp]
        handle.distaff_syn_div.argtypes = [
            vp, ll, ll, ll, vp, vp, vp, vp, i32, u32p, u32p, vp, vp, vp, vp, vp]
        handle.distaff_power_series.argtypes = [vp, vp, i32, llp, i32p, llp, llp, vp]
        handle.distaff_merkle_tree.argtypes = [vp, vp, vp, ll, i32, i32p, vp]
        handle.distaff_trace_absorb.argtypes = [
            vp, ll, i32, ll, vp, vp, vp, ll, i32, ctypes.c_uint, ctypes.c_uint,
            ctypes.c_ulonglong, vp]
        handle.distaff_coeff_wsum.argtypes = [vp, ll, i32, ll, vp, vp, vp, vp]
        handle.distaff_leaf256.argtypes = [vp, vp, vp, ll, vp]
        handle.distaff_leaf256_blocks_per_sm.argtypes = [i32p, i32p]
        for fn in (handle.distaff_ntt_pass, handle.distaff_field_binary,
                   handle.distaff_field_exp, handle.distaff_blake3_rows,
                   handle.distaff_butterfly, handle.distaff_inv_batch,
                   handle.distaff_deep_compose, handle.distaff_poly_eval,
                   handle.distaff_fri_fold, handle.distaff_boundary_columns,
                   handle.distaff_syn_div, handle.distaff_power_series,
                   handle.distaff_merkle_tree, handle.distaff_trace_absorb,
                   handle.distaff_coeff_wsum, handle.distaff_leaf256,
                   handle.distaff_leaf256_blocks_per_sm):
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


def stream_key(device):
    """(device, current stream's handle): the key of a kernel's scratch
    that the launches on one stream share (launches in order there), so
    that two streams of one card, a mesh's slots, never share it."""
    device = torch.device(device)
    if device.type != "cuda":
        return (str(device), None)
    return (str(device), torch.cuda.current_stream(device).cuda_stream)


def ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def require_limbs(what, *tensors):
    """Raise unless every tensor is a uint32 limb tensor on the current
    card (a launch goes to the current device: a mesh's slot launches under
    torch.cuda.device of its card) whose limb axis is contiguous and
    16-byte aligned (the kernels read whole elements as 16-byte vectors)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected a CUDA tensor, got one on {t.device}")
        current = torch.cuda.current_device()
        if t.device.index != current:
            raise ValueError(f"{what}: a tensor on {t.device}, the current device is "
                             f"cuda:{current}")
        if t.dtype != torch.uint32 or t.shape[-1] != 4 or t.stride(-1) != 1:
            raise ValueError(
                f"{what}: expected (..., 4) uint32 limbs, got {t.dtype} {tuple(t.shape)} "
                f"strides {t.stride()}")
        if t.data_ptr() % 16 or any(
                st % 4 for st, sz in zip(t.stride()[:-1], t.shape[:-1]) if sz > 1):
            raise ValueError(f"{what}: limb rows must be 16-byte aligned")
