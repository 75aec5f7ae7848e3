"""ctypes bindings to the native host runtime, built from `native/*.cpp`.

Provides the C++ VM (trace generation), batch BLAKE3, the Merkle node
builder and the op-sponge rounds of program hashing.  (native/air.cpp, the
JAX package's host AIR sweep, is not built: the port evaluates the
transition constraints on the device, kernel K4.)  The library is compiled at first use with g++ and the
flags of native/Makefile into the port's build directory (see
distaff_torch/build.py); the committed binary under native/ is never
loaded, and nothing is written there.  A failed build or load raises,
although the port has a pure-Python VM (distaff_torch/processor/): no
silent fallback, since a broken build would hide behind a step 0 over
ten times slower.
"""

import ctypes
import struct
from pathlib import Path

import numpy as np

from . import build

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("vm.cpp", "blake3.cpp")
HEADERS = ("field128.h", "ark_constants.h")
# native/Makefile's CXXFLAGS, plus -shared
FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp", "-Wall", "-shared")

_lib = None


def lib():
    """The loaded native library, built on first use."""
    global _lib
    if _lib is None:
        sources = [str(NATIVE_DIR / s) for s in SOURCES]
        path = build.shared_library(
            "distaff_native", ["g++", *FLAGS, *sources],
            sources + [str(NATIVE_DIR / h) for h in HEADERS])
        handle = ctypes.CDLL(str(path))
        handle.dt_execute.restype = ctypes.c_int
        handle.dt_execute.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_char_p),
        ]
        handle.dt_free.argtypes = [ctypes.c_void_p]
        handle.dt_blake3_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_char_p]
        handle.dt_blake3_single.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        handle.dt_merkle_nodes.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        handle.dt_sponge_rounds.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_size_t, ctypes.c_size_t]
        _lib = handle
    return _lib


# ------------------------------------------------------------------------------------------------
# program serialization (must match native/vm.cpp's Reader)
# ------------------------------------------------------------------------------------------------

_HINT_KINDS = {"none": 0, "eq_start": 1, "rc_start": 2, "cmp_start": 3,
               "pmpath_start": 4, "push": 5}


def _serialize_block(block, out):
    from .programs.blocks import Span, Group, Switch, Loop

    if isinstance(block, Span):
        out.append(b"\x00")
        out.append(struct.pack("<I", len(block.op_codes)))
        out.append(bytes(int(op) for op in block.op_codes))
        hints = sorted(block.op_hints.items())
        out.append(struct.pack("<I", len(hints)))
        for step, hint in hints:
            out.append(struct.pack("<IB", step, _HINT_KINDS[hint.kind]))
            out.append(int(hint.value).to_bytes(16, "little"))
    elif isinstance(block, Group):
        out.append(b"\x01")
        out.append(struct.pack("<I", len(block.body)))
        for b in block.body:
            _serialize_block(b, out)
    elif isinstance(block, Switch):
        out.append(b"\x02")
        out.append(int(block.true_branch_hash()).to_bytes(16, "little"))
        out.append(int(block.false_branch_hash()).to_bytes(16, "little"))
        out.append(struct.pack("<I", len(block.t_branch)))
        for b in block.t_branch:
            _serialize_block(b, out)
        out.append(struct.pack("<I", len(block.f_branch)))
        for b in block.f_branch:
            _serialize_block(b, out)
    elif isinstance(block, Loop):
        out.append(b"\x03")
        out.append(int(block.image()).to_bytes(16, "little"))
        out.append(int(block.body_hash()).to_bytes(16, "little"))
        out.append(int(block.skip_hash()).to_bytes(16, "little"))
        out.append(struct.pack("<I", len(block.body)))
        for b in block.body:
            _serialize_block(b, out)
    else:
        raise TypeError(f"unknown block type {type(block)}")


def serialize_program(program):
    out = [struct.pack("<I", len(program.root.body))]
    for b in program.root.body:
        _serialize_block(b, out)
    return b"".join(out)


def execute_u64(program, inputs):
    """Native trace generation returning raw (R, n, 2) uint64 register words
    (little-endian u128 halves), with the context and loop depths."""
    blob = serialize_program(program)
    pub = b"".join(int(v).to_bytes(16, "little") for v in inputs.get_public_inputs())
    sa, sb = inputs.get_secret_inputs()
    ta = b"".join(int(v).to_bytes(16, "little") for v in sa)
    tb = b"".join(int(v).to_bytes(16, "little") for v in sb)

    out_buf = ctypes.c_void_p()
    out_regs = ctypes.c_size_t()
    out_len = ctypes.c_size_t()
    out_ctx = ctypes.c_size_t()
    out_loop = ctypes.c_size_t()
    err = ctypes.c_char_p()

    native = lib()
    rc = native.dt_execute(
        blob, len(blob), pub, len(pub) // 16, ta, len(ta) // 16, tb, len(tb) // 16,
        ctypes.byref(out_buf), ctypes.byref(out_regs), ctypes.byref(out_len),
        ctypes.byref(out_ctx), ctypes.byref(out_loop), ctypes.byref(err))
    if rc != 0:
        raise AssertionError(f"native execution failed: {err.value.decode()}")

    n_regs, n = out_regs.value, out_len.value
    raw = ctypes.cast(out_buf, ctypes.POINTER(ctypes.c_uint8 * (n_regs * n * 16)))
    arr = np.frombuffer(bytearray(raw.contents), dtype=np.uint64).reshape(n_regs, n, 2)
    native.dt_free(out_buf)
    return arr, out_ctx.value, out_loop.value


def sponge_rounds(state, op_codes, op_values, step_offset):
    """Apply len(op_codes) op-injecting sponge rounds to 4 field elements;
    bit-identical to repeated utils.sponge.apply_round."""
    n = len(op_codes)
    buf = ctypes.create_string_buffer(
        b"".join(int(v).to_bytes(16, "little") for v in state), 64)
    codes = bytes(int(c) & 0xFF for c in op_codes)
    vals = b"".join(int(v).to_bytes(16, "little") for v in op_values)
    lib().dt_sponge_rounds(buf, codes, vals, step_offset, n)
    raw = buf.raw
    return [int.from_bytes(raw[i * 16 : (i + 1) * 16], "little") for i in range(4)]


def blake3_single(data: bytes) -> bytes:
    """One-shot BLAKE3 of any length."""
    out = ctypes.create_string_buffer(32)
    lib().dt_blake3_single(data, len(data), out)
    return out.raw


def blake3_batch(data: np.ndarray) -> np.ndarray:
    """Batch hash: (N, L) uint8 -> (N, 32) uint8."""
    data = np.ascontiguousarray(data)
    n, length = data.shape
    out = np.empty((n, 32), dtype=np.uint8)
    lib().dt_blake3_batch(
        data.ctypes.data_as(ctypes.c_char_p), n, length,
        out.ctypes.data_as(ctypes.c_char_p))
    return out


def merkle_nodes(leaves: np.ndarray) -> np.ndarray:
    """Full-tree internal node construction for blake3 trees."""
    leaves = np.ascontiguousarray(leaves)
    n = leaves.shape[0]
    out = np.empty((2 * (n // 2), 32), dtype=np.uint8)
    lib().dt_merkle_nodes(
        leaves.ctypes.data_as(ctypes.c_char_p), n,
        out.ctypes.data_as(ctypes.c_char_p))
    return out
