"""Kernel K4 (air_transition): its launch, its tables and its host build.

K4 (csrc/air_transition.cu, per-row evaluator csrc/air_row.cuh) replaces
the fused XLA AIR kernel of the JAX package,
distaff_tpu/stark/constraints/device_eval.py::_transition_kernel: over every
row j of the evaluation domain D_ev it evaluates the decoder and stack
transition constraints between row j and row j + 8 (the next trace step)
of the stride-(ext/8) LDE slice, and folds them into the degree-grouped
random linear combination.  It also counts the trace-step rows where the
combination is nonzero (`bad`), leaving out the last step, whose
wrap-around transition is legitimately nonzero.  Bound by operations (a
few hundred field multiplies a row); see the source for the design.

The evaluator is a template over the trace's depths (ctx, loop, stack):
`air_lib` builds one library per depth triple at its first launch (nvcc,
into distaff_torch/_build/), and a triple out of range raises.  The
coefficient positions and degree groups are fixed in the build; the
launch checks that the tables' groups are the library's.

`air_transition` launches the kernel on tensors on the card and raises on
any other.  K4's plain version is the polymorphic AIR over TorchCol
columns, stark/constraints/device_eval.py `transition_plain`, and
`device_eval.transition` chooses between the two by the tensor's device.
"""

import ctypes
import dataclasses

import torch

from . import cuda_lib

STEP_ROWS = 8                      # rows of D_ev per trace step (MAX_CONSTRAINT_DEGREE)
MAX_CTX, MAX_LOOP, MAX_STACK = 16, 8, 32
MAX_CONSTRAINTS = 22 + MAX_CTX + MAX_LOOP + MAX_STACK


@dataclasses.dataclass
class AirTables:
    """Everything K4 reads besides the trace, for one evaluator.

    Periodic tables are (k, cycle, 4) limbs indexed by j % cycle; `mds` is
    the sponge MDS, its inverse, the hasher MDS and its inverse, row-major,
    as (104, 4); `cc` holds the coefficient pairs in consumption order (the
    stack's are sized for a stack of at least 8); `groups` lists the
    constraint indices of each degree group, by ascending degree; `incr`
    holds each group's degree-adjustment exponent (mod n), so that the
    group's adjustment at row j of D_ev is r^(incr j mod n), r the root of
    D_ev; `x_lo` and `x_hi` are r's two power tables over D_ev
    (tiles._store_factors: r^e = x_lo[e % 1024] x_hi[e // 1024], x_hi None
    up to 1024 points)."""
    ctx_depth: int
    loop_depth: int
    stack_depth: int
    groups: tuple
    dec_ark: torch.Tensor
    masks: torch.Tensor
    stk_ark: torch.Tensor
    mds: torch.Tensor
    cc: torch.Tensor
    incr: tuple
    x_lo: torch.Tensor
    x_hi: torch.Tensor

    def depths(self):
        return (self.ctx_depth, self.loop_depth, self.stack_depth)

    def domain(self):
        """The points of D_ev that the power tables cover."""
        return self.x_lo.shape[0] * (1 if self.x_hi is None else self.x_hi.shape[0])

    def x_tables(self):
        """The power tables that are present."""
        return [t for t in (self.x_lo, self.x_hi) if t is not None]

    def constraint_count(self):
        return (20 + max(self.ctx_depth, 1) + max(self.loop_depth, 1)
                + 2 + self.stack_depth)


def degree_groups(degrees):
    """Constraint indices grouped by degree, by ascending degree (the
    Evaluator's grouping)."""
    return tuple(tuple(c for c, d in enumerate(degrees) if d == degree)
                 for degree in sorted(set(degrees)))


def check_inputs(lde, t, n=None):
    """Raise unless the slice and the tables fit each other and the depths
    fit the kernel; n is the domain's size where the slice holds a window
    of it (default its own rows)."""
    r, n = lde.shape[0], lde.shape[1] if n is None else n
    depths = t.depths()
    if not (0 <= t.ctx_depth <= MAX_CTX and 0 <= t.loop_depth <= MAX_LOOP
            and 0 <= t.stack_depth <= MAX_STACK):
        raise ValueError(f"air_transition: depths {depths} out of range")
    if lde.dim() != 3 or r != 15 + sum(depths):
        raise ValueError(f"air_transition: expected ({15 + sum(depths)}, n, 4) registers, "
                         f"got {tuple(lde.shape)}")
    cycle = t.dec_ark.shape[1]
    if n < STEP_ROWS or n & (n - 1) or n % cycle or t.domain() != n or \
            len(t.incr) != len(t.groups):
        raise ValueError(f"air_transition: domain {n} (a power of two) does not fit cycle "
                         f"{cycle}, power tables of {t.domain()} points or {len(t.incr)} "
                         f"exponents")
    if (t.dec_ark.shape[0], t.masks.shape[0], t.stk_ark.shape[0]) != (8, 3, 12) or \
            t.masks.shape[1] != cycle or t.stk_ark.shape[1] != cycle or t.mds.shape[0] != 104:
        raise ValueError("air_transition: periodic or MDS tables of the wrong shape")
    count = t.constraint_count()
    if t.cc.shape[0] < 2 * count or sum(len(g) for g in t.groups) != count:
        raise ValueError(f"air_transition: expected {count} constraints in the groups")


def series_args(tables):
    """The degree adjustments' arguments of K4's entry points: the groups'
    exponents (a host array), their count, r's power tables (x_hi null up
    to 1024 points) and log2 of x_lo's length."""
    incr = (ctypes.c_longlong * max(1, len(tables.incr)))(*tables.incr)
    hi = ctypes.c_void_p(None) if tables.x_hi is None else cuda_lib.ptr(tables.x_hi)
    return (incr, len(tables.incr), cuda_lib.ptr(tables.x_lo), hi,
            tables.x_lo.shape[0].bit_length() - 1)


# ------------------------------------------------------------------------------------------------
# the kernel: one library per depth triple
# ------------------------------------------------------------------------------------------------

_libs = {}


def air_lib(depths):
    """K4 built for these (ctx, loop, stack) depths at first use, with the
    groups of its degree table: (ctypes handle, groups, build log path)."""
    depths = tuple(int(d) for d in depths)
    if depths not in _libs:
        ctx, loop, stack = depths
        if not (0 <= ctx <= MAX_CTX and 0 <= loop <= MAX_LOOP and 0 <= stack <= MAX_STACK):
            raise ValueError(f"air_transition: depths {depths} out of range")
        path = cuda_lib.build_library(
            f"distaff_air_{ctx}_{loop}_{stack}", cuda_lib.CSRC / "air_transition.cu",
            [f"AIR_CTX={ctx}", f"AIR_LOOP={loop}", f"AIR_STACK={stack}"])
        handle = ctypes.CDLL(str(path))
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        handle.distaff_air_transition.argtypes = [
            vp, ll, ll, ll, vp, vp, vp, i32, vp, vp, ctypes.POINTER(ll), i32, vp, vp, i32, vp,
            vp, ll, ll, vp, vp]
        handle.distaff_air_transition.restype = i32
        handle.distaff_air_layout.argtypes = [vp, vp]
        handle.distaff_air_layout.restype = i32
        built, degrees = (ctypes.c_int * 3)(), (ctypes.c_int * MAX_CONSTRAINTS)()
        count = handle.distaff_air_layout(built, degrees)
        if tuple(built) != depths:
            raise RuntimeError(f"air_transition: library for {depths} reports {tuple(built)}")
        _libs[depths] = (handle, degree_groups(degrees[:count]), path.with_suffix(".log"))
    return _libs[depths]


def ptxas_report(depths):
    """ptxas' lines (registers, stack frame, spills) for K4 at these depths."""
    return cuda_lib.ptxas_lines(air_lib(depths)[2])


def check_shard(lde, tables, first, halo):
    """Raise unless the (R, count, 4) rows [first, first + count) of D_ev
    and the (R, 8, 4) halo of the 8 rows after them fit the tables' domain
    (a window of whole trace steps, at least one)."""
    n, count = tables.domain(), lde.shape[1]
    check_inputs(lde, tables, n)
    if halo.shape != (lde.shape[0], STEP_ROWS, 4) or first % STEP_ROWS or \
            count % STEP_ROWS or not 0 <= first < first + count <= n:
        raise ValueError(f"air_transition: rows [{first}, {first + count}) of {n} with a halo "
                         f"of {tuple(halo.shape)}")


def air_transition(lde, tables, first=0, halo=None):
    """(R, n, 4) LDE slice over D_ev on the card (any row and register
    strides, limbs contiguous) -> (combined (n, 4) column, bad count as a
    (1,) int32 tensor on the same device), in one launch.  With a `halo`
    (R, 8, 4), the slice holds the rows [first, first + count) of D_ev
    alone (a slot's, parallel/mesh_stages.transition_sharded), halo the 8
    after them, and the column is theirs; without, it is the whole domain."""
    t = tables
    if halo is None:
        if first:
            raise ValueError("air_transition: a window of the domain needs its halo")
        check_inputs(lde, t)
    else:
        check_shard(lde, t, first, halo)
        halo = halo.contiguous()
    cuda_lib.require_limbs("air_transition", lde, t.dec_ark, t.masks, t.stk_ark, t.mds,
                           t.cc, *t.x_tables(), *([] if halo is None else [halo]))
    handle, groups, _ = air_lib(t.depths())
    if tuple(tuple(g) for g in t.groups) != groups:
        raise ValueError(f"air_transition: the tables' degree groups are not those of the "
                         f"kernel built for depths {t.depths()}")
    dec_ark, masks, stk_ark = t.dec_ark.contiguous(), t.masks.contiguous(), t.stk_ark.contiguous()
    mds, cc = t.mds.contiguous(), t.cc.contiguous()
    count = lde.shape[1]
    out = torch.empty((count, 4), dtype=torch.uint32, device=lde.device)
    bad = torch.zeros((1,), dtype=torch.int32, device=lde.device)
    p = cuda_lib.ptr
    code = handle.distaff_air_transition(
        p(lde), t.domain(), lde.stride(0) // 4, lde.stride(1) // 4,
        p(dec_ark), p(masks), p(stk_ark), dec_ark.shape[1], p(mds), p(cc),
        *series_args(t), p(out), p(bad), first, count,
        ctypes.c_void_p(None) if halo is None else p(halo), cuda_lib.stream(lde))
    cuda_lib.check(code, "air_transition")
    cuda_lib.LAUNCHES["air_transition"] += 1
    return out, bad


# ------------------------------------------------------------------------------------------------
# the per-row evaluator of csrc/air_row.cuh built for the host (g++), at the
# triples of csrc/air_row_host.cpp: the CPU tests hold it against the plain
# version, and its operation counts give K4's bound
# ------------------------------------------------------------------------------------------------

_host = None


def host_lib():
    """csrc/air_row_host.cpp built with g++ at first use."""
    global _host
    if _host is None:
        from .. import build

        src = cuda_lib.CSRC / "air_row_host.cpp"
        headers = [cuda_lib.CSRC / h for h in ("air_row.cuh", "field128.cuh")]
        path = build.shared_library(
            "distaff_air_host", ["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                                 "-I", str(cuda_lib.CSRC), str(src)], [src, *headers])
        handle = ctypes.CDLL(str(path))
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        handle.distaff_air_host_triples.argtypes = [vp]
        handle.distaff_air_rows_host.argtypes = [
            i32, i32, i32, vp, ll, ll, ll, vp, vp, vp, i32, vp, vp, ctypes.POINTER(ll), i32,
            vp, vp, i32, vp]
        handle.distaff_air_ops_host.argtypes = [i32, i32, i32, ctypes.POINTER(ll)]
        handle.distaff_air_layout_host.argtypes = [i32, i32, i32, vp]
        for fn in (handle.distaff_air_host_triples, handle.distaff_air_rows_host,
                   handle.distaff_air_ops_host, handle.distaff_air_layout_host):
            fn.restype = i32
        _host = handle
    return _host


def host_triples():
    """The depth triples the host build instantiates."""
    out = (ctypes.c_int * 96)()
    count = host_lib().distaff_air_host_triples(out)
    return [tuple(out[3 * k: 3 * k + 3]) for k in range(count)]


def _host_call(depths, code):
    if code < 0:
        raise ValueError(f"air_row_host: no instantiation for depths {tuple(depths)} "
                         f"(built: {host_triples()})")
    return code


def air_rows_host(lde, tables):
    """The combined column computed row by row on the host by air_row.cuh."""
    check_inputs(lde, tables)
    t = tables
    if tuple(tuple(g) for g in t.groups) != degree_groups(air_degrees_host(t.depths())):
        raise ValueError("air_rows_host: the tables' degree groups are not the evaluator's")
    lde = lde.detach().cpu()
    t = dataclasses.replace(t, **{name: None if x is None else x.detach().cpu().contiguous()
                                  for name, x in (("dec_ark", t.dec_ark), ("masks", t.masks),
                                                  ("stk_ark", t.stk_ark), ("mds", t.mds),
                                                  ("cc", t.cc), ("x_lo", t.x_lo),
                                                  ("x_hi", t.x_hi))})
    n = lde.shape[1]
    out = torch.empty((n, 4), dtype=torch.uint32)
    p = cuda_lib.ptr
    _host_call(t.depths(), host_lib().distaff_air_rows_host(
        *t.depths(), p(lde), n, lde.stride(0) // 4, lde.stride(1) // 4,
        p(t.dec_ark), p(t.masks), p(t.stk_ark), t.dec_ark.shape[1], p(t.mds), p(t.cc),
        *series_args(t), p(out)))
    return out


def air_ops_per_row(depths):
    """(multiplies, adds, subtractions) in the field that air_row.cuh does
    for one row at these (ctx, loop, stack) depths, over a domain of more
    than 1024 points (each group's x^incr from the power tables is one
    multiply there): the count is the same for every row and every value."""
    counts = (ctypes.c_longlong * 3)()
    _host_call(depths, host_lib().distaff_air_ops_host(*depths, counts))
    return tuple(counts)


def air_degrees_host(depths):
    """The degree of each constraint in air_row.cuh's table at these depths."""
    degrees = (ctypes.c_int * MAX_CONSTRAINTS)()
    count = _host_call(depths, host_lib().distaff_air_layout_host(*depths, degrees))
    return list(degrees[:count])
