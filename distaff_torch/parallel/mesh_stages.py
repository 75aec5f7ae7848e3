"""The prover's stages split over a mesh: the port of
distaff_tpu/parallel/mesh_stages.py.

Where the JAX package places its arrays with NamedSharding and lets XLA
split each stage and insert the collectives at layout changes, here each
stage runs its kernel on every slot's share, at the share's first row of
the domain (the kernels' offset launches), and the reshards are explicit
copies between slots (parallel/mesh.py).  Values are those of the
single-device path bit for bit.

Stage -> split (the reference's concurrency surface, src/math/
parallel.rs:10-179 and src/math/fft.rs:29-38, becomes these placements):

- trace LDE:        registers      (mesh.extend_registers, K1)
- transition AIR:   rows of D_ev   (transition_sharded, K4 with an 8-row halo)
- boundary columns: rows of D_ev   (boundaries_sharded, K10)
- constraint iNTT:  four-step      (ntt_sharded, K1; K11 on slot 0 after)
- constraint LDE:   four-step      (ntt_sharded, K1), then rows
- DEEP composition: rows of D      (compose_sharded, K7)
- FRI folds:        rows of a layer (fold_sharded, K9)
- Merkle subtrees:  leaves         (subtree_nodes_sharded, K13)

Every stage records its layout in RECORDED_SHARDINGS, for the tests and
the smoke run to see that it ran split (in a multi-process job each slot
named with its rank, Mesh.names).  In a job each rank launches on its own
slot only, and take() and the gathers bring their values to every rank's
home (parallel/mesh.py).
"""

import numpy as np
import torch

from ..math import field
from ..math import field_torch as ft
from ..config import MAX_CONSTRAINT_DEGREE
from .mesh import Sharded

M = field.M

# stage name -> (axis, the slots' devices) of that stage's main operand,
# recorded at every call on the mesh (the tests clear it)
RECORDED_SHARDINGS = {}


def _record(stage, axis, mesh):
    RECORDED_SHARDINGS[stage] = (axis, mesh.names())


def rows_of(value, mesh, axis="rows"):
    """value split by rows (dimension 0) over the mesh: as it is where it is
    a Sharded, else scattered from the home device."""
    if isinstance(value, Sharded):
        return value
    return mesh.scatter(value, 0, axis)


def take(value, indexes):
    """The rows of a Sharded at global `indexes` along its split dimension,
    gathered on each slot by its owner and brought, in order, to the home
    device (in a job, to every rank's)."""
    mesh, dim, share = value.mesh, value.dim, value.share()
    indexes = [int(i) for i in indexes]
    by_slot = [[(n, i % share) for n, i in enumerate(indexes) if i // share == s]
               for s in range(mesh.size)]
    pieces, order = [], []
    with mesh.stage():
        with mesh.exchange():
            for s, wanted in enumerate(by_slot):
                if not wanted:
                    continue
                slot, got = mesh.slots[s], None
                if slot.local:
                    with slot.run():
                        local = torch.tensor([i for _, i in wanted],
                                             dtype=torch.int64).to(slot.device)
                        got = value.parts[s].index_select(dim, local)
                shape = list(value.parts[s].shape)
                shape[dim] = len(wanted)
                pieces.append(mesh.to_home(mesh.empty(mesh.home_index, shape), got, s))
                order += [n for n, _ in wanted]
        with mesh.slots[mesh.home_index].run():
            joined = torch.cat(pieces, dim=dim)
            inverse = [0] * len(order)
            for at, n in enumerate(order):
                inverse[n] = at
            return joined.index_select(
                dim, torch.tensor(inverse, dtype=torch.int64).to(mesh.home))


# ------------------------------------------------------------------------------------------------
# step 3: transition AIR over the evaluation domain, rows split
# ------------------------------------------------------------------------------------------------

def ev_rows(trace, mesh):
    """The trace over D_ev split by rows: each slot's stride slice of its
    LDE rows (read in place), or, streaming, the slice that the commitment
    wrote, scattered."""
    if trace.streaming:
        return mesh.scatter(trace.lde_stride_dev, 1, "rows")
    stride = trace.extension_factor // MAX_CONSTRAINT_DEGREE
    return Sharded(mesh, [p[:, ::stride] for p in trace.lde_rows.parts], 1, "rows")


def transition_fits(n_ev, mesh):
    """Whether the transition sweep splits: each slot takes whole trace
    steps (8 rows of D_ev each), at least one."""
    return mesh.splits(n_ev) and (n_ev // mesh.size) % MAX_CONSTRAINT_DEGREE == 0


def transition_sharded(evaluator, trace, mesh):
    """The transition constraints' combined column over D_ev, each slot's
    rows by one K4 launch at their first row (the CPU: K4's plain
    version).  The operand 8 rows ahead, which the JAX package builds as
    one concatenate, is each slot's own rows and an 8-row halo: the next
    slot's first 8 rows (the first slot's at the last).  Returns (the
    column split by rows, the slots' counts of trace steps whose
    constraints do not vanish, (1,) int32 a slot, split)."""
    from ..stark.constraints.device_eval import air_tables, transition

    lde = ev_rows(trace, mesh)
    _record("transition", lde.axis, mesh)
    k, share = mesh.size, lde.share()
    with mesh.stage():
        halos = []
        with mesh.exchange():
            for s in range(k):
                nxt = (s + 1) % k
                halo = mesh.empty(s, (lde.parts[nxt].shape[0], MAX_CONSTRAINT_DEGREE, 4))
                halos.append(mesh.copy_(halo, s, lde.parts[nxt][:, :MAX_CONSTRAINT_DEGREE],
                                        nxt))
        out, bad = zip(*mesh.each(
            lambda slot, part, halo: transition(part, air_tables(evaluator, slot.device),
                                                slot.index * share, halo),
            lde.parts, halos))
    return Sharded(mesh, out, 0, "rows"), Sharded(mesh, bad, 0, "rows")


# ------------------------------------------------------------------------------------------------
# step 3: boundary columns, rows split
# ------------------------------------------------------------------------------------------------

def boundaries_sharded(evaluator, trace, mesh):
    """The first- and last-step boundary columns over D_ev, each slot's
    rows by one K10 launch at their first row.  Returns the two columns
    split by rows."""
    from ..ops import boundary_kernels

    lde = ev_rows(trace, mesh)
    _record("boundaries", lde.axis, mesh)
    n_ev = evaluator.domain_size
    xb_root = field.exp(field.get_root_of_unity(n_ev), evaluator.b_degree_adj)
    i_parts, f_parts = evaluator.boundary_weight_vectors(trace.register_count())
    with mesh.stage():
        firsts, lasts = zip(*mesh.each(
            lambda slot, part: boundary_kernels.boundary_columns(
                part, i_parts, f_parts, xb_root, slot.index * lde.share(), n_ev),
            lde.parts))
    return Sharded(mesh, firsts, 0, "rows"), Sharded(mesh, lasts, 0, "rows")


# ------------------------------------------------------------------------------------------------
# step 6: DEEP composition, rows split
# ------------------------------------------------------------------------------------------------

def _compose_full(a1, a2, c_lde, root, z, nz, s1, s2, c_at_z, k1, k2, kc, incr_base):
    """The DEEP composition over a whole domain on K2's and K6's plain
    versions (the JAX package's _compose_full): a1, a2 and c_lde (n, 4)
    limbs, the rest host ints; the plain counterpart of compose_sharded."""
    from ..ops import field_kernels as fk

    n, device = a1.shape[0], a1.device
    mul, add, sub = fk.mul_plain, fk.add_plain, fk.sub_plain
    const = lambda v: ft.constant(v, device)
    xs = fk.power_series_plain(root, n, device)
    xz = sub(xs, const(z))
    xnz = sub(xs, const(nz))
    w = fk.inv_batch_plain(mul(xz, xnz))
    u = mul(w, xnz)
    v = mul(w, xz)
    base = add(mul(sub(a1, const(s1)), u), mul(sub(a2, const(s2)), v))
    x_incr = fk.power_series_plain(incr_base, n, device)
    composed = add(mul(base, const(k1)), mul(mul(base, x_incr), const(k2)))
    return add(composed, mul(mul(sub(c_lde, const(c_at_z)), u), const(kc)))


def _wsum_full(lde, w):
    """sum_i w[i] lde[i] over (R, D, 4) on K2's plain versions (the JAX
    package's _wsum_full)."""
    from ..ops.deep_kernels import weighted_sum_plain

    return weighted_sum_plain(lde, w)


def _compose_slots(lde, constraint_lde, w1, w2, z, cc, s1, s2, c_at_z, trace_length):
    """K7 on each slot's rows of the LDE domain, at their first point:
    w1 and w2 the weights a row of lde's parts as host ints."""
    from ..ops import deep_kernels
    from ..stark import utils as stark_utils

    mesh = lde.mesh
    n = lde.share() * mesh.size
    next_z = field.mul(z, field.get_root_of_unity(trace_length))
    root = field.get_root_of_unity(n)
    incr = stark_utils.get_incremental_trace_degree(trace_length)
    scalars = (z, next_z, s1, s2, c_at_z, cc.t1_degree, cc.t2_degree, cc.constraints)
    _record("composition", constraint_lde.axis, mesh)

    def compose(slot, part, c_part):
        weights = [ft.from_ints(np.array(w, dtype=object), slot.device) for w in (w1, w2)]
        return deep_kernels.deep_compose(part, c_part, *weights, root, incr, scalars,
                                         slot.index * part.shape[1], n)

    with mesh.stage():
        return Sharded(mesh, mesh.each(compose, lde.parts, constraint_lde.parts), 0, "rows")


def compose_sharded_from_sums(sums, constraint_lde, z, cc_obj, s1, s2, c_at_z, mesh,
                              trace_length):
    """The row-split DEEP composition from the weighted register sums A1 and
    A2 over the LDE domain ((2, D/k, 4) a slot: the streamed prover extends
    them from the coefficients, and the full LDE never exists), K7 reading
    them with the weights (1, 0) and (0, 1)."""
    return _compose_slots(sums, constraint_lde, [1, 0], [0, 1], z, cc_obj, s1, s2, c_at_z,
                          trace_length)


def compose_sharded(trace, constraint_lde, z, cc_obj, s1, s2, c_at_z, mesh):
    """The row-split DEEP composition over the LDE domain: K7 on each
    slot's rows of the LDE and of the constraint evaluations."""
    r_count = trace.register_count()
    return _compose_slots(trace.lde_rows, constraint_lde, cc_obj.trace1[:r_count],
                          cc_obj.trace2[:r_count], z, cc_obj, s1, s2, c_at_z,
                          trace.unextended_length())


# ------------------------------------------------------------------------------------------------
# step 7: FRI folds, rows of a layer split
# ------------------------------------------------------------------------------------------------

def fold_fits(q, mesh):
    """Whether a layer of q rows (4q points) folds on the mesh: each slot
    folds at least 4 rows and its rows make whole leaves of their tree."""
    k = mesh.size
    return k & (k - 1) == 0 and q >= 4 * k


def fold_layout(column, q):
    """A layer's evaluations, split by rows of its column of 4q points,
    laid out as each slot's rows of the layer: slot s takes the rows [s
    q/k, (s + 1) q/k), the four quarters' values of them, as (4, q/k, 4)
    (an all-to-all: each quarter's share lies on one slot of the column)."""
    mesh = column.mesh
    k = mesh.size
    share, rows = column.share(), q // k
    parts = [mesh.empty(s, (4, rows, 4)) for s in range(k)]
    with mesh.stage(), mesh.exchange():
        for s in range(k):
            for j in range(4):
                start = j * q + s * rows
                u, at = divmod(start, share)
                mesh.copy_(parts[s][j], s, column.parts[u][at:at + rows], u)
    return Sharded(mesh, parts, 1, "rows")


def layer_rows(layout):
    """The layer's (q, 4, 4) quartic rows of a fold layout, split by rows:
    the Merkle tree's rows and the openings' values."""
    return Sharded(layout.mesh, [p.transpose(0, 1) for p in layout.parts], 0, "rows")


def fold_sharded(layout, special_x, root, stride, mesh):
    """One radix-4 fold with the rows split (each row folds alone, no
    communication): K9 on each slot's rows of fold_layout's layout, at
    their first row.  Returns the folded column (q points) split by rows."""
    from ..ops import fri_torch

    rows = layout.share()
    q = rows * mesh.size
    _record("fri_fold", layout.axis, mesh)
    with mesh.stage():
        return Sharded(mesh, mesh.each(
            lambda slot, part: fri_torch.fri_fold(part.view(4 * rows, 4), special_x, root,
                                                  stride, first=slot.index * rows, layer_rows=q),
            layout.parts), 0, "rows")


# ------------------------------------------------------------------------------------------------
# steps 2, 5 and 7: Merkle subtrees, leaves split
# ------------------------------------------------------------------------------------------------

def subtree_fits(n, mesh):
    """Whether a tree of n leaves splits into one subtree a slot of at least
    2 leaves."""
    k = mesh.size
    return k & (k - 1) == 0 and n >= 2 * k


def subtree_nodes_sharded(leaves, mesh):
    """(N/k, 8) leaf digests a slot -> each slot's subtree's flat node array
    ((N/k, 8), the root at 1), one K13 launch a slot."""
    from ..ops.blake3_torch import merkle_tree

    _record("merkle_subtrees", leaves.axis, mesh)
    with mesh.stage():
        return mesh.each(lambda slot, part: merkle_tree(part), leaves.parts)
