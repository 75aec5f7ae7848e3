"""Transition constraints over the whole evaluation domain, on the device.

The port's counterpart of distaff_tpu/stark/constraints/device_eval.py.
Prover step 3 evaluates the decoder and stack transition constraints at
every row of D_ev (the stride-(ext/8) slice of the LDE) against the row 8
ahead, and folds them into the degree-grouped random linear combination.
On the card this is one launch of kernel K4 (ops/air_kernels.py) over the
whole domain, reading the LDE slice in place; on the CPU it is K4's plain
version, `transition_plain` below (`transition` chooses by device): the polymorphic AIR (decoder_air,
stack_air) run over TorchCol columns, with the structured hot spots
batched through the math/torch_col helpers.  Both give the values of the
JAX package's fused kernel and of its host columnar sweep bit for bit.

Unlike the JAX package, the port runs this at every domain size and in one
piece: there is no compile to amortize and no chunking.
"""

import functools

import numpy as np
import torch

from ...math import field
from ...math import field_torch as ft
from ...math.torch_col import TorchCol, stack_cols, unstack, weighted_sum
from ...config import MAX_CONSTRAINT_DEGREE, NUM_CF_OPS, NUM_LD_OPS, NUM_HD_OPS
from ...crypto.ark_constants import SPONGE_MDS, SPONGE_INV_MDS, HASHER_MDS, HASHER_INV_MDS
from ...ops import air_kernels, tiles
from ...ops.air_kernels import AirTables
from ...ops.field_kernels import sub_plain, mul_plain
from ...programs.opcodes import OpCode
from ..trace_state import TraceState
from .evaluator import _ResultView

M = field.M


class _DeviceTraceState(TraceState):
    """TraceState whose lazy op-flag computation runs as stacked column
    products.

    Bit-identical to TraceState._compute_flags (including the reference's
    ld_op_flags[2] quirk using cf_op_bits[1] and the PUSH/ASSERT degree
    fix-ups after the BEGIN and NOOP flags, trace_state.rs:281-350) but with
    the flag families factored as binary splits: low-bit combinations times
    high-bit combinations, one (k, n, 4) multiply per level.  Field
    multiplication is exact, so the new association order changes nothing."""

    def _compute_flags(self):
        device = self.cf_op_bits[0].t.device

        def bits_and_nots(bit_cols):
            b = stack_cols(bit_cols)
            return b, sub_plain(ft.constant(1, device), b)

        def pick(t, seq):
            return t.index_select(0, torch.tensor(seq, dtype=torch.int64, device=device))

        cb, ncb = bits_and_nots(self.cf_op_bits)
        lb, nlb = bits_and_nots(self.ld_op_bits)
        hb, nhb = bits_and_nots(self.hd_op_bits)

        # cf flags: low-2-bit combinations, then times bit 2
        cf01 = mul_plain(torch.stack([ncb[0], cb[0], ncb[0], cb[0]]),
                         torch.stack([ncb[1], ncb[1], cb[1], cb[1]]))
        cf = mul_plain(pick(cf01, [i & 3 for i in range(NUM_CF_OPS)]),
                       torch.stack([cb[2] if (i >> 2) & 1 else ncb[2]
                                    for i in range(NUM_CF_OPS)]))

        # ld flags: combination 2 of the low two bits takes cf_op_bits[1] as
        # its position-1 factor, the reference's quirk (trace_state.rs:301)
        ld01 = mul_plain(torch.stack([nlb[0], lb[0], nlb[0], lb[0]]),
                         torch.stack([nlb[1], nlb[1], cb[1], lb[1]]))
        ld23 = mul_plain(torch.stack([nlb[2], lb[2], nlb[2], lb[2]]),
                         torch.stack([nlb[3], nlb[3], lb[3], lb[3]]))
        ld234 = mul_plain(pick(ld23, [i & 3 for i in range(8)]),
                          torch.stack([lb[4] if (i >> 2) & 1 else nlb[4] for i in range(8)]))
        ld = mul_plain(pick(ld01, [i & 3 for i in range(NUM_LD_OPS)]),
                       pick(ld234, [i >> 2 for i in range(NUM_LD_OPS)]))

        hd = mul_plain(torch.stack([nhb[0], hb[0], nhb[0], hb[0]]),
                       torch.stack([nhb[1], nhb[1], hb[1], hb[1]]))[:NUM_HD_OPS]

        begin_flag = TorchCol(mul_plain(ld[OpCode.Begin.ld_index()], hd[OpCode.Begin.hd_index()]))
        noop_flag = TorchCol(mul_plain(ld[OpCode.Noop.ld_index()], hd[OpCode.Noop.hd_index()]))

        # degree fix-ups so PUSH/ASSERT flags don't coincide with BEGIN
        hd = torch.cat([mul_plain(hd[0], lb[0])[None], hd[1:]])
        ld = torch.cat([mul_plain(ld[0], hb[0])[None], ld[1:]])

        self._flags = (unstack(cf), unstack(ld), unstack(hd), begin_flag, noop_flag)


def _device_state(tables, columns):
    state = TraceState.from_vec(tables.ctx_depth, tables.loop_depth, tables.stack_depth, columns)
    state.__class__ = _DeviceTraceState
    return state


@functools.lru_cache(maxsize=None)
def _air(ctx_depth, loop_depth, stack_depth):
    """Decoder and Stack AIR objects: here they supply constraint code and
    counts only; their periodic constants arrive through the tables."""
    from .decoder_air import Decoder
    from .stack_air import Stack

    return (Decoder(16, MAX_CONSTRAINT_DEGREE, ctx_depth, loop_depth),
            Stack(16, MAX_CONSTRAINT_DEGREE, stack_depth))


def _nonzero_step_rows(combined):
    """Count of trace-step rows (every 8th) where `combined` is nonzero,
    leaving out the last step, as a (1,) int32 tensor."""
    rows = combined[::MAX_CONSTRAINT_DEGREE].view(torch.int32)
    nonzero = rows.ne(0).sum(dim=1).gt(0)
    return nonzero[:-1].sum().to(torch.int32).reshape(1)


def degree_adjustments(tables, rows):
    """(G, len(rows), 4): each degree group's x^incr at these rows j of D_ev
    (an int64 tensor), r^(incr j mod n) from r's power tables, as K4 looks
    it up, on K2's plain multiply."""
    n, log_lo = tables.domain(), tables.x_lo.shape[0].bit_length() - 1
    out = []
    for incr in tables.incr:
        e = rows * incr % n
        x = tables.x_lo.index_select(0, e & (tables.x_lo.shape[0] - 1))
        if tables.x_hi is not None:
            x = mul_plain(x, tables.x_hi.index_select(0, e >> log_lo))
        out.append(x)
    return torch.stack(out)


def transition_plain(lde, tables, rows=None):
    """K4's plain version: (R, n, 4) slice over D_ev and its AirTables ->
    (combined (n, 4) column, count of trace-step rows other than the last
    where it is nonzero, as a (1,) int32 tensor).  `rows` gives the rows of
    D_ev that the slice holds, where it is a window of it (default all)."""
    r_count, n = lde.shape[0], lde.shape[1]
    if rows is None:
        rows = torch.arange(n, device=lde.device)
    xp = degree_adjustments(tables, rows)
    nxt = torch.cat([lde[:, MAX_CONSTRAINT_DEGREE:], lde[:, :MAX_CONSTRAINT_DEGREE]], dim=1)
    current = _device_state(tables, [TorchCol(lde[i]) for i in range(r_count)])
    next_state = _device_state(tables, [TorchCol(nxt[i]) for i in range(r_count)])

    phase = rows % tables.dec_ark.shape[1]

    def tile(table):
        # each row's entry of the periodic table, whatever row the slice starts at
        return [TorchCol(table[k].index_select(0, phase)) for k in range(table.shape[0])]

    dec, stk = _air(tables.ctx_depth, tables.loop_depth, tables.stack_depth)
    num_decoder = dec.constraint_count()
    evaluations = [0] * (num_decoder + stk.constraint_count())
    dec.evaluate_columns(current, next_state, tile(tables.dec_ark), tile(tables.masks),
                         _ResultView(evaluations, 0, num_decoder))
    stk.evaluate_columns(current, next_state, tile(tables.stk_ark),
                         _ResultView(evaluations, num_decoder, len(evaluations)))

    # degree-grouped combination (Evaluator._combine_transition), each group
    # two weighted sums over its stacked constraint columns
    result = TorchCol(ft.zeros((n,), lde.device))
    i = 0
    for g, constraints in enumerate(tables.groups):
        cols = [evaluations[c] if isinstance(evaluations[c], TorchCol)
                else TorchCol(ft.constant(int(evaluations[c]) % M, lde.device).expand(n, 4))
                for c in constraints]
        pairs = torch.arange(2 * i, 2 * (i + len(constraints)), device=lde.device)
        even = tables.cc.index_select(0, pairs[0::2])
        odd = tables.cc.index_select(0, pairs[1::2])
        i += len(constraints)
        result = (result + weighted_sum(cols, even)) % M
        result = (result + weighted_sum(cols, odd) * TorchCol(xp[g])) % M
    combined = result.t.expand(n, 4).contiguous()
    return combined, _nonzero_step_rows(combined)


def transition_plain_rows(lde, tables, start, stop):
    """transition_plain's combined column at rows [start, stop) of the
    slice alone, from those rows and the cycle of rows after them (wrapping
    at the end), so that a long slice can be held a window at a time;
    start and stop are multiples of the tables' cycle."""
    n, cycle = lde.shape[1], tables.dec_ark.shape[1]
    if start % cycle or stop % cycle or not 0 <= start < stop <= n:
        raise ValueError(f"transition_plain_rows: rows [{start}, {stop}) of {n} in whole "
                         f"cycles of {cycle}")
    rows = torch.arange(start, stop + cycle, device=lde.device) % n
    combined, _ = transition_plain(lde.index_select(1, rows), tables, rows)
    return combined[:stop - start]


def transition_plain_shard(lde, tables, first, halo):
    """K4's plain version on a slot's rows: (R, count, 4) rows [first,
    first + count) of D_ev and the (R, 8, 4) halo of the 8 rows after them
    -> (their combined (count, 4) column, the count of their trace-step
    rows, the domain's last step left out, where it is nonzero, as a (1,)
    int32 tensor).  first and count are multiples of 8 (whole steps)."""
    air_kernels.check_shard(lde, tables, first, halo)
    count, n = lde.shape[1], tables.domain()
    # the halo's rows are the window's last step: their own next state (the
    # window's first rows) is wrong, and their results are dropped
    window = torch.cat([lde, halo], dim=1)
    rows = torch.arange(first, first + count + MAX_CONSTRAINT_DEGREE, device=lde.device) % n
    combined = transition_plain(window, tables, rows)[0][:count].contiguous()
    steps = torch.arange(first, first + count, MAX_CONSTRAINT_DEGREE, device=lde.device)
    nonzero = combined[::MAX_CONSTRAINT_DEGREE].view(torch.int32).ne(0).sum(dim=1).gt(0)
    bad = (nonzero & steps.ne(n - MAX_CONSTRAINT_DEGREE)).sum().to(torch.int32).reshape(1)
    return combined, bad


def transition(lde, tables, first=0, halo=None):
    """K4's wrapper: its plain version for a slice on the CPU, one launch of
    the kernel for a slice on the card (ops/air_kernels.air_transition).
    With a `halo`, lde holds a slot's rows [first, first + count) of D_ev
    and halo the 8 rows after them (air_kernels.air_transition)."""
    if lde.device.type == "cpu":
        if halo is not None:
            return transition_plain_shard(lde, tables, first, halo)
        air_kernels.check_inputs(lde, tables)
        return transition_plain(lde, tables)
    return air_kernels.air_transition(lde, tables, first, halo)


def air_table_keys(n_ev, device):
    """The keys of the power tables air_tables reads: those of D_ev's root
    (K4's x^incr lookups)."""
    return [tiles.factors_key(n_ev, field.get_root_of_unity(n_ev), 1, device)]


def air_tables(evaluator, device):
    """The AirTables of an evaluator on `device`: periodic constants, MDS
    matrices, transcript coefficients, groups, their degree-adjustment
    exponents and the power tables of D_ev's root (cached by ops/tiles)."""
    n_ev = evaluator.domain_size
    (x_lo, x_hi), = tiles.tables(air_table_keys(n_ev, device))
    groups = tuple(tuple(cs) for _, cs in evaluator.t_degree_groups)

    def limbs(rows):
        return ft.from_ints(np.array(rows, dtype=object), device)

    return AirTables(
        ctx_depth=evaluator.ctx_depth, loop_depth=evaluator.loop_depth,
        stack_depth=evaluator.stack_depth, groups=groups,
        dec_ark=limbs(evaluator.decoder.ark_rows), masks=limbs(evaluator.decoder.mask_rows),
        stk_ark=limbs(evaluator.stack.ark_rows),
        mds=limbs(SPONGE_MDS + SPONGE_INV_MDS + HASHER_MDS + HASHER_INV_MDS),
        cc=limbs(evaluator.coefficients.transition),
        incr=tuple(incr % n_ev for incr, _ in evaluator.t_degree_groups), x_lo=x_lo, x_hi=x_hi)


def evaluate_transition_device(evaluator, trace):
    """Prover step 3 (transition part) on the device of the LDE: one K4
    launch on the card, the plain version on the CPU.  Returns the combined
    column over D_ev as (n_ev, 4) limbs and the count of trace steps, other
    than the last, whose transition constraints do not vanish, as a (1,)
    int32 tensor: 0 for an honest trace."""
    lde = trace.ev_slice()
    return transition(lde, air_tables(evaluator, lde.device))
