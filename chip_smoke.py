"""Smoke run of distaff_torch on one NVIDIA H100: builds the kernels, holds
each against its plain PyTorch version at the main path's shapes, proves
and verifies the bench's Fibonacci program on the card, runs the kernel
bench, proves the six examples and the CLI on the card, proves the
bench's larger rungs, proves with the streaming LDE up to 2^22 steps,
whose extended trace does not fit the card, proves over a mesh of slots
of the card (distaff_torch/parallel/), proves the Python VM's traces
(distaff_torch/processor/) and holds the tensor-core leaf NTT (K16), and
proves over several processes (distaff_torch/dist_setup.py).

Usage (from the root of the repository, on a machine with the card):

    python3 chip_smoke.py
    python3 chip_smoke.py --step-times 16 18
    python3 chip_smoke.py --kernel-times
    python3 chip_smoke.py --tree-times
    python3 chip_smoke.py --wsum-times
    python3 chip_smoke.py --inv-times
    python3 chip_smoke.py --processes

The second form only prints step times (step_times below), the third only
the times of K9 and K11 at the proofs' shapes (kernel_times below), the
fourth only the times of the Merkle trees of the 2^16 proof and of 2^23 to
2^25 leaves, of a first proof's power tables and of the other kernels on
the BLAKE3 compression (tree_times below), the fifth only the times of K7
and K15 at the proofs' calls (wsum_times below), the sixth only those of
K6 and of K2's exp_const at M - 2 (inv_times below): a copy of this file
placed at the root of another checkout times that checkout's port, so
that two versions compare on one card in one call.  The seventh runs only
phase 11 (with its own single-process proof in place of phase 4's); each
rank of its jobs is this script again, with --rank-proof.

Phases, in order; any failure raises and exits non-zero:
  1. build    - all at once: nvcc builds each distaff_torch/csrc/*.cu but
                K4's (K1-K3, K5-K16) in its own call and links them, and K4
                once for each depth triple of AIR_TRIPLES (its library is
                built per geometry); g++ builds native/*.cpp and K4's host
                row evaluator (all into distaff_torch/_build/); prints each
                build's seconds, ptxas' register and spill lines for K1, for
                K4 at each triple and for K6-K16, the counts of IADD3,
                IMAD, LOP3, SHF, PRMT and IMMA in the SASS of K3, K9, K13
                and K14 (their compression's split over the two integer
                pipes) and of K7, K10, K15 and K16 (whose IMMA tensor-core
                instructions must not be 0; K16's two pipes' counts too,
                then its resident warps (at least 16 an SM), no spills, its
                IMMA a leaf (fewer than the dense product's 1,024, covering
                no more K bytes than the 544 live k-steps; printed beside
                those 544 as one m16n8k32 each, over or within), its PRMT
                and two pipes' instructions a leaf with each pipe's floor
                and the IMMA's at (163840, 256): k16_report),
                IMAD's forms (IMAD.WIDE,
                IMAD.HI, IMAD.X, IMAD.MOV) beside IADD3, LOP3, SHF, SEL and
                ISETP in K2's exp_kernel and K6, and the card's name and
                power limit
  2. kernels  - K1 ntt_pass at every pass the 2^16 proof launches (its
                NTTs run on random inputs of their shapes, each pass
                recorded and launched again), one row each,
                K2 add/sub/mul at 2^21 elements, over every pair of edge
                values (the PTX multiply's carries) and on the broadcast
                operands of the main path, K2 exp_const at 2^21 and 2^21 -
                2077 elements at every exponent of tests/test_torch_field.py's
                EXPONENTS (the row at M - 2, with its schedule's bound and
                square-and-multiply's), K3 blake3_rows at 2^21 rows of 320
                bytes, K4
                air_transition at (20, 2^19) on the stride slice of the 2^16
                Fibonacci LDE (bad steps 0), on a copy with one value altered
                (bad steps > 0) and on random registers, K5 butterfly at 2^19
                pairs, K6 inv_batch at 2^21 elements with zeros and edge
                values and at INV_LENGTHS (1, 255, 2049, 2^21 - 2077), each
                also all zeros, K7 deep_compose over the 2^16
                proof's LDE domain ((20, 2^21), its tables and exponent) on
                random inputs and with x - z and x - zg vanishing at two
                points, then at (2, 2^21) with the streamed prover's
                weights (1, 0) and (0, 1), at (128, 2^16) with every value,
                weight and constraint evaluation M - 1 (four register
                groups, the largest digit sums) and over a ragged 2^21 - 37
                points (through the C entry: the wrapper takes powers of
                two), K8 poly_eval at the proof's point evaluations ((20,
                2^16) at two points, (1, 2^19) at one; one launch a call,
                and no host-to-device copy where the profiler traces the
                card), K9 fri_fold at every
                layer the 2^16 proof folds (2^19 ... 2^7 rows, each at the
                LDE domain's root and the layer's stride, random values and
                special_x), with the next layer's leaf digests (against the
                plain fold and K3's plain BLAKE3 of its rows) and without,
                K10 boundary_columns at (20, 2^19) point stride 4
                on the 2^16 Fibonacci LDE's slice and on random registers,
                at (128, 2^16) with every value, weight and constant M - 1
                and at (20, 2^18) point stride 8,
                K11 syn_div at the step 4 of the 2^16, 2^18 and 2^20 proofs
                ((3, 2^19), (3, 2^21), (3, 2^23), degree n/8, x_last) on
                random and edge-value coefficients, K12
                power_series over every table the 2^16 proof builds in its
                one launch (the proof run once with the table cache empty
                and the call recorded), at the kernel bench's one-table
                calls of 2^18 and 2^20 rows, and one launch over tables of
                one row, a ragged length (c != 1) and 2^20 rows, K13
                merkle_tree at every tree the 2^16 proof builds (2^21,
                2^20, 2^19, 2^17, ..., 2^5 random leaf digests, each whole
                tree in one launch; the 2^21 tree then TREE_REPEATS times
                in a row, equal each time: the ticket counters reset), each
                equal (tolerance zero: integer field arithmetic and
                hashing) to its plain version on the same inputs; times from
                CUDA events
  3. golden   - `begin push.3 push.5 add end` with ProofOptions(16, 10, 2)
                proved on cuda (step 3 through K10 at point stride 2 and K4
                at depths (0, 0, 2), step 6 through K7 and K8, step 7
                through K9 once: its LDE of 1024 points folds one layer,
                step 4 through K11) must serialize to the bytes pinned in
                tests/test_determinism.py, with no K2 launch and K3 over
                rows K3_ROW_LAUNCHES times; its K9 (with the leaf digests),
                K10, K11 and K13 calls are held against the plain versions
                (K13 at each of its trees, one launch a tree)
  4. main     - the bench's 2^16 Fibonacci proof (bench.py sizing, inputs
                [1, 0], default ProofOptions) proved on cuda and verified,
                with its time, peak device memory and the launches of every
                kernel, the table cache emptied first as for a first proof:
                K1, K3, K4 and K7-K12 must launch (K4, K7, K10 and K11
                exactly once, K3 over rows K3_ROW_LAUNCHES times: the trace
                and the first FRI layer, K6 and K2 never), K1 exactly at
                the passes phase 2 checked and none of two points, K8
                exactly at the
                evaluations phase 2 checked, each one launch, K9
                once at each layer phase 2 checked, K10 and K11 at the
                shapes they were checked at, K12 exactly once (every table
                the proof builds, the launch phase 2 held), K13 at exactly
                the tree sizes phase 2 checked, one launch a tree (K3 never
                over a Merkle level); then proved with per-step times
                (steps 1, 3, 6 and 7 in parts too; step 4 and step 3's K4
                part printed again), and once more without, these two with
                the tables cached: K12 never
  5. bench    - the kernel bench (distaff_torch/tools/kernel_bench.py) at
                2^14, 2^18 and 2^20, which holds ntt_stagewise (K5) equal to
                tiles.ntt (K1) at each size, and K16 (min(4096, n / 256)
                leaves) equal to K1 at 256 points, with both rates in
                Gbutterflies/s; K5, K2's exp_const, K6, K16 and K1-K3 must
                launch
  6. examples - K4 at each example's depths and evaluation domain (at its
                defaults) and K10 at its register count and domain (point
                stride 4) on random registers, equal to their plain
                versions, a row each; then the six examples of distaff_torch/
                examples.py at their CLI defaults proved on cuda with the
                default ProofOptions, each with the table cache emptied: the
                expected outputs, verified, a tampered output rejected, the
                path's kernels launched (K4, K10, K11 and K12 once, at
                the example's depths and registers, K3 over rows
                K3_ROW_LAUNCHES times, K2 never), the K11 call held
                against its plain version; `python -m distaff_torch
                fibonacci` on the card must exit 0; the golden case with
                hash_fn="sha3" must give the JAX package's bytes
  7. ladder   - K1 through two levels of its recursion above leaf^2 points
                (a zero-extended transform of 2^SMALL_LOG2 points at leaf
                SMALL_LEAF and its inverse) against the plain passes on the
                host, the transform timed; then for each rung of LADDER
                (2^18 and 2^20 steps):
                every K1 pass and K8 call of the bench's Fibonacci proof
                held against its plain version, a row each (but the other
                rung's K1 passes: held by their last piece of 2^LAST_PIECE
                points, at the largest offsets they write, and printed);
                the proof on cuda unstepped and verified, with its
                time, step 0, peak device memory, LDE size and K1 passes
                (the LDE must take K1's recursion; its K1 passes and K8
                calls must be exactly those held; K9 once a layer, K10 and
                K11 once, K3 over rows K3_ROW_LAUNCHES times, K12 once, K13
                once a tree, K2 never); every call it made of K3, K4, K7, K9 (its leaf
                digests too), K10, K11 and K13 held against the plain
                versions on the proof's own inputs, run a piece of
                2^LAST_PIECE rows or points at a time (the other rung: the
                last piece of each call; K13 at 2^LADDER_HELD each whole
                tree, at the other rung each tree's nodes above its first
                stage's subtrees and its last subtree's nodes), with a row
                for each class of call at 2^LADDER_HELD; then the
                2^LADDER_HELD rung once more with the step log
  8. stream   - K14 trace_absorb over every block of random registers at
                R = 22 (a partial last block) and R = 70 (two chunks and the
                parent node), its digests equal to the plain version's and
                to K3's of the whole rows, and a middle block at the groups
                of the streamed 2^16, 2^20 and 2^22 proofs ((4, 2^21), (4,
                2^25), (4, 2^27) points) held over its last 2^LAST_PIECE
                rows, a row each; K15 coeff_wsum at (20, 2^16) whole and
                (20, 2^22) over its last piece, a row each, and at (2,
                2^16) with the weights (1, 0) and (0, 1), at (128, 2^14)
                with every value and weight M - 1 and at (20, 2^16 - 37) (a
                ragged last tile); then the bench's
                Fibonacci proof streamed: at 2^16 and 2^20 forced
                (DISTAFF_STREAM_LDE=1), its bytes those of the materialized
                proof of phase 4 or 7 and its peak device memory below that
                proof's; at 2^22 in auto mode, where the LDE with K1's
                scratch (128.8 GB) does not fit, so it must stream; each
                verified, a tampered output rejected, its time, step 0,
                peak memory and launches printed (K14 ceil(R / 4), K15 once,
                K3 over rows once: the first FRI layer; K12 once, K13 once a
                tree; K2 never), and the
                last piece of each call of K4, K7, K10, K14 and K15 held
                against the plain versions (LastPieces)
  9. mesh     - distaff_torch/parallel/ on MESH_SLOTS slots of the card
                (check_offsets): each launch that a slot of the 2^16
                proof makes at its rows, at the last slot's shapes, held
                against its plain version at the same offset, a row each
                (K1's first pass of the sharded constraint LDE at the
                slot's first column, K4 with its 8-row halo, also at slot
                1, both equal to the whole slice's launch at their rows,
                K10 and K7 at their first point, K9 on the slot's rows of
                the first FRI layer); parallel.mesh.dryrun_step(4) on the
                card equal to it on 4 CPU slots; DISTAFF_MESH_DEVICES=2
                raising on one card (with two or more cards, the 2^16 proof
                on cuda:0,cuda:1 instead); then MESH_PROOFS, each proved on
                its slots of the card (k slots on one card: no scaling),
                verified, a tampered output rejected, its bytes those of
                phase 4, 7 or 8's single-device proof, its time, peak
                memory, launches and RECORDED_SHARDINGS printed, every
                stage of MESH_STAGES split over all its slots and the
                split kernels' launches those of mesh_launches
 10. processor - the bench's 2^16 program and the six examples through
                the Python VM (processor.execute_u64), each trace equal to
                the native VM's, the two step 0 times printed, proved on
                cuda through TraceTable and stark.prove (launches counted
                from 0: every kernel of the main path must launch) with the
                bytes of phase 4's or phase 6's proof of the same program,
                verified; then K16 leaf256 at LEAF_SHAPES ((4096, 256), the
                JAX benchmark's, and (163840, 256), the 2^16 LDE's points
                in 256-point leaves) on random leaves with rows of 0, 1 and
                M - 1, at the 256th root and its inverse, equal to its
                plain version and to K1 (tiles.ntt_batched), one launch a
                call, timed beside K1 (a row each), and at a ragged
                (4083, 256)
 11. processes - jobs of several processes on the card, each rank this
                script (--rank-proof) joined through DISTAFF_COORDINATOR
                on a free local port, each job under a time limit: with
                one card a job of 1 rank (NCCL) and jobs of 2 and 4 ranks
                sharing cuda:0 (gloo through pinned host memory); with
                more, 2 ranks (and 4 with 4 cards) over NCCL, a card a
                rank (OpenMP's threads a rank the cores over the ranks);
                every rank proves the 2^16 main program at the default
                options three times (warm, steady, stepped) with phase
                4's bytes, every stage of MESH_STAGES split over the
                ranks; each rank's backend, card, warm and steady seconds,
                peak device memory, launches of K1, K4, K7, K9, K10 and
                K13, exchanges and step times printed with the card's
                name and power limit; then python -m
                distaff_torch.tools.multihost_prove 16 --bench on one rank
                (its proof_sha256 that of a single-process proof of its
                program and options made in the phase) and on 2 ranks of
                the card (or a card a rank) against it as --baseline
                (proof_matches_baseline true, scaling_efficiency printed)

The new paths run after the 2^16 proof, so that what they build and
cache on the card leaves phase 4's peak memory as it was.

The last two lines are the kernel table as JSON and the contract line
{"ok": true, "device": {...}}.
"""

import argparse
import gc
import hashlib
import json
import logging
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import torch

from distaff_torch.ops import field_kernels as fk
from distaff_torch.tools.timing import time_ms

GOLDEN_SHA256 = "876d9f49cddbe11a3b360c04245d3b29712b6309a1eb446af835b123c729c842"
GOLDEN_LEN = 12926
MAIN_LOG2_TRACE = 16
SEED = 20261016

# Bounds: the least time the card could take is the larger of the bytes
# moved (each input read once, each output written once) at 3.35 TB/s
# (H100 SXM data sheet) and the 32-bit integer instructions issued at the
# SM's issue width: 4 schedulers x 32 lanes, one instruction per lane per
# cycle, x SM count x maximum SM clock, both read from the card.  (The
# integer-only pipe has 64 lanes per SM, but IMAD and shifts also issue to
# the FMA pipe; the BLAKE3 kernel runs faster than 64 lanes would allow.)
# Instruction counts per operation, from the algorithms at their leanest
# (K1's butterflies and multiplies counted from this run's data, dif_work):
# a modular add or sub is 4 carry-chained adds, 4 trial subtractions and 4
# selects; a modular multiply is 16 wide 32x32->64 multiply-adds with 16
# carry adds, the fold of the high half through the 46-bit R (8 + 8), the
# second fold (4 + 4) and the final conditional subtraction (8), a
# squaring the same with 10 wide products and 8 adds that double the cross
# products (field_kernels.MUL_OPS, SQR_OPS, which also choose K2's
# exp_const schedule); a BLAKE3 compression is 7 rounds x 8 G x 12 (2
# three-input adds, 2 adds, 4 xors, 4 rotates) plus the 8 output xors.
# K4's field operations per row are
# counted from its own code (air_kernels.air_ops_per_row: the row
# evaluator built for the host counts them at this run's depths).  K2's
# exp_const: the squarings and multiplies of the schedule it runs
# (field_kernels.exp_schedule), a squaring at SQR_OPS.  K6's bound: one
# read and one write of 16 bytes an element (2^21 elements: 67 MB, 0.020
# ms) against 3 multiplies an element,
# Montgomery's least; at the FMA pipe's 64 lanes its multiplies take
# longer (tools/air_probe.py k2exp counts a multiply's instructions on each
# pipe), and a block's one inversion is a dependent chain.  K7's bound
# (compose_bound) is the larger of its bytes (the LDE
# and the constraint evaluations read once, the output written once, the
# weights and its tables) at 3.35 TB/s, its int8 product (2 x 64 x 16R byte
# operations a point) at the tensor cores' 1,979 TOP/s, and its epilogue's
# 32-bit instructions at the issue width (two digit reductions, 15
# multiplies, 3 adds, 7 subtractions a point: deep_kernels.deep_compose_ops;
# before its sums were on the tensor cores, 2R + 13 multiplies a point);
# K8 does one multiply and one add per coefficient and point and
# reads each coefficient once.  K10's bound (boundary_bound) is the larger
# of its bytes (the slice's R values a point read once, the two columns
# written, the weights and x^b's tables) at 3.35 TB/s, its int8 product
# (2 x 128 x 16R byte operations a point, boundary_kernels.boundary_ops) at
# the tensor cores' 1,979 TOP/s (H100 SXM data sheet, dense int8), and its
# epilogue's 32-bit instructions at the issue width: a point's four digit
# reductions at REDUCE_OPS each (31 digits added at their byte offsets into
# a 9-limb sum, 3 each: a shift and a carried add of two limbs; the fold of
# the bits from 2^256 up through R^2, 8; the 256-bit value's folds and
# conditional subtraction as a multiply's, 32), 3 multiplies and 6 adds.
# K9's bytes are the layer read once, the folded column and the next
# layer's leaf digests written and the power tables, its operations those
# of its code (fri_torch.fri_fold_ops) and a compression a leaf.
# K11's bytes are the three columns read once,
# the output written and b's and 1/b's power tables, its operations those of
# the three divisions at their leanest (syndiv_kernels.syn_div_ops); K12's
# bytes are its rows written and the host's squarings, its multiplies
# counted from its code (field_kernels.power_series_ops).  A tree of n
# leaves (K13) reads its leaves and writes its n-row flat array once, 64n
# bytes, against its n - 1 compressions (tree_bound).  K14 reads a block's
# registers once, reads and writes each row's 32-byte chaining value and
# writes the slice's points, against a compression a row (absorb_bound);
# K15 reads the coefficients once and writes its two sums, against K7's
# int8 product and two digit reductions a coefficient (wsum_bound;
# deep_kernels.coeff_wsum_ops; 2R multiplies and 2(R - 1) adds before).
# The bytes bound of K7 and K15 is the same whatever implements them, so
# wsum_times prints it beside the times of two versions.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
ISSUE_LANES_PER_SM = 128
ADD_OPS = SUB_OPS = 12
REDUCE_OPS = 31 * 3 + 8 + 32
COMPRESS_OPS = 7 * 8 * 12 + 8
# phase 2 builds the 2^16 proof's largest tree this many times in a row
TREE_REPEATS = 20
# --tree-times also times K13 at these leaves: the trace trees of the 2^18
# and 2^20 proofs and the constraint tree of the 2^20 proof
TREE_TIMES_LARGE = (1 << 23, 1 << 24, 1 << 25)
# a kernel's time is the median of this many means over back-to-back launches
KERNEL_TRIALS = 7
# kernels of each path: the proof launches K1, K3, K4 and K7-K13 (and K2
# no more, since K11 divides step 4 and K12 builds the power tables), the
# kernel bench K2, K5, K6 and K12 with K1, K3 (the bench also times K4, on a
# random domain)
MAIN_PATH = ("ntt_pass", "blake3_rows", "air_transition", "deep_compose", "poly_eval",
             "fri_fold", "boundary_columns", "syn_div", "power_series", "merkle_tree")
K13 = "distaff_torch/csrc/merkle_tree.cu"
K13_REPLACES = "distaff_tpu/crypto/merkle_dev.py:34"
K14 = "distaff_torch/csrc/trace_absorb.cu"
K14_REPLACES = "distaff_tpu/ops/blake3_jax.py:157"
K15 = "distaff_torch/csrc/coeff_wsum.cu"
K15_REPLACES = "distaff_tpu/ops/tiles.py:221"
# a streamed proof launches K14 (the trace commitment) and K15 (step 6's
# sums) besides the main path's kernels
STREAM_PATH = MAIN_PATH + ("trace_absorb", "coeff_wsum")
# the rungs phase 8 proves forced to stream, whose bytes must equal phases 4
# and 7's materialized proofs; and the rung whose LDE (128.8 GB with K1's
# scratch) does not fit the card, proved in auto mode
STREAM_RUNGS = (16, 20)
STREAM_LOG2_TRACE = 22
# rung -> (sha256 of the proof's bytes, peak device memory) of the
# materialized proofs of phases 4 and 7
MATERIALIZED = {}
# K3's launches over rows in a blake3 proof: the trace rows and the first
# FRI layer's (K9 hashes each folded layer's leaves as it folds it)
K3_ROW_LAUNCHES = 2
# K2's operations: a proof launches none of them
K2_OPS = ("field_ew.add", "field_ew.sub", "field_ew.mul", "field_ew.exp_const")
BENCH_PATH = ("ntt_pass", "field_ew.mul", "field_ew.exp_const", "inv_batch", "blake3_rows",
              "butterfly", "leaf256")
BENCH_SIZES = (14, 18, 20)
# phase 2 holds K6 also at these lengths (and each all zeros), and K2's
# exp_const also at this seeded random exponent (tests/test_torch_field.py's
# EXPONENTS); --inv-times times both at these sizes
INV_LENGTHS = (1, 255, 2049, (1 << 21) - 2077)
EXP_RANDOM = 0xFC80BE13E9BB466A287385820942DC06
INV_TIMES = (18, 20, 21)
# K4's geometries on this run's paths: the bench program's (also the kernel
# bench's AIR_DEPTHS and the fibonacci example's), the golden program's, and
# those of the other examples at their defaults (collatz, comparison,
# conditional, merkle, rangecheck)
AIR_TRIPLES = ((1, 0, 4), (0, 0, 2), (2, 1, 8), (1, 0, 12), (1, 0, 3), (0, 0, 11), (0, 0, 6))
# the bench's rungs above the main path: their LDEs (2^23 and 2^25 points)
# take K1's recursion above tiles.LEAF^2 points
LADDER = (18, 20)
# the rung whose K1 passes and K8 calls phase 7 holds at their shapes; the
# other rung's passes must be of the kinds held
LADDER_HELD = 18
# phase 7 runs the plain versions over the 2^LADDER_HELD rung's domains a
# piece of 2^LAST_PIECE points (rows) at a time; at the other rung it holds
# the last piece of each call alone, at the largest offsets the call reaches
LAST_PIECE = 21
# the leaf and size of the recursive transform phase 7 holds against its
# plain version: two levels of recursion, 16^2 < 2^10 < 2^14
SMALL_LEAF, SMALL_LOG2 = 16, 14
# phase 9: the mesh's slots on the card (parallel/mesh.py), the proofs on
# them (tag, rung, slots, streamed) and the stages each must record split
# over all its slots (parallel/mesh_stages.RECORDED_SHARDINGS)
MESH_SLOTS = 4
MESH_PROOFS = (("2^16 on 4 slots", 16, ["cuda:0"] * 4, False),
               ("2^16 on 8 slots", 16, ["cuda:0"] * 8, False),
               ("2^18 on 4 slots", 18, ["cuda:0"] * 4, False),
               ("2^16 streamed on 4 slots", 16, ["cuda:0"] * 4, True))
MESH_STAGES = ("transition", "boundaries", "composition", "fri_fold", "constraint_intt",
               "constraint_lde", "merkle_subtrees")
# phase 10: K16 at the JAX benchmark's 4096 leaves and at the 2^16 LDE's 20 x 2^21 points
# cut into 256-point leaves, and a ragged batch; example name -> sha256 of phase 6's proof
LEAF_SHAPES = (4096, 20 * (1 << 21) // 256)
LEAF_RAGGED = 4096 - 13
K16 = "distaff_torch/csrc/leaf256.cu"
K16_REPLACES = "distaff_tpu/ops/mxu_ntt.py:156"
# K16's SASS holds one inlined copy of its tile body a stage, and each runs
# twice a leaf (stage A: two n8 tiles of vectors a leaf; stage B: sixteen
# k2 over eight leaves); its design wants at least this many warps an SM
# and no byte products beyond the live k-steps
K16_RUNS_PER_LEAF = 2
K16_MIN_WARPS = 16
K16_LIVE_MMA = 544                  # a leaf: the live (digit, k-step) pairs, an m16n8k32 each
K16_DENSE_MMA = 1024                # a leaf: every k-step of BIGMAT's 496 rows
IMMA_K = {"16832": 32, "16816": 16}  # the K bytes of an m16n8k32 and of an m16n8k16
# int8 mma.sync rates, ops/s, at 8 chains a warp and 16 warps an SM on an
# NVIDIA H100 80GB HBM3 at 700 W (tools/air_probe.py k16): an m16n8k16
# takes 0.68 of an m16n8k32's time for half its work
MMA_SYNC_OPS_PER_S = {"16832": 1270.6e12, "16816": 927.8e12}
EXAMPLE_PROOFS = {}
# phase 11: multi-process jobs (distaff_torch/dist_setup.py), each rank a
# process of this script (--rank-proof) or of the tool: the ranks of each job
# (on one card: NCCL at one rank, then ranks sharing cuda:0 over gloo; with
# more cards: one card a rank over NCCL), a job's time limit, the kernels
# whose launches a rank prints, and the tool's options and size
PROCESS_RANKS_ONE_CARD = (1, 2, 4)
PROCESS_TIMEOUT = 300
PROCESS_KERNELS = ("ntt_pass", "air_transition", "deep_compose", "fri_fold", "boundary_columns",
                   "merkle_tree")
TOOL_OPTIONS = (16, 10, 2)
# the prover's steps, as its DEBUG log names them
PROVER_STEPS = ("extend trace", "trace tree", "evaluate constraints", "constraint polynomial",
                "constraint tree", "DEEP composition", "FRI layers",
                "proof of work and queries", "proof assembly")
# the golden case with hash_fn="sha3": the JAX package's proof bytes before
# the options (tests/test_torch_prove.py pins them and says how they were made)
SHA3_BODY_SHA256 = "73fd09242cd8ffc781def7cd68416ea83fd41c59d63a94c570d15a03340ba74b"
SHA3_BODY_LEN = 13794


def int32_ops_per_s():
    """32-bit instructions the card can issue per second."""
    clock_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_LANES_PER_SM * float(clock_mhz) * 1e6


def max_abs_err(got, want):
    """Largest difference between two tensors, or two tuples of them."""
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_equal(name, shape, kernel, plain):
    """Hold kernel() against plain() (tolerance zero); returns kernel()'s
    result and the largest difference, 0."""
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name} at {shape}: kernel and plain version differ "
                             f"(max abs err {err})")
    return got, err


def bound(bound_bytes, bound_ops, ops_rate, tensor_ops=0):
    """(bound in ms, "bytes" or "operations"): the larger of the bytes at
    the memory rate, the 32-bit instructions at the issue rate and the int8
    tensor-core operations at their dense rate."""
    t_bytes = bound_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(bound_ops / ops_rate, tensor_ops / INT8_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(name, shape, kernel, plain, reps, plain_reps, bound_bytes, bound_ops,
                 ops_rate, source, replaces, tensor_ops=0):
    """Hold kernel() against plain() (tolerance zero), time both and return
    the kernel's row of the JSON table."""
    _, err = check_equal(name, shape, kernel, plain)
    ms = time_ms(kernel, reps, KERNEL_TRIALS, queued=True)
    plain_ms = time_ms(plain, plain_reps)
    bound_ms, bound_by = bound(bound_bytes, bound_ops, ops_rate, tensor_ops)
    print(f"kernel {name} at {shape}: equal to plain; {ms:.4f} ms (plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by})", flush=True)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_kernels(ops_rate):
    """Each kernel at the main path's shapes, equal to its plain version.
    K1 and K8 give a row for each of the proof's passes and calls; for the
    other kernels the first check of each entry gives its row of the JSON
    table, and the others hold K2's broadcast layouts (those of the chains
    that K9-K12 replaced) and edge values."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import blake3_torch as b3
    from distaff_torch.ops import field_kernels as fk
    from distaff_torch.tools.timing import random_elements

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    k2 = "distaff_torch/csrc/field_ew.cu"
    k3 = "distaff_torch/csrc/blake3_rows.cu"
    rows, _ = check_passes(gen, ops_rate, MAIN_LOG2_TRACE)

    # K2 at the LDE domain of the 2^16 rung: 2^21 elements
    count = 1 << 21
    a = random_elements(gen, (count,))
    c = random_elements(gen, (count,))
    for op, cost, line in (("mul", fk.MUL_OPS, 248), ("add", ADD_OPS, 123),
                           ("sub", SUB_OPS, 137)):
        kern, plain = getattr(fk, op), getattr(fk, op + "_plain")
        rows.append(check_kernel(
            f"field_ew.{op}", f"{count} x {count}", lambda k=kern: k(a, c),
            lambda p=plain: p(a, c), 50, 3, 3 * count * 16, count * cost, ops_rate,
            k2, f"distaff_tpu/math/field_jax.py:{line}"))
    rows.append(check_exp_const(gen, ops_rate, a))

    # the PTX multiply's carries: K2 over every pair of edge values
    x, y = edge_pairs(ft)
    for op in ("mul", "add", "sub"):
        kern, plain = getattr(fk, op), getattr(fk, op + "_plain")
        check_equal(f"field_ew.{op}", f"{x.shape[0]} edge pairs", lambda: kern(x, y),
                    lambda: plain(x, y))
    print(f"kernel field_ew.mul/add/sub over {x.shape[0]} edge pairs: equal to plain",
          flush=True)

    # K6 at 2^21 with every 1000th element zero and the edge values in
    # front, then at INV_LENGTHS (a ragged last block among them) and all
    # zeros
    z = a.clone()
    z[::1000] = ft.zeros((), "cuda")
    z[1:x.shape[0] + 1] = x
    rows.append(check_kernel(
        "inv_batch", f"{count}, zeros and edge values", lambda: fk.inv_batch(z),
        lambda: fk.inv_batch_plain(z), 50, 1, 2 * count * 16, count * 3 * fk.MUL_OPS,
        ops_rate, "distaff_torch/csrc/inv_batch.cu", "distaff_tpu/math/field_jax.py:338"))
    for length in INV_LENGTHS:
        for what, values in (("", z[:length]), (", all zeros", torch.zeros_like(z[:length]))):
            check_equal("inv_batch", f"{length}{what}", lambda v=values: fk.inv_batch(v),
                        lambda v=values: fk.inv_batch_plain(v))
    print(f"kernel inv_batch at {', '.join(map(str, INV_LENGTHS))}, each also all zeros: equal "
          f"to plain", flush=True)

    # K2's broadcasts: a constant operand (the power series' doublings
    # before K12), and neg (a zero scalar minus a column) and a register of
    # the LDE's stride-4 slice times its weight (the layouts of step 3's and
    # step 7's chains before K10 and K9)
    scalar = ft.constant(0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321, "cuda")
    zero = ft.zeros((), "cuda")
    variants = [
        ("mul", f"{count} x (4,)", a, scalar, count, 2 * count + 1),
        ("sub", f"(4,) x {count}", zero, a, count, 2 * count + 1),
    ]
    lde = random_elements(gen, (20, count))
    variants.append(("mul", f"(20, {count})[3, ::4] x (4,)", lde[3, ::4], scalar, count // 4,
                     2 * (count // 4)))
    for op, shape, x, y, n, elements in variants:
        kern, plain = getattr(fk, op), getattr(fk, op + "_plain")
        check_kernel(f"field_ew.{op}", shape, lambda k=kern, x=x, y=y: k(x, y),
                     lambda p=plain, x=x, y=y: p(x, y), 50, 1, elements * 16,
                     n * (fk.MUL_OPS if op == "mul" else ADD_OPS), ops_rate, k2, "")

    # K3: trace rows of the 2^16 rung (20 registers = 320 bytes) hashed in
    # place from the (R, D, 4) LDE
    regs = 20
    trace_rows = lde.permute(1, 0, 2)
    blocks = (regs * 16 + 63) // 64
    rows.append(check_kernel(
        "blake3_rows", f"{count} rows x {regs * 16} B", lambda: b3.hash_rows(trace_rows),
        lambda: b3.hash_rows_plain(trace_rows), 10, 1, count * (regs * 16 + 32),
        count * blocks * COMPRESS_OPS, ops_rate, k3, "distaff_tpu/ops/blake3_jax.py:95"))
    del lde, trace_rows
    rows.extend(check_merkle_tree(gen, ops_rate, MAIN_LOG2_TRACE))
    trace, evaluator = fibonacci_case()
    rows.append(check_air(gen, ops_rate, trace, evaluator))
    rows.append(check_boundary(gen, ops_rate, trace, evaluator))
    del trace, evaluator
    rows.append(check_butterfly(gen, ops_rate))
    rows.append(check_deep_compose(gen, ops_rate))
    rows.extend(check_poly_eval(gen, ops_rate, MAIN_LOG2_TRACE))
    rows.extend(check_fri_fold(gen, ops_rate, MAIN_LOG2_TRACE))
    rows.append(check_syn_div(gen, ops_rate))
    rows.extend(check_power_series(ops_rate))
    return rows


def exp_bound(count, steps):
    """exp_const's bound by operations for `count` elements under a
    schedule: its squarings at SQR_OPS and its multiplies at MUL_OPS."""
    squarings, multiplies = fk.exp_schedule_ops(steps)
    return 2 * count * 16, count * (squarings * fk.SQR_OPS + multiplies * fk.MUL_OPS)


def check_exp_const(gen, ops_rate, a):
    """K2's exp_const at every exponent of EXPONENTS on `a` (2^21 elements)
    and on a ragged count, equal to exp_const_plain; the row of e = M - 2
    (the Fermat inverse: the kernel bench's), with the bound of its schedule
    and, printed beside it, that of square-and-multiply's 250 multiplies
    (the parent design's yardstick)."""
    from distaff_torch.crypto.ark_constants import INV_ALPHA

    m = fk.M
    count = a.shape[0]
    ragged = a[:count - 2077]
    for e in (0, 1, 2, 3, m - 1, 2**127, INV_ALPHA, EXP_RANDOM, (1 << 128) - 1):
        for x in (a, ragged):
            check_equal("field_ew.exp_const", f"{x.shape[0]}, e = {e:#x}",
                        lambda x=x, e=e: fk.exp_const(x, e),
                        lambda x=x, e=e: fk.exp_const_plain(x, e))
    check_equal("field_ew.exp_const", f"{ragged.shape[0]}, e = M - 2",
                lambda: fk.exp_const(ragged, m - 2), lambda: fk.exp_const_plain(ragged, m - 2))
    print(f"kernel field_ew.exp_const at {count} and {ragged.shape[0]}, e = 0, 1, 2, 3, M - 1, "
          f"2^127, INV_ALPHA, a random e, 2^128 - 1 and M - 2: equal to plain", flush=True)
    steps = fk.exp_schedule(m - 2)
    row = check_kernel("field_ew.exp_const", f"{count}, e = M - 2", lambda: fk.exp_const(a, m - 2),
                       lambda: fk.exp_const_plain(a, m - 2), 5, 1, *exp_bound(count, steps),
                       ops_rate, "distaff_torch/csrc/field_ew.cu",
                       "distaff_tpu/math/field_jax.py:279")
    old, old_by = bound(*exp_bound(count, fk.window_schedule(m - 2, 1)), ops_rate)
    print(f"kernel field_ew.exp_const: the schedule's {fk.exp_schedule_ops(steps)} squarings and "
          f"multiplies bound it at {row['bound_ms']:.4f} ms; square-and-multiply's 127 and 123 "
          f"at {old:.4f} ms by {old_by}", flush=True)
    return row


class PassRecorder:
    """Within its `with`, records the key and kind of every K1 pass that
    ops/tiles launches (field_kernels.ntt_pass) and launches it; with
    `keep`, its arguments too (which keeps their tensors alive)."""

    def __init__(self, keep=True):
        self.keep = keep

    def __enter__(self):
        from distaff_torch.ops import field_kernels as fk

        self.fk, self.real, self.calls, self.records = fk, fk.ntt_pass, [], []
        fk.ntt_pass = self.record
        return self

    def record(self, *args):
        if self.keep:
            self.calls.append(args)
        self.records.append((pass_key(*args), pass_kind(*args), 2 * args[2].shape[0]))
        return self.real(*args)

    def __exit__(self, *exc):
        self.fk.ntt_pass = self.real

    def keys(self):
        return [key for key, _, _ in self.records]

    def kinds(self):
        return {kind for _, kind, _ in self.records}


def pass_key(src, dst, tw, batch, cols, src_strides, dst_strides, n_in, lo=None, hi=None):
    """A K1 pass's shape: its geometry and which store factors it takes."""
    factors = "" if lo is None else " x lo" if hi is None else " x lo x hi"
    return (f"({batch}, {cols}, {2 * tw.shape[0]}) in {tuple(src_strides)} n_in {n_in} "
            f"out {tuple(dst_strides)}{factors}")


def pass_kind(src, dst, tw, batch, cols, src_strides, dst_strides, n_in, lo=None, hi=None):
    """A K1 pass's kind, its shape without its sizes: how it reads and
    writes (one transform a row, strided columns, or rows of points),
    whether it zero-extends and which store factors it takes."""
    m = 2 * tw.shape[0]

    def layout(strides):
        return "row" if cols == 1 else "columns" if strides[1] == 1 else "rows"

    reach = (cols - 1) * src_strides[1] + (m - 1) * src_strides[2] + 1
    factors = "" if lo is None else " x lo" if hi is None else " x lo x hi"
    return (f"{layout(src_strides)}{' zero extended' if n_in < reach else ''} -> "
            f"{layout(dst_strides)}{factors}")


def main_path_transforms(gen, log2_trace):
    """The NTTs of the bench's 2^log2_trace proof on random inputs of their
    shapes: step 1's interpolation (20, n) and LDE (20, n -> 32 n), step 4's
    interpolation (3, 8 n) and step 5's constraint LDE (8 n -> 32 n)."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import tiles
    from distaff_torch.tools.timing import random_elements

    n, ev, domain = 1 << log2_trace, 1 << (log2_trace + 3), 1 << (log2_trace + 5)
    root = hostfield.get_root_of_unity
    regs, comb, poly = (random_elements(gen, s) for s in ((20, n), (3, ev), (ev,)))
    return [("step 1 interpolation", lambda: tiles.intt_batched(regs, root(n))),
            ("step 1 LDE", lambda: tiles.ntt_batched(regs, root(domain), n=domain)),
            ("step 4 interpolation", lambda: tiles.intt_batched(comb, root(ev))),
            ("step 5 constraint LDE", lambda: tiles.ntt(poly, root(domain), n=domain))]


def dif_work(m, valid):
    """(butterflies, multiplies) of a size-m transform whose first `valid`
    points are nonzero and the rest zero, at the least the data needs: a
    butterfly of two zeros is no work, one with twiddle 1 no multiply (a
    DIF transform; its stage of span h has twiddle 1 at i mod h = 0)."""
    import numpy as np

    nonzero = np.arange(m) < valid
    butterflies = multiplies = 0
    h = m // 2
    while h >= 1:
        pairs = nonzero.reshape(-1, 2, h)
        active = pairs[:, 0] | pairs[:, 1]
        butterflies += int(active.sum())
        multiplies += int(active[:, 1:].sum())
        nonzero = np.stack([active, active], 1).reshape(m)
        h //= 2
    return butterflies, multiplies


def pass_pieces(args, points):
    """The pieces of at most `points` points in which pass_plain runs K1's
    plain version of a pass (the int64 temporaries of a whole LDE would not
    fit the card): groups of whole batch rows, or where one batch row holds
    more, ranges of its columns.  Each is (first batch row, rows, first
    column, stop column)."""
    src, dst, tw, batch, cols, ss, ds, n_in, lo, hi = args
    m = 2 * tw.shape[0]
    if cols * m <= points:
        rows = points // (cols * m)
        return [(b, min(rows, batch - b), 0, cols) for b in range(0, batch, rows)]
    step = max(1, points // m)
    return [(b, 1, c, min(c + step, cols)) for b in range(batch) for c in range(0, cols, step)]


def pass_plain(args, points=1 << 23, last=False):
    """K1's plain version of one pass, a piece at a time (pass_pieces);
    with `last`, the last piece alone."""
    from distaff_torch.ops import field_kernels as fk

    src, dst, tw, batch, cols, ss, ds, n_in, lo, hi = args
    flat_src, flat_dst = src.reshape(-1, 4), dst.reshape(-1, 4)
    pieces = pass_pieces(args, points)
    for b, rows, first, stop in pieces[-1:] if last else pieces:
        fk.ntt_pass_plain(flat_src[b * ss[0]:], flat_dst[b * ds[0]:], tw, rows, cols, ss, ds,
                          n_in, lo, hi, columns=(first, stop))
    return dst


def pass_bound(args):
    """A K1 pass's least bytes and operations on this run's data: the
    points it reads (those below n_in), the points it writes and its tables,
    and the butterflies and multiplies its data needs (dif_work), with the
    store's factor multiply."""
    src, dst, tw, batch, cols, ss, ds, n_in, lo, hi = args
    m = 2 * tw.shape[0]
    in_row = (torch.arange(cols)[:, None] * ss[1] + torch.arange(m)[None, :] * ss[2])
    valid = (in_row < n_in).sum(1).tolist()
    reads = batch * sum(valid)
    points = batch * cols * m
    butterflies = multiplies = 0
    for v, count in Counter(valid).items():
        bf, mul = dif_work(m, v)
        butterflies += batch * count * bf
        multiplies += batch * count * mul
    if lo is not None:
        multiplies += points                 # the four-step twiddle or 1/n
    tables = m // 2 + sum(t.shape[0] for t in (lo, hi) if t is not None)
    return ((reads + points + tables) * 16,
            butterflies * (ADD_OPS + SUB_OPS) + multiplies * fk.MUL_OPS)


def check_passes(gen, ops_rate, log2_trace, last=False):
    """K1 at every pass the bench's 2^log2_trace proof launches: the
    proof's NTTs run on random inputs of their shapes with each pass
    recorded, then each pass is launched again into a fresh output and held
    equal to its plain version on the same inputs, and timed, a row each.
    With `last`, only the pass's last piece (pass_pieces, of 2^LAST_PIECE
    points: at the largest offsets the pass writes) is held, and its time
    is printed, not made a row.  Returns the rows and the keys of the
    passes."""
    from distaff_torch.ops import field_kernels as fk

    rows, keys = [], []
    for what, transform in main_path_transforms(gen, log2_trace):
        with PassRecorder() as rec:
            transform()
        for args in rec.calls:
            args = (args + (None, None))[:10]
            key = pass_key(*args)
            keys.append(key)
            shape = f"2^{log2_trace} {what}: {key}"
            out = torch.zeros_like(args[1])
            launch = lambda: fk.ntt_pass(args[0], out, *args[2:])
            bound_bytes, bound_ops = pass_bound(args)
            source = ("distaff_torch/csrc/ntt_pass.cu", "distaff_tpu/ops/field_pallas.py:252")
            if not last:
                want = torch.zeros_like(out)
                row = check_kernel("ntt_pass", shape, launch,
                                   lambda: pass_plain(args[:1] + (want,) + args[2:]), 20, 1,
                                   bound_bytes, bound_ops, ops_rate, *source)
                row["key"] = ("ntt_pass", log2_trace, key)
                rows.append(row)
                del want
            else:
                launch()
                want = out.clone()
                pass_plain(args[:1] + (want,) + args[2:], 1 << LAST_PIECE, last=True)
                b, count, first, stop = pass_pieces(args, 1 << LAST_PIECE)[-1]
                ds, m = args[6], 2 * args[2].shape[0]
                reach = 4 * ((b + count - 1) * ds[0] + (stop - 1) * ds[1] + (m - 1) * ds[2]) + 3
                differ = int(out.view(torch.int32).ne(want.view(torch.int32)).sum())
                if differ:
                    raise AssertionError(f"ntt_pass at {shape}: {differ} words of the last piece "
                                         f"differ from the plain version")
                ms = time_ms(launch, 3, 3, queued=True)
                bound = max(bound_bytes / HBM_BYTES_PER_S, bound_ops / ops_rate) * 1e3
                print(f"kernel ntt_pass at {shape}: the last piece (batch rows {b}-"
                      f"{b + count - 1}, columns {first}-{stop - 1}, words written up to "
                      f"{reach}) equal to plain; {ms:.4f} ms (bound {bound:.4f} ms)", flush=True)
                del want
            del out
        del rec
    return rows, keys


def check_recursion(gen, ops_rate):
    """K1's recursion above leaf^2 points at a small leaf: one zero-extended
    transform of 2^SMALL_LOG2 points (two levels of recursion) and its
    inverse on the card, equal to the same transforms of the plain passes
    on the host and to the card's transform at the full leaf.  Then the
    forward transform is timed; its bound is the sum of its passes'
    (pass_bound), its plain time the host's.  Returns its row of the JSON
    table (0 launches a proof)."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import tiles
    from distaff_torch.tools.timing import random_elements

    n = 1 << SMALL_LOG2
    root = hostfield.get_root_of_unity(n)
    x = random_elements(gen, (3, n // 32))
    with PassRecorder() as rec:
        got = tiles.ntt_batched(x, root, SMALL_LEAF, n=n)
    forward = len(rec.calls)
    with PassRecorder(keep=False) as rec_inverse:
        back = tiles.intt_batched(got, root, SMALL_LEAF)
    t0 = time.perf_counter()
    want = tiles.ntt_batched(x.cpu(), root, SMALL_LEAF, n=n)
    plain_ms = (time.perf_counter() - t0) * 1e3
    full = tiles.ntt_batched(x, root, n=n)
    torch.cuda.synchronize()
    zero = torch.zeros((3, n - n // 32, 4), dtype=torch.uint32, device="cuda")
    errors = (max_abs_err(got.cpu(), want), max_abs_err(got, full),
              max_abs_err(back, torch.cat([x, zero], 1)))
    if any(errors):
        raise AssertionError(f"K1 recursion at leaf {SMALL_LEAF}: max abs errors {errors}")
    bounds = [pass_bound((args + (None, None))[:10]) for args in rec.calls]
    t_bytes = sum(b for b, _ in bounds) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(o for _, o in bounds) / ops_rate * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    ms = time_ms(lambda: tiles.ntt_batched(x, root, SMALL_LEAF, n=n), 20, KERNEL_TRIALS,
                 queued=True)
    levels = tiles.ntt_buffers(n, SMALL_LEAF) - 2
    print(f"kernel ntt_pass: recursive transform of 2^{SMALL_LOG2} points at leaf {SMALL_LEAF} "
          f"({levels} levels of recursion, {forward} passes for it and "
          f"{len(rec_inverse.records)} for its inverse), equal to the plain passes on the host, "
          f"to the full leaf's transform, and its inverse to the input; the transform "
          f"{ms:.4f} ms (plain on the host {plain_ms:.1f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"by {bound_by})", flush=True)
    return {"name": "ntt_pass", "route": "cuda", "source": "distaff_torch/csrc/ntt_pass.cu",
            "replaces": "distaff_tpu/ops/field_pallas.py:252", "launches": None,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": bound_by, "library_ms": None,
            "key": ("ntt_pass", "recursion", f"leaf {SMALL_LEAF}")}


def edge_pairs(ft):
    """Every pair of edge values as two (n, 4) limb tensors on the card: 0,
    1, M - 1, M - 2, 2^64 +- 1, limbs of all ones below M, and products
    2^127 y whose first fold lies less than 2^93 below a multiple of 2^128
    (the second fold carries into bit 128; tests/test_torch_field.py's
    interpreter of the PTX multiply takes the same values)."""
    m = ft.M
    values = [0, 1, 2, m - 1, m - 2, m - 3, 2**64 - 1, 2**64, 2**64 + 1, 2**32 - 1,
              2**96 - 1, 2**127 - 1, 2**127, 2**128 - 2**96 - 1, m // 2]
    r_inv = pow((45 << 40) - 1, -1, 1 << 128)
    for bits in range(1, 94, 4):
        y = 2 * ((-(1 << bits) + 1) * r_inv % (1 << 128))
        if y < m:
            values.append(y)
    xs = [v for v in values for _ in values]
    ys = [w for _ in values for w in values]
    return ft.from_ints(xs, "cuda"), ft.from_ints(ys, "cuda")


def fibonacci_case():
    """The 2^16 Fibonacci trace extended on the card (ext 32) and its
    Evaluator, as the proof's step 3 sees them."""
    from distaff_torch import assembly, native, ProgramInputs
    from distaff_torch.stark.constraints.evaluator import Evaluator
    from distaff_torch.stark.trace_table import TraceTable

    inputs = ProgramInputs.from_public([1, 0])
    regs, ctx, loop = native.execute_u64(fibonacci_program(assembly, MAIN_LOG2_TRACE), inputs)
    trace = TraceTable(regs, ctx, loop, 32)
    trace.extend("cuda")
    root = trace.build_merkle_tree("blake3").root()
    return trace, Evaluator.from_trace(trace, root, inputs.get_public_inputs(),
                                       trace.get_last_state().user_stack[:1])


def check_air(gen, ops_rate, trace, evaluator):
    """K4 at (20, 2^19): on the stride slice of the 2^16 Fibonacci LDE (no
    bad steps), on a copy with one value altered (bad steps), and on random
    registers, which set every op flag and so reach every constraint arm.
    The first check gives K4's row of the JSON table."""
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import air_kernels
    from distaff_torch.stark.constraints.device_eval import air_tables, transition_plain
    from distaff_torch.tools.timing import random_elements

    lde = trace.lde_dev[:, ::4]                                  # D_ev = 2^19 rows
    tables = air_tables(evaluator, "cuda")
    r, n = lde.shape[0], lde.shape[1]
    muls, adds, subs = air_kernels.air_ops_per_row(tables.depths())
    print(f"K4 at {r} registers, depths {tables.depths()}: "
          f"{muls} multiplies, {adds} adds, {subs} subtractions a row", flush=True)
    bound_bytes, bound_ops = air_bounds(tables, r, n)
    source = ("distaff_torch/csrc/air_transition.cu",
              "distaff_tpu/stark/constraints/device_eval.py:121")

    def run(x, plain=False):
        f = transition_plain if plain else air_kernels.air_transition
        return lambda: f(x, tables)

    row = check_kernel("air_transition", f"({r}, {n}) Fibonacci LDE slice", run(lde),
                       run(lde, True), 20, 1, bound_bytes, bound_ops, ops_rate, *source)
    bad = [int(run(lde)()[1])]
    tampered = lde.clone()
    tampered[0, 8 * 1000] = ft.constant(12345, "cuda")       # the op counter at step 1000
    noise = random_elements(gen, (r, n))
    for what, x in (("slice with one value altered", tampered), ("random registers", noise)):
        (_, count), _ = check_equal("air_transition", f"({r}, {n}) {what}", run(x), run(x, True))
        print(f"kernel air_transition at ({r}, {n}) {what}: equal to plain", flush=True)
        bad.append(int(count))
    print(f"K4 bad steps: {bad[0]} on the Fibonacci slice, {bad[1]} with one value altered, "
          f"{bad[2]} on random registers", flush=True)
    if bad[0] != 0 or bad[1] == 0:
        raise AssertionError(f"K4 bad-step counts {bad[:2]}: expected 0 and > 0")
    return row


def air_bounds(tables, r, n):
    """K4's bound in bytes and operations at (r, n) with these tables."""
    from distaff_torch.ops import air_kernels

    muls, adds, subs = air_kernels.air_ops_per_row(tables.depths())
    table_bytes = sum(t.numel() * t.element_size() for t in (
        tables.dec_ark, tables.masks, tables.stk_ark, tables.mds, tables.cc, *tables.x_tables()))
    return ((r + 1) * n * 16 + table_bytes,
            n * (muls * fk.MUL_OPS + adds * ADD_OPS + subs * SUB_OPS))


def check_air_examples(gen, ops_rate):
    """K4 at each example's geometry (its depths and evaluation domain at
    its defaults, read from one VM run), on random registers and random
    transcript tables, equal to transition_plain; and K10 at its register
    count and domain, point stride 4 (extension 32), on random registers
    with the evaluator's weights, equal to boundary_columns_plain; a row
    each."""
    import numpy as np

    from distaff_torch import examples, native
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import air_kernels
    from distaff_torch.ops import boundary_kernels as bk
    from distaff_torch.stark.constraints.device_eval import air_tables, transition_plain
    from distaff_torch.stark.constraints.evaluator import Evaluator
    from distaff_torch.tools.timing import random_elements

    rng = np.random.default_rng(SEED)
    rows = []
    for name, example in examples.EXAMPLES.items():
        program, inputs, _, _ = example()
        regs, ctx, loop = native.execute_u64(program, inputs)
        depths = (ctx, loop, regs.shape[0] - 15 - ctx - loop)
        n = regs.shape[1] * air_kernels.STEP_ROWS                   # D_ev
        evaluator = Evaluator(regs.shape[1], air_kernels.STEP_ROWS, *depths, rng.bytes(32),
                              [0, 0], 0, [], [])
        tables = air_tables(evaluator, "cuda")
        lde = random_elements(gen, (regs.shape[0], n))
        row = check_kernel(
            "air_transition", f"example {name}: depths {depths}, ({regs.shape[0]}, {n}) "
            f"random registers", lambda: air_kernels.air_transition(lde, tables),
            lambda: transition_plain(lde, tables), 20, 1,
            *air_bounds(tables, regs.shape[0], n), ops_rate,
            "distaff_torch/csrc/air_transition.cu",
            "distaff_tpu/stark/constraints/device_eval.py:121")
        row["key"] = ("air_transition", "example", name)
        rows.append(row)
        slice_ = random_elements(gen, (regs.shape[0], 4 * n))[:, ::4]
        i_parts, f_parts = evaluator.boundary_weight_vectors(regs.shape[0])
        root = pow(hostfield.get_root_of_unity(n), evaluator.b_degree_adj, hostfield.M)
        row = check_kernel(
            "boundary_columns", f"example {name}: {boundary_key(slice_)} random registers",
            lambda: bk.boundary_columns(slice_, i_parts, f_parts, root),
            lambda: bk.boundary_columns_plain(slice_, i_parts, f_parts, root), 20, 1,
            ops_rate=ops_rate, source="distaff_torch/csrc/boundary_columns.cu",
            replaces="distaff_tpu/stark/prover.py:385", **boundary_bound(regs.shape[0], n))
        row["key"] = ("boundary_columns", "example", name)
        rows.append(row)
    return rows


def check_butterfly(gen, ops_rate):
    """K5 at 2^19 pairs: the middle stage of a 2^20-point stagewise NTT."""
    from distaff_torch.ops import field_kernels as fk
    from distaff_torch.tools.timing import random_elements

    pairs = 1 << 19
    a, b, w = (random_elements(gen, (pairs,)) for _ in range(3))
    return check_kernel(
        "butterfly", f"{pairs} pairs", lambda: fk.butterfly_stage(a, b, w),
        lambda: fk.butterfly_stage_plain(a, b, w), 50, 3, pairs * 80,
        pairs * (ADD_OPS + SUB_OPS + fk.MUL_OPS), ops_rate,
        "distaff_torch/csrc/butterfly.cu", "distaff_tpu/ops/field_pallas.py:171")


def compose_bytes(regs, n):
    """K7's bytes over (regs, n) points: the LDE and the constraint
    evaluations read once, the output written once, the weights and the
    four power tables of the domain."""
    return ((regs + 2) * n + 2 * regs + 2 * power_tables(n)) * 16


def compose_bound(regs, n):
    """K7's bound as keywords of check_kernel and piece_row: its bytes, the
    epilogue's 32-bit instructions and the int8 product's operations, from
    its code (deep_kernels.deep_compose_ops)."""
    from distaff_torch.ops import deep_kernels as dk

    product, reductions, muls, adds, subs = dk.deep_compose_ops(regs)
    return {"bound_bytes": compose_bytes(regs, n),
            "bound_ops": n * (reductions * REDUCE_OPS + muls * fk.MUL_OPS + adds * ADD_OPS
                              + subs * SUB_OPS),
            "tensor_ops": n * product}


def deep_compose_first(lde, c_lde, w1, w2, root, incr, scalars, n):
    """K7 over the first n points of lde's domain (any n, through the C
    entry: the wrapper takes whole power-of-two domains); not counted as a
    launch of the main path."""
    import ctypes

    from distaff_torch.ops import cuda_lib
    from distaff_torch.ops import deep_kernels as dk

    stride, regs, _, tables, words = dk.compose_args(lde, root, incr, scalars)
    out = torch.empty((n, 4), dtype=torch.uint32, device="cuda")
    cuda_lib.check(cuda_lib.lib().distaff_deep_compose(
        cuda_lib.ptr(lde), stride, regs, n, cuda_lib.ptr(c_lde), cuda_lib.ptr(w1),
        cuda_lib.ptr(w2), *[ctypes.c_void_p(None) if t is None else cuda_lib.ptr(t)
                            for t in tables], dk.LOG_LO,
        (ctypes.c_uint32 * 32)(*words), cuda_lib.ptr(out), 0, cuda_lib.stream(out)),
        "deep_compose")
    return out


def check_deep_compose(gen, ops_rate):
    """K7 over the 2^16 proof's LDE domain: random (20, 2^21) registers,
    constraint evaluations and weights at the proof's root and x^incr
    exponent (so that phase 4 finds their power tables built), with random
    scalars, then with z = w^k and zg = z g (g the trace domain's root, w^32),
    so that x - z and x - zg vanish at points k and k + 32 and the output
    must be 0 there; then at (2, 2^21) with the streamed prover's weights
    (1, 0) and (0, 1) (one k-step of the product), at (128, 2^16) with
    every value, weight and constraint evaluation M - 1 (four register
    groups, the largest digit sums), and over the first 2^21 - 37 points (a
    ragged last tile).  The first check gives K7's row of the JSON table."""
    import random

    from distaff_torch.math import field as hostfield
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import deep_kernels as dk
    from distaff_torch.stark import utils
    from distaff_torch.tools.timing import random_elements

    regs, trace_length, blowup = 20, 1 << MAIN_LOG2_TRACE, 32
    n = trace_length * blowup
    root = hostfield.get_root_of_unity(n)
    incr = utils.get_incremental_trace_degree(trace_length)
    lde, w1, w2 = (random_elements(gen, shape) for shape in ((regs, n), (regs,), (regs,)))
    c_lde = random_elements(gen, (n,))
    rng = random.Random(SEED)
    scalars = [rng.randrange(hostfield.M) for _ in range(8)]
    k = n // 3
    z = pow(root, k, hostfield.M)
    vanishing = [z, z * pow(root, blowup, hostfield.M) % hostfield.M] + scalars[2:]

    def run(values, plain=False, x=lde, c=c_lde, ws=(w1, w2), at=root):
        f = dk.deep_compose_plain if plain else dk.deep_compose
        return lambda: f(x, c, *ws, at, incr, values)

    row = check_kernel("deep_compose", f"({regs}, {n}), random scalars", run(scalars),
                       run(scalars, True), 20, 1, ops_rate=ops_rate,
                       source="distaff_torch/csrc/deep_compose.cu",
                       replaces="distaff_tpu/stark/prover.py:724", **compose_bound(regs, n))
    got, _ = check_equal("deep_compose", f"({regs}, {n}), x - z and x - zg vanishing",
                         run(vanishing), run(vanishing, True))
    at = got.view(torch.int32).index_select(0, torch.tensor([k, k + blowup], device="cuda"))
    if int((at != 0).sum()):
        raise AssertionError("deep_compose: nonzero where x - z or x - zg vanishes")
    print(f"kernel deep_compose at ({regs}, {n}) with x - z and x - zg vanishing at points "
          f"{k} and {k + blowup}: equal to plain, 0 there", flush=True)
    unit = [ft.from_ints([1, 0], "cuda"), ft.from_ints([0, 1], "cuda")]
    pair = random_elements(gen, (2, n))
    check_equal("deep_compose", f"(2, {n}), weights (1, 0) and (0, 1)",
                run(scalars, x=pair, ws=unit), run(scalars, True, x=pair, ws=unit))
    print(f"kernel deep_compose at (2, {n}) with the streamed prover's weights (1, 0) and "
          f"(0, 1): equal to plain", flush=True)
    del pair
    top, wide_n = hostfield.M - 1, 1 << 16
    wide = ft.constant(top, "cuda").expand(128, wide_n, 4).contiguous()
    tops = ft.constant(top, "cuda").expand(128, 4).contiguous()
    wide_c = ft.constant(top, "cuda").expand(wide_n, 4).contiguous()
    wide_root = hostfield.get_root_of_unity(wide_n)
    check_equal("deep_compose", f"(128, {wide_n}) every value, weight and evaluation M - 1",
                run(scalars, x=wide, c=wide_c, ws=(tops, tops), at=wide_root),
                run(scalars, True, x=wide, c=wide_c, ws=(tops, tops), at=wide_root))
    print(f"kernel deep_compose at (128, {wide_n}) with every value, weight and constraint "
          f"evaluation M - 1 (the largest digit sums): equal to plain", flush=True)
    del wide, wide_c
    ragged = n - 37
    check_equal("deep_compose", f"({regs}, {n}) first {ragged} points",
                lambda: deep_compose_first(lde, c_lde, w1, w2, root, incr, scalars, ragged),
                lambda: dk.deep_compose_plain(lde[:, :ragged], c_lde[:ragged], w1, w2, root,
                                              incr, scalars))
    print(f"kernel deep_compose at ({regs}, {n}) over its first {ragged} points (a ragged last "
          f"tile): equal to plain", flush=True)
    return row


def power_tables(n):
    """Entries of the two power tables of an n-point domain
    (tiles._store_factors)."""
    return min(n, 1024) + (n // 1024 if n > 1024 else 0)


def boundary_key(lde):
    """A K10 call's shape: registers, points and point stride."""
    return f"({lde.shape[0]}, {lde.shape[1]}) point stride {lde.stride(1) // 4}"


def boundary_bound(regs, n):
    """K10's bound as keywords of check_kernel and piece_row: bytes (the
    slice's values read once, the two columns written, the weights and
    x^b's tables), the epilogue's 32-bit instructions and the int8
    product's operations, from its code (boundary_kernels.boundary_ops)."""
    from distaff_torch.ops import boundary_kernels as bk

    product, reductions, muls, adds = bk.boundary_ops(regs)
    return {"bound_bytes": ((regs + 2) * n + 4 * regs + power_tables(n)) * 16,
            "bound_ops": n * (reductions * REDUCE_OPS + muls * fk.MUL_OPS + adds * ADD_OPS),
            "tensor_ops": n * product}


def check_boundary(gen, ops_rate, trace, evaluator):
    """K10 at (20, 2^19), point stride 4: on the 2^16 Fibonacci LDE's slice
    with its evaluator's weights (the row of the JSON table), and on random
    registers with the same weights; then at (128, 2^16) with every value,
    weight and constant M - 1 (four register groups, the largest digit
    sums), and at (20, 2^18) point stride 8 with the evaluator's weights."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import boundary_kernels as bk
    from distaff_torch.tools.timing import random_elements

    lde = trace.lde_dev[:, ::4]
    regs, n = lde.shape[0], lde.shape[1]
    i_parts, f_parts = evaluator.boundary_weight_vectors(regs)
    root = hostfield.exp(hostfield.get_root_of_unity(n), evaluator.b_degree_adj)

    def run(x, plain=False, parts=(i_parts, f_parts), xb=root):
        f = bk.boundary_columns_plain if plain else bk.boundary_columns
        return lambda: f(x, *parts, xb)

    row = check_kernel("boundary_columns", f"{boundary_key(lde)} Fibonacci LDE slice", run(lde),
                       run(lde, True), 20, 1, ops_rate=ops_rate,
                       source="distaff_torch/csrc/boundary_columns.cu",
                       replaces="distaff_tpu/stark/prover.py:385", **boundary_bound(regs, n))
    row["key"] = ("boundary_columns", MAIN_LOG2_TRACE, boundary_key(lde))
    noise = random_elements(gen, (regs, 4 * n))[:, ::4]
    check_equal("boundary_columns", f"{boundary_key(noise)} random registers", run(noise),
                run(noise, True))
    print(f"kernel boundary_columns at {boundary_key(noise)} random registers: equal to plain",
          flush=True)
    del noise
    top = hostfield.M - 1
    wide = ft.constant(top, "cuda").expand(128, 1 << 16, 4).contiguous()
    worst = ([top] * 128, [top] * 128, top, top)
    xb = hostfield.exp(hostfield.get_root_of_unity(1 << 16), 11)
    check_equal("boundary_columns", f"{boundary_key(wide)} every value, weight and constant M - 1",
                run(wide, parts=(worst, worst), xb=xb), run(wide, True, (worst, worst), xb))
    print(f"kernel boundary_columns at {boundary_key(wide)} with every value, weight and constant "
          f"M - 1 (the largest digit sums): equal to plain", flush=True)
    del wide
    strided = random_elements(gen, (regs, 8 << 18))[:, ::8]
    xb = hostfield.exp(hostfield.get_root_of_unity(1 << 18), evaluator.b_degree_adj)
    check_equal("boundary_columns", f"{boundary_key(strided)} random registers",
                run(strided, xb=xb), run(strided, True, xb=xb))
    print(f"kernel boundary_columns at {boundary_key(strided)} random registers: equal to plain",
          flush=True)
    return row


def fold_key(column, stride):
    """A K9 call's shape: the layer's rows and its table stride."""
    return f"{column.shape[0] // 4} rows, stride {stride}"


def fold_bound(q, order):
    """K9's bound over q rows in bytes and operations, with the next
    layer's leaf digests: the layer's 4q values read once, the q outputs
    and q/4 digests written, the power tables of the order-point domain;
    its operations from its code (fri_torch.fri_fold_ops) and a compression
    a leaf."""
    from distaff_torch.ops import fri_torch

    muls, adds, subs = fri_torch.fri_fold_ops(q, order)
    return ((5 * q + power_tables(order)) * 16 + q // 4 * 32,
            muls * fk.MUL_OPS + adds * ADD_OPS + subs * SUB_OPS + q // 4 * COMPRESS_OPS)


def check_fri_fold(gen, ops_rate, log2_trace):
    """K9 at every layer the bench's 2^log2_trace proof folds: a random
    column of the layer's points at the LDE domain's root and the layer's
    stride, folded at a random special_x with the next layer's leaf
    digests (a row each), and without them (the path of any hash but
    blake3)."""
    import random

    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import fri_torch
    from distaff_torch.stark import fri
    from distaff_torch.tools.timing import random_elements

    n = 1 << (log2_trace + 5)
    root = hostfield.get_root_of_unity(n)
    rng = random.Random(SEED + 4)
    rows, length, stride = [], n, 1
    while length > fri.MAX_REMAINDER_LENGTH:
        column = random_elements(gen, (length,))
        special_x = rng.randrange(hostfield.M)
        shape = f"2^{log2_trace} layer {fold_key(column, stride)}"
        row = check_kernel(
            "fri_fold", f"{shape} with its leaf digests",
            lambda: fri_torch.fri_fold(column, special_x, root, stride, digests=True),
            lambda: fri_torch.fri_fold_plain(column, special_x, root, stride, digests=True), 20,
            1, *fold_bound(length // 4, n), ops_rate, "distaff_torch/csrc/fri_fold.cu",
            "distaff_tpu/ops/fri_jax.py:53")
        row["key"] = ("fri_fold", log2_trace, fold_key(column, stride))
        rows.append(row)
        check_equal("fri_fold", shape, lambda: fri_torch.fri_fold(column, special_x, root, stride),
                    lambda: fri_torch.fri_fold_plain(column, special_x, root, stride))
        length, stride = length // 4, stride * 4
    print(f"kernel fri_fold at every 2^{log2_trace} layer without digests: equal to plain",
          flush=True)
    return rows


def eval_key(polys, points):
    """A K8 call's shape: rows, their length and the number of points."""
    return f"({polys.shape[0]}, {polys.shape[1]}) at {len(points)} points"


def host_copies(fn, kernel):
    """The profiler's count of host-to-device copies in one fn() on the
    card, or None where it saw no launch of `kernel` (its trace then says
    nothing)."""
    from torch.profiler import profile, ProfilerActivity

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [event.name for event in prof.events()]
    if not any(kernel in name for name in names):
        return None
    return sum("HtoD" in name for name in names)


def check_poly_eval(gen, ops_rate, log2_trace):
    """K8 at the point evaluations of the bench's 2^log2_trace proof, on
    random coefficients and points: the trace polynomials (20, n) at two
    points and the constraint polynomial (1, 8 n) at one; a row each.  Each
    call must launch once, and queue no host-to-device copy where the
    profiler traces the card."""
    import random

    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import cuda_lib
    from distaff_torch.ops import deep_kernels as dk
    from distaff_torch.tools.timing import random_elements

    rng = random.Random(SEED + 1)
    rows = []
    for regs, length, count in ((20, 1 << log2_trace, 2), (1, 1 << (log2_trace + 3), 1)):
        polys = random_elements(gen, (regs, length))
        points = [rng.randrange(hostfield.M) for _ in range(count)]
        row = check_kernel(
            "poly_eval", eval_key(polys, points), lambda: dk.poly_eval(polys, points),
            lambda: dk.poly_eval_plain(polys, points), 20, 1,
            (regs * length + count * regs + count * dk.POLY_EVAL_SQUARINGS) * 16,
            count * regs * length * (fk.MUL_OPS + ADD_OPS), ops_rate,
            "distaff_torch/csrc/poly_eval.cu", "distaff_tpu/stark/prover.py:636")
        row["key"] = ("poly_eval", log2_trace, eval_key(polys, points))
        rows.append(row)
        before = cuda_lib.LAUNCHES["poly_eval"]
        copies = host_copies(lambda: dk.poly_eval(polys, points), "poly_eval")
        launched = cuda_lib.LAUNCHES["poly_eval"] - before
        if launched != dk.poly_eval_launches(count) or copies:
            raise AssertionError(f"poly_eval at {eval_key(polys, points)}: {launched} launches "
                                 f"and {copies} host-to-device copies in one call")
        print(f"kernel poly_eval at {eval_key(polys, points)}: {launched} launch a call, "
              + ("host-to-device copies not traced" if copies is None else
                 f"{copies} host-to-device copies"), flush=True)
    return rows


def syn_div_key(polys3, degree):
    """A K11 call's shape: the coefficients' points and the degree."""
    return f"(3, {polys3.shape[1]}) degree {degree}"


def syn_div_bound(n, degree):
    """K11's bound in bytes and operations: the three columns read once,
    the output written, b's and 1/b's power tables; the divisions'
    multiplies and adds at their leanest (syndiv_kernels.syn_div_ops)."""
    from distaff_torch.ops import syndiv_kernels as sk

    muls, adds = sk.syn_div_ops(n, degree)
    return (4 * n + 2 * power_tables(n)) * 16, muls * fk.MUL_OPS + adds * ADD_OPS


def check_syn_div(gen, ops_rate):
    """K11 at the step 4 of the 2^16, 2^18 and 2^20 proofs: random (3, 8n)
    coefficients, degree n and the trace's x_last, then with the edge
    values 0, 1, M - 1 and M - 2 at both ends of each row; above 2^21
    points held a piece of 2^LAST_PIECE rows at a time.  The 2^16 call
    gives the row of the JSON table, the others a printed line."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import syndiv_kernels as sk
    from distaff_torch.tools.timing import random_elements

    edge = ft.from_ints([0, 1, hostfield.M - 1, hostfield.M - 2], "cuda")
    for log2_trace in (MAIN_LOG2_TRACE, *LADDER):
        degree = 1 << log2_trace
        n = degree * 8
        x_last = hostfield.exp(hostfield.get_root_of_unity(degree), degree - 1)
        polys3 = random_elements(gen, (3, n))
        shape = f"2^{log2_trace} step 4 {syn_div_key(polys3, degree)}"
        kernel = lambda: sk.syn_div(polys3, degree, x_last)
        if log2_trace == MAIN_LOG2_TRACE:
            row = check_kernel(
                "syn_div", shape, kernel, lambda: sk.syn_div_plain(polys3, degree, x_last), 20,
                1, *syn_div_bound(n, degree), ops_rate, "distaff_torch/csrc/syn_div.cu",
                "distaff_tpu/stark/prover.py:482")
            row["key"] = ("syn_div", MAIN_LOG2_TRACE, syn_div_key(polys3, degree))
        else:
            piece_row("syn_div", shape, kernel, pieces(n, lambda a, b: lambda: sk.syn_div_plain(
                polys3, degree, x_last, start=a)[:b - a]), False, *syn_div_bound(n, degree),
                ops_rate, "distaff_torch/csrc/syn_div.cu", "distaff_tpu/stark/prover.py:482")
        polys3[:, :4] = edge
        polys3[:, -4:] = edge
        hold_pieces("syn_div", f"{shape} edge values", kernel, pieces(
            n, lambda a, b: lambda: sk.syn_div_plain(polys3, degree, x_last, start=a)[:b - a]),
            False)
        print(f"kernel syn_div at {syn_div_key(polys3, degree)} with edge values at both ends: "
              f"equal to plain", flush=True)
        del polys3
    return row


def series_key(x, n, c):
    """A K12 table: its rows, base and constant."""
    return f"{n} rows of {x:#x}^i times {c:#x}"


def tables_key(specs):
    """A K12 call: its tables and their rows."""
    return f"{len(specs)} tables of {sum(n for _, n, _ in specs)} rows"


def series_bound(specs):
    """K12's bound in bytes and operations over the tables (x, n, c) of a
    launch: the rows written and the host's factors read; its multiplies
    from its code (power_series_ops)."""
    from distaff_torch.ops import field_kernels as fk

    rows = sum(n + len(fk.power_series_factors(x, n, c)) for x, n, c in specs)
    return rows * 16, sum(fk.power_series_ops(n) for _, n, _ in specs) * fk.MUL_OPS


def proof_tables(log2_trace):
    """The K12 tables (x, n, c) that a first proof of the bench's program at
    2^log2_trace steps builds, each call of the K12 wrapper a list: the
    proof run once with the table cache emptied and the calls recorded
    (the cache emptied again after).  A version of the port whose K12
    builds a table a launch records a list of one a call."""
    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.ops import tiles

    tiles._TABLES.clear()
    program = fibonacci_program(assembly, log2_trace)
    with ProofCalls(keep=False) as calls:
        distaff_torch.execute(program, ProgramInputs.from_public([1, 0]), 1, ProofOptions(),
                              device="cuda")
    tiles._TABLES.clear()
    return calls.series


def check_power_series(ops_rate):
    """K12 at every power table the 2^16 proof builds, in the one launch
    that the proof makes (proof_tables): each table held against the plain
    version, the launch timed, one row; then the kernel bench's one-table
    calls at 2^18 and 2^20 rows of the domain root, a row each; then one
    launch over a table of one row, a ragged one (c != 1) and 2^20 rows."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import field_kernels as fk

    calls = proof_tables(MAIN_LOG2_TRACE)
    if len(calls) != 1:
        raise AssertionError(f"the 2^{MAIN_LOG2_TRACE} proof built its tables in {len(calls)} "
                             f"K12 calls, not one")
    specs, = calls
    source, replaces = "distaff_torch/csrc/power_series.cu", "distaff_tpu/ops/tiles.py:118"
    plain = lambda: torch.cat([fk.power_series_plain(x, n, "cuda", c) for x, n, c in specs])
    many = lambda: torch.cat(fk.power_series_many(specs, "cuda"))
    row = check_kernel("power_series", f"2^{MAIN_LOG2_TRACE} proof's {tables_key(specs)} in one "
                       f"launch", many, plain, 20, 1, *series_bound(specs), ops_rate, source,
                       replaces)
    row["key"] = ("power_series", MAIN_LOG2_TRACE, tables_key(specs))
    rows = [row]
    root = hostfield.get_root_of_unity(1 << 20)
    for n in (1 << 18, 1 << 20):
        row = check_kernel("power_series", f"kernel bench's table {series_key(root, n, 1)}",
                           lambda: fk.power_series(root, n, "cuda"),
                           lambda: fk.power_series_plain(root, n, "cuda"), 20, 1,
                           *series_bound([(root, n, 1)]), ops_rate, source, replaces)
        row["key"] = ("power_series", "kernel bench", n)    # no launch on the main path
        rows.append(row)
    mixed = [(root, 1, 7), (root, 3000, 0x1234_5678_9ABC_DEF0), (root, 1 << 20, 5)]
    check_equal("power_series", "one launch of 1, 3000 and 2^20 rows",
                lambda: torch.cat(fk.power_series_many(mixed, "cuda")),
                lambda: torch.cat([fk.power_series_plain(x, n, "cuda", c) for x, n, c in mixed]))
    print(f"kernel power_series: the 2^{MAIN_LOG2_TRACE} proof's {len(specs)} tables in one "
          f"launch, equal to plain; one launch of 1, 3000 (c != 1) and 2^20 rows equal to plain",
          flush=True)
    return rows


def tree_sizes(log2_trace, extension=32):
    """The leaves of every Merkle tree that a blake3 proof of 2^log2_trace
    steps builds: the trace tree's (a point of the LDE domain a leaf), the
    constraint tree's (two evaluations a leaf) and each FRI layer's (a
    quartic row a leaf), the remainder's last."""
    domain = extension << log2_trace
    return [domain, domain // 2] + [domain >> 2 * (k + 1) for k in range(fold_layers(domain) + 1)]


def tree_bound(n):
    """K13's bound terms for a tree of n leaves: (bytes, 32-bit operations)."""
    return 64 * n, (n - 1) * COMPRESS_OPS


def tree_plan(n):
    """K13's plan for a tree of n leaves on this card."""
    from distaff_torch.ops import blake3_torch as b3

    return b3.tree_plan(n, b3.device_sms(0))


def check_merkle_tree(gen, ops_rate, log2_trace):
    """K13 at every tree the bench's 2^log2_trace proof builds, on random
    leaf digests, one launch each: each whole tree held equal to the plain
    version (the level loop), a row each; then the largest tree built
    REPEATS times in a row, its nodes equal each time (the last block of
    each group leaves its ticket counter at 0 for the next tree)."""
    from distaff_torch.ops import blake3_torch as b3
    from distaff_torch.ops import cuda_lib
    from distaff_torch.tools.timing import random_elements

    rows = []
    for n in tree_sizes(log2_trace):
        leaves = random_elements(gen, (n, 2)).view(n, 8)
        cuda_lib.reset_launches()
        b3.merkle_tree(leaves)
        if cuda_lib.LAUNCHES["merkle_tree"] != 1:
            raise AssertionError(f"merkle_tree: {cuda_lib.LAUNCHES['merkle_tree']} launches "
                                 f"for a tree of {n} leaves")
        row = check_kernel(
            "merkle_tree", f"2^{log2_trace} tree of {n} leaves in one launch, plan "
            f"{tree_plan(n)}", lambda: b3.merkle_tree(leaves),
            lambda: b3.merkle_tree_plain(leaves), 20, 1, *tree_bound(n), ops_rate, K13,
            K13_REPLACES)
        row["key"] = ("merkle_tree", log2_trace, n)
        rows.append(row)
        if n == tree_sizes(log2_trace)[0]:
            want = b3.merkle_tree_plain(leaves)
            for k in range(TREE_REPEATS):
                if not torch.equal(b3.merkle_tree(leaves), want):
                    raise AssertionError(f"merkle_tree: the tree of {n} leaves differs from "
                                         f"plain when built {k + 1} times in a row")
            print(f"kernel merkle_tree: the tree of {n} leaves built {TREE_REPEATS} times in a "
                  f"row, equal to plain each time", flush=True)
    return rows


def check_tree_top(shape, nodes, leaves):
    """Hold a tree's flat nodes where phase 7's other rung holds them: the
    root and every node above the first stage's subtrees (the plain tree
    over their roots), and the nodes of the last subtree (the plain tree
    over its leaves, at their rows of the whole tree).  Returns the time of
    the plain trees in ms (CUDA events)."""
    from distaff_torch.ops import blake3_torch as b3

    n = leaves.shape[0]
    levels = tree_plan(n)[0]
    roots, size = n >> levels, 1 << levels
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    top = b3.merkle_tree_plain(nodes[roots : 2 * roots]) if roots > 1 else None
    last = b3.merkle_tree_plain(leaves[n - size :])
    end_ev.record()
    torch.cuda.synchronize()
    # the last subtree's local node 2^k + q sits at row 2^k (2 roots - 1) + q
    rows = torch.cat([torch.arange(1 << k, 2 << k) + ((1 << k) * (2 * roots - 2))
                      for k in range(levels)]).to(nodes.device)
    err = max_abs_err(nodes.index_select(0, rows), last[1:])
    if top is not None:
        err = max(err, max_abs_err(nodes[1:roots], top[1:]))
    if err:
        raise AssertionError(f"merkle_tree at {shape}: differs from the plain version "
                             f"(max abs err {err})")
    return start_ev.elapsed_time(end_ev)


def phase_golden():
    """The golden case on cuda: its bytes, verified, no K2 launch; K10 and
    K11 launched once (K10 at point stride 2, extension 16) and K9 once a
    FRI layer (its LDE of 1024 points folds one), each call held against
    its plain version on the proof's own inputs."""
    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.ops import blake3_torch as b3
    from distaff_torch.ops import boundary_kernels as bk
    from distaff_torch.ops import cuda_lib, fri_torch
    from distaff_torch.ops import syndiv_kernels as sk
    from distaff_torch.stark import fri, serde

    program = assembly.compile("begin push.3 push.5 add end")
    inputs = ProgramInputs.none()
    options = ProofOptions(extension_factor=16, num_queries=10, grinding_factor=2)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    with ProofCalls() as calls:
        outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cuda")
    launches = dict(cuda_lib.LAUNCHES)
    blob = serde.serialize(proof)
    digest = hashlib.sha256(blob).hexdigest()
    if len(blob) != GOLDEN_LEN or digest != GOLDEN_SHA256:
        raise AssertionError(f"golden proof differs: {len(blob)} bytes, sha256 {digest}")
    if not distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof):
        raise AssertionError("golden proof does not verify")
    print(f"golden proof on cuda: {len(blob)} bytes, sha256 {digest}, verified", flush=True)
    domain = proof.trace_length() * options.extension_factor()
    (lde, i_parts, f_parts, root), = calls.boundaries
    trees = calls.keys["merkle_tree"]
    tree_launches = len(trees)                     # one K13 launch a tree
    if launches["boundary_columns"] != 1 or lde.stride(1) != 8 or \
            launches["fri_fold"] != fold_layers(domain) or launches["syn_div"] != 1 or \
            launches["blake3_rows"] != K3_ROW_LAUNCHES or any(launches[k] for k in K2_OPS) or \
            sorted(trees, reverse=True) != tree_sizes(proof.trace_length().bit_length() - 1,
                                                      options.extension_factor()) or \
            launches["merkle_tree"] != tree_launches:
        raise AssertionError(f"golden: K10 launched {launches['boundary_columns']} times at "
                             f"{boundary_key(lde)}, K9 {launches['fri_fold']} times, K11 "
                             f"{launches['syn_div']}, K3 over rows {launches['blake3_rows']}, K2 "
                             f"{[launches[k] for k in K2_OPS]}, K13 {launches['merkle_tree']} "
                             f"times over trees of {trees} leaves")
    for (leaves,) in calls.trees:
        check_equal("merkle_tree", f"golden tree of {leaves.shape[0]} leaves",
                    lambda: b3.merkle_tree(leaves), lambda: b3.merkle_tree_plain(leaves))
    (polys3, degree, x_last), = calls.syn_divs
    check_equal("syn_div", f"golden {syn_div_key(polys3, degree)}",
                lambda: sk.syn_div(polys3, degree, x_last),
                lambda: sk.syn_div_plain(polys3, degree, x_last))
    check_equal("boundary_columns", f"golden {boundary_key(lde)}",
                lambda: bk.boundary_columns(lde, i_parts, f_parts, root),
                lambda: bk.boundary_columns_plain(lde, i_parts, f_parts, root))
    for column, special_x, root, stride, digests in calls.folds:
        if not digests:
            raise AssertionError("golden: a blake3 proof folded a layer without its leaf digests")
        check_equal("fri_fold", f"golden layer {fold_key(column, stride)} with its leaf digests",
                    lambda: fri_torch.fri_fold(column, special_x, root, stride, digests=True),
                    lambda: fri_torch.fri_fold_plain(column, special_x, root, stride,
                                                     digests=True))
    print(f"golden: K10 once at {boundary_key(lde)}; K11 once at "
          f"{syn_div_key(polys3, degree)}; the LDE of {domain} points folds "
          f"{launches['fri_fold']} FRI layer(s) ({', '.join(calls.keys['fri_fold'])}) down to at "
          f"most {fri.MAX_REMAINDER_LENGTH} points, K9 once each with the leaf digests; K13 "
          f"{tree_launches} times over its trees of {trees} leaves; each call equal to plain; K3 "
          f"over rows {launches['blake3_rows']} times; K2 never", flush=True)


class _StepLog(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def fibonacci_program(assembly, log2_trace):
    # bench.py's sizing: 3N/64 unrolled iterations pad to exactly 2^k steps
    n_iter = (1 << log2_trace) * 3 // 64
    return assembly.compile(f"begin repeat.{n_iter} swap dup.2 drop add end end")


def timed_execute(program, inputs, options, stepped, num_outputs=1):
    """One proof on cuda and its wall time, with the log lines of the
    package.  With `stepped`, the prover's DEBUG step logging is on, which
    synchronizes the card at each step's end; without, only the line of
    step 0 (the VM, before the prover) comes back."""
    import distaff_torch

    steps = _StepLog()
    package_log = logging.getLogger("distaff_torch")
    prover_log = logging.getLogger("distaff_torch.stark.prover")
    package_log.addHandler(steps)
    package_log.setLevel(logging.DEBUG)
    if not stepped:
        prover_log.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        outputs, proof = distaff_torch.execute(program, inputs, num_outputs, options,
                                               device="cuda")
        torch.cuda.synchronize()
        return outputs, proof, time.perf_counter() - t0, steps.lines
    finally:
        package_log.removeHandler(steps)
        package_log.setLevel(logging.NOTSET)
        prover_log.setLevel(logging.NOTSET)


def step_times(sizes, runs=2):
    """For each 2^k of `sizes`, the bench's Fibonacci proof on cuda once to
    warm up, `runs` times with the step log (a synchronize at each step's
    and part's end) and once without; prints each stepped run's step and
    part lines and each run's wall time with the launches of every kernel
    that launched (K2 by operation), each line tagged with the directory of
    the checkout whose package ran.  It uses only what every
    version of the port has (execute, the step log, cuda_lib's launch
    counts)."""
    import os

    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.ops import cuda_lib

    tag = os.path.basename(os.path.dirname(os.path.dirname(
        os.path.abspath(distaff_torch.__file__))))
    inputs, options = ProgramInputs.from_public([1, 0]), ProofOptions()

    def prove(program, stepped):
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        _, _, seconds, lines = timed_execute(program, inputs, options, stepped)
        return seconds, lines, json.dumps({k: v for k, v in cuda_lib.LAUNCHES.items() if v})

    for log2_n in sizes:
        program = fibonacci_program(assembly, log2_n)
        prove(program, False)
        for run in range(runs):
            seconds, lines, k2 = prove(program, True)
            for line in lines:
                print(f"[{tag}] 2^{log2_n} run {run}: {line}", flush=True)
            print(f"[{tag}] 2^{log2_n} run {run}: execute, stepped {seconds:.3f} s; launches "
                  f"{k2}", flush=True)
        seconds, _, k2 = prove(program, False)
        print(f"[{tag}] 2^{log2_n}: execute, unstepped {seconds:.3f} s; launches {k2}",
              flush=True)


def kernel_times():
    """K9 at every layer of the 2^16 proof and at the first layer of the
    2^18 and 2^20 proofs (random columns and special_x), with the next
    layer's leaf digests, and alone; and K11 at the 2^16, 2^18 and 2^20
    proofs' step 4 ((3, 8n) random coefficients, degree n): each timed as
    phase 2 times it and printed with the directory of the checkout whose
    package ran.  It uses only what every version of the port has: where
    fri_fold takes no `digests`, the digests are K3's launch over the
    folded layer's rows after it, as the proof ran them."""
    import inspect
    import os
    import random

    import distaff_torch
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import blake3_torch as b3
    from distaff_torch.ops import fri_torch
    from distaff_torch.ops import syndiv_kernels as sk
    from distaff_torch.tools.timing import random_elements

    tag = os.path.basename(os.path.dirname(os.path.dirname(
        os.path.abspath(distaff_torch.__file__))))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    rng = random.Random(SEED + 5)
    fused = "digests" in inspect.signature(fri_torch.fri_fold).parameters

    def with_leaves(column, special_x, root, stride):
        if fused:
            return fri_torch.fri_fold(column, special_x, root, stride, digests=True)
        out = fri_torch.fri_fold(column, special_x, root, stride)
        return out, b3.hash_rows(fri_torch.transpose_quartic(out, 1))

    layers = [(16, 1 << 21 >> 2 * k, 4 ** k) for k in range(7)]
    layers += [(18, 1 << 23, 1), (20, 1 << 25, 1)]
    for log2_trace, length, stride in layers:
        root = hostfield.get_root_of_unity(1 << (log2_trace + 5))
        column = random_elements(gen, (length,))
        special_x = rng.randrange(hostfield.M)
        both = time_ms(lambda: with_leaves(column, special_x, root, stride), 20, KERNEL_TRIALS,
                       queued=True)
        alone = time_ms(lambda: fri_torch.fri_fold(column, special_x, root, stride), 20,
                        KERNEL_TRIALS, queued=True)
        print(f"[{tag}] kernel fri_fold at 2^{log2_trace} layer {fold_key(column, stride)}: "
              f"with the leaf digests {both:.4f} ms ({'one launch' if fused else 'K9 + K3'}), "
              f"fold alone {alone:.4f} ms", flush=True)
        del column
    for log2_trace in (16, 18, 20):
        degree = 1 << log2_trace
        x_last = hostfield.exp(hostfield.get_root_of_unity(degree), degree - 1)
        polys3 = random_elements(gen, (3, 8 * degree))
        ms = time_ms(lambda: sk.syn_div(polys3, degree, x_last), 20, KERNEL_TRIALS, queued=True)
        print(f"[{tag}] kernel syn_div at {syn_div_key(polys3, degree)}: {ms:.4f} ms", flush=True)
        del polys3


def wsum_times():
    """K7 at the calls of the 2^16, 2^18 and 2^20 proofs ((20, 2^21), (20,
    2^23), (20, 2^25)) and of the streamed 2^16, 2^20 and 2^22 proofs ((2,
    2^21), (2, 2^25), (2, 2^27): the weights (1, 0) and (0, 1)), and K15 at
    the streamed proofs' calls ((20, 2^16), (20, 2^18), (20, 2^20), (20,
    2^22)), on random values at the proof's root and x^incr exponent: each
    timed as phase 2 times it, printed with its bytes bound (the same
    whatever implements the kernel) and the directory of the checkout whose
    package ran.  It uses only what every version of the port has."""
    import os
    import random

    import distaff_torch
    from distaff_torch.math import field as hostfield
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import deep_kernels as dk
    from distaff_torch.stark import utils
    from distaff_torch.tools.timing import random_elements

    tag = os.path.basename(os.path.dirname(os.path.dirname(
        os.path.abspath(distaff_torch.__file__))))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    rng = random.Random(SEED + 13)
    scalars = [rng.randrange(hostfield.M) for _ in range(8)]
    for regs, log2_trace in ((20, 16), (20, 18), (20, 20), (2, 16), (2, 20), (2, 22)):
        n = 32 << log2_trace
        root = hostfield.get_root_of_unity(n)
        incr = utils.get_incremental_trace_degree(1 << log2_trace)
        lde, c_lde = random_rows(gen, (regs,), n), random_rows(gen, (), n)
        w1, w2 = (random_elements(gen, (regs,)) for _ in range(2)) if regs > 2 else \
            (ft.from_ints([1, 0], "cuda"), ft.from_ints([0, 1], "cuda"))
        ms = time_ms(lambda: dk.deep_compose(lde, c_lde, w1, w2, root, incr, scalars),
                     5 if n > 1 << 23 else 20, KERNEL_TRIALS, queued=True)
        bound_ms = compose_bytes(regs, n) / HBM_BYTES_PER_S * 1e3
        print(f"[{tag}] kernel deep_compose at ({regs}, {n}) the 2^{log2_trace} proof's call: "
              f"{ms:.4f} ms (bytes bound {bound_ms:.4f} ms)", flush=True)
        del lde, c_lde
    for log2_trace in (16, 18, 20, 22):
        n = 1 << log2_trace
        polys = random_rows(gen, (20,), n)
        w1, w2 = random_elements(gen, (20,)), random_elements(gen, (20,))
        ms = time_ms(lambda: dk.coeff_wsum(polys, w1, w2), 20, KERNEL_TRIALS, queued=True)
        bound_ms = wsum_bytes(20, n) / HBM_BYTES_PER_S * 1e3
        print(f"[{tag}] kernel coeff_wsum at (20, {n}) the streamed 2^{log2_trace} proof's "
              f"call: {ms:.4f} ms (bytes bound {bound_ms:.4f} ms)", flush=True)
        del polys


def inv_times():
    """K6 inv_batch and K2's exp_const at e = M - 2 (the same function) at
    2^INV_TIMES elements, on random values with zeros, each held against
    the other and timed as phase 2 times a kernel, with K6's bytes bound;
    tagged with the directory of the checkout whose package ran.  It uses
    only what every version of the port has."""
    import os

    import distaff_torch
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import field_kernels as fk
    from distaff_torch.tools.timing import random_elements

    tag = os.path.basename(os.path.dirname(os.path.dirname(
        os.path.abspath(distaff_torch.__file__))))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    for log_n in INV_TIMES:
        n = 1 << log_n
        a = random_elements(gen, (n,))
        a[::1000] = ft.zeros((), "cuda")
        check_equal("inv_batch", f"{n}", lambda: fk.inv_batch(a), lambda: fk.exp_const(a, fk.M - 2))
        inv_ms = time_ms(lambda: fk.inv_batch(a), 50, KERNEL_TRIALS, queued=True)
        exp_ms = time_ms(lambda: fk.exp_const(a, fk.M - 2), 5, KERNEL_TRIALS, queued=True)
        print(f"[{tag}] 2^{log_n} elements: inv_batch {inv_ms:.4f} ms (bytes bound "
              f"{2 * n * 16 / HBM_BYTES_PER_S * 1e3:.4f} ms), exp_const at M - 2 {exp_ms:.4f} ms",
              flush=True)
        del a


def tree_times():
    """The times of K13 at every tree the 2^16 proof builds (tree_sizes) and
    at TREE_TIMES_LARGE leaves, on random leaf digests, each tree held
    against its plain version and timed as phase 2 times a kernel, with its
    launches, bound and loss (ms - bound); then K12 over the tables of a
    first 2^16 proof (proof_tables), all its calls timed as one; then the
    other kernels on blake3.cuh's compression: K3 over 2^21 rows of 320
    bytes, K9 at the 2^16 proof's first layer (2^19 rows, with the leaf
    digests), K14 at a middle block of (4, 2^21) and (4, 2^25) points,
    and K8 at the 2^16 proof's two calls ((20, 2^16) at two points, (1,
    2^19) at one; random coefficients and points).
    Each line is tagged with the directory of the checkout whose package
    ran; it uses only what the port has had since K13 and field_kernels'
    MUL_OPS (K9's and K12's bounds), so that a copy of this file times an
    older checkout's kernels."""
    import os
    import random

    import distaff_torch
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import blake3_torch as b3
    from distaff_torch.ops import cuda_lib, fri_torch
    from distaff_torch.ops import field_kernels as fk
    from distaff_torch.tools.timing import random_elements

    tag = os.path.basename(os.path.dirname(os.path.dirname(
        os.path.abspath(distaff_torch.__file__))))
    ops_rate = int32_ops_per_s()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)

    def timed(what, fn, bound_terms, reps=20):
        fn()                                    # builds the tables that fn reads
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        fn()
        launches = sum(cuda_lib.LAUNCHES.values())
        ms = time_ms(fn, reps, KERNEL_TRIALS, queued=True)
        bound_ms, bound_by = bound(*bound_terms, ops_rate)
        print(f"[{tag}] {what}: {ms:.4f} ms in {launches} launch(es), bound {bound_ms:.4f} ms "
              f"by {bound_by}, lost {ms - bound_ms:.4f} ms", flush=True)
        return ms, ms - bound_ms

    all_ms = all_lost = 0.0
    proof_trees = tree_sizes(MAIN_LOG2_TRACE)
    for n in proof_trees + [n for n in TREE_TIMES_LARGE if n not in proof_trees]:
        leaves = random_elements(gen, (n, 2)).view(n, 8)
        check_equal("merkle_tree", f"{n} leaves", lambda: b3.merkle_tree(leaves),
                    lambda: b3.merkle_tree_plain(leaves))
        ms, lost = timed(f"tree of {n} leaves", lambda: b3.merkle_tree(leaves), tree_bound(n),
                         20 if n < 1 << 23 else 5)
        if n in proof_trees:
            all_ms += ms
            all_lost += lost
        del leaves
    print(f"[{tag}] the 2^{MAIN_LOG2_TRACE} proof's {len(proof_trees)} trees: "
          f"{all_ms:.4f} ms, lost {all_lost:.4f} ms", flush=True)

    calls = proof_tables(MAIN_LOG2_TRACE)
    specs = [spec for call in calls for spec in call]
    many = getattr(fk, "power_series_many", None)

    def tables():
        for call in calls:
            many(call, "cuda") if many else fk.power_series(*call[0][:2], "cuda", call[0][2])
    timed(f"the first 2^{MAIN_LOG2_TRACE} proof's {tables_key(specs)} (K12)", tables,
          series_bound(specs))

    rows = random_elements(gen, (1 << 21, 20))
    timed("K3 over 2^21 rows of 320 B", lambda: b3.hash_rows(rows),
          ((1 << 21) * (320 + 32), (1 << 21) * 5 * COMPRESS_OPS))
    column = random_elements(gen, (1 << 21,))
    special_x = random.Random(SEED).randrange(hostfield.M)
    root = hostfield.get_root_of_unity(1 << 21)
    timed("K9 at 2^19 rows with the leaf digests",
          lambda: fri_torch.fri_fold(column, special_x, root, 1, digests=True),
          fold_bound(1 << 19, 1 << 21))
    del rows, column
    for d in (1 << 21, 1 << 25):
        # phase 8's middle block: into rows 16-19 of the (20, D / 4) slice
        group = random_elements(gen, (4, d))
        cv = random_elements(gen, (d, 2)).view(d, 8)
        ev = torch.empty((20, d >> 2, 4), dtype=torch.uint32, device="cuda")
        timed(f"K14 at a middle block of (4, 2^{d.bit_length() - 1}), slice stride 4",
              lambda: b3.trace_absorb(group, cv, 1, 320, None, ev[16:], 2),
              absorb_bound(d, 4, 2), 20 if d < 1 << 23 else 5)
        del group, cv, ev
    from distaff_torch.ops import deep_kernels as dk

    rng = random.Random(SEED + 6)
    for regs, length, count in ((20, 1 << MAIN_LOG2_TRACE, 2), (1, 8 << MAIN_LOG2_TRACE, 1)):
        polys = random_elements(gen, (regs, length))
        points = [rng.randrange(hostfield.M) for _ in range(count)]
        timed(f"K8 at ({regs}, {length}) x {count} point(s)",
              lambda: dk.poly_eval(polys, points),
              (regs * length * 16, regs * length * count * (fk.MUL_OPS + ADD_OPS)))
        del polys


def print_step4(log2_trace, lines):
    """Step 4 (the iNTT and K11) and step 3's K4 part from a stepped
    proof's log lines."""
    print(f"2^{log2_trace} step 4 (iNTT, K11): {step_ms(lines, 'step 4 constraint polynomial')}"
          f" ms; step 3's K4 part (tables and launch): "
          f"{step_ms(lines, 'step 3 part transition (K4 tables and launch)')} ms", flush=True)


def step_ms(lines, name):
    """The time of one logged step, in ms."""
    for line in lines:
        if line.startswith(name + ":"):
            return float(line.split(":")[1].split()[0])
    raise AssertionError(f"no log line for {name}")


class EvalRecorder:
    """Within its `with`, records each K8 call of the prover
    (deep_kernels.poly_eval): its shape and the launches it made."""

    def __enter__(self):
        from distaff_torch.ops import cuda_lib
        from distaff_torch.ops import deep_kernels as dk

        self.dk, self.cuda_lib, self.real = dk, cuda_lib, dk.poly_eval
        self.calls, self.launches = [], Counter()
        dk.poly_eval = self.record
        return self

    def record(self, polys, points):
        before = self.cuda_lib.LAUNCHES["poly_eval"]
        out = self.real(polys, points)
        key = eval_key(polys, points)
        self.calls.append((key, self.dk.poly_eval_launches(len(points))))
        self.launches[key] += self.cuda_lib.LAUNCHES["poly_eval"] - before
        return out

    def __exit__(self, *exc):
        self.dk.poly_eval = self.real


def phase_main(checked_keys):
    """The 2^16 proof three times: as a user runs it (no step logging, so
    no synchronize between steps), with the launch counts, K1's passes, K8's
    calls and peak memory read around it; with DEBUG step logging for the
    per-step times; and unstepped again, so that the cost of the step
    synchronizes shows beside the drift from one proof to the next.  K1's
    passes must be exactly the ("ntt_pass", rung, key)s of `checked_keys`,
    those phase 2 held and timed, and none a two-point transform; K8's calls
    exactly its ("poly_eval", rung, key)s, each one launch (up to four
    points); K9's, K10's and K11's calls exactly their ("fri_fold", ...),
    ("boundary_columns", ...) and ("syn_div", ...) keys, each one launch;
    with the table cache emptied first, K12 once (every table the proof
    builds, the launch phase 2 held), and K12 never in the two proofs that
    follow with the tables cached; K13's trees exactly its ("merkle_tree",
    ...) keys, one launch each; K2 never.  Returns the launches and a
    Counter of launches by (kernel, rung, key)."""
    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.ops import cuda_lib, tiles
    from distaff_torch.stark import serde

    program = fibonacci_program(assembly, MAIN_LOG2_TRACE)
    inputs = ProgramInputs.from_public([1, 0])
    options = ProofOptions()
    tiles._TABLES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    with PassRecorder() as rec, EvalRecorder() as evals, ProofCalls(keep=False) as calls:
        outputs, proof, prove_s, _ = timed_execute(program, inputs, options, stepped=False)
    launches = dict(cuda_lib.LAUNCHES)
    proof_keys = rec.keys()
    peak = torch.cuda.max_memory_allocated()
    MATERIALIZED[MAIN_LOG2_TRACE] = (hashlib.sha256(serde.serialize(proof)).hexdigest(), peak)

    if proof.trace_length() != 1 << MAIN_LOG2_TRACE:
        raise AssertionError(f"trace length {proof.trace_length()}")
    t1 = time.perf_counter()
    if not distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof):
        raise AssertionError("2^16 proof does not verify")
    verify_s = time.perf_counter() - t1
    print(f"2^{MAIN_LOG2_TRACE} proof: execute {prove_s:.3f} s, verify {verify_s:.3f} s, "
          f"output {outputs}, peak device memory {peak} bytes", flush=True)
    print(f"2^{MAIN_LOG2_TRACE} launches: {json.dumps(launches)}", flush=True)
    idle = [k for k in MAIN_PATH if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    pass_keys = [key for kernel, _, key in checked_keys if kernel == "ntt_pass"]
    eval_keys = [key for kernel, _, key in checked_keys if kernel == "poly_eval"]
    held = {name: [key for kernel, rung, key in checked_keys
                   if kernel == name and rung == MAIN_LOG2_TRACE]
            for name in ProofCalls.KEYED}
    for name, want in (("air_transition", 1), ("deep_compose", 1), ("inv_batch", 0),
                       ("boundary_columns", 1), ("syn_div", 1), ("power_series", 1),
                       ("fri_fold", len(held["fri_fold"])), ("ntt_pass", len(pass_keys)),
                       ("blake3_rows", K3_ROW_LAUNCHES),
                       ("poly_eval", sum(n for _, n in evals.calls)),
                       ("merkle_tree", len(held["merkle_tree"])),
                       ("trace_absorb", 0), ("coeff_wsum", 0), *((k, 0) for k in K2_OPS)):
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times, not {want}")
    for name in ProofCalls.KEYED:
        for key in calls.keys[name]:
            print(f"2^{MAIN_LOG2_TRACE} {name} call {key}", flush=True)
        # each table is built once a proof, so K12's calls compare as a set
        same = (set if name == "power_series" else Counter)
        if same(calls.keys[name]) != same(held[name]):
            raise AssertionError(f"the proof's {name} calls are not those phase 2 checked")
    for key in proof_keys:
        print(f"2^{MAIN_LOG2_TRACE} K1 pass {key}", flush=True)
    if Counter(proof_keys) != Counter(pass_keys):
        raise AssertionError("the proof's K1 passes are not those phase 2 checked")
    small = [args for args in rec.calls if args[2].shape[0] < 2]
    if small:
        raise AssertionError(f"{len(small)} two-point K1 passes in the proof")
    for key, n in evals.calls:
        print(f"2^{MAIN_LOG2_TRACE} K8 call {key}: {n} launch(es)", flush=True)
    if sorted(key for key, _ in evals.calls) != sorted(eval_keys):
        raise AssertionError("the proof's K8 calls are not those phase 2 checked")
    field_ew = {k.split(".")[1]: v for k, v in launches.items() if k.startswith("field_ew.")}
    print(f"2^{MAIN_LOG2_TRACE} K1 launched {launches['ntt_pass']} times, no two-point "
          f"transform; K7 {launches['deep_compose']}, K8 {launches['poly_eval']}, K9 "
          f"{launches['fri_fold']} (one a layer, with the leaf digests), K3 over rows "
          f"{launches['blake3_rows']}, K10 {launches['boundary_columns']}, K11 "
          f"{launches['syn_div']}, K12 {launches['power_series']} (the {len(tiles._TABLES)} "
          f"tables the proof built, in one launch), K13 {launches['merkle_tree']} over "
          f"{len(calls.keys['merkle_tree'])} trees, K6 {launches['inv_batch']}; field_ew by "
          f"operation {json.dumps(field_ew)}", flush=True)

    cuda_lib.reset_launches()
    stepped_outputs, _, stepped_s, lines = timed_execute(program, inputs, options, stepped=True)
    again_outputs, _, again_s, _ = timed_execute(program, inputs, options, stepped=False)
    if stepped_outputs != outputs or again_outputs != outputs:
        raise AssertionError("a repeated 2^16 proof's outputs differ")
    if cuda_lib.LAUNCHES["power_series"] or \
            cuda_lib.LAUNCHES["merkle_tree"] != 2 * launches["merkle_tree"]:
        raise AssertionError(f"the two proofs with the tables cached launched K12 "
                             f"{cuda_lib.LAUNCHES['power_series']} times and K13 "
                             f"{cuda_lib.LAUNCHES['merkle_tree']}")
    print(f"2^{MAIN_LOG2_TRACE} with the tables cached: K12 0 launches, K13 one a tree",
          flush=True)
    for line in lines:
        print(f"2^{MAIN_LOG2_TRACE} {line}", flush=True)
    print_step4(MAIN_LOG2_TRACE, lines)
    print(f"2^{MAIN_LOG2_TRACE} execute: stepped (synchronized at each step's end) "
          f"{stepped_s:.3f} s, then unstepped again {again_s:.3f} s", flush=True)
    keyed = Counter(("ntt_pass", MAIN_LOG2_TRACE, key) for key in proof_keys)
    keyed.update({("poly_eval", MAIN_LOG2_TRACE, key): n for key, n in evals.launches.items()})
    for name in ProofCalls.KEYED:
        for key in calls.keys[name]:
            keyed[(name, MAIN_LOG2_TRACE, key)] += 1
    return launches, keyed


def phase_examples(ops_rate):
    """K4 at each example's geometry held against its plain version (a
    row each); then each example at its CLI defaults proved on cuda with
    the default ProofOptions and the table cache emptied, its outputs
    checked against the example's, verified, and a tampered output
    rejected; every kernel of the path must launch, K4, K10 and K11 once,
    K12 once a table built, K2 never, and the K11 call is held against its
    plain version.  Then the CLI once on the card, and the golden case with
    sha3, whose bytes must be the JAX package's.  Returns the rows and a
    Counter of K4's and K10's launches by (kernel, "example", name)."""
    import distaff_torch
    from distaff_torch import assembly, examples, ProgramInputs, ProofOptions
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import cuda_lib, tiles
    from distaff_torch.ops import syndiv_kernels as sk
    from distaff_torch.stark import serde

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    rows = check_air_examples(gen, ops_rate)
    keyed = Counter()
    for name, example in examples.EXAMPLES.items():
        program, inputs, num_outputs, expected = example()
        tiles._TABLES.clear()
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        with ProofCalls() as calls:
            outputs, proof, prove_s, _ = timed_execute(program, inputs, ProofOptions(),
                                                       stepped=False, num_outputs=num_outputs)
        launches = dict(cuda_lib.LAUNCHES)
        EXAMPLE_PROOFS[name] = hashlib.sha256(serde.serialize(proof)).hexdigest()
        public = inputs.get_public_inputs()
        if outputs != expected:
            raise AssertionError(f"example {name}: outputs {outputs}, expected {expected}")
        if not distaff_torch.verify(program.hash, public, outputs, proof):
            raise AssertionError(f"example {name}: the proof does not verify")
        tampered = [(outputs[0] + 1) % hostfield.M] + outputs[1:]
        try:
            distaff_torch.verify(program.hash, public, tampered, proof)
        except ValueError:
            pass
        else:
            raise AssertionError(f"example {name}: a tampered output verifies")
        idle = [k for k in MAIN_PATH if launches[k] == 0]
        if idle or launches["air_transition"] != 1 or launches["boundary_columns"] != 1 or \
                launches["syn_div"] != 1 or launches["power_series"] != 1 or \
                launches["merkle_tree"] != len(calls.trees) or \
                launches["blake3_rows"] != K3_ROW_LAUNCHES or any(launches[k] for k in K2_OPS):
            raise AssertionError(f"example {name}: kernels not launched {idle}, launches "
                                 f"{json.dumps(launches)}, {len(tiles._TABLES)} tables built")
        (polys3, degree, x_last), = calls.syn_divs
        check_equal("syn_div", f"example {name} {syn_div_key(polys3, degree)}",
                    lambda: sk.syn_div(polys3, degree, x_last),
                    lambda: sk.syn_div_plain(polys3, degree, x_last))
        trees = len(calls.trees)
        del calls, polys3
        info = proof.trace_info
        keyed[("air_transition", "example", name)] += launches["air_transition"]
        keyed[("boundary_columns", "example", name)] += launches["boundary_columns"]
        print(f"example {name}: trace length {proof.trace_length()}, depths "
              f"({info.ctx_depth}, {info.loop_depth}, {info.stack_depth}), execute "
              f"{prove_s:.3f} s, K4 launches {launches['air_transition']}, K9 "
              f"{launches['fri_fold']}, K10 {launches['boundary_columns']}, K11 "
              f"{launches['syn_div']} (held), K12 {launches['power_series']}, K13 "
              f"{launches['merkle_tree']} over {trees} trees, outputs {outputs} "
              f"as expected, verified, a tampered output rejected", flush=True)

    cli = subprocess.run([sys.executable, "-m", "distaff_torch", "fibonacci"],
                         capture_output=True, text=True, timeout=300)
    for line in cli.stdout.splitlines():
        print(f"cli: {line}", flush=True)
    if cli.returncode != 0:
        raise AssertionError(f"python -m distaff_torch fibonacci exited {cli.returncode}:\n"
                             f"{cli.stderr[-2000:]}")
    print("cli: python -m distaff_torch fibonacci exited 0 on the card", flush=True)

    program = assembly.compile("begin push.3 push.5 add end")
    inputs = ProgramInputs.none()
    outputs, proof = distaff_torch.execute(
        program, inputs, 1, ProofOptions(16, 10, 2, "sha3"), device="cuda")
    body = serde.serialize_body(proof)
    digest = hashlib.sha256(body).hexdigest()
    if len(body) != SHA3_BODY_LEN or digest != SHA3_BODY_SHA256:
        raise AssertionError(f"sha3 golden proof differs: {len(body)} bytes, sha256 {digest}")
    if not distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof):
        raise AssertionError("sha3 golden proof does not verify")
    print(f"golden proof with sha3 on cuda: {len(body)} bytes before the options, sha256 "
          f"{digest} (the JAX package's), verified", flush=True)
    return rows, keyed


class ProofCalls:
    """Within its `with`, records the calls that the prover makes of K3 (the
    rows it hashes and the launch's counter), K4, K7, K9, K10, K11, K12 and
    K13 (their arguments; K12's a list of tables a call), and lets each
    launch; the keys of K9, K10, K11, K12 and K13 (fold_key, boundary_key,
    syn_div_key, tables_key, the tree's leaves) by name.  Without `keep`,
    it records the keys alone and keeps no tensor alive."""

    KEYED = ("fri_fold", "boundary_columns", "syn_div", "power_series", "merkle_tree")

    def __init__(self, keep=True):
        self.keep = keep
        self.keys = {name: [] for name in self.KEYED}
        self.hashes, self.airs, self.composes, self.folds, self.boundaries = [], [], [], [], []
        self.syn_divs, self.series, self.trees = [], [], []

    def __enter__(self):
        from distaff_torch.crypto import merkle_dev
        from distaff_torch.ops import air_kernels, blake3_torch, boundary_kernels, deep_kernels
        from distaff_torch.ops import field_kernels as fk
        from distaff_torch.ops import fri_torch
        from distaff_torch.ops import syndiv_kernels

        self.patches = [(blake3_torch, "_launch", self.hash),
                        (merkle_dev, "merkle_tree", self.tree),
                        (air_kernels, "air_transition", self.air),
                        (deep_kernels, "deep_compose", self.compose),
                        (fri_torch, "fri_fold", self.fold),
                        (boundary_kernels, "boundary_columns", self.boundary),
                        (syndiv_kernels, "syn_div", self.syn_div)]
        if hasattr(fk, "power_series_many"):
            self.patches.append((fk, "power_series_many", self.tables))
        else:                    # a version of the port whose K12 builds a table a launch
            self.patches.append((fk, "power_series", self.table))
        self.real = {}
        for module, name, fn in self.patches:
            self.real[name] = getattr(module, name)
            setattr(module, name, fn)
        return self

    def record(self, calls, name, args):
        if self.keep:
            calls.append(args)
        return self.real[name](*args)

    def hash(self, rows, out, counter):
        if self.keep:
            self.hashes.append((rows, counter))
        return self.real["_launch"](rows, out, counter)

    def air(self, lde, tables, *shard):
        # (first, halo) of a slot's share; the calls recorded are whole domains
        if shard[1:2] not in ((), (None,)):
            raise ValueError("ProofCalls records single-device proofs")
        if self.keep:
            self.airs.append((lde, tables))
        return self.real["air_transition"](lde, tables, *shard)

    def compose(self, *args):
        return self.record(self.composes, "deep_compose", args)

    def fold(self, column, special_x, root, stride=1, digests=False):
        self.keys["fri_fold"].append(fold_key(column, stride))
        return self.record(self.folds, "fri_fold", (column, special_x, root, stride, digests))

    def boundary(self, lde, i_parts, f_parts, xb_root):
        self.keys["boundary_columns"].append(boundary_key(lde))
        return self.record(self.boundaries, "boundary_columns", (lde, i_parts, f_parts, xb_root))

    def syn_div(self, polys3, degree, x_last):
        self.keys["syn_div"].append(syn_div_key(polys3, degree))
        return self.record(self.syn_divs, "syn_div", (polys3, degree, x_last))

    def tree(self, leaves):
        self.keys["merkle_tree"].append(leaves.shape[0])
        return self.record(self.trees, "merkle_tree", (leaves,))

    def tables(self, specs, device):
        specs = [(x, n, c) for x, n, c in specs]       # host ints: nothing kept alive
        self.keys["power_series"].append(tables_key(specs))
        self.series.append(specs)
        return self.real["power_series_many"](specs, device)

    def table(self, x, n, device, c=1):
        self.keys["power_series"].append(tables_key([(x, n, c)]))
        self.series.append([(x, n, c)])
        return self.real["power_series"](x, n, device, c)

    def __exit__(self, *exc):
        for module, name, _ in self.patches:
            setattr(module, name, self.real[name])
        self.patches = None          # its bound methods would keep the calls alive in a cycle


def pieces(n, make):
    """[(start, stop, make(start, stop))] over [0, n) in pieces of at most
    2^LAST_PIECE."""
    step = 1 << LAST_PIECE
    return [(a, min(a + step, n), make(a, min(a + step, n))) for a in range(0, n, step)]


def check_pieces(name, shape, got, parts, last):
    """Hold a kernel's output `got` against its plain version computed a
    piece at a time: parts lists (start, stop, plain) with plain() the
    output's rows [start, stop); with `last`, the last piece alone.
    Returns the time of the plain pieces in ms (CUDA events)."""
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    wants = [(a, b, plain()) for a, b, plain in (parts[-1:] if last else parts)]
    end_ev.record()
    torch.cuda.synchronize()
    for a, b, want in wants:
        err = max_abs_err(got[a:b], want)
        if err:
            raise AssertionError(f"{name} at {shape}: rows {a}-{b - 1} differ from the plain "
                                 f"version (max abs err {err})")
    return start_ev.elapsed_time(end_ev)


def hold_pieces(name, shape, kernel, parts, last):
    """check_pieces on kernel()'s output (the first of a tuple).  Returns
    the output and the time of the plain pieces in ms."""
    got = kernel()
    got = got[0] if isinstance(got, tuple) else got
    return got, check_pieces(name, shape, got, parts, last)


def piece_row(name, shape, kernel, parts, last, bound_bytes, bound_ops, ops_rate, source,
              replaces, reps=20, tensor_ops=0):
    """hold_pieces, then the kernel timed: its row of the JSON table
    (plain_ms the one run of the plain pieces), or with `last` a printed
    line and no row."""
    _, plain_ms = hold_pieces(name, shape, kernel, parts, last)
    ms = time_ms(kernel, 3 if last else reps, 3 if last else KERNEL_TRIALS, queued=True)
    bound_ms, bound_by = bound(bound_bytes, bound_ops, ops_rate, tensor_ops)
    held = f"its last {parts[-1][1] - parts[-1][0]} rows" if last else f"{len(parts)} piece(s)"
    print(f"kernel {name} at {shape}: equal to plain over {held}; {ms:.4f} ms (plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by})", flush=True)
    if last:
        return None
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def fold_layers(domain):
    """The FRI layers a proof over an LDE of `domain` points folds
    (stark/fri.reduce: down to at most MAX_REMAINDER_LENGTH points)."""
    from distaff_torch.stark import fri

    layers = 0
    while domain > fri.MAX_REMAINDER_LENGTH:
        domain, layers = domain // 4, layers + 1
    return layers


def check_proof_calls(gen, ops_rate, log2_trace, calls, last):
    """Every call of K3, K4, K7, K9, K10, K11 and K13 that a proof made (a
    ProofCalls), held against the plain versions on the proof's own inputs,
    a piece of 2^LAST_PIECE rows or points at a time (with `last`, the last
    piece of each call alone; K13's trees whole, or with `last` by
    check_tree_top).  Without `last` a row for each class of call (K3: the
    trace rows, the FRI layer rows; K4; K7; K9 and K13 timed at their
    largest layer and tree; K10; K11), keyed by (kernel, rung, class), and
    a Counter of the proof's launches by those keys."""
    from distaff_torch.ops import air_kernels
    from distaff_torch.ops import blake3_torch as b3
    from distaff_torch.ops import boundary_kernels as bk
    from distaff_torch.ops import deep_kernels as dk
    from distaff_torch.ops import fri_torch
    from distaff_torch.ops import syndiv_kernels as sk
    from distaff_torch.stark.constraints.device_eval import transition_plain_rows

    tag = f"2^{log2_trace} proof"
    rows, keyed = [], Counter()

    def add(row, kernel, cls, launches):
        if row is not None:
            row["key"] = (kernel, log2_trace, cls)
            rows.append(row)
            keyed[row["key"]] += launches

    # K3: each call on the proof's rows
    k3 = "distaff_torch/csrc/blake3_rows.cu"
    groups = {}
    for rows_in, counter in calls.hashes:
        cls = "trace rows" if rows_in.shape[1] > 4 else "FRI layer rows"
        groups.setdefault((counter, cls), []).append(rows_in)
    for (counter, cls), group in groups.items():
        group.sort(key=lambda t: -t.shape[0])
        for i, rows_in in enumerate(group):
            count, k = rows_in.shape[0], rows_in.shape[1]
            parts = pieces(count, lambda a, b, r=rows_in: lambda: b3.hash_rows_plain(r[a:b]))
            kernel = lambda r=rows_in: b3._launch(
                r, torch.empty((r.shape[0], 8), dtype=torch.uint32, device=r.device), counter)
            shape = f"{tag} {cls}: {count} rows x {k * 16} B"
            if i:
                hold_pieces(counter, shape, kernel, parts, last)
                continue
            row = piece_row(counter, shape, kernel, parts, last, count * (k * 16 + 32),
                            count * ((k * 16 + 63) // 64) * COMPRESS_OPS, ops_rate, k3,
                            "distaff_tpu/ops/blake3_jax.py:95")
            add(row, counter, cls, len(group))
        print(f"kernel {counter}: {tag}'s {len(group)} calls of {cls} equal to plain", flush=True)

    # K13 on the proof's leaves, the largest tree timed
    trees = sorted(calls.trees, key=lambda args: -args[0].shape[0])
    for i, (leaves,) in enumerate(trees):
        n = leaves.shape[0]
        shape = f"{tag} tree of {n} leaves in one launch, plan {tree_plan(n)}"
        kernel = lambda: b3.merkle_tree(leaves)
        if last:
            plain_ms = check_tree_top(shape, kernel(), leaves)
            if i == 0:
                ms = time_ms(kernel, 3, 3, queued=True)
                bound_ms, bound_by = bound(*tree_bound(n), ops_rate)
                print(f"kernel merkle_tree at {shape}: equal to plain above its first stage's "
                      f"subtrees and in its last; {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
                      f"{bound_ms:.4f} ms by {bound_by})", flush=True)
            continue
        parts = [(0, n, lambda: b3.merkle_tree_plain(leaves))]
        if i:
            hold_pieces("merkle_tree", shape, kernel, parts, False)
            continue
        row = piece_row("merkle_tree", shape, kernel, parts, False, *tree_bound(n), ops_rate,
                        K13, K13_REPLACES)
        add(row, "merkle_tree", "trees", len(trees))
    print(f"kernel merkle_tree: {tag}'s {len(trees)} trees equal to plain "
          f"({'above the first stage and in the last subtree' if last else 'whole'})",
          flush=True)

    # K4 on the proof's LDE slice and tables: no bad step
    for lde, tables in calls.airs:
        r, n = lde.shape[0], lde.shape[1]
        parts = pieces(n, lambda a, b: lambda: transition_plain_rows(lde, tables, a, b))
        kernel = lambda: air_kernels.air_transition(lde, tables)
        if int(kernel()[1]):
            raise AssertionError(f"air_transition at {tag}: bad steps on an honest trace")
        row = piece_row("air_transition", f"{tag} ({r}, {n}) LDE slice, strides "
                        f"{tuple(lde.stride())}", kernel, parts, last, *air_bounds(tables, r, n),
                        ops_rate, "distaff_torch/csrc/air_transition.cu",
                        "distaff_tpu/stark/constraints/device_eval.py:121")
        add(row, "air_transition", "LDE slice", 1)

    # K7 on the proof's LDE, constraint evaluations, weights and scalars
    for lde, c_lde, w1, w2, root, incr, scalars in calls.composes:
        regs, n = lde.shape[0], lde.shape[1]
        parts = pieces(n, lambda a, b: lambda: dk.deep_compose_plain(
            lde[:, a:b], c_lde[a:b], w1, w2, root, incr, scalars, start=a))
        bounds = compose_bound(regs, n)
        row = piece_row(
            "deep_compose", f"{tag} ({regs}, {n})",
            lambda: dk.deep_compose(lde, c_lde, w1, w2, root, incr, scalars), parts, last,
            bounds["bound_bytes"], bounds["bound_ops"], ops_rate,
            "distaff_torch/csrc/deep_compose.cu", "distaff_tpu/stark/prover.py:724",
            tensor_ops=bounds["tensor_ops"])
        add(row, "deep_compose", "LDE", 1)

    # K9 on the proof's layers, the largest timed: the folded column
    # against the plain fold, a piece at a time, then the leaf digests
    # against the plain BLAKE3 of that column's rows; K10 on the proof's slice
    folds = sorted(calls.folds, key=lambda args: -args[0].shape[0])
    for i, (column, special_x, root, stride, digests) in enumerate(folds):
        q = column.shape[0] // 4
        parts = pieces(q, lambda a, b: lambda: fri_torch.fri_fold_plain(
            column, special_x, root, stride, rows=(a, b)))
        kernel = lambda: fri_torch.fri_fold(column, special_x, root, stride, digests=digests)
        shape = f"{tag} layer {fold_key(column, stride)}" + (" with its leaf digests"
                                                             if digests else "")
        if i:
            got, _ = hold_pieces("fri_fold", shape, kernel, parts, last)
        else:
            got = None
            row = piece_row("fri_fold", shape, kernel, parts, last,
                            *fold_bound(q, 4 * q * stride), ops_rate,
                            "distaff_torch/csrc/fri_fold.cu", "distaff_tpu/ops/fri_jax.py:53")
            add(row, "fri_fold", "layers", len(folds))
        if digests:
            folded, leaves = kernel()
            rows_in = fri_torch.transpose_quartic(folded, 1)
            check_pieces("fri_fold", f"{shape}: digests", leaves, pieces(
                q // 4, lambda a, b: lambda: b3.hash_rows_plain(rows_in[a:b])), last)
            del folded, leaves, rows_in
        del got
    print(f"kernel fri_fold: {tag}'s {len(folds)} layers equal to plain, with their leaf "
          f"digests", flush=True)
    for lde, i_parts, f_parts, root in calls.boundaries:
        regs, n = lde.shape[0], lde.shape[1]
        parts = pieces(n, lambda a, b: lambda: torch.stack(bk.boundary_columns_plain(
            lde[:, a:b], i_parts, f_parts, root, start=a), 1))
        row = piece_row(
            "boundary_columns", f"{tag} {boundary_key(lde)} LDE slice",
            lambda: torch.stack(bk.boundary_columns(lde, i_parts, f_parts, root), 1), parts,
            last, ops_rate=ops_rate, source="distaff_torch/csrc/boundary_columns.cu",
            replaces="distaff_tpu/stark/prover.py:385", **boundary_bound(regs, n))
        add(row, "boundary_columns", "LDE slice", 1)

    # K11 on the proof's iNTT output: rows [a, b) of the plain version read
    # the coefficients from a on
    for polys3, degree, x_last in calls.syn_divs:
        n = polys3.shape[1]
        parts = pieces(n, lambda a, b: lambda: sk.syn_div_plain(
            polys3, degree, x_last, start=a)[:b - a])
        row = piece_row(
            "syn_div", f"{tag} step 4 {syn_div_key(polys3, degree)}",
            lambda: sk.syn_div(polys3, degree, x_last), parts, last,
            *syn_div_bound(n, degree), ops_rate, "distaff_torch/csrc/syn_div.cu",
            "distaff_tpu/stark/prover.py:482")
        add(row, "syn_div", "constraint polynomial", 1)
    return rows, keyed


def phase_ladder(ops_rate):
    """K1's recursion at a small leaf; then for each rung of LADDER, the
    bench's Fibonacci program (bench.py sizing, default options): every K1
    pass and K8 call of its proof held against the plain versions (at the
    2^LADDER_HELD rung in full, a row each; at the other rung K1's last
    piece of each pass), the proof made on cuda unstepped and verified,
    with its wall time, step 0, peak device memory, LDE size and K1
    passes (the LDE must take K1's recursion, the passes and K8 calls must
    be exactly those held; the table cache emptied first, K12 once; K13
    once a tree; K2 never), and every
    call it made of K3, K4, K7, K9, K10, K11 and K13 held against the plain
    versions (check_proof_calls).  Then the
    LADDER_HELD rung once more with the step log.  Returns the rows and a
    Counter of launches by (kernel, rung, key)."""
    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.ops import cuda_lib, tiles
    from distaff_torch.stark import serde

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    inputs = ProgramInputs.from_public([1, 0])
    options = ProofOptions()
    rows, keyed = [check_recursion(gen, ops_rate)], Counter()
    for log2_trace in LADDER:
        last = log2_trace != LADDER_HELD
        pass_rows, pass_keys = check_passes(gen, ops_rate, log2_trace, last)
        eval_rows = check_poly_eval(gen, ops_rate, log2_trace)
        rows += pass_rows + eval_rows
        program = fibonacci_program(assembly, log2_trace)
        tiles._TABLES.clear()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        with PassRecorder(keep=False) as rec, EvalRecorder() as evals, ProofCalls() as calls:
            outputs, proof, prove_s, lines = timed_execute(program, inputs, options,
                                                           stepped=False)
        launches = dict(cuda_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        MATERIALIZED[log2_trace] = (hashlib.sha256(serde.serialize(proof)).hexdigest(), peak)
        t1 = time.perf_counter()
        if proof.trace_length() != 1 << log2_trace:
            raise AssertionError(f"trace length {proof.trace_length()}")
        if not distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof):
            raise AssertionError(f"2^{log2_trace} proof does not verify")
        verify_s = time.perf_counter() - t1
        info = proof.trace_info
        regs = 15 + info.ctx_depth + info.loop_depth + info.stack_depth
        domain = proof.trace_length() * options.extension_factor()
        print(f"2^{log2_trace} proof: execute {prove_s:.3f} s (step 0 "
              f"{step_ms(lines, 'step 0 execute program'):.3f} ms), verify {verify_s:.3f} s, "
              f"output {outputs}, peak device memory {peak} bytes, LDE ({regs}, {domain}) = "
              f"{regs * domain * 16} bytes", flush=True)
        print(f"2^{log2_trace} launches: {json.dumps(launches)}", flush=True)
        for key in rec.keys():
            print(f"2^{log2_trace} K1 pass {key}", flush=True)
        idle = [k for k in MAIN_PATH if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels not launched at 2^{log2_trace}: {idle}")
        for name, want in (("air_transition", 1), ("deep_compose", 1), ("inv_batch", 0),
                           ("boundary_columns", 1), ("fri_fold", fold_layers(domain)),
                           ("syn_div", 1), ("power_series", 1),
                           ("blake3_rows", K3_ROW_LAUNCHES), ("trace_absorb", 0),
                           ("coeff_wsum", 0), *((k, 0) for k in K2_OPS)):
            if launches[name] != want:
                raise AssertionError(f"2^{log2_trace}: {name} launched {launches[name]} times")
        recorded = Counter(counter for _, counter in calls.hashes)
        recorded["merkle_tree"] = len(calls.trees)
        for name in ("blake3_rows", "merkle_tree"):
            if recorded[name] != launches[name]:
                raise AssertionError(f"2^{log2_trace}: {recorded[name]} launches of {name} "
                                     f"recorded, {launches[name]} launched")
        if sorted(calls.keys["merkle_tree"], reverse=True) != tree_sizes(log2_trace):
            raise AssertionError(f"2^{log2_trace}: trees of {calls.keys['merkle_tree']} leaves")
        if tiles.ntt_buffers(domain) < 3 or not any(
                kind.startswith("columns zero extended -> columns x lo")
                for kind in rec.kinds()):
            raise AssertionError(f"2^{log2_trace}: the LDE did not take K1's recursion")
        if any(m < 4 for _, _, m in rec.records):
            raise AssertionError(f"2^{log2_trace}: a two-point K1 pass")
        if Counter(rec.keys()) != Counter(pass_keys):
            raise AssertionError(f"2^{log2_trace}: the K1 passes are not those held")
        if sorted(key for key, _ in evals.calls) != sorted(row["key"][2] for row in eval_rows):
            raise AssertionError(f"2^{log2_trace}: the K8 calls are not those held")
        keyed.update(("ntt_pass", log2_trace, key) for key in rec.keys())
        keyed.update({("poly_eval", log2_trace, key): n for key, n in evals.launches.items()})
        print(f"2^{log2_trace} K1: {launches['ntt_pass']} passes of kinds "
              f"{sorted(rec.kinds())}, the LDE through {tiles.ntt_buffers(domain) - 2} level(s) "
              f"of recursion, each held; K8 {launches['poly_eval']} launches, each held; K9 "
              f"{launches['fri_fold']} (one a layer, with the leaf digests), K3 over rows "
              f"{launches['blake3_rows']}, K10 {launches['boundary_columns']}, K11 "
              f"{launches['syn_div']}, K12 {launches['power_series']} ({len(tiles._TABLES)} "
              f"tables built), K13 {launches['merkle_tree']} over {len(calls.trees)} trees, K2 0",
              flush=True)
        del outputs, proof
        call_rows, call_keyed = check_proof_calls(gen, ops_rate, log2_trace, calls, last)
        rows += call_rows
        keyed += call_keyed
        del calls
        torch.cuda.empty_cache()

    program = fibonacci_program(assembly, LADDER_HELD)
    _, _, stepped_s, lines = timed_execute(program, inputs, options, stepped=True)
    for line in lines:
        print(f"2^{LADDER_HELD} {line}", flush=True)
    print_step4(LADDER_HELD, lines)
    print(f"2^{LADDER_HELD} execute, stepped: {stepped_s:.3f} s", flush=True)
    return rows, keyed


def absorb_bound(d, regs, shift, first=False, parent=False):
    """K14's bound for one launch over d rows of `regs` registers: bytes
    (the registers read once, the chaining values read, but on a chunk's
    first block, and written, chunk 0's read for a parent node, the slice's
    points written) and operations (a compression a row, two with the
    parent node)."""
    cv_bytes = 32 * ((1 if first else 2) + (1 if parent else 0))
    return (d * (16 * regs + cv_bytes) + (d >> shift) * 16 * regs,
            d * COMPRESS_OPS * (2 if parent else 1))


def wsum_bytes(regs, n):
    """K15's bytes over (regs, n) coefficients: the coefficients read once,
    the two sums written, the weights."""
    return (regs * n + 2 * n + 2 * regs) * 16


def wsum_bound(regs, n):
    """K15's bound as keywords of check_kernel: its bytes, the digit
    reductions' 32-bit instructions and the int8 product's operations (from
    its code, deep_kernels.coeff_wsum_ops)."""
    from distaff_torch.ops import deep_kernels as dk

    product, reductions = dk.coeff_wsum_ops(regs)
    return {"bound_bytes": wsum_bytes(regs, n), "bound_ops": n * reductions * REDUCE_OPS,
            "tensor_ops": n * product}


def plain_absorb_rows(cols, slice_out, shift):
    """blake3_torch.absorb_rows over the registers `cols` (R, D, 4) with
    K14's plain version in place of the kernel."""
    from distaff_torch.ops import blake3_torch as b3

    real, b3.trace_absorb = b3.trace_absorb, b3.trace_absorb_plain
    try:
        return b3.absorb_rows(lambda lo: cols[lo:lo + 4], cols.shape[0], slice_out, shift)
    finally:
        b3.trace_absorb = real


def random_rows(gen, shape, d):
    """(*shape, d, 4) limbs: a random (*shape, 2^LAST_PIECE) block repeated
    (d / 2^LAST_PIECE times) along the rows, so that a large tensor needs
    no int64 draw of its size and its last piece is random."""
    from distaff_torch.tools.timing import random_elements

    piece = min(d, 1 << LAST_PIECE)
    block = random_elements(gen, (*shape, piece))
    return block.repeat(*([1] * len(shape)), d // piece, 1) if d > piece else block


def check_trace_absorb(gen, ops_rate):
    """K14 on random registers: every block of rows of R = 22 registers (a
    32-byte last block) at 2^LAST_PIECE points and of R = 70 (two chunks,
    and the parent node) at a quarter of that, its digests equal to the
    plain version's and to K3's of the whole rows, its slice to the plain
    version's and to the registers' points; then a middle block (chaining values read and
    written) at the groups of the streamed 2^16, 2^20 and 2^22 proofs ((4,
    2^21), (4, 2^25), (4, 2^27) points, into rows 16-19 of the (20, D / 4)
    slice: at 2^22 both reach past 2^31 words), held over its last
    2^LAST_PIECE rows against the plain version and timed: a row each,
    keyed (trace_absorb, rung, "group")."""
    from distaff_torch.ops import blake3_torch as b3

    shift = 2                                        # ext 32: D_ev is every fourth point
    for regs, d in ((22, 1 << LAST_PIECE), (70, 1 << LAST_PIECE - 2)):
        cols = random_rows(gen, (regs,), d)
        got_slice = torch.empty((regs, d >> shift, 4), dtype=torch.uint32, device="cuda")
        want_slice = torch.empty_like(got_slice)
        got = b3.absorb_rows(lambda lo: cols[lo:lo + 4], regs, got_slice, shift)
        want = plain_absorb_rows(cols, want_slice, shift)
        whole = b3.hash_rows(cols.permute(1, 0, 2))
        torch.cuda.synchronize()
        for what, x, y in (("digests", got, want), ("digests against K3", got, whole),
                           ("slice", got_slice, want_slice),
                           ("slice against the points", got_slice, cols[:, ::1 << shift])):
            if max_abs_err(x, y):
                raise AssertionError(f"trace_absorb at ({regs}, {d}): {what} differ")
        print(f"kernel trace_absorb over the {-(-regs // 4)} blocks of ({regs}, {d}) random "
              f"registers{' (two chunks)' if regs > 64 else ''}: digests equal to plain and to "
              f"K3's of the rows, slice equal", flush=True)
        del cols, got_slice, want_slice, got, want, whole

    rows, piece = [], 1 << LAST_PIECE
    for log2_trace in (*STREAM_RUNGS, STREAM_LOG2_TRACE):
        d = 32 << log2_trace
        a = d - piece
        group = random_rows(gen, (4,), d)
        cv = random_rows(gen, (2,), d).view(d, 8)
        ev = torch.empty((20, d >> shift, 4), dtype=torch.uint32, device="cuda")
        cv_in = cv[a:].clone()
        b3.trace_absorb(group, cv, 1, 320, None, ev[16:], shift)
        want_slice = torch.empty((4, piece >> shift, 4), dtype=torch.uint32, device="cuda")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = b3.trace_absorb_plain(group[:, a:], cv_in, 1, 320, None, want_slice, shift)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        if max_abs_err(cv[a:], want) or max_abs_err(ev[16:, a >> shift:], want_slice):
            raise AssertionError(f"trace_absorb at (4, {d}): the last {piece} rows differ")
        kernel = lambda: b3.trace_absorb(group, cv, 1, 320, None, ev[16:], shift)
        ms = time_ms(kernel, 20 if d <= piece else 3, KERNEL_TRIALS if d <= piece else 3,
                     queued=True)
        bound_ms, bound_by = bound(*absorb_bound(d, 4, shift), ops_rate)
        shape = f"2^{log2_trace} proof's group (4, {d}), a middle block, slice stride 4"
        print(f"kernel trace_absorb at {shape}: equal to plain over its last {piece} rows; "
              f"{ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by})",
              flush=True)
        rows.append({"name": "trace_absorb", "route": "cuda", "source": K14,
                     "replaces": K14_REPLACES, "launches": None, "max_abs_err": 0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "key": ("trace_absorb", log2_trace, "group")})
        del group, cv, ev, cv_in, want, want_slice
    return rows


def check_coeff_wsum(gen, ops_rate):
    """K15 at (20, 2^16), the streamed 2^16 proof's call, whole, and at (20,
    2^22), the 2^22 proof's, held over its last 2^LAST_PIECE coefficients:
    random coefficients and weights, a row each, keyed (coeff_wsum, rung,
    "sums"); then at (2, 2^16) with the weights (1, 0) and (0, 1), at (128,
    2^14) with every value and weight M - 1 (four register groups, the
    largest digit sums) and at (20, 2^16 - 37) (a ragged last tile)."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import deep_kernels as dk
    from distaff_torch.tools.timing import random_elements

    rows = []
    for log2_trace in (STREAM_RUNGS[0], STREAM_LOG2_TRACE):
        n = 1 << log2_trace
        a = n - min(n, 1 << LAST_PIECE)
        polys = random_rows(gen, (20,), n)
        w1, w2 = random_elements(gen, (20,)), random_elements(gen, (20,))
        held = "whole" if a == 0 else f"its last {n - a} coefficients"
        row = check_kernel(
            "coeff_wsum", f"(20, {n}) 2^{log2_trace} proof's call, {held}",
            lambda: dk.coeff_wsum(polys, w1, w2)[:, a:],
            lambda: dk.coeff_wsum_plain(polys[:, a:], w1, w2), 20 if a == 0 else 5, 1,
            ops_rate=ops_rate, source=K15, replaces=K15_REPLACES, **wsum_bound(20, n))
        row["key"] = ("coeff_wsum", log2_trace, "sums")
        rows.append(row)
        del polys
    top = hostfield.M - 1
    unit = (ft.from_ints([1, 0], "cuda"), ft.from_ints([0, 1], "cuda"))
    tops = ft.constant(top, "cuda").expand(128, 4).contiguous()
    cases = (("weights (1, 0) and (0, 1)", random_rows(gen, (2,), 1 << 16), unit),
             ("every value and weight M - 1",
              ft.constant(top, "cuda").expand(128, 1 << 14, 4).contiguous(), (tops, tops)),
             ("a ragged last tile", random_rows(gen, (20,), (1 << 16) - 37),
              (random_elements(gen, (20,)), random_elements(gen, (20,)))))
    for what, polys, (w1, w2) in cases:
        shape = f"({polys.shape[0]}, {polys.shape[1]})"
        check_equal("coeff_wsum", f"{shape} {what}", lambda: dk.coeff_wsum(polys, w1, w2),
                    lambda: dk.coeff_wsum_plain(polys, w1, w2))
        print(f"kernel coeff_wsum at {shape} with {what}: equal to plain", flush=True)
    return rows


class LastPieces:
    """Within its `with`, lets each call of K4, K7, K10, K14 and K15 launch
    and copies to the host the last piece of 2^LAST_PIECE rows or points of
    its inputs and its output (K4 also the cycle of rows after it, where it
    wraps), so that check() holds them against the plain versions after
    the proof, whose tensors are gone by then; the copies leave the
    proof's peak device memory as it was.  Keeps K14's calls' (block, byte
    length, points) and the K1 passes' count."""

    def __enter__(self):
        from distaff_torch.ops import air_kernels, blake3_torch, boundary_kernels, deep_kernels

        self.calls, self.absorbs = [], []
        self.patches = [(blake3_torch, "trace_absorb", self.absorb),
                        (deep_kernels, "coeff_wsum", self.wsum),
                        (deep_kernels, "deep_compose", self.compose),
                        (boundary_kernels, "boundary_columns", self.boundary),
                        (air_kernels, "air_transition", self.air)]
        self.real = {}
        for module, name, fn in self.patches:
            self.real[name] = getattr(module, name)
            setattr(module, name, fn)
        return self

    def __exit__(self, *exc):
        for module, name, _ in self.patches:
            setattr(module, name, self.real[name])
        self.patches = None

    @staticmethod
    def start(n):
        return n - min(n, 1 << LAST_PIECE)

    def absorb(self, group, cv, block, byte_len, chunk0=None, slice_out=None, slice_shift=0):
        d = group.shape[1]
        a = self.start(d)
        self.absorbs.append((block, byte_len, d))
        inputs = (group[:, a:].cpu(), cv[a:].cpu(), None if chunk0 is None else chunk0[a:].cpu())
        out = self.real["trace_absorb"](group, cv, block, byte_len, chunk0, slice_out,
                                        slice_shift)
        self.calls.append(("trace_absorb", f"block {block} of ({group.shape[0]}, {d})", a,
                           inputs + (block, byte_len, slice_shift),
                           (cv[a:].cpu(), slice_out[:, a >> slice_shift:].cpu())))
        return out

    def wsum(self, polys, w1, w2):
        out = self.real["coeff_wsum"](polys, w1, w2)
        a = self.start(polys.shape[1])
        self.calls.append(("coeff_wsum", f"{tuple(polys.shape[:2])}", a,
                           (polys[:, a:].cpu(), w1.cpu(), w2.cpu()), out[:, a:].cpu()))
        return out

    def compose(self, lde, c_lde, w1, w2, root, incr, scalars):
        out = self.real["deep_compose"](lde, c_lde, w1, w2, root, incr, scalars)
        a = self.start(lde.shape[1])
        self.calls.append(("deep_compose", f"{tuple(lde.shape[:2])}", a,
                           (lde[:, a:].cpu(), c_lde[a:].cpu(), w1.cpu(), w2.cpu(), root, incr,
                            scalars), out[a:].cpu()))
        return out

    def boundary(self, lde, i_parts, f_parts, xb_root):
        out = self.real["boundary_columns"](lde, i_parts, f_parts, xb_root)
        a = self.start(lde.shape[1])
        self.calls.append(("boundary_columns", boundary_key(lde), a,
                           (lde[:, a:].cpu(), i_parts, f_parts, xb_root),
                           torch.stack(out)[:, a:].cpu()))
        return out

    def air(self, lde, tables, *shard):
        # (first, halo) of a slot's share; the calls recorded are whole domains
        if shard[1:2] not in ((), (None,)):
            raise ValueError("LastPieces records single-device proofs")
        out = self.real["air_transition"](lde, tables, *shard)
        n, cycle = lde.shape[1], tables.dec_ark.shape[1]
        a = self.start(n)
        self.calls.append(("air_transition", boundary_key(lde), a,
                           (torch.cat([lde[:, a:], lde[:, :cycle]], 1).cpu(), tables, n),
                           out[0][a:].cpu()))
        return out

    def check(self, tag):
        """Each recorded call's last piece against its plain version on the
        card; prints a line a kernel."""
        from distaff_torch.ops import blake3_torch as b3
        from distaff_torch.ops import boundary_kernels as bk
        from distaff_torch.ops import deep_kernels as dk
        from distaff_torch.stark.constraints.device_eval import transition_plain

        held = Counter()
        for name, shape, a, inputs, got in self.calls:
            cuda = [x.cuda() if torch.is_tensor(x) else x for x in inputs]
            if name == "trace_absorb":
                group, cv, chunk0, block, byte_len, shift = cuda
                sliced = torch.empty((group.shape[0], group.shape[1] >> shift, 4),
                                     dtype=torch.uint32, device="cuda")
                want = (b3.trace_absorb_plain(group, cv, block, byte_len, chunk0, sliced, shift),
                        sliced)
            elif name == "coeff_wsum":
                want = dk.coeff_wsum_plain(*cuda)
            elif name == "deep_compose":
                want = dk.deep_compose_plain(*cuda, start=a)
            elif name == "boundary_columns":
                want = torch.stack(bk.boundary_columns_plain(*cuda, start=a))
            else:
                window, tables, n = cuda
                rows = torch.arange(a, n + tables.dec_ark.shape[1], device="cuda") % n
                want = transition_plain(window, tables, rows)[0][:n - a]
            got = tuple(x.cuda() for x in got) if isinstance(got, tuple) else got.cuda()
            err = max_abs_err(got, want)
            torch.cuda.synchronize()
            if err:
                raise AssertionError(f"{name} at {tag} {shape}: its last piece from row {a} "
                                     f"differs from the plain version (max abs err {err})")
            held[name] += 1
        print(f"{tag}: the last piece of each call equal to plain: "
              f"{', '.join(f'{k} {v}' for k, v in sorted(held.items()))}", flush=True)
        return held


def phase_stream(ops_rate):
    """K14 and K15 against their plain versions (check_trace_absorb,
    check_coeff_wsum); then the bench's Fibonacci proof (bench.py sizing,
    default options) streamed: at each rung of STREAM_RUNGS forced
    (DISTAFF_STREAM_LDE=1), its bytes equal to the materialized proof's of
    phase 4 or 7 and its peak device memory below that proof's; at
    2^STREAM_LOG2_TRACE in auto mode, where the LDE does not fit the card
    and the proof must stream.  Each proof on cuda unstepped, with the
    table cache emptied first: verified, a tampered output rejected; its
    time, step 0, peak memory and launches printed; K14 once a block of a
    row (ceil(R / 4)), K15 once, K3 over rows once (the first FRI layer),
    K4, K7, K10, K11 and K12 once, K9 once a layer, K13 once a tree, K2
    and K6 never; the last piece of
    each call of K4, K7, K10, K14 and K15 held against the plain versions
    (LastPieces).  Returns the rows and a Counter of launches by (kernel,
    rung, key)."""
    import os

    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import blake3_torch as b3
    from distaff_torch.ops import cuda_lib, tiles
    from distaff_torch.stark import serde

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    rows = check_trace_absorb(gen, ops_rate) + check_coeff_wsum(gen, ops_rate)
    torch.cuda.empty_cache()
    keyed = Counter()
    inputs = ProgramInputs.from_public([1, 0])
    options = ProofOptions()
    saved = os.environ.get("DISTAFF_STREAM_LDE")
    for log2_trace in (*STREAM_RUNGS, STREAM_LOG2_TRACE):
        forced = log2_trace in STREAM_RUNGS
        tag = f"2^{log2_trace} streamed proof ({'forced' if forced else 'auto'})"
        program = fibonacci_program(assembly, log2_trace)
        tiles._TABLES.clear()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        os.environ["DISTAFF_STREAM_LDE"] = "1" if forced else "auto"
        try:
            with LastPieces() as pieces:
                outputs, proof, prove_s, lines = timed_execute(program, inputs, options,
                                                               stepped=False)
        finally:
            if saved is None:
                os.environ.pop("DISTAFF_STREAM_LDE")
            else:
                os.environ["DISTAFF_STREAM_LDE"] = saved
        launches = dict(cuda_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        data = serde.serialize(proof)
        digest = hashlib.sha256(data).hexdigest()
        public = inputs.get_public_inputs()
        t1 = time.perf_counter()
        if not distaff_torch.verify(program.hash, public, outputs, proof):
            raise AssertionError(f"{tag} does not verify")
        verify_s = time.perf_counter() - t1
        tampered = [(outputs[0] + 1) % hostfield.M] + outputs[1:]
        try:
            distaff_torch.verify(program.hash, public, tampered, proof)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{tag}: a tampered output verifies")
        info = proof.trace_info
        regs = 15 + info.ctx_depth + info.loop_depth + info.stack_depth
        domain = proof.trace_length() * options.extension_factor()
        del proof
        print(f"{tag}: execute {prove_s:.3f} s (step 0 "
              f"{step_ms(lines, 'step 0 execute program'):.3f} ms), verify {verify_s:.3f} s, "
              f"output {outputs}, a tampered output rejected, peak device memory {peak} bytes, "
              f"{len(data)} bytes sha256 {digest}; the LDE ({regs}, {domain}) would be "
              f"{regs * domain * 16} bytes", flush=True)
        print(f"2^{log2_trace} streamed launches: {json.dumps(launches)}", flush=True)
        idle = [k for k in STREAM_PATH if launches[k] == 0]
        if idle:
            raise AssertionError(f"{tag}: kernels not launched: {idle}")
        trees = len(tree_sizes(log2_trace))
        for name, want in (("trace_absorb", -(-regs // b3.BLOCK_REGISTERS)), ("coeff_wsum", 1),
                           ("blake3_rows", 1), ("air_transition", 1), ("deep_compose", 1),
                           ("boundary_columns", 1), ("syn_div", 1), ("inv_batch", 0),
                           ("fri_fold", fold_layers(domain)), ("merkle_tree", trees),
                           ("power_series", 1),
                           *((k, 0) for k in K2_OPS)):
            if launches[name] != want:
                raise AssertionError(f"{tag}: {name} launched {launches[name]} times, not {want}")
        if [(block, d) for block, _, d in pieces.absorbs] != [
                (block, domain) for block in range(-(-regs // b3.BLOCK_REGISTERS))]:
            raise AssertionError(f"{tag}: K14's calls {pieces.absorbs}")
        if forced:
            want_digest, want_peak = MATERIALIZED[log2_trace]
            if digest != want_digest:
                raise AssertionError(f"{tag}: its bytes differ from the materialized proof's")
            if peak >= want_peak:
                raise AssertionError(f"{tag}: peak device memory {peak} bytes, the materialized "
                                     f"proof's {want_peak}")
            print(f"{tag}: the materialized proof's bytes; peak device memory {peak} bytes "
                  f"against its {want_peak}", flush=True)
        print(f"{tag}: K14 {launches['trace_absorb']} (a block of each row), K15 "
              f"{launches['coeff_wsum']}, K3 over rows {launches['blake3_rows']} (the first "
              f"FRI layer), K13 {launches['merkle_tree']}, K8 {launches['poly_eval']}, K2 0",
              flush=True)
        pieces.check(tag)
        del pieces
        keyed[("trace_absorb", log2_trace, "group")] += launches["trace_absorb"]
        keyed[("coeff_wsum", log2_trace, "sums")] += launches["coeff_wsum"]
    return rows, keyed


def mesh_env(devices, stream=False):
    """The environment of a proof on a mesh of these slots (parallel/
    mesh.py), streamed where `stream`; returns the values to restore."""
    import os

    saved = {k: os.environ.get(k) for k in ("DISTAFF_MESH_DEVICES", "DISTAFF_STREAM_LDE")}
    os.environ["DISTAFF_MESH_DEVICES"] = ",".join(devices)
    if stream:
        os.environ["DISTAFF_STREAM_LDE"] = "1"
    return saved


def restore_env(saved):
    import os

    for key, value in saved.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def mesh_launches(domain, slots, streamed, regs):
    """The launches a proof over an LDE domain of `domain` points on `slots`
    slots of the card makes of the
    kernels that the mesh splits, from its geometry (parallel/
    mesh_stages.py): K4, K10 and K7 once a slot; K11 once, on the home
    slot; K9 once a slot on each layer of at least 4 rows a slot, once on
    each smaller one; K13 once a slot on the trace's and the constraints'
    trees and on each split layer's, once on each other layer's; K3 once a
    slot on the trace's rows (but streamed) and each split layer's rows,
    once on the first layer that folds on the home slot (K9's digests hash
    the rest); K12 once a card (the caller sets it); K2 and K6 never."""
    from distaff_torch.stark import fri

    want = {"air_transition": slots, "boundary_columns": slots, "deep_compose": slots,
            "syn_div": 1, "power_series": 1, "inv_batch": 0, **{k: 0 for k in K2_OPS}}
    trees, folds, rows = 2 * slots, 0, 0 if streamed else slots
    q, home = domain // 4, False
    while True:
        split = not home and q >= 4 * slots
        trees += slots if split else 1
        rows += slots if split else (1 if not home else 0)
        home = home or not split
        if 4 * q <= fri.MAX_REMAINDER_LENGTH:
            break
        folds += slots if split else 1
        q //= 4
    want.update(merkle_tree=trees, fri_fold=folds, blake3_rows=rows)
    if streamed:
        want.update(trace_absorb=-(-regs // 4), coeff_wsum=1)
    return want


def check_offsets(gen, ops_rate, slots=MESH_SLOTS):
    """Each kernel that the 2^16 proof launches at a slot's rows on a mesh
    of `slots` slots, at those shapes, held against its plain version at
    the same offset (tolerance zero), a row each, at the last slot (whose
    K4 halo wraps to slot 0's first rows): K1's first pass of the sharded
    constraint LDE (its twiddles at the slot's global columns), K4 with its
    8-row halo (also at slot 1, and both equal to the whole slice's launch
    at those rows), K10 and K7 at their first point, and K9 on the slot's
    rows of the first FRI layer."""
    import random

    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import air_kernels, boundary_kernels as bk, deep_kernels as dk
    from distaff_torch.ops import fri_torch, tiles
    from distaff_torch.parallel import ntt_sharded as ns
    from distaff_torch.stark import utils as stark_utils
    from distaff_torch.stark.constraints.device_eval import air_tables, transition_plain_shard
    from distaff_torch.tools.timing import random_elements

    rows, last = [], slots - 1
    rng = random.Random(SEED + 9)
    domain = 1 << (MAIN_LOG2_TRACE + 5)
    n_ev = domain // 4
    root = hostfield.get_root_of_unity(domain)

    def row(name, shape, kernel, plain, bound_bytes, bound_ops, source, replaces, tensor_ops=0):
        out = check_kernel(name, f"mesh slot {last} of {slots}: {shape}", kernel, plain, 20, 1,
                           bound_bytes, bound_ops, ops_rate, source, replaces, tensor_ops)
        out["key"] = ("mesh", name)
        rows.append(out)

    # K1: step 1 of the constraint LDE split over the slots (the constraint
    # polynomial's 2^19 coefficients zero extended to 2^21 points)
    n1, n2 = ns._split(domain)
    c = n1 // slots
    points = n_ev // n1
    src = random_elements(gen, (1, points, c))
    tw = tiles._stage_twiddles(n2, pow(root, n1, hostfield.M), "cuda")
    lo, hi = tiles._store_factors(domain, root, 1, "cuda")
    args = (src, None, tw, 1, c, (points * c, 1, c), (n2 * c, 1, c), points * c, lo, hi)
    out = torch.zeros((1, n2, c, 4), dtype=torch.uint32, device="cuda")
    want = torch.zeros_like(out)
    row("ntt_pass", f"sharded transform step 1, first column {last * c}: "
        f"{pass_key(*args[:1], out, *args[2:])}",
        lambda: fk.ntt_pass(src, out, *args[2:], first=last * c),
        lambda: fk.ntt_pass_plain(src, want, *args[2:], first=last * c),
        *pass_bound((src, out) + args[2:]), "distaff_torch/csrc/ntt_pass.cu",
        "distaff_tpu/ops/field_pallas.py:252")
    del src, out, want

    # K4 and K10 on the slots' rows of the 2^16 Fibonacci LDE's slice
    trace, evaluator = fibonacci_case()
    whole = trace.lde_dev[:, ::4]
    tables = air_tables(evaluator, "cuda")
    regs, n_ev = whole.shape[0], whole.shape[1]
    share = n_ev // slots
    full, _ = air_kernels.air_transition(whole, tables)
    for s in (last, 1):
        first = s * share
        part = whole[:, first:first + share]
        nxt = (first + share) % n_ev
        halo = whole[:, nxt:nxt + 8].contiguous()
        kernel = lambda: air_kernels.air_transition(part, tables, first, halo)
        plain = lambda: transition_plain_shard(part, tables, first, halo)
        if s == last:
            row("air_transition", f"({regs}, {share}) rows from {first}, halo from {nxt}",
                kernel, plain, *air_bounds(tables, regs, share),
                "distaff_torch/csrc/air_transition.cu",
                "distaff_tpu/stark/constraints/device_eval.py:121")
        else:
            check_equal("air_transition", f"slot {s}", kernel, plain)
        got, bad = kernel()
        if not torch.equal(got, full[first:first + share]) or int(bad) != 0:
            raise AssertionError(f"air_transition at slot {s}: its rows differ from the whole "
                                 f"slice's launch, or {int(bad)} bad steps")
    print(f"kernel air_transition at slots {last} and 1 of {slots} with their halos: equal to "
          f"plain and to the whole slice's launch at their rows, no bad step", flush=True)
    first = last * share
    part = whole[:, first:first + share]
    i_parts, f_parts = evaluator.boundary_weight_vectors(regs)
    xb = hostfield.exp(hostfield.get_root_of_unity(n_ev), evaluator.b_degree_adj)
    row("boundary_columns", f"{boundary_key(part)} rows from {first}",
        lambda: bk.boundary_columns(part, i_parts, f_parts, xb, first, n_ev),
        lambda: bk.boundary_columns_plain(part, i_parts, f_parts, xb, first),
        source="distaff_torch/csrc/boundary_columns.cu",
        replaces="distaff_tpu/stark/prover.py:385", **boundary_bound(regs, share))
    del trace, evaluator, whole, full, part

    # K7 on the slot's points of the LDE domain, random inputs
    share = domain // slots
    first = last * share
    lde = random_elements(gen, (regs, share))
    c_lde = random_elements(gen, (share,))
    w1, w2 = random_elements(gen, (regs,)), random_elements(gen, (regs,))
    incr = stark_utils.get_incremental_trace_degree(1 << MAIN_LOG2_TRACE)
    scalars = [rng.randrange(hostfield.M) for _ in range(8)]
    row("deep_compose", f"({regs}, {share}) points from {first}",
        lambda: dk.deep_compose(lde, c_lde, w1, w2, root, incr, scalars, first, domain),
        lambda: dk.deep_compose_plain(lde, c_lde, w1, w2, root, incr, scalars, first),
        source="distaff_torch/csrc/deep_compose.cu",
        replaces="distaff_tpu/stark/prover.py:643", **compose_bound(regs, share))
    del lde, c_lde

    # K9 on the slot's rows of the first FRI layer (without digests)
    q = domain // 4
    share = q // slots
    first = last * share
    column = random_elements(gen, (4 * share,))
    special_x = rng.randrange(hostfield.M)
    muls, adds, subs = fri_torch.fri_fold_ops(share, domain)
    row("fri_fold", f"{share} rows from {first} of a {q}-row layer",
        lambda: fri_torch.fri_fold(column, special_x, root, 1, first=first, layer_rows=q),
        lambda: fri_torch.fri_fold_plain(column, special_x, root, 1, first=first),
        (5 * share + power_tables(domain)) * 16,
        muls * fk.MUL_OPS + adds * ADD_OPS + subs * SUB_OPS, "distaff_torch/csrc/fri_fold.cu",
        "distaff_tpu/ops/fri_jax.py:53")
    return rows


def phase_mesh(ops_rate):
    """The mesh (distaff_torch/parallel/): the offset launches held
    (check_offsets); parallel.mesh.dryrun_step on 4 slots of the card equal
    to the same step on 4 CPU slots (the plain versions); the configured
    mesh DISTAFF_MESH_DEVICES=2 raising on a machine of one card (else the
    2^16 proof on cuda:0,cuda:1); then each proof of MESH_PROOFS on its
    slots of the card: verified, a tampered output rejected, its bytes
    those of the single-device proof of phase 4, 7 or 8, its time, peak
    device memory, launches and RECORDED_SHARDINGS printed, every stage of
    MESH_STAGES recorded on all its slots and the launches of the split
    kernels those of mesh_launches.  k slots on one card show no scaling.
    Returns the rows and a Counter of launches by ("mesh", kernel) (the 2^16
    proof on 4 slots)."""
    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import cuda_lib, tiles
    from distaff_torch.parallel import mesh as pm, mesh_stages
    from distaff_torch.stark import serde
    from distaff_torch.tools.timing import card_line

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    rows = check_offsets(gen, ops_rate)
    torch.cuda.empty_cache()

    got = pm.dryrun_step(MESH_SLOTS, devices=["cuda:0"] * MESH_SLOTS)
    want = pm.dryrun_step(MESH_SLOTS, devices=["cpu"] * MESH_SLOTS)
    if not torch.equal(got.cpu(), want):
        raise AssertionError("dryrun_step on the card's slots differs from the CPU slots'")
    print(f"mesh: dryrun_step({MESH_SLOTS}) on {MESH_SLOTS} slots of cuda:0 equal to "
          f"{MESH_SLOTS} CPU slots ({tuple(got.shape)})", flush=True)

    cards = torch.cuda.device_count()
    saved = mesh_env(["2"])
    try:
        if cards < 2:
            try:
                pm.configured_mesh("cuda")
            except RuntimeError as e:
                print(f"mesh: DISTAFF_MESH_DEVICES=2 on {cards} card raises: {e}", flush=True)
            else:
                raise AssertionError("DISTAFF_MESH_DEVICES=2 did not raise on one card")
            print("mesh: the multi-card placement was not exercised (one card)", flush=True)
    finally:
        restore_env(saved)
    proofs = list(MESH_PROOFS)
    if cards >= 2:
        proofs.insert(0, (f"2^{MAIN_LOG2_TRACE} on cuda:0,cuda:1", MAIN_LOG2_TRACE,
                          ["cuda:0", "cuda:1"], False))

    keyed = Counter()
    inputs = ProgramInputs.from_public([1, 0])
    options = ProofOptions()
    card = card_line()
    for tag, log2_trace, devices, streamed in proofs:
        program = fibonacci_program(assembly, log2_trace)
        tiles._TABLES.clear()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        mesh_stages.RECORDED_SHARDINGS.clear()
        saved = mesh_env(devices, streamed)
        try:
            outputs, proof, prove_s, _ = timed_execute(program, inputs, options, stepped=False)
        finally:
            restore_env(saved)
        launches = dict(cuda_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        recorded = dict(mesh_stages.RECORDED_SHARDINGS)
        data = serde.serialize(proof)
        digest = hashlib.sha256(data).hexdigest()
        public = inputs.get_public_inputs()
        if not distaff_torch.verify(program.hash, public, outputs, proof):
            raise AssertionError(f"mesh proof {tag} does not verify")
        tampered = [(outputs[0] + 1) % hostfield.M] + outputs[1:]
        try:
            distaff_torch.verify(program.hash, public, tampered, proof)
        except ValueError:
            pass
        else:
            raise AssertionError(f"mesh proof {tag}: a tampered output verifies")
        info = proof.trace_info
        regs = 15 + info.ctx_depth + info.loop_depth + info.stack_depth
        domain = proof.trace_length() * options.extension_factor()
        del proof
        print(f"mesh proof {tag} ({card}; {len(devices)} slots on "
              f"{len(set(devices))} card(s): no scaling measured): {prove_s:.3f} s, peak device "
              f"memory {peak} bytes (single device: {MATERIALIZED[log2_trace][1]}), {len(data)} "
              f"bytes sha256 {digest}", flush=True)
        print(f"mesh proof {tag} RECORDED_SHARDINGS: "
              f"{json.dumps({k: [a, list(v)] for k, (a, v) in recorded.items()})}", flush=True)
        print(f"mesh proof {tag} launches: {json.dumps(launches)}", flush=True)
        if digest != MATERIALIZED[log2_trace][0]:
            raise AssertionError(f"mesh proof {tag}: its bytes differ from the single-device "
                                 f"proof's")
        stages = MESH_STAGES + (("stream_ntt", "composition_wsum_lde") if streamed else ())
        off = [st for st in stages if st not in recorded or len(recorded[st][1]) != len(devices)]
        if off:
            raise AssertionError(f"mesh proof {tag}: stages not split over its slots: {off}")
        want = mesh_launches(domain, len(devices), streamed, regs)
        want["power_series"] = len(set(devices))
        wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
        if wrong or launches["ntt_pass"] == 0 or launches["poly_eval"] == 0:
            raise AssertionError(f"mesh proof {tag}: launches (made, expected) {wrong}")
        print(f"mesh proof {tag}: verified, a tampered output rejected, the single-device "
              f"bytes, every stage split over its {len(devices)} slots, the split kernels' "
              f"launches as planned", flush=True)
        if (log2_trace, len(devices), streamed) == (16, MESH_SLOTS, False):
            for name in ("ntt_pass", "air_transition", "boundary_columns", "deep_compose",
                         "fri_fold"):
                keyed[("mesh", name)] += launches[name]
    return rows, keyed


def prove_processor_trace(program, inputs, num_outputs, options):
    """Step 0 through the Python VM (processor.execute_u64) and through the
    native VM, timed, their words held equal; then the processor's trace
    proved on cuda through TraceTable and stark.prove with the launches
    counted from 0.  Returns (outputs, proof, Python seconds, native
    seconds, launches)."""
    from distaff_torch import native, processor, stark
    from distaff_torch.ops import cuda_lib, tiles
    from distaff_torch.stark import TraceTable

    t0 = time.perf_counter()
    words, ctx, loop = processor.execute_u64(program, inputs)
    python_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_words, native_ctx, native_loop = native.execute_u64(program, inputs)
    native_s = time.perf_counter() - t0
    if (ctx, loop) != (native_ctx, native_loop) or words.shape != native_words.shape or \
            not (words == native_words).all():
        raise AssertionError(f"the Python VM's trace {words.shape} ({ctx}, {loop}) is not the "
                             f"native VM's {native_words.shape} ({native_ctx}, {native_loop})")
    tiles._TABLES.clear()
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    trace = TraceTable(words, ctx, loop, options.extension_factor())
    outputs = trace.get_last_state().user_stack[:num_outputs]
    proof = stark.prove(trace, inputs.get_public_inputs(), outputs, options, "cuda")
    torch.cuda.synchronize()
    return outputs, proof, python_s, native_s, dict(cuda_lib.LAUNCHES)


def check_leaf256(gen, ops_rate, leaves):
    """K16 over `leaves` random leaves (rows of 0, 1 and M - 1 in front) at
    the 256th root and its inverse, equal to its plain version and to K1
    (tiles.ntt_batched, one pass), one launch a call; the forward transform
    timed as phase 2 times a kernel, K1 beside it.  Returns K16's row."""
    from distaff_torch.math import field as hostfield
    from distaff_torch.math import field_torch as ft
    from distaff_torch.ops import cuda_lib, mxu_ntt, tiles
    from distaff_torch.tools.timing import random_elements

    x = random_elements(gen, (leaves, 256), "cuda")
    for row, v in enumerate((0, 1, ft.M - 1)):
        x[row] = ft.constant(v, "cuda")
    root = hostfield.get_root_of_unity(256)
    shape = f"({leaves}, 256)"
    for r, what in ((root, "forward"), (hostfield.inv(root), "inverse")):
        before = cuda_lib.LAUNCHES["leaf256"]
        got, err = check_equal("leaf256", f"{shape} {what}", lambda: mxu_ntt.leaf_ntt256(x, r),
                               lambda: mxu_ntt.leaf_ntt256_plain(x, r))
        if cuda_lib.LAUNCHES["leaf256"] - before != 1:
            raise AssertionError(f"leaf256 at {shape}: {cuda_lib.LAUNCHES['leaf256'] - before} "
                                 f"launches for one call")
        if not torch.equal(got, tiles.ntt_batched(x, r)):
            raise AssertionError(f"leaf256 at {shape} {what}: K16 and K1 differ")
    bound_bytes, tensor_ops, reductions = mxu_ntt.leaf256_work(leaves)
    row = check_kernel("leaf256", f"{shape} forward", lambda: mxu_ntt.leaf_ntt256(x, root),
                       lambda: mxu_ntt.leaf_ntt256_plain(x, root), 20, 1,
                       bound_bytes + mxu_ntt.kernel_entries(root, "cuda").numel() * 4,
                       reductions * REDUCE_OPS, ops_rate, K16, K16_REPLACES, tensor_ops)
    row["k1_ms"] = time_ms(lambda: tiles.ntt_batched(x, root), 20, KERNEL_TRIALS, queued=True)
    rate = leaves * 128 * 8 / row["ms"] / 1e6
    print(f"leaf256 at {shape}: K16 equal to plain and to K1 (forward and inverse), one launch a "
          f"call; K16 {row['ms']:.4f} ms ({rate:.1f} Gbutterflies/s), K1 {row['k1_ms']:.4f} ms "
          f"({leaves * 128 * 8 / row['k1_ms'] / 1e6:.1f})", flush=True)
    return row


def k16_report(ops_rate):
    """K16's design on the card: no spills in ptxas' report, at least
    K16_MIN_WARPS resident an SM, fewer IMMA a leaf than the dense
    product's K16_DENSE_MMA and no more K bytes than the K16_LIVE_MMA live
    k-steps (no zero k-step issued); prints its IMMA a leaf against
    K16_LIVE_MMA, its opcode mix and its floors at (163840, 256): each
    integer pipe's instructions at 64 lanes a clock an SM (half of
    `ops_rate`'s 128 issue lanes), the IMMA at the mma.sync rates
    (MMA_SYNC_OPS_PER_S) and their operations at the dense int8 rate."""
    from distaff_torch.ops import cuda_lib, mxu_ntt

    for line in cuda_lib.ptxas_report("leaf256"):
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and spill.groups() != ("0", "0"):
            raise AssertionError(f"leaf256 spills: {line.strip()}")
    warps = mxu_ntt.resident_warps()
    if warps < K16_MIN_WARPS:
        raise AssertionError(f"leaf256: {warps} warps resident an SM, fewer than {K16_MIN_WARPS}")
    sass = cuda_lib.sass("leaf256")
    if sass is None:
        print(f"K16: {warps} warps resident an SM; SASS not counted (no cuobjdump)", flush=True)
        return
    mix = cuda_lib.opcode_mix(sass)
    counts = cuda_lib.opcode_counts(sass)
    fma, alu = cuda_lib.pipe_counts(sass)
    imma = {shape: sum(k for op, k in mix.items() if op.startswith("IMMA." + shape))
            * K16_RUNS_PER_LEAF for shape in IMMA_K}
    total = sum(imma.values())
    k_bytes = sum(imma[shape] * IMMA_K[shape] for shape in IMMA_K)
    if total != counts["IMMA"] * K16_RUNS_PER_LEAF:
        raise AssertionError(f"leaf256: IMMA of other shapes than {list(IMMA_K)}: {mix}")
    if not 0 < total < K16_DENSE_MMA or k_bytes > K16_LIVE_MMA * 32:
        raise AssertionError(f"leaf256: {imma['16832']} m16n8k32 and {imma['16816']} m16n8k16 "
                             f"a leaf ({k_bytes} K bytes, the live k-steps' "
                             f"{K16_LIVE_MMA * 32})")
    leaves = LEAF_SHAPES[1]
    pipe_ms = [count * K16_RUNS_PER_LEAF * leaves * 64 / ops_rate * 1e3 for count in (fma, alu)]
    ops = {shape: imma[shape] * 2 * 16 * 8 * IMMA_K[shape] for shape in IMMA_K}
    mma_ms = sum(ops[shape] / MMA_SYNC_OPS_PER_S[shape] for shape in IMMA_K) * leaves * 1e3
    dense_ms = sum(ops.values()) * leaves / INT8_OPS_PER_S * 1e3
    print(f"K16: {warps} warps resident an SM; a leaf {total} IMMA ({imma['16832']} m16n8k32, "
          f"{imma['16816']} m16n8k16), {'over' if total > K16_LIVE_MMA else 'within'} the "
          f"{K16_LIVE_MMA} live k-steps as one m16n8k32 each; {k_bytes} K bytes of their "
          f"{K16_LIVE_MMA * 32}; {counts['PRMT'] * K16_RUNS_PER_LEAF} PRMT, FMA pipe "
          f"{fma * K16_RUNS_PER_LEAF}, integer-only pipe {alu * K16_RUNS_PER_LEAF}; floors at "
          f"({leaves}, 256): FMA pipe {pipe_ms[0]:.4f} ms, integer-only pipe {pipe_ms[1]:.4f} "
          f"ms, IMMA at the mma.sync rates {mma_ms:.4f} ms (their operations at the dense int8 "
          f"rate {dense_ms:.4f} ms)", flush=True)


def phase_processor(ops_rate):
    """The Python VM's traces of the 2^16 bench program and the six examples
    equal to the native VM's, each proved on cuda through TraceTable and
    stark.prove with the bytes of phase 4's or phase 6's proof of the same
    program, verified, every kernel of the main path launched; then K16
    against its plain version and K1 at LEAF_SHAPES (a row each) and a
    ragged batch.  Returns the rows and an empty Counter."""
    import distaff_torch
    from distaff_torch import assembly, examples, ProgramInputs, ProofOptions
    from distaff_torch.math import field as hostfield
    from distaff_torch.ops import mxu_ntt
    from distaff_torch.stark import serde
    from distaff_torch.tools.timing import random_elements

    cases = [(f"2^{MAIN_LOG2_TRACE}", fibonacci_program(assembly, MAIN_LOG2_TRACE),
              ProgramInputs.from_public([1, 0]), 1, MATERIALIZED[MAIN_LOG2_TRACE][0])]
    for name, example in examples.EXAMPLES.items():
        program, inputs, num_outputs, _ = example()
        cases.append((f"example {name}", program, inputs, num_outputs, EXAMPLE_PROOFS[name]))
    for tag, program, inputs, num_outputs, digest in cases:
        outputs, proof, python_s, native_s, launches = prove_processor_trace(
            program, inputs, num_outputs, ProofOptions())
        got = hashlib.sha256(serde.serialize(proof)).hexdigest()
        if got != digest:
            raise AssertionError(f"processor path, {tag}: proof sha256 {got}, the native "
                                 f"path's {digest}")
        if not distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof):
            raise AssertionError(f"processor path, {tag}: the proof does not verify")
        idle = [k for k in MAIN_PATH if launches[k] == 0]
        if idle:
            raise AssertionError(f"processor path, {tag}: kernels not launched {idle}")
        print(f"processor path, {tag}: trace length {proof.trace_length()}, step 0 in the Python "
              f"VM {python_s:.3f} s against the native VM's {native_s:.3f} s, traces equal; "
              f"proved on cuda with the native path's bytes (sha256 {got[:16]}...), verified; "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    rows = [check_leaf256(gen, ops_rate, leaves) for leaves in LEAF_SHAPES]
    x = random_elements(gen, (LEAF_RAGGED, 256), "cuda")
    root = hostfield.get_root_of_unity(256)
    check_equal("leaf256", f"({LEAF_RAGGED}, 256)", lambda: mxu_ntt.leaf_ntt256(x, root),
                lambda: mxu_ntt.leaf_ntt256_plain(x, root))
    print(f"leaf256 at ({LEAF_RAGGED}, 256), a ragged last tile: equal to plain", flush=True)
    return rows, Counter()


def rank_proof(out):
    """One rank of a phase-11 job (its environment names the job): the 2^16
    proof at the default options three times on its card, warm, steady
    (its launches, exchanges and peak memory counted from 0) and stepped
    (the prover's DEBUG step times, a synchronize at each step's end);
    writes the rank's backend, device, times, peak device memory, launches,
    exchanges, step times, recorded stages and proof digest to `out` as
    JSON."""
    import distaff_torch
    from distaff_torch import assembly, dist_setup, ProgramInputs, ProofOptions
    from distaff_torch.ops import cuda_lib
    from distaff_torch.parallel import mesh as pm, mesh_stages
    from distaff_torch.stark import serde

    program = fibonacci_program(assembly, MAIN_LOG2_TRACE)
    inputs = ProgramInputs.from_public([1, 0])
    outputs, proof, warm_s, _ = timed_execute(program, inputs, ProofOptions(), stepped=False)
    job = dist_setup.job()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    mesh_stages.RECORDED_SHARDINGS.clear()
    pm.EXCHANGES.update(posts=0, sent=0, received=0)
    outputs, proof, steady_s, _ = timed_execute(program, inputs, ProofOptions(), stepped=False)
    if not distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof):
        raise AssertionError(f"rank {job.rank}: the proof does not verify")
    data = serde.serialize(proof)
    result = {"rank": job.rank, "ranks": job.world, "backend": job.describe(),
              "device": str(job.device), "warm_s": warm_s,
              "steady_s": steady_s, "peak": torch.cuda.max_memory_allocated(),
              "launches": {k: cuda_lib.LAUNCHES[k] for k in PROCESS_KERNELS},
              "exchanges": dict(pm.EXCHANGES),
              "recorded": {k: len(v) for k, (_, v) in mesh_stages.RECORDED_SHARDINGS.items()},
              "sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
    _, stepped, _, lines = timed_execute(program, inputs, ProofOptions(), stepped=True)
    if serde.serialize(stepped) != data:
        raise AssertionError(f"rank {job.rank}: the stepped proof's bytes differ")
    result["steps"] = {f"{i}": step_ms(lines, f"step {i} {name}") for i, name in
                       enumerate(PROVER_STEPS, 1)}
    with open(out, "w") as fh:
        json.dump(result, fh)


def run_job(ranks, command, env=None):
    """The processes of one job, one a rank, each `command(rank)` from the
    root of the repository with the job's coordinator on a free local port
    and, as torchrun does, OpenMP's threads limited (to the host's cores
    over the ranks, where the environment does not set them: every rank's
    native host code, the grinding's hashes among it, would otherwise run
    a thread a core): [(stdout, stderr)] a rank.  A rank that exits
    non-zero, or a job past PROCESS_TIMEOUT, raises; every process is
    stopped before it returns."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    threads = max(1, len(os.sched_getaffinity(0)) // ranks)
    procs = []
    try:
        for rank in range(ranks):
            rank_env = dict(os.environ, DISTAFF_COORDINATOR=f"127.0.0.1:{port}",
                            DISTAFF_NUM_PROCESSES=str(ranks), DISTAFF_PROCESS_ID=str(rank),
                            DISTAFF_RENDEZVOUS_TIMEOUT=str(PROCESS_TIMEOUT // 2), **(env or {}))
            rank_env.setdefault("OMP_NUM_THREADS", str(threads))
            procs.append(subprocess.Popen(command(rank), cwd=root, env=rank_env, text=True,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        deadline = time.monotonic() + PROCESS_TIMEOUT
        outs = []
        for rank, proc in enumerate(procs):
            try:
                stdout, stderr = proc.communicate(timeout=max(1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"a job of {ranks} rank(s): rank {rank} did not end within "
                                     f"{PROCESS_TIMEOUT} s")
            if proc.returncode != 0:
                raise AssertionError(f"a job of {ranks} rank(s): rank {rank} exited "
                                     f"{proc.returncode}:\n{stdout[-3000:]}\n{stderr[-6000:]}")
            outs.append((stdout, stderr))
        return outs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def phase_processes(ops_rate):
    """Proving over several processes (distaff_torch/dist_setup.py, the mesh
    over a job's ranks): with one card, a job of one rank (NCCL, through the
    whole entry path) and jobs of 2 and 4 ranks sharing cuda:0 over gloo
    through pinned host memory; with more cards, 2 ranks (and 4 with 4
    cards) over NCCL, one card a rank.  Each rank of each job proves the 2^16
    main program at the default options (rank_proof): every rank's bytes
    phase 4's, every stage of MESH_STAGES split over the ranks of a job of
    2 or more; each job's backend, ranks, cards, warm and steady seconds,
    each rank's peak device memory and launches of PROCESS_KERNELS printed
    with the card's name and power limit.  Then the tool (python -m
    distaff_torch.tools.multihost_prove) at 2^16 with --bench on one rank,
    its proof_sha256 that of a single-process proof of its program and
    options made here, and on 2 ranks (one card) or on one card a rank
    against it as --baseline: proof_matches_baseline true.  Returns no
    rows."""
    import os
    import tempfile

    import distaff_torch
    from distaff_torch import assembly, ProgramInputs, ProofOptions
    from distaff_torch.stark import serde
    from distaff_torch.tools.timing import card_line

    card = card_line()
    cards = torch.cuda.device_count()
    inputs = ProgramInputs.from_public([1, 0])
    program = fibonacci_program(assembly, MAIN_LOG2_TRACE)
    if MAIN_LOG2_TRACE not in MATERIALIZED:
        _, proof = distaff_torch.execute(program, inputs, 1, ProofOptions(), device="cuda")
        MATERIALIZED[MAIN_LOG2_TRACE] = (hashlib.sha256(serde.serialize(proof)).hexdigest(), 0)
    want = MATERIALIZED[MAIN_LOG2_TRACE][0]
    _, proof = distaff_torch.execute(program, inputs, 1, ProofOptions(*TOOL_OPTIONS),
                                     device="cuda")
    tool_want = hashlib.sha256(serde.serialize(proof)).hexdigest()
    del proof
    torch.cuda.empty_cache()
    jobs = PROCESS_RANKS_ONE_CARD if cards == 1 else (1, 2) + ((4,) if cards >= 4 else ())

    with tempfile.TemporaryDirectory() as tmp:
        for ranks in jobs:
            outs = [f"{tmp}/rank-{ranks}-{rank}.json" for rank in range(ranks)]
            t0 = time.perf_counter()
            run_job(ranks, lambda rank: [sys.executable, os.path.abspath(__file__),
                                         "--rank-proof", outs[rank]],
                    {"DISTAFF_MESH_DEVICES": str(ranks)})
            job_s = time.perf_counter() - t0
            results = []
            for path in outs:
                with open(path) as fh:
                    results.append(json.load(fh))
            backends = {r["backend"] for r in results}
            used = sorted({r["device"] for r in results})
            for r in results:
                print(f"processes, {ranks} rank(s), rank {r['rank']} on {r['device']} ({card}): "
                      f"backend {r['backend']}, warm {r['warm_s']:.3f} s, steady "
                      f"{r['steady_s']:.3f} s, peak device memory {r['peak']} bytes, launches "
                      f"{json.dumps(r['launches'])}, exchanges {json.dumps(r['exchanges'])}, "
                      f"stepped proof's steps 1-9 (ms) {json.dumps(r['steps'])}, {r['bytes']} "
                      f"bytes sha256 {r['sha256']}",
                      flush=True)
            print(f"processes, {ranks} rank(s) on {len(used)} card(s) {used} ({card}): backend "
                  f"{'; '.join(sorted(backends))}, the job's command time {job_s:.1f} s, "
                  f"OpenMP threads a rank {max(1, len(os.sched_getaffinity(0)) // ranks)} "
                  f"(unless the environment sets OMP_NUM_THREADS)", flush=True)
            wrong = [r["rank"] for r in results if r["sha256"] != want]
            if wrong:
                raise AssertionError(f"{ranks} rank(s): ranks {wrong} proved other bytes than "
                                     f"phase 4's proof")
            expected = "nccl" if len(used) == ranks else \
                "gloo through pinned host memory (ranks share a card)"
            if backends != {expected}:
                raise AssertionError(f"{ranks} rank(s) on {used}: backend {backends}, not "
                                     f"{expected}")
            off = [(r["rank"], st) for r in results for st in MESH_STAGES
                   if ranks > 1 and r["recorded"].get(st) != ranks]
            idle = [(r["rank"], k) for r in results for k in PROCESS_KERNELS
                    if r["launches"][k] == 0]
            if off or idle:
                raise AssertionError(f"{ranks} rank(s): stages not split over the ranks {off}, "
                                     f"kernels not launched {idle}")
            print(f"processes, {ranks} rank(s): every rank verified phase 4's bytes"
                  + (", every stage split over the ranks" if ranks > 1 else ""), flush=True)

        tool = [sys.executable, "-m", "distaff_torch.tools.multihost_prove",
                str(MAIN_LOG2_TRACE), "--bench"]
        base = f"{tmp}/tool-1.json"
        (stdout, _), = run_job(1, lambda rank: tool + ["--out", base])
        line = json.loads(stdout.strip().splitlines()[-1])
        print(f"processes, tool on 1 rank ({card}): {stdout.strip().splitlines()[0]}; "
              f"{json.dumps(line)}", flush=True)
        if line["proof_sha256"] != tool_want:
            raise AssertionError(f"the tool's proof_sha256 {line['proof_sha256']}, a single "
                                 f"process's {tool_want}")
        ranks = 2 if cards == 1 else min(cards, 4)
        outs = run_job(ranks, lambda rank: tool + ["--baseline", base])
        line = json.loads(outs[0][0].strip().splitlines()[-1])
        for stdout, _ in outs:
            print(f"processes, tool on {ranks} ranks ({card}): {stdout.strip().splitlines()[0]}",
                  flush=True)
        print(f"processes, tool on {ranks} ranks ({card}): {json.dumps(line)}", flush=True)
        if line["proof_matches_baseline"] is not True or line["proof_sha256"] != tool_want:
            raise AssertionError(f"the tool on {ranks} ranks: {line}")
    if cards == 1:
        print("multi-process: NCCL across cards not exercised (1 card)", flush=True)
    return [], Counter()


def phase_bench():
    """The kernel bench at BENCH_SIZES; it raises if ntt_stagewise and
    tiles.ntt differ at any size.  Returns the launches of its run."""
    from distaff_torch.ops import cuda_lib
    from distaff_torch.tools import kernel_bench

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    kernel_bench.bench(BENCH_SIZES)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"bench launches: {json.dumps(launches)}", flush=True)
    print(f"bench: ntt_stagewise equal to tiles.ntt at 2^{', 2^'.join(map(str, BENCH_SIZES))}",
          flush=True)
    idle = [k for k in BENCH_PATH if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the bench path: {idle}")
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--step-times", nargs="+", type=int, metavar="LOG2_N",
                        help="only print the step times of the bench's proofs at these sizes")
    parser.add_argument("--kernel-times", action="store_true",
                        help="only print the times of K9 and K11 at the proofs' shapes")
    parser.add_argument("--tree-times", action="store_true",
                        help="only print the times of the Merkle trees, a first proof's power "
                             "tables and K3, K9 and K14")
    parser.add_argument("--wsum-times", action="store_true",
                        help="only print the times of K7 and K15 at the proofs' calls")
    parser.add_argument("--inv-times", action="store_true",
                        help="only print the times of K6 and of K2's exp_const at M - 2")
    parser.add_argument("--processes", action="store_true",
                        help="only run phase 11, the multi-process jobs")
    parser.add_argument("--rank-proof", metavar="OUT",
                        help="run as one rank of a phase-11 job, writing its result to OUT")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.rank_proof:
        rank_proof(args.rank_proof)
        return 0
    if args.processes:
        from distaff_torch.tools.timing import card_line

        print(card_line(), flush=True)
        phase_processes(None)
        return 0
    if args.step_times or args.kernel_times or args.tree_times or args.wsum_times or \
            args.inv_times:
        from distaff_torch.tools.timing import card_line

        print(card_line(), flush=True)
        if args.inv_times:
            inv_times()
        if args.wsum_times:
            wsum_times()
        if args.tree_times:
            tree_times()
        if args.kernel_times:
            kernel_times()
        if args.step_times:
            step_times(args.step_times)
        return 0
    from distaff_torch import native
    from distaff_torch.ops import air_kernels, cuda_lib
    from distaff_torch.tools.timing import card_line

    # phase 1: build every library at once (each kernel source in its own
    # nvcc, K4 once per triple), each timed from the start of the phase
    t0 = time.perf_counter()

    def timed(fn, *args):
        fn(*args)
        return time.perf_counter() - t0

    builds = {"kernels K1-K3, K5-K16": (cuda_lib.lib,), "native runtime": (native.lib,),
              "K4 host evaluator": (air_kernels.host_lib,)}
    builds.update({f"K4 at {d}": (air_kernels.air_lib, d) for d in AIR_TRIPLES})
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        done = {name: pool.submit(timed, *job) for name, job in builds.items()}
        seconds = {name: f.result() for name, f in done.items()}
    card = card_line()
    print(f"build: every library in {time.perf_counter() - t0:.1f} s; "
          + ", ".join(f"{name} done at {s:.1f} s" for name, s in seconds.items()), flush=True)
    for d in AIR_TRIPLES:
        for line in air_kernels.ptxas_report(d):
            print(f"K4 {d} {line.strip()}", flush=True)
    for name, stem in (("K6", "inv_batch"), ("K7", "deep_compose"), ("K8", "poly_eval"),
                       ("K9", "fri_fold"), ("K10", "boundary_columns"), ("K11", "syn_div"),
                       ("K12", "power_series"), ("K13", "merkle_tree"), ("K14", "trace_absorb"),
                       ("K15", "coeff_wsum"), ("K16", "leaf256")):
        for line in cuda_lib.ptxas_report(stem):
            print(f"{name} {line.strip()}", flush=True)
    # the integer opcode mix of the kernels on blake3.cuh's compression (K3,
    # K9, K13, K14: IMAD on the FMA pipe, the rest on the integer-only pipe)
    # and of those on the int8 tensor cores (K7, K10, K15, K16: IMMA; K16's
    # two integer pipes too: its fragments' byte_perms and its reductions)
    for name, stem in (("K3", "blake3_rows"), ("K9", "fri_fold"), ("K13", "merkle_tree"),
                       ("K14", "trace_absorb"), ("K7", "deep_compose"),
                       ("K10", "boundary_columns"), ("K15", "coeff_wsum"), ("K16", "leaf256")):
        sass = cuda_lib.sass(stem)
        if sass is None:
            print(f"{name} SASS: no cuobjdump found, opcodes not counted", flush=True)
            continue
        counts = cuda_lib.opcode_counts(sass)
        pipes = "; FMA pipe {}, integer-only pipe {}".format(*cuda_lib.pipe_counts(sass)) \
            if stem == "leaf256" else ""
        print(f"{name} SASS opcodes: " + ", ".join(f"{op} {k}" for op, k in counts.items())
              + pipes, flush=True)
        if stem in ("deep_compose", "boundary_columns", "coeff_wsum", "leaf256") and \
                counts["IMMA"] == 0:
            raise AssertionError(f"{stem}: no IMMA instruction in its SASS")
    # the multiply's kernels off the proof: IMAD's forms against the
    # integer-only pipe's adds and logic (tools/air_probe.py k2exp splits
    # them into a squaring's and a multiply's)
    for name, stem, kernel in (("K2 exp_const", "field_ew", "exp_kernel"),
                               ("K6", "inv_batch", "inv_batch_kernel")):
        sass = cuda_lib.sass(stem)
        if sass is None:
            print(f"{name} SASS: no cuobjdump found, opcodes not counted", flush=True)
            continue
        sass = cuda_lib.function_sass(sass, kernel)
        counts = cuda_lib.opcode_counts(sass, cuda_lib.MULTIPLY_OPCODES)
        fma, alu = cuda_lib.pipe_counts(sass)
        print(f"{name} SASS opcodes: " + ", ".join(f"{op} {k}" for op, k in counts.items())
              + f"; FMA pipe {fma}, integer-only pipe {alu}", flush=True)
    ops_rate = int32_ops_per_s()
    k16_report(ops_rate)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    for line in cuda_lib.ptxas_report("ntt_pass"):
        print(f"K1 {line.strip()}", flush=True)
    rows = phase_kernels(ops_rate)
    phase_golden()
    launches, keyed = phase_main([row["key"] for row in rows if "key" in row])
    bench_launches = phase_bench()
    for phase in (phase_examples, phase_ladder, phase_stream, phase_mesh, phase_processor,
                  phase_processes):
        phase_rows, phase_keyed = phase(ops_rate)
        rows += phase_rows
        keyed += phase_keyed
    for row in rows:
        name = row["name"]
        if "key" in row:
            row["launches"] = keyed[row.pop("key")]
        else:
            row["launches"] = bench_launches[name] if name in BENCH_PATH and \
                name not in MAIN_PATH else launches[name]

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
