// K14 trace_absorb: one 64-byte BLAKE3 block of every row of the extended
// trace, absorbed into the row's chaining value, while the block's registers
// are copied into the evaluation domain's stride slice.
//
// Replaces the JAX package's distaff_tpu/ops/blake3_jax.py::absorb_begin,
// absorb_block, absorb_finish and, for rows of two chunks, parent_root, as
// the streaming commitment (distaff_tpu/stark/trace_table.py::
// _stream_commit) drives them: the trace's LDE is computed four registers at
// a time (a 64-byte block of each row), and no (R, D) LDE ever exists.  A
// row's bytes are its registers' little-endian limbs in order, as K3 hashes
// a row of the whole LDE, so the finished chaining values are K3's digests:
// the Merkle tree's leaves.
//
// A launch absorbs block `block` of each of the D rows: the n_regs <= 4
// registers of the group (zero words past them, where the last block of a
// row is partial), its flags, length and chunk counter from the host
// (ops/blake3_torch.absorb_flags):
// - on a chunk's first block the chaining value starts from the IV, so no
//   launch or memset prepares the state;
// - rows of up to 64 registers are one chunk, whose last block is flagged
//   ROOT; a longer row's chunk 0 ends at block 15, its chaining values are
//   kept by the host, and the launch of the row's last block reads them
//   and writes the parent node (PARENT | ROOT, counter 0) over the two
//   chunks' values;
// - the chaining values are (D, 8) uint32 rows, so the finished ones are
//   the (D, 8) leaf digests that K13 takes, with no transpose.
// Points d of the domain with d = 0 mod 2^slice_shift (the evaluation
// domain, ext / 8 apart) also go to the group's rows of the stride slice
// (R, D >> slice_shift, 4), which step 3 reads.
//
// Bound on this card: bytes.  A thread (one row) reads 16 bytes of each of
// the group's registers and its 32-byte chaining value, and writes the
// value back: 128 bytes a row of a full block against one compression (680
// instructions), so a million rows take 40 us of bytes at 3.35 TB/s against
// 21 us of instructions.  The design: one thread a row, consecutive threads on
// consecutive rows, so each register's 16-byte loads are coalesced; the
// registers are read once (streaming loads), the chaining values in place.
// Offsets are 64-bit: a group at 2^22 steps is (4, 2^27, 4) words.
//
// Compiles as plain C++ too (field128.cuh's qualifiers): the CPU tests run
// `row` over every row against the plain version.

#pragma once
#include <cstdint>

#include "blake3.cuh"
#include "field128.cuh"
#include "points.cuh"

namespace trace_absorb {

constexpr int kThreads = 256;
constexpr int kBlockRegisters = 4;          // 16-byte registers in a 64-byte block

struct Args {
    const uint4* regs;      // register j's point d at regs[j * reg_stride + d]
    long long reg_stride;   // in 16-byte units
    int n_regs;             // registers of this block: 1 to 4, the words past them zero
    long long rows;         // D, the points of the domain
    uint4* cv;              // (D, 8) uint32 chaining values, two 16-byte halves a row
    const uint4* chunk0;    // chunk 0's finished values, or null: the parent node
    uint4* slice;           // register j's point e of the slice at slice[j * slice_stride + e],
                            // or null
    long long slice_stride;
    int slice_shift;        // the slice takes points d = e << slice_shift
    uint32_t flags;         // CHUNK_START, CHUNK_END and ROOT of this block
    uint32_t block_len;     // its bytes
    uint64_t counter;       // the chunk counter
};

F128_FN long long blocks(const Args& a) { return (a.rows + kThreads - 1) / kThreads; }

// Row d: the block's message from the group's registers (copied to the slice
// where d is a point of it), compressed into the row's chaining value, and
// with chunk0 the parent node of the two chunks.
F128_FN void row(const Args& a, long long d) {
    uint32_t m[16];
    const bool in_slice = a.slice && (d & ((1LL << a.slice_shift) - 1)) == 0;
#pragma unroll
    for (int j = 0; j < kBlockRegisters; ++j) {
        uint4 v = {0, 0, 0, 0};
        if (j < a.n_regs) {
            v = points::load_stream(a.regs + j * a.reg_stride + d);
            if (in_slice) a.slice[j * a.slice_stride + (d >> a.slice_shift)] = v;
        }
        m[4 * j] = v.x;
        m[4 * j + 1] = v.y;
        m[4 * j + 2] = v.z;
        m[4 * j + 3] = v.w;
    }
    uint32_t cv[8];
    if (a.flags & blake3::kChunkStart) {
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = blake3::iv(i);
    } else {
        const uint4 lo = a.cv[2 * d], hi = a.cv[2 * d + 1];
        cv[0] = lo.x; cv[1] = lo.y; cv[2] = lo.z; cv[3] = lo.w;
        cv[4] = hi.x; cv[5] = hi.y; cv[6] = hi.z; cv[7] = hi.w;
    }
    blake3::compress(cv, m, a.counter, a.block_len, a.flags);
    if (a.chunk0) {
        const uint4 lo = a.chunk0[2 * d], hi = a.chunk0[2 * d + 1];
        m[0] = lo.x; m[1] = lo.y; m[2] = lo.z; m[3] = lo.w;
        m[4] = hi.x; m[5] = hi.y; m[6] = hi.z; m[7] = hi.w;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            m[8 + i] = cv[i];
            cv[i] = blake3::iv(i);
        }
        blake3::compress(cv, m, 0, 64, blake3::kParent | blake3::kRoot);
    }
    const uint4 lo = {cv[0], cv[1], cv[2], cv[3]};
    const uint4 hi = {cv[4], cv[5], cv[6], cv[7]};
    a.cv[2 * d] = lo;
    a.cv[2 * d + 1] = hi;
}

}  // namespace trace_absorb
