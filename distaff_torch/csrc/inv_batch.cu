// K6 inv_batch: the inverse of every element in the 128-bit field (zero maps
// to zero), by Montgomery's trick within each block.
//
// Replaces distaff_tpu/math/field_jax.py::inv_batch_scan, the XLA batch
// inversion that the JAX prover's DEEP composition takes on an accelerator
// (prover.py, `use_scan_inv`): a log-depth prefix and suffix product over
// the whole batch and one Fermat chain on its total.  The port's proof no
// longer calls it (K7 deep_compose inverts inside its own blocks on the
// same product tree); the kernel bench does.  On this card nothing
// carries across blocks, so each block inverts its own range of tiles with
// one chain, and the grid holds no more blocks than the card keeps resident
// at once, so that the chains of all blocks run together:
//   - a tile is T x K consecutive elements (256 threads x 8), a thread's
//     element k at tile offset k T + thread, so loads and stores are
//     coalesced; zeros count as ones in the products and map back to zero
//     at the end, as inv_batch_scan does;
//   - a thread runs through its elements of the block's tiles keeping the
//     running product, and writes each prefix to `out` as scratch;
//   - the block's threads meet in inv_block.cuh's product tree (shared
//     with K7 deep_compose), which inverts the block's product once
//     (field128.cuh's inv, binary extended Euclid: K6 takes 0.084 ms at
//     2^21 with it and 0.116 ms with square-and-multiply's 250 dependent
//     multiplies, tools/air_probe.py, PERF.md) and gives each thread the
//     inverse of its own product;
//   - a thread then walks back through its elements: inv(a_e) = inv(q_e)
//     q_(e-1) and inv(q_(e-1)) = inv(q_e) a_e, q the prefixes it wrote.
// That is Montgomery's 3 multiplies an element, about 3 more a thread and one
// chain a block, against the 250 multiplies of a Fermat chain for every
// element (K2's exp_const).  The inverse is unique, so every result equals
// exp_const(a, M - 2).
//
// Bound on this card: bytes (16 read and 16 written an element; 3
// multiplies an element are below that).  The scratch prefixes add a write
// and a read an element, which the 50 MB L2 mostly keeps; the floor in
// practice is the latency of the passes' dependent multiplies and of one
// inversion.

#include <cuda_runtime.h>
#include <cstdint>

#include "field128.cuh"
#include "inv_block.cuh"

namespace {

using f128::u128;

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;

// block b inverts tiles [b P, (b + 1) P) of a into out, P = tiles_per_block
__global__ void __launch_bounds__(kThreads)
inv_batch_kernel(const uint4* __restrict__ a, uint4* __restrict__ out, long long n,
                 long long tiles_per_block) {
    __shared__ u128 tree[2 * kThreads];
    const int tid = threadIdx.x;
    const long long first = (long long)blockIdx.x * tiles_per_block * kTile + tid;
    const long long last = first + tiles_per_block * kTile;     // past the thread's last element

    // the running product of the thread's elements (zeros as ones), each
    // prefix written to out
    u128 run = 1;
    for (long long t = first; t < last && t < n; t += kTile) {
#pragma unroll
        for (int k = 0; k < kPerThread; k++) {
            const long long i = t + (long long)k * kThreads;
            if (i < n) {
                const u128 v = f128::from_limbs(a[i]);
                if (v != 0) run = f128::mul(run, v);
                out[i] = f128::to_limbs(run);
            }
        }
    }

    // 1 / (the thread's product) from the block's tree; then back through
    // the elements, last first
    u128 inv_q = inv_block::inverse_of_total<kThreads>(tree, run);
    for (long long t = first + (tiles_per_block - 1) * kTile; t >= first; t -= kTile) {
#pragma unroll
        for (int k = kPerThread - 1; k >= 0; k--) {
            const long long i = t + (long long)k * kThreads;
            if (i >= n) continue;
            const long long prev = k ? i - kThreads : i - kTile + (kPerThread - 1) * kThreads;
            const u128 q_prev = k || t > first ? f128::from_limbs(out[prev]) : 1;
            const u128 v = f128::from_limbs(a[i]);
            out[i] = f128::to_limbs(v == 0 ? 0 : f128::mul(inv_q, q_prev));
            if (v != 0) inv_q = f128::mul(inv_q, v);
        }
    }
}

}  // namespace

// out[i] = a[i]^(M - 2) for i < n, (n, 4) limbs each
extern "C" int distaff_inv_batch(const void* a, void* out, long long n, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    static int resident = 0;                 // blocks the card keeps resident at once
    if (resident == 0) {
        int device, sms, per_sm;
        cudaError_t e = cudaGetDevice(&device);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inv_batch_kernel, kThreads, 0);
        if (e != cudaSuccess) return (int)e;
        resident = sms * per_sm;
    }
    const long long tiles = (n + kTile - 1) / kTile;
    const long long per_block = (tiles + resident - 1) / resident;
    const long long blocks = (tiles + per_block - 1) / per_block;
    inv_batch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (uint4*)out, n, per_block);
    return (int)cudaGetLastError();
}
