// K6 inv_batch: the inverse of every element in the 128-bit field (zero maps
// to zero), by Montgomery's trick within each block.
//
// Replaces distaff_tpu/math/field_jax.py::inv_batch_scan, the XLA batch
// inversion that the JAX prover's DEEP composition takes on an accelerator
// (prover.py, `use_scan_inv`): a log-depth prefix and suffix product over
// the whole batch and one Fermat chain on its total.  The port's proof no
// longer calls it (K7 deep_compose inverts inside its own blocks); the
// kernel bench does.  On this card nothing carries across blocks, so each
// block inverts its own range with one inversion, and the grid holds no
// more blocks than the card keeps resident at once, so that the
// inversions of all blocks run together.  The passes and the tree are
// inv_batch.cuh's.
//
// Bound on this card: bytes (16 read and 16 written an element) against
// Montgomery's 3 multiplies an element; a multiply issues 67 instructions
// to the FMA pipe and 66 to the integer-only one (tools/air_probe.py
// k2exp), so at 64 lanes an SM each the multiplies take longer than the
// bytes.  A block's inversion is a dependent chain of ~90 steps on one
// thread that no other work of the block hides (~11 us), and the tree
// around it ~10 dependent multiplies.  The design keeps a thread's state
// small (one product, no branch around a multiply, ~45 registers) so that
// warps hide each other's latencies, meets in a tree of warp shuffles that
// forms every product but the inverse beside the inversion, and inverts by
// Kaliski's almost Montgomery inverse (field128.cuh's inv).  A thread takes
// at least kMinElements (16) elements where that leaves every SM a block,
// so that the tree's ~12 multiplies a thread stay well below the passes'
// (at 2^20 elements: 2 blocks an SM, not 4).

#include <cuda_runtime.h>
#include <cstdint>

#include "per_device.cuh"
#include "field128.cuh"
#include "inv_batch.cuh"

namespace {

using inv_batch::Args;
using inv_batch::kThreads;
using inv_batch::u128;

// a thread's least elements while every SM keeps a block (the tree's
// multiplies amortized)
constexpr long long kMinElements = 16;

// at most 64 registers a thread: 4-6 blocks an SM
__global__ void __launch_bounds__(kThreads, 4) inv_batch_kernel(const Args g) {
    __shared__ uint4 tree[inv_batch::kWarps + 1];
    const int tid = threadIdx.x;
    const long long b = blockIdx.x;
    const long long count = inv_batch::count(g, b, tid);
    const u128 q = inv_batch::forward(g, b, tid, count);
    const u128 inv_q = inv_batch::invert_total(q, tree);
    inv_batch::backward(g, b, tid, count, inv_q);
}

}  // namespace

// out[i] = a[i]^(M - 2) for i < n, (n, 4) limbs each
extern "C" int distaff_inv_batch(const void* a, void* out, long long n, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    // the card's SMs, and the blocks it keeps resident
    static std::atomic<int> sm_counts[per_device::kMaxDevices], residents[per_device::kMaxDevices];
    int sms = 0, resident = 0;
    cudaError_t e = per_device::sm_count(sm_counts, &sms);
    if (e == cudaSuccess)
        e = per_device::cached(residents, &resident, [&](int, int* v) {
            int per_sm = 0;
            const cudaError_t r =
                cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inv_batch_kernel, kThreads, 0);
            *v = sms * per_sm;
            return r;
        });
    if (e != cudaSuccess) return (int)e;
    Args g;
    g.a = (const uint4*)a;
    g.out = (uint4*)out;
    g.n = n;
    // as few elements a thread as fill the resident blocks, but at least
    // kMinElements while that leaves a block an SM
    const long long all = (long long)resident * kThreads, one = (long long)sms * kThreads;
    const long long spread = (n + all - 1) / all;
    long long least = (n + one - 1) / one;
    if (least > kMinElements) least = kMinElements;
    g.per_thread = spread > least ? spread : least;
    const long long per_block = g.per_thread * kThreads;
    const long long blocks = (n + per_block - 1) / per_block;
    inv_batch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}
