// One-time launch setup a card, for the kernels' C entry points.
//
// A kernel's dynamic shared-memory limit (cudaFuncSetAttribute) and the
// card's SM count or resident blocks hold for the current device only.
// Kept in a function-local static they would be set up on the first card a
// process launches on and missing on every other: a mesh of slots on two
// cards (distaff_torch/parallel/mesh.py) launches on both.  Here each is
// kept a device, indexed by cudaGetDevice.  A setup that failed is tried
// again at the next launch.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace per_device {

constexpr int kMaxDevices = 64;

// The current device's index, checked against kMaxDevices.
inline cudaError_t current(int* device) {
    const cudaError_t e = cudaGetDevice(device);
    if (e != cudaSuccess) return e;
    return *device >= 0 && *device < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// Runs setup(device) once a device: `done` is a static array of the
// caller's, zero at the start.
template <typename Setup>
cudaError_t once(std::atomic<int> (&done)[kMaxDevices], Setup setup) {
    int device = 0;
    cudaError_t e = current(&device);
    if (e != cudaSuccess) return e;
    if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
    e = setup(device);
    if (e == cudaSuccess) done[device].store(1, std::memory_order_release);
    return e;
}

// A kernel's dynamic shared-memory limit, set once a device.
template <typename Kernel>
cudaError_t shared_limit(std::atomic<int> (&done)[kMaxDevices], Kernel kernel, int bytes) {
    return once(done, [&](int) {
        return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    });
}

// value = read(device) for the current device, read once a device and
// cached in `cache` (a static array of the caller's, zero at the start;
// read must give a positive value).
template <typename Read>
cudaError_t cached(std::atomic<int> (&cache)[kMaxDevices], int* value, Read read) {
    int device = 0;
    cudaError_t e = current(&device);
    if (e != cudaSuccess) return e;
    int v = cache[device].load(std::memory_order_acquire);
    if (v == 0) {
        e = read(device, &v);
        if (e != cudaSuccess) return e;
        cache[device].store(v, std::memory_order_release);
    }
    *value = v;
    return cudaSuccess;
}

// The current device's SM count.
inline cudaError_t sm_count(std::atomic<int> (&cache)[kMaxDevices], int* sms) {
    return cached(cache, sms, [](int device, int* v) {
        return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, device);
    });
}

}  // namespace per_device
