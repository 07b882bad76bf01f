// Burst factor chi of the per-epoch kernels, shared by epoch_maps.cu and
// emergent_maps.cu.
//
// Launch time and jet side arrive packed in one float per cell,
// tss = +(ts + off) on the blue side and -(ts + off) on the red side
// (ops/kernels.py:pack_launch_time), and chi follows the Pallas kernels'
// float32 order:
//   lt = t - (|tss| - off),  g = amp * expf(-(lt - t0)^2 * inv2s2),
//   chi = 1 + sum of g over the cell's side's bursts.
#pragma once

#include <cuda_runtime.h>

#define MAX_BURSTS 32

// Burst list: (t0 [s], 1/(2 sigma^2) [s^-2], relative amplitude, is_red).
// Mirrors the ctypes Structure _Bursts in ops/kernels.py field for field.
struct Bursts {
    int n;
    float t0[MAX_BURSTS];
    float inv2s2[MAX_BURSTS];
    float amp[MAX_BURSTS];
    int is_red[MAX_BURSTS];
};

static __device__ __forceinline__ float burst_chi(float tss, float t,
                                                  float off,
                                                  const Bursts& b) {
    const float lt = t - (fabsf(tss) - off);
    const int red = tss < 0.0f;
    float chi = 1.0f;
    for (int i = 0; i < b.n; ++i) {
        const float d = lt - b.t0[i];
        const float g = b.amp[i] * expf(-(d * d) * b.inv2s2[i]);
        if (b.is_red[i] == red) chi = chi + g;
    }
    return chi;
}
