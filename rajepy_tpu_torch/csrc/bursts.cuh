// Burst factor chi of the per-epoch kernels, shared by epoch_maps.cu and
// emergent_maps.cu.
//
// Launch time and jet side arrive packed in one float per cell,
// tss = +(ts + off) on the blue side and -(ts + off) on the red side
// (ops/kernels.py:pack_launch_time), and chi follows the Pallas kernels'
// float32 order:
//   lt = t - (|tss| - off),  g = amp * expf(-(lt - t0)^2 * inv2s2),
//   chi = 1 + sum of g over the cell's side's bursts, in list order.
//
// The list arrives split by side, each side's bursts in their original
// order, so a cell evaluates only its own side's bursts: one expf per burst
// of its side (2 or 3 for the bundled jet, not 5).  The TPU kernels
// evaluate every burst and add the other side's terms as zeros; chi + 0 is
// chi, so the per-side sum is the same sequence of float32 additions and
// chi is bit for bit the same.  Lanes of one warp may sit on different
// sides: the loop runs over the lane's own count with its own side's
// parameters (read from the kernel's parameter space by a per-lane index),
// so the warp runs max(n_red, n_blue) iterations with the shorter side's
// lanes masked, never the two sides one after the other.  The loop is not
// unrolled: a side holds up to MAX_BURSTS bursts and several call sites are
// unrolled over cells already.
#pragma once

#include <cuda_runtime.h>

#define MAX_BURSTS 32   // the whole list, both sides together
#define SIDE_BLUE 0
#define SIDE_RED 1

// Burst list by side (SIDE_BLUE, SIDE_RED): the count, and per burst
// (t0 [s], 1/(2 sigma^2) [s^-2], relative amplitude, unused), four floats
// so that a burst's parameters lie in one 16-byte slot of the kernel's
// parameter space.  Mirrors the ctypes Structure _Bursts in ops/kernels.py
// field for field.
struct Bursts {
    int n[2];
    float p[2][MAX_BURSTS][4];
};

static __device__ __forceinline__ float burst_chi(float tss, float t,
                                                  float off,
                                                  const Bursts& b) {
    const float lt = t - (fabsf(tss) - off);
    const int side = tss < 0.0f ? SIDE_RED : SIDE_BLUE;
    const int n = b.n[side];
    float chi = 1.0f;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
        const float d = lt - b.p[side][i][0];
        const float g = b.p[side][i][2] * expf(-(d * d) * b.p[side][i][1]);
        chi = chi + g;
    }
    return chi;
}
