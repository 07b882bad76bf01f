// Per-epoch LOS-collapsed burst maps  sum_y base * chi(t - ts)^2  for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// rajepy_tpu_torch/ops/kernels.py.
//
// Replaces the three Pallas TPU kernels of rajepy_tpu/ops/pallas_kernels.py
// on the continuum main path:
//   epoch_tiles_kernel   <- epoch_base_map_tiles   (_epoch_tiles_kernel)
//   epoch_tiles2_kernel  <- epoch_base_maps2_tiles (_epoch_tiles2_kernel)
//   epoch_full_kernel    <- epoch_base_map_pallas  (_epoch_base_kernel)
//
// What bounds them: bytes.  Per cell a kernel reads 4 bytes of base (8 for
// the dual-base kernel) and 4 of packed launch time, and does one expf per
// burst (5 for the bundled example jet): about 2 flop per byte, far below
// the card's ~20 flop/byte float32 balance point.  So the design streams
// each input once, coalesced, and keeps everything else in registers:
//   * one thread owns one (tile, x, z) column and loops over the tile's 64
//     y cells (the full grid's ny cells for epoch_full_kernel), summing
//     base * chi^2 in a register; there is no cross-thread reduction and
//     no shared memory;
//   * a block is (128 z, 8 x) threads, so a warp reads 32 neighbouring z
//     addresses (128 contiguous bytes) per y step;
//   * the burst parameters arrive by value in the kernel's parameter space
//     (no device copy per epoch) and chi is evaluated in registers; the
//     dual-base kernel reads the launch time once and evaluates chi once
//     for both bases.
// The TPU versions accumulate the full-grid sum across sequential y-chunk
// grid steps; here one thread owns a whole column, so nothing depends on
// the order in which blocks run.
//
// Numerics follow the Pallas kernels' float32 order (burst_chi in
// bursts.cuh).  Build with -fmad=false so that no multiply-add is
// contracted.

#include <cuda_runtime.h>
#include <stddef.h>

#include "bursts.cuh"

#define TILE_X 8
#define TILE_Y 64
#define TILE_Z 128

// One block per active tile; out[tile, x, z] = sum_y base * chi * chi.
__global__ void __launch_bounds__(TILE_X * TILE_Z)
epoch_tiles_kernel(const float* __restrict__ base,
                   const float* __restrict__ tss,
                   float* __restrict__ out, float t, float off, Bursts b) {
    const int z = threadIdx.x;
    const int x = threadIdx.y;
    const size_t col = (size_t)blockIdx.x * (TILE_X * TILE_Y * TILE_Z) +
                       (size_t)x * (TILE_Y * TILE_Z) + z;
    float acc = 0.0f;
#pragma unroll 4
    for (int y = 0; y < TILE_Y; ++y) {
        const size_t i = col + (size_t)y * TILE_Z;
        const float chi = burst_chi(tss[i], t, off, b);
        acc = acc + base[i] * chi * chi;
    }
    out[(size_t)blockIdx.x * (TILE_X * TILE_Z) + x * TILE_Z + z] = acc;
}

// Dual-base variant: one tss read and one chi for both maps.
__global__ void __launch_bounds__(TILE_X * TILE_Z)
epoch_tiles2_kernel(const float* __restrict__ base_a,
                    const float* __restrict__ base_b,
                    const float* __restrict__ tss,
                    float* __restrict__ out_a, float* __restrict__ out_b,
                    float t, float off, Bursts b) {
    const int z = threadIdx.x;
    const int x = threadIdx.y;
    const size_t col = (size_t)blockIdx.x * (TILE_X * TILE_Y * TILE_Z) +
                       (size_t)x * (TILE_Y * TILE_Z) + z;
    float acc_a = 0.0f;
    float acc_b = 0.0f;
#pragma unroll 4
    for (int y = 0; y < TILE_Y; ++y) {
        const size_t i = col + (size_t)y * TILE_Z;
        const float chi = burst_chi(tss[i], t, off, b);
        const float chi2 = chi * chi;
        acc_a = acc_a + base_a[i] * chi2;
        acc_b = acc_b + base_b[i] * chi2;
    }
    const size_t o = (size_t)blockIdx.x * (TILE_X * TILE_Z) + x * TILE_Z + z;
    out_a[o] = acc_a;
    out_b[o] = acc_b;
}

// Full (nx, ny, nz) grid: one thread per (x, z) column, ragged edges
// masked; out is (nx, nz).
__global__ void __launch_bounds__(TILE_X * TILE_Z)
epoch_full_kernel(const float* __restrict__ base,
                  const float* __restrict__ tss, float* __restrict__ out,
                  int nx, int ny, int nz, float t, float off, Bursts b) {
    const int z = blockIdx.x * TILE_Z + threadIdx.x;
    const int x = blockIdx.y * TILE_X + threadIdx.y;
    if (x >= nx || z >= nz) return;
    const size_t col = (size_t)x * ny * nz + z;
    float acc = 0.0f;
#pragma unroll 4
    for (int y = 0; y < ny; ++y) {
        const size_t i = col + (size_t)y * nz;
        const float chi = burst_chi(tss[i], t, off, b);
        acc = acc + base[i] * chi * chi;
    }
    out[(size_t)x * nz + z] = acc;
}

// Host entry points.  Each launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" {

int epoch_tiles(const float* base, const float* tss, float* out, int n_act,
                float t, float off, Bursts b, void* stream) {
    const dim3 block(TILE_Z, TILE_X);
    epoch_tiles_kernel<<<n_act, block, 0, (cudaStream_t)stream>>>(
        base, tss, out, t, off, b);
    return (int)cudaGetLastError();
}

int epoch_tiles2(const float* base_a, const float* base_b, const float* tss,
                 float* out_a, float* out_b, int n_act, float t, float off,
                 Bursts b, void* stream) {
    const dim3 block(TILE_Z, TILE_X);
    epoch_tiles2_kernel<<<n_act, block, 0, (cudaStream_t)stream>>>(
        base_a, base_b, tss, out_a, out_b, t, off, b);
    return (int)cudaGetLastError();
}

int epoch_full(const float* base, const float* tss, float* out, int nx,
               int ny, int nz, float t, float off, Bursts b, void* stream) {
    const dim3 block(TILE_Z, TILE_X);
    const dim3 grid((nz + TILE_Z - 1) / TILE_Z, (nx + TILE_X - 1) / TILE_X);
    epoch_full_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        base, tss, out, nx, ny, nz, t, off, b);
    return (int)cudaGetLastError();
}

}  // extern "C"
