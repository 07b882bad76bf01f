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
// The two tile kernels.  What bounds them: bytes.  Per cell a kernel reads
// 4 bytes of base (8 for the dual-base kernel) and 4 of packed launch time,
// and does one expf per burst (5 for the bundled example jet): about 2 flop
// per byte, far below the card's ~20 flop/byte float32 balance point.  So
// the design streams each input once, coalesced, and keeps everything else
// in registers:
//   * one thread owns one (tile, x, z) column and loops over the tile's 64
//     y cells, summing base * chi^2 in a register; there is no cross-thread
//     reduction and no shared memory;
//   * a block is (128 z, 8 x) threads, so a warp reads 32 neighbouring z
//     addresses (128 contiguous bytes) per y step;
//   * the burst parameters arrive by value in the kernel's parameter space
//     (no device copy per epoch) and chi is evaluated in registers; the
//     dual-base kernel reads the launch time once and evaluates chi once
//     for both bases.
//
// The full-grid kernel.  It runs when no tile is active, so its base cube
// is zero everywhere or nearly so, and a cell with base = 0 adds exactly 0
// whatever its launch time (tss is finite everywhere).  Evaluating chi at
// every cell would cost five expf and ~75 instructions per cell, as much
// time as the bytes; so the kernel reads base whole and everything else
// only where base != 0.  What bounds it: the bytes of base.  The design
// (stream.cuh): a warp owns a strip of 32 z columns of one x, base arrives
// 16 y rows at a time through a warp-private ring of 4 shared-memory stages
// filled by asynchronous copies, a chunk that is all zero costs one
// shared-memory pass and a warp vote, and in any other chunk only lanes with
// base != 0 load tss (all of a chunk's loads started before the first chi)
// and add base * chi^2, in y order, in a register.  Grids with nz % 4 != 0,
// unaligned cubes and the ragged last strip take 4-byte asynchronous copies
// into the same ring.  A wholly jet cube skips nothing and is bound by
// the instruction rate, as the dense evaluation above.
//
// The TPU versions accumulate the full-grid sum across sequential y-chunk
// grid steps; here one thread owns a whole column, so nothing depends on
// the order in which blocks run, and every column's sum is taken in y
// order: the result equals a plain loop's bit for bit (apart from the sign
// of a zero).
//
// Numerics follow the Pallas kernels' float32 order (burst_chi in
// bursts.cuh).  Build with -fmad=false so that no multiply-add is
// contracted.

#include <cuda_runtime.h>
#include <stddef.h>

#include "bursts.cuh"
#include "stream.cuh"

#define TILE_X 8
#define TILE_Y 64
#define TILE_Z 128
// epoch_full_kernel: warps (strips of 32 z) per block, y rows per stage,
// stages per warp's ring
#define EPOCH_WARPS 4
#define EPOCH_CY 16
#define EPOCH_STAGES 4

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

// Full (nx, ny, nz) grid -> out (nx, nz).  A block is EPOCH_WARPS warps, each
// with its own strip of 32 z columns and its own ring; blockIdx.x =
// x * blocks per row + block along z.  The lane owns column z0 + lane.
__global__ void __launch_bounds__(EPOCH_WARPS * 32)
epoch_full_kernel(const float* __restrict__ base,
                  const float* __restrict__ tss, float* __restrict__ out,
                  int nx, int ny, int nz, int blocks_z, float t, float off,
                  Bursts b) {
    __shared__ __align__(16) float
        ring[EPOCH_WARPS][EPOCH_STAGES * EPOCH_CY * STRIP_W];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int x = blockIdx.x / blocks_z;
    const int z0 = ((blockIdx.x % blocks_z) * EPOCH_WARPS + warp) * STRIP_W;
    if (z0 >= nz) return;             // no block-wide barrier follows
    const Strip strip = make_strip(base, x, ny, nz, z0, 0);
    // this lane's column of tss; lanes beyond nz see base = 0 and never
    // load through it
    const float* tss_col = tss + (size_t)x * ny * nz + z0 + lane;
    float acc = 0.0f;
    StripStream<EPOCH_CY, EPOCH_STAGES, false> stream(ring[warp], strip, lane,
                                                    32);
    stream.start();
    for (int c = 0; c < stream.n_chunks; ++c) {
        bool any;
        const float* stage = stream.acquire(c, any);
        if (!any) continue;
        float bv[EPOCH_CY], tv[EPOCH_CY];
#pragma unroll
        for (int k = 0; k < EPOCH_CY; ++k) bv[k] = stage[k * STRIP_W + lane];
        const float* p = tss_col + (size_t)c * EPOCH_CY * nz;
#pragma unroll
        for (int k = 0; k < EPOCH_CY; ++k) {
            tv[k] = 1.0f;
            if (bv[k] != 0.0f) tv[k] = p[(size_t)k * nz];
        }
#pragma unroll
        for (int k = 0; k < EPOCH_CY; ++k) {
            if (bv[k] != 0.0f) {
                const float chi = burst_chi(tv[k], t, off, b);
                acc = acc + bv[k] * chi * chi;
            }
        }
    }
    if (z0 + lane < nz) out[(size_t)x * nz + z0 + lane] = acc;
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
    const int strips = (nz + STRIP_W - 1) / STRIP_W;
    const int blocks_z = (strips + EPOCH_WARPS - 1) / EPOCH_WARPS;
    epoch_full_kernel<<<blocks_z * nx, EPOCH_WARPS * 32, 0,
                        (cudaStream_t)stream>>>(
        base, tss, out, nx, ny, nz, blocks_z, t, off, b);
    return (int)cudaGetLastError();
}

}  // extern "C"
