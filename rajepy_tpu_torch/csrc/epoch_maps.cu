// Per-epoch LOS-collapsed burst maps  sum_y base * chi(t - ts)^2  for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// rajepy_tpu_torch/ops/kernels.py.
//
// Replaces the three Pallas TPU kernels of rajepy_tpu/ops/pallas_kernels.py
// on the continuum main path:
//   epoch_tiles_kernel   <- epoch_base_map_tiles   (_epoch_tiles_kernel)
//   epoch_maps2_kernel   <- epoch_base_maps2_tiles (_epoch_tiles2_kernel)
//                           and the fold of its per-tile partials
//   epoch_full_kernel    <- epoch_base_map_pallas  (_epoch_base_kernel)
//
// The single-base tile kernel (epoch_tiles_kernel).  One thread owns one
// (tile, x, z) column and loops over the tile's 64 y cells, summing
// base * chi^2 in a register; a block is (128 z, 8 x) threads, one block per
// tile, and the host folds the (8, 128) partials into the map.
//
// The dual-base tile kernel (epoch_maps2_kernel), the one the pipeline runs.
// What bounds it: bytes.  Both bases are read whole (8 bytes a cell), the
// packed launch time only where a base is non-zero (the jet fills ~18% of
// the flagship's tiles), the two maps written once; chi costs one expf per
// burst of the cell's side at those cells only, far under the bytes' time.
// The design:
//   * work item = one x row of one (x, z) tile position: a block walks the
//     position's tiles itself, through the host-made permutation
//     (order, seg_start) of ops/kernels.py:segment_order, so no per-tile
//     partials, no zero-filled buffer, no index_add_ and no permute copy
//     exist, and the block writes its row of both maps once (zeros where the
//     position holds no tile);
//   * a block is (128 z lanes, 4 y groups): a warp reads 128 contiguous
//     bytes per row, thread (z, g) takes y = 16 g .. 16 g + 15 of every tile
//     of the position, tile after tile, eight rows of both bases loaded
//     together (16 loads in flight a thread), then the launch times of the
//     rows that hold a non-zero base, then chi;
//   * the four y groups' sums meet in shared memory and group 0 adds them in
//     a fixed order: no atomics, the same bits on every run;
//   * the flagship's 64 tiles give ~256 busy rows among 2,048, so the grid is
//     persistent (two blocks an SM, each taking every gridDim-th row): an
//     empty row costs a few instructions, not a block.
// A cell with both bases 0 adds exactly 0 whatever its launch time (tss is
// finite), so skipping it is exact.
//
// The full-grid kernel.  It runs when no tile is active, so its base cube
// is zero everywhere or nearly so, and a cell with base = 0 adds exactly 0
// whatever its launch time (tss is finite everywhere).  So the kernel reads
// base whole and everything else only where base != 0.  What bounds it: the
// bytes of base.  The design (stream.cuh): a warp owns a strip of 32 z
// columns of one x, base arrives 16 y rows at a time through a warp-private
// ring of 4 shared-memory stages filled by asynchronous copies, a chunk
// that is all zero costs one shared-memory pass and a warp vote, and in any
// other chunk only lanes with base != 0 load tss (all of a chunk's loads
// started before the first chi) and add base * chi^2, in y order, in a
// register.  Grids with nz % 4 != 0, unaligned cubes and the ragged last
// strip take 4-byte asynchronous copies into the same ring.  A wholly jet
// cube skips nothing and is bound by the instruction rate of chi.
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
// epoch_maps2_kernel: y groups of a block, y rows of a tile per group, rows
// whose loads are started together
#define K2_GROUPS 4
#define K2_ROWS (TILE_Y / K2_GROUPS)
#define K2_BATCH 8

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

// Dual-base maps: out_a = sum_y a * chi^2, out_b = sum_y b * chi^2, both
// (nx, nz).  Item = (tile position s, x row xr), position s = (x tile,
// z tile) = (s / n_zt, s % n_zt) holding tiles order[seg_start[s]] ..
// order[seg_start[s + 1] - 1]; block b takes items b, b + gridDim.x, ...
__global__ void __launch_bounds__(TILE_Z * K2_GROUPS, 2)
epoch_maps2_kernel(const float* __restrict__ base_a,
                   const float* __restrict__ base_b,
                   const float* __restrict__ tss,
                   const int* __restrict__ order,
                   const int* __restrict__ seg_start,
                   float* __restrict__ out_a, float* __restrict__ out_b,
                   int n_zt, int nx, int nz, int n_items, float t, float off,
                   Bursts b) {
    __shared__ float part[2][K2_GROUPS][TILE_Z];
    const int z = threadIdx.x;
    const int g = threadIdx.y;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int s = item / TILE_X;
        const int xr = item % TILE_X;
        const int x = (s / n_zt) * TILE_X + xr;
        if (x >= nx) continue;            // a padding row of the last x tile
        const int zo = (s % n_zt) * TILE_Z + z;
        const size_t o = (size_t)x * nz + zo;
        const int first = seg_start[s];
        const int last = seg_start[s + 1];
        if (first == last) {              // no tile: exact zeros
            if (g == 0 && zo < nz) {
                out_a[o] = 0.0f;
                out_b[o] = 0.0f;
            }
            continue;
        }
        float acc_a = 0.0f;
        float acc_b = 0.0f;
        for (int k = first; k < last; ++k) {
            const size_t col = (size_t)order[k] * (TILE_X * TILE_Y * TILE_Z) +
                               (size_t)xr * (TILE_Y * TILE_Z) +
                               (size_t)(g * K2_ROWS) * TILE_Z + z;
            for (int y0 = 0; y0 < K2_ROWS; y0 += K2_BATCH) {
                float av[K2_BATCH], bv[K2_BATCH], tv[K2_BATCH];
#pragma unroll
                for (int j = 0; j < K2_BATCH; ++j) {
                    const size_t i = col + (size_t)(y0 + j) * TILE_Z;
                    av[j] = base_a[i];
                    bv[j] = base_b[i];
                }
#pragma unroll
                for (int j = 0; j < K2_BATCH; ++j) {
                    tv[j] = 1.0f;
                    if (av[j] != 0.0f || bv[j] != 0.0f)
                        tv[j] = tss[col + (size_t)(y0 + j) * TILE_Z];
                }
#pragma unroll
                for (int j = 0; j < K2_BATCH; ++j) {
                    if (av[j] != 0.0f || bv[j] != 0.0f) {
                        const float chi = burst_chi(tv[j], t, off, b);
                        const float chi2 = chi * chi;
                        acc_a = acc_a + av[j] * chi2;
                        acc_b = acc_b + bv[j] * chi2;
                    }
                }
            }
        }
        part[0][g][z] = acc_a;
        part[1][g][z] = acc_b;
        __syncthreads();
        if (g == 0 && zo < nz) {
            float sa = part[0][0][z];
            float sb = part[1][0][z];
#pragma unroll
            for (int h = 1; h < K2_GROUPS; ++h) {
                sa = sa + part[0][h][z];
                sb = sb + part[1][h][z];
            }
            out_a[o] = sa;
            out_b[o] = sb;
        }
        __syncthreads();                  // part is reused by the next item
    }
}

// burst_chi alone, one cell a thread: out[i] = chi(tss[i]).  Built so that
// the instructions chi issues per cell can be read from the library's SASS
// (chip_smoke.py); not on any model path.
__global__ void burst_chi_probe_kernel(const float* __restrict__ tss,
                                       float* __restrict__ out, int n,
                                       float t, float off, Bursts b) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = burst_chi(tss[i], t, off, b);
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
// synchronise, and returns cudaGetLastError() (0 on success).  The burst
// list comes by pointer (a host struct, copied into the launch's parameters)
// because passing 1 KB by value through ctypes costs host time per call.
extern "C" {

int epoch_tiles(const float* base, const float* tss, float* out, int n_act,
                float t, float off, const Bursts* b, void* stream) {
    const dim3 block(TILE_Z, TILE_X);
    epoch_tiles_kernel<<<n_act, block, 0, (cudaStream_t)stream>>>(
        base, tss, out, t, off, *b);
    return (int)cudaGetLastError();
}

int epoch_maps2(const float* base_a, const float* base_b, const float* tss,
                const int* order, const int* seg_start, float* out_a,
                float* out_b, int n_xt, int n_zt, int nx, int nz, float t,
                float off, const Bursts* b, void* stream) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int n_items = n_xt * n_zt * TILE_X;
    const int blocks = n_items < 2 * sms ? n_items : 2 * sms;
    const dim3 block(TILE_Z, K2_GROUPS);
    epoch_maps2_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
        base_a, base_b, tss, order, seg_start, out_a, out_b, n_zt, nx, nz,
        n_items, t, off, *b);
    return (int)cudaGetLastError();
}

int burst_chi_probe(const float* tss, float* out, int n, float t, float off,
                    const Bursts* b, void* stream) {
    burst_chi_probe_kernel<<<(n + 255) / 256, 256, 0,
                             (cudaStream_t)stream>>>(tss, out, n, t, off,
                                                     *b);
    return (int)cudaGetLastError();
}

int epoch_full(const float* base, const float* tss, float* out, int nx,
               int ny, int nz, float t, float off, const Bursts* b,
               void* stream) {
    const int strips = (nz + STRIP_W - 1) / STRIP_W;
    const int blocks_z = (strips + EPOCH_WARPS - 1) / EPOCH_WARPS;
    epoch_full_kernel<<<blocks_z * nx, EPOCH_WARPS * 32, 0,
                        (cudaStream_t)stream>>>(
        base, tss, out, nx, ny, nz, blocks_z, t, off, *b);
    return (int)cudaGetLastError();
}

}  // extern "C"
