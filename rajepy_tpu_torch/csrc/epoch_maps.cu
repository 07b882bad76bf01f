// Per-epoch LOS-collapsed burst maps  sum_y base * chi(t - ts)^2  for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// rajepy_tpu_torch/ops/kernels.py.
//
// Replaces the three Pallas TPU kernels of rajepy_tpu/ops/pallas_kernels.py
// on the continuum main path:
//   epoch_maps_kernel<1> <- epoch_base_map_tiles   (_epoch_tiles_kernel)
//   epoch_maps_kernel<2> <- epoch_base_maps2_tiles (_epoch_tiles2_kernel)
//                           and the fold of their per-tile partials
//   epoch_full_kernel    <- epoch_base_map_pallas  (_epoch_base_kernel)
//
// The tile kernel, templated on the number of bases NB (1: the single-base
// map of flux_ff, emission_measure and the RRL continuum; 2: both maps of
// continuum_rt_products, the one the pipeline runs).  What bounds it:
// bytes.  The bases are read whole (4 NB bytes a cell), the packed launch
// time only where a base is non-zero (the jet fills ~18% of the flagship's
// tiles), the maps written once; chi costs one expf per burst of the
// cell's side at those cells only, far under the bytes' time.  The design:
//   * work item = one x row of one (x, z) tile position: a block walks the
//     position's tiles itself, through the host-made permutation
//     (order, seg_start) of ops/kernels.py:segment_order, so no per-tile
//     partials, no zero-filled buffer, no index_add_ and no permute copy
//     exist, and the block writes its row of each map once (zeros where
//     the position holds no tile);
//   * a block is (128 z lanes, 4 y groups): a warp reads 128 contiguous
//     bytes per row, thread (z, g) takes y = 16 g .. 16 g + 15 of every tile
//     of the position, tile after tile, a batch of rows of every base
//     loaded together, then the launch times of the rows that hold a
//     non-zero base, then chi;
//   * the four y groups' sums meet in shared memory and group 0 adds them in
//     a fixed order: no atomics, the same bits on every run;
//   * the flagship's 64 tiles give ~256 busy rows among 2,048, so the grid is
//     persistent (two blocks an SM, each taking every gridDim-th row): an
//     empty row costs a few instructions, not a block.
// A cell whose bases are all 0 adds exactly 0 whatever its launch time (tss
// is finite), so skipping it is exact; a zero base beside a non-zero one
// adds +0.  So each map of NB = 2 equals the NB = 1 map of its base bit for
// bit: one summation order serves both.
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
// epoch_maps_kernel: y groups of a block, y rows of a tile per group, rows
// whose loads are started together (per number of bases; 16 rows for one
// base measured no faster than 8 on an H100)
#define MAPS_GROUPS 4
#define MAPS_ROWS (TILE_Y / MAPS_GROUPS)
#define MAPS_BATCH1 8
#define MAPS_BATCH2 8

// NB maps out[j] = sum_y base[j] * chi^2, each (nx, nz).  Item = (tile
// position s, x row xr), position s = (x tile, z tile) = (s / n_zt,
// s % n_zt) holding tiles order[seg_start[s]] .. order[seg_start[s + 1] - 1];
// block b takes items b, b + gridDim.x, ...
template <int NB>
__global__ void __launch_bounds__(TILE_Z * MAPS_GROUPS, 2)
epoch_maps_kernel(const float* __restrict__ base_a,
                  const float* __restrict__ base_b,
                  const float* __restrict__ tss,
                  const int* __restrict__ order,
                  const int* __restrict__ seg_start,
                  float* __restrict__ out_a, float* __restrict__ out_b,
                  int n_zt, int nx, int nz, int n_items, float t, float off,
                  Bursts b) {
    constexpr int BATCH = NB == 1 ? MAPS_BATCH1 : MAPS_BATCH2;
    const float* const base[2] = {base_a, base_b};
    float* const out[2] = {out_a, out_b};
    __shared__ float part[NB][MAPS_GROUPS][TILE_Z];
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
#pragma unroll
                for (int j = 0; j < NB; ++j) out[j][o] = 0.0f;
            }
            continue;
        }
        float acc[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[j] = 0.0f;
        for (int k = first; k < last; ++k) {
            const size_t col = (size_t)order[k] * (TILE_X * TILE_Y * TILE_Z) +
                               (size_t)xr * (TILE_Y * TILE_Z) +
                               (size_t)(g * MAPS_ROWS) * TILE_Z + z;
            for (int y0 = 0; y0 < MAPS_ROWS; y0 += BATCH) {
                float bv[BATCH][NB], tv[BATCH];
                bool live[BATCH];
#pragma unroll
                for (int r = 0; r < BATCH; ++r) {
                    const size_t i = col + (size_t)(y0 + r) * TILE_Z;
#pragma unroll
                    for (int j = 0; j < NB; ++j) bv[r][j] = base[j][i];
                }
#pragma unroll
                for (int r = 0; r < BATCH; ++r) {
                    live[r] = false;
#pragma unroll
                    for (int j = 0; j < NB; ++j)
                        live[r] = live[r] || bv[r][j] != 0.0f;
                    tv[r] = 1.0f;
                    if (live[r]) tv[r] = tss[col + (size_t)(y0 + r) * TILE_Z];
                }
#pragma unroll
                for (int r = 0; r < BATCH; ++r) {
                    if (live[r]) {
                        const float chi = burst_chi(tv[r], t, off, b);
                        const float chi2 = chi * chi;
#pragma unroll
                        for (int j = 0; j < NB; ++j)
                            acc[j] = acc[j] + bv[r][j] * chi2;
                    }
                }
            }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) part[j][g][z] = acc[j];
        __syncthreads();
        if (g == 0 && zo < nz) {
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                float sum = part[j][0][z];
#pragma unroll
                for (int h = 1; h < MAPS_GROUPS; ++h) sum = sum + part[j][h][z];
                out[j][o] = sum;
            }
        }
        __syncthreads();                  // part is reused by the next item
    }
}

// Both instantiations, each its own entry in ptxas's report.
template __global__ void epoch_maps_kernel<1>(
    const float*, const float*, const float*, const int*, const int*, float*,
    float*, int, int, int, int, float, float, Bursts);
template __global__ void epoch_maps_kernel<2>(
    const float*, const float*, const float*, const int*, const int*, float*,
    float*, int, int, int, int, float, float, Bursts);

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

// One launch of epoch_maps_kernel<NB> over every x row of every tile
// position: a persistent grid of at most two blocks an SM.
template <int NB>
static int launch_epoch_maps(const float* base_a, const float* base_b,
                             const float* tss, const int* order,
                             const int* seg_start, float* out_a,
                             float* out_b, int n_xt, int n_zt, int nx, int nz,
                             float t, float off, const Bursts* b,
                             void* stream) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int n_items = n_xt * n_zt * TILE_X;
    const int blocks = n_items < 2 * sms ? n_items : 2 * sms;
    const dim3 block(TILE_Z, MAPS_GROUPS);
    epoch_maps_kernel<NB><<<blocks, block, 0, (cudaStream_t)stream>>>(
        base_a, base_b, tss, order, seg_start, out_a, out_b, n_zt, nx, nz,
        n_items, t, off, *b);
    return (int)cudaGetLastError();
}

// Host entry points.  Each launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).  The burst
// list comes by pointer (a host struct, copied into the launch's parameters)
// because passing 1 KB by value through ctypes costs host time per call.
extern "C" {

int epoch_maps1(const float* base, const float* tss, const int* order,
                const int* seg_start, float* out, int n_xt, int n_zt, int nx,
                int nz, float t, float off, const Bursts* b, void* stream) {
    return launch_epoch_maps<1>(base, nullptr, tss, order, seg_start, out,
                                nullptr, n_xt, n_zt, nx, nz, t, off, b,
                                stream);
}

int epoch_maps2(const float* base_a, const float* base_b, const float* tss,
                const int* order, const int* seg_start, float* out_a,
                float* out_b, int n_xt, int n_zt, int nx, int nz, float t,
                float off, const Bursts* b, void* stream) {
    return launch_epoch_maps<2>(base_a, base_b, tss, order, seg_start, out_a,
                                out_b, n_xt, n_zt, nx, nz, t, off, b, stream);
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
