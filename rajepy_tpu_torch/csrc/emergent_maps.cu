// Ordered emergent free-free scans along the line of sight for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// rajepy_tpu_torch/ops/kernels.py.
//
// Each (x, z) column is walked from the observer's end, carrying the
// optical depth tau in front of the current cell:
//   I += S e^{-tau} (1 - e^{-d}),   then   tau += d,
// and the column's I and total tau are written once at the end.
//
// Replaces the three Pallas TPU kernels of rajepy_tpu/ops/pallas_kernels.py
// on the emergent path:
//   transfer_scan_kernel  <- transfer_scan_pallas (_scan_kernel): given
//                            source and opacity cubes, one channel;
//   emergent_full_kernel  <- emergent_ff_pallas (_emergent_kernel): the
//                            full (nx, ny, nz) grid, every channel from one
//                            frequency-independent opacity base,
//                            d = scale[c] * base,
//                            S = cnu[c] / expm1(hnuk[c] / T);
//   emergent_tiles_kernel <- emergent_ff_tiles (_emergent_tiles_kernel):
//                            the same over compacted (8, 64, 128) tiles in
//                            observer order, base = a * chi^2 with the
//                            burst factor chi evaluated per cell
//                            (bursts.cuh), tau carried across a segment's
//                            tiles.
//
// The ordering trap.  The TPU kernels carry tau across sequential grid
// steps in VMEM scratch (y chunks, or a segment's consecutive tiles) and
// form the in-chunk exclusive prefix with a triangular matmul at
// Precision.HIGHEST, because Mosaic has no cumsum.  Blocks of a GPU run in
// no order, so here one thread owns one (x, z) column (of the grid, or of a
// segment) for its channels and walks all of its cells in order in
// registers: the carry is a register, the prefix is exact float32
// sequential addition, and nothing depends on block order.  No atomics.
//
// What bounds them.  transfer_scan_kernel reads two floats per cell and
// does ~9 operations (two transcendentals): bytes.  emergent_full_kernel
// reads base at every cell but temp only where base != 0 (jet cells are a
// few in a thousand of the grid, none of a jet-free one), and does ~13
// operations per jet cell and channel: the bytes of base, read once for up
// to 64 channels.  emergent_tiles_kernel reads its three tile cubes (about
// 50 MB at the 512^3 flagship) once per block of channels, mostly from the
// 50 MB L2, and spends 7 + 8 per burst operations per jet cell on chi plus
// ~13 per channel; the flagship's few tens of segments give only n_seg x
// 1,024 columns, so it is latency-bound by its grid:
//   * emergent_full_kernel (stream.cuh): a block owns a strip of 32 z
//     columns of one x and up to 64 channels, one warp per group of 4
//     channels.  base arrives 64 y rows at a time through a ring of 4
//     shared-memory stages that the block's warps fill together by
//     asynchronous copies and all read, so one read of base serves every
//     channel group and a thread carries 4 channels' constants and sums,
//     not 16.  Whether a chunk holds any non-zero value is voted in the
//     ring's barrier, each thread looking at the part it copied; if none,
//     the chunk is done, else only lanes with base != 0 load temp and
//     update their channels.  Beyond 64 channels blockIdx.y walks the
//     channel blocks, each reading base again.  Grids with nz % 4 != 0,
//     unaligned cubes and the ragged last strip take 4-byte asynchronous
//     copies into the same ring;
//   * on tiles channels ride 4 to a thread and one launch dimension walks
//     the channel blocks, as the RRL kernels;
//   * cells with base = 0 (a = 0 on tiles) are skipped before temp (and
//     tss) are loaded: they neither emit nor attenuate, exactly as the TPU
//     kernel's skip of zero-opacity y chunks.  The skip also keeps the
//     T = 1 fill of empty cells, whose source may overflow expm1f to inf,
//     out of the arithmetic;
//   * the tile kernel's blocks are (128 z, 2 x) threads
//     (transfer_scan_kernel (128 z, 8 x)), so a warp reads 32 neighbouring
//     z addresses per y step; the ragged edges of the grid are masked, not
//     padded;
//   * transfer_scan_kernel and emergent_full_kernel walk y downwards when
//     the observer sits at +y, so no flipped copy of a cube is made.
//
// Numerics follow the Pallas bodies' float32 operation order; build with
// -fmad=false so that no multiply-add is contracted.  1 - e^{-d} is
// -expm1f(-d) and the Planck denominator expm1f(hnuk / T): the TPU's Taylor
// substitutes exist only because Mosaic has no expm1.

#include <cuda_runtime.h>
#include <stddef.h>

#include "bursts.cuh"
#include "stream.cuh"

#define TILE_X 8
#define TILE_Y 64
#define TILE_Z 128
#define BLOCK_Z 128
#define BLOCK_X 2
#define SCAN_BLOCK_X 8
#define CPT_FULL 4    // channels per thread (one warp's group), full grid
#define GROUP_FULL 64 // channels per block of emergent_full_kernel
#define EM_CY 64      // y rows per stage of its ring
#define EM_STAGES 4   // stages of its ring (32 KB in all)
#define EM_SUB 4      // rows whose temp loads are started together
#define CPT_TILES 4   // channels per thread, emergent_tiles_kernel

// Per-channel constants of channels c0 .. c0 + nc - 1 into registers, and
// the running sums cleared.
template <int CPT>
__device__ __forceinline__ void load_channels(
        const float* __restrict__ cnu, const float* __restrict__ hnuk,
        const float* __restrict__ scale, int c0, int nc, float cn[CPT],
        float hk[CPT], float sc[CPT], float inten[CPT], float tau[CPT]) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        cn[j] = j < nc ? cnu[c0 + j] : 0.0f;
        hk[j] = j < nc ? hnuk[c0 + j] : 1.0f;
        sc[j] = j < nc ? scale[c0 + j] : 0.0f;
        inten[j] = 0.0f;
        tau[j] = 0.0f;
    }
}

// One cell of the ordered scan, for CPT channels: opacity d = base * sc,
// source S = cn / expm1f(hk / temp).
template <int CPT>
__device__ __forceinline__ void scan_cell(float base, float temp, int nc,
                                          const float cn[CPT],
                                          const float hk[CPT],
                                          const float sc[CPT],
                                          float inten[CPT], float tau[CPT]) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        if (j < nc) {
            const float d = base * sc[j];
            const float emit = (cn[j] / expm1f(hk[j] / temp)) * -expm1f(-d);
            inten[j] = inten[j] + emit * expf(-tau[j]);
            tau[j] = tau[j] + d;
        }
    }
}

// Given source and opacity cubes (nx, ny, nz) -> I and total tau (nx, nz).
__global__ void __launch_bounds__(BLOCK_Z * SCAN_BLOCK_X)
transfer_scan_kernel(const float* __restrict__ src,
                     const float* __restrict__ dtau,
                     float* __restrict__ out_i, float* __restrict__ out_tau,
                     int nx, int ny, int nz, int near_y0) {
    const int z = blockIdx.x * BLOCK_Z + threadIdx.x;
    const int x = blockIdx.y * SCAN_BLOCK_X + threadIdx.y;
    if (x >= nx || z >= nz) return;
    const size_t col = (size_t)x * ny * nz + z;
    float inten = 0.0f;
    float tau = 0.0f;
    for (int k = 0; k < ny; ++k) {
        const int y = near_y0 ? k : ny - 1 - k;
        const size_t i = col + (size_t)y * nz;
        const float d = dtau[i];
        inten = inten + src[i] * expf(-tau) * -expm1f(-d);
        tau = tau + d;
    }
    out_i[(size_t)x * nz + z] = inten;
    out_tau[(size_t)x * nz + z] = tau;
}

// Full grid: temp and base (nx, ny, nz) -> I and total tau (n_chan, nx, nz).
// A block is (32 z lanes, warps) threads: blockIdx.x = x * strips + strip of
// 32 z columns, blockIdx.y = block of GROUP_FULL channels, warp w takes
// channels c0 + 4 w .. of it.  A warp whose group lies beyond n_chan still
// copies and synchronises with the block, and does nothing else.
__global__ void __launch_bounds__(GROUP_FULL / CPT_FULL * 32)
emergent_full_kernel(const float* __restrict__ cnu,
                     const float* __restrict__ hnuk,
                     const float* __restrict__ scale,
                     const float* __restrict__ temp,
                     const float* __restrict__ base,
                     float* __restrict__ out_i, float* __restrict__ out_tau,
                     int nx, int ny, int nz, int strips, int n_chan,
                     int near_y0) {
    __shared__ __align__(16) float ring[EM_STAGES * EM_CY * STRIP_W];
    const int lane = threadIdx.x;
    const int x = blockIdx.x / strips;
    const int z0 = (blockIdx.x % strips) * STRIP_W;
    const int c0 = blockIdx.y * GROUP_FULL + threadIdx.y * CPT_FULL;
    const int nc = max(0, min(CPT_FULL, n_chan - c0));
    float cn[CPT_FULL], hk[CPT_FULL], sc[CPT_FULL];
    float inten[CPT_FULL], tau[CPT_FULL];
    load_channels<CPT_FULL>(cnu, hnuk, scale, c0, nc, cn, hk, sc, inten,
                            tau);
    const Strip strip = make_strip(base, x, ny, nz, z0, !near_y0);
    // this lane's column of temp; lanes beyond nz see base = 0 and never
    // load through it
    const float* temp_col = temp + (size_t)x * ny * nz + z0 + lane;
    StripStream<EM_CY, EM_STAGES, true> stream(
        ring, strip, threadIdx.y * 32 + lane, blockDim.y * 32);
    stream.start();
    for (int c = 0; c < stream.n_chunks; ++c) {
        bool any;
        const float* stage = stream.acquire(c, any);
        if (nc == 0 || !any) continue;
        for (int k0 = 0; k0 < EM_CY; k0 += EM_SUB) {
            float bv[EM_SUB], tv[EM_SUB];
#pragma unroll
            for (int k = 0; k < EM_SUB; ++k)
                bv[k] = stage[(k0 + k) * STRIP_W + lane];
#pragma unroll
            for (int k = 0; k < EM_SUB; ++k) {
                tv[k] = 1.0f;
                if (bv[k] != 0.0f) {
                    const int step = c * EM_CY + k0 + k;
                    const int y = near_y0 ? step : ny - 1 - step;
                    tv[k] = temp_col[(size_t)y * nz];
                }
            }
#pragma unroll
            for (int k = 0; k < EM_SUB; ++k) {
                if (bv[k] != 0.0f)
                    scan_cell<CPT_FULL>(bv[k], tv[k], nc, cn, hk, sc, inten,
                                        tau);
            }
        }
    }
    if (z0 + lane >= nz) return;
    const size_t plane = (size_t)nx * nz;
    const size_t o = (size_t)c0 * plane + (size_t)x * nz + z0 + lane;
#pragma unroll
    for (int j = 0; j < CPT_FULL; ++j) {
        if (j < nc) {
            out_i[o + (size_t)j * plane] = inten[j];
            out_tau[o + (size_t)j * plane] = tau[j];
        }
    }
}

// Compacted observer-ordered tiles (n_act, 8, 64, 128), a segment's tiles
// consecutive and in LOS order, tiles seg_start[s] .. seg_start[s+1] - 1
// forming segment s -> per-segment I and total tau
// (n_seg, n_chan, 8, 128).  blockIdx.x = segment * (TILE_X / BLOCK_X) +
// x-quarter, blockIdx.y = channel block of CPT_TILES.
__global__ void __launch_bounds__(BLOCK_Z * BLOCK_X)
emergent_tiles_kernel(const float* __restrict__ cnu,
                      const float* __restrict__ hnuk,
                      const float* __restrict__ scale,
                      const float* __restrict__ temp,
                      const float* __restrict__ a,
                      const float* __restrict__ tss,
                      const int* __restrict__ seg_start,
                      float* __restrict__ out_i,
                      float* __restrict__ out_tau, int n_chan, float t,
                      float off, Bursts b) {
    const int z = threadIdx.x;
    const int per_seg = TILE_X / BLOCK_X;
    const int s = blockIdx.x / per_seg;
    const int x = (blockIdx.x % per_seg) * BLOCK_X + threadIdx.y;
    const int c0 = blockIdx.y * CPT_TILES;
    const int nc = min(CPT_TILES, n_chan - c0);
    float cn[CPT_TILES], hk[CPT_TILES], sc[CPT_TILES];
    float inten[CPT_TILES], tau[CPT_TILES];
    load_channels<CPT_TILES>(cnu, hnuk, scale, c0, nc, cn, hk, sc, inten,
                             tau);
    const int first = seg_start[s];
    const int last = seg_start[s + 1];
    for (int tile = first; tile < last; ++tile) {
        const size_t col = (size_t)tile * (TILE_X * TILE_Y * TILE_Z) +
                           (size_t)x * (TILE_Y * TILE_Z) + z;
        for (int y = 0; y < TILE_Y; ++y) {
            const size_t i = col + (size_t)y * TILE_Z;
            const float av = a[i];
            if (av == 0.0f) continue;
            const float chi = burst_chi(tss[i], t, off, b);
            scan_cell<CPT_TILES>(av * chi * chi, temp[i], nc, cn, hk, sc,
                                 inten, tau);
        }
    }
    const size_t o = ((size_t)s * n_chan + c0) * (TILE_X * TILE_Z) +
                     (size_t)x * TILE_Z + z;
#pragma unroll
    for (int j = 0; j < CPT_TILES; ++j) {
        if (j < nc) {
            out_i[o + (size_t)j * (TILE_X * TILE_Z)] = inten[j];
            out_tau[o + (size_t)j * (TILE_X * TILE_Z)] = tau[j];
        }
    }
}

// Host entry points.  Each launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" {

int transfer_scan(const float* src, const float* dtau, float* out_i,
                  float* out_tau, int nx, int ny, int nz, int near_y0,
                  void* stream) {
    const dim3 block(BLOCK_Z, SCAN_BLOCK_X);
    const dim3 grid((nz + BLOCK_Z - 1) / BLOCK_Z,
                    (nx + SCAN_BLOCK_X - 1) / SCAN_BLOCK_X);
    transfer_scan_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        src, dtau, out_i, out_tau, nx, ny, nz, near_y0);
    return (int)cudaGetLastError();
}

int emergent_full(const float* cnu, const float* hnuk, const float* scale,
                  const float* temp, const float* base, float* out_i,
                  float* out_tau, int nx, int ny, int nz, int n_chan,
                  int near_y0, void* stream) {
    const int strips = (nz + STRIP_W - 1) / STRIP_W;
    const int in_block = n_chan < GROUP_FULL ? n_chan : GROUP_FULL;
    const dim3 block(32, (in_block + CPT_FULL - 1) / CPT_FULL);
    const dim3 grid(strips * nx, (n_chan + GROUP_FULL - 1) / GROUP_FULL);
    emergent_full_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        cnu, hnuk, scale, temp, base, out_i, out_tau, nx, ny, nz, strips,
        n_chan, near_y0);
    return (int)cudaGetLastError();
}

int emergent_tiles(const float* cnu, const float* hnuk, const float* scale,
                   const float* temp, const float* a, const float* tss,
                   const int* seg_start, float* out_i, float* out_tau,
                   int n_seg, int n_chan, float t, float off, Bursts b,
                   void* stream) {
    const dim3 block(BLOCK_Z, BLOCK_X);
    const dim3 grid(n_seg * (TILE_X / BLOCK_X),
                    (n_chan + CPT_TILES - 1) / CPT_TILES);
    emergent_tiles_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        cnu, hnuk, scale, temp, a, tss, seg_start, out_i, out_tau, n_chan,
        t, off, b);
    return (int)cudaGetLastError();
}

}  // extern "C"
