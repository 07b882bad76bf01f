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
// The tile kernel splits a column's walk into chunks and folds the chunks'
// (I, tau) in observer order in a fixed order, so its sums are taken in
// another order than a plain loop's, but the same on every run.
//
// What bounds them.  transfer_scan_kernel reads two floats per cell and
// does ~9 operations (two transcendentals): bytes.  emergent_full_kernel
// reads base at every cell but temp only where base != 0 (jet cells are a
// few in a thousand of the grid, none of a jet-free one), and does ~13
// operations per jet cell and channel: the bytes of base, read once for up
// to 64 channels.  emergent_tiles_kernel reads a whole (about 16 MB at the
// 512^3 flagship) and tss and temp at the jet cells; per jet cell and
// channel it does two divisions, two expm1f and an expf, so the special
// function units (MUFU, 16 a clock per SM) weigh about as much as the bytes.
// The designs:
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
//   * emergent_tiles_kernel: a block owns a strip of 32 z columns of one x
//     row of one segment, and 16 warps.  For each of the segment's tiles in
//     observer order, the 512 threads first read the strip's 64 x 32 cells
//     of a (a warp four rows, 128 contiguous bytes a row), load tss and temp
//     where a != 0, and write each column's jet cells, compacted in y order,
//     into shared memory as base = a chi^2 and 1 / T: chi is evaluated once
//     a cell for every channel, and the next tile's a is loaded while the
//     channels run.  Then the warps are G channel groups of 4 channels
//     times K = 16 / G chunks (G = 4, K = 4 at 16 channels): chunk k of a
//     column takes the k-th quarter (K-th part) of that column's jet cells,
//     so the chunks carry equal work wherever the jet lies in y, and scans
//     them for its 4 channels from the chunk's own start, giving
//     (I_k, tau_k).  The chunk-0 warps fold the chunks into the column's
//     running (I, tau) in observer order, I += I_k e^{-tau}, tau += tau_k,
//     in registers across the segment's tiles.  The grid is n_seg x 8 x 4
//     blocks (1,024 at the flagship) whatever the channel count; beyond
//     16 G channels blockIdx.y walks channel blocks.  The fold is
//     associative, so a segment of any length is walked tile by tile; no
//     atomics, the same bits on every run.  Per jet cell and channel the
//     scan is ~20 instructions and 2 MUFU (tile_cell); a strip whose tile
//     holds no jet cell is dropped after a block vote;
//   * cells with base = 0 (a = 0 on tiles) are skipped before temp (and
//     tss) are loaded: they neither emit nor attenuate, exactly as the TPU
//     kernel's skip of zero-opacity y chunks.  The skip also keeps the
//     T = 1 fill of empty cells, whose source may overflow expm1f to inf,
//     out of the arithmetic;
//   * transfer_scan_kernel's blocks are (128 z, 8 x) threads, so a warp
//     reads 32 neighbouring z addresses per y step; the ragged edges of the
//     grid are masked, not padded;
//   * transfer_scan_kernel and emergent_full_kernel walk y downwards when
//     the observer sits at +y, so no flipped copy of a cube is made.
//
// Numerics follow the Pallas bodies' float32 operation order; build with
// -fmad=false so that no multiply-add is contracted.  The tile kernel
// alone departs from it where that is cheap and harmless (tile_cell: 1 / T
// once a cell, series for small arguments, MUFU reciprocals and
// exponentials), moving its maps by ~1e-7 relative.  1 - e^{-d} is
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
#define SCAN_BLOCK_X 8
#define CPT_FULL 4    // channels per thread (one warp's group), full grid
#define GROUP_FULL 64 // channels per block of emergent_full_kernel
#define EM_CY 64      // y rows per stage of its ring
#define EM_STAGES 4   // stages of its ring (32 KB in all)
#define EM_SUB 4      // rows whose temp loads are started together
#define CPT_TILES 4   // channels per thread, emergent_tiles_kernel
#define TW 32         // z columns of its block
#define T_LOG2 4      // log2 of the warps of its block
#define TWARPS (1 << T_LOG2)   // G channel groups x K chunks
#define T_STRIPS (TILE_Z / TW)
#define T_CELLS (TILE_Y / TWARPS)   // y cells of a column a thread prepares
#define SERIES_CUT 0.05f             // below it expm1 by its 4-term series

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

// 1 / v and 2^v by the special function unit alone (rcp.approx.ftz,
// ex2.approx.ftz: about 1 and 2 ulp, denormals flushed to 0).
__device__ __forceinline__ float mufu_rcp(float v) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}

__device__ __forceinline__ float mufu_ex2(float v) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}

#define LOG2E 1.4426950408889634f

// One jet cell of the tile kernel for CPT channels: opacity d = base * sc,
// Planck argument x = hk * inv_t, source S = cn / expm1(x).  Where every
// channel's x (or d) lies below SERIES_CUT, expm1 is its first four terms
// (truncation x^4 / 120 relative, under 6e-8, 4 multiply-adds against
// expm1f's ~20 instructions); the division is a MUFU reciprocal and the
// attenuation e^{-tau} a MUFU exponential (a few ulp; it flushes to 0 below
// 2^-126, where a cell's weight is nil).  These move a map by ~1e-7
// relative, far inside the 1e-5 it is held to.
template <int CPT>
__device__ __forceinline__ void tile_cell(float base, float inv_t,
                                          const float cn[CPT],
                                          const float hk[CPT],
                                          const float sc[CPT],
                                          float inten[CPT], float tau[CPT]) {
    float d[CPT], x[CPT], em1[CPT], stim[CPT];
    bool small_x = true, small_d = true;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        d[j] = base * sc[j];
        x[j] = hk[j] * inv_t;
        small_x = small_x && x[j] < SERIES_CUT;
        small_d = small_d && d[j] < SERIES_CUT;
    }
    if (small_x) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            em1[j] = x[j] * fmaf(x[j], fmaf(x[j], fmaf(x[j], 1.0f / 24.0f,
                                                       1.0f / 6.0f),
                                            0.5f),
                                 1.0f);
        }
    } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j) em1[j] = expm1f(x[j]);
    }
    if (small_d) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            stim[j] = d[j] * fmaf(d[j], fmaf(d[j], fmaf(d[j], -1.0f / 24.0f,
                                                       1.0f / 6.0f),
                                            -0.5f),
                                  1.0f);
        }
    } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j) stim[j] = -expm1f(-d[j]);
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        const float emit = cn[j] * mufu_rcp(em1[j]) * stim[j];
        inten[j] = inten[j] + emit * mufu_ex2(tau[j] * -LOG2E);
        tau[j] = tau[j] + d[j];
    }
}

// Compacted observer-ordered tiles (n_act, 8, 64, 128), a segment's tiles
// consecutive and in LOS order, tiles seg_start[s] .. seg_start[s+1] - 1
// forming segment s -> per-segment I and total tau (n_seg, n_chan, 8, 128).
// blockIdx.x = (segment * TILE_X + x row) * T_STRIPS + strip of TW z,
// blockIdx.y = channel block of CPT_TILES << groups_log2 channels.  Warp w
// prepares rows T_CELLS w .. T_CELLS w + T_CELLS - 1 of the strip, then is
// channel group w % G and chunk w / G of K = TWARPS / G chunks.
__global__ void __launch_bounds__(TWARPS * 32, 2)
emergent_tiles_kernel(const float* __restrict__ cnu,
                      const float* __restrict__ hnuk,
                      const float* __restrict__ scale,
                      const float* __restrict__ temp,
                      const float* __restrict__ a,
                      const float* __restrict__ tss,
                      const int* __restrict__ seg_start,
                      float* __restrict__ out_i,
                      float* __restrict__ out_tau, int n_chan,
                      int groups_log2, float t, float off, Bursts b) {
    // a column's jet cells of the current tile, compacted in y order
    __shared__ float s_base[TILE_Y][TW];
    __shared__ float s_inv_t[TILE_Y][TW];
    __shared__ int s_cnt[TWARPS][TW];
    __shared__ float s_part[2][TWARPS][CPT_TILES][TW];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int grp = warp & ((1 << groups_log2) - 1);
    const int chunk = warp >> groups_log2;
    const int chunks_log2 = T_LOG2 - groups_log2;
    const int s = blockIdx.x / (TILE_X * T_STRIPS);
    const int xr = (blockIdx.x / T_STRIPS) % TILE_X;
    const int z = (blockIdx.x % T_STRIPS) * TW + lane;
    const int c0 = (blockIdx.y << groups_log2) * CPT_TILES + grp * CPT_TILES;
    const int nc = max(0, min(CPT_TILES, n_chan - c0));
    float cn[CPT_TILES], hk[CPT_TILES], sc[CPT_TILES];
    float inten[CPT_TILES], tau[CPT_TILES];
    float run_i[CPT_TILES], run_tau[CPT_TILES];   // the column's (I, tau)
    load_channels<CPT_TILES>(cnu, hnuk, scale, c0, nc, cn, hk, sc, run_i,
                             run_tau);
    const int first = seg_start[s];
    const int last = seg_start[s + 1];
    // this thread's cells: rows T_CELLS warp + j of column lane
    const size_t col = (size_t)xr * (TILE_Y * TILE_Z) +
                       (size_t)(T_CELLS * warp) * TILE_Z + z;
    float av[T_CELLS];
    auto load_a = [&](int tl) {
#pragma unroll
        for (int j = 0; j < T_CELLS; ++j) {
            av[j] = a[(size_t)tl * (TILE_X * TILE_Y * TILE_Z) + col +
                      (size_t)j * TILE_Z];
        }
    };
    if (first < last) load_a(first);
    for (int tile = first; tile < last; ++tile) {
        // cells: tss and temp where a != 0, then each column's jet cells
        // compacted in y order with base = a chi^2 and 1 / T, computed
        // once for every channel
        float sv[T_CELLS], tv[T_CELLS];
        int cnt = 0;
        const size_t cell0 = (size_t)tile * (TILE_X * TILE_Y * TILE_Z) + col;
#pragma unroll
        for (int j = 0; j < T_CELLS; ++j) {
            sv[j] = 1.0f;
            tv[j] = 1.0f;
            if (av[j] != 0.0f) {
                sv[j] = tss[cell0 + (size_t)j * TILE_Z];
                tv[j] = temp[cell0 + (size_t)j * TILE_Z];
                ++cnt;
            }
        }
        s_cnt[warp][lane] = cnt;
        if (!__syncthreads_or(cnt)) {     // no jet cell in the strip
            if (tile + 1 < last) load_a(tile + 1);
            continue;
        }
        int pos = 0, n_cells = 0;
#pragma unroll
        for (int w = 0; w < TWARPS; ++w) {
            const int c = s_cnt[w][lane];
            pos += w < warp ? c : 0;
            n_cells += c;
        }
#pragma unroll
        for (int j = 0; j < T_CELLS; ++j) {
            if (av[j] != 0.0f) {
                const float chi = burst_chi(sv[j], t, off, b);
                s_base[pos][lane] = av[j] * chi * chi;
                s_inv_t[pos][lane] = mufu_rcp(tv[j]);
                ++pos;
            }
        }
        if (tile + 1 < last) load_a(tile + 1);   // in flight from now
        __syncthreads();
        // channels: this chunk's share of the column's jet cells, in y
        // order, from the chunk's own start: (I_k, tau_k)
#pragma unroll
        for (int j = 0; j < CPT_TILES; ++j) {
            inten[j] = 0.0f;
            tau[j] = 0.0f;
        }
        if (nc > 0) {
            const int lo = (n_cells * chunk) >> chunks_log2;
            const int hi = (n_cells * (chunk + 1)) >> chunks_log2;
            for (int k = lo; k < hi; ++k) {
                tile_cell<CPT_TILES>(s_base[k][lane], s_inv_t[k][lane], cn,
                                     hk, sc, inten, tau);
            }
        }
#pragma unroll
        for (int j = 0; j < CPT_TILES; ++j) {
            s_part[0][warp][j][lane] = inten[j];
            s_part[1][warp][j][lane] = tau[j];
        }
        __syncthreads();
        // fold the chunks into the column's (I, tau), in observer order; a
        // chunk with tau_k = 0 holds no opacity and I_k = 0, and is skipped
        if (chunk == 0 && nc > 0) {
            for (int k = 0; k < (1 << chunks_log2); ++k) {
                const int w = (k << groups_log2) + grp;
#pragma unroll
                for (int j = 0; j < CPT_TILES; ++j) {
                    const float tk = s_part[1][w][j][lane];
                    if (tk != 0.0f) {
                        run_i[j] = run_i[j] +
                                   s_part[0][w][j][lane] *
                                       mufu_ex2(run_tau[j] * -LOG2E);
                        run_tau[j] = run_tau[j] + tk;
                    }
                }
            }
        }
        // s_base and s_part are rewritten only after the next tile's first
        // barrier, which every warp reaches after this fold; s_cnt is read
        // only between a tile's first two barriers
    }
    if (chunk != 0) return;
    const size_t o = ((size_t)s * n_chan + c0) * (TILE_X * TILE_Z) +
                     (size_t)xr * TILE_Z + z;
#pragma unroll
    for (int j = 0; j < CPT_TILES; ++j) {
        if (j < nc) {
            out_i[o + (size_t)j * (TILE_X * TILE_Z)] = run_i[j];
            out_tau[o + (size_t)j * (TILE_X * TILE_Z)] = run_tau[j];
        }
    }
}

// Host entry points.  Each launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).  The burst
// list comes by pointer to a host struct (see epoch_maps.cu).
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
                   int n_seg, int n_chan, int groups_log2, float t,
                   float off, const Bursts* b, void* stream) {
    const int per_block = CPT_TILES << groups_log2;
    const dim3 grid(n_seg * TILE_X * T_STRIPS,
                    (n_chan + per_block - 1) / per_block);
    emergent_tiles_kernel<<<grid, TWARPS * 32, 0, (cudaStream_t)stream>>>(
        cnu, hnuk, scale, temp, a, tss, seg_start, out_i, out_tau, n_chan,
        groups_log2, t, off, *b);
    return (int)cudaGetLastError();
}

}  // extern "C"
