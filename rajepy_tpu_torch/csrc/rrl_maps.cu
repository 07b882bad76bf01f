// LOS-collapsed radio-recombination-line optical-depth maps for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// rajepy_tpu_torch/ops/kernels.py.
//
// For every channel c and (x, z) column:
//   tau[c, x, z] = sum_y amp * Re w(x_c + i y_v) * (1 - exp(-(f_c + nu0) hkT)),
//   x_c = (f_c - rest) * scale,
// from the channel-independent per-cell factors of
// ops/radtrans.py:tau_rrl_precompute (amp, rest, scale, y_v, hkT), with f_c
// and rest as float32 OFFSETS from the line centre nu0.  Cells with amp = 0
// contribute exactly 0, and a column with no such cell is exactly 0.
//
// Replaces the two Pallas TPU kernels of rajepy_tpu/ops/pallas_kernels.py
// on the RRL path:
//   rrl_tiles_kernel <- rrl_tiles_pallas (_rrl_tiles_kernel) and its fold
//                       segment_tile_maps: compacted (8, 64, 128) tiles
//                       straight to the (n_chan, nx, nz) maps, each block
//                       summing the tiles of one (x, z) tile position (a
//                       segment) itself;
//   rrl_activity_kernel + rrl_cube_kernel <- rrl_cube_pallas (_rrl_kernel):
//                       the same maths over the full (nx, ny, nz) grid.
//
// Re w is the per-cell choice of the TPU kernels' evaluators: the 3-term
// asymptotic series where |x| + y > 8 (_voigt_re_far), else the
// Weideman-16 rational by the Goertzel recurrence (_voigt_re_weideman),
// with the coefficients (highest power first) and L passed by value from
// the host.  The TPU picks wings/core/mixed once per (block, channel) only
// to save vector work; a per-cell branch gives the same values.
//
// What bounds them: operations.  A jet cell costs ~100 float32 operations
// per channel in the core and ~45 in the wings, against 20 bytes of inputs:
// thousands of operations per byte at 1,000 channels.  The jet fills ~18% of
// a tile's cells, in runs along z, so the design keeps every lane busy on a
// jet cell and reads each factor few times:
//   * the unit of work is a ROW BLOCK, one x row of 64 y by 128 z cells (a
//     tile's row, or a (1, 64, 128) block of the full grid).  A block stages
//     it CHUNK_Y rows at a time: THREADS / 128 threads per z column read
//     amp, a prefix over the column counts places each jet cell, and only
//     those cells' other four factors are copied into shared memory, with
//     cp.async, compacted column by column.  The staging capacity is a
//     whole chunk (CHUNK cells), so a wholly jet chunk fits and nothing
//     overflows;
//   * lanes over channels, cells shared: a warp takes one column at a time
//     and its lanes evaluate the same staged cell (a shared-memory
//     broadcast) for neighbouring channels, CPL adjacent channels per lane.
//     No lane waits on another's empty cell, and neighbouring channels have
//     nearly equal x, so the wings/core branch agrees across the warp
//     except where it crosses, and a lane's channels run their evaluations
//     side by side as independent chains.  The lanes form 32/lanes cell
//     slots (at least two), summed by shuffles at the end of the column;
//   * each block owns one row of output columns and a group of CPL * lanes
//     channels (at most 64); its per-(channel, z) sums stay in shared
//     memory (rows padded to ROW_Z + 1 floats, so neither the warps' adds
//     nor the final reads meet a bank conflict) until the block writes its
//     maps once, coalesced along z (16 bytes a thread where the rows
//     allow).  Every output
//     element is written exactly once, zeros included, so the wrappers
//     allocate with torch.empty; a block with no jet cell writes its zeros
//     without touching shared memory;
//   * enough blocks for 132 SMs at any channel count: a row block's work is
//     serial inside its block, so with one or two channel groups (16
//     channels: one group, and only the jet's few hundred row blocks carry
//     work) the blocks have 1,024 threads, and with more (1,000 channels:
//     16) 256, three resident per SM;
//   * rrl_tiles_kernel walks the tiles of its segment in the order of a
//     host-made permutation (tiles sorted by segment, seg_start offsets), so
//     no per-tile partials, no zero-filled buffer, no index_add_ and no
//     permute copy exist;
//   * the full grid is read once by rrl_activity_kernel, which flags the
//     row blocks that hold a jet cell; rrl_cube_kernel then stages only the
//     flagged ones.  A jet-free grid costs one read of amp and the write of
//     the zero maps, whatever the number of channels;
//   * one launch dimension, row block major and channel group minor, so the
//     channel groups of one row block run side by side and share its
//     factors in L2.
//
// Numerics: the Pallas bodies' formulas in float32.  This source alone is
// built with multiply-add contraction (no -fmad=false: the Goertzel step is
// two FMAs), and the two divisions of Re w are an approximate reciprocal
// (fast_rcp, about 1 ulp); both move the sums by about 1e-7 relative, well
// inside the 1e-5 that the kernels are held to against their plain
// versions.  f_c + nu0 is formed once per channel.  The stimulated factor
// 1 - e^{-d} is -expm1f(-d), except below |d| = 0.05 (every jet cell of
// the flagship: d is ~1e-4 at 1e4 K), where the first four terms of its
// series are used: their truncation, d^4/120 relative, stays under 6e-8,
// and they cost 4 multiply-adds against expm1f's ~20 instructions.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define TILE_X 8
#define ROW_Y 64                  // y extent of a row block
#define ROW_Z 128                 // z extent of a row block
#define CHUNK_Y 16                // rows of a row block staged at once
#define CHUNK (CHUNK_Y * ROW_Z)   // staging capacity: a whole chunk
#define CPL 4                     // channels per lane
#define ACC_STRIDE (ROW_Z + 1)    // padded row of the per-channel sums
#define N_FACTORS 5
#define N_WEID 16
#define INV_SQRT_PI 0.56418958354775628f
#define FAR_CUT 8.0f
#define STIM_SERIES_CUT 0.05f
#define FULL_MASK 0xffffffffu

// Weideman (1994) N=16 expansion: scale L and coefficients, highest power
// first.  Mirrors the ctypes Structure _Weideman in ops/kernels.py.
struct Weideman {
    float ell;
    float c[N_WEID];
};

// The five per-cell factors, each laid out like amp.
struct Factors {
    const float* amp;
    const float* rest;
    const float* scale;
    const float* yv;
    const float* hkt;
};

// The block's shared memory: the staged chunk (N_FACTORS arrays of CHUNK
// floats, dynamic), the per-(channel, z) sums (dynamic, after it), and the
// staging's column offsets.
struct Smem {
    float* fac;
    float* acc;
    int* col_start;   // [ROW_Z + 1]
    int* cnt;         // [THREADS / ROW_Z][ROW_Z]: jet cells per thread
    int* warp_tot;    // [ROW_Z / 32]
};

// A lane's CPL neighbouring channels: offsets fo and fo + nu0.  A channel
// past n_chan gets fo = 0 (finite values that are never written out).
struct Lane {
    float fo[CPL];
    float fn[CPL];
};

// 1 / v by the hardware's approximate reciprocal (rcp.approx.ftz, about
// 1 ulp).  Both of Re w's denominators stay far from the denormals it
// flushes: x^2 + y^2 > 32 in the wings, (L + y)^2 + x^2 >= L^2 ~ 11.3 in
// the core.
__device__ __forceinline__ float fast_rcp(float v) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}

// Re w(x + iy) by the 3-term asymptotic series
// w(z) ~ i/(sqrt(pi) z) sum_k (2k-1)!!/(2 z^2)^k, for |x| + y > 8.
__device__ __forceinline__ float voigt_re_far(float x, float y) {
    const float inv = fast_rcp(x * x + y * y);
    const float inv2 = inv * inv;
    const float wr2 = 0.5f * (x * x - y * y) * inv2;
    const float wi2 = -x * y * inv2;
    float sr = wr2 * 15.0f + 3.0f;
    float si = wi2 * 15.0f;
    float tr = sr * wr2 - si * wi2 + 1.0f;
    float ti = sr * wi2 + si * wr2;
    sr = tr * wr2 - ti * wi2 + 1.0f;
    si = tr * wi2 + ti * wr2;
    return (y * sr - x * si) * inv * INV_SQRT_PI;
}

// Re w(x + iy) by the Weideman rational, p(Z) at Z = (L+iz)/(L-iz) by the
// Goertzel recurrence b_k = c_k + 2 Re(Z) b_{k+1} - |Z|^2 b_{k+2},
// p = b_0 - b_1 conj(Z); valid for |x| + y <= 8.
__device__ __forceinline__ float voigt_re_weideman(float x, float y,
                                                   const Weideman& w) {
    const float dr = w.ell + y;
    const float di = -x;
    const float nr = w.ell - y;
    const float ni = x;
    const float inv_den = fast_rcp(dr * dr + di * di);
    const float zr = (nr * dr + ni * di) * inv_den;
    const float zi = (ni * dr - nr * di) * inv_den;
    const float r = 2.0f * zr;
    const float s = zr * zr + zi * zi;
    float b1 = w.c[0];      // the first step from b1 = b2 = 0
    float b2 = 0.0f;
#pragma unroll
    for (int k = 1; k < N_WEID; ++k) {
        const float b0 = w.c[k] + r * b1 - s * b2;
        b2 = b1;
        b1 = b0;
    }
    const float pr = b1 - b2 * zr;
    const float pi = b2 * zi;
    const float inv_r = dr * inv_den;
    const float inv_i = -di * inv_den;
    const float inv2_r = inv_r * inv_r - inv_i * inv_i;
    const float inv2_i = 2.0f * inv_r * inv_i;
    return 2.0f * (pr * inv2_r - pi * inv2_i) + inv_r * INV_SQRT_PI;
}

// One cell's line opacity for a lane's CPL channels, added to sum.  The
// channels are neighbours, so they nearly always take the same branches,
// and then their evaluations run side by side (independent chains).
// 1 - e^{-d} is the series d (1 + d (-1/2 + d (1/6 - d/24))) below
// |d| = STIM_SERIES_CUT, -expm1f(-d) above.
__device__ __forceinline__ void rrl_cells(const Lane& ln, float amp,
                                          float rest, float scale, float yv,
                                          float hkt, const Weideman& w,
                                          float sum[CPL]) {
    float x[CPL], d[CPL], stim[CPL], re[CPL];
    bool far[CPL];
    bool small = true, all_far = true, all_near = true;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        x[j] = (ln.fo[j] - rest) * scale;
        d[j] = ln.fn[j] * hkt;
        small = small && fabsf(d[j]) < STIM_SERIES_CUT;
        far[j] = fabsf(x[j]) + yv > FAR_CUT;
        all_far = all_far && far[j];
        all_near = all_near && !far[j];
    }
    if (small) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            stim[j] = d[j] * fmaf(d[j], fmaf(d[j], fmaf(d[j], -1.0f / 24.0f,
                                                     1.0f / 6.0f),
                                             -0.5f),
                                  1.0f);
        }
    } else {
#pragma unroll
        for (int j = 0; j < CPL; ++j) stim[j] = -expm1f(-d[j]);
    }
    if (all_far) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) re[j] = voigt_re_far(x[j], yv);
    } else if (all_near) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) re[j] = voigt_re_weideman(x[j], yv, w);
    } else {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            if (far[j]) {
                re[j] = voigt_re_far(x[j], yv);
            } else {
                re[j] = voigt_re_weideman(x[j], yv, w);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) sum[j] += amp * re[j] * stim[j];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
}

// Stages the jet cells (amp != 0) of rows 0 .. ny_c - 1 and columns
// 0 .. nz_c - 1 of a chunk whose cell (y, z) lies at offset
// base + y * ystride + z, into s.fac: column by column, in y order within a
// column, column z's cells at s.col_start[z] .. s.col_start[z + 1] - 1.
// Thread (z, h) reads amp at rows h * ROWS .. (h + 1) * ROWS - 1 of column
// z; the other four factors are copied only at jet cells.  Returns the
// number of cells staged (the same in every thread).
template <int THREADS>
__device__ int stage_chunk(const Factors& f, size_t base, size_t ystride,
                           int ny_c, int nz_c, const Smem& s) {
    constexpr int SPLIT = THREADS / ROW_Z;
    constexpr int ROWS = CHUNK_Y / SPLIT;
    static_assert(ROWS * SPLIT == CHUNK_Y, "CHUNK_Y rows split evenly");
    const int tid = threadIdx.x;
    const int z = tid % ROW_Z;
    const int h = tid / ROW_Z;
    const int lane = tid % 32;
    float a[ROWS];
    unsigned mask = 0;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const int y = h * ROWS + k;
        a[k] = (z < nz_c && y < ny_c) ? f.amp[base + (size_t)y * ystride + z]
                                      : 0.0f;
        if (a[k] != 0.0f) mask |= 1u << k;
    }
    s.cnt[h * ROW_Z + z] = __popc(mask);
    __syncthreads();
    // inclusive prefix of the column totals, by the first ROW_Z threads
    int incl = 0;
    if (h == 0) {
#pragma unroll
        for (int j = 0; j < SPLIT; ++j) incl += s.cnt[j * ROW_Z + z];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(FULL_MASK, incl, o);
            if (lane >= o) incl += u;
        }
        if (lane == 31) s.warp_tot[z / 32] = incl;
    }
    __syncthreads();
    if (h == 0) {
        for (int w = 0; w < z / 32; ++w) incl += s.warp_tot[w];
        s.col_start[z + 1] = incl;
        if (z == 0) s.col_start[0] = 0;
    }
    __syncthreads();
    const int n_cells = s.col_start[ROW_Z];
    if (n_cells == 0) return 0;
    int pos = s.col_start[z];
    for (int j = 0; j < h; ++j) pos += s.cnt[j * ROW_Z + z];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (mask & (1u << k)) {
            const size_t i = base + (size_t)(h * ROWS + k) * ystride + z;
            s.fac[pos] = a[k];
            cp_async4(s.fac + CHUNK + pos, f.rest + i);
            cp_async4(s.fac + 2 * CHUNK + pos, f.scale + i);
            cp_async4(s.fac + 3 * CHUNK + pos, f.yv + i);
            cp_async4(s.fac + 4 * CHUNK + pos, f.hkt + i);
            ++pos;
        }
    }
    cp_async_wait_all();
    __syncthreads();
    return n_cells;
}

// Adds the staged cells' opacity into s.acc: warp w takes columns w,
// w + THREADS / 32, ...; its lanes form 32 >> lanes_log2 cell slots of
// `lanes` lanes, lane l of a slot carrying channels CPL * l .. CPL * l +
// CPL - 1 of the group.  The slots' sums meet by shuffles and the first
// slot adds channel CPL * l + j to acc row j * lanes + l (stride ACC_STRIDE
// between lanes: no bank conflict), column z (a column has one warp, so no
// two warps add to one sum).
template <int THREADS>
__device__ void eval_chunk(const Smem& s, int nz_c, const Lane& ln,
                           int lanes_log2, const Weideman& w) {
    const int lane = threadIdx.x % 32;
    const int lanes = 1 << lanes_log2;
    const int slot = lane >> lanes_log2;
    const int n_slots = 32 >> lanes_log2;
    const int l = lane & (lanes - 1);
    for (int z = threadIdx.x / 32; z < nz_c; z += THREADS / 32) {
        const int s0 = s.col_start[z];
        const int n = s.col_start[z + 1] - s0;
        if (n == 0) continue;
        float sum[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) sum[j] = 0.0f;
        for (int i = slot; i < n; i += n_slots) {
            const int c = s0 + i;
            const float a = s.fac[c];
            const float r = s.fac[CHUNK + c];
            const float sc = s.fac[2 * CHUNK + c];
            const float v = s.fac[3 * CHUNK + c];
            const float h = s.fac[4 * CHUNK + c];
            rrl_cells(ln, a, r, sc, v, h, w, sum);
        }
        for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
                sum[j] += __shfl_xor_sync(FULL_MASK, sum[j], o);
            }
        }
        if (slot == 0) {
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
                s.acc[(j * lanes + l) * ACC_STRIDE + z] += sum[j];
            }
        }
    }
}

// One row block (ny_r rows of nz_c columns, cell (y, z) at
// base + y * ystride + z), CHUNK_Y rows at a time, into s.acc.  The one
// evaluator of both front ends.
template <int THREADS>
__device__ void row_block(const Factors& f, size_t base, size_t ystride,
                          int ny_r, int nz_c, const Smem& s, const Lane& ln,
                          int lanes_log2, const Weideman& w) {
    for (int y0 = 0; y0 < ny_r; y0 += CHUNK_Y) {
        if (stage_chunk<THREADS>(f, base + (size_t)y0 * ystride, ystride,
                                 min(CHUNK_Y, ny_r - y0), nz_c, s) == 0) {
            continue;
        }
        eval_chunk<THREADS>(s, nz_c, ln, lanes_log2, w);
    }
}

// The lane's channels (c0 + CPL * l + j of the block's group of
// CPL * lanes) and cleared sums.
template <int THREADS>
__device__ void block_setup(const Smem& s, const float* freqs, int n_chan,
                            float nu0, int c0, int lanes_log2, Lane& ln) {
    const int l = (threadIdx.x % 32) & ((1 << lanes_log2) - 1);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        const int c = c0 + CPL * l + j;
        ln.fo[j] = c < n_chan ? freqs[c] : 0.0f;
        ln.fn[j] = ln.fo[j] + nu0;
    }
    for (int i = threadIdx.x; i < (CPL << lanes_log2) * ACC_STRIDE;
         i += THREADS) {
        s.acc[i] = 0.0f;
    }
}

// Writes the block's sums (or zeros, for acc == nullptr) to the maps: acc
// row cl (channel c0 + CPL * (cl % lanes) + cl / lanes) to that channel's
// row of nz_c columns, consecutive threads on consecutive z, four floats a
// thread when the rows are 16-byte aligned.
template <int THREADS>
__device__ void write_maps(const float* acc, float* __restrict__ out,
                           size_t plane, size_t row, int nz_c, int c0,
                           int lanes_log2, int n_chan) {
    const int cg = CPL << lanes_log2;
    const int lanes = 1 << lanes_log2;
    const bool vec = (plane % 4 == 0) && (row % 4 == 0) &&
                     ((uintptr_t)out % 16 == 0) && (nz_c % 4 == 0);
    const int per_row = vec ? ROW_Z / 4 : ROW_Z;
    for (int i = threadIdx.x; i < cg * per_row; i += THREADS) {
        const int cl = i / per_row;
        const int c = c0 + CPL * (cl & (lanes - 1)) + (cl >> lanes_log2);
        const int z = (i % per_row) * (vec ? 4 : 1);
        if (c >= n_chan || z >= nz_c) continue;
        float* o = out + (size_t)c * plane + row + z;
        const float* a = acc + cl * ACC_STRIDE + z;
        if (vec) {
            *reinterpret_cast<float4*>(o) =
                acc != nullptr ? make_float4(a[0], a[1], a[2], a[3])
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
            *o = acc != nullptr ? a[0] : 0.0f;
        }
    }
}

// Compacted tiles (n_act, 8, 64, 128) -> maps (n_chan, nx, nz).  Block b:
// row block b / n_groups = segment * TILE_X + x row, channel group
// b % n_groups.  Segment s = (x tile, z tile) = (s / n_zt, s % n_zt) holds
// tiles order[seg_start[s]] .. order[seg_start[s + 1] - 1].
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
rrl_tiles_kernel(const float* __restrict__ freqs, Factors f,
                 const int* __restrict__ order,
                 const int* __restrict__ seg_start, float* __restrict__ out,
                 int n_zt, int nx, int nz, int n_chan, int n_groups,
                 int lanes_log2, float nu0, Weideman w) {
    extern __shared__ float dyn[];
    __shared__ int col_start[ROW_Z + 1], cnt[THREADS], warp_tot[ROW_Z / 32];
    const int rb = blockIdx.x / n_groups;
    const int c0 = (blockIdx.x % n_groups) * (CPL << lanes_log2);
    const int seg = rb / TILE_X;
    const int xr = rb % TILE_X;
    const int x = (seg / n_zt) * TILE_X + xr;
    const int z0 = (seg % n_zt) * ROW_Z;
    if (x >= nx) return;      // a padding row of the last x tile
    const size_t plane = (size_t)nx * nz;
    const size_t row = (size_t)x * nz + z0;
    const int nz_c = min(ROW_Z, nz - z0);
    const int first = seg_start[seg];
    const int last = seg_start[seg + 1];
    if (first == last) {      // no tile on these lines of sight
        write_maps<THREADS>(nullptr, out, plane, row, nz_c, c0, lanes_log2,
                            n_chan);
        return;
    }
    const Smem s = {dyn, dyn + N_FACTORS * CHUNK, col_start, cnt, warp_tot};
    Lane ln;
    block_setup<THREADS>(s, freqs, n_chan, nu0, c0, lanes_log2, ln);
    for (int k = first; k < last; ++k) {
        const size_t base = (size_t)order[k] * (TILE_X * ROW_Y * ROW_Z) +
                            (size_t)xr * (ROW_Y * ROW_Z);
        row_block<THREADS>(f, base, ROW_Z, ROW_Y, ROW_Z, s, ln, lanes_log2,
                           w);
    }
    __syncthreads();
    write_maps<THREADS>(s.acc, out, plane, row, nz_c, c0, lanes_log2,
                        n_chan);
}

// Full grid (nx, ny, nz) -> active[x, y block, z block]: whether the
// (1, ROW_Y, ROW_Z) row block holds a cell with amp != 0.  One block of 256
// threads per row block: 16-byte loads where the rows allow (8 a thread),
// else 4-byte ones (32 a thread); ragged edges masked.
__global__ void __launch_bounds__(256)
rrl_activity_kernel(const float* __restrict__ amp,
                    uint8_t* __restrict__ active, int ny, int nz, int n_yc,
                    int n_zc) {
    const size_t b = blockIdx.x;
    const int zc = (int)(b % n_zc);
    const int yc = (int)((b / n_zc) % n_yc);
    const size_t x = b / ((size_t)n_zc * n_yc);
    int any = 0;
    if (nz % 4 == 0 && (uintptr_t)amp % 16 == 0) {
        const int z = zc * ROW_Z + (threadIdx.x % 32) * 4;
        if (z < nz) {
#pragma unroll
            for (int k = threadIdx.x / 32; k < ROW_Y; k += 8) {
                const int y = yc * ROW_Y + k;
                if (y < ny) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        amp + (x * ny + y) * nz + z);
                    any |= (v.x != 0.0f) | (v.y != 0.0f) | (v.z != 0.0f) |
                           (v.w != 0.0f);
                }
            }
        }
    } else {
        const int z = zc * ROW_Z + threadIdx.x % ROW_Z;
        if (z < nz) {
#pragma unroll 8
            for (int k = threadIdx.x / ROW_Z; k < ROW_Y; k += 2) {
                const int y = yc * ROW_Y + k;
                if (y < ny) any |= amp[(x * ny + y) * nz + z] != 0.0f;
            }
        }
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) active[b] = (uint8_t)(any != 0);
}

// Full grid (nx, ny, nz) -> maps (n_chan, nx, nz).  Block b: output row
// b / n_groups = (x, z block), channel group b % n_groups; it stages only
// the row blocks that rrl_activity_kernel flagged.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
rrl_cube_kernel(const float* __restrict__ freqs, Factors f,
                const uint8_t* __restrict__ active, float* __restrict__ out,
                int nx, int ny, int nz, int n_chan, int n_groups,
                int lanes_log2, float nu0, Weideman w) {
    extern __shared__ float dyn[];
    __shared__ int col_start[ROW_Z + 1], cnt[THREADS], warp_tot[ROW_Z / 32];
    const int n_yc = (ny + ROW_Y - 1) / ROW_Y;
    const int n_zc = (nz + ROW_Z - 1) / ROW_Z;
    const int rb = blockIdx.x / n_groups;
    const int c0 = (blockIdx.x % n_groups) * (CPL << lanes_log2);
    const size_t x = rb / n_zc;
    const int zc = rb % n_zc;
    const size_t plane = (size_t)nx * nz;
    const size_t row = x * nz + (size_t)zc * ROW_Z;
    const int nz_c = min(ROW_Z, nz - zc * ROW_Z);
    const uint8_t* flags = active + x * n_yc * n_zc + zc;
    int any = 0;
    for (int yc = threadIdx.x; yc < n_yc; yc += THREADS) {
        any |= flags[(size_t)yc * n_zc];
    }
    if (!__syncthreads_or(any)) {    // no jet cell on these lines of sight
        write_maps<THREADS>(nullptr, out, plane, row, nz_c, c0, lanes_log2,
                            n_chan);
        return;
    }
    const Smem s = {dyn, dyn + N_FACTORS * CHUNK, col_start, cnt, warp_tot};
    Lane ln;
    block_setup<THREADS>(s, freqs, n_chan, nu0, c0, lanes_log2, ln);
    for (int yc = 0; yc < n_yc; ++yc) {
        if (!flags[(size_t)yc * n_zc]) continue;
        const size_t base = (x * ny + (size_t)yc * ROW_Y) * nz +
                            (size_t)zc * ROW_Z;
        row_block<THREADS>(f, base, (size_t)nz, min(ROW_Y, ny - yc * ROW_Y),
                           nz_c, s, ln, lanes_log2, w);
    }
    __syncthreads();
    write_maps<THREADS>(s.acc, out, plane, row, nz_c, c0, lanes_log2,
                        n_chan);
}

static size_t maps_smem(int lanes_log2) {
    return (size_t)(N_FACTORS * CHUNK + (CPL << lanes_log2) * ACC_STRIDE) *
           sizeof(float);
}

// Threads per block of the maps kernels: a row block's work is serial in
// its block, so when few channel groups share the row blocks, larger
// blocks keep the SMs full.
static int maps_threads(int n_groups) {
    return n_groups <= 2 ? 1024 : 256;
}

// Launches the maps kernel built for maps_threads(n_groups) threads (k256
// or k1024) after allowing its dynamic shared memory; returns a
// cudaError_t.
template <typename... P, typename... A>
static int launch_maps(int n_groups, unsigned n_blocks, size_t smem,
                       void* stream, void (*k256)(P...), void (*k1024)(P...),
                       A... args) {
    const int threads = maps_threads(n_groups);
    void (*k)(P...) = threads == 1024 ? k1024 : k256;
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<n_blocks, threads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

// Host entry points.  Each launches on the caller's stream, does not
// synchronise, and returns a cudaError_t (0 on success).  `lanes_log2`
// sets the channel group, CPL << lanes_log2 channels per block.
extern "C" {

int rrl_tiles(const float* freqs, const float* amp, const float* rest,
              const float* scale, const float* yv, const float* hkt,
              const int* order, const int* seg_start, float* out, int n_xt,
              int n_zt, int nx, int nz, int n_chan, int lanes_log2,
              float nu0, Weideman w, void* stream) {
    const size_t smem = maps_smem(lanes_log2);
    const int n_groups = (n_chan + (CPL << lanes_log2) - 1) /
                         (CPL << lanes_log2);
    const Factors f = {amp, rest, scale, yv, hkt};
    const unsigned n_blocks = (unsigned)n_xt * n_zt * TILE_X * n_groups;
    return launch_maps(n_groups, n_blocks, smem, stream,
                       rrl_tiles_kernel<256>, rrl_tiles_kernel<1024>, freqs,
                       f, order, seg_start, out, n_zt, nx, nz, n_chan,
                       n_groups, lanes_log2, nu0, w);
}

int rrl_activity(const float* amp, unsigned char* active, int nx, int ny,
                 int nz, void* stream) {
    const int n_yc = (ny + ROW_Y - 1) / ROW_Y;
    const int n_zc = (nz + ROW_Z - 1) / ROW_Z;
    const unsigned n_blocks = (unsigned)nx * n_yc * n_zc;
    rrl_activity_kernel<<<n_blocks, 256, 0, (cudaStream_t)stream>>>(
        amp, active, ny, nz, n_yc, n_zc);
    return (int)cudaGetLastError();
}

int rrl_cube(const float* freqs, const float* amp, const float* rest,
             const float* scale, const float* yv, const float* hkt,
             const unsigned char* active, float* out, int nx, int ny,
             int nz, int n_chan, int lanes_log2, float nu0, Weideman w,
             void* stream) {
    const size_t smem = maps_smem(lanes_log2);
    const int n_zc = (nz + ROW_Z - 1) / ROW_Z;
    const int n_groups = (n_chan + (CPL << lanes_log2) - 1) /
                         (CPL << lanes_log2);
    const Factors f = {amp, rest, scale, yv, hkt};
    const unsigned n_blocks = (unsigned)nx * n_zc * n_groups;
    return launch_maps(n_groups, n_blocks, smem, stream,
                       rrl_cube_kernel<256>, rrl_cube_kernel<1024>, freqs,
                       f, active, out, nx, ny, nz, n_chan, n_groups,
                       lanes_log2, nu0, w);
}

}  // extern "C"
