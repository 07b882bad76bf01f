// LOS-collapsed radio-recombination-line optical-depth maps for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// rajepy_tpu_torch/ops/kernels.py.
//
// For every channel c and (x, z) column:
//   tau[c, x, z] = sum_y amp * Re w(x_c + i y_v) * (1 - exp(-(f_c + nu0) hkT)),
//   x_c = (f_c - rest) * scale,
// from the channel-independent per-cell factors of
// ops/radtrans.py:tau_rrl_precompute (amp, rest, scale, y_v, hkT), with f_c
// and rest as float32 OFFSETS from the line centre nu0.
//
// Replaces the two Pallas TPU kernels of rajepy_tpu/ops/pallas_kernels.py
// on the RRL path:
//   rrl_tiles_kernel <- rrl_tiles_pallas (_rrl_tiles_kernel): per-tile
//                       partials over compacted (8, 64, 128) tiles;
//   rrl_cube_kernel  <- rrl_cube_pallas  (_rrl_kernel): the same maths over
//                       the full (nx, ny, nz) grid.
//
// Re w is the per-cell choice of the TPU kernels' evaluators: the 3-term
// asymptotic series where |x| + y > 8 (_voigt_re_far), else the
// Weideman-16 rational by the Goertzel recurrence (_voigt_re_weideman),
// with the coefficients (highest power first) and L passed by value from
// the host.  The TPU picks wings/core/mixed once per (block, channel) only
// to save vector work; a per-cell branch gives the same values, and only
// the chosen formula runs, so no clamp is needed.
//
// What bounds them: operations.  A jet cell costs ~100 float32 operations
// per channel in the core (16 Goertzel steps of 4) and ~45 in the wings,
// against 20 bytes of inputs read once for every channel: thousands of
// operations per byte at 1000 channels, far above the card's ~20
// operation/byte float32 balance point.  So the design keeps the inputs
// near and the work in registers:
//   * one thread owns one (x, z) column (of a tile, or of the full grid)
//     and loops over y itself, summing in registers: nothing depends on
//     the order in which blocks run (the TPU kernel of the full grid
//     accumulates across sequential y-chunk grid steps, which a GPU does
//     not have);
//   * a thread carries CPT channels at once: each cell's five factors are
//     loaded once per CPT channels, and one dimension of the launch grid
//     walks the channel blocks;
//   * cells with amp = 0 (outside the jet, and tile padding) are skipped
//     before their other four factors are loaded; their contribution is
//     exactly 0, as the TPU kernel's skip of all-zero blocks;
//   * every (x, z) column of the output is written, 0 where amp is all 0
//     (the wrapper allocates with torch.empty).
// Blocks are (128 z, 2 x) threads, so a warp reads 32 neighbouring z
// addresses per y step.
//
// Numerics follow the Pallas bodies' float32 operation order; build with
// -fmad=false so that no multiply-add is contracted.  The stimulated
// factor is -expm1f(-d) (the TPU's Taylor substitute exists only because
// Mosaic has no expm1).

#include <cuda_runtime.h>
#include <stddef.h>

#define TILE_X 8
#define TILE_Y 64
#define TILE_Z 128
#define BLOCK_Z 128
#define BLOCK_X 2
#define N_WEID 16
#define CPT 16  // channels per thread
#define SQRT_PI 1.7724538509055159f
#define FAR_CUT 8.0f

// Weideman (1994) N=16 expansion: scale L and coefficients, highest power
// first.  Mirrors the ctypes Structure _Weideman in ops/kernels.py.
struct Weideman {
    float ell;
    float c[N_WEID];
};

// Re w(x + iy) by the 3-term asymptotic series
// w(z) ~ i/(sqrt(pi) z) sum_k (2k-1)!!/(2 z^2)^k, for |x| + y > 8.
__device__ __forceinline__ float voigt_re_far(float x, float y) {
    const float inv = 1.0f / (x * x + y * y);
    const float wr2 = 0.5f * (x * x - y * y) * inv * inv;
    const float wi2 = -x * y * inv * inv;
    float sr = wr2 * 15.0f + 3.0f;
    float si = wi2 * 15.0f;
    float tr = sr * wr2 - si * wi2 + 1.0f;
    float ti = sr * wi2 + si * wr2;
    sr = tr * wr2 - ti * wi2 + 1.0f;
    si = tr * wi2 + ti * wr2;
    return (y * sr - x * si) * inv / SQRT_PI;
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
    const float inv_den = 1.0f / (dr * dr + di * di);
    const float zr = (nr * dr + ni * di) * inv_den;
    const float zi = (ni * dr - nr * di) * inv_den;
    const float r = 2.0f * zr;
    const float s = zr * zr + zi * zi;
    float b1 = 0.0f;
    float b2 = 0.0f;
#pragma unroll
    for (int k = 0; k < N_WEID; ++k) {
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
    return 2.0f * (pr * inv2_r - pi * inv2_i) + inv_r / SQRT_PI;
}

// One cell's line opacity at channel offset fo.
__device__ __forceinline__ float rrl_cell(float fo, float amp, float rest,
                                          float scale, float yv, float hkt,
                                          float nu0, const Weideman& w) {
    const float x = (fo - rest) * scale;
    const float stim = -expm1f(-((fo + nu0) * hkt));
    float re;
    if (fabsf(x) + yv > FAR_CUT) {
        re = voigt_re_far(x, yv);
    } else {
        re = voigt_re_weideman(x, yv, w);
    }
    return amp * re * stim;
}

// Sum over ny cells of one column starting at flat index col with stride
// `stride` between y steps, for channels c0 .. c0 + nc - 1.
__device__ __forceinline__ void column_sums(
        const float* __restrict__ freqs, const float* __restrict__ amp,
        const float* __restrict__ rest, const float* __restrict__ scale,
        const float* __restrict__ yv, const float* __restrict__ hkt,
        size_t col, int ny, size_t stride, int c0, int nc, float nu0,
        const Weideman& w, float acc[CPT]) {
    float f[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        f[j] = j < nc ? freqs[c0 + j] : 0.0f;
        acc[j] = 0.0f;
    }
    for (int y = 0; y < ny; ++y) {
        const size_t i = col + (size_t)y * stride;
        const float a = amp[i];
        if (a == 0.0f) continue;
        const float r = rest[i];
        const float s = scale[i];
        const float v = yv[i];
        const float h = hkt[i];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            if (j < nc) {
                acc[j] = acc[j] + rrl_cell(f[j], a, r, s, v, h, nu0, w);
            }
        }
    }
}

// Compacted tiles (n_act, 8, 64, 128) -> partials (n_act, n_chan, 8, 128).
// blockIdx.x = tile * (TILE_X / BLOCK_X) + x-quarter, blockIdx.y = channel
// block of CPT.
__global__ void __launch_bounds__(BLOCK_Z * BLOCK_X)
rrl_tiles_kernel(const float* __restrict__ freqs,
                 const float* __restrict__ amp,
                 const float* __restrict__ rest,
                 const float* __restrict__ scale,
                 const float* __restrict__ yv,
                 const float* __restrict__ hkt, float* __restrict__ out,
                 int n_chan, float nu0, Weideman w) {
    const int z = threadIdx.x;
    const int per_tile = TILE_X / BLOCK_X;
    const int tile = blockIdx.x / per_tile;
    const int x = (blockIdx.x % per_tile) * BLOCK_X + threadIdx.y;
    const int c0 = blockIdx.y * CPT;
    const int nc = min(CPT, n_chan - c0);
    const size_t col = (size_t)tile * (TILE_X * TILE_Y * TILE_Z) +
                       (size_t)x * (TILE_Y * TILE_Z) + z;
    float acc[CPT];
    column_sums(freqs, amp, rest, scale, yv, hkt, col, TILE_Y, TILE_Z, c0,
                nc, nu0, w, acc);
    const size_t o = ((size_t)tile * n_chan + c0) * (TILE_X * TILE_Z) +
                     (size_t)x * TILE_Z + z;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        if (j < nc) out[o + (size_t)j * (TILE_X * TILE_Z)] = acc[j];
    }
}

// Full (nx, ny, nz) grid -> maps (n_chan, nx, nz); ragged edges masked.
__global__ void __launch_bounds__(BLOCK_Z * BLOCK_X)
rrl_cube_kernel(const float* __restrict__ freqs,
                const float* __restrict__ amp,
                const float* __restrict__ rest,
                const float* __restrict__ scale,
                const float* __restrict__ yv,
                const float* __restrict__ hkt, float* __restrict__ out,
                int nx, int ny, int nz, int n_chan, float nu0, Weideman w) {
    const int z = blockIdx.x * BLOCK_Z + threadIdx.x;
    const int x = blockIdx.y * BLOCK_X + threadIdx.y;
    if (x >= nx || z >= nz) return;
    const int c0 = blockIdx.z * CPT;
    const int nc = min(CPT, n_chan - c0);
    const size_t col = (size_t)x * ny * nz + z;
    float acc[CPT];
    column_sums(freqs, amp, rest, scale, yv, hkt, col, ny, (size_t)nz, c0,
                nc, nu0, w, acc);
    const size_t plane = (size_t)nx * nz;
    const size_t o = (size_t)c0 * plane + (size_t)x * nz + z;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        if (j < nc) out[o + (size_t)j * plane] = acc[j];
    }
}

// Host entry points.  Each launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" {

int rrl_tiles(const float* freqs, const float* amp, const float* rest,
              const float* scale, const float* yv, const float* hkt,
              float* out, int n_act, int n_chan, float nu0, Weideman w,
              void* stream) {
    const dim3 block(BLOCK_Z, BLOCK_X);
    const dim3 grid(n_act * (TILE_X / BLOCK_X), (n_chan + CPT - 1) / CPT);
    rrl_tiles_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        freqs, amp, rest, scale, yv, hkt, out, n_chan, nu0, w);
    return (int)cudaGetLastError();
}

int rrl_cube(const float* freqs, const float* amp, const float* rest,
             const float* scale, const float* yv, const float* hkt,
             float* out, int nx, int ny, int nz, int n_chan, float nu0,
             Weideman w, void* stream) {
    const dim3 block(BLOCK_Z, BLOCK_X);
    const dim3 grid((nz + BLOCK_Z - 1) / BLOCK_Z, (nx + BLOCK_X - 1) / BLOCK_X,
                    (n_chan + CPT - 1) / CPT);
    rrl_cube_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        freqs, amp, rest, scale, yv, hkt, out, nx, ny, nz, n_chan, nu0, w);
    return (int)cudaGetLastError();
}

}  // extern "C"
