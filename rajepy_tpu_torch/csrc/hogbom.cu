// Hogbom's CLEAN minor cycle on a block of channels for Hopper (sm_90a),
// with a plain C interface loaded through ctypes by
// rajepy_tpu_torch/ops/kernels.py (class ``HogbomCycle``).
//
// One iteration, on every channel c still above its threshold:
//   idx   = argmax |res * mask|            (the first of equal maxima)
//   stop unless |res[idx] * mask[idx]| > thr[c]
//   model[idx] += res[idx] * gain          (rounded once)
//   res  -= res[idx] * gain * psf shifted to put its centre on idx
//                                          (rounded once a pixel)
// The plain version is synthobs/imaging._hogbom_plain, the eager step the
// CPU runs: ~25 full-plane passes and ~25 small operations an iteration
// (the masked absolute value, argmax, two gathers of a window out of a
// zero-padded PSF, Veltkamp's split of the window, the Dekker/Knuth
// update), each pass reading and writing 300-600 MB at 153 channels of
// 500^2 float64.
//
// It replaces no TPU kernel: the JAX package's Hogbom is a lax.while_loop
// that XLA compiles, with no Pallas kernel.
//
// What bounds it: bytes.  A channel-iteration must read the residual once
// (its peak) and read the PSF's window and write the residual's window once
// (the subtraction): ~6 MB at 500^2 float64.  The split and the
// error-free product and sum are ~20 operations a pixel, far below the
// card's balance in float64.  So one iteration is two launches:
//   * hogbom_update_peak_kernel, a grid of (tiles of the plane) x
//     (channels): a channel still live first applies the previous
//     iteration's subtraction, only over the overlap of the plane with the
//     PSF centred on the previous peak, reading the unpadded PSF with
//     bounds checks (outside the overlap the window is zero and the plain
//     version changes at most the sign of a zero: those pixels are left
//     as they are), then finds the tile's largest |res * mask| with its
//     lowest flat index from the values in registers, one (value, index)
//     pair a tile.  A finished channel's blocks return at once;
//   * hogbom_component_kernel, one block a channel: reduces the tiles'
//     pairs to the peak, applies the stop test, writes the component,
//     counts the iteration and leaves (peak, gain * res[peak]) for the
//     next launch of the first kernel, or marks the channel finished.
// The first iteration subtracts nothing; after the last, the first kernel
// runs once more to apply the last subtraction alone.
//
// Rounding: every operation is the plain version's, in its order, each
// rounded on its own (compiled with -fmad=false: no contraction):
// Veltkamp's split, Dekker's product and Knuth's sum (imaging._split and
// imaging._sub_product), so every pixel of a finite residual has the
// plain version's bits (a zero's sign aside, see above) and argmax's ties
// fall the same way.  A number that multiplies a float32 tensor is first
// rounded to float32, as PyTorch rounds it.
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stddef.h>

#define THREADS 256
#define WARPS (THREADS / 32)
// pixels a thread of the first kernel; a tile is THREADS * PIX pixels
// (HOGBOM_TILE in ops/kernels.py)
#define PIX 8
#define TILE (THREADS * PIX)

template <typename T>
struct Veltkamp;

template <>
struct Veltkamp<double> {
    static constexpr double k = 134217729.0;    // 2^27 + 1
};

template <>
struct Veltkamp<float> {
    static constexpr float k = 4097.0f;         // 2^12 + 1
};

// imaging._split: a = hi + lo exactly
template <typename T>
__device__ __forceinline__ void split(T a, T& hi, T& lo) {
    const T c = Veltkamp<T>::k * a;
    hi = c - (c - a);
    lo = a - hi;
}

// imaging._sub_product: r - v * x rounded once
template <typename T>
__device__ __forceinline__ T sub_product(T r, T v, T vh, T vl, T x, T xh,
                                         T xl) {
    const T p = v * x;
    const T e = (((vh * xh - p) + vh * xl) + vl * xh) + vl * xl;
    const T s = r - p;
    const T bb = s - r;
    const T t = (r - (s - bb)) + (-p - bb);
    return s + (t - e);
}

// torch.argmax's order: a NaN above every number, and of equal values the
// lowest index first
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
    if (isnan(a)) return !isnan(b) || ia < ib;
    if (isnan(b)) return false;
    return a > b || (a == b && ia < ib);
}

// the block's first largest pair, in thread 0
template <typename T>
__device__ __forceinline__ void block_peak(T& v, int& i) {
    __shared__ T sv[WARPS];
    __shared__ int si[WARPS];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const T v2 = __shfl_down_sync(0xffffffffu, v, o);
        const int i2 = __shfl_down_sync(0xffffffffu, i, o);
        if (before(v2, i2, v, i)) {
            v = v2;
            i = i2;
        }
    }
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    if (l == 0) {
        sv[w] = v;
        si[w] = i;
    }
    __syncthreads();
    if (w == 0) {
        v = l < WARPS ? sv[l] : T(-1);
        i = l < WARPS ? si[l] : INT_MAX;
#pragma unroll
        for (int o = WARPS / 2; o > 0; o >>= 1) {
            const T v2 = __shfl_down_sync(0xffffffffu, v, o);
            const int i2 = __shfl_down_sync(0xffffffffu, i, o);
            if (before(v2, i2, v, i)) {
                v = v2;
                i = i2;
            }
        }
    }
}

// res (nb, n*n) in place; psf (nb, n*n); mask (n*n); live, peak, val (nb);
// part_v, part_i (nb, n_tiles).  subtract: apply the pending subtraction;
// find: write the tiles' peaks.
template <typename T>
__global__ void __launch_bounds__(THREADS)
hogbom_update_peak_kernel(T* __restrict__ res, const T* __restrict__ psf,
                          const T* __restrict__ mask,
                          const int* __restrict__ live,
                          const int* __restrict__ peak,
                          const T* __restrict__ val, T* __restrict__ part_v,
                          int* __restrict__ part_i, int n, int subtract,
                          int find) {
    const int c = blockIdx.y;
    if (!live[c]) return;
    const int npix = n * n;
    const size_t plane = (size_t)c * npix;
    T* r = res + plane;
    const int j0 = blockIdx.x * TILE + threadIdx.x;

    T rv[PIX];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
        const int j = j0 + k * THREADS;
        rv[k] = j < npix ? r[j] : T(0);
    }
    if (subtract) {
        // the window puts the PSF's centre (n/2, n/2) on the peak
        const int h = n / 2;
        const int pk = peak[c];
        const int dy = h - pk / n, dx = h - pk % n;
        const T v = val[c];
        T vh, vl;
        split(v, vh, vl);
        const T* p = psf + plane;
        int at[PIX];
        T wv[PIX];
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
            const int j = j0 + k * THREADS;
            const int y = j / n, x = j - y * n;
            const int yy = y + dy, xx = x + dx;
            at[k] = (j < npix && (unsigned)yy < (unsigned)n &&
                     (unsigned)xx < (unsigned)n) ? yy * n + xx : -1;
            wv[k] = at[k] >= 0 ? p[at[k]] : T(0);
        }
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
            if (at[k] < 0) continue;
            T wh, wl;
            split(wv[k], wh, wl);
            rv[k] = sub_product(rv[k], v, vh, vl, wv[k], wh, wl);
            r[j0 + k * THREADS] = rv[k];
        }
    }
    if (!find) return;
    T best = T(-1);
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
        const int j = j0 + k * THREADS;
        if (j >= npix) break;
        const T m = fabs(rv[k] * mask[j]);
        if (before(m, j, best, bi)) {
            best = m;
            bi = j;
        }
    }
    block_peak(best, bi);
    if (threadIdx.x == 0) {
        const size_t o = (size_t)c * gridDim.x + blockIdx.x;
        part_v[o] = best;
        part_i[o] = bi;
    }
}

// model (nb, n*n); thr, live, peak, val, count (nb); the tiles' pairs of
// the first kernel.
template <typename T>
__global__ void __launch_bounds__(THREADS)
hogbom_component_kernel(const T* __restrict__ res, T* __restrict__ model,
                        const T* __restrict__ thr, int* __restrict__ live,
                        int* __restrict__ peak, T* __restrict__ val,
                        long long* __restrict__ count,
                        const T* __restrict__ part_v,
                        const int* __restrict__ part_i, int n, int n_tiles,
                        T gain) {
    const int c = blockIdx.x;
    if (!live[c]) return;
    T best = T(-1);
    int bi = INT_MAX;
    for (int t = threadIdx.x; t < n_tiles; t += THREADS) {
        const size_t o = (size_t)c * n_tiles + t;
        if (before(part_v[o], part_i[o], best, bi)) {
            best = part_v[o];
            bi = part_i[o];
        }
    }
    block_peak(best, bi);
    if (threadIdx.x != 0) return;
    if (!(best > thr[c])) {
        live[c] = 0;
        return;
    }
    const size_t o = (size_t)c * n * n + bi;
    const T ri = res[o];
    T rh, rl, gh, gl;
    split(ri, rh, rl);
    const T neg_gain = -gain;
    split(neg_gain, gh, gl);
    // the component: model + res * gain, rounded once
    model[o] = sub_product(model[o], ri, rh, rl, neg_gain, gh, gl);
    val[c] = ri * gain;
    peak[c] = bi;
    count[c] += 1;
}

static inline int n_tiles_of(int n) { return (n * n + TILE - 1) / TILE; }

extern "C" {

// The first kernel over nb channels of (n, n) planes; dbl picks float64
// (else float32).  The wrapper checks shapes, types and n * n < 2^31.
int hogbom_update_peak(void* res, const void* psf, const void* mask,
                       const int* live, const int* peak, const void* val,
                       void* part_v, int* part_i, int nb, int n, int dbl,
                       int subtract, int find, void* stream) {
    const dim3 grid(n_tiles_of(n), nb);
    cudaStream_t s = (cudaStream_t)stream;
    if (dbl) {
        hogbom_update_peak_kernel<double><<<grid, THREADS, 0, s>>>(
            (double*)res, (const double*)psf, (const double*)mask, live,
            peak, (const double*)val, (double*)part_v, part_i, n, subtract,
            find);
    } else {
        hogbom_update_peak_kernel<float><<<grid, THREADS, 0, s>>>(
            (float*)res, (const float*)psf, (const float*)mask, live, peak,
            (const float*)val, (float*)part_v, part_i, n, subtract, find);
    }
    return (int)cudaGetLastError();
}

// The second kernel: one block a channel.  gain is rounded to the
// planes' type.
int hogbom_component(const void* res, void* model, const void* thr,
                     int* live, int* peak, void* val, long long* count,
                     const void* part_v, const int* part_i, int nb, int n,
                     int dbl, double gain, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int n_tiles = n_tiles_of(n);
    if (dbl) {
        hogbom_component_kernel<double><<<nb, THREADS, 0, s>>>(
            (const double*)res, (double*)model, (const double*)thr, live,
            peak, (double*)val, count, (const double*)part_v, part_i, n,
            n_tiles, gain);
    } else {
        hogbom_component_kernel<float><<<nb, THREADS, 0, s>>>(
            (const float*)res, (float*)model, (const float*)thr, live, peak,
            (float*)val, count, (const float*)part_v, part_i, n, n_tiles,
            (float)gain);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
