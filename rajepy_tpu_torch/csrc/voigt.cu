// The Faddeeva function w(x + iy), y >= 0, elementwise for Hopper (sm_90a),
// with a plain C interface loaded through ctypes by
// rajepy_tpu_torch/ops/kernels.py (wrapper ``wofz_kernel``).
//
// It replaces no TPU kernel: the JAX package leaves rajepy_tpu/ops/voigt.py's
// wofz to XLA, which fuses the whole scheme into one loop.  Eager PyTorch
// cannot: ops/voigt.py's plain version dispatches one operation per term on
// the whole tensor (~1,135 operations a float64 call, 90% of an RRL fit
// step's), so it got a kernel of its own.  The autograd Function around it
// (ops/voigt._Wofz) and its derivative from the Faddeeva ODE stay in
// PyTorch.
//
// The scheme is ops/voigt.py's, term for term, and so are the constants:
//   * float64: the Weideman (1994) rational of degree N = 128 where
//     |x| + y <= 9, a 15-level Laplace continued fraction beyond; for
//     y < 3e-5 both parts are Taylor-expanded to y^3 from the real axis,
//     where Re w = exp(-x^2) (the composite evaluated at y = 0);
//   * float32: Weideman N = 32 where |x| + y <= 8, a 9-level fraction
//     beyond.
// The host computes the coefficients once (ops/voigt._weideman_coeffs) and
// passes them by value, so they sit in the launch's constant bank, and the
// loops are unrolled whole so that each coefficient is a constant operand.
// One thread evaluates one element with every term in registers; a thread
// takes only its own branch (the plain version computes both everywhere
// and selects).
//
// Rounding: compiled with -fmad=false, every operation rounds as the eager
// chain's does, in its order.  PyTorch's CUDA division of a tensor by a
// Python number multiplies by the number's reciprocal, rounded in the
// tensor's type, and so do these kernels at the same places (RSQRT_PI,
// SIXTH); a number added to or multiplying a float32 tensor is first
// rounded to float32.
//
// What bounds it: float64 operations.  An interior element costs ~950
// (127 Horner steps of 7), against 32 bytes of inputs and outputs.
#include <cuda_runtime.h>
#include <stddef.h>

#define SQRT_PI 1.7724538509055159

// Weideman scale L and coefficients, highest power first.  Mirrors the
// ctypes Structures _WofzCoeffs64 and _WofzCoeffs32 in ops/kernels.py.
template <typename T, int N>
struct WofzCoeffs {
    T ell;
    T a[N];
};

typedef WofzCoeffs<double, 128> WofzCoeffs64;
typedef WofzCoeffs<float, 32> WofzCoeffs32;

// ops/voigt._wofz_core at one element, x and y >= 0 of type T.
template <typename T, int N, int LEVELS>
__device__ __forceinline__ void wofz_core(T x, T y, T cut,
                                          const WofzCoeffs<T, N>& c, T& wr,
                                          T& wi) {
    const T rsqrt_pi = T(1) / T(SQRT_PI);
    if (fabs(x) + y > cut) {
        // far wings: w = (i/sqrt(pi)) / (z - (1/2)/(z - 1/(z - ...)))
        T rr = T(0), ri = T(0);
#pragma unroll
        for (int k = LEVELS; k > 0; --k) {
            const T den_r = x - rr;
            const T den_i = y - ri;
            const T den = den_r * den_r + den_i * den_i;
            rr = T(k / 2.0) * den_r / den;
            ri = T(-(k / 2.0)) * den_i / den;
        }
        const T den_r = x - rr;
        const T den_i = y - ri;
        const T den = den_r * den_r + den_i * den_i;
        const T d = den * T(SQRT_PI);
        wr = den_i / d;
        wi = den_r / d;
        return;
    }
    // interior: Z = (L + iz)/(L - iz), z = x + iy
    const T dr = c.ell + y, di = -x;
    const T nr = c.ell - y, ni = x;
    const T den = dr * dr + di * di;
    const T zr = (nr * dr + ni * di) / den;
    const T zi = (ni * dr - nr * di) / den;
    // Horner evaluation of p(Z) = sum a_k Z^k
    T pr = c.a[0], pi = T(0);
#pragma unroll
    for (int k = 1; k < N; ++k) {
        const T qr = pr * zr - pi * zi + c.a[k];
        pi = pr * zi + pi * zr;
        pr = qr;
    }
    // w = 2 p / (L - iz)^2 + (1/sqrt(pi)) / (L - iz)
    const T inv_r = dr / den, inv_i = -di / den;
    const T inv2_r = inv_r * inv_r - inv_i * inv_i;
    const T inv2_i = T(2) * inv_r * inv_i;
    wr = T(2) * (pr * inv2_r - pi * inv2_i) + inv_r * rsqrt_pi;
    wi = T(2) * (pr * inv2_i + pi * inv2_r) + inv_i * rsqrt_pi;
}

__global__ void __launch_bounds__(256)
wofz_f64_kernel(const double* __restrict__ xs, const double* __restrict__ ys,
                double* __restrict__ re, double* __restrict__ im, size_t n,
                WofzCoeffs64 c) {
    const double sixth = 1.0 / 6.0;
    const double two_rsqrt_pi = 2.0 / SQRT_PI;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        const double x = xs[i], y = ys[i];
        const bool tiny = y < 3e-5;
        double wr, wi;
        wofz_core<double, 128, 15>(x, tiny ? 0.0 : y, 9.0, c, wr, wi);
        if (tiny) {
            // Re w on the axis is exp(-x^2) exactly; Taylor both parts up
            // to y^3 from w' = -2 z w + 2i/sqrt(pi)
            const double w0r = exp(-x * x);
            const double w0i = wi;
            const double d1r = -2.0 * x * w0r;
            const double d1i = -2.0 * x * w0i + two_rsqrt_pi;
            const double d2r = -2.0 * w0r - 2.0 * x * d1r;
            const double d2i = -2.0 * w0i - 2.0 * x * d1i;
            const double d3r = -4.0 * d1r - 2.0 * x * d2r;
            const double d3i = -4.0 * d1i - 2.0 * x * d2i;
            const double y2 = y * y;
            const double y3 = y2 * y * sixth;
            wr = w0r - y * d1i - 0.5 * y2 * d2r + y3 * d3i;
            wi = w0i + y * d1r - 0.5 * y2 * d2i - y3 * d3r;
        }
        re[i] = wr;
        im[i] = wi;
    }
}

__global__ void __launch_bounds__(256)
wofz_f32_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                float* __restrict__ re, float* __restrict__ im, size_t n,
                WofzCoeffs32 c) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        float wr, wi;
        wofz_core<float, 32, 9>(xs[i], ys[i], 8.0f, c, wr, wi);
        re[i] = wr;
        im[i] = wi;
    }
}

// blocks of 256 threads, one element a thread, at most 8 resident blocks'
// worth an SM (132 SMs) before the grid strides
static unsigned wofz_blocks(size_t n) {
    const size_t want = (n + 255) / 256;
    const size_t most = (size_t)132 * 8 * 16;
    return (unsigned)(want < most ? want : most);
}

extern "C" {

int wofz_f64(const double* x, const double* y, double* re, double* im,
             size_t n, const WofzCoeffs64* c, void* stream) {
    wofz_f64_kernel<<<wofz_blocks(n), 256, 0, (cudaStream_t)stream>>>(
        x, y, re, im, n, *c);
    return (int)cudaGetLastError();
}

int wofz_f32(const float* x, const float* y, float* re, float* im, size_t n,
             const WofzCoeffs32* c, void* stream) {
    wofz_f32_kernel<<<wofz_blocks(n), 256, 0, (cudaStream_t)stream>>>(
        x, y, re, im, n, *c);
    return (int)cudaGetLastError();
}

}  // extern "C"
