// The LTE channel stage of an RRL run for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by rajepy_tpu_torch/ops/kernels.py
// (wrapper ``rrl_flux_maps``).
//
// For every channel c and (x, z) pixel p inside the jet's silhouette:
//   tau_c = scale[c] * A[p]
//   I_L   = B_nu(T[p]) e^{-tau_c} (1 - e^{-tau_L[c, p]}) * 1e-7 * 1e4
//   flux  = I_L * fscale  (+ fscale * 2 nu^2 k_B T[p] (1 - e^{-tau_c}) / c^2
//                          unless contsub)
// and flux = 0 exactly outside it.  The plain version is
// ops/radtrans.rrl_flux_maps_lte: radtrans.intensity_rrl_maps (with
// physics.blackbody_nu's cube-root prefactor and expm1 forms) times
// radtrans.flux_scale_jy, plus radtrans.flux_ff_maps.
//
// It replaces no TPU kernel: the JAX package leaves this stage to XLA,
// which fuses it into one loop.  Eager PyTorch runs ~25 passes over the
// (n_chan, nx, nz) maps, reading and writing a 1 GB temporary in each at
// 1,000 channels of a 512^2 image.
//
// What bounds it: bytes.  It must write the flux maps (4 B an element) and
// read tau_L where the pixel lies inside the silhouette (4 B more); the
// 2-D maps and the channel vectors are a few MB.  Inside the silhouette an
// element costs two divisions, three expm1f and one expf, a few dozen
// float32 operations for 8 bytes, below the card's balance.  So:
//   * tau_c is formed in registers and never stored;
//   * a thread owns V = 4 neighbouring pixels along z (1 where the maps do
//     not allow 16-byte accesses) and loads their A, T and silhouette flag
//     once, then walks a block of CB channels: each step reads tau_L with
//     one 16-byte load, only where one of its pixels is inside, and writes
//     the flux with one 16-byte store, coalesced across the warp;
//   * a thread whose pixels all lie outside writes zeros and reads nothing;
//   * each block computes its CB channels' constants (h nu, the B_nu
//     prefactor cubed, 2 nu^2 k_B, the continuum scale) once into shared
//     memory, as the plain version computes them once per channel.
//
// Rounding: float32 with expf/expm1f, no fast-math intrinsics, compiled
// with -fmad=false, so every operation rounds as the eager chain's does, in
// its order.  A number that multiplies a float32 tensor is first rounded to
// float32 (the constants come from the host as floats), and PyTorch's
// division of a tensor by a Python number multiplies by the number's
// reciprocal rounded in float32 (1 / c^2 here).
#include <cuda_runtime.h>
#include <stddef.h>

// Physical constants, each rounded to float32 on the host.  Mirrors the
// ctypes Structure _RrlFluxConsts in ops/kernels.py.
struct RrlFluxConsts {
    float bb_cbrt;  // (2 h / c^2)^(1/3), cgs
    float h_cgs;    // h, cgs
    float k_cgs;    // k_B, cgs
    float k_b;      // k_B, SI
    float c2;       // c^2, SI
    float fscale;   // arctan(csize / d)^2 / 1e-26
};

#define THREADS 256
// channels a block
#define CB 64

template <int V>
struct Vec;

template <>
struct Vec<4> {
    static __device__ __forceinline__ void load(const float* p, float* v) {
        const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    }
    static __device__ __forceinline__ void store(float* p, const float* v) {
        __stcs(reinterpret_cast<float4*>(p),
               make_float4(v[0], v[1], v[2], v[3]));
    }
};

template <>
struct Vec<1> {
    static __device__ __forceinline__ void load(const float* p, float* v) {
        v[0] = __ldcs(p);
    }
    static __device__ __forceinline__ void store(float* p, const float* v) {
        __stcs(p, v[0]);
    }
};

template <int V>
__global__ void __launch_bounds__(THREADS)
rrl_flux_kernel(const float* __restrict__ freqs,
                const float* __restrict__ scale,
                const float* __restrict__ a_map,
                const float* __restrict__ tbar,
                const unsigned char* __restrict__ any_in,
                const float* __restrict__ tau_l, float* __restrict__ out,
                int n_chan, int npix, int contsub, RrlFluxConsts k) {
    __shared__ float s_hf[CB], s_t3[CB], s_sc[CB], s_ff[CB];
    const int c0 = blockIdx.y * CB;
    const int nc = min(CB, n_chan - c0);
    if (threadIdx.x < nc) {
        const float f = freqs[c0 + threadIdx.x];
        const float t = k.bb_cbrt * f;
        s_t3[threadIdx.x] = t * t * t;
        s_hf[threadIdx.x] = k.h_cgs * f;
        s_ff[threadIdx.x] = 2.0f * (f * f) * k.k_b;
        s_sc[threadIdx.x] = scale[c0 + threadIdx.x];
    }
    __syncthreads();
    const int p0 = (blockIdx.x * THREADS + threadIdx.x) * V;
    if (p0 >= npix) return;   // npix % V == 0: a thread's pixels all exist
    const size_t plane = (size_t)npix;
    float* o = out + (size_t)c0 * plane + p0;
    const float* tl = tau_l + (size_t)c0 * plane + p0;

    bool in[V];
    bool any = false;
    float a[V], tb[V], kt[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        in[v] = any_in[p0 + v] != 0;
        any |= in[v];
        a[v] = in[v] ? a_map[p0 + v] : 0.0f;
        tb[v] = in[v] ? tbar[p0 + v] : 1.0f;
        kt[v] = k.k_cgs * tb[v];
    }
    float r[V];
    if (!any) {
#pragma unroll
        for (int v = 0; v < V; ++v) r[v] = 0.0f;
        for (int c = 0; c < nc; ++c) Vec<V>::store(o + c * plane, r);
        return;
    }
    const float inv_c2 = 1.0f / k.c2;
    const float e7 = (float)1e-7;
    const float e4 = (float)1e4;
    for (int c = 0; c < nc; ++c) {
        float l[V];
        Vec<V>::load(tl + c * plane, l);
        const float hf = s_hf[c], t3 = s_t3[c], sc = s_sc[c], ff = s_ff[c];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            if (!in[v]) {
                r[v] = 0.0f;
                continue;
            }
            const float b_nu = t3 / expm1f(hf / kt[v]);
            const float tau_c = sc * a[v];
            float line = b_nu * expf(-tau_c);
            line = line * (-expm1f(-l[v]));
            line = line * e7;
            line = line * e4;
            float flux = line * k.fscale;
            if (!contsub) {
                const float t_b = tb[v] * (-expm1f(-tau_c));
                float cont = ff * t_b;
                cont = cont * inv_c2;
                cont = cont * k.fscale;
                flux = flux + cont;
            }
            r[v] = flux;
        }
        Vec<V>::store(o + c * plane, r);
    }
}

extern "C" {

// flux (n_chan, npix) from freqs, scale (n_chan,), a_map, tbar, any_in
// (npix,) and tau_l (n_chan, npix); vec != 0 takes 4 pixels a thread
// (npix % 4 == 0, tau_l and out 16-byte aligned: the wrapper checks).
int rrl_flux(const float* freqs, const float* scale, const float* a_map,
             const float* tbar, const unsigned char* any_in,
             const float* tau_l, float* out, int n_chan, int npix, int vec,
             int contsub, const RrlFluxConsts* k, void* stream) {
    const int v = vec ? 4 : 1;
    const int per_block = THREADS * v;
    const dim3 grid((npix + per_block - 1) / per_block,
                    (n_chan + CB - 1) / CB);
    if (vec) {
        rrl_flux_kernel<4><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            freqs, scale, a_map, tbar, any_in, tau_l, out, n_chan, npix,
            contsub, *k);
    } else {
        rrl_flux_kernel<1><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            freqs, scale, a_map, tbar, any_in, tau_l, out, n_chan, npix,
            contsub, *k);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
