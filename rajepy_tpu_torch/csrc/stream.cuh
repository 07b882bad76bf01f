// Streaming front and sparse back of the two full-grid kernels
// (epoch_full_kernel in epoch_maps.cu, emergent_full_kernel in
// emergent_maps.cu).
//
// Both walk every (x, z) column of an (nx, ny, nz) cube `base` along y and
// need a second cube only where base != 0, which is a few cells in a
// thousand of a jet grid and none of a jet-free one.  A loop of the form
//   b = base[i]; if (b == 0) continue; ...
// keeps one 4-byte load per thread in flight, so it is bound by the
// latency of device memory, not by its rate.  Here the read of base is
// taken out of the consumer's hands:
//
//   * front: a strip of STRIP_W = 32 neighbouring z columns of one x (128
//     contiguous bytes per y row) is brought CY rows at a time into a ring
//     of NSTAGE shared-memory stages by asynchronous copies (cp.async
//     groups; the 16-byte form, four rows per warp instruction).  NSTAGE - 1
//     chunks are always in flight per strip, whatever the consumer does;
//     the chunks follow the walk's direction (downwards in y for an
//     observer at +y), so no flipped copy of a cube exists;
//   * ragged route: 16-byte copies need nz % 4 == 0, a 16-byte aligned
//     cube and a strip that lies wholly inside the grid.  Any other strip
//     takes 4-byte asynchronous copies, one row per warp instruction, with
//     the columns beyond nz and the rows beyond ny zero-filled in shared
//     memory (masked, not padded): the same ring, the same consumer;
//   * back: when its copies of a chunk have landed, each thread reads back
//     the pieces it copied itself and the vote that every thread's part is
//     folded into the barrier that publishes the stage (__syncthreads_or,
//     or __any_sync for a warp's own ring), so asking whether a chunk holds
//     any non-zero value costs the same however many warps share the ring.
//     If none does, the chunk is done.  If one does, each lane reads its
//     own column's values from the stage and only lanes with base != 0
//     touch the second cube and do arithmetic, in y order, in registers:
//     the order of every column's sum is that of a plain loop over y.
//
// The ring is private to a warp (BLOCK = false: the warp's lanes copy what
// they consume, __syncwarp orders them) or shared by a block's warps
// (BLOCK = true: every thread of the block copies, __syncthreads orders
// them, and every thread of the block walks the same strip).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define STRIP_W 32

// One strip: STRIP_W neighbouring columns of one x of an (nx, ny, nz) cube.
struct Strip {
    const float* src;  // cell (x, 0, z0) of the cube
    int ny;            // rows of a column
    int nz;            // floats between two rows
    int ncol;          // columns of the strip inside the grid, 1 .. STRIP_W
    int down;          // 0: walk y upwards from 0; 1: downwards from ny - 1
    int vec;           // 1: every row is a 16-byte aligned run of 128 bytes
};

__device__ __forceinline__ Strip make_strip(const float* cube, int x, int ny,
                                            int nz, int z0, int down) {
    Strip s;
    s.src = cube + (size_t)x * ny * nz + z0;
    s.ny = ny;
    s.nz = nz;
    s.ncol = min(STRIP_W, nz - z0);
    s.down = down;
    s.vec = s.ncol == STRIP_W && (nz & 3) == 0 &&
            (reinterpret_cast<uintptr_t>(cube) & 15) == 0;
    return s;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The ring's barrier, with a vote: true for every thread when `pred` holds
// for any thread that shares the ring.
template <bool BLOCK>
__device__ __forceinline__ bool ring_sync_any(bool pred) {
    if (BLOCK) return __syncthreads_or(pred) != 0;
    const bool any = __any_sync(0xffffffffu, pred) != 0;
    __syncwarp();
    return any;
}

// Starts the copies of chunk `chunk` (walk steps chunk * CY ..) into
// `stage` (CY x STRIP_W floats), shared among `nthr` threads of which this
// is thread `tid`.  Steps beyond ny and columns beyond the grid are
// zero-filled.  Does not commit.
template <int CY>
__device__ __forceinline__ void strip_copy(float* stage, const Strip& s,
                                            int chunk, int tid, int nthr) {
    const int k0 = chunk * CY;
    if (s.vec) {
        for (int p = tid; p < CY * (STRIP_W / 4); p += nthr) {
            const int k = p / (STRIP_W / 4);
            const int q = (p % (STRIP_W / 4)) * 4;
            float* dst = stage + k * STRIP_W + q;
            const int step = k0 + k;
            if (step < s.ny) {
                const int y = s.down ? s.ny - 1 - step : step;
                cp_async16(dst, s.src + (size_t)y * s.nz + q);
            } else {
                *reinterpret_cast<float4*>(dst) =
                    make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
        }
    } else {
        for (int p = tid; p < CY * STRIP_W; p += nthr) {
            const int k = p / STRIP_W;
            const int q = p % STRIP_W;
            float* dst = stage + k * STRIP_W + q;
            const int step = k0 + k;
            if (step < s.ny && q < s.ncol) {
                const int y = s.down ? s.ny - 1 - step : step;
                cp_async4(dst, s.src + (size_t)y * s.nz + q);
            } else {
                *dst = 0.0f;
            }
        }
    }
}

// True when any value that this thread copied into `stage` (the pieces
// strip_copy gave it) is non-zero; a NaN counts, -0 does not.  Called once
// the thread's own copies have landed.
template <int CY>
__device__ __forceinline__ bool strip_own_any(const float* stage,
                                              const Strip& s, int tid,
                                              int nthr) {
    unsigned bits = 0;
    if (s.vec) {
        for (int p = tid; p < CY * (STRIP_W / 4); p += nthr) {
            const uint4 w = reinterpret_cast<const uint4*>(stage)[p];
            bits |= w.x | w.y | w.z | w.w;
        }
    } else {
        for (int p = tid; p < CY * STRIP_W; p += nthr)
            bits |= reinterpret_cast<const unsigned*>(stage)[p];
    }
    return (bits & 0x7fffffffu) != 0;
}

// The walk over one strip.  start() puts the first NSTAGE - 1 chunks in
// flight; acquire(c, any), called for c = 0, 1, .. n_chunks - 1 in turn,
// returns the stage that holds chunk c (CY x STRIP_W floats, row k = walk
// step c * CY + k, i.e. y = step, or ny - 1 - step when walking down), sets
// `any` when one of its values is non-zero, and starts the copies of chunk
// c + NSTAGE - 1.  The stage stays valid until the next acquire.  `ring`
// holds NSTAGE * CY * STRIP_W floats, 16-byte aligned; it is shared by
// `nthr` threads of which this is thread `tid`.
template <int CY, int NSTAGE, bool BLOCK>
struct StripStream {
    static_assert(NSTAGE >= 2, "a ring has at least two stages");
    float* ring;
    Strip s;
    int tid, nthr, n_chunks;

    __device__ __forceinline__ StripStream(float* ring_, const Strip& s_,
                                           int tid_, int nthr_)
        : ring(ring_), s(s_), tid(tid_), nthr(nthr_),
          n_chunks((s_.ny + CY - 1) / CY) {}

    __device__ __forceinline__ void start() {
#pragma unroll
        for (int c = 0; c < NSTAGE - 1; ++c) {
            if (c < n_chunks)
                strip_copy<CY>(ring + c * (CY * STRIP_W), s, c, tid, nthr);
            cp_async_commit();
        }
    }

    __device__ __forceinline__ const float* acquire(int c, bool& any) {
        // chunk c has landed for this thread, which looks at its own part;
        // the barrier makes every thread's part visible, gathers the
        // votes, and retires the reads of chunk c - 1, whose stage the
        // next copies overwrite
        const float* stage = ring + (c % NSTAGE) * (CY * STRIP_W);
        cp_async_wait<NSTAGE - 2>();
        any = ring_sync_any<BLOCK>(strip_own_any<CY>(stage, s, tid, nthr));
        const int ahead = c + NSTAGE - 1;
        if (ahead < n_chunks)
            strip_copy<CY>(ring + (ahead % NSTAGE) * (CY * STRIP_W), s,
                            ahead, tid, nthr);
        cp_async_commit();
        return stage;
    }
};
