// Search-region geometry shared by capture.cu (capture_level) and lk.cu
// (lk_iterate): one definition of where a feature's (Rg, Rg) region lies
// and of how it is read.
//
// Positions and origins are in the coordinates of the level edge-padded by
// `pad` on every side, as the tracker's host code computes them. The padded
// copy itself is never made: a padded pixel (r, c) is the level's pixel at
// the clamped coordinates (r - pad, c - pad), which is edge replication bit
// for bit.
//
// A region is staged in shared memory by asynchronous 4-byte copies
// (cp.async): rows start at arbitrary columns of the level, so nothing wider
// is aligned, but all of a block's copies are in flight at once and no
// thread holds a register for them. A warp takes a region row and its lanes
// the columns, so no index is divided and a row's clamp is computed once.

#pragma once

#include <cuda_runtime.h>

namespace pmv {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Integer origin along one axis of the region around float position `c`:
// floor(c - half) - m, clipped so that the region lies inside the padded
// extent `padded`. half = (win - 1) / 2, m = (Rg - win) / 2 centres the
// region on the position. Same arithmetic, in float32, as
// lucas_kanade.block_origins.
__device__ __forceinline__ int region_origin(float c, int win, int Rg,
                                             int padded) {
    const float half = (float)(win - 1) / 2.0f;
    const int m = (Rg - win) / 2;
    return clampi((int)floorf(c - half) - m, 0, max(padded - Rg, 0));
}

// Source index inside the unpadded level (extent n) of padded coordinate p.
__device__ __forceinline__ int clamped_source(int p, int pad, int n) {
    return clampi(p - pad, 0, n - 1);
}

// Start the copies of the (Rg, Rg) region with origin (r0, c0) (padded
// coordinates) of the unpadded (H, W) level into s_reg (row-major, Rg*Rg
// floats of shared memory). Called by all `warps` warps of the block; the
// copies have landed after wait_staged() and a block barrier.
__device__ __forceinline__ void stage_region(float* s_reg,
                                             const float* __restrict__ level,
                                             int H, int W, int pad, int r0,
                                             int c0, int Rg, int warps) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < Rg; r += warps) {
        const float* src = level + (size_t)clamped_source(r0 + r, pad, H) * W;
        for (int c = lane; c < Rg; c += 32) {
            const unsigned dst =
                (unsigned)__cvta_generic_to_shared(s_reg + r * Rg + c);
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                         "l"(src + clamped_source(c0 + c, pad, W))
                         : "memory");
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies of stage_region.
__device__ __forceinline__ void wait_staged() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace pmv
