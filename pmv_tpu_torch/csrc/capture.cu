// LK search-region block capture for Hopper (sm_90a).
//
// Replaces the TPU kernel pmv_tpu/frontend/pallas_capture.py (_capture_call,
// entry capture_level): for each feature, the (Rg, Rg) block of the
// edge-padded pyramid level whose top-left corner is the integer origin
// (r0, c0) = floor(center - half) - m, clipped to the padded level. Pure
// extraction, no arithmetic on pixels, so the result is bit-exact.
//
// Where it runs: at init and after a reseed only, when the cached blocks do
// not cover the new feature positions. On a tracked frame the level kernel
// (lk.cu) captures its own region and hands it on.
//
// Bound: bytes by the roofline (each block element is read once and written
// once; nothing is computed); in fact the latency of a block's dependent
// accesses: centre, then region, then the write. What the design does:
// - it reads the unpadded level at clamped coordinates (region.cuh), so no
//   padded copy of the level is written and read back first;
// - one thread block per feature derives its own origin and stages the
//   region in shared memory with the same asynchronous copies as lk.cu
//   (region.cuh: a warp per row, lanes over columns, no index divided), so
//   all of a block's reads are in flight at once, one round trip deep;
// - the block is then written out as one flat, fully coalesced copy;
// - the level is at most 1.8 MB and stays in the 50 MB L2 while 512
//   overlapping regions read it.
// The TPU design's aligned slab, rotate pair and post-crop served its
// tile-granular slicing and are gone.

#include <cuda_runtime.h>

#include "region.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void capture_kernel(const float* __restrict__ level, int H, int W,
                               int pad, const float* __restrict__ center,
                               int Rg, int win, float* __restrict__ out,
                               int* __restrict__ r0_out,
                               int* __restrict__ c0_out) {
    extern __shared__ float s_reg[];  // Rg*Rg
    const int n = blockIdx.x;
    const int r0 = pmv::region_origin(center[2 * n + 1], win, Rg, H + 2 * pad);
    const int c0 = pmv::region_origin(center[2 * n], win, Rg, W + 2 * pad);
    pmv::stage_region(s_reg, level, H, W, pad, r0, c0, Rg, WARPS);
    if (threadIdx.x == 0) {
        r0_out[n] = r0;
        c0_out[n] = c0;
    }
    pmv::wait_staged();
    __syncthreads();
    const int rr = Rg * Rg;
    float* dst = out + (size_t)n * rr;
    for (int i = threadIdx.x; i < rr; i += THREADS) dst[i] = s_reg[i];
}

}  // namespace

// level: (H, W) float32, unpadded; pad: the edge padding the coordinates
// assume; center: (N, 2) float32 (u=column, v=row) in padded coordinates;
// out: (N, Rg, Rg) float32; r0_out, c0_out: (N,) int32 block origins in
// padded coordinates.
extern "C" int pmv_capture_level(const float* level, int H, int W, int pad,
                                 const float* center, int N, int Rg, int win,
                                 float* out, int* r0_out, int* c0_out,
                                 cudaStream_t stream) {
    if (N <= 0) return 0;
    const size_t bytes = (size_t)Rg * Rg * sizeof(float);
    if (bytes > 48 * 1024) {
        int err = (int)cudaFuncSetAttribute(
            capture_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (err) return err;
    }
    capture_kernel<<<N, THREADS, bytes, stream>>>(level, H, W, pad, center, Rg,
                                                  win, out, r0_out, c0_out);
    return (int)cudaGetLastError();
}
