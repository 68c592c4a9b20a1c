// LK search-region block capture for Hopper (sm_90a).
//
// Replaces the TPU kernel pmv_tpu/frontend/pallas_capture.py (_capture_call,
// entry capture_level): for each feature, copy the (Rg, Rg) block of the
// edge-padded pyramid level whose top-left corner is the integer origin
// (r0, c0) = floor(center - half) - m, clipped to the level (the clipping
// that capture_level does around the TPU kernel is done here by the block
// itself). Pure extraction, no arithmetic on pixels, so the result is
// bit-exact.
//
// Bound: bytes. Each block element is read once and written once; nothing is
// computed. One thread block per feature derives its own origin and strides
// over the Rg*Rg elements, so writes are fully coalesced and reads are
// coalesced along each Rg-wide row segment. The TPU design's aligned slab,
// rotate pair and post-crop served its tile-granular slicing and are gone.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void capture_kernel(const float* __restrict__ img, int Hp, int Wp,
                               const float* __restrict__ center, int Rg,
                               int win, float* __restrict__ out,
                               int* __restrict__ r0_out,
                               int* __restrict__ c0_out) {
    const int n = blockIdx.x;
    const float half = (float)(win - 1) / 2.0f;
    const int m = (Rg - win) / 2;  // center the block on the capture position
    const int r0 = clampi((int)floorf(center[2 * n + 1] - half) - m, 0,
                          max(Hp - Rg, 0));
    const int c0 = clampi((int)floorf(center[2 * n] - half) - m, 0,
                          max(Wp - Rg, 0));
    if (threadIdx.x == 0) {
        r0_out[n] = r0;
        c0_out[n] = c0;
    }
    const float* src = img + (size_t)r0 * Wp + c0;
    float* dst = out + (size_t)n * Rg * Rg;
    const int total = Rg * Rg;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int r = i / Rg;
        const int c = i - r * Rg;
        dst[i] = src[(size_t)r * Wp + c];
    }
}

}  // namespace

// img: (Hp, Wp) float32 with Hp, Wp >= Rg; center: (N, 2) float32 (u=column,
// v=row) in the image's coordinates; out: (N, Rg, Rg) float32; r0_out,
// c0_out: (N,) int32 block origins.
extern "C" int pmv_capture_level(const float* img, int Hp, int Wp,
                                 const float* center, int N, int Rg, int win,
                                 float* out, int* r0_out, int* c0_out,
                                 cudaStream_t stream) {
    if (N > 0) {
        capture_kernel<<<N, 256, 0, stream>>>(img, Hp, Wp, center, Rg, win, out,
                                              r0_out, c0_out);
    }
    return (int)cudaGetLastError();
}
