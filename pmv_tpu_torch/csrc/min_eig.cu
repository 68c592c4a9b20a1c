// Shi-Tomasi corner response, one pass image -> response, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pmv_tpu/frontend/pallas_kernels.py
// (min_eig_response): central-difference gradients, their products, a 3x3
// box blur of each product, then mean - sqrt(d^2 + Ixy^2).
//
// Border semantics are those of image.min_eig_response (the plain version):
// the gradient is zero on the 1-px image border and the box blur replicates
// the edge. A replicated product is the border pixel's, which is zero, so a
// product is zero wherever its (unclamped) pixel is not strictly inside the
// image. The whole image, border included, agrees with the plain version.
//
// Bound: bytes (one image read, one response written; ~60 flops a pixel are
// far below the card's float32 rate). The plain version writes and re-reads
// eight full-size intermediates. Here the blur is taken as the separable
// pass it is, sliding down the image:
//  - a lane owns a column and a band of BH rows; it loads its column's BH + 4
//    pixels up front (all loads in flight at once, clamped rows), so each
//    pixel is read once per band and its gradient computed once;
//  - the row neighbours come by warp shuffles (the pixels, then the two
//    gradients: six a row): a warp covers 32 columns, the outer two on
//    either side are apron (lanes 0, 31 supply pixels, lanes 1, 30 gradients
//    as well), lanes 2..29 write; no shared memory, no barrier, no index is
//    divided;
//  - per row a lane forms the three products and their horizontal thirds
//    h = (left + centre + right) / 3 and keeps the last three rows of h in
//    registers; an output is (h0 + h1 + h2) / 3 of each, nine adds a pixel.
// The order of additions is the plain version's (columns first, then rows,
// left to right and top to bottom). The TPU design's row bands with an 8-row
// halo and its 128-lane width padding served its tiling and are gone.
//
// Compiled with --fmad=false so that every product and sum rounds as in the
// plain version.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;     // per block; warps are independent
constexpr int OUT_W = 28;    // output columns of a warp: lanes 2..29
// Rows of a band. On a 370x1226 frame on an H100, 4 and 8 measured alike and
// 16 slower (fewer warps to hide the loads behind); 8 forms fewer rows twice.
constexpr int BH = 8;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// x / 3, correctly rounded, in three instructions: with y = RN(1/3) and
// q = RN(x * y), the residual r = x - 3q is exact in one fused multiply-add
// and RN(q + r * y) is the correctly rounded quotient (Markstein's division
// step) — the bits of the plain version's `/ 3.0` without the compiler's
// general division sequence, of which an output takes six.
__device__ __forceinline__ float div3(float x) {
    constexpr float y = 1.0f / 3.0f;
    const float q = __fmul_rn(x, y);
    return __fmaf_rn(__fmaf_rn(-3.0f, q, x), y, q);
}

// Value of `v` in the lane to the left / right. The outermost lanes get
// their own value; they are apron and what they make of it is not used.
__device__ __forceinline__ float from_left(float v) {
    return __shfl_up_sync(0xffffffffu, v, 1);
}
__device__ __forceinline__ float from_right(float v) {
    return __shfl_down_sync(0xffffffffu, v, 1);
}

__global__ void __launch_bounds__(WARPS * 32)
min_eig_kernel(const float* __restrict__ img, int H, int W,
               float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int x = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * OUT_W + lane - 2;
    const int y0 = blockIdx.y * BH;
    if (x - lane + 2 >= W) return;  // the whole warp lies beyond the image

    // Rows y0 - 2 .. y0 + BH + 1 of this lane's column, clamped.
    const float* col = img + clampi(x, 0, W - 1);
    float v[BH + 4];
#pragma unroll
    for (int i = 0; i < BH + 4; ++i)
        v[i] = col[(size_t)clampi(y0 - 2 + i, 0, H - 1) * W];

    const bool x_in = x > 0 && x < W - 1;
    const bool writes = lane >= 2 && lane < 2 + OUT_W && x < W;
    float hxx[3], hyy[3], hxy[3];  // the last three rows of thirds
#pragma unroll
    for (int i = 0; i < BH + 2; ++i) {
        const int y = y0 - 1 + i;  // row of this step's thirds; pixel row v[i + 1]
        float gx = 0.0f, gy = 0.0f;
        {
            const float left = from_left(v[i + 1]), right = from_right(v[i + 1]);
            if (x_in && y > 0 && y < H - 1) {
                gx = (right - left) * 0.5f;
                gy = (v[i + 2] - v[i]) * 0.5f;
            }
        }
        // the neighbours' gradients travel, not their three products
        const float gxl = from_left(gx), gxr = from_right(gx);
        const float gyl = from_left(gy), gyr = from_right(gy);
        hxx[i % 3] = div3(gxl * gxl + gx * gx + gxr * gxr);
        hyy[i % 3] = div3(gyl * gyl + gy * gy + gyr * gyr);
        hxy[i % 3] = div3(gxl * gyl + gx * gy + gxr * gyr);
        if (i >= 2) {
            const int yo = y - 1;
            const float Ixx = div3(hxx[(i - 2) % 3] + hxx[(i - 1) % 3] + hxx[i % 3]);
            const float Iyy = div3(hyy[(i - 2) % 3] + hyy[(i - 1) % 3] + hyy[i % 3]);
            const float Ixy = div3(hxy[(i - 2) % 3] + hxy[(i - 1) % 3] + hxy[i % 3]);
            const float mean = (Ixx + Iyy) * 0.5f;
            const float d = (Ixx - Iyy) * 0.5f;
            const float rad = sqrtf(d * d + Ixy * Ixy);
            if (writes && yo < H) out[(size_t)yo * W + x] = mean - rad;
        }
    }
}

}  // namespace

// img, out: (H, W) float32, contiguous.
extern "C" int pmv_min_eig_response(const float* img, int H, int W, float* out,
                                    cudaStream_t stream) {
    if (H <= 0 || W <= 0) return 0;
    dim3 grid((W + WARPS * OUT_W - 1) / (WARPS * OUT_W), (H + BH - 1) / BH);
    min_eig_kernel<<<grid, WARPS * 32, 0, stream>>>(img, H, W, out);
    return (int)cudaGetLastError();
}
