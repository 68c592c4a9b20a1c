// Shi-Tomasi corner response, one pass image -> response, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pmv_tpu/frontend/pallas_kernels.py
// (min_eig_response): central-difference gradients, their products, a 3x3
// box blur of each product, then mean - sqrt(d^2 + Ixy^2).
//
// Border semantics are those of image.min_eig_response (the plain version):
// the gradient is zero on the 1-px image border and the box blur replicates
// the edge. The whole image, border included, agrees with the plain version.
//
// Bound: bytes (one image read, one response written; ~60 flops a pixel are
// far below the card's float32 rate). The plain version writes and re-reads
// eight full-size intermediates; here a 32x16 output tile stages its input
// with a 2-px apron in shared memory, forms the gradient products on the
// 1-px apron in shared memory and writes each output once. The TPU design's
// row bands, 8-row halo and 128-lane width padding are gone.
//
// Compiled with --fmad=false so that every product and sum rounds as in the
// plain version.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;
constexpr int TH = 16;
constexpr int IW = TW + 4;  // staged image tile
constexpr int IH = TH + 4;
constexpr int PW = TW + 2;  // gradient-product tile
constexpr int PH = TH + 2;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// 3x3 box blur at output (oy, ox) of a product tile whose origin lies one
// pixel up and left; additions in the plain version's order.
__device__ __forceinline__ float box3(const float (*p)[PW], int oy, int ox) {
    const float h0 = (p[oy][ox] + p[oy][ox + 1] + p[oy][ox + 2]) / 3.0f;
    const float h1 = (p[oy + 1][ox] + p[oy + 1][ox + 1] + p[oy + 1][ox + 2]) / 3.0f;
    const float h2 = (p[oy + 2][ox] + p[oy + 2][ox + 1] + p[oy + 2][ox + 2]) / 3.0f;
    return (h0 + h1 + h2) / 3.0f;
}

__global__ void min_eig_kernel(const float* __restrict__ img, int H, int W,
                               float* __restrict__ out) {
    __shared__ float s_img[IH][IW];
    __shared__ float s_xx[PH][PW];
    __shared__ float s_yy[PH][PW];
    __shared__ float s_xy[PH][PW];

    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int tid = threadIdx.y * TW + threadIdx.x;
    const int nthreads = TW * TH;

    for (int i = tid; i < IH * IW; i += nthreads) {
        const int ty = i / IW, tx = i - ty * IW;
        const int y = clampi(y0 - 2 + ty, 0, H - 1);
        const int x = clampi(x0 - 2 + tx, 0, W - 1);
        s_img[ty][tx] = img[(size_t)y * W + x];
    }
    __syncthreads();

    for (int i = tid; i < PH * PW; i += nthreads) {
        const int py = i / PW, px = i - py * PW;
        // Edge replication of the products: evaluate at the clamped pixel.
        const int y = clampi(y0 - 1 + py, 0, H - 1);
        const int x = clampi(x0 - 1 + px, 0, W - 1);
        float gx = 0.0f, gy = 0.0f;
        if (y > 0 && y < H - 1 && x > 0 && x < W - 1) {
            const int ty = y - (y0 - 2), tx = x - (x0 - 2);
            gx = (s_img[ty][tx + 1] - s_img[ty][tx - 1]) * 0.5f;
            gy = (s_img[ty + 1][tx] - s_img[ty - 1][tx]) * 0.5f;
        }
        s_xx[py][px] = gx * gx;
        s_yy[py][px] = gy * gy;
        s_xy[py][px] = gx * gy;
    }
    __syncthreads();

    const int ox = threadIdx.x, oy = threadIdx.y;
    const int x = x0 + ox, y = y0 + oy;
    if (x >= W || y >= H) return;

    const float Ixx = box3(s_xx, oy, ox);
    const float Iyy = box3(s_yy, oy, ox);
    const float Ixy = box3(s_xy, oy, ox);
    const float mean = (Ixx + Iyy) * 0.5f;
    const float d = (Ixx - Iyy) * 0.5f;
    const float rad = sqrtf(d * d + Ixy * Ixy);
    out[(size_t)y * W + x] = mean - rad;
}

}  // namespace

// img, out: (H, W) float32, contiguous.
extern "C" int pmv_min_eig_response(const float* img, int H, int W, float* out,
                                    cudaStream_t stream) {
    dim3 block(TW, TH);
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    min_eig_kernel<<<grid, block, 0, stream>>>(img, H, W, out);
    return (int)cudaGetLastError();
}
