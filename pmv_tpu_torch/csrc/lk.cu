// Pyramidal Lucas-Kanade level kernels for Hopper (sm_90a): template
// statistics and the iteration loop.
//
// Replace the two TPU kernels of pmv_tpu/frontend/pallas_lk.py (_level_call):
// _make_template_kernel -> lk_template, _make_iter_kernel -> lk_iterate.
//
// lk_template: bilinear-sample a (win+2)^2 window from the previous frame's
// cached (Rg, Rg) block at the clipped float offset; T = interior, Ix, Iy =
// central differences * 0.5; Gxx, Gxy, Gyy sums; inv_det (0 where det <=
// 1e-6); min_eig = (mean - rad) / win^2.
//
// lk_iterate: `iters` LK updates per feature with the search region resident
// in shared memory: sample win x win at clip((g - half) - reg0, 0,
// Rg - win - 1.000001), r = T - I, bx = sum r*Ix, by = sum r*Iy,
// du = (Gyy*bx - Gxy*by)*inv_det, dv = (Gxx*by - Gxy*bx)*inv_det,
// g += (dv, du) in (row, col).
//
// Bound: bytes for both (the block or region is read once from device
// memory; the iteration loop itself touches no device memory). One thread
// block per feature; the region (12.1 KB at Rg=55, 28 KB at Rg=84) and
// T/Ix/Iy live in shared memory across the iterations; bx/by and the G sums
// are block reductions (warp shuffle, then a fixed-order sum of the warp
// partials, so every thread holds the same bits and runs are repeatable).
// The TPU design's feature-lanes layout, 128-lane groups, binary-shift
// window select and packed scalar rows are gone: a thread indexes its tap
// directly. The two kernels stay separate here so that each TPU kernel has
// its counterpart.
//
// The bilinear blend is row blend then column blend, (1-f)*a + f*b, as in
// the TPU kernel; compiled with --fmad=false so that it rounds like the
// plain version. Reduction order differs from the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// Bilinear tap at integer (i, j) of a row-major tile of width `stride`:
// rows blended first with fr, then columns with fc.
__device__ __forceinline__ float tap(const float* __restrict__ tile, int stride,
                                     int i, int j, float fr, float fc) {
    const float* p = tile + i * stride + j;
    const float a = (1.0f - fr) * p[0] + fr * p[stride];
    const float b = (1.0f - fr) * p[1] + fr * p[stride + 1];
    return (1.0f - fc) * a + fc * b;
}

// Sum `v` over the block; every thread returns the same value. `part` holds
// WARPS floats of shared memory. Ends with a barrier so `part` can be reused.
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w];
    __syncthreads();
    return s;
}

__global__ void lk_template_kernel(const float* __restrict__ blk,
                                   const float* __restrict__ raw_r,
                                   const float* __restrict__ raw_c, int Rg,
                                   int win, float t_lim,
                                   float* __restrict__ T,
                                   float* __restrict__ Ix,
                                   float* __restrict__ Iy,
                                   float* __restrict__ stats) {
    extern __shared__ float smem[];
    const int n = blockIdx.x;
    const int fw = win + 2;
    float* F = smem;                  // (win+2)^2
    float* part = smem + fw * fw;     // WARPS

    const float* tile = blk + (size_t)n * Rg * Rg;
    const float lr = clampf(raw_r[n], 0.0f, t_lim);
    const float lc = clampf(raw_c[n], 0.0f, t_lim);
    const float fi = floorf(lr), fj = floorf(lc);
    const float fr = lr - fi, fc = lc - fj;
    const int i0 = (int)fi, j0 = (int)fj;

    for (int i = threadIdx.x; i < fw * fw; i += THREADS) {
        const int a = i / fw, b = i - a * fw;
        F[i] = tap(tile, Rg, i0 + a, j0 + b, fr, fc);
    }
    __syncthreads();

    float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
    const size_t base = (size_t)n * win * win;
    for (int i = threadIdx.x; i < win * win; i += THREADS) {
        const int a = i / win, b = i - a * win;
        const float* f = F + (a + 1) * fw + (b + 1);
        const float ix = (f[1] - f[-1]) * 0.5f;
        const float iy = (f[fw] - f[-fw]) * 0.5f;
        T[base + i] = f[0];
        Ix[base + i] = ix;
        Iy[base + i] = iy;
        gxx += ix * ix;
        gxy += ix * iy;
        gyy += iy * iy;
    }
    const float Gxx = block_sum(gxx, part);
    const float Gxy = block_sum(gxy, part);
    const float Gyy = block_sum(gyy, part);
    if (threadIdx.x == 0) {
        const float det = Gxx * Gyy - Gxy * Gxy;
        const float mean = (Gxx + Gyy) * 0.5f;
        const float h = (Gxx - Gyy) * 0.5f;
        const float rad = sqrtf(fmaxf(h * h + Gxy * Gxy, 0.0f));
        float* st = stats + (size_t)n * 5;
        st[0] = Gxx;
        st[1] = Gxy;
        st[2] = Gyy;
        st[3] = det > 1e-6f ? 1.0f / det : 0.0f;
        st[4] = (mean - rad) / (float)(win * win);
    }
}

__global__ void lk_iterate_kernel(const float* __restrict__ region,
                                  const float* __restrict__ T,
                                  const float* __restrict__ Ix,
                                  const float* __restrict__ Iy,
                                  const float* __restrict__ stats,
                                  const float* __restrict__ guess,
                                  const int* __restrict__ reg_r0,
                                  const int* __restrict__ reg_c0, int Rg,
                                  int win, int iters, float i_lim,
                                  float* __restrict__ out) {
    extern __shared__ float smem[];
    const int n = blockIdx.x;
    const int ww = win * win;
    float* s_reg = smem;              // Rg*Rg
    float* s_T = s_reg + Rg * Rg;     // win^2 each
    float* s_Ix = s_T + ww;
    float* s_Iy = s_Ix + ww;
    float* part = s_Iy + ww;          // WARPS

    const float* reg = region + (size_t)n * Rg * Rg;
    for (int i = threadIdx.x; i < Rg * Rg; i += THREADS) s_reg[i] = reg[i];
    const size_t base = (size_t)n * ww;
    for (int i = threadIdx.x; i < ww; i += THREADS) {
        s_T[i] = T[base + i];
        s_Ix[i] = Ix[base + i];
        s_Iy[i] = Iy[base + i];
    }
    const float* st = stats + (size_t)n * 5;
    const float Gxx = st[0], Gxy = st[1], Gyy = st[2], inv_det = st[3];
    const float r0 = (float)reg_r0[n], c0 = (float)reg_c0[n];
    const float half = (float)(win - 1) / 2.0f;
    float g_c = guess[2 * n];       // u = column
    float g_r = guess[2 * n + 1];   // v = row
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
        const float lr = clampf((g_r - half) - r0, 0.0f, i_lim);
        const float lc = clampf((g_c - half) - c0, 0.0f, i_lim);
        const float fi = floorf(lr), fj = floorf(lc);
        const float fr = lr - fi, fc = lc - fj;
        const int i0 = (int)fi, j0 = (int)fj;
        float bx = 0.0f, by = 0.0f;
        for (int i = threadIdx.x; i < ww; i += THREADS) {
            const int a = i / win, b = i - a * win;
            const float r = s_T[i] - tap(s_reg, Rg, i0 + a, j0 + b, fr, fc);
            bx += r * s_Ix[i];
            by += r * s_Iy[i];
        }
        bx = block_sum(bx, part);
        by = block_sum(by, part);
        const float du = (Gyy * bx - Gxy * by) * inv_det;
        const float dv = (Gxx * by - Gxy * bx) * inv_det;
        g_r += dv;
        g_c += du;
    }
    if (threadIdx.x == 0) {
        out[2 * n] = g_c;
        out[2 * n + 1] = g_r;
    }
}

int opt_in(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// blk: (N, Rg, Rg); raw_r, raw_c: (N,) float offsets of the (win+2)^2 window
// inside the block (clipped here); T, Ix, Iy: (N, win, win); stats: (N, 5) =
// [Gxx, Gxy, Gyy, inv_det, min_eig]. All float32, contiguous. t_lim is the
// upper clip of the offsets, Rg - (win + 2) - 1e-5, rounded by the caller.
extern "C" int pmv_lk_template(const float* blk, const float* raw_r,
                               const float* raw_c, int N, int Rg, int win,
                               float t_lim, float* T, float* Ix, float* Iy, float* stats,
                               cudaStream_t stream) {
    if (N <= 0) return 0;
    const size_t bytes = ((size_t)(win + 2) * (win + 2) + WARPS) * sizeof(float);
    int err = opt_in((const void*)lk_template_kernel, bytes);
    if (err) return err;
    lk_template_kernel<<<N, THREADS, bytes, stream>>>(blk, raw_r, raw_c, Rg, win,
                                                     t_lim, T, Ix, Iy, stats);
    return (int)cudaGetLastError();
}

// region: (N, Rg, Rg); T, Ix, Iy: (N, win, win); stats: (N, 5); guess, out:
// (N, 2) as (u=column, v=row) in padded-level coordinates; reg_r0, reg_c0:
// (N,) int32 region origins. i_lim is the upper clip of the local window
// position, Rg - win - 1.000001, rounded by the caller.
extern "C" int pmv_lk_iterate(const float* region, const float* T,
                              const float* Ix, const float* Iy,
                              const float* stats, const float* guess,
                              const int* reg_r0, const int* reg_c0, int N,
                              int Rg, int win, int iters, float i_lim,
                              float* out,
                              cudaStream_t stream) {
    if (N <= 0) return 0;
    const size_t bytes =
        ((size_t)Rg * Rg + 3 * (size_t)win * win + WARPS) * sizeof(float);
    int err = opt_in((const void*)lk_iterate_kernel, bytes);
    if (err) return err;
    lk_iterate_kernel<<<N, THREADS, bytes, stream>>>(
        region, T, Ix, Iy, stats, guess, reg_r0, reg_c0, Rg, win, iters, i_lim,
        out);
    return (int)cudaGetLastError();
}
