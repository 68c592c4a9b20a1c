// Pyramidal Lucas-Kanade level kernels for Hopper (sm_90a): template
// statistics, and the iteration loop that captures its own search region.
//
// Replace the two TPU kernels of pmv_tpu/frontend/pallas_lk.py (_level_call):
// _make_template_kernel -> lk_template, _make_iter_kernel -> lk_iterate. On a
// tracked frame lk_iterate also does the work of the TPU capture kernel
// (pmv_tpu/frontend/pallas_capture.py): the TPU captures in a kernel of its
// own because it slices only at tile granularity, and keeps template and
// iteration apart because both blocks would not fit its scoped fast memory.
// Neither reason holds here: a Hopper block holds the 12.1 KB region (28 KB
// at Rg=84) in shared memory with room to spare.
//
// lk_template: bilinear-sample a (win+2)^2 window from the previous frame's
// cached (Rg, Rg) block at the clipped float offset; T = interior, Ix, Iy =
// central differences * 0.5; Gxx, Gxy, Gyy sums; inv_det (0 where det <=
// 1e-6); min_eig = (mean - rad) / win^2. Bound: bytes.
//
// lk_iterate, one launch per level, one thread block per feature:
//  1. the region's integer origin from the guess (region.cuh, the same
//     floor-and-clip as capture_level);
//  2. the (Rg, Rg) region of the unpadded level, read at clamped coordinates
//     (= edge replication) into shared memory;
//  3. the region and its origin written out as the next frame's template
//     block;
//  4. `iters` LK updates with the region resident in shared memory: sample
//     win x win at clip((g - half) - reg0, 0, Rg - win - 1.000001),
//     r = T - I, bx = sum r*Ix, by = sum r*Iy,
//     du = (Gyy*bx - Gxy*by)*inv_det, dv = (Gxx*by - Gxy*bx)*inv_det,
//     g += (dv, du) in (row, col).
//
// What bounds lk_iterate: by the roofline, bytes (the level read once, T/Ix/
// Iy read, the region written); in fact latency, of the block's dependent
// accesses (guess, then region) and of `iters` dependent iterations, each a
// reduction over the window. What the design does about it:
//  - the region arrives by asynchronous copies (region.cuh), all in flight
//    at once; while they fly each iterating thread loads its own taps' T,
//    Ix, Iy and the feature's statistics into registers, and works out its
//    taps' shared-memory offsets, once for all iterations;
//  - the region never makes a round trip through device memory, and no
//    iterating thread waits for its way out: the first ITER_WARPS warps
//    iterate, the block's other warps write the region out from shared
//    memory meanwhile and leave;
//  - two warps iterate whatever the block size. Measured on an H100, an
//    iteration is bound by its chain of dependent instructions (position ->
//    offsets -> taps -> shuffles -> barrier -> partials -> update), not by
//    bytes: more warps add partials and redundant copies of the chain's
//    scalar part, one warp alone gets too long a run of taps;
//  - a thread's taps are a row strip of 7, so neighbouring taps share
//    their row blends ((1-fr)*a + fr*b of a column is computed once and
//    serves the taps on either side, as in the plain version's row pass),
//    and the taps carry no branch (a tap beyond the window has zero Ix, Iy
//    and adds nothing), so that their loads overlap;
//  - an iteration has one barrier, among the iterating warps only: bx and
//    by go through the warp shuffles together, the warps' partials are
//    written to a buffer chosen by the iteration's parity (so the next
//    iteration's writes cannot overtake this one's reads), and every thread
//    adds the partials in one fixed tree order. All threads therefore hold
//    the same bits of the position, and runs repeat bit for bit;
//  - the block size is a template parameter (128, 256 or 448 threads); the
//    wrapper names the one that measured fastest.
// T, Ix, Iy live in registers, not in shared memory, and shared memory holds
// only the region and the partials: a kernel that also computes the
// template (folding lk_template in) would stage the (win+3)^2 patch of the
// cached block behind the partials and fill the same registers from it, with
// no change to the loop.
//
// The bilinear blend is row blend then column blend, (1-f)*a + f*b, as in
// the TPU kernel; compiled with --fmad=false so that it rounds like the
// plain version. Reduction order differs from the plain version.

#include <cuda_runtime.h>

#include "region.cuh"

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

// Warps that run the iterations. The window is dealt out over their lanes in
// row strips of STRIP taps: strip s covers row s / S, columns (s % S) * STRIP
// onwards, with S = ceil(win / STRIP) strips per row (63 strips on 64 lanes
// at win=21). A strip's last taps may lie beyond the window's row: they have
// zero Ix and Iy and read up to SLACK floats past the region's last row,
// which are zeroed so that nothing non-finite is multiplied by those zeros.
constexpr int ITER_WARPS = 2;
constexpr int ITER_LANES = ITER_WARPS * 32;
constexpr int STRIP = 7;
constexpr int SLACK = 8;

// NT threads; each of the first ITER_LANES has at most STRIPS strips (strip
// s belongs to thread s % ITER_LANES). Shared memory: the region (Rg*Rg
// floats), SLACK zeros, then two buffers of ITER_WARPS (bx, by) partials.

template <int NT, int STRIPS>
__global__ void __launch_bounds__(NT)
lk_iterate_kernel(const float* __restrict__ level, int H, int W, int pad,
                  const float* __restrict__ T, const float* __restrict__ Ix,
                  const float* __restrict__ Iy,
                  const float* __restrict__ stats,
                  const float* __restrict__ guess, int Rg, int win, int iters,
                  float i_lim, float* __restrict__ out,
                  float* __restrict__ region_out, int* __restrict__ r0_out,
                  int* __restrict__ c0_out) {
    static_assert(NT >= ITER_LANES && NT % 32 == 0, "block too small");
    extern __shared__ float smem[];
    const int rr = Rg * Rg;
    float* s_reg = smem;
    float2* part = reinterpret_cast<float2*>(smem + ((rr + SLACK + 1) & ~1));

    const int n = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    float g_c = guess[2 * n];       // u = column
    float g_r = guess[2 * n + 1];   // v = row
    const int r0 = pmv::region_origin(g_r, win, Rg, H + 2 * pad);
    const int c0 = pmv::region_origin(g_c, win, Rg, W + 2 * pad);
    pmv::stage_region(s_reg, level, H, W, pad, r0, c0, Rg, NT / 32);
    if (tid < SLACK) s_reg[rr + tid] = 0.0f;

    // While the copies fly: this thread's strips, for all iterations. A
    // strip it does not have sits on the region's corner with zero Ix, Iy.
    const int S = (win + STRIP - 1) / STRIP;  // strips per window row
    const int nstrips = win * S;
    const size_t base = (size_t)n * win * win;
    int off[STRIPS];  // offset of the strip's first tap inside the region
    float tT[STRIPS][STRIP], tIx[STRIPS][STRIP], tIy[STRIPS][STRIP];
#pragma unroll
    for (int k = 0; k < STRIPS; ++k) {
        const int s = tid + k * ITER_LANES;
        off[k] = 0;
        int row = 0, col = 0, len = 0;
        if (tid < ITER_LANES && s < nstrips) {
            row = s / S;
            col = (s - row * S) * STRIP;
            len = min(STRIP, win - col);
            off[k] = row * Rg + col;
        }
#pragma unroll
        for (int j = 0; j < STRIP; ++j) {
            tT[k][j] = tIx[k][j] = tIy[k][j] = 0.0f;
            if (j < len) {
                const size_t i = base + row * win + col + j;
                tT[k][j] = T[i];
                tIx[k][j] = Ix[i];
                tIy[k][j] = Iy[i];
            }
        }
    }
    const float* st = stats + (size_t)n * 5;
    const float Gxx = st[0], Gxy = st[1], Gyy = st[2], inv_det = st[3];
    const float r0f = (float)r0, c0f = (float)c0;
    const float half = (float)(win - 1) / 2.0f;

    pmv::wait_staged();
    __syncthreads();

    // Hand the region on: by the warps that do not iterate, which then
    // leave; by everyone first where every warp iterates.
    float* dst = region_out + (size_t)n * rr;
    if (NT > ITER_LANES) {
        if (tid >= ITER_LANES) {
            for (int i = tid - ITER_LANES; i < rr; i += NT - ITER_LANES)
                dst[i] = s_reg[i];
            return;
        }
    } else {
        for (int i = tid; i < rr; i += NT) dst[i] = s_reg[i];
    }
    if (tid == 0) {
        r0_out[n] = r0;
        c0_out[n] = c0;
    }

    for (int it = 0; it < iters; ++it) {
        const float lr = clampf((g_r - half) - r0f, 0.0f, i_lim);
        const float lc = clampf((g_c - half) - c0f, 0.0f, i_lim);
        const float fi = floorf(lr), fj = floorf(lc);
        const float fr = lr - fi, fc = lc - fj;
        const float wr = 1.0f - fr, wc = 1.0f - fc;
        const float* p0 = s_reg + (int)fi * Rg + (int)fj;
        float bx = 0.0f, by = 0.0f;
#pragma unroll
        for (int k = 0; k < STRIPS; ++k) {
            const float* p = p0 + off[k];
            float rb[STRIP + 1];  // row blends of the strip's columns
#pragma unroll
            for (int j = 0; j <= STRIP; ++j) rb[j] = wr * p[j] + fr * p[Rg + j];
#pragma unroll
            for (int j = 0; j < STRIP; ++j) {
                const float r = tT[k][j] - (wc * rb[j] + fc * rb[j + 1]);
                bx += r * tIx[k][j];
                by += r * tIy[k][j];
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            bx += __shfl_xor_sync(0xffffffffu, bx, o);
            by += __shfl_xor_sync(0xffffffffu, by, o);
        }
        float2* pp = part + (it & 1) * ITER_WARPS;
        if (lane == 0) pp[warp] = make_float2(bx, by);
        // barrier 1: the iterating warps only (the others may have left)
        asm volatile("bar.sync 1, %0;" ::"n"(ITER_LANES) : "memory");
        float2 v[ITER_WARPS];
#pragma unroll
        for (int w = 0; w < ITER_WARPS; ++w) v[w] = pp[w];
#pragma unroll
        for (int s = 1; s < ITER_WARPS; s *= 2) {
#pragma unroll
            for (int w = 0; w + s < ITER_WARPS; w += 2 * s) {
                v[w].x += v[w + s].x;
                v[w].y += v[w + s].y;
            }
        }
        bx = v[0].x;
        by = v[0].y;
        const float du = (Gyy * bx - Gxy * by) * inv_det;
        const float dv = (Gxx * by - Gxy * bx) * inv_det;
        g_r += dv;
        g_c += du;
    }
    if (tid == 0) {
        out[2 * n] = g_c;
        out[2 * n + 1] = g_r;
    }
}

int opt_in(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NT, int STRIPS>
int launch_iterate(const float* level, int H, int W, int pad, const float* T,
                   const float* Ix, const float* Iy, const float* stats,
                   const float* guess, int N, int Rg, int win, int iters,
                   float i_lim, float* out, float* region_out, int* r0_out,
                   int* c0_out, cudaStream_t stream) {
    const size_t bytes = (((size_t)Rg * Rg + SLACK + 1) & ~(size_t)1) * sizeof(float) +
                         2 * ITER_WARPS * sizeof(float2);
    int err = opt_in((const void*)lk_iterate_kernel<NT, STRIPS>, bytes);
    if (err) return err;
    lk_iterate_kernel<NT, STRIPS><<<N, NT, bytes, stream>>>(
        level, H, W, pad, T, Ix, Iy, stats, guess, Rg, win, iters, i_lim, out,
        region_out, r0_out, c0_out);
    return (int)cudaGetLastError();
}

template <int NT, typename... Args>
int launch_iterate_strips(int win, Args... args) {
    const int nstrips = win * ((win + STRIP - 1) / STRIP);
    const int strips = (nstrips + ITER_LANES - 1) / ITER_LANES;
    if (strips <= 1) return launch_iterate<NT, 1>(args...);
    if (strips <= 2) return launch_iterate<NT, 2>(args...);
    if (strips <= 3) return launch_iterate<NT, 3>(args...);
    return (int)cudaErrorInvalidValue;
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

// level: (H, W) float32, unpadded; pad: the edge padding the coordinates
// assume; T, Ix, Iy: (N, win, win); stats: (N, 5); guess, out: (N, 2) as
// (u=column, v=row) in padded-level coordinates; region_out: (N, Rg, Rg);
// r0_out, c0_out: (N,) int32 region origins in padded coordinates. i_lim is
// the upper clip of the local window position, Rg - win - 1.000001, rounded
// by the caller. threads: 128, 256 or 448; win * ceil(win / 7) <= 192 (three
// strips per iterating thread; win <= 35).
extern "C" int pmv_lk_iterate(const float* level, int H, int W, int pad,
                              const float* T, const float* Ix, const float* Iy,
                              const float* stats, const float* guess, int N,
                              int Rg, int win, int iters, float i_lim,
                              int threads, float* out, float* region_out,
                              int* r0_out, int* c0_out, cudaStream_t stream) {
    if (N <= 0) return 0;
#define PMV_ITERATE(NT)                                                      \
    launch_iterate_strips<NT>(win, level, H, W, pad, T, Ix, Iy, stats, guess, N, \
                            Rg, win, iters, i_lim, out, region_out, r0_out,    \
                            c0_out, stream)
    switch (threads) {
        case 128: return PMV_ITERATE(128);
        case 256: return PMV_ITERATE(256);
        case 448: return PMV_ITERATE(448);
    }
#undef PMV_ITERATE
    return (int)cudaErrorInvalidValue;
}
