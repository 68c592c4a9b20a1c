// Pyramidal Lucas-Kanade level kernel for Hopper (sm_90a): one launch per
// pyramid level of a tracked frame, one thread block per feature.
//
// Replaces both TPU kernels of pmv_tpu/frontend/pallas_lk.py (_level_call:
// _make_template_kernel and _make_iter_kernel) together with the scalar
// prologue and epilogue of pallas_lk._track_level_cached around them, and on
// a tracked frame the TPU capture kernel (pmv_tpu/frontend/pallas_capture.py)
// too. The TPU keeps these apart for its own reasons: it slices only at tile
// granularity, so capture is a kernel of its own, and template block and
// search region together overflowed its scoped fast memory, so template and
// iteration are two kernels that hand T, Ix, Iy over through device memory.
// Neither holds here: a Hopper block holds the region, the template's patch
// and its sampled window in 17 KB of shared memory (38 KB at win=32, Rg=84).
//
// Stages of lk_level_kernel:
//  1. thread-uniform scalars: the template window's offset inside the cached
//     block, raw = pts + pad - half - 1 - blk_origin (float32, in that
//     association); `ok` = the offset lies within 0.75 px of the clip range;
//     the padded guess; the region's integer origin (region.cuh, the same
//     floor-and-clip as capture_level);
//  2. two groups of asynchronous copies, started back to back: the (win+3)^2
//     patch of the previous frame's cached block that the template's bilinear
//     taps touch, then the (Rg, Rg) region of the unpadded level at clamped
//     coordinates (= edge replication). Only the patch is waited for;
//  3. the template, while the region flies: all warps sample the (win+2)^2
//     window F from the patch; each iterating thread then fills its taps'
//     T = F interior, Ix, Iy = central differences * 0.5 into registers and
//     sums Ix^2, Ix*Iy, Iy^2 over them; the three sums go through the warp
//     shuffles together and meet in one fixed-order reduction over the
//     iterating warps' partials: Gxx, Gxy, Gyy, inv_det (0 where det <=
//     1e-6), min_eig = (mean - rad) / win^2;
//  4. wait for the region; the block's other warps write it and its origin
//     out as the next frame's template block and leave, the iterating warps
//     run `iters` LK updates with the region resident in shared memory:
//     sample win x win at clip((g - half) - reg0, 0, Rg - win - 1.000001),
//     r = T - I, bx = sum r*Ix, by = sum r*Iy,
//     du = (Gyy*bx - Gxy*by)*inv_det, dv = (Gxx*by - Gxy*bx)*inv_det,
//     g += (dv, du) in (row, col);
//  5. outputs: g - pad, min_eig, ok, the region and its origin. T, Ix, Iy and
//     the statistics stay in registers; they are written out only where the
//     caller passes pointers for them (the check against the plain version).
//
// What bounds it: by the roofline, bytes (the level read once, the patches
// read, the region written); in fact latency, of the block's dependent
// accesses (scalars, then patch and region) and of `iters` dependent
// iterations, each a reduction over the window. What the design does:
//  - a level is one launch: no second launch, no T/Ix/Iy round trip through
//    device memory (2.7 MB written and read back per level at N=512, win=21),
//    and none of the small operators that computed the scalars;
//  - patch and region arrive by asynchronous copies, all in flight at once;
//    the template's arithmetic runs under the region's flight;
//  - the region never makes a round trip through device memory, and no
//    iterating thread waits for its way out: the first ITER_WARPS warps
//    iterate, the block's other warps write the region out meanwhile;
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
//
// The bilinear blend is row blend then column blend, (1-f)*a + f*b, as in
// the TPU kernel; compiled with --fmad=false so that it rounds like the
// plain version. Reduction order differs from the plain version.

#include <cuda_runtime.h>

#include "region.cuh"

namespace {

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

// Shared memory, in floats: the region (Rg*Rg), SLACK zeros directly behind
// it, two buffers of ITER_WARPS (bx, by) partials, ITER_WARPS (Gxx, Gxy,
// Gyy) partials, the (win+3)^2 patch of the cached block, the (win+2)^2
// sampled window F, and SLACK floats that a strip's taps beyond the window
// may read (and discard) behind F's last row.
__host__ __device__ constexpr int part_offset(int Rg) {
    return (Rg * Rg + SLACK + 1) & ~1;  // float2-aligned
}
__host__ __device__ constexpr int gpart_offset(int Rg) {
    return part_offset(Rg) + 2 * ITER_WARPS * 2;
}
__host__ __device__ constexpr int patch_offset(int Rg) {
    return gpart_offset(Rg) + ITER_WARPS * 4;
}
__host__ __device__ constexpr int shared_floats(int Rg, int win) {
    return patch_offset(Rg) + (win + 3) * (win + 3) + (win + 2) * (win + 2) + SLACK;
}

struct LevelArgs {
    const float* blk;     // (N, Rg, Rg) cached blocks of the previous frame
    const int* blk_r0;    // (N,) their origins, padded coordinates
    const int* blk_c0;
    const float* level;   // (H, W) this frame's level, unpadded
    const float* pts;     // (N, 2) previous positions (u, v), level coordinates
    const float* guess;   // (N, 2) starting positions (u, v), level coordinates
    int H, W, pad, Rg, win, iters;
    float t_lim, ok_hi, i_lim;
    float* out;           // (N, 2) refined positions, level coordinates
    float* min_eig;       // (N,)
    unsigned char* ok;    // (N,) 0 / 1
    float* region;        // (N, Rg, Rg)
    int* r0;              // (N,) region origins, padded coordinates
    int* c0;
    float* T;             // (N, win, win) each, or null
    float* Ix;
    float* Iy;
    float* stats;         // (N, 5) or null
};

// Blocks of NT threads that should share an SM: 512 features on 132 SMs are
// four blocks each. Stating it lets the compiler spend the registers that
// this occupancy leaves free (64 a thread at 256 threads) on keeping an
// iteration's shared-memory loads in flight together; without it, it holds
// the kernel to 48 and sends them out one behind the other. A window that
// needs more than one strip a lane needs more registers than that.
constexpr int min_blocks(int nt, int strips) {
    return strips > 1 ? 1 : (nt >= 448 ? 2 : 4);
}

// NT threads; each of the first ITER_LANES has at most STRIPS strips (strip
// s belongs to thread s % ITER_LANES).
template <int NT, int STRIPS>
__global__ void __launch_bounds__(NT, min_blocks(NT, STRIPS))
lk_level_kernel(const LevelArgs a) {
    static_assert(NT > ITER_LANES && NT % 32 == 0, "block too small");
    extern __shared__ float smem[];
    const int Rg = a.Rg, win = a.win, rr = Rg * Rg;
    const int pw = win + 3, fw = win + 2;
    float* s_reg = smem;
    float2* part = reinterpret_cast<float2*>(smem + part_offset(Rg));
    float* gpart = smem + gpart_offset(Rg);
    float* s_patch = smem + patch_offset(Rg);
    float* s_F = s_patch + pw * pw;

    const int n = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    constexpr int NW = NT / 32;

    // 1. scalars, the same in every thread
    const float padf = (float)a.pad;
    const float half = (float)(win - 1) / 2.0f;
    const float raw_r = (((a.pts[2 * n + 1] + padf) - half) - 1.0f) - (float)a.blk_r0[n];
    const float raw_c = (((a.pts[2 * n] + padf) - half) - 1.0f) - (float)a.blk_c0[n];
    float g_c = a.guess[2 * n] + padf;       // u = column
    float g_r = a.guess[2 * n + 1] + padf;   // v = row
    const int r0 = pmv::region_origin(g_r, win, Rg, a.H + 2 * a.pad);
    const int c0 = pmv::region_origin(g_c, win, Rg, a.W + 2 * a.pad);
    const float t_r = clampf(raw_r, 0.0f, a.t_lim);
    const float t_c = clampf(raw_c, 0.0f, a.t_lim);
    const float t_fi = floorf(t_r), t_fj = floorf(t_c);
    const float t_fr = t_r - t_fi, t_fc = t_c - t_fj;

    // 2. copies: the template's patch (group 0), then the region (group 1)
    {
        const float* src = a.blk + (size_t)n * rr + (int)t_fi * Rg + (int)t_fj;
        for (int r = warp; r < pw; r += NW) {
            for (int c = lane; c < pw; c += 32) {
                const unsigned dst =
                    (unsigned)__cvta_generic_to_shared(s_patch + r * pw + c);
                asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                             "l"(src + r * Rg + c)
                             : "memory");
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    pmv::stage_region(s_reg, a.level, a.H, a.W, a.pad, r0, c0, Rg, NW);
    if (tid < SLACK) s_reg[rr + tid] = 0.0f;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // the patch
    __syncthreads();

    // 3. template, under the region's flight: F by all warps, a warp per row
    for (int i = warp; i < fw; i += NW)
        for (int j = lane; j < fw; j += 32)
            s_F[i * fw + j] = tap(s_patch, pw, i, j, t_fr, t_fc);
    __syncthreads();

    // This thread's strips, for all iterations. A strip it does not have
    // sits on the region's corner with zero Ix, Iy.
    const int S = (win + STRIP - 1) / STRIP;  // strips per window row
    const int nstrips = win * S;
    int off[STRIPS];  // offset of the strip's first tap inside the region
    float tT[STRIPS][STRIP], tIx[STRIPS][STRIP], tIy[STRIPS][STRIP];
    if (tid < ITER_LANES) {
        float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
#pragma unroll
        for (int k = 0; k < STRIPS; ++k) {
            const int s = tid + k * ITER_LANES;
            off[k] = 0;
            int row = 0, col = 0, len = 0;
            if (s < nstrips) {
                row = s / S;
                col = (s - row * S) * STRIP;
                len = min(STRIP, win - col);
                off[k] = row * Rg + col;
            }
            // No branch on a tap: one beyond the window reads on along F
            // (at most SLACK floats past its end) and is set to zero.
            const float* f = s_F + (row + 1) * fw + (col + 1);
#pragma unroll
            for (int j = 0; j < STRIP; ++j) {
                const bool in = j < len;
                const float ix = in ? (f[j + 1] - f[j - 1]) * 0.5f : 0.0f;
                const float iy = in ? (f[j + fw] - f[j - fw]) * 0.5f : 0.0f;
                tT[k][j] = in ? f[j] : 0.0f;
                tIx[k][j] = ix;
                tIy[k][j] = iy;
                gxx += ix * ix;
                gxy += ix * iy;
                gyy += iy * iy;
            }
            if (a.T != nullptr) {  // the check of this stage only
                const size_t base = (size_t)n * win * win + row * win + col;
                for (int j = 0; j < len; ++j) {
                    a.T[base + j] = f[j];
                    a.Ix[base + j] = (f[j + 1] - f[j - 1]) * 0.5f;
                    a.Iy[base + j] = (f[j + fw] - f[j - fw]) * 0.5f;
                }
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            gxx += __shfl_xor_sync(0xffffffffu, gxx, o);
            gxy += __shfl_xor_sync(0xffffffffu, gxy, o);
            gyy += __shfl_xor_sync(0xffffffffu, gyy, o);
        }
        if (lane == 0) {
            gpart[warp * 4] = gxx;
            gpart[warp * 4 + 1] = gxy;
            gpart[warp * 4 + 2] = gyy;
        }
    }

    // 4. the region has landed; the barrier also publishes the G partials
    pmv::wait_staged();
    __syncthreads();

    // Hand the region on, by the warps that do not iterate, which then leave.
    if (tid >= ITER_LANES) {
        float* dst = a.region + (size_t)n * rr;
        for (int i = tid - ITER_LANES; i < rr; i += NT - ITER_LANES) dst[i] = s_reg[i];
        return;
    }

    float Gxx = gpart[0], Gxy = gpart[1], Gyy = gpart[2];
#pragma unroll
    for (int w = 1; w < ITER_WARPS; ++w) {
        Gxx += gpart[w * 4];
        Gxy += gpart[w * 4 + 1];
        Gyy += gpart[w * 4 + 2];
    }
    const float det = Gxx * Gyy - Gxy * Gxy;
    const float inv_det = det > 1e-6f ? 1.0f / det : 0.0f;
    if (tid == 0) {
        const float mean = (Gxx + Gyy) * 0.5f;
        const float h = (Gxx - Gyy) * 0.5f;
        const float rad = sqrtf(fmaxf(h * h + Gxy * Gxy, 0.0f));
        const float min_eig = (mean - rad) / (float)(win * win);
        a.min_eig[n] = min_eig;
        a.ok[n] = (raw_r > -0.75f) && (raw_r < a.ok_hi) && (raw_c > -0.75f) &&
                  (raw_c < a.ok_hi);
        a.r0[n] = r0;
        a.c0[n] = c0;
        if (a.stats != nullptr) {
            float* st = a.stats + (size_t)n * 5;
            st[0] = Gxx;
            st[1] = Gxy;
            st[2] = Gyy;
            st[3] = inv_det;
            st[4] = min_eig;
        }
    }
    const float r0f = (float)r0, c0f = (float)c0;

    for (int it = 0; it < a.iters; ++it) {
        const float lr = clampf((g_r - half) - r0f, 0.0f, a.i_lim);
        const float lc = clampf((g_c - half) - c0f, 0.0f, a.i_lim);
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
        // barrier 1: the iterating warps only (the others have left)
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
        a.out[2 * n] = g_c - padf;
        a.out[2 * n + 1] = g_r - padf;
    }
}

template <int NT, int STRIPS>
int launch_level(const LevelArgs& a, int N, cudaStream_t stream) {
    const size_t bytes = (size_t)shared_floats(a.Rg, a.win) * sizeof(float);
    if (bytes > 48 * 1024) {
        int err = (int)cudaFuncSetAttribute(
            lk_level_kernel<NT, STRIPS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err) return err;
    }
    lk_level_kernel<NT, STRIPS><<<N, NT, bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int NT>
int launch_level_strips(const LevelArgs& a, int N, cudaStream_t stream) {
    const int nstrips = a.win * ((a.win + STRIP - 1) / STRIP);
    const int strips = (nstrips + ITER_LANES - 1) / ITER_LANES;
    if (strips <= 1) return launch_level<NT, 1>(a, N, stream);
    if (strips <= 2) return launch_level<NT, 2>(a, N, stream);
    if (strips <= 3) return launch_level<NT, 3>(a, N, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// blk: (N, Rg, Rg) cached blocks with origins blk_r0, blk_c0 (N,) int32 in
// the coordinates of the level edge-padded by `pad`; level: (H, W) float32,
// unpadded; pts, guess, out: (N, 2) float32 as (u=column, v=row) in unpadded
// level coordinates; min_eig: (N,) float32; ok: (N,) bytes, 0 or 1; region:
// (N, Rg, Rg); r0, c0: (N,) int32 region origins in padded coordinates.
// T, Ix, Iy ((N, win, win) each) and stats ((N, 5) = [Gxx, Gxy, Gyy,
// inv_det, min_eig]) may be null: they are written only for the check of the
// template stage. The caller rounds the three limits to float32: t_lim, the
// upper clip of the template window's offset, Rg - (win + 2) - 1e-5; ok_hi =
// t_lim + 0.75 in double; i_lim, the upper clip of the local window
// position, Rg - win - 1.000001. threads: 128, 256 or 448; win * ceil(win /
// 7) <= 192 (three strips per iterating thread; win <= 35); Rg >= win + 3.
extern "C" int pmv_lk_track_level(const float* blk, const int* blk_r0,
                                  const int* blk_c0, const float* level, int H,
                                  int W, int pad, const float* pts,
                                  const float* guess, int N, int Rg, int win,
                                  int iters, float t_lim, float ok_hi,
                                  float i_lim, int threads, float* out,
                                  float* min_eig, unsigned char* ok,
                                  float* region, int* r0, int* c0, float* T,
                                  float* Ix, float* Iy, float* stats,
                                  cudaStream_t stream) {
    if (N <= 0) return 0;
    if (Rg < win + 3) return (int)cudaErrorInvalidValue;
    const LevelArgs a = {blk, blk_r0, blk_c0, level, pts, guess, H, W, pad, Rg,
                         win, iters, t_lim, ok_hi, i_lim, out, min_eig, ok,
                         region, r0, c0, T, Ix, Iy, stats};
    switch (threads) {
        case 128: return launch_level_strips<128>(a, N, stream);
        case 256: return launch_level_strips<256>(a, N, stream);
        case 448: return launch_level_strips<448>(a, N, stream);
    }
    return (int)cudaErrorInvalidValue;
}
