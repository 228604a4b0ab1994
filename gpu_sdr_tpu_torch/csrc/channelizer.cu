// Fused PFB channelizer (pre-sum + two-stage DFT), for Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_sdr_tpu/ops/pallas_channelizer.py:
// channelizer_frames_t (_kernel_t), the fused-loopback TONES / NOISE
// chain (engine/fused._ChannelizerWavetableChain).
//
// For frame t of the block (nfft = n1*n2, bin k = k1 + n1*k2):
//   pre[t, s]     = sum_{i<avg} W[i, s] * ext[t + i, s]   (ext = spare ++ x)
//   z_k1[t, b]    = sum_{a<n1} F1[a, k1] * pre[t, a*n2 + b]          stage 1
//   out[t, k]     = sum_{b<n2} z_k1[t, b] * G[k1, b, k2]             stage 2
// with F1[a, k1] = exp(-2 pi i a k1 / n1) and the twiddle folded into
// G[k1, b, k2] = exp(-2 pi i b k1 / nfft) * exp(-2 pi i b k2 / n2).
// Output is (T, nfft) in natural bin order.  In const-frame mode x is ONE
// frame standing for all T frames of the block (a bin-quantized comb is
// nfft-periodic): only the block read is saved, every frame is computed.
//
// Grid: (frame tile of FT = 32 frames, k1).  A block
//   1. copies G_k1 (n2*n2 complex, 125 KB at n2 = 125) into shared memory
//      (dynamic shared memory, raised above 48 KB by cudaFuncSetAttribute);
//   2. computes pre-sum + stage 1 for its tile and k1 into shared memory,
//      reading the halo rows from the spare and from the tile's preceding
//      frames in place (no concatenated ext);
//   3. multiplies the (FT, n2) z tile by G_k1 in FP32 FFMA: each thread
//      keeps a 4-frame x 4-bin register tile, so one pass over b costs 8
//      shared loads for 64 FFMA.
//
// Bound: the FP32 pipes.  Stage 2 is 8*n2 flops per sample; the pre-sum
// and stage 1, recomputed by each of the n1 k1-blocks, add n1*(4*avg+8):
// ~1,190 flops per sample at nfft = 1000 (8 x 125, avg 4), against
// <= 16 bytes of HBM per sample (read x, write the spectrum; the n1-fold
// re-reads of x hit L2).  That is ~75 flops per byte, far above the
// card's FP32-to-bandwidth ratio (~20), so plain FFMA, not memory, sets
// the time.  The TPU kernel's layout artifacts are dropped: no
// (n1, T, n2) transpose, no scrambled order, no 8-frame halo padding,
// no bf16 hi/lo split, no bt % 8 rule.  Tensor cores (wgmma with a
// 3xbf16 or 3xTF32 split to hold 90 dB) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;          // frames per tile (8 warps x 4 frames)
constexpr int NTHREADS = 256;
constexpr int RF = 4;           // frames per thread in stage 2
constexpr int RK = 4;           // bins per thread in stage 2
constexpr int KCHUNK = 32 * RK; // k2 covered by one pass of a warp

__global__ void __launch_bounds__(NTHREADS)
channelizer_kernel(const float2* __restrict__ x,
                   const float2* __restrict__ spare,
                   const float* __restrict__ w,
                   const float2* __restrict__ F1,
                   const float2* __restrict__ G,
                   float2* __restrict__ out,
                   int T, int n1, int n2, int avg, int const_x) {
    extern __shared__ float2 smem[];
    const int nfft = n1 * n2;
    const int lead = avg - 1;
    const int k1 = blockIdx.y;
    const int t0 = blockIdx.x * FT;
    float2* Gs = smem;                 // (n2, n2): [b][k2]
    float2* zs = smem + n2 * n2;       // (FT, n2): [f][b]

    // 1. G_k1 -> shared memory
    const float2* Gk = G + (size_t)k1 * n2 * n2;
    for (int e = threadIdx.x; e < n2 * n2; e += NTHREADS) Gs[e] = Gk[e];

    // 2. pre-sum + stage 1 for this k1 -> zs
    for (int e = threadIdx.x; e < FT * n2; e += NTHREADS) {
        const int f = e / n2;
        const int b = e - f * n2;
        const int t = t0 + f;
        float zr = 0.f, zi = 0.f;
        if (t < T) {
            for (int a = 0; a < n1; ++a) {
                const int s = a * n2 + b;
                float pr = 0.f, pi = 0.f;
                for (int i = 0; i < avg; ++i) {
                    const int r = t + i;                 // row of ext
                    const float2 v =
                        (r < lead) ? spare[(size_t)r * nfft + s]
                                   : x[(const_x ? (size_t)0
                                                : (size_t)(r - lead) * nfft)
                                       + s];
                    const float wi = w[i * nfft + s];
                    pr = fmaf(wi, v.x, pr);
                    pi = fmaf(wi, v.y, pi);
                }
                const float2 c = F1[a * n1 + k1];
                zr = fmaf(c.x, pr, zr);
                zr = fmaf(-c.y, pi, zr);
                zi = fmaf(c.x, pi, zi);
                zi = fmaf(c.y, pr, zi);
            }
        }
        zs[e] = make_float2(zr, zi);
    }
    __syncthreads();

    // 3. stage 2: Y[f, k2] = sum_b zs[f, b] * Gs[b, k2]
    const int lane = threadIdx.x & 31;
    const int fbase = (threadIdx.x >> 5) * RF;
    for (int kb = 0; kb < n2; kb += KCHUNK) {
        int kc[RK];
        bool ok[RK];
#pragma unroll
        for (int j = 0; j < RK; ++j) {
            const int k2 = kb + lane + 32 * j;
            ok[j] = k2 < n2;
            kc[j] = ok[j] ? k2 : 0;
        }
        float ar[RF][RK], ai[RF][RK];
#pragma unroll
        for (int r = 0; r < RF; ++r)
#pragma unroll
            for (int j = 0; j < RK; ++j) ar[r][j] = ai[r][j] = 0.f;
        for (int b = 0; b < n2; ++b) {
            float2 g[RK];
#pragma unroll
            for (int j = 0; j < RK; ++j) g[j] = Gs[b * n2 + kc[j]];
#pragma unroll
            for (int r = 0; r < RF; ++r) {
                const float2 z = zs[(fbase + r) * n2 + b];
#pragma unroll
                for (int j = 0; j < RK; ++j) {
                    ar[r][j] = fmaf(z.x, g[j].x, ar[r][j]);
                    ar[r][j] = fmaf(-z.y, g[j].y, ar[r][j]);
                    ai[r][j] = fmaf(z.x, g[j].y, ai[r][j]);
                    ai[r][j] = fmaf(z.y, g[j].x, ai[r][j]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < RF; ++r) {
            const int t = t0 + fbase + r;
            if (t >= T) continue;
#pragma unroll
            for (int j = 0; j < RK; ++j)
                if (ok[j])
                    out[(size_t)t * nfft + k1 + n1 * (kb + lane + 32 * j)] =
                        make_float2(ar[r][j], ai[r][j]);
        }
    }
}

}  // namespace

extern "C" int sdr_channelizer_frame_tile() { return FT; }

extern "C" int sdr_channelizer(const void* x, const void* spare,
                               const void* w, const void* F1, const void* G,
                               void* out, int T, int n1, int n2, int avg,
                               int const_x, void* stream) {
    // the same size as smem_bytes() in ops/channelizer.py
    const size_t smem = (size_t)(n2 * n2 + FT * n2) * sizeof(float2);
    cudaError_t e = cudaFuncSetAttribute(
        channelizer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((T + FT - 1) / FT, n1);
    channelizer_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const float2*)x, (const float2*)spare, (const float*)w,
        (const float2*)F1, (const float2*)G, (float2*)out, T, n1, n2, avg,
        const_x);
    return (int)cudaGetLastError();
}
