// Fused PFB channelizer (pre-sum + two-stage DFT), for Hopper (sm_90a).
//
// Replaces the TPU kernels gpu_sdr_tpu/ops/pallas_channelizer.py:
//   channelizer_frames_t  (_kernel_t): a streamed block, or one frame in
//                         const-frame mode; the fused-loopback TONES /
//                         NOISE chain (engine/fused._ChannelizerWavetableChain);
//   channelizer_frames    (_kernel): a streamed block, its spectra stored
//                         in the scrambled order k1*n2 + k2 (bin k at
//                         (k % n1)*n2 + k / n1); sdr_channelizer_scrambled;
//   channelizer_frames_at (_kernel_t_at): block `idx` of a resident
//                         (total_frames, nfft) recording, read in place;
//                         the device replay's channelizer_at sub-path;
//   channelizer_frames_at_halo (_kernel_t_at_h): block `idx` of one time
//                         shard's span of the recording after a staged
//                         halo; the sharded device replay's
//                         channelizer_at sub-path.
//
// For frame t of the block (nfft = n1*n2, bin k = k1 + n1*k2):
//   pre[t, s]     = sum_{i<avg} W[i, s] * ext[t + i, s]   (ext = spare ++ x)
//   z_k1[t, b]    = sum_{a<n1} F1[a, k1] * pre[t, a*n2 + b]          stage 1
//   out[t, k]     = sum_{b<n2} z_k1[t, b] * G[k1, b, k2]             stage 2
// with F1[a, k1] = exp(-2 pi i a k1 / n1) and the twiddle folded into
// G[k1, b, k2] = exp(-2 pi i b k1 / nfft) * exp(-2 pi i b k2 / n2).
// Output is (T, nfft) in natural bin order (or, for channelizer_frames,
// scrambled: each (tile, k1) block then writes its n2 bins of a frame as
// one contiguous run, where the natural order strides them by n1; no
// separate permutation pass).  The extended block (avg-1
// halo rows, then the block's T frames) is read in place from one of three
// sources, a template parameter of the kernel so that each mode's
// addressing costs what it needs in the pre-sum's inner loop:
//   Streamed: a streamed block after its carried spare; in const-frame
//             mode x is ONE frame standing for all T frames of the block
//             (a bin-quantized comb is nfft-periodic): only the block read
//             is saved, every frame is computed;
//   Recorded: a recording's frames [base, base + T) after the avg-1
//             frames before them, wrapped at the loop seam and zero on
//             the stream's first block (`valid` 0), as rows.cuh says,
//             addressed as cheaply as Streamed (no 64-bit row products,
//             no modulo in the inner loop);
//   Staged:   one time shard's frames of the block, in place in its span,
//             after avg-1 halo frames staged at upload (they lie on the
//             previous shard, or in the previous block), zero on the
//             stream's first block (rows.cuh (c)).  Bound as #4: 48.5 MB
//             of HBM per 3000-frame shard block against ~3.6 GFLOP of
//             FFMA, so the FP32 pipes set the time.
//
// Grid: (frame tile of FT = 32 frames, k1).  A block
//   1. copies G_k1 (n2*n2 complex, 125 KB at n2 = 125) into shared memory
//      (dynamic shared memory, raised above 48 KB by cudaFuncSetAttribute);
//   2. computes pre-sum + stage 1 for its tile and k1 into shared memory,
//      reading the halo rows from the spare (or the recording) and from
//      the tile's preceding frames in place (no concatenated ext);
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
// the time.  The TPU kernels' layout artifacts are dropped: no
// (n1, T, n2) transpose (of the block, or of the whole recording at
// upload), no 8-frame halo units, no bf16 hi/lo
// split, no bt % 8 or total_frames % 8 rule.  Tensor cores (wgmma with a
// 3xbf16 or 3xTF32 split to hold 90 dB) are later work.

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr int FT = 32;          // frames per tile (8 warps x 4 frames)
constexpr int NTHREADS = 256;
constexpr int RF = 4;           // frames per thread in stage 2
constexpr int RK = 4;           // bins per thread in stage 2
constexpr int KCHUNK = 32 * RK; // k2 covered by one pass of a warp

// Row r of a streamed block's extended frames, column s: a pointer select
// and an int offset (the launcher checks that the rows fit an int), so
// the pre-sum's loop over avg keeps its loads in flight.
struct Streamed {
    const float2* x;
    const float2* spare;
    int T, lead, nfft, const_x;

    __device__ __forceinline__ float2 operator()(int r, int s) const {
        const float2* p = r < lead ? spare + r * nfft
                                   : x + (const_x ? 0 : (r - lead) * nfft);
        return p[s];
    }
};

// Row r of a recording block's extended frames, column s: recording row
// base - lead + r, at an int offset from the block's first frame (`body`)
// or, for the halo rows before the recording's first row (r < split),
// from its end (`wrap`: the loop seam); the halo is zero on the stream's
// first block (`valid` 0).  A pointer select and a load predicated on
// `valid`, as in Streamed.  It wraps once, so it needs total_frames >=
// lead.
struct Recorded {
    const float2* body;   // recording row base
    const float2* wrap;   // recording row base + total_frames
    int T, lead, nfft, split, valid;

    __device__ __forceinline__ float2 operator()(int r, int s) const {
        const float2* p = r < split ? wrap : body;
        return r >= lead || valid ? p[(r - lead) * nfft + s]
                                  : make_float2(0.f, 0.f);
    }
};

// Row r of the extended frames of block `blk` of one time shard's span
// (rows.cuh (c)): the halo rows (r < lead) from the staged array's row
// blk, zero on the stream's first block (`valid` 0); the body rows read
// in place from the shard's span, at an int offset from the block's
// first frame.  A pointer select and a predicated load, as in Recorded.
struct Staged {
    const float2* body;   // shard span row blk*T
    const float2* halo;   // staged (nblk, lead, nfft) row blk
    int T, lead, nfft, valid;

    __device__ __forceinline__ float2 operator()(int r, int s) const {
        if (r < lead)
            return valid ? halo[r * nfft + s] : make_float2(0.f, 0.f);
        return body[(r - lead) * nfft + s];
    }
};

// A recording shorter than the halo (total_frames < lead), whose halo
// wraps more than once: rows.cuh's general addressing.
struct RecordedShort {
    Rows in;
    int T;

    __device__ __forceinline__ float2 operator()(int r, int s) const {
        return sample(in, r, s);
    }
};

template <class Src, bool kScrambled>
__global__ void __launch_bounds__(NTHREADS)
channelizer_kernel(Src src, const float* __restrict__ w,
                   const float2* __restrict__ F1,
                   const float2* __restrict__ G,
                   float2* __restrict__ out, int n1, int n2, int avg) {
    extern __shared__ float2 smem[];
    const int nfft = n1 * n2;
    const int T = src.T;
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
                    const float2 v = src(t + i, s);      // row of ext
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
            for (int j = 0; j < RK; ++j) {
                const int k2 = kb + lane + 32 * j;
                if (ok[j])
                    out[(size_t)t * nfft +
                        (kScrambled ? k1 * n2 + k2 : k1 + n1 * k2)] =
                        make_float2(ar[r][j], ai[r][j]);
            }
        }
    }
}

template <class Src, bool kScrambled = false>
int launch(const Src& src, const void* w, const void* F1, const void* G,
           void* out, int n1, int n2, int avg, void* stream) {
    // the same size as smem_bytes() in ops/channelizer.py
    const size_t smem = (size_t)(n2 * n2 + FT * n2) * sizeof(float2);
    cudaError_t e = cudaFuncSetAttribute(
        channelizer_kernel<Src, kScrambled>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((src.T + FT - 1) / FT, n1);
    channelizer_kernel<Src, kScrambled>
        <<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
            src, (const float*)w, (const float2*)F1, (const float2*)G,
            (float2*)out, n1, n2, avg);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdr_channelizer_frame_tile() { return FT; }

// Streamed block x (T, nfft), or its one frame with const_x, after the
// spare (avg-1, nfft).
extern "C" int sdr_channelizer(const void* x, const void* spare,
                               const void* w, const void* F1, const void* G,
                               void* out, int T, int n1, int n2, int avg,
                               int const_x, void* stream) {
    if ((long long)(T + avg - 1) * n1 * n2 >= (1LL << 31))   // int offsets
        return (int)cudaErrorInvalidValue;
    const Streamed src{(const float2*)x, (const float2*)spare, T, avg - 1,
                       n1 * n2, const_x};
    return launch(src, w, F1, G, out, n1, n2, avg, stream);
}

// Streamed block x (T, nfft) after the spare (avg-1, nfft), spectra in
// the scrambled order k1*n2 + k2.
extern "C" int sdr_channelizer_scrambled(const void* x, const void* spare,
                                         const void* w, const void* F1,
                                         const void* G, void* out, int T,
                                         int n1, int n2, int avg,
                                         void* stream) {
    if ((long long)(T + avg - 1) * n1 * n2 >= (1LL << 31))   // int offsets
        return (int)cudaErrorInvalidValue;
    const Streamed src{(const float2*)x, (const float2*)spare, T, avg - 1,
                       n1 * n2, 0};
    return launch<Streamed, true>(src, w, F1, G, out, n1, n2, avg, stream);
}

// Frames [base, base + T) of a (total_frames, nfft) recording.
extern "C" int sdr_channelizer_at(const void* rec, const void* w,
                                  const void* F1, const void* G, void* out,
                                  long long total_frames, long long base,
                                  int T, int n1, int n2, int avg, int valid,
                                  void* stream) {
    const int nfft = n1 * n2, lead = avg - 1;
    if (total_frames <= 0 || base < 0 || base + T > total_frames ||
        (long long)(T + lead) * nfft >= (1LL << 31))   // int row offsets
        return (int)cudaErrorInvalidValue;
    const float2* x = (const float2*)rec;
    if (total_frames < lead)
        return launch(RecordedShort{{x, nullptr, total_frames, base, T, lead,
                                     nfft, valid}, T},
                      w, F1, G, out, n1, n2, avg, stream);
    const Recorded src{x + base * nfft, x + (base + total_frames) * nfft, T,
                       lead, nfft, base < lead ? (int)(lead - base) : 0,
                       valid};
    return launch(src, w, F1, G, out, n1, n2, avg, stream);
}

// Block `blk` (frames [blk*T, (blk+1)*T)) of one time shard's span of
// span_frames frames, its avg-1 halo frames the staged (nblk, avg-1,
// nfft) array's row blk.
extern "C" int sdr_channelizer_at_halo(const void* span, const void* staged,
                                       const void* w, const void* F1,
                                       const void* G, void* out,
                                       long long span_frames, long long blk,
                                       int T, int n1, int n2, int avg,
                                       int valid, void* stream) {
    const int nfft = n1 * n2, lead = avg - 1;
    if (blk < 0 || (blk + 1) * T > span_frames ||
        (long long)(T + lead) * nfft >= (1LL << 31))   // int row offsets
        return (int)cudaErrorInvalidValue;
    const Staged src{(const float2*)span + blk * T * nfft,
                     (const float2*)staged + blk * lead * nfft, T, lead,
                     nfft, valid};
    return launch(src, w, F1, G, out, n1, n2, avg, stream);
}
