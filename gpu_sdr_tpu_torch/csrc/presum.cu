// PFB windowed pre-sum, one pass, for Hopper (sm_90a).  One body, two
// ways to address the block's rows (rows.cuh).
//
// Replaces the TPU kernels gpu_sdr_tpu/ops/pallas_pfb.py:
//   pallas_presum    (_kernel): a streamed block, reached through
//                    pfb_frames_fused on the host-fed TONES / NOISE
//                    demodulator;
//   pallas_presum_at (_kernel_at): block `idx` of a resident
//                    (total_frames, nfft) recording, the device replay's
//                    pfb_at sub-path.
//
//   pre[t, b] = sum_{i<avg} W[i, b] * ext[t + i, b]
//   ext       = the avg-1 halo rows, then the block's rows (T)
//
// ext is never built.  Streamed: the halo is the carried spare.
// Recording: the block is rows [base, base + T) of the recording, read in
// place, and the halo is the rows before it, wrapped mod total_frames at
// the loop seam and zero on the stream's first block (`valid` 0).  The
// TPU kernels staged 8-row halo units because Mosaic blocks cannot
// overlap, and needed 8-aligned tiles and recordings; here every thread
// reads what it needs directly, so no halo array and no alignment rule
// exist.
//
// Bound: device memory.  Each output reads avg complex samples (the
// neighbouring frames are re-read from L1/L2, not from HBM) and writes
// one: ~16 B of HBM traffic per sample against 2*avg FFMA.  The design
// is one thread per complex output with a loop over avg, neighbouring
// threads on neighbouring bins so every load and store is coalesced.
// Accumulation is FP32 FFMA in order i = 0..avg-1.

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

__global__ void presum_kernel(Rows in, const float* __restrict__ w,
                              float2* __restrict__ out, int avg) {
    const int nfft = in.M;
    const long long total = (long long)in.nb * nfft;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += stride) {
        const long long t = e / nfft;
        const int b = (int)(e - t * nfft);
        float re = 0.f, im = 0.f;
        for (int i = 0; i < avg; ++i) {
            const float2 v = sample(in, t + i, b);   // row of ext
            const float wi = w[(long long)i * nfft + b];
            re = fmaf(wi, v.x, re);
            im = fmaf(wi, v.y, im);
        }
        out[e] = make_float2(re, im);
    }
}

int launch(const Rows& in, const void* w, void* out, int avg, void* stream) {
    const long long total = (long long)in.nb * in.M;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 30)) blocks = 1LL << 30;   // grid-stride covers it
    presum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        in, (const float*)w, (float2*)out, avg);
    return (int)cudaGetLastError();
}

}  // namespace

// Streamed block x (T, nfft) after the spare (avg-1, nfft).
extern "C" int sdr_presum(const void* x, const void* spare, const void* w,
                          void* out, int T, int nfft, int avg,
                          void* stream) {
    const Rows in{(const float2*)x, (const float2*)spare, T, 0, T, avg - 1,
                  nfft, 1};
    return launch(in, w, out, avg, stream);
}

// Block rows [base, base + T) of a (total_frames, nfft) recording.
extern "C" int sdr_presum_at(const void* rec, const void* w, void* out,
                             long long total_frames, long long base, int T,
                             int nfft, int avg, int valid, void* stream) {
    if (total_frames <= 0 || base < 0 || base + T > total_frames)
        return (int)cudaErrorInvalidValue;
    const Rows in{(const float2*)rec, nullptr, total_frames, base, T,
                  avg - 1, nfft, valid};
    return launch(in, w, out, avg, stream);
}

extern "C" const char* sdr_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
