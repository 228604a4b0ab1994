// PFB windowed pre-sum, one pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_sdr_tpu/ops/pallas_pfb.py: pallas_presum
// (_kernel), reached through pfb_frames_fused on the host-fed TONES /
// NOISE demodulator.
//
//   pre[t, b] = sum_{i<avg} W[i, b] * ext[t + i, b]
//   ext       = spare rows (avg-1) followed by the block's rows X (T)
//
// ext is never built: row r < avg-1 is read from the spare, any other
// row from X, in place.  The TPU kernel staged an 8-row halo per tile
// because Mosaic blocks cannot overlap; here every thread reads what it
// needs directly, so no halo array exists.
//
// Bound: device memory.  Each output reads avg complex samples (the
// neighbouring frames are re-read from L1/L2, not from HBM) and writes
// one: ~16 B of HBM traffic per sample against 2*avg FFMA.  The design
// is one thread per complex output with a loop over avg, neighbouring
// threads on neighbouring bins so every load and store is coalesced.
// Accumulation is FP32 FFMA in order i = 0..avg-1.

#include <cuda_runtime.h>

namespace {

__global__ void presum_kernel(const float2* __restrict__ x,
                              const float2* __restrict__ spare,
                              const float* __restrict__ w,
                              float2* __restrict__ out,
                              long long total, int nfft, int avg) {
    const int lead = avg - 1;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += stride) {
        const long long t = e / nfft;
        const int b = (int)(e - t * nfft);
        float re = 0.f, im = 0.f;
        for (int i = 0; i < avg; ++i) {
            const long long r = t + i;          // row of ext
            const float2 v = (r < lead) ? spare[r * nfft + b]
                                        : x[(r - lead) * nfft + b];
            const float wi = w[(long long)i * nfft + b];
            re = fmaf(wi, v.x, re);
            im = fmaf(wi, v.y, im);
        }
        out[e] = make_float2(re, im);
    }
}

}  // namespace

extern "C" int sdr_presum(const void* x, const void* spare, const void* w,
                          void* out, int T, int nfft, int avg,
                          void* stream) {
    const long long total = (long long)T * nfft;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 30)) blocks = 1LL << 30;   // grid-stride covers it
    presum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float2*)x, (const float2*)spare, (const float*)w,
        (float2*)out, total, nfft, avg);
    return (int)cudaGetLastError();
}

extern "C" const char* sdr_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
