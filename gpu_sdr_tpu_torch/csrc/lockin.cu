// Table-oscillator chirp lock-in, one block per segment, for Hopper
// (sm_90a).  One body, two modes.
//
// Replaces the TPU kernels gpu_sdr_tpu/ops/pallas_lockin.py:
//   pallas_chirp_lockin_table       (table mode; the host-fed CHIRP
//                                    demodulator's table step)
//   pallas_chirp_lockin_table_self  (self mode; the fused CHIRP->CHIRP
//                                    loopback, chain chirp_wavetable)
//
// The integer-phase chirp repeats exactly every period, so one period of
// the oscillator lives in device memory as (period/ppt, ppt) segment rows
// and each block reads its rows in place, by row offset:
//
//   table: y[s] = sum_k w[k] * conj(c[c_row0 + s, k]) * x[x_row0 + s, k]
//   self:  y[s] = sum_k w[k] * |c[c_row0 + s, k]|^2     (imag exactly 0)
//
// In self mode the signal is the table (the loopback), each row is read
// once, and the imaginary half is formed from the same product set as
// the JAX kernel, cr*ci - ci*cr, with __fmul_rn so that nvcc cannot
// contract one product into an FMA: it is exactly 0, as on the TPU.
//
// Bound: device memory.  Config 2 (ppt 20,000, 200 segments per
// 4,000,000-sample block): self mode reads 32 MB per block, 0.0096 ms at
// 3.35 TB/s, for ~5 FLOP per sample; table mode reads 64 MB, 0.019 ms,
// for ~10.  The design streams every row once: one block of 512 threads
// per segment (200 blocks, all resident at once on 132 SMs), each thread
// accumulating FP32 partials over coalesced 8-byte loads, four loads per
// operand in flight, then a warp-shuffle and shared-memory tree.  The
// order of the sums is fixed: no atomics, the same bits every run.  The
// block indices come in as row offsets from the host; JAX's scalar
// prefetch and 8-segment row tile have no counterpart.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

template <bool kSelf>
__device__ __forceinline__ void accumulate(float& re, float& im, float2 c,
                                           float2 x, float w) {
    if (kSelf) {
        const float zr = fmaf(c.x, c.x, c.y * c.y);
        const float zi = __fsub_rn(__fmul_rn(c.x, c.y), __fmul_rn(c.y, c.x));
        re = fmaf(w, zr, re);
        im = fmaf(w, zi, im);
    } else {
        const float zr = fmaf(c.x, x.x, c.y * x.y);     // conj(c) * x
        const float zi = fmaf(c.x, x.y, -(c.y * x.x));
        re = fmaf(w, zr, re);
        im = fmaf(w, zi, im);
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

template <bool kSelf>
__global__ void __launch_bounds__(kThreads)
lockin_kernel(const float2* __restrict__ table, const float2* __restrict__ sig,
              const float* __restrict__ w, float2* __restrict__ out,
              long long c_row0, long long x_row0, int ppt) {
    __shared__ float2 part[kWarps];
    const int s = blockIdx.x;
    const float2* c = table + (c_row0 + s) * (long long)ppt;
    const float2* x = kSelf ? c : sig + (x_row0 + s) * (long long)ppt;
    float re = 0.f, im = 0.f;
    int k = threadIdx.x;
    for (; k + (kUnroll - 1) * kThreads < ppt; k += kUnroll * kThreads) {
        float2 cv[kUnroll], xv[kUnroll];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            cv[u] = __ldg(c + k + u * kThreads);
            xv[u] = kSelf ? cv[u] : __ldg(x + k + u * kThreads);
            wv[u] = __ldg(w + k + u * kThreads);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            accumulate<kSelf>(re, im, cv[u], xv[u], wv[u]);
    }
    for (; k < ppt; k += kThreads) {
        const float2 cv = __ldg(c + k);
        accumulate<kSelf>(re, im, cv, kSelf ? cv : __ldg(x + k), __ldg(w + k));
    }
    re = warp_sum(re);
    im = warp_sum(im);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = make_float2(re, im);
    __syncthreads();
    if (warp == 0) {
        const float2 p = lane < kWarps ? part[lane] : make_float2(0.f, 0.f);
        re = warp_sum(p.x);
        im = warp_sum(p.y);
        if (lane == 0) out[s] = make_float2(re, im);
    }
}

}  // namespace

// sig == NULL selects self mode (the signal is the table).  c_row0 /
// x_row0: first row of the block in the table / the signal.
extern "C" int sdr_lockin(const void* table, const void* sig, const void* w,
                          void* out, long long c_row0, long long x_row0,
                          int nseg, int ppt, void* stream) {
    if (nseg <= 0 || ppt <= 0 || c_row0 < 0 || x_row0 < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (sig == nullptr)
        lockin_kernel<true><<<(unsigned)nseg, kThreads, 0, st>>>(
            (const float2*)table, nullptr, (const float*)w, (float2*)out,
            c_row0, 0, ppt);
    else
        lockin_kernel<false><<<(unsigned)nseg, kThreads, 0, st>>>(
            (const float2*)table, (const float2*)sig, (const float*)w,
            (float2*)out, c_row0, x_row0, ppt);
    return (int)cudaGetLastError();
}
