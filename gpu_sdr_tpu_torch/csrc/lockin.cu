// Chirp lock-in, one block per segment, for Hopper (sm_90a).  One body,
// three modes.
//
// Replaces the TPU kernels gpu_sdr_tpu/ops/pallas_lockin.py:
//   pallas_chirp_lockin_table       (table mode; the host-fed CHIRP
//                                    demodulator's table step and the
//                                    device replay's chirp_table)
//   pallas_chirp_lockin_table_self  (self mode; the fused CHIRP->CHIRP
//                                    loopback, chain chirp_wavetable)
//   pallas_chirp_lockin_at          (chirp mode; the device replay's
//                                    chirp_at, _kernel and _phase_wave)
//
// The integer-phase chirp repeats exactly every period, so one period of
// the oscillator can live in device memory as (period/ppt, ppt) segment
// rows, and each block reads its rows in place, by row offset:
//
//   table: y[s] = sum_k w[k] * conj(c[c_row0 + s, k]) * x[x_row0 + s, k]
//   self:  y[s] = sum_k w[k] * |c[c_row0 + s, k]|^2     (imag exactly 0)
//   chirp: y[s] = sum_k w[k] * conj(c(last, s*ppt + k)) * x[x_row0 + s, k]
//
// In self mode the signal is the table (the loopback), each row is read
// once, and the imaginary half is formed from the same product set as
// the JAX kernel, cr*ci - ci*cr, with __fmul_rn so that nvcc cannot
// contract one product into an FMA: it is exactly 0, as on the TPU.
//
// Chirp mode forms the oscillator in registers from the stream position
// `last` of the block's first sample, where no table fits (a period that
// blocks do not divide, or a table over the device budget).  The phase
// is _phase_wave's wrapping uint32 arithmetic (CUDA's unsigned int):
//   eff = last % period + n % period, wrapped once;  fi = eff / length
//   q   = (fi/2)*(fi+1) + (fi%2)*((fi+1)/2);          pc = chirpness*(length*q)
//   idx = (int)(eff*(f0 + fi*chirpness) - pc)
//   th  = pi_f * ((float)idx * inv_f);  c = (sin th, -cos th)
// with pi_f and inv_f the wrapper's float32 constants, and the accurate
// sincosf (|th| < 2.3, so it takes its fast reduction path).  Any
// (rows, ppt) recording works: x_row0 is a 64-bit row offset, so a
// streamed block is the same body at x_row0 = 0.
//
// Bound: device memory.  Config 2 (ppt 20,000, 200 segments per
// 4,000,000-sample block): self mode reads 32 MB per block, 0.0096 ms at
// 3.35 TB/s, for ~5 FLOP per sample; table mode reads 64 MB, 0.019 ms,
// for ~10.  Chirp mode reads 8 bytes a sample (48 MB per 6,000,000-
// sample block, 0.0143 ms) against ~50 integer and float operations a
// sample (the phase, sincos, the mix and the sum): close to the card's
// balance, so both its loads and its arithmetic must stay in flight.
// The design streams every row once: one block of 512 threads per
// segment (200-300 blocks, all resident at once on 132 SMs), each
// thread accumulating FP32 partials over coalesced 8-byte loads, four
// loads per operand in flight, then a warp-shuffle and shared-memory
// tree.  The order of the sums is fixed: no atomics, the same bits every
// run.  The block indices come in as row offsets from the host; JAX's
// scalar prefetch and 8-segment row tile have no counterpart.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

enum Mode { kTable, kSelf, kChirp };

// The integer-phase chirp of chirp mode (ops/chirp.ChirpConfig).
struct Chirp {
    unsigned period, length, chirpness, f0;
    unsigned last;        // stream position of the block's first sample,
                          // already reduced mod period
    float pi, inv;        // float32(pi), float32(1 / 2147483647.5)
};

// The unit chirp at offset n of the block (_phase_wave).
__device__ __forceinline__ float2 chirp_at(const Chirp& ch, unsigned n) {
    unsigned eff = ch.last + n % ch.period;
    if (eff >= ch.period) eff -= ch.period;
    const unsigned fi = eff / ch.length;
    const unsigned q = (fi / 2u) * (fi + 1u) + (fi % 2u) * ((fi + 1u) / 2u);
    const unsigned pc = ch.chirpness * (ch.length * q);
    const int idx = (int)(eff * (ch.f0 + fi * ch.chirpness) - pc);
    const float th = ch.pi * __fmul_rn((float)idx, ch.inv);
    float s, c;
    sincosf(th, &s, &c);
    return make_float2(s, -c);
}

template <Mode kMode>
__device__ __forceinline__ void accumulate(float& re, float& im, float2 c,
                                           float2 x, float w) {
    if (kMode == kSelf) {
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

template <Mode kMode>
__global__ void __launch_bounds__(kThreads)
lockin_kernel(const float2* __restrict__ table, const float2* __restrict__ sig,
              const float* __restrict__ w, float2* __restrict__ out,
              long long c_row0, long long x_row0, int ppt, Chirp ch) {
    __shared__ float2 part[kWarps];
    const int s = blockIdx.x;
    const float2* c = kMode == kChirp ? nullptr
                                      : table + (c_row0 + s) * (long long)ppt;
    const float2* x = kMode == kSelf ? c : sig + (x_row0 + s) * (long long)ppt;
    const unsigned n0 = (unsigned)s * (unsigned)ppt;   // offset in the block
    float re = 0.f, im = 0.f;
    int k = threadIdx.x;
    for (; k + (kUnroll - 1) * kThreads < ppt; k += kUnroll * kThreads) {
        float2 cv[kUnroll], xv[kUnroll];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (kMode != kChirp) cv[u] = __ldg(c + k + u * kThreads);
            xv[u] = kMode == kSelf ? cv[u] : __ldg(x + k + u * kThreads);
            wv[u] = __ldg(w + k + u * kThreads);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (kMode == kChirp) cv[u] = chirp_at(ch, n0 + k + u * kThreads);
            accumulate<kMode>(re, im, cv[u], xv[u], wv[u]);
        }
    }
    for (; k < ppt; k += kThreads) {
        const float2 cv = kMode == kChirp ? chirp_at(ch, n0 + k)
                                          : __ldg(c + k);
        accumulate<kMode>(re, im, cv, kMode == kSelf ? cv : __ldg(x + k),
                          __ldg(w + k));
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
    const Chirp none{};
    if (sig == nullptr)
        lockin_kernel<kSelf><<<(unsigned)nseg, kThreads, 0, st>>>(
            (const float2*)table, nullptr, (const float*)w, (float2*)out,
            c_row0, 0, ppt, none);
    else
        lockin_kernel<kTable><<<(unsigned)nseg, kThreads, 0, st>>>(
            (const float2*)table, (const float2*)sig, (const float*)w,
            (float2*)out, c_row0, x_row0, ppt, none);
    return (int)cudaGetLastError();
}

// Chirp mode: the signal's rows [x_row0, x_row0 + nseg) against the
// chirp from stream position `last`.
extern "C" int sdr_lockin_at(const void* sig, const void* w, void* out,
                             long long x_row0, int nseg, int ppt,
                             unsigned period, unsigned length,
                             unsigned chirpness, unsigned f0, unsigned last,
                             float pi, float inv, void* stream) {
    if (nseg <= 0 || ppt <= 0 || x_row0 < 0 || period == 0 || length == 0 ||
        (long long)nseg * ppt >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const Chirp ch{period, length, chirpness, f0, last % period, pi, inv};
    lockin_kernel<kChirp><<<(unsigned)nseg, kThreads, 0,
                            (cudaStream_t)stream>>>(
        nullptr, (const float2*)sig, (const float*)w, (float2*)out, 0,
        x_row0, ppt, ch);
    return (int)cudaGetLastError();
}
