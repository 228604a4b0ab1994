// Chirp lock-in for Hopper (sm_90a): one body for the table and self
// modes and a kernel of its own for chirp mode, one block a segment.
//
// Replaces the TPU kernels gpu_sdr_tpu/ops/pallas_lockin.py:
//   pallas_chirp_lockin_table       (table mode; the host-fed CHIRP
//                                    demodulator's table step and the
//                                    device replay's chirp_table)
//   pallas_chirp_lockin_table_self  (self mode; the fused CHIRP->CHIRP
//                                    loopback, chain chirp_wavetable)
//   pallas_chirp_lockin_at          (chirp mode; the device replay's
//                                    chirp_at, _kernel and _phase_wave)
//   pallas_chirp_lockin             (chirp mode at row offset 0)
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
// Table and self modes: bound by device memory (config 2, ppt 20,000,
// 200 segments per 4,000,000-sample block: self mode reads 32 MB, 0.0096
// ms at 3.35 TB/s; table mode 64 MB, 0.019 ms).  One block of 512
// threads per segment, each thread accumulating FP32 partials over
// coalesced 8-byte loads, four loads per operand in flight, then a
// warp-shuffle and shared-memory tree.
//
// Chirp mode forms the oscillator in registers from the stream position
// `last` of the block's first sample, where no table fits (a period that
// blocks do not divide, or a table over the device budget).  The phase
// is _phase_wave's wrapping uint32 arithmetic (CUDA's unsigned int):
//   eff = (last + n) mod period;  fi = eff / length  (the step)
//   q   = (fi/2)*(fi+1) + (fi%2)*((fi+1)/2);  pc = chirpness*(length*q)
//   idx = eff*(f0 + fi*chirpness) - pc
// It reads 8 bytes a sample (48 MB per 6,000,000-sample block, 0.0144
// ms), so its per-sample arithmetic must stay under that:
//   - The phase is a recurrence.  While fi holds, idx(eff + d) = idx(eff)
//     + d*F with F = f0 + fi*chirpness, exactly mod 2^32.  A thread owns
//     the columns j, j + T, j + 2T, ... of its segment (T column vectors
//     a stride), so it adds G = F*stride each stride and F between the
//     two samples of a 16-byte vector.  Only where its
//     position reaches the step's end `nb` (a step boundary, or the seam
//     where the last step ends the period) does it walk on (`settle`:
//     one step a boundary, eff wrapped at the seam) and form idx afresh.
//     The per-sample loop holds no division: a thread divides once, at
//     its start (its segment's first position mod period, and its
//     step).  Any ppt against length, a period shorter than a segment
//     and a down-chirp (chirpness past 2^31) run the same walk.
//   - The oscillator (sin th, -cos th) at th = pi_f*((float)idx*inv_f)
//     (the plain version's float32 th) is the MUFU __sincosf, chosen by
//     measurement over the accurate sincosf and a sincos from the
//     integer phase itself (its top bits pick the nearest quarter turn,
//     minimax polynomials give the rest): on an H100 all three hold the
//     90 dB bars against float64 (the oscillator alone 135.7, 141.7 and
//     149.4 dB) and MUFU is the fastest (bench/lockin_variants.py keeps
//     the other two as variants; their numbers in PERF.md).
//   - One block of kChirpThreads a segment.  Few, long blocks beat many
//     short ones: a block's start (its position mod period, its step)
//     and its sums cost the same however few columns it walks.
//   - Two samples a 16-byte load (float4) and two taps a float2, where
//     ppt is even and the row and profile pointers aligned (the wide
//     body); else 8-byte loads (the narrow body).  The launcher picks it
//     per launch: a view of a recording may start on an odd row.
// The order of every sum is fixed (a thread's columns in turn, a shuffle
// tree, the warps): no atomics, the same bits
// every run.  The block indices come in as row offsets from the host;
// JAX's scalar prefetch and 8-segment row tile have no counterpart.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

constexpr int kChirpThreads = 256;  // threads a block of chirp mode
constexpr int kChirpWarps = kChirpThreads / 32;
constexpr int kChirpUnroll = 4;     // column vectors whose loads a thread
                                    // issues at once

enum Mode { kTable, kSelf };

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
              long long c_row0, long long x_row0, int ppt) {
    __shared__ float2 part[kWarps];
    const int s = blockIdx.x;
    const float2* c = table + (c_row0 + s) * (long long)ppt;
    const float2* x = kMode == kSelf ? c : sig + (x_row0 + s) * (long long)ppt;
    float re = 0.f, im = 0.f;
    int k = threadIdx.x;
    for (; k + (kUnroll - 1) * kThreads < ppt; k += kUnroll * kThreads) {
        float2 cv[kUnroll], xv[kUnroll];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            cv[u] = __ldg(c + k + u * kThreads);
            xv[u] = kMode == kSelf ? cv[u] : __ldg(x + k + u * kThreads);
            wv[u] = __ldg(w + k + u * kThreads);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            accumulate<kMode>(re, im, cv[u], xv[u], wv[u]);
    }
    for (; k < ppt; k += kThreads) {
        const float2 cv = __ldg(c + k);
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

// ---- chirp mode -----------------------------------------------------

// The integer-phase chirp (ops/chirp.ChirpConfig).
struct Chirp {
    unsigned period, length, chirpness, f0;
    unsigned last;        // stream position of the block's first sample,
                          // already reduced mod period
    float pi, inv;        // float32(pi), float32(1 / 2147483647.5)
};

// idx at stream position eff of step fi (_phase_wave).
__device__ __forceinline__ unsigned phase_at(const Chirp& ch, unsigned eff,
                                             unsigned fi) {
    const unsigned q = (fi >> 1) * (fi + 1u) + (fi & 1u) * ((fi + 1u) >> 1);
    return eff * (ch.f0 + fi * ch.chirpness) - ch.chirpness * (ch.length * q);
}

// Walk (eff, fi, nb) on until eff lies before its step's end nb: one step
// a boundary crossed, eff wrapped to step 0 at the seam.
__device__ __forceinline__ void settle(const Chirp& ch, unsigned& eff,
                                       unsigned& fi, unsigned& nb) {
    while (eff >= nb) {
        if (nb == ch.period) {
            eff -= ch.period;
            fi = 0u;
            nb = ch.length;
        } else {
            ++fi;
            nb += ch.length;
        }
    }
}

// A thread's walk over its columns: the stream position eff of its
// current column vector's first sample, the step fi and its end nb, the
// step's increment F and its stride multiple G, and idx at eff.
struct Walk {
    unsigned eff, fi, nb, F, G, ia;
};

// The walk of a thread whose first sample is at block offset n0 + off:
// n0 (< 2^31) is its segment's first sample, reduced mod period once.
template <int V>
__device__ __forceinline__ Walk walk_start(const Chirp& ch, unsigned n0,
                                           unsigned off) {
    constexpr unsigned kStride = kChirpThreads * V;
    Walk w;
    unsigned e0 = ch.last + n0 % ch.period;
    if (e0 >= ch.period) e0 -= ch.period;
    w.fi = e0 / ch.length;
    w.nb = (w.fi + 1u) * ch.length;
    w.eff = e0 + off;
    settle(ch, w.eff, w.fi, w.nb);
    w.F = ch.f0 + w.fi * ch.chirpness;
    w.G = w.F * kStride;
    w.ia = phase_at(ch, w.eff, w.fi);
    return w;
}

// idx of the current column vector's samples (a; b, the second, where
// V is 2), then the walk one stride on.
template <int V>
__device__ __forceinline__ void walk_next(const Chirp& ch, Walk& w,
                                          unsigned& a, unsigned& b) {
    constexpr unsigned kStride = kChirpThreads * V;
    a = w.ia;
    if (V == 2) {
        if (w.eff + 1u < w.nb) {
            b = w.ia + w.F;
        } else {
            unsigned e = w.eff + 1u, f = w.fi, n = w.nb;
            settle(ch, e, f, n);
            b = phase_at(ch, e, f);
        }
    }
    w.eff += kStride;
    w.ia += w.G;
    if (w.eff >= w.nb) {
        settle(ch, w.eff, w.fi, w.nb);
        w.F = ch.f0 + w.fi * ch.chirpness;
        w.G = w.F * kStride;
        w.ia = phase_at(ch, w.eff, w.fi);
    }
}

// The unit chirp (sin th, -cos th) at th = pi * idx / 2^31, by MUFU.
__device__ __forceinline__ float2 osc(const Chirp& ch, unsigned idx) {
    const float th = ch.pi * __fmul_rn((float)(int)idx, ch.inv);
    float s, c;
    __sincosf(th, &s, &c);
    return make_float2(s, -c);
}

// A column vector of the wide body: two samples (16 bytes), two taps.
struct Wide {
    static constexpr int kVec = 2;
    using X = float4;
    using W = float2;
    __device__ static X zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ static X load(const float2* row, int j) {
        return __ldg(reinterpret_cast<const float4*>(row) + j);
    }
    __device__ static W tap(const float* w, int j) {
        return __ldg(reinterpret_cast<const float2*>(w) + j);
    }
    __device__ static void mix(float2 ca, float2 cb, X x, W w, float& re,
                               float& im) {
        accumulate<kTable>(re, im, ca, make_float2(x.x, x.y), w.x);
        accumulate<kTable>(re, im, cb, make_float2(x.z, x.w), w.y);
    }
};

// A column vector of the narrow body: one sample (8 bytes).
struct Narrow {
    static constexpr int kVec = 1;
    using X = float2;
    using W = float;
    __device__ static X zero() { return make_float2(0.f, 0.f); }
    __device__ static X load(const float2* row, int j) {
        return __ldg(row + j);
    }
    __device__ static W tap(const float* w, int j) { return __ldg(w + j); }
    __device__ static void mix(float2 ca, float2, X x, W w, float& re,
                               float& im) {
        accumulate<kTable>(re, im, ca, x, w);
    }
};

// Chirp mode: block s walks segment s's row.
template <class B>
__global__ void __launch_bounds__(kChirpThreads)
chirp_kernel(const float2* __restrict__ sig, const float* __restrict__ w,
             float2* __restrict__ out, long long x_row0, int ppt, Chirp ch) {
    constexpr int V = B::kVec;
    __shared__ float2 warps[kChirpWarps];
    const int s = blockIdx.x, cols = ppt / V;
    const float2* x = sig + (x_row0 + s) * (long long)ppt;
    Walk wk = walk_start<V>(ch, (unsigned)s * (unsigned)ppt, threadIdx.x * V);
    float re = 0.f, im = 0.f;
    for (int j = threadIdx.x; j < cols; j += kChirpUnroll * kChirpThreads) {
        typename B::X xv[kChirpUnroll];
        typename B::W wv[kChirpUnroll];
#pragma unroll
        for (int u = 0; u < kChirpUnroll; ++u) {
            const int c = j + u * kChirpThreads;
            xv[u] = c < cols ? B::load(x, c) : B::zero();
            wv[u] = c < cols ? B::tap(w, c) : typename B::W{};
        }
#pragma unroll
        for (int u = 0; u < kChirpUnroll; ++u) {
            unsigned a, b = 0u;
            walk_next<V>(ch, wk, a, b);
            if (j + u * kChirpThreads < cols) {
                const float2 ca = osc(ch, a);
                B::mix(ca, V == 2 ? osc(ch, b) : ca, xv[u], wv[u], re, im);
            }
        }
    }
    re = warp_sum(re);
    im = warp_sum(im);
    const int lane = threadIdx.x & 31;
    if (lane == 0) warps[threadIdx.x >> 5] = make_float2(re, im);
    __syncthreads();
    // every warp sums the warps' partials alike (no divergent shuffle);
    // thread 0's is the segment's
    const float2 v = lane < kChirpWarps ? warps[lane] : make_float2(0.f, 0.f);
    re = warp_sum(v.x);
    im = warp_sum(v.y);
    if (threadIdx.x == 0) out[s] = make_float2(re, im);
}

// The integer phases chirp mode's walk gives, stored (idx[s*ppt + k]):
// the walk checked exactly on the card.
template <int V>
__global__ void __launch_bounds__(kChirpThreads)
chirp_phase_kernel(int* __restrict__ out, int ppt, Chirp ch) {
    const int s = blockIdx.x, cols = ppt / V;
    Walk wk = walk_start<V>(ch, (unsigned)s * (unsigned)ppt, threadIdx.x * V);
    int* row = out + (long long)s * ppt;
    for (int j = threadIdx.x; j < cols; j += kChirpThreads) {
        unsigned a, b = 0u;
        walk_next<V>(ch, wk, a, b);
        row[j * V] = (int)a;
        if (V == 2) row[j * V + 1] = (int)b;
    }
}

// The launch plan of chirp mode (ops/lockin_at.py chirp_plan mirrors
// it): samples a column vector (vec: 2, the wide body; 1, the narrow),
// threads a block, blocks (one a segment).
struct ChirpPlan {
    int vec, threads, blocks;
};

ChirpPlan make_chirp_plan(int nseg, int ppt, bool aligned) {
    ChirpPlan p;
    p.vec = aligned && ppt % 2 == 0 ? 2 : 1;
    p.threads = kChirpThreads;
    p.blocks = nseg;
    return p;
}

bool aligned_to(const void* p, unsigned n) {
    return reinterpret_cast<std::uintptr_t>(p) % n == 0;
}

int chirp_args_ok(int nseg, int ppt, unsigned period, unsigned length) {
    return nseg > 0 && ppt > 0 && period > 0 && length > 0 &&
           period < (1u << 31) && (long long)nseg * ppt < (1LL << 31);
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
        lockin_kernel<kSelf><<<(unsigned)nseg, kThreads, 0, st>>>(
            (const float2*)table, nullptr, (const float*)w, (float2*)out,
            c_row0, 0, ppt);
    else
        lockin_kernel<kTable><<<(unsigned)nseg, kThreads, 0, st>>>(
            (const float2*)table, (const float2*)sig, (const float*)w,
            (float2*)out, c_row0, x_row0, ppt);
    return (int)cudaGetLastError();
}

// Chirp mode: the signal's rows [x_row0, x_row0 + nseg) against the
// chirp from stream position `last`.  The wide body needs ppt even, the
// block's first row 16-byte and the profile 8-byte aligned.
extern "C" int sdr_lockin_at(const void* sig, const void* w, void* out,
                             long long x_row0, int nseg, int ppt,
                             unsigned period, unsigned length,
                             unsigned chirpness, unsigned f0, unsigned last,
                             float pi, float inv, void* stream) {
    if (!chirp_args_ok(nseg, ppt, period, length) || x_row0 < 0)
        return (int)cudaErrorInvalidValue;
    const Chirp ch{period, length, chirpness, f0, last % period, pi, inv};
    const float2* x = (const float2*)sig;
    const bool aligned = aligned_to(x + x_row0 * ppt, 16) && aligned_to(w, 8);
    const ChirpPlan p = make_chirp_plan(nseg, ppt, aligned);
    const cudaStream_t st = (cudaStream_t)stream;
    if (p.vec == 2)
        chirp_kernel<Wide><<<(unsigned)p.blocks, p.threads, 0, st>>>(
            x, (const float*)w, (float2*)out, x_row0, ppt, ch);
    else
        chirp_kernel<Narrow><<<(unsigned)p.blocks, p.threads, 0, st>>>(
            x, (const float*)w, (float2*)out, x_row0, ppt, ch);
    return (int)cudaGetLastError();
}

// The launch plan of chirp mode for nseg, ppt and the pointers'
// alignment (ops/lockin_at.py chirp_plan mirrors it): ChirpPlan's 3
// fields in order into out; -1 for nseg or ppt out of range.
extern "C" int sdr_lockin_chirp_plan(int nseg, int ppt, int aligned,
                                     int* out) {
    if (nseg <= 0 || ppt <= 0 || (long long)nseg * ppt >= (1LL << 31))
        return -1;
    const ChirpPlan p = make_chirp_plan(nseg, ppt, aligned != 0);
    const int v[] = {p.vec, p.threads, p.blocks};
    for (int i = 0; i < 3; ++i) out[i] = v[i];
    return 0;
}

// The integer phases of chirp mode's walk for nseg segments of ppt from
// stream position `last`, on the body `vec` (2: the wide body, where ppt
// is even), into idx (nseg * ppt int32).
extern "C" int sdr_lockin_chirp_phases(void* idx, int nseg, int ppt,
                                       int vec, unsigned period,
                                       unsigned length, unsigned chirpness,
                                       unsigned f0, unsigned last,
                                       void* stream) {
    if (!chirp_args_ok(nseg, ppt, period, length))
        return (int)cudaErrorInvalidValue;
    const Chirp ch{period, length, chirpness, f0, last % period, 0.f, 0.f};
    const ChirpPlan p = make_chirp_plan(nseg, ppt, vec == 2);
    const cudaStream_t st = (cudaStream_t)stream;
    if (p.vec == 2)
        chirp_phase_kernel<2><<<(unsigned)p.blocks, p.threads, 0, st>>>(
            (int*)idx, ppt, ch);
    else
        chirp_phase_kernel<1><<<(unsigned)p.blocks, p.threads, 0, st>>>(
            (int*)idx, ppt, ch);
    return (int)cudaGetLastError();
}
