// PFB windowed pre-sum, one pass, for Hopper (sm_90a): a streaming
// stencil down the rows.  One body, two ways to address the block's rows
// (rows.cuh).
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
// overlap, and needed 8-aligned tiles and recordings; here no halo array
// and no alignment rule exist.
//
// Bound: device memory.  The function reads each sample once and writes
// each output once, 16 B of HBM traffic a sample against 2*avg FFMA (96
// MB a call at 6000 x 1000).  The design streams rows once:
//   - A block owns a strip of columns and a tile of kRows output rows;
//     the grid is (tiles, strips), so nothing divides.  A thread owns one
//     column: two complex bins, 16-byte loads and stores, where nfft is
//     even and every pointer 16-byte aligned (the wide body); else one
//     bin, 8 bytes (the narrow body).  The launcher picks it per launch.
//   - A thread walks down its tile and loads each ext row of its column
//     once.  For avg <= kMaxRingAvg the avg-term sum comes from a
//     register ring of the last avg rows, the kernel templated on avg so
//     that the ring's indices are known at compile time, and kInFlight
//     rows' loads are issued together.  A larger avg takes a generic
//     body that loads avg rows an output (re-read from L1).
//   - A tile re-reads only its avg-1 halo rows, which the tile before it
//     (the block before it in launch order) has just brought into L2.
//   - The window is loaded into registers once a thread: avg x 2 floats.
//   - A row's source (the spare, a block row, a seam wrap, or zeros) is
//     resolved once a row (rows.cuh row_ptr), not once a sample.
// Accumulation is FP32 FFMA in order i = 0..avg-1.

#include <cstdint>

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr int kRows = 32;         // output rows a tile
constexpr int kThreads = 256;     // threads a block: a strip's columns
constexpr int kInFlight = 2;      // rows whose loads a thread issues at once
constexpr int kMaxRingAvg = 8;    // the largest avg of the register ring

// A column of the wide body: two complex bins and their two window taps.
struct Wide {
    using V = float4;
    using W = float2;
    static constexpr int kBins = 2;
    __device__ static V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ static V load(const float2* row, int c) {
        return __ldg(reinterpret_cast<const float4*>(row) + c);
    }
    __device__ static W tap(const float* w, int c) {
        return __ldg(reinterpret_cast<const float2*>(w) + c);
    }
    __device__ static void fma(W w, V v, V& a) {
        a.x = fmaf(w.x, v.x, a.x);
        a.y = fmaf(w.x, v.y, a.y);
        a.z = fmaf(w.y, v.z, a.z);
        a.w = fmaf(w.y, v.w, a.w);
    }
    __device__ static void store(float2* row, int c, V v) {
        reinterpret_cast<float4*>(row)[c] = v;
    }
};

// A column of the narrow body: one complex bin.
struct Narrow {
    using V = float2;
    using W = float;
    static constexpr int kBins = 1;
    __device__ static V zero() { return make_float2(0.f, 0.f); }
    __device__ static V load(const float2* row, int c) {
        return __ldg(row + c);
    }
    __device__ static W tap(const float* w, int c) { return __ldg(w + c); }
    __device__ static void fma(W w, V v, V& a) {
        a.x = fmaf(w, v.x, a.x);
        a.y = fmaf(w, v.y, a.y);
    }
    __device__ static void store(float2* row, int c, V v) { row[c] = v; }
};

// Column c of extended row g, zeros where the row stands for zeros.
template <class B>
__device__ __forceinline__ typename B::V load_row(const Rows& in,
                                                  long long g, int c) {
    const float2* row = row_ptr(in, g);
    return row != nullptr ? B::load(row, c) : B::zero();
}

// avg = AVG <= kMaxRingAvg.  v[k + i] holds ext row t0 + t + k + i over a
// step of kInFlight output rows t .. t + kInFlight - 1: the step loads its
// kInFlight new rows together, sums, and slides the ring by kInFlight.
template <class B, int AVG>
__global__ void __launch_bounds__(kThreads)
presum_ring(Rows in, const float* __restrict__ w, float2* __restrict__ out) {
    const int c = blockIdx.y * blockDim.x + threadIdx.x;
    if (c >= in.M / B::kBins) return;
    const int t0 = blockIdx.x * kRows;
    const int nt = min(kRows, in.nb - t0);
    typename B::W wr[AVG];
#pragma unroll
    for (int i = 0; i < AVG; ++i) wr[i] = B::tap(w + (long long)i * in.M, c);
    typename B::V v[AVG - 1 + kInFlight];
#pragma unroll
    for (int i = 0; i < AVG - 1; ++i) v[i] = load_row<B>(in, t0 + i, c);
    for (int t = 0; t < nt; t += kInFlight) {
#pragma unroll
        for (int k = 0; k < kInFlight; ++k)
            v[AVG - 1 + k] = t + k < nt
                ? load_row<B>(in, t0 + t + k + AVG - 1, c) : B::zero();
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
            typename B::V acc = B::zero();
#pragma unroll
            for (int i = 0; i < AVG; ++i) B::fma(wr[i], v[k + i], acc);
            if (t + k < nt)
                B::store(out + (long long)(t0 + t + k) * in.M, c, acc);
        }
#pragma unroll
        for (int i = 0; i < AVG - 1; ++i) v[i] = v[i + kInFlight];
    }
}

// Any avg: each output loads its avg rows and taps.
template <class B>
__global__ void __launch_bounds__(kThreads)
presum_any(Rows in, const float* __restrict__ w, float2* __restrict__ out,
           int avg) {
    const int c = blockIdx.y * blockDim.x + threadIdx.x;
    if (c >= in.M / B::kBins) return;
    const int t0 = blockIdx.x * kRows;
    const int nt = min(kRows, in.nb - t0);
    for (int t = 0; t < nt; ++t) {
        typename B::V acc = B::zero();
        for (int i = 0; i < avg; ++i)
            B::fma(B::tap(w + (long long)i * in.M, c),
                   load_row<B>(in, t0 + t + i, c), acc);
        B::store(out + (long long)(t0 + t) * in.M, c, acc);
    }
}

// The launch plan (ops/presum.py presum_plan mirrors it): complex bins a
// column (vec), threads a block, column strips, rows a tile, row tiles,
// and the ring's avg (0: the generic body).
struct Plan {
    int vec, threads, strips, rows, tiles, ring;
};

Plan make_plan(int T, int nfft, int avg, bool aligned) {
    Plan p;
    p.vec = aligned && nfft % 2 == 0 ? 2 : 1;
    const int cols = nfft / p.vec;
    const int whole = (cols + 31) / 32 * 32;     // whole warps
    p.threads = whole < kThreads ? whole : kThreads;
    p.strips = (cols + p.threads - 1) / p.threads;
    p.rows = kRows;
    p.tiles = (T + kRows - 1) / kRows;
    p.ring = avg <= kMaxRingAvg ? avg : 0;
    return p;
}

bool aligned_to(const void* p, unsigned n) {
    return reinterpret_cast<std::uintptr_t>(p) % n == 0;
}

template <class B>
void launch_body(const Plan& p, const Rows& in, const float* w, float2* out,
                 int avg, cudaStream_t s) {
    const dim3 grid(p.tiles, p.strips);
    switch (p.ring) {
        case 1: presum_ring<B, 1><<<grid, p.threads, 0, s>>>(in, w, out); break;
        case 2: presum_ring<B, 2><<<grid, p.threads, 0, s>>>(in, w, out); break;
        case 3: presum_ring<B, 3><<<grid, p.threads, 0, s>>>(in, w, out); break;
        case 4: presum_ring<B, 4><<<grid, p.threads, 0, s>>>(in, w, out); break;
        case 5: presum_ring<B, 5><<<grid, p.threads, 0, s>>>(in, w, out); break;
        case 6: presum_ring<B, 6><<<grid, p.threads, 0, s>>>(in, w, out); break;
        case 7: presum_ring<B, 7><<<grid, p.threads, 0, s>>>(in, w, out); break;
        case 8: presum_ring<B, 8><<<grid, p.threads, 0, s>>>(in, w, out); break;
        default: presum_any<B><<<grid, p.threads, 0, s>>>(in, w, out, avg);
    }
}

// The wide body needs nfft even and the rows (x, hist, out) 16-byte and
// the window 8-byte aligned: a view of a recording may start on an odd
// sample.
int launch(const Rows& in, const void* w, void* out, int avg, void* stream) {
    if (in.nb < 0 || in.M < 1 || avg < 1) return (int)cudaErrorInvalidValue;
    if (in.nb == 0) return 0;
    const bool aligned = aligned_to(in.x, 16) && aligned_to(in.hist, 16) &&
                         aligned_to(out, 16) && aligned_to(w, 8);
    const Plan p = make_plan(in.nb, in.M, avg, aligned);
    const cudaStream_t s = (cudaStream_t)stream;
    if (p.vec == 2)
        launch_body<Wide>(p, in, (const float*)w, (float2*)out, avg, s);
    else
        launch_body<Narrow>(p, in, (const float*)w, (float2*)out, avg, s);
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

// The launch plan for T, nfft, avg and the pointers' alignment (ops/
// presum.py presum_plan mirrors it): Plan's 6 fields in order into out;
// -1 for T, nfft or avg out of range.
extern "C" int sdr_presum_plan(int T, int nfft, int avg, int aligned,
                               int* out) {
    if (T < 0 || nfft < 1 || avg < 1) return -1;
    const Plan p = make_plan(T, nfft, avg, aligned != 0);
    const int v[] = {p.vec, p.threads, p.strips, p.rows, p.tiles, p.ring};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 0;
}

extern "C" const char* sdr_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
