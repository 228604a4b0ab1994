// Multi-tone direct down-conversion + decimating polyphase FIR (DIRECT
// mode), one pass, for Hopper (sm_90a).
//
// Replaces four TPU kernels that compute one function and differ only
// in where their input rows come from and in how they fill the MXU:
//   gpu_sdr_tpu/ops/pallas_ddc.py:    _pallas_ddc (_kernel), via ddc_fused
//   gpu_sdr_tpu/ops/pallas_replay.py: ReplayDDC.multi_step (_kernel)
//   gpu_sdr_tpu/ops/pallas_replay.py: ReplayDDCT.multi_step (_kernel_t)
//   gpu_sdr_tpu/ops/pallas_replay.py: ShardedReplayDDC.invoke_local
//                                     (_kernel_h), via sdr_ddc_staged
//
//   y[n, c] = rot_c * ramp[n, c] * sum_{j<f} sum_{m<M} E[n + j, m] * hmod[j*M + m, c]
//
// E is the block's extended (nb + f - 1, M) row view: f - 1 history
// rows, then the block's nb rows, from a streamed block (a), read in
// place from a resident recording (b), or from one time shard's span of
// it after a staged history (c) (rows.cuh).
// rot_c = exp(-2 pi i phase_c / W) is formed here from the exact integer
// phase, in float32 as the JAX package forms it (ops/ddc.py:141-143),
// with the precise sincosf.
//
// Bound: FP32 arithmetic and the loads that feed it, not device memory.
// Each output costs 4*f*M FFMA against 8 bytes written: at config 3
// (M 100, f 4, C 100) that is 12.8 GFLOP per 4,000,000-sample block
// against 32 MB read and 32 MB written.  The TPU kernels' bf16 hi/lo
// split, 8-row halo units, pre-tiled transposed recording and lane
// padding have no counterpart: the arithmetic is FP32 FFMA (the 90 dB
// bar rules out TF32) and the halo is read where it lies.
//
// Design: a block owns a tile of output rows and stages the tile's
// extended rows in shared memory, a chunk of taps and a chunk of samples
// of each row at a time, so any M and any f fit: for taps [j0, j0 + J)
// the tile's rows [n0 + j0, n0 + j0 + tile + J - 1) are staged and
// accumulated, J the most taps whose rows keep a block within the
// default 48 KB (31 in channel mode, 59 in row mode), so shared memory
// is bounded by J and not by f.  The row pitch is odd so that row-strided
// reads hit distinct banks.  Two thread mappings:
//   channel mode (many channels, config 3): lanes over 32 channels, each
//     thread 8 rows in registers; hmod[i, c] is read through L1/L2,
//     coalesced, once per 8 rows, and every staged sample is a shared-
//     memory broadcast to the warp.
//   row mode (at most 8 channels, config 1 has 1): one thread per output
//     row looping over the channels in registers, so no lane idles at
//     C = 1; hmod reads are warp-uniform broadcasts.
// Accumulation is FP32 FFMA, taps in order: chunks of J taps, then
// chunks of samples, then j, then m.

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr int kLanes = 32;        // channel mode: channels per block
constexpr int kGroups = 8;        // channel mode: warps (row groups)
constexpr int kRowsPerThread = 8; // channel mode: rows per thread
constexpr int kTileC = kGroups * kRowsPerThread;   // 64 rows per block
constexpr int kChunkC = 64;       // channel mode: staged samples per row
constexpr int kTileR = 128;       // row mode: rows (threads) per block
constexpr int kChunkR = 32;       // row mode: staged samples per row
constexpr int kMaxRowChannels = 8;
constexpr int kSmemDefault = 48 * 1024;   // a block's shared memory, no opt-in

// Taps staged per pass: the most whose tile + taps - 1 rows of a chunk
// fit kSmemDefault (31 in channel mode, 59 in row mode).
constexpr int taps_per_pass(int tile, int chunk) {
    return kSmemDefault / ((chunk + 1) * (int)sizeof(float2)) - tile + 1;
}
constexpr int kTapsC = taps_per_pass(kTileC, kChunkC);
constexpr int kTapsR = taps_per_pass(kTileR, kChunkR);
static_assert((kTileC + kTapsC - 1) * (kChunkC + 1) * sizeof(float2) <=
              kSmemDefault, "channel mode over 48 KB");
static_assert((kTileR + kTapsR - 1) * (kChunkR + 1) * sizeof(float2) <=
              kSmemDefault, "row mode over 48 KB");

// Stage extended rows [g0, g0 + nrows), columns [m0, m0 + mc).
__device__ __forceinline__ void stage(float2* xs, const Rows& in,
                                      long long g0, int nrows, int m0,
                                      int mc, int pitch, int tid,
                                      int nthreads) {
    for (int e = tid; e < nrows * mc; e += nthreads) {
        const int q = e / mc;
        const int m = e - q * mc;
        xs[q * pitch + m] = sample(in, g0 + q, m0 + m);
    }
}

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 rotation(const long long* phase, int c,
                                           float two_pi_w) {
    float s, co;
    sincosf((float)phase[c] * two_pi_w, &s, &co);
    return make_float2(co, -s);
}

// kDeep: f > kTapsC, passes of kTapsC taps; else one pass of all f taps,
// the j0 loop gone at compile time.
template <bool kDeep>
__global__ void __launch_bounds__(kLanes * kGroups)
ddc_channel_kernel(Rows in, const float2* __restrict__ hmod,
                   const float2* __restrict__ ramp,
                   const long long* __restrict__ phase,
                   float2* __restrict__ out, int f, int C, float two_pi_w) {
    extern __shared__ float2 xs[];
    const int pitch = kChunkC + 1;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int c = blockIdx.y * kLanes + tx;
    const int cl = c < C ? c : C - 1;             // dead lanes load a live column
    const long long n0 = (long long)blockIdx.x * kTileC;
    float2 acc[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) acc[k] = make_float2(0.f, 0.f);

    for (int j0 = 0; j0 < (kDeep ? f : 1); j0 += kTapsC) {
        const int jc = kDeep ? min(kTapsC, f - j0) : f;
        for (int m0 = 0; m0 < in.M; m0 += kChunkC) {
            const int mc = min(kChunkC, in.M - m0);
            __syncthreads();
            stage(xs, in, n0 + j0, kTileC + jc - 1, m0, mc, pitch,
                  ty * kLanes + tx, kLanes * kGroups);
            __syncthreads();
            for (int j = 0; j < jc; ++j) {
                const float2* h = hmod + ((long long)(j0 + j) * in.M + m0) * C
                                  + cl;
                const float2* xr = xs + (ty + j) * pitch;
                for (int m = 0; m < mc; ++m) {
                    const float2 hv = __ldg(h + (long long)m * C);
#pragma unroll
                    for (int k = 0; k < kRowsPerThread; ++k)
                        cmac(acc[k], xr[k * kGroups * pitch + m], hv);
                }
            }
        }
    }
    if (c >= C) return;
    const float2 rot = rotation(phase, c, two_pi_w);
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
        const long long n = n0 + ty + k * kGroups;
        if (n < in.nb) {
            const long long o = n * C + c;
            out[o] = cmul(cmul(acc[k], ramp[o]), rot);
        }
    }
}

template <bool kDeep>             // as ddc_channel_kernel's, at kTapsR
__global__ void __launch_bounds__(kTileR)
ddc_row_kernel(Rows in, const float2* __restrict__ hmod,
               const float2* __restrict__ ramp,
               const long long* __restrict__ phase,
               float2* __restrict__ out, int f, int C, float two_pi_w) {
    extern __shared__ float2 xs[];
    const int pitch = kChunkR + 1;
    const int t = threadIdx.x;
    const long long n0 = (long long)blockIdx.x * kTileR;
    float2 acc[kMaxRowChannels];
#pragma unroll
    for (int c = 0; c < kMaxRowChannels; ++c) acc[c] = make_float2(0.f, 0.f);

    for (int j0 = 0; j0 < (kDeep ? f : 1); j0 += kTapsR) {
        const int jc = kDeep ? min(kTapsR, f - j0) : f;
        for (int m0 = 0; m0 < in.M; m0 += kChunkR) {
            const int mc = min(kChunkR, in.M - m0);
            __syncthreads();
            stage(xs, in, n0 + j0, kTileR + jc - 1, m0, mc, pitch, t, kTileR);
            __syncthreads();
            for (int j = 0; j < jc; ++j) {
                const float2* h = hmod + ((long long)(j0 + j) * in.M + m0) * C;
                const float2* xr = xs + (t + j) * pitch;
                for (int m = 0; m < mc; ++m) {
                    const float2 xv = xr[m];
#pragma unroll
                    for (int c = 0; c < kMaxRowChannels; ++c)
                        if (c < C)
                            cmac(acc[c], xv, __ldg(h + (long long)m * C + c));
                }
            }
        }
    }
    const long long n = n0 + t;
    if (n >= in.nb) return;
#pragma unroll
    for (int c = 0; c < kMaxRowChannels; ++c) {
        if (c < C) {
            const long long o = n * C + c;
            out[o] = cmul(cmul(acc[c], ramp[o]), rotation(phase, c, two_pi_w));
        }
    }
}

// A block's dynamic shared memory: tile + min(f, taps) - 1 staged rows
// (ops/ddc.py smem_bytes mirrors it), at most kSmemDefault for any f.
int smem_bytes(int f, int row_mode) {
    return row_mode
        ? (kTileR + (f < kTapsR ? f : kTapsR) - 1) * (kChunkR + 1) *
              (int)sizeof(float2)
        : (kTileC + (f < kTapsC ? f : kTapsC) - 1) * (kChunkC + 1) *
              (int)sizeof(float2);
}

int launch(const Rows& in, const void* hmod, const void* ramp,
           const void* phase, void* out, int C, float two_pi_w,
           int row_mode, void* stream) {
    const int nb = in.nb, f = in.lead + 1;
    if (nb <= 0 || in.M <= 0 || f <= 0 || C <= 0 ||
        (row_mode && C > kMaxRowChannels))
        return (int)cudaErrorInvalidValue;
    const int smem = smem_bytes(f, row_mode);
    const cudaStream_t s = (cudaStream_t)stream;
    if (row_mode) {
        const auto kernel = f > kTapsR ? ddc_row_kernel<true>
                                       : ddc_row_kernel<false>;
        kernel<<<(unsigned)((nb + kTileR - 1) / kTileR), kTileR, smem, s>>>(
            in, (const float2*)hmod, (const float2*)ramp,
            (const long long*)phase, (float2*)out, f, C, two_pi_w);
    } else {
        const dim3 grid((unsigned)((nb + kTileC - 1) / kTileC),
                        (unsigned)((C + kLanes - 1) / kLanes));
        const auto kernel = f > kTapsC ? ddc_channel_kernel<true>
                                       : ddc_channel_kernel<false>;
        kernel<<<grid, dim3(kLanes, kGroups), smem, s>>>(
            in, (const float2*)hmod, (const float2*)ramp,
            (const long long*)phase, (float2*)out, f, C, two_pi_w);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The launch's shared memory for f taps (row_mode 1: row mode), the
// plan ops/ddc.py smem_bytes mirrors; -1 for f < 1.
extern "C" int sdr_ddc_smem_bytes(int f, int row_mode) {
    return f < 1 ? -1 : smem_bytes(f, row_mode);
}

// (a) a streamed block after its history (`hist` of (f-1)*M samples), or
// (b) block rows [base, base + nb) of an x_rows-row recording (`hist`
// null).
extern "C" int sdr_ddc(const void* x, const void* hist, const void* hmod,
                       const void* ramp, const void* phase, void* out,
                       long long x_rows, long long base, int nb, int M,
                       int f, int C, int valid, float two_pi_w,
                       int row_mode, void* stream) {
    const Rows in{(const float2*)x, (const float2*)hist, x_rows, base, nb,
                  f - 1, M, valid};
    return launch(in, hmod, ramp, phase, out, C, two_pi_w, row_mode, stream);
}

// (c) block `blk` of one time shard's span: rows [blk*nb, (blk+1)*nb) of
// the shard's x_rows rows, its f-1 history rows the staged (nblk, f-1, M)
// array's row blk, zero when `valid` is 0.  Replaces the TPU kernel
// gpu_sdr_tpu/ops/pallas_replay.py: ShardedReplayDDC.invoke_local
// (_kernel_h), the sharded device replay's replay_kernel sub-path.
extern "C" int sdr_ddc_staged(const void* x, const void* staged,
                              const void* hmod, const void* ramp,
                              const void* phase, void* out,
                              long long x_rows, long long blk, int nb,
                              int M, int f, int C, int valid,
                              float two_pi_w, int row_mode, void* stream) {
    if (blk < 0 || (blk + 1) * nb > x_rows || f < 2)
        return (int)cudaErrorInvalidValue;
    const float2* hist = (const float2*)staged + blk * (f - 1) * M;
    const Rows in{(const float2*)x, hist, x_rows, blk * nb, nb, f - 1, M,
                  valid};
    return launch(in, hmod, ramp, phase, out, C, two_pi_w, row_mode, stream);
}
