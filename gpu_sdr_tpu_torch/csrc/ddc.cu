// Multi-tone direct down-conversion + decimating polyphase FIR (DIRECT
// mode), one pass, for Hopper (sm_90a).
//
// Replaces three TPU kernels that compute one function and differ only
// in where their input rows come from and in how they fill the MXU:
//   gpu_sdr_tpu/ops/pallas_ddc.py:    _pallas_ddc (_kernel), via ddc_fused
//   gpu_sdr_tpu/ops/pallas_replay.py: ReplayDDC.multi_step (_kernel)
//   gpu_sdr_tpu/ops/pallas_replay.py: ReplayDDCT.multi_step (_kernel_t)
//
//   y[n, c] = rot_c * ramp[n, c] * sum_{j<f} sum_{m<M} E[n + j, m] * hmod[j*M + m, c]
//
// E is the block's extended (nb + f - 1, M) row view: f - 1 history
// rows, then the block's nb rows, from a streamed block (a) or read in
// place from a resident recording (b) (rows.cuh).
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
// extended rows in shared memory, a chunk of samples of each row at a
// time, so any M fits; the row pitch is odd so that row-strided reads
// hit distinct banks.  Two thread mappings:
//   channel mode (many channels, config 3): lanes over 32 channels, each
//     thread 8 rows in registers; hmod[i, c] is read through L1/L2,
//     coalesced, once per 8 rows, and every staged sample is a shared-
//     memory broadcast to the warp.
//   row mode (at most 8 channels, config 1 has 1): one thread per output
//     row looping over the channels in registers, so no lane idles at
//     C = 1; hmod reads are warp-uniform broadcasts.
// Accumulation is FP32 FFMA, taps in order j, then m.

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

    for (int m0 = 0; m0 < in.M; m0 += kChunkC) {
        const int mc = min(kChunkC, in.M - m0);
        __syncthreads();
        stage(xs, in, n0, kTileC + in.lead, m0, mc, pitch,
              ty * kLanes + tx, kLanes * kGroups);
        __syncthreads();
        for (int j = 0; j < f; ++j) {
            const float2* h = hmod + ((long long)j * in.M + m0) * C + cl;
            const float2* xr = xs + (ty + j) * pitch;
            for (int m = 0; m < mc; ++m) {
                const float2 hv = __ldg(h + (long long)m * C);
#pragma unroll
                for (int k = 0; k < kRowsPerThread; ++k)
                    cmac(acc[k], xr[k * kGroups * pitch + m], hv);
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

    for (int m0 = 0; m0 < in.M; m0 += kChunkR) {
        const int mc = min(kChunkR, in.M - m0);
        __syncthreads();
        stage(xs, in, n0, kTileR + in.lead, m0, mc, pitch, t, kTileR);
        __syncthreads();
        for (int j = 0; j < f; ++j) {
            const float2* h = hmod + ((long long)j * in.M + m0) * C;
            const float2* xr = xs + (t + j) * pitch;
            for (int m = 0; m < mc; ++m) {
                const float2 xv = xr[m];
#pragma unroll
                for (int c = 0; c < kMaxRowChannels; ++c)
                    if (c < C) cmac(acc[c], xv, __ldg(h + (long long)m * C + c));
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

int smem_bytes(int lead, int row_mode) {
    return row_mode ? (kTileR + lead) * (kChunkR + 1) * (int)sizeof(float2)
                    : (kTileC + lead) * (kChunkC + 1) * (int)sizeof(float2);
}

}  // namespace

extern "C" int sdr_ddc(const void* x, const void* hist, const void* hmod,
                       const void* ramp, const void* phase, void* out,
                       long long x_rows, long long base, int nb, int M,
                       int f, int C, int valid, float two_pi_w,
                       int row_mode, void* stream) {
    if (nb <= 0 || M <= 0 || f <= 0 || C <= 0 ||
        (row_mode && C > kMaxRowChannels))
        return (int)cudaErrorInvalidValue;
    const Rows in{(const float2*)x, (const float2*)hist, x_rows, base, nb,
                  f - 1, M, valid};
    // an f too deep for shared memory fails here, cudaErrorInvalidValue
    const int smem = smem_bytes(f - 1, row_mode);
    if (smem > 48 * 1024) {
        const cudaError_t e = row_mode
            ? cudaFuncSetAttribute(ddc_row_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem)
            : cudaFuncSetAttribute(ddc_channel_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (e != cudaSuccess) return (int)e;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    if (row_mode) {
        ddc_row_kernel<<<(unsigned)((nb + kTileR - 1) / kTileR), kTileR,
                         smem, s>>>(
            in, (const float2*)hmod, (const float2*)ramp,
            (const long long*)phase, (float2*)out, f, C, two_pi_w);
    } else {
        const dim3 grid((unsigned)((nb + kTileC - 1) / kTileC),
                        (unsigned)((C + kLanes - 1) / kLanes));
        ddc_channel_kernel<<<grid, dim3(kLanes, kGroups), smem, s>>>(
            in, (const float2*)hmod, (const float2*)ramp,
            (const long long*)phase, (float2*)out, f, C, two_pi_w);
    }
    return (int)cudaGetLastError();
}
