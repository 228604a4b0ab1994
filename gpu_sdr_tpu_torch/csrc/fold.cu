// Shift-fold TONES->DIRECT loopback, one output tile per block, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_sdr_tpu/ops/pallas_chain.py:
// TonesDirectFoldKernel.invoke_factored (_fold_kernel), the fused
// loopback of an aperiodic comb into a DIRECT receiver (config 3).
// Synthesis, mix-down and FIR are contracted into one (Ct, Cp) constant
// G2 (ops/fold.py), and the comb's phase table factors by tile:
// P[b*R + r, t] = P1[r, t] * PB[b, t].  So, per tile b of R rows,
//
//   y[b*R + r, c] = (sum_t P1[r, t] * crot[b, t] * G2[t, c])
//                   * ramp1[r, c] * qrot[b, c]
//
// with crot = srot * PB[b] and qrot = drot * RB[b] built by the wrapper.
// Nothing is read from device memory per row but the output: P1, G2 and
// ramp1 are small constants (config 3: 50 KB, 80 KB, 50 KB) served by L2.
// The stream's first-block startup correction stays outside (ops/fold.py).
//
// Bound: FP32 arithmetic.  Each output costs 4*Ct FFMA against 8 bytes
// written: config 3 (Ct = Cp = 100, nb 40,000) is 3.2 GFLOP and 32 MB
// per 4,000,000-sample block.  The TPU kernel's bf16 hi/lo split, its
// self-ramp special case (there to save an HBM stream of the ramp; here
// ramp1 is an L2-resident table), lane padding and 8-row rotation units
// have no counterpart.
//
// Design: grid (tile, 32-channel chunk).  A block stages A = P1 * crot[b]
// (R rows x a chunk of Ct) in shared memory, lanes run over channels
// with 8 rows each in registers, G2[t, c] is read coalesced once per 8
// rows and every A element is a shared-memory broadcast to the warp.
// The tile height is fixed (64); the last tile is masked, so nb needs no
// divisor.  Accumulation is FP32 FFMA in order t.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;        // channels per block
constexpr int kGroups = 8;        // warps (row groups)
constexpr int kRowsPerThread = 8;
constexpr int kTile = kGroups * kRowsPerThread;   // 64 rows per tile
constexpr int kChunk = 64;        // tones staged per pass
constexpr int kPitch = kChunk + 1;

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kLanes * kGroups)
fold_kernel(const float2* __restrict__ P1, const float2* __restrict__ G2,
            const float2* __restrict__ crot, const float2* __restrict__ qrot,
            const float2* __restrict__ ramp1, float2* __restrict__ out,
            int nb, int Ct, int Cp) {
    __shared__ float2 as[kTile * kPitch];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kLanes + tx;
    const int b = blockIdx.x;
    const int c = blockIdx.y * kLanes + tx;
    const int cl = c < Cp ? c : Cp - 1;           // dead lanes load a live column
    const float2* cr = crot + (long long)b * Ct;
    float2 acc[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) acc[k] = make_float2(0.f, 0.f);

    for (int t0 = 0; t0 < Ct; t0 += kChunk) {
        const int tc = min(kChunk, Ct - t0);
        __syncthreads();
        for (int e = tid; e < kTile * tc; e += kLanes * kGroups) {
            const int r = e / tc;
            const int t = e - r * tc;
            as[r * kPitch + t] = cmul(P1[r * Ct + t0 + t], cr[t0 + t]);
        }
        __syncthreads();
        const float2* g = G2 + (long long)t0 * Cp + cl;
        const float2* a = as + ty * kPitch;
        for (int t = 0; t < tc; ++t) {
            const float2 gv = __ldg(g + (long long)t * Cp);
#pragma unroll
            for (int k = 0; k < kRowsPerThread; ++k)
                cmac(acc[k], a[k * kGroups * kPitch + t], gv);
        }
    }
    if (c >= Cp) return;
    const float2 q = qrot[(long long)b * Cp + c];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = ty + k * kGroups;
        const long long n = (long long)b * kTile + r;
        if (n < nb)
            out[n * Cp + c] = cmul(cmul(acc[k], ramp1[r * Cp + c]), q);
    }
}

}  // namespace

// Rows per tile: P1 and ramp1 have this many rows, crot/qrot one row per
// tile.
extern "C" int sdr_fold_tile() { return kTile; }

extern "C" int sdr_fold(const void* P1, const void* G2, const void* crot,
                        const void* qrot, const void* ramp1, void* out,
                        int nb, int Ct, int Cp, int n_tiles, void* stream) {
    if (nb <= 0 || Ct <= 0 || Cp <= 0 ||
        (long long)n_tiles * kTile < nb || (long long)(n_tiles - 1) * kTile >= nb)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)n_tiles, (unsigned)((Cp + kLanes - 1) / kLanes));
    fold_kernel<<<grid, dim3(kLanes, kGroups), 0, (cudaStream_t)stream>>>(
        (const float2*)P1, (const float2*)G2, (const float2*)crot,
        (const float2*)qrot, (const float2*)ramp1, (float2*)out, nb, Ct, Cp);
    return (int)cudaGetLastError();
}
