// G-fused TONES->DIRECT loopback chain, one time shard's rows of one
// block, for Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_sdr_tpu/ops/pallas_chain.py:
// TonesDirectChain.invoke (_kernel), the sharded fused DIRECT chain's
// g_chain sub-path (gpu_sdr_tpu/parallel/fused_sharded.py:774-811).  A
// comb x[n*M + m] = sum_t srot_t * P[n, t] * Q[t, m] looped into the
// DDC+FIR contracts through x: with G[j, t, c] = sum_m Q[t, m] *
// Hmod[j*M + m, c] (built host-side in float64, ops/chain.py),
//
//   y[r, c] = ramp[r, c] * drot_c * sum_{j<f} sum_t E[r + j, t] * G[j, t, c]
//
// over the shard's extended rows E (nbt + f - 1, Ct): its f - 1 halo rows
// hP (the P rows before the shard's span, wrapped mod nb) rotated by
// hrot, then its nbt rows of P rotated by srot.  The halo rows carry no
// state: they are re-synthesised from P under the rotation of the block
// they belong to, which is the rule at the seams
// (pallas_chain.py:80-90, fused_sharded.py:782-790):
//   shard 0: its halo is the previous block's tail, hrot = the previous
//            block's rotation, zero ahead of the stream's first block;
//   shard t > 0: its halo is shard t-1's rows of the same block, hrot =
//            srot.
// The wrapper passes hrot; the kernel does not know which shard it runs.
//
// Bound: FP32 arithmetic.  Each output costs 4*f*Ct FFMA against 8 bytes
// written and 16 bytes of P and ramp read: config 3 through
// use_fold=False (Ct = Cp = 100, f 4, 20,000 rows per shard) is 6.4 GFLOP
// against 48 MB.  The TPU kernel's bf16 hi/lo split of G, its lP halo
// units padded to 8 rows, the rep8 rotation rows, the divisor-of-nb tile
// rule and the K blocks per launch have no counterpart.
//
// Design: as the DDC kernel's channel mode (ddc.cu).  Grid (tile of 64
// rows, 32-channel chunk).  A block stages the tile's extended rows,
// rotated, in shared memory with an odd pitch, a chunk of taps and a
// chunk of 32 tones at a time: for taps [j0, j0 + J) the rows from
// j0 on, 64 + J - 1 of them, J the most that keep a block within the
// default 48 KB (123), so any f runs.  Lanes run over channels with 8
// rows each in registers; G[j, t, c] is read coalesced once per 8 rows,
// every staged value is a shared-memory broadcast to the warp.  The last
// tile is masked.  Accumulation is FP32 FFMA in order: chunks of J taps,
// then chunks of tones, then j, then t.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;        // channels per block
constexpr int kGroups = 8;        // warps (row groups)
constexpr int kRowsPerThread = 8;
constexpr int kTile = kGroups * kRowsPerThread;   // 64 rows per tile
constexpr int kChunk = 32;        // tones staged per pass
constexpr int kPitch = kChunk + 1;
constexpr int kSmemDefault = 48 * 1024;   // a block's shared memory, no opt-in
// taps staged per pass: the most whose kTile + taps - 1 rows fit (123)
constexpr int kTaps = kSmemDefault / (kPitch * (int)sizeof(float2)) - kTile + 1;
static_assert((kTile + kTaps - 1) * kPitch * sizeof(float2) <= kSmemDefault,
              "chain block over 48 KB");

// A block's dynamic shared memory for f taps (ops/chain.py smem_bytes
// mirrors it), at most kSmemDefault for any f.
int smem_bytes(int f) {
    return (kTile + (f < kTaps ? f : kTaps) - 1) * kPitch * (int)sizeof(float2);
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

// kDeep: f > kTaps, passes of kTaps taps; else one pass of all f taps,
// the j0 loop gone at compile time (the main path's f 4).
template <bool kDeep>
__global__ void __launch_bounds__(kLanes * kGroups)
chain_kernel(const float2* __restrict__ P, const float2* __restrict__ hP,
             const float2* __restrict__ G, const float2* __restrict__ ramp,
             const float2* __restrict__ srot, const float2* __restrict__ hrot,
             const float2* __restrict__ drot, float2* __restrict__ out,
             int nbt, int Ct, int Cp, int f) {
    extern __shared__ float2 as[];
    const int lead = f - 1;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kLanes + tx;
    const int n0 = blockIdx.x * kTile;
    const int c = blockIdx.y * kLanes + tx;
    const int cl = c < Cp ? c : Cp - 1;           // dead lanes load a live column
    float2 acc[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) acc[k] = make_float2(0.f, 0.f);

    for (int j0 = 0; j0 < (kDeep ? f : 1); j0 += kTaps) {
        const int jc = kDeep ? min(kTaps, f - j0) : f;
        const int ext = kTile + jc - 1;
        for (int t0 = 0; t0 < Ct; t0 += kChunk) {
            const int tc = min(kChunk, Ct - t0);
            __syncthreads();
            // staged row q of this pass is shard row n0 - lead + j0 + q: a
            // halo row below 0, a P row up to nbt, zero past the end
            for (int e = tid; e < ext * tc; e += kLanes * kGroups) {
                const int q = e / tc;
                const int t = e - q * tc;
                const int r = n0 - lead + j0 + q;
                float2 v = make_float2(0.f, 0.f);
                if (r < 0)
                    v = cmul(hP[(r + lead) * Ct + t0 + t], hrot[t0 + t]);
                else if (r < nbt)
                    v = cmul(P[(long long)r * Ct + t0 + t], srot[t0 + t]);
                as[q * kPitch + t] = v;
            }
            __syncthreads();
            for (int j = 0; j < jc; ++j) {
                const float2* g = G + ((long long)(j0 + j) * Ct + t0) * Cp + cl;
                const float2* a = as + (ty + j) * kPitch;
                for (int t = 0; t < tc; ++t) {
                    const float2 gv = __ldg(g + (long long)t * Cp);
#pragma unroll
                    for (int k = 0; k < kRowsPerThread; ++k)
                        cmac(acc[k], a[k * kGroups * kPitch + t], gv);
                }
            }
        }
    }
    if (c >= Cp) return;
    const float2 d = drot[c];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = n0 + ty + k * kGroups;
        if (r < nbt) {
            const long long o = (long long)r * Cp + c;
            out[o] = cmul(cmul(acc[k], ramp[o]), d);
        }
    }
}

}  // namespace

// The launch's shared memory for f taps, the plan ops/chain.py
// smem_bytes mirrors; -1 for f < 1.
extern "C" int sdr_chain_smem_bytes(int f) {
    return f < 1 ? -1 : smem_bytes(f);
}

// P (nbt, Ct), hP (f-1, Ct), G (f, Ct, Cp), ramp (nbt, Cp), srot and
// hrot (Ct,), drot (Cp,) -> out (nbt, Cp).
extern "C" int sdr_chain(const void* P, const void* hP, const void* G,
                         const void* ramp, const void* srot, const void* hrot,
                         const void* drot, void* out, int nbt, int Ct,
                         int Cp, int f, void* stream) {
    if (nbt <= 0 || Ct <= 0 || Cp <= 0 || f < 2 || f - 1 > nbt)
        return (int)cudaErrorInvalidValue;
    const int smem = smem_bytes(f);
    const dim3 grid((unsigned)((nbt + kTile - 1) / kTile),
                    (unsigned)((Cp + kLanes - 1) / kLanes));
    const auto kernel = f > kTaps ? chain_kernel<true> : chain_kernel<false>;
    kernel<<<grid, dim3(kLanes, kGroups), smem, (cudaStream_t)stream>>>(
        (const float2*)P, (const float2*)hP, (const float2*)G,
        (const float2*)ramp, (const float2*)srot, (const float2*)hrot,
        (const float2*)drot, (float2*)out, nbt, Ct, Cp, f);
    return (int)cudaGetLastError();
}
