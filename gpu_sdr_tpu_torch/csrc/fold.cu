// Shift-fold TONES->DIRECT loopback on Hopper's tensor cores (sm_90a).
// One kernel template, four TPU kernels.
//
// Replaces the TPU kernels gpu_sdr_tpu/ops/pallas_chain.py:
//   TonesDirectFoldKernel.invoke_factored (_fold_kernel), the fused
//       loopback of an aperiodic comb into a DIRECT receiver (config 3):
//       sdr_fold;
//   TonesDirectFoldKernel.invoke (_fold_kernel, P and the ramp streamed),
//       its multi_step with time_shards > 1: sdr_fold_streamed;
//   TonesDirectFoldKernel.invoke_factored_rotg (_fold_rotg_kernel), its
//       multi_step with rotg: sdr_fold_rotg;
//   TonesDirectFoldT.invoke_t (_fold_t_kernel), the channel-major form:
//       sdr_fold_t.
// Synthesis, mix-down and FIR are contracted into one (Ct, Cp) constant
// G2 (ops/fold.py), so for K blocks of nb rows each
//
//   y[b*nb + n, c] = (sum_t P[n, t] * srot[b, t] * G2[t, c])
//                    * ramp[n, c] * drot[b, c]                (streamed)
//
// with P (nb, Ct) and ramp (nb, Cp) the full tables.  The comb's phase
// table factors by tile, P[i*R + r, t] = P1[r, t] * PB[i, t] and
// ramp[i*R + r] = ramp1[r] * RB[i], so for tile i of block b
//
//   y[b*nb + i*R + r, c] = (sum_t P1[r, t] * crot[b*nt + i, t] * G2[t, c])
//                          * ramp1[r, c] * qrot[b*nt + i, c]  (factored)
//
// with crot = srot * PB[i], qrot = drot * RB[i] built by the wrapper.
// The template's three choices: where A's rows come from (P1, or the
// block's rows of P: kStream), which operand carries the rotation (A, or
// G2 as P1 @ (diag(crot) G2): kRotG) and the store (row-major (K*nb, Cp),
// or channel-major (Cp, K*nb): kColMajor).  The stream's first-block
// startup correction stays outside (ops/fold.py).
//
// Bound: config 3 (Ct = Cp = 100, nb 40,000) is 3.25 GFLOP and 32 MB
// written per block (the streamed form also reads 64 MB of P and ramp).
// In FP32 FFMA the operations bind (0.049 ms at 67 TFLOP/s); on the
// tensor cores, three TF32 passes of it, 9.75 GFLOP at 495 TFLOP/s, take
// 0.020 ms, and the bytes (0.0099 ms; streamed 0.029) come near.
//
// Design: the product runs on mma.sync TF32 with a three-pass split
// (tc.cuh: the real embedding of the complex product, the split at
// fragment load).  What bounds the kernel is not the products but the
// latency of staging from L2, a thread's loads one after another (an
// earlier layout that staged A and G2 per tile: PERF.md), so nothing is
// staged per tile that does not change per tile.  A persistent grid of one block
// per SM walks the tiles of R = 64 rows; the block keeps G2 (config 3:
// 80 KB), P1 and ramp1 (or its transpose) in shared memory for its
// life, and holds two groups of 8 warps that take alternate tiles.  Per
// tile a group stages only its rotation row (crot, or the block's srot)
// and output rotation row, and the rotation is applied to A's FP32
// operand as its fragments load (kRotG: to G2's); #12 brings the tile's
// P rows by cp.async.  The mainloop runs 4 warps of 16 rows by 2 warps of
// up to 13 column fragments; the epilogue multiplies by the ramp and the
// output rotation in registers and stores each lane's four channels of
// a row, 32 bytes (channel-major: 8 rows of a channel, 64 bytes).  Where
// the constants do not fit 227 KB, the channels are cut into chunks of
// at most 104 (grid.y) and the tones into passes that stage their chunks
// of G2 and A, one group a block.
// The last tile is masked, so nb needs no divisor; K blocks per launch.
// The TPU kernels' bf16 hi/lo splits and Karatsuba planes, the self-ramp
// special case, the identity-matrix diagonal extraction, lane padding,
// 8-row rotation units and divisor-of-nb tile rules have no counterpart.

#include <cuda_runtime.h>

#include <algorithm>

#include "tc.cuh"

namespace {

using tc::cmul;
using tc::kNF;
using tc::kThreads;

constexpr int kTile = tc::kRows;  // rows per tile, ops/fold.py FOLD_TILE
constexpr int kGroupsMax = 2;     // groups of 8 warps a block

// the group's barrier: named barrier 1 + group over its 256 threads
__device__ __forceinline__ void group_sync(int grp) {
    asm volatile("bar.sync %0, %1;" :: "r"(grp + 1), "r"(kThreads));
}

// rows x KC complex from `src` (row pitch `ld` complex, tones from t0) into
// shared memory at pitch AS floats, by cp.async: zero past Ct and past
// `live` rows.  Warps over rows, lanes over tones.
__device__ __forceinline__ void stage_rows(float* dst, const float2* src,
                                           long long ld, int rows, int live,
                                           int t0, int Ct, const tc::Plan& pl,
                                           int tid, int nthr) {
    for (int r = tid >> 5; r < rows; r += nthr >> 5)
        for (int t = tid & 31; t < pl.KC; t += 32) {
            const bool ok = r < live && t0 + t < Ct;
            tc::cp_async8(dst + r * pl.AS + 2 * t,
                          ok ? src + r * ld + t0 + t : src, ok ? 8 : 0);
        }
}

// P (factored: P1 (R, Ct); kStream: the block's P (nb, Ct)), G2 (Ct, Cp),
// srot / drot: one row per tile (crot, qrot) or, kStream, per block;
// ramp: ramp1 (R, Cp), its transpose (Cp, R) when kColMajor, or kStream
// the block's ramp (nb, Cp); out (K*nb, Cp), or (Cp, ncols) kColMajor.
template <bool kStream, bool kRotG, bool kColMajor>
__global__ void __launch_bounds__(kGroupsMax * kThreads, 1)
fold_kernel(const float2* __restrict__ P, const float2* __restrict__ G2,
            const float2* __restrict__ srot, const float2* __restrict__ drot,
            const float2* __restrict__ ramp, float2* __restrict__ out,
            int nb, int nt, int tiles, int Ct, int Cp, long long ncols,
            tc::Plan pl) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int groups = blockDim.x / kThreads;
    const int grp = threadIdx.x / kThreads;
    const int tid = threadIdx.x - grp * kThreads;
    // one pass over the tones: G2 (and, factored, P1) stay for the
    // block's life; else every pass stages its chunks, one group a block
    const bool resident = pl.nk == 1;
    const bool shared_a = resident && !kStream;
    float* gs = smem;                                  // G2 (KC x CNs)
    float* as = gs + pl.bfl + (shared_a ? 0 : grp * pl.afl);   // A rows
    float* rs = gs + pl.bfl + (shared_a ? 1 : groups) * pl.afl;  // ramp1
    float2* rotv = reinterpret_cast<float2*>(rs + pl.rfl + grp * pl.vfl);
    float2* qv = rotv + pl.KC;                         // output rotation
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp & 3, wn = warp >> 2;
    // the chunk's column fragments split evenly over the two warps
    const int nfh = (pl.CN / 4 + 1) / 2;               // at most kNF
    const int jn0 = wn * nfh;                          // first fragment
    const int nfw = min(nfh, pl.CN / 4 - jn0);
    const int c0 = blockIdx.y * pl.CN;
    const int cn = min(pl.CN, Cp - c0);                // live channels
    if (resident) {
        for (int t = threadIdx.x >> 5; t < pl.KC; t += blockDim.x >> 5)
            for (int c = lane; c < pl.CN; c += 32) {
                const bool ok = t < Ct && c0 + c < Cp;
                tc::cp_async8(gs + 2 * (t * pl.CNs + c),
                              ok ? G2 + (long long)t * Cp + c0 + c : G2,
                              ok ? 8 : 0);
            }
        if (shared_a)
            stage_rows(as, P, Ct, kTile, kTile, 0, Ct, pl, threadIdx.x,
                       blockDim.x);
    }
    if (!kStream) {                 // ramp1 (or its transpose) stays too
        float2* r2 = reinterpret_cast<float2*>(rs);
        for (int i = threadIdx.x >> 5; i < (kColMajor ? pl.CN : kTile);
             i += blockDim.x >> 5)
            for (int k = lane; k < (kColMajor ? kTile : pl.CN); k += 32) {
                const int r = kColMajor ? k : i, c = kColMajor ? i : k;
                const bool ok = c0 + c < Cp;
                tc::cp_async8(
                    r2 + (kColMajor ? c * tc::kTPitch + r : r * pl.CNs + c),
                    ok ? ramp + (kColMajor ? (c0 + c) * kTile + r
                                           : r * Cp + c0 + c)
                       : ramp,
                    ok ? 8 : 0);
            }
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    for (int tile = grp * gridDim.x + blockIdx.x; tile < tiles;
         tile += groups * gridDim.x) {
        const int blk = tile / nt;
        const int n0 = (tile - blk * nt) * kTile;
        const int rot = kStream ? blk : tile;
        const float2* sr = srot + (long long)rot * Ct;
        float acc[kNF][4];
#pragma unroll
        for (int j = 0; j < kNF; ++j)
            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        for (int kc = 0; kc < pl.nk; ++kc) {
            const int t0 = kc * pl.KC;
            group_sync(grp);        // the last readers of this group's
                                    // rows, rotations and G chunk are done
            if (!resident) {
                for (int t = warp; t < pl.KC; t += kThreads / 32)
                    for (int c = lane; c < pl.CN; c += 32) {
                        const bool ok = t0 + t < Ct && c0 + c < Cp;
                        tc::cp_async8(
                            gs + 2 * (t * pl.CNs + c),
                            ok ? G2 + (long long)(t0 + t) * Cp + c0 + c : G2,
                            ok ? 8 : 0);
                    }
            }
            if (kStream)
                stage_rows(as, P + (long long)n0 * Ct, Ct, kTile, nb - n0,
                           t0, Ct, pl, tid, kThreads);
            else if (!resident)
                stage_rows(as, P, Ct, kTile, kTile, t0, Ct, pl, tid,
                           kThreads);
            tc::cp_async_commit();
            for (int t = tid; t < pl.KC; t += kThreads)
                rotv[t] = t0 + t < Ct ? sr[t0 + t] : make_float2(0.f, 0.f);
            if (kc == 0)
                for (int c = tid; c < pl.CN; c += kThreads)
                    qv[c] = c < cn ? drot[(long long)rot * Cp + c0 + c]
                                   : make_float2(0.f, 0.f);
            tc::cp_async_wait<0>();
            group_sync(grp);
            if (nfw > 0)
                tc::mainloop<!kRotG, kRotG>(acc, as + wm * 16 * pl.AS, pl.AS,
                                            gs + 8 * jn0, pl.CNs, rotv,
                                            pl.KC, nfw);
        }
        // the epilogue from the registers: ramp and output rotation, then
        // each lane's four channels of a row (32 bytes), or 8 rows of a
        // channel (channel-major)
        const int g = lane >> 2, q = lane & 3;
        const float2* r2 = reinterpret_cast<const float2*>(rs);
#pragma unroll
        for (int j = 0; j < kNF; ++j) {
            const int ch = (jn0 + j) * 4 + q;
            if (j >= nfw || ch >= cn) continue;
            const float2 d = qv[ch];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = wm * 16 + g + 8 * h;
                const int n = n0 + r;
                if (n >= nb) continue;
                const float2 rp =
                    kStream ? ramp[(long long)n * Cp + c0 + ch]
                            : r2[kColMajor ? ch * tc::kTPitch + r
                                           : r * pl.CNs + ch];
                const float2 y = cmul(cmul(make_float2(acc[j][2 * h],
                                                       acc[j][2 * h + 1]),
                                           rp), d);
                if (kColMajor)
                    out[(long long)(c0 + ch) * ncols + (long long)blk * nb + n] = y;
                else
                    out[((long long)blk * nb + n) * Cp + c0 + ch] = y;
            }
        }
    }
}

// The block's plan: channel chunks, then the fewest passes over the
// tones whose G2 chunk, A rows, ramp table and rotation vectors fit;
// two groups where G2 stays.
tc::Plan plan(int Ct, int Cp, bool stream, bool col_major) {
    tc::Plan p{};
    tc::channel_plan(Cp, (Cp + tc::kChanMax - 1) / tc::kChanMax, p);
    p.rfl = stream ? 0 : col_major ? p.CN * tc::kTPitch * 2 : kTile * p.CNs * 2;
    for (int nk = 1;; ++nk) {
        tc::tone_plan(Ct, nk, p);
        p.afl = kTile * p.AS;
        p.vfl = 2 * (p.KC + p.CNs);
        for (int groups = nk == 1 ? kGroupsMax : 1; groups >= 1; --groups) {
            const int a = nk == 1 && !stream ? 1 : groups;
            p.groups = groups;
            p.smem = (p.bfl + a * p.afl + p.rfl + groups * p.vfl) *
                     (int)sizeof(float);
            if (p.smem <= tc::kSmemMax) return p;
        }
    }
}

// K blocks of nb rows: nt = ceil(nb / kTile) tiles each.  Non-zero for
// a geometry the kernels refuse.
int tiles(int nb, int K, int Ct, int Cp, int* nt) {
    if (nb <= 0 || K <= 0 || Ct <= 0 || Cp <= 0) return 1;
    *nt = (nb + kTile - 1) / kTile;
    return (long long)*nt * K >= (1LL << 31) ? 1 : 0;
}

template <bool kStream, bool kRotG, bool kColMajor>
int launch(const void* P, const void* G2, const void* srot, const void* drot,
           const void* ramp, void* out, int nb, int K, int Ct, int Cp,
           void* stream) {
    int nt = 0;
    if (tiles(nb, K, Ct, Cp, &nt)) return (int)cudaErrorInvalidValue;
    const tc::Plan pl = plan(Ct, Cp, kStream, kColMajor);
    const auto kernel = fold_kernel<kStream, kRotG, kColMajor>;
    static tc::LaunchCache cache;
    const int threads = pl.groups * kThreads;
    int slots = 0;
    const cudaError_t err =
        tc::resident_blocks(kernel, cache, threads, pl.smem, &slots);
    if (err != cudaSuccess) return (int)err;
    const int all = nt * K;
    const dim3 grid((unsigned)std::min(std::max(1, slots / pl.nc),
                                       (all + pl.groups - 1) / pl.groups),
                    (unsigned)pl.nc);
    kernel<<<grid, threads, pl.smem, (cudaStream_t)stream>>>(
        (const float2*)P, (const float2*)G2, (const float2*)srot,
        (const float2*)drot, (const float2*)ramp, (float2*)out, nb, nt, all,
        Ct, Cp, (long long)K * nb, pl);
    return (int)cudaGetLastError();
}

}  // namespace

// Rows per tile: P1 and ramp1 have this many rows, crot/qrot one row per
// tile.
extern "C" int sdr_fold_tile() { return kTile; }

// #11: K blocks, P1 (R, Ct), crot (K*nt, Ct), qrot (K*nt, Cp), ramp1
// (R, Cp) -> out (K*nb, Cp).
extern "C" int sdr_fold(const void* P1, const void* G2, const void* crot,
                        const void* qrot, const void* ramp1, void* out,
                        int nb, int K, int Ct, int Cp, void* stream) {
    return launch<false, false, false>(P1, G2, crot, qrot, ramp1, out, nb, K,
                                       Ct, Cp, stream);
}

// #12: K blocks, P (nb, Ct), srot (K, Ct), drot (K, Cp), ramp (nb, Cp)
// -> out (K*nb, Cp).
extern "C" int sdr_fold_streamed(const void* P, const void* G2,
                                 const void* srot, const void* drot,
                                 const void* ramp, void* out, int nb, int K,
                                 int Ct, int Cp, void* stream) {
    return launch<true, false, false>(P, G2, srot, drot, ramp, out, nb, K,
                                      Ct, Cp, stream);
}

// #13: as sdr_fold, the rotation applied to G2.
extern "C" int sdr_fold_rotg(const void* P1, const void* G2, const void* crot,
                             const void* qrot, const void* ramp1, void* out,
                             int nb, int K, int Ct, int Cp, void* stream) {
    return launch<false, true, false>(P1, G2, crot, qrot, ramp1, out, nb, K,
                                      Ct, Cp, stream);
}

// #14: as sdr_fold, ramp1T (Cp, R) -> out (Cp, K*nb).
extern "C" int sdr_fold_t(const void* P1, const void* G2, const void* crot,
                          const void* qrot, const void* ramp1T, void* out,
                          int nb, int K, int Ct, int Cp, void* stream) {
    return launch<false, false, true>(P1, G2, crot, qrot, ramp1T, out, nb, K,
                                      Ct, Cp, stream);
}
