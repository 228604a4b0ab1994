// Shift-fold TONES->DIRECT loopback, one output tile per block, for
// Hopper (sm_90a).  One file, four TPU kernels.
//
// Replaces the TPU kernels gpu_sdr_tpu/ops/pallas_chain.py:
//   TonesDirectFoldKernel.invoke_factored (_fold_kernel), the fused
//       loopback of an aperiodic comb into a DIRECT receiver (config 3):
//       sdr_fold, mode kFactored;
//   TonesDirectFoldKernel.invoke (_fold_kernel, P and the ramp streamed),
//       its multi_step with time_shards > 1: sdr_fold_streamed, mode
//       kStreamed;
//   TonesDirectFoldKernel.invoke_factored_rotg (_fold_rotg_kernel), its
//       multi_step with rotg: sdr_fold_rotg, mode kRotG;
//   TonesDirectFoldT.invoke_t (_fold_t_kernel), the channel-major form:
//       sdr_fold_t, fold_t_kernel.
// Synthesis, mix-down and FIR are contracted into one (Ct, Cp) constant
// G2 (ops/fold.py), so for K blocks of nb rows each
//
//   y[b*nb + n, c] = (sum_t P[n, t] * srot[b, t] * G2[t, c])
//                    * ramp[n, c] * drot[b, c]                (kStreamed)
//
// with P (nb, Ct) and ramp (nb, Cp) the full tables, read per tile.  The
// comb's phase table factors by tile, P[i*R + r, t] = P1[r, t] * PB[i, t]
// and ramp[i*R + r] = ramp1[r] * RB[i], so for tile i of block b
//
//   y[b*nb + i*R + r, c] = (sum_t P1[r, t] * crot[b*nt + i, t] * G2[t, c])
//                          * ramp1[r, c] * qrot[b*nt + i, c]  (kFactored)
//
// with crot = srot * PB[i], qrot = drot * RB[i] built by the wrapper;
// kRotG moves the rotation onto the constant, P1 @ (diag(crot) G2), and
// fold_t_kernel writes the kFactored result channel-major, (Cp, K*nb).
// Nothing is read from device memory per row but the output (and, in
// kStreamed, P and the ramp): P1, G2 and ramp1 are small constants
// (config 3: 50 KB, 80 KB, 50 KB) served by L2.  The stream's first-
// block startup correction stays outside (ops/fold.py).
//
// Bound: FP32 arithmetic.  Each output costs 4*Ct FFMA against 8 bytes
// written: config 3 (Ct = Cp = 100, nb 40,000) is 3.2 GFLOP and 32 MB per
// 4,000,000-sample block (kStreamed also reads 64 MB of P and ramp).  The
// TPU kernels' bf16 hi/lo splits (of P1 host-side too), the self-ramp
// special case (there to save an HBM stream of the ramp; here ramp1 is an
// L2-resident table), the identity-matrix diagonal extraction, lane
// padding, 8-row rotation units and the divisor-of-nb tile rules have no
// counterpart.
//
// Design: grid (tile, 32-channel chunk), tiles of R = 64 rows, nt tiles
// per block, the last one masked, so nb needs no divisor.  Row-major
// modes: lanes run over channels with 8 rows each in registers and every
// A element is a shared-memory broadcast to the warp.  kFactored and
// kStreamed stage A = P * rotation (64 rows x a chunk of Ct) and read
// G2[t, c] coalesced once per 8 rows; kRotG stages P1 unrotated and the
// chunk's crot[t] * G2[t, c] (tc x 32), formed once per block, so the
// rotation costs tc * 32 and not 64 * tc complex products.  Channel-major
// (fold_t_kernel): lanes run over rows (two rows, 32 apart, each) and the
// eight warps over four channels each, so the 32 lanes of a warp write
// 32 consecutive samples of one channel; P1 rows come from shared memory
// (odd pitch, conflict-free), crot * G2 as in kRotG (warp broadcasts),
// and the ramp from its transpose (Cp, R).  Accumulation is FP32 FFMA in
// order t.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;        // channels per block
constexpr int kGroups = 8;        // warps (row groups)
constexpr int kRowsPerThread = 8;
constexpr int kTile = kGroups * kRowsPerThread;   // 64 rows per tile
constexpr int kChunk = 64;        // tones staged per pass (A only)
constexpr int kChunkG = 32;       // tones staged per pass (A and rotated G2)
constexpr int kChanPerWarp = kLanes / kGroups;    // channel-major: 4

enum Mode { kFactored, kStreamed, kRotG };

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Stage the chunk's crot[t] * G2[t, c] for the block's 32 channels:
// gs[t][lane], dead channels a live column.
__device__ __forceinline__ void stage_rotated_g2(
        float2* gs, const float2* __restrict__ G2, const float2* rot, int t0,
        int tc, int c0, int Cp, int tid) {
    for (int e = tid; e < tc * kLanes; e += kLanes * kGroups) {
        const int t = e / kLanes;
        const int l = e - t * kLanes;
        const int c = c0 + l < Cp ? c0 + l : Cp - 1;
        gs[e] = cmul(rot[t0 + t], G2[(long long)(t0 + t) * Cp + c]);
    }
}

// Row-major modes.  P: P1 (R, Ct) or, in kStreamed, the block's P (nb,
// Ct); ramp likewise; srot / drot: one row per tile (crot, qrot) or, in
// kStreamed, per block; out (K*nb, Cp).
template <Mode kMode>
__global__ void __launch_bounds__(kLanes * kGroups)
fold_kernel(const float2* __restrict__ P, const float2* __restrict__ G2,
            const float2* __restrict__ srot, const float2* __restrict__ drot,
            const float2* __restrict__ ramp, float2* __restrict__ out,
            int nb, int nt, int Ct, int Cp) {
    constexpr int kC = kMode == kRotG ? kChunkG : kChunk;
    constexpr int kPitch = kC + 1;
    __shared__ float2 as[kTile * kPitch];
    __shared__ float2 gs[kMode == kRotG ? kChunkG * kLanes : 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kLanes + tx;
    const int tile = blockIdx.x;                   // of the K blocks' tiles
    const int blk = tile / nt;
    const int n0 = (tile - blk * nt) * kTile;      // first row in its block
    const int c = blockIdx.y * kLanes + tx;
    const int cl = c < Cp ? c : Cp - 1;            // dead lanes load a live column
    // kStreamed reads the tables' rows of the tile and rotates per block;
    // the factored modes read the tile-invariant tables and rotate per tile
    const int row0 = kMode == kStreamed ? n0 : 0;
    const int rot = kMode == kStreamed ? blk : tile;
    const float2* sr = srot + (long long)rot * Ct;
    float2 acc[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) acc[k] = make_float2(0.f, 0.f);

    for (int t0 = 0; t0 < Ct; t0 += kC) {
        const int tc = min(kC, Ct - t0);
        __syncthreads();
        for (int e = tid; e < kTile * tc; e += kLanes * kGroups) {
            const int r = e / tc;
            const int t = e - r * tc;
            const int n = row0 + r;
            float2 v = make_float2(0.f, 0.f);
            if (kMode != kStreamed)
                v = P[r * Ct + t0 + t];
            else if (n < nb)
                v = P[(long long)n * Ct + t0 + t];
            as[r * kPitch + t] = kMode == kRotG ? v : cmul(v, sr[t0 + t]);
        }
        if constexpr (kMode == kRotG)
            stage_rotated_g2(gs, G2, sr, t0, tc, blockIdx.y * kLanes, Cp, tid);
        __syncthreads();
        const float2* g = G2 + (long long)t0 * Cp + cl;
        const float2* a = as + ty * kPitch;
        for (int t = 0; t < tc; ++t) {
            const float2 gv = kMode == kRotG ? gs[t * kLanes + tx]
                                             : __ldg(g + (long long)t * Cp);
#pragma unroll
            for (int k = 0; k < kRowsPerThread; ++k)
                cmac(acc[k], a[k * kGroups * kPitch + t], gv);
        }
    }
    if (c >= Cp) return;
    const float2 q = drot[(long long)rot * Cp + c];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = ty + k * kGroups;
        const int n = n0 + r;
        if (n < nb)
            out[((long long)blk * nb + n) * Cp + c] =
                cmul(cmul(acc[k], kMode == kStreamed
                                      ? ramp[(long long)n * Cp + c]
                                      : ramp[r * Cp + c]), q);
    }
}

// Channel-major factored fold: out (Cp, ncols), column b*nb + n.  P1 (R,
// Ct), G2 (Ct, Cp), crot (tiles, Ct), qrot (tiles, Cp), ramp1T (Cp, R).
__global__ void __launch_bounds__(kLanes * kGroups)
fold_t_kernel(const float2* __restrict__ P1, const float2* __restrict__ G2,
              const float2* __restrict__ crot, const float2* __restrict__ qrot,
              const float2* __restrict__ ramp1T, float2* __restrict__ out,
              int nb, int nt, int Ct, int Cp, long long ncols) {
    constexpr int kPitch = kChunkG + 1;
    __shared__ float2 ps[kTile * kPitch];
    __shared__ float2 gs[kChunkG * kLanes];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kLanes + tx;
    const int tile = blockIdx.x;
    const int blk = tile / nt;
    const int n0 = (tile - blk * nt) * kTile;
    const int c0 = blockIdx.y * kLanes;
    const int cw = ty * kChanPerWarp;              // the warp's channels
    const float2* cr = crot + (long long)tile * Ct;
    float2 acc[2][kChanPerWarp];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kChanPerWarp; ++j) acc[h][j] = make_float2(0.f, 0.f);

    for (int t0 = 0; t0 < Ct; t0 += kChunkG) {
        const int tc = min(kChunkG, Ct - t0);
        __syncthreads();
        for (int e = tid; e < kTile * tc; e += kLanes * kGroups) {
            const int r = e / tc;
            const int t = e - r * tc;
            ps[r * kPitch + t] = P1[r * Ct + t0 + t];
        }
        stage_rotated_g2(gs, G2, cr, t0, tc, c0, Cp, tid);
        __syncthreads();
        for (int t = 0; t < tc; ++t) {
            const float2 a0 = ps[tx * kPitch + t];
            const float2 a1 = ps[(tx + kLanes) * kPitch + t];
#pragma unroll
            for (int j = 0; j < kChanPerWarp; ++j) {
                const float2 gv = gs[t * kLanes + cw + j];
                cmac(acc[0][j], a0, gv);
                cmac(acc[1][j], a1, gv);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < kChanPerWarp; ++j) {
        const int c = c0 + cw + j;
        if (c >= Cp) continue;
        const float2 q = qrot[(long long)tile * Cp + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = tx + h * kLanes;
            const int n = n0 + r;
            if (n < nb)
                out[(long long)c * ncols + (long long)blk * nb + n] =
                    cmul(cmul(acc[h][j], ramp1T[c * kTile + r]), q);
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

template <Mode kMode>
int launch(const void* P, const void* G2, const void* srot, const void* drot,
           const void* ramp, void* out, int nb, int K, int Ct, int Cp,
           void* stream) {
    int nt = 0;
    if (tiles(nb, K, Ct, Cp, &nt)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(nt * K), (unsigned)((Cp + kLanes - 1) / kLanes));
    fold_kernel<kMode><<<grid, dim3(kLanes, kGroups), 0,
                         (cudaStream_t)stream>>>(
        (const float2*)P, (const float2*)G2, (const float2*)srot,
        (const float2*)drot, (const float2*)ramp, (float2*)out, nb, nt, Ct,
        Cp);
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
    return launch<kFactored>(P1, G2, crot, qrot, ramp1, out, nb, K, Ct, Cp,
                             stream);
}

// #12: K blocks, P (nb, Ct), srot (K, Ct), drot (K, Cp), ramp (nb, Cp)
// -> out (K*nb, Cp).
extern "C" int sdr_fold_streamed(const void* P, const void* G2,
                                 const void* srot, const void* drot,
                                 const void* ramp, void* out, int nb, int K,
                                 int Ct, int Cp, void* stream) {
    return launch<kStreamed>(P, G2, srot, drot, ramp, out, nb, K, Ct, Cp,
                             stream);
}

// #13: as sdr_fold, the rotation applied to G2.
extern "C" int sdr_fold_rotg(const void* P1, const void* G2, const void* crot,
                             const void* qrot, const void* ramp1, void* out,
                             int nb, int K, int Ct, int Cp, void* stream) {
    return launch<kRotG>(P1, G2, crot, qrot, ramp1, out, nb, K, Ct, Cp,
                         stream);
}

// #14: as sdr_fold, ramp1T (Cp, R) -> out (Cp, K*nb).
extern "C" int sdr_fold_t(const void* P1, const void* G2, const void* crot,
                          const void* qrot, const void* ramp1T, void* out,
                          int nb, int K, int Ct, int Cp, void* stream) {
    int nt = 0;
    if (tiles(nb, K, Ct, Cp, &nt)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(nt * K), (unsigned)((Cp + kLanes - 1) / kLanes));
    fold_t_kernel<<<grid, dim3(kLanes, kGroups), 0, (cudaStream_t)stream>>>(
        (const float2*)P1, (const float2*)G2, (const float2*)crot,
        (const float2*)qrot, (const float2*)ramp1T, (float2*)out, nb, nt, Ct,
        Cp, (long long)K * nb);
    return (int)cudaGetLastError();
}
