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
//   y[n, c] = rot_c * ramp[n, c] * sum_{k < f*M} ext[n*M + k] * hmod[k, c]
//
// ext is the block's extended samples, the (nb + f - 1, M) row view E
// read flat: (f - 1)*M history samples, then the block's nb*M, from a
// streamed block (a), read in place from a resident recording (b), or
// from one time shard's span of it after a staged history (c)
// (rows.cuh).  Window row n is E[n .. n + f - 1] flattened, so row n at
// column k is ext[n*M + k], and the sum is a complex product of the
// (nb, f*M) window rows by hmod (f*M, C).
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
// bar rules out a single TF32 pass, and the three-pass tensor-core
// product runs no faster here, csrc/tc.cuh) and the halo is read where
// it lies.
//
// Channel mode (more than 8 channels, config 3): a register-tiled FP32
// complex GEMM.  A block owns BM = 8 * RG output rows and a tile of up
// to 128 channels (grid.y over the tiles beyond that), its threads CG =
// tile / 4 channel groups by RG row groups (chan_plan; at C = 100: 25 by
// 10, 80 rows, no idle group), so each window sample is staged once per
// row tile.  A thread holds 8 rows by 4 channels of complex FP32
// accumulators: rows rg + i*RG, and channel pairs cg and cg + CG, so
// that a warp's tap loads are consecutive 16-byte vectors.  The k axis
// runs in chunks of kKC columns; each chunk's window and its hmod rows
// for the block's channels are staged in shared memory by cp.async,
// double-buffered: the next chunk's copies are in flight while the
// current chunk's FFMA run.  A row tile's window is a span of ext: where
// M <= kKC the span itself is staged and the rows overlap in it (span
// mode), else each row's kKC samples at pitch kKP (piece mode).  A copy
// takes 16 bytes where a pair of samples lies contiguous and 16-byte
// aligned in one source, else 8 bytes a sample; a sample that stands for
// zero (history at the stream's start, past the block) is zero-filled
// from a valid address.  Shared memory (at most 102,400 bytes for any
// C, whatever f and M: chan_plan) is taken by the opt-in.  Per column a thread loads 8
// window samples and two 16-byte tap vectors for 128 FFMA.  No tensor
// cores: FP32 FFMA, taps summed in FP32, keeps the 90 dB bar.  The
// epilogue applies ramp and rot_c and writes (nb, C) in natural order;
// the tail tile's dead rows and dead channels write nothing.
//
// Row mode (at most 8 channels; config 1 has 1): a block owns a tile of
// R output rows and every channel, in 8 warps of RR rows (RR 8 at up to
// 2 channels, 16 / CP beyond, CP the channels rounded up to a power of
// 2, the accumulators' width; row_plan).  Row n's window is ext[n*M,
// n*M + f*M), so a tile's windows overlap in one span of ext: the taps
// run in passes of J tap rows (a multiple of kArmR), and each pass's
// span, rows n0 + j0 .. n0 + j0 + R + J - 2 of the (nb + f - 1, M) row
// view, is staged once by cp.async with the pass's taps; with more
// than one chunk, double-buffered: the next chunk's copies are in
// flight while this one is summed.  Where M is wider than a stage takes
// (row_plan's nmc > 1) the columns run in chunks too, each row's piece
// at pitch P.  A lane's
// task is one arm m (a column of the row view) and kArmR consecutive
// tap rows: it holds its RR rows' kArmR + RR - 1 window samples in
// registers and slides the taps over them, so one shared-memory load
// feeds RR (a tap) or up to kArmR (a sample) complex MACs per channel;
// a warp's lanes take consecutive arms, so their loads are consecutive
// words.  The lanes' partial sums are reduced by a halving shuffle tree
// (each level sends half the values still held), the epilogue applies
// ramp and rot_c, and each output is written once.  Accumulation is
// FP32 FFMA: passes, then column chunks, then a lane's tasks, then the
// tap rows of a task; then the tree.  Bound: device memory at config 1
// (M 100, f 4, C 1: 32 MB read, 0.13 GFLOP), FP32 operations at a deep
// FIR (f 800 at M 10: 2.6 GFLOP).

#include <cuda_runtime.h>

#include <cstdint>

#include "rows.cuh"

namespace {

constexpr int kTM = 8;            // channel mode: rows a thread
constexpr int kTN = 4;            // channel mode: channels a thread (two pairs)
constexpr int kKC = 32;           // channel mode: window columns a chunk
constexpr int kKP = 34;           // channel mode: a staged row's pitch
constexpr int kStages = 2;        // channel mode: chunks staged at once
constexpr int kChanTile = 128;    // channel mode: channels a block at most
constexpr int kThreadsC = 256;    // channel mode: threads a block at most
constexpr int kRowGroupsMax = 16; // channel mode: row groups a block at most
constexpr int kMaxRowChannels = 8;   // row mode: channels at most
constexpr int kWarpsR = 8;        // row mode: warps a block
constexpr int kThreadsR = kWarpsR * 32;
constexpr int kRowsWarp = 8;      // row mode: rows a warp at up to 2 channels
constexpr int kAccR = 16;         // row mode: a lane's sums at 2+ channels
constexpr int kArmR = 4;          // row mode: tap rows a lane's task slides
constexpr int kStageR = 7104;     // row mode: samples a stage, window + taps
constexpr int kStagesR = 2;       // row mode: stages at most
constexpr int kSmemMax = 232448;  // a block's shared memory with the opt-in
// kKP = kKC + 2: room for a row's odd first sample and the pair it ends in
static_assert(kKP == kKC + 2 && kKC % 8 == 0 && kTM % 2 == 0,
              "channel-mode chunk");
// two row-mode blocks an SM (an SM's 233,472 bytes, 1 KB a block kept)
static_assert(2 * (kStagesR * kStageR * (int)sizeof(float2) + 1024) <=
              233472, "row mode over two blocks an SM");

// The channel mode's launch for C channels (ops/ddc.py channel_plan
// mirrors it).
struct ChanPlan {
    int ntile;    // channel tiles (grid.y)
    int Ct;       // channels a tile
    int CG;       // channel groups, ceil(Ct / kTN)
    int RG;       // row groups
    int BM;       // rows a block, kTM * RG
    int threads;  // CG * RG
    int smem;     // bytes: kStages x (BM x kKP window + kKC x 4 CG taps)
};

ChanPlan chan_plan(int C) {
    ChanPlan p;
    p.ntile = (C + kChanTile - 1) / kChanTile;
    p.Ct = (C + p.ntile - 1) / p.ntile;
    p.CG = (p.Ct + kTN - 1) / kTN;
    p.RG = kThreadsC / p.CG < kRowGroupsMax ? kThreadsC / p.CG
                                            : kRowGroupsMax;
    p.BM = kTM * p.RG;
    p.threads = p.CG * p.RG;
    p.smem = kStages * (p.BM * kKP + kKC * kTN * p.CG) *
             (int)sizeof(float2);
    return p;
}
static_assert(kStages * (kTM * kRowGroupsMax * kKP + kKC * kChanTile) *
              sizeof(float2) <= kSmemMax, "channel mode over 227 KB");

// Row mode: rows a warp at CP channels, a lane's sums RR x CP complex.
__host__ __device__ constexpr int rows_a_warp(int CP) {
    return kAccR / CP < kRowsWarp ? kAccR / CP : kRowsWarp;
}

// The row mode's launch for M samples a row, f taps a polyphase arm and
// C channels (ops/ddc.py row_plan mirrors it).  A chunk is a pass's J
// tap rows by P columns: its window, R + J - 1 rows at pitch P (rounded
// up to even: the span is staged in pairs), then its taps, channel c's
// J x P at c*J*P; a stage holds one chunk within kStageR samples.
struct RowPlan {
    int CP;       // channels rounded up to a power of 2 (1, 2, 4, 8)
    int R;        // rows a block, kWarpsR * rows_a_warp(CP)
    int P;        // columns a chunk and the window's pitch (M: the span)
    int nmc;      // column chunks, ceil(M / P)
    int J;        // tap rows a pass, a multiple of kArmR
    int npass;    // passes, ceil(f / J)
    int nchunk;   // chunks, npass * nmc
    int woff;     // a stage's taps, after the window
    int stage;    // samples a stage (even: 16-byte aligned)
    int smem;     // bytes: one stage, two where there are two chunks
};

RowPlan row_plan(int M, int f, int C) {
    RowPlan p;
    p.CP = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
    p.R = kWarpsR * rows_a_warp(p.CP);
    // the widest chunk that takes kArmR tap rows, then the most tap rows
    const int wmax = (kStageR - 1) / (p.R + kArmR - 1 + p.CP * kArmR);
    p.nmc = (M + wmax - 1) / wmax;
    p.P = (M + p.nmc - 1) / p.nmc;
    int J = (kStageR - 1 - (p.R - 1) * p.P) / ((1 + p.CP) * p.P);
    J -= J % kArmR;
    const int fr = (f + kArmR - 1) / kArmR * kArmR;
    p.J = J < fr ? J : fr;
    p.npass = (f + p.J - 1) / p.J;
    p.nchunk = p.npass * p.nmc;
    p.woff = ((p.R + p.J - 1) * p.P + 1) & ~1;
    p.stage = (p.woff + p.CP * p.J * p.P + 1) & ~1;
    p.smem = (p.nchunk > 1 ? kStagesR : 1) * p.stage * (int)sizeof(float2);
    return p;
}

// The extended samples of one block (rows.cuh's three sources, read
// flat): at(e) is the address of ext sample e, an address of the
// source's own memory for every e, and `live` is false where the sample
// stands for zero (history on the stream's first block, past the block).
struct Ext {
    const float2* x;      // the block (a), the recording (b), the span (c)
    const float2* body;   // ext sample H: x + base*M
    const float2* hist;   // (a), (c): the history samples; (b): nullptr
    long long H;          // history samples, lead*M
    long long end;        // ext samples, (nb + lead)*M
    long long w0;         // (b): recording sample of ext sample 0
    long long X;          // (b): recording samples
    int valid;

    __device__ __forceinline__ const float2* at(long long e,
                                                bool& live) const {
        live = e < end && (e >= H || valid);
        if (!live) return x;
        if (e >= H) return body + (e - H);
        if (hist != nullptr) return hist + e;
        long long w = w0 + e;
        if (w < 0) w += X;            // before the recording: the loop seam
        if (w < 0) w = (w % X + X) % X;   // a recording shorter than that
        return x + w;
    }
};

Ext ext_of(const Rows& in) {
    Ext s;
    s.x = in.x;
    s.body = in.x + in.base * in.M;
    s.hist = in.hist;
    s.H = (long long)in.lead * in.M;
    s.end = (long long)(in.nb + in.lead) * in.M;
    s.w0 = in.base * in.M - s.H;
    s.X = in.x_rows * in.M;
    s.valid = in.valid;
    return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(d), "l"(src));
}

// 8 bytes, zero-filled where `bytes` is 0
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Copy ext samples e, e + 1 (e even) to dst (16-byte aligned): one
// 16-byte copy where both are live, contiguous and aligned in one
// source, else one of 8 bytes each, a dead sample zero-filled.
__device__ __forceinline__ void stage_pair(float2* dst, const Ext& s,
                                           long long e) {
    bool l0, l1;
    const float2* p0 = s.at(e, l0);
    const float2* p1 = s.at(e + 1, l1);
    if (l0 && l1 && p1 == p0 + 1 && ((uintptr_t)p0 & 15) == 0) {
        cp_async16(dst, p0);
    } else {
        cp_async8(dst, p0, l0 ? 8 : 0);
        cp_async8(dst + 1, p1, l1 ? 8 : 0);
    }
}

// Copy taps hmod[k, c], hmod[k, c + 1] to dst (16-byte aligned) the
// same way: live for k < K and a channel c < cend of the block's tile.
__device__ __forceinline__ void stage_taps(float2* dst,
                                           const float2* hmod, int k,
                                           int K, int c, int cend, int C) {
    const bool l0 = k < K && c < cend, l1 = k < K && c + 1 < cend;
    const float2* p0 = l0 ? hmod + (long long)k * C + c : hmod;
    if (l1 && ((uintptr_t)p0 & 15) == 0) {
        cp_async16(dst, p0);
    } else {
        cp_async8(dst, p0, l0 ? 8 : 0);
        cp_async8(dst + 1, l1 ? p0 + 1 : hmod, l1 ? 8 : 0);
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

// Special registers read afresh (volatile asm), so that the staging's
// indices are formed again for each chunk and no register holds them
// across the k-loop, whose accumulators want every register.
__device__ __forceinline__ int tid_x() {
    int v;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
    return v;
}

__device__ __forceinline__ int ctaid(int axis) {
    int v;
    if (axis == 0) asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
    else asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
    return v;
}

// Stage chunk k0 (window columns [k0, k0 + kKC)) of the block's row tile
// and channel tile into buf: the window (span mode: the span from ext
// sample n0*M + k0, even as BM and k0 are; piece mode: kKP / 2 pairs a
// row from the row's first sample rounded down to even), then kKC
// columns of taps, 2 CG pairs a column.  Each thread copies the pairs
// tid, tid + threads, ..., its (row, pair) stepped without a division.
// The fast paths: a window inside the block's body, whose even ext
// samples are 16-byte aligned, and a chunk of live taps aligned alike,
// one 16-byte copy a pair without the per-sample test.
__device__ __forceinline__ void stage_chunk(const Ext& src, int M, int K,
                                            const float2* hmod, int C,
                                            const ChanPlan& p, int k0,
                                            float2* buf) {
    constexpr int kRowPairs = kKP / 2;
    const int tid = tid_x(), nthr = p.threads;
    const long long e0 = (long long)ctaid(0) * p.BM * M + k0;
    const bool span = M <= kKC;
    const int wpairs = span ? ((p.BM - 1) * M + kKC + 1) / 2
                            : p.BM * kRowPairs;
    const long long wext = span ? 2LL * wpairs
                                : (long long)(p.BM - 1) * M + kKP;
    const bool fast =
        e0 >= src.H && e0 + wext <= src.end &&
        ((((uintptr_t)src.body >> 3) ^ (uintptr_t)src.H) & 1) == 0;
    const float2* w = fast ? src.body + (e0 - src.H) : src.body;
    if (span) {
        for (int q = tid; q < wpairs; q += nthr) {
            if (fast) cp_async16(buf + 2 * q, w + 2 * q);
            else stage_pair(buf + 2 * q, src, e0 + 2 * q);
        }
    } else {
        int r = tid / kRowPairs, j = tid % kRowPairs;
        const int dr = nthr / kRowPairs, dj = nthr % kRowPairs;
        for (int q = tid; q < wpairs; q += nthr) {
            const int o = ((r * M) & ~1) + 2 * j;   // from e0
            float2* dst = buf + r * kKP + 2 * j;
            if (fast) cp_async16(dst, w + o);
            else stage_pair(dst, src, e0 + o);
            r += dr;
            j += dj;
            if (j >= kRowPairs) { j -= kRowPairs; ++r; }
        }
    }
    const int c0 = ctaid(1) * p.Ct, cend = min(C, c0 + p.Ct);
    const int tw = kTN * p.CG, tpr = tw / 2;
    const bool tfast = cend - c0 == tw && (C & 1) == 0 && (c0 & 1) == 0 &&
                       ((uintptr_t)hmod & 15) == 0 && k0 + kKC <= K;
    const float2* h = hmod + (long long)k0 * C + c0;
    float2* hs = buf + p.BM * kKP;
    int k = tid / tpr, c = tid % tpr;
    const int dk = nthr / tpr, dc = nthr % tpr;
    for (int q = tid; q < kKC * tpr; q += nthr) {
        float2* dst = hs + k * tw + 2 * c;
        if (tfast) cp_async16(dst, h + k * C + 2 * c);
        else stage_taps(dst, hmod, k0 + k, K, c0 + 2 * c, cend, C);
        k += dk;
        c += dc;
        if (c >= tpr) { c -= tpr; ++k; }
    }
}

__global__ void __launch_bounds__(kThreadsC, 2)
ddc_channel_kernel(Ext src, int M, int nb, int K,
                   const float2* __restrict__ hmod,
                   const float2* __restrict__ ramp,
                   const long long* __restrict__ phase,
                   float2* __restrict__ out, int C, ChanPlan p,
                   float two_pi_w) {
    extern __shared__ __align__(16) float2 smem[];
    const int cg = threadIdx.x % p.CG;
    const int win = p.BM * kKP;               // staged window samples
    const int stage_len = win + kKC * kTN * p.CG;
    // row rg + i*RG of the tile at column 0 of a staged window
    int rowoff[kTM];
    {
        const int rg = threadIdx.x / p.CG;
        const long long n0 = (long long)blockIdx.x * p.BM;
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
            const int r = rg + i * p.RG;
            rowoff[i] = M <= kKC ? r * M
                                 : r * kKP + (int)(((n0 + r) * M) & 1);
        }
    }
    float2 acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = make_float2(0.f, 0.f);

    const int nchunks = (K + kKC - 1) / kKC;
    stage_chunk(src, M, K, hmod, C, p, 0, smem);
    cp_async_commit();
    for (int ch = 0; ch < nchunks; ++ch) {
        cp_async_wait_all();
        __syncthreads();      // chunk ch landed; ch - 1's buffer is free
        if (ch + 1 < nchunks)
            stage_chunk(src, M, K, hmod, C, p, (ch + 1) * kKC,
                        smem + ((ch + 1) & 1) * stage_len);
        cp_async_commit();
        const float2* A = smem + (ch & 1) * stage_len;
        const float4* B = reinterpret_cast<const float4*>(A + win);
        const int tpr = 2 * p.CG;             // tap pairs a column
        // columns past f*M have zero taps: round the chunk up to 8
        const int kc = min(kKC, ((K - ch * kKC) + 7) & ~7);
        for (int kk = 0; kk < kc; kk += 8) {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                float2 a[kTM];
#pragma unroll
                for (int i = 0; i < kTM; ++i) a[i] = A[rowoff[i] + kk + u];
                const float4 b0 = B[(kk + u) * tpr + cg];
                const float4 b1 = B[(kk + u) * tpr + cg + p.CG];
#pragma unroll
                for (int i = 0; i < kTM; ++i) {
                    cmac(acc[i][0], a[i], make_float2(b0.x, b0.y));
                    cmac(acc[i][1], a[i], make_float2(b0.z, b0.w));
                    cmac(acc[i][2], a[i], make_float2(b1.x, b1.y));
                    cmac(acc[i][3], a[i], make_float2(b1.z, b1.w));
                }
            }
        }
    }

    const int rg = threadIdx.x / p.CG;
    const long long n0 = (long long)blockIdx.x * p.BM;
    const int c0 = blockIdx.y * p.Ct, cend = min(C, c0 + p.Ct);
    int cc[kTN];
    float2 rot[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
        cc[j] = c0 + 2 * (cg + (j >> 1) * p.CG) + (j & 1);
        rot[j] = rotation(phase, cc[j] < cend ? cc[j] : c0, two_pi_w);
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
        const long long n = n0 + rg + i * p.RG;
        if (n >= nb) continue;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            if (cc[j] < cend) {
                const long long o = n * C + cc[j];
                out[o] = cmul(cmul(acc[i][j], ramp[o]), rot[j]);
            }
        }
    }
}

// Pairs q = tid, tid + nthr, ... of a (rows, per) walk, stepped
// without a division (row mode's pieces and taps).
struct Walk {
    int r, j, dr, dj, per;
    __device__ __forceinline__ Walk(int tid, int nthr, int per_row)
        : r(tid / per_row), j(tid % per_row), dr(nthr / per_row),
          dj(nthr % per_row), per(per_row) {}
    __device__ __forceinline__ void next() {
        r += dr;
        j += dj;
        if (j >= per) { j -= per; ++r; }
    }
};

// The geometry of row-mode chunk ch: pass ch / nmc (tap rows [j0, j0 +
// jc), jr of them staged, jc rounded up to kArmR) and column chunk ch %
// nmc (columns [m0, m0 + mc)).
struct RowChunk {
    int j0, jc, jr, m0, mc;
    __device__ __forceinline__ RowChunk(const RowPlan& p, int ch, int M,
                                        int f) {
        const int pass = ch / p.nmc;
        j0 = pass * p.J;
        jc = min(p.J, f - j0);
        jr = (jc + kArmR - 1) / kArmR * kArmR;
        m0 = (ch - pass * p.nmc) * p.P;
        mc = min(p.P, M - m0);
    }
};

// Stage row-mode chunk ch of the block's row tile into buf: the window,
// ext rows n0 + j0 + u for u < R + jr - 1, columns [m0, m0 + mc) at
// pitch P (one column chunk: the span itself, in pairs from an even ext
// sample, one 16-byte copy a pair where the span lies in the body, else
// stage_pair; more: a piece a row, a sample a copy), then the taps,
// channel c's [jj, col] at c*J*P + jj*P + col, zero past tap row jc and
// channel C.
template <int CP>
__device__ __forceinline__ void stage_rows(const Ext& src, int M, int f,
                                           int C, const float2* hmod,
                                           const RowPlan& p, int ch,
                                           float2* buf) {
    const int tid = tid_x();
    const RowChunk k(p, ch, M, f);
    const int rows = p.R + k.jr - 1;
    const long long e0 =
        ((long long)ctaid(0) * p.R + k.j0) * M + k.m0;   // even if span
    if (p.nmc == 1) {
        const int npairs = (rows * M + 1) / 2;
        const bool fast =
            e0 >= src.H && e0 + 2LL * npairs <= src.end &&
            ((((uintptr_t)src.body >> 3) ^ (uintptr_t)src.H) & 1) == 0;
        const float2* w = fast ? src.body + (e0 - src.H) : src.body;
        for (int q = tid; q < npairs; q += kThreadsR) {
            if (fast) cp_async16(buf + 2 * q, w + 2 * q);
            else stage_pair(buf + 2 * q, src, e0 + 2 * q);
        }
    } else {
        Walk w(tid, kThreadsR, k.mc);
        for (int q = tid; q < rows * k.mc; q += kThreadsR, w.next()) {
            bool live;
            const float2* s = src.at(e0 + (long long)w.r * M + w.j, live);
            cp_async8(buf + w.r * p.P + w.j, s, live ? 8 : 0);
        }
    }
    float2* hs = buf + p.woff;
    const int ts = p.J * p.P;
    Walk w(tid, kThreadsR, k.mc * CP);
    for (int q = tid; q < k.jr * k.mc * CP; q += kThreadsR, w.next()) {
        const int col = w.j / CP, c = w.j % CP;
        const bool live = w.r < k.jc && c < C;
        const float2* s =
            live ? hmod + ((long long)(k.j0 + w.r) * M + k.m0 + col) * C + c
                 : hmod;
        cp_async8(hs + c * ts + w.r * p.P + col, s, live ? 8 : 0);
    }
}

// Sum each of v[0..N) over the warp's lanes, a level for O = 16, 8, ...,
// 1: while N > 1 a level keeps one half of the values (the upper where
// the lane's bit O is set) and adds the partner's, so it sends N / 2;
// then the one value left is added whole.  Lane l ends with the sum of
// value l (N = 32) or l >> 1 (N = 16) in v[0].
template <int N, int O>
__device__ __forceinline__ void reduce_lanes(float* v, int lane) {
    if constexpr (O > 0) {
        if constexpr (N > 1) {
            const bool up = lane & O;
#pragma unroll
            for (int k = 0; k < N / 2; ++k) {
                const float send = up ? v[k] : v[k + N / 2];
                const float keep = up ? v[k + N / 2] : v[k];
                v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
            }
            reduce_lanes<N / 2, O / 2>(v, lane);
        } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
            reduce_lanes<1, O / 2>(v, lane);
        }
    }
}

template <int CP>                 // channels rounded up to a power of 2
__global__ void __launch_bounds__(kThreadsR, 2)
ddc_row_kernel(Ext src, int M, int nb, int f, int C,
               const float2* __restrict__ hmod,
               const float2* __restrict__ ramp,
               const long long* __restrict__ phase,
               float2* __restrict__ out, RowPlan p, float two_pi_w) {
    constexpr int RR = rows_a_warp(CP);
    constexpr int NX = RR + kArmR - 1;        // window samples a task
    constexpr int V = 2 * (RR * CP);          // floats a lane sums: 16, 32
    constexpr int S = V == 32 ? 0 : 1;        // a value's lanes, log2
    static_assert(V == 16 || V == 32, "row-mode lane sums");
    extern __shared__ __align__(16) float2 smem[];
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x >> 5) * RR;   // the warp's first row
    float2 acc[RR][CP];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[i][c] = make_float2(0.f, 0.f);

    stage_rows<CP>(src, M, f, C, hmod, p, 0, smem);
    cp_async_commit();
    for (int ch = 0; ch < p.nchunk; ++ch) {
        cp_async_wait_all();
        __syncthreads();      // chunk ch landed; ch - 1's buffer is free
        if (ch + 1 < p.nchunk)
            stage_rows<CP>(src, M, f, C, hmod, p, ch + 1,
                           smem + ((ch + 1) & 1) * p.stage);
        cp_async_commit();
        const float2* W = smem + (ch & 1) * p.stage;
        const float2* T = W + p.woff;
        const RowChunk k(p, ch, M, f);
        const int P = p.P, ts = p.J * p.P;
        // task t: arm m, tap rows jb*kArmR + [0, kArmR), t = jb*mc + m
        const int nt = k.jr / kArmR * k.mc;
        int jb = lane / k.mc, m = lane % k.mc;
        const int djb = 32 / k.mc, dm = 32 % k.mc;
        for (int t = lane; t < nt; t += 32) {
            const float2* w = W + (r0 + jb * kArmR) * P + m;
            const float2* h = T + jb * kArmR * P + m;
            float2 x[NX];
#pragma unroll
            for (int u = 0; u < NX; ++u) x[u] = w[u * P];
#pragma unroll
            for (int jj = 0; jj < kArmR; ++jj) {
                float2 hv[CP];
#pragma unroll
                for (int c = 0; c < CP; ++c) hv[c] = h[c * ts + jj * P];
#pragma unroll
                for (int i = 0; i < RR; ++i)
#pragma unroll
                    for (int c = 0; c < CP; ++c)
                        cmac(acc[i][c], x[i + jj], hv[c]);
            }
            m += dm;
            jb += djb;
            if (m >= k.mc) { m -= k.mc; ++jb; }
        }
    }

    float v[V];                   // v[2*(i*CP + c) + {0: re, 1: im}]
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int c = 0; c < CP; ++c) {
            v[2 * (i * CP + c)] = acc[i][c].x;
            v[2 * (i * CP + c) + 1] = acc[i][c].y;
        }
    reduce_lanes<V, 16>(v, lane);
    const int g = lane >> S;                  // this lane's value of v
    const float other = __shfl_xor_sync(0xffffffffu, v[0], 1 << S);
    if ((g & 1) == 0 && (lane & ((1 << S) - 1)) == 0) {
        const int i = (g >> 1) / CP, c = (g >> 1) % CP;
        const long long n = (long long)blockIdx.x * p.R + r0 + i;
        if (n < nb && c < C) {
            const long long o = n * C + c;
            out[o] = cmul(cmul(make_float2(v[0], other), ramp[o]),
                          rotation(phase, c, two_pi_w));
        }
    }
}

// A block's dynamic shared memory for f taps and C channels (ops/ddc.py
// smem_bytes mirrors it): row mode the most a launch takes for any M,
// two stages, kStagesR * kStageR samples; channel mode chan_plan's,
// independent of f and M, at most 102,400 bytes for any C.
int smem_bytes(int f, int row_mode, int C) {
    return row_mode ? kStagesR * kStageR * (int)sizeof(float2)
                    : chan_plan(C).smem;
}

template <int CP>
cudaError_t launch_rows(const Rows& in, const float2* hmod,
                        const float2* ramp, const long long* phase,
                        float2* out, int C, float two_pi_w,
                        cudaStream_t s) {
    const int f = in.lead + 1;
    const RowPlan p = row_plan(in.M, f, C);
    // the bound of every launch, so that no launch's attribute is another's
    const cudaError_t e = cudaFuncSetAttribute(
        ddc_row_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(f, 1, C));
    if (e != cudaSuccess) return e;
    ddc_row_kernel<CP><<<(unsigned)((in.nb + p.R - 1) / p.R), kThreadsR,
                         p.smem, s>>>(ext_of(in), in.M, in.nb, f, C, hmod,
                                      ramp, phase, out, p, two_pi_w);
    return cudaSuccess;
}

int launch(const Rows& in, const void* hmod, const void* ramp,
           const void* phase, void* out, int C, float two_pi_w,
           int row_mode, void* stream) {
    const int nb = in.nb, f = in.lead + 1;
    if (nb <= 0 || in.M <= 0 || f <= 0 || C <= 0 ||
        (row_mode && C > kMaxRowChannels))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (row_mode) {
        const auto h = (const float2*)hmod;
        const auto r = (const float2*)ramp;
        const auto ph = (const long long*)phase;
        const auto o = (float2*)out;
        const cudaError_t e =
            C <= 1 ? launch_rows<1>(in, h, r, ph, o, C, two_pi_w, s)
            : C <= 2 ? launch_rows<2>(in, h, r, ph, o, C, two_pi_w, s)
            : C <= 4 ? launch_rows<4>(in, h, r, ph, o, C, two_pi_w, s)
                     : launch_rows<8>(in, h, r, ph, o, C, two_pi_w, s);
        if (e != cudaSuccess) return (int)e;
    } else {
        const ChanPlan p = chan_plan(C);
        const cudaError_t e = cudaFuncSetAttribute(
            ddc_channel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            p.smem);
        if (e != cudaSuccess) return (int)e;
        const dim3 grid((unsigned)((nb + p.BM - 1) / p.BM),
                        (unsigned)p.ntile);
        ddc_channel_kernel<<<grid, p.threads, p.smem, s>>>(
            ext_of(in), in.M, nb, f * in.M, (const float2*)hmod,
            (const float2*)ramp, (const long long*)phase, (float2*)out, C,
            p, two_pi_w);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// A launch's shared memory for f taps and C channels (row_mode 1: row
// mode, the most for any M), the plan ops/ddc.py smem_bytes mirrors; -1
// for f < 1 or C < 1.
extern "C" int sdr_ddc_smem_bytes(int f, int row_mode, int C) {
    return f < 1 || C < 1 ? -1 : smem_bytes(f, row_mode, C);
}

// The row mode's plan for M, f, C (ops/ddc.py row_plan mirrors it):
// RowPlan's 10 fields in order into out; -1 for M, f or C out of range.
extern "C" int sdr_ddc_row_plan(int M, int f, int C, int* out) {
    if (M < 1 || f < 1 || C < 1 || C > kMaxRowChannels) return -1;
    const RowPlan p = row_plan(M, f, C);
    const int v[] = {p.CP, p.R, p.P, p.nmc, p.J, p.npass, p.nchunk,
                     p.woff, p.stage, p.smem};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
    return 0;
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
