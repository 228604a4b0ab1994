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
// Row mode (at most 8 channels, config 1 has 1): one thread per output
// row looping over the channels in registers, so no lane idles at C = 1;
// a block stages its tile's extended rows a chunk of taps and of samples
// at a time, so any M and any f fit the default 48 KB: for taps [j0, j0
// + J) the rows [n0 + j0, n0 + j0 + tile + J - 1), J = 59 taps (the row
// pitch odd so that row-strided reads hit distinct banks); hmod reads
// are warp-uniform broadcasts.  Accumulation is FP32 FFMA, taps in
// order: chunks of J taps, then chunks of samples, then j, then m.

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
constexpr int kTileR = 128;       // row mode: rows (threads) per block
constexpr int kChunkR = 32;       // row mode: staged samples per row
constexpr int kMaxRowChannels = 8;
constexpr int kSmemDefault = 48 * 1024;   // a block's shared memory, no opt-in
constexpr int kSmemMax = 232448;  // a block's shared memory with the opt-in
// kKP = kKC + 2: room for a row's odd first sample and the pair it ends in
static_assert(kKP == kKC + 2 && kKC % 8 == 0 && kTM % 2 == 0,
              "channel-mode chunk");

// Taps staged per pass in row mode: the most whose tile + taps - 1 rows
// of a chunk fit kSmemDefault (59).
constexpr int taps_per_pass(int tile, int chunk) {
    return kSmemDefault / ((chunk + 1) * (int)sizeof(float2)) - tile + 1;
}
constexpr int kTapsR = taps_per_pass(kTileR, kChunkR);
static_assert((kTileR + kTapsR - 1) * (kChunkR + 1) * sizeof(float2) <=
              kSmemDefault, "row mode over 48 KB");

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

// Stage extended rows [g0, g0 + nrows), columns [m0, m0 + mc) (row mode).
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

template <bool kDeep>             // f > kTapsR: passes of kTapsR taps
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

// A block's dynamic shared memory for f taps and C channels (ops/ddc.py
// smem_bytes mirrors it): row mode tile + min(f, taps) - 1 staged rows,
// at most kSmemDefault for any f; channel mode chan_plan's, independent
// of f and M, at most 102,400 bytes for any C.
int smem_bytes(int f, int row_mode, int C) {
    return row_mode
        ? (kTileR + (f < kTapsR ? f : kTapsR) - 1) * (kChunkR + 1) *
              (int)sizeof(float2)
        : chan_plan(C).smem;
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
        const int smem = smem_bytes(f, row_mode, C);
        const auto kernel = f > kTapsR ? ddc_row_kernel<true>
                                       : ddc_row_kernel<false>;
        kernel<<<(unsigned)((nb + kTileR - 1) / kTileR), kTileR, smem, s>>>(
            in, (const float2*)hmod, (const float2*)ramp,
            (const long long*)phase, (float2*)out, f, C, two_pi_w);
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

// The launch's shared memory for f taps and C channels (row_mode 1: row
// mode), the plan ops/ddc.py smem_bytes mirrors; -1 for f < 1 or C < 1.
extern "C" int sdr_ddc_smem_bytes(int f, int row_mode, int C) {
    return f < 1 || C < 1 ? -1 : smem_bytes(f, row_mode, C);
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
