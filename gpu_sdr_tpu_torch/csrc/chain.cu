// G-fused TONES->DIRECT loopback chain, one time shard's rows of one
// block, on Hopper's tensor cores (sm_90a).
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
// Bound: config 3 through use_fold=False (Ct = Cp = 100, f 4, 20,000 rows
// per shard) is 6.42 GFLOP against 48 MB: in FP32 FFMA 0.096 ms
// (operations), on the tensor cores, three TF32 passes at 495 TFLOP/s,
// 0.039 ms; at f 1000 9.7 ms.  The TPU kernel's bf16 hi/lo split of G,
// its lP halo units padded to 8 rows, the rep8 rotation rows, the
// divisor-of-nb tile rule and the K blocks per launch have no
// counterpart.
//
// Design: the fold's mainloop (tc.cuh: mma.sync TF32, three-pass split,
// the real embedding) over K = f * Ct.  A persistent grid, one block of
// 16 warps per SM, walks the shard's tiles of 64 rows, all of a chunk's
// channels (config 3: all 100) at once: 4 warps over the rows by 4 over
// the channels, up to 7 column fragments each.  Per tile a block stages
// the tile's extended rows once (64 + J - 1 rows for J taps) by
// cp.async and rotates them in place (halo rows by hrot, P rows by
// srot): tap j is the same staged rows read from row j on, no im2col.
// The rows are double-buffered: the next tile's come while the tensor
// cores run on this one's.  G (320 KB at config 3) does not fit beside
// them, so it streams through a two-slot ring of items, one tap's chunk
// of tones each (config 3: 52 and 48 tones, 42 KB), the next item in
// flight while the tensor cores run on this one; each item costs one
// barrier, and its 12-13 steps of k run unrolled twice.  16 warps of 7
// fragments outran 8 of 13 (0.28 against 0.40 ms at config 3:
// bench/chain_variants.py, PERF.md): the warps, not the sub-partitions'
// products, set the pace.  Each tap's product is summed on the tensor
// core and the taps' sums in FP32 registers: the tensor core's
// accumulation loses accuracy with the additions into one accumulator
// (tc.cuh).  J is the most taps whose two row buffers fit beside the
// ring within 227 KB (28 at config 3's widths); f > J runs passes of J
// taps (kDeep), each staging its rows again, so any f runs in bounded
// shared memory; f <= J (the main path's f 4) runs the instance without
// the pass arithmetic.
// Channels past 112 go to further blocks (grid.y), tones past what fits
// to chunks of rows staged in turn.  The epilogue loads its ramp and
// output rotations first, all in flight at once, multiplies in registers
// and stores each lane's four channels of a row (32 bytes).  The last
// tile is masked.

#include <cuda_runtime.h>

#include <algorithm>

#include "tc.cuh"

namespace {

using tc::cmul;

constexpr int kTile = tc::kRows;          // rows per tile
constexpr int kWarpsN = 4;                // warps over a chunk's channels
constexpr int kNF = 7;                    // column fragments (4 channels) a warp
constexpr int kChanMax = kWarpsN * kNF * 4;   // channels per block (112)
constexpr int kThreads = 4 * kWarpsN * 32;    // 16 warps (512)
constexpr int kMinTaps = 8;               // fewest taps a pass is cut to

// The launch's plan (ops/chain.py plan mirrors it).
struct Plan {
    int CN, CNs, nc;   // channels a block (grid.y blocks), pitch in complex
    int KE, nke, AS;   // tones of a chunk of staged rows, chunks, pitch (floats)
    int KG, nsub;      // tones of a G item, items a chunk of rows
    int taps;          // J: taps a pass, 64 + J - 1 rows staged
    int smem;          // bytes
};

// Channel chunks of at most kChanMax; then the fewest chunks of tones
// (KE) and, for them, the fewest G items a chunk (KG tones) that leave
// room, beside the ring's two items, for two buffers of the rows of at
// least min(f, kMinTaps) taps; J the most that fit.
Plan plan(int f, int Ct, int Cp) {
    Plan p{};
    p.nc = (Cp + kChanMax - 1) / kChanMax;
    p.CN = tc::round_up((Cp + p.nc - 1) / p.nc, 4);
    p.CNs = p.CN + ((4 - p.CN) % 16 + 16) % 16;
    const int avail = tc::kSmemMax / (int)sizeof(float);
    for (p.nke = 1;; ++p.nke) {
        p.KE = tc::round_up(
            (tc::round_up(Ct, 4) / 4 + p.nke - 1) / p.nke * 4, 4);
        p.AS = 2 * p.KE + 4;
        for (int d = 1; d <= p.KE / 4; ++d) {
            p.KG = (p.KE / 4 + d - 1) / d * 4;
            p.nsub = (p.KE + p.KG - 1) / p.KG;
            const int ring = 2 * p.KG * p.CNs * 2;
            p.taps = std::min(f, (avail - ring) / (2 * p.AS) - kTile + 1);
            if (p.taps >= std::min(f, kMinTaps)) {
                p.smem = (ring + 2 * (kTile + p.taps - 1) * p.AS) *
                         (int)sizeof(float);
                return p;
            }
        }
    }
}

// Where a block is: its tile, pass of taps, chunk of tones of the staged
// rows, tap in the pass and G item in the chunk.
struct Cursor {
    int tile, p, kc, j, s;
};

// kDeep: f > J, passes of J taps; else one pass of all f taps.
template <bool kDeep>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const float2* __restrict__ P, const float2* __restrict__ hP,
             const float2* __restrict__ G, const float2* __restrict__ ramp,
             const float2* __restrict__ srot, const float2* __restrict__ hrot,
             const float2* __restrict__ drot, float2* __restrict__ out,
             int nbt, int Ct, int Cp, int f, Plan pl) {
    extern __shared__ float4 smem4[];
    float* const ring = reinterpret_cast<float*>(smem4);   // two G items
    const int gfl = pl.KG * pl.CNs * 2;                     // floats an item
    float* const rows = ring + 2 * gfl;                     // two row buffers
    const int efl = (kTile + pl.taps - 1) * pl.AS;          // floats a buffer
    const int lead = f - 1;
    const int J = kDeep ? pl.taps : f;
    const int npass = kDeep ? (f + J - 1) / J : 1;
    const int nt = (nbt + kTile - 1) / kTile;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = warp & 3, wn = warp >> 2;
    // the chunk's column fragments split over the four warps
    const int nfh = (pl.CN / 4 + kWarpsN - 1) / kWarpsN;   // at most kNF
    const int jn0 = wn * nfh;
    const int nfw = min(nfh, pl.CN / 4 - jn0);
    const int c0 = blockIdx.y * pl.CN;
    const int cn = min(pl.CN, Cp - c0);
    auto taps_in = [&](int p) { return kDeep ? min(J, f - p * J) : f; };
    auto next_rows = [&](Cursor& c) {      // the next chunk of staged rows
        c.j = c.s = 0;
        if (++c.kc < pl.nke) return;
        c.kc = 0;
        if (kDeep && ++c.p < npass) return;
        c.p = 0;
        c.tile += gridDim.x;
    };
    auto next_item = [&](Cursor& c) {
        if (++c.s < pl.nsub) return;
        c.s = 0;
        if (++c.j < taps_in(c.p)) return;
        next_rows(c);
    };
    // staged row q is shard row n0 - lead + p*J + q: a halo row below 0,
    // a P row up to nbt, zero past; tones kc*KE on, zero past Ct
    auto stage_rows = [&](float* e, const Cursor& c) {
        const int r0 = c.tile * kTile - lead + c.p * J;
        const int t0 = c.kc * pl.KE;
        for (int q = warp; q < kTile + taps_in(c.p) - 1; q += kThreads / 32) {
            const int r = r0 + q;
            const float2* src = r < 0 ? hP + (long long)(r + lead) * Ct
                                      : P + (long long)r * Ct;
            for (int t = lane; t < pl.KE; t += 32) {
                const bool ok = t0 + t < Ct && r < nbt;
                tc::cp_async8(e + q * pl.AS + 2 * t, ok ? src + t0 + t : P,
                              ok ? 8 : 0);
            }
        }
    };
    auto rotate_rows = [&](float* e, const Cursor& c) {
        const int r0 = c.tile * kTile - lead + c.p * J;
        const int t0 = c.kc * pl.KE;
        const int kt = min(pl.KE, Ct - t0);
        for (int q = warp; q < kTile + taps_in(c.p) - 1; q += kThreads / 32) {
            const float2* rv = (r0 + q < 0 ? hrot : srot) + t0;
            for (int t = lane; t < kt; t += 32) {
                float2* v = reinterpret_cast<float2*>(e + q * pl.AS + 2 * t);
                *v = cmul(*v, __ldg(rv + t));
            }
        }
    };
    auto item_tones = [&](const Cursor& c) {
        return min(pl.KG, pl.KE - c.s * pl.KG);
    };
    // the item's chunk of G[p*J + j]: tones kc*KE + s*KG on, zero past Ct
    // and Cp
    auto issue_g = [&](float* slot, const Cursor& c) {
        const int t0 = c.kc * pl.KE + c.s * pl.KG;
        const float2* src = G + (long long)(c.p * J + c.j) * Ct * Cp + c0;
        const int kt = item_tones(c);
        for (int t = warp; t < kt; t += kThreads / 32)
            for (int ch = lane; ch < pl.CN; ch += 32) {
                const bool ok = t0 + t < Ct && c0 + ch < Cp;
                tc::cp_async8(slot + 2 * (t * pl.CNs + ch),
                              ok ? src + (long long)(t0 + t) * Cp + ch : G,
                              ok ? 8 : 0);
            }
    };
    Cursor c{(int)blockIdx.x, 0, 0, 0, 0};
    if (c.tile >= nt) return;
    stage_rows(rows, c);
    issue_g(ring, c);
    tc::cp_async_commit();
    float acc[kNF][4], part[kNF][4];
#pragma unroll
    for (int q = 0; q < kNF; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
    for (int eb = 0, gb = 0;;) {
        const bool first = c.j == 0 && c.s == 0;   // the rows' first item
        Cursor n = c;
        next_item(n);
        float* e = rows + eb * efl;
        tc::cp_async_wait<0>();
        __syncthreads();        // this item and its rows are in; the other
                                // slot and buffer are read
        if (first) rotate_rows(e, c);
        if (n.tile < nt) issue_g(ring + (gb ^ 1) * gfl, n);
        if (first) {
            Cursor r = c;
            next_rows(r);
            if (r.tile < nt) stage_rows(rows + (eb ^ 1) * efl, r);
        }
        tc::cp_async_commit();
        if (first) __syncthreads();                // the rows are rotated
        if (nfw > 0) {
            // the tap's sum on the tensor core, the taps' sums in FP32
            if (c.s == 0) {
#pragma unroll
                for (int q = 0; q < kNF; ++q)
                    part[q][0] = part[q][1] = part[q][2] = part[q][3] = 0.f;
            }
            tc::mainloop<false, false, kNF, 2>(
                part, e + (wm * 16 + c.j) * pl.AS + 2 * c.s * pl.KG, pl.AS,
                ring + gb * gfl + 8 * jn0, pl.CNs, nullptr, item_tones(c),
                nfw);
            if (c.s == pl.nsub - 1) {
#pragma unroll
                for (int q = 0; q < kNF; ++q)
#pragma unroll
                    for (int k = 0; k < 4; ++k) acc[q][k] += part[q][k];
            }
        }
        if (n.tile != c.tile) {
            // the epilogue from the registers: ramp and output rotation,
            // each lane's four channels of a row (32 bytes); the loads
            // first, all in flight at once
            const int g = lane >> 2, q4 = lane & 3;
            const int n0 = c.tile * kTile + wm * 16 + g;
            float2 rp[kNF][2], d[kNF];
#pragma unroll
            for (int q = 0; q < kNF; ++q) {
                const int ch = (jn0 + q) * 4 + q4;
                const bool live = q < nfw && ch < cn;
                d[q] = live ? drot[c0 + ch] : make_float2(0.f, 0.f);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = n0 + 8 * h;
                    rp[q][h] = live && r < nbt
                                   ? ramp[(long long)r * Cp + c0 + ch]
                                   : make_float2(0.f, 0.f);
                }
            }
#pragma unroll
            for (int q = 0; q < kNF; ++q) {
                const int ch = (jn0 + q) * 4 + q4;
                if (q < nfw && ch < cn) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int r = n0 + 8 * h;
                        if (r < nbt)
                            out[(long long)r * Cp + c0 + ch] = cmul(
                                cmul(make_float2(acc[q][2 * h],
                                                 acc[q][2 * h + 1]),
                                     rp[q][h]), d[q]);
                    }
                }
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[q][k] = 0.f;
            }
        }
        if (n.tile >= nt) break;
        if (n.j == 0 && n.s == 0) eb ^= 1;
        gb ^= 1;
        c = n;
    }
}

}  // namespace

// The launch's shared memory for f taps at Ct tones and Cp channels, the
// plan ops/chain.py smem_bytes mirrors; -1 for a geometry it refuses.
extern "C" int sdr_chain_smem_bytes(int f, int Ct, int Cp) {
    return f < 1 || Ct < 1 || Cp < 1 ? -1 : plan(f, Ct, Cp).smem;
}

// P (nbt, Ct), hP (f-1, Ct), G (f, Ct, Cp), ramp (nbt, Cp), srot and
// hrot (Ct,), drot (Cp,) -> out (nbt, Cp).
extern "C" int sdr_chain(const void* P, const void* hP, const void* G,
                         const void* ramp, const void* srot, const void* hrot,
                         const void* drot, void* out, int nbt, int Ct,
                         int Cp, int f, void* stream) {
    if (nbt <= 0 || Ct <= 0 || Cp <= 0 || f < 2 || f - 1 > nbt)
        return (int)cudaErrorInvalidValue;
    const Plan pl = plan(f, Ct, Cp);
    const bool deep = f > pl.taps;
    static tc::LaunchCache caches[2];
    const auto kernel = deep ? chain_kernel<true> : chain_kernel<false>;
    int slots = 0;
    const cudaError_t err = tc::resident_blocks(kernel, caches[deep],
                                                kThreads, pl.smem, &slots);
    if (err != cudaSuccess) return (int)err;
    const int nt = (nbt + kTile - 1) / kTile;
    const dim3 grid((unsigned)std::min(nt, std::max(1, slots / pl.nc)),
                    (unsigned)pl.nc);
    kernel<<<grid, kThreads, pl.smem, (cudaStream_t)stream>>>(
        (const float2*)P, (const float2*)hP, (const float2*)G,
        (const float2*)ramp, (const float2*)srot, (const float2*)hrot,
        (const float2*)drot, (float2*)out, nbt, Ct, Cp, f, pl);
    return (int)cudaGetLastError();
}
