// Fused PFB channelizer (pre-sum + mixed-radix FFT), for Hopper (sm_90a).
//
// Replaces the TPU kernels gpu_sdr_tpu/ops/pallas_channelizer.py:
//   channelizer_frames_t  (:390, its pallas_call :473): a streamed block,
//                         or one frame in const-frame mode; the
//                         fused-loopback TONES / NOISE chain
//                         (engine/fused._ChannelizerWavetableChain);
//   channelizer_frames_at (:712, :765): block `idx` of a resident
//                         (total_frames, nfft) recording, read in place;
//                         the device replay's channelizer_at sub-path;
//   channelizer_frames_at_halo (:622, :680): block `idx` of one time
//                         shard's span of the recording after a staged
//                         halo; the sharded device replay's
//                         channelizer_at sub-path;
//   channelizer_frames    (:213, :263): a streamed block, its spectra
//                         stored in the scrambled order k1*n2 + k2 (bin k
//                         at (k % n1)*n2 + k / n1);
//                         sdr_channelizer_scrambled.
//
// For frame t of the block:
//   pre[t, s] = sum_{i<avg} W[i, s] * ext[t + i, s]    (ext = halo ++ x)
//   out[t, k] = sum_s pre[t, s] exp(-2 pi i s k / nfft)
// in natural bin order (or scrambled).  The extended block (avg-1 halo
// rows, then the block's T frames) is read in place from one of four
// sources, a template parameter, each giving a row's address:
//   Streamed: a streamed block after its carried spare; in const-frame
//             mode x is ONE frame standing for all T frames of the block
//             (a bin-quantized comb is nfft-periodic): only the block read
//             is saved, every frame's pre-sum and FFT is computed;
//   Recorded: a recording's frames [base, base + T) after the avg-1
//             frames before them, wrapped at the loop seam and zero on
//             the stream's first block (`valid` 0), as rows.cuh says;
//   Staged:   one time shard's frames of the block, in place in its span,
//             after avg-1 halo frames staged at upload (rows.cuh (c));
//   RecordedShort: a recording shorter than the halo (rows.cuh (b)).
//
// Bound: device memory.  The function reads each block sample once and
// writes each bin once, 16 B a sample (97 MB for a 6000 x 1000 block),
// against ~4*avg flops of pre-sum and ~5 log2(nfft) of FFT a sample
// (0.39 GFLOP): 0.029 ms of HBM against 0.006 ms of FP32 on an H100.
// The TPU kernels (and this port's first kernel) computed the DFT as a
// two-stage 125 x 125 matmul, ~1,000 flops a sample, a shape chosen for
// the MXU; here it is an FFT, and the design keeps the bytes at the
// function's own and a tile's work in shared memory and registers:
//   1. one block owns a tile of FT frames and every bin of each, and
//      forms each frame's pre-sum once: no block reads the two-stage
//      constants or repeats another's pre-sum.  The avg-1 rows a tile
//      shares with the one before, and each row's avg reads, come from
//      L1 / L2: the shared-memory carveout is left at its default, which
//      keeps L1 large enough for them;
//   2. the frames' DFT runs as Stockham passes, natural order out, a
//      barrier between passes, the butterflies in registers: radix 16
//      (4 x 4), 10 (2 x 5), 8 (2 x 4), 6 (2 x 3), 5, 4, 3, 7, 2, and any
//      prime factor left as one direct-DFT pass (the plan from
//      ops/channelizer.fft_radices: nfft 1000 is three radix-10
//      passes).  The first pass is folded into the pre-sum, each
//      butterfly pre-summing its R samples (neighbouring threads on
//      neighbouring samples, a row's R loads issued together);
//      the last stores its outputs straight to `out`, contiguous across
//      a warp: a tile goes through shared memory once a pass, less one.
//      Twiddles and each radix's roots come from a table built in
//      float64 on the host and stored float32 (no sincosf, no fast-math
//      intrinsics), read through L1, laid out so that a warp's loads are
//      contiguous; the quarter turns inside a butterfly are exact;
//   3. the scrambled order of #3 (and a plan with no register pass) goes
//      out after the last pass as one contiguous run of the tile's bins
//      in 16-byte stores, the scrambled order a permuted read of shared
//      memory;
//   4. FT is sized so that a tile's two buffers take at most 72 KB
//      (nfft 1000: 4 frames, 64 KB).  An nfft whose single frame does
//      not fit a block's shared memory (> 14,528) keeps its two buffers
//      in device memory (`scratch`, one pair a block, the blocks looping
//      over the frames); no geometry the host-side gate admits is
//      refused.
// FP32 throughout: the pre-sum in FFMA in order i = 0..avg-1, the FFT's
// error grows with log(nfft) (~138 dB against float64 at nfft 1000).
// No tensor cores, no cuFFT.

#include <cuda_runtime.h>

#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int FT_MAX = 32;           // frames of a tile at most
constexpr int SMEM_TILE = 73728;     // a multi-frame tile's two buffers
constexpr int SMEM_MAX = 232448;     // a block's shared memory on Hopper
constexpr int MAX_PASSES = 32;

// The FFT plan: radix and stride of each Stockham pass, and where its
// twiddles start in the table.  The table holds, for each pass p with
// ns = radix[0] * ... * radix[p-1] and R = radix[p], the twiddles
// exp(-2 pi i r m / (ns R)) at [(r-1) ns + m] for 1 <= r < R, m < ns (a
// warp's butterflies, on neighbouring m, load neighbouring twiddles),
// then R's roots exp(-2 pi i j / R) for j < R (ops/channelizer.py builds
// it, fft_table).
struct Plan {
    int n, passes;
    int radix[MAX_PASSES];
    int ns[MAX_PASSES];
    int off[MAX_PASSES];
};

// Frames of a tile: two (FT, n) complex buffers within SMEM_TILE, at
// least one (ops/channelizer.tile_frames mirrors it).
int tile_frames(int n) {
    const long long f = SMEM_TILE / (16LL * n);
    return f < 1 ? 1 : f > FT_MAX ? FT_MAX : (int)f;
}

// Shared memory of one block, or 0 when one frame's two buffers exceed
// it and the buffers are in device memory (ops/channelizer.smem_bytes).
int smem_bytes(int n) {
    const long long b = 16LL * tile_frames(n) * n;
    return b <= SMEM_MAX ? (int)b : 0;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 mul_mi(float2 a) {   // a * (-i)
    return make_float2(a.y, -a.x);
}

// The butterflies: v <- DFT_R(v), y_k = sum_q v_q exp(-2 pi i q k / R),
// over R's roots w[j] = exp(-2 pi i j / R), j <= R/2, from the table.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R],
                                    const float2 (&w)[R / 2 + 1]);

// exp(-2 pi i j / R) for any j (a compile-time constant once unrolled)
template <int R>
__device__ __forceinline__ float2 root(const float2 (&w)[R / 2 + 1], int j) {
    j %= R;
    return j <= R / 2 ? w[j] : make_float2(w[R - j].x, -w[R - j].y);
}

// x * exp(-2 pi i j / R): the quarter turns exact, the rest from w
template <int R>
__device__ __forceinline__ float2 rotate(float2 x,
                                         const float2 (&w)[R / 2 + 1],
                                         int j) {
    j %= R;
    if (j == 0) return x;
    if (4 * j == R) return mul_mi(x);
    if (2 * j == R) return make_float2(-x.x, -x.y);
    if (4 * j == 3 * R) return make_float2(-x.y, x.x);
    return cmul(x, root<R>(w, j));
}

__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2,
                                     float2& v3) {
    const float2 t0 = cadd(v0, v2), t1 = csub(v0, v2);
    const float2 t2 = cadd(v1, v3), t3 = mul_mi(csub(v1, v3));
    v0 = cadd(t0, t2);
    v2 = csub(t0, t2);
    v1 = cadd(t1, t3);
    v3 = csub(t1, t3);
}

// odd R: v_q and v_{R-q} paired, y_m and y_{R-m} from the same sums
template <int R>
__device__ __forceinline__ void dft_odd(float2 (&v)[R],
                                        const float2 (&w)[R / 2 + 1]) {
    constexpr int H = R / 2;
    float2 a[H + 1], b[H + 1], y[R];
    y[0] = v[0];
#pragma unroll
    for (int q = 1; q <= H; ++q) {
        a[q] = cadd(v[q], v[R - q]);
        b[q] = csub(v[q], v[R - q]);
        y[0] = cadd(y[0], a[q]);
    }
#pragma unroll
    for (int m = 1; m <= H; ++m) {
        float re = v[0].x, im = v[0].y, sr = 0.f, si = 0.f;
#pragma unroll
        for (int q = 1; q <= H; ++q) {
            const int j = q * m % R;
            const float c = j <= H ? w[j].x : w[R - j].x;     // cos
            const float s = j <= H ? -w[j].y : w[R - j].y;    // sin
            re = fmaf(c, a[q].x, re);
            im = fmaf(c, a[q].y, im);
            sr = fmaf(s, b[q].x, sr);
            si = fmaf(s, b[q].y, si);
        }
        y[m] = make_float2(re + si, im - sr);
        y[R - m] = make_float2(re - si, im + sr);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = y[r];
}

// R = A B in registers (Cooley-Tukey): B DFTs of size A over v[n1 B +
// n2], output k1 of the n2-th rotated by exp(-2 pi i n2 k1 / R), then A
// DFTs of size B; y[k1 + A k2]
template <int A, int B>
__device__ __forceinline__ void dft_ct(float2 (&v)[A * B],
                                       const float2 (&w)[A * B / 2 + 1]) {
    constexpr int R = A * B;
    float2 wa[A / 2 + 1], wb[B / 2 + 1], u[R];
#pragma unroll
    for (int j = 0; j <= A / 2; ++j) wa[j] = root<R>(w, j * B);
#pragma unroll
    for (int j = 0; j <= B / 2; ++j) wb[j] = root<R>(w, j * A);
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) {
        float2 t[A];
#pragma unroll
        for (int n1 = 0; n1 < A; ++n1) t[n1] = v[n1 * B + n2];
        dft<A>(t, wa);
#pragma unroll
        for (int k1 = 0; k1 < A; ++k1)
            u[k1 * B + n2] = rotate<R>(t[k1], w, n2 * k1);
    }
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
        float2 t[B];
#pragma unroll
        for (int n2 = 0; n2 < B; ++n2) t[n2] = u[k1 * B + n2];
        dft<B>(t, wb);
#pragma unroll
        for (int k2 = 0; k2 < B; ++k2) v[k1 + A * k2] = t[k2];
    }
}

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R],
                                    const float2 (&w)[R / 2 + 1]) {
    if constexpr (R == 2) {
        const float2 a = v[0];
        v[0] = cadd(a, v[1]);
        v[1] = csub(a, v[1]);
    } else if constexpr (R == 4) {
        dft4(v[0], v[1], v[2], v[3]);
    } else if constexpr (R % 2) {
        dft_odd<R>(v, w);
    } else if constexpr (R == 6 || R == 10) {
        dft_ct<2, R / 2>(v, w);
    } else {                                  // 8, 16
        dft_ct<R / 4, 4>(v, w);
    }
}

// One Stockham pass of radix R over the tile's nf frames, a -> b:
// butterfly j (of nb = n / R) reads a[j + r nb], r < R, twiddles them by
// exp(-2 pi i r m / (ns R)) with m = j % ns, and writes its R outputs to
// b[(j - m) R + m + r ns].  `tw` is the pass's part of the table.
template <int R>
__device__ __forceinline__ void pass_r(const float2* a, float2* b,
                                       const float2* __restrict__ tw, int nf,
                                       int n, int ns) {
    const int nb = n / R;
    float2 w[R / 2 + 1];
#pragma unroll
    for (int j = 0; j <= R / 2; ++j) w[j] = __ldg(tw + ns * (R - 1) + j);
    // butterflies e = f nb + j, e = threadIdx.x + k NTHREADS: (f, j, m)
    // stepped by (df, dj, dm) with a carry, no division in the loop (nb
    // is a multiple of ns, so j's carry leaves m as it is)
    const int df = NTHREADS / nb, dj = NTHREADS % nb, dm = dj % ns;
    int f = threadIdx.x / nb, j = threadIdx.x % nb, m = j % ns;
    while (f < nf) {
        const float2* src = a + f * n + j;
        float2 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = src[r * nb];
        if (m) {
#pragma unroll
            for (int r = 1; r < R; ++r)
                v[r] = cmul(v[r], __ldg(tw + (r - 1) * ns + m));
        }
        dft<R>(v, w);
        float2* dst = b + f * n + (j - m) * R + m;
#pragma unroll
        for (int r = 0; r < R; ++r) dst[r * ns] = v[r];
        f += df;
        j += dj;
        m += dm;
        if (j >= nb) {
            j -= nb;
            ++f;
        }
        if (m >= ns) m -= ns;
    }
}

// The same pass for any other radix R (a prime factor the radices above
// leave): one thread an output, a direct DFT over the roots in the table.
__device__ __forceinline__ void pass_any(const float2* a, float2* b,
                                         const float2* __restrict__ tw,
                                         int nf, int n, int ns, int R) {
    const int nb = n / R;
    const float2* roots = tw + ns * (R - 1);
    for (int e = threadIdx.x; e < nf * n; e += NTHREADS) {
        const int f = e / n;
        const int k = (e - f * n) / nb;           // output k of butterfly j
        const int j = e - f * n - k * nb;
        const int m = j % ns;
        const float2* src = a + f * n + j;
        float2 acc = src[0];
        int idx = 0;                              // q k mod R
        for (int q = 1; q < R; ++q) {
            float2 v = src[q * nb];
            if (m) v = cmul(v, __ldg(tw + (q - 1) * ns + m));
            idx += k;
            if (idx >= R) idx -= R;
            acc = cadd(acc, cmul(v, __ldg(roots + idx)));
        }
        b[f * n + (j - m) * R + m + k * ns] = acc;
    }
}

__device__ __forceinline__ void fft_pass(const Plan& plan, int p,
                                         const float2* __restrict__ table,
                                         const float2* a, float2* b, int nf) {
    const int n = plan.n, ns = plan.ns[p];
    const float2* tw = table + plan.off[p];
    switch (plan.radix[p]) {
        case 16: pass_r<16>(a, b, tw, nf, n, ns); break;
        case 10: pass_r<10>(a, b, tw, nf, n, ns); break;
        case 8: pass_r<8>(a, b, tw, nf, n, ns); break;
        case 6: pass_r<6>(a, b, tw, nf, n, ns); break;
        case 5: pass_r<5>(a, b, tw, nf, n, ns); break;
        case 4: pass_r<4>(a, b, tw, nf, n, ns); break;
        case 3: pass_r<3>(a, b, tw, nf, n, ns); break;
        case 7: pass_r<7>(a, b, tw, nf, n, ns); break;
        case 2: pass_r<2>(a, b, tw, nf, n, ns); break;
        default: pass_any(a, b, tw, nf, n, ns, plan.radix[p]);
    }
}

// The four row sources.  row(r) is the address of extended row r, a row
// of the source's own memory for every r < T + lead; live(r) is false
// where that row stands for zeros (the halo on the stream's first
// block).  So a load is never from an invalid address, whatever the
// compiler hoists, and a row that is not live is selected away.

// A streamed block: the spare's rows, then x's (in const-frame mode x's
// one row for all).  Offsets are int (the launcher checks that the rows
// fit one).
struct Streamed {
    const float2* x;
    const float2* spare;
    int T, lead, nfft, const_x;

    __device__ __forceinline__ const float2* row(int r) const {
        return r < lead ? spare + r * nfft
                        : x + (const_x ? 0 : (r - lead) * nfft);
    }
    __device__ __forceinline__ bool live(int) const { return true; }
};

// A recording block: recording row base - lead + r, at an int offset
// from the block's first frame (`body`) or, for the halo rows before the
// recording's first row (r < split), from its end (`wrap`: the loop
// seam); the halo is zero on the stream's first block (`valid` 0).  It
// wraps once, so it needs total_frames >= lead.
struct Recorded {
    const float2* body;   // recording row base
    const float2* wrap;   // recording row base + total_frames
    int T, lead, nfft, split, valid;

    __device__ __forceinline__ const float2* row(int r) const {
        return (r < split ? wrap : body) + (r - lead) * nfft;
    }
    __device__ __forceinline__ bool live(int r) const {
        return r >= lead || valid;
    }
};

// Block `blk` of one time shard's span (rows.cuh (c)): the halo rows (r <
// lead) from the staged array's row blk, zero on the stream's first
// block (`valid` 0); the body rows in place in the shard's span.
struct Staged {
    const float2* body;   // shard span row blk*T
    const float2* halo;   // staged (nblk, lead, nfft) row blk
    int T, lead, nfft, valid;

    __device__ __forceinline__ const float2* row(int r) const {
        return r < lead ? halo + r * nfft : body + (r - lead) * nfft;
    }
    __device__ __forceinline__ bool live(int r) const {
        return r >= lead || valid;
    }
};

// A recording shorter than the halo (total_frames < lead), whose halo
// wraps more than once: rows.cuh's general addressing, a row at a time.
struct RecordedShort {
    Rows in;
    int T;

    __device__ __forceinline__ const float2* row(int g) const {
        long long w = in.base + g - in.lead;
        if (w < 0) {                  // before the recording's first row
            w %= in.x_rows;
            if (w < 0) w += in.x_rows;
        }
        return in.x + w * in.M;
    }
    __device__ __forceinline__ bool live(int g) const {
        return g >= in.lead || in.valid;
    }
};

// acc += w * v
__device__ __forceinline__ void wfma(float w, float2 v, float2& acc) {
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
}

// The tile's pre-sum and the first Stockham pass (radix R, ns 1) at once,
// frames t0 .. t0+nf-1 into b: butterfly j pre-sums its R samples j + r
// nb (nb = n / R) of each of the avg rows, a row's R loads issued
// together (neighbouring threads on neighbouring samples), and writes
// its DFT to b[j R + r].  Saves the pre-sum's round trip through shared
// memory.  R = 1 is the pre-sum alone, where the first pass has no
// register butterfly (a direct-DFT pass, or none).
template <int R, class Src>
__device__ __forceinline__ void presum_pass(const Src& src,
                                            const float* __restrict__ w,
                                            int t0, int nf, int n, int avg,
                                            const float2* __restrict__ tw,
                                            float2* b) {
    const int nb = n / R;
    float2 wr[R / 2 + 1];
    if constexpr (R > 1) {
#pragma unroll
        for (int j = 0; j <= R / 2; ++j) wr[j] = __ldg(tw + (R - 1) + j);
    }
    const int df = NTHREADS / nb, dj = NTHREADS % nb;
    int f = threadIdx.x / nb, j = threadIdx.x % nb;
    while (f < nf) {
        float2 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = make_float2(0.f, 0.f);
        for (int i = 0; i < avg; ++i) {
            const float2* row = src.row(t0 + f + i) + j;
            const bool live = src.live(t0 + f + i);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float2 x = __ldg(row + r * nb);
                wfma(__ldg(w + i * n + j + r * nb),
                     live ? x : make_float2(0.f, 0.f), v[r]);
            }
        }
        if constexpr (R > 1) dft<R>(v, wr);
        float2* dst = b + f * n + j * R;
#pragma unroll
        for (int r = 0; r < R; ++r) dst[r] = v[r];
        f += df;
        j += dj;
        if (j >= nb) {
            j -= nb;
            ++f;
        }
    }
}

// The tile's pre-sum into a, folding in the first pass where its radix
// has a register butterfly: the passes done.
template <class Src>
__device__ __forceinline__ int presum(const Src& src,
                                      const float* __restrict__ w, int t0,
                                      int nf, int n, int avg,
                                      const Plan& plan,
                                      const float2* __restrict__ table,
                                      float2* a) {
#define SDR_PRESUM_PASS(R) \
    case R: presum_pass<R>(src, w, t0, nf, n, avg, table, a); return 1;
    switch (plan.passes ? plan.radix[0] : 0) {
        SDR_PRESUM_PASS(16) SDR_PRESUM_PASS(10) SDR_PRESUM_PASS(8)
        SDR_PRESUM_PASS(6) SDR_PRESUM_PASS(5) SDR_PRESUM_PASS(4)
        SDR_PRESUM_PASS(3) SDR_PRESUM_PASS(7) SDR_PRESUM_PASS(2)
    }
#undef SDR_PRESUM_PASS
    presum_pass<1>(src, w, t0, nf, n, avg, table, a);
    return 0;
}

// Position p of a scrambled spectrum holds bin (p / n2) + n1 (p % n2).
__device__ __forceinline__ int scrambled_bin(int p, int n1, int n2) {
    const int k1 = p / n2;
    return k1 + n1 * (p - k1 * n2);
}

// The tile's nf spectra (a, natural order) to `out`, its first frame's
// row: one contiguous run of nf*n bins, 16-byte stores when `vec`.
template <bool kScrambled>
__device__ __forceinline__ void store(const float2* a,
                                      float2* __restrict__ out, int nf,
                                      int n, int n1, int n2, bool vec) {
    if (vec) {
        const int h = n >> 1;
        for (int e = threadIdx.x; e < nf * h; e += NTHREADS) {
            float4 v;
            if (kScrambled) {
                const int f = e / h;
                const int p = 2 * (e - f * h);
                const float2 u0 = a[f * n + scrambled_bin(p, n1, n2)];
                const float2 u1 = a[f * n + scrambled_bin(p + 1, n1, n2)];
                v = make_float4(u0.x, u0.y, u1.x, u1.y);
            } else {
                v = reinterpret_cast<const float4*>(a)[e];
            }
            reinterpret_cast<float4*>(out)[e] = v;
        }
        return;
    }
    for (int e = threadIdx.x; e < nf * n; e += NTHREADS) {
        if (kScrambled) {
            const int f = e / n;
            out[e] = a[f * n + scrambled_bin(e - f * n, n1, n2)];
        } else {
            out[e] = a[e];
        }
    }
}

template <class Src, bool kScrambled>
__global__ void __launch_bounds__(NTHREADS)
channelizer_kernel(Src src, const float* __restrict__ w,
                   const float2* __restrict__ table,
                   const __grid_constant__ Plan plan,
                   float2* __restrict__ out, float2* scratch, int ft, int n1,
                   int n2, int avg, int vec) {
    extern __shared__ float4 smem[];
    const int n = plan.n;
    float2* const buf0 = scratch ? scratch + (size_t)blockIdx.x * 2 * ft * n
                                 : reinterpret_cast<float2*>(smem);
    float2* const buf1 = buf0 + ft * n;
    const int tiles = (src.T + ft - 1) / ft;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int t0 = tile * ft;
        const int nf = min(ft, src.T - t0);
        float2* const o = out + (size_t)t0 * n;
        int p = presum(src, w, t0, nf, n, avg, plan, table, buf0);
        __syncthreads();
        float2 *a = buf0, *b = buf1;
        for (; p < plan.passes; ++p) {
            // the last pass writes natural order: straight to `out`
            const bool last = !kScrambled && p == plan.passes - 1;
            fft_pass(plan, p, table, a, last ? o : b, nf);
            if (last) break;
            __syncthreads();
            float2* c = a;
            a = b;
            b = c;
        }
        if (p == plan.passes)
            store<kScrambled>(a, o, nf, n, n1, n2, vec);
        __syncthreads();            // buf0 is written again next tile
    }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The plan from the wrapper's radices (product n), or false.
bool make_plan(const int* radices, int passes, int n, Plan* plan) {
    if (passes < 0 || passes > MAX_PASSES || n <= 0) return false;
    plan->n = n;
    plan->passes = passes;
    long long ns = 1, off = 0;
    for (int p = 0; p < passes; ++p) {
        const int R = radices[p];
        if (R < 2) return false;
        plan->radix[p] = R;
        plan->ns[p] = (int)ns;
        plan->off[p] = (int)off;
        off += ns * (R - 1) + R;
        ns *= R;
        if (ns > n) return false;
    }
    return ns == n;
}

// Launch over the block's T frames.
template <class Src, bool kScrambled = false>
int launch(const Src& src, const void* w, const void* table,
           const int* radices, int passes, void* out, void* scratch,
           int nscratch, int n1, int n2, int avg, void* stream) {
    Plan plan;
    if (!make_plan(radices, passes, n1 * n2, &plan) || src.T <= 0)
        return (int)cudaErrorInvalidValue;
    const int n = plan.n;
    const int smem = smem_bytes(n);
    const int ft = smem ? tile_frames(n) : 1;
    const int tiles = (src.T + ft - 1) / ft;
    int grid = tiles;
    if (!smem) {                    // buffers in device memory
        if (scratch == nullptr || nscratch < 1)
            return (int)cudaErrorInvalidValue;
        grid = nscratch < tiles ? nscratch : tiles;
    }
    // 16-byte stores of the tile's run: an even n, aligned buffers
    const bool vec = n % 2 == 0 && aligned16(out) &&
                     (scratch == nullptr || aligned16(scratch));
    // the carveout stays at its default: the least shared memory for the
    // resident blocks leaves L1 the most room for the pre-sum's avg
    // re-reads of each row (the most shared memory leaves it 28 KB, and
    // those reads go to L2)
    const cudaError_t e = cudaFuncSetAttribute(
        channelizer_kernel<Src, kScrambled>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    channelizer_kernel<Src, kScrambled>
        <<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
            src, (const float*)w, (const float2*)table, plan, (float2*)out,
            (float2*)scratch, ft, n1, n2, avg, (int)vec);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdr_channelizer_frame_tile() { return FT_MAX; }

extern "C" int sdr_channelizer_smem_bytes(int nfft) {
    return nfft > 0 ? smem_bytes(nfft) : -1;
}

// Streamed block x (T, nfft), or its one frame with const_x, after the
// spare (avg-1, nfft).  table / radices / passes: the FFT plan of nfft
// = n1*n2; scratch: nscratch pairs of (nfft) buffers where
// sdr_channelizer_smem_bytes(nfft) is 0, else null.
extern "C" int sdr_channelizer(const void* x, const void* spare,
                               const void* w, const void* table,
                               const int* radices, int passes, void* out,
                               void* scratch, int nscratch, int T, int n1,
                               int n2, int avg, int const_x, void* stream) {
    if ((long long)(T + avg - 1) * n1 * n2 >= (1LL << 31))   // int offsets
        return (int)cudaErrorInvalidValue;
    const Streamed src{(const float2*)x, (const float2*)spare, T, avg - 1,
                       n1 * n2, const_x};
    return launch(src, w, table, radices, passes, out, scratch, nscratch,
                  n1, n2, avg, stream);
}

// Streamed block x (T, nfft) after the spare (avg-1, nfft), spectra in
// the scrambled order k1*n2 + k2.
extern "C" int sdr_channelizer_scrambled(const void* x, const void* spare,
                                         const void* w, const void* table,
                                         const int* radices, int passes,
                                         void* out, void* scratch,
                                         int nscratch, int T, int n1, int n2,
                                         int avg, void* stream) {
    if ((long long)(T + avg - 1) * n1 * n2 >= (1LL << 31))   // int offsets
        return (int)cudaErrorInvalidValue;
    const Streamed src{(const float2*)x, (const float2*)spare, T, avg - 1,
                       n1 * n2, 0};
    return launch<Streamed, true>(src, w, table, radices, passes, out,
                                  scratch, nscratch, n1, n2, avg, stream);
}

// Frames [base, base + T) of a (total_frames, nfft) recording.
extern "C" int sdr_channelizer_at(const void* rec, const void* w,
                                  const void* table, const int* radices,
                                  int passes, void* out, void* scratch,
                                  int nscratch, long long total_frames,
                                  long long base, int T, int n1, int n2,
                                  int avg, int valid, void* stream) {
    const int nfft = n1 * n2, lead = avg - 1;
    if (total_frames <= 0 || base < 0 || base + T > total_frames ||
        (long long)(T + lead) * nfft >= (1LL << 31))   // int row offsets
        return (int)cudaErrorInvalidValue;
    const float2* x = (const float2*)rec;
    if (total_frames < lead)
        return launch(RecordedShort{{x, nullptr, total_frames, base, T, lead,
                                     nfft, valid}, T},
                      w, table, radices, passes, out, scratch, nscratch, n1,
                      n2, avg, stream);
    const Recorded src{x + base * nfft, x + (base + total_frames) * nfft, T,
                       lead, nfft, base < lead ? (int)(lead - base) : 0,
                       valid};
    return launch(src, w, table, radices, passes, out, scratch, nscratch, n1,
                  n2, avg, stream);
}

// Block `blk` (frames [blk*T, (blk+1)*T)) of one time shard's span of
// span_frames frames, its avg-1 halo frames the staged (nblk, avg-1,
// nfft) array's row blk.
extern "C" int sdr_channelizer_at_halo(const void* span, const void* staged,
                                       const void* w, const void* table,
                                       const int* radices, int passes,
                                       void* out, void* scratch,
                                       int nscratch, long long span_frames,
                                       long long blk, int T, int n1, int n2,
                                       int avg, int valid, void* stream) {
    const int nfft = n1 * n2, lead = avg - 1;
    if (blk < 0 || (blk + 1) * T > span_frames ||
        (long long)(T + lead) * nfft >= (1LL << 31))   // int row offsets
        return (int)cudaErrorInvalidValue;
    const Staged src{(const float2*)span + blk * T * nfft,
                     (const float2*)staged + blk * lead * nfft, T, lead,
                     nfft, valid};
    return launch(src, w, table, radices, passes, out, scratch, nscratch, n1,
                  n2, avg, stream);
}
