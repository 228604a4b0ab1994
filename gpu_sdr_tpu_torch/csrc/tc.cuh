// The complex tensor-core mainloop of the fold (fold.cu) and the chain
// (chain.cu): a block's rows times a resident complex constant, on
// Hopper's tensor cores in TF32 with a three-pass split, FP32 sums.
//
// The product.  A complex64 row (re0, im0, re1, im1, ...) is a real row
// of length 2*Ct, and a complex constant G (Ct, Cp) is the real
// (2*Ct, 2*Cp) matrix B whose 2x2 block at (t, c) is [[Gr, Gi], [-Gi,
// Gr]]: the real product of the two comes out interleaved, (Re, Im) per
// channel, as complex64 wants it.  This is the real embedding, four
// real products per complex MAC; Karatsuba's three would save a quarter
// of the tensor-core work at the price of a cancelling sum (the TPU
// kernels' 92.8 dB) and of three operand planes.  B is never stored:
// shared memory holds G as complex64, and each lane reads the one real
// part of B its mma.sync fragment wants, at row k = 2t + dt and column
// n = 2c + dc: Gr where dt == dc, Gi where dt != dc, negated where dt = 1
// and dc = 0.  In the m16n8k8 fragment dt and dc are fixed per lane
// (lane & 1, (lane >> 2) & 1), so the selection is a fixed offset and
// the sign one XOR.
//
// The split.  TF32 keeps 10 of FP32's 23 mantissa bits, one pass 70-75
// dB.  Each operand x is split as big = rna(x) and small = rna(x - big),
// rna the rounding of cvt.rna.tf32.f32 (done on the bits: to_tf32), with
// x - big formed from the rounded big (the tensor core drops an
// unrounded operand's low 13 bits), and the sum is small*big + big*small
// + big*big: about 22 bits of each operand, ~2^-22 per product
// (tests/test_torch_tf32_split.py rehearses it bit for bit on the CPU;
// the measured SNR is in PERF.md).  The split
// is formed when the fragments load, from FP32 operands in shared
// memory: A's fragments are used for every column fragment of a warp, so
// their split is amortised, and shared memory holds one FP32 copy of
// each operand, not two.  The tensor core's FP32 accumulation does not
// round to nearest, and its error grows with the additions into one
// accumulator: 118.8 dB for the fold's 25 steps of k = 8, three passes
// each; 65.6 dB for the chain at f 1000 (75,000 additions; PERF.md).  So
// a product deeper than one tap is summed into the tensor core per tap
// and the taps' sums in FP32 registers (chain.cu).
//
// mma.sync and not wgmma: wgmma wants both TF32 operands K-major in
// shared memory in its swizzled layouts, which a per-lane selection of
// B's parts and a split at fragment load cannot give; mma.sync takes
// registers.  Its TF32 rate on Hopper is below wgmma's, but a fold's
// product is small (3.25 GFLOP a block) and its bytes bound is near.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

constexpr int kRows = 64;         // rows of a tile: 4 warps of 16 rows
// the fold's group of warps: 4 over the rows by kWarpsN over a chunk's
// channels, kNF column fragments (4 channels) each
constexpr int kWarpsN = 2;
constexpr int kNF = 13;
constexpr int kChanMax = kWarpsN * kNF * 4;   // channels per chunk (104)
constexpr int kThreads = 4 * kWarpsN * 32;    // a group of 8 warps (256)
constexpr int kSmemMax = 232448;  // a block's shared memory with the opt-in
constexpr int kTPitch = kRows + 4;            // pitch of a transposed table

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// cvt.rna.tf32.f32 on the bits: half a TF32 ulp added to the magnitude,
// the low 13 bits cleared (round to nearest, ties away from zero; the
// same bits for finite x, in two integer operations)
__device__ __forceinline__ uint32_t to_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32, small from the rounded big
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
}

// d += a * b, m16n8k8, TF32 in, FP32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (u, w) with (x + iy) * r's part `part` (0: real, 1: imaginary) = x*u
// + y*w: a complex rotation applied to one real part of an operand
__device__ __forceinline__ float2 rot_coef(float2 r, int part) {
    return part ? make_float2(r.y, r.x) : make_float2(r.x, -r.y);
}

__device__ __forceinline__ float rot_part(float2 v, float2 uw) {
    return fmaf(v.x, uw.x, v.y * uw.y);
}

// acc[j] += A (16 rows from `a`, pitch `pa` floats, interleaved complex)
// times G's column fragments j < nfw <= kN (from `b`, complex, pitch `pb`
// complex, already offset to the warp's first fragment), over `tones`
// tones (a multiple of 4).  kRotA: A's tone t is taken times rot[t];
// kRotB: G's tone row t is (rot[t] * G[t, c]); the rotation is applied
// to the FP32 operand as its fragment loads, before the split.  Pass
// order small*big, big*small, big*big.  kUnroll: steps of k unrolled
// (the chain's short items: 2).
template <bool kRotA, bool kRotB, int kN = kNF, int kUnroll = 1>
__device__ __forceinline__ void mainloop(float (&acc)[kN][4],
                                         const float* __restrict__ a,
                                         int pa, const float* __restrict__ b,
                                         int pb, const float2* rot,
                                         int tones, int nfw) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int part = q & 1;                 // A's real part, B's row parity
    const int sel = (q ^ g) & 1;            // B's part: Gr or Gi
    // lane's A value: row g, tone (q >> 1), part q & 1 (a whole complex
    // when it is rotated); lane's B part: tone (q >> 1), channel (g >> 1)
    const float* ap = a + g * pa + (kRotA ? 2 * (q >> 1) : q);
    const float* bp = b + (q >> 1) * 2 * pb + 2 * (g >> 1) + (kRotB ? 0 : sel);
    const uint32_t neg = (q & 1) && !(g & 1) ? 0x80000000u : 0u;
    const int b2 = 4 * pb;                  // two tones on, in floats
#pragma unroll (kUnroll)
    for (int k = 0; k < tones; k += 4) {
        const float* p = ap + 2 * k;
        float av[4];
        if (kRotA) {
            const float2 u0 = rot_coef(rot[k + (q >> 1)], part);
            const float2 u2 = rot_coef(rot[k + (q >> 1) + 2], part);
            av[0] = rot_part(*reinterpret_cast<const float2*>(p), u0);
            av[1] = rot_part(*reinterpret_cast<const float2*>(p + 8 * pa), u0);
            av[2] = rot_part(*reinterpret_cast<const float2*>(p + 4), u2);
            av[3] = rot_part(*reinterpret_cast<const float2*>(p + 8 * pa + 4),
                             u2);
        } else {
            av[0] = p[0];
            av[1] = p[8 * pa];
            av[2] = p[4];
            av[3] = p[8 * pa + 4];
        }
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(av[i], ab[i], as[i]);
        float2 w0, w2;
        if (kRotB) {
            w0 = rot_coef(rot[k + (q >> 1)], sel);
            w2 = rot_coef(rot[k + (q >> 1) + 2], sel);
        }
        const float* bk = bp + k * 2 * pb;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
            if (j < nfw) {
                float v0, v1;
                if (kRotB) {
                    v0 = rot_part(*reinterpret_cast<const float2*>(bk + 8 * j),
                                  w0);
                    v1 = rot_part(
                        *reinterpret_cast<const float2*>(bk + 8 * j + b2), w2);
                } else {
                    v0 = bk[8 * j];
                    v1 = bk[8 * j + b2];
                }
                uint32_t bb0, bs0, bb1, bs1;
                split(__uint_as_float(__float_as_uint(v0) ^ neg), bb0, bs0);
                split(__uint_as_float(__float_as_uint(v1) ^ neg), bb1, bs1);
                mma(acc[j], as, bb0, bb1);
                mma(acc[j], ab, bs0, bs1);
                mma(acc[j], ab, bb0, bb1);
            }
        }
    }
}

// 8 bytes from global to shared memory, zero-filled where `bytes` is 0
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(kPending));
}

// The fold's shared-memory plan: channels per chunk and their pitch,
// tones per chunk and A's pitch, bytes of each region, groups of warps.
struct Plan {
    int CN;      // channels per chunk (a multiple of 4), grid.y chunks
    int CNs;     // their pitch in complex, = 4 mod 16: conflict-free
    int nc;      // channel chunks
    int KC;      // tones per pass over K (a multiple of 4)
    int nk;      // passes over K
    int AS;      // A's pitch in floats, 2*KC + 4 (= 4 mod 8)
    int bfl;     // floats of one G region (KC x CNs complex)
    int afl;     // floats of one A region (rows x AS)
    int rfl;     // floats of the fold's ramp table (0: read from memory)
    int vfl;     // floats of a group's rotation vectors
    int smem;    // bytes in all
    int groups;  // groups of kThreads a block
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A kernel instance's launch facts per device, found once: the shared
// memory it was last opted into, with the thread count, and how many
// blocks of that size the card holds at once.
struct LaunchCache {
    static constexpr int kDevices = 64;
    int smem[kDevices] = {}, threads[kDevices] = {}, blocks[kDevices] = {};
};

// Opt `kernel` into `smem` bytes of shared memory and return in *blocks
// how many blocks of `threads` fit the card at once; cached per device.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, LaunchCache& cache, int threads,
                            int smem, int* blocks) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool cached = dev < LaunchCache::kDevices;
    if (cached && cache.smem[dev] == smem && cache.threads[dev] == threads) {
        *blocks = cache.blocks[dev];
        return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, smem);
    if (err != cudaSuccess) return err;
    *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
    if (cached) {
        cache.smem[dev] = smem;
        cache.threads[dev] = threads;
        cache.blocks[dev] = *blocks;
    }
    return cudaSuccess;
}

// nc channel chunks, balanced (nc at least ceil(Cp / kChanMax))
inline void channel_plan(int Cp, int nc, Plan& p) {
    p.nc = nc;
    p.CN = round_up((Cp + p.nc - 1) / p.nc, 4);
    p.CNs = p.CN + ((4 - p.CN) % 16 + 16) % 16;
}

// tones per pass when K is cut into nk passes
inline void tone_plan(int Ct, int nk, Plan& p) {
    p.nk = nk;
    p.KC = round_up((round_up(Ct, 4) / 4 + nk - 1) / nk * 4, 4);
    p.AS = 2 * p.KC + 4;
    p.bfl = p.KC * p.CNs * 2;
}

}  // namespace tc
