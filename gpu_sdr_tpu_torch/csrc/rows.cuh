// The extended rows of one block: its lead history rows, then its nb
// rows.  Shared by ddc.cu (rows of M samples, lead f - 1), presum.cu and
// channelizer.cu (frames of nfft samples, lead avg - 1).
//
// Three ways to address them:
//   (a) streamed block: history rows from `hist`, block rows from `x`
//       (`base` 0, `valid` 1);
//   (b) resident recording (`hist` null): `x` holds x_rows rows and the
//       block starts at row `base`; its history rows are the rows before
//       it, wrapped mod x_rows (the loop seam), and zero when `valid` is
//       0 (the stream's first block).  Rows are read in place: nothing is
//       copied out of the recording first.
//   (c) one time shard's span of a resident recording: `x` holds the
//       shard's rows (its span of every block, block after block) and
//       the block starts at row `base`; its history rows are `hist`'s,
//       the rows before the span in stream order, staged at upload
//       (they lie on the previous shard, or in the previous block), and
//       zero when `valid` is 0.  Body rows are read in place.
// Row offsets are 64-bit: a 2 GiB recording holds 268M samples.

#pragma once

#include <cuda_runtime.h>

namespace {

struct Rows {
    const float2* x;      // block rows (a) or the whole recording (b)
    const float2* hist;   // (a), (c): lead history rows; (b): nullptr
    long long x_rows;     // rows in x
    long long base;       // row of x where the block starts
    int nb;               // rows of the block
    int lead;             // history rows before it
    int M;                // samples per row
    int valid;            // (b), (c): history rows are the stream's
};

// Extended row g (0 <= g < nb + lead) of the block, column m.
__device__ __forceinline__ float2 sample(const Rows& in, long long g, int m) {
    if (g >= in.nb + in.lead) return make_float2(0.f, 0.f);   // past the block
    const long long r = g - in.lead;
    if (r >= 0) return in.x[(in.base + r) * in.M + m];
    if (!in.valid) return make_float2(0.f, 0.f);
    if (in.hist != nullptr) return in.hist[g * in.M + m];
    long long w = in.base + r;
    if (w < 0) {                      // before the recording's first row:
        w %= in.x_rows;               // wrapped at the loop seam
        if (w < 0) w += in.x_rows;
    }
    return in.x[w * in.M + m];
}

// Extended row g (0 <= g < nb + lead) of the block: the address of its
// first sample, or nullptr where it stands for zeros (past the block, or a
// history row when `valid` is 0).  sample()'s rule, resolved once for all
// of a row's samples.
__device__ __forceinline__ const float2* row_ptr(const Rows& in,
                                                 long long g) {
    if (g >= in.nb + in.lead) return nullptr;                 // past the block
    const long long r = g - in.lead;
    if (r >= 0) return in.x + (in.base + r) * in.M;
    if (!in.valid) return nullptr;
    if (in.hist != nullptr) return in.hist + g * in.M;
    long long w = in.base + r;
    if (w < 0) {                      // before the recording's first row:
        w %= in.x_rows;               // wrapped at the loop seam
        if (w < 0) w += in.x_rows;
    }
    return in.x + w * in.M;
}

}  // namespace
