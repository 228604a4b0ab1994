// The tensor-core mainloop of the fold and the chain (csrc/tc.cuh) alone,
// on one H100: operands resident in shared memory (A 64 x 100 complex
// rows per group of 8 warps, G 100 x 100 complex), 200 tiles a group, the
// sums written out, timed with CUDA events.  Four forms: the three-pass
// mainloop, one pass without the split, mma.sync alone on fixed
// fragments, and the mainloop with A rotated as its fragments load; each
// with one and two groups a block (8 and 16 warps).  TFLOP/s counts the
// TF32 products (2048 operations an m16n8k8).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o gpu_sdr_tpu_torch/_build/mainloop \
//       gpu_sdr_tpu_torch/bench/mainloop.cu && gpu_sdr_tpu_torch/_build/mainloop

#include <cuda_runtime.h>
#include <cstdio>
#include "../csrc/tc.cuh"
using namespace tc;

template <int kMode>  // 0: tc::mainloop; 1: one pass; 2: mma only; 3: mainloop, A rotated
__global__ void __launch_bounds__(512, 1) bench(float* out, int iters, int groups) {
    extern __shared__ float4 sm4[];
    float* sm = (float*)sm4;
    const int CNs = 100, AS = 204;
    float* b = sm;                       // 100 x 100 complex
    float* a = sm + 20000 + (threadIdx.x / 256) * 64 * AS;
    for (int i = threadIdx.x; i < 20000 + groups * 64 * AS; i += blockDim.x)
        sm[i] = 1.0f + 1e-3f * (i % 97);
    __syncthreads();
    const int tid = threadIdx.x & 255, warp = tid >> 5;
    const int wm = warp & 3, wn = warp >> 2, jn0 = wn * kNF;
    const int nfw = min(kNF, 25 - jn0);
    float acc[kNF][4];
    for (int j = 0; j < kNF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int it = 0; it < iters; ++it) {
        if (kMode == 0) {
            mainloop<false, false>(acc, a + wm * 16 * AS, AS, b + 8 * jn0, CNs, nullptr, 100, nfw);
        } else if (kMode == 3) {
            mainloop<true, false>(acc, a + wm * 16 * AS, AS, b + 8 * jn0, CNs,
                                  reinterpret_cast<const float2*>(b), 100, nfw);
        } else if (kMode == 1) {
            const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
            const float* ap = a + wm * 16 * AS + g * AS + q;
            const float* bp = b + 8 * jn0 + (q >> 1) * 2 * CNs + 2 * (g >> 1) + ((q ^ g) & 1);
            for (int k = 0; k < 100; k += 4) {
                const float* p = ap + 2 * k;
                uint32_t ab[4] = {__float_as_uint(p[0]), __float_as_uint(p[8 * AS]),
                                  __float_as_uint(p[4]), __float_as_uint(p[8 * AS + 4])};
                const float* bk = bp + k * 2 * CNs;
#pragma unroll
                for (int j = 0; j < kNF; ++j)
                    if (j < nfw)
                        mma(acc[j], ab, __float_as_uint(bk[8 * j]), __float_as_uint(bk[8 * j + 4 * CNs]));
            }
        } else {
            uint32_t ab[4] = {1, 2, 3, 4};
            for (int k = 0; k < 100; k += 4) {
#pragma unroll
                for (int j = 0; j < kNF; ++j)
                    if (j < nfw) {
                        mma(acc[j], ab, 5, 6); mma(acc[j], ab, 7, 8); mma(acc[j], ab, 9, 10);
                    }
            }
        }
    }
    float s = 0.f;
    for (int j = 0; j < kNF; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kMode>
void run(const char* name, int groups, float* out, int iters) {
    const int smem = (20000 + groups * 64 * 204) * 4;
    cudaFuncSetAttribute(bench<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    bench<kMode><<<132, 256 * groups, smem>>>(out, 2, groups);
    cudaEventRecord(a);
    bench<kMode><<<132, 256 * groups, smem>>>(out, iters, groups);
    cudaEventRecord(b); cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b);
    // mma a tile of a group: 25 k-steps x 3 passes x the column fragments
    // of its warps (4 over the rows by 13 + 12 over the channels: 100)
    const double mma = 132.0 * groups * iters * (25 * 3 * 100) / (kMode == 1 ? 3 : 1);
    printf("%s groups %d: %.4f ms for %d tiles/group, %.3f ms per 4.73 tiles/SM-equivalent, %.1f TFLOP/s tf32 mma (%s)\n",
           name, groups, ms, iters, ms / (iters * groups) * 4.73, mma * 2048 / ms / 1e9,
           cudaGetErrorString(cudaGetLastError()));
}

int main() {
    float* out; cudaMalloc(&out, 132 * 512 * 4);
    for (int g = 1; g <= 2; ++g) {
        run<0>("3-pass mainloop", g, out, 200);
        run<1>("1-pass, no split", g, out, 200);
        run<2>("mma only", g, out, 200);
        run<3>("3-pass mainloop, A rotated", g, out, 200);
    }
    return 0;
}
