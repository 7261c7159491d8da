// Modulated deformable convolution (DCNv2), 3x3, stride 1, pad 1, sm_90a.
//
// Replaces the TPU kernel comfyui_propainter_nodes_tpu/ops/pallas/deform_conv.py
// (`_kernel`, launched by `deform_conv2d_pallas`, dispatched from
// ops/deform_conv.py::deform_conv2d).
//
// What it computes: out[p, co] = bias[co] + sum_{k, ci} w[k, ci, co] *
// mask[p, g, k] * bilinear(x[:, :, ci], p + tap_k + offset[p, g, k]) with
// g = ci / (Cin / G), offsets in torchvision's (dy, dx) pair order, and
// each of the 4 bilinear corners zero when it falls outside the image.
//
// Layout: x [N, H, W, Cin] (NHWC, channels contiguous), offset
// [N, H, W, G, 9, 2], mask [N, H, W, G, 9], all fp32 or bf16; weight
// re-laid out once by the wrapper to [9 * Cin, Cout] fp32 (tap outer,
// channel inner); bias fp32; out [N, H, W, Cout] in the input type.
//
// What bounds it on the H100: at the feature-propagation shape (x [5, 90,
// 160, 128], Cout 128) one call is 2*72000*1152*128 = 21.2 GFLOP against
// ~99 MB of x, offsets (16 groups x 27 values per pixel, the largest
// input), mask and output in bf16: ~214 flop/byte, below the bf16
// tensor-core ridge (~295), so bytes; the flow-completion shape (x [2,
// 45, 80, 256]) is 4.2 GFLOP against ~12 MB, ~360 flop/byte, so
// operations. On the CUDA cores (fp32 FMAs, as here) both are bound by
// operations.
//
// Design: implicit GEMM. A block owns a tile of 64 output pixels x 128
// output channels and walks the K = 9 * Cin reduction in chunks of one
// tap x 32 channels: it gathers the chunk's bilinear, masked samples into
// shared memory (threads on consecutive channels, so the NHWC reads are
// coalesced), stages the matching [32, 128] weight slice beside them, and
// each thread accumulates a 4 x 8 register tile with fp32 FMAs. No
// sample matrix ever reaches device memory. This first version uses the
// CUDA cores; wgmma on the tensor cores is the follow-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 128;   // output channels per block
constexpr int KC = 32;    // input channels per K chunk (one tap)
constexpr int NT = 256;   // threads per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(NT)
deform_conv_kernel(const T* __restrict__ x, const T* __restrict__ off,
                   const T* __restrict__ msk, const float* __restrict__ wt,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int N, int H, int W, int Cin, int Cout, int G) {
  __shared__ float s_a[KC][BM + 1];
  __shared__ __align__(16) float s_b[KC][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // output channels tx*8 .. tx*8+7
  const int ty = tid >> 4;   // output pixels ty*4 .. ty*4+3
  const long long M = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int HW = H * W;
  const int cg = Cin / G;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < 9; ++k) {
    const int ki = k / 3;
    const int kj = k - ki * 3;
    for (int c0 = 0; c0 < Cin; c0 += KC) {
      // gather: 64 pixels x 32 channels of masked bilinear samples
#pragma unroll
      for (int rep = 0; rep < (BM * KC) / NT; ++rep) {
        const int idx = tid + rep * NT;
        const int c = idx % KC;
        const int px = idx / KC;
        const long long p = m0 + px;
        const int ci = c0 + c;
        float val = 0.0f;
        if (p < M && ci < Cin) {
          const int n = (int)(p / HW);
          const int rem = (int)(p - (long long)n * HW);
          const int py = rem / W;
          const int pxx = rem - py * W;
          const int g = ci / cg;
          const long long pg = p * G + g;
          const float dy = to_f(off[pg * 18 + 2 * k]);
          const float dx = to_f(off[pg * 18 + 2 * k + 1]);
          const float mk = to_f(msk[pg * 9 + k]);
          const float sy = (float)(py + ki - 1) + dy;
          const float sx = (float)(pxx + kj - 1) + dx;
          const float y0 = floorf(sy);
          const float x0 = floorf(sx);
          const float wy1 = sy - y0, wx1 = sx - x0;
          const float wy0 = 1.0f - wy1, wx0 = 1.0f - wx1;
          const int iy = (int)fminf(fmaxf(y0, -4.0f), (float)H + 4.0f);
          const int ix = (int)fminf(fmaxf(x0, -4.0f), (float)W + 4.0f);
          const T* xb = x + (long long)n * HW * Cin + ci;
          const bool y0ok = iy >= 0 && iy < H;
          const bool y1ok = iy + 1 >= 0 && iy + 1 < H;
          const bool x0ok = ix >= 0 && ix < W;
          const bool x1ok = ix + 1 >= 0 && ix + 1 < W;
          float v = 0.0f;
          if (y0ok && x0ok) v += to_f(xb[((long long)iy * W + ix) * Cin]) * (wy0 * wx0);
          if (y0ok && x1ok) v += to_f(xb[((long long)iy * W + ix + 1) * Cin]) * (wy0 * wx1);
          if (y1ok && x0ok) v += to_f(xb[((long long)(iy + 1) * W + ix) * Cin]) * (wy1 * wx0);
          if (y1ok && x1ok) v += to_f(xb[((long long)(iy + 1) * W + ix + 1) * Cin]) * (wy1 * wx1);
          val = v * mk;
        }
        s_a[c][px] = val;
      }
      // weight slice [KC, BN] of the [9*Cin, Cout] matrix
#pragma unroll
      for (int rep = 0; rep < (KC * BN) / NT; ++rep) {
        const int idx = tid + rep * NT;
        const int co = idx % BN;
        const int c = idx / BN;
        const int ci = c0 + c;
        float wv = 0.0f;
        if (ci < Cin && n0 + co < Cout) wv = wt[((long long)k * Cin + ci) * Cout + n0 + co];
        s_b[c][co] = wv;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < KC; ++c) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_a[c][ty * 4 + i];
        const float4 b0 = *reinterpret_cast<const float4*>(&s_b[c][tx * 8]);
        const float4 b1 = *reinterpret_cast<const float4*>(&s_b[c][tx * 8 + 4]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = m0 + ty * 4 + i;
    if (p >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = n0 + tx * 8 + j;
      if (co < Cout) {
        const float bv = bias != nullptr ? bias[co] : 0.0f;
        store(out + p * Cout + co, acc[i][j] + bv);
      }
    }
  }
}

}  // namespace

extern "C" int propainter_deform_conv(
    const void* x, const void* off, const void* msk, const void* wt,
    const void* bias, void* out, int N, int H, int W, int Cin, int Cout,
    int G, int is_bf16, void* stream) {
  const long long M = (long long)N * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M > 0 && Cout > 0) {
    if (is_bf16) {
      deform_conv_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
          reinterpret_cast<const __nv_bfloat16*>(x),
          reinterpret_cast<const __nv_bfloat16*>(off),
          reinterpret_cast<const __nv_bfloat16*>(msk),
          reinterpret_cast<const float*>(wt),
          reinterpret_cast<const float*>(bias),
          reinterpret_cast<__nv_bfloat16*>(out), N, H, W, Cin, Cout, G);
    } else {
      deform_conv_kernel<float><<<grid, NT, 0, s>>>(
          reinterpret_cast<const float*>(x), reinterpret_cast<const float*>(off),
          reinterpret_cast<const float*>(msk), reinterpret_cast<const float*>(wt),
          reinterpret_cast<const float*>(bias), reinterpret_cast<float*>(out),
          N, H, W, Cin, Cout, G);
    }
  }
  return (int)cudaGetLastError();
}
