// RAFT correlation window lookup (4 pyramid levels, radius 4), sm_90a.
//
// Replaces the TPU kernel comfyui_propainter_nodes_tpu/ops/pallas/corr_lanes.py
// (`_kernel`, launched by `_level_lookup`, driven by `corr_lookup_lanes`).
//
// What it computes: for every query pixel of every image and every level l,
// the 9x9 bilinear samples of that pixel's correlation map around
// coords / 2^l, with zero for taps outside the map (grid_sample zeros
// padding, align_corners=True), accumulated in fp32. Output channel order
// is (level, dx, dy): the reference stacks meshgrid(dy, dx) onto (x, y)
// coords (RAFT corr.py:37-43), so channel i*9 + j samples offset
// (dx = i - 4, dy = j - 4); the update block's weights depend on it.
//
// Layout: the natural GPU (pixel-major) pyramid, level l is
// [n_pix, H_l, W_l] in fp32 or bf16; coords [n_pix, 2] fp32 as (x, y);
// out [n_pix, 4 * 81] fp32. The TPU kernel's pixel-minor volume and
// scalar-prefetched y-blocks exist only to put pixels on the TPU's lanes.
//
// What bounds it on the H100: bytes. Each output costs 4 loads and a few
// flops, so the work is far below the card's ~295 flop/byte ridge; the
// least traffic is each pixel's 10x10 window per level read once plus the
// [n_pix, 324] fp32 result written once.
//
// Design: one thread per output element, in output order, so the 324
// outputs of a pixel are written by consecutive threads (fully coalesced
// stores, which are the larger share of the bytes). The 4 corner loads of
// neighbouring taps hit the same 10x10 window and are served from L1.
// Each corner is checked on its own, so windows partly or wholly outside
// the map read exact zeros, and odd level sizes (45 -> 22 -> 11 -> 5) need
// no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Levels {
  const void* map[4];
  int h[4];
  int w[4];
};

template <typename T>
__global__ void __launch_bounds__(256)
corr_lookup_kernel(Levels lv, const float* __restrict__ coords,
                   float* __restrict__ out, long long total) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int r = (int)(o % 324);
  const long long pix = o / 324;
  const int lvl = r / 81;
  const int rem = r - lvl * 81;
  const int i = rem / 9;      // dx tap
  const int j = rem - i * 9;  // dy tap
  const int hl = lv.h[lvl];
  const int wl = lv.w[lvl];
  const T* m = reinterpret_cast<const T*>(lv.map[lvl]) + pix * (long long)hl * wl;

  const float inv = 1.0f / (float)(1 << lvl);
  const float cx = coords[2 * pix] * inv;
  const float cy = coords[2 * pix + 1] * inv;
  // clamp before the int conversion: far-away centroids read zeros anyway
  const float x0f = fminf(fmaxf(floorf(cx), -1.0e6f), 1.0e6f);
  const float y0f = fminf(fmaxf(floorf(cy), -1.0e6f), 1.0e6f);
  const float fx = cx - floorf(cx);
  const float fy = cy - floorf(cy);
  const int x = (int)x0f - 4 + i;
  const int y = (int)y0f - 4 + j;

  const bool x0ok = x >= 0 && x < wl;
  const bool x1ok = x + 1 >= 0 && x + 1 < wl;
  const bool y0ok = y >= 0 && y < hl;
  const bool y1ok = y + 1 >= 0 && y + 1 < hl;
  const long long r0 = (long long)y * wl;
  const long long r1 = r0 + wl;
  const float v00 = (y0ok && x0ok) ? to_f(m[r0 + x]) : 0.0f;
  const float v01 = (y0ok && x1ok) ? to_f(m[r0 + x + 1]) : 0.0f;
  const float v10 = (y1ok && x0ok) ? to_f(m[r1 + x]) : 0.0f;
  const float v11 = (y1ok && x1ok) ? to_f(m[r1 + x + 1]) : 0.0f;
  // rows first, then columns (the order of the JAX slice-window path)
  const float va = v00 * (1.0f - fy) + v10 * fy;
  const float vb = v01 * (1.0f - fy) + v11 * fy;
  out[o] = va * (1.0f - fx) + vb * fx;
}

}  // namespace

extern "C" int propainter_corr_lookup(
    const void* m0, const void* m1, const void* m2, const void* m3,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
    const void* coords, void* out, long long n_pix, int is_bf16,
    void* stream) {
  Levels lv;
  lv.map[0] = m0; lv.map[1] = m1; lv.map[2] = m2; lv.map[3] = m3;
  lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
  lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
  const long long total = n_pix * 324;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    if (is_bf16) {
      corr_lookup_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
          lv, reinterpret_cast<const float*>(coords),
          reinterpret_cast<float*>(out), total);
    } else {
      corr_lookup_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
          lv, reinterpret_cast<const float*>(coords),
          reinterpret_cast<float*>(out), total);
    }
  }
  return (int)cudaGetLastError();
}
