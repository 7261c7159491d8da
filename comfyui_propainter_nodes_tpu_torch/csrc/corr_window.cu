// RAFT correlation window lookup from zero-padded maps, sm_90a: one level
// and four levels.
//
// Replaces the TPU kernels in
// comfyui_propainter_nodes_tpu/ops/pallas/corr_lookup.py:
//   * `_kernel` (launched by `corr_window_lookup_pallas`), one level;
//   * `_kernel4_block` (launched by `corr_window_lookup4_pallas`, the RAFT
//     lookup under PROPAINTER_TPU_CORR_KERNEL=pallas), four levels.
//
// What they compute, per pixel p (and level l): the pixel's 10x10 window of
// its own zero-padded correlation map at the integer start (sy, sx), then
// the shared-fraction bilinear combine, rows first and columns second:
//   vy[i][x] = w[i][x] * (1 - fy) + w[i + 1][x] * fy
//   out[i][j] = vy[i][j] * (1 - fx) + vy[i][j + 1] * fx
// in fp32, written in natural (dy, dx) order. Maps are fp32 or bf16; the
// fractions come in as fp32 (the caller has already rounded them to the
// map's type, as the JAX package does).
//
// What bounds them on the H100: bytes. Each output costs four loads and
// six flops; the least traffic is each pixel's 10x10 window read once per
// level plus the [M, 81] fp32 result per level written once.
//
// Design: one thread per output tap, in output order, so the 81 (or 324)
// outputs of a pixel are written by consecutive threads (coalesced stores,
// the larger share of the bytes) and the four corner loads of neighbouring
// taps hit the same window rows in L1. The TPU kernels' DMA rings, lane
// rotations and row-concatenated map blocks exist only to feed the TPU's
// vector lanes and have no counterpart here. The products and sums are
// rounded one by one (no FMA contraction), so the fp32 result equals the
// plain PyTorch version bit for bit. Starts are clamped to [0, Hp-10] and
// [0, Wp-10] in the kernel, so no start can read outside its map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 10;
constexpr int TAPS = 81;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// one tap: rows first (vy), then columns, each product and sum rounded
template <typename T>
__device__ __forceinline__ float tap(const T* __restrict__ map, int hp, int wp,
                                     int sy, int sx, float fy, float fx, int dy, int dx) {
  sy = min(max(sy, 0), hp - WIN);
  sx = min(max(sx, 0), wp - WIN);
  const T* p = map + (long long)(sy + dy) * wp + sx + dx;
  const float v00 = to_f(p[0]), v01 = to_f(p[1]);
  const float v10 = to_f(p[wp]), v11 = to_f(p[wp + 1]);
  const float gy = 1.0f - fy, gx = 1.0f - fx;
  const float vy0 = __fadd_rn(__fmul_rn(v00, gy), __fmul_rn(v10, fy));
  const float vy1 = __fadd_rn(__fmul_rn(v01, gy), __fmul_rn(v11, fy));
  return __fadd_rn(__fmul_rn(vy0, gx), __fmul_rn(vy1, fx));
}

template <typename T>
__global__ void __launch_bounds__(256)
corr_window_kernel(const T* __restrict__ map, const int* __restrict__ sy,
                   const int* __restrict__ sx, const float* __restrict__ fy,
                   const float* __restrict__ fx, float* __restrict__ out,
                   long long total, int hp, int wp) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const long long pix = o / TAPS;
  const int r = (int)(o - pix * TAPS);
  const int dy = r / 9;
  const int dx = r - dy * 9;
  out[o] = tap(map + pix * hp * wp, hp, wp, sy[pix], sx[pix], fy[pix], fx[pix], dy, dx);
}

struct Levels {
  const void* map[4];
  int hp[4];
  int wp[4];
};

// sy/sx/fy/fx are [4, M]; out is [M, 4, 9, 9]
template <typename T>
__global__ void __launch_bounds__(256)
corr_window4_kernel(Levels lv, const int* __restrict__ sy, const int* __restrict__ sx,
                    const float* __restrict__ fy, const float* __restrict__ fx,
                    float* __restrict__ out, long long m) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= m * 4 * TAPS) return;
  const long long pix = o / (4 * TAPS);
  const int r = (int)(o - pix * (4 * TAPS));
  const int lvl = r / TAPS;
  const int t = r - lvl * TAPS;
  const int dy = t / 9;
  const int dx = t - dy * 9;
  const int hp = lv.hp[lvl];
  const int wp = lv.wp[lvl];
  const T* map = reinterpret_cast<const T*>(lv.map[lvl]) + pix * hp * wp;
  const long long i = lvl * m + pix;
  out[o] = tap(map, hp, wp, sy[i], sx[i], fy[i], fx[i], dy, dx);
}

}  // namespace

extern "C" int propainter_corr_window(const void* map, const void* sy, const void* sx,
                                      const void* fy, const void* fx, void* out,
                                      long long m, int hp, int wp, int is_bf16,
                                      void* stream) {
  if (hp < WIN || wp < WIN) return (int)cudaErrorInvalidValue;
  const long long total = m * TAPS;
  const long long blocks = (total + 255) / 256;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const int* y = reinterpret_cast<const int*>(sy);
    const int* x = reinterpret_cast<const int*>(sx);
    const float* a = reinterpret_cast<const float*>(fy);
    const float* b = reinterpret_cast<const float*>(fx);
    float* o = reinterpret_cast<float*>(out);
    if (is_bf16) {
      corr_window_kernel<__nv_bfloat16><<<(unsigned)blocks, 256, 0, s>>>(
          reinterpret_cast<const __nv_bfloat16*>(map), y, x, a, b, o, total, hp, wp);
    } else {
      corr_window_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(
          reinterpret_cast<const float*>(map), y, x, a, b, o, total, hp, wp);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int propainter_corr_window4(const void* m0, const void* m1, const void* m2,
                                       const void* m3, int hp0, int wp0, int hp1, int wp1,
                                       int hp2, int wp2, int hp3, int wp3, const void* sy,
                                       const void* sx, const void* fy, const void* fx,
                                       void* out, long long m, int is_bf16, void* stream) {
  Levels lv;
  lv.map[0] = m0; lv.map[1] = m1; lv.map[2] = m2; lv.map[3] = m3;
  lv.hp[0] = hp0; lv.hp[1] = hp1; lv.hp[2] = hp2; lv.hp[3] = hp3;
  lv.wp[0] = wp0; lv.wp[1] = wp1; lv.wp[2] = wp2; lv.wp[3] = wp3;
  for (int l = 0; l < 4; ++l)
    if (lv.hp[l] < WIN || lv.wp[l] < WIN) return (int)cudaErrorInvalidValue;
  const long long blocks = (m * 4 * TAPS + 255) / 256;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const int* y = reinterpret_cast<const int*>(sy);
    const int* x = reinterpret_cast<const int*>(sx);
    const float* a = reinterpret_cast<const float*>(fy);
    const float* b = reinterpret_cast<const float*>(fx);
    float* o = reinterpret_cast<float*>(out);
    if (is_bf16) {
      corr_window4_kernel<__nv_bfloat16><<<(unsigned)blocks, 256, 0, s>>>(lv, y, x, a, b, o, m);
    } else {
      corr_window4_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(lv, y, x, a, b, o, m);
    }
  }
  return (int)cudaGetLastError();
}
