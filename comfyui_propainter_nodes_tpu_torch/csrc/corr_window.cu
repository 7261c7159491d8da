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
// Design of the one-level lookup (B7): a block of 256 threads owns 32
// pixels (a multiple of 4, so the block's [32 * 81] fp32 output range is
// 16-byte aligned). (1) 32 threads load each pixel's start, clamped once,
// and fractions into shared memory. (2) The block stages the 32 windows of
// 10 x 10 map elements in the map's type, each element loaded once, every
// load of a thread issued before its first shared store. (3) Each thread
// computes four consecutive outputs of the block's contiguous output range
// (a group may span two pixels: 81 is odd) and writes them as one 16-byte
// store; the tail block's last group, if short, is stored element by
// element. The window rows are 10 elements, so each row touches one to
// three 32-byte sectors: the bytes moved are about twice the bound's.
//
// Design of the four-level lookup (B6): a block of 256 threads owns 24
// pixels. (1) 96 threads load each (pixel, level)'s start, clamped, and
// fractions once into shared memory. (2) The block stages the 24 x 4
// windows of 10 x 10 map elements into shared memory in the map's type,
// each element loaded once (read-only loads, all forty of a thread in
// flight before the first is stored); neighbouring threads read
// neighbouring elements of a window row.
// (3) Each thread computes four consecutive outputs of a pixel's 324 from
// the staged windows and writes them as one 16-byte store: a pixel's
// output is 1296 bytes, a multiple of 16, so the block's stores cover one
// contiguous, aligned range. Index math is 32-bit inside a block; only the
// map's pixel base (pix * Hp * Wp, past 2^31 elements at 1280x720) and the
// block's output base are 64-bit.
//
// Both: the TPU kernels' DMA rings, lane rotations and row-concatenated
// map blocks exist only to feed the TPU's vector lanes and have no
// counterpart here. The products and sums are rounded one by one (no FMA
// contraction), so the fp32 result equals the plain PyTorch version bit
// for bit. Starts are clamped to [0, Hp-10] and [0, Wp-10] in the kernels,
// so no start can read outside its map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 10;
constexpr int TAPS = 81;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the bilinear combine of four corners: rows first (vy), then columns,
// each product and sum rounded
__device__ __forceinline__ float combine(float v00, float v01, float v10, float v11, float fy, float fx) {
  const float gy = 1.0f - fy, gx = 1.0f - fx;
  const float vy0 = __fadd_rn(__fmul_rn(v00, gy), __fmul_rn(v10, fy));
  const float vy1 = __fadd_rn(__fmul_rn(v01, gy), __fmul_rn(v11, fy));
  return __fadd_rn(__fmul_rn(vy0, gx), __fmul_rn(vy1, fx));
}

constexpr int WELEM = WIN * WIN;     // elements of a window
constexpr int NT = 256;              // threads per block, both kernels
// pixels per block, one level: a multiple of 4, so a block's fp32 output
// range is 16-byte aligned (16-96 timed in B7's redesign: 16 within 2% of 32, CHANGES.md)
constexpr int PIX1 = 32;

// out is [M, 9, 9]
template <typename T>
__global__ void __launch_bounds__(NT)
corr_window_kernel(const T* __restrict__ map, const int* __restrict__ sy,
                   const int* __restrict__ sx, const float* __restrict__ fy,
                   const float* __restrict__ fx, float* __restrict__ out,
                   long long m, int hp, int wp) {
  __shared__ __align__(16) unsigned char win_bytes[PIX1 * WELEM * sizeof(T)];
  T* win = reinterpret_cast<T*>(win_bytes);  // [pixel][10][10]
  __shared__ int s_y[PIX1], s_x[PIX1];
  __shared__ float s_fy[PIX1], s_fx[PIX1];
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * PIX1;
  const int np = (int)min((long long)PIX1, m - p0);

  // (1) starts and fractions, once per pixel
  if (tid < np) {
    s_y[tid] = min(max(sy[p0 + tid], 0), hp - WIN);
    s_x[tid] = min(max(sx[p0 + tid], 0), wp - WIN);
    s_fy[tid] = fy[p0 + tid];
    s_fx[tid] = fx[p0 + tid];
  }
  __syncthreads();

  // (2) the windows, each element loaded once: every load is issued
  // before the first is stored
  constexpr int LOADS = (PIX1 * WELEM + NT - 1) / NT;
  const T* base = map + p0 * hp * wp;
  const int plane = hp * wp;  // Hp * Wp < 2^31 for one pixel
  T v[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = tid + i * NT;
    if (e < np * WELEM) {
      const int pix = e / WELEM;
      const int r = e - pix * WELEM;
      const int rr = r / WIN;
      v[i] = __ldg(base + (long long)pix * plane + (s_y[pix] + rr) * wp + s_x[pix] + (r - rr * WIN));
    }
  }
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = tid + i * NT;
    if (e < np * WELEM) win[e] = v[i];
  }
  __syncthreads();

  // (3) four consecutive outputs of the block's range a thread, one
  // 16-byte store
  constexpr int STEPS = (PIX1 * TAPS / 4 + NT - 1) / NT;
  const int n_out = np * TAPS;
  float* o = out + p0 * TAPS;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int j0 = (tid + i * NT) * 4;
    if (j0 < n_out) {
      float res[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = min(j0 + k, n_out - 1);
        const int pix = j / TAPS;
        const int t = j - pix * TAPS;
        const int dy = t / 9;
        const T* w = win + pix * WELEM + dy * WIN + (t - dy * 9);
        res[k] = combine(to_f(w[0]), to_f(w[1]), to_f(w[WIN]), to_f(w[WIN + 1]), s_fy[pix], s_fx[pix]);
      }
      if (j0 + 4 <= n_out) {
        *reinterpret_cast<float4*>(o + j0) = make_float4(res[0], res[1], res[2], res[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j0 + k < n_out) o[j0 + k] = res[k];
      }
    }
  }
}

struct Levels {
  const void* map[4];
  int hp[4];
  int wp[4];
};

constexpr int LEVELS = 4;
constexpr int OUT4 = LEVELS * TAPS;  // fp32 outputs of a pixel: [4, 9, 9]
constexpr int GROUPS = OUT4 / 4;     // 16-byte groups of a pixel's outputs
constexpr int PIX = 24;              // pixels per block, four levels

// level l's (Hp, Wp) with l known only at run time: selects, not an
// indexed copy of the parameter arrays
__device__ __forceinline__ void level_dims(const Levels& lv, int l, int& hp, int& wp) {
  hp = l == 0 ? lv.hp[0] : l == 1 ? lv.hp[1] : l == 2 ? lv.hp[2] : lv.hp[3];
  wp = l == 0 ? lv.wp[0] : l == 1 ? lv.wp[1] : l == 2 ? lv.wp[2] : lv.wp[3];
}

// sy/sx/fy/fx are [4, M]; out is [M, 4, 9, 9]
template <typename T>
__global__ void __launch_bounds__(NT, 3)
corr_window4_kernel(Levels lv, const int* __restrict__ sy, const int* __restrict__ sx,
                    const float* __restrict__ fy, const float* __restrict__ fx,
                    float* __restrict__ out, long long m) {
  __shared__ __align__(16) unsigned char win_bytes[PIX * LEVELS * WELEM * sizeof(T)];
  T* win = reinterpret_cast<T*>(win_bytes);  // [pixel][level][10][10]
  __shared__ int s_y[LEVELS][PIX], s_x[LEVELS][PIX];
  __shared__ float s_fy[LEVELS][PIX], s_fx[LEVELS][PIX];
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * PIX;
  const int np = (int)min((long long)PIX, m - p0);

  // (1) starts and fractions, once per (pixel, level)
  if (tid < LEVELS * PIX) {
    const int l = tid / PIX;
    const int pix = tid - l * PIX;
    if (pix < np) {
      int hp, wp;
      level_dims(lv, l, hp, wp);
      const long long i = l * m + p0 + pix;
      s_y[l][pix] = min(max(sy[i], 0), hp - WIN);
      s_x[l][pix] = min(max(sx[i], 0), wp - WIN);
      s_fy[l][pix] = fy[i];
      s_fx[l][pix] = fx[i];
    }
  }
  __syncthreads();

  // (2) the windows, each element loaded once: every load of the four
  // levels is issued before the first is stored
  constexpr int LOADS = (PIX * WELEM + NT - 1) / NT;
  T v[LEVELS][LOADS];
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
    const T* map = static_cast<const T*>(lv.map[l]) + p0 * lv.hp[l] * lv.wp[l];
    const int plane = lv.hp[l] * lv.wp[l];  // Hp * Wp < 2^31 for one pixel
    const int wp = lv.wp[l];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * NT;
      if (e < np * WELEM) {
        const int pix = e / WELEM;
        const int r = e - pix * WELEM;
        const int rr = r / WIN;
        v[l][i] = __ldg(map + (long long)pix * plane + (s_y[l][pix] + rr) * wp + s_x[l][pix] + (r - rr * WIN));
      }
    }
  }
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * NT;
      if (e < np * WELEM) {
        const int pix = e / WELEM;
        win[(pix * LEVELS + l) * WELEM + (e - pix * WELEM)] = v[l][i];
      }
    }
  }
  __syncthreads();

  // (3) four consecutive outputs a thread, one 16-byte store
  float* o = out + p0 * OUT4;
  constexpr int STEPS = (PIX * GROUPS + NT - 1) / NT;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int g = tid + i * NT;
    if (g < np * GROUPS) {
      const int pix = g / GROUPS;
      const int j0 = (g - pix * GROUPS) * 4;  // first output, in [0, 324)
      float res[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        const int l = j / TAPS;
        const int t = j - l * TAPS;
        const int dy = t / 9;
        const T* w = win + (pix * LEVELS + l) * WELEM + dy * WIN + (t - dy * 9);
        res[k] = combine(to_f(w[0]), to_f(w[1]), to_f(w[WIN]), to_f(w[WIN + 1]), s_fy[l][pix], s_fx[l][pix]);
      }
      *reinterpret_cast<float4*>(o + pix * OUT4 + j0) = make_float4(res[0], res[1], res[2], res[3]);
    }
  }
}

}  // namespace

extern "C" int propainter_corr_window(const void* map, const void* sy, const void* sx,
                                      const void* fy, const void* fx, void* out,
                                      long long m, int hp, int wp, int is_bf16,
                                      void* stream) {
  if (hp < WIN || wp < WIN) return (int)cudaErrorInvalidValue;
  const long long blocks = (m + PIX1 - 1) / PIX1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const int* y = reinterpret_cast<const int*>(sy);
    const int* x = reinterpret_cast<const int*>(sx);
    const float* a = reinterpret_cast<const float*>(fy);
    const float* b = reinterpret_cast<const float*>(fx);
    float* o = reinterpret_cast<float*>(out);
    if (is_bf16) {
      corr_window_kernel<__nv_bfloat16><<<(unsigned)blocks, NT, 0, s>>>(
          reinterpret_cast<const __nv_bfloat16*>(map), y, x, a, b, o, m, hp, wp);
    } else {
      corr_window_kernel<float><<<(unsigned)blocks, NT, 0, s>>>(
          reinterpret_cast<const float*>(map), y, x, a, b, o, m, hp, wp);
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
  const long long blocks = (m + PIX - 1) / PIX;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const int* y = reinterpret_cast<const int*>(sy);
    const int* x = reinterpret_cast<const int*>(sx);
    const float* a = reinterpret_cast<const float*>(fy);
    const float* b = reinterpret_cast<const float*>(fx);
    float* o = reinterpret_cast<float*>(out);
    if (is_bf16) {
      corr_window4_kernel<__nv_bfloat16><<<(unsigned)blocks, NT, 0, s>>>(lv, y, x, a, b, o, m);
    } else {
      corr_window4_kernel<float><<<(unsigned)blocks, NT, 0, s>>>(lv, y, x, a, b, o, m);
    }
  }
  return (int)cudaGetLastError();
}
