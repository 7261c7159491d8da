// RAFT correlation window lookup (4 pyramid levels, radius 4), both flow
// directions in one launch, sm_90a.
//
// Replaces the TPU kernel comfyui_propainter_nodes_tpu/ops/pallas/corr_lanes.py
// (`_kernel`, launched by `_level_lookup`, driven by `corr_lookup_lanes`).
//
// What it computes: for every query pixel and every level l, the 9x9
// bilinear samples of that pixel's correlation map around coords / 2^l,
// with zero for taps outside the map (grid_sample zeros padding,
// align_corners=True), in the maps' type on store.
// Output channel order is (level, dx, dy): the reference stacks
// meshgrid(dy, dx) onto (x, y) coords (RAFT corr.py:37-43), so channel
// i*9 + j samples offset (dx = i - 4, dy = j - 4); the update block's
// weights depend on it. Each sample combines rows first, then columns,
// each product and sum rounded (no FMA contraction). Two blends, those of
// the JAX package's RAFT dispatcher (models/raft.py:540-580 there):
//   * `corr_lookup_kernel<T>` (the lanes kernel's): fp32 fractions and
//     fp32 arithmetic, one rounding to T on store, so the fp32 result
//     equals the plain PyTorch version bit for bit and the bf16 result
//     equals it rounded;
//   * `corr_lookup_map_kernel` (bf16 maps; `lookup_corr` there): the
//     fractions f rounded to bf16, g = bf16(1 - f), and every product and
//     sum rounded to bf16, as PyTorch and XLA round each bf16 operation
//     (the fp32 result rounded once: a product of two bf16 values is exact
//     in fp32, and so is the sum of two unless their exponents lie so far
//     apart that either rounding returns the larger). The kernel does it
//     with Hopper's bf16x2 multiplies and bf16 adds, each rounded to
//     nearest: (v00, v10) * (g, f) in one multiply, then the two summed.
//     For fp32 maps the two blends are the same arithmetic, and the fp32
//     kernel serves both.
//
// Layout: two natural GPU (pixel-major) pyramids, forward and backward:
// level l of each is [n_dir, H_l, W_l] in fp32 or bf16 (one pyramid: both
// pointers the same). coords [n_pix, 2] fp32 as (x, y): pixels below
// n_fwd read the forward pyramid, the rest the backward one at pixel -
// n_fwd. out [n_pix, 324] in the maps' type. The maps are not padded:
// level sizes such as 45 -> 22 -> 11 -> 5 are taken as they are. The TPU
// kernel's pixel-minor volume and scalar-prefetched y-blocks exist only to
// put pixels on the TPU's lanes.
//
// What bounds it on the H100: bytes. Each output costs four loads and six
// flops (the map blend: three bf16x2 multiplies and three adds); the least
// traffic is the in-map part of each pixel's 10x10 window per level read
// once, plus the coords and the [n_pix, 324] result.
//
// Design (as the padded-map lookup corr_window4_kernel): a block of 256
// threads owns 24 pixels. (1) 96 threads compute each (pixel, level)'s
// map plane, window start and fractions once into shared memory. (2) The
// block stages the 24 x 4 windows of 10 x 10 elements in the maps' type,
// each element loaded once, map elements outside the map stored as exact
// zeros; every load of a thread is issued before its first shared store.
// (3) Each thread computes 16 bytes of consecutive outputs of the block's
// contiguous output range (4 in fp32, 8 in bf16; a bf16 group may span
// two pixels) and writes them as one 16-byte store. Index math is 32-bit
// inside a block; only the map planes' and the block's output base are
// 64-bit. Both blends share the block (`lookup_block<T, MAP>`); only the
// fractions' form in shared memory and the combine differ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int R = 4;                 // window radius
constexpr int WIN = 2 * R + 2;       // staged window side: the 9 taps and their +1 corner
constexpr int TAPS = 81;
constexpr int LEVELS = 4;
constexpr int OUT = LEVELS * TAPS;   // outputs of a pixel
constexpr int WELEM = WIN * WIN;
constexpr int PIX = 24;              // pixels a block (even: the block's output is 16-byte aligned)
constexpr int NT = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.0f); }

// the bilinear combine of four corners: rows first, then columns, each
// product and sum rounded (fp32)
__device__ __forceinline__ float combine(float v00, float v01, float v10, float v11, float fy, float fx) {
  const float gy = 1.0f - fy, gx = 1.0f - fx;
  const float vy0 = __fadd_rn(__fmul_rn(v00, gy), __fmul_rn(v10, fy));
  const float vy1 = __fadd_rn(__fmul_rn(v01, gy), __fmul_rn(v11, fy));
  return __fadd_rn(__fmul_rn(vy0, gx), __fmul_rn(vy1, fx));
}

// the same in bf16, each product and sum rounded to bf16: w points at the
// window's corner (dy, dx); wy = (gy, fy) and wx = (gx, fx), already bf16
__device__ __forceinline__ __nv_bfloat16 combine_map(const __nv_bfloat16* w, __nv_bfloat162 wy, __nv_bfloat162 wx) {
  const __nv_bfloat162 p0 = __hmul2_rn(__halves2bfloat162(w[0], w[WIN]), wy);
  const __nv_bfloat162 p1 = __hmul2_rn(__halves2bfloat162(w[1], w[WIN + 1]), wy);
  const __nv_bfloat162 vy = __halves2bfloat162(__hadd_rn(__low2bfloat16(p0), __high2bfloat16(p0)),
                                               __hadd_rn(__low2bfloat16(p1), __high2bfloat16(p1)));
  const __nv_bfloat162 q = __hmul2_rn(vy, wx);
  return __hadd_rn(__low2bfloat16(q), __high2bfloat16(q));
}

// (bf16(1 - fb), fb) for fb, the fraction f rounded to bf16
__device__ __forceinline__ __nv_bfloat162 weights_map(float f) {
  const __nv_bfloat16 fb = __float2bfloat16_rn(f);
  return __halves2bfloat162(__float2bfloat16_rn(1.0f - __bfloat162float(fb)), fb);
}

// 16 bytes of outputs
__device__ __forceinline__ void store16(float* o, const float (&r)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* o, const float (&r)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 v = __floats2bfloat162_rn(r[2 * j], r[2 * j + 1]);
    w[j] = *reinterpret_cast<uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* o, const __nv_bfloat16 (&r)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 v = __halves2bfloat162(r[2 * j], r[2 * j + 1]);
    w[j] = *reinterpret_cast<uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) { *o = __float2bfloat16(v); }
__device__ __forceinline__ void store1(__nv_bfloat16* o, __nv_bfloat16 v) { *o = v; }

struct Pyramids {
  const void* fwd[LEVELS];
  const void* bwd[LEVELS];
  int h[LEVELS];
  int w[LEVELS];
};

// level l's fields with l known only at run time: selects, not an indexed
// copy of the parameter arrays
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[LEVELS], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// the block of both kernels: MAP selects the map-dtype blend
template <typename T, bool MAP>
__device__ __forceinline__ void lookup_block(const Pyramids& py, const float* __restrict__ coords,
                                             T* __restrict__ out, long long n_fwd, long long n_pix) {
  __shared__ __align__(16) unsigned char win_bytes[PIX * LEVELS * WELEM * sizeof(T)];
  T* win = reinterpret_cast<T*>(win_bytes);  // [pixel][level][10][10]
  __shared__ const T* s_map[LEVELS][PIX];
  __shared__ int s_y[LEVELS][PIX], s_x[LEVELS][PIX];
  __shared__ float s_fy[LEVELS][PIX], s_fx[LEVELS][PIX];          // lanes blend
  __shared__ __nv_bfloat162 s_wy[LEVELS][PIX], s_wx[LEVELS][PIX];  // map blend: (g, f)
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * PIX;
  const int np = (int)min((long long)PIX, n_pix - p0);

  // (1) map plane, window start and fractions, once per (pixel, level)
  if (tid < LEVELS * PIX) {
    const int l = tid / PIX;
    const int pix = tid - l * PIX;
    if (pix < np) {
      const long long p = p0 + pix;
      const bool fwd = p < n_fwd;
      const T* base = static_cast<const T*>(fwd ? pick(py.fwd, l) : pick(py.bwd, l));
      s_map[l][pix] = base + (fwd ? p : p - n_fwd) * pick(py.h, l) * pick(py.w, l);
      const float inv = 1.0f / (float)(1 << l);
      const float cx = coords[2 * p] * inv;
      const float cy = coords[2 * p + 1] * inv;
      const float x0 = floorf(cx), y0 = floorf(cy);
      // clamp before the int conversion: far-away centroids read zeros anyway
      s_x[l][pix] = (int)fminf(fmaxf(x0, -1.0e6f), 1.0e6f) - R;
      s_y[l][pix] = (int)fminf(fmaxf(y0, -1.0e6f), 1.0e6f) - R;
      if constexpr (MAP) {
        s_wx[l][pix] = weights_map(cx - x0);
        s_wy[l][pix] = weights_map(cy - y0);
      } else {
        s_fx[l][pix] = cx - x0;
        s_fy[l][pix] = cy - y0;
      }
    }
  }
  __syncthreads();

  // (2) the windows, each element loaded once, zeros outside the map:
  // every load of the four levels is issued before the first is stored
  constexpr int LOADS = (PIX * WELEM + NT - 1) / NT;
  T v[LEVELS][LOADS];
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
    const int hl = py.h[l], wl = py.w[l];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * NT;
      v[l][i] = zero<T>();
      if (e < np * WELEM) {
        const int pix = e / WELEM;
        const int r = e - pix * WELEM;
        const int rr = r / WIN;
        const int y = s_y[l][pix] + rr;
        const int x = s_x[l][pix] + (r - rr * WIN);
        if ((unsigned)y < (unsigned)hl && (unsigned)x < (unsigned)wl) v[l][i] = __ldg(s_map[l][pix] + y * wl + x);
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

  // (3) V consecutive outputs of the block's range a thread, one 16-byte store
  constexpr int V = 16 / sizeof(T);
  constexpr int STEPS = (PIX * OUT / V + NT - 1) / NT;
  const int n_out = np * OUT;
  T* o = out + p0 * OUT;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int j0 = (tid + i * NT) * V;
    if (j0 < n_out) {
      std::conditional_t<MAP, __nv_bfloat16, float> res[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = min(j0 + k, n_out - 1);
        const int pix = j / OUT;
        const int r = j - pix * OUT;
        const int l = r / TAPS;
        const int t = r - l * TAPS;
        const int dx = t / 9;
        const T* w = win + (pix * LEVELS + l) * WELEM + (t - dx * 9) * WIN + dx;
        if constexpr (MAP) {
          res[k] = combine_map(w, s_wy[l][pix], s_wx[l][pix]);
        } else {
          res[k] = combine(to_f(w[0]), to_f(w[1]), to_f(w[WIN]), to_f(w[WIN + 1]), s_fy[l][pix], s_fx[l][pix]);
        }
      }
      if (j0 + V <= n_out) {
        store16(o + j0, res);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (j0 + k < n_out) store1(o + j0 + k, res[k]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 3)
corr_lookup_kernel(Pyramids py, const float* __restrict__ coords, T* __restrict__ out,
                   long long n_fwd, long long n_pix) {
  lookup_block<T, false>(py, coords, out, n_fwd, n_pix);
}

// a kernel of its own name, so profiles and launch counts tell the blends apart
__global__ void __launch_bounds__(NT, 3)
corr_lookup_map_kernel(Pyramids py, const float* __restrict__ coords, __nv_bfloat16* __restrict__ out,
                       long long n_fwd, long long n_pix) {
  lookup_block<__nv_bfloat16, true>(py, coords, out, n_fwd, n_pix);
}

}  // namespace

// mode: 0 fp32 maps (either blend), 1 bf16 maps with the lanes blend,
// 2 bf16 maps with the map-dtype blend
extern "C" int propainter_corr_lookup(
    const void* f0, const void* f1, const void* f2, const void* f3,
    const void* b0, const void* b1, const void* b2, const void* b3,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
    const void* coords, void* out, long long n_fwd, long long n_pix, int mode,
    void* stream) {
  Pyramids py;
  py.fwd[0] = f0; py.fwd[1] = f1; py.fwd[2] = f2; py.fwd[3] = f3;
  py.bwd[0] = b0; py.bwd[1] = b1; py.bwd[2] = b2; py.bwd[3] = b3;
  py.h[0] = h0; py.h[1] = h1; py.h[2] = h2; py.h[3] = h3;
  py.w[0] = w0; py.w[1] = w1; py.w[2] = w2; py.w[3] = w3;
  const long long blocks = (n_pix + PIX - 1) / PIX;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    const float* c = reinterpret_cast<const float*>(coords);
    if (mode == 2) {
      corr_lookup_map_kernel<<<(unsigned)blocks, NT, 0, s>>>(py, c, reinterpret_cast<__nv_bfloat16*>(out), n_fwd, n_pix);
    } else if (mode == 1) {
      corr_lookup_kernel<__nv_bfloat16><<<(unsigned)blocks, NT, 0, s>>>(
          py, c, reinterpret_cast<__nv_bfloat16*>(out), n_fwd, n_pix);
    } else {
      corr_lookup_kernel<float><<<(unsigned)blocks, NT, 0, s>>>(py, c, reinterpret_cast<float*>(out), n_fwd, n_pix);
    }
  }
  return (int)cudaGetLastError();
}
