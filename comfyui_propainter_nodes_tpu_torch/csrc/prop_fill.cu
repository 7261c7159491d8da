// Image propagation's warp-fill step, sm_90a: one launch a step of a
// direction.
//
// Replaces no TPU kernel: the JAX package leaves the step to XLA
// (comfyui_propainter_nodes_tpu/models/propainter.py::_prop_direction_image),
// and the port ran it as about 137 eager launches a step. Its plain version
// is ops/cuda/prop_fill.py::prop_step_plain.
//
// What it computes, for slot s of one direction (the previous slot p = s - 1
// going forward, s + 1 going backward; flows at f = min(s, p)), per batch row
// and pixel (y, x), with (fx, fy) = flow_prop[f] at the pixel and the sampling
// point (x + fx, y + fy) in float32:
//   * the bilinear warp of [flow_check[f], masks[p]] (zero outside the
//     frame): the flow's backward partner and the propagated mask;
//   * the nearest (half to even) warp of feats[p], or its bilinear warp
//     under "bilinear";
//   * the forward-backward check: valid = |fw + bw|^2 < 0.01 (|fw|^2 +
//     |bw|^2) + 0.5;
//   * the fill: union = binarize(mask * valid * (1 - binarize(warped
//     mask))), feats[s] = union * warped + (1 - union) * x[s], masks[s] =
//     binarize(mask * (1 - valid * (1 - binarize(warped mask))));
//   * a batch row whose restart flag is set keeps x[s] and mask[s].
//
// Same result as the plain version on the card, bit for bit: the kernel
// evaluates the plain version's expressions in its order and rounds where
// eager PyTorch rounds. In bf16 every op computes in float32 and rounds to
// bf16 (the tap weights (x - x0), 1 - w and wy * wx; each tap's product and
// each partial sum ((t00 + t01) + t10) + t11; the squares; each two-term sum,
// added in float32 and rounded once; 0.01 * mag, the scalar in float32, and
// + 0.5); the threshold of binarize is 0.1 in the tensors' type. In float32
// every product and sum is rounded alone (__fmul_rn, __fadd_rn: no FMA
// contraction). Out-of-bounds taps read the clamped pixel and multiply it by
// a zero weight, as the plain version does, so the signs of zeros agree, and
// the fill is the plain version's sum of products, not a select.
//
// What bounds it on the H100: neither bytes nor operations, but the launch.
// At the outpaint cell's 768 x 360 a step reads the pixel's flow, frame and
// mask and gathers four taps of the previous slot's mask and the check flow
// and one (or four) of its frame: about 40 bytes a pixel in bf16, 11 MB a
// step, 3.3 us at 3.35 TB/s, the previous slot (about 2.2 MB) held in L2.
// Design: one thread a pixel of a batch row, 256 threads a block (1080
// blocks at 768 x 360, eight an SM), no shared memory; the pixel's flow and
// each tap's check flow are one 4- or 8-byte load, the frames' three
// channels three loads that neighbouring threads coalesce. A direction is
// one launch a step on the caller's stream: a step reads the slot the
// launch before it wrote.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float r(float v) { return v; }
  static __device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float2 ld2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
  static __device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
    return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// one eager op: computed in float32, rounded to the tensors' type
template <typename T>
__device__ __forceinline__ float mul(float a, float b) { return Num<T>::r(__fmul_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float add(float a, float b) { return Num<T>::r(__fadd_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float sub(float a, float b) { return Num<T>::r(__fsub_rn(a, b)); }

// a whole-valued float (floor or rint) as a pixel index; far outside any
// frame it stays outside
__device__ __forceinline__ int to_index(float v) { return (int)fminf(fmaxf(v, -16777216.f), 16777216.f); }

template <typename T>
struct Args {
  const T* x;           // [N, T, H, W, 3]
  const T* mask;        // [N, T, H, W, 1]
  const T* flow_prop;   // [N, T - 1, H, W, 2]
  const T* flow_check;  // [N, T - 1, H, W, 2]
  T* feats;             // [N, T, H, W, 3]: slot p read, slot s written
  T* masks;             // [N, T, H, W, 1]
  const unsigned char* restart;  // [N] or null
  int t, h, w, s, p, f;
};

template <typename T, bool NEAREST>
__global__ void __launch_bounds__(NT) prop_fill_kernel(Args<T> a) {
  using N = Num<T>;
  const int hw = a.h * a.w;
  const int pix = blockIdx.x * NT + threadIdx.x;
  if (pix >= hw) return;
  const int b = blockIdx.y;
  const int y = pix / a.w, x = pix - y * a.w;
  const long long cur = ((long long)b * a.t + a.s) * hw;
  const long long prev = ((long long)b * a.t + a.p) * hw;
  const long long fl = ((long long)b * (a.t - 1) + a.f) * hw;
  const T* check = a.flow_check + fl * 2;
  const T* mprev = a.masks + prev;
  const T* fprev = a.feats + prev * 3;

  // the sampling point in float32, as ops/warp.py::flow_warp builds it
  const float2 fp = N::ld2(a.flow_prop + (fl + pix) * 2);
  const float xf = __fadd_rn((float)x, fp.x), yf = __fadd_rn((float)y, fp.y);

  // the bilinear warp of [flow_check, mask_prop] (and feat_prop under
  // "bilinear"): the taps in the plain version's order, each weighed by
  // its weight times its validity, summed tap by tap
  constexpr int C = NEAREST ? 3 : 6;
  const float x0 = floorf(xf), y0 = floorf(yf);
  const float wx1 = N::r(__fsub_rn(xf, x0)), wy1 = N::r(__fsub_rn(yf, y0));
  const float wx0 = sub<T>(1.f, wx1), wy0 = sub<T>(1.f, wy1);
  const int ix0 = to_index(x0), iy0 = to_index(y0);
  float sum[C];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int iy = iy0 + (k >> 1), ix = ix0 + (k & 1);
    const float wgt = mul<T>(k >> 1 ? wy1 : wy0, k & 1 ? wx1 : wx0);
    const bool in = ix >= 0 && ix < a.w && iy >= 0 && iy < a.h;
    const float wv = mul<T>(wgt, in ? 1.f : 0.f);
    const int q = min(max(iy, 0), a.h - 1) * a.w + min(max(ix, 0), a.w - 1);
    float v[C];
    const float2 c2 = N::ld2(check + q * 2);
    v[0] = c2.x;
    v[1] = c2.y;
    v[2] = N::ld(mprev + q);
    if (!NEAREST) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 + c] = N::ld(fprev + q * 3 + c);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float tap = mul<T>(v[c], wv);
      sum[c] = k == 0 ? tap : add<T>(sum[c], tap);
    }
  }
  float warped[3];
  if (NEAREST) {
    const float xn = rintf(xf), yn = rintf(yf);  // half to even, as torch.round
    const int ix = to_index(xn), iy = to_index(yn);
    const float in = ix >= 0 && ix < a.w && iy >= 0 && iy < a.h ? 1.f : 0.f;
    const int q = min(max(iy, 0), a.h - 1) * a.w + min(max(ix, 0), a.w - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) warped[c] = mul<T>(N::ld(fprev + q * 3 + c), in);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) warped[c] = sum[3 + c];
  }

  // the forward-backward check and the fill
  const float thr = N::r(0.1f);
  const float bx = sum[0], by = sum[1];
  const float mpv = sum[2] > thr ? 1.f : 0.f;
  const float dx = add<T>(fp.x, bx), dy = add<T>(fp.y, by);
  const float mag_f = N::r(__fadd_rn(mul<T>(fp.x, fp.x), mul<T>(fp.y, fp.y)));
  const float mag_b = N::r(__fadd_rn(mul<T>(bx, bx), mul<T>(by, by)));
  const float lim = add<T>(N::r(__fmul_rn(add<T>(mag_f, mag_b), 0.01f)), 0.5f);
  const float valid = N::r(__fadd_rn(mul<T>(dx, dx), mul<T>(dy, dy))) < lim ? 1.f : 0.f;
  const float mc = N::ld(a.mask + cur + pix);
  const float omv = sub<T>(1.f, mpv);
  const float un = mul<T>(mul<T>(mc, valid), omv) > thr ? 1.f : 0.f;
  const float omu = sub<T>(1.f, un);
  float mnew = mul<T>(mc, sub<T>(1.f, mul<T>(valid, omv))) > thr ? 1.f : 0.f;
  const T* xc = a.x + (cur + pix) * 3;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = N::ld(xc + c);
  if (a.restart == nullptr || a.restart[b] == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = add<T>(mul<T>(un, warped[c]), mul<T>(omu, out[c]));
  } else {
    mnew = mc;
  }
  T* fo = a.feats + (cur + pix) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) N::st(fo + c, out[c]);
  N::st(a.masks + cur + pix, mnew);
}

template <typename T>
int launch(const Args<T>& a, int n, int nearest, cudaStream_t s) {
  const dim3 grid((unsigned)((a.h * a.w + NT - 1) / NT), (unsigned)n);
  if (nearest) {
    prop_fill_kernel<T, true><<<grid, NT, 0, s>>>(a);
  } else {
    prop_fill_kernel<T, false><<<grid, NT, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One step: slot s of feats and masks from slot p (|s - p| = 1) and the
// flows at f = min(s, p). restart: [N] flags (uint8) or null.
extern "C" int propainter_prop_fill(const void* x, const void* mask, const void* flow_prop,
                                    const void* flow_check, void* feats, void* masks,
                                    const void* restart, int n, int t, int h, int w, int s,
                                    int p, int f, int is_bf16, int nearest, void* stream) {
  if (n < 1 || n > 65535 || t < 2 || h < 1 || w < 1 || (long long)h * w >= (1LL << 31) / 3 ||
      s < 0 || s >= t || p < 0 || p >= t || (s - p != 1 && p - s != 1) || f != (s < p ? s : p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const unsigned char* rs = reinterpret_cast<const unsigned char*>(restart);
  if (is_bf16) {
    using T = __nv_bfloat16;
    Args<T> a{reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(mask),
              reinterpret_cast<const T*>(flow_prop), reinterpret_cast<const T*>(flow_check),
              reinterpret_cast<T*>(feats), reinterpret_cast<T*>(masks), rs, t, h, w, s, p, f};
    return launch(a, n, nearest, st);
  }
  Args<float> a{reinterpret_cast<const float*>(x), reinterpret_cast<const float*>(mask),
                reinterpret_cast<const float*>(flow_prop), reinterpret_cast<const float*>(flow_check),
                reinterpret_cast<float*>(feats), reinterpret_cast<float*>(masks), rs, t, h, w, s, p, f};
  return launch(a, n, nearest, st);
}
