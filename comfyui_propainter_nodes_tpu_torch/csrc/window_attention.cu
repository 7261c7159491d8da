// Occupancy-sparse window attention over segmented keys, sm_90a.
//
// Replaces the TPU kernel
// comfyui_propainter_nodes_tpu/ops/pallas/window_attention.py
// (`_kernel_single`, launched by `_window_attention_single` via
// `window_attention_pallas`, called from ops/attention.py).
//
// What it computes, per (batch*window w, head h), with scale 1/sqrt(ch):
//   * occupied window (occ[w] != 0): softmax attention of all QT = T*wsz
//     queries over three key segments, [window keys (QT) + bias_w |
//     rolled keys (RL) + bias_r | pooled keys (PL) + bias_p]. The biases
//     are per batch row b = w / n_win_per_b (0 or -1e9: t_ind subset and
//     padded frames); pooled K/V are read unbroadcast, [B, head, PL, ch];
//   * clean window: each frame's wsz queries attend to the same frame's
//     wsz window keys only, no bias.
// Inputs fp32 or bf16, fp32 scores, running max/sum and accumulators,
// output [W, head, QT, ch] in the input type.
//
// What bounds it on the H100: operations for occupied windows (4*QT*
// (QT+RL+PL)*ch flops per (window, head): ~680 MFLOP at the 640x360
// shape, against ~1.2 MB of bf16 K/V), bytes for clean ones (4*QT*wsz*ch
// flops against the window's Q/K/V). At the node's occupancy the occupied
// windows' products are most of the work.
//
// Design: the three segments are one key sequence for a segment decoder
// (a tile may straddle segment ends; the ragged tail is masked per key),
// so one flash loop runs per block. bf16 inputs take the tensor-core loop
// (flash_mma.cuh): one block per (64-query tile, head, window), Q·Kᵀ and
// P·V as bf16 `mma.sync` tiles with fp32 accumulation and 64-key K/V tiles
// double-buffered by `cp.async`, which puts the occupied windows' products
// on the tensor cores and overlaps each tile's loads with the previous
// tile's math. fp32 inputs (`fp16: disable`, training) take the CUDA-core
// loop (flash_f32.cuh) with the same decoder, one block of 128 threads per
// 64-query tile: register blocks of S and O fed by float4 shared loads,
// 32-key K/V tiles double-buffered by `cp.async` (16-byte copies where
// ch % 4 == 0 and every tensor is 16-byte aligned, 4-byte copies
// otherwise: any ch <= 128); TF32 tensor cores would not hold fp32's
// tolerance. Clean windows decode
// only the frames their query tile touches (at most 3 at wsz 45 and 64
// queries), each key's frame masking the rows of other frames. Biases are
// added as given (-1e9, not -inf), exactly like the reference.

#include "flash_f32.cuh"
#include "flash_mma.cuh"

namespace {

// key j of an occupied window: [window | rolled | pooled]
template <typename T>
struct SegmentKeys {
  const T* wk;
  const T* wv;
  const T* rk;
  const T* rv;
  const T* pk;
  const T* pv;
  const float* bw;
  const float* br;
  const float* bp;
  int QT, RL, ch;
  __device__ __forceinline__ void operator()(int j, const T*& kp, const T*& vp, float& bias,
                                             int& fr) const {
    if (j < QT) {
      kp = wk + (long long)j * ch;
      vp = wv + (long long)j * ch;
      bias = bw[j];
    } else if (j - QT < RL) {
      j -= QT;
      kp = rk + (long long)j * ch;
      vp = rv + (long long)j * ch;
      bias = br[j];
    } else {
      j -= QT + RL;
      kp = pk + (long long)j * ch;
      vp = pv + (long long)j * ch;
      bias = bp[j];
    }
  }
};

struct Args {
  const void *q, *wk, *wv, *rk, *rv, *pk, *pv;
  const int* occ;
  const float *bw, *br, *bp;
  void* out;
  int n_head, QT, RL, PL, ch, n_win_per_b, wsz;
  float scale;
};

template <typename T>
__device__ __forceinline__ SegmentKeys<T> segment_keys(const Args& a, long long wh, int b, int h) {
  const long long bh = (long long)b * a.n_head + h;
  const long long wo = wh * a.QT * a.ch, ro = wh * a.RL * a.ch, po = bh * a.PL * a.ch;
  return SegmentKeys<T>{static_cast<const T*>(a.wk) + wo, static_cast<const T*>(a.wv) + wo,
                        static_cast<const T*>(a.rk) + ro, static_cast<const T*>(a.rv) + ro,
                        static_cast<const T*>(a.pk) + po, static_cast<const T*>(a.pv) + po,
                        a.bw + (long long)b * a.QT, a.br + (long long)b * a.RL,
                        a.bp + (long long)b * a.PL, a.QT, a.RL, a.ch};
}

// bf16: the tensor-core loop, one block per (64 queries, head, window)
__global__ void __launch_bounds__(fmma::NT, fmma::MIN_BLOCKS) window_attention_mma_kernel(Args a) {
  using T = fmma::bf16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * fmma::BQ;
  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const long long wh = (long long)w * a.n_head + h;
  const long long wo = wh * a.QT * a.ch;
  fmma::attend_window(smem, q0, a.QT, a.wsz, a.ch, a.scale, a.occ[w] != 0, a.QT + a.RL + a.PL,
                      segment_keys<T>(a, wh, w / a.n_win_per_b, h),
                      wkeys::FrameKeys<T>{static_cast<const T*>(a.wk) + wo, static_cast<const T*>(a.wv) + wo, a.ch, a.wsz},
                      wkeys::WindowRows<const T*>{static_cast<const T*>(a.q) + wo, q0, a.ch},
                      wkeys::WindowRows<T*>{static_cast<T*>(a.out) + wo, q0, a.ch});
}

// fp32: the CUDA-core loop, one block per (64 queries, head, window);
// VEC: 16-byte copies (ch % 4 == 0, every tensor 16-byte aligned)
template <bool VEC>
__global__ void __launch_bounds__(ff32::NT, ff32::MIN_BLOCKS) window_attention_f32_kernel(Args a) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * ff32::BQ;
  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const long long wh = (long long)w * a.n_head + h;
  const long long wo = wh * a.QT * a.ch;
  ff32::attend_window<VEC>(smem, q0, a.QT, a.wsz, a.ch, a.scale, a.occ[w] != 0, a.QT + a.RL + a.PL,
                           segment_keys<T>(a, wh, w / a.n_win_per_b, h),
                           wkeys::FrameKeys<T>{static_cast<const T*>(a.wk) + wo, static_cast<const T*>(a.wv) + wo, a.ch, a.wsz},
                           wkeys::WindowRows<const T*>{static_cast<const T*>(a.q) + wo, q0, a.ch},
                           wkeys::WindowRows<T*>{static_cast<T*>(a.out) + wo, q0, a.ch});
}

template <bool VEC>
cudaError_t launch_f32(const Args& a, int n_win, cudaStream_t s) {
  const size_t smem = ff32::smem_bytes(a.ch);
  const cudaError_t e = cudaFuncSetAttribute(window_attention_f32_kernel<VEC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.QT + ff32::BQ - 1) / ff32::BQ), (unsigned)a.n_head, (unsigned)n_win);
  window_attention_f32_kernel<VEC><<<grid, ff32::NT, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int propainter_window_attention(
    const void* q, const void* wk, const void* wv, const void* rk,
    const void* rv, const void* pk, const void* pv, const void* occ,
    const void* bw, const void* br, const void* bp, void* out, int n_win,
    int n_head, int QT, int RL, int PL, int ch, int n_win_per_b, int wsz,
    float scale, int is_bf16, void* stream) {
  if (ch <= 0 || ch > ff32::CHM || (is_bf16 && ch % 16 != 0)) return (int)cudaErrorInvalidValue;
  if (n_win <= 0 || QT <= 0) return (int)cudaGetLastError();
  const Args a{q, wk, wv, rk, rv, pk, pv, static_cast<const int*>(occ),
               static_cast<const float*>(bw), static_cast<const float*>(br),
               static_cast<const float*>(bp), out, n_head, QT, RL, PL, ch, n_win_per_b, wsz, scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const size_t smem = fmma::smem_bytes(ch);
    const cudaError_t e = cudaFuncSetAttribute(window_attention_mma_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((QT + fmma::BQ - 1) / fmma::BQ), (unsigned)n_head, (unsigned)n_win);
    window_attention_mma_kernel<<<grid, fmma::NT, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  const bool vec = ch % 4 == 0 && ff32::aligned16({q, wk, wv, rk, rv, pk, pv, out});
  return (int)(vec ? launch_f32<true>(a, n_win, s) : launch_f32<false>(a, n_win, s));
}
