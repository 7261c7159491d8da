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
// flops against the window's Q/K/V). The occupied share depends on the
// mask, and with it which bound the whole call meets.
//
// Design: one block per (32-query tile, head, window), flash style. The
// query tile stays in shared memory; 16-key K/V tiles of each segment are
// staged in shared memory in turn, and each query row keeps an online
// softmax (running max m, sum l, 32 output columns per thread) so no
// score matrix reaches device memory. Segment lengths need not be tile
// multiples: the ragged tail tile masks its missing keys. Clean windows
// run the same loop over only the key frames their query tile touches,
// with keys of other frames masked. Biases are added as given (-1e9, not
// -inf), exactly like the reference. CUDA-core FMAs for now; wgmma is
// the follow-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;    // queries per block
constexpr int BK = 16;    // keys per staged tile
constexpr int CHM = 128;  // largest head width supported
constexpr int NT = 128;   // threads per block: 4 per query row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(NT)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ wk,
                        const T* __restrict__ wv, const T* __restrict__ rk,
                        const T* __restrict__ rv, const T* __restrict__ pk,
                        const T* __restrict__ pv, const int* __restrict__ occ,
                        const float* __restrict__ bw, const float* __restrict__ br,
                        const float* __restrict__ bp, T* __restrict__ out,
                        int n_head, int QT, int RL, int PL, int ch,
                        int n_win_per_b, int wsz, float scale) {
  __shared__ float sq[BQ][CHM + 1];
  __shared__ float sk[BK][CHM + 1];
  __shared__ float sv[BK][CHM];
  __shared__ float sp[BQ][BK + 1];

  const int tid = threadIdx.x;
  const int r = tid >> 2;  // query row within the tile
  const int l4 = tid & 3;  // lane within the row's 4 threads
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const int b = w / n_win_per_b;
  const int nq = min(BQ, QT - q0);
  const bool occupied = occ[w] != 0;
  const long long wh = (long long)w * n_head + h;

  for (int idx = tid; idx < BQ * ch; idx += NT) {
    const int rr = idx / ch;
    const int c = idx - rr * ch;
    sq[rr][c] = rr < nq ? to_f(q[(wh * QT + q0 + rr) * ch + c]) : 0.0f;
  }

  float m_i = -1.0e30f;
  float l_i = 0.0f;
  float o[CHM / 4];
#pragma unroll
  for (int j = 0; j < CHM / 4; ++j) o[j] = 0.0f;

  const int n_seg = occupied ? 3 : 1;
  for (int seg = 0; seg < n_seg; ++seg) {
    const T* kb;
    const T* vb;
    const float* bb = nullptr;
    int klo = 0, khi;
    if (seg == 0) {
      kb = wk + wh * QT * ch;
      vb = wv + wh * QT * ch;
      if (occupied) {
        bb = bw + (long long)b * QT;
        khi = QT;
      } else {  // only the frames this query tile touches
        klo = (q0 / wsz) * wsz;
        khi = min(QT, ((q0 + nq - 1) / wsz + 1) * wsz);
      }
    } else if (seg == 1) {
      kb = rk + wh * RL * ch;
      vb = rv + wh * RL * ch;
      bb = br + (long long)b * RL;
      khi = RL;
    } else {
      const long long bh = (long long)b * n_head + h;
      kb = pk + bh * PL * ch;
      vb = pv + bh * PL * ch;
      bb = bp + (long long)b * PL;
      khi = PL;
    }

    for (int k0 = klo; k0 < khi; k0 += BK) {
      const int nk = min(BK, khi - k0);
      __syncthreads();  // earlier readers of sk / sv / sp are done
      for (int idx = tid; idx < BK * ch; idx += NT) {
        const int kk = idx / ch;
        const int c = idx - kk * ch;
        float kv = 0.0f, vv = 0.0f;
        if (kk < nk) {
          const long long g = (long long)(k0 + kk) * ch + c;
          kv = to_f(kb[g]);
          vv = to_f(vb[g]);
        }
        sk[kk][c] = kv;
        sv[kk][c] = vv;
      }
      __syncthreads();

      // scores for keys l4, l4+4, l4+8, l4+12 of this tile
      float s[BK / 4];
#pragma unroll
      for (int mm = 0; mm < BK / 4; ++mm) s[mm] = 0.0f;
      for (int c = 0; c < ch; ++c) {
        const float qv = sq[r][c];
#pragma unroll
        for (int mm = 0; mm < BK / 4; ++mm) s[mm] += qv * sk[l4 + 4 * mm][c];
      }
      float mx = -INFINITY;
#pragma unroll
      for (int mm = 0; mm < BK / 4; ++mm) {
        const int kk = l4 + 4 * mm;
        const int kg = k0 + kk;
        bool valid = kk < nk;
        if (!occupied) valid = valid && ((q0 + r) / wsz == kg / wsz);
        s[mm] = valid ? s[mm] * scale + (bb != nullptr ? bb[kg] : 0.0f) : -INFINITY;
        mx = fmaxf(mx, s[mm]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = expf(m_i - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int mm = 0; mm < BK / 4; ++mm) {
        const float pval = expf(s[mm] - m_new);
        sp[r][l4 + 4 * mm] = pval;
        ps += pval;
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l_i = l_i * alpha + ps;
      m_i = m_new;
#pragma unroll
      for (int j = 0; j < CHM / 4; ++j) o[j] *= alpha;
      __syncthreads();  // sp complete for every row
      for (int kk = 0; kk < nk; ++kk) {
        const float pval = sp[r][kk];
#pragma unroll
        for (int j = 0; j < CHM / 4; ++j) {
          const int c = l4 + 4 * j;
          if (c < ch) o[j] += pval * sv[kk][c];
        }
      }
    }
  }

  if (r < nq) {
    const float inv = 1.0f / l_i;
    T* dst = out + (wh * QT + q0 + r) * ch;
#pragma unroll
    for (int j = 0; j < CHM / 4; ++j) {
      const int c = l4 + 4 * j;
      if (c < ch) store(dst + c, o[j] * inv);
    }
  }
}

}  // namespace

extern "C" int propainter_window_attention(
    const void* q, const void* wk, const void* wv, const void* rk,
    const void* rv, const void* pk, const void* pv, const void* occ,
    const void* bw, const void* br, const void* bp, void* out, int n_win,
    int n_head, int QT, int RL, int PL, int ch, int n_win_per_b, int wsz,
    float scale, int is_bf16, void* stream) {
  if (ch > CHM || ch <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((QT + BQ - 1) / BQ), (unsigned)n_head, (unsigned)n_win);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_win > 0 && QT > 0) {
    if (is_bf16) {
      using T = __nv_bfloat16;
      window_attention_kernel<T><<<grid, NT, 0, s>>>(
          reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(wk),
          reinterpret_cast<const T*>(wv), reinterpret_cast<const T*>(rk),
          reinterpret_cast<const T*>(rv), reinterpret_cast<const T*>(pk),
          reinterpret_cast<const T*>(pv), reinterpret_cast<const int*>(occ),
          reinterpret_cast<const float*>(bw), reinterpret_cast<const float*>(br),
          reinterpret_cast<const float*>(bp), reinterpret_cast<T*>(out),
          n_head, QT, RL, PL, ch, n_win_per_b, wsz, scale);
    } else {
      using T = float;
      window_attention_kernel<T><<<grid, NT, 0, s>>>(
          reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(wk),
          reinterpret_cast<const T*>(wv), reinterpret_cast<const T*>(rk),
          reinterpret_cast<const T*>(rv), reinterpret_cast<const T*>(pk),
          reinterpret_cast<const T*>(pv), reinterpret_cast<const int*>(occ),
          reinterpret_cast<const float*>(bw), reinterpret_cast<const float*>(br),
          reinterpret_cast<const float*>(bp), reinterpret_cast<T*>(out),
          n_head, QT, RL, PL, ch, n_win_per_b, wsz, scale);
    }
  }
  return (int)cudaGetLastError();
}
