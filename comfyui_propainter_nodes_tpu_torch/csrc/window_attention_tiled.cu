// Occupancy-sparse window attention with segment tiles split across blocks
// (split-KV), sm_90a.
//
// Replaces the TPU kernel
// comfyui_propainter_nodes_tpu/ops/pallas/window_attention.py (`_kernel`,
// launched by `_window_attention_tiled`, which `window_attention_pallas`
// picks over the single-pass kernel once its size estimate reaches 12e6:
// the node at 1280x720).
//
// What it computes is the single-pass kernel's function
// (window_attention.cu) with the TPU kernel's tiling semantics: for an
// occupied window the keys are [window keys (QT) + bias_w | rolled keys
// padded to a SEG_TILE multiple + bias_r | pooled keys padded likewise +
// bias_p], where a padding key has a zero row and bias -1e9; a clean
// window's queries attend within their own frame's wsz keys, no bias.
// fp32 scores and statistics, output in the input type.
//
// What bounds it on the H100: operations for the occupied windows
// (4 * QT * keys * ch flops per window and head, about 1.5 GFLOP at the
// 1280x720 shape) against about 2.5 MB of bf16 K/V per window; bytes for
// the clean ones.
//
// Design. The TPU walks a window's segment tiles in order on one core,
// carrying the flash statistics in scratch. Here one block per (query
// tile, head, occupied window, split) runs a flash loop over its split of
// the window's padded key sequence. bf16 inputs take the tensor-core loop
// (flash_mma.cuh, 64-query tiles, 64-key tiles) with one split a window, so
// each block finishes its rows itself: on the H100 one split ran faster
// than splits of 512, 1024 or 2048 keys, whose fp32 partials and combine
// cost more than the shorter blocks saved. fp32 inputs take the CUDA-core
// loop (flash_f32.cuh: 64-query tiles, 32-key tiles by `cp.async`; TF32
// would not hold fp32's tolerance) in splits of split_keys keys, each
// writing its rows' partial (m, l, O) to a workspace (PartRows), and a
// combine pass weights each split by exp(m_split - m) and normalises. A split whose keys all carry -1e9
// (padding, invalid frames) has m near -1e9 and p near 1, and that weight
// makes it vanish, exactly as the running max makes such a tile vanish on
// the TPU. Only occupied windows get workspace slots (the wrapper lists
// them); clean windows run their frame-local attention in the same launch
// and write the output directly. The long blocks of occupied windows are
// first in the grid, so the clean windows' short blocks fill the card
// while the last long ones finish.

#include "flash_f32.cuh"
#include "flash_mma.cuh"

namespace {

constexpr float NEG = -1.0e9f;

// virtual key j of an occupied window: [window | rolled (padded) | pooled (padded)]
template <typename T>
struct TiledKeys {
  const T* wk;
  const T* wv;
  const T* rk;
  const T* rv;
  const T* pk;
  const T* pv;
  const float* bw;
  const float* br;
  const float* bp;
  int QT, RL, RLp, PL, ch;
  __device__ __forceinline__ void operator()(int j, const T*& kp, const T*& vp, float& bias,
                                             int& fr) const {
    if (j < QT) {
      kp = wk + (long long)j * ch;
      vp = wv + (long long)j * ch;
      bias = bw[j];
      return;
    }
    j -= QT;
    if (j < RLp) {
      if (j < RL) {
        kp = rk + (long long)j * ch;
        vp = rv + (long long)j * ch;
        bias = br[j];
      } else {
        bias = NEG;
      }
      return;
    }
    j -= RLp;
    if (j < PL) {
      kp = pk + (long long)j * ch;
      vp = pv + (long long)j * ch;
      bias = bp[j];
    } else {
      bias = NEG;
    }
  }
};

struct Args {
  const void *q, *wk, *wv, *rk, *rv, *pk, *pv;
  const int* occ;
  const int* occ_list;
  const float *bw, *br, *bp;
  void* out;
  float *part_m, *part_l, *part_o;
  int n_win, n_occ, n_head, QT, RL, RLp, PL, PLp, ch, n_win_per_b, wsz, n_split, split_keys;
  float scale;
};

// What block z does. The long blocks come first, so the short clean ones
// fill the card while the last long ones finish: z < n_occ * n_split is
// (occupied slot, split) of the listed occupied windows; after them comes
// window z - n_occ * n_split, all of it if it is clean, nothing if it is
// occupied (its splits ran above). Returns false for nothing.
struct Role {
  int w, slot, sp;
};

__device__ __forceinline__ bool role(const Args& a, Role& r) {
  const int z = blockIdx.z;
  const int n_long = a.n_occ * a.n_split;
  if (z < n_long) {
    r.slot = z / a.n_split;
    r.sp = z - r.slot * a.n_split;
    r.w = a.occ_list[r.slot];
    return true;
  }
  r.w = z - n_long;
  r.slot = -1;
  r.sp = 0;
  return a.occ[r.w] == 0;
}

template <typename T>
__device__ __forceinline__ TiledKeys<T> tiled_keys(const Args& a, long long wh, int b, int h) {
  const long long bh = (long long)b * a.n_head + h;
  const long long wo = wh * a.QT * a.ch, ro = wh * a.RL * a.ch, po = bh * a.PL * a.ch;
  return TiledKeys<T>{static_cast<const T*>(a.wk) + wo, static_cast<const T*>(a.wv) + wo,
                      static_cast<const T*>(a.rk) + ro, static_cast<const T*>(a.rv) + ro,
                      static_cast<const T*>(a.pk) + po, static_cast<const T*>(a.pv) + po,
                      a.bw + (long long)b * a.QT, a.br + (long long)b * a.RL, a.bp + (long long)b * a.PL,
                      a.QT, a.RL, a.RLp, a.PL, a.ch};
}

// workspace row of (occupied slot, head, split, query): [n_occ, head, n_split, QT]
__device__ __forceinline__ long long part_row(const Args& a, const Role& r, int h, int qi) {
  return (((long long)r.slot * a.n_head + h) * a.n_split + r.sp) * a.QT + qi;
}

// bf16: the tensor-core loop, one block per (64 queries, head, role), one
// split an occupied window
__global__ void __launch_bounds__(fmma::NT, fmma::MIN_BLOCKS) window_attention_split_mma_kernel(Args a) {
  using T = fmma::bf16;
  extern __shared__ __align__(16) unsigned char smem[];
  Role r;
  if (!role(a, r)) return;
  const int q0 = blockIdx.x * fmma::BQ;
  const int h = blockIdx.y;
  const long long wh = (long long)r.w * a.n_head + h;
  const long long wo = wh * a.QT * a.ch;
  fmma::attend_window(smem, q0, a.QT, a.wsz, a.ch, a.scale, r.slot >= 0, a.QT + a.RLp + a.PLp,
                      tiled_keys<T>(a, wh, r.w / a.n_win_per_b, h),
                      wkeys::FrameKeys<T>{static_cast<const T*>(a.wk) + wo, static_cast<const T*>(a.wv) + wo, a.ch, a.wsz},
                      wkeys::WindowRows<const T*>{static_cast<const T*>(a.q) + wo, q0, a.ch},
                      wkeys::WindowRows<T*>{static_cast<T*>(a.out) + wo, q0, a.ch});
}

// The fp32 split epilogue: each row's partial (m, l, O) to the workspace,
// unnormalised; row0 is the workspace row of the tile's first query
template <bool VEC>
struct PartRows {
  const Args& a;
  long long row0;
  __device__ __forceinline__ void operator()(const ff32::Rows& r) const {
#pragma unroll
    for (int i = 0; i < ff32::RO; ++i) {
      if (r.r0 + i >= r.nq) continue;
      const long long row = row0 + r.r0 + i;
      if (r.cg == 0) {
        a.part_m[row] = r.m[i];
        a.part_l[row] = r.l[i];
      }
#pragma unroll
      for (int k = 0; k < ff32::NC; ++k) {
        const int c = 4 * r.cg + 64 * k;
        if (c < r.ch) ff32::store4<VEC>(a.part_o + row * r.ch, c, r.ch, r.o[i][k]);
      }
    }
  }
};

// fp32: the CUDA-core loop, one block per (64 queries, head, role); every
// split goes through the workspace; VEC: 16-byte copies (ch % 4 == 0,
// every tensor 16-byte aligned)
template <bool VEC>
__global__ void __launch_bounds__(ff32::NT, ff32::MIN_BLOCKS) window_attention_split_f32_kernel(Args a) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem[];
  Role r;
  if (!role(a, r)) return;
  const int q0 = blockIdx.x * ff32::BQ;
  const int h = blockIdx.y;
  const long long wh = (long long)r.w * a.n_head + h;
  const long long wo = wh * a.QT * a.ch;
  const int nq = min(ff32::BQ, a.QT - q0);
  const wkeys::WindowRows<const T*> q_row{static_cast<const T*>(a.q) + wo, q0, a.ch};
  if (r.slot < 0) {  // clean: only the frames this query tile touches
    int klo, khi;
    wkeys::clean_range(q0, nq, a.QT, a.wsz, klo, khi);
    const wkeys::WindowRows<T*> out_row{static_cast<T*>(a.out) + wo, q0, a.ch};
    ff32::attend<VEC>(smem, nq, a.ch, a.scale, klo, khi,
                      wkeys::FrameKeys<T>{static_cast<const T*>(a.wk) + wo, static_cast<const T*>(a.wv) + wo, a.ch, a.wsz},
                      q_row, ff32::StoreRows<VEC, wkeys::WindowRows<T*>>{out_row}, q0, a.wsz);
    return;
  }
  const int k0 = r.sp * a.split_keys;
  ff32::attend<VEC>(smem, nq, a.ch, a.scale, k0, min(a.QT + a.RLp + a.PLp, k0 + a.split_keys),
                    tiled_keys<T>(a, wh, r.w / a.n_win_per_b, h), q_row, PartRows<VEC>{a, part_row(a, r, h, q0)}, q0, 0);
}

template <bool VEC>
cudaError_t launch_split_f32(const Args& a, unsigned nz, cudaStream_t s) {
  const size_t smem = ff32::smem_bytes(a.ch);
  const cudaError_t e = cudaFuncSetAttribute(window_attention_split_f32_kernel<VEC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.QT + ff32::BQ - 1) / ff32::BQ), (unsigned)a.n_head, nz);
  window_attention_split_f32_kernel<VEC><<<grid, ff32::NT, smem, s>>>(a);
  return cudaGetLastError();
}

// one thread per (occupied slot, head, query, channel): merge the splits
__global__ void __launch_bounds__(256) window_attention_combine_kernel(Args a, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % a.ch);
  const long long row = idx / a.ch;  // (slot * n_head + h) * QT + qi
  const int qi = (int)(row % a.QT);
  const long long sh = row / a.QT;  // slot * n_head + h
  const int h = (int)(sh % a.n_head);
  const long long slot = sh / a.n_head;
  const long long first = sh * a.n_split * a.QT + qi;
  float mx = -INFINITY;
  for (int s = 0; s < a.n_split; ++s) mx = fmaxf(mx, a.part_m[first + (long long)s * a.QT]);
  float l = 0.0f, o = 0.0f;
  for (int s = 0; s < a.n_split; ++s) {
    const long long rs = first + (long long)s * a.QT;
    const float wgt = expf(a.part_m[rs] - mx);  // m in base e, as flash_f32.cuh keeps it
    l += a.part_l[rs] * wgt;
    o += a.part_o[rs * a.ch + c] * wgt;
  }
  const long long w = a.occ_list[slot];
  static_cast<float*>(a.out)[((w * a.n_head + h) * a.QT + qi) * a.ch + c] = o / l;
}

}  // namespace

extern "C" int propainter_window_attention_tiled(
    const void* q, const void* wk, const void* wv, const void* rk, const void* rv,
    const void* pk, const void* pv, const void* occ, const void* occ_list, const void* bw,
    const void* br, const void* bp, void* out, void* part_m, void* part_l, void* part_o,
    int n_win, int n_occ, int n_head, int QT, int RL, int RLp, int PL, int PLp, int ch,
    int n_win_per_b, int wsz, int n_split, int split_keys, float scale, int is_bf16,
    void* stream) {
  if (ch > ff32::CHM || ch <= 0 || split_keys <= 0 || n_split <= 0 ||
      (is_bf16 && (ch % 16 != 0 || n_split != 1)))
    return (int)cudaErrorInvalidValue;
  if (n_win <= 0 || QT <= 0) return (int)cudaGetLastError();
  const Args a{q, wk, wv, rk, rv, pk, pv, static_cast<const int*>(occ), static_cast<const int*>(occ_list),
               static_cast<const float*>(bw), static_cast<const float*>(br), static_cast<const float*>(bp),
               out, static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_o),
               n_win, n_occ, n_head, QT, RL, RLp, PL, PLp, ch, n_win_per_b, wsz, n_split, split_keys, scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned nz = (unsigned)(n_win + n_occ * n_split);
  if (is_bf16) {
    const size_t smem = fmma::smem_bytes(ch);
    const cudaError_t e = cudaFuncSetAttribute(window_attention_split_mma_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((QT + fmma::BQ - 1) / fmma::BQ), (unsigned)n_head, nz);
    window_attention_split_mma_kernel<<<grid, fmma::NT, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  const bool vec = ch % 4 == 0 && ff32::aligned16({q, wk, wv, rk, rv, pk, pv, out, part_o});
  const cudaError_t e = vec ? launch_split_f32<true>(a, nz, s) : launch_split_f32<false>(a, nz, s);
  if (e != cudaSuccess || n_occ == 0) return (int)e;
  const long long total = (long long)n_occ * n_head * QT * ch;
  window_attention_combine_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(a, total);
  return (int)cudaGetLastError();
}
