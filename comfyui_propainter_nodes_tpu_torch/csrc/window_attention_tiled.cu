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
// loop (flash_tile.cuh, 32-query tiles; TF32 would not hold fp32's
// tolerance) in splits of split_keys keys, each writing its rows' partial
// (m, l, O) to a workspace, and a combine pass weights each split by
// exp(m_split - m) and normalises. A split whose keys all carry -1e9
// (padding, invalid frames) has m near -1e9 and p near 1, and that weight
// makes it vanish, exactly as the running max makes such a tile vanish on
// the TPU. Only occupied windows get workspace slots (the wrapper lists
// them); clean windows run their frame-local attention in the same launch
// and write the output directly. The long blocks of occupied windows are
// first in the grid, so the clean windows' short blocks fill the card
// while the last long ones finish.

#include "flash_mma.cuh"
#include "flash_tile.cuh"

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
                      flash::FrameKeys<T>{static_cast<const T*>(a.wk) + wo, static_cast<const T*>(a.wv) + wo, a.ch, a.wsz},
                      flash::WindowRows<const T*>{static_cast<const T*>(a.q) + wo, q0, a.ch},
                      flash::WindowRows<T*>{static_cast<T*>(a.out) + wo, q0, a.ch});
}

// fp32: the CUDA-core loop, one block per (32 queries, head, role); every
// split goes through the workspace
__global__ void __launch_bounds__(flash::NT, flash::MIN_BLOCKS) window_attention_split_kernel(Args a) {
  using T = float;
  __shared__ flash::Smem<T> sm;
  Role r;
  if (!role(a, r)) return;
  const int q0 = blockIdx.x * flash::BQ;
  const int h = blockIdx.y;
  const int nq = min(flash::BQ, a.QT - q0);
  const int rr = threadIdx.x >> 2;
  const long long wh = (long long)r.w * a.n_head + h;
  const long long wo = wh * a.QT * a.ch;
  flash::load_q(sm, nq, a.ch, flash::WindowRows<const T*>{static_cast<const T*>(a.q) + wo, q0, a.ch});
  flash::Row st;
  flash::init(st);

  if (r.slot < 0) {  // clean: only the frames this query tile touches
    int klo, khi;
    flash::clean_range(q0, nq, a.QT, a.wsz, klo, khi);
    flash::attend(sm, st, klo, khi,
                  flash::FrameKeys<T>{static_cast<const T*>(a.wk) + wo, static_cast<const T*>(a.wv) + wo, a.ch, a.wsz},
                  a.ch, a.scale, (q0 + rr) / a.wsz);
    if (rr < nq) flash::store_row(st, static_cast<T*>(a.out) + wo + (long long)(q0 + rr) * a.ch, a.ch);
    return;
  }

  const int k0 = r.sp * a.split_keys;
  flash::attend(sm, st, k0, min(a.QT + a.RLp + a.PLp, k0 + a.split_keys),
                tiled_keys<T>(a, wh, r.w / a.n_win_per_b, h), a.ch, a.scale, -1);
  if (rr < nq) {
    const long long row = part_row(a, r, h, q0 + rr);
    if ((threadIdx.x & 3) == 0) {
      a.part_m[row] = st.m;
      a.part_l[row] = st.l;
    }
    const int l4 = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < flash::CHM / 4; ++j) {
      const int c = l4 + 4 * j;
      if (c < a.ch) a.part_o[row * a.ch + c] = st.o[j];
    }
  }
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
    const float wgt = expf(a.part_m[rs] - mx);  // m in base e, as flash_tile.cuh keeps it
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
  if (ch > flash::CHM || ch <= 0 || split_keys <= 0 || n_split <= 0 ||
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
  const dim3 grid((unsigned)((QT + flash::BQ - 1) / flash::BQ), (unsigned)n_head, nz);
  window_attention_split_kernel<<<grid, flash::NT, 0, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_occ == 0) return (int)e;
  const long long total = (long long)n_occ * n_head * QT * ch;
  window_attention_combine_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(a, total);
  return (int)cudaGetLastError();
}
