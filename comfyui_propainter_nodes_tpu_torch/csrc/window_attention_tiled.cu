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
// (4 * QT * keys * ch flops per window and head, about 1.4 GFLOP at the
// 1280x720 shape) against about 2.5 MB of bf16 K/V per window; bytes for
// the clean ones.
//
// Design. The TPU walks a window's segment tiles in order on one core,
// carrying the flash statistics in scratch. Here the tiles become
// independent blocks: each occupied window's padded key sequence is cut
// into splits of SPLIT segment tiles, and one block per (32 queries, head,
// occupied window, split) runs the shared flash tile loop
// (flash_tile.cuh) over its split and writes its partial (m, l, o) to a
// workspace. A combine pass weights each split by exp(m_split - m) and
// normalises. A split whose keys all carry -1e9 (padding, invalid frames)
// has m near -1e9 and p near 1, and that weight makes it vanish, exactly
// as the running max makes such a tile vanish on the TPU. Only occupied
// windows get workspace slots (the wrapper lists them); clean windows run
// their frame-local attention in the same launch and write the output
// directly. A block of an occupied window walks at most SPLIT * SEG_TILE
// keys instead of all of them (about 4.9k at 1280x720), so the last
// occupied blocks no longer set the kernel's end.

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

// blockIdx.z < n_win: window z (clean: the whole attention; occupied: exit);
// blockIdx.z >= n_win: (occupied slot, split) of the listed occupied windows
template <typename T>
__global__ void __launch_bounds__(flash::NT, flash::MIN_BLOCKS)
window_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ wk,
                              const T* __restrict__ wv, const T* __restrict__ rk,
                              const T* __restrict__ rv, const T* __restrict__ pk,
                              const T* __restrict__ pv, const int* __restrict__ occ,
                              const int* __restrict__ occ_list, const float* __restrict__ bw,
                              const float* __restrict__ br, const float* __restrict__ bp,
                              T* __restrict__ out, float* __restrict__ part_m,
                              float* __restrict__ part_l, float* __restrict__ part_o,
                              int n_win, int n_head, int QT, int RL, int RLp, int PL, int PLp,
                              int ch, int n_win_per_b, int wsz, int n_split, int split_keys,
                              float scale) {
  __shared__ flash::Smem<T> sm;
  const int q0 = blockIdx.x * flash::BQ;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const int nq = min(flash::BQ, QT - q0);
  const int r = threadIdx.x >> 2;
  int w, slot = -1, sp = 0;
  if (z < n_win) {
    w = z;
    if (occ[w] != 0) return;  // whole block: occupied windows run as splits
  } else {
    slot = (z - n_win) / n_split;
    sp = (z - n_win) - slot * n_split;
    w = occ_list[slot];
  }
  const int b = w / n_win_per_b;
  const long long wh = (long long)w * n_head + h;
  flash::load_q(sm, nq, ch, flash::WindowRows<const T*>{q + wh * QT * ch, q0, ch});
  flash::Row st;
  flash::init(st);

  if (slot < 0) {  // clean: only the frames this query tile touches
    const int klo = (q0 / wsz) * wsz;
    const int khi = min(QT, ((q0 + nq - 1) / wsz + 1) * wsz);
    flash::attend(sm, st, klo, khi, flash::FrameKeys<T>{wk + wh * QT * ch, wv + wh * QT * ch, ch, wsz},
                  ch, scale, (q0 + r) / wsz);
    if (r < nq) flash::store_row(st, out + (wh * QT + q0 + r) * ch, ch);
    return;
  }

  const long long bh = (long long)b * n_head + h;
  const TiledKeys<T> keys{wk + wh * QT * ch, wv + wh * QT * ch, rk + wh * RL * ch,
                          rv + wh * RL * ch, pk + bh * PL * ch, pv + bh * PL * ch,
                          bw + (long long)b * QT, br + (long long)b * RL, bp + (long long)b * PL,
                          QT, RL, RLp, PL, ch};
  const int total = QT + RLp + PLp;
  const int k0 = sp * split_keys;
  flash::attend(sm, st, k0, min(total, k0 + split_keys), keys, ch, scale, -1);
  if (r < nq) {
    const long long row = (((long long)slot * n_head + h) * n_split + sp) * QT + q0 + r;
    if ((threadIdx.x & 3) == 0) {
      part_m[row] = st.m;
      part_l[row] = st.l;
    }
    const int l4 = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < flash::CHM / 4; ++j) {
      const int c = l4 + 4 * j;
      if (c < ch) part_o[row * ch + c] = st.o[j];
    }
  }
}

// one thread per (occupied slot, head, query, channel): merge the splits
template <typename T>
__global__ void __launch_bounds__(256)
window_attention_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                                const float* __restrict__ part_o, const int* __restrict__ occ_list,
                                T* __restrict__ out, long long total, int n_head, int QT, int ch,
                                int n_split) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % ch);
  const long long row = idx / ch;  // (slot * n_head + h) * QT + qi
  const int qi = (int)(row % QT);
  const long long sh = row / QT;  // slot * n_head + h
  const int h = (int)(sh % n_head);
  const long long slot = sh / n_head;
  const long long first = sh * n_split * QT + qi;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[first + (long long)s * QT]);
  float l = 0.0f, o = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const long long rs = first + (long long)s * QT;
    const float wgt = expf(part_m[rs] - mx);
    l += part_l[rs] * wgt;
    o += part_o[rs * ch + c] * wgt;
  }
  const long long w = occ_list[slot];
  flash::store(out + ((w * n_head + h) * QT + qi) * ch + c, o / l);
}

template <typename T>
int launch(const void* q, const void* wk, const void* wv, const void* rk, const void* rv,
           const void* pk, const void* pv, const int* occ, const int* occ_list,
           const float* bw, const float* br, const float* bp, void* out, float* part_m,
           float* part_l, float* part_o, int n_win, int n_occ, int n_head, int QT, int RL,
           int RLp, int PL, int PLp, int ch, int n_win_per_b, int wsz, int n_split,
           int split_keys, float scale, cudaStream_t s) {
  const dim3 grid((unsigned)((QT + flash::BQ - 1) / flash::BQ), (unsigned)n_head,
                  (unsigned)(n_win + n_occ * n_split));
  window_attention_split_kernel<T><<<grid, flash::NT, 0, s>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(wk),
      reinterpret_cast<const T*>(wv), reinterpret_cast<const T*>(rk),
      reinterpret_cast<const T*>(rv), reinterpret_cast<const T*>(pk),
      reinterpret_cast<const T*>(pv), occ, occ_list, bw, br, bp, reinterpret_cast<T*>(out),
      part_m, part_l, part_o, n_win, n_head, QT, RL, RLp, PL, PLp, ch, n_win_per_b, wsz,
      n_split, split_keys, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_occ == 0) return (int)e;
  const long long total = (long long)n_occ * n_head * QT * ch;
  window_attention_combine_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_m, part_l, part_o, occ_list, reinterpret_cast<T*>(out), total, n_head, QT, ch,
      n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int propainter_window_attention_tiled(
    const void* q, const void* wk, const void* wv, const void* rk, const void* rv,
    const void* pk, const void* pv, const void* occ, const void* occ_list, const void* bw,
    const void* br, const void* bp, void* out, void* part_m, void* part_l, void* part_o,
    int n_win, int n_occ, int n_head, int QT, int RL, int RLp, int PL, int PLp, int ch,
    int n_win_per_b, int wsz, int n_split, int split_keys, float scale, int is_bf16,
    void* stream) {
  if (ch > flash::CHM || ch <= 0 || split_keys <= 0) return (int)cudaErrorInvalidValue;
  if (n_win <= 0 || QT <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* oc = reinterpret_cast<const int*>(occ);
  const int* ol = reinterpret_cast<const int*>(occ_list);
  const float* fbw = reinterpret_cast<const float*>(bw);
  const float* fbr = reinterpret_cast<const float*>(br);
  const float* fbp = reinterpret_cast<const float*>(bp);
  float* pm = reinterpret_cast<float*>(part_m);
  float* pl = reinterpret_cast<float*>(part_l);
  float* po = reinterpret_cast<float*>(part_o);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, wk, wv, rk, rv, pk, pv, oc, ol, fbw, fbr, fbp, out, pm, pl,
                                 po, n_win, n_occ, n_head, QT, RL, RLp, PL, PLp, ch,
                                 n_win_per_b, wsz, n_split, split_keys, scale, s);
  return launch<float>(q, wk, wv, rk, rv, pk, pv, oc, ol, fbw, fbr, fbp, out, pm, pl, po, n_win,
                       n_occ, n_head, QT, RL, RLp, PL, PLp, ch, n_win_per_b, wsz, n_split,
                       split_keys, scale, s);
}
