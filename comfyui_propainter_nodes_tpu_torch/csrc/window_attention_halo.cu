// Window attention read straight from the token grid (halo form), sm_90a.
//
// Replaces the TPU kernel
// comfyui_propainter_nodes_tpu/ops/pallas/window_attention_halo.py
// (`_kernel`, launched by `window_attention_halo`, the attention under
// PROPAINTER_TPU_ATTN=halo).
//
// What it computes: the sparse window attention of ops/attention.py, with
// its inputs left as token grids. For window (b, wy, wx) of (wh, ww)
// tokens and head h (scale 1/sqrt(ch)):
//   * occupied window: all QT = T*wh*ww queries attend over [the window's
//     keys + bias_w | the (wh+2eh) x (ww+2ew) halo of the circularly
//     padded K/V grid at each t_ind frame + bias_h | the pooled keys +
//     bias_p]. bias_h is the static survivor bias (0 at the 148 halo
//     positions that the four rolled K/V copies bring into the window,
//     -1e9 at the other 61) plus the frame's validity bias, so attention
//     over the halo is attention over the reference's rolled keys;
//   * clean window: each frame's wh*ww queries attend within the same
//     frame's window keys, no bias.
// q/k/v/out are [B, T, Hp, Wp, C], khalo/vhalo [B, T_sel, Hp+2eh, Wp+2ew, C],
// pooled K/V [B, head, PL, ch]; fp32 or bf16 with fp32 statistics.
//
// What bounds it on the H100: operations for occupied windows (4 * QT *
// (QT + T_sel*209 + PL) * ch flops per window and head) against the
// window's q/k/v, its halo rows and the pooled keys; bytes for clean ones.
//
// Design: one block per (32 queries, head, window), as the single-pass
// kernel, running the shared flash tile loop (flash_tile.cuh). Window
// q/k/v/out rows are addressed in the token grid with strides, so there is
// no partition or un-partition pass and no rolled copy: the halo rows are
// read from the padded grid, and only by occupied windows. Pooled keys
// stream through the same 16-key staged tiles (the TPU's 1024-key DMA
// chunks and their -1e9 padding exist only to bound its VMEM blocks).

#include "flash_tile.cuh"

namespace {

// key j of a window in a token grid: frame j / wsz, position j % wsz
template <typename T>
struct GridKeys {
  const T* k;
  const T* v;
  const float* bias;  // nullptr: clean window (no bias, frame-local)
  long long frame_stride;
  int row_stride, C, ww, wsz;
  __device__ __forceinline__ void operator()(int j, const T*& kp, const T*& vp, float& b,
                                             int& fr) const {
    const int t = j / wsz;
    const int rr = j - t * wsz;
    const int y = rr / ww;
    const long long off = t * frame_stride + (long long)y * row_stride + (long long)(rr - y * ww) * C;
    kp = k + off;
    vp = v + off;
    if (bias != nullptr) {
      b = bias[j];
    } else {
      b = 0.0f;
      fr = t;
    }
  }
};

// halo key j: t_ind frame j / (hh*hw), position (py, px) in the halo
template <typename T>
struct HaloKeys {
  const T* k;
  const T* v;
  const float* bias;
  long long frame_stride;
  int row_stride, C, hw, hhw;
  __device__ __forceinline__ void operator()(int j, const T*& kp, const T*& vp, float& b,
                                             int& fr) const {
    const int ts = j / hhw;
    const int pos = j - ts * hhw;
    const int py = pos / hw;
    const long long off = ts * frame_stride + (long long)py * row_stride + (long long)(pos - py * hw) * C;
    kp = k + off;
    vp = v + off;
    b = bias[j];
  }
};

template <typename T>
struct PooledKeys {
  const T* k;
  const T* v;
  const float* bias;
  int ch;
  __device__ __forceinline__ void operator()(int j, const T*& kp, const T*& vp, float& b,
                                             int& fr) const {
    kp = k + (long long)j * ch;
    vp = v + (long long)j * ch;
    b = bias[j];
  }
};

// the keys of an occupied window as one sequence: [window | halo | pooled]
// (one flash loop instance keeps the kernel at the register count of the
// tiled kernel, where three instances needed twice as many)
template <typename T>
struct OccupiedKeys {
  GridKeys<T> win;
  HaloKeys<T> halo;
  PooledKeys<T> pooled;
  int QT, HL;
  __device__ __forceinline__ void operator()(int j, const T*& kp, const T*& vp, float& b,
                                             int& fr) const {
    if (j < QT) {
      win(j, kp, vp, b, fr);
    } else if (j - QT < HL) {
      halo(j - QT, kp, vp, b, fr);
    } else {
      pooled(j - QT - HL, kp, vp, b, fr);
    }
  }
};

// offset of query qi of a window from the window's first token
__device__ __forceinline__ long long grid_offset(int qi, long long frame_stride, int row_stride,
                                                 int C, int ww, int wsz) {
  const int t = qi / wsz;
  const int p = qi - t * wsz;
  const int y = p / ww;
  return t * frame_stride + (long long)y * row_stride + (long long)(p - y * ww) * C;
}

template <typename T>
struct GridRows {
  const T* base;
  long long frame_stride;
  int row_stride, C, ww, wsz, q0;
  __device__ __forceinline__ const T* operator()(int rr) const {
    return base + grid_offset(q0 + rr, frame_stride, row_stride, C, ww, wsz);
  }
};

template <typename T>
__global__ void __launch_bounds__(flash::NT, flash::MIN_BLOCKS)
window_attention_halo_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ kh,
                             const T* __restrict__ vh, const T* __restrict__ pk,
                             const T* __restrict__ pv, const int* __restrict__ occ,
                             const float* __restrict__ bw, const float* __restrict__ bh,
                             const float* __restrict__ bp, T* __restrict__ out, int T_,
                             int T_sel, int Hp, int Wp, int C, int n_head, int wh, int ww, int eh,
                             int ew, int PL, int nwh, int nww, float scale) {
  __shared__ flash::Smem<T> sm;
  const int ch = C / n_head;
  const int wsz = wh * ww;
  const int QT = T_ * wsz;
  const int q0 = blockIdx.x * flash::BQ;
  const int h = blockIdx.y;
  const int z = blockIdx.z;  // (b, wy, wx), the layout of occ
  const int b = z / (nwh * nww);
  const int wi = z - b * nwh * nww;
  const int wy = wi / nww;
  const int wx = wi - wy * nww;
  const int nq = min(flash::BQ, QT - q0);
  const int r = threadIdx.x >> 2;

  // the window's first token (frame 0, row wy*wh, col wx*ww), head h
  const long long fs = (long long)Hp * Wp * C;
  const long long win0 = (long long)b * T_ * fs + ((long long)wy * wh * Wp + (long long)wx * ww) * C + h * ch;
  const GridRows<T> rows{q + win0, fs, Wp * C, C, ww, wsz, q0};
  flash::load_q(sm, nq, ch, rows);
  flash::Row st;
  flash::init(st);

  if (occ[z] != 0) {
    const int hh = wh + 2 * eh, hw = ww + 2 * ew;
    const int HL = T_sel * hh * hw;
    const int Wpp = Wp + 2 * ew;
    const long long hfs = (long long)(Hp + 2 * eh) * Wpp * C;
    const long long halo0 = (long long)b * T_sel * hfs + ((long long)wy * wh * Wpp + (long long)wx * ww) * C + h * ch;
    const long long bhd = ((long long)b * n_head + h) * PL * ch;
    const OccupiedKeys<T> keys{
        GridKeys<T>{k + win0, v + win0, bw + (long long)b * QT, fs, Wp * C, C, ww, wsz},
        HaloKeys<T>{kh + halo0, vh + halo0, bh + (long long)b * HL, hfs, Wpp * C, C, hw, hh * hw},
        PooledKeys<T>{pk + bhd, pv + bhd, bp + (long long)b * PL, ch}, QT, HL};
    flash::attend(sm, st, 0, QT + HL + PL, keys, ch, scale, -1);
  } else {  // clean: only the frames this query tile touches
    const int klo = (q0 / wsz) * wsz;
    const int khi = min(QT, ((q0 + nq - 1) / wsz + 1) * wsz);
    flash::attend(sm, st, klo, khi, GridKeys<T>{k + win0, v + win0, nullptr, fs, Wp * C, C, ww, wsz},
                  ch, scale, (q0 + r) / wsz);
  }
  if (r < nq) {
    flash::store_row(st, out + win0 + grid_offset(q0 + r, fs, Wp * C, C, ww, wsz), ch);
  }
}

}  // namespace

extern "C" int propainter_window_attention_halo(
    const void* q, const void* k, const void* v, const void* kh, const void* vh, const void* pk,
    const void* pv, const void* occ, const void* bw, const void* bh, const void* bp, void* out,
    int B, int T_, int T_sel, int Hp, int Wp, int C, int n_head, int wh, int ww, int PL,
    float scale, int is_bf16, void* stream) {
  const int eh = (wh + 1) / 2, ew = (ww + 1) / 2;
  if (n_head <= 0 || C % n_head != 0 || C / n_head > flash::CHM || Hp % wh != 0 || Wp % ww != 0)
    return (int)cudaErrorInvalidValue;
  const int nwh = Hp / wh, nww = Wp / ww;
  const int QT = T_ * wh * ww;
  if (B <= 0 || QT <= 0 || nwh == 0 || nww == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((QT + flash::BQ - 1) / flash::BQ), (unsigned)n_head,
                  (unsigned)(B * nwh * nww));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* oc = reinterpret_cast<const int*>(occ);
  const float* fbw = reinterpret_cast<const float*>(bw);
  const float* fbh = reinterpret_cast<const float*>(bh);
  const float* fbp = reinterpret_cast<const float*>(bp);
  const float sc = scale;
  if (is_bf16) {
    using T = __nv_bfloat16;
    window_attention_halo_kernel<T><<<grid, flash::NT, 0, s>>>(
        reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k), reinterpret_cast<const T*>(v),
        reinterpret_cast<const T*>(kh), reinterpret_cast<const T*>(vh),
        reinterpret_cast<const T*>(pk), reinterpret_cast<const T*>(pv), oc, fbw, fbh, fbp,
        reinterpret_cast<T*>(out), T_, T_sel, Hp, Wp, C, n_head, wh, ww, eh, ew, PL, nwh, nww, sc);
  } else {
    using T = float;
    window_attention_halo_kernel<T><<<grid, flash::NT, 0, s>>>(
        reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k), reinterpret_cast<const T*>(v),
        reinterpret_cast<const T*>(kh), reinterpret_cast<const T*>(vh),
        reinterpret_cast<const T*>(pk), reinterpret_cast<const T*>(pv), oc, fbw, fbh, fbp,
        reinterpret_cast<T*>(out), T_, T_sel, Hp, Wp, C, n_head, wh, ww, eh, ew, PL, nwh, nww, sc);
  }
  return (int)cudaGetLastError();
}
