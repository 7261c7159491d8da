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
// (QT + T_sel*148 + PL) * ch flops per window and head) against the
// window's q/k/v, its halo rows and the pooled keys; bytes for clean ones.
//
// Design: window q/k/v/out rows are addressed in the token grid with
// strides, so there is no partition or un-partition pass and no rolled
// copy: the halo rows are read from the padded grid, and only by occupied
// windows. The halo segment enumerates only the survivor positions of each
// t_ind frame (148 of 209 for a (5, 9) window, from a table the wrapper
// builds from halo_bias_static), so an occupied window walks as many keys
// as the single-pass kernel's rolled segment. Skipping the others changes
// nothing in fp32: their static bias is -1e9, and every row also holds a
// key whose bias is 1e9 larger (the survivors of the same frame), so their
// weight exp(-1e9 - m) is an exact 0. The window, halo and pooled segments
// are one key sequence for one flash loop. bf16 inputs take the
// tensor-core loop (flash_mma.cuh: 64-query blocks, `mma.sync` bf16 tiles
// for Q·Kᵀ and P·V, 64-key K/V tiles double-buffered by `cp.async`), which
// puts the occupied windows' products on the tensor cores; fp32 inputs
// take the CUDA-core loop of B3 and B4 (flash_f32.cuh: 64-query blocks of
// 128 threads, register blocks of S and O fed by float4 shared loads,
// 32-key K/V tiles double-buffered by `cp.async`, 16-byte copies where ch
// % 4 == 0 and every tensor is 16-byte aligned, 4-byte copies otherwise).
// Both loops run the same decoders. A clean window passes a null bias:
// its keys then carry their frame, which the fp32 loop holds against each
// query row's frame, so a 64-query tile that spans three frames attends
// within each. The pooled keys stream through the same tiles (the TPU's
// 1024-key DMA chunks and their -1e9 padding exist only to bound its VMEM
// blocks).

#include "flash_f32.cuh"
#include "flash_mma.cuh"

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

// halo key j: t_ind frame j / n_surv, survivor surv[j % n_surv], a
// position (py, px) of the frame's hh x hw halo
template <typename T>
struct HaloKeys {
  const T* k;
  const T* v;
  const float* bias;  // [T_sel, hh*hw]
  const int* surv;    // [n_surv] halo positions
  long long frame_stride;
  int row_stride, C, hw, hhw, n_surv;
  __device__ __forceinline__ void operator()(int j, const T*& kp, const T*& vp, float& b,
                                             int& fr) const {
    const int ts = j / n_surv;
    const int pos = __ldg(surv + (j - ts * n_surv));
    const int py = pos / hw;
    const long long off = ts * frame_stride + (long long)py * row_stride + (long long)(pos - py * hw) * C;
    kp = k + off;
    vp = v + off;
    b = bias[ts * hhw + pos];
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
// (one flash loop instance keeps the register count down: three
// instances in a row needed twice as many)
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

// query row rr of a tile starting at query q0 of a window, in the grid
template <typename P>
struct GridRows {
  P base;  // the window's first token, head h
  long long frame_stride;
  int row_stride, C, ww, wsz, q0;
  __device__ __forceinline__ P operator()(int rr) const {
    const int qi = q0 + rr;
    const int t = qi / wsz;
    const int p = qi - t * wsz;
    const int y = p / ww;
    return base + (t * frame_stride + (long long)y * row_stride + (long long)(p - y * ww) * C);
  }
};

struct Args {
  const void *q, *k, *v, *kh, *vh, *pk, *pv;
  const int* occ;
  const float *bw, *bh, *bp;
  const int* surv;
  void* out;
  int T_, T_sel, Hp, Wp, C, n_head, wh, ww, eh, ew, PL, nwh, nww, n_surv;
  float scale;
};

// one (window, head): where its rows live and which keys it attends
template <typename T>
struct Window {
  GridRows<const T*> rows;
  GridRows<T*> out;
  OccupiedKeys<T> keys;  // valid if occupied
  GridKeys<T> clean;
  bool occupied;
  int QT, wsz;
};

template <typename T>
__device__ __forceinline__ Window<T> window(const Args& a, int q0) {
  const int ch = a.C / a.n_head;
  const int wsz = a.wh * a.ww;
  const int QT = a.T_ * wsz;
  const int h = blockIdx.y;
  const int z = blockIdx.z;  // (b, wy, wx), the layout of occ
  const int b = z / (a.nwh * a.nww);
  const int wi = z - b * a.nwh * a.nww;
  const int wy = wi / a.nww;
  const int wx = wi - wy * a.nww;
  // the window's first token (frame 0, row wy*wh, col wx*ww), head h
  const long long fs = (long long)a.Hp * a.Wp * a.C;
  const long long win0 = (long long)b * a.T_ * fs + ((long long)wy * a.wh * a.Wp + (long long)wx * a.ww) * a.C + h * ch;
  const int rs = a.Wp * a.C;
  const T* k = static_cast<const T*>(a.k) + win0;
  const T* v = static_cast<const T*>(a.v) + win0;
  const int hh = a.wh + 2 * a.eh, hw = a.ww + 2 * a.ew;
  const int Wpp = a.Wp + 2 * a.ew;
  const long long hfs = (long long)(a.Hp + 2 * a.eh) * Wpp * a.C;
  const long long halo0 = (long long)b * a.T_sel * hfs + ((long long)wy * a.wh * Wpp + (long long)wx * a.ww) * a.C + h * ch;
  const long long bhd = ((long long)b * a.n_head + h) * a.PL * ch;
  const int HL = a.T_sel * a.n_surv;
  return Window<T>{
      GridRows<const T*>{static_cast<const T*>(a.q) + win0, fs, rs, a.C, a.ww, wsz, q0},
      GridRows<T*>{static_cast<T*>(a.out) + win0, fs, rs, a.C, a.ww, wsz, q0},
      OccupiedKeys<T>{
          GridKeys<T>{k, v, a.bw + (long long)b * QT, fs, rs, a.C, a.ww, wsz},
          HaloKeys<T>{static_cast<const T*>(a.kh) + halo0, static_cast<const T*>(a.vh) + halo0,
                      a.bh + (long long)b * a.T_sel * hh * hw, a.surv, hfs, Wpp * a.C, a.C, hw,
                      hh * hw, a.n_surv},
          PooledKeys<T>{static_cast<const T*>(a.pk) + bhd, static_cast<const T*>(a.pv) + bhd,
                        a.bp + (long long)b * a.PL, ch},
          QT, HL},
      GridKeys<T>{k, v, nullptr, fs, rs, a.C, a.ww, wsz},
      a.occ[z] != 0, QT, wsz};
}

// bf16: the tensor-core loop, one block per (64 queries, head, window)
__global__ void __launch_bounds__(fmma::NT, fmma::MIN_BLOCKS) window_attention_halo_mma_kernel(Args a) {
  using T = fmma::bf16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * fmma::BQ;
  const Window<T> w = window<T>(a, q0);
  fmma::attend_window(smem, q0, w.QT, w.wsz, a.C / a.n_head, a.scale, w.occupied, w.keys.QT + w.keys.HL + a.PL,
                      w.keys, w.clean, w.rows, w.out);
}

// fp32: the CUDA-core loop, one block per (64 queries, head, window);
// VEC: 16-byte copies (ch % 4 == 0, every tensor 16-byte aligned)
template <bool VEC>
__global__ void __launch_bounds__(ff32::NT, ff32::MIN_BLOCKS) window_attention_halo_f32_kernel(Args a) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * ff32::BQ;
  const Window<T> w = window<T>(a, q0);
  ff32::attend_window<VEC>(smem, q0, w.QT, w.wsz, a.C / a.n_head, a.scale, w.occupied,
                           w.keys.QT + w.keys.HL + a.PL, w.keys, w.clean, w.rows, w.out);
}

template <bool VEC>
cudaError_t launch_f32(const Args& a, const dim3& grid, cudaStream_t s) {
  const size_t smem = ff32::smem_bytes(a.C / a.n_head);
  const cudaError_t e = cudaFuncSetAttribute(window_attention_halo_f32_kernel<VEC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  window_attention_halo_f32_kernel<VEC><<<grid, ff32::NT, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int propainter_window_attention_halo(
    const void* q, const void* k, const void* v, const void* kh, const void* vh, const void* pk,
    const void* pv, const void* occ, const void* bw, const void* bh, const void* bp,
    const void* surv, void* out, int B, int T_, int T_sel, int Hp, int Wp, int C, int n_head,
    int wh, int ww, int PL, int n_surv, float scale, int is_bf16, void* stream) {
  const int eh = (wh + 1) / 2, ew = (ww + 1) / 2;
  if (n_head <= 0 || C % n_head != 0 || C / n_head > ff32::CHM || Hp % wh != 0 || Wp % ww != 0 ||
      (is_bf16 && (C / n_head) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int nwh = Hp / wh, nww = Wp / ww;
  const int QT = T_ * wh * ww;
  if (B <= 0 || QT <= 0 || nwh == 0 || nww == 0) return (int)cudaGetLastError();
  const Args a{q, k, v, kh, vh, pk, pv, static_cast<const int*>(occ), static_cast<const float*>(bw),
               static_cast<const float*>(bh), static_cast<const float*>(bp),
               static_cast<const int*>(surv), out, T_, T_sel, Hp, Wp, C, n_head, wh, ww, eh, ew, PL,
               nwh, nww, n_surv, scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const size_t smem = fmma::smem_bytes(C / n_head);
    const cudaError_t e = cudaFuncSetAttribute(window_attention_halo_mma_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((QT + fmma::BQ - 1) / fmma::BQ), (unsigned)n_head, (unsigned)(B * nwh * nww));
    window_attention_halo_mma_kernel<<<grid, fmma::NT, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((QT + ff32::BQ - 1) / ff32::BQ), (unsigned)n_head, (unsigned)(B * nwh * nww));
  const bool vec = (C / n_head) % 4 == 0 && ff32::aligned16({q, k, v, kh, vh, pk, pv, out});
  return (int)(vec ? launch_f32<true>(a, grid, s) : launch_f32<false>(a, grid, s));
}
