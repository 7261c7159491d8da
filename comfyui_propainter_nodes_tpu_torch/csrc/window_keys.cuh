// The key decoders and row functions that the window attention kernels
// (window_attention.cu, window_attention_tiled.cu, window_attention_halo.cu)
// hand to both flash-attention loops: the bf16 loop on the tensor cores
// (flash_mma.cuh) and the fp32 loop on the CUDA cores (flash_f32.cuh).
//
// A decoder maps key j of a sequence to a K and a V row pointer, an
// additive bias and the key's frame. Where a key comes from is the
// caller's business, so one loop serves keys read from partitioned
// windows, padded segment tiles, a halo of the token grid or pooled rows.
// Conventions of a decoded key:
//   * bias == -INFINITY: the key is absent (ragged tile tail), p = 0;
//   * k == nullptr: a padding key with a zero row (score = bias);
//   * frame >= 0 with frame_wsz > 0: the key counts only for rows of the
//     same frame (the clean-window branch); -1 otherwise.
// Biases are added as given (0 or -1e9, not -inf), as in the reference.

#pragma once

#include <cuda_runtime.h>

namespace wkeys {

// window key j of a clean window: its frame restricts it to that frame's rows
template <typename T>
struct FrameKeys {
  const T* wk;
  const T* wv;
  int ch, wsz;
  __device__ __forceinline__ void operator()(int j, const T*& kp, const T*& vp, float& bias,
                                             int& fr) const {
    kp = wk + (long long)j * ch;
    vp = wv + (long long)j * ch;
    bias = 0.0f;
    fr = j / wsz;
  }
};

// the window keys [klo, khi) a clean window's query tile (rows [q0, q0 +
// nq) of QT) attends over: the frames the tile touches
__device__ __forceinline__ void clean_range(int q0, int nq, int QT, int wsz, int& klo, int& khi) {
  klo = (q0 / wsz) * wsz;
  khi = min(QT, ((q0 + nq - 1) / wsz + 1) * wsz);
}

// row rr of a query tile starting at row q0 of a [rows, ch] block
template <typename P>
struct WindowRows {
  P base;
  int q0, ch;
  __device__ __forceinline__ P operator()(int rr) const { return base + (long long)(q0 + rr) * ch; }
};

}  // namespace wkeys
