// The earlier flash-attention tile loop on the CUDA cores: the fp32 inputs
// of the halo kernel (window_attention_halo.cu), whose bf16 inputs run the
// tensor-core loop of flash_mma.cuh. The single-pass and segment-tiled
// kernels' fp32 inputs run flash_f32.cuh. The key decoders and row
// functions below (FrameKeys, clean_range, WindowRows) serve all three
// loops.
//
// A block of NT = 128 threads owns BQ = 32 query rows of one (window,
// head), four threads to a row. The query tile sits in shared memory in
// fp32. Keys arrive in staged tiles of BK = 16: the first BK threads decode
// their key (a row pointer into K and V, an additive bias, the key's frame)
// through the caller's decoder, then the block stages the tile's K and V
// rows in fp32 and each row continues its online softmax (running max m,
// running sum l, CHM/4 output columns per thread). Where a key comes from
// is the caller's business, so one loop serves keys read from partitioned
// windows, padded segment tiles, a halo of the token grid or pooled rows.
//
// Conventions of a decoded key:
//   * bias == -INFINITY: the key is absent (ragged tile tail), p = 0;
//   * k == nullptr: a padding key with a zero row (score = bias);
//   * frame >= 0 with row_frame >= 0: the key counts only for rows of the
//     same frame (the clean-window branch); -1 otherwise.
// Biases are added as given (0 or -1e9, not -inf), as in the reference.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash {

constexpr int BQ = 32;    // query rows per block
constexpr int BK = 16;    // keys per staged tile
constexpr int CHM = 128;  // largest head width
constexpr int NT = 128;   // threads per block: 4 per query row
// blocks per SM asked of the compiler: caps a kernel at 80 registers. The
// loop waits on shared memory and barriers, so resident warps set its
// rate: on an H100 the halo kernel took 22.4 ms at 154 registers (3
// blocks per SM) and 11.6 ms at this cap (chip_smoke.py, bf16, the
// 640x360 token grid).
constexpr int MIN_BLOCKS = 6;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
struct Smem {
  float q[BQ][CHM + 1];
  float k[BK][CHM + 1];
  float v[BK][CHM];
  float p[BQ][BK + 1];
  const T* kp[BK];
  const T* vp[BK];
  float bias[BK];
  int frame[BK];
};

// online-softmax state of one query row, split over its 4 threads
struct Row {
  float m;
  float l;
  float o[CHM / 4];
};

__device__ __forceinline__ void init(Row& st) {
  st.m = -1.0e30f;
  st.l = 0.0f;
#pragma unroll
  for (int j = 0; j < CHM / 4; ++j) st.o[j] = 0.0f;
}

// query tile: row_ptr(rr) is the first element of query row rr (< nq)
template <typename T, typename RowPtr>
__device__ __forceinline__ void load_q(Smem<T>& sm, int nq, int ch, const RowPtr& row_ptr) {
  for (int idx = threadIdx.x; idx < BQ * ch; idx += NT) {
    const int rr = idx / ch;
    const int c = idx - rr * ch;
    sm.q[rr][c] = rr < nq ? to_f(row_ptr(rr)[c]) : 0.0f;
  }
}

// continue every row's softmax over keys [k0, k1) of `dec`
template <typename T, typename Dec>
__device__ __forceinline__ void attend(Smem<T>& sm, Row& st, int k0, int k1, const Dec& dec,
                                       int ch, float scale, int row_frame) {
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int l4 = tid & 3;
  for (int kb = k0; kb < k1; kb += BK) {
    const int nk = min(BK, k1 - kb);
    __syncthreads();  // earlier readers of the staged tile are done
    if (tid < BK) {
      const T* kp = nullptr;
      const T* vp = nullptr;
      float bias = -INFINITY;
      int fr = -1;
      if (tid < nk) dec(kb + tid, kp, vp, bias, fr);
      sm.kp[tid] = kp;
      sm.vp[tid] = vp;
      sm.bias[tid] = bias;
      sm.frame[tid] = fr;
    }
    __syncthreads();
    for (int idx = tid; idx < BK * ch; idx += NT) {
      const int kk = idx / ch;
      const int c = idx - kk * ch;
      const T* kp = sm.kp[kk];
      const T* vp = sm.vp[kk];
      sm.k[kk][c] = kp != nullptr ? to_f(kp[c]) : 0.0f;
      sm.v[kk][c] = vp != nullptr ? to_f(vp[c]) : 0.0f;
    }
    __syncthreads();

    // scores for keys l4, l4 + 4, l4 + 8, l4 + 12 of this tile
    float s[BK / 4];
#pragma unroll
    for (int mm = 0; mm < BK / 4; ++mm) s[mm] = 0.0f;
    for (int c = 0; c < ch; ++c) {
      const float qv = sm.q[r][c];
#pragma unroll
      for (int mm = 0; mm < BK / 4; ++mm) s[mm] += qv * sm.k[l4 + 4 * mm][c];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int mm = 0; mm < BK / 4; ++mm) {
      const int kk = l4 + 4 * mm;
      const float b = sm.bias[kk];
      const bool valid = b != -INFINITY && (row_frame < 0 || sm.frame[kk] == row_frame);
      s[mm] = valid ? s[mm] * scale + b : -INFINITY;
      mx = fmaxf(mx, s[mm]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m, mx);
    const float alpha = expf(st.m - m_new);
    float ps = 0.0f;
#pragma unroll
    for (int mm = 0; mm < BK / 4; ++mm) {
      const float pv = expf(s[mm] - m_new);
      sm.p[r][l4 + 4 * mm] = pv;
      ps += pv;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    st.l = st.l * alpha + ps;
    st.m = m_new;
#pragma unroll
    for (int j = 0; j < CHM / 4; ++j) st.o[j] *= alpha;
    __syncthreads();  // p complete for every row
    for (int kk = 0; kk < nk; ++kk) {
      const float pv = sm.p[r][kk];
#pragma unroll
      for (int j = 0; j < CHM / 4; ++j) {
        const int c = l4 + 4 * j;
        if (c < ch) st.o[j] += pv * sm.v[kk][c];
      }
    }
  }
}

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

// write a finished row (o / l) of a query tile in the output type
template <typename T>
__device__ __forceinline__ void store_row(const Row& st, T* dst, int ch) {
  const float inv = 1.0f / st.l;
  const int l4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < CHM / 4; ++j) {
    const int c = l4 + 4 * j;
    if (c < ch) store(dst + c, st.o[j] * inv);
  }
}

}  // namespace flash
