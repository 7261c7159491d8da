// The bf16 flash-attention tile loop on the tensor cores, shared by the
// single-pass (window_attention.cu), segment-tiled
// (window_attention_tiled.cu) and halo (window_attention_halo.cu) window
// attention kernels. Their fp32 inputs run the CUDA-core loop of
// flash_f32.cuh; both loops take the key decoders of window_keys.cuh.
//
// A block of NT = 128 threads (four warps) owns BQ = 64 query rows of one
// (window, head), 16 rows to a warp. Keys arrive in tiles of BK = 64:
//   * 64 threads decode the tile's keys through the caller's decoder (a K
//     and a V row pointer, an additive bias, the key's frame) two tiles
//     ahead: the decoder's loads are issued before a tile's math and their
//     results stored to shared memory after it, so their latency hides
//     under the math. Every thread issues 16-byte `cp.async` copies of the
//     K and V rows (zero-fill for absent or padding keys). K/V tiles are
//     double-buffered: tile i+1's copies are in flight while tile i
//     computes. Key metadata has three slots; one barrier a tile keeps a
//     slot or a buffer from being rewritten while a warp still reads it.
//   * S = Q·Kᵀ with `mma.sync.m16n8k16` bf16 tiles, fp32 accumulation; the
//     Q fragments are loaded once (`ldmatrix`), K fragments come from the
//     staged tile (`ldmatrix`).
//   * online softmax in registers: each row's scores sit in one quad of
//     threads and reduce with two shuffles; exp2 with log2(e) folded into
//     the scale and the bias; the running max starts at -1e30, so a row
//     whose keys so far are all masked holds p = 0 and no NaN.
//   * O += P·V: P rounded to bf16 in registers is the A operand (the TPU
//     kernel rounds P to the value dtype too), V fragments come from the
//     [key][ch] tile with `ldmatrix.trans`. O (16 x ch fp32 per warp) stays
//     in registers; at the end the caller's epilogue gets it with each
//     row's m and l (StoreRows, the epilogue of all three kernels, divides
//     by l and stores bf16).
// Shared rows are padded by 8 elements: a row stride of an odd number of
// 16-byte units puts the 8 rows of each `ldmatrix` phase on distinct banks.
//
// Conventions of a decoded key (window_keys.cuh):
//   * bias == -INFINITY: the key is absent (ragged tile tail), p = 0;
//   * k == nullptr: a padding key with a zero row (score = bias);
//   * frame >= 0 with frame_wsz > 0: the key counts only for rows of the
//     same frame (row frame = (q0 + row) / frame_wsz, the clean-window
//     branch); -1 otherwise.
// Biases are added as given (0 or -1e9, not -inf), as in the reference.
//
// Head width: ch a multiple of 16, at most CHM. Shared memory: 87 KB at
// ch 128 (dynamic; the launcher raises the limit), so two blocks share an
// SM; MIN_BLOCKS = 2 leaves the compiler up to 255 registers a thread,
// which the 64 O, 32 S and 32 Q fragment registers need without spills.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_keys.cuh"  // FrameKeys, WindowRows, clean_range
#include "mma_prims.cuh"   // smem_u32, cp_async16, ldsm_x4, mma, pack_bf16

namespace fmma {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per staged tile
constexpr int CHM = 128;  // largest head width
constexpr int NT = 128;   // four warps
constexpr int MIN_BLOCKS = 2;
constexpr float LOG2E = 1.4426950408889634f;

struct KeyMeta {
  const bf16* k;
  const bf16* v;
  float bias;
  int frame;
};

// dynamic shared memory of one block: key metadata [3][BK], Q [BQ][ch+8],
// K [2][BK][ch+8], V [2][BK][ch+8]
inline size_t smem_bytes(int ch) {
  return 3 * BK * sizeof(KeyMeta) + (size_t)(BQ + 4 * BK) * (ch + 8) * sizeof(bf16);
}

// The usual epilogue: normalise each row of the tile by its sum and store
// it in bf16 through out_row(rr), the first element of row rr (< nq).
// An epilogue gets the tile's row count nq, this thread's rows r0 and
// r0 + 8, its column pair within each 8-column group (tig), the head width
// in 16-column steps (nks), each row's running max (base 2) and sum, and
// the unnormalised fp32 accumulator fragments: o[nt][0..1] are row r0,
// columns nt * 8 + 2 * tig + {0, 1}; o[nt][2..3] the same columns of row
// r0 + 8.
template <typename ORow>
struct StoreRows {
  const ORow& out_row;
  __device__ __forceinline__ void operator()(int nq, int r0, int tig, int nks, float m0, float m1, float l0,
                                             float l1, const float (&o)[CHM / 8][4]) const {
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
    for (int nt = 0; nt < CHM / 8; ++nt) {
      if (nt < 2 * nks) {
        const int c = nt * 8 + tig * 2;
        if (r0 < nq) *reinterpret_cast<uint32_t*>(out_row(r0) + c) = pack_bf16(o[nt][0] * inv0, o[nt][1] * inv0);
        if (r0 + 8 < nq)
          *reinterpret_cast<uint32_t*>(out_row(r0 + 8) + c) = pack_bf16(o[nt][2] * inv1, o[nt][3] * inv1);
      }
    }
  }
};

// Attention of query rows [0, nq) of a tile over keys [k0, k1) of `dec`,
// finished by the caller's epilogue `epi`. q_row(rr): first element of
// query row rr (< nq). Every
// pointer a decoder or a row function returns is 16-byte aligned (the
// wrappers check the tensors).
template <typename Dec, typename QRow, typename Epi>
__device__ __forceinline__ void attend(unsigned char* smem, int nq, int ch, float scale, int k0, int k1,
                                       const Dec& dec, const QRow& q_row, const Epi& epi, int q0,
                                       int frame_wsz) {
  KeyMeta* meta = reinterpret_cast<KeyMeta*>(smem);
  bf16* sq = reinterpret_cast<bf16*>(smem + 3 * BK * sizeof(KeyMeta));
  const int ld = ch + 8;
  bf16* sk = sq + BQ * ld;
  bf16* sv = sk + 2 * BK * ld;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row within the warp's 8-row half
  const int tig = lane & 3;  // thread within the row's quad
  const int nch = ch >> 3;   // 16-byte chunks per row
  const int nks = ch >> 4;   // 16-wide steps over the channels
  const int n_tiles = (k1 - k0 + BK - 1) / BK;
  const bf16* dummy = q_row(0);

  // key j's metadata: decoded into registers a tile ahead of its store
  auto decode = [&](int t) {
    KeyMeta m{nullptr, nullptr, -INFINITY, -1};
    const int j = k0 + t * BK + tid;
    if (tid < BK && j < k1) dec(j, m.k, m.v, m.bias, m.frame);
    return m;
  };
  auto issue = [&](int t) {
    const KeyMeta* mt = meta + (t % 3) * BK;
    bf16* dk = sk + (t & 1) * BK * ld;
    bf16* dv = sv + (t & 1) * BK * ld;
    for (int idx = tid; idx < BK * nch; idx += NT) {
      const int kk = idx / nch;
      const int c = (idx - kk * nch) * 8;
      const bf16* kp = mt[kk].k;
      const bf16* vp = mt[kk].v;
      cp_async16(smem_u32(dk + kk * ld + c), kp != nullptr ? kp + c : dummy, kp != nullptr ? 16 : 0);
      cp_async16(smem_u32(dv + kk * ld + c), vp != nullptr ? vp + c : dummy, vp != nullptr ? 16 : 0);
    }
  };

  if (tid < BK) {
    meta[tid] = decode(0);
    meta[BK + tid] = decode(1);
  }
  __syncthreads();
  for (int idx = tid; idx < BQ * nch; idx += NT) {
    const int rr = idx / nch;
    const int c = (idx - rr * nch) * 8;
    const bool ok = rr < nq;
    cp_async16(smem_u32(sq + rr * ld + c), ok ? q_row(rr) + c : dummy, ok ? 16 : 0);
  }
  issue(0);
  cp_commit();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int rf0 = frame_wsz > 0 ? (q0 + r0) / frame_wsz : -1;
  const int rf1 = frame_wsz > 0 ? (q0 + r0 + 8) / frame_wsz : -1;
  const float sl2 = scale * LOG2E;
  float m0 = -1.0e30f, m1 = -1.0e30f, l0 = 0.0f, l1 = 0.0f;
  float o[CHM / 8][4];
#pragma unroll
  for (int nt = 0; nt < CHM / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
  uint32_t qf[CHM / 16][4];

  // One barrier a tile. At the top of tile t: this thread's copies of
  // tile t have landed, and after the barrier everyone's have, the
  // metadata of tile t+1 (stored during tile t-1) is visible, and no warp
  // still reads the K/V buffer or the metadata slot that tile t+1 and
  // tile t+2 reuse (both last read by tile t-1).
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1);
    cp_commit();
    const KeyMeta next = decode(t + 2);  // its loads complete under this tile's math
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < CHM / 16; ++ks)
        if (ks < nks) ldsm_x4(qf[ks], smem_u32(sq + (warp * 16 + (lane & 15)) * ld + ks * 16 + (lane >> 4) * 8));
    }
    const bf16* tk = sk + (t & 1) * BK * ld;
    const bf16* tv = sv + (t & 1) * BK * ld;
    const KeyMeta* mt = meta + (t % 3) * BK;

    // S = Q·Kᵀ: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < CHM / 16; ++ks) {
      if (ks < nks) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, smem_u32(tk + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ld + ks * 16 +
                              ((lane >> 3) & 1) * 8));
          mma(s[2 * np], qf[ks], b[0], b[1]);
          mma(s[2 * np + 1], qf[ks], b[2], b[3]);
        }
      }
    }

    // bias, frame mask, online softmax (base 2)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const KeyMeta& km = mt[nt * 8 + tig * 2 + e];
        const bool present = km.bias != -INFINITY;
        const float b2 = km.bias * LOG2E;
        const bool v0 = present && (rf0 < 0 || km.frame == rf0);
        const bool v1 = present && (rf1 < 0 || km.frame == rf1);
        s[nt][e] = v0 ? s[nt][e] * sl2 + b2 : -INFINITY;
        s[nt][2 + e] = v1 ? s[nt][2 + e] * sl2 + b2 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < CHM / 8; ++nt) {
      o[nt][0] *= a0;
      o[nt][1] *= a0;
      o[nt][2] *= a1;
      o[nt][3] *= a1;
    }

    // O += P·V: 16-key steps, P's accumulator layout is the A fragment's
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < CHM / 16; ++np) {
        if (np < nks) {
          uint32_t b[4];
          ldsm_x4_trans(b, smem_u32(tv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + np * 16 +
                                    (lane >> 4) * 8));
          mma(o[2 * np], pa, b[0], b[1]);
          mma(o[2 * np + 1], pa, b[2], b[3]);
        }
      }
    }
    if (tid < BK) meta[((t + 2) % 3) * BK + tid] = next;
  }
  cp_wait<0>();
  epi(nq, r0, tig, nks, m0, m1, l0, l1, o);
}

// One block of a window attention kernel: query rows [q0, q0 + BQ) of a
// window of QT queries in frames of wsz. An occupied window's rows attend
// over keys [0, n_keys) of `occ_keys`; a clean window's over the frames the
// tile touches, each key of `clean_keys` counting for its own frame's rows.
// StoreRows finishes the rows through out_row.
template <typename Occ, typename Clean, typename QRow, typename ORow>
__device__ __forceinline__ void attend_window(unsigned char* smem, int q0, int QT, int wsz, int ch, float scale,
                                              bool occupied, int n_keys, const Occ& occ_keys,
                                              const Clean& clean_keys, const QRow& q_row, const ORow& out_row) {
  const int nq = min(BQ, QT - q0);
  const StoreRows<ORow> out{out_row};
  if (occupied) {
    attend(smem, nq, ch, scale, 0, n_keys, occ_keys, q_row, out, q0, 0);
  } else {
    int klo, khi;
    wkeys::clean_range(q0, nq, QT, wsz, klo, khi);
    attend(smem, nq, ch, scale, klo, khi, clean_keys, q_row, out, q0, wsz);
  }
}

}  // namespace fmma
