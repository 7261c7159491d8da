// The fp32 flash-attention loop on the CUDA cores, for the fp32 inputs of
// the single-pass (window_attention.cu), segment-tiled
// (window_attention_tiled.cu) and halo (window_attention_halo.cu) window
// attention kernels. bf16 inputs run the tensor-core loop of
// flash_mma.cuh; both loops take the key decoders of window_keys.cuh.
//
// What bounds it: occupied windows are operations (4 * rows * keys * ch
// flops), done as fp32 FFMAs: TF32 tensor cores would not hold fp32's
// tolerance. An SM issues 128 FFMA lanes a clock but its shared memory
// returns 32 floats a clock to the threads (128 bytes, broadcast or not),
// so the loop needs about 4 FFMAs for each float a thread loads, as a
// register-blocked SGEMM does; the earlier loop (32-query, 16-key tiles,
// one output row to four threads) did fewer than one.
//
// A block of NT = 128 threads (four warps) owns BQ = 64 query rows of one
// (window, head), WR = 16 rows to a warp. Keys arrive in tiles of BK = 32.
//   * 32 threads decode the tile's keys through the caller's decoder (a K
//     and a V row pointer, an additive bias, the key's frame) two tiles
//     ahead: the decoder's loads are issued before a tile's math and their
//     results stored to shared memory after it. K and V rows are staged
//     row-major ([key][ld]) by `cp.async`, 16 bytes a copy where every row
//     is 16-byte aligned (ch % 4 == 0 and aligned tensors: VEC), 4 bytes a
//     copy otherwise; absent and padding keys and the columns past ch are
//     zero-filled. K/V tiles are double-buffered: tile t+1's copies are in
//     flight while tile t computes; key metadata has three slots; one
//     barrier a tile.
//   * S = Q·Kᵀ: lane 8p + g of a warp computes a 4 x 4 block of S (the
//     warp's rows 4p .. 4p + 3, keys g, g + 8, g + 16, g + 24), four
//     channels a step: four float4 loads of Q and four of K (32 floats)
//     feed 64 FFMAs. A quarter warp reads one Q row (a broadcast) and 8
//     consecutive K rows; the row pitch ld = round_up(ch, 8) + 4 floats is
//     an odd number of 16-byte units, so those rows fall on distinct banks.
//   * Online softmax in registers, base e (expf): the row max over the
//     lane's 4 keys, then 3 shuffles over the row's 8 lanes; the running
//     max starts at -1e30, so a row whose keys so far are all masked holds
//     p = 0 and no NaN. Each lane keeps a partial row sum over its own keys
//     (rescaled with the row), reduced once at the end. In a clean window
//     a warp skips the key tiles of frames its 16 rows do not hold (their
//     p would all be exact zeros).
//   * O = O * alpha + P·V: lane 16h + cg holds rows 8h .. 8h + 7 of its
//     warp x the columns of float4 groups cg and cg + 16 (64 accumulators
//     at ch 128). P and each row's rescale factor alpha go through a
//     per-warp shared buffer (P as [key][16 rows], pitch 20 floats:
//     conflict-free float4 stores) with a __syncwarp only: a warp reads
//     only its own rows. Per key two float4 loads of P and two of V (16
//     floats) feed 64 FFMAs.
// A 32-key tile at ch 128 thus does 2.67 FFMAs a float loaded: the loop
// can reach about two thirds of the FFMA peak before shared memory's
// return path stops it. Shared memory at ch 128: Q 33 KB, K/V 2 x 2 x 16.5
// KB, the warps' buffers 10 KB, key metadata 2.3 KB: 113 KB, so two blocks
// (eight warps) share an SM, and MIN_BLOCKS = 2 leaves the compiler up to
// 255 registers a thread (64 O, 16 S, 32 fragment registers; ptxas gives
// 218-230, no spills). Measured on the H100 against two other shapes of
// the same loop: 256 threads with a 2 x 4 block of S and 2 rows x 16
// columns of O (1.5 FFMAs a float; capped at 128 registers, it spilled)
// took 1.6x the time of this loop at path A's shapes (B3 and B4); two
// warps of 32 rows with an 8 x 4 block of S and 8 rows x 16 columns of O
// (3.56 FFMAs a float) needed more than 255 registers, spilled, and ran
// slower at every shape. A 64-key tile needs 178 KB a block: one block
// and four warps an SM.
//
// Conventions of a decoded key (window_keys.cuh):
//   * bias == -INFINITY: the key is absent (ragged tile tail), p = 0;
//   * k == nullptr: a padding key with a zero row (score = bias);
//   * frame >= 0 with frame_wsz > 0: the key counts only for rows of the
//     same frame (row frame = (q0 + row) / frame_wsz, the clean-window
//     branch); -1 otherwise.
// Biases are added as given (0 or -1e9, not -inf), as in the reference.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "window_keys.cuh"  // FrameKeys, WindowRows, clean_range
#include "mma_prims.cuh"   // smem_u32, cp_async16, cp_commit, cp_wait

namespace ff32 {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 32;    // keys per staged tile
constexpr int CHM = 128;  // largest head width
constexpr int NT = 128;   // four warps
constexpr int MIN_BLOCKS = 2;
constexpr int WR = 16;                   // query rows a warp
constexpr int RO = 8;                    // O rows a lane
constexpr int NC = CHM / 64;             // O float4 column groups a lane at CHM
constexpr int PLD = WR + 4;              // P buffer pitch: 16 rows + 4
constexpr int WBUF = BK * PLD + 2 * WR;  // a warp's buffer: P, then two values a row

struct KeyMeta {
  const float* k;
  const float* v;
  float bias;
  int frame;
};

// row pitch of the staged Q, K and V tiles, in floats
__host__ __device__ inline int row_ld(int ch) { return ((ch + 7) & ~7) + 4; }

// dynamic shared memory of one block: key metadata [3][BK], Q [BQ][ld],
// K [2][BK][ld], V [2][BK][ld], the warps' buffers [NT / 32][WBUF]
inline size_t smem_bytes(int ch) {
  return 3 * BK * sizeof(KeyMeta) + ((size_t)(BQ + 4 * BK) * row_ld(ch) + (NT / 32) * WBUF) * sizeof(float);
}

// true when every pointer is 16-byte aligned (the launchers' VEC test)
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// 4 bytes global -> shared; src_bytes 0 writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// Copy unit c of a row into shared memory: VEC, the 16 bytes of columns
// 4c .. 4c + 3 (ch a multiple of 4); else the 4 bytes of column c, zero
// past ch. A null row is zeros.
template <bool VEC>
__device__ __forceinline__ void copy_unit(float* dst, const float* src, int c, int ch, const float* dummy) {
  if (VEC) {
    fmma::cp_async16(fmma::smem_u32(dst + 4 * c), src != nullptr ? src + 4 * c : dummy, src != nullptr ? 16 : 0);
  } else {
    const bool ok = src != nullptr && c < ch;
    cp_async4(fmma::smem_u32(dst + c), ok ? src + c : dummy, ok ? 4 : 0);
  }
}

// Copy units a row of a staged tile: ch / 4 (VEC) or round_up(ch, 4)
template <bool VEC>
__device__ __forceinline__ int row_units(int ch) { return VEC ? ch >> 2 : (ch + 3) & ~3; }

// f(r, c) once for every row r < n and unit c < nc (nc <= NT), spread
// over the block's threads with one division a thread
template <typename F>
__device__ __forceinline__ void for_units(int n, int nc, const F& f) {
  int r = threadIdx.x / nc;
  int c = threadIdx.x - r * nc;
  const int dr = NT / nc;
  const int dc = NT - dr * nc;
  while (r < n) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
}

__device__ __forceinline__ float4 scaled(float4 a, float s) { return make_float4(a.x * s, a.y * s, a.z * s, a.w * s); }

// Store 4 values at columns c .. c + 3 of a row (VEC: one float4; else
// those below ch)
template <bool VEC>
__device__ __forceinline__ void store4(float* dst, int c, int ch, float4 v) {
  if (VEC) {
    *reinterpret_cast<float4*>(dst + c) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < ch) dst[c + j] = e[j];
  }
}

// What an epilogue finishes: this lane's RO rows r0 .. r0 + RO - 1 of the
// tile (those below nq count), each row's running max (base e) and full
// sum, and the unnormalised accumulators o[row][k] of columns 4 cg + 64 k
// .. + 3 (k < NC; those below ch count).
struct Rows {
  int nq, r0, cg, ch;
  const float (&m)[RO];
  const float (&l)[RO];
  const float4 (&o)[RO][NC];
};

// The usual epilogue: normalise each row by its sum and store it through
// out_row(rr), the first element of row rr.
template <bool VEC, typename ORow>
struct StoreRows {
  const ORow& out_row;
  __device__ __forceinline__ void operator()(const Rows& r) const {
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      if (r.r0 + i >= r.nq) continue;
      const float inv = 1.0f / r.l[i];
      float* dst = out_row(r.r0 + i);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = 4 * r.cg + 64 * k;
        if (c < r.ch) store4<VEC>(dst, c, r.ch, scaled(r.o[i][k], inv));
      }
    }
  }
};

// Attention of query rows [0, nq) of a tile over keys [k0, k1) of `dec`,
// finished by the caller's epilogue `epi`. q_row(rr): first element of
// query row rr (< nq). Under VEC every pointer a decoder or a row function
// returns is 16-byte aligned (the launchers check the tensors).
template <bool VEC, typename Dec, typename QRow, typename Epi>
__device__ __forceinline__ void attend(unsigned char* smem, int nq, int ch, float scale, int k0, int k1,
                                       const Dec& dec, const QRow& q_row, const Epi& epi, int q0, int frame_wsz) {
  KeyMeta* meta = reinterpret_cast<KeyMeta*>(smem);
  const int ld = row_ld(ch);
  float* sq = reinterpret_cast<float*>(smem + 3 * BK * sizeof(KeyMeta));
  float* sk = sq + BQ * ld;
  float* sv = sk + 2 * BK * ld;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* wb = sv + 2 * BK * ld + warp * WBUF;  // this warp's P [BK][PLD]
  float* wstat = wb + BK * PLD;                // and two values a row
  const int chp = (ch + 3) & ~3;
  const int n_tiles = (k1 - k0 + BK - 1) / BK;
  const float* dummy = q_row(0);

  auto decode = [&](int t) {
    KeyMeta m{nullptr, nullptr, -INFINITY, -1};
    const int j = k0 + t * BK + tid;
    if (tid < BK && j < k1) dec(j, m.k, m.v, m.bias, m.frame);
    return m;
  };
  const int nu = row_units<VEC>(ch);
  auto issue = [&](int t) {  // tile t's K and V rows
    const KeyMeta* mt = meta + (t % 3) * BK;
    float* dk = sk + (t & 1) * BK * ld;
    float* dv = sv + (t & 1) * BK * ld;
    for_units(BK, nu, [&](int r, int c) {
      copy_unit<VEC>(dk + r * ld, mt[r].k, c, ch, dummy);
      copy_unit<VEC>(dv + r * ld, mt[r].v, c, ch, dummy);
    });
  };

  if (tid < BK) {
    meta[tid] = decode(0);
    meta[BK + tid] = decode(1);
  }
  __syncthreads();
  for_units(BQ, nu, [&](int r, int c) { copy_unit<VEC>(sq + r * ld, r < nq ? q_row(r) : nullptr, c, ch, dummy); });
  issue(0);
  fmma::cp_commit();

  // S mapping: rows sr .. sr + 3 of the warp's WR, keys g + 8j
  const int p = lane >> 3;
  const int g = lane & 7;
  const int sr = 4 * p;
  // O mapping: rows orow .. orow + RO - 1 of the warp's WR, column groups cg, cg + 16
  const int cg = lane & 15;
  const int orow = RO * (lane >> 4);
  int rf[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rf[i] = frame_wsz > 0 ? (q0 + warp * WR + sr + i) / frame_wsz : -1;
  float m[4], l[4];  // per S row: running max, this lane's keys' share of the sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1.0e30f;
    l[i] = 0.0f;
  }
  float4 o[RO][NC];
#pragma unroll
  for (int i = 0; i < RO; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) o[i][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* qs = sq + (warp * WR + sr) * ld;
  const bool col1 = 4 * cg + 64 < chp;  // this lane's second column group is in the head
  // frames of this warp's rows (a clean window's): a key tile outside them
  // has every p of the warp 0, alpha 1, and is skipped
  const int wf0 = frame_wsz > 0 ? (q0 + warp * WR) / frame_wsz : 0;
  const int wf1 = frame_wsz > 0 ? (q0 + warp * WR + WR - 1) / frame_wsz : 0;

  // One barrier a tile. At the top of tile t: this thread's copies of
  // tile t have landed, and after the barrier everyone's have, the
  // metadata of tile t+1 (stored during tile t-1) is visible, and no warp
  // still reads the K/V buffer or the metadata slot that tile t+1 and
  // tile t+2 reuse (both last read by tile t-1), nor its own buffer, which
  // tile t rewrites. A skipped tile stores its metadata slot all the same.
  for (int t = 0; t < n_tiles; ++t) {
    fmma::cp_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1);
    fmma::cp_commit();
    const KeyMeta next = decode(t + 2);  // its loads complete under this tile's math
    const float* tk = sk + (t & 1) * BK * ld + g * ld;  // key g; key g + 8j is 8j rows on
    const float* tv = sv + (t & 1) * BK * ld + 4 * cg;  // column group cg of key 0
    const KeyMeta* mt = meta + (t % 3) * BK;
    const int kt0 = k0 + t * BK;
    if (frame_wsz > 0 && ((min(k1, kt0 + BK) - 1) / frame_wsz < wf0 || kt0 / frame_wsz > wf1)) {
      if (tid < BK) meta[((t + 2) % 3) * BK + tid] = next;
      continue;
    }

    // S = Q·Kᵀ
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < chp; c += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + i * ld + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(tk + 8 * j * ld + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // bias, frame mask, online softmax (base e); P and alpha to the warp's buffer
    float bias[4];
    int kf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bias[j] = mt[g + 8 * j].bias;
      kf[j] = mt[g + 8 * j].frame;
    }
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = bias[j] != -INFINITY && (rf[i] < 0 || kf[j] == rf[i]);
        s[i][j] = valid ? s[i][j] * scale + bias[j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
      }
      l[i] = l[i] * alpha[i] + ps;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(wb + (g + 8 * j) * PLD + sr) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    if (g == 0) *reinterpret_cast<float4*>(wstat + sr) = make_float4(alpha[0], alpha[1], alpha[2], alpha[3]);
    __syncwarp();

    // O = O * alpha + P·V, one key a step
    {
      const float4 a0 = *reinterpret_cast<const float4*>(wstat + orow);
      const float4 a1 = *reinterpret_cast<const float4*>(wstat + orow + 4);
      const float al[RO] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < RO; ++i)
#pragma unroll
        for (int k = 0; k < NC; ++k) o[i][k] = scaled(o[i][k], al[i]);
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(wb + kk * PLD + orow);
      const float4 p1 = *reinterpret_cast<const float4*>(wb + kk * PLD + orow + 4);
      const float pr[RO] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float4 v[NC];
      v[0] = *reinterpret_cast<const float4*>(tv + kk * ld);
      v[1] = col1 ? *reinterpret_cast<const float4*>(tv + kk * ld + 64) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < RO; ++i)
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          o[i][k].x = fmaf(pr[i], v[k].x, o[i][k].x);
          o[i][k].y = fmaf(pr[i], v[k].y, o[i][k].y);
          o[i][k].z = fmaf(pr[i], v[k].z, o[i][k].z);
          o[i][k].w = fmaf(pr[i], v[k].w, o[i][k].w);
        }
    }
    if (tid < BK) meta[((t + 2) % 3) * BK + tid] = next;
  }
  fmma::cp_wait<0>();

  // each S row's full sum and its max, to the O lanes of the row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
  __syncwarp();  // the warp's last reads of its buffer are done
  if (g == 0) {
    *reinterpret_cast<float4*>(wstat + sr) = make_float4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<float4*>(wb + sr) = make_float4(l[0], l[1], l[2], l[3]);
  }
  __syncwarp();
  float mo[RO], lo[RO];
#pragma unroll
  for (int i = 0; i < RO; ++i) {
    mo[i] = wstat[orow + i];
    lo[i] = wb[orow + i];
  }
  epi(Rows{nq, warp * WR + orow, cg, ch, mo, lo, o});
}

// One block of a window attention kernel: query rows [q0, q0 + BQ) of a
// window of QT queries in frames of wsz. An occupied window's rows attend
// over keys [0, n_keys) of `occ_keys`; a clean window's over the frames the
// tile touches, each key of `clean_keys` counting for its own frame's rows.
// StoreRows finishes the rows through out_row.
template <bool VEC, typename Occ, typename Clean, typename QRow, typename ORow>
__device__ __forceinline__ void attend_window(unsigned char* smem, int q0, int QT, int wsz, int ch, float scale,
                                              bool occupied, int n_keys, const Occ& occ_keys,
                                              const Clean& clean_keys, const QRow& q_row, const ORow& out_row) {
  const int nq = min(BQ, QT - q0);
  const StoreRows<VEC, ORow> out{out_row};
  if (occupied) {
    attend<VEC>(smem, nq, ch, scale, 0, n_keys, occ_keys, q_row, out, q0, 0);
  } else {
    int klo, khi;
    wkeys::clean_range(q0, nq, QT, wsz, klo, khi);
    attend<VEC>(smem, nq, ch, scale, klo, khi, clean_keys, q_row, out, q0, wsz);
  }
}

}  // namespace ff32
