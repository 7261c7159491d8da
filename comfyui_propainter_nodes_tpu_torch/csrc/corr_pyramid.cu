// RAFT's all-pairs correlation pyramids, sm_90a: one launch a RAFT call,
// both directions' four bf16 levels written from the tiles.
//
// Replaces no TPU kernel: the JAX package leaves the build to XLA
// (comfyui_propainter_nodes_tpu/models/raft.py::build_corr_pyramid_bi, its
// einsum of bf16 maps with float32 accumulation, stored in bf16). The port
// built it eagerly: a float32 product of the upcast maps, its scaling, its
// cast to bf16, a transposed copy for the backward direction and two strided
// pools. Its plain version is ops/cuda/corr_pyramid.py::corr_pyramids_plain.
//
// What it computes, for pair n of fmap1, fmap2 [N, H, W, C] (bf16, C a
// multiple of 16), image-1 position p and image-2 position q of the H x W
// grid:
//   * level 0: corr[p, q] = bf16(float32 sum over c of f1[p, c] f2[q, c],
//     times 1 / sqrt(C) rounded to float32, as eager PyTorch on the card
//     scales a tensor divided by a host scalar); the forward level-0 row of
//     p holds corr[p, :] over q's grid, the backward row of q holds
//     corr[:, q] over p's grid;
//   * levels 1-3 of each direction: 2x2 pools of the level below over its
//     row's grid, in the plain version's order and roundings (rows first,
//     bf16(a + b); then columns, bf16(bf16(s0 * 0.25) + bf16(s1 * 0.25))),
//     odd tail rows and columns dropped: level l is [N*H*W, H >> l, W >> l].
// Each product of two bf16 values is exact in float32, so the tensor cores'
// float32 sums are the plain version's arithmetic in another order; levels
// 1-3 are bit for bit the plain pooling of the kernel's own level 0.
//
// What bounds it on the H100: the writes. At 1280x720's call of 4 pairs of
// 90 x 160 the two directions' pyramids are 4.40 GB (1.31 ms at 3.35 TB/s);
// the product is 0.42 TFLOP (0.43 ms at 989 TFLOP/s on the tensor cores) and
// the maps it reads (7.4 MB a pair) stay in L2.
// Design: a block (CTA) owns one tile, a block P of 128 image-1 positions by
// a block Q of 128 image-2 positions, each 8 grid rows x 16 grid columns and
// aligned to them, so that every pooled value of levels 1-3 lies inside one
// tile in both directions. Eight warps (2 x 4, a 64 x 32 warp tile) run the
// sum over C in 64-channel chunks with `mma.sync.m16n8k16` (bf16, float32
// accumulators), the chunks of both blocks double-buffered by `cp.async`
// (zero rows for positions off the grid). The epilogue stages the tile's
// level 0 in bf16 in shared memory, over the operand buffers; two lanes
// write a map row's piece of a block row (16 values, one 32-byte sector), a
// forward row's from a row of the staged tile and a backward row's from a
// column; then half the threads pool a forward row each and half a
// backward row each into levels 1-3. Tiles are ordered by (pair, band of
// P, band of Q), a band being one 8-row strip of blocks, so the blocks in
// flight complete whole strips of the rows they write and the L2 merges the
// pieces of neighbouring tiles before they reach memory. 73,728 bytes of
// dynamic shared memory and at most 128 registers a thread: two blocks an
// SM, one's epilogue under the other's product.
// What is left: a tile's pieces of levels 1-3 are shorter than a 32-byte
// sector (16, 8 and 4 bytes a row), and the memory system merges them
// across tiles at a cost (PERF.md, row P2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_prims.cuh"  // smem_u32, cp_async16, cp_commit, cp_wait, ldsm_x4, mma

namespace {

using bf16 = __nv_bfloat16;
using fmma::cp_async16;
using fmma::cp_commit;
using fmma::cp_wait;
using fmma::ldsm_x4;
using fmma::smem_u32;

constexpr int LEVELS = 4;
constexpr int BY = 8;        // grid rows of a position block
constexpr int BX = 16;       // grid columns of a position block
constexpr int BP = BY * BX;  // positions a block
constexpr int PIECE = 8;     // level-0 columns a lane writes (16 bytes)
constexpr int KC = 64;       // channels a staged chunk
constexpr int LDK = KC + 8;  // padded row of a staged chunk
constexpr int LDT = BP + 8;  // padded row of the staged level-0 tile
constexpr int NT = 256;      // eight warps
constexpr int SMEM = 4 * BP * LDK * (int)sizeof(bf16);  // A and B chunks, two buffers each
static_assert(BP * LDT <= 4 * BP * LDK, "the staged tile fits over the operand buffers");

struct Args {
  const bf16* f1;
  const bf16* f2;
  bf16* fwd[LEVELS];
  bf16* bwd[LEVELS];  // all null: the forward direction alone
  int h, w, c;
  int nbx, nby;  // blocks of a grid row, block rows of the grid
  float inv;     // 1 / sqrt(C), rounded to float32
};

__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// one pooled value from a 2x2 cell: (a, b) the left column's two rows,
// (c, d) the right column's
__device__ __forceinline__ float pool4(float a, float b, float c, float d) {
  const float s0 = rb(__fadd_rn(a, b)), s1 = rb(__fadd_rn(c, d));
  return rb(__fadd_rn(rb(__fmul_rn(s0, 0.25f)), rb(__fmul_rn(s1, 0.25f))));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// N values of one map row to dst, at column x of a row of wl: one 2N-byte
// store where VEC (the piece lies whole on the row, aligned to its size),
// else the values left of wl
template <bool VEC, int N>
__device__ __forceinline__ void store_piece(bf16* dst, const float (&v)[N], int x, int wl) {
  if constexpr (VEC) {
    if constexpr (N == 8) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
    } else if constexpr (N == 4) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
    } else {
      static_assert(N == 2, "pieces of 8, 4 or 2 values");
      *reinterpret_cast<uint32_t*>(dst) = pack2(v[0], v[1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (x + j < wl) dst[j] = __float2bfloat16_rn(v[j]);
  }
}

// Levels 1-3 of one map row from its tile values: row16(y, v) fills v
// with level-0 row y (< 8) of the block, 16 values; the block's origin on
// the pooled grid is (y0, x0); rows[l] is the row's level-l map [H >> l, W >> l].
template <bool VEC, typename Row16>
__device__ __forceinline__ void pool_levels(const Row16& row16, bf16* const (&rows)[LEVELS], int y0, int x0,
                                            int h, int w) {
  float l1[4][8], l2[2][4], l3[2];
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    float e[BX], o[BX];  // level-0 rows 2y and 2y + 1 of the block
    row16(2 * y, e);
    row16(2 * y + 1, o);
#pragma unroll
    for (int x = 0; x < 8; ++x) l1[y][x] = pool4(e[2 * x], o[2 * x], e[2 * x + 1], o[2 * x + 1]);
  }
#pragma unroll
  for (int y = 0; y < 2; ++y)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      l2[y][x] = pool4(l1[2 * y][2 * x], l1[2 * y + 1][2 * x], l1[2 * y][2 * x + 1], l1[2 * y + 1][2 * x + 1]);
#pragma unroll
  for (int x = 0; x < 2; ++x) l3[x] = pool4(l2[0][2 * x], l2[1][2 * x], l2[0][2 * x + 1], l2[1][2 * x + 1]);
  // a pooled value exists where its whole 2^l x 2^l cell of level 0 lies on the grid
  {
    const int hl = h >> 1, wl = w >> 1, yl = y0 >> 1, xl = x0 >> 1;
#pragma unroll
    for (int y = 0; y < 4; ++y)
      if (yl + y < hl && xl < wl) store_piece<VEC>(rows[1] + (long long)(yl + y) * wl + xl, l1[y], xl, wl);
  }
  {
    const int hl = h >> 2, wl = w >> 2, yl = y0 >> 2, xl = x0 >> 2;
#pragma unroll
    for (int y = 0; y < 2; ++y)
      if (yl + y < hl && xl < wl) store_piece<VEC>(rows[2] + (long long)(yl + y) * wl + xl, l2[y], xl, wl);
  }
  {
    const int hl = h >> 3, wl = w >> 3, yl = y0 >> 3, xl = x0 >> 3;
    if (yl < hl && xl < wl) store_piece<VEC>(rows[3] + (long long)yl * wl + xl, l3, xl, wl);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2) corr_pyramid_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sa = reinterpret_cast<bf16*>(smem_raw);  // [2][BP][LDK]
  bf16* const sb = sa + 2 * BP * LDK;                   // [2][BP][LDK]
  bf16* const st = sa;                                  // [BP][LDT]: level 0, over the operands
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // this warp's 64 p rows and 32 q columns of the tile

  // the tile: (pair, band of P, band of Q, block of P in its band, block of Q in its band)
  const int nb2 = a.nbx * a.nbx;
  const int per_pair = a.nby * a.nby * nb2;
  const int pair = blockIdx.x / per_pair;
  const int r = blockIdx.x - pair * per_pair;
  const int band = r / nb2, within = r - band * nb2;
  const int pband = band / a.nby, qband = band - pband * a.nby;
  const int pbx = within / a.nbx, qbx = within - pbx * a.nbx;
  const int py0 = pband * BY, px0 = pbx * BX, qy0 = qband * BY, qx0 = qbx * BX;
  const int h = a.h, w = a.w, c = a.c;
  const long long hw = (long long)h * w;
  const long long row0 = (long long)pair * hw;  // the pair's first map row of each level
  const bf16* f1 = a.f1 + row0 * c;
  const bf16* f2 = a.f2 + row0 * c;

  // chunk kc of both blocks' rows into buffer buf; positions off the grid
  // and channels past C read as zeros
  auto load = [&](int kc, int buf) {
    const int k0 = kc * KC;
    const int units = min(KC, c - k0) >> 3;
    bf16* da = sa + buf * BP * LDK;
    bf16* db = sb + buf * BP * LDK;
#pragma unroll
    for (int i = 0; i < BP * (KC / 8) / NT; ++i) {
      const int idx = tid + i * NT;
      const int row = idx >> 3, u = idx & 7;
      const int dy = row / BX, dx = row % BX;
      const bool pa = u < units && py0 + dy < h && px0 + dx < w;
      const bool pb = u < units && qy0 + dy < h && qx0 + dx < w;
      const bf16* srca = f1 + ((long long)(py0 + dy) * w + px0 + dx) * c + k0 + u * 8;
      const bf16* srcb = f2 + ((long long)(qy0 + dy) * w + qx0 + dx) * c + k0 + u * 8;
      cp_async16(smem_u32(da + row * LDK + u * 8), pa ? srca : a.f1, pa ? 16 : 0);
      cp_async16(smem_u32(db + row * LDK + u * 8), pb ? srcb : a.f2, pb ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;

  const int nk = (c + KC - 1) / KC;
  load(0, 0);
  cp_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load(kc + 1, (kc + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* ta = sa + (kc & 1) * BP * LDK;
    const bf16* tb = sb + (kc & 1) * BP * LDK;
    const int steps = min(KC, c - kc * KC) >> 4;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      if (ks < steps) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldsm_x4(af[mt], smem_u32(ta + (wm * 64 + mt * 16 + (lane & 15)) * LDK + ks * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, smem_u32(tb + (wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDK + ks * 16 +
                              ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            fmma::mma(acc[mt][2 * np], af[mt], b[0], b[1]);
            fmma::mma(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is free for chunk kc + 2, the operands for the staged tiles
  }

  // level 0 in bf16, staged p-major: st[i][j], i the tile's p position, j its q position
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = wm * 64 + mt * 16 + g, j = wn * 32 + nt * 8 + 2 * tig;
      const float* v = acc[mt][nt];
      *reinterpret_cast<uint32_t*>(st + i * LDT + j) = pack2(__fmul_rn(v[0], a.inv), __fmul_rn(v[1], a.inv));
      *reinterpret_cast<uint32_t*>(st + (i + 8) * LDT + j) = pack2(__fmul_rn(v[2], a.inv), __fmul_rn(v[3], a.inv));
    }
  __syncthreads();

  const bool backward = a.bwd[0] != nullptr;
  // level 0: two lanes a map row's piece of a block row (16 values, one
  // 32-byte sector): a forward row reads a row of st, a backward row a column
#pragma unroll
  for (int it = 0; it < 2 * BP * BY * (BX / PIECE) / NT; ++it) {
    const int idx = tid + it * NT;
    const int k = idx & 1, i = (idx >> 1) & (BP - 1), y = (idx >> 8) & (BY - 1), dir = idx >> 11;
    const int ry = (dir ? qy0 : py0) + i / BX, rx = (dir ? qx0 : px0) + i % BX;  // the row's position
    const int oy0 = dir ? py0 : qy0, ox0 = (dir ? px0 : qx0) + k * PIECE;        // its piece's origin
    if ((dir == 0 || backward) && ry < h && rx < w && oy0 + y < h && ox0 < w) {
      bf16* dst = (dir ? a.bwd[0] : a.fwd[0]) + (row0 + (long long)ry * w + rx) * hw + (long long)(oy0 + y) * w + ox0;
      if (dir == 0) {
        const bf16* src = st + i * LDT + y * BX + k * PIECE;
        if (VEC) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int x = 0; x < PIECE && ox0 + x < w; ++x) dst[x] = src[x];
        }
      } else {
        const bf16* src = st + (y * BX + k * PIECE) * LDT + i;
        if (VEC) {
          uint32_t u[PIECE / 2];
#pragma unroll
          for (int x = 0; x < PIECE / 2; ++x) {
            __nv_bfloat162 two;
            two.x = src[(2 * x) * LDT];
            two.y = src[(2 * x + 1) * LDT];
            u[x] = *reinterpret_cast<uint32_t*>(&two);
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
        } else {
          for (int x = 0; x < PIECE && ox0 + x < w; ++x) dst[x] = src[x * LDT];
        }
      }
    }
  }

  // levels 1-3: threads [0, 128) a forward row each (a row of st), [128,
  // 256) a backward row each (a column of st)
  const int i = tid & (BP - 1);
  const long long hw1 = (long long)(h >> 1) * (w >> 1), hw2 = (long long)(h >> 2) * (w >> 2),
                  hw3 = (long long)(h >> 3) * (w >> 3);
  if (tid < BP) {
    const int py = py0 + i / BX, px = px0 + i % BX;
    if (py < h && px < w) {
      const long long m = row0 + (long long)py * w + px;
      bf16* const rows[LEVELS] = {nullptr, a.fwd[1] + m * hw1, a.fwd[2] + m * hw2, a.fwd[3] + m * hw3};
      const bf16* src = st + i * LDT;
      auto row16 = [&](int y, float (&v)[BX]) {  // two 16-byte loads
        const uint4 lo = reinterpret_cast<const uint4*>(src + y * BX)[0];
        const uint4 hi = reinterpret_cast<const uint4*>(src + y * BX)[1];
        const uint32_t u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[j]));
          v[2 * j] = f.x;
          v[2 * j + 1] = f.y;
        }
      };
      pool_levels<VEC>(row16, rows, qy0, qx0, h, w);
    }
  } else if (backward) {
    const int qy = qy0 + i / BX, qx = qx0 + i % BX;
    if (qy < h && qx < w) {
      const long long m = row0 + (long long)qy * w + qx;
      bf16* const rows[LEVELS] = {nullptr, a.bwd[1] + m * hw1, a.bwd[2] + m * hw2, a.bwd[3] + m * hw3};
      const bf16* src = st + i;
      auto row16 = [&](int y, float (&v)[BX]) {  // a column of st: a warp reads 64 contiguous bytes
#pragma unroll
        for (int x = 0; x < BX; ++x) v[x] = __bfloat162float(src[(y * BX + x) * LDT]);
      };
      pool_levels<VEC>(row16, rows, py0, px0, h, w);
    }
  }
}

template <bool VEC>
int launch(const Args& a, int n, cudaStream_t s) {
  const cudaError_t e =
      cudaFuncSetAttribute(corr_pyramid_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)n * a.nby * a.nby * a.nbx * a.nbx;
  corr_pyramid_kernel<VEC><<<(unsigned)blocks, NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Both directions' pyramids (bwd null: the forward one alone) of n pairs of
// [h, w, c] bf16 maps, contiguous and 16-byte aligned; each level l an
// [n*h*w, h >> l, w >> l] bf16 map, allocated by the caller. inv: 1 / sqrt(c)
// as a float32.
extern "C" int propainter_corr_pyramid(const void* f1, const void* f2, void* fwd0, void* fwd1, void* fwd2,
                                       void* fwd3, void* bwd0, void* bwd1, void* bwd2, void* bwd3, int n, int h,
                                       int w, int c, float inv, void* stream) {
  const int nbx = (w + BX - 1) / BX, nby = (h + BY - 1) / BY;
  if (n < 1 || h < 1 || w < 1 || c < 16 || c % 16 != 0 || (long long)h * w * c >= (1LL << 31) ||
      (long long)n * nby * nby * nbx * nbx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool backward = bwd0 != nullptr;
  Args a{reinterpret_cast<const bf16*>(f1),
         reinterpret_cast<const bf16*>(f2),
         {reinterpret_cast<bf16*>(fwd0), reinterpret_cast<bf16*>(fwd1), reinterpret_cast<bf16*>(fwd2),
          reinterpret_cast<bf16*>(fwd3)},
         {backward ? reinterpret_cast<bf16*>(bwd0) : nullptr, reinterpret_cast<bf16*>(bwd1),
          reinterpret_cast<bf16*>(bwd2), reinterpret_cast<bf16*>(bwd3)},
         h, w, c, nbx, nby, inv};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // where W is a multiple of 16, a block lies whole on the grid or off it and every piece is aligned
  return w % BX == 0 ? launch<true>(a, n, s) : launch<false>(a, n, s);
}
