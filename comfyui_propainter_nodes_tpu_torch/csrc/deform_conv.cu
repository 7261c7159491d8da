// Modulated deformable convolution (DCNv2), 3x3, stride 1, pad 1, sm_90a.
//
// Replaces the TPU kernel comfyui_propainter_nodes_tpu/ops/pallas/deform_conv.py
// (`_kernel`, launched by `deform_conv2d_pallas`, dispatched from
// ops/deform_conv.py::deform_conv2d).
//
// What it computes: out[p, co] = bias[co] + sum_{k, ci} w[k, ci, co] *
// mask[p, g, k] * bilinear(x[:, :, ci], p + tap_k + offset[p, g, k]) with
// g = ci / (Cin / G), offsets in torchvision's (dy, dx) pair order, and
// each of the 4 bilinear corners zero when it falls outside the image.
//
// Layout: x [N, H, W, Cin] (NHWC, channels contiguous), offset
// [N, Ho, W, G, 9, 2], mask [N, Ho, W, G, 9], out [N, Ho, W, Cout], all in
// the input type. Output row y samples around input row row0 + y of x
// (a row slab of the output, as the spatial H split runs it); row0 = 0
// and Ho = H is the whole image. The wrapper lays the weights out once
// per weight tensor, Cout padded to Np = a multiple of 128 and zeros in
// the padding: fp32 [9, Kp, Np] (Cin padded to Kp = a multiple of 16;
// output channels contiguous) for the CUDA-core kernel, bf16 [Np, 9, Kp]
// (Kp a multiple of 64; K contiguous per output channel) for the
// tensor-core kernel.
//
// What bounds it on the H100: at the feature-propagation shape (x [5, 90,
// 160, 128], Cout 128) one call is 2*72000*1152*128 = 21.2 GFLOP against
// ~99 MB of x, offsets (16 groups x 27 values per pixel, the largest
// input), mask and output in bf16: ~214 flop/byte, below the bf16
// tensor-core ridge (~295), so bytes; the flow-completion shape (x [2,
// 45, 80, 256]) is 4.2 GFLOP against ~12 MB, so operations. In practice
// the gather is the cost: every (pixel, group, tap) reads four corners of
// its cg channels, about 0.66 GB through L2 and L1 a call at the
// feature-propagation shape, though x itself is 18 MB.
//
// Both kernels are implicit GEMMs, out[M, Cout] = S[M, 9 * Cin] · W + bias,
// where S (the masked bilinear samples) is built tile by tile in shared
// memory and never reaches device memory.
//
// fp32 (`deform_conv_kernel<VEC>`, fp32 FFMAs on the CUDA cores: TF32
// would not hold fp32's tolerance). Its bound is operations (2 * M * 9 *
// Cin * Cout at 67 TFLOP/s). An SM issues 128 FFMA lanes a clock, but
// its shared memory returns 32 floats a clock to the threads, broadcast
// or not, so the product needs about 4 FFMAs a float loaded. The design:
//   * a block of NT = 128 threads owns BM = 64 pixels x BN = 128 output
//     channels, each thread a register tile of 8 pixels x 8 channels: per
//     K step two float4 loads of A and two of B (16 floats) feed 64
//     FFMAs, 4 a float. A is stored K-major ([k][pixel]), so a thread's
//     pixels are two float4 loads (pixels 4ty .. 4ty + 3 and 32 + 4ty ..),
//     and B row-major ([k][channel]; channels 4tx .. and 64 + 4tx ..), so
//     each quarter warp reads 128 contiguous bytes of B.
//   * K is walked in chunks of one tap x KC = 16 channels. A gather unit
//     is (pixel, tap, 4-channel slice), two a thread: it reads its
//     group's (dy, dx) and mask once, computes the floor, the weights and
//     the validity once, loads the four corners as 16-byte NHWC vectors
//     (VEC: cg % 4 == 0 and x 16-byte aligned; otherwise it computes each
//     channel's sample on its own), blends them in the plain version's
//     corner order and multiplies by the mask. Four lanes take a pixel's
//     four slices (64 contiguous bytes a corner); their stores to A are
//     swizzled (pixel column ^ 8 * slice), so a warp's 32 stores hit 32
//     banks and a thread's 4 pixels stay one aligned float4.
//   * one barrier a chunk, and no load that waits on another: a unit's
//     offset pair and mask are loaded two chunks ahead and its corners one
//     chunk ahead (at positions computed from those offsets), both in
//     flight under the current chunk's products; the corners are blended
//     and stored after them. The weight slice arrives by `cp.async` into
//     the other of two buffers. 24 KB of shared memory a block;
//     MIN_BLOCKS = 2 blocks an SM leave up to 255 registers a thread
//     (ptxas: 209 for <1>, 157 for <0>, no spills).
//   * where the pixel tiles would give fewer than three blocks for every
//     two SMs (`tap_splits` in ops/cuda/deform_conv.py), each tap runs in
//     a block of its own (grid z, 9 splits; the kernel also takes 3): each
//     writes its partial sums to a workspace [splits, M, Cout], and
//     `deform_conv_reduce_kernel` adds them in split order, then the
//     bias. No atomics: two calls on the same inputs give the same bits.
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (this kernel's
// redesign, CHANGES.md): with the corners loaded in the same chunk as their
// offsets (the first form), the kernel at 3 blocks an SM (168 registers)
// took 0.885 ms at x[5,90,160,128] and 1.99 ms in path MH's row form;
// at 2 blocks, 4 blocks (spilling 156-180 bytes) and with 256 threads
// it was slower. The kept form spills at 3 blocks an SM and takes 0.85
// ms and 1.71 ms at 2 (256 threads x 1 block: within 2%), 37% and 40%
// of the bound there.
//
// bf16 (`deform_conv_mma_kernel`, on the tensor cores): a block of 8
// warps owns BM pixels (64, or 32 where 64 would leave SMs idle) x 128
// output channels; K is walked in chunks of one tap x 64 channels,
// double-buffered in shared memory. One gather unit is (pixel, tap,
// 8-channel slice): it reads its group's (dy, dx) and mask once, computes
// the floor, the weights and the validity once, loads the four corners as
// 16-byte NHWC vectors (cg a multiple of 8, x 16-byte aligned; otherwise
// channel by channel), blends in fp32, multiplies by the mask and rounds
// once to bf16 (the JAX package's XLA path also rounds the samples to the
// input type before the product), then stores one 16-byte piece of the A
// tile. Chunk c+1's loads are issued into registers before chunk c's
// products and stored after them; its weight slice arrives by `cp.async`.
// Products are `mma.sync.m16n8k16` bf16 with fp32 accumulation (fragments
// by `ldmatrix`, rows padded by 8 elements so each `ldmatrix` phase hits
// distinct banks). The epilogue adds the bias in fp32, rounds once to bf16
// and writes through shared memory as 16-byte rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_prims.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------ both kernels

// the bilinear sample position of output pixel (py, px), tap (ki, kj),
// offset (dy, dx): the top-left corner (clamped to a few pixels outside,
// where every corner reads zero) and the fractions
struct Pos {
  int iy, ix;
  float wy, wx;
};

__device__ __forceinline__ Pos position(int py, int px, int ki, int kj, float dy, float dx, int H, int W) {
  const float sy = (float)(py + ki - 1) + dy;
  const float sx = (float)(px + kj - 1) + dx;
  const float y0 = floorf(sy), x0 = floorf(sx);
  Pos p;
  p.wy = sy - y0;
  p.wx = sx - x0;
  p.iy = (int)fminf(fmaxf(y0, -4.0f), (float)H + 4.0f);
  p.ix = (int)fminf(fmaxf(x0, -4.0f), (float)W + 4.0f);
  return p;
}

__device__ __forceinline__ bool inside(int iy, int ix, int H, int W) {
  return (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
}

// corners summed in the plain version's order, then the mask
__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11, float wy, float wx, float mk) {
  const float gy = 1.0f - wy, gx = 1.0f - wx;
  return (v00 * (gy * gx) + v01 * (gy * wx) + v10 * (wy * gx) + v11 * (wy * wx)) * mk;
}

// ------------------------------------------------ fp32, CUDA cores

namespace f32 {

constexpr int NT = 128;                  // threads: 16 along the output channels x NT / 16 along the pixels
constexpr int MIN_BLOCKS = 2;            // blocks an SM asked of the compiler: at most 255 registers a thread
constexpr int BM = NT / 2;               // output pixels per block, 8 a thread
constexpr int BN = 128;                  // output channels per block, 8 a thread
constexpr int KC = 16;                   // channels of one K chunk (one tap)
constexpr int SLICES = KC / 4;           // 4-channel gather slices of a chunk row
constexpr int UNITS = BM * SLICES / NT;  // gather units a thread
constexpr int UROWS = NT / SLICES;       // pixels between a thread's units

struct Args {
  const float* x;
  const float* off;
  const float* msk;
  const float* wt;    // [9, Kp, Np]
  const float* bias;  // [Cout], or nullptr (and always with a tap split)
  float* out;         // [M, Cout]; with a tap split the workspace [splits, M, Cout]
  long long M;
  int H, W, Cin, Cout, G, Kp, Np;
  int Ho, row0;  // output rows, and the input row of output row 0
  int taps;      // taps a block: 9 / splits
};

// a gather unit's registers between its loads and its store: the four
// corners' 4 channels (vector path) or the 4 finished samples (per channel)
template <bool VEC>
struct Unit;
template <>
struct Unit<true> {
  float4 v[4];
  float wy, wx, mk;
};
template <>
struct Unit<false> {
  float val[4];
};

// a vector unit's offset pair and mask, loaded a chunk before its corners
struct OffMask {
  float dy, dx, mk;
};

template <bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) deform_conv_kernel(Args a) {
  __shared__ __align__(16) float sa[2][KC][BM];  // samples, K-major, pixel columns swizzled
  __shared__ __align__(16) float sb[2][KC][BN];  // the weight slice

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * a.taps;
  const int H = a.H, W = a.W, Cin = a.Cin, G = a.G;
  const int cg = Cin / G;
  const int cpt = a.Kp / KC;  // chunks a tap
  const int n_chunks = a.taps * cpt;

  // this thread's gather units: slice `sl` of pixels row_u + i * UROWS
  const int sl = tid % SLICES;
  const int row_u = tid / SLICES;
  const float* img[UNITS];
  int py[UNITS], px[UNITS];  // py -1: past M
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const long long p = m0 + row_u + i * UROWS;
    img[i] = a.x;
    py[i] = -1;
    px[i] = 0;
    if (p < a.M) {
      const int HWo = a.Ho * W;
      const int n = (int)(p / HWo);
      const int rem = (int)(p - (long long)n * HWo);
      img[i] = a.x + (long long)n * H * W * Cin;
      py[i] = a.row0 + rem / W;
      px[i] = rem - (rem / W) * W;
    }
  }

  // chunk c's offset pairs and masks into registers (vector path; the
  // per-channel path reads its own in `gather`)
  auto fetch = [&](int c, OffMask (&o)[UNITS]) {
    if constexpr (VEC) {
      const int kt = c / cpt;
      const int k = k0 + kt;
      const int ci0 = (c - kt * cpt) * KC + sl * 4;
#pragma unroll
      for (int i = 0; i < UNITS; ++i) {
        o[i].dy = o[i].dx = o[i].mk = 0.0f;
        if (py[i] >= 0 && ci0 < Cin) {
          const long long pg = (m0 + row_u + i * UROWS) * G + ci0 / cg;
          const float* op = a.off + (pg * 9 + k) * 2;
          o[i].dy = __ldg(op);
          o[i].dx = __ldg(op + 1);
          o[i].mk = __ldg(a.msk + pg * 9 + k);
        }
      }
    }
  };

  // chunk c's corner loads into registers, at the positions of its
  // offsets o (vector path); the per-channel path finishes its samples
  auto gather = [&](int c, const OffMask (&o)[UNITS], Unit<VEC> (&u)[UNITS]) {
    const int kt = c / cpt;
    const int k = k0 + kt;
    const int ci0 = (c - kt * cpt) * KC + sl * 4;
    const int ki = k / 3, kj = k - (k / 3) * 3;
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const bool live = py[i] >= 0;
      if constexpr (VEC) {
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        u[i].v[0] = u[i].v[1] = u[i].v[2] = u[i].v[3] = zero;
        u[i].wy = u[i].wx = u[i].mk = 0.0f;
        if (live && ci0 < Cin) {
          const Pos s = position(py[i], px[i], ki, kj, o[i].dy, o[i].dx, H, W);
          u[i].wy = s.wy;
          u[i].wx = s.wx;
          u[i].mk = o[i].mk;
          const float* xb = img[i] + ci0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int iy = s.iy + (q >> 1), ix = s.ix + (q & 1);
            if (inside(iy, ix, H, W)) u[i].v[q] = __ldg(reinterpret_cast<const float4*>(xb + (iy * W + ix) * Cin));
          }
        }
      } else {
        const long long p = m0 + row_u + i * UROWS;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = ci0 + e;
          float val = 0.0f;
          if (live && ci < Cin) {
            const long long pg = p * G + ci / cg;
            const float* op = a.off + (pg * 9 + k) * 2;
            const Pos s = position(py[i], px[i], ki, kj, __ldg(op), __ldg(op + 1), H, W);
            const float* xb = img[i] + ci;
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int iy = s.iy + (q >> 1), ix = s.ix + (q & 1);
              v[q] = inside(iy, ix, H, W) ? __ldg(xb + (iy * W + ix) * Cin) : 0.0f;
            }
            val = blend(v[0], v[1], v[2], v[3], s.wy, s.wx, __ldg(a.msk + pg * 9 + k));
          }
          u[i].val[e] = val;
        }
      }
    }
  };

  // the units' samples into A buffer `buf`: channel row sl * 4 + e, pixel
  // column row ^ 8 * sl (the four slices of 8 pixels on 32 banks)
  auto store = [&](int buf, const Unit<VEC> (&u)[UNITS]) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      float val[4];
      if constexpr (VEC) {
        const float4* v = u[i].v;
        val[0] = blend(v[0].x, v[1].x, v[2].x, v[3].x, u[i].wy, u[i].wx, u[i].mk);
        val[1] = blend(v[0].y, v[1].y, v[2].y, v[3].y, u[i].wy, u[i].wx, u[i].mk);
        val[2] = blend(v[0].z, v[1].z, v[2].z, v[3].z, u[i].wy, u[i].wx, u[i].mk);
        val[3] = blend(v[0].w, v[1].w, v[2].w, v[3].w, u[i].wy, u[i].wx, u[i].mk);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) val[e] = u[i].val[e];
      }
      const int col = (row_u + i * UROWS) ^ (sl << 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[buf][sl * 4 + e][col] = val[e];
    }
  };

  // chunk c's weight slice [KC][BN] into B buffer `buf`
  auto stage_b = [&](int c, int buf) {
    const int kt = c / cpt;
    const float* src = a.wt + ((long long)(k0 + kt) * a.Kp + (c - kt * cpt) * KC) * a.Np + n0;
#pragma unroll
    for (int i = 0; i < KC * BN / 4 / NT; ++i) {
      const int idx = tid + i * NT;
      const int row = idx / (BN / 4);
      const int col = (idx - row * (BN / 4)) * 4;
      fmma::cp_async16(fmma::smem_u32(&sb[buf][row][col]), src + (long long)row * a.Np + col, 16);
    }
    fmma::cp_commit();
  };

  const int tx = tid & 15;  // output channels 4tx .. 4tx + 3 and BN/2 + 4tx ..
  const int ty = tid >> 4;  // output pixels 4ty .. 4ty + 3 and BM/2 + 4ty ..
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  Unit<VEC> u[UNITS];
  OffMask o[UNITS];
  fetch(0, o);
  gather(0, o, u);
  stage_b(0, 0);
  store(0, u);
  if (n_chunks > 1) fetch(1, o);

  // One barrier a chunk. At the top of chunk c: this thread's weight
  // copies of chunk c have landed, and after the barrier everyone's
  // samples and copies have, and no warp still reads the buffers that
  // chunk c+1 reuses (last read by chunk c-1). The corner loads of chunk
  // c+1 and the offset loads of chunk c+2 are in flight under chunk c's
  // products, so no load waits on another within a chunk.
  for (int c = 0; c < n_chunks; ++c) {
    fmma::cp_wait<0>();
    __syncthreads();
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      stage_b(c + 1, buf ^ 1);
      gather(c + 1, o, u);
      if (c + 2 < n_chunks) fetch(c + 2, o);
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int sw = (kk >> 2) << 3;
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[buf][kk][(4 * ty) ^ sw]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[buf][kk][(BM / 2 + 4 * ty) ^ sw]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb[buf][kk][BN / 2 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (c + 1 < n_chunks) store(buf ^ 1, u);
  }

  // epilogue: bias, rows of 4 channels as float4 where Cout % 4 == 0
  const int Cout = a.Cout;
  float* ob = a.out + (long long)blockIdx.z * a.M * Cout;
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    const int co = n0 + jh * (BN / 2) + 4 * tx;
    if (co >= Cout) continue;
    float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (a.bias != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (co + j < Cout) b[j] = a.bias[co + j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long p = m0 + (i >> 2) * (BM / 2) + 4 * ty + (i & 3);
      if (p >= a.M) continue;
      float* dst = ob + p * Cout + co;
      if ((Cout & 3) == 0) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][4 * jh] + b[0], acc[i][4 * jh + 1] + b[1],
                                                      acc[i][4 * jh + 2] + b[2], acc[i][4 * jh + 3] + b[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co + j < Cout) dst[j] = acc[i][4 * jh + j] + b[j];
      }
    }
  }
}

// out = (partial 0 + partial 1 + ...) + bias, in split order
__global__ void deform_conv_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                                          float* __restrict__ out, long long MC, int Cout, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < MC; i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int sp = 1; sp < splits; ++sp) s += ws[sp * MC + i];
    out[i] = s + (bias != nullptr ? bias[i % Cout] : 0.0f);
  }
}

template <bool VEC>
int launch(const Args& a, int splits, cudaStream_t s) {
  const dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)(a.Np / BN), (unsigned)splits);
  deform_conv_kernel<VEC><<<grid, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------ bf16, tensor cores

namespace tc {

constexpr int KC = 64;          // channels of one K chunk (one tap)
constexpr int LDS = KC + 8;     // shared row stride of the A and B tiles (144 B)
constexpr int BN = 128;         // output channels per block
constexpr int NT = 256;         // 8 warps: 2 along the pixels x 4 along the channels
constexpr int SLICES = KC / 8;  // 8-channel slices of a chunk row
constexpr int LDO = BN + 8;     // shared row stride of the output tile

inline size_t smem_bytes(int bm) { return (size_t)2 * (bm + BN) * LDS * sizeof(bf16); }

struct Args {
  const bf16* x;
  const bf16* off;
  const bf16* msk;
  const bf16* wt;    // [Np, 9, Kp]
  const bf16* bias;  // [Cout] or nullptr
  bf16* out;
  long long M;
  int H, W, Cin, Cout, G, Kp;
  int Ho, row0;  // output rows, and the input row of output row 0
};

// a gather unit's registers between its loads and its store: the four
// corners' 8 channels (vector path) or the 8 finished samples (per channel)
template <bool VEC>
struct Unit;
template <>
struct Unit<true> {
  uint4 v[4];
  float wy, wx, mk;
};
template <>
struct Unit<false> {
  float val[8];
};

// eight bf16 of a 16-byte vector as fp32 (exact: a bf16 is the top half
// of its fp32)
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(NT, 2) deform_conv_mma_kernel(Args a) {
  constexpr int UNITS = BM * SLICES / NT;  // gather units a thread: 2 (BM 64) or 1 (BM 32)
  constexpr int MT = BM / 32;              // 16-row tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);  // [2][BM][LDS]
  bf16* sb = sa + 2 * BM * LDS;              // [2][BN][LDS]
  __shared__ const bf16* s_img[BM];          // the pixel's image in x
  __shared__ int s_py[BM], s_px[BM];         // s_py -1: past M

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int H = a.H, W = a.W, Cin = a.Cin, G = a.G;
  const int HW = H * W;
  const int HWo = a.Ho * W;
  const int cg = Cin / G;
  const int cchunks = a.Kp / KC;  // chunks a tap
  const int n_chunks = 9 * cchunks;

  for (int r = tid; r < BM; r += NT) {
    const long long p = m0 + r;
    if (p < a.M) {
      const int n = (int)(p / HWo);
      const int rem = (int)(p - (long long)n * HWo);
      s_img[r] = a.x + (long long)n * HW * Cin;
      s_py[r] = a.row0 + rem / W;
      s_px[r] = rem - (rem / W) * W;
    } else {
      s_img[r] = a.x;
      s_py[r] = -1;
      s_px[r] = 0;
    }
  }
  __syncthreads();

  // chunk c's gather loads into registers
  auto load = [&](int c, Unit<VEC> (&u)[UNITS]) {
    const int k = c / cchunks;
    const int c0 = (c - k * cchunks) * KC;
    const int ki = k / 3, kj = k - (k / 3) * 3;
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int unit = tid + i * NT;
      const int row = unit / SLICES;
      const int ci0 = c0 + (unit - row * SLICES) * 8;
      const int py = s_py[row], px = s_px[row];
      const bool live = py >= 0;
      if constexpr (VEC) {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        u[i].v[0] = u[i].v[1] = u[i].v[2] = u[i].v[3] = zero;
        u[i].wy = u[i].wx = u[i].mk = 0.0f;
        if (live && ci0 < Cin) {
          const long long pg = (m0 + row) * G + ci0 / cg;
          const bf16* o = a.off + (pg * 9 + k) * 2;
          const Pos s = position(py, px, ki, kj, __bfloat162float(o[0]), __bfloat162float(o[1]), H, W);
          u[i].wy = s.wy;
          u[i].wx = s.wx;
          u[i].mk = __bfloat162float(a.msk[pg * 9 + k]);
          const bf16* xb = s_img[row] + ci0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int iy = s.iy + (q >> 1), ix = s.ix + (q & 1);
            if (inside(iy, ix, H, W)) u[i].v[q] = __ldg(reinterpret_cast<const uint4*>(xb + (iy * W + ix) * Cin));
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ci = ci0 + e;
          float val = 0.0f;
          if (live && ci < Cin) {
            const long long pg = (m0 + row) * G + ci / cg;
            const bf16* o = a.off + (pg * 9 + k) * 2;
            const Pos s = position(py, px, ki, kj, __bfloat162float(o[0]), __bfloat162float(o[1]), H, W);
            const bf16* xb = s_img[row] + ci;
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int iy = s.iy + (q >> 1), ix = s.ix + (q & 1);
              v[q] = inside(iy, ix, H, W) ? __bfloat162float(xb[(iy * W + ix) * Cin]) : 0.0f;
            }
            val = blend(v[0], v[1], v[2], v[3], s.wy, s.wx, __bfloat162float(a.msk[pg * 9 + k]));
          }
          u[i].val[e] = val;
        }
      }
    }
  };

  // the units' samples, rounded once to bf16, into A buffer `buf`
  auto store = [&](int buf, const Unit<VEC> (&u)[UNITS]) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int unit = tid + i * NT;
      const int row = unit / SLICES;
      float val[8];
      if constexpr (VEC) {
        float c[4][8];
#pragma unroll
        for (int q = 0; q < 4; ++q) unpack8(u[i].v[q], c[q]);
#pragma unroll
        for (int e = 0; e < 8; ++e) val[e] = blend(c[0][e], c[1][e], c[2][e], c[3][e], u[i].wy, u[i].wx, u[i].mk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) val[e] = u[i].val[e];
      }
      const uint4 packed = make_uint4(fmma::pack_bf16(val[0], val[1]), fmma::pack_bf16(val[2], val[3]),
                                      fmma::pack_bf16(val[4], val[5]), fmma::pack_bf16(val[6], val[7]));
      *reinterpret_cast<uint4*>(sa + (buf * BM + row) * LDS + (unit - row * SLICES) * 8) = packed;
    }
  };

  // chunk c's weight slice [BN][KC] into B buffer `buf`
  auto stage_b = [&](int c, int buf) {
    const int k = c / cchunks;
    const int c0 = (c - k * cchunks) * KC;
#pragma unroll
    for (int i = 0; i < BN * SLICES / NT; ++i) {
      const int idx = tid + i * NT;
      const int row = idx / SLICES;
      const int piece = idx - row * SLICES;
      const bf16* src = a.wt + ((long long)(n0 + row) * 9 + k) * a.Kp + c0 + piece * 8;
      fmma::cp_async16(fmma::smem_u32(sb + (buf * BN + row) * LDS + piece * 8), src, 16);
    }
    fmma::cp_commit();
  };

  const int wm = warp >> 2, wn = warp & 3;
  const int rbase = wm * (BM / 2);  // this warp's rows and columns of the tile
  const int cbase = wn * 32;
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;

  Unit<VEC> u[UNITS];
  load(0, u);
  stage_b(0, 0);
  store(0, u);

  // One barrier a chunk. At the top of chunk c: this thread's weight
  // copies of chunk c have landed, and after the barrier everyone's
  // samples and copies have, and no warp still reads the buffers that
  // chunk c+1 reuses (last read by chunk c-1).
  for (int c = 0; c < n_chunks; ++c) {
    fmma::cp_wait<0>();
    __syncthreads();
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      stage_b(c + 1, buf ^ 1);
      load(c + 1, u);  // in flight under this chunk's products
    }
    const bf16* ta = sa + buf * BM * LDS;
    const bf16* tb = sb + buf * BN * LDS;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        fmma::ldsm_x4(af[mt], fmma::smem_u32(ta + (rbase + mt * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        fmma::ldsm_x4(b, fmma::smem_u32(tb + (cbase + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS + ks * 16 +
                                        ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          fmma::mma(acc[mt][2 * np], af[mt], b[0], b[1]);
          fmma::mma(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
    if (c + 1 < n_chunks) store(buf ^ 1, u);
  }

  // epilogue: bias in fp32, one rounding, rows staged in shared memory
  __syncthreads();  // every warp is done with the tiles
  bf16* so = reinterpret_cast<bf16*>(smem);  // [BM][LDO]
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = cbase + nt * 8 + tig * 2;
    float b0 = 0.0f, b1 = 0.0f;
    if (a.bias != nullptr) {
      if (n0 + col < a.Cout) b0 = __bfloat162float(a.bias[n0 + col]);
      if (n0 + col + 1 < a.Cout) b1 = __bfloat162float(a.bias[n0 + col + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = rbase + mt * 16 + g;
      *reinterpret_cast<uint32_t*>(so + r * LDO + col) = fmma::pack_bf16(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      *reinterpret_cast<uint32_t*>(so + (r + 8) * LDO + col) =
          fmma::pack_bf16(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
  __syncthreads();
  const int ncols = min(BN, a.Cout - n0);
  const int nrows = (int)min((long long)BM, a.M - m0);
  bf16* ob = a.out + m0 * a.Cout + n0;
  if ((a.Cout & 7) == 0) {  // 16-byte rows pieces
    for (int idx = tid; idx < BM * (BN / 8); idx += NT) {
      const int r = idx / (BN / 8);
      const int q = (idx - r * (BN / 8)) * 8;
      if (r < nrows && q < ncols)
        *reinterpret_cast<uint4*>(ob + (long long)r * a.Cout + q) = *reinterpret_cast<const uint4*>(so + r * LDO + q);
    }
  } else {
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int r = idx / BN;
      const int q = idx - r * BN;
      if (r < nrows && q < ncols) ob[(long long)r * a.Cout + q] = so[r * LDO + q];
    }
  }
}

template <int BM, bool VEC>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem = smem_bytes(BM);
  const cudaError_t e =
      cudaFuncSetAttribute(deform_conv_mma_kernel<BM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)((a.Cout + BN - 1) / BN));
  deform_conv_mma_kernel<BM, VEC><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// fp32 on the CUDA cores. wt: [9, Kp, Np] fp32 (Kp, Np multiples of 16,
// 128); splits: 1, 3 or 9 blocks over the taps (3 or 9: ws holds [splits,
// M, Cout] floats); vec: 1 if cg % 4 == 0 and x is 16-byte aligned
// (corners as 16-byte vectors), else 0 (channel by channel); out [N, Ho,
// W, Cout]: output row y at input row row0 + y (0 <= row0, row0 + Ho <=
// H; the wrapper checks).
extern "C" int propainter_deform_conv(
    const void* x, const void* off, const void* msk, const void* wt,
    const void* bias, void* out, void* ws, int N, int H, int W, int Cin,
    int Cout, int G, int Kp, int Np, int splits, int vec, int Ho, int row0,
    void* stream) {
  if ((splits != 1 && splits != 3 && splits != 9) || (splits > 1 && ws == nullptr) || Kp % f32::KC != 0 ||
      Kp < Cin || Np % f32::BN != 0 || Np < Cout)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * Ho * W;
  if (M == 0 || Cout == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* b = reinterpret_cast<const float*>(bias);
  f32::Args a{reinterpret_cast<const float*>(x), reinterpret_cast<const float*>(off),
              reinterpret_cast<const float*>(msk), reinterpret_cast<const float*>(wt),
              splits == 1 ? b : nullptr, reinterpret_cast<float*>(splits == 1 ? out : ws),
              M, H, W, Cin, Cout, G, Kp, Np, Ho, row0, 9 / splits};
  const int e = vec ? f32::launch<true>(a, splits, s) : f32::launch<false>(a, splits, s);
  if (e != 0 || splits == 1) return e;
  const long long MC = M * Cout;
  const unsigned blocks = (unsigned)((MC + 255) / 256);
  f32::deform_conv_reduce_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float*>(ws), b,
                                                         reinterpret_cast<float*>(out), MC, Cout, splits);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores. wt: [Np, 9, Kp] bf16 (Np, Kp multiples of 128,
// 64); bm: 64 or 32 pixels a block; vec: 1 if cg % 8 == 0 and x is 16-byte
// aligned (corners as 16-byte vectors), else 0 (channel by channel);
// Ho, row0 as for the fp32 kernel.
extern "C" int propainter_deform_conv_mma(
    const void* x, const void* off, const void* msk, const void* wt,
    const void* bias, void* out, int N, int H, int W, int Cin, int Cout,
    int G, int Kp, int bm, int vec, int Ho, int row0, void* stream) {
  if ((bm != 32 && bm != 64) || Kp % tc::KC != 0 || Kp < Cin) return (int)cudaErrorInvalidValue;
  tc::Args a{reinterpret_cast<const bf16*>(x), reinterpret_cast<const bf16*>(off),
             reinterpret_cast<const bf16*>(msk), reinterpret_cast<const bf16*>(wt),
             reinterpret_cast<const bf16*>(bias), reinterpret_cast<bf16*>(out),
             (long long)N * Ho * W, H, W, Cin, Cout, G, Kp, Ho, row0};
  if (a.M == 0 || Cout == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bm == 64) return vec ? tc::launch<64, true>(a, s) : tc::launch<64, false>(a, s);
  return vec ? tc::launch<32, true>(a, s) : tc::launch<32, false>(a, s);
}
