// Fused VGG block 1: conv1_1 (3->64, 3x3 SAME) + bias + ReLU ->
// conv1_2 (64->64, 3x3 SAME) + bias + ReLU -> 2x2/2 max-pool, one pass.
//
// Replaces tpupose/ops/pallas_block1.py::fused_block1 (_block1_kernel).
// Same contract: bf16 operands, f32 accumulation, f32 bias, conv1_1
// rounded to bf16 before conv1_2, bf16 (N, H/2, W/2, 64) NHWC output.
//
// What bounds it on the H100: operations. conv1_2 is 73.7 k multiply-adds
// per pixel on the tensor cores; the image (12 B per pixel as f32) and the
// pooled output (32 B per conv pixel) are a twentieth of that in time. What
// a wgmma reads from shared memory decides how near the tensor cores' rate
// it runs: with 64 pixels as M and the 64 channels as N an m64n64k16 tile
// reads 4 KB in its 32 tensor-core clocks, the whole shared-memory rate.
// The design cuts that and keeps everything else off the critical path:
//
//  * Persistent blocks, one per SM, walk over the 6 x 62-pixel tiles of
//    all images of the launch. The conv1_2 weights (72 KB bf16), the
//    conv1_1 weights and the biases enter shared memory or registers once
//    per block.
//  * Warp specialisation. One producer warpgroup stages the next tile's
//    input (read in the layout and type the caller holds, through its
//    strides; the loads of tile t+2 are in flight while tile t+1 is
//    computed) and computes conv1_1 into one of two activation buffers
//    while three consumer warpgroups run conv1_2 on the other; mbarriers
//    (full/empty per buffer) hand the buffers over. The producer keeps two
//    activation rows in flight (its small products queue behind the
//    consumers' on the same tensor cores, and one row at a time made it the
//    slower side); setmaxnreg hands it the registers for that.
//  * conv1_2 is an implicit GEMM on wgmma m64n128k16 with the roles
//    swapped: M = the 64 output channels (A: the weights), N = 128 pixels
//    (B: the activations), K = 9 taps x 64 channels = 36 steps, f32
//    accumulators in registers: 6 KB of shared-memory reads per 64
//    tensor-core clocks, three quarters of the rate. The activation tile
//    is stored as eight planes of 8 channels, [plane][pixel][8 channels],
//    16 B per pixel and plane: 8 consecutive pixels are one 128 B core
//    matrix of the unswizzled descriptor layout, so a tap is nothing but a
//    start address shifted by (dy * 64 + dx) * 16 B. The row pitch is
//    exactly 64 pixels (62 conv columns + the halo), so the 128 pixels of
//    one product are two whole rows at every tap; the two surplus columns
//    of a row are computed and never stored.
//  * conv1_1 runs on the tensor cores too. On the CUDA cores its 27 x 64
//    multiply-adds per activation pixel (over the halo: 1.38 x the tile's
//    pixels) are 0.5 ms of the card's whole f32 rate per 4-scale batch of
//    8, as much as the kernel's entire bound; as a K = 27 -> 32 product it
//    is 7 % more tensor-core work. The producer threads gather the im2col
//    straight into wgmma's register A fragments from the staged bf16
//    input (here pixels are M, so that the accumulators land in the plane
//    layout as 128 contiguous bytes per warp store); the weights are bf16,
//    as in the kernel this replaces. Bias, ReLU, the zero outside the
//    image and the rounding to bf16 happen on the accumulators.
//  * The pool stays in registers, without a shuffle. A consumer warpgroup
//    owns conv rows 2r and 2r+1, the N of its products: a thread's
//    accumulator columns hold both pixels of a horizontal pair and, 64
//    columns on, the pair below, so the 2x2 max is four of its own values;
//    bias and ReLU come after the max. The host orders conv1_2's output
//    channels so that a thread's two accumulator rows are a neighbouring
//    channel pair: a pooled pixel leaves a warp as 32 contiguous bytes.
//
// Measured times are in PERF.md (section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kC = 64;                    // channels of conv1_1 and conv1_2
constexpr int kRows = 6;                  // conv rows per tile (3 pooled rows)
constexpr int kCols = 62;                 // conv columns per tile (31 pooled)
constexpr int kActRows = kRows + 2;       // activation rows incl. conv1_2's halo
constexpr int kActW = 64;                 // activation row pitch: kCols + 2
constexpr int kPlanePx = kActRows * kActW + 8;   // taps read 2 pixels past the end
constexpr int kPlaneBytes = kPlanePx * 16;       // 8 channels of every pixel
constexpr int kActBytes = 8 * kPlaneBytes;
constexpr int kInRows = kRows + 4;        // input rows incl. both halos
constexpr int kInW = kCols + 4;
constexpr int kInPitch = kInW * 3;        // bf16 elements per staged input row
constexpr int kInElems = kInRows * kInPitch;
constexpr int kConsumers = 3;             // warpgroups, one pooled row each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStageLoads = (kInElems + 127) / 128;
// registers per thread once the roles part (the launch gives each 128): the
// producer keeps two rows' accumulators and the prefetched input window
constexpr int kConsumerRegs = 104;
constexpr int kProducerRegs = 200;
static_assert(kConsumers * kConsumerRegs + kProducerRegs <= 4 * 128, "the SM's register file");

constexpr int kW2Bytes = 9 * 8 * kC * 16;        // [tap][8-channel chunk][n][8]
constexpr int kW1Bytes = 4 * kC * 16;            // [k chunk][n][8], K = 27 -> 32
constexpr int kOffW1 = kW2Bytes;
constexpr int kOffAct = kOffW1 + kW1Bytes;
constexpr int kOffIn = kOffAct + 2 * kActBytes;
constexpr int kOffBar = kOffIn + ((kInElems * 2 + 15) / 16) * 16;
constexpr int kSmem = kOffBar + 4 * 8;
static_assert(kActW == kCols + 2 && kRows == 2 * kConsumers, "tile geometry");
static_assert(kSmem <= 227 * 1024, "one block must fit an SM's shared memory");

struct Block1Args {
  const void* x;                 // (N, H, W, 3) through the element strides below
  long long sn, sh, sw, sc;
  const __nv_bfloat16* w1;       // packed, see ops/block1.py pack_weights
  const float* b1;
  const __nv_bfloat16* w2;
  const float* b2;
  __nv_bfloat16* out;            // (N, H/2, W/2, 64) contiguous
  int n, h, w, tiles_x, tiles_y;
};

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Tile {
  int n, y0, x0, ty, tx;
};
__device__ __forceinline__ Tile tile_of(int t, const Block1Args& a) {
  Tile r;
  r.tx = t % a.tiles_x;
  const int rest = t / a.tiles_x;
  r.ty = rest % a.tiles_y;
  r.n = rest / a.tiles_y;
  r.y0 = r.ty * kRows;
  r.x0 = r.tx * kCols;
  return r;
}

// The producer's prefetch: this thread's share of the (kInRows x kInW x 3)
// input window of tile `tile`, zero outside the image.
template <typename T>
__device__ __forceinline__ void load_window(const Block1Args& a, const Tile& tile, int tid,
                                            float (&raw)[kStageLoads]) {
  const T* x = static_cast<const T*>(a.x) + tile.n * a.sn;
#pragma unroll
  for (int i = 0; i < kStageLoads; ++i) {
    const int e = tid + 128 * i;           // channel-major, columns fastest
    const int c = e / (kInRows * kInW);
    const int r = e % (kInRows * kInW) / kInW;
    const int col = e % kInW;
    const int gy = tile.y0 - 2 + r;
    const int gx = tile.x0 - 2 + col;
    float v = 0.f;
    if (e < kInElems && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
      v = load_as_float(x + gy * a.sh + gx * a.sw + c * a.sc);
    raw[i] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) block1_kernel(const Block1Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem + kOffIn);
  const uint32_t s_base = smem_addr(smem);
  const uint32_t bar_full = s_base + kOffBar;        // [2], then empty [2]
  const uint32_t bar_empty = bar_full + 16;

  const int tid = threadIdx.x;
  const int total = a.n * a.tiles_y * a.tiles_x;

  // --- once per block: weights, pad pixels, barriers -----------------------
  {
    const uint4* g2 = reinterpret_cast<const uint4*>(a.w2);
    uint4* s2 = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < kW2Bytes / 16; i += kThreads) s2[i] = g2[i];
    const uint4* g1 = reinterpret_cast<const uint4*>(a.w1);
    uint4* s1 = reinterpret_cast<uint4*>(smem + kOffW1);
    for (int i = tid; i < kW1Bytes / 16; i += kThreads) s1[i] = g1[i];
    // the 8 pixels behind each plane are read by the two surplus columns
    for (int i = tid; i < 2 * 8 * 8; i += kThreads)
      *reinterpret_cast<uint4*>(smem + kOffAct + (i / 8) * kPlaneBytes + kActRows * kActW * 16 +
                                (i % 8) * 16) = make_uint4(0, 0, 0, 0);
    if (tid == 0) {
      mbar_init(bar_full, 128);
      mbar_init(bar_full + 8, 128);
      mbar_init(bar_empty, kConsumers * 128);
      mbar_init(bar_empty + 8, kConsumers * 128);
    }
  }
  fence_async_proxy();
  __syncthreads();

  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int warp = wtid / 32;          // within the warpgroup
  const int g = wtid % 32 / 4;
  const int q = wtid % 4;

  if (wg == kConsumers) {
    // ======================= producer warpgroup ============================
    setmaxnreg_inc<kProducerRegs>();
    // im2col offsets of this thread's 8 K columns (k = (dy * 3 + dx) * 3 + c
    // reads input (row + dy, 3 * col + 3 * dx + c); columns 27..31 are zero)
    int koff[8];
    bool kvalid[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = 16 * (i / 4) + 8 * (i / 2 % 2) + 2 * q + i % 2;
      kvalid[i] = k < 27;
      koff[i] = k / 9 * kInPitch + k % 9;
    }
    float bias[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) bias[i] = a.b1[8 * (i / 2) + 2 * q + i % 2];
    const uint64_t w1_desc = matrix_desc(s_base + kOffW1, kC * 16, 128);

    float raw[kStageLoads];
    int t = blockIdx.x;
    Tile tile = tile_of(t < total ? t : 0, a);
    if (t < total) load_window<T>(a, tile, wtid, raw);
    for (int it = 0; t < total; ++it, t += gridDim.x) {
      named_barrier(1, 128);           // conv1_1 of the previous tile has read s_in
#pragma unroll
      for (int i = 0; i < kStageLoads; ++i) {
        const int e = wtid + 128 * i;
        if (e < kInElems) {
          const int c = e / (kInRows * kInW);
          const int rc = e % (kInRows * kInW);
          s_in[rc * 3 + c] = __float2bfloat16(raw[i]);
        }
      }
      named_barrier(1, 128);
      const Tile cur = tile;
      if (t + gridDim.x < total) {
        tile = tile_of(t + gridDim.x, a);
        load_window<T>(a, tile, wtid, raw);
      }
      const int buf = it & 1;
      mbar_wait(bar_empty + 8 * buf, ((it >> 1) & 1) ^ 1);
      unsigned char* act = smem + kOffAct + buf * kActBytes;
      const int m0 = 16 * warp + g;
      const int gx0 = cur.x0 - 1 + m0;
      const bool in_x0 = gx0 >= 0 && gx0 < a.w;
      const bool in_x1 = gx0 + 8 >= 0 && gx0 + 8 < a.w;
      // conv1_1 of activation row ay: the im2col rows of pixels m0 and
      // m0 + 8 into wgmma's A registers, two K = 16 steps against w1
      auto start_row = [&](int ay, uint32_t (&frag)[2][4], float (&acc)[32]) {
        const unsigned short* row =
            reinterpret_cast<const unsigned short*>(s_in) + ay * kInPitch + m0 * 3;
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          // columns k, k + 1 of rows m0 (even register) and m0 + 8 (odd)
          uint32_t lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
          if (kvalid[i]) { lo0 = row[koff[i]]; lo1 = row[koff[i] + 24]; }
          if (kvalid[i + 1]) { hi0 = row[koff[i + 1]]; hi1 = row[koff[i + 1] + 24]; }
          frag[i / 4][i / 2 % 2 * 2] = lo0 | (hi0 << 16);
          frag[i / 4][i / 2 % 2 * 2 + 1] = lo1 | (hi1 << 16);
        }
        fence_acc(acc);
        wgmma_fence();
        wgmma_rs(acc, frag[0], w1_desc, 0);
        wgmma_rs(acc, frag[1], w1_desc + 2 * (kC * 16 >> 4), 1);
        wgmma_commit();
      };
      // bias, ReLU, zero outside the image, bf16, into the plane layout
      auto finish_row = [&](int ay, float (&acc)[32]) {
        fence_acc(acc);
        const int gy = cur.y0 - 1 + ay;
        const bool in_y = gy >= 0 && gy < a.h;
        unsigned char* dst = act + (ay * kActW + m0) * 16 + q * 4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t v0 = 0, v1 = 0;
          if (in_y && in_x0)
            v0 = pack_bf16(fmaxf(acc[4 * j] + bias[2 * j], 0.f),
                           fmaxf(acc[4 * j + 1] + bias[2 * j + 1], 0.f));
          if (in_y && in_x1)
            v1 = pack_bf16(fmaxf(acc[4 * j + 2] + bias[2 * j], 0.f),
                           fmaxf(acc[4 * j + 3] + bias[2 * j + 1], 0.f));
          *reinterpret_cast<uint32_t*>(dst + j * kPlaneBytes) = v0;
          *reinterpret_cast<uint32_t*>(dst + j * kPlaneBytes + 8 * 16) = v1;
        }
      };
      // two rows in flight: the product of one runs under the gather and
      // the epilogue of its neighbours
      uint32_t frag_a[2][4], frag_b[2][4];
      float acc_a[32], acc_b[32];
      start_row(0, frag_a, acc_a);
#pragma unroll
      for (int ay = 0; ay < kActRows; ay += 2) {
        start_row(ay + 1, frag_b, acc_b);
        wgmma_wait<1>();
        finish_row(ay, acc_a);
        if (ay + 2 < kActRows) {
          start_row(ay + 2, frag_a, acc_a);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        finish_row(ay + 1, acc_b);
      }
      fence_async_proxy();
      mbar_arrive(bar_full + 8 * buf);
    }
  } else {
    // ======================= consumer warpgroups ===========================
    setmaxnreg_dec<kConsumerRegs>();
    // this thread's accumulator rows 16 warp + g and + 8 are the channel
    // pair 16 warp + 2 g, + 1 (the host orders conv1_2's output channels so)
    const int co = 16 * warp + 2 * g;
    const float bias0 = a.b2[co];
    const float bias1 = a.b2[co + 1];
    const int ho = a.h / 2;
    const int wo = a.w / 2;
    const uint64_t w2_desc = matrix_desc(s_base, kC * 16, 128);

    int it = 0;
    for (int t = blockIdx.x; t < total; ++it, t += gridDim.x) {
      const Tile tile = tile_of(t, a);
      const int buf = it & 1;
      mbar_wait(bar_full + 8 * buf, (it >> 1) & 1);
      // N = the 128 consecutive pixels of rows 2 wg and 2 wg + 1 of the
      // tile; tap (dy, dx) starts dy rows and dx pixels further on
      const uint64_t act_desc = matrix_desc(
          s_base + kOffAct + buf * kActBytes + 2 * wg * kActW * 16, kPlaneBytes, 128);
      float acc[64];
      fence_acc(acc);
      wgmma_fence();
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n128(
                acc, w2_desc + ((((dy * 3 + dx) * 8 + 2 * ks) * kC * 16) >> 4),
                act_desc + ((2 * ks * kPlaneBytes + (dy * kActW + dx) * 16) >> 4),
                (dy | dx | ks) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(bar_empty + 8 * buf);

      // pool: column 8 j + 2 q + e is pixel 8 j + 2 q + e of the first row
      // (j < 8) or the second, so the four values of a pooled pixel are this
      // thread's; bias and ReLU after the max
      const int py = tile.ty * kConsumers + wg;
      if (py < ho) {
        __nv_bfloat16* orow = a.out + (static_cast<size_t>(tile.n) * ho + py) * wo * kC + co;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int pc = 4 * j + q;                          // pooled column in the tile
          const int px = tile.tx * (kCols / 2) + pc;
          const float v0 = fmaxf(fmaxf(acc[4 * j], acc[4 * j + 1]),
                                 fmaxf(acc[4 * (j + 8)], acc[4 * (j + 8) + 1]));
          const float v1 = fmaxf(fmaxf(acc[4 * j + 2], acc[4 * j + 3]),
                                 fmaxf(acc[4 * (j + 8) + 2], acc[4 * (j + 8) + 3]));
          if (pc < kCols / 2 && px < wo)
            *reinterpret_cast<uint32_t*>(orow + static_cast<size_t>(px) * kC) =
                pack_bf16(fmaxf(v0 + bias0, 0.f), fmaxf(v1 + bias1, 0.f));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Block1Args& a, cudaStream_t stream) {
  cudaError_t err = tp_allow_smem(block1_kernel<T>, kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long tiles = static_cast<long long>(a.n) * a.tiles_y * a.tiles_x;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  block1_kernel<T><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

// One bare wgmma tile, for the descriptor layout's own test. pixels is
// [2 planes][n_pixels][8] bf16, w is [2][64][8]. As conv1_2 takes a tap:
// out (64 x 128) = w (pixels[shift : shift + 128])^T through two descriptors;
// as conv1_1 takes its im2col (from_regs): out (64 x 64) = pixels[shift :
// shift + 64] w^T with the pixels in registers.
__global__ void __launch_bounds__(128) wgmma_probe_kernel(const __nv_bfloat16* pixels,
                                                          const __nv_bfloat16* w, float* out,
                                                          int n_pixels, int shift,
                                                          int from_regs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int px_bytes = 2 * n_pixels * 16;
  for (int i = threadIdx.x; i < px_bytes / 16; i += 128)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(pixels)[i];
  for (int i = threadIdx.x; i < 2 * kC; i += 128)
    reinterpret_cast<uint4*>(smem + px_bytes)[i] = reinterpret_cast<const uint4*>(w)[i];
  fence_async_proxy();
  __syncthreads();
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, q = threadIdx.x % 4;
  const uint32_t s_base = smem_addr(smem);
  const uint64_t w_desc = matrix_desc(s_base + px_bytes, kC * 16, 128);
  if (from_regs) {
    float acc[32];
    fence_acc(acc);
    uint32_t frag[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = shift + 16 * warp + g + 8 * (i % 2);
      frag[i] =
          *reinterpret_cast<const uint32_t*>(smem + (i / 2) * n_pixels * 16 + row * 16 + q * 4);
    }
    wgmma_fence();
    wgmma_rs(acc, frag, w_desc, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      out[(16 * warp + g + 8 * (i / 2 % 2)) * kC + 8 * (i / 4) + 2 * q + i % 2] = acc[i];
  } else {
    float acc[64];
    fence_acc(acc);
    wgmma_fence();
    wgmma_ss_n128(acc, w_desc, matrix_desc(s_base + shift * 16, n_pixels * 16, 128), 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i)
      out[(16 * warp + g + 8 * (i / 2 % 2)) * 128 + 8 * (i / 4) + 2 * q + i % 2] = acc[i];
  }
}

}  // namespace

// x: (N, H, W, 3) f32 or bf16 read through its element strides (sn, sh, sw,
// sc), H and W even; w1, b1, w2, b2 as ops/block1.py pack_weights lays them
// out; out (N, H/2, W/2, 64) bf16 contiguous. Returns the cudaError_t of
// the launch.
extern "C" int tp_block1(const void* x, int x_is_bf16, long long sn, long long sh, long long sw,
                         long long sc, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int n, int h, int w, void* stream) {
  Block1Args a;
  a.x = x;
  a.sn = sn, a.sh = sh, a.sw = sw, a.sc = sc;
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n = n, a.h = h, a.w = w;
  a.tiles_x = (w + kCols - 1) / kCols;
  a.tiles_y = (h + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

// pixels: (2, n_pixels, 8) bf16, w: (2, 64, 8) bf16; out (64, 128) f32 = w
// pixels[shift : shift + 128]^T, or with from_regs (64, 64) = pixels[shift :
// shift + 64] w^T; shift + 128 <= n_pixels <= 1024.
extern "C" int tp_block1_wgmma_probe(const void* pixels, const void* w, void* out, int n_pixels,
                                     int shift, int from_regs, void* stream) {
  if (shift < 0 || n_pixels < shift + 128 || n_pixels > 1024) return cudaErrorInvalidValue;
  const size_t bytes = 2 * n_pixels * 16 + 2 * kC * 16;
  wgmma_probe_kernel<<<1, 128, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pixels), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), n_pixels, shift, from_regs);
  return cudaGetLastError();
}
