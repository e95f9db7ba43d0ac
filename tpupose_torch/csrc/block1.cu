// Fused VGG block 1: conv1_1 (3->64, 3x3 SAME) + bias + ReLU ->
// conv1_2 (64->64, 3x3 SAME) + bias + ReLU -> 2x2/2 max-pool, one pass.
//
// Replaces tpupose/ops/pallas_block1.py::fused_block1 (_block1_kernel).
// Same contract: bf16 operands, f32 accumulation, f32 bias, conv1_1
// rounded to bf16 before conv1_2, bf16 (N, H/2, W/2, 64) NHWC output.
//
// What bounds it on the H100: conv1_2 is 576 MACs per output channel and
// pixel (74k per pixel), the bulk of the FLOPs; the 64-channel full-res
// activation between the two convs is 128 bytes per pixel, which the
// unfused path writes and reads back from device memory twice (conv1_2
// input, pool input). Design: one block of 16 warps owns a 32x16 conv
// tile (16x8 pooled outputs). conv1_1 runs on CUDA cores over the 34x18
// halo tile (27 MACs per output, weights in registers) straight into
// shared memory, so the full-res activation never reaches device memory;
// conv1_2 runs on the tensor cores (WMMA bf16 16x16x16, f32 accumulators)
// as an implicit GEMM whose A operand is read in place from the shared
// activation tile (rows = 16 consecutive pixels, stride = the padded
// channel pitch) and whose B operand (the 72 KB of conv1_2 weights) sits
// in shared memory at a conflict-free row pitch. Each warp owns the two
// conv rows of one pooled row, so the vertical max of the pool is an
// element-wise max of two accumulator fragments; bias and ReLU commute
// with max and are applied once, after the pool. Per image the kernel
// reads H*W*3 bf16 once and writes (H/2)*(W/2)*64 bf16 once. The 188 KB
// of shared memory allow one block per SM. Not yet done (later work):
// wgmma/TMA, conv1_1 on the tensor cores, and a persistent loop that
// keeps the weights resident across tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kC = 64;              // channels of conv1_1 and conv1_2
constexpr int kTileH = 32;          // conv rows per block (16 pooled rows)
constexpr int kTileW = 16;          // conv cols per block (8 pooled cols)
constexpr int kActH = kTileH + 2;   // conv1_1 tile incl. the halo conv1_2 reads
constexpr int kActW = kTileW + 2;
constexpr int kInH = kTileH + 4;    // input tile incl. both halos
constexpr int kInW = kTileW + 4;
constexpr int kPitch = 80;          // channel pitch of the activation tile:
                                    // 160 B keeps WMMA's 32 B alignment and
                                    // spreads rows over the shared banks
constexpr int kW2Pitch = 72;        // row pitch of the conv1_2 weights: 144 B
                                    // rows make the 8-row fragment loads
                                    // conflict-free (128 B rows are 8-way)
constexpr int kWarps = kTileH / 2;  // one per pooled row of the tile
constexpr int kThreads = kWarps * 32;

constexpr size_t kW2Bytes = 9 * kC * kW2Pitch * sizeof(__nv_bfloat16);      // 82944
constexpr size_t kActBytes = kActH * kActW * kPitch * sizeof(__nv_bfloat16);  // 97920
constexpr size_t kInBytes = kInH * kInW * 4 * sizeof(float);                  // 11520
constexpr size_t kStageBytes = kWarps * kTileW * kC * sizeof(float);         // 65536
constexpr size_t kSmem = kW2Bytes + kActBytes + kInBytes + kC * sizeof(float);
static_assert(kStageBytes <= kActBytes, "the pool staging reuses the activation tile");

__global__ void __launch_bounds__(kThreads)
block1_kernel(const __nv_bfloat16* __restrict__ x,   // (N, H, W, 3)
              const float* __restrict__ w1,          // (3, 3, 3, 64) HWIO
              const float* __restrict__ b1,          // (64,)
              const __nv_bfloat16* __restrict__ w2,  // (3, 3, 64, 64) HWIO
              const float* __restrict__ b2,          // (64,)
              __nv_bfloat16* __restrict__ out,       // (N, H/2, W/2, 64)
              int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_w2 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_act = reinterpret_cast<__nv_bfloat16*>(smem + kW2Bytes);
  float* s_in = reinterpret_cast<float*>(smem + kW2Bytes + kActBytes);
  float* s_b2 = s_in + kInH * kInW * 4;

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  // --- conv1_2 weights and the zero-padded input tile (3 channels + a
  //     zero 4th, so a pixel is one 16 B load) ---------------------------
  {
    const uint4* g = reinterpret_cast<const uint4*>(w2);
    constexpr int kRowVecs = kC * sizeof(__nv_bfloat16) / sizeof(uint4);   // 8
    for (int i = tid; i < 9 * kC * kRowVecs; i += kThreads) {
      const int row = i / kRowVecs;
      reinterpret_cast<uint4*>(s_w2 + row * kW2Pitch)[i % kRowVecs] = g[i];
    }
  }
  if (tid < kC) s_b2[tid] = b2[tid];
  const __nv_bfloat16* xn = x + static_cast<size_t>(n) * H * W * 3;
  for (int i = tid; i < kInH * kInW * 4; i += kThreads) {
    const int c = i % 4;
    const int p = i / 4;
    const int gy = y0 - 2 + p / kInW;
    const int gx = x0 - 2 + p % kInW;
    float v = 0.f;
    if (c < 3 && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __bfloat162float(xn[(static_cast<size_t>(gy) * W + gx) * 3 + c]);
    s_in[i] = v;
  }
  __syncthreads();

  // --- conv1_1 + bias + ReLU -> bf16 activation tile (zero off-image) --
  // act[ay][ax] is conv1_1 at image (y0 - 1 + ay, x0 - 1 + ax). Thread t
  // owns output channel t % 64 (its 27 weights stay in registers) and
  // every (kThreads / 64)-th pixel; a warp's 32 threads share the pixel,
  // so their input reads are broadcasts.
  {
    const int co = tid % kC;
    float wr[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) wr[k] = w1[k * kC + co];
    const float bias = b1[co];
    for (int p = tid / kC; p < kActH * kActW; p += kThreads / kC) {
      const int ay = p / kActW;
      const int ax = p % kActW;
      const int gy = y0 - 1 + ay;
      const int gx = x0 - 1 + ax;
      float acc = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float4* in = reinterpret_cast<const float4*>(s_in) + ay * kInW + ax;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 v = in[dy * kInW + dx];
            const float* w = wr + (dy * 3 + dx) * 3;
            acc = fmaf(v.x, w[0], acc);
            acc = fmaf(v.y, w[1], acc);
            acc = fmaf(v.z, w[2], acc);
          }
        acc = fmaxf(acc + bias, 0.f);
      }
      s_act[p * kPitch + co] = __float2bfloat16(acc);
    }
  }
  __syncthreads();

  // --- conv1_2 on the tensor cores: warp w computes conv rows 2w, 2w+1 -
  const int warp = tid / 32;
  const int lane = tid % 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0[4], acc1[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    wmma::fill_fragment(acc0[f], 0.f);
    wmma::fill_fragment(acc1[f], 0.f);
  }
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
#pragma unroll
    for (int c0 = 0; c0 < kC; c0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, s_act + ((2 * warp + dy) * kActW + dx) * kPitch + c0, kPitch);
      wmma::load_matrix_sync(a1, s_act + ((2 * warp + 1 + dy) * kActW + dx) * kPitch + c0,
                             kPitch);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, s_w2 + (tap * kC + c0) * kW2Pitch + f * 16, kW2Pitch);
        wmma::mma_sync(acc0[f], a0, b, acc0[f]);
        wmma::mma_sync(acc1[f], a1, b, acc1[f]);
      }
    }
  }
  __syncthreads();  // every warp is done with the activation tile

  // --- pool: vertical max of the two rows (same fragment layout), then
  //     the horizontal max, bias and ReLU per (pooled col, channel) ------
  float* st = reinterpret_cast<float*>(s_act) + warp * kTileW * kC;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
#pragma unroll
    for (int i = 0; i < acc0[f].num_elements; ++i)
      acc0[f].x[i] = fmaxf(acc0[f].x[i], acc1[f].x[i]);
    wmma::store_matrix_sync(st + f * 16, acc0[f], kC, wmma::mem_row_major);
  }
  __syncwarp();

  const int Ho = H / 2;
  const int Wo = W / 2;
  const int py = blockIdx.y * (kTileH / 2) + warp;
  if (py >= Ho) return;
  const int c = 2 * lane;
  for (int p = 0; p < kTileW / 2; ++p) {
    const int px = blockIdx.x * (kTileW / 2) + p;
    if (px >= Wo) break;
    float v0 = fmaxf(st[(2 * p) * kC + c], st[(2 * p + 1) * kC + c]);
    float v1 = fmaxf(st[(2 * p) * kC + c + 1], st[(2 * p + 1) * kC + c + 1]);
    v0 = fmaxf(v0 + s_b2[c], 0.f);
    v1 = fmaxf(v1 + s_b2[c + 1], 0.f);
    *reinterpret_cast<__nv_bfloat162*>(
        out + ((static_cast<size_t>(n) * Ho + py) * Wo + px) * kC + c) =
        __floats2bfloat162_rn(v0, v1);
  }
}

}  // namespace

// x (N, H, W, 3) bf16, w1 (3,3,3,64) f32, b1 (64) f32, w2 (3,3,64,64)
// bf16, b2 (64) f32, out (N, H/2, W/2, 64) bf16; all contiguous, H and W
// even. Returns the cudaError_t of the launch.
extern "C" int tp_block1(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int n, int h, int w, void* stream) {
  cudaError_t err = tp_allow_smem(block1_kernel, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  block1_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), h, w);
  return cudaGetLastError();
}
