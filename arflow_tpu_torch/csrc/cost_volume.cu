// Local-correlation cost volume, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels arflow_tpu/ops/pallas/cost_volume_pallas.py:
// _fwd_kernel_v2 (the TPU default) and _fwd_kernel (v1). It computes
//
//   out[b, (dy+md)*(2md+1) + (dx+md), y, x]
//       = (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y+dy, x+dx],
//
// for |dy|, |dx| <= md, with f2 zero outside the image. Layout is NCHW:
// f1, f2 (B, C, H, W) float32 contiguous, out (B, (2md+1)^2, H, W) float32.
// Output channels are dy-major, as in arflow_tpu/ops/cost_volume.py.
//
// What bounds it: memory traffic. Each output pixel needs f1 and f2 read
// once (2*C*4 bytes) and (2md+1)^2 floats written: 580 bytes at C=32,
// md=4, against 5,184 FLOP, about 9 FLOP per byte, far below the card's
// float32 rate over its memory rate. The 81 shifted products, which the
// TPU kernel kept in VMEM, never leave the chip here either:
//
// - One thread per output pixel; x runs across the 32 threads of a warp,
//   so f1 reads and output writes coalesce. A thread keeps its (2md+1)^2
//   sums in registers (md is a template parameter, so the loops unroll).
// - A block covers a TY x TX tile of pixels. For each chunk of CC channels
//   it stages the f2 tile with its md-wide halo in shared memory, with
//   zeros where the halo leaves the image, so the inner loop has no bounds
//   checks and each f2 value is read from device memory about once per
//   block instead of (2md+1)^2 times.
// - Sums run over the channels in order, in float32, and are divided by C
//   at the end, as the plain version's mean does.
//
// wgmma, TMA loads and a pipelined halo ring are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kChunkC = 8;

template <int MD>
__global__ void __launch_bounds__(kTileX * kTileY)
cost_volume_fwd_kernel(const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       float* __restrict__ out,
                       int C, int H, int W) {
  constexpr int S = 2 * MD + 1;
  constexpr int SH = kTileY + 2 * MD;
  constexpr int SW = kTileX + 2 * MD;
  __shared__ float tile[kChunkC][SH][SW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool inside = (x < W) && (y < H);
  const int tid = ty * kTileX + tx;

  const size_t plane = static_cast<size_t>(H) * W;
  const float* f1b = f1 + static_cast<size_t>(b) * C * plane;
  const float* f2b = f2 + static_cast<size_t>(b) * C * plane;
  const size_t pix = inside ? static_cast<size_t>(y) * W + x : 0;

  float acc[S * S];
#pragma unroll
  for (int k = 0; k < S * S; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kChunkC) {
    const int nc = min(kChunkC, C - c0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < kChunkC * SH * SW; i += kTileX * kTileY) {
      const int cc = i / (SH * SW);
      const int r = i - cc * (SH * SW);
      const int sy = r / SW;
      const int sx = r - sy * SW;
      const int gy = y0 - MD + sy;
      const int gx = x0 - MD + sx;
      float v = 0.0f;
      if (cc < nc && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = f2b[static_cast<size_t>(c0 + cc) * plane +
                static_cast<size_t>(gy) * W + gx];
      }
      tile[cc][sy][sx] = v;
    }
    __syncthreads();
    if (inside) {
      for (int cc = 0; cc < nc; ++cc) {
        const float a = f1b[static_cast<size_t>(c0 + cc) * plane + pix];
#pragma unroll
        for (int dy = 0; dy < S; ++dy) {
#pragma unroll
          for (int dx = 0; dx < S; ++dx) {
            acc[dy * S + dx] = fmaf(a, tile[cc][ty + dy][tx + dx],
                                    acc[dy * S + dx]);
          }
        }
      }
    }
  }

  if (inside) {
    const float cf = static_cast<float>(C);
    float* outb = out + static_cast<size_t>(b) * (S * S) * plane + pix;
#pragma unroll
    for (int k = 0; k < S * S; ++k) outb[static_cast<size_t>(k) * plane] = acc[k] / cf;
  }
}

template <int MD>
void launch(const float* f1, const float* f2, float* out, int B, int C, int H,
            int W, cudaStream_t stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B);
  cost_volume_fwd_kernel<MD><<<grid, block, 0, stream>>>(f1, f2, out, C, H, W);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronizing and returns cudaGetLastError() (0 on success).
extern "C" int arflow_cost_volume_fwd(const float* f1, const float* f2,
                                      float* out, int B, int C, int H, int W,
                                      int md, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (md) {
    case 1: launch<1>(f1, f2, out, B, C, H, W, s); break;
    case 2: launch<2>(f1, f2, out, B, C, H, W, s); break;
    case 3: launch<3>(f1, f2, out, B, C, H, W, s); break;
    case 4: launch<4>(f1, f2, out, B, C, H, W, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
