// Local-correlation cost volume, backward, for Hopper (sm_90a).
//
// Replaces the backward of the TPU cost volume,
// arflow_tpu/ops/pallas/cost_volume_pallas.py:_grad_shifted (:141), the
// custom VJP of cost_volume_pallas_v2 (:226, :300) and of cost_volume_pallas
// (:174, :188), which XLA runs as 2 x (2md+1)^2 shifted products. With
// k = (dy+md)*(2md+1) + (dx+md) it computes, in NCHW float32,
//
//   gf1[b,c,y,x] = (1/C) sum_k g[b,k,y,x]           * f2[b,c,y+dy,x+dx]
//   gf2[b,c,y,x] = (1/C) sum_k g[b,k,y-dy,x-dx]     * f1[b,c,y-dy,x-dx]
//
// for |dy|, |dx| <= md (1 <= md <= 4), g, f1 and f2 zero outside the image,
// for any C, H and W: g (B, (2md+1)^2, H, W), f1, f2, gf1, gf2 (B, C, H, W),
// all contiguous. Either gradient may be skipped (null pointer).
//
// What bounds it: bytes. Per pixel the function reads g (K = 81 floats at
// md=4) and f1 and f2 (C each) and writes gf1 and gf2 (C each): (K + 4C)*4
// = 836 bytes at C=32, against 2*2*K*C = 10,368 FLOP, 12.4 FLOP per byte,
// under the card's float32 rate over its memory rate (67 TFLOP/s over 3.35
// TB/s, 20 FLOP per byte). The design, simple first:
//
// - Gather, not scatter. gf2 has the shape of gf1 with g read at the
//   shifted pixel, f1 for f2 and the displacements negated, so both are
//   gathers: each output reads its window. No atomics, so the result is
//   deterministic and does not depend on the launch plan. One launch
//   computes both: grid z runs over (batch, gradient).
// - g in registers. A thread owns one pixel of one gradient and keeps the
//   pixel's K values of g (for gf2 the shifted ones, zero outside) in
//   registers for its whole channel loop, since g is the same for every
//   channel. Each gradient reads g once, so the kernel reads it twice: it
//   moves (2K + 4C)*4 bytes per pixel, 1,160 at C=32, at best 72% of the
//   bound above.
// - The other factor from shared memory. Per chunk of 8 channels the block
//   stages the (8+2md) x (32+2md) window of f2 (f1 for gf2) around its 32x8
//   pixel tile, zeros outside the image, and each thread runs K FMAs per
//   channel, each with one shared load; a warp reads 32 consecutive floats,
//   so without bank conflicts. One shared load per FMA holds the kernel to
//   a quarter of the card's FMA rate; at the training shapes that is still
//   within a few times the byte bound.
// - Channel groups over blocks. Where tiles x batch x gradients leave SMs
//   without a block (the small levels), a tile's channels are split over
//   up to C/8 blocks. Each output's sum stays in one thread.
// - Sum order. Each output sums fmaf over k = 0..K-1 in order, in float32,
//   and is divided by C once at the end (rounded as division rounds it).
//   The plain version divides each term by C before it adds it, so the two
//   differ by rounding.
//
// Tensor cores are not used, for the forward's reasons (cost_volume.cu):
// TF32 would break the float32 parity.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileX = 32;   // tile width, pixels: one warp per row
constexpr int kTileY = 8;    // tile height: 8 warps
constexpr int kChunk = 8;    // channels staged per barrier pair
constexpr int kThreads = kTileX * kTileY;
constexpr int kMaxGridY = 65535;
constexpr int kMaxGridZ = 65535;

template <int MD>
__global__ void __launch_bounds__(kThreads, 2)
cost_volume_bwd_kernel(const float* __restrict__ g,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       float* __restrict__ gf1, float* __restrict__ gf2,
                       int C, int H, int W, int ntx, int group,
                       int first_grad, int ngrads) {
  constexpr int S = 2 * MD + 1;
  constexpr int K = S * S;
  constexpr int kCols = kTileX + 2 * MD;
  constexpr int kRows = kTileY + 2 * MD;
  constexpr int kPlane = kRows * kCols;
  __shared__ float tile[kChunk * kPlane];

  const int cg = blockIdx.x / ntx;
  const int x0 = (blockIdx.x - cg * ntx) * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int b = blockIdx.z / ngrads;
  const bool second = first_grad + static_cast<int>(blockIdx.z % ngrads) == 1;
  const int tx = threadIdx.x % kTileX;
  const int ty = threadIdx.x / kTileX;
  const int x = x0 + tx;
  const int y = y0 + ty;

  const size_t plane = static_cast<size_t>(H) * W;
  const float* gb = g + static_cast<size_t>(b) * K * plane;
  // gf1 reads f2 around the pixel; gf2 reads f1 and g at the pixel minus
  // the displacement.
  const float* src = (second ? f1 : f2) + static_cast<size_t>(b) * C * plane;
  float* out = (second ? gf2 : gf1) + static_cast<size_t>(b) * C * plane;

  float gk[K];
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int gy = second ? y - (i - MD) : y;
      const int gx = second ? x - (j - MD) : x;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      gk[i * S + j] =
          in ? __ldg(gb + static_cast<size_t>(i * S + j) * plane +
                     static_cast<size_t>(gy) * W + gx)
             : 0.0f;
    }
  }

  const float cf = static_cast<float>(C);
  const float rc = 1.0f / cf;
  const bool store = y < H && x < W;
  const int c_begin = cg * group;
  const int c_end = min(C, c_begin + group);
  // Staged row r, column q holds image row y0 - MD + r, column x0 - MD + q.
  const float* own = tile + ty * kCols + tx;
  for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
    const int nc = min(kChunk, c_end - c0);
    __syncthreads();  // everyone is done with the previous chunk
    const float* sc = src + static_cast<size_t>(c0) * plane;
    for (int l = threadIdx.x; l < nc * kPlane; l += kThreads) {
      const int cc = l / kPlane;
      const int rem = l - cc * kPlane;
      const int r = rem / kCols;
      const int q = rem - r * kCols;
      const int gy = y0 - MD + r;
      const int gx = x0 - MD + q;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      tile[l] = in ? __ldg(sc + static_cast<size_t>(cc) * plane +
                           static_cast<size_t>(gy) * W + gx)
                   : 0.0f;
    }
    __syncthreads();
    for (int cc = 0; cc < nc; ++cc) {
      const float* t = own + cc * kPlane;
      float acc = 0.0f;
      if (second) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            acc = fmaf(gk[i * S + j], t[(2 * MD - i) * kCols + 2 * MD - j],
                       acc);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < S; ++i) {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            acc = fmaf(gk[i * S + j], t[i * kCols + j], acc);
          }
        }
      }
      if (store) {
        // acc / C, correctly rounded (Markstein's correction of acc * RN(1/C)).
        const float v = acc * rc;
        out[static_cast<size_t>(c0 + cc) * plane +
            static_cast<size_t>(y) * W + x] = fmaf(fmaf(-v, cf, acc), rc, v);
      }
    }
  }
}

struct Plan {
  int ntx;    // x tiles
  int group;  // channels per block
  dim3 grid;
};

// Tiles first; where B * tiles * gradients would leave SMs without a block,
// split each tile's channels (in chunks of kChunk) over the fewest blocks
// that give every SM one.
cudaError_t make_plan(int B, int C, int H, int W, int ngrads, Plan* plan) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int ntx = (W + kTileX - 1) / kTileX;
  const int nty = (H + kTileY - 1) / kTileY;
  if (nty > kMaxGridY || static_cast<long long>(B) * ngrads > kMaxGridZ) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = static_cast<long long>(ntx) * nty * B * ngrads;
  const int chunks = (C + kChunk - 1) / kChunk;
  int parts = 1;
  while (parts < chunks && tiles * parts < sms) ++parts;
  const int group = (chunks + parts - 1) / parts * kChunk;
  parts = (C + group - 1) / group;
  if (static_cast<long long>(ntx) * parts > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  plan->ntx = ntx;
  plan->group = group;
  plan->grid = dim3(ntx * parts, nty, B * ngrads);
  return cudaSuccess;
}

template <int MD>
cudaError_t launch(const float* g, const float* f1, const float* f2,
                   float* gf1, float* gf2, int C, int H, int W, int first,
                   int ngrads, const Plan& p, cudaStream_t stream) {
  cost_volume_bwd_kernel<MD><<<p.grid, kThreads, 0, stream>>>(
      g, f1, f2, gf1, gf2, C, H, W, p.ntx, p.group, first, ngrads);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches one kernel on `stream`
// without synchronizing and returns cudaGetLastError() (0 on success). A
// null gf1 or gf2 skips that gradient; with both null nothing is launched.
extern "C" int arflow_cost_volume_bwd(const float* g, const float* f1,
                                      const float* f2, float* gf1,
                                      float* gf2, int B, int C, int H, int W,
                                      int md, void* stream) {
  if (md < 1 || md > 4) return static_cast<int>(cudaErrorInvalidValue);
  const int ngrads = (gf1 != nullptr) + (gf2 != nullptr);
  if (ngrads == 0) return 0;
  const int first = gf1 != nullptr ? 0 : 1;
  Plan p;
  const cudaError_t err = make_plan(B, C, H, W, ngrads, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (md) {
    case 1:
      return static_cast<int>(
          launch<1>(g, f1, f2, gf1, gf2, C, H, W, first, ngrads, p, s));
    case 2:
      return static_cast<int>(
          launch<2>(g, f1, f2, gf1, gf2, C, H, W, first, ngrads, p, s));
    case 3:
      return static_cast<int>(
          launch<3>(g, f1, f2, gf1, gf2, C, H, W, first, ngrads, p, s));
    default:
      return static_cast<int>(
          launch<4>(g, f1, f2, gf1, gf2, C, H, W, first, ngrads, p, s));
  }
}

// Blocks that arflow_cost_volume_bwd launches for this shape and number of
// gradients on the current device (its grid size), or -1 if it would
// refuse the shape.
extern "C" long long arflow_cost_volume_bwd_blocks(int B, int C, int H, int W,
                                                   int md, int ngrads) {
  Plan p;
  if (md < 1 || md > 4 || ngrads < 1 || ngrads > 2 ||
      make_plan(B, C, H, W, ngrads, &p) != cudaSuccess) {
    return -1;
  }
  return static_cast<long long>(p.grid.x) * p.grid.y * p.grid.z;
}
