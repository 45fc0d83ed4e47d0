// Local-correlation cost volume, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of arflow_tpu/ops/pallas/cost_volume_pallas.py:
// _fwd_kernel_v2 (the TPU default, pallas_call at :267) and _fwd_kernel
// (v1, halos pre-stacked, pallas_call at :96). It computes
//
//   out[b, (dy+md)*(2md+1) + (dx+md), y, x]
//       = (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y+dy, x+dx],
//
// for |dy|, |dx| <= md (1 <= md <= 4), with f2 zero outside the image, for
// any C, H and W. Layout is NCHW: f1, f2 (B, C, H, W) float32 contiguous,
// out (B, (2md+1)^2, H, W) float32. Output channels are dy-major, as in
// arflow_tpu/ops/cost_volume.py.
//
// What bounds it: bytes. Each output pixel needs f1 and f2 read once
// (2*C*4 bytes) and (2md+1)^2 floats written: 580 bytes at C=32, md=4,
// against 5,184 FLOP, about 9 FLOP per byte, under the card's float32 rate
// over its memory rate (67 TFLOP/s over 3.35 TB/s, 20 FLOP per byte). The
// design keeps the rest of the work under that bound:
//
// - Displacement rows over warps (against few blocks with long serial
//   paths). A block covers a 32x8 pixel tile. A thread owns a strip of 8
//   consecutive x in one pixel row and one dy row, with all 2md+1 dx:
//   8*(2md+1) sums in registers, 72 at md=4. Warp w of a block takes the
//   block's w-th dy row; lane l takes pixel row l%8 and strip l/8. Where the
//   tiles alone would leave SMs without a block (small levels, batch 1), the
//   2md+1 dy rows of a tile are split over up to 2md+1 blocks (`make_plan`),
//   so the grid still reaches every SM and each block's serial path shrinks
//   by the same factor. The channel sum is never split.
// - f2 from registers (against one shared-memory load per FMA). Per channel
//   a thread reads the 16 f2 values its strip needs in its dy row (8 plus a
//   4-column halo on each side) with four 16-byte shared loads and its 8 f1
//   values with two, then runs 8*(2md+1) FMAs from registers: 6 loads per
//   72 FMAs at md=4. Row strides of odd numbers of 16-byte units put the 8
//   rows that a quarter-warp reads on distinct banks.
// - Channel chunks through a ring (against loads not overlapped with
//   compute). f2's halo tile and f1's tile go through a ring of 2 stages of
//   8 channels in shared memory, filled with cp.async: the copies of chunk
//   k+1 run under the FMAs of chunk k, with one barrier per chunk. A copy
//   whose source lies outside the image has source size 0, which writes
//   zeros, so the zero halo is never materialized and the inner loop has no
//   bounds checks. A thread issues the copies of a staged position for all
//   channels of the chunk, with one division by a constant per position.
//   Rows whose width is a multiple of 4 floats (every UFlow level of
//   384x640), with 16-byte aligned pointers, take 16-byte copies and
//   16-byte stores; other shapes take 4-byte copies and scalar stores in the
//   same kernel (template parameter kVec). The ring is 63,488 bytes at md=4,
//   which needs the opt-in above 48 KB.
// - Occupancy (against too few resident warps). md is a template parameter,
//   so the sums stay in registers; __launch_bounds__ asks for 2 blocks of
//   2md+1 warps per SM, 18 warps (4.5 per scheduler) at md=4.
// - Stores. A warp stages each output plane of its tile in the ring slot
//   the last chunk left free, then writes it back so that each 16-byte
//   store instruction covers whole 128-byte lines (4 tile rows). Stored
//   straight from the strips, each instruction covers part of 8 lines, and
//   the output, the larger share of the bytes, goes out markedly slower.
// - Sum order. Each output sums fmaf over c = 0..C-1 in order, in float32,
//   and is divided by C at the end, rounded as division rounds it, as the
//   plain version's mean does. No atomics: the result does not depend on
//   the launch plan.
//
// Tensor cores are not used. At the level-1 shape of a 384x640 batch of 8
// the float32 FMA work (637 MFLOP, 9.5 us at 67 TFLOP/s) lies under the
// byte bound (21.3 us), so CUDA cores can reach the bound. TF32 would break
// the float32 parity that the port holds with TF32 off, and a 3xTF32 split
// would triple the work on a banded product that fills little of a wgmma
// tile.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileX = 32;                   // tile width, pixels
constexpr int kStrip = 8;                    // consecutive x per thread
constexpr int kStrips = kTileX / kStrip;     // strips per tile row
constexpr int kTileY = 32 / kStrips;         // tile height: one warp's rows
constexpr int kHalo = 4;                     // f2 columns staged each side
constexpr int kChunk = 8;                    // channels per ring stage
constexpr int kStages = 2;                   // ring depth
constexpr int kF2Cols = kTileX + 2 * kHalo;  // staged f2 columns
// Row strides in floats, odd numbers of 16-byte units, so that the 8 rows
// a quarter-warp reads with 16-byte loads fall on distinct banks.
constexpr int kF2Stride = kF2Cols + 4;
constexpr int kF1Stride = kTileX + 4;
constexpr int kOutStride = kTileX + 4;  // a warp's staged output plane
static_assert(kF2Stride % 8 == 4 && kF1Stride % 8 == 4 && kOutStride % 8 == 4,
              "odd 16-byte units");
// A free ring slot holds every warp's staged output plane (md <= 4).
static_assert(kChunk * kTileY * (kF2Stride + kF1Stride) >=
                  9 * kTileY * kOutStride,
              "output staging fits a ring slot");
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 (4) bytes to shared memory, or write zeros when `in` is false.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// One staged position for channels 0..nc-1 of a chunk: 16 bytes (kVec) or
// 4 bytes per channel, zeros where `in` is false.
template <bool kVec>
__device__ __forceinline__ void copy_channels(float* dst, int dst_stride,
                                              const float* src,
                                              size_t src_stride, int nc,
                                              bool in) {
#pragma unroll
  for (int cc = 0; cc < kChunk; ++cc) {
    if (cc < nc) {
      if constexpr (kVec) {
        cp_async16(dst + cc * dst_stride, src + cc * src_stride, in);
      } else {
        cp_async4(dst + cc * dst_stride, src + cc * src_stride, in);
      }
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Grid: x = x-tile + ntx * part, y = y-tile, z = batch. Block: one warp per
// dy row of the block's part (nw warps). Part p takes dy rows
// [p*nw, min((p+1)*nw, 2md+1)).
template <int MD, bool kVec>
__global__ void __launch_bounds__(32 * (2 * MD + 1), 2)
cost_volume_fwd_kernel(const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       float* __restrict__ out,
                       int C, int H, int W, int ntx, int nw) {
  constexpr int S = 2 * MD + 1;
  constexpr int kW = kVec ? 4 : 1;     // floats per copy
  constexpr int kN2 = kF2Cols / kW;    // copies per staged f2 row
  constexpr int kN1 = kTileX / kW;     // copies per staged f1 row
  extern __shared__ __align__(16) float smem[];

  const int part = blockIdx.x / ntx;
  const int x0 = (blockIdx.x - part * ntx) * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int r = tid % kTileY;          // pixel row in the tile
  const int s = (tid & 31) / kTileY;   // strip in the tile row
  const int dy0 = part * nw;           // the block's first dy row
  const int ndy = min(nw, S - dy0);    // dy rows this block computes
  const bool active = warp < ndy;
  const int f2_rows = kTileY + ndy - 1;        // staged f2 rows
  const int f2_pitch = (kTileY + nw - 1) * kF2Stride;  // floats per channel
  const int f2_stage = kChunk * f2_pitch;
  const int stage = f2_stage + kChunk * kTileY * kF1Stride;
  const int gy0 = y0 - MD + dy0;       // image row of staged f2 row 0

  const size_t plane = static_cast<size_t>(H) * W;
  const float* f1b = f1 + static_cast<size_t>(b) * C * plane;
  const float* f2b = f2 + static_cast<size_t>(b) * C * plane;

  // Issue the copies of channel chunk k into ring slot k % kStages. A
  // thread takes staged positions (row, column group) and copies each for
  // the chunk's channels: one constant division per position, none per copy.
  auto load = [&](int k) {
    const int c0 = k * kChunk;
    const int nc = min(kChunk, C - c0);
    float* s2 = smem + (k % kStages) * stage;
    float* s1 = s2 + f2_stage;
    const float* f2c = f2b + static_cast<size_t>(c0) * plane;
    const float* f1c = f1b + static_cast<size_t>(c0) * plane;
    for (int pos = tid; pos < f2_rows * kN2; pos += blockDim.x) {
      const int sy = pos / kN2;
      const int sx = (pos - sy * kN2) * kW;
      const int gy = gy0 + sy;
      const int gx = x0 - kHalo + sx;
      // With kVec, W % 4 == 0 and gx % 4 == 0: a copy is all in or all out.
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      copy_channels<kVec>(s2 + sy * kF2Stride + sx, f2_pitch,
                          f2c + (in ? gy * W + gx : 0), plane, nc, in);
    }
    for (int pos = tid; pos < kTileY * kN1; pos += blockDim.x) {
      const int sy = pos / kN1;
      const int sx = (pos - sy * kN1) * kW;
      const int gy = y0 + sy;
      const int gx = x0 + sx;
      const bool in = gy < H && gx < W;
      copy_channels<kVec>(s1 + sy * kF1Stride + sx, kTileY * kF1Stride,
                          f1c + (in ? gy * W + gx : 0), plane, nc, in);
    }
  };

  float acc[kStrip][S];
#pragma unroll
  for (int p = 0; p < kStrip; ++p) {
#pragma unroll
    for (int j = 0; j < S; ++j) acc[p][j] = 0.0f;
  }

  const int nchunks = (C + kChunk - 1) / kChunk;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nchunks) load(k);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk k landed
    __syncthreads();  // everyone's have; everyone is done with chunk k-1
    if (k + kStages - 1 < nchunks) load(k + kStages - 1);  // chunk k-1's slot
    cp_async_commit();
    if (active) {
      const int nc = min(kChunk, C - k * kChunk);
      const float* slot = smem + (k % kStages) * stage;
      const float* s2 = slot + (r + warp) * kF2Stride + s * kStrip;
      const float* s1 = slot + f2_stage + r * kF1Stride + s * kStrip;
#pragma unroll
      for (int cc = 0; cc < kChunk; ++cc) {
        if (cc < nc) {
          const float* pa = s1 + cc * kTileY * kF1Stride;
          const float* pv = s2 + cc * f2_pitch;
          const float4 a0 = *reinterpret_cast<const float4*>(pa);
          const float4 a1 = *reinterpret_cast<const float4*>(pa + 4);
          const float4 v0 = *reinterpret_cast<const float4*>(pv);
          const float4 v1 = *reinterpret_cast<const float4*>(pv + 4);
          const float4 v2 = *reinterpret_cast<const float4*>(pv + 8);
          const float4 v3 = *reinterpret_cast<const float4*>(pv + 12);
          const float a[kStrip] = {a0.x, a0.y, a0.z, a0.w,
                                   a1.x, a1.y, a1.z, a1.w};
          const float v[kStrip + 2 * kHalo] = {
              v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
              v2.x, v2.y, v2.z, v2.w, v3.x, v3.y, v3.z, v3.w};
          // Staged column q holds image column x0 - kHalo + q.
#pragma unroll
          for (int p = 0; p < kStrip; ++p) {
#pragma unroll
            for (int j = 0; j < S; ++j) {
              acc[p][j] = fmaf(a[p], v[p + j + kHalo - MD], acc[p][j]);
            }
          }
        }
      }
    }
  }

  if (!active) return;
  // sum / C, correctly rounded as division rounds it (Markstein's
  // correction of sum * RN(1/C)), without division's branch to its slow
  // path per value.
  const float cf = static_cast<float>(C);
  const float rc = 1.0f / cf;
  const int y = y0 + r;
  const int x = x0 + s * kStrip;
  float* ob = out + (static_cast<size_t>(b) * S + dy0 + warp) * S * plane;
  // The ring slot the last chunk did not use: every warp finished reading
  // it before the last barrier, and no copy is in flight into it.
  float* staged = smem + (nchunks % kStages) * stage +
                  warp * kTileY * kOutStride;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float v[kStrip];
#pragma unroll
    for (int p = 0; p < kStrip; ++p) {
      const float q = acc[p][j] * rc;
      v[p] = fmaf(fmaf(-q, cf, acc[p][j]), rc, q);
    }
    float* oj = ob + static_cast<size_t>(j) * plane;
    if constexpr (kVec) {
      // Through shared memory, so that each store instruction writes
      // whole 128-byte lines (4 tile rows).
      float* t = staged + r * kOutStride + s * kStrip;
      *reinterpret_cast<float4*>(t) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(t + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
      __syncwarp();
#pragma unroll
      for (int h = 0; h < kTileY * kTileX / 128; ++h) {
        const int i = (tid & 31) + 32 * h;
        const int row = i / (kTileX / 4);
        const int col = (i - row * (kTileX / 4)) * 4;
        if (y0 + row < H && x0 + col < W) {
          *reinterpret_cast<float4*>(
              oj + static_cast<size_t>(y0 + row) * W + x0 + col) =
              *reinterpret_cast<const float4*>(staged + row * kOutStride +
                                               col);
        }
      }
      __syncwarp();
    } else if (y < H) {
#pragma unroll
      for (int p = 0; p < kStrip; ++p) {
        if (x + p < W) oj[static_cast<size_t>(y) * W + x + p] = v[p];
      }
    }
  }
}

struct Plan {
  int ntx;    // x tiles
  int nw;     // dy rows (warps) per block
  dim3 grid;
  dim3 block;
  size_t smem;
};

// Tiles first; where B * tiles would leave SMs without a block, split each
// tile's 2md+1 dy rows over the fewest parts that give every SM one.
cudaError_t make_plan(int B, int H, int W, int md, Plan* plan) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int S = 2 * md + 1;
  const int ntx = (W + kTileX - 1) / kTileX;
  const int nty = (H + kTileY - 1) / kTileY;
  if (nty > kMaxGridY) return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>(ntx) * nty * B;
  int parts = 1;
  while (parts < S && tiles * parts < sms) ++parts;
  const int nw = (S + parts - 1) / parts;
  parts = (S + nw - 1) / nw;
  plan->ntx = ntx;
  plan->nw = nw;
  plan->grid = dim3(ntx * parts, nty, B);
  plan->block = dim3(32 * nw);
  plan->smem = sizeof(float) * kStages * kChunk *
               ((kTileY + nw - 1) * kF2Stride + kTileY * kF1Stride);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <int MD>
cudaError_t launch(const float* f1, const float* f2, float* out, int C,
                   int H, int W, const Plan& p, cudaStream_t stream) {
  const bool vec =
      W % 4 == 0 && aligned16(f1) && aligned16(f2) && aligned16(out);
  auto kernel = vec ? cost_volume_fwd_kernel<MD, true>
                    : cost_volume_fwd_kernel<MD, false>;
  // The ring takes more than the 48 KB of dynamic shared memory a kernel
  // gets without opting in.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.block, p.smem, stream>>>(f1, f2, out, C, H, W, p.ntx,
                                               p.nw);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches one kernel on `stream`
// without synchronizing and returns cudaGetLastError() (0 on success).
extern "C" int arflow_cost_volume_fwd(const float* f1, const float* f2,
                                      float* out, int B, int C, int H, int W,
                                      int md, void* stream) {
  if (md < 1 || md > 4) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = make_plan(B, H, W, md, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (md) {
    case 1: return static_cast<int>(launch<1>(f1, f2, out, C, H, W, p, s));
    case 2: return static_cast<int>(launch<2>(f1, f2, out, C, H, W, p, s));
    case 3: return static_cast<int>(launch<3>(f1, f2, out, C, H, W, p, s));
    default: return static_cast<int>(launch<4>(f1, f2, out, C, H, W, p, s));
  }
}

// Blocks that arflow_cost_volume_fwd launches for this shape on the current
// device (its grid size), or -1 if it would refuse the shape.
extern "C" long long arflow_cost_volume_blocks(int B, int H, int W, int md) {
  Plan p;
  if (md < 1 || md > 4 || make_plan(B, H, W, md, &p) != cudaSuccess) return -1;
  return static_cast<long long>(p.grid.x) * p.grid.y * p.grid.z;
}
