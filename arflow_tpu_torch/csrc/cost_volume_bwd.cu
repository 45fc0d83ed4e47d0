// Local-correlation cost volume, backward, for Hopper (sm_90a).
//
// Replaces the backward of the TPU cost volume,
// arflow_tpu/ops/pallas/cost_volume_pallas.py:_grad_shifted (:141), the
// custom VJP of cost_volume_pallas_v2 (:226, :300) and of cost_volume_pallas
// (:174, :188), which XLA runs as 2 x (2md+1)^2 shifted products. With
// S = 2md+1, K = S^2 and k = (dy+md)*S + (dx+md) it computes, in NCHW
// float32,
//
//   gf1[b,c,y,x] = (1/C) sum_k g[b,k,y,x]       * f2[b,c,y+dy,x+dx]
//   gf2[b,c,y,x] = (1/C) sum_k g[b,k,y-dy,x-dx] * f1[b,c,y-dy,x-dx]
//
// for |dy|, |dx| <= md (1 <= md <= 4), g, f1 and f2 zero outside the image,
// for any C, H and W: g (B, K, H, W), f1, f2, gf1, gf2 (B, C, H, W), all
// contiguous. Either gradient may be skipped (null pointer).
//
// What bounds it: bytes. Per pixel the function reads g (K = 81 floats at
// md=4) and f1 and f2 (C each) and writes gf1 and gf2 (C each): (K + 4C)*4
// = 836 bytes at C=32, against 2*2*K*C = 10,368 FLOP, 12.4 FLOP per byte,
// under the card's float32 rate over its memory rate (67 TFLOP/s over 3.35
// TB/s, 20 FLOP per byte). Next in line: at large maps shared memory, which
// feeds the FMAs; at small maps, where a few blocks hold all the work, the
// serial path of one thread. The design:
//
// - One gather for both gradients (against two inner loops). Substituting
//   the mirrored displacement K-1-k for k in gf2 gives both the one form
//
//     out[b,c,p] = (1/C) sum_k G[b,k,p] * F[b,c,p+d_k],  d_k = (dy, dx),
//
//   gf1 with G = g, F = f2, and gf2 with G[k,p] = g[K-1-k, p+d_k], F = f1.
//   The mirror and the row shift dy of g are applied when g is staged; the
//   column shift dx when a thread reads its 4 values of G (below). The FMA
//   loop is the same for both. Each output's sum stays in one thread: no
//   atomics, the result does not depend on the launch plan, and a gradient
//   computed alone equals the pair bit for bit. One launch computes both:
//   grid z runs over (batch, gradient).
// - 4 consecutive x by kGroup channels of one pixel row per thread (against
//   one dependent chain per output): 4*kGroup independent sums. The thread
//   loops over the S dy rows. Per dy row it reads its 4 pixels of G for
//   each dx, and per channel the 12 values [x-4, x+7] of the row of F at
//   that dy with 3 16-byte loads; md and the dx loop are compile-time, so
//   each FMA takes its F operand from those registers by a constant index.
//   G's 4 values are one aligned 16-byte load for gf1 and for gf2 where
//   dx % 4 == 0, two otherwise. With 8 channels at md=4 that is 33 loads
//   (132 words; gf2 45, 180) for 288 FMAs, against one load per FMA.
// - Two tiles (template parameter kQuads). Large maps: 16 quads (64 px) by
//   4 rows by 4 groups of 8 channels, so that shared memory feeds the FMAs
//   with the fewest loads. Small maps, where those tiles would leave more
//   than half the SMs without a block: 4 quads (16 px) by 4 rows by 16
//   groups of 2 channels, a quarter of the serial path per thread, and up
//   to 4x the threads inside the image where W is under 64. Both are 256
//   threads and hold all 32 channels of a UFlow level, so each tile stages
//   g once; more channels go to further blocks (grid x). Channels are not
//   split over blocks to fill the SMs: every part would stage all of g
//   again. A quarter-warp reads one row: 8 consecutive 16-byte units, or
//   with 4-quad tiles 4 units in each of 2 channel groups, whose rings are
//   8 mod 16 floats apart, so without bank conflicts either way.
// - dy rows through rings (against loads not overlapped with compute). Per
//   dy row the block stages g's S planes for the tile's 4 rows and the one
//   row of F that enters the 4-row window (the first dy row stages 4). Both
//   are staged as image rows with a 4-column halo, so that every copy is
//   aligned: 16 bytes where the width is a multiple of 4 floats and the
//   pointers are aligned, 8 where it is even, 4 otherwise (template
//   parameter kW). Shifting gf2's planes by dx in the copies instead would
//   take 4-byte copies, 4x as many, and the copies weigh on every level. F
//   rows live in a ring of 4 + kAhead rows per channel, so each is staged
//   once for all the dy rows that read it. cp.async copies, issued kAhead
//   dy rows ahead, run under the FMAs of the current row, with one barrier
//   per dy row. A copy whose source lies outside the image (or past C) has
//   source size 0 and writes zeros, so the FMA loop has no bounds checks.
//   Dynamic shared memory at md=4, 32 channels: 87,424 bytes with 16-quad
//   tiles, which needs the opt-in above 48 KB and leaves room for 2 blocks
//   per SM; 29,824 with 4-quad tiles.
// - Sum order. Each output sums fmaf over k = 0..K-1 in order, in float32,
//   whatever the tile, and is divided by C once at the end, correctly
//   rounded (one reciprocal and Markstein's correction). The plain version
//   divides each term by C before it adds it, so the two differ by
//   rounding.
//
// Tensor cores are not used, for the forward's reasons (cost_volume.cu):
// TF32 would break the float32 parity.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTileY = 4;               // tile height, rows
constexpr int kHalo = 4;                // columns staged each side
constexpr int kAhead = 2;               // dy rows staged ahead
constexpr int kRing = kTileY + kAhead;  // F rows per channel
constexpr int kGStages = kAhead + 1;    // G stages
constexpr int kBlockChannels = 32;      // channels per block
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kMaxGridZ = 65535;

// A tile of kQuads 4-pixel quads by kTileY rows, for all kBlockChannels
// channels in groups of kGroup, one thread per quad, row and group.
template <int kQuads>
struct Tile {
  static constexpr int kTileX = 4 * kQuads;              // pixels
  static constexpr int kGroup = kQuads / 2;              // per thread
  static constexpr int kMaxGroups = kBlockChannels / kGroup;
  static constexpr int kCols = kTileX + 2 * kHalo;       // a staged row
  // F ring floats per channel, 8 mod 16: the two channel groups that a
  // quarter-warp of a 4-quad tile reads fall 4 units apart in the banks.
  static constexpr int kFChan = (kRing * kCols + 15) / 16 * 16 + 8;
  static constexpr int kGPlane = kTileY * kCols;         // one staged plane
  static_assert(kQuads * kTileY * kMaxGroups == kThreads, "256 threads");
};

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy kW floats to shared memory, or write zeros when `in` is false.
template <int kW>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  if constexpr (kW == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else if constexpr (kW == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 8 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// kW floats of image row gy of `plane`, from staged column `col` (image
// column x0 - kHalo + col), into `dst_row`; zeros outside the image. With
// W % kW == 0 and col % kW == 0 a copy is all in or all out.
template <int kW>
__device__ __forceinline__ void copy_piece(float* dst_row, const float* plane,
                                           bool plane_in, int gy, int col,
                                           int x0, int H, int W) {
  const int gx = x0 - kHalo + col;
  const bool in = plane_in && gy >= 0 && gy < H && gx >= 0 && gx < W;
  cp_async<kW>(dst_row + col,
               in ? plane + static_cast<size_t>(gy) * W + gx : plane, in);
}

// The thread's 4 values of G for each dx and its FMAs over the block's
// staged dy row. gs, fs: the thread's row of the G stage and of the F ring
// at staged column 4q (image column x - 4).
template <int MD, int kQuads, bool kSecond>
__device__ __forceinline__ void dy_row(
    float (&acc)[Tile<kQuads>::kGroup][4], const float* gs, const float* fs) {
  using T = Tile<kQuads>;
  constexpr int S = 2 * MD + 1;
  float gv[S][4];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    // Pixel x+e reads G at image column x+e (gf1) or x+e+dx (gf2): staged
    // column 4q + o + e.
    const int o = kHalo + (kSecond ? j - MD : 0);
    const float* p = gs + j * T::kGPlane + (o & ~3);
    const float4 a = *reinterpret_cast<const float4*>(p);
    if (o % 4 == 0) {
      gv[j][0] = a.x;
      gv[j][1] = a.y;
      gv[j][2] = a.z;
      gv[j][3] = a.w;
    } else {
      const float4 c = *reinterpret_cast<const float4*>(p + 4);
      const float w[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[j][e] = w[(o & 3) + e];
    }
  }
#pragma unroll
  for (int cc = 0; cc < T::kGroup; ++cc) {
    const float* f = fs + cc * T::kFChan;
    const float4 v0 = *reinterpret_cast<const float4*>(f);
    const float4 v1 = *reinterpret_cast<const float4*>(f + 4);
    const float4 v2 = *reinterpret_cast<const float4*>(f + 8);
    const float v[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                         v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        acc[cc][e] = fmaf(gv[j][e], v[e + j + kHalo - MD], acc[cc][e]);
      }
    }
  }
}

// Grid: x = x-tile + ntx * part, y = y-tile, z = batch * ngrads + gradient.
// Block: kQuads * kTileY threads per channel group; thread = quad + kQuads
// * (group + groups * row). Part p takes channels [p * nch, (p + 1) * nch).
template <int MD, int kW, int kQuads>
__global__ void __launch_bounds__(kThreads, 2)
cost_volume_bwd_kernel(const float* __restrict__ g,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       float* __restrict__ gf1, float* __restrict__ gf2,
                       int C, int H, int W, int ntx, int first_grad,
                       int ngrads) {
  using T = Tile<kQuads>;
  constexpr int S = 2 * MD + 1;
  constexpr int K = S * S;
  constexpr int kN = T::kCols / kW;  // copies per staged row
  extern __shared__ __align__(16) float smem[];

  const int groups = blockDim.x / (kQuads * kTileY);
  const int nch = groups * T::kGroup;  // channels staged by this block
  const int part = blockIdx.x / ntx;
  const int x0 = (blockIdx.x - part * ntx) * T::kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int b = blockIdx.z / ngrads;
  const bool second = first_grad + static_cast<int>(blockIdx.z % ngrads) == 1;
  const int c0 = part * nch;
  const int tid = threadIdx.x;
  const int q = tid % kQuads;
  const int grp = (tid / kQuads) % groups;
  const int r = tid / (kQuads * groups);
  const int cg0 = c0 + grp * T::kGroup;  // the thread's first channel

  const size_t plane = static_cast<size_t>(H) * W;
  const float* gb = g + static_cast<size_t>(b) * K * plane;
  // gf1 gathers f2 around the pixel, gf2 gathers f1.
  const float* F = (second ? f1 : f2) + static_cast<size_t>(b) * C * plane;
  float* out = (second ? gf2 : gf1) + static_cast<size_t>(b) * C * plane;
  float* ring = smem;                   // [nch][kFChan], kRing rows each
  float* gst = smem + nch * T::kFChan;  // [kGStages][S][kTileY][kCols]

  // Dy row t: F's staged rows that enter the window (image row y0 - MD + s
  // for s = 0..3 at t = 0, else s = t + 3) into ring row s % kRing, and g's
  // planes of dy row t into G stage t % kGStages: for gf1 planes t*S + j at
  // rows y0 + rr, for gf2 planes K-1-(t*S + j) at rows y0 + rr + t - MD.
  auto load = [&](int t) {
    for (int s = t == 0 ? 0 : t + kTileY - 1; s < t + kTileY; ++s) {
      float* dst = ring + (s % kRing) * T::kCols;
      for (int pos = tid; pos < nch * kN; pos += blockDim.x) {
        const int cc = pos / kN;
        copy_piece<kW>(dst + cc * T::kFChan, F + (c0 + cc) * plane,
                       c0 + cc < C, y0 - MD + s, (pos - cc * kN) * kW, x0, H,
                       W);
      }
    }
    float* gdst = gst + (t % kGStages) * S * T::kGPlane;
    const int sy = second ? t - MD : 0;
    for (int pos = tid; pos < S * kTileY * kN; pos += blockDim.x) {
      const int row = pos / kN;  // j * kTileY + rr
      const int j = row / kTileY;
      const int rr = row - j * kTileY;
      const int k = t * S + j;
      copy_piece<kW>(gdst + row * T::kCols,
                     gb + static_cast<size_t>(second ? K - 1 - k : k) * plane,
                     true, y0 + rr + sy, (pos - row * kN) * kW, x0, H, W);
    }
  };

  float acc[T::kGroup][4];
#pragma unroll
  for (int cc = 0; cc < T::kGroup; ++cc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[cc][e] = 0.0f;
  }

  const bool active = cg0 < C;
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < S) load(t);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < S; ++i) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of dy row i landed
    __syncthreads();  // everyone's have; everyone is done with dy row i-1
    if (i + kAhead < S) load(i + kAhead);  // into the slots row i-1 used
    cp_async_commit();
    if (active) {
      const float* gs =
          gst + (i % kGStages) * S * T::kGPlane + r * T::kCols + 4 * q;
      const float* fs = ring + (grp * T::kGroup) * T::kFChan +
                        ((i + r) % kRing) * T::kCols + 4 * q;
      if (second) {
        dy_row<MD, kQuads, true>(acc, gs, fs);
      } else {
        dy_row<MD, kQuads, false>(acc, gs, fs);
      }
    }
  }

  const int y = y0 + r;
  const int x = x0 + 4 * q;
  if (!active || y >= H || x >= W) return;
  // sum / C, correctly rounded as division rounds it (Markstein's
  // correction of sum * RN(1/C)).
  const float cf = static_cast<float>(C);
  const float rc = 1.0f / cf;
  float* o = out + static_cast<size_t>(cg0) * plane +
             static_cast<size_t>(y) * W + x;
#pragma unroll
  for (int cc = 0; cc < T::kGroup; ++cc) {
    if (cg0 + cc < C) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float qv = acc[cc][e] * rc;
        v[e] = fmaf(fmaf(-qv, cf, acc[cc][e]), rc, qv);
      }
      float* oc = o + cc * plane;
      if constexpr (kW == 4) {
        *reinterpret_cast<float4*>(oc) = make_float4(v[0], v[1], v[2], v[3]);
      } else if constexpr (kW == 2) {
        // W even: x < W covers x + 1, and x + 2 < W covers x + 3.
        *reinterpret_cast<float2*>(oc) = make_float2(v[0], v[1]);
        if (x + 2 < W) {
          *reinterpret_cast<float2*>(oc + 2) = make_float2(v[2], v[3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (x + e < W) oc[e] = v[e];
        }
      }
    }
  }
}

struct Plan {
  int quads;  // tile width in quads: 16 or 4
  int ntx;    // x tiles
  dim3 grid;
  dim3 block;
  size_t smem;
};

template <int kQuads>
cudaError_t make_plan_for(int B, int C, int H, int W, int md, int ngrads,
                          Plan* plan) {
  using T = Tile<kQuads>;
  const int ntx = (W + T::kTileX - 1) / T::kTileX;
  const int nty = (H + kTileY - 1) / kTileY;
  if (nty > kMaxGridY || static_cast<long long>(B) * ngrads > kMaxGridZ) {
    return cudaErrorInvalidValue;
  }
  const int chunks = (C + T::kGroup - 1) / T::kGroup;  // channel groups of C
  int groups = T::kMaxGroups;
  while (groups > 1 && groups / 2 >= chunks) groups /= 2;
  const int parts = (chunks + groups - 1) / groups;
  if (static_cast<long long>(ntx) * parts > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int S = 2 * md + 1;
  plan->quads = kQuads;
  plan->ntx = ntx;
  plan->grid = dim3(ntx * parts, nty, B * ngrads);
  plan->block = dim3(kQuads * kTileY * groups);
  plan->smem = sizeof(float) *
               (static_cast<size_t>(groups) * T::kGroup * T::kFChan +
                static_cast<size_t>(kGStages) * S * T::kGPlane);
  return cudaSuccess;
}

// 16-quad tiles, unless they would leave more than half the SMs without a
// block; then 4-quad tiles. The choice depends on the shape only, not on
// the gradients asked for, so that one gradient alone is computed by the
// same threads as the pair.
cudaError_t make_plan(int B, int C, int H, int W, int md, int ngrads,
                      Plan* plan) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long wide = static_cast<long long>(B) * 2 *
                         ((W + Tile<16>::kTileX - 1) / Tile<16>::kTileX) *
                         ((H + kTileY - 1) / kTileY);
  return 2 * wide >= sms ? make_plan_for<16>(B, C, H, W, md, ngrads, plan)
                         : make_plan_for<4>(B, C, H, W, md, ngrads, plan);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// The widest copy that every row start allows: 4 floats where W % 4 == 0
// and the pointers are 16-byte aligned, 2 where W is even and they are
// 8-byte aligned, else 1. A null gradient is never written.
int copy_width(const void* const* ptrs, int n, int W) {
  for (int kw = 4; kw > 1; kw /= 2) {
    bool ok = W % kw == 0;
    for (int i = 0; i < n && ok; ++i) ok = aligned(ptrs[i], 4 * kw);
    if (ok) return kw;
  }
  return 1;
}

template <int MD, int kW, int kQuads>
cudaError_t launch_tile(const float* g, const float* f1, const float* f2,
                        float* gf1, float* gf2, int C, int H, int W,
                        int first, int ngrads, const Plan& p,
                        cudaStream_t stream) {
  auto kernel = cost_volume_bwd_kernel<MD, kW, kQuads>;
  // The rings of 16-quad tiles take more than the 48 KB of dynamic shared
  // memory a kernel gets without opting in.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.block, p.smem, stream>>>(g, f1, f2, gf1, gf2, C, H, W,
                                               p.ntx, first, ngrads);
  return cudaGetLastError();
}

template <int MD, int kW>
cudaError_t launch_w(const float* g, const float* f1, const float* f2,
                     float* gf1, float* gf2, int C, int H, int W, int first,
                     int ngrads, const Plan& p, cudaStream_t stream) {
  return p.quads == 16
             ? launch_tile<MD, kW, 16>(g, f1, f2, gf1, gf2, C, H, W, first,
                                       ngrads, p, stream)
             : launch_tile<MD, kW, 4>(g, f1, f2, gf1, gf2, C, H, W, first,
                                      ngrads, p, stream);
}

template <int MD>
cudaError_t launch(const float* g, const float* f1, const float* f2,
                   float* gf1, float* gf2, int C, int H, int W, int first,
                   int ngrads, const Plan& p, cudaStream_t stream) {
  const void* ptrs[] = {g, f1, f2, gf1, gf2};
  switch (copy_width(ptrs, 5, W)) {
    case 4:
      return launch_w<MD, 4>(g, f1, f2, gf1, gf2, C, H, W, first, ngrads, p,
                             stream);
    case 2:
      return launch_w<MD, 2>(g, f1, f2, gf1, gf2, C, H, W, first, ngrads, p,
                             stream);
    default:
      return launch_w<MD, 1>(g, f1, f2, gf1, gf2, C, H, W, first, ngrads, p,
                             stream);
  }
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
  const cudaError_t err = make_plan(B, C, H, W, md, ngrads, &p);
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
      make_plan(B, C, H, W, md, ngrads, &p) != cudaSuccess) {
    return -1;
  }
  return static_cast<long long>(p.grid.x) * p.grid.y * p.grid.z;
}
