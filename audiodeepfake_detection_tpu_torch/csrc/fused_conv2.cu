// The DCNN's second pool block in one pass: conv2d(Cin -> Cout, 3x3, zero
// pad 1) with BatchNorm-folded weights + an additive map -> PReLU (one slope)
// -> floor-mode 2x2 max-pool, forward and backward, on NCHW memory.
//
//   x [B, Cin, H, W] (f32 or bf16), wk [Cin, 9, Cout], corr [Cout, H, W],
//   alpha [1] (f32)  ->  out [B, Cout, H/2, W/2] (x's type)
//   training forward also: a selection code per output element (pool phase
//     dh*2+dw of the FIRST maximum | "selected conv value < 0" << 2, one
//     byte) and per-block partial per-channel (sum, sumsq) of the rounded
//     stored output;
//   backward, three kernels:
//     dx    [B, Cin, H, W]: the transposed convolution of the conv-output
//           cotangent d, rebuilt tile by tile from (g, code, out);
//     dw    partials [splits, 9 * Cin, Cout]: x (*) d, split over B * H * W;
//     small dcorr [Cout, H, W] (the sum of d over the batch) and per-block
//           partials of dalpha.
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/fused_conv2.py::
// _fwd_kernel and ::_bwd_kernel (reached through fused_conv2_prelu_pool and
// fused_conv2_prelu_pool_stats).  Those hold a whole padded NHWC image per
// grid cell, build an im2col patch [W, 9*Cin] per conv row for one matrix-
// unit product, keep a whole-image dx accumulator that persists across the
// sequential grid, and accumulate dw / dcorr / dalpha into whole-array output
// blocks; none of that is carried over (blocks run in any order here, and a
// block has 227 KB).  Kept: what is computed, the first-match tie-break, the
// code, and what stays out of device memory -- the pre-pool conv output
// [B, Cout, H, W] and its cotangent, in both directions.  The tensors stay in
// the NCHW memory of the cuDNN layers around the block.
//
// What bounds it on the H100: operations.  At B=128, 48x129, 64 -> 96 the
// forward is 87.7 GFLOP (1.31 ms at 67 TFLOP/s of fp32 FMA) against 0.09 ms
// of bytes, and dx and dw are another 87.7 GFLOP each.  So the contraction is
// register-tiled on the CUDA cores and the inner loops hold little but FMAs:
//
// * forward and dx share one tile routine.  A block owns 2 output rows by 64
//   columns (32 pool windows, one per lane) and up to 96 output channels; a
//   warp is a group of NC (8 or 12) channels, so a thread owns a 2x2 window
//   x NC channels.  Per chunk of 8 input channels the block stages a
//   zero-padded 4 x 66 halo tile per channel and the [8, 9, channels] weight
//   slab in shared memory; per input channel a thread reads its 4x4 patch
//   (8 conflict-free 8-byte loads) and 9 * NC weights (16-byte broadcast
//   loads) for 36 * NC FMAs.
// * dx is that routine run on d with flipped taps, so every block owns a
//   tile of dx (a gather): no scatter, no atomics, and rows or columns past
//   the pooled region (odd H or W) still receive their neighbours' share.
//   The d halo tile is built in shared memory from (g, code, out).
// * dw: a thread owns dw[9 taps, 1 input channel, 8 output channels] (72
//   sums); a warp's lanes are 32 input channels, its warps 8-channel groups
//   of Cout.  Per step the block stages 2 conv rows x 32 columns of x (with
//   halo) and of d; a thread slides a 3x3 window of its channel's x along a
//   row (3 new loads a pixel) against 8 broadcast d values: 72 FMAs for 5
//   loads.  Each block takes a fixed share of the B * H/2 * W/32 steps and
//   writes one row of partials; one torch.sum finishes it.
// * bf16 inputs: x, wk and alpha hold bf16 values (products of two are exact
//   in f32), sums are f32, corr and d stay f32.
//
// dalpha is the true sum of conv * g over negative selected elements.  With
// alpha != 0 the conv value is out / alpha; at alpha == 0 exactly (out is 0
// there) the small kernel recomputes the selected conv value, so a zero
// slope still receives its gradient (the TPU kernel returns 0 there).
//
// No atomics anywhere; every sum has a fixed order, so all outputs are
// bit-for-bit reproducible.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/fused_conv2_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileWindows = 32;                // pool windows (lanes) per tile
constexpr int kTileW = 2 * kTileWindows + 2;    // 66 columns with the halo
constexpr int kTileH = 4;                       // 2 rows with the halo
constexpr int kPlane = kTileH * kTileW;         // floats per staged channel
constexpr int kChunk = 8;                       // input channels per stage
constexpr int kMaxThreads = 256;

constexpr int kDwLanes = 32;                    // input channels per dw block
constexpr int kDwCo = 8;                        // output channels per thread
constexpr int kDwCols = 32;                     // conv columns per step
constexpr int kDwXW = kDwCols + 2;              // 34 with the halo
constexpr int kDwXPlane = 4 * kDwXW + 1;        // 137: odd, lanes on 32 banks
constexpr int kDwMaxThreads = 192;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// The cotangent that reaches the selected conv value of pooled element o:
// (g + gs + 2 * out * gq), and the PReLU factor of the selected element.
template <typename T>
__device__ __forceinline__ float cotangent(const T* __restrict__ g,
                                           const T* __restrict__ out,
                                           size_t o, float gsc, float gqc) {
  return to_float(g[o]) + gsc + 2.f * to_float(out[o]) * gqc;
}

// Stage the weight slab ws[kChunk][9][nt] of input channels [k0, k0 + 8) and
// output channels [n0, n0 + nt) from wk [kin, 9, nout]; zero past either end.
__device__ __forceinline__ void load_slab(const float* __restrict__ wk,
                                          float* ws, int k0, int kin, int n0,
                                          int nout, int nt) {
  for (int idx = threadIdx.x; idx < kChunk * 9 * nt; idx += blockDim.x) {
    const int kt = idx / nt, n = idx - kt * nt;  // kt = k * 9 + tap
    const int k = k0 + kt / 9;
    float v = 0.f;
    if (k < kin && n0 + n < nout)
      v = wk[(static_cast<size_t>(k0) * 9 + kt) * nout + n0 + n];
    ws[idx] = v;
  }
}

// One staged chunk: acc[a * 2 + b][n] += tile[k][a + dh][2 * lane + b + dw]
// * ws[k][dh * 3 + dw][cg * NC + n].
template <int NC>
__device__ __forceinline__ void accumulate_chunk(const float* ts,
                                                 const float* ws, int nt,
                                                 int lane, int cg,
                                                 float (&acc)[4][NC]) {
#pragma unroll 1
  for (int k = 0; k < kChunk; ++k) {
    float p[4][4];
    const float* tb = ts + k * kPlane + 2 * lane;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 lo = *reinterpret_cast<const float2*>(tb + r * kTileW);
      const float2 hi = *reinterpret_cast<const float2*>(tb + r * kTileW + 2);
      p[r][0] = lo.x;
      p[r][1] = lo.y;
      p[r][2] = hi.x;
      p[r][3] = hi.y;
    }
    const float* wb = ws + k * 9 * nt + cg * NC;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap - dh * 3;
      float wv[NC];
#pragma unroll
      for (int q = 0; q < NC / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(wb + tap * nt)[q];
        wv[4 * q] = v.x;
        wv[4 * q + 1] = v.y;
        wv[4 * q + 2] = v.z;
        wv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        acc[0][n] = fmaf(p[dh][dw], wv[n], acc[0][n]);
        acc[1][n] = fmaf(p[dh][dw + 1], wv[n], acc[1][n]);
        acc[2][n] = fmaf(p[dh + 1][dw], wv[n], acc[2][n]);
        acc[3][n] = fmaf(p[dh + 1][dw + 1], wv[n], acc[3][n]);
      }
    }
  }
}

struct TileOrigin {
  int b, i, j0;  // frame, output row pair, first output column pair
};

// blockIdx.x = (b * n_rows + i) * n_jt + jt
__device__ __forceinline__ TileOrigin tile_origin(int n_rows, int n_jt) {
  int blk = blockIdx.x;
  TileOrigin t;
  t.j0 = (blk % n_jt) * kTileWindows;
  blk /= n_jt;
  t.i = blk % n_rows;
  t.b = blk / n_rows;
  return t;
}

// Forward.  Grid: x = B * (H/2) * ceil((W/2) / 32) tiles, y = channel tiles
// of nt = (blockDim.x / 32) * NC output channels.  Dynamic shared memory: the
// x tile (kChunk * kPlane floats), then the weight slab (kChunk * 9 * nt).
template <typename T, int NC>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv2_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wk,
                       const float* __restrict__ corr,
                       const float* __restrict__ alpha_p, T* __restrict__ out,
                       unsigned char* __restrict__ code,
                       float* __restrict__ stat_partials, int cin, int cout,
                       int h, int w) {
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;
  float* ws = smem + kChunk * kPlane;
  const int h2 = h / 2, w2 = w / 2;
  const int n_jt = (w2 + kTileWindows - 1) / kTileWindows;
  const TileOrigin t = tile_origin(h2, n_jt);
  const int lane = threadIdx.x & 31, cg = threadIdx.x >> 5;
  const int nt = (blockDim.x >> 5) * NC;
  const int n0 = blockIdx.y * nt;
  const float alpha = alpha_p[0];

  float acc[4][NC];
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[ph][n] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += kChunk) {
    __syncthreads();
    // x rows 2i - 1 .. 2i + 2, columns 2 * j0 - 1 .. 2 * j0 + 64, zero padded
    for (int idx = threadIdx.x; idx < kChunk * kPlane; idx += blockDim.x) {
      const int k = idx / kPlane, rem = idx - k * kPlane;
      const int r = rem / kTileW, c = rem - r * kTileW;
      const int row = 2 * t.i - 1 + r, col = 2 * t.j0 - 1 + c;
      float v = 0.f;
      if (k0 + k < cin && row >= 0 && row < h && col >= 0 && col < w)
        v = to_float(
            x[((static_cast<size_t>(t.b) * cin + k0 + k) * h + row) * w + col]);
      ts[idx] = v;
    }
    load_slab(wk, ws, k0, cin, n0, cout, nt);
    __syncthreads();
    accumulate_chunk<NC>(ts, ws, nt, lane, cg, acc);
  }

  const int gj = t.j0 + lane;
  const bool live = gj < w2;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int co = n0 + cg * NC + n;
    float stats[2] = {0.f, 0.f};
    if (live && co < cout) {
      const float* cbase =
          corr + (static_cast<size_t>(co) * h + 2 * t.i) * w + 2 * gj;
      float best = 0.f, best_pre = 0.f;
      int best_ph = 0;
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        const float conv = acc[ph][n] + cbase[(ph >> 1) * w + (ph & 1)];
        const float act = conv >= 0.f ? conv : alpha * conv;
        // strict >: ties keep the first phase of (0,0),(0,1),(1,0),(1,1)
        if (ph == 0 || act > best) {
          best = act;
          best_pre = conv;
          best_ph = ph;
        }
      }
      const size_t o =
          ((static_cast<size_t>(t.b) * cout + co) * h2 + t.i) * w2 + gj;
      T stored;
      from_float(best, &stored);
      out[o] = stored;
      if (code != nullptr)
        code[o] = static_cast<unsigned char>(best_ph | ((best_pre < 0.f) << 2));
      const float rounded = to_float(stored);  // what a later pass would read
      stats[0] = rounded;
      stats[1] = rounded * rounded;
    }
    if (stat_partials != nullptr) {  // uniform over the block
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        stats[0] += __shfl_down_sync(0xffffffffu, stats[0], off);
        stats[1] += __shfl_down_sync(0xffffffffu, stats[1], off);
      }
      if (lane == 0 && co < cout) {
        float* dst = stat_partials + static_cast<size_t>(blockIdx.x) * 2 * cout;
        dst[co] = stats[0];
        dst[cout + co] = stats[1];
      }
    }
  }
}

// dx = transposed convolution of d.  Grid: x = B * ceil(H/2) * ceil(ceil(W/2)
// / 32) tiles of dx, y = tiles of nt input channels.  wk is the flipped,
// transposed kernel [Cout, 9, Cin].  Shared memory as in the forward, the
// staged tile holding d instead of x.
template <typename T, int NC>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv2_dx_kernel(const float* __restrict__ wk,
                      const float* __restrict__ alpha_p,
                      const T* __restrict__ g, const T* __restrict__ out,
                      const unsigned char* __restrict__ code,
                      const float* __restrict__ gs,
                      const float* __restrict__ gq, T* __restrict__ dx,
                      int cin, int cout, int h, int w) {
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;
  float* ws = smem + kChunk * kPlane;
  const int h2 = h / 2, w2 = w / 2;
  const int hp = (h + 1) / 2, wp = (w + 1) / 2;  // row / column pairs of dx
  const int n_jt = (wp + kTileWindows - 1) / kTileWindows;
  const TileOrigin t = tile_origin(hp, n_jt);
  const int lane = threadIdx.x & 31, cg = threadIdx.x >> 5;
  const int nt = (blockDim.x >> 5) * NC;
  const int n0 = blockIdx.y * nt;
  const float alpha = alpha_p[0];

  float acc[4][NC];
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[ph][n] = 0.f;

  for (int k0 = 0; k0 < cout; k0 += kChunk) {
    __syncthreads();
    // d rows 2i - 1 .. 2i + 2, columns 2 * j0 - 1 .. 2 * j0 + 64: the
    // selected position of each pool window holds scale * cotangent, every
    // other position (and everything past the pooled region) is zero
    for (int idx = threadIdx.x; idx < kChunk * kPlane; idx += blockDim.x) {
      const int k = idx / kPlane, rem = idx - k * kPlane;
      const int r = rem / kTileW, c = rem - r * kTileW;
      const int row = 2 * t.i - 1 + r, col = 2 * t.j0 - 1 + c;
      const int co = k0 + k;
      float v = 0.f;
      if (co < cout && row >= 0 && row < 2 * h2 && col >= 0 && col < 2 * w2) {
        const size_t o =
            ((static_cast<size_t>(t.b) * cout + co) * h2 + (row >> 1)) * w2 +
            (col >> 1);
        const int cd = code[o];
        if ((cd & 3) == ((row & 1) * 2 + (col & 1))) {
          const float gt = cotangent(g, out, o, gs != nullptr ? gs[co] : 0.f,
                                     gq != nullptr ? gq[co] : 0.f);
          v = cd >= 4 ? alpha * gt : gt;
        }
      }
      ts[idx] = v;
    }
    load_slab(wk, ws, k0, cout, n0, cin, nt);
    __syncthreads();
    accumulate_chunk<NC>(ts, ws, nt, lane, cg, acc);
  }

  const int gj = t.j0 + lane;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int ci = n0 + cg * NC + n;
    if (ci >= cin) continue;
    T* plane = dx + (static_cast<size_t>(t.b) * cin + ci) * h * w;
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      const int row = 2 * t.i + (ph >> 1), col = 2 * gj + (ph & 1);
      if (row < h && col < w)
        from_float(acc[ph][n], plane + static_cast<size_t>(row) * w + col);
    }
  }
}

// dw.  Grid: x = ceil(Cin / 32) * ceil(Cout / nco) tiles of dw (nco =
// (blockDim.x / 32) * 8), y = splits of the B * (H/2) * ceil((W/2) / 16)
// steps.  Dynamic shared memory: the x tile (32 * kDwXPlane floats), then d
// as [2 * 32 pixels][ds_stride], ds_stride = nco + 4.
template <typename T>
__global__ void __launch_bounds__(kDwMaxThreads)
fused_conv2_dw_kernel(const T* __restrict__ x,
                      const float* __restrict__ alpha_p,
                      const T* __restrict__ g, const T* __restrict__ out,
                      const unsigned char* __restrict__ code,
                      const float* __restrict__ gs,
                      const float* __restrict__ gq,
                      float* __restrict__ partials, int bsz, int cin, int cout,
                      int h, int w) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ds = smem + kDwLanes * kDwXPlane;
  const int h2 = h / 2, w2 = w / 2;
  const int lane = threadIdx.x & 31, cog = threadIdx.x >> 5;
  const int nco = (blockDim.x >> 5) * kDwCo;
  const int ds_stride = nco + 4;
  const int n_cot = (cout + nco - 1) / nco;
  const int ci0 = (blockIdx.x / n_cot) * kDwLanes;
  const int co0 = (blockIdx.x % n_cot) * nco;
  const int n_jt = (w2 + kDwCols / 2 - 1) / (kDwCols / 2);
  const int steps = bsz * h2 * n_jt;
  const float alpha = alpha_p[0];

  float acc[9][kDwCo];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int n = 0; n < kDwCo; ++n) acc[tap][n] = 0.f;

  for (int s = blockIdx.y; s < steps; s += gridDim.y) {
    const int jt = s % n_jt;
    const int i = (s / n_jt) % h2;
    const int b = s / (n_jt * h2);
    const int j0 = jt * (kDwCols / 2);
    __syncthreads();
    // x rows 2i - 1 .. 2i + 2, columns 2 * j0 - 1 .. 2 * j0 + 32
    for (int idx = threadIdx.x; idx < kDwLanes * 4 * kDwXW; idx += blockDim.x) {
      const int cl = idx / (4 * kDwXW), rem = idx - cl * (4 * kDwXW);
      const int r = rem / kDwXW, c = rem - r * kDwXW;
      const int row = 2 * i - 1 + r, col = 2 * j0 - 1 + c;
      float v = 0.f;
      if (ci0 + cl < cin && row >= 0 && row < h && col >= 0 && col < w)
        v = to_float(
            x[((static_cast<size_t>(b) * cin + ci0 + cl) * h + row) * w + col]);
      xs[cl * kDwXPlane + rem] = v;
    }
    // d of conv rows 2i, 2i + 1 and columns 2 * j0 .. 2 * j0 + 31
    for (int idx = threadIdx.x; idx < nco * (kDwCols / 2); idx += blockDim.x) {
      const int cl = idx / (kDwCols / 2), jl = idx - cl * (kDwCols / 2);
      const int co = co0 + cl, gj = j0 + jl;
      int sel = -1;
      float d = 0.f;
      if (co < cout && gj < w2) {
        const size_t o =
            ((static_cast<size_t>(b) * cout + co) * h2 + i) * w2 + gj;
        const int cd = code[o];
        const float gt = cotangent(g, out, o, gs != nullptr ? gs[co] : 0.f,
                                   gq != nullptr ? gq[co] : 0.f);
        sel = cd & 3;
        d = cd >= 4 ? alpha * gt : gt;
      }
#pragma unroll
      for (int ph = 0; ph < 4; ++ph)
        ds[((ph >> 1) * kDwCols + 2 * jl + (ph & 1)) * ds_stride + cl] =
            ph == sel ? d : 0.f;
    }
    __syncthreads();

    const float* xl = xs + lane * kDwXPlane;
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {
      float x0[3], x1[3], x2[3];
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        x0[dh] = xl[(r + dh) * kDwXW];
        x1[dh] = xl[(r + dh) * kDwXW + 1];
      }
      const float* dr = ds + r * kDwCols * ds_stride + cog * kDwCo;
#pragma unroll 8
      for (int c = 0; c < kDwCols; ++c) {
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) x2[dh] = xl[(r + dh) * kDwXW + c + 2];
        const float4 lo = reinterpret_cast<const float4*>(dr + c * ds_stride)[0];
        const float4 hi = reinterpret_cast<const float4*>(dr + c * ds_stride)[1];
        const float dv[kDwCo] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int n = 0; n < kDwCo; ++n) {
            acc[dh * 3][n] = fmaf(x0[dh], dv[n], acc[dh * 3][n]);
            acc[dh * 3 + 1][n] = fmaf(x1[dh], dv[n], acc[dh * 3 + 1][n]);
            acc[dh * 3 + 2][n] = fmaf(x2[dh], dv[n], acc[dh * 3 + 2][n]);
          }
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          x0[dh] = x1[dh];
          x1[dh] = x2[dh];
        }
      }
    }
  }

  const int ci = ci0 + lane;
  if (ci < cin) {
    float* dst = partials + static_cast<size_t>(blockIdx.y) * 9 * cin * cout;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int n = 0; n < kDwCo; ++n) {
        const int co = co0 + cog * kDwCo + n;
        if (co < cout)
          dst[(static_cast<size_t>(tap) * cin + ci) * cout + co] = acc[tap][n];
      }
  }
}

// The conv value at (b, co, row, col), recomputed from x, wk [Cin, 9, Cout]
// and corr: only for dalpha at alpha == 0.
template <typename T>
__device__ float conv_at(const T* __restrict__ x, const float* __restrict__ wk,
                         const float* __restrict__ corr, int b, int co,
                         int row, int col, int cin, int cout, int h, int w) {
  float conv = corr[(static_cast<size_t>(co) * h + row) * w + col];
  for (int ci = 0; ci < cin; ++ci) {
    const T* plane = x + (static_cast<size_t>(b) * cin + ci) * h * w;
    for (int tap = 0; tap < 9; ++tap) {
      const int r = row + tap / 3 - 1, c = col + tap % 3 - 1;
      if (r >= 0 && r < h && c >= 0 && c < w)
        conv = fmaf(to_float(plane[static_cast<size_t>(r) * w + c]),
                    wk[(static_cast<size_t>(ci) * 9 + tap) * cout + co], conv);
    }
  }
  return conv;
}

// dcorr and dalpha.  One thread per pooled position (co, i, j), looping over
// the batch in order; dcorr (zeroed by the caller past the pooled region)
// receives the thread's 2x2 window.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv2_small_kernel(const T* __restrict__ x, const float* __restrict__ wk,
                         const float* __restrict__ corr,
                         const float* __restrict__ alpha_p,
                         const T* __restrict__ g, const T* __restrict__ out,
                         const unsigned char* __restrict__ code,
                         const float* __restrict__ gs,
                         const float* __restrict__ gq,
                         float* __restrict__ dcorr,
                         float* __restrict__ dalpha_partials, int bsz, int cin,
                         int cout, int h, int w) {
  __shared__ float red[kMaxThreads / 32];
  const int h2 = h / 2, w2 = w / 2;
  const float alpha = alpha_p[0];
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float da = 0.f;
  if (tid < static_cast<long long>(cout) * h2 * w2) {
    const int j = static_cast<int>(tid % w2);
    const int i = static_cast<int>((tid / w2) % h2);
    const int co = static_cast<int>(tid / (static_cast<long long>(w2) * h2));
    const float gsc = gs != nullptr ? gs[co] : 0.f;
    const float gqc = gq != nullptr ? gq[co] : 0.f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int b = 0; b < bsz; ++b) {
      const size_t o = ((static_cast<size_t>(b) * cout + co) * h2 + i) * w2 + j;
      const int cd = code[o];
      const int sel = cd & 3;
      const float gt = cotangent(g, out, o, gsc, gqc);
      const float d = cd >= 4 ? alpha * gt : gt;
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) acc[ph] += ph == sel ? d : 0.f;
      if (cd >= 4) {
        const float pre =
            alpha != 0.f
                ? to_float(out[o]) / alpha
                : conv_at(x, wk, corr, b, co, 2 * i + (sel >> 1),
                          2 * j + (sel & 1), cin, cout, h, w);
        da = fmaf(pre, gt, da);
      }
    }
    float* dst = dcorr + (static_cast<size_t>(co) * h + 2 * i) * w + 2 * j;
    dst[0] = acc[0];
    dst[1] = acc[1];
    dst[w] = acc[2];
    dst[w + 1] = acc[3];
  }
  // fixed-order block sum of da
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    da += __shfl_down_sync(0xffffffffu, da, off);
  if (lane == 0) red[warp] = da;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int k = 0; k < (blockDim.x >> 5); ++k) total += red[k];
    dalpha_partials[blockIdx.x] = total;
  }
}

template <typename T, int NC>
cudaError_t launch_fwd(const void* x, const float* wk, const float* corr,
                       const float* alpha, void* out, unsigned char* code,
                       float* stat_partials, int cin, int cout, int h, int w,
                       dim3 grid, int threads, int smem, cudaStream_t s) {
  fused_conv2_fwd_kernel<T, NC><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), wk, corr, alpha, static_cast<T*>(out), code,
      stat_partials, cin, cout, h, w);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dx(const float* wk, const float* alpha, const void* g,
                      const void* out, const unsigned char* code,
                      const float* gs, const float* gq, void* dx, int cin,
                      int cout, int h, int w, dim3 grid, int threads, int smem,
                      cudaStream_t s) {
  fused_conv2_dx_kernel<T, NC><<<grid, threads, smem, s>>>(
      wk, alpha, static_cast<const T*>(g), static_cast<const T*>(out), code, gs,
      gq, static_cast<T*>(dx), cin, cout, h, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw_small(const void* x, const float* wk, const float* corr,
                            const float* alpha, const void* g, const void* out,
                            const unsigned char* code, const float* gs,
                            const float* gq, float* dw_partials, float* dcorr,
                            float* dalpha_partials, int bsz, int cin, int cout,
                            int h, int w, dim3 dw_grid, int dw_threads,
                            int dw_smem, int small_blocks, cudaStream_t s) {
  fused_conv2_dw_kernel<T><<<dw_grid, dw_threads, dw_smem, s>>>(
      static_cast<const T*>(x), alpha, static_cast<const T*>(g),
      static_cast<const T*>(out), code, gs, gq, dw_partials, bsz, cin, cout, h,
      w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_conv2_small_kernel<T><<<small_blocks, kMaxThreads, 0, s>>>(
      static_cast<const T*>(x), wk, corr, alpha, static_cast<const T*>(g),
      static_cast<const T*>(out), code, gs, gq, dcorr, dalpha_partials, bsz,
      cin, cout, h, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every launcher returns the cudaError_t of its launches (0 on success).
// nc is the number of channels a thread owns in the tile routine: 8 or 12.

int fused_conv2_fwd_launch(const void* x, const void* wk, const void* corr,
                           const void* alpha, void* out, void* code,
                           void* stat_partials, int cin, int cout, int h, int w,
                           int is_bf16, int nc, int grid_x, int grid_y,
                           int threads, int smem_bytes, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  const float* wf = static_cast<const float*>(wk);
  const float* cf = static_cast<const float*>(corr);
  const float* af = static_cast<const float*>(alpha);
  unsigned char* cd = static_cast<unsigned char*>(code);
  float* sp = static_cast<float*>(stat_partials);
  if (is_bf16) {
    err = nc == 12 ? launch_fwd<__nv_bfloat16, 12>(x, wf, cf, af, out, cd, sp,
                                                   cin, cout, h, w, grid,
                                                   threads, smem_bytes, s)
                   : launch_fwd<__nv_bfloat16, 8>(x, wf, cf, af, out, cd, sp,
                                                  cin, cout, h, w, grid,
                                                  threads, smem_bytes, s);
  } else {
    err = nc == 12 ? launch_fwd<float, 12>(x, wf, cf, af, out, cd, sp, cin,
                                           cout, h, w, grid, threads,
                                           smem_bytes, s)
                   : launch_fwd<float, 8>(x, wf, cf, af, out, cd, sp, cin, cout,
                                          h, w, grid, threads, smem_bytes, s);
  }
  return static_cast<int>(err);
}

int fused_conv2_dx_launch(const void* wk_flipped, const void* alpha,
                          const void* g, const void* out, const void* code,
                          const void* gs, const void* gq, void* dx, int cin,
                          int cout, int h, int w, int is_bf16, int nc,
                          int grid_x, int grid_y, int threads, int smem_bytes,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  const float* wf = static_cast<const float*>(wk_flipped);
  const float* af = static_cast<const float*>(alpha);
  const unsigned char* cd = static_cast<const unsigned char*>(code);
  const float* gsf = static_cast<const float*>(gs);
  const float* gqf = static_cast<const float*>(gq);
  if (is_bf16) {
    err = nc == 12 ? launch_dx<__nv_bfloat16, 12>(wf, af, g, out, cd, gsf, gqf,
                                                  dx, cin, cout, h, w, grid,
                                                  threads, smem_bytes, s)
                   : launch_dx<__nv_bfloat16, 8>(wf, af, g, out, cd, gsf, gqf,
                                                 dx, cin, cout, h, w, grid,
                                                 threads, smem_bytes, s);
  } else {
    err = nc == 12 ? launch_dx<float, 12>(wf, af, g, out, cd, gsf, gqf, dx, cin,
                                          cout, h, w, grid, threads,
                                          smem_bytes, s)
                   : launch_dx<float, 8>(wf, af, g, out, cd, gsf, gqf, dx, cin,
                                         cout, h, w, grid, threads, smem_bytes,
                                         s);
  }
  return static_cast<int>(err);
}

int fused_conv2_dw_small_launch(const void* x, const void* wk, const void* corr,
                                const void* alpha, const void* g,
                                const void* out, const void* code,
                                const void* gs, const void* gq,
                                void* dw_partials, void* dcorr,
                                void* dalpha_partials, int bsz, int cin,
                                int cout, int h, int w, int is_bf16,
                                int dw_grid_x, int dw_grid_y, int dw_threads,
                                int dw_smem_bytes, int small_blocks, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(dw_grid_x, dw_grid_y);
  const float* wf = static_cast<const float*>(wk);
  const float* cf = static_cast<const float*>(corr);
  const float* af = static_cast<const float*>(alpha);
  const unsigned char* cd = static_cast<const unsigned char*>(code);
  const float* gsf = static_cast<const float*>(gs);
  const float* gqf = static_cast<const float*>(gq);
  float* dwp = static_cast<float*>(dw_partials);
  float* dc = static_cast<float*>(dcorr);
  float* dap = static_cast<float*>(dalpha_partials);
  if (is_bf16) {
    err = launch_dw_small<__nv_bfloat16>(x, wf, cf, af, g, out, cd, gsf, gqf,
                                         dwp, dc, dap, bsz, cin, cout, h, w,
                                         grid, dw_threads, dw_smem_bytes,
                                         small_blocks, s);
  } else {
    err = launch_dw_small<float>(x, wf, cf, af, g, out, cd, gsf, gqf, dwp, dc,
                                 dap, bsz, cin, cout, h, w, grid, dw_threads,
                                 dw_smem_bytes, small_blocks, s);
  }
  return static_cast<int>(err);
}

const char* fused_conv2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
