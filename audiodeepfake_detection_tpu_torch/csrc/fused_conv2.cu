// The DCNN's second pool block in one pass: conv2d(Cin -> Cout, 3x3, zero
// pad 1) with BatchNorm-folded weights + an additive map -> PReLU (one slope)
// -> floor-mode 2x2 max-pool, forward and backward, on NCHW memory.
//
//   x [B, Cin, H, W] (f32 or bf16), weights (re-arranged on the host, see
//   ops/fused_conv2_cuda.py), corr [Cout, H, W], alpha [1] (f32)
//   ->  out [B, Cout, H/2, W/2] (x's type)
//   training forward also: a selection code per output element (pool phase
//     dh*2+dw of the FIRST maximum | "selected conv value < 0" << 2, one
//     byte) and per-block partial per-channel (sum, sumsq) of the rounded
//     stored output;
//   backward, three kernels:
//     dx    [B, Cin, H, W]: the transposed convolution of the conv-output
//           cotangent d, rebuilt tile by tile from (g, code, out);
//     dw    partials [splits, 9 * Cin, Cout]: im2col(x)^T . d, split over
//           B * H * W;
//     small dcorr [Cout, H, W] (the sum of d over the batch) and per-block
//           partials of dalpha.
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/fused_conv2.py::
// _fwd_kernel and ::_bwd_kernel (reached through fused_conv2_prelu_pool and
// fused_conv2_prelu_pool_stats).  Those hold a whole padded NHWC image per
// grid cell, build an im2col patch [W, 9*Cin] per conv row for one matrix-
// unit product (jax.lax.dot_general), keep a whole-image dx accumulator that
// persists across the sequential grid, and accumulate dw / dcorr / dalpha
// into whole-array output blocks; none of that is carried over (blocks run
// in any order here, and a block has 227 KB).  Kept: what is computed, the
// first-match tie-break, the code, and what stays out of device memory --
// the pre-pool conv output [B, Cout, H, W] and its cotangent, in both
// directions.  The tensors stay in the NCHW memory of the cuDNN layers
// around the block.
//
// What bounds it on the H100: operations.  At B=128, 48x129, 64 -> 96 the
// forward is 87.7 GFLOP (1.31 ms of fp32 FMA at 67 TFLOP/s, 0.089 ms of bf16
// tensor-core work at 989 TFLOP/s) against 0.09 ms of bytes.  The backward
// needs 43.5 GFLOP (the cotangent is zero at three of a window's four
// positions), but that zero moves per channel, so dx and dw run dense
// products, 87.7 GFLOP each, on the tensor cores.  Two routes, by x's type:
//
// float32 (parity mode, the CLIs):
// * backward, dx and dw: implicit GEMMs on mma.sync m16n8k8 (TF32 in, fp32
//   sums), the counterpart of the TPU kernel's matrix-unit dot_general.
//   fp32 accuracy from split TF32: each fp32 operand a becomes big =
//   cvt.rna.tf32(a) and small = cvt.rna.tf32(a - big), so a = big + small
//   to 2^-22 relative, and a product is small*big + big*small + big*big
//   (small terms first; small*small, 2^-22, is dropped).  Per product the
//   error is ~2^-22 relative, 3-4 orders under the 1e-3 the gradients are
//   held to; one TF32 pass would give ~2^-11, which parity mode refuses.
//   The tensor core's own sum truncates toward zero (see mma3_add), so a
//   long chain of MMAs into one accumulator drifts: dw, ~4500 MMAs a block,
//   sums each k-step from zero and adds it in fp32 (6.3e-7 of the largest
//   entry against float64, chip_smoke.py phase 14, H100); dx keeps its chain
//   of 324 (5.7e-6), as a sum from zero spills at its 128 registers.  One
//   TF32 pass reads 3e-4 on the same inputs.  Dense 3xTF32 is 526 GFLOP
//   (1.06 ms at 495 TFLOP/s), beside the 43.5 GFLOP least-work bound.
//   - dx: rows are a block's 8 x 32 pixels, columns 64 input channels, K is
//     (8-channel chunk of Cout, tap); a warp owns 2 pixel rows x 32 channels
//     (4 x 4 tiles).  A is d, rebuilt per chunk in shared memory from
//     (g, code, out) as whole 2x2 windows over a 12 x 36 ring around the
//     10 x 34 halo (so the conv-output cotangent never reaches device
//     memory, and no window needs a mask), stored split; B the flipped
//     weights [Cout, 9, Cin], split as read.  Every block owns a tile of dx:
//     no scatter, no atomics, and rows or columns past the pooled region
//     (odd H or W) still receive their neighbours' share.
//   - dw: 12 warps, 3 tap rows x 4 quarters of 96 output channels; rows are
//     (tap, 32 input channels), K is the 64 pixels of a step (one pooled
//     row, 16 pooled columns).  A is the x halo tile shifted by the tap,
//     split as read, B the d tile, stored split.  Each block takes a fixed
//     share of the steps and writes one row of partials; one torch.sum
//     finishes them.
//   - Staging: a ring of two stages.  The weight slabs (16-byte cp.async;
//     the host pads them to whole chunks) and x (4-byte cp.async: rows of an
//     odd W are not 16-byte aligned; zero-filled past the image) of the next
//     stage are in flight while the current one runs its MMAs.  d's raw
//     (g, out, code) are loaded into registers before the MMAs, from valid
//     addresses whatever their liveness (a select on a load would wait on
//     it), and written as d after them (a one-byte code cannot be copied
//     asynchronously).
//   - Products go pass-major (all small*big of a group of tiles, then
//     big*small, then big*big), so that consecutive MMAs feed different
//     accumulators; each accumulator sees the same order.
//   - Layout: every fragment load hits 32 distinct banks.  Channel planes
//     and rows are padded so that the lanes' stride is 8 or 24 (mod 32)
//     across the 4 k-lanes and 1 across the 8 row-lanes (dx's d ring, its
//     weight slab), or 12 and 1 (dw's x tile), or 4 and 1 (dw's d tile).
// * forward: on the FMA pipe, with the FMA sequence of every output that
//   the kernel had before the tensor-core backward: k ascending, then taps
//   0..8, then + corr in the epilogue -- the order cuDNN's implicit GEMM
//   also takes, so the forward reads 0.0 against F.conv2d.  A reordered (or
//   tensor-core) forward would differ by ~1e-7 and flip the max-pool's
//   choice in the few windows whose two best values lie that close, each
//   flip moving ~0.1 of gradient, far past what parity mode holds the
//   gradients to.  A block owns 2 output rows by 64 columns (32 pool
//   windows, one per lane) and up to 96 output channels; a warp is a group
//   of NC (8 or 12) channels, so a thread owns a 2x2 window x NC channels.
//   Per chunk of 8 input channels the x halo tile (4 x 66 per channel) and
//   the [8, 9, channels] weight slab stream through the two-stage cp.async
//   ring; per input channel a thread reads its 4x4 patch (8 conflict-free
//   8-byte loads) and 9 * NC weights (16-byte broadcast loads) for 36 * NC
//   FMAs.  Staging is mapped row by row (warp -> row, lane -> column).
//
// bfloat16 (the speed mode): the JAX kernel's arithmetic -- bf16 products
// summed in fp32 by the matrix unit, + corr in fp32, and in the backward the
// conv-output cotangent d rounded to bf16 once (d_row.astype(bf16)) before
// both products (dcorr and dalpha keep it fp32).  There the block is held to
// a bf16 tolerance, not to bits, so no summation order is kept, and all
// three GEMMs run mma.sync m16n8k16 (bf16 in, fp32 sums): one pass where
// split TF32 takes two or three.  Operands sit in shared memory as bf16,
// channels innermost where ldmatrix reads a fragment at a pixel shift, each
// staged position padded to an odd number of 16-byte slots (48 or 80 B), so
// that the 8 rows of every ldmatrix phase hit 8 different slots.  Global x,
// g and out are NCHW, so the stages transpose: values are loaded into
// registers before the current stage's MMAs (a warp along a run of one
// row, two channels a thread) and stored, a channel pair a 32-bit word,
// after them, half of a thread's slots at a time (each half's loads overlap
// about half the taps, and half the registers stay live); the weights, laid
// out on the host in B-fragment order, stream by 16-byte cp.async.  Two
// stages, as the fp32 route.  What bounds it on the card: operations at 989
// TFLOP/s, which mma.sync does not reach (that needs wgmma); per k16 step a
// warp reads ~20 bytes of shared memory per 1 KFLOP of MMA, so the tiles
// are sized to reuse each fragment 2-6 times.  Beside the MMAs, a CTA's time
// goes to staging the next chunk and to the epilogue; staging x instead by
// 4-byte cp.async of its raw rows with a shared-memory transpose, and
// staging the epilogue's corr reads and output stores through shared
// memory, each ran slower on the card and are not used.
// * forward: an implicit GEMM, M = the 2 x 64 conv pixels of one pooled
//   row's 32 windows, N = 16 * nf output channels (nf = 2, 4, 6, 8: N tiles
//   of 32-128 shaped to Cout, 96 at the headline), K = 9 taps x 16-channel
//   chunks.  Warps 4 (M) x 2 (N); an m16 tile is one conv row, its rows
//   ordered so that rows q and q + 8 are a window's two columns: a
//   thread's C fragments then hold all four conv values of its windows, and
//   the epilogue runs in registers (all its corr values loaded first, then
//   + corr in fp32, PReLU with the fp32 value of the bf16 slope, the
//   first-match max, the code byte, the bf16 store, the moments of the
//   rounded output by shuffles and a fixed-order sum over the four M warps
//   into per-block partials).  The halo (4 rows x
//   66 columns) is stored by column parity, so the 8 rows of an ldmatrix
//   phase (every other column) are consecutive positions.
// * dx: the fp32 route's tiling (8 x 32 pixels x 64 input channels, warps
//   2 rows x 32 channels), K = (16-channel chunk of Cout, flipped tap); the
//   d ring of 12 x 36 positions rebuilt per chunk from (g, code, out),
//   rounded to bf16, a channel pair a word.
// * dw: rows (tap, input channel), columns output channels, K the 64 pixels
//   of a step in four k16 steps; 12 warps: tap row x 16 input channels x 48
//   output channels.  A is the x tile read transposed (ldmatrix .trans) at
//   the tap's shift, B the d tile ([channel][pixel]); each k16 step is
//   summed from zero and added in fp32, and the per-block partials are
//   summed in a fixed order by one torch.sum.
//
// dalpha is the true sum of conv * g over negative selected elements.  With
// alpha != 0 the conv value is out / alpha; at alpha == 0 exactly (out is 0
// there) the small kernel recomputes the selected conv value, so a zero
// slope still receives its gradient (the TPU kernel returns 0 there).  That
// recomputation sums on the FMA pipe in the fp32 forward's order: for bf16
// x it may differ from the tensor-core forward's value by a rounding.
//
// No atomics anywhere; every sum has a fixed order, so all outputs are
// bit-for-bit reproducible in both routes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/fused_conv2_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 8;                       // channels of K per stage

// forward
constexpr int kTileWindows = 32;                // pool windows (lanes) per tile
constexpr int kTileW = 2 * kTileWindows + 2;    // 66 columns with the halo
constexpr int kTileH = 4;                       // 2 rows with the halo
constexpr int kPlane = kTileH * kTileW;         // floats per staged channel
constexpr int kMaxThreads = 256;

// dx
constexpr int kDxRows = 8, kDxCols = 32;        // dx pixels per block
constexpr int kDxRingW = kDxCols + 4;           // 36: d columns col0 - 2 ..
constexpr int kDxPlane = 440;                   // >= 12 * 36; 24 mod 32
constexpr int kDxCi = 64;                       // input channels per block
constexpr int kDxWRow = 9 * kDxCi + 8;          // 584 floats; 8 mod 32
constexpr int kDxStage = kChunk * (2 * kDxPlane + kDxWRow);
constexpr int kDxThreads = 256;                 // 4 row pairs x 2 channel halves
constexpr int kDxPooledW = kDxCols / 2 + 2;     // 18 pooled columns per row
constexpr int kDxPooled = (kDxRows / 2 + 2) * kDxPooledW;  // 108 a channel
constexpr int kDxSlots = (kDxPooled + 31) / 32;

// dw
constexpr int kDwCi = 32;                       // input channels per block
constexpr int kDwCo = 96;                       // output channels per block
constexpr int kDwWindows = 16;                  // pool windows per step
constexpr int kDwPix = 4 * kDwWindows;          // 64 pixels (K) per step
constexpr int kDwXW = 2 * kDwWindows + 2;       // 34 columns with the halo
constexpr int kDwXPlane = 140;                  // >= 4 * 34; 12 mod 32
constexpr int kDwDRow = kDwPix + 4;             // 68; 4 mod 32
constexpr int kDwStage = kDwCi * kDwXPlane + 2 * kDwCo * kDwDRow;
constexpr int kDwThreads = 12 * 32;             // 3 tap rows x 4 channel quarters
constexpr int kDwSlots = (kDwCo * kDwWindows + kDwThreads - 1) / kDwThreads;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
// 4 bytes, or zeros when !pred (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n floats (a multiple of 4, 16-byte aligned at both ends) as 16-byte copies.
__device__ __forceinline__ void stage_flat(float* dst, const float* src, int n) {
  for (int q = threadIdx.x; q < n / 4; q += blockDim.x)
    cp_async16(dst + 4 * q, src + 4 * q);
}

// -------------------------------------------------------- split-TF32 MMA

__device__ __forceinline__ unsigned tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = big + small to ~2^-22 relative
__device__ __forceinline__ void split(float v, unsigned& big, unsigned& small) {
  big = tf32(v);
  small = tf32(v - __uint_as_float(big));
}
// c += a . b, m16n8k8, TF32 in, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A fragment of N registers, split into big and small TF32 parts.
template <int N>
struct Frag {
  unsigned big[N], small[N];
};
template <int N>
__device__ __forceinline__ void make_frag(Frag<N>& f, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(v[i], f.big[i], f.small[i]);
}

// c[m][n] += a[m] . b[n] to fp32 accuracy for M x N tiles: small*big,
// big*small, big*big, small terms first.  Pass-major, so that consecutive
// MMAs go to different accumulators; every accumulator sees the same three
// products in the same order.
template <int M, int N>
__device__ __forceinline__ void mma3(float (&c)[M][N][4], const Frag<4> (&a)[M],
                                     const Frag<2> (&b)[N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma_tf32(c[m][n], a[m].small[0], a[m].small[1], a[m].small[2], a[m].small[3],
               b[n].big[0], b[n].big[1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma_tf32(c[m][n], a[m].big[0], a[m].big[1], a[m].big[2], a[m].big[3],
               b[n].small[0], b[n].small[1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma_tf32(c[m][n], a[m].big[0], a[m].big[1], a[m].big[2], a[m].big[3],
               b[n].big[0], b[n].big[1]);
}

// The same product summed from zero, m tile by m tile, then added to c by an
// ordinary fp32 add.  The tensor core's sum truncates (it aligns the addends
// and drops the low bits of the smaller, toward zero), so an accumulator fed
// by one long chain of MMAs drifts toward zero a little every step: over a
// dw block's ~4500 MMAs (186 steps of 8 k-steps, three products each) dw
// read 7.8e-5 of its largest entry where cuDNN's fp32 reads 4e-7.  From zero
// the truncation is relative to one k-step's product, whose sign varies,
// and the long sum rounds to nearest.
template <int M, int N>
__device__ __forceinline__ void mma3_add(float (&c)[M][N][4], const Frag<4> (&a)[M],
                                         const Frag<2> (&b)[N]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float t[1][N][4] = {};
    const Frag<4> am[1] = {a[m]};
    mma3(t, am, b);
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) c[m][n][k] += t[0][n][k];
  }
}

// The cotangent that reaches the selected conv value of a pooled element
// from its output's (g) and the moments' (gs, gq on the channel).
__device__ __forceinline__ float cotangent(float g, float out, float gsc, float gqc) {
  return g + gsc + 2.f * out * gqc;
}

// ------------------------------------------------------------------ forward

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

// Stage chunk k0 of the forward: x rows 2i - 1 .. 2i + 2, columns 2 * j0 - 1
// .. 2 * j0 + 64 (zero padded), row rr = k * 4 + r of the tile to warp
// rr mod warps, column c to lane c mod 32; and the chunk's weight slab,
// contiguous in the host's [tiles][Cin_pad][9][nt] layout.
__device__ __forceinline__ void fwd_stage(float* ts, float* ws,
                                          const float* __restrict__ x,
                                          const float* __restrict__ slab,
                                          const TileOrigin& t, int k0, int cin,
                                          int h, int w, int nt) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int rr = threadIdx.x >> 5; rr < kChunk * kTileH; rr += warps) {
    const int k = rr >> 2, row = 2 * t.i - 1 + (rr & 3);
    const bool row_ok = k0 + k < cin && row >= 0 && row < h;
    const float* src = x + ((static_cast<size_t>(t.b) * cin + (row_ok ? k0 + k : 0)) * h +
                            (row_ok ? row : 0)) * w;
    float* dst = ts + k * kPlane + (rr & 3) * kTileW;
    for (int c = lane; c < kTileW; c += 32) {
      const int col = 2 * t.j0 - 1 + c;
      const bool ok = row_ok && col >= 0 && col < w;
      cp_async4(dst + c, src + (ok ? col : 0), ok);
    }
  }
  stage_flat(ws, slab + static_cast<size_t>(k0) * 9 * nt, kChunk * 9 * nt);
}

// Forward.  Grid: x = B * (H/2) * ceil((W/2) / 32) tiles, y = channel tiles
// of nt = (blockDim.x / 32) * NC output channels.  wk: [grid y][Cin_pad][9]
// [nt], zero past Cin and Cout.  Dynamic shared memory: two stages of the x
// tile (kChunk * kPlane floats) and the weight slab (kChunk * 9 * nt).
template <int NC>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv2_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                       const float* __restrict__ corr,
                       const float* __restrict__ alpha_p, float* __restrict__ out,
                       unsigned char* __restrict__ code,
                       float* __restrict__ stat_partials, int cin, int cin_pad,
                       int cout, int h, int w) {
  extern __shared__ __align__(16) float smem[];
  const int h2 = h / 2, w2 = w / 2;
  const int n_jt = (w2 + kTileWindows - 1) / kTileWindows;
  const TileOrigin t = tile_origin(h2, n_jt);
  const int lane = threadIdx.x & 31, cg = threadIdx.x >> 5;
  const int nt = (blockDim.x >> 5) * NC;
  const int n0 = blockIdx.y * nt;
  const int stage = kChunk * (kPlane + 9 * nt);
  const float* slab = wk + static_cast<size_t>(blockIdx.y) * cin_pad * 9 * nt;
  const float alpha = alpha_p[0];

  float acc[4][NC];
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[ph][n] = 0.f;

  fwd_stage(smem, smem + kChunk * kPlane, x, slab, t, 0, cin, h, w, nt);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int k0 = 0, s = 0; k0 < cin; k0 += kChunk, s ^= 1) {
    float* cur = smem + s * stage;
    if (k0 + kChunk < cin) {  // the next chunk lands in the other stage
      float* nxt = smem + (s ^ 1) * stage;
      fwd_stage(nxt, nxt + kChunk * kPlane, x, slab, t, k0 + kChunk, cin, h, w, nt);
      cp_async_commit();
    }
    accumulate_chunk<NC>(cur, cur + kChunk * kPlane, nt, lane, cg, acc);
    cp_async_wait_all();
    __syncthreads();
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
      out[o] = best;
      if (code != nullptr)
        code[o] = static_cast<unsigned char>(best_ph | ((best_pre < 0.f) << 2));
      stats[0] = best;
      stats[1] = best * best;
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

// ----------------------------------------------------------------------- dx

// The pooled elements whose windows cover a dx block's d: 6 pooled rows by
// 18 pooled columns a channel, whose 2x2 windows tile a 12 x 36 ring (d rows
// row0 - 2 .. row0 + 9, columns col0 - 2 .. col0 + 33) around the 10 x 34
// halo the GEMM reads; so every window is written whole, without a mask.  A
// thread serves its warp's channel and kDxSlots of those elements: p = lane
// + 32 q, past the 108th repeating the first ones (the same values to the
// same places).  Recomputed where used, to spare registers.
__device__ __forceinline__ int dx_pooled(int q) {
  const int p = (threadIdx.x & 31) + 32 * q;
  return p >= kDxPooled ? p - kDxPooled : p;
}

// The raw (code, g, out) of a thread's pooled elements of channel co, the
// channel's moment cotangents, and which elements are live.  The loads are
// unconditional (a dead element reads offset 0), so that nothing waits on
// them before the MMAs that they overlap; liveness is applied at the store.
static_assert(kDxSlots <= 4, "one code byte a slot");
struct DxRaw {
  unsigned cd, live;
  float g[kDxSlots], out[kDxSlots];
  float gs, gq;
};

__device__ __forceinline__ void dx_load(DxRaw& r, const float* __restrict__ g,
                                        const float* __restrict__ out,
                                        const unsigned char* __restrict__ code,
                                        const float* __restrict__ gs,
                                        const float* __restrict__ gq, int b, int co,
                                        int cout, int row0, int col0, int h2, int w2) {
  const size_t plane =
      (static_cast<size_t>(b) * cout + min(co, cout - 1)) * h2 * w2;
  r.cd = r.live = 0;
#pragma unroll
  for (int q = 0; q < kDxSlots; ++q) {
    const int p = dx_pooled(q);
    const int pr = p / kDxPooledW, pc = p - pr * kDxPooledW;
    const int pi = row0 / 2 - 1 + pr, pj = col0 / 2 - 1 + pc;
    const bool live = co < cout && pi >= 0 && pi < h2 && pj >= 0 && pj < w2;
    const size_t o = live ? plane + pi * w2 + pj : 0;
    r.cd |= static_cast<unsigned>(code[o]) << (8 * q);
    r.g[q] = g[o];
    r.out[q] = out[o];
    r.live |= static_cast<unsigned>(live) << q;
  }
  r.gs = gs[min(co, cout - 1)];
  r.gq = gq[min(co, cout - 1)];
}

// d as the GEMMs read it: the selected position of a window holds scale *
// cotangent, the other three (and everything past the pooled region) zero.
__device__ __forceinline__ float d_value(int cd, float g, float out, float gsc,
                                         float gqc, float alpha) {
  const float gt = cotangent(g, out, gsc, gqc);
  return cd >= 4 ? alpha * gt : gt;
}
// v split: big at dst, small small_off floats further
__device__ __forceinline__ void put_split(float* dst, int small_off, float v) {
  unsigned big, small;
  split(v, big, small);
  dst[0] = __uint_as_float(big);
  dst[small_off] = __uint_as_float(small);
}

// Write d of a thread's pooled elements into its channel's ring, split.
__device__ __forceinline__ void dx_store(float* dplane, const DxRaw& r, float alpha) {
#pragma unroll
  for (int q = 0; q < kDxSlots; ++q) {
    const int p = dx_pooled(q);
    const int pr = p / kDxPooledW, pc = p - pr * kDxPooledW;
    const int cd = (r.live >> q) & 1 ? static_cast<int>((r.cd >> (8 * q)) & 255) : -1;
    const float v = d_value(cd, r.g[q], r.out[q], r.gs, r.gq, alpha);
#pragma unroll
    for (int ph = 0; ph < 4; ++ph)
      put_split(dplane + 2 * pr * kDxRingW + 2 * pc + (ph >> 1) * kDxRingW + (ph & 1),
                kChunk * kDxPlane, (cd >= 0 && (cd & 3) == ph) ? v : 0.f);
  }
}

// dx = transposed convolution of d, as a GEMM: rows are the block's 8 x 32
// pixels, columns its 64 input channels, K = (chunk of 8 output channels,
// tap).  Grid: x = B * ceil(H/8) * ceil(W/32) tiles, y = ceil(Cin/64).
// wdx: [grid y][Cout_pad][kDxWRow], row co = [9 flipped taps][64 channels]
// + 8 zeros.  Warp w owns pixel rows 2 (w & 3), + 1 (four m16 tiles of 16
// columns) and channels 32 * (w >> 2) .. + 32 (four n8 tiles).  Dynamic
// shared memory: two stages of [d big rings kChunk x kDxPlane][d small
// rings][weight slab kChunk x kDxWRow]; the weights are split as they are
// read (four fragments a tap, against sixteen of d).
__global__ void __launch_bounds__(kDxThreads, 2)
fused_conv2_dx_kernel(const float* __restrict__ wdx,
                      const float* __restrict__ alpha_p,
                      const float* __restrict__ g, const float* __restrict__ out,
                      const unsigned char* __restrict__ code,
                      const float* __restrict__ gs,
                      const float* __restrict__ gq, float* __restrict__ dx,
                      int cin, int cout, int cout_pad, int h, int w) {
  constexpr int kSlab = 2 * kChunk * kDxPlane;  // the weights' offset in a stage
  extern __shared__ __align__(16) float smem[];
  const int h2 = h / 2, w2 = w / 2;
  const int n_ct = (w + kDxCols - 1) / kDxCols;
  const int n_rt = (h + kDxRows - 1) / kDxRows;
  int blk = blockIdx.x;
  const int col0 = (blk % n_ct) * kDxCols;
  blk /= n_ct;
  const int row0 = (blk % n_rt) * kDxRows;
  const int b = blk / n_rt;
  const int ci0 = blockIdx.y * kDxCi;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane >> 2, tl = lane & 3;  // fragment row / k lane
  const int wr = 2 * (warp & 3), wn = warp >> 2;
  const float alpha = alpha_p[0];
  const float* slab = wdx + static_cast<size_t>(blockIdx.y) * cout_pad * kDxWRow;

  float acc[2][2][4][4];  // [pixel row][16-column half][n tile][fragment]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][j][nt][i] = 0.f;

  DxRaw raw;
  stage_flat(smem + kSlab, slab, kChunk * kDxWRow);
  cp_async_commit();
  dx_load(raw, g, out, code, gs, gq, b, warp, cout, row0, col0, h2, w2);
  dx_store(smem + warp * kDxPlane, raw, alpha);
  cp_async_wait_all();
  __syncthreads();

  for (int k0 = 0, s = 0; k0 < cout; k0 += kChunk, s ^= 1) {
    const float* ds = smem + s * kDxStage;
    const float* ws = ds + kSlab;
    float* nxt = smem + (s ^ 1) * kDxStage;
    const bool more = k0 + kChunk < cout;
    if (more) {
      stage_flat(nxt + kSlab, slab + static_cast<size_t>(k0 + kChunk) * kDxWRow,
                 kChunk * kDxWRow);
      cp_async_commit();
      dx_load(raw, g, out, code, gs, gq, b, k0 + kChunk + warp, cout, row0, col0, h2,
              w2);
    }
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int eh = tap / 3, ew = tap - 3 * eh;
      const float* b_base = ws + tl * kDxWRow + tap * kDxCi + 32 * wn + gl;
      Frag<2> bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float v[2] = {b_base[8 * nt], b_base[4 * kDxWRow + 8 * nt]};
        make_frag(bf[nt], v);
      }
      // pixel (wr + r, c) reads ring (wr + r + eh + 1, c + ew + 1)
      const float* a_base = ds + tl * kDxPlane + (wr + eh + 1) * kDxRingW + gl + ew + 1;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Frag<4> af[2];  // 16-column halves j
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* ap = a_base + r * kDxRingW + 16 * j;
          const int o[4] = {0, 8, 4 * kDxPlane, 4 * kDxPlane + 8};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            af[j].big[i] = __float_as_uint(ap[o[i]]);
            af[j].small[i] = __float_as_uint(ap[o[i] + kChunk * kDxPlane]);
          }
        }
        mma3(acc[r], af, bf);
      }
    }
    if (more) dx_store(nxt + warp * kDxPlane, raw, alpha);
    cp_async_wait_all();
    __syncthreads();
  }

  // C fragment: (pixel gl | gl + 8, channel 2 tl | 2 tl + 1)
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + wr + r;
          const int col = col0 + 16 * j + gl + 8 * (i >> 1);
          const int ci = ci0 + 32 * wn + 8 * nt + 2 * tl + (i & 1);
          if (row < h && col < w && ci < cin)
            dx[((static_cast<size_t>(b) * cin + ci) * h + row) * w + col] = acc[r][j][nt][i];
        }
}

// ----------------------------------------------------------------------- dw

// The x tile of a dw step: row rr = ci * 4 + r of the tile to warp rr mod 12
// (slot q: rr = warp + 12 q), column c to lane c mod 32 (slot c2: c = lane +
// 32 c2).  Fixed trip counts, unrolled, so that a thread's copies, loads and
// splits are independent and issue back to back.
constexpr int kDwXRows = (kDwCi * 4 + kDwThreads / 32 - 1) / (kDwThreads / 32);  // 11
constexpr int kDwXCols = (kDwXW + 31) / 32;                                      // 2

// Stage step (b, i, j0): x rows 2i - 1 .. 2i + 2, columns 2 * j0 - 1 .. 2 * j0
// + 32 of input channels ci0 .. ci0 + 31, zero padded, by cp.async.
__device__ __forceinline__ void dw_stage_x(float* xs, const float* __restrict__ x,
                                           int b, int i, int j0, int ci0, int cin,
                                           int h, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kDwXRows; ++q) {
    const int rr = warp + (kDwThreads / 32) * q;
    const int ci = ci0 + (rr >> 2), row = 2 * i - 1 + (rr & 3);
    const bool row_ok = rr < kDwCi * 4 && ci < cin && row >= 0 && row < h;
    const float* src = x + ((static_cast<size_t>(b) * cin + (row_ok ? ci : 0)) * h +
                            (row_ok ? row : 0)) * w;
#pragma unroll
    for (int c2 = 0; c2 < kDwXCols; ++c2) {
      const int c = lane + 32 * c2, col = 2 * j0 - 1 + c;
      const bool ok = row_ok && c < kDwXW && col >= 0 && col < w;
      if (rr < kDwCi * 4 && c < kDwXW)
        cp_async4(xs + (rr >> 2) * kDwXPlane + (rr & 3) * kDwXW + c, src + (ok ? col : 0),
                  ok);
    }
  }
}

// The raw (code, g, out) of this thread's pooled elements of one step:
// element q is idx = threadIdx.x + q * kDwThreads, channel co0 + idx / 16,
// pooled column j0 + idx % 16.  The loads are unconditional (a dead element
// reads offset 0, its code byte is then 0xff), so that nothing waits on them
// before the MMAs that they overlap; the codes are packed a byte each.
static_assert(kDwCo * kDwWindows == kDwSlots * kDwThreads, "dw slots");
static_assert(kDwSlots <= 4, "one code byte a slot");
struct DwRaw {
  unsigned cd, live;
  float g[kDwSlots], out[kDwSlots];
};

__device__ __forceinline__ void dw_load(DwRaw& r, const float* __restrict__ g,
                                        const float* __restrict__ out,
                                        const unsigned char* __restrict__ code,
                                        int b, int i, int j0, int co0, int cout,
                                        int h2, int w2) {
  r.cd = r.live = 0;
#pragma unroll
  for (int q = 0; q < kDwSlots; ++q) {
    const int idx = threadIdx.x + q * kDwThreads;
    const int co = co0 + (idx >> 4), gj = j0 + (idx & 15);
    const bool live = co < cout && gj < w2;
    const size_t o =
        live ? ((static_cast<size_t>(b) * cout + co) * h2 + i) * w2 + gj : 0;
    r.cd |= static_cast<unsigned>(code[o]) << (8 * q);
    r.g[q] = g[o];
    r.out[q] = out[o];
    r.live |= static_cast<unsigned>(live) << q;
  }
}

// d of one step as [kDwCo channels][kDwDRow], big then small kDwCo *
// kDwDRow floats further: pixel r * 32 + c of conv row 2i + r, column
// 2 * j0 + c; the selected position of each window holds scale *
// cotangent, the other three zero.  gsq: the block's (gs, gq) in shared
// memory, [2][kDwCo].
__device__ __forceinline__ void dw_store(float* ds, const DwRaw& r, const float* gsq,
                                         float alpha) {
#pragma unroll
  for (int q = 0; q < kDwSlots; ++q) {
    const int idx = threadIdx.x + q * kDwThreads;
    const int cd = (r.live >> q) & 1 ? static_cast<int>((r.cd >> (8 * q)) & 255) : -1;
    const float v =
        d_value(cd, r.g[q], r.out[q], gsq[idx >> 4], gsq[kDwCo + (idx >> 4)], alpha);
    float* dst = ds + (idx >> 4) * kDwDRow + 2 * (idx & 15);
#pragma unroll
    for (int ph = 0; ph < 4; ++ph)
      put_split(dst + (ph >> 1) * 2 * kDwWindows + (ph & 1), kDwCo * kDwDRow,
                (cd >= 0 && (cd & 3) == ph) ? v : 0.f);
  }
}

// dw = im2col(x)^T . d as a GEMM: rows (tap, input channel), columns output
// channels, K the pixels.  Grid: x = ceil(Cin / 32) * ceil(Cout / 96) tiles
// of dw, y = splits of the B * (H/2) * ceil((W/2) / 16) steps of 64 pixels.
// Warp w owns the three taps of row dh = w / 4 for the block's 32 input
// channels (six m16 tiles) by output channels 24 (w % 4) .. + 24 (three n8
// tiles).  Dynamic shared memory: two stages of [x kDwCi x kDwXPlane][d big
// kDwCo x kDwDRow][d small], then the block's (gs, gq); x is split as it is
// read, one tap (two fragments) at a time.
__global__ void __launch_bounds__(kDwThreads)
fused_conv2_dw_kernel(const float* __restrict__ x,
                      const float* __restrict__ alpha_p,
                      const float* __restrict__ g, const float* __restrict__ out,
                      const unsigned char* __restrict__ code,
                      const float* __restrict__ gs,
                      const float* __restrict__ gq,
                      float* __restrict__ partials, int bsz, int cin, int cout,
                      int h, int w) {
  constexpr int kX = kDwCi * kDwXPlane, kD = kDwCo * kDwDRow;  // floats
  extern __shared__ __align__(16) float smem[];
  const int h2 = h / 2, w2 = w / 2;
  const int n_cot = (cout + kDwCo - 1) / kDwCo;
  const int ci0 = (blockIdx.x / n_cot) * kDwCi;
  const int co0 = (blockIdx.x % n_cot) * kDwCo;
  const int n_jt = (w2 + kDwWindows - 1) / kDwWindows;
  const int steps = bsz * h2 * n_jt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane >> 2, tl = lane & 3;
  const int dh = warp >> 2, nq = warp & 3;
  const float alpha = alpha_p[0];

  float acc[3][2][3][4];  // [dw][m tile][n tile][fragment]
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[dw][mt][nt][k] = 0.f;

  float* gsq = smem + 2 * kDwStage;
  for (int k = threadIdx.x; k < 2 * kDwCo; k += kDwThreads) {
    const int co = min(co0 + (k % kDwCo), cout - 1);
    gsq[k] = k < kDwCo ? gs[co] : gq[co];
  }
  DwRaw raw;
  int s = blockIdx.y;
  {
    const int jt = s % n_jt, i = (s / n_jt) % h2, b = s / (n_jt * h2);
    dw_stage_x(smem, x, b, i, jt * kDwWindows, ci0, cin, h, w);
    cp_async_commit();
    dw_load(raw, g, out, code, b, i, jt * kDwWindows, co0, cout, h2, w2);
    __syncthreads();  // gsq
    dw_store(smem + kX, raw, gsq, alpha);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int buf = 0; s < steps; s += gridDim.y, buf ^= 1) {
    const float* xs = smem + buf * kDwStage;
    const float* ds = xs + kX;
    float* nxt = smem + (buf ^ 1) * kDwStage;
    const int sn = s + gridDim.y;
    const bool more = sn < steps;
    if (more) {
      const int jt = sn % n_jt, ni = (sn / n_jt) % h2, nb = sn / (n_jt * h2);
      dw_stage_x(nxt, x, nb, ni, jt * kDwWindows, ci0, cin, h, w);
      cp_async_commit();
      dw_load(raw, g, out, code, nb, ni, jt * kDwWindows, co0, cout, h2, w2);
    }
#pragma unroll 2
    for (int ks = 0; ks < kDwPix / 8; ++ks) {
      // pixels ks * 8 .. + 7: conv row ks >> 2, columns (ks & 3) * 8 + k
      const float* b_base = ds + (24 * nq + gl) * kDwDRow + ks * 8 + tl;
      Frag<2> bf[3];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        const float* bp = b_base + 8 * nt * kDwDRow;
        bf[nt].big[0] = __float_as_uint(bp[0]);
        bf[nt].big[1] = __float_as_uint(bp[4]);
        bf[nt].small[0] = __float_as_uint(bp[kD]);
        bf[nt].small[1] = __float_as_uint(bp[kD + 4]);
      }
      const float* a_base =
          xs + gl * kDwXPlane + ((ks >> 2) + dh) * kDwXW + (ks & 3) * 8 + tl;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        Frag<4> af[2];  // m tiles
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* ap = a_base + dw + 16 * mt * kDwXPlane;
          const float v[4] = {ap[0], ap[8 * kDwXPlane], ap[4], ap[8 * kDwXPlane + 4]};
          make_frag(af[mt], v);
        }
        mma3_add(acc[dw], af, bf);
      }
    }
    if (more) dw_store(nxt + kX, raw, gsq, alpha);
    cp_async_wait_all();
    __syncthreads();
  }

  // C fragment: (channel gl | gl + 8, output channel 2 tl | 2 tl + 1)
  float* dst = partials + static_cast<size_t>(blockIdx.y) * 9 * cin * cout;
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ci = ci0 + 16 * mt + gl + 8 * (k >> 1);
          const int co = co0 + 24 * nq + 8 * nt + 2 * tl + (k & 1);
          if (ci < cin && co < cout)
            dst[(static_cast<size_t>(dh * 3 + dw) * cin + ci) * cout + co] =
                acc[dw][mt][nt][k];
        }
}

// -------------------------------------------------------- dcorr and dalpha

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
    const float gsc = gs[co], gqc = gq[co];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int b = 0; b < bsz; ++b) {
      const size_t o = ((static_cast<size_t>(b) * cout + co) * h2 + i) * w2 + j;
      const int cd = code[o];
      const int sel = cd & 3;
      const float gt = cotangent(to_float(g[o]), to_float(out[o]), gsc, gqc);
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

// ------------------------------------------------ bf16 route: tensor cores

constexpr int kBfChunk = 16;     // channels of K a stage: one m16n8k16 step a tap
constexpr int kBfPos = 24;       // bf16 slots of a staged position: 16 channels + 8 (48 B)
constexpr int kBfThreads = 256;

// forward: a CTA owns one pooled row's 32 windows (2 x 64 conv pixels)
constexpr int kBfWin = kTileWindows;
constexpr int kBfHaloW = 2 * kBfWin + 2;            // 66 halo columns
constexpr int kBfParity = kBfWin + 1;               // 33 halo columns of each parity
constexpr int kBfX = 4 * 2 * kBfParity * kBfPos;    // bf16 elements of a stage's halo
constexpr int kBfXSlots = (8 * 4 * kBfHaloW + kBfThreads - 1) / kBfThreads;  // 9
constexpr int kBfXHalf = (kBfXSlots + 1) / 2;       // slots held in registers at once

// dx: the d ring of 12 x 36 positions around the 8 x 32 pixels
constexpr int kBxD = (kDxRows + 4) * kDxRingW * kBfPos;  // bf16 elements
constexpr int kBxSlab = 9 * (kDxCi / 8) * 32;            // uint2 of a chunk's weights
constexpr int kBxItems = (kBfChunk / 2) * kDxPooled;     // 864 (channel pair, element)
constexpr int kBxSlots = (kBxItems + kDxThreads - 1) / kDxThreads;  // 4
constexpr int kBxHalf = kBxSlots / 2;

// dw
constexpr int kBwPos = kDwCi + 8;                 // bf16 slots of a staged x position (80 B)
constexpr int kBwX = 4 * kDwXW * kBwPos;          // bf16 elements of a step's x tile
constexpr int kBwDRow = kDwPix + 8;               // bf16 of a channel's d row (144 B)
constexpr int kBwD = kDwCo * kBwDRow;
constexpr int kBwXItems = (kDwCi / 2) * 4 * kDwXW;  // 2176 (channel pair, row, column)
constexpr int kBwXSlots = (kBwXItems + kDwThreads - 1) / kDwThreads;  // 6

static_assert(kBfX % 8 == 0 && kBxD % 8 == 0 && (kBwX + kBwD) % 8 == 0,
              "every stage region starts on a 16-byte boundary");

// The bf16 route's d before its one rounding to bf16: as d_value, but each
// operation rounded on its own (no contraction into an FMA), so that a
// check can rebuild it bit for bit from the same fp32 operations.
__device__ __forceinline__ float d_value_rn(int cd, float g, float out, float gsc,
                                            float gqc, float alpha) {
  const float gt = __fadd_rn(__fadd_rn(g, gsc), __fmul_rn(__fmul_rn(2.f, out), gqc));
  return cd >= 4 ? __fmul_rn(alpha, gt) : gt;
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c += a . b, m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c = a . b, summed from zero
__device__ __forceinline__ void mma_bf16_zero(float (&c)[4], const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// The x halo of one forward chunk: channel pairs (k0 + 2p, + 1) x rows 2i - 1
// .. 2i + 2 x columns 2 * j0 - 1 .. 2 * j0 + 64, zero outside the image and
// past Cin.  Item e = threadIdx.x + q * kBfThreads: column e % 66 (a warp
// reads a run of one row), (pair, row) e / 66.  Loaded into registers before
// the current chunk's MMAs, stored a channel pair a word after them, into
// the stage's [row][column parity][column / 2][channel] layout.  Half of a
// thread's slots at a time ([Q0, Q1)): their loads overlap half the taps'
// MMAs, and half the registers stay live across them.
struct BfX {
  unsigned short lo[kBfXHalf], hi[kBfXHalf];
};

template <int Q0, int Q1>
__device__ __forceinline__ void bf_fwd_load(BfX& r, const unsigned short* __restrict__ x,
                                            const TileOrigin& t, int k0, int cin, int h,
                                            int w) {
#pragma unroll
  for (int q = Q0; q < Q1; ++q) {
    const int e = threadIdx.x + q * kBfThreads;
    const int c = e % kBfHaloW, pr = e / kBfHaloW;
    const int ci = k0 + 2 * (pr >> 2), row = 2 * t.i - 1 + (pr & 3);
    const int col = 2 * t.j0 - 1 + c;
    const bool ok = pr < 32 && row >= 0 && row < h && col >= 0 && col < w;
    const size_t o = ((static_cast<size_t>(t.b) * cin + ci) * h + row) * w + col;
    r.lo[q - Q0] = ok && ci < cin ? __ldg(x + o) : 0;
    r.hi[q - Q0] = ok && ci + 1 < cin ? __ldg(x + o + static_cast<size_t>(h) * w) : 0;
  }
}

template <int Q0, int Q1>
__device__ __forceinline__ void bf_fwd_store(unsigned char* xs, const BfX& r) {
#pragma unroll
  for (int q = Q0; q < Q1; ++q) {
    const int e = threadIdx.x + q * kBfThreads;
    const int c = e % kBfHaloW, pr = e / kBfHaloW;
    if (pr < 32) {
      const int pos = ((pr & 3) * 2 + (c & 1)) * kBfParity + (c >> 1);
      *reinterpret_cast<unsigned*>(xs + (pos * kBfPos + 2 * (pr >> 2)) * 2) =
          r.lo[q - Q0] | (static_cast<unsigned>(r.hi[q - Q0]) << 16);
    }
  }
}

// Taps [T0, T1) of a forward chunk: per tap two ldmatrix (the warp's m16
// tiles, one conv row each) and kNF B fragments.  xs: the lane's ldmatrix
// row in the stage's halo; ws: its B fragment of the warp's first n8 tile.
template <int kNF, int T0, int T1>
__device__ __forceinline__ void fwd_taps(float (&acc)[2][kNF][4], unsigned xs,
                                         const uint2* ws, int bq) {
#pragma unroll
  for (int tap = T0; tap < T1; ++tap) {
    const int th = tap / 3, tw = tap - 3 * th;
    const int par = (bq + tw) & 1, sh = (bq + tw) >> 1;
    unsigned a[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      ldsm_x4(a[r], xs + (((r + th) * 2 + par) * kBfParity + sh) * kBfPos * 2);
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      const uint2 b = ws[(tap * 2 * kNF + f) * 32];
#pragma unroll
      for (int r = 0; r < 2; ++r) mma_bf16(acc[r][f], a[r], b.x, b.y);
    }
  }
}

// bf16 forward.  Grid: x = B * (H/2) * ceil((W/2) / 32) tiles (a pooled row's
// 32 windows each), y = channel tiles of kNT = 16 * kNF.  wf: [grid y][Cin /
// 16 chunks][9 taps][kNT / 8 n8 tiles][32 lanes] B fragments (uint2: k 2tl,
// 2tl + 1 and 2tl + 8, 2tl + 9 of column gl), zero past Cin and Cout.
// Warps 4 (M) x 2 (N): warp (wm, wn) owns windows 8 wm .. 8 wm + 7, both
// conv rows (m16 tile r = conv row 2i + r; its row q = pixel column 2 (8 wm
// + q % 8) + q / 8), and n8 tiles wn * kNF ...  Dynamic shared memory: two
// stages of [halo kBfX bf16][weights 288 * kNT bytes].
template <int kNF>
__global__ void __launch_bounds__(kBfThreads, 2)
fused_conv2_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const uint2* __restrict__ wf, const float* __restrict__ corr,
                            const float* __restrict__ alpha_p,
                            __nv_bfloat16* __restrict__ out, unsigned char* __restrict__ code,
                            float* __restrict__ stat_partials, int cin, int cout, int h,
                            int w) {
  constexpr int kNT = 16 * kNF;              // output channels a CTA
  constexpr int kSlab = 9 * (kNT / 8) * 32;  // uint2 of a chunk's weights
  constexpr int kStage = 2 * kBfX + 8 * kSlab;  // bytes
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int h2 = h / 2, w2 = w / 2;
  const TileOrigin t = tile_origin(h2, (w2 + kBfWin - 1) / kBfWin);
  const int chunks = (cin + kBfChunk - 1) / kBfChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gl = lane >> 2, tl = lane & 3;
  const int n0 = blockIdx.y * kNT;
  const uint2* slab = wf + static_cast<size_t>(blockIdx.y) * chunks * kSlab;
  const unsigned short* xu = reinterpret_cast<const unsigned short*>(x);

  float acc[2][kNF][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int f = 0; f < kNF; ++f)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][f][k] = 0.f;

  BfX raw;
  stage_flat(reinterpret_cast<float*>(smem_b + 2 * kBfX), reinterpret_cast<const float*>(slab),
             2 * kSlab);
  cp_async_commit();
  bf_fwd_load<0, kBfXHalf>(raw, xu, t, 0, cin, h, w);
  bf_fwd_store<0, kBfXHalf>(smem_b, raw);
  bf_fwd_load<kBfXHalf, kBfXSlots>(raw, xu, t, 0, cin, h, w);
  bf_fwd_store<kBfXHalf, kBfXSlots>(smem_b, raw);
  cp_async_wait_all();
  __syncthreads();

  // ldmatrix rows: lane l gives row q = l % 8 + 8 ((l / 8) % 2) of an m16
  // tile, channels 8 (l / 16) ..; at tap (th, tw) row q of tile r reads halo
  // row r + th, column 2 (8 wm + q % 8) + q / 8 + tw
  const int bq = (lane >> 3) & 1;
  const unsigned lane_off = ((wm * 8 + (lane & 7)) * kBfPos + (lane >> 4) * 8) * 2;
  for (int c = 0, s = 0; c < chunks; ++c, s ^= 1) {
    const unsigned char* cur = smem_b + s * kStage;
    unsigned char* nxt = smem_b + (s ^ 1) * kStage;
    const bool more = c + 1 < chunks;
    const int k1 = (c + 1) * kBfChunk;
    if (more) {
      stage_flat(reinterpret_cast<float*>(nxt + 2 * kBfX),
                 reinterpret_cast<const float*>(slab + static_cast<size_t>(c + 1) * kSlab),
                 2 * kSlab);
      cp_async_commit();
      bf_fwd_load<0, kBfXHalf>(raw, xu, t, k1, cin, h, w);
    }
    const unsigned xs = smem_addr(cur) + lane_off;
    const uint2* ws = reinterpret_cast<const uint2*>(cur + 2 * kBfX) + wn * kNF * 32 + lane;
    fwd_taps<kNF, 0, 5>(acc, xs, ws, bq);
    if (more) {
      bf_fwd_store<0, kBfXHalf>(nxt, raw);
      bf_fwd_load<kBfXHalf, kBfXSlots>(raw, xu, t, k1, cin, h, w);
    }
    fwd_taps<kNF, 5, 9>(acc, xs, ws, bq);
    if (more) bf_fwd_store<kBfXHalf, kBfXSlots>(nxt, raw);
    cp_async_wait_all();
    __syncthreads();
  }

  // C fragment e of tile (r, f): pixel column 2 (8 wm + gl) + e / 2, channel
  // 2 tl + e % 2 of n8 tile wn * kNF + f: phase r * 2 + e / 2 of window gl.
  // The moments: the warp's 8 windows by shuffles (into red [wm][sum |
  // sumsq][kNT], in the stages' memory, free after the last sync), then the
  // 4 M warps in order.  Every corr value is loaded before any is used.
  const float alpha = alpha_p[0];
  const int gj = t.j0 + wm * 8 + gl;
  const bool live = gj < w2;
  float* red = reinterpret_cast<float*>(smem_b);
  float cv[kNF][2][4];
#pragma unroll
  for (int f = 0; f < kNF; ++f)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int co = n0 + (wn * kNF + f) * 8 + 2 * tl + cc;
      const float* cb = corr + (static_cast<size_t>(co) * h + 2 * t.i) * w + 2 * gj;
#pragma unroll
      for (int ph = 0; ph < 4; ++ph)
        cv[f][cc][ph] = live && co < cout ? __ldg(cb + (ph >> 1) * w + (ph & 1)) : 0.f;
    }
#pragma unroll
  for (int f = 0; f < kNF; ++f)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int co = n0 + (wn * kNF + f) * 8 + 2 * tl + cc;
      float st[2] = {0.f, 0.f};
      if (live && co < cout) {
        float best = 0.f, best_pre = 0.f;
        int best_ph = 0;
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
          const float conv = acc[ph >> 1][f][(ph & 1) * 2 + cc] + cv[f][cc][ph];
          const float act = conv >= 0.f ? conv : alpha * conv;
          // strict >: ties keep the first phase of (0,0),(0,1),(1,0),(1,1)
          if (ph == 0 || act > best) {
            best = act;
            best_pre = conv;
            best_ph = ph;
          }
        }
        const size_t o = ((static_cast<size_t>(t.b) * cout + co) * h2 + t.i) * w2 + gj;
        const __nv_bfloat16 stored = __float2bfloat16_rn(best);
        out[o] = stored;
        if (code != nullptr)
          code[o] = static_cast<unsigned char>(best_ph | ((best_pre < 0.f) << 2));
        const float rounded = __bfloat162float(stored);  // what a later pass reads
        st[0] = rounded;
        st[1] = rounded * rounded;
      }
      if (stat_partials != nullptr) {  // uniform over the block
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = st[k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gl == 0) red[(wm * 2 + k) * kNT + (wn * kNF + f) * 8 + 2 * tl + cc] = v;
        }
      }
    }
  if (stat_partials != nullptr) {
    __syncthreads();
    float* dst = stat_partials + static_cast<size_t>(blockIdx.x) * 2 * cout;
    for (int n = threadIdx.x; n < kNT && n0 + n < cout; n += kBfThreads) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        sum += red[(m * 2) * kNT + n];
        sq += red[(m * 2 + 1) * kNT + n];
      }
      dst[n0 + n] = sum;
      dst[cout + n0 + n] = sq;
    }
  }
}

// The raw (code, g, out) of one dx chunk's d: channel pairs (k0 + 2p, + 1) x
// the 6 x 18 pooled elements whose windows tile the ring; item e =
// threadIdx.x + q * kDxThreads is pair e % 8, element e / 8.  Loads from
// valid addresses whatever the liveness (a dead element reads offset 0).
// Half of a thread's slots at a time ([Q0, Q1)), as the forward stages x.
struct BxRaw {
  unsigned char cd[kBxHalf][2];
  unsigned short g[kBxHalf][2], out[kBxHalf][2];
};

__device__ __forceinline__ bool bx_item(int q, int& p, int& pr, int& pc) {
  const int e = threadIdx.x + q * kDxThreads;
  const int el = e >> 3;
  p = e & 7;
  pr = el / kDxPooledW;
  pc = el - pr * kDxPooledW;
  return e < kBxItems;
}

template <int Q0, int Q1>
__device__ __forceinline__ void bx_load(BxRaw& r, const unsigned short* __restrict__ g,
                                        const unsigned short* __restrict__ out,
                                        const unsigned char* __restrict__ code, int b, int k0,
                                        int cout, int row0, int col0, int h2, int w2) {
#pragma unroll
  for (int q = Q0; q < Q1; ++q) {
    int p, pr, pc;
    const bool item = bx_item(q, p, pr, pc);
    const int pi = row0 / 2 - 1 + pr, pj = col0 / 2 - 1 + pc;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int co = k0 + 2 * p + cc;
      const bool live = item && co < cout && pi >= 0 && pi < h2 && pj >= 0 && pj < w2;
      const size_t o = live ? ((static_cast<size_t>(b) * cout + co) * h2 + pi) * w2 + pj : 0;
      r.cd[q - Q0][cc] = code[o];
      r.g[q - Q0][cc] = g[o];
      r.out[q - Q0][cc] = out[o];
    }
  }
}

// d of a chunk into the ring, rounded to bf16 once: each pooled element's
// 2x2 window, the selected position holding d and the other three zero, a
// channel pair a 32-bit word.  gsq: [gs | gq][cpad] in shared memory.
template <int Q0, int Q1>
__device__ __forceinline__ void bx_store(unsigned char* ring, const BxRaw& r, const float* gsq,
                                         int cpad, float alpha, int k0, int cout, int row0,
                                         int col0, int h2, int w2) {
#pragma unroll
  for (int q = Q0; q < Q1; ++q) {
    int p, pr, pc;
    if (!bx_item(q, p, pr, pc)) continue;
    const int pi = row0 / 2 - 1 + pr, pj = col0 / 2 - 1 + pc;
    unsigned v[2];
    int ph[2];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int co = k0 + 2 * p + cc;
      const bool live = co < cout && pi >= 0 && pi < h2 && pj >= 0 && pj < w2;
      const int cd = r.cd[q - Q0][cc];
      ph[cc] = live ? (cd & 3) : -1;
      v[cc] = live ? bf16_bits(d_value_rn(cd, bf16_value(r.g[q - Q0][cc]),
                                          bf16_value(r.out[q - Q0][cc]), gsq[co],
                                          gsq[cpad + co], alpha))
                   : 0u;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pos = (2 * pr + (k >> 1)) * kDxRingW + 2 * pc + (k & 1);
      *reinterpret_cast<unsigned*>(ring + (pos * kBfPos + 2 * p) * 2) =
          (ph[0] == k ? v[0] : 0u) | ((ph[1] == k ? v[1] : 0u) << 16);
    }
  }
}

// Flipped taps [T0, T1) of a dx chunk: per tap the warp's 4 B fragments and
// 4 ldmatrix (2 pixel rows x 2 halves of 16 columns).  ds: the lane's
// ldmatrix row in the stage's ring; ws: its B fragment of the warp's first
// n8 tile.
template <int T0, int T1>
__device__ __forceinline__ void dx_taps(float (&acc)[2][2][4][4], unsigned ds,
                                        const uint2* ws, int wr) {
#pragma unroll
  for (int tap = T0; tap < T1; ++tap) {
    const int eh = tap / 3, ew = tap - 3 * eh;
    uint2 bf[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) bf[nt] = ws[(tap * 8 + nt) * 32];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned a[4];
        ldsm_x4(a, ds + ((wr + r + eh + 1) * kDxRingW + 16 * j + ew + 1) * kBfPos * 2);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[r][j][nt], a, bf[nt].x, bf[nt].y);
      }
  }
}

// bf16 dx: the transposed convolution of d as a GEMM, rows the block's 8 x 32
// pixels, columns its 64 input channels, K = (chunk of 16 output channels,
// tap).  Grid: as the fp32 dx kernel.  wdx: [grid y][Cout / 16 chunks][9
// flipped taps][8 n8 tiles][32 lanes] B fragments.  Warp w owns pixel rows
// 2 (w % 4), + 1 (four m16 tiles of 16 columns) and channels 32 (w / 4) ..
// + 32 (four n8 tiles).  Dynamic shared memory: two stages of [d ring
// kBxD bf16, [row][column][channel]][weights kBxSlab uint2], then the
// moments' cotangents [gs | gq][Cout_pad] float.
__global__ void __launch_bounds__(kDxThreads, 2)
fused_conv2_dx_bf16_kernel(const uint2* __restrict__ wdx, const float* __restrict__ alpha_p,
                           const __nv_bfloat16* __restrict__ g,
                           const __nv_bfloat16* __restrict__ out,
                           const unsigned char* __restrict__ code,
                           const float* __restrict__ gs, const float* __restrict__ gq,
                           __nv_bfloat16* __restrict__ dx, int cin, int cout, int h, int w) {
  constexpr int kStage = 2 * kBxD + 8 * kBxSlab;  // bytes
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int h2 = h / 2, w2 = w / 2;
  const int chunks = (cout + kBfChunk - 1) / kBfChunk, cpad = chunks * kBfChunk;
  const int n_ct = (w + kDxCols - 1) / kDxCols;
  const int n_rt = (h + kDxRows - 1) / kDxRows;
  int blk = blockIdx.x;
  const int col0 = (blk % n_ct) * kDxCols;
  blk /= n_ct;
  const int row0 = (blk % n_rt) * kDxRows;
  const int b = blk / n_rt;
  const int ci0 = blockIdx.y * kDxCi;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane >> 2, tl = lane & 3;
  const int wr = 2 * (warp & 3), wn = warp >> 2;
  const float alpha = alpha_p[0];
  const uint2* slab = wdx + static_cast<size_t>(blockIdx.y) * chunks * kBxSlab;
  const unsigned short* gu = reinterpret_cast<const unsigned short*>(g);
  const unsigned short* ou = reinterpret_cast<const unsigned short*>(out);
  float* gsq = reinterpret_cast<float*>(smem_b + 2 * kStage);
  for (int k = threadIdx.x; k < 2 * cpad; k += kDxThreads) {
    const int co = k < cpad ? k : k - cpad;
    gsq[k] = co < cout ? (k < cpad ? gs[co] : gq[co]) : 0.f;
  }

  float acc[2][2][4][4];  // [pixel row][16-column half][n tile][fragment]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][j][nt][i] = 0.f;

  BxRaw raw;
  stage_flat(reinterpret_cast<float*>(smem_b + 2 * kBxD), reinterpret_cast<const float*>(slab),
             2 * kBxSlab);
  cp_async_commit();
  __syncthreads();  // gsq
  bx_load<0, kBxHalf>(raw, gu, ou, code, b, 0, cout, row0, col0, h2, w2);
  bx_store<0, kBxHalf>(smem_b, raw, gsq, cpad, alpha, 0, cout, row0, col0, h2, w2);
  bx_load<kBxHalf, kBxSlots>(raw, gu, ou, code, b, 0, cout, row0, col0, h2, w2);
  bx_store<kBxHalf, kBxSlots>(smem_b, raw, gsq, cpad, alpha, 0, cout, row0, col0, h2, w2);
  cp_async_wait_all();
  __syncthreads();

  // ldmatrix rows: lane l gives pixel column 16 j + l % 8 + 8 ((l / 8) % 2),
  // channels 8 (l / 16) ..; pixel (wr + r, c) reads ring (wr + r + eh + 1,
  // c + ew + 1) at flipped tap (eh, ew)
  const unsigned lane_off = (((lane & 7) + 8 * ((lane >> 3) & 1)) * kBfPos + (lane >> 4) * 8) * 2;
  for (int c = 0, s = 0; c < chunks; ++c, s ^= 1) {
    const unsigned char* cur = smem_b + s * kStage;
    unsigned char* nxt = smem_b + (s ^ 1) * kStage;
    const bool more = c + 1 < chunks;
    const int k1 = (c + 1) * kBfChunk;
    if (more) {
      stage_flat(reinterpret_cast<float*>(nxt + 2 * kBxD),
                 reinterpret_cast<const float*>(slab + static_cast<size_t>(c + 1) * kBxSlab),
                 2 * kBxSlab);
      cp_async_commit();
      bx_load<0, kBxHalf>(raw, gu, ou, code, b, k1, cout, row0, col0, h2, w2);
    }
    const unsigned ds = smem_addr(cur) + lane_off;
    const uint2* ws = reinterpret_cast<const uint2*>(cur + 2 * kBxD) + wn * 4 * 32 + lane;
    dx_taps<0, 5>(acc, ds, ws, wr);
    if (more) {
      bx_store<0, kBxHalf>(nxt, raw, gsq, cpad, alpha, k1, cout, row0, col0, h2, w2);
      bx_load<kBxHalf, kBxSlots>(raw, gu, ou, code, b, k1, cout, row0, col0, h2, w2);
    }
    dx_taps<5, 9>(acc, ds, ws, wr);
    if (more) bx_store<kBxHalf, kBxSlots>(nxt, raw, gsq, cpad, alpha, k1, cout, row0, col0, h2, w2);
    cp_async_wait_all();
    __syncthreads();
  }

  // C fragment: (pixel gl | gl + 8, channel 2 tl | 2 tl + 1)
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + wr + r;
          const int col = col0 + 16 * j + gl + 8 * (i >> 1);
          const int ci = ci0 + 32 * wn + 8 * nt + 2 * tl + (i & 1);
          if (row < h && col < w && ci < cin)
            dx[((static_cast<size_t>(b) * cin + ci) * h + row) * w + col] =
                __float2bfloat16_rn(acc[r][j][nt][i]);
        }
}

// The x tile of a bf16 dw step: channel pairs (ci0 + 2p, + 1) x rows 2i - 1 ..
// 2i + 2 x columns 2 * j0 - 1 .. 2 * j0 + 32, zero padded, into [row][column]
// [channel]; item e = threadIdx.x + q * kDwThreads: column e % 34, (pair, row)
// e / 34.
struct BwX {
  unsigned short lo[kBwXSlots], hi[kBwXSlots];
};

__device__ __forceinline__ void bw_load_x(BwX& r, const unsigned short* __restrict__ x, int b,
                                          int i, int j0, int ci0, int cin, int h, int w) {
#pragma unroll
  for (int q = 0; q < kBwXSlots; ++q) {
    const int e = threadIdx.x + q * kDwThreads;
    const int c = e % kDwXW, pr = e / kDwXW;
    const int ci = ci0 + 2 * (pr >> 2), row = 2 * i - 1 + (pr & 3);
    const int col = 2 * j0 - 1 + c;
    const bool ok = pr < kDwCi * 2 && row >= 0 && row < h && col >= 0 && col < w;
    const size_t o = ((static_cast<size_t>(b) * cin + ci) * h + row) * w + col;
    r.lo[q] = ok && ci < cin ? __ldg(x + o) : 0;
    r.hi[q] = ok && ci + 1 < cin ? __ldg(x + o + static_cast<size_t>(h) * w) : 0;
  }
}

__device__ __forceinline__ void bw_store_x(unsigned char* xs, const BwX& r) {
#pragma unroll
  for (int q = 0; q < kBwXSlots; ++q) {
    const int e = threadIdx.x + q * kDwThreads;
    const int c = e % kDwXW, pr = e / kDwXW;
    if (pr < kDwCi * 2)
      *reinterpret_cast<unsigned*>(xs + (((pr & 3) * kDwXW + c) * kBwPos + 2 * (pr >> 2)) * 2) =
          r.lo[q] | (static_cast<unsigned>(r.hi[q]) << 16);
  }
}

// The raw (code, g, out) of a bf16 dw step's pooled elements: element q is
// idx = threadIdx.x + q * kDwThreads, channel co0 + idx / 16, pooled column
// j0 + idx % 16; loads from valid addresses whatever the liveness.
struct BwRaw {
  unsigned char cd[kDwSlots];
  unsigned short g[kDwSlots], out[kDwSlots];
};

__device__ __forceinline__ void bw_load_d(BwRaw& r, const unsigned short* __restrict__ g,
                                          const unsigned short* __restrict__ out,
                                          const unsigned char* __restrict__ code, int b, int i,
                                          int j0, int co0, int cout, int h2, int w2) {
#pragma unroll
  for (int q = 0; q < kDwSlots; ++q) {
    const int idx = threadIdx.x + q * kDwThreads;
    const int co = co0 + (idx >> 4), gj = j0 + (idx & 15);
    const bool live = co < cout && gj < w2;
    const size_t o = live ? ((static_cast<size_t>(b) * cout + co) * h2 + i) * w2 + gj : 0;
    r.cd[q] = code[o];
    r.g[q] = g[o];
    r.out[q] = out[o];
  }
}

// d of a step as [kDwCo channels][kBwDRow] bf16, rounded once: pixel r * 32 +
// c of conv row 2i + r, column 2 * j0 + c; a window's two pixels of a row as
// one word.  gsq: the block's [gs | gq][kDwCo].
__device__ __forceinline__ void bw_store_d(unsigned char* ds, const BwRaw& r, const float* gsq,
                                           float alpha, int j0, int co0, int cout, int w2) {
#pragma unroll
  for (int q = 0; q < kDwSlots; ++q) {
    const int idx = threadIdx.x + q * kDwThreads;
    const int cl = idx >> 4, jw = idx & 15;
    const bool live = co0 + cl < cout && j0 + jw < w2;
    const int ph = live ? (r.cd[q] & 3) : -1;
    const unsigned v =
        live ? bf16_bits(d_value_rn(r.cd[q], bf16_value(r.g[q]), bf16_value(r.out[q]),
                                    gsq[cl], gsq[kDwCo + cl], alpha))
             : 0u;
    unsigned* dst = reinterpret_cast<unsigned*>(ds + (cl * kBwDRow + 2 * jw) * 2);
    dst[0] = (ph == 0 ? v : 0u) | ((ph == 1 ? v : 0u) << 16);
    dst[kDwWindows] = (ph == 2 ? v : 0u) | ((ph == 3 ? v : 0u) << 16);
  }
}

// bf16 dw = im2col(x)^T . d: rows (tap, input channel), columns output
// channels, K the 64 pixels of a step in four k16 steps (k16 step ks: conv
// row ks / 2, columns 16 (ks % 2) ..).  Grid: as the fp32 dw kernel.  Warp w
// owns tap row dh = w / 4, input channels 16 ((w / 2) % 2) .. + 16 (one m16
// tile for each of the three taps of the row) by output channels 48 (w % 2)
// .. + 48 (six n8 tiles).  A is the x tile, read transposed (ldmatrix
// .trans) at the tap's shift; B the d tile.  Each k16 step is summed from
// zero and added in fp32 (the tensor core's sum truncates; see mma3_add).
// Dynamic shared memory: two stages of [x kBwX bf16][d kBwD bf16], then the
// block's [gs | gq][kDwCo] float.
__global__ void __launch_bounds__(kDwThreads)
fused_conv2_dw_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ alpha_p,
                           const __nv_bfloat16* __restrict__ g,
                           const __nv_bfloat16* __restrict__ out,
                           const unsigned char* __restrict__ code,
                           const float* __restrict__ gs, const float* __restrict__ gq,
                           float* __restrict__ partials, int bsz, int cin, int cout, int h,
                           int w) {
  constexpr int kStage = 2 * (kBwX + kBwD);  // bytes
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int h2 = h / 2, w2 = w / 2;
  const int n_cot = (cout + kDwCo - 1) / kDwCo;
  const int ci0 = (blockIdx.x / n_cot) * kDwCi;
  const int co0 = (blockIdx.x % n_cot) * kDwCo;
  const int n_jt = (w2 + kDwWindows - 1) / kDwWindows;
  const int steps = bsz * h2 * n_jt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane >> 2, tl = lane & 3;
  const int dh = warp >> 2, ch = (warp >> 1) & 1, nh = warp & 1;
  const float alpha = alpha_p[0];
  const unsigned short* xu = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* gu = reinterpret_cast<const unsigned short*>(g);
  const unsigned short* ou = reinterpret_cast<const unsigned short*>(out);

  float acc[3][6][4];  // [dw][n tile][fragment]
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int f = 0; f < 6; ++f)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[dw][f][k] = 0.f;

  float* gsq = reinterpret_cast<float*>(smem_b + 2 * kStage);
  for (int k = threadIdx.x; k < 2 * kDwCo; k += kDwThreads) {
    const int co = min(co0 + (k % kDwCo), cout - 1);
    gsq[k] = k < kDwCo ? gs[co] : gq[co];
  }
  BwX xr;
  BwRaw dr;
  int s = blockIdx.y;
  {
    const int jt = s % n_jt, i = (s / n_jt) % h2, b = s / (n_jt * h2);
    bw_load_x(xr, xu, b, i, jt * kDwWindows, ci0, cin, h, w);
    bw_load_d(dr, gu, ou, code, b, i, jt * kDwWindows, co0, cout, h2, w2);
    __syncthreads();  // gsq
    bw_store_x(smem_b, xr);
    bw_store_d(smem_b + 2 * kBwX, dr, gsq, alpha, jt * kDwWindows, co0, cout, w2);
    __syncthreads();
  }
  // ldmatrix rows.  A (x, transposed): lane l gives pixel l % 8 + 8 ((l /
  // 16) % 2) of the k16 step, channels 16 ch + 8 ((l / 8) % 2) ..  B (d):
  // channel 48 nh + l % 8 + 8 (l / 16) (+ 16 for the next pair of n8 tiles),
  // pixels 8 ((l / 8) % 2) ..
  const unsigned a_off =
      (((lane & 7) + 8 * ((lane >> 4) & 1)) * kBwPos + 16 * ch + 8 * ((lane >> 3) & 1)) * 2;
  const unsigned b_off =
      ((48 * nh + (lane & 7) + 8 * (lane >> 4)) * kBwDRow + 8 * ((lane >> 3) & 1)) * 2;
  for (int buf = 0; s < steps; s += gridDim.y, buf ^= 1) {
    const unsigned char* cur = smem_b + buf * kStage;
    unsigned char* nxt = smem_b + (buf ^ 1) * kStage;
    const int sn = s + gridDim.y;
    const bool more = sn < steps;
    const int jt = sn % n_jt, ni = (sn / n_jt) % h2, nb = sn / (n_jt * h2);
    if (more) {
      bw_load_x(xr, xu, nb, ni, jt * kDwWindows, ci0, cin, h, w);
      bw_load_d(dr, gu, ou, code, nb, ni, jt * kDwWindows, co0, cout, h2, w2);
    }
    const unsigned xs = smem_addr(cur) + a_off;
    const unsigned ds = smem_addr(cur + 2 * kBwX) + b_off;
#pragma unroll
    for (int ks = 0; ks < kDwPix / 16; ++ks) {
      unsigned bq[3][4];  // n8 tiles 2m, 2m + 1: (b0, b1), (b0, b1)
#pragma unroll
      for (int m = 0; m < 3; ++m) ldsm_x4(bq[m], ds + (16 * m * kBwDRow + 16 * ks) * 2);
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        unsigned a[4];
        ldsm_x4_trans(a, xs + (((ks >> 1) + dh) * kDwXW + 16 * (ks & 1) + dw) * kBwPos * 2);
#pragma unroll
        for (int f = 0; f < 6; ++f) {
          float t[4];
          mma_bf16_zero(t, a, bq[f >> 1][2 * (f & 1)], bq[f >> 1][2 * (f & 1) + 1]);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[dw][f][k] += t[k];
        }
      }
    }
    if (more) {
      bw_store_x(nxt, xr);
      bw_store_d(nxt + 2 * kBwX, dr, gsq, alpha, jt * kDwWindows, co0, cout, w2);
    }
    __syncthreads();
  }

  // C fragment: (input channel gl | gl + 8, output channel 2 tl | 2 tl + 1)
  float* dst = partials + static_cast<size_t>(blockIdx.y) * 9 * cin * cout;
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int f = 0; f < 6; ++f)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ci = ci0 + 16 * ch + gl + 8 * (k >> 1);
        const int co = co0 + 48 * nh + 8 * f + 2 * tl + (k & 1);
        if (ci < cin && co < cout)
          dst[(static_cast<size_t>(dh * 3 + dw) * cin + ci) * cout + co] = acc[dw][f][k];
      }
}

// ---------------------------------------------------------------- launches

// Raise a kernel's dynamic shared memory cap to what this launch asks.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int NC>
cudaError_t launch_fwd(const float* x, const float* wk, const float* corr,
                       const float* alpha, float* out, unsigned char* code,
                       float* stat_partials, int cin, int cin_pad, int cout,
                       int h, int w, dim3 grid, int threads, int smem,
                       cudaStream_t s) {
  cudaError_t err = allow_smem(fused_conv2_fwd_kernel<NC>, smem);
  if (err != cudaSuccess) return err;
  fused_conv2_fwd_kernel<NC><<<grid, threads, smem, s>>>(
      x, wk, corr, alpha, out, code, stat_partials, cin, cin_pad, cout, h, w);
  return cudaGetLastError();
}

template <int kNF>
cudaError_t launch_fwd_bf16(const void* x, const void* wf, const float* corr,
                            const float* alpha, void* out, unsigned char* code,
                            float* stat_partials, int cin, int cout, int h, int w, dim3 grid,
                            int smem, cudaStream_t s) {
  cudaError_t err = allow_smem(fused_conv2_fwd_bf16_kernel<kNF>, smem);
  if (err != cudaSuccess) return err;
  fused_conv2_fwd_bf16_kernel<kNF><<<grid, kBfThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint2*>(wf), corr, alpha,
      static_cast<__nv_bfloat16*>(out), code, stat_partials, cin, cout, h, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_small(const void* x, const float* wk, const float* corr,
                         const float* alpha, const void* g, const void* out,
                         const unsigned char* code, const float* gs,
                         const float* gq, float* dcorr, float* dalpha_partials,
                         int bsz, int cin, int cout, int h, int w, int blocks,
                         cudaStream_t s) {
  fused_conv2_small_kernel<T><<<blocks, kMaxThreads, 0, s>>>(
      static_cast<const T*>(x), wk, corr, alpha, static_cast<const T*>(g),
      static_cast<const T*>(out), code, gs, gq, dcorr, dalpha_partials, bsz,
      cin, cout, h, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every launcher returns the cudaError_t of its launch (0 on success).

// float32; nc is the number of channels a forward thread owns: 8 or 12.
int fused_conv2_fwd_launch(const void* x, const void* wk, const void* corr,
                           const void* alpha, void* out, void* code,
                           void* stat_partials, int cin, int cin_pad, int cout,
                           int h, int w, int nc, int grid_x, int grid_y, int threads,
                           int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wk);
  const float* cf = static_cast<const float*>(corr);
  const float* af = static_cast<const float*>(alpha);
  float* of = static_cast<float*>(out);
  unsigned char* cd = static_cast<unsigned char*>(code);
  float* sp = static_cast<float*>(stat_partials);
  err = nc == 12 ? launch_fwd<12>(xf, wf, cf, af, of, cd, sp, cin, cin_pad, cout, h, w, grid,
                                  threads, smem_bytes, s)
                 : launch_fwd<8>(xf, wf, cf, af, of, cd, sp, cin, cin_pad, cout, h, w, grid,
                                 threads, smem_bytes, s);
  return static_cast<int>(err);
}

// bf16; nf is the number of n8 tiles a warp owns: 2, 4, 6 or 8 (N tiles of
// 32, 64, 96 or 128 output channels).
int fused_conv2_fwd_bf16_launch(const void* x, const void* wf, const void* corr,
                                const void* alpha, void* out, void* code,
                                void* stat_partials, int cin, int cout, int h, int w,
                                int nf, int grid_x, int grid_y, int smem_bytes, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  const float* cf = static_cast<const float*>(corr);
  const float* af = static_cast<const float*>(alpha);
  unsigned char* cd = static_cast<unsigned char*>(code);
  float* sp = static_cast<float*>(stat_partials);
  switch (nf) {
    case 2:
      err = launch_fwd_bf16<2>(x, wf, cf, af, out, cd, sp, cin, cout, h, w, grid, smem_bytes, s);
      break;
    case 4:
      err = launch_fwd_bf16<4>(x, wf, cf, af, out, cd, sp, cin, cout, h, w, grid, smem_bytes, s);
      break;
    case 6:
      err = launch_fwd_bf16<6>(x, wf, cf, af, out, cd, sp, cin, cout, h, w, grid, smem_bytes, s);
      break;
    case 8:
      err = launch_fwd_bf16<8>(x, wf, cf, af, out, cd, sp, cin, cout, h, w, grid, smem_bytes, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

int fused_conv2_dx_launch(const void* wdx, const void* alpha, const void* g,
                          const void* out, const void* code, const void* gs,
                          const void* gq, void* dx, int cin, int cout,
                          int cout_pad, int h, int w, int is_bf16, int grid_x,
                          int grid_y, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  const float* af = static_cast<const float*>(alpha);
  const unsigned char* cd = static_cast<const unsigned char*>(code);
  const float* gsf = static_cast<const float*>(gs);
  const float* gqf = static_cast<const float*>(gq);
  if (is_bf16) {
    err = allow_smem(fused_conv2_dx_bf16_kernel, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_conv2_dx_bf16_kernel<<<grid, kDxThreads, smem_bytes, s>>>(
        static_cast<const uint2*>(wdx), af, static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(out), cd, gsf, gqf,
        static_cast<__nv_bfloat16*>(dx), cin, cout, h, w);
  } else {
    err = allow_smem(fused_conv2_dx_kernel, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_conv2_dx_kernel<<<grid, kDxThreads, smem_bytes, s>>>(
        static_cast<const float*>(wdx), af, static_cast<const float*>(g),
        static_cast<const float*>(out), cd, gsf, gqf, static_cast<float*>(dx), cin, cout,
        cout_pad, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_conv2_dw_launch(const void* x, const void* alpha, const void* g,
                          const void* out, const void* code, const void* gs,
                          const void* gq, void* partials, int bsz, int cin,
                          int cout, int h, int w, int is_bf16, int tiles,
                          int splits, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, splits);
  const float* af = static_cast<const float*>(alpha);
  const unsigned char* cd = static_cast<const unsigned char*>(code);
  const float* gsf = static_cast<const float*>(gs);
  const float* gqf = static_cast<const float*>(gq);
  float* pf = static_cast<float*>(partials);
  if (is_bf16) {
    err = allow_smem(fused_conv2_dw_bf16_kernel, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_conv2_dw_bf16_kernel<<<grid, kDwThreads, smem_bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), af, static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(out), cd, gsf, gqf, pf, bsz, cin, cout, h, w);
  } else {
    err = allow_smem(fused_conv2_dw_kernel, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_conv2_dw_kernel<<<grid, kDwThreads, smem_bytes, s>>>(
        static_cast<const float*>(x), af, static_cast<const float*>(g),
        static_cast<const float*>(out), cd, gsf, gqf, pf, bsz, cin, cout, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_conv2_small_launch(const void* x, const void* wk, const void* corr,
                             const void* alpha, const void* g, const void* out,
                             const void* code, const void* gs, const void* gq,
                             void* dcorr, void* dalpha_partials, int bsz,
                             int cin, int cout, int h, int w, int is_bf16,
                             int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(wk);
  const float* cf = static_cast<const float*>(corr);
  const float* af = static_cast<const float*>(alpha);
  const unsigned char* cd = static_cast<const unsigned char*>(code);
  const float* gsf = static_cast<const float*>(gs);
  const float* gqf = static_cast<const float*>(gq);
  float* dc = static_cast<float*>(dcorr);
  float* dap = static_cast<float*>(dalpha_partials);
  err = is_bf16 ? launch_small<__nv_bfloat16>(x, wf, cf, af, g, out, cd, gsf, gqf,
                                              dc, dap, bsz, cin, cout, h, w, blocks, s)
                : launch_small<float>(x, wf, cf, af, g, out, cd, gsf, gqf, dc, dap,
                                      bsz, cin, cout, h, w, blocks, s);
  return static_cast<int>(err);
}

const char* fused_conv2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
