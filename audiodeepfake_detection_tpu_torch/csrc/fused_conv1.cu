// First DCNN block in one pass: conv2d(1 -> C, 3x3, zero pad 2) + bias ->
// PReLU (one slope) -> floor-mode 2x2 max-pool, forward and backward.
//
//   x [B, H, W] (f32 or bf16), w [9, C], b [C], alpha [1] (f32)
//     -> out [B, h2, w2, C] (x's type), h2 = (H + 2) / 2, w2 = (W + 2) / 2
//   training forward also: a selection code per output element
//     (pool phase | negative << 2, one byte) and per-block partial
//     per-channel (sum, sumsq) of the rounded stored output;
//   backward: per-block partials of dW [9, C], db [C] and dalpha.
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/fused_conv1.py::
// _fwd_master and ::_bwd_kernel (reached through fused_conv1_prelu_pool and
// fused_conv1_prelu_pool_stats).  Those kernels split the image into four
// parity phases outside the kernel, materialised 36 tap planes in scratch,
// ran a block-diagonal [4C, 36] matmul per row and stored [B, h2, C, w2] for
// a later transpose; all of that served the TPU's matrix unit and lane
// layout and is not carried over.  Kept: what is computed, and what stays
// out of device memory -- the pre-pool activation [B, H+2, W+2, C] (four
// times the output) in the forward, and its gradient in the backward.
//
// What bounds it on the H100: bytes.  At B=128, H=95, W=256, C=64 in f32 the
// training forward reads 12.5 MB and writes 203 MB of output plus 51 MB of
// codes, and does 36 FMAs per output element (3.7 GFLOP): ~79 us of memory
// traffic at 3.35 TB/s against ~55 us of FMA at 67 TFLOP/s -- close to the
// f32 ridge, so the design keeps both small: every input byte is read once
// from device memory (a halo tile of x in shared memory), the output is
// written once, NHWC with channels across neighbouring threads so each
// pixel's C values are one coalesced store, and the 9 taps of a thread's
// channel stay in registers.  The backward reads g, out and the code once
// and re-reads the same x tile; it saves the code so that no pooling
// decision is ever recomputed.
//
// Cross-block reductions: Hopper's blocks run in any order, so nothing is
// accumulated across blocks here, and no atomics are used.  Each block
// reduces its own threads in a fixed order in shared memory and writes one
// row of partials; the wrapper sums the rows with one torch.sum, which is
// deterministic.  BatchNorm moments and gradients are therefore bit-for-bit
// reproducible from run to run.
//
// Thread layout: a block owns one frame's strip of `rows` pooled rows by
// `wt` pooled columns.  threads = groups * C; thread t serves channel
// t % C for the pixels t / C, t / C + groups, ...  A warp thus holds one
// pixel (C >= 32) and its reads of the x tile are broadcasts.
//
// dalpha is the true sum of conv * g over negative selected elements: the
// backward rebuilds the selected conv value from the 9 tile reads it makes
// for dW anyway, so an exactly-zero slope still receives its gradient (the
// TPU kernel divides by alpha and returns 0 there).
//
// The second kernel pair of this file, fused_conv_mfm_{fwd,bwd}_kernel, is
// the LCNN's first block on the same tiles; its note stands above it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/fused_conv1_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBwdRows = 11;  // 9 dW taps, db, dalpha

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

struct Tile {
  int b, i0, j0;  // frame, first pooled row, first pooled column
};

// Blocks are numbered frame-major, then row strip, then column strip.
__device__ __forceinline__ Tile tile_of_block(int h2, int w2, int rows, int wt) {
  const int n_ct = (w2 + wt - 1) / wt;
  const int n_rt = (h2 + rows - 1) / rows;
  int blk = blockIdx.x;
  Tile t;
  t.j0 = (blk % n_ct) * wt;
  blk /= n_ct;
  t.i0 = (blk % n_rt) * rows;
  t.b = blk / n_rt;
  return t;
}

// Zero-padded tile of one frame in shared memory: padded rows
// [2*i0, 2*i0 + 2*rows + HALO) and padded columns [2*j0, 2*j0 + 2*wt + HALO),
// where padded (r, c) is x[r - 2][c - 2] (both blocks pad by 2) and HALO is
// the kernel size minus one: 2 for the 3x3 block, 4 for the 5x5 one.
template <int HALO, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, float* xs,
                                          Tile t, int h, int w, int rows,
                                          int wt, int stride) {
  const T* frame = x + static_cast<size_t>(t.b) * h * w;
  const int tile_h = 2 * rows + HALO, tile_w = 2 * wt + HALO;
  for (int k = threadIdx.x; k < tile_h * tile_w; k += blockDim.x) {
    const int lr = k / tile_w, lc = k - lr * tile_w;
    const int r = 2 * t.i0 + lr - 2, c = 2 * t.j0 + lc - 2;
    float v = 0.f;
    if (r >= 0 && r < h && c >= 0 && c < w)
      v = to_float(frame[static_cast<size_t>(r) * w + c]);
    xs[lr * stride + lc] = v;
  }
}

// Sum each of a thread's N values over the block's pixel groups in a fixed
// order and write them as partials[blockIdx.x][k][col0 + channel], rows of
// `row_len` floats (c_total threads serve one pixel).
template <int N>
__device__ __forceinline__ void block_reduce_store(const float (&vals)[N],
                                                   float* red,
                                                   float* __restrict__ partials,
                                                   int c_total, int row_len,
                                                   int col0) {
  const int groups = blockDim.x / c_total;
  const int c = threadIdx.x % c_total, pg = threadIdx.x / c_total;
#pragma unroll
  for (int k = 0; k < N; ++k) red[(pg * N + k) * c_total + c] = vals[k];
  __syncthreads();
  if (pg == 0) {
    float* dst =
        partials + static_cast<size_t>(blockIdx.x) * N * row_len + col0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = 0.f;
      for (int g = 0; g < groups; ++g) acc += red[(g * N + k) * c_total + c];
      dst[k * row_len + c] = acc;
    }
  }
}

// Dynamic shared memory: the x tile ((2*rows + 2) * stride floats), then the
// reduction buffer (groups * N * C floats, N = 2 or 11).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv1_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ alpha_p, T* __restrict__ out,
                       unsigned char* __restrict__ code,
                       float* __restrict__ stat_partials, int h, int win,
                       int c_total, int rows, int wt, int stride) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* red = smem + (2 * rows + 2) * stride;
  const int h2 = (h + 2) / 2, w2 = (win + 2) / 2;
  const Tile t = tile_of_block(h2, w2, rows, wt);
  load_tile<2>(x, xs, t, h, win, rows, wt, stride);

  const int c = threadIdx.x % c_total, pg = threadIdx.x / c_total;
  const int groups = blockDim.x / c_total;
  float wk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wk[k] = w[k * c_total + c];
  const float bc = bias[c];
  const float alpha = alpha_p[0];
  __syncthreads();

  float stats[2] = {0.f, 0.f};
  for (int p = pg; p < rows * wt; p += groups) {
    const int li = p / wt, lj = p - li * wt;
    const int gi = t.i0 + li, gj = t.j0 + lj;
    if (gi >= h2 || gj >= w2) continue;
    // the 4x4 patch under this pool window: conv (2gi+a, 2gj+b), tap
    // (dh, dw) reads patch[a + dh][b + dw]
    const float* base = xs + (2 * li) * stride + 2 * lj;
    float patch[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) patch[r][q] = base[r * stride + q];
    float best = 0.f, best_pre = 0.f;
    int best_ph = 0;
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      const int a = ph >> 1, b = ph & 1;
      float conv = bc;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw)
          conv = fmaf(wk[dh * 3 + dw], patch[a + dh][b + dw], conv);
      const float act = conv >= 0.f ? conv : alpha * conv;
      // strict >: ties keep the first phase of (0,0),(0,1),(1,0),(1,1)
      if (ph == 0 || act > best) {
        best = act;
        best_pre = conv;
        best_ph = ph;
      }
    }
    const size_t o =
        ((static_cast<size_t>(t.b) * h2 + gi) * w2 + gj) * c_total + c;
    T stored;
    from_float(best, &stored);
    out[o] = stored;
    if (code != nullptr)
      code[o] = static_cast<unsigned char>(best_ph | ((best_pre < 0.f) << 2));
    if (stat_partials != nullptr) {
      const float rounded = to_float(stored);  // what a later pass would read
      stats[0] += rounded;
      stats[1] = fmaf(rounded, rounded, stats[1]);
    }
  }
  if (stat_partials != nullptr)
    block_reduce_store(stats, red, stat_partials, c_total, c_total, 0);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv1_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ alpha_p,
                       const T* __restrict__ g, const T* __restrict__ out,
                       const unsigned char* __restrict__ code,
                       const float* __restrict__ gs,
                       const float* __restrict__ gq,
                       float* __restrict__ partials, int h, int win,
                       int c_total, int rows, int wt, int stride) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* red = smem + (2 * rows + 2) * stride;
  const int h2 = (h + 2) / 2, w2 = (win + 2) / 2;
  const Tile t = tile_of_block(h2, w2, rows, wt);
  load_tile<2>(x, xs, t, h, win, rows, wt, stride);

  const int c = threadIdx.x % c_total, pg = threadIdx.x / c_total;
  const int groups = blockDim.x / c_total;
  float wk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wk[k] = w[k * c_total + c];
  const float bc = bias[c];
  const float alpha = alpha_p[0];
  // cotangents of the per-channel (sum, sumsq) outputs fold into g
  const float gsc = gs != nullptr ? gs[c] : 0.f;
  const float gqc = gq != nullptr ? gq[c] : 0.f;
  __syncthreads();

  float acc[kBwdRows];
#pragma unroll
  for (int k = 0; k < kBwdRows; ++k) acc[k] = 0.f;
  for (int p = pg; p < rows * wt; p += groups) {
    const int li = p / wt, lj = p - li * wt;
    const int gi = t.i0 + li, gj = t.j0 + lj;
    if (gi >= h2 || gj >= w2) continue;
    const size_t o =
        ((static_cast<size_t>(t.b) * h2 + gi) * w2 + gj) * c_total + c;
    const int cd = code[o];
    const int ph = cd & 3;
    const bool neg = cd >= 4;
    const float gt =
        to_float(g[o]) + gsc + 2.f * to_float(out[o]) * gqc;
    const float d = neg ? alpha * gt : gt;  // through PReLU, selected phase
    const float* base =
        xs + (2 * li + (ph >> 1)) * stride + 2 * lj + (ph & 1);
    float conv = bc;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const float xv = base[dh * stride + dw];
        acc[dh * 3 + dw] = fmaf(d, xv, acc[dh * 3 + dw]);
        conv = fmaf(wk[dh * 3 + dw], xv, conv);
      }
    acc[9] += d;
    if (neg) acc[10] = fmaf(conv, gt, acc[10]);
  }
  block_reduce_store(acc, red, partials, c_total, c_total, 0);
}

// ---------------------------------------------------------------------------
// First LCNN block in one pass: conv2d(1 -> C, 5x5, zero pad 2) + bias ->
// MaxFeatureMap (maximum of channel k and channel k + C/2) -> floor-mode 2x2
// max-pool, forward and backward.
//
//   x [B, H, W] (f32 or bf16), w [25, C], b [C] (f32)
//     -> out, stored [B, C/2, H/2, W/2] (NCHW; x's type)
//   training forward also: a selection code per output element, stored like
//     out, the index phase * 2 + half of the FIRST maximal candidate among
//     the eight (phase (0,0), (0,1), (1,0), (1,1)) x (half k, k + C/2);
//   backward: per-block partials of dW [25, C] and db [C] from (g, code),
//     g stored like out.
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/fused_conv1.py::
// _fwd_mfm_kernel and ::_bwd_mfm_kernel (reached through
// fused_conv_mfm_pool).  Their parity-phase planes, the 100 tap planes in
// scratch and the block-diagonal [4C, 100] products served the TPU's matrix
// unit and are not carried over.  Kept: what is computed, the first-match
// tie-break, and what stays out of device memory -- the pre-pool conv output
// [B, C, H, W] (eight times the block's output) and its gradient.  The
// output is stored NCHW because the convolutions behind the block (cuDNN)
// read NCHW: the wrapper hands it out as a [B, H/2, W/2, C/2] view, so no
// transposing copy follows the block in either direction.
//
// What bounds it on the H100: operations, in the forward.  At B=128, H=101,
// W=256, C=64 in f32 it reads 13 MB and writes 105 MB of output plus 26 MB of
// codes (~43 us at 3.35 TB/s) but every stored value is the maximum of eight
// 25-tap sums: 200 FMAs per output, 10.5 GFLOP, ~157 us at 67 TFLOP/s.  So
// the forward's inner loop is FMAs and little else: a thread owns one pool
// window, holds the 6x6 patch of x under it in registers (read once from the
// shared halo tile as aligned float2s; neighbouring lanes own neighbouring
// windows of a row, so the reads are conflict-free), and walks the channel
// pairs: the 50 taps and 2 biases of pair k are 13 float4 reads of a shared
// copy of w and b that every lane of the warp reads at once (broadcasts), 13
// loads for 200 FMAs.  Stores run along the window's row: coalesced.  Each
// conv value is the bias, then fmaf over the taps with dh ascending and dw
// ascending inside it; candidates are compared phase-major, lower half
// first, with a strict >, so out and code do not depend on the tiling.
//
// The backward is bound by bytes (g, code and x read once, ~43 us) in
// principle; in practice by issue: per window and channel pair it makes 25
// shared-memory reads and 50 FMAs.  A thread owns the channel pair (k,
// k + C/2): for each window it takes the code and g of its pair, reads the
// 25 x values under the selected phase (the warp's lanes read at most four
// addresses of the tile, in distinct banks) and adds g * x to the selected
// half's taps.  Both halves' sums live in registers (predicated, no indexed
// local memory) and leave the block as two reductions of 26 rows.  g and the
// codes are NCHW in device memory, so the block stages them: chunks of one
// pooled row (whole 512-byte rows of g at the LCNN's shape; dynamic shared
// memory above 48 KB), all channel pairs, copied coalesced along the row by
// 16-byte cp.async (codes: 4-byte) into a ring of two stages, so the next
// chunk's loads fly while this one is summed.  Staged rows of g lie an odd
// number of 16-byte units apart, rows of codes an odd number of words: a
// warp reading four windows of g (one float4) for 32 channel pairs hits
// distinct banks in each quarter warp, and one word of four codes distinct
// banks.  No global load sits on the chain
// from a code to the x address it selects.
//
// As above: nothing is accumulated across blocks and no atomics are used, so
// dW and db are bit-for-bit reproducible.  No gradient for x.

constexpr int kMfmTaps = 25;
constexpr int kMfmRows = 26;        // 25 dW taps, db
constexpr int kMfmPairFloats = 52;  // per channel pair: ba, bb, (wa_i, wb_i)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes between staged rows of `bytes` bytes, in units of `unit`: an odd
// number of units, so that the lanes of a warp reading the same unit of
// consecutive rows hit distinct banks (16-byte units: per quarter warp).
// ops/fused_conv1_cuda.py sizes the ring with the same formula.
__device__ __forceinline__ int mfm_pitch(int bytes, int unit) {
  return unit * (((bytes + unit - 1) / unit) | 1);
}

// One element of a staged row, when its row is not aligned for whole units:
// f32 by 4-byte cp.async, the others by an ordinary load and store.
__device__ __forceinline__ void stage_elem(float* dst, const float* src) {
  cp_async4(dst, src);
}
template <typename E>
__device__ __forceinline__ void stage_elem(E* dst, const E* src) {
  *dst = *src;
}

// Stage `n_rows` rows of n elements, row r from src0 + r * row_step, to
// dst + r * pitch bytes, element j at byte j * sizeof(E): a warp a row, its
// lanes on consecutive units (coalesced).  Where every row starts on a UNIT
// boundary the copies are whole UNIT-byte cp.asyncs (16: g; 4: the codes);
// the last may bring bytes past the row, which lie in the same page and
// are never read.  Otherwise element by element.  Threads of a last,
// partial warp copy nothing.
template <int UNIT, typename E>
__device__ __forceinline__ void stage_rows(const E* src0, size_t row_step,
                                           int n, int n_rows,
                                           unsigned char* dst, int pitch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (warp >= n_warps) return;
  const bool whole = (reinterpret_cast<uintptr_t>(src0) % UNIT) == 0 &&
                     (row_step * sizeof(E)) % UNIT == 0;
  const int units = (n * static_cast<int>(sizeof(E)) + UNIT - 1) / UNIT;
  for (int r = warp; r < n_rows; r += n_warps) {
    const E* src = src0 + r * row_step;
    unsigned char* d = dst + r * pitch;
    if (whole) {
      for (int q = lane; q < units; q += 32) {
        if (UNIT == 16)
          cp_async16(d + 16 * q, reinterpret_cast<const char*>(src) + 16 * q);
        else
          cp_async4(d + 4 * q, reinterpret_cast<const char*>(src) + 4 * q);
      }
    } else {
      for (int j = lane; j < n; j += 32) stage_elem(reinterpret_cast<E*>(d) + j, src + j);
    }
  }
}

// Four consecutive staged elements of g as floats (16 bytes of f32, 8 of
// bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// As block_reduce_store, with C/2 threads a group: each thread's N values
// summed over the block's groups in a fixed order, the N * C/2 sums spread
// over all threads; partials[blockIdx.x][k][col0 + channel], rows of
// `row_len` floats.
template <int N>
__device__ __forceinline__ void mfm_reduce_store(const float (&vals)[N], float* red,
                                                 float* __restrict__ partials,
                                                 int c_half, int row_len, int col0) {
  const int groups = blockDim.x / c_half;
  const int c = threadIdx.x % c_half, pg = threadIdx.x / c_half;
#pragma unroll
  for (int k = 0; k < N; ++k) red[(pg * N + k) * c_half + c] = vals[k];
  __syncthreads();
  float* dst = partials + static_cast<size_t>(blockIdx.x) * N * row_len + col0;
  for (int o = threadIdx.x; o < N * c_half; o += blockDim.x) {
    const int k = o / c_half, cc = o - k * c_half;
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += red[(g * N + k) * c_half + cc];
    dst[k * row_len + cc] = acc;
  }
}

// The zero-padded x tile that load_tile<4> would load, a warp a tile row
// (no division per element): f32 by 4-byte cp.async (a padding element
// reads nothing and lands as zero), bf16 by a widening load.  The caller
// commits the copies to a group and waits for it.
__device__ __forceinline__ void stage_x(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void stage_x(float* dst, const __nv_bfloat16* src, bool in) {
  *dst = in ? __bfloat162float(*src) : 0.f;
}
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, float* xs, Tile t,
                                           int h, int w, int rows, int wt, int stride) {
  const T* frame = x + static_cast<size_t>(t.b) * h * w;
  const int tile_h = 2 * rows + 4, tile_w = 2 * wt + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (warp >= n_warps) return;
  for (int lr = warp; lr < tile_h; lr += n_warps) {
    const int r = 2 * t.i0 + lr - 2;
    const bool row_in = r >= 0 && r < h;
    const T* src = frame + static_cast<size_t>(row_in ? r : 0) * w;
    for (int lc = lane; lc < tile_w; lc += 32) {
      const int c = 2 * t.j0 + lc - 2;
      const bool in = row_in && c >= 0 && c < w;
      stage_x(xs + lr * stride + lc, src + (in ? c : 0), in);
    }
  }
}

// Dynamic shared memory: the channel pairs' biases and taps (C/2 * 52
// floats, 16-byte rows), then the x tile ((2*rows + 4) * stride floats).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv_mfm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, T* __restrict__ out,
                          unsigned char* __restrict__ code, int h, int win,
                          int c_half, int rows, int wt, int stride) {
  extern __shared__ float4 mfm_smem[];
  float* ws = reinterpret_cast<float*>(mfm_smem);
  float* xs = ws + c_half * kMfmPairFloats;
  const int h2 = h / 2, w2 = win / 2;
  const Tile t = tile_of_block(h2, w2, rows, wt);
  const int c_total = 2 * c_half;
  // pair k's row: ba, bb, then wa_i, wb_i for tap i = 0..24
  for (int i = threadIdx.x; i < c_half * kMfmPairFloats; i += blockDim.x) {
    const int k = i / kMfmPairFloats, r = i - k * kMfmPairFloats;
    const int col = (r & 1) ? c_half + k : k;
    ws[i] = r < 2 ? bias[col] : w[((r - 2) >> 1) * c_total + col];
  }
  stage_tile(x, xs, t, h, win, rows, wt, stride);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const size_t plane = static_cast<size_t>(h2) * w2;
  for (int p = threadIdx.x; p < rows * wt; p += blockDim.x) {
    const int li = p / wt, lj = p - li * wt;
    const int gi = t.i0 + li, gj = t.j0 + lj;
    if (gi >= h2 || gj >= w2) continue;
    // the 6x6 patch under this pool window: conv (2gi+a, 2gj+b), tap
    // (dh, dw) reads patch[a + dh][b + dw]; stride and 2*lj are even
    const float* base = xs + (2 * li) * stride + 2 * lj;
    float patch[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float2 v = reinterpret_cast<const float2*>(base + r * stride)[q];
        patch[r][2 * q] = v.x;
        patch[r][2 * q + 1] = v.y;
      }
    const size_t o0 =
        static_cast<size_t>(t.b) * c_half * plane + static_cast<size_t>(gi) * w2 + gj;
#pragma unroll 1
    for (int k = 0; k < c_half; ++k) {
      const float4* wk = reinterpret_cast<const float4*>(ws + k * kMfmPairFloats);
      float tw[kMfmPairFloats];
#pragma unroll
      for (int i = 0; i < kMfmPairFloats / 4; ++i) {
        const float4 v = wk[i];  // the same address in every lane: a broadcast
        tw[4 * i] = v.x;
        tw[4 * i + 1] = v.y;
        tw[4 * i + 2] = v.z;
        tw[4 * i + 3] = v.w;
      }
      float ca[4], cb[4];  // phase ph of channel k and of k + C/2
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        ca[ph] = tw[0];
        cb[ph] = tw[1];
      }
      // each sum keeps its order: the bias, then dh ascending, dw ascending
#pragma unroll
      for (int dh = 0; dh < 5; ++dh)
#pragma unroll
        for (int dw = 0; dw < 5; ++dw) {
          const float wa = tw[2 + 2 * (dh * 5 + dw)], wb = tw[3 + 2 * (dh * 5 + dw)];
#pragma unroll
          for (int ph = 0; ph < 4; ++ph) {
            const float xv = patch[(ph >> 1) + dh][(ph & 1) + dw];
            ca[ph] = fmaf(wa, xv, ca[ph]);
            cb[ph] = fmaf(wb, xv, cb[ph]);
          }
        }
      float best = 0.f;
      int best_idx = 0;
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        // strict >: a tie keeps the earlier candidate, phase-major and the
        // lower half first
        if (ph == 0 || ca[ph] > best) {
          best = ca[ph];
          best_idx = 2 * ph;
        }
        if (cb[ph] > best) {
          best = cb[ph];
          best_idx = 2 * ph + 1;
        }
      }
      const size_t o = o0 + k * plane;
      from_float(best, &out[o]);
      if (code != nullptr) code[o] = static_cast<unsigned char>(best_idx);
    }
  }
}

// Dynamic shared memory: the x tile ((2*rows + 4) * stride floats), then the
// ring of two stages, each C/2 staged rows of g and C/2 of codes; the
// reduction buffer (blockDim * 26 floats) reuses it all once the chunks are
// summed.
// Three blocks an SM (80 registers, no spills): the loop is bound by issue.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 3)
fused_conv_mfm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const unsigned char* __restrict__ code,
                          float* __restrict__ partials, int h, int win,
                          int c_half, int rows, int wt, int stride,
                          int chunk_cols) {
  extern __shared__ float4 mfm_smem[];
  float* xs = reinterpret_cast<float*>(mfm_smem);
  unsigned char* ring = reinterpret_cast<unsigned char*>(xs + (2 * rows + 4) * stride);
  const int g_pitch = mfm_pitch(chunk_cols * static_cast<int>(sizeof(T)), 16);
  const int c_pitch = mfm_pitch(chunk_cols, 4);
  const int stage_bytes = (c_half * (g_pitch + c_pitch) + 15) & ~15;
  const int h2 = h / 2, w2 = win / 2;
  const Tile t = tile_of_block(h2, w2, rows, wt);
  const int n_cols = min(wt, w2 - t.j0);
  const int pieces = (n_cols + chunk_cols - 1) / chunk_cols;
  const int n_chunks = min(rows, h2 - t.i0) * pieces;
  const size_t plane = static_cast<size_t>(h2) * w2;
  // element offset of channel pair 0 at chunk c's first window
  auto chunk_at = [&](int c, int& li, int& col0, int& n) {
    li = c / pieces;
    col0 = (c - li * pieces) * chunk_cols;
    n = min(chunk_cols, n_cols - col0);
    return static_cast<size_t>(t.b) * c_half * plane +
           static_cast<size_t>(t.i0 + li) * w2 + t.j0 + col0;
  };
  auto issue = [&](int c) {
    int li, col0, n;
    const size_t e0 = chunk_at(c, li, col0, n);
    unsigned char* st = ring + (c & 1) * stage_bytes;
    stage_rows<16>(g + e0, plane, n, c_half, st, g_pitch);
    stage_rows<4>(code + e0, plane, n, c_half, st + c_half * g_pitch, c_pitch);
    cp_async_commit();
  };
  stage_tile(x, xs, t, h, win, rows, wt, stride);
  issue(0);  // one group: the x tile and chunk 0

  const int k = threadIdx.x % c_half, pg = threadIdx.x / c_half;
  const int groups = blockDim.x / c_half;
  float acc_a[kMfmRows], acc_b[kMfmRows];  // channel k, channel k + C/2
#pragma unroll
  for (int i = 0; i < kMfmRows; ++i) acc_a[i] = acc_b[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; chunk c - 1's stage is free
    if (c + 1 < n_chunks) issue(c + 1);
    int li, col0, n;
    (void)chunk_at(c, li, col0, n);
    const unsigned char* st = ring + (c & 1) * stage_bytes;
    const T* gk = reinterpret_cast<const T*>(st + k * g_pitch);
    const unsigned* ck =
        reinterpret_cast<const unsigned*>(st + c_half * g_pitch + k * c_pitch);
    const float* row = xs + (2 * li) * stride + 2 * col0;
    // four windows a step: one 16-byte (bf16: 8-byte) read of g and one
    // word of codes serve them
    for (int q = pg; 4 * q < n; q += groups) {
      float4 g4 = load4(gk + 4 * q);
      unsigned c4 = ck[q];
#pragma unroll
      for (int j = 4 * q; j < min(4 * q + 4, n); ++j) {
        const int cd = c4 & 0xff;
        const int ph = cd >> 1;
        const float gv = g4.x;
        c4 >>= 8;  // the next window's code and cotangent move to the front
        g4 = make_float4(g4.y, g4.z, g4.w, 0.f);
        // the cotangent goes to the selected half alone
        const float da = (cd & 1) ? 0.f : gv;
        const float db = (cd & 1) ? gv : 0.f;
        const float* base = row + (ph >> 1) * stride + 2 * j + (ph & 1);
#pragma unroll
        for (int dh = 0; dh < 5; ++dh)
#pragma unroll
          for (int dw = 0; dw < 5; ++dw) {
            const float xv = base[dh * stride + dw];
            acc_a[dh * 5 + dw] = fmaf(da, xv, acc_a[dh * 5 + dw]);
            acc_b[dh * 5 + dw] = fmaf(db, xv, acc_b[dh * 5 + dw]);
          }
        acc_a[kMfmTaps] += da;
        acc_b[kMfmTaps] += db;
      }
    }
  }
  __syncthreads();  // every stage is read before the reduction reuses it
  float* red = reinterpret_cast<float*>(mfm_smem);
  // partials [blocks, 26, C]: columns [0, C/2) then [C/2, C), one buffer
  mfm_reduce_store(acc_a, red, partials, c_half, 2 * c_half, 0);
  __syncthreads();
  mfm_reduce_store(acc_b, red, partials, c_half, 2 * c_half, c_half);
}

// Column sums of the backward's partials [n_rows, 26 * C] in a fixed order
// (warp w adds rows w, w + 32, ... of its block's 32 columns; then warp 0
// adds the 32 warps' sums in order): dW [25, C] and db [C], bit-equal from
// run to run.  One launch beside the backward, where torch.sum and two
// slices would cost the host more than the sum costs the card.
constexpr int kSumWarps = 32;

__global__ void __launch_bounds__(32 * kSumWarps)
fused_conv_mfm_sum_kernel(const float* __restrict__ partials, int n_rows, int cols,
                        float* __restrict__ dw, float* __restrict__ db, int n_dw) {
  __shared__ float red[kSumWarps][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < cols) {
#pragma unroll 8
    for (int r = warp; r < n_rows; r += kSumWarps)
      acc += partials[static_cast<size_t>(r) * cols + col];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float sum = 0.f;
    for (int w = 0; w < kSumWarps; ++w) sum += red[w][lane];
    if (col < n_dw)
      dw[col] = sum;
    else
      db[col - n_dw] = sum;
  }
}

}  // namespace

extern "C" {

const char* fused_conv1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward on `stream`, no synchronisation; returns cudaGetLastError().
// `code` and `stat_partials` may be null (inference: neither is produced).
// Grid: batch * ceil(h2 / rows) * ceil(w2 / wt) blocks of `threads`.
int fused_conv1_fwd_launch(const void* x, const float* w, const float* bias,
                           const float* alpha, void* out, unsigned char* code,
                           float* stat_partials, int h, int win, int c_total,
                           int is_bf16, int rows, int wt, int stride,
                           int threads, int blocks, int smem_bytes, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_conv1_fwd_kernel<__nv_bfloat16><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, bias, alpha,
        static_cast<__nv_bfloat16*>(out), code, stat_partials, h, win, c_total,
        rows, wt, stride);
  } else {
    fused_conv1_fwd_kernel<float><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const float*>(x), w, bias, alpha, static_cast<float*>(out),
        code, stat_partials, h, win, c_total, rows, wt, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`; `gs` / `gq` may be null (no moment cotangents).
// Writes partials [blocks, 11, C]: rows 0-8 dW taps, 9 db, 10 dalpha.
int fused_conv1_bwd_launch(const void* x, const float* w, const float* bias,
                           const float* alpha, const void* g, const void* out,
                           const unsigned char* code, const float* gs,
                           const float* gq, float* partials, int h, int win,
                           int c_total, int is_bf16, int rows, int wt,
                           int stride, int threads, int blocks, int smem_bytes,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_conv1_bwd_kernel<__nv_bfloat16><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, bias, alpha,
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(out), code, gs, gq, partials, h, win,
        c_total, rows, wt, stride);
  } else {
    fused_conv1_bwd_kernel<float><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const float*>(x), w, bias, alpha,
        static_cast<const float*>(g), static_cast<const float*>(out), code, gs,
        gq, partials, h, win, c_total, rows, wt, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// MFM block forward on `stream`; `code` may be null (no parameter needs a
// gradient).  out and code are stored [B, C/2, H/2, W/2].  Grid: batch *
// ceil((H/2) / rows) * ceil((W/2) / wt) blocks of `threads`.
int fused_conv_mfm_fwd_launch(const void* x, const float* w, const float* bias,
                              void* out, unsigned char* code, int h, int win,
                              int c_half, int is_bf16, int rows, int wt,
                              int stride, int threads, int blocks,
                              int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_conv_mfm_fwd_kernel<__nv_bfloat16>
        <<<blocks, threads, smem_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(x), w, bias,
            static_cast<__nv_bfloat16*>(out), code, h, win, c_half, rows, wt,
            stride);
  } else {
    fused_conv_mfm_fwd_kernel<float><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const float*>(x), w, bias, static_cast<float*>(out), code,
        h, win, c_half, rows, wt, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// MFM block backward on `stream`; g and code stored [B, C/2, H/2, W/2].
// Writes per-block partials [blocks, 26, C] (rows 0-24 dW taps, 25 db) to
// the scratch `partials`, then their sums to dw [25, C] and db [C].
int fused_conv_mfm_bwd_launch(const void* x, const void* g,
                              const unsigned char* code, float* partials,
                              float* dw, float* db, int h, int win, int c_half,
                              int is_bf16, int rows, int wt, int stride,
                              int chunk_cols, int threads, int blocks,
                              int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes > 48 * 1024) {
    err = is_bf16 ? cudaFuncSetAttribute(fused_conv_mfm_bwd_kernel<__nv_bfloat16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes)
                  : cudaFuncSetAttribute(fused_conv_mfm_bwd_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (is_bf16) {
    fused_conv_mfm_bwd_kernel<__nv_bfloat16>
        <<<blocks, threads, smem_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), code, partials, h, win,
            c_half, rows, wt, stride, chunk_cols);
  } else {
    fused_conv_mfm_bwd_kernel<float><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), code,
        partials, h, win, c_half, rows, wt, stride, chunk_cols);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = kMfmRows * 2 * c_half;
  fused_conv_mfm_sum_kernel<<<(cols + 31) / 32, 32 * kSumWarps, 0, s>>>(
      partials, blocks, cols, dw, db, kMfmTaps * 2 * c_half);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
