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
// the LCNN's first block built on the same plan; its note stands above it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/fused_conv1_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
//     -> out [B, H/2, W/2, C/2] (x's type)
//   training forward also: a selection code per output element, the index
//     phase * 2 + half of the FIRST maximal candidate among the eight
//     (phase (0,0), (0,1), (1,0), (1,1)) x (half k, k + C/2), one byte;
//   backward: per-block partials of dW [25, C] and db [C] from (g, code).
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/fused_conv1.py::
// _fwd_mfm_kernel and ::_bwd_mfm_kernel (reached through
// fused_conv_mfm_pool).  Their parity-phase planes, the 100 tap planes in
// scratch and the block-diagonal [4C, 100] products served the TPU's matrix
// unit and are not carried over.  Kept: what is computed, the first-match
// tie-break, and what stays out of device memory -- the pre-pool conv output
// [B, H, W, C] (eight times the block's output) and its gradient.
//
// What bounds it on the H100: operations, in the forward.  At B=128, H=101,
// W=256, C=64 in f32 it reads 13 MB and writes 105 MB of output plus 26 MB of
// codes (~43 us at 3.35 TB/s) but every stored value is the maximum of eight
// 25-tap sums: 200 FMAs per output, 10.5 GFLOP, ~157 us at 67 TFLOP/s.  The
// design therefore keeps the inner loop free of everything but FMAs: a
// thread owns the channel pair (k, k + C/2) with its 50 taps and 2 biases in
// registers, reads the 6x6 patch of x under a pool window from the shared
// halo tile once (36 reads, warp broadcasts when C/2 >= 32) and feeds all
// eight candidates from it.  The backward is bound by bytes (g, code and x
// read once, ~43 us): it reads the 25 x values under the selected phase and
// adds g * x to the selected half's taps; both halves' sums live in
// registers (predicated, no indexed local memory) and leave the block as two
// reductions of 26 rows that reuse one shared buffer.
//
// As above: nothing is accumulated across blocks and no atomics are used, so
// dW and db are bit-for-bit reproducible.  No gradient for x.

constexpr int kMfmTaps = 25;
constexpr int kMfmRows = 26;  // 25 dW taps, db

// Dynamic shared memory: the x tile ((2*rows + 4) * stride floats); the
// backward adds the reduction buffer (groups * 26 * C/2 floats).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv_mfm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, T* __restrict__ out,
                          unsigned char* __restrict__ code, int h, int win,
                          int c_half, int rows, int wt, int stride) {
  extern __shared__ float smem[];
  float* xs = smem;
  const int h2 = h / 2, w2 = win / 2;
  const Tile t = tile_of_block(h2, w2, rows, wt);
  load_tile<4>(x, xs, t, h, win, rows, wt, stride);

  const int k = threadIdx.x % c_half, pg = threadIdx.x / c_half;
  const int groups = blockDim.x / c_half;
  const int c_total = 2 * c_half;
  float wa[kMfmTaps], wb[kMfmTaps];  // taps of channel k and of k + C/2
#pragma unroll
  for (int i = 0; i < kMfmTaps; ++i) {
    wa[i] = w[i * c_total + k];
    wb[i] = w[i * c_total + c_half + k];
  }
  const float ba = bias[k], bb = bias[c_half + k];
  __syncthreads();

  for (int p = pg; p < rows * wt; p += groups) {
    const int li = p / wt, lj = p - li * wt;
    const int gi = t.i0 + li, gj = t.j0 + lj;
    if (gi >= h2 || gj >= w2) continue;
    // the 6x6 patch under this pool window: conv (2gi+a, 2gj+b), tap
    // (dh, dw) reads patch[a + dh][b + dw]
    const float* base = xs + (2 * li) * stride + 2 * lj;
    float patch[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int q = 0; q < 6; ++q) patch[r][q] = base[r * stride + q];
    float best = 0.f;
    int best_idx = 0;
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      const int a = ph >> 1, b = ph & 1;
      float ca = ba, cb = bb;
#pragma unroll
      for (int dh = 0; dh < 5; ++dh)
#pragma unroll
        for (int dw = 0; dw < 5; ++dw) {
          const float xv = patch[a + dh][b + dw];
          ca = fmaf(wa[dh * 5 + dw], xv, ca);
          cb = fmaf(wb[dh * 5 + dw], xv, cb);
        }
      // strict >: a tie keeps the earlier candidate, phase-major and the
      // lower half first
      if (ph == 0 || ca > best) {
        best = ca;
        best_idx = 2 * ph;
      }
      if (cb > best) {
        best = cb;
        best_idx = 2 * ph + 1;
      }
    }
    const size_t o =
        ((static_cast<size_t>(t.b) * h2 + gi) * w2 + gj) * c_half + k;
    from_float(best, &out[o]);
    if (code != nullptr) code[o] = static_cast<unsigned char>(best_idx);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv_mfm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const unsigned char* __restrict__ code,
                          float* __restrict__ partials, int h, int win,
                          int c_half, int rows, int wt, int stride) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* red = smem + (2 * rows + 4) * stride;
  const int h2 = h / 2, w2 = win / 2;
  const Tile t = tile_of_block(h2, w2, rows, wt);
  load_tile<4>(x, xs, t, h, win, rows, wt, stride);

  const int k = threadIdx.x % c_half, pg = threadIdx.x / c_half;
  const int groups = blockDim.x / c_half;
  __syncthreads();

  float acc_a[kMfmRows], acc_b[kMfmRows];  // channel k, channel k + C/2
#pragma unroll
  for (int i = 0; i < kMfmRows; ++i) acc_a[i] = acc_b[i] = 0.f;
  for (int p = pg; p < rows * wt; p += groups) {
    const int li = p / wt, lj = p - li * wt;
    const int gi = t.i0 + li, gj = t.j0 + lj;
    if (gi >= h2 || gj >= w2) continue;
    const size_t o =
        ((static_cast<size_t>(t.b) * h2 + gi) * w2 + gj) * c_half + k;
    const int cd = code[o];
    const int ph = cd >> 1;
    const float gv = to_float(g[o]);
    // the cotangent goes to the selected half alone
    const float da = (cd & 1) ? 0.f : gv;
    const float db = (cd & 1) ? gv : 0.f;
    const float* base =
        xs + (2 * li + (ph >> 1)) * stride + 2 * lj + (ph & 1);
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
  // partials [blocks, 26, C]: columns [0, C/2) then [C/2, C), one buffer
  block_reduce_store(acc_a, red, partials, c_half, 2 * c_half, 0);
  __syncthreads();
  block_reduce_store(acc_b, red, partials, c_half, 2 * c_half, c_half);
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
// gradient).  Grid: batch * ceil((H/2) / rows) * ceil((W/2) / wt) blocks of
// `threads` = groups * C/2.
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

// MFM block backward on `stream`.  Writes partials [blocks, 26, C]: rows
// 0-24 dW taps, 25 db.
int fused_conv_mfm_bwd_launch(const void* x, const void* g,
                              const unsigned char* code, float* partials,
                              int h, int win, int c_half, int is_bf16,
                              int rows, int wt, int stride, int threads,
                              int blocks, int smem_bytes, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_conv_mfm_bwd_kernel<__nv_bfloat16>
        <<<blocks, threads, smem_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), code, partials, h, win,
            c_half, rows, wt, stride);
  } else {
    fused_conv_mfm_bwd_kernel<float><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), code,
        partials, h, win, c_half, rows, wt, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
