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
// [2*i0, 2*i0 + 2*rows + 2) and padded columns [2*j0, 2*j0 + 2*wt + 2),
// where padded (r, c) is x[r - 2][c - 2].
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, float* xs,
                                          Tile t, int h, int w, int rows,
                                          int wt, int stride) {
  const T* frame = x + static_cast<size_t>(t.b) * h * w;
  const int tile_h = 2 * rows + 2, tile_w = 2 * wt + 2;
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
// order and write them as partials[blockIdx.x][k][channel].
template <int N>
__device__ __forceinline__ void block_reduce_store(const float (&vals)[N],
                                                   float* red,
                                                   float* __restrict__ partials,
                                                   int c_total) {
  const int groups = blockDim.x / c_total;
  const int c = threadIdx.x % c_total, pg = threadIdx.x / c_total;
#pragma unroll
  for (int k = 0; k < N; ++k) red[(pg * N + k) * c_total + c] = vals[k];
  __syncthreads();
  if (pg == 0) {
    float* dst = partials + static_cast<size_t>(blockIdx.x) * N * c_total;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = 0.f;
      for (int g = 0; g < groups; ++g) acc += red[(g * N + k) * c_total + c];
      dst[k * c_total + c] = acc;
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
  load_tile(x, xs, t, h, win, rows, wt, stride);

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
    block_reduce_store(stats, red, stat_partials, c_total);
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
  load_tile(x, xs, t, h, win, rows, wt, stride);

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
  block_reduce_store(acc, red, partials, c_total);
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

}  // extern "C"
