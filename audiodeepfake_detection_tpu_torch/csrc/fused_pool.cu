// PReLU (one slope) then floor-mode 2x2 max-pool in one pass, forward and
// backward, on NCHW memory.
//
//   x [B, C, H, W] (f32 or bf16), alpha [1] (f32)
//     -> out [B, C, H/2, W/2] (x's type)
//   training forward also: a selection code per output element (pool phase
//     dh*2+dw of the FIRST maximum | "selected input < 0" << 2, one byte) and
//     per-plane partial (sum, sumsq) of the rounded stored output;
//   backward: dx [B, C, H, W] rebuilt from (g, code), zero in a dropped odd
//     row or column, and per-plane partials of dalpha.
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/fused_pool.py::
// _fwd_kernel and ::_bwd_kernel (reached through fused_prelu_pool and
// fused_prelu_pool_stats).  Those kernels are NHWC with W in sublanes and
// split W-pairs by a sublane reshape; here the tensors stay in the NCHW
// memory the cuDNN layers on both sides use, so no copy stands before or
// behind the kernel.  Kept: what is computed, the first-match tie-break
// (strict > in the order (0,0), (0,1), (1,0), (1,1), which is also what
// max_pool2d's backward does), and what stays out of device memory -- the
// PReLU'd full-size activation in the forward, and in the backward the
// full-size pool gradient that a PReLU backward would read again.
//
// What bounds it on the H100: bytes.  One compare-select per input element
// against 4 bytes read; the design is one coalesced pass.  The forward gives
// each thread one pooled element (its 2x2 window: four loads that share
// sectors with the neighbouring lanes).  The backward runs over the elements
// of dx, not of g: every store is coalesced, odd tails are written as plain
// zeros by the same loop, and the four threads of a window read the same
// (g, code, out), which the L1 serves.
//
// dalpha is the true sum of x * g over negative selected elements: the one
// thread of a window that owns the selected position reads x there (only
// when the code says negative), so an exactly-zero slope still receives its
// gradient (the TPU kernel divides the saved output by alpha and returns 0
// there).
//
// Cross-block reductions: a block owns one (b, c) plane, reduces its threads
// in a fixed order and writes one row of partials; the wrapper finishes with
// one torch.sum over the batch.  No atomics: bit-for-bit reproducible.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/fused_pool_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// Sum N values per thread over the block in a fixed order (warp shuffles,
// then the warps' results in order); thread 0 holds the result.
template <int N>
__device__ __forceinline__ void block_sum(float (&vals)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      vals[k] += __shfl_down_sync(0xffffffffu, vals[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = vals[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = 0.f;
      for (int w = 0; w < warps; ++w) acc += red[w * N + k];
      vals[k] = acc;
    }
  }
}

// One block per (b, c) plane; blockIdx.x = b * C + c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_pool_fwd_kernel(const T* __restrict__ x, const float* __restrict__ alpha_p,
                      T* __restrict__ out, unsigned char* __restrict__ code,
                      float* __restrict__ stat_partials, int h, int w) {
  __shared__ float red[2 * kThreads / 32];
  const int h2 = h / 2, w2 = w / 2;
  const float alpha = alpha_p[0];
  const T* plane = x + static_cast<size_t>(blockIdx.x) * h * w;
  const size_t o0 = static_cast<size_t>(blockIdx.x) * h2 * w2;
  float stats[2] = {0.f, 0.f};
  for (int p = threadIdx.x; p < h2 * w2; p += blockDim.x) {
    const int i = p / w2, j = p - i * w2;
    const T* base = plane + static_cast<size_t>(2 * i) * w + 2 * j;
    float best = 0.f, best_pre = 0.f;
    int best_ph = 0;
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      const float pre = to_float(base[(ph >> 1) * w + (ph & 1)]);
      const float act = pre >= 0.f ? pre : alpha * pre;
      // strict >: ties keep the first phase of (0,0),(0,1),(1,0),(1,1)
      if (ph == 0 || act > best) {
        best = act;
        best_pre = pre;
        best_ph = ph;
      }
    }
    T stored;
    from_float(best, &stored);
    out[o0 + p] = stored;
    if (code != nullptr)
      code[o0 + p] =
          static_cast<unsigned char>(best_ph | ((best_pre < 0.f) << 2));
    const float rounded = to_float(stored);  // what a later pass would read
    stats[0] += rounded;
    stats[1] = fmaf(rounded, rounded, stats[1]);
  }
  if (stat_partials != nullptr) {
    block_sum(stats, red);
    if (threadIdx.x == 0) {
      stat_partials[2 * static_cast<size_t>(blockIdx.x)] = stats[0];
      stat_partials[2 * static_cast<size_t>(blockIdx.x) + 1] = stats[1];
    }
  }
}

// One block per (b, c) plane, one loop over the plane's H * W elements of dx.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_pool_bwd_kernel(const T* __restrict__ x, const float* __restrict__ alpha_p,
                      const T* __restrict__ g, const T* __restrict__ out,
                      const unsigned char* __restrict__ code,
                      const float* __restrict__ gs,
                      const float* __restrict__ gq, T* __restrict__ dx,
                      float* __restrict__ dalpha_partials, int c_total, int h,
                      int w) {
  __shared__ float red[kThreads / 32];
  const int h2 = h / 2, w2 = w / 2;
  const float alpha = alpha_p[0];
  const int c = blockIdx.x % c_total;
  // cotangents of the per-channel (sum, sumsq) outputs fold into g
  const float gsc = gs != nullptr ? gs[c] : 0.f;
  const float gqc = gq != nullptr ? gq[c] : 0.f;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * h * w;
  const size_t o0 = static_cast<size_t>(blockIdx.x) * h2 * w2;
  float da[1] = {0.f};
  for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
    const int r = e / w, q = e - r * w;
    const int i = r >> 1, j = q >> 1;
    float d = 0.f;
    if (i < h2 && j < w2) {
      const size_t o = o0 + static_cast<size_t>(i) * w2 + j;
      const int cd = code[o];
      if ((cd & 3) == ((r & 1) * 2 + (q & 1))) {
        const float gt = to_float(g[o]) + gsc + 2.f * to_float(out[o]) * gqc;
        if (cd >= 4) {
          d = alpha * gt;
          da[0] = fmaf(to_float(x[e0 + e]), gt, da[0]);
        } else {
          d = gt;
        }
      }
    }
    T stored;
    from_float(d, &stored);
    dx[e0 + e] = stored;
  }
  block_sum(da, red);
  if (threadIdx.x == 0) dalpha_partials[blockIdx.x] = da[0];
}

}  // namespace

extern "C" {

// Both launchers return the cudaError_t of the launch (0 on success).

int fused_pool_fwd_launch(const void* x, const void* alpha, void* out,
                          void* code, void* stat_partials, int planes, int h,
                          int w, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_pool_fwd_kernel<__nv_bfloat16><<<planes, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(alpha),
        static_cast<__nv_bfloat16*>(out), static_cast<unsigned char*>(code),
        static_cast<float*>(stat_partials), h, w);
  } else {
    fused_pool_fwd_kernel<float><<<planes, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(alpha),
        static_cast<float*>(out), static_cast<unsigned char*>(code),
        static_cast<float*>(stat_partials), h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_pool_bwd_launch(const void* x, const void* alpha, const void* g,
                          const void* out, const void* code, const void* gs,
                          const void* gq, void* dx, void* dalpha_partials,
                          int planes, int c_total, int h, int w, int is_bf16,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_pool_bwd_kernel<__nv_bfloat16><<<planes, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(alpha),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(out),
        static_cast<const unsigned char*>(code), static_cast<const float*>(gs),
        static_cast<const float*>(gq), static_cast<__nv_bfloat16*>(dx),
        static_cast<float*>(dalpha_partials), c_total, h, w);
  } else {
    fused_pool_bwd_kernel<float><<<planes, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(alpha),
        static_cast<const float*>(g), static_cast<const float*>(out),
        static_cast<const unsigned char*>(code), static_cast<const float*>(gs),
        static_cast<const float*>(gq), static_cast<float*>(dx),
        static_cast<float*>(dalpha_partials), c_total, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
