// PReLU (one slope) then floor-mode 2x2 max-pool in one pass, forward and
// backward, on NCHW memory.
//
//   x [B, C, H, W] (f32 or bf16), alpha [1] (f32)
//     -> out [B, C, H/2, W/2] (x's type)
//   training forward also: a selection code per output element (pool phase
//     dh*2+dw of the FIRST maximum | "selected input < 0" << 2, one byte) and
//     per-plane partial (sum, sumsq) of the rounded stored output;
//   backward: dx [B, C, H, W] rebuilt from (g, code), zero in a dropped odd
//     row or column, and per-block partials of dalpha.
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
// sectors with the neighbouring lanes).  The backward gives each thread
// whole windows (consecutive lanes, consecutive windows of a pooled row;
// consecutive warps, consecutive pooled rows of a strip): code, g and out
// are read once, by independent loads that nothing waits on before they
// are issued, two windows' worth at once.  Each window's four dx values go
// to a copy of the strip's input rows in shared memory, and the strip,
// one contiguous run of dx, goes out as aligned 16-byte stores whatever
// the parity of W (the DCNN's second pool has W = 129).  The first version
// gave each element of dx a thread of a block per plane: an integer divide
// per element, the window's code read by four threads, and g, out and x
// behind a branch on it, three dependent memory round trips per element
// that left it bound by latency (35 % of the byte bound at the DCNN's
// second pool).  What is left above the bound: the reads of x at negative
// selections, a 32-byte sector for 4 bytes each, and the block's barrier
// between its two phases.
//
// dalpha is the true sum of x * g over negative selected elements: the
// thread of a window reads x at the selected position (only when the code
// says negative), so an exactly-zero slope still receives its gradient (the
// TPU kernel divides the saved output by alpha and returns 0 there).
//
// Cross-block reductions: a forward block owns one (b, c) plane, a backward
// block a strip of pooled rows of one; each reduces its threads in
// a fixed order and writes one entry of partials, and the wrapper finishes
// with one torch.sum.  No atomics: bit-for-bit reproducible.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/fused_pool_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // forward

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

// Backward geometry: a block of kBwdWarps warps owns a strip of up to
// kBwdRows pooled rows of one (b, c) plane (fewer where a strip of input
// rows would not fit kBwdSmem bytes of shared memory: bwd_rows); warp y
// takes the strip's rows y, y + kBwdWarps, ..., lane l the windows j = l +
// 32 m of a row, two at a time.
constexpr int kBwdWarps = 8;
constexpr int kBwdRows = 16;
constexpr int kBwdWindows = 2;               // windows of a row a thread takes at once
constexpr size_t kBwdSmem = 48 * 1024;       // a strip's staging, without an opt-in
constexpr size_t kBwdSmemMax = 227 * 1024;   // what a block can opt in to

// Pooled rows a backward strip takes: as many as kBwdRows, while the
// strip's 2 rows + 1 of input (a dropped odd row rides in the last strip)
// fit kBwdSmem; one row at least, whose staging may need the opt-in.
inline int bwd_rows(int w, int elt) {
  const size_t input_rows = (kBwdSmem - 16) / (static_cast<size_t>(w) * elt);
  const size_t rows = input_rows >= 3 ? (input_rows - 1) / 2 : 1;
  return static_cast<int>(rows < kBwdRows ? rows : kBwdRows);
}
// Shared memory of a strip of `rows` pooled rows: its 2 rows + 1 input rows
// and up to 16 bytes in front, so that the strip's first element sits at
// its global address modulo 16 bytes.
inline size_t bwd_smem(int rows, int w, int elt) {
  return (static_cast<size_t>(2 * rows + 1) * w * elt + 16 + 15) / 16 * 16;
}

// blockIdx.x = plane * strips + strip, plane = b * C + c.  Phase 1, per
// window: code, g and out read once, by independent coalesced loads with no
// branch in front of them; the cotangent gt = g + gs[c] + 2 out gq[c] formed
// once (the expression of the first version of this kernel, so dx is
// bit-equal to it), times alpha where the selected input was negative; the
// window's four dx values written to a staging copy of the strip's input
// rows in shared memory, zeros in a dropped last column and, in the last
// strip, a dropped last row.  x is read only at a negative selection.
// Phase 2: the strip's rows are one contiguous run of dx, written out as
// aligned 16-byte chunks (the staging copy starts at the run's offset
// within 16 bytes), the partial chunks at its two ends element by element.
// dalpha: each thread sums x * gt over its windows in order, the block in a
// fixed order, one partial per block.
template <typename T>
__global__ void __launch_bounds__(32 * kBwdWarps)
fused_pool_bwd_kernel(const T* __restrict__ x, const float* __restrict__ alpha_p,
                      const T* __restrict__ g, const T* __restrict__ out,
                      const unsigned char* __restrict__ code,
                      const float* __restrict__ gs,
                      const float* __restrict__ gq, T* __restrict__ dx,
                      float* __restrict__ dalpha_partials, int c_total, int h,
                      int w, int rows, int strips) {
  constexpr int kV = 16 / sizeof(T);  // elements a 16-byte chunk
  extern __shared__ float4 staged4[];
  T* staged = reinterpret_cast<T*>(staged4);
  __shared__ float red[kBwdWarps];
  const int h2 = h / 2, w2 = w / 2;
  const float alpha = alpha_p[0];
  const int plane = blockIdx.x / strips, strip = blockIdx.x - plane * strips;
  const int c = plane % c_total;
  // cotangents of the per-channel (sum, sumsq) outputs fold into g
  const float gsc = gs != nullptr ? gs[c] : 0.f;
  const float gqc = gq != nullptr ? gq[c] : 0.f;
  const size_t e0 = static_cast<size_t>(plane) * h * w;
  const size_t o0 = static_cast<size_t>(plane) * h2 * w2;
  const int i0 = strip * rows, i1 = min(i0 + rows, h2);
  // input rows [2 i0, r_end) of the plane: the strip's, and a dropped odd
  // last row in the last strip
  const int r_end = strip == strips - 1 ? h : 2 * i1;
  const size_t begin = e0 + static_cast<size_t>(2 * i0) * w;
  const int len = (r_end - 2 * i0) * w;
  const int head = static_cast<int>(begin % kV);  // dx itself is 16-byte aligned
  const int lane = threadIdx.x & 31;
  float da[1] = {0.f};
  for (int i = i0 + (threadIdx.x >> 5); i < i1; i += kBwdWarps) {
    const size_t orow = o0 + static_cast<size_t>(i) * w2;
    T* row0 = staged + head + 2 * (i - i0) * w;
    for (int j0 = lane; j0 < w2; j0 += 32 * kBwdWindows) {
      int cd[kBwdWindows];
      float gv[kBwdWindows], ov[kBwdWindows];
#pragma unroll
      for (int u = 0; u < kBwdWindows; ++u) {
        const int j = j0 + 32 * u;
        if (j < w2) {
          cd[u] = code[orow + j];
          gv[u] = to_float(g[orow + j]);
          ov[u] = to_float(out[orow + j]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdWindows; ++u) {
        const int j = j0 + 32 * u;
        if (j >= w2) continue;
        const int ph = cd[u] & 3;
        const float gt = gv[u] + gsc + 2.f * ov[u] * gqc;
        float d;
        if (cd[u] >= 4) {
          d = alpha * gt;
          const size_t at = e0 + static_cast<size_t>(2 * i + (ph >> 1)) * w + 2 * j + (ph & 1);
          da[0] = fmaf(to_float(x[at]), gt, da[0]);
        } else {
          d = gt;
        }
        from_float(ph == 0 ? d : 0.f, row0 + 2 * j);
        from_float(ph == 1 ? d : 0.f, row0 + 2 * j + 1);
        from_float(ph == 2 ? d : 0.f, row0 + w + 2 * j);
        from_float(ph == 3 ? d : 0.f, row0 + w + 2 * j + 1);
      }
    }
    if ((w & 1) && lane == 0) {  // the dropped last column
      from_float(0.f, row0 + w - 1);
      from_float(0.f, row0 + 2 * w - 1);
    }
  }
  if (r_end > 2 * i1) {  // the dropped last row
    T* last = staged + head + 2 * (i1 - i0) * w;
    for (int q = threadIdx.x; q < w; q += blockDim.x) from_float(0.f, last + q);
  }
  __syncthreads();
  const int chunks = (head + len + kV - 1) / kV;
  T* base = dx + begin - head;  // 16-byte aligned
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    if (k > 0 && k < chunks - 1) {
      reinterpret_cast<float4*>(base)[k] = staged4[k];
    } else {  // the run's two ends
      for (int e = k * kV; e < (k + 1) * kV; ++e)
        if (e >= head && e < head + len) base[e] = staged[e];
    }
  }
  block_sum(da, red);
  if (threadIdx.x == 0) dalpha_partials[blockIdx.x] = da[0];
}

template <typename T>
int bwd_launch(const void* x, const void* alpha, const void* g, const void* out,
               const void* code, const void* gs, const void* gq, void* dx,
               void* dalpha_partials, int planes, int c_total, int h, int w, cudaStream_t s) {
  const int rows = bwd_rows(w, sizeof(T));
  const int strips = (h / 2 + rows - 1) / rows;
  const size_t smem = bwd_smem(rows, w, sizeof(T));
  if (smem > kBwdSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_pool_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(planes) * static_cast<unsigned>(strips);
  fused_pool_bwd_kernel<T><<<blocks, 32 * kBwdWarps, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(alpha), static_cast<const T*>(g),
      static_cast<const T*>(out), static_cast<const unsigned char*>(code),
      static_cast<const float*>(gs), static_cast<const float*>(gq), static_cast<T*>(dx),
      static_cast<float*>(dalpha_partials), c_total, h, w, rows, strips);
  return static_cast<int>(cudaGetLastError());
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

// Backward blocks per plane, and so dalpha partials per plane (strips of
// pooled rows); 0 where a strip of one pooled row does not fit a block's
// shared memory (W beyond ~19,000 in fp32, ~38,000 in bf16).
int fused_pool_bwd_strips(int h, int w, int is_bf16) {
  const int elt = is_bf16 ? 2 : 4;
  const int rows = bwd_rows(w, elt);
  if (bwd_smem(rows, w, elt) > kBwdSmemMax) return 0;
  return (h / 2 + rows - 1) / rows;
}

// dalpha_partials: planes * fused_pool_bwd_strips(h, w, is_bf16) floats.
int fused_pool_bwd_launch(const void* x, const void* alpha, const void* g,
                          const void* out, const void* code, const void* gs,
                          const void* gq, void* dx, void* dalpha_partials,
                          int planes, int c_total, int h, int w, int is_bf16,
                          int device, void* stream) {
  if (fused_pool_bwd_strips(h, w, is_bf16) == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_launch<__nv_bfloat16>(x, alpha, g, out, code, gs, gq, dx,
                                             dalpha_partials, planes, c_total, h, w, s)
                 : bwd_launch<float>(x, alpha, g, out, code, gs, gq, dx, dalpha_partials,
                                     planes, c_total, h, w, s);
}

const char* fused_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
