// Whole wavelet-packet cascade in one kernel: [B, T] f32 -> [B, 2^L, n_L] f32.
//
// Replaces the TPU kernel audiodeepfake_detection_tpu/ops/wpt_pallas.py::
// wpt_packets_pallas.  That kernel recast each level as banded matmuls for
// the MXU, in a 128-lane chunk plan over 16-frame VMEM tiles with a
// bit-reversed node layout; all of that existed for the TPU and is not
// carried over.  What is kept is what it computes and what it keeps out of
// device memory: the intermediate levels.
//
// What bounds it on the H100: the ideal kernel reads each frame once and
// writes the last level once, ~185 KB per frame, and does 2*taps flops per
// output per level, ~3.6 MFLOP per frame for sym5 at T=22050.  It sits at
// the fp32 ridge: at B=64 that is ~3.5 us of memory traffic at 3.35 TB/s
// and ~3.5 us of FMA at 67 TFLOP/s.  The plain version instead
// round-trips every level through device memory and issues a gather and a
// convolution launch per level.  This first kernel is bound by neither:
// it occupies one CTA per frame (64 of 132 SMs at B=64) and waits at a
// barrier between levels.
//
// Design: one CTA per frame runs all L levels.  Levels 1..L-1 ping-pong
// between two buffers in dynamic shared memory (sym5 at T=22050: 2 x ~23k
// floats, about 183 KB of the 227 KB a block may opt into), so between the
// frame's read and the output's write nothing touches device memory.  Level
// 1 reads the frame straight from global memory; the last level writes
// straight to the output, with the Gray-code (frequency) node order and the
// optional log(|x|^p + 1e-12) applied at the store.  Threads stride over a
// level's nodes x n_out outputs; each output is a filt_len-tap dot product
// of the flipped dec_lo (even child) or dec_hi (odd child) with the
// parent's samples, whole-point reflected at the edges exactly like
// _reflect (wpt_pallas.py:55).  Not yet done (later work): with one CTA per
// frame, B=64 fills 64 of the 132 SMs; splitting frames across CTAs or a
// cluster would fill the rest.  Stride-2 shared-memory reads cost 2-way
// bank conflicts.
//
// Long frames: a frame whose level buffers exceed one block's shared memory
// (sym5 level 8 above T = 28,232 samples, e.g. 2 s at 22050 Hz or 1 s at
// 32 kHz) takes a second route, wpt_level_kernel: one launch per level,
// one thread per output coefficient over (frame, node, index), the level
// read from and written to device memory.  Same taps, the same reflection
// and the same last-level store (frequency order, optional log) as the
// one-block kernel, so both routes give the same sums in the same order.
// It moves every level through device memory (B=128, T=44,100: ~23 MB a
// level, ~0.1 ms for eight levels at 3.35 TB/s); the wrapper
// (ops/wpt_cuda.py) chooses the route from the shared-memory plan.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/wpt_cuda.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int reflect_index(int t, int n) {
  if (n == 1) return 0;
  while (t < 0 || t >= n) {
    if (t < 0) t = -t;
    if (t >= n) t = 2 * (n - 1) - t;
  }
  return t;
}

// Dynamic shared memory layout (float offsets, chosen by the wrapper):
//   [0, 2*filt_len)            flipped dec_lo taps, then flipped dec_hi taps
//   [buf_a_off, ...)           outputs of levels 0, 2, 4, ... (not the last)
//   [buf_b_off, ...)           outputs of levels 1, 3, 5, ... (not the last)
__global__ void __launch_bounds__(kThreads)
wpt_cascade_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const float* __restrict__ taps, int t, int level,
                   int filt_len, int buf_a_off, int buf_b_off, int log_scale,
                   float power) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < 2 * filt_len; k += blockDim.x) smem[k] = taps[k];
  __syncthreads();
  const float* taps_lo = smem;
  const float* taps_hi = smem + filt_len;
  float* bufs[2] = {smem + buf_a_off, smem + buf_b_off};

  const int padl = (2 * filt_len - 3) / 2;
  const float* src = x + static_cast<size_t>(blockIdx.x) * t;
  int n_in = t;
  for (int lvl = 0; lvl < level; ++lvl) {
    const int nodes_out = 2 << lvl;
    const int n_out = (n_in + filt_len - 1) / 2;
    const bool last = lvl == level - 1;
    float* dst = last ? out + static_cast<size_t>(blockIdx.x) * nodes_out * n_out
                      : bufs[lvl & 1];
    const int total = nodes_out * n_out;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = i / n_out;
      const int s = i - row * n_out;
      // rows of the last level are in frequency order: row f holds the
      // natural node f ^ (f >> 1); inner levels stay in natural order,
      // where node m is child (m & 1) of parent m >> 1
      const int node = last ? (row ^ (row >> 1)) : row;
      const float* f = (node & 1) ? taps_hi : taps_lo;
      const float* in = src + static_cast<size_t>(node >> 1) * n_in;
      const int base = 2 * s - padl;
      float acc = 0.f;
      if (base >= 0 && base + filt_len <= n_in) {
        for (int k = 0; k < filt_len; ++k) acc = fmaf(f[k], in[base + k], acc);
      } else {
        for (int k = 0; k < filt_len; ++k)
          acc = fmaf(f[k], in[reflect_index(base + k, n_in)], acc);
      }
      if (last && log_scale) {
        const float a = fabsf(acc);
        acc = logf((power == 2.0f ? a * a : powf(a, power)) + 1e-12f);
      }
      dst[i] = acc;
    }
    __syncthreads();
    src = dst;
    n_in = n_out;
  }
}

// One level of the cascade through device memory: in [batch, nodes_in, n_in]
// (natural node order) -> out [batch, 2 * nodes_in, n_out]; the last level
// in frequency order with the optional log at the store.
__global__ void __launch_bounds__(256)
wpt_level_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const float* __restrict__ taps, long long total, int nodes_in,
                 int n_in, int n_out, int filt_len, int last, int log_scale,
                 float power) {
  extern __shared__ float taps_s[];
  for (int k = threadIdx.x; k < 2 * filt_len; k += blockDim.x) taps_s[k] = taps[k];
  __syncthreads();
  const int padl = (2 * filt_len - 3) / 2;
  const long long per_frame = 2LL * nodes_in * n_out;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long frame = i / per_frame;
    const int rem = static_cast<int>(i - frame * per_frame);
    const int row = rem / n_out;
    const int s = rem - row * n_out;
    const int node = last ? (row ^ (row >> 1)) : row;
    const float* f = taps_s + ((node & 1) ? filt_len : 0);
    const float* src = in + (frame * nodes_in + (node >> 1)) * n_in;
    const int base = 2 * s - padl;
    float acc = 0.f;
    if (base >= 0 && base + filt_len <= n_in) {
      for (int k = 0; k < filt_len; ++k) acc = fmaf(f[k], src[base + k], acc);
    } else {
      for (int k = 0; k < filt_len; ++k)
        acc = fmaf(f[k], src[reflect_index(base + k, n_in)], acc);
    }
    if (last && log_scale) {
      const float a = fabsf(acc);
      acc = logf((power == 2.0f ? a * a : powf(a, power)) + 1e-12f);
    }
    out[i] = acc;
  }
}

}  // namespace

extern "C" {

const char* wpt_cascade_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest dynamic shared memory one block may opt into on ``device``.
int wpt_cascade_smem_limit(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Launch on ``stream`` without synchronising; returns cudaGetLastError().
int wpt_cascade_launch(const float* x, float* out, const float* taps,
                       int batch, int t, int level, int filt_len,
                       int buf_a_off, int buf_b_off, int smem_bytes,
                       int log_scale, float power, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wpt_cascade_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wpt_cascade_kernel<<<batch, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      x, out, taps, t, level, filt_len, buf_a_off, buf_b_off, log_scale,
      power);
  return static_cast<int>(cudaGetLastError());
}

// One level of the long-frame route on ``stream``; returns cudaGetLastError().
int wpt_level_launch(const float* in, float* out, const float* taps, int batch,
                     int nodes_in, int n_in, int n_out, int filt_len, int last,
                     int log_scale, float power, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = 2LL * batch * nodes_in * n_out;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  wpt_level_kernel<<<blocks, 256, 2 * filt_len * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      in, out, taps, total, nodes_in, n_in, n_out, filt_len, last, log_scale,
      power);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
