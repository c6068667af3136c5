// Wavelet-packet cascade: [B, T] f32 -> [B, 2^L, n_L] f32, a CTA per subtree.
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
// and ~3.5 us of FMA at 67 TFLOP/s.  Inside a CTA the levels run one after
// another with a barrier between them, so what it pays above that is the
// frame's read and the last level's write, each in a phase of its own,
// and per level the window loads, the stores and the barrier.
//
// Design.
// * A CTA per subtree.  Node c at level k determines all 2^(L-k) of its
//   descendants at level L and nothing else, so the grid is (frame, node at
//   the split depth k): B * 2^k CTAs, each running its subtree in shared
//   memory and writing its 2^(L-k) rows of the last level.  Those rows are
//   one contiguous run of the frequency-ordered (Gray-code) output, copied
//   out by coalesced stores.  The launcher (ops/wpt_cuda.py, wpt_plan)
//   picks k from the batch, the frame, the SM count and the shared-memory
//   limit, so that a small batch reaches many SMs and a large one
//   recomputes nothing.
// * The CTA's own level-k node comes from a level j <= k held in device
//   memory (j = 0: the frame itself): the CTA walks down its path of
//   ancestors from there, one node a level, before it expands the subtree.
//   With j = 0 ("frame" for k <= 1, "path" beyond) it recomputes its
//   ancestors from the frame; with j = k - 1 ("levels") the top j levels
//   go through device memory first, wpt_level_kernel, one launch a level.
//   Frames longer than one CTA holds (2 s at 22050 Hz, 1 s at 32 kHz,
//   level-14 haar) are the same design at a deeper k.
// * The first level a CTA computes is staged: the samples under a chunk of
//   its outputs are copied from device memory, reflected at the ends, into
//   shared memory by coalesced cp.async copies.
// * Padded rows.  Every node in shared memory is a row of padl = F - 2
//   reflected samples, its samples and padl + 1 reflected samples (the
//   whole-point reflection of _reflect, wpt_pallas.py:55, repeated where a
//   pad is longer than the node), 16-byte aligned.  The stores of a level
//   mirror each sample into its row's pads, so no output needs an index
//   check or a reflection when the next level reads it.
// * Register-blocked taps.  A thread computes R consecutive outputs of
//   both children of one parent from one window of 2R + F - 2 samples read
//   as float4s (R = 6: a quarter-warp's loads and a half-warp's float2
//   stores fall on 32 distinct banks); the taps are a kernel parameter that
//   the FMAs read from the constant bank.  Templated on F for haar (2),
//   db4 (8), sym5 (10), db8 (16) and coif4 (24, R = 2), with a generic
//   instance for every other length.  Threads walk (node, block of R
//   outputs) with no per-output integer divide.  The log(|x|^p + 1e-12) of
//   the last level is taken as its outputs are stored.
// * The same sums.  Each output is fmaf over taps k = 0 .. F-1 from 0, as
//   in the first version of this kernel and in the plain version's
//   convolution, so every route and every split depth gives the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/wpt_cuda.py).

#include <cuda_runtime.h>

constexpr int kWptMaxLevel = 30;  // 2^31 rows overflow: the wrapper refuses
// the generic instance's tap arrays
constexpr int kWptMaxTaps = 64;

// Everything a call passes but the tensors and the stream, built once per
// geometry on the host (ops/wpt_cuda.py::LaunchArgs mirrors it) and handed
// to the kernels as their parameter, whose taps the FMAs read from the
// constant bank.  Outside the anonymous namespace: the extern "C"
// launchers take it.
struct LaunchArgs {
  int filt_len;
  int batch;
  int level;
  int split;
  int in_level;
  int buf_b_off;
  int smem_bytes;
  int threads;
  int log_scale;
  int device;
  float power;
  int len[kWptMaxLevel + 1];
  float taps[2 * kWptMaxTaps];  // flipped dec_lo, then flipped dec_hi
};

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLevelThreads = 256;

// Whole-point reflection of index t into [0, n), repeated while out of
// range (pads longer than the node, n == 1): out of line, being rare.
__device__ __noinline__ int reflect_repeat(int t, int n) {
  if (n == 1) return 0;
  while (t < 0 || t >= n) {
    if (t < 0) t = -t;
    if (t >= n) t = 2 * (n - 1) - t;
  }
  return t;
}

__device__ __forceinline__ int reflect_index(int t, int n) {
  if (t < 0) t = -t;
  if (t >= n) t = 2 * (n - 1) - t;
  if (static_cast<unsigned>(t) >= static_cast<unsigned>(n)) t = reflect_repeat(t, n);
  return t;
}

// A node of n samples held in shared memory is a padded row: padl = F - 2
// reflected samples, the n samples, padl + 1 reflected samples (all that
// the outputs read), rounded up to 4 floats (must match
// ops/wpt_cuda.py::_row_stride).  Rows start on 16 bytes, so the window of
// output s, which starts at row + 2s, is read as aligned float4s.
__device__ __forceinline__ int row_stride(int n, int filt_len) {
  return (n + 2 * filt_len) & ~3;
}

// natural node index -> row of the frequency-ordered output (inverse Gray)
__device__ __forceinline__ int freq_row(int node) {
  node ^= node >> 1;
  node ^= node >> 2;
  node ^= node >> 4;
  node ^= node >> 8;
  node ^= node >> 16;
  return node;
}

// Outputs of each child a thread computes from one window: R consecutive
// outputs start 2R samples apart, so a warp's windows start 2R floats
// apart.  R = 6 puts a quarter-warp's float4 window loads (and a half-warp's
// float2 stores) on 32 distinct banks; coif4's 24 taps take R = 2 for
// registers; the generic instance, which reads samples one by one, R = 2.
template <int F>
__host__ __device__ constexpr int outputs_per_window() {
  return (F == 0 || F >= 24) ? 2 : 6;
}

// R consecutive outputs of one child: y[r] = sum_k f[k] * w[2r + k], each
// an fmaf chain over k = 0 .. F-1 from 0
template <int F, int R>
__device__ __forceinline__ void fir(const float* f, const float* w,
                                    float (&y)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) y[r] = 0.f;
#pragma unroll
  for (int k = 0; k < F; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r) y[r] = fmaf(f[k], w[2 * r + k], y[r]);
  }
}

// the same for a filter length known only at run time, samples read from
// shared memory one by one
template <int R>
__device__ __forceinline__ void fir_generic(const float* f, int filt_len,
                                            const float* w, float (&y)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc = 0.f;
    for (int k = 0; k < filt_len; ++k) acc = fmaf(f[k], w[2 * r + k], acc);
    y[r] = acc;
  }
}

__device__ __forceinline__ float log_store(float v, float power) {
  const float a = fabsf(v);
  return logf((power == 2.0f ? a * a : powf(a, power)) + 1e-12f);
}

// What a level's stores to shared memory do besides writing the samples:
// the log (the last level), or, for a level the next one reads, mirror
// each sample into the reflected pads of its row (``mirror`` = padl; a
// node of n >= padl + 2 samples needs one reflection, so every pad sample
// has one source sample; -1: the pads are filled apart, after a barrier).
struct Sink {
  int mirror;
  int log_scale;
  float power;
};

// outputs s0 .. s0 + R - 1 (those below n) to ``row`` (its samples); in
// shared memory s0 is even and the samples start on 8 bytes: float2s
template <bool kShared, int R>
__device__ __forceinline__ void store(float* row, int s0, int n, float (&y)[R],
                                      const Sink& sink) {
  if (!kShared) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (s0 + r < n) row[s0 + r] = y[r];
    return;
  }
  if (sink.log_scale) {
#pragma unroll
    for (int r = 0; r < R; ++r) y[r] = log_store(y[r], sink.power);
  }
  if (s0 + R <= n) {
#pragma unroll
    for (int r = 0; r < R; r += 2)
      *reinterpret_cast<float2*>(row + s0 + r) = make_float2(y[r], y[r + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (s0 + r < n) row[s0 + r] = y[r];
  }
  const int padl = sink.mirror;
  if (padl >= 0 && (s0 <= padl || s0 + R + padl + 1 >= n)) {
    // samples 1 .. padl are the left pad reflected, n-2-padl .. n-2 the right
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r;
      if (s >= 1 && s <= padl) row[-s] = y[r];
      if (s >= n - 2 - padl && s <= n - 2) row[2 * (n - 1) - s] = y[r];
    }
  }
}

// Outputs s0 .. s0 + R - 1 of child 0 (to d0) and child 1 (to d1), or of
// child ``bit`` alone (to d0) unless kBoth, from the window ``w`` of the
// parent: w[i] is the parent's sample 2 * s0 - padl + i, reflected.
template <int F, bool kBoth, bool kShared>
__device__ __forceinline__ void outputs(const float* taps, int filt_len,
                                        const float* w, int s0, int n_out,
                                        float* d0, float* d1, int bit,
                                        const Sink& sink) {
  constexpr int R = outputs_per_window<F>();
  float y[R];
  if (kBoth || bit == 0) {
    if constexpr (F > 0)
      fir<F, R>(taps, w, y);
    else
      fir_generic<R>(taps, filt_len, w, y);
    store<kShared, R>(d0, s0, n_out, y, sink);
  }
  if (kBoth || bit == 1) {
    if constexpr (F > 0)
      fir<F, R>(taps + F, w, y);
    else
      fir_generic<R>(taps + filt_len, filt_len, w, y);
    store<kShared, R>(kBoth ? d1 : d0, s0, n_out, y, sink);
  }
}

// The window of outputs s0 .. s0 + R - 1 from a padded row in shared
// memory (``p`` = row + 2 * s0): float4 loads, no index checks.
template <int F>
struct Window {
  static constexpr int kR = outputs_per_window<F>();
  static constexpr int kW4 = (2 * kR + F - 2 + 3) / 4;
  float w[4 * kW4];
  __device__ __forceinline__ explicit Window(const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < kW4; ++i) {
      const float4 v = q[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
};

// One level in shared memory: each of ``parents`` padded rows (``src``,
// ``src_stride`` apart) -> both children (rows 2p and 2p + 1 of ``dst``)
// or, unless kBoth, child ``bit`` of the one parent (row 0).  Item i is
// (parent p, block blk) with blk fastest; each thread advances its (p,
// blk) by the CTA's stride without dividing.
template <int F, bool kBoth>
__device__ __forceinline__ void smem_step(const float* taps, int filt_len,
                                          const float* src, int src_stride,
                                          int parents, float* dst,
                                          int dst_stride, int n_out, int bit,
                                          const Sink& sink) {
  constexpr int R = outputs_per_window<F>();
  const int padl = filt_len - 2;
  const int nblk = (n_out + R - 1) / R;
  const int total = parents * nblk;
  const int stride = blockDim.x;
  const int dp = stride / nblk, db = stride - dp * nblk;
  int p = threadIdx.x / nblk;
  int blk = threadIdx.x - p * nblk;
  for (int i = threadIdx.x; i < total; i += stride) {
    const float* row = src + p * src_stride + 2 * R * blk;
    float* d0 = dst + (kBoth ? 2 * p : 0) * dst_stride + padl;
    if constexpr (F > 0) {
      const Window<F> win(row);
      outputs<F, kBoth, true>(taps, filt_len, win.w, R * blk, n_out, d0,
                              d0 + dst_stride, bit, sink);
    } else {
      outputs<F, kBoth, true>(taps, filt_len, row, R * blk, n_out, d0,
                              d0 + dst_stride, bit, sink);
    }
    blk += db;
    p += dp;
    if (blk >= nblk) {
      blk -= nblk;
      ++p;
    }
  }
}

// 4 bytes from device memory to shared memory, asynchronously (cp.async):
// a thread issues all its copies before it waits for any
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first level a CTA computes, from one row of device memory (n_in
// samples): chunk by chunk, the samples under a chunk's outputs are
// copied, reflected at the row's ends, into ``stage`` (``stage_floats``
// of shared memory) by coalesced asynchronous copies; then the chunk's
// outputs are computed from there like those of any padded row.  kBoth:
// both children to rows 0 and 1 of ``dst``; else child ``bit`` to row 0.
template <int F, bool kBoth>
__device__ __forceinline__ void first_step(const float* taps, int filt_len,
                                           const float* __restrict__ src,
                                           int n_in, float* stage,
                                           int stage_floats, float* dst,
                                           int dst_stride, int n_out, int bit,
                                           const Sink& sink) {
  constexpr int R = outputs_per_window<F>();
  const int padl = filt_len - 2;
  // outputs per chunk: a multiple of R whose samples, with the float4 loads'
  // overrun, fit the stage
  const int chunk = ((stage_floats - filt_len - 4 * R - 8) / (2 * R)) * R;
  float* d0 = dst + padl;
  for (int c0 = 0; c0 < n_out; c0 += chunk) {
    const int outs = min(chunk, n_out - c0);
    const int nblk = (outs + R - 1) / R;
    const int span = 2 * R * nblk + filt_len + 2 * R;
    const int g0 = 2 * c0 - padl;
    for (int i = threadIdx.x; i < span; i += blockDim.x)
      copy_async(stage + i, src + reflect_index(g0 + i, n_in));
    copy_async_wait();
    __syncthreads();
    for (int blk = threadIdx.x; blk < nblk; blk += blockDim.x) {
      const float* row = stage + 2 * R * blk;
      if constexpr (F > 0) {
        const Window<F> win(row);
        outputs<F, kBoth, true>(taps, filt_len, win.w, c0 + R * blk, n_out, d0,
                                d0 + dst_stride, bit, sink);
      } else {
        outputs<F, kBoth, true>(taps, filt_len, row, c0 + R * blk, n_out, d0,
                                d0 + dst_stride, bit, sink);
      }
    }
    __syncthreads();
  }
}

// The reflected pads of ``rows`` padded rows of n samples, from their
// samples (after a barrier: the samples are another thread's outputs).
__device__ __forceinline__ void pad_rows(float* buf, int rows, int stride,
                                         int n, int filt_len) {
  const int padl = filt_len - 2;
  const int per = 2 * padl + 1;  // padl left, padl + 1 right
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per;
    const int e = i - r * per;
    float* row = buf + r * stride + padl;
    const int t = e < padl ? e - padl : n + e - padl;
    row[t] = row[reflect_index(t, n)];
  }
}

// The CTA's 2^m rows of the last level (natural order, samples at ``src``,
// rows ``stride`` apart) to ``out``: they are the frequency rows f0 .. f0 +
// 2^m - 1 of the frame, one contiguous run of device memory, where row f
// holds natural node f ^ (f >> 1).  Each warp copies 32 consecutive
// samples of a row at a time (coalesced stores).
__device__ __forceinline__ void store_rows(const float* src, int stride,
                                           float* out, int m, int first,
                                           int n) {
  const int rows = 1 << m;
  const int f0 = freq_row(first) & ~(rows - 1);
  const int chunks = (n + 31) >> 5;
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows * chunks; i += warps) {
    const int q = i / chunks;
    const int s = ((i - q * chunks) << 5) + lane;
    if (s < n) {
      const int f = f0 + q;
      out[static_cast<size_t>(f) * n + s] =
          src[((f ^ (f >> 1)) & (rows - 1)) * stride + s];
    }
  }
}

// One CTA per (frame, node c at level k).  ``in`` is level j of the
// cascade, [B, 2^j, len[j]] in natural node order (j = 0: the frames).
// Levels j+1 .. L alternate between buffer A (at 0) and buffer B (at
// buf_b_off) of dynamic shared memory as padded rows; the first of them
// is staged through buffer B; then the last level goes to ``out`` [B,
// 2^L, len[L]].  Levels at or above k are the one node on the CTA's path.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
wpt_subtree_kernel(const float* __restrict__ in, float* __restrict__ out,
                   const __grid_constant__ LaunchArgs g) {
  extern __shared__ __align__(16) float smem[];
  const float* const taps = g.taps;
  const int filt_len = F > 0 ? F : g.filt_len;
  const int k = g.split, j = g.in_level, L = g.level;
  const int stage_floats = g.smem_bytes / 4 - g.buf_b_off;
  const int c = blockIdx.x & ((1 << k) - 1);
  const size_t frame = blockIdx.x >> k;
  float* const buf_b = smem + g.buf_b_off;

  // level j + 1 from the CTA's ancestor at level j, in device memory; each
  // level's stores mirror its samples into its pads where one reflection
  // makes them, else pad_rows fills them after a barrier
  const int padl = filt_len - 2;
  const float* const gsrc =
      in + ((frame << j) + static_cast<size_t>(c >> (k - j))) * g.len[j];
  int n = g.len[j + 1];
  int stride = row_stride(n, filt_len);
  bool mirrored = n >= padl + 2;
  Sink sink{j + 1 < L && mirrored ? padl : -1, j + 1 == L ? g.log_scale : 0,
            g.power};
  if (j < k)
    first_step<F, false>(taps, filt_len, gsrc, g.len[j], buf_b, stage_floats,
                         smem, stride, n, (c >> (k - j - 1)) & 1, sink);
  else
    first_step<F, true>(taps, filt_len, gsrc, g.len[j], buf_b, stage_floats,
                        smem, stride, n, 0, sink);
  float* src = smem;
  for (int lvl = j + 2, t = 1; lvl <= L; ++lvl, ++t) {
    const int rows_in = lvl - 1 <= k ? 1 : 1 << (lvl - 1 - k);
    if (!mirrored) {
      pad_rows(src, rows_in, stride, n, filt_len);
      __syncthreads();
    }
    const int n_out = g.len[lvl];
    const int dst_stride = row_stride(n_out, filt_len);
    float* const dst = (t & 1) ? buf_b : smem;
    mirrored = n_out >= padl + 2;
    sink.mirror = lvl < L && mirrored ? padl : -1;
    sink.log_scale = lvl == L ? g.log_scale : 0;
    if (lvl <= k)
      smem_step<F, false>(taps, filt_len, src, stride, 1, dst, dst_stride,
                          n_out, (c >> (k - lvl)) & 1, sink);
    else
      smem_step<F, true>(taps, filt_len, src, stride, rows_in, dst, dst_stride,
                         n_out, 0, sink);
    __syncthreads();
    src = dst;
    n = n_out;
    stride = dst_stride;
  }
  store_rows(src + padl, stride, out + (frame << L) * static_cast<size_t>(n),
             L - k, c << (L - k), n);
}

// Level ``lvl`` through device memory: in [rows, n_in] -> out [2 * rows,
// n_out] (natural order: row r's children are rows 2r, 2r + 1), rows =
// batch * 2^(lvl-1).  Grid: x over blocks of kLevelThreads windows, y over
// rows.  Each thread loads its window from device memory, reflected at the
// row's ends.
template <int F>
__global__ void __launch_bounds__(kLevelThreads)
wpt_level_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const __grid_constant__ LaunchArgs g, int lvl) {
  constexpr int R = outputs_per_window<F>();
  constexpr int kW = F > 0 ? 2 * R + F - 2 : 2 * R + kWptMaxTaps - 2;
  const int filt_len = F > 0 ? F : g.filt_len;
  const int rows = g.batch << (lvl - 1), n_in = g.len[lvl - 1], n_out = g.len[lvl];
  const int blk = blockIdx.x * kLevelThreads + threadIdx.x;
  if (blk >= (n_out + R - 1) / R) return;
  const int wlen = 2 * R + filt_len - 2;
  const int base = 2 * R * blk - (filt_len - 2);
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* src = in + static_cast<size_t>(r) * n_in;
    float w[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i)
      if (F > 0 || i < wlen) w[i] = __ldg(src + reflect_index(base + i, n_in));
    float* d0 = out + static_cast<size_t>(2 * r) * n_out;
    outputs<F, true, false>(g.taps, filt_len, w, R * blk, n_out, d0, d0 + n_out,
                            0, Sink{-1, 0, 0.f});
  }
}

// Launch on the stream's device: switch only if the calling thread's
// current device differs, and switch back.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

template <int F>
cudaError_t subtree_launch(const float* in, float* out, const LaunchArgs& a,
                           cudaStream_t stream) {
  wpt_subtree_kernel<F><<<a.batch << a.split, a.threads, a.smem_bytes, stream>>>(
      in, out, a);
  return cudaGetLastError();
}

template <int F>
cudaError_t level_launch(const float* in, float* out, const LaunchArgs& a,
                         int lvl, cudaStream_t stream) {
  constexpr int R = outputs_per_window<F>();
  const int rows = a.batch << (lvl - 1);
  const int nblk = (a.len[lvl] + R - 1) / R;
  const dim3 grid((nblk + kLevelThreads - 1) / kLevelThreads,
                  rows < 65535 ? rows : 65535);
  wpt_level_kernel<F><<<grid, kLevelThreads, 0, stream>>>(in, out, a, lvl);
  return cudaGetLastError();
}

template <int F>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(wpt_subtree_kernel<F>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the instance for a filter length: templated ones, else the generic one
template <template <int> class Fn, typename... Args>
cudaError_t dispatch(int filt_len, Args&&... args) {
  switch (filt_len) {
    case 2: return Fn<2>::run(args...);
    case 8: return Fn<8>::run(args...);
    case 10: return Fn<10>::run(args...);
    case 16: return Fn<16>::run(args...);
    case 24: return Fn<24>::run(args...);
    default: return Fn<0>::run(args...);
  }
}

template <int F>
struct SubtreeLaunch {
  static cudaError_t run(const float* in, float* out, const LaunchArgs& a,
                         cudaStream_t s) {
    return subtree_launch<F>(in, out, a, s);
  }
};

template <int F>
struct LevelLaunch {
  static cudaError_t run(const float* in, float* out, const LaunchArgs& a,
                         int lvl, cudaStream_t s) {
    return level_launch<F>(in, out, a, lvl, s);
  }
};

template <int F>
struct AllowSmem {
  static cudaError_t run(int bytes) { return allow_smem<F>(bytes); }
};

bool valid(const LaunchArgs& a) {
  return a.level >= 1 && a.level <= kWptMaxLevel && a.split >= 0 &&
         a.split < a.level && a.in_level >= 0 && a.in_level <= a.split &&
         a.threads >= 32 && a.threads <= kMaxThreads && a.filt_len >= 2 &&
         a.filt_len % 2 == 0 && a.filt_len <= kWptMaxTaps;
}

}  // namespace

extern "C" {

const char* wpt_cascade_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest dynamic shared memory one block may opt into on ``device``, and
// its number of SMs.
int wpt_cascade_device_limits(int device, int* smem_bytes, int* sm_count) {
  cudaError_t err = cudaDeviceGetAttribute(
      smem_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(
      sm_count, cudaDevAttrMultiProcessorCount, device));
}

// Opt every instance of the subtree kernel into ``smem_bytes`` of dynamic
// shared memory on ``device``: once per device, not per call.
int wpt_cascade_prepare(int device, int smem_bytes) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const int lengths[] = {2, 4, 8, 10, 16, 24};  // 4: the generic instance
  for (int f : lengths) {
    const cudaError_t err = dispatch<AllowSmem>(f, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The subtree kernel on ``stream``, without synchronising: ``in`` is level
// a->in_level of the cascade ([B, 2^j, len[j]], natural order); returns
// cudaGetLastError().
int wpt_subtree_launch(const float* in, float* out, const LaunchArgs* a,
                       void* stream) {
  if (!valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(a->device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  return static_cast<int>(dispatch<SubtreeLaunch>(
      a->filt_len, in, out, *a, static_cast<cudaStream_t>(stream)));
}

// Level ``lvl`` (1 <= lvl <= in_level) through device memory on ``stream``:
// [B, 2^(lvl-1), len[lvl-1]] -> [B, 2^lvl, len[lvl]]; returns
// cudaGetLastError().
int wpt_level_launch(const float* in, float* out, const LaunchArgs* a, int lvl,
                     void* stream) {
  if (!valid(*a) || lvl < 1 || lvl > a->in_level)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(a->device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  return static_cast<int>(dispatch<LevelLaunch>(
      a->filt_len, in, out, *a, lvl, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
