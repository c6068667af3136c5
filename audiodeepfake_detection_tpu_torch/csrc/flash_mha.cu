// Multi-head attention from the packed qkv projection, forward and backward,
// with the [B, H, N, N] scores kept out of device memory in both directions.
//
//   qkv [B, N, 3*H*D] (f32 or bf16; lane order [3][head][dim], D = 64)
//     -> out [B, N, H*D] = softmax(q k^T * scale) v per head (qkv's type)
//   training forward also: per-row softmax statistics (max m, sum l) [B, H, N, 2]
//   backward: dqkv [B, N, 3*H*D] (qkv's type) from (qkv, dout, statistics),
//     plus the row term rowsum(dP * P) [B, H, N] as scratch
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/flash_attention.py::
// _fwd_kernel and ::_bwd_kernel (reached through flash_mha_packed).  Those
// run one grid step per batch element with every head's whole 227 x 227 score
// tile in VMEM.  Here a block owns one (query tile of 64 rows, head, batch
// element): 1,536 blocks at B=32, H=12, N=227 for 132 SMs.  The scores of a
// tile live in registers, the probabilities of a tile in shared memory; K and
// V stream through shared memory 64 keys at a time, so any N fits.
//
// Kept from the TPU kernel: what is computed and where it rounds.  Scores,
// softmax and every product accumulate in f32; the probabilities are cast to
// the input type before P.V and before dV (flash_attention.py:74, :91), dS
// is cast before dQ and dK (:102-104), and the backward's row term is
// rowsum(dP * P) computed from the recomputed probabilities, as there (not
// the rowsum(dO * O) shortcut, which differs once O is rounded to bf16).
// The forward takes two passes over the keys: the first finds each row's max
// and sum, the second forms p = exp(s - m) / l exactly as the TPU kernel's
// softmax does, rounds it and multiplies by V.  The backward recomputes P
// from qkv and the saved (m, l), bit for bit the forward's.
//
// Backward without atomics (bit-for-bit reproducible): a dQ kernel per query
// tile walks the keys twice (first for the row term, then for dS.K) and
// writes the row term; a dK/dV kernel per key tile then walks every query
// tile.  Every element of dqkv is written by exactly one thread.
//
// What bounds it on the H100: operations.  At B=32, N=227, H=12 the forward
// needs 2 N^2 D H B flops for each of q.k^T and p.v (5.1 GFLOP, 76 us at
// 67 TFLOP/s f32) against 89 MB moved (27 us); the backward five such
// products.  This first version runs on the f32 FMA pipe from shared memory
// (4 x 4 outputs a thread, 256 threads), which keeps f32 parity (TF32 tensor
// cores would not) but does not reach the FMA peak either: the forward
// computes q.k^T twice, the backward q.k^T and dO.V^T four times in all.
// Tensor-core (mma / wgmma) bf16 paths and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/flash_attention_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;          // head width
constexpr int kTile = 64;       // query rows / key rows per tile
constexpr int kLd = kD + 1;     // shared-memory row stride: conflict-free columns
constexpr int kTileFloats = kTile * kLd;
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// Rows [row0, row0 + 64) of one 64-wide slice (src points at the slice's
// first column of row 0; rows are `stride` elements apart) into a [64][kLd]
// f32 tile; rows at or past n are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int stride,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    const int row = row0 + r;
    dst[r * kLd + c] = row < n ? to_float(src[(size_t)row * stride + c]) : 0.f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over the head width
__device__ __forceinline__ void dot_rows(const float* a, const float* b,
                                        float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r w[r][row(i)] * x[r][tx + 16 j] over a tile's 64 rows,
// where row(i) = ty + 16 i indexes w's columns when `transposed`, else w is
// read as w[row(i)][r].
template <bool kTransposed>
__device__ __forceinline__ void accumulate(const float* w, const float* x,
                                           float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float wv[4], xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wv[i] = kTransposed ? w[r * kLd + ty + 16 * i] : w[(ty + 16 * i) * kLd + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = x[r * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
  }
}

// s = (q . k) * scale, rounded as a product of its own (no multiply-add
// contraction into the softmax's subtraction): the TPU kernel's order.
__device__ __forceinline__ void scale_scores(float (&s)[4][4], float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = __fmul_rn(s[i][j], scale);
}

// Reductions over the 16 threads that share a row (one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One (query tile, head, batch element) per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_mha_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                         float* __restrict__ stats, int n, int heads,
                         float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTileFloats;
  float* vs = ks + kTileFloats;
  float* ps = vs + kTileFloats;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * kD, c = 3 * hd;
  const T* base = qkv + (size_t)b * n * c + h * kD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(qs, base, c, q0, n);
  float m[4], l[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  // pass 1: row max and sum of exp(s - max), rescaled as the max grows
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    load_tile(ks, base + hd, c, k0, n);
    __syncthreads();
    dot_rows(qs, ks, s);
    scale_scores(s, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < n) tmax = fmaxf(tmax, s[i][j]);
      const float mnew = fmaxf(m[i], row_max(tmax));
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < n) tsum += expf(s[i][j] - mnew);
      l[i] = l[i] * expf(m[i] - mnew) + row_sum(tsum);
      m[i] = mnew;
    }
  }
  // pass 2: p = exp(s - m) / l, rounded to the input type, times V
  float acc[4][4] = {};
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    load_tile(ks, base + hd, c, k0, n);
    load_tile(vs, base + 2 * hd, c, k0, n);
    __syncthreads();
    dot_rows(qs, ks, s);
    scale_scores(s, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx + 16 * j < n ? expf(s[i][j] - m[i]) / l[i] : 0.f;
        ps[(ty + 16 * i) * kLd + tx + 16 * j] = round_to(p, qkv);
      }
    __syncthreads();
    accumulate<false>(ps, vs, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(acc[i][j], out + ((size_t)b * n + row) * hd + h * kD + tx + 16 * j);
    if (stats != nullptr && tx == 0) {
      float* st = stats + (((size_t)b * heads + h) * n + row) * 2;
      st[0] = m[i];
      st[1] = l[i];
    }
  }
}

// dQ and the row term, one (query tile, head, batch element) per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_mha_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                            const float* __restrict__ stats,
                            float* __restrict__ delta, T* __restrict__ dqkv,
                            int n, int heads, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTileFloats;
  float* ks = dos + kTileFloats;
  float* vs = ks + kTileFloats;
  float* dss = vs + kTileFloats;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * kD, c = 3 * hd;
  const T* base = qkv + (size_t)b * n * c + h * kD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t row_stats = ((size_t)b * heads + h) * n;

  load_tile(qs, base, c, q0, n);
  load_tile(dos, dout + (size_t)b * n * hd + h * kD, hd, q0, n);
  float m[4], l[4], dsum[4], s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    m[i] = row < n ? stats[(row_stats + row) * 2] : 0.f;
    l[i] = row < n ? stats[(row_stats + row) * 2 + 1] : 1.f;
    dsum[i] = 0.f;
  }
  // pass A: the row term rowsum(dP * P)
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    load_tile(ks, base + hd, c, k0, n);
    load_tile(vs, base + 2 * hd, c, k0, n);
    __syncthreads();
    dot_rows(qs, ks, s);
    scale_scores(s, scale);
    dot_rows(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < n)
          dsum[i] += dp[i][j] * (expf(s[i][j] - m[i]) / l[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dsum[i] = row_sum(dsum[i]);
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < n) delta[row_stats + row] = dsum[i];
  }
  // pass B: dS = P * (dP - rowterm) * scale, rounded; dQ = dS . K
  float acc[4][4] = {};
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    load_tile(ks, base + hd, c, k0, n);
    load_tile(vs, base + 2 * hd, c, k0, n);
    __syncthreads();
    dot_rows(qs, ks, s);
    scale_scores(s, scale);
    dot_rows(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds = 0.f;
        if (k0 + tx + 16 * j < n) {
          const float p = expf(s[i][j] - m[i]) / l[i];
          ds = p * (dp[i][j] - dsum[i]) * scale;
        }
        dss[(ty + 16 * i) * kLd + tx + 16 * j] = round_to(ds, qkv);
      }
    __syncthreads();
    accumulate<false>(dss, ks, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(acc[i][j], dqkv + ((size_t)b * n + row) * c + h * kD + tx + 16 * j);
  }
}

// dK and dV, one (key tile, head, batch element) per block, walking every
// query tile in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_mha_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                             const float* __restrict__ stats,
                             const float* __restrict__ delta, T* __restrict__ dqkv,
                             int n, int heads, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;
  float* dos = qs + kTileFloats;
  float* ps = dos + kTileFloats;
  float* dss = ps + kTileFloats;
  float* row_m = dss + kTileFloats;
  float* row_l = row_m + kTile;
  float* row_d = row_l + kTile;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * kD, c = 3 * hd;
  const T* base = qkv + (size_t)b * n * c + h * kD;
  const T* dbase = dout + (size_t)b * n * hd + h * kD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t row_stats = ((size_t)b * heads + h) * n;

  load_tile(ks, base + hd, c, k0, n);
  load_tile(vs, base + 2 * hd, c, k0, n);
  float s[4][4], dp[4][4], dk[4][4] = {}, dv[4][4] = {};
  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();
    load_tile(qs, base, c, q0, n);
    load_tile(dos, dbase, hd, q0, n);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < n;
      row_m[threadIdx.x] = ok ? stats[(row_stats + row) * 2] : 0.f;
      row_l[threadIdx.x] = ok ? stats[(row_stats + row) * 2 + 1] : 1.f;
      row_d[threadIdx.x] = ok ? delta[row_stats + row] : 0.f;
    }
    __syncthreads();
    // this thread's (query ty + 16 i, key tx + 16 j) entries of P and dS
    dot_rows(qs, ks, s);
    scale_scores(s, scale);
    dot_rows(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = 0.f, ds = 0.f;
        if (q0 + r < n && k0 + tx + 16 * j < n) {
          p = expf(s[i][j] - row_m[r]) / row_l[r];
          ds = p * (dp[i][j] - row_d[r]) * scale;
        }
        ps[r * kLd + tx + 16 * j] = round_to(p, qkv);
        dss[r * kLd + tx + 16 * j] = round_to(ds, qkv);
      }
    }
    __syncthreads();
    // dV += P^T . dO and dK += dS^T . Q for keys ty + 16 i, dims tx + 16 j
    accumulate<true>(ps, dos, dv);
    accumulate<true>(dss, qs, dk);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= n) continue;
    T* dst = dqkv + ((size_t)b * n + row) * c + h * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store(dk[i][j], dst + hd + tx + 16 * j);
      store(dv[i][j], dst + 2 * hd + tx + 16 * j);
    }
  }
}

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDqSmem = 5 * kTileFloats * sizeof(float);
constexpr size_t kDkvSmem = (6 * kTileFloats + 3 * kTile) * sizeof(float);

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int fwd(const void* qkv, void* out, void* stats, int b, int n, int heads,
        float scale, cudaStream_t s) {
  cudaError_t err = allow_smem(flash_mha_fwd_kernel<T>, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  flash_mha_fwd_kernel<T><<<grid, kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), static_cast<float*>(stats),
      n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* qkv, const void* dout, const void* stats, void* delta,
        void* dqkv, int b, int n, int heads, float scale, cudaStream_t s) {
  cudaError_t err = allow_smem(flash_mha_bwd_dq_kernel<T>, kDqSmem);
  if (err == cudaSuccess) err = allow_smem(flash_mha_bwd_dkv_kernel<T>, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  flash_mha_bwd_dq_kernel<T><<<grid, kThreads, kDqSmem, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<float*>(delta),
      static_cast<T*>(dqkv), n, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mha_bwd_dkv_kernel<T><<<grid, kThreads, kDkvSmem, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<T*>(dqkv), n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// stats may be null (inference: no statistics written).
int flash_mha_fwd_launch(const void* qkv, void* out, void* stats, int b, int n,
                         int heads, float scale, int is_bf16, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<__nv_bfloat16>(qkv, out, stats, b, n, heads, scale, s)
                 : fwd<float>(qkv, out, stats, b, n, heads, scale, s);
}

int flash_mha_bwd_launch(const void* qkv, const void* dout, const void* stats,
                         void* delta, void* dqkv, int b, int n, int heads,
                         float scale, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? bwd<__nv_bfloat16>(qkv, dout, stats, delta, dqkv, b, n, heads, scale, s)
             : bwd<float>(qkv, dout, stats, delta, dqkv, b, n, heads, scale, s);
}

int flash_mha_head_dim() { return kD; }

const char* flash_mha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
