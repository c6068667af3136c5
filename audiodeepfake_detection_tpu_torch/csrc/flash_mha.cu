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
// tile in VMEM: S once, the exact softmax, P rounded to the input type before
// P.V.  Kept from them: what is computed and where it rounds.  Scores,
// softmax and every product accumulate in f32 (s = dot * scale by __fmul_rn,
// no contraction into the softmax); P is rounded to the input type before
// P.V and before dV (flash_attention.py:74, :91), dS before dQ and dK
// (:102-104); the backward's row term is rowsum(dP * P) from the recomputed
// probabilities, as there (not the rowsum(dO * O) shortcut, which differs
// once O is rounded to bf16).  The backward recomputes P from qkv and the
// saved (m, l), bit for bit the forward's.
//
// What bounds it on the H100: operations.  At B=32, N=227, H=12 each N^2 D
// product is 2 N^2 D H B = 2.5 GFLOP: the forward needs two (q.k^T, p.v;
// 76 us at 67 TFLOP/s f32) against 89 MB moved (27 us), the backward five
// (dP, dV, dQ, dK and S again).
//
// Two routes, chosen by geometry in ops/flash_attention_cuda.py, both without
// atomics (every output element is summed by one thread in a fixed order, so
// runs repeat bit for bit):
//
// * Resident (N <= 256, the AST's N = 227): a block owns a 64-row query
//   tile of one (batch element, head) and holds that tile's scores for the
//   whole key range in shared memory (64 x 244 f32 = 61 KB at N = 227), as
//   the TPU kernel holds them in VMEM.  Forward (4 warps): K tiles then V
//   tiles stream through a cp.async ring (two tiles deep in fp32, four in
//   bf16, whose mma products take less time than a load); S = Q K^T *
//   scale tile by tile, the exact softmax of each whole row (max,
//   exp(s - m), sum, divide; P written over S), O = P V: two products.
//   The row passes hold four rows a warp in registers and divide by the
//   row sum with a branch-free, correctly rounded sequence (IEEE
//   division's slow-path check had put each element in a branch region of
//   its own and made the softmax the largest part of a bf16 block's time).
//   Backward (two warpgroups of 4 warps, one splitting each step's products
//   with the other; rings of three (Q, dO) or (K, V) pairs, two in the fp32
//   query side, which holds 227 KB at N = 256): a query-tile kernel keeps
//   P and dP for the whole key range, forms the row term and dS in one pass
//   over the resident rows and walks the K tiles again for dQ = dS K
//   (three products: S, dP, dQ); a key-tile kernel streams (Q, dO) tiles
//   and computes S and dP again, then dV = P^T dO and dK = dS^T Q (four):
//   seven products for the five the bound counts, the price of no atomics
//   and no [B, H, N, N] scratch.  f32 runs on the FMA
//   pipe (parity mode, no TF32): 8 x 4 outputs a thread, float4 shared-
//   memory loads (12 per 128 FMAs) from XOR-swizzled 64-float rows that hit
//   every bank once.  bf16 keeps its tiles in bf16 and runs every product
//   as mma.sync m16n8k16 (bf16 in, f32 sums) with ldmatrix fragments; P and
//   dS, rounded to bf16 where the TPU kernel rounds them, are written as
//   bf16 over their f32 rows and become the next mma's A operand; softmax,
//   statistics, dP and the row term stay f32.
// * Streaming (any N; the route above N = 256): the first version.  A block
//   of 256 threads owns a 64-row query tile; K and V stream through shared
//   memory 64 keys at a time, so any N fits.  The forward takes two passes
//   over the keys (row max and sum, then p = exp(s - m) / l rounded and
//   multiplied by V): three products.  The backward's dQ kernel walks the
//   keys twice (the row term, then dS.K) and its dK/dV kernel computes S and
//   dP again: nine products.  4 x 4 outputs a thread with scalar loads (8
//   per 16 FMAs, bound by shared-memory bandwidth), synchronous loads, and
//   bf16 converted to f32 in shared memory (no tensor cores).
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

// ------------------------------------------------------------------------
// Resident route (N <= kMaxResident): a block holds a query tile's scores for
// the whole key range, so each product is computed once.

constexpr int kFwdThreads = 128;  // one 64-row query tile: 4 warps
constexpr int kBwdThreads = 256;  // two warpgroups of 4 warps
constexpr int kMaxResident = 256;

// A 64 x 64 operand tile streamed into shared memory by cp.async, 16 bytes
// (`kElems` values) a copy.  fp32: rows of 64 floats, chunk cc of row r at
// chunk cc ^ (r & 7), so the float4 reads of 8 rows or of 16 chunks hit all
// 32 banks.  bf16: rows padded to 72 values (144 bytes), conflict-free for
// ldmatrix.
template <typename T> struct Op;
template <> struct Op<float> {
  static constexpr int kElems = 4, kLd = kD;
  __device__ static int chunk(int r, int cc) { return r * kLd + ((cc ^ (r & 7)) << 2); }
};
template <> struct Op<__nv_bfloat16> {
  static constexpr int kElems = 8, kLd = kD + 8;
  __device__ static int chunk(int r, int cc) { return r * kLd + (cc << 3); }
};
// Row stride of a plain row-major 64 x 64 tile the kernels write themselves
// (P and dS of the key side): 16-byte rows, float4 / ldmatrix reads
// conflict-free.
template <typename T> struct PlainLd;
template <> struct PlainLd<float> { static constexpr int value = kD + 4; };
template <> struct PlainLd<__nv_bfloat16> { static constexpr int value = kD + 8; };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [row0, row0 + 64) of a 64-wide slice (src: the slice's column 0 of
// row 0; rows `stride` elements apart; row0 < n) into an operand tile; rows
// at or past n are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int stride,
                                                int row0, int n) {
  constexpr int kChunks = kD / Op<T>::kElems;
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, cc = i % kChunks;
    const bool ok = row0 + r < n;
    cp_async16(dst + Op<T>::chunk(r, cc),
               src + static_cast<size_t>(ok ? row0 + r : row0) * stride + cc * Op<T>::kElems,
               ok);
  }
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The three 64 x 64 tile products of one warpgroup (threads tid & 127),
// accumulated into float acc[8][4]:
//   nt: acc(i, j) += sum_k a[i][k] * b[j][k]  (S = Q K^T, dP = dO V^T)
//       a, b operand tiles
//   nn: acc(i, d) += sum_k a[i][k] * b[k][d]  (O = P V, dQ = dS K)
//       a row-major with stride lda, k < kext; b an operand tile
//   tn: acc(j, d) += sum_i a[i][j] * b[i][d]  (dV = P^T dO, dK = dS^T Q)
//       a a plain tile (stride lda), b an operand tile
// and the element -> (row, col) map of each.  fp32: the FMA pipe, 8 x 4
// outputs a thread, 12 float4 shared-memory loads per 128 FMAs.  bf16:
// mma.sync m16n8k16 (bf16 in, fp32 sums), one warp per 16 rows, fragments
// by ldmatrix.
template <typename T> struct Tile;

template <> struct Tile<float> {
  using Ld = Op<float>;
  __device__ static int ty() { return (threadIdx.x & 127) >> 4; }
  __device__ static int tx() { return threadIdx.x & 15; }
  __device__ static int nt_row(int r, int) { return ty() + 8 * r; }
  __device__ static int nt_col(int, int c) { return tx() + 16 * c; }
  __device__ static int nn_row(int r, int) { return ty() + 8 * r; }
  __device__ static int nn_col(int, int c) { return 4 * tx() + c; }
  __device__ static int tn_row(int r, int) { return 8 * ty() + r; }
  __device__ static int tn_col(int, int c) { return 4 * tx() + c; }

  __device__ static void nt(const float* a, const float* b, float (&acc)[8][4]) {
    // rows ty + 8 r of a share the swizzle key ty & 7, rows tx + 16 c of b tx & 7
    const float* ar = a + ty() * Ld::kLd;
    const float* br = b + tx() * Ld::kLd;
    const int sa = ty() & 7, sb = tx() & 7;
#pragma unroll 2
    for (int kc = 0; kc < kD / 4; ++kc) {
      float4 av[8], bv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        av[r] = *reinterpret_cast<const float4*>(ar + 8 * r * Ld::kLd + ((kc ^ sa) << 2));
#pragma unroll
      for (int c = 0; c < 4; ++c)
        bv[c] = *reinterpret_cast<const float4*>(br + 16 * c * Ld::kLd + ((kc ^ sb) << 2));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(lane4(av[r], kk), lane4(bv[c], kk), acc[r][c]);
    }
  }

  __device__ static void nn(const float* a, int lda, const float* b, int kext,
                            float (&acc)[8][4]) {
    const float* ar = a + ty() * lda;
#pragma unroll 2
    for (int k = 0; k < kext; k += 4) {
      float4 av[8], bv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        av[r] = *reinterpret_cast<const float4*>(ar + 8 * r * lda + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bv[kk] = *reinterpret_cast<const float4*>(b + Ld::chunk(k + kk, tx()));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(lane4(av[r], kk), lane4(bv[kk], c), acc[r][c]);
    }
  }

  __device__ static void tn(const float* a, int lda, const float* b, float (&acc)[8][4]) {
    const float* ac = a + 8 * ty();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const float4 a0 = *reinterpret_cast<const float4*>(ac + i * lda);
      const float4 a1 = *reinterpret_cast<const float4*>(ac + i * lda + 4);
      const float4 bv = *reinterpret_cast<const float4*>(b + Ld::chunk(i, tx()));
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(lane4(r < 4 ? a0 : a1, r & 3), lane4(bv, c), acc[r][c]);
    }
  }
};

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp w (of the warpgroup) owns rows 16w .. 16w + 15 of every product;
// acc[nb][e] is the mma accumulator of columns 8 nb .. 8 nb + 7: row 16w + g
// + 8 (e >> 1), column 8 nb + 2 t + (e & 1), for lane = 4 g + t.
template <> struct Tile<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  static constexpr int kLd = Op<bf16>::kLd;
  __device__ static int warp() { return (threadIdx.x >> 5) & 3; }
  __device__ static int lane() { return threadIdx.x & 31; }
  __device__ static int nt_row(int, int e) {
    return 16 * warp() + (lane() >> 2) + 8 * (e >> 1);
  }
  __device__ static int nt_col(int nb, int e) { return 8 * nb + 2 * (lane() & 3) + (e & 1); }
  __device__ static int nn_row(int nb, int e) { return nt_row(nb, e); }
  __device__ static int nn_col(int nb, int e) { return nt_col(nb, e); }
  __device__ static int tn_row(int nb, int e) { return nt_row(nb, e); }
  __device__ static int tn_col(int nb, int e) { return nt_col(nb, e); }

  __device__ static void nt(const bf16* a, const bf16* b, float (&acc)[8][4]) {
    const int l = lane();
    const bf16* ap = a + (16 * warp() + (l & 15)) * kLd + 8 * (l >> 4);
    const bf16* bp = b + ((l & 7) + 8 * (l >> 4)) * kLd + 8 * ((l >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      unsigned af[4];
      ldsm_x4(af, ap + 16 * ks);
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        unsigned bf[4];
        ldsm_x4(bf, bp + 16 * nb2 * kLd + 16 * ks);
        mma_bf16(acc[2 * nb2], af, bf[0], bf[1]);
        mma_bf16(acc[2 * nb2 + 1], af, bf[2], bf[3]);
      }
    }
  }

  __device__ static void nn(const bf16* a, int lda, const bf16* b, int kext,
                            float (&acc)[8][4]) {
    const int l = lane();
    const bf16* ap = a + (16 * warp() + (l & 15)) * lda + 8 * (l >> 4);
    const bf16* bp = b + ((l & 7) + 8 * ((l >> 3) & 1)) * kLd + 8 * (l >> 4);
    for (int ks = 0; ks < kext / 16; ++ks) {
      unsigned af[4];
      ldsm_x4(af, ap + 16 * ks);
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        unsigned bf[4];
        ldsm_x4_trans(bf, bp + 16 * ks * kLd + 16 * nb2);
        mma_bf16(acc[2 * nb2], af, bf[0], bf[1]);
        mma_bf16(acc[2 * nb2 + 1], af, bf[2], bf[3]);
      }
    }
  }

  __device__ static void tn(const bf16* a, int lda, const bf16* b, float (&acc)[8][4]) {
    const int l = lane();
    const bf16* ap = a + ((l & 7) + 8 * (l >> 4)) * lda + 16 * warp() + 8 * ((l >> 3) & 1);
    const bf16* bp = b + ((l & 7) + 8 * ((l >> 3) & 1)) * kLd + 8 * (l >> 4);
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      unsigned af[4];
      ldsm_x4_trans(af, ap + 16 * ks * lda);
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        unsigned bf[4];
        ldsm_x4_trans(bf, bp + 16 * ks * kLd + 16 * nb2);
        mma_bf16(acc[2 * nb2], af, bf[0], bf[1]);
        mma_bf16(acc[2 * nb2 + 1], af, bf[2], bf[3]);
      }
    }
  }
};

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Depth of each kernel's cp.async ring of streamed tiles (pairs of tiles in
// the backward): a bf16 tile's mma products take about a microsecond, no
// longer than a load, so its rings prefetch two or three tiles ahead; fp32
// rings are as deep as shared memory allows without costing a block an SM
// (the forward's two blocks; the query side holds 227 KB at N = 256).
template <typename T> struct Ring;
template <> struct Ring<float> { static constexpr int kFwd = 2, kDq = 2, kDkv = 3; };
template <> struct Ring<__nv_bfloat16> { static constexpr int kFwd = 4, kDq = 3, kDkv = 3; };

// Geometry of the resident route: kept key columns (N rounded up to 16, the
// mma depth), the fp32 score row stride, and the 64-key tiles.
struct Resident {
  int ns, lds, nt;
  __host__ __device__ explicit Resident(int n)
      : ns((n + 15) & ~15), lds(((n + 15) & ~15) + 4), nt((n + kTile - 1) / kTile) {}
};

// p = e / l, correctly rounded for the operands of a softmax (e in [0, 1],
// l >= 1; inv_l = 1.f / l): q = e * inv_l, then one exact residual and a
// fused correction (Markstein), with no branch.  IEEE division's slow-path
// check puts every element of a row in a branch region of its own, which
// serialised the row passes on the special-function unit's latency.
__device__ __forceinline__ float div_by_sum(float e, float l, float inv_l) {
  const float q = __fmul_rn(e, inv_l);
  return fmaf(fmaf(-q, l, e), inv_l, q);
}

// Keys a lane holds of one row (N <= kMaxResident), and rows a warp works on
// at once in the row passes: the loads, exps and divides of a row and of the
// rows beside it are independent, so a pass waits on memory and shuffles
// once per group of rows rather than once per key.
constexpr int kRowKeys = kMaxResident / 32;
constexpr int kRowGroup = 4;

// The exact softmax of each score row in place (s: float [64][lds]), 64 /
// warps rows a warp, lanes over keys: row max m, e = exp(s - m), l = sum e,
// p = e / l rounded to T and written as T over the row's first bytes
// (columns [n, ns) set to 0) once the whole row is in registers.  Keys past
// n enter as -inf, so exp gives them 0 without a branch.
template <typename T>
__device__ void softmax_rows(float* s, int lds, int n, int ns, float* stats, int q0) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = kTile / (blockDim.x >> 5);
  for (int r0 = 0; r0 < per_warp; r0 += kRowGroup) {
    float v[kRowGroup][kRowKeys], m[kRowGroup], l[kRowGroup];
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) {
      const float* sr = s + (per_warp * w + r0 + q) * lds;
      m[q] = -INFINITY;
#pragma unroll
      for (int i = 0; i < kRowKeys; ++i) {
        const int j = lane + 32 * i;
        v[q][i] = j < n ? sr[j] : -INFINITY;
        m[q] = fmaxf(m[q], v[q][i]);
      }
    }
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) m[q] = warp_max(m[q]);
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) {
      l[q] = 0.f;
#pragma unroll
      for (int i = 0; i < kRowKeys; ++i) {
        v[q][i] = expf(v[q][i] - m[q]);
        l[q] += v[q][i];
      }
    }
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) l[q] = warp_sum(l[q]);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) {
      const int row = per_warp * w + r0 + q;
      T* pr = reinterpret_cast<T*>(s + row * lds);
      const float inv_l = 1.f / l[q];
#pragma unroll
      for (int i = 0; i < kRowKeys; ++i) {
        const int j = lane + 32 * i;
        if (j < ns) store(div_by_sum(v[q][i], l[q], inv_l), pr + j);
      }
      if (stats != nullptr && lane == 0 && q0 + row < n) {
        stats[(q0 + row) * 2] = m[q];
        stats[(q0 + row) * 2 + 1] = l[q];
      }
    }
  }
}

// Forward, one (query tile, head, batch element) per block of 4 warps.  K
// tiles then V tiles stream through a cp.async ring: S = Q K^T *
// scale into shared memory tile by tile, the exact softmax over the whole
// row, then O = P V.  Two N^2 D products.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    flash_mha_resident_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                                  float* __restrict__ stats, int n, int heads, float scale) {
  using Ops = Tile<T>;
  constexpr int kTileElems = kTile * Op<T>::kLd;
  const Resident g(n);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRing = Ring<T>::kFwd;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ring = qs + kTileElems;
  float* sbuf = reinterpret_cast<float*>(ring + kRing * kTileElems);
  const T* pbuf = reinterpret_cast<const T*>(sbuf);
  const int ldp = g.lds * static_cast<int>(sizeof(float) / sizeof(T));
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * kD, c = 3 * hd;
  const T* base = qkv + static_cast<size_t>(b) * n * c + h * kD;

  const int tiles = 2 * g.nt;  // K_0 .. K_{nt-1}, V_0 .. V_{nt-1}
  // one commit group per tile (empty past the last), so that waiting for all
  // but the newest kRing - 1 groups waits for tile u
  auto issue = [&](int v) {
    if (v < tiles)
      load_tile_async(ring + (v % kRing) * kTileElems, base + (v < g.nt ? hd : 2 * hd), c,
                      (v < g.nt ? v : v - g.nt) * kTile, n);
    cp_async_commit();
  };
  load_tile_async(qs, base, c, q0, n);
  for (int v = 0; v < kRing - 1; ++v) issue(v);
  float acc[8][4];
  zero(acc);
  for (int u = 0; u < tiles; ++u) {
    issue(u + kRing - 1);
    cp_async_wait<kRing - 1>();
    __syncthreads();
    const T* tile = ring + (u % kRing) * kTileElems;
    if (u < g.nt) {
      float st[8][4];
      zero(st);
      Ops::nt(qs, tile, st);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = u * kTile + Ops::nt_col(r, e);
          if (col < g.ns) sbuf[Ops::nt_row(r, e) * g.lds + col] = __fmul_rn(st[r][e], scale);
        }
      if (u == g.nt - 1) {
        __syncthreads();
        softmax_rows<T>(sbuf, g.lds, n, g.ns,
                        stats == nullptr ? nullptr
                                         : stats + (static_cast<size_t>(b) * heads + h) * n * 2,
                        q0);
      }
    } else {
      const int t = u - g.nt;
      Ops::nn(pbuf + t * kTile, ldp, tile, min(kTile, g.ns - t * kTile), acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + Ops::nn_row(r, e);
      if (row < n)
        store(acc[r][e], out + (static_cast<size_t>(b) * n + row) * hd + h * kD +
                             Ops::nn_col(r, e));
    }
}

// Backward, query side: one (query tile, head, batch element) per block of
// two warpgroups.  (K_t, V_t) pairs stream through a cp.async ring of
// pairs; warpgroup 0 forms P = exp(S - m) / l from S = Q K_t^T (the
// forward's values bit for bit), warpgroup 1 dP = dO V_t^T, both kept in
// shared memory for the whole key range.  One pass over the resident rows
// gives the row term rowsum(dP * P) (written for the key side) and dS =
// P * (dP - rowterm) * scale rounded to T.  Then (K_{2m}, K_{2m+1}) pairs:
// warpgroup w sums dS K over the key tiles of parity w, and the two halves
// are added in a fixed order.  Three N^2 D products.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    flash_mha_resident_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                 const float* __restrict__ stats, float* __restrict__ delta,
                                 T* __restrict__ dqkv, int n, int heads, float scale) {
  using Ops = Tile<T>;
  constexpr int kTileElems = kTile * Op<T>::kLd;
  const Resident g(n);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRing = Ring<T>::kDq;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kTileElems;
  T* ring = qs + 2 * kTileElems;  // kRing slots of two tiles
  float* pbuf = reinterpret_cast<float*>(ring + 2 * kRing * kTileElems);
  float* dpbuf = pbuf + kTile * g.lds;
  float* row_m = dpbuf + kTile * g.lds;
  float* row_l = row_m + kTile;
  float* row_r = row_l + kTile;  // 1 / l
  const int ldp = g.lds * static_cast<int>(sizeof(float) / sizeof(T));
  const int wg = threadIdx.x >> 7;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * kD, c = 3 * hd;
  const T* base = qkv + static_cast<size_t>(b) * n * c + h * kD;
  const size_t row_stats = (static_cast<size_t>(b) * heads + h) * n;
  // stages 0 .. nt-1: (K_t, V_t); then (K_{2m}, K_{2m+1}) for dQ
  const int stages = g.nt + (g.nt + 1) / 2;
  auto issue = [&](int st) {  // one commit group per stage, as in the forward
    T* slot = ring + 2 * (st % kRing) * kTileElems;
    if (st < g.nt) {
      load_tile_async(slot, base + hd, c, st * kTile, n);
      load_tile_async(slot + kTileElems, base + 2 * hd, c, st * kTile, n);
    } else if (st < stages) {
      const int t = 2 * (st - g.nt);
      load_tile_async(slot, base + hd, c, t * kTile, n);
      if (t + 1 < g.nt) load_tile_async(slot + kTileElems, base + hd, c, (t + 1) * kTile, n);
    }
    cp_async_commit();
  };

  load_tile_async(qs, base, c, q0, n);
  load_tile_async(dos, dout + static_cast<size_t>(b) * n * hd + h * kD, hd, q0, n);
  for (int st = 0; st < kRing - 1; ++st) issue(st);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    row_m[threadIdx.x] = row < n ? stats[(row_stats + row) * 2] : 0.f;
    row_l[threadIdx.x] = row < n ? stats[(row_stats + row) * 2 + 1] : 1.f;
    row_r[threadIdx.x] = 1.f / row_l[threadIdx.x];
  }
  float acc[8][4];
  zero(acc);
  for (int st = 0; st < stages; ++st) {
    issue(st + kRing - 1);
    cp_async_wait<kRing - 1>();
    __syncthreads();
    const T* slot = ring + (2 * (st % kRing) + wg) * kTileElems;  // this warpgroup's tile
    if (st < g.nt) {
      float pr[8][4];
      zero(pr);
      Ops::nt(wg ? dos : qs, slot, pr);
      float* dst = wg ? dpbuf : pbuf;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = Ops::nt_row(r, e), col = st * kTile + Ops::nt_col(r, e);
          if (col >= g.ns) continue;
          float v = pr[r][e];
          if (wg == 0) {  // P, the forward's arithmetic; 0 past the last key
            const float p =
                div_by_sum(expf(__fmul_rn(v, scale) - row_m[row]), row_l[row], row_r[row]);
            v = col < n ? p : 0.f;
          }
          dst[row * g.lds + col] = v;
        }
      if (st == g.nt - 1) {
        // the row term and dS, 8 rows a warp, lanes over keys, two rows at
        // once held in registers; dS (type T) is written over P's row
        __syncthreads();
        const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
        constexpr int kPerWarp = kTile / (kBwdThreads / 32), kGroup = 2;
        for (int r0 = 0; r0 < kPerWarp; r0 += kGroup) {
          float pv[kGroup][kRowKeys], dpv[kGroup][kRowKeys], d[kGroup];
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            const int row = kPerWarp * w + r0 + q;
            d[q] = 0.f;
#pragma unroll
            for (int i = 0; i < kRowKeys; ++i) {
              const int j = lane + 32 * i;
              pv[q][i] = j < n ? pbuf[row * g.lds + j] : 0.f;
              dpv[q][i] = j < n ? dpbuf[row * g.lds + j] : 0.f;
              d[q] += dpv[q][i] * pv[q][i];
            }
          }
#pragma unroll
          for (int q = 0; q < kGroup; ++q) d[q] = warp_sum(d[q]);
          __syncwarp();
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            const int row = kPerWarp * w + r0 + q;
            if (lane == 0 && q0 + row < n) delta[row_stats + q0 + row] = d[q];
            T* dsr = reinterpret_cast<T*>(pbuf + row * g.lds);
#pragma unroll
            for (int i = 0; i < kRowKeys; ++i) {
              const int j = lane + 32 * i;
              if (j < g.ns) store(pv[q][i] * (dpv[q][i] - d[q]) * scale, dsr + j);
            }
          }
        }
      }
    } else {
      const int t = 2 * (st - g.nt) + wg;
      if (t < g.nt)
        Ops::nn(reinterpret_cast<const T*>(pbuf) + t * kTile, ldp, slot,
                min(kTile, g.ns - t * kTile), acc);
    }
    __syncthreads();
  }
  // dQ = (even key tiles) + (odd key tiles), through the free Q / dO tiles
  float* half = reinterpret_cast<float*>(qs);
  const int lt = threadIdx.x & 127;
  if (wg == 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) half[(r * 4 + e) * 128 + lt] = acc[r][e];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + Ops::nn_row(r, e);
      if (row < n)
        store(acc[r][e] + half[(r * 4 + e) * 128 + lt],
              dqkv + (static_cast<size_t>(b) * n + row) * c + h * kD + Ops::nn_col(r, e));
    }
}

// Backward, key side: one (key tile, head, batch element) per block of two
// warpgroups, K and V resident, (Q, dO) tile pairs of every query tile
// through a cp.async ring.  Per query tile: warpgroup 0 computes S,
// warpgroup 1 dP (two products); warpgroup 0 forms P and dS from the saved
// statistics and row term, rounded to T into shared memory; then warpgroup 0
// sums dV += P^T dO and warpgroup 1 dK += dS^T Q (two more).  Four N^2 D
// products; every element of dK and dV is summed by one thread in a fixed
// order.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    flash_mha_resident_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                  const float* __restrict__ stats,
                                  const float* __restrict__ delta, T* __restrict__ dqkv,
                                  int n, int heads, float scale) {
  using Ops = Tile<T>;
  constexpr int kTileElems = kTile * Op<T>::kLd;
  constexpr int kPlain = PlainLd<T>::value;
  constexpr int kPlainF = PlainLd<float>::value;
  const Resident g(n);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRing = Ring<T>::kDkv;
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kTileElems;
  T* ring = ks + 2 * kTileElems;  // kRing slots of (Q, dO) tiles
  T* pt = ring + 2 * kRing * kTileElems;
  T* dst = pt + kTile * kPlain;
  float* dpt = reinterpret_cast<float*>(dst + kTile * kPlain);
  float* row_m = dpt + kTile * kPlainF;
  float* row_l = row_m + kTile;
  float* row_d = row_l + kTile;
  float* row_r = row_d + kTile;  // 1 / l
  const int wg = threadIdx.x >> 7;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * kD, c = 3 * hd;
  const T* base = qkv + static_cast<size_t>(b) * n * c + h * kD;
  const T* dbase = dout + static_cast<size_t>(b) * n * hd + h * kD;
  const size_t row_stats = (static_cast<size_t>(b) * heads + h) * n;

  auto issue = [&](int s) {  // one commit group per query tile, as in the forward
    if (s < g.nt) {
      T* slot = ring + 2 * (s % kRing) * kTileElems;
      load_tile_async(slot, base, c, s * kTile, n);
      load_tile_async(slot + kTileElems, dbase, hd, s * kTile, n);
    }
    cp_async_commit();
  };
  load_tile_async(ks, base + hd, c, k0, n);
  load_tile_async(vs, base + 2 * hd, c, k0, n);
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  float acc[8][4];  // dV in warpgroup 0, dK in warpgroup 1
  zero(acc);
  for (int s = 0; s < g.nt; ++s) {
    issue(s + kRing - 1);
    if (threadIdx.x < kTile) {
      const int row = s * kTile + threadIdx.x;
      const bool ok = row < n;
      row_m[threadIdx.x] = ok ? stats[(row_stats + row) * 2] : 0.f;
      row_l[threadIdx.x] = ok ? stats[(row_stats + row) * 2 + 1] : 1.f;
      row_d[threadIdx.x] = ok ? delta[row_stats + row] : 0.f;
      row_r[threadIdx.x] = 1.f / row_l[threadIdx.x];
    }
    cp_async_wait<kRing - 1>();
    __syncthreads();
    const T* qt = ring + 2 * (s % kRing) * kTileElems;
    const T* dot = qt + kTileElems;
    float pr[8][4];  // S in warpgroup 0, dP in warpgroup 1
    zero(pr);
    Ops::nt(wg ? dot : qt, wg ? vs : ks, pr);
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[Ops::nt_row(r, e) * kPlainF + Ops::nt_col(r, e)] = pr[r][e];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = Ops::nt_row(r, e), j = Ops::nt_col(r, e);
          const bool valid = s * kTile + i < n && k0 + j < n;
          const float p =
              div_by_sum(expf(__fmul_rn(pr[r][e], scale) - row_m[i]), row_l[i], row_r[i]);
          const float ds = p * (dpt[i * kPlainF + j] - row_d[i]) * scale;
          store(valid ? p : 0.f, pt + i * kPlain + j);
          store(valid ? ds : 0.f, dst + i * kPlain + j);
        }
    }
    __syncthreads();
    Ops::tn(wg ? dst : pt, kPlain, wg ? qt : dot, acc);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + Ops::tn_row(r, e);
      if (row < n)
        store(acc[r][e], dqkv + (static_cast<size_t>(b) * n + row) * c + (wg ? hd : 2 * hd) +
                             h * kD + Ops::tn_col(r, e));
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
constexpr size_t op_bytes() {
  return static_cast<size_t>(kTile) * Op<T>::kLd * sizeof(T);
}

template <typename T>
int resident_fwd(const void* qkv, void* out, void* stats, int b, int n, int heads,
                 float scale, cudaStream_t s) {
  const Resident g(n);
  const size_t bytes = (1 + Ring<T>::kFwd) * op_bytes<T>() + sizeof(float) * kTile * g.lds;
  cudaError_t err = allow_smem(flash_mha_resident_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mha_resident_fwd_kernel<T><<<dim3(g.nt, heads, b), kFwdThreads, bytes, s>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), static_cast<float*>(stats), n,
      heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resident_bwd(const void* qkv, const void* dout, const void* stats, void* delta,
                 void* dqkv, int b, int n, int heads, float scale, cudaStream_t s) {
  const Resident g(n);
  const size_t dq_bytes = (2 + 2 * Ring<T>::kDq) * op_bytes<T>() +
                          sizeof(float) * (2 * kTile * g.lds + 3 * kTile);
  const size_t dkv_bytes = (2 + 2 * Ring<T>::kDkv) * op_bytes<T>() +
                           2 * sizeof(T) * kTile * PlainLd<T>::value +
                           sizeof(float) * (kTile * PlainLd<float>::value + 4 * kTile);
  cudaError_t err = allow_smem(flash_mha_resident_dq_kernel<T>, dq_bytes);
  if (err == cudaSuccess) err = allow_smem(flash_mha_resident_dkv_kernel<T>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.nt, heads, b);
  flash_mha_resident_dq_kernel<T><<<grid, kBwdThreads, dq_bytes, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<float*>(delta), static_cast<T*>(dqkv),
      n, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mha_resident_dkv_kernel<T><<<grid, kBwdThreads, dkv_bytes, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<T*>(dqkv), n, heads, scale);
  return static_cast<int>(cudaGetLastError());
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

// The resident route (N <= flash_mha_resident_max_n()); arguments as above.
int flash_mha_resident_fwd_launch(const void* qkv, void* out, void* stats, int b, int n,
                                  int heads, float scale, int is_bf16, int device,
                                  void* stream) {
  if (n > kMaxResident) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? resident_fwd<__nv_bfloat16>(qkv, out, stats, b, n, heads, scale, s)
                 : resident_fwd<float>(qkv, out, stats, b, n, heads, scale, s);
}

int flash_mha_resident_bwd_launch(const void* qkv, const void* dout, const void* stats,
                                  void* delta, void* dqkv, int b, int n, int heads,
                                  float scale, int is_bf16, int device, void* stream) {
  if (n > kMaxResident) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? resident_bwd<__nv_bfloat16>(qkv, dout, stats, delta, dqkv, b, n, heads,
                                               scale, s)
                 : resident_bwd<float>(qkv, dout, stats, delta, dqkv, b, n, heads, scale, s);
}

int flash_mha_resident_max_n() { return kMaxResident; }

int flash_mha_head_dim() { return kD; }

const char* flash_mha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
