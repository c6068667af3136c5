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
// once O is rounded to bf16; only the fp32 streaming route, where P is
// never rounded, takes it).  The backward recomputes P from qkv and the
// saved (m, l), the forward's arithmetic (the streaming key side forms S^T
// with the operands swapped, which in split TF32 may move its last bit).
//
// What bounds it on the H100: operations.  At B=32, N=227, H=12 each N^2 D
// product is 2 N^2 D H B = 2.5 GFLOP (11.2 at the 477 tokens of 2 s
// frames): the forward needs two (q.k^T, p.v; 76 us at 67 TFLOP/s f32)
// against 89 MB moved (27 us), the backward five (dP, dV, dQ, dK and S
// again).
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
// * Streaming (any N: the route above N = 256, e.g. the 477 tokens of 2 s
//   frames, and for tensors that do not start on a 16-byte boundary):
//   FlashAttention-2's shape on mma.sync.  A block of 4 warps owns 64 rows
//   of one (batch element, head), each warp 16 of them from start to
//   finish; the other side's 64-row tiles stream through a cp.async ring
//   (an element-wise variant of each kernel takes unaligned sources).  S
//   and dP live in the mma accumulators, row max and sum are shuffles among
//   the 4 lanes that share a row, and P and dS become the next product's A
//   operand in registers (two m16n8 accumulators are one m16n8k16 A
//   operand; in m16n8k8 a lane's own two columns), never touching shared
//   memory.  bf16: m16n8k16, ldmatrix (.trans for the second operand of P
//   V, dS K, P^T dO, dS^T Q).  fp32: split TF32 on m16n8k8 (big =
//   tf32(a), small = tf32(a - big); small*big + big*small + big*big, small
//   terms first: ~2^-22 a product, where one TF32 pass gives ~2^-11), each
//   tile's P V-type product summed from zero and added in fp32.  Forward:
//   fp32 one pass with the online softmax (two products), bf16 two passes,
//   as its contract rounds the exact P (three).  Backward, no atomics: a
//   query-side kernel finds the row term (bf16: a walk over the keys, S and
//   dP; fp32: rowsum(dO * O) from the forward's output) and walks the keys
//   for dS and dQ = dS K; a key-side kernel, keys as rows, walks the query
//   tiles for S^T, dP^T, dV = P^T dO and dK = dS^T Q: nine products in
//   bf16, seven in fp32.  What bounds it now is issue, not the tensor
//   cores: bf16 spends its slots on the softmax (an exp, a correctly
//   rounded divide and the masks per score, in both forward passes), fp32
//   on splitting every operand as it is read (five integer and float
//   operations a value, once per warp) beside the three mmas; chip_smoke.py
//   (phases 17, 19, 20) holds and times it, PERF.md has the figures.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/flash_attention_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head width
constexpr int kTile = 64;       // query rows / key rows per tile

__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
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
template <typename T, typename L = Op<T>>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int stride,
                                                int row0, int n) {
  constexpr int kChunks = kD / L::kElems;
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, cc = i % kChunks;
    const bool ok = row0 + r < n;
    cp_async16(dst + L::chunk(r, cc),
               src + static_cast<size_t>(ok ? row0 + r : row0) * stride + cc * L::kElems,
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

// ------------------------------------------------------------------------
// Streaming route (any N): a block of 4 warps owns 64 rows of one (batch
// element, head), each warp 16 of them from start to finish, and the other
// side's 64-row tiles stream past through a cp.async ring.  Every product is
// a warp's 16 rows against a whole tile, its result held in the mma
// accumulators; P and dS go from accumulators straight into the next
// product's A operand, never through shared memory.

constexpr int kStreamThreads = 128;

// The streaming route's tile layouts: bf16 as the resident route's (rows of
// 72 values, conflict-free for ldmatrix); fp32 rows padded to 68 floats, no
// swizzle, so that every fragment read is a fixed offset from a lane's base
// and the reads of a warp (rows 8 nb + g, columns 8 ks + t; or rows 8 j +
// 2 t (+ 1), columns 8 nb + g) hit 32 different banks.
template <typename T> struct SOp;
template <> struct SOp<__nv_bfloat16> : Op<__nv_bfloat16> {};
template <> struct SOp<float> {
  static constexpr int kElems = 4, kLd = kD + 4;
  __device__ static int chunk(int r, int cc) { return r * kLd + (cc << 2); }
};

// Depth of the streaming kernels' cp.async rings (slots of two tiles): the
// next stage loads while a stage's products run.  A third slot made the
// bf16 forward slower (fewer blocks an SM), and no other kernel faster.
constexpr int kStreamRing = 2;

// v rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32 for finite v, in two integer operations (half
// of the dropped 13 bits added to the magnitude, then cleared; the ptx
// conversion compiles to a longer sequence that also screens NaN and
// infinity).  v = big + small to ~2^-22 relative.
__device__ __forceinline__ unsigned tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float v, unsigned& big, unsigned& small) {
  big = tf32(v);
  small = tf32(v - __uint_as_float(big));
}
// c += a . b, m16n8k8, TF32 in, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// acc[nb] += a . b[nb] to fp32 accuracy: small*big, big*small, big*big, the
// small terms first (small*small, ~2^-22 relative, is dropped), pass-major
// so that consecutive mmas feed different accumulators.
__device__ __forceinline__ void mma3(float (&acc)[8][4], const unsigned (&ab)[4],
                                     const unsigned (&as)[4], const unsigned (&bb)[8][2],
                                     const unsigned (&bs)[8][2]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) mma_tf32(acc[nb], as, bb[nb]);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) mma_tf32(acc[nb], ab, bs[nb]);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) mma_tf32(acc[nb], ab, bb[nb]);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The two warp products of the streaming route, on operand tiles (SOp<T>
// layouts).  Warp w owns rows 16w .. 16w + 15; acc[nb][e] holds row 16w + g
// + 8 (e >> 1), column 8 nb + 2 t + (e & 1), for lane = 4 g + t.
//   nt: acc += X Y^T over the 64 head dims: X's rows of this warp (Q, dO;
//       K, V on the key side), Y a whole tile (K, V; Q, dO).
//   nn: acc += P Y over a tile's 64 rows: P [16 x 64] in accumulator layout
//       (P, dS; P^T, dS^T), Y a tile whose rows are P's columns (V, K; dO, Q).
// bf16: m16n8k16, fragments by ldmatrix (.trans for nn's Y); nn rounds P to
// bf16 as it packs two accumulators into one A register, which is where the
// TPU kernel rounds P and dS.  fp32: split TF32 on m16n8k8, operands split
// as read; in nn the lane's A columns t and t + 4 of k-step j are the
// accumulator's own columns 8j + 2t and 8j + 2t + 1, so P needs no shuffle
// and Y's rows are read in the same order.
template <typename T> struct Warp;

template <> struct Warp<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  static constexpr int kLd = Op<bf16>::kLd;

  __device__ static void nt(const bf16* x, const bf16* y, float (&acc)[8][4]) {
    Tile<bf16>::nt(x, y, acc);
  }

  __device__ static void nn(const float (&p)[8][4], const bf16* y, float (&acc)[8][4]) {
    const int l = threadIdx.x & 31;
    const bf16* bp = y + ((l & 7) + 8 * ((l >> 3) & 1)) * kLd + 8 * (l >> 4);
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const unsigned a[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                             pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                             pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                             pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        unsigned bf[4];
        ldsm_x4_trans(bf, bp + 16 * ks * kLd + 16 * nb2);
        mma_bf16(acc[2 * nb2], a, bf[0], bf[1]);
        mma_bf16(acc[2 * nb2 + 1], a, bf[2], bf[3]);
      }
    }
  }
};

template <> struct Warp<float> {
  static constexpr int kLd = SOp<float>::kLd;

  __device__ static void nt(const float* x, const float* y, float (&acc)[8][4]) {
    const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
    const float* xr = x + (16 * ((threadIdx.x >> 5) & 3) + g) * kLd + t;
    const float* yr = y + g * kLd + t;
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      unsigned ab[4], as[4], bb[8][2], bs[8][2];
      split(xr[8 * ks], ab[0], as[0]);
      split(xr[8 * kLd + 8 * ks], ab[1], as[1]);
      split(xr[8 * ks + 4], ab[2], as[2]);
      split(xr[8 * kLd + 8 * ks + 4], ab[3], as[3]);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        split(yr[8 * nb * kLd + 8 * ks], bb[nb][0], bs[nb][0]);
        split(yr[8 * nb * kLd + 8 * ks + 4], bb[nb][1], bs[nb][1]);
      }
      mma3(acc, ab, as, bb, bs);
    }
  }

  __device__ static void nn(const float (&p)[8][4], const float* y, float (&acc)[8][4]) {
    const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
    const float* yr = y + 2 * t * kLd + g;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      unsigned ab[4], as[4], bb[8][2], bs[8][2];
      split(p[j][0], ab[0], as[0]);
      split(p[j][2], ab[1], as[1]);
      split(p[j][1], ab[2], as[2]);
      split(p[j][3], ab[3], as[3]);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        split(yr[8 * j * kLd + 8 * nb], bb[nb][0], bs[nb][0]);
        split(yr[(8 * j + 1) * kLd + 8 * nb], bb[nb][1], bs[nb][1]);
      }
      mma3(acc, ab, as, bb, bs);
    }
  }
};

// acc += P Y as above, in fp32 summed from zero and then added in fp32:
// the tensor core's own sum truncates, so one accumulator fed across
// every tile of a long row would drift (csrc/fused_conv2.cu, mma3_add).  A
// tile is 24 mmas deep.  bf16 keeps one chain: its outputs round to bf16.
template <typename T>
__device__ __forceinline__ void nn_add(const float (&p)[8][4], const T* y, float (&acc)[8][4]) {
  if constexpr (sizeof(T) == 4) {
    float part[8][4];
    zero(part);
    Warp<T>::nn(p, y, part);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] += part[nb][e];
  } else {
    Warp<T>::nn(p, y, acc);
  }
}

// Rows [row0, row0 + 64) of a 64-wide slice into an operand tile, as
// load_tile_async, for sources that are not 16-byte aligned: element by
// element through registers (the same layout; rows at or past n zero).
template <typename T, bool kAligned>
__device__ __forceinline__ void load_tile_any(T* dst, const T* src, int stride, int row0,
                                              int n) {
  if constexpr (kAligned) {
    load_tile_async<T, SOp<T>>(dst, src, stride, row0, n);
  } else {
    constexpr int kE = SOp<T>::kElems;
    for (int i = threadIdx.x; i < kTile * kD; i += blockDim.x) {
      const int r = i / kD, col = i % kD;
      dst[SOp<T>::chunk(r, col / kE) + col % kE] =
          row0 + r < n ? src[static_cast<size_t>(row0 + r) * stride + col]
                       : static_cast<T>(0.f);
    }
  }
}

// Quad reductions: the four lanes (t = 0 .. 3) that hold one row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store2(float a, float b, float* dst) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(float a, float b, __nv_bfloat16* dst) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// The warp's 16 x 64 block of acc into dst (the tile's row 0; rows `ld`
// elements apart), rows row0 + r at or past n left out.
template <typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], T* dst, int ld, int row0,
                                           int n) {
  const int l = threadIdx.x & 31, r = 16 * ((threadIdx.x >> 5) & 3) + (l >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row0 + r + 8 * i >= n) continue;
    T* d = dst + static_cast<size_t>(r + 8 * i) * ld + 2 * (l & 3);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) store2(acc[nb][2 * i], acc[nb][2 * i + 1], d + 8 * nb);
  }
}

// Forward, one (query tile, head, batch element) per block.  s = (q . k) *
// scale by __fmul_rn, keys past n at -inf.  fp32: one pass with the online
// softmax: per K/V tile the row max m grows, O and l are rescaled by exp(m_old
// - m), P = exp(s - m) and O += P V; O / l at the end, the exact softmax's
// output up to fp32 rounding (rounding P to fp32 is the identity).  Two
// products.  bf16: the contract rounds the exact P to bf16 before P V, so
// pass 1 streams K alone for m and l, and pass 2 streams (K, V): S again, p =
// exp(s - m) / l rounded, O += P V.  Three products.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kStreamThreads)
    flash_mha_stream_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                                float* __restrict__ stats, int n, int heads, float scale) {
  constexpr bool kOnePass = sizeof(T) == 4;
  constexpr int kTileElems = kTile * SOp<T>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ring = qs + kTileElems;  // kStreamRing slots of (K, V)
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * kD, c = 3 * hd;
  const T* base = qkv + static_cast<size_t>(b) * n * c + h * kD;
  const int nt = (n + kTile - 1) / kTile;
  const int first_v = kOnePass ? 0 : nt;  // the first stage that carries V
  const int stages = first_v + nt;
  auto issue = [&](int st) {  // one commit group per stage
    if (st < stages) {
      const int k0 = (st < nt ? st : st - nt) * kTile;
      T* slot = ring + 2 * (st % kStreamRing) * kTileElems;
      load_tile_any<T, kAligned>(slot, base + hd, c, k0, n);
      if (st >= first_v) load_tile_any<T, kAligned>(slot + kTileElems, base + 2 * hd, c, k0, n);
    }
    cp_async_commit();
  };
  load_tile_any<T, kAligned>(qs, base, c, q0, n);
  for (int st = 0; st < kStreamRing - 1; ++st) issue(st);

  const int t = threadIdx.x & 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[8][4];
  zero(acc);
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kStreamRing - 2>();
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    issue(st + kStreamRing - 1);
    const T* kt = ring + 2 * (st % kStreamRing) * kTileElems;
    const int k0 = (st < nt ? st : st - nt) * kTile;
    float s[8][4];
    zero(s);
    Warp<T>::nt(qs, kt, s);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nb][e] = k0 + 8 * nb + 2 * t + (e & 1) < n ? __fmul_rn(s[nb][e], scale) : -INFINITY;
    if (st < nt) {  // the online max and sum (and, in fp32, O)
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) tmax = fmaxf(tmax, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
        const float mnew = fmaxf(m[i], quad_max(tmax));  // finite: key k0 < n
        alpha[i] = expf(m[i] - mnew);
        float tsum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            s[nb][e] = expf(s[nb][e] - mnew);
            tsum += s[nb][e];
          }
        l[i] = l[i] * alpha[i] + quad_sum(tsum);
        m[i] = mnew;
      }
      if constexpr (kOnePass) {
        float part[8][4];
        zero(part);
        Warp<T>::nn(s, kt + kTileElems, part);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nb][e] = fmaf(acc[nb][e], alpha[e >> 1], part[nb][e]);
      }
    } else {  // bf16 pass 2: p = exp(s - m) / l, rounded as nn packs it
      const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nb][e] = div_by_sum(expf(s[nb][e] - m[e >> 1]), l[e >> 1], inv_l[e >> 1]);
      Warp<T>::nn(s, kt + kTileElems, acc);
    }
  }
  if constexpr (kOnePass) {
    const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = div_by_sum(acc[nb][e], l[e >> 1], inv_l[e >> 1]);
  }
  store_rows(acc, out + (static_cast<size_t>(b) * n + q0) * hd + h * kD, hd, q0, n);
  if (stats != nullptr && t == 0) {
    const int r = q0 + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
    float* st = stats + (static_cast<size_t>(b) * heads + h) * n * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r + 8 * i < n) {
        st[2 * (r + 8 * i)] = m[i];
        st[2 * (r + 8 * i) + 1] = l[i];
      }
  }
}

// Backward, query side: one (query tile, head, batch element) per block, Q
// and dO staged once, (K, V) tiles streamed.  The row term comes first.
// bf16 (out null): walk 1 over the keys, S and dP = dO V^T give P (from the
// saved m and l, the forward's arithmetic) and rowsum(dP * P), as the TPU
// kernel forms it from the exact P (rowsum(dO * O) would differ, O being
// rounded to bf16).  fp32 (out: the forward's output): rowsum(dO * O), which
// equals rowsum(dP * P) in exact arithmetic since P is unrounded, from the
// staged dO and 64 values of O a row, which saves walk 1's two products.
// The row term goes to `delta` for the key side.  Then the dQ walk: S and dP,
// dS = P * (dP - rowterm) * scale (rounded to bf16 as nn packs it), dQ += dS
// K.  Five products (fp32: three).
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kStreamThreads)
    flash_mha_stream_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                               const T* __restrict__ out, const float* __restrict__ stats,
                               float* __restrict__ delta, T* __restrict__ dqkv, int n,
                               int heads, float scale) {
  constexpr int kTileElems = kTile * SOp<T>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kTileElems;
  T* ring = dos + kTileElems;  // kStreamRing slots of (K, V)
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * kD, c = 3 * hd;
  const T* base = qkv + static_cast<size_t>(b) * n * c + h * kD;
  const size_t row_stats = (static_cast<size_t>(b) * heads + h) * n;
  const int nt = (n + kTile - 1) / kTile;
  const int walk = out == nullptr ? nt : 0;  // the first stage of the dQ walk
  const int stages = walk + nt;
  auto issue = [&](int st) {
    if (st < stages) {
      const int k0 = (st % nt) * kTile;
      T* slot = ring + 2 * (st % kStreamRing) * kTileElems;
      load_tile_any<T, kAligned>(slot, base + hd, c, k0, n);
      load_tile_any<T, kAligned>(slot + kTileElems, base + 2 * hd, c, k0, n);
    }
    cp_async_commit();
  };
  load_tile_any<T, kAligned>(qs, base, c, q0, n);
  load_tile_any<T, kAligned>(dos, dout + static_cast<size_t>(b) * n * hd + h * kD, hd, q0, n);
  for (int st = 0; st < kStreamRing - 1; ++st) issue(st);

  const int t = threadIdx.x & 3;
  const int rl = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);  // tile rows rl, rl + 8
  const int r = q0 + rl;
  float m[2], l[2], inv_l[2], rowterm[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = r + 8 * i < n;
    m[i] = ok ? stats[(row_stats + r + 8 * i) * 2] : 0.f;
    l[i] = ok ? stats[(row_stats + r + 8 * i) * 2 + 1] : 1.f;
    inv_l[i] = 1.f / l[i];
  }
  auto finish_rowterm = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rowterm[i] = quad_sum(rowterm[i]);
      if (t == 0 && r + 8 * i < n) delta[row_stats + r + 8 * i] = rowterm[i];
    }
  };
  float acc[8][4];
  zero(acc);
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kStreamRing - 2>();
    __syncthreads();
    issue(st + kStreamRing - 1);
    if (st == 0 && walk == 0) {  // rowsum(dO * O): lane t sums dims 16t .. 16t + 15
      constexpr int kE = SOp<T>::kElems;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (r + 8 * i >= n) continue;
        const T* o = out + (static_cast<size_t>(b) * n + r + 8 * i) * hd + h * kD;
#pragma unroll
        for (int d = 16 * t; d < 16 * t + 16; ++d)
          rowterm[i] += static_cast<float>(dos[SOp<T>::chunk(rl + 8 * i, d / kE) + d % kE]) *
                        static_cast<float>(o[d]);
      }
      finish_rowterm();
    }
    const T* kt = ring + 2 * (st % kStreamRing) * kTileElems;
    const int k0 = (st % nt) * kTile;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    Warp<T>::nt(qs, kt, s);
    Warp<T>::nt(dos, kt + kTileElems, dp);
    // P in s; keys past n give exp(-inf) = 0
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv =
            k0 + 8 * nb + 2 * t + (e & 1) < n ? __fmul_rn(s[nb][e], scale) : -INFINITY;
        s[nb][e] = div_by_sum(expf(sv - m[e >> 1]), l[e >> 1], inv_l[e >> 1]);
      }
    if (st < walk) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) rowterm[e >> 1] += dp[nb][e] * s[nb][e];
      if (st == walk - 1) finish_rowterm();
    } else {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nb][e] = s[nb][e] * (dp[nb][e] - rowterm[e >> 1]) * scale;
      nn_add(dp, kt, acc);
    }
  }
  store_rows(acc, dqkv + (static_cast<size_t>(b) * n + q0) * c + h * kD, c, q0, n);
}

// Backward, key side: one (key tile, head, batch element) per block, K and V
// staged once, (Q, dO) tiles of every query tile streamed in order with the
// tile's m, 1 / l, l and row term.  Keys are the M dimension: S^T = K Q^T and
// dP^T = V dO^T come out with a warp's keys as rows, so P^T and dS^T are
// already the A operands of dV += P^T dO and dK += dS^T Q.  Four products.
// Query rows past n arrive as zero Q and dO rows (m = 0, l = 1, row term 0),
// which add nothing; key rows past n are computed and never stored.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kStreamThreads)
    flash_mha_stream_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                const float* __restrict__ stats,
                                const float* __restrict__ delta, T* __restrict__ dqkv, int n,
                                int heads, float scale) {
  constexpr int kTileElems = kTile * SOp<T>::kLd;
  // two tiles, then m, 1 / l, l and the row term of the slot's 64 queries
  constexpr int kSlotElems = 2 * kTileElems + 4 * kTile * (sizeof(float) / sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kTileElems;
  T* ring = vs + kTileElems;  // kStreamRing slots of (Q, dO, row values)
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * kD, c = 3 * hd;
  const T* base = qkv + static_cast<size_t>(b) * n * c + h * kD;
  const T* dbase = dout + static_cast<size_t>(b) * n * hd + h * kD;
  const size_t row_stats = (static_cast<size_t>(b) * heads + h) * n;
  const int nt = (n + kTile - 1) / kTile;
  auto rows_of = [&](int st) {
    return reinterpret_cast<float*>(ring + (st % kStreamRing) * kSlotElems + 2 * kTileElems);
  };
  auto issue = [&](int st) {
    if (st < nt) {
      T* slot = ring + (st % kStreamRing) * kSlotElems;
      load_tile_any<T, kAligned>(slot, base, c, st * kTile, n);
      load_tile_any<T, kAligned>(slot + kTileElems, dbase, hd, st * kTile, n);
      if (threadIdx.x < kTile) {
        float* rv = rows_of(st);
        const int row = st * kTile + threadIdx.x;
        const bool ok = row < n;
        const float lv = ok ? stats[(row_stats + row) * 2 + 1] : 1.f;
        rv[threadIdx.x] = ok ? stats[(row_stats + row) * 2] : 0.f;
        rv[kTile + threadIdx.x] = 1.f / lv;
        rv[2 * kTile + threadIdx.x] = lv;
        rv[3 * kTile + threadIdx.x] = ok ? delta[row_stats + row] : 0.f;
      }
    }
    cp_async_commit();
  };
  load_tile_any<T, kAligned>(ks, base + hd, c, k0, n);
  load_tile_any<T, kAligned>(vs, base + 2 * hd, c, k0, n);
  for (int st = 0; st < kStreamRing - 1; ++st) issue(st);

  const int t = threadIdx.x & 3;
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int st = 0; st < nt; ++st) {
    cp_async_wait<kStreamRing - 2>();
    __syncthreads();
    issue(st + kStreamRing - 1);
    const T* qt = ring + (st % kStreamRing) * kSlotElems;
    const T* dot = qt + kTileElems;
    const float* rv = rows_of(st);
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    Warp<T>::nt(ks, qt, s);
    Warp<T>::nt(vs, dot, dp);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int j = 8 * nb + 2 * t;  // this lane's two queries
      const float2 mv = *reinterpret_cast<const float2*>(rv + j);
      const float2 rl = *reinterpret_cast<const float2*>(rv + kTile + j);
      const float2 lv = *reinterpret_cast<const float2*>(rv + 2 * kTile + j);
      const float2 dv2 = *reinterpret_cast<const float2*>(rv + 3 * kTile + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 1;
        const float p = div_by_sum(expf(__fmul_rn(s[nb][e], scale) - (hi ? mv.y : mv.x)),
                                   hi ? lv.y : lv.x, hi ? rl.y : rl.x);
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - (hi ? dv2.y : dv2.x)) * scale;
      }
    }
    nn_add(s, dot, dv);
    nn_add(dp, qt, dk);
  }
  T* dst = dqkv + (static_cast<size_t>(b) * n + k0) * c + h * kD;
  store_rows(dk, dst + hd, c, k0, n);
  store_rows(dv, dst + 2 * hd, c, k0, n);
}

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

// The streaming route's element-wise variant takes sources that are not
// 16-byte aligned (cp.async moves 16 bytes); every other part is the same.
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
constexpr size_t stream_tile_bytes() {
  return static_cast<size_t>(kTile) * SOp<T>::kLd * sizeof(T);
}

template <typename T, bool kAligned>
int stream_fwd(const void* qkv, void* out, void* stats, int b, int n, int heads, float scale,
               cudaStream_t s) {
  const size_t bytes = (1 + 2 * kStreamRing) * stream_tile_bytes<T>();
  cudaError_t err = allow_smem(flash_mha_stream_fwd_kernel<T, kAligned>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  flash_mha_stream_fwd_kernel<T, kAligned><<<grid, kStreamThreads, bytes, s>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), static_cast<float*>(stats), n, heads,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAligned>
int stream_bwd(const void* qkv, const void* dout, const void* out, const void* stats,
               void* delta, void* dqkv, int b, int n, int heads, float scale, cudaStream_t s) {
  const size_t dq_bytes = (2 + 2 * kStreamRing) * stream_tile_bytes<T>();
  const size_t slot = 2 * stream_tile_bytes<T>() + 4 * kTile * sizeof(float);
  const size_t dkv_bytes = 2 * stream_tile_bytes<T>() + kStreamRing * slot;
  cudaError_t err = allow_smem(flash_mha_stream_dq_kernel<T, kAligned>, dq_bytes);
  if (err == cudaSuccess) err = allow_smem(flash_mha_stream_dkv_kernel<T, kAligned>, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  flash_mha_stream_dq_kernel<T, kAligned><<<grid, kStreamThreads, dq_bytes, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<const T*>(out),
      static_cast<const float*>(stats), static_cast<float*>(delta), static_cast<T*>(dqkv), n,
      heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mha_stream_dkv_kernel<T, kAligned><<<grid, kStreamThreads, dkv_bytes, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<T*>(dqkv), n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const void* qkv, void* out, void* stats, int b, int n, int heads, float scale,
        cudaStream_t s) {
  return aligned16(qkv) ? stream_fwd<T, true>(qkv, out, stats, b, n, heads, scale, s)
                        : stream_fwd<T, false>(qkv, out, stats, b, n, heads, scale, s);
}

template <typename T>
int bwd(const void* qkv, const void* dout, const void* out, const void* stats, void* delta,
        void* dqkv, int b, int n, int heads, float scale, cudaStream_t s) {
  return aligned16(qkv) && aligned16(dout)
             ? stream_bwd<T, true>(qkv, dout, out, stats, delta, dqkv, b, n, heads, scale, s)
             : stream_bwd<T, false>(qkv, dout, out, stats, delta, dqkv, b, n, heads, scale, s);
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

// out: the forward's output in fp32, whose row term is then rowsum(dout *
// out); null in bf16 (the row term rowsum(dP * P), from a walk over the keys).
int flash_mha_bwd_launch(const void* qkv, const void* dout, const void* out, const void* stats,
                         void* delta, void* dqkv, int b, int n, int heads, float scale,
                         int is_bf16, int device, void* stream) {
  if ((out == nullptr) != (is_bf16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd<__nv_bfloat16>(qkv, dout, out, stats, delta, dqkv, b, n, heads, scale, s)
                 : bwd<float>(qkv, dout, out, stats, delta, dqkv, b, n, heads, scale, s);
}

// The resident route (N <= flash_mha_resident_max_n()); arguments as above,
// without out (its row term is rowsum(dP * P) in both types).
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
