// Multi-head attention from the packed qkv projection, forward and backward,
// with the [B, H, N, N] scores kept out of device memory in both directions.
//
//   qkv [B, N, 3*H*D] (f32 or bf16; lane order [3][head][dim], D = 64)
//     -> out [B, N, H*D] = softmax(q k^T * scale) v per head (qkv's type)
//   training forward also: per-row softmax statistics (max m, sum l) [B, H, N, 2]
//   backward: dqkv [B, N, 3*H*D] (qkv's type) from (qkv, dout, statistics;
//     in fp32 also the forward's out), plus the row term [B, H, N] as scratch
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/flash_attention.py::
// _fwd_kernel and ::_bwd_kernel (reached through flash_mha_packed).  Those
// run one grid step per batch element with every head's whole 227 x 227 score
// tile in VMEM: S once, the exact softmax, P rounded to the input type before
// P.V.  Kept from them: what is computed and where it rounds.  Scores,
// softmax and every product accumulate in f32 (s = dot * scale by __fmul_rn,
// no contraction into the softmax); P is rounded to the input type before
// P.V and before dV (flash_attention.py:74, :91), dS before dQ and dK
// (:102-104).  The backward's row term is rowsum(dP * P) from the recomputed
// probabilities in bf16, as there (rowsum(dO * O) would differ, O being
// rounded to bf16), and rowsum(dO * O) in fp32, where P is never rounded and
// the two are equal in exact arithmetic.  The backward recomputes P from qkv
// and the saved (m, l) with the forward's arithmetic (the key side forms S^T
// with the operands swapped, which in split TF32 may move its last bit).
//
// What bounds it on the H100: operations.  At B=32, N=227, H=12 each N^2 D
// product is 2 N^2 D H B = 2.5 GFLOP (11.2 at the 477 tokens of 2 s
// frames): the forward needs two (q.k^T, p.v; 76 us at 67 TFLOP/s f32)
// against 89 MB moved (27 us), the backward five (dP, dV, dQ, dK and S
// again).
//
// One route for every N, FlashAttention-2's shape on mma.sync, without
// atomics (every output element is summed by one thread in a fixed order, so
// runs repeat bit for bit).  A block of 4 warps owns 64 rows of one (batch
// element, head), each warp 16 of them from start to finish; the other
// side's 64-row tiles stream through a cp.async ring (an element-wise
// variant of each kernel takes sources that do not start on a 16-byte
// boundary).  S and dP live in the mma accumulators, row max and sum are
// shuffles among the 4 lanes that share a row, and P and dS become the next
// product's A operand in registers (two m16n8 accumulators are one m16n8k16
// A operand; in m16n8k8 a lane's own two columns), never touching shared
// memory.  bf16: m16n8k16, ldmatrix (.trans for the second operand of P V,
// dS K, P^T dO, dS^T Q).  fp32: split TF32 on m16n8k8 (big = tf32(a), small
// = tf32(a - big); small*big + big*small + big*big, small terms first:
// ~2^-22 a product, where one TF32 pass gives ~2^-11), each tile's P V-type
// product summed from zero and added in fp32.  Forward: fp32 one pass with
// the online softmax (two products), bf16 two passes, as its contract rounds
// the exact P (three).  Backward: a query-side kernel finds the row term
// (bf16: a walk over the keys, S and dP; fp32: from the forward's output)
// and walks the keys for dS and dQ = dS K; a key-side kernel, keys as rows,
// walks the query tiles for S^T, dP^T, dV = P^T dO and dK = dS^T Q: nine
// products in bf16, seven in fp32.  What bounds it now is issue, not the
// tensor cores: bf16 spends its slots on the softmax (an exp, a correctly
// rounded divide and the masks per score, in both forward passes), fp32 on
// splitting every operand as it is read (five integer and float operations
// a value, once per warp) beside the three mmas; chip_smoke.py (phases 17,
// 19, 20) holds and times it, PERF.md has the figures.
//
// History: up to N = 256 a second, resident route (a query tile's scores
// for the whole key range in shared memory, fp32 on the FMA pipe) ran until
// these kernels beat it at the AST's N = 227 in both types and directions;
// it was retired, and this file serves every N.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/flash_attention_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;               // head width
constexpr int kTile = 64;            // query rows / key rows per tile
constexpr int kStreamThreads = 128;  // 4 warps, 16 rows each

// A 64 x 64 operand tile streamed into shared memory by cp.async, 16 bytes
// (`kElems` values) a copy.  bf16: rows padded to 72 values (144 bytes),
// conflict-free for ldmatrix.  fp32: rows padded to 68 floats, no swizzle,
// so that every fragment read is a fixed offset from a lane's base and the
// reads of a warp (rows 8 nb + g, columns 8 ks + t; or rows 8 j + 2 t (+ 1),
// columns 8 nb + g) hit 32 different banks.
template <typename T> struct Op;
template <> struct Op<__nv_bfloat16> {
  static constexpr int kElems = 8, kLd = kD + 8;
  __device__ static int chunk(int r, int cc) { return r * kLd + (cc << 3); }
};
template <> struct Op<float> {
  static constexpr int kElems = 4, kLd = kD + 4;
  __device__ static int chunk(int r, int cc) { return r * kLd + (cc << 2); }
};

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
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int stride, int row0,
                                                int n) {
  constexpr int kChunks = kD / Op<T>::kElems;
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, cc = i % kChunks;
    const bool ok = row0 + r < n;
    cp_async16(dst + Op<T>::chunk(r, cc),
               src + static_cast<size_t>(ok ? row0 + r : row0) * stride + cc * Op<T>::kElems,
               ok);
  }
}

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

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// p = e / l, correctly rounded for the operands of a softmax (e in [0, 1],
// l >= 1; inv_l = 1.f / l): q = e * inv_l, then one exact residual and a
// fused correction (Markstein), with no branch.  IEEE division's slow-path
// check puts every element in a branch region of its own, which serialised
// a softmax on the special-function unit's latency.
__device__ __forceinline__ float div_by_sum(float e, float l, float inv_l) {
  const float q = __fmul_rn(e, inv_l);
  return fmaf(fmaf(-q, l, e), inv_l, q);
}

// Depth of the kernels' cp.async rings (slots of two tiles): the
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

// The two warp products of the kernels, on operand tiles (Op<T>
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
    const int l = threadIdx.x & 31;
    const bf16* xp = x + (16 * ((threadIdx.x >> 5) & 3) + (l & 15)) * kLd + 8 * (l >> 4);
    const bf16* yp = y + ((l & 7) + 8 * (l >> 4)) * kLd + 8 * ((l >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      unsigned af[4];
      ldsm_x4(af, xp + 16 * ks);
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        unsigned bf[4];
        ldsm_x4(bf, yp + 16 * nb2 * kLd + 16 * ks);
        mma_bf16(acc[2 * nb2], af, bf[0], bf[1]);
        mma_bf16(acc[2 * nb2 + 1], af, bf[2], bf[3]);
      }
    }
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
  static constexpr int kLd = Op<float>::kLd;

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
    load_tile_async(dst, src, stride, row0, n);
  } else {
    constexpr int kE = Op<T>::kElems;
    for (int i = threadIdx.x; i < kTile * kD; i += blockDim.x) {
      const int r = i / kD, col = i % kD;
      dst[Op<T>::chunk(r, col / kE) + col % kE] =
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
  constexpr int kTileElems = kTile * Op<T>::kLd;
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
  constexpr int kTileElems = kTile * Op<T>::kLd;
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
      constexpr int kE = Op<T>::kElems;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (r + 8 * i >= n) continue;
        const T* o = out + (static_cast<size_t>(b) * n + r + 8 * i) * hd + h * kD;
#pragma unroll
        for (int d = 16 * t; d < 16 * t + 16; ++d)
          rowterm[i] += static_cast<float>(dos[Op<T>::chunk(rl + 8 * i, d / kE) + d % kE]) *
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
  constexpr int kTileElems = kTile * Op<T>::kLd;
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

// The element-wise variant of each kernel takes sources that are not
// 16-byte aligned (cp.async moves 16 bytes); every other part is the same.
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
constexpr size_t tile_bytes() {
  return static_cast<size_t>(kTile) * Op<T>::kLd * sizeof(T);
}

template <typename T, bool kAligned>
int stream_fwd(const void* qkv, void* out, void* stats, int b, int n, int heads, float scale,
               cudaStream_t s) {
  const size_t bytes = (1 + 2 * kStreamRing) * tile_bytes<T>();
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
  const size_t dq_bytes = (2 + 2 * kStreamRing) * tile_bytes<T>();
  const size_t slot = 2 * tile_bytes<T>() + 4 * kTile * sizeof(float);
  const size_t dkv_bytes = 2 * tile_bytes<T>() + kStreamRing * slot;
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

int flash_mha_head_dim() { return kD; }

const char* flash_mha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
