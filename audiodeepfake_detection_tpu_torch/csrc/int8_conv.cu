// s8 x s8 -> s32 convolution, stride 1, as an implicit GEMM on the int8
// tensor cores, with the per-output-channel dequantization in its epilogue.
//
//   x [B, H, W, Cin] int8 codes (NHWC), w [Npad, Kpad] int8 codes (row n:
//   output channel n, reduction index k = (kh * ksize + kw) * Cin + c, zero
//   beyond Cout and beyond K = ksize * ksize * Cin), scale [Cout] float32
//     -> out [B, Cout, Ho, Wo] (NCHW) in float32 or bfloat16:
//        float(acc) * scale[oc], rounded once to the output type;
//        or the int32 accumulators themselves.
//   Ho = H + 2 * pad - dil * (ksize - 1), the same for Wo; zero padding
//   (code 0 is the value 0 under symmetric quantization).
//
// Replaces no Pallas kernel.  The JAX package runs these convolutions as
// XLA's s8 convolution (audiodeepfake_detection_tpu/ops/quantize.py:113,
// int8_conv, preferred_element_type=int32); PyTorch has no int8 convolution
// on CUDA (F.conv2d refuses int8), and im2col + torch._int_mm would build a
// copy of the input K times its size (228 MB of int8 at the DCNN's cnn_7,
// B = 64, for 25 MB of input).  The sites: the DCNN's cnn_0 (3x3, Cin 1,
// pad 2: K = 9), cnn_4 (1x1), cnn_7 .. cnn_17 (3x3) and its dilated dil_1 /
// dil_4 / dil_7 (Cin 12, dilations 1, 2, 4); the LCNN's lcnn_0 (5x5, Cin 1)
// and its 1x1 and 3x3 sites (Cin 32, 48, 64).
//
// What bounds it on the H100: bytes.  Every site writes its output in the
// working type (4 bytes a value in float32) and reads int8, and the
// arithmetic intensity (2 K operations a 4-byte output) stays far below
// the int8 tensor cores' 1,979 TOPS over 3.35 TB/s at every site's K
// (9 to 1,152).  The design is the simple one that is right first:
//   - a CTA of 4 warps owns 64 output positions (M = B * Ho * Wo,
//     flattened) x 64 output channels; each warp 32 x 32, eight
//     mma.sync.m16n8k32 (IMMA) per 32-deep step into int32 registers;
//   - each step stages 64 x 32 codes of the implicit im2col matrix and of
//     the weights in shared memory (rows 48 bytes apart: the fragment
//     loads meet no bank conflict), double-buffered through registers, so
//     the next step's global loads are in flight during this step's MMAs;
//   - A's rows are gathered from x: 16-byte loads where Cin is a multiple
//     of 16 (a 16-code run never crosses a tap), byte loads otherwise
//     (Cin = 1, 12); taps outside the plane and k >= K read as zero;
//   - the epilogue scales each accumulator and stores NCHW straight from
//     the fragments: eight consecutive positions of one channel per 32-byte
//     run, so nothing transposes the output afterwards.
// Not here yet (later work): wgmma / TMA, a persistent grid, tiles shaped
// to Cout (Cout = 32 or 12 leaves part of the 64-channel tile idle), and
// quantizing x on the fly from the working type.
//
// The sum is exact (|acc| <= K * 127 * 127 < 2^31), so the accumulators
// equal the plain version's float64 convolution of the codes rounded to
// int32, and the dequantized output is the same bits as its
// (acc.float() * scale).to(type): __int2float_rn, one __fmul_rn, and
// __float2bfloat16_rn, each rounding to nearest even as PyTorch does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/int8_conv_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;         // output positions a CTA
constexpr int kBN = 64;         // output channels a CTA (w is padded to it)
constexpr int kBK = 32;         // reduction depth a step: one m16n8k32
constexpr int kRow = kBK + 16;  // shared row stride in bytes
constexpr int kThreads = 128;   // 4 warps, 2 x 2, each 32 positions x 32 channels

struct Geometry {
  int h, w, cin;               // input plane and channels (NHWC)
  int cout, ksize, pad, dil;   // weights, stride 1
  int ho, wo;                  // output plane
  int k, kpad;                 // reduction length, and w's row length
  int m;                       // B * Ho * Wo
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The code of x at reduction index kidx for the output position (b, oh, ow)
// whose batch row starts at xb; 0 beyond K or outside the plane.
__device__ __forceinline__ int8_t code_at(const int8_t* __restrict__ xb,
                                          const Geometry& g, int oh, int ow,
                                          int kidx) {
  if (kidx >= g.k) return 0;
  const int tap = kidx / g.cin, c = kidx - tap * g.cin;
  const int kh = tap / g.ksize, kw = tap - kh * g.ksize;
  const int ih = oh - g.pad + kh * g.dil, iw = ow - g.pad + kw * g.dil;
  if (ih < 0 || ih >= g.h || iw < 0 || iw >= g.w) return 0;
  return xb[(static_cast<size_t>(ih) * g.w + iw) * g.cin + c];
}

// Sixteen codes of A's row at reduction indices k0 .. k0 + 15.
template <bool kVec>
__device__ __forceinline__ int4 load_a(const int8_t* __restrict__ xb,
                                       const Geometry& g, bool valid, int oh,
                                       int ow, int k0) {
  int4 v = make_int4(0, 0, 0, 0);
  if (!valid) return v;
  if (kVec) {
    // Cin % 16 == 0: the run lies in one tap, 16-byte aligned in x
    if (k0 >= g.k) return v;
    const int tap = k0 / g.cin, c = k0 - tap * g.cin;
    const int kh = tap / g.ksize, kw = tap - kh * g.ksize;
    const int ih = oh - g.pad + kh * g.dil, iw = ow - g.pad + kw * g.dil;
    if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
      v = *reinterpret_cast<const int4*>(
          xb + (static_cast<size_t>(ih) * g.w + iw) * g.cin + c);
    return v;
  }
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t byte = static_cast<uint8_t>(code_at(xb, g, oh, ow, k0 + j));
    word[j >> 2] |= byte << ((j & 3) * 8);
  }
  v.x = static_cast<int>(word[0]);
  v.y = static_cast<int>(word[1]);
  v.z = static_cast<int>(word[2]);
  v.w = static_cast<int>(word[3]);
  return v;
}

__device__ __forceinline__ void store_out(float* p, int acc, float s) {
  *p = __fmul_rn(__int2float_rn(acc), s);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, int acc, float s) {
  *p = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), s));
}
__device__ __forceinline__ void store_out(int* p, int acc, float) { *p = acc; }

template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                     const float* __restrict__ scale, OutT* __restrict__ out,
                     Geometry g) {
  __shared__ __align__(16) int8_t sa[2][kBM * kRow];
  __shared__ __align__(16) int8_t sb[2][kBN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int plane = g.ho * g.wo;

  // the loader's share: 16 codes of row tid / 2 of A and of B a step
  const int lr = tid >> 1, lc = (tid & 1) * 16;
  const int am = m0 + lr;
  const bool arow = am < g.m;
  int ab = 0, aoh = 0, aow = 0;
  if (arow) {
    ab = am / plane;
    const int r = am - ab * plane;
    aoh = r / g.wo;
    aow = r - aoh * g.wo;
  }
  const int8_t* xb = x + static_cast<size_t>(ab) * g.h * g.w * g.cin;
  const int8_t* wrow = wt + static_cast<size_t>(n0 + lr) * g.kpad + lc;
  const int soff = lr * kRow + lc;

  int4 ra = load_a<kVec>(xb, g, arow, aoh, aow, lc);
  int4 rb = *reinterpret_cast<const int4*>(wrow);
  *reinterpret_cast<int4*>(&sa[0][soff]) = ra;
  *reinterpret_cast<int4*>(&sb[0][soff]) = rb;
  __syncthreads();

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int grp = lane >> 2, tig = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = g.kpad / kBK;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {
      const int k0 = (s + 1) * kBK;
      ra = load_a<kVec>(xb, g, arow, aoh, aow, k0 + lc);
      rb = *reinterpret_cast<const int4*>(wrow + k0);
    }
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* p = &sa[cur][(wm + i * 16 + grp) * kRow + tig * 4];
      a[i][0] = *reinterpret_cast<const uint32_t*>(p);
      a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
      a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* p = &sb[cur][(wn + j * 8 + grp) * kRow + tig * 4];
      b[j][0] = *reinterpret_cast<const uint32_t*>(p);
      b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    if (more) {
      *reinterpret_cast<int4*>(&sa[cur ^ 1][soff]) = ra;
      *reinterpret_cast<int4*>(&sb[cur ^ 1][soff]) = rb;
    }
    __syncthreads();
  }

  // accumulator e of tile (i, j): position row grp (+ 8 for e >= 2),
  // channel column tig * 2 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + grp + half * 8;
      if (m >= g.m) continue;
      const int b = m / plane;
      OutT* ob = out + static_cast<size_t>(b) * g.cout * plane + (m - b * plane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + tig * 2 + e;
          if (n < g.cout)
            store_out(ob + static_cast<size_t>(n) * plane, acc[i][j][half * 2 + e],
                      scale != nullptr ? scale[n] : 0.0f);
        }
      }
    }
  }
}

template <typename OutT>
void launch(bool vec, dim3 grid, cudaStream_t s, const int8_t* x, const int8_t* wt,
            const float* scale, void* out, const Geometry& g) {
  if (vec)
    int8_conv_kernel<OutT, true><<<grid, kThreads, 0, s>>>(
        x, wt, scale, static_cast<OutT*>(out), g);
  else
    int8_conv_kernel<OutT, false><<<grid, kThreads, 0, s>>>(
        x, wt, scale, static_cast<OutT*>(out), g);
}

}  // namespace

extern "C" {

// The tile sizes the wrapper pads the weights to: {kBN, kBK}.
int int8_conv_tile(int which) { return which == 0 ? kBN : kBK; }

// out_kind: 0 float32, 1 bfloat16, 2 int32 accumulators (scale unread).
// Returns the cudaError_t of the launch (0 on success); the geometry is
// checked by the wrapper.
int int8_conv_launch(const void* x, const void* wt, const void* scale, void* out,
                     int batch, int h, int w, int cin, int cout, int ksize,
                     int pad, int dil, int kpad, int out_kind, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.ksize = ksize;
  g.pad = pad;
  g.dil = dil;
  g.ho = h + 2 * pad - dil * (ksize - 1);
  g.wo = w + 2 * pad - dil * (ksize - 1);
  g.k = ksize * ksize * cin;
  g.kpad = kpad;
  g.m = batch * g.ho * g.wo;
  const bool vec = cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((g.m + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(wt);
  const float* sc = static_cast<const float*>(scale);
  if (out_kind == 0)
    launch<float>(vec, grid, s, xq, wq, sc, out, g);
  else if (out_kind == 1)
    launch<__nv_bfloat16>(vec, grid, s, xq, wq, sc, out, g);
  else
    launch<int>(vec, grid, s, xq, wq, nullptr, out, g);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
