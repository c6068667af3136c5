// A whole post-training int8 convolution site in one kernel: the working-type
// activation quantized to codes as it is loaded, the s8 x s8 -> s32 product,
// and an epilogue that dequantizes, adds the BatchNorm fold's map and adds
// the bias, each rounded where the plain PyTorch version rounds.
//
//   site mode:  x [B, Cin, H, W] float32 or bfloat16 (NCHW, any strides: the
//               DCNN's first site reads a transposed view), s_x, s_w [Cout],
//               optional map [Cout, Ho, Wo] and bias [Cout] in x's type
//     code  = clip(rint(x * inv), -127, 127), inv = float32(1 / s_x)
//     acc   = sum of code products (stride 1, zero padding, dilation)
//     y     = (float(acc) * float32(s_x * s_w[oc])) rounded to x's type,
//             then + map, rounded, then + bias, rounded
//     -> out [B, Cout, Ho, Wo] (NCHW) in x's type.
//   codes-in mode: x [B, H, W, Cin] int8 codes (NHWC), scale [Cout]
//     -> out in float32 or bfloat16 (float(acc) * scale[oc], rounded once),
//        or the int32 accumulators themselves.
//   Ho = H + 2 * pad - dil * (ksize - 1), the same for Wo.
//
// Replaces no Pallas kernel.  The JAX package runs these convolutions as
// XLA's s8 convolution (audiodeepfake_detection_tpu/ops/quantize.py:113,
// int8_conv, and :135, quantized_conv, whose quantizing pass and map and
// bias additions XLA fuses around it); PyTorch has no int8 convolution on
// CUDA.  The sites: the DCNN's cnn_0 (3x3, Cin 1), cnn_4 (1x1), cnn_7 ..
// cnn_17 (3x3, Cin 32-128) and dil_1 / dil_4 / dil_7 (Cin 12, dilations 1,
// 2, 4); the LCNN's lcnn_0 (5x5, Cin 1) and its 1x1 and 3x3 sites.
//
// What bounds it on the H100: bytes, at the data-sheet rates: a site reads
// its activation once in the working type and writes its output once; the
// codes never leave the chip (2 K operations a 4-byte output, K = 9 ..
// 1,152).  A first version of this kernel, its phases timed by
// %globaltimer on the card, was a chain of latencies at two CTAs an SM:
// its loads, then its MMAs waiting on weights from L2, then an epilogue
// that read the scale, bias and map from global memory once per stored
// run; and its Cin = 1 route stored runs that began and ended inside
// 128-byte lines (8 bytes off the line grid it ran 2.2x slower than on
// it).  The design that tested best:
//   - MMA route (Cin > 1): a CTA of 8 warps owns a tile of tr output rows x
//     tw columns (tr * tw <= 128 positions; tw splits Wo evenly into runs
//     of at most 64) and an N tile of 32, 64, 96 or 128 channels, the
//     smallest that holds Cout; 2-4 CTAs an SM.  Its prologue loads the
//     tile's halo for every channel (Cin padded to whole 32-channel chunks)
//     straight from NCHW, a warp 32 neighbouring positions (whole-line
//     load requests) and a lane 16 channels of one position, quantizes,
//     and stores the codes channels-innermost, 16 to a store: a position's
//     codes are one run, 16 bytes more than whole chunks apart (an odd
//     number of 16-byte slots: the ldmatrix rows, and the 16-byte stores,
//     of 8 neighbouring positions hit 8 different slots).  The im2col matrix is
//     implicit: a lane's ldmatrix row address is its position's run plus
//     the tap's offset, so the K loop reads no global input.  B, the
//     weights, is laid out at bake time in the m16n8k32 fragment order and
//     streams through a ring of six 32-deep steps in shared memory by
//     cp.async, issued before the prologue, five steps ahead of the MMAs.
//     Warps 4 (M) x 2 (N), each 32 positions x BN/2 channels of
//     mma.sync.m16n8k32 s8 (IMMA) into int32 registers; at 129 columns
//     (cnn_4, cnn_7) a tile is 2 x 43, so a third of its MMA rows idle.  The epilogue
//     scales each accumulator in its own lane (scales from shared memory),
//     stages the tile in shared memory (rows of 132 words: the fragments'
//     writes meet no bank conflict), and stores each channel's run -- with
//     tw = Wo, all its rows as one run -- with lane l on the elements
//     congruent to l mod 32, adding the map (read along the same run, four
//     runs' reads in flight a warp) and the bias as it goes: each store
//     instruction fills one aligned line but at the run's two ends.
//   - Cin = 1 route (K = k * k = 9 or 25, which an MMA step would pad to 32
//     with zeros): a CTA of whole output rows (about 256 positions), a
//     thread one position, its taps packed four to a word in registers;
//     dp4a over each channel's packed taps (weights, scales and bias as
//     shared-memory broadcasts), 32 channels at a time finished into shared
//     memory and stored as line-aligned runs.  Bound by its output bytes.
//   - codes-in mode: the same kernels; the MMA route's prologue copies each
//     position's NHWC codes into the halo by cp.async, 16 channels a copy,
//     where Cin % 16 == 0 and the codes lie on the 16-byte grid, and loads
//     them byte by byte otherwise.
//   - site mode at an N tile of 32 (Cout <= 32: the DCNN's cnn_14), where the
//     input halo outweighs the output: the halo's NCHW rows copied by
//     cp.async into shared memory, 16 channels at a time, and quantized from
//     there, on tiles of 4 x 32 (a smaller halo a position than 2 x 64).  At
//     wider N tiles this prologue tested slower than the register loads
//     (tools/int8_site_probe.py compare).
// Not here yet (later work): wgmma, TMA, a persistent grid that overlaps
// one tile's epilogue with the next tile's loads.
//
// The sum is exact (|acc| <= K * 127 * 127 < 2^31), and every rounding is
// the plain version's: __fmul_rn for x * inv and for s_x * s_w,
// __float2int_rn (round half to even, as torch.round), __int2float_rn,
// __fmul_rn, __fadd_rn, and __float2bfloat16_rn after every bf16 step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/int8_conv_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // MMA route: 8 warps
constexpr int kBM = 128;               // MMA route: output positions a CTA
constexpr int kStageRow = kBM + 4;     // its staged tile's row (words)
constexpr int kRing = 6;               // its weight steps in shared memory
constexpr int kCin1MaxThreads = 512;   // Cin = 1 route: threads (positions) a CTA
constexpr int kCin1MaxN = 256;         //   channels a CTA
constexpr int kCin1Group = 32;         //   channels staged at a time
constexpr int kInF32 = 0, kInBF16 = 1, kInS8 = 2;
// MMA route's prologue: loads into registers (any strides; NHWC codes at any
// address or Cin), cp.async of 16-byte NHWC code words (codes-in mode, Cin %
// 16 == 0, x on the 16-byte grid), or cp.async of NCHW rows contiguous along
// W (site mode)
constexpr int kStageLoads = 0, kStageCodes = 1, kStageRows = 2;
constexpr int kRowGroup = 16;          // kStageRows: channels staged at a time

struct Geometry {
  int h, w, cin, cout, ksize, pad, dil, ho, wo;
  int cin_p;            // MMA route: Cin padded to whole 32-channel chunks
  int tr, tw;           // a CTA's output tile
  int hr, hc;           // its halo: tr + reach rows, tw + reach columns
  int stride;           // MMA route: bytes between two positions' codes
  int staging;          // MMA route's prologue: kStageLoads, kStageCodes or kStageRows
  int tiles_h, tiles_w;
  int n_tiles8;         // MMA route: n8 tiles of the laid-out weights
  long long sb, sc, sh, sw;  // site mode: x's strides in elements
  float inv;            // the quantizing multiplier (site mode)
  float s_x;            // the activation scale (1 in the codes-in mode)
};

__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  const int q = __float2int_rn(__fmul_rn(v, inv));
  return static_cast<uint32_t>(min(127, max(-127, q))) & 0xffu;
}

// The activation loaders: NCHW in the working type (quantized here) or
// NHWC int8 codes (read as they are).
template <int kIn> struct In;
template <> struct In<kInF32> {
  using T = float;
  __device__ static T load(const void* x, size_t i) {
    return __ldg(static_cast<const float*>(x) + i);
  }
  __device__ static uint32_t code(T v, float inv) { return quantize(v, inv); }
  __device__ static size_t index(const Geometry& g, int b, int c, int ih, int iw) {
    return b * g.sb + c * g.sc + ih * g.sh + iw * g.sw;
  }
  __device__ static size_t cstep(const Geometry& g) { return static_cast<size_t>(g.sc); }
};
template <> struct In<kInBF16> {
  using T = __nv_bfloat16;
  __device__ static T load(const void* x, size_t i) {
    return __ldg(static_cast<const __nv_bfloat16*>(x) + i);
  }
  __device__ static uint32_t code(T v, float inv) {
    return quantize(__bfloat162float(v), inv);
  }
  __device__ static size_t index(const Geometry& g, int b, int c, int ih, int iw) {
    return b * g.sb + c * g.sc + ih * g.sh + iw * g.sw;
  }
  __device__ static size_t cstep(const Geometry& g) { return static_cast<size_t>(g.sc); }
};
template <> struct In<kInS8> {
  using T = signed char;
  __device__ static T load(const void* x, size_t i) {
    return __ldg(static_cast<const signed char*>(x) + i);
  }
  __device__ static uint32_t code(T v, float) {
    return static_cast<uint32_t>(static_cast<uint8_t>(v));
  }
  __device__ static size_t index(const Geometry& g, int b, int c, int ih, int iw) {
    return ((static_cast<size_t>(b) * g.h + ih) * g.w + iw) * g.cin + c;
  }
  __device__ static size_t cstep(const Geometry&) { return 1; }
};

// The output types: an accumulator scaled and rounded to the type (the
// fragment pass, as a 32-bit word of the staged tile), then the map and
// the bias added, each rounded to the type as the plain version rounds
// (the store pass).
template <typename T> struct Out;
template <> struct Out<float> {
  __device__ static float value(const float* p) { return __ldg(p); }
  __device__ static uint32_t scaled(int acc, float scale) {
    return __float_as_uint(__fmul_rn(__int2float_rn(acc), scale));
  }
  __device__ static float finish(uint32_t w, bool has_map, float map, bool has_bias,
                                 float bias) {
    float v = __uint_as_float(w);
    if (has_map) v = __fadd_rn(v, map);
    if (has_bias) v = __fadd_rn(v, bias);
    return v;
  }
};
template <> struct Out<__nv_bfloat16> {
  __device__ static float value(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
  __device__ static uint32_t scaled(int acc, float scale) {
    return __float_as_uint(
        __bfloat162float(__float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), scale))));
  }
  // the word holds a bf16 value: every conversion back is exact
  __device__ static __nv_bfloat16 finish(uint32_t w, bool has_map, float map, bool has_bias,
                                         float bias) {
    float v = __uint_as_float(w);
    if (has_map) v = __bfloat162float(__float2bfloat16_rn(__fadd_rn(v, map)));
    if (has_bias) v = __bfloat162float(__float2bfloat16_rn(__fadd_rn(v, bias)));
    return __float2bfloat16_rn(v);
  }
};
template <> struct Out<int> {
  __device__ static float value(const int*) { return 0.0f; }
  __device__ static uint32_t scaled(int acc, float) { return static_cast<uint32_t>(acc); }
  __device__ static int finish(uint32_t w, bool, float, bool, float) {
    return static_cast<int>(w);
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int v) { return static_cast<float>(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The CTA's output tile from blockIdx.x: (batch row, first output row and
// column).
__device__ __forceinline__ void tile_of(const Geometry& g, int& b, int& oh0, int& ow0) {
  int t = blockIdx.x;
  const int tw_i = t % g.tiles_w;
  t /= g.tiles_w;
  const int th_i = t % g.tiles_h;
  b = t / g.tiles_h;
  oh0 = th_i * g.tr;
  ow0 = tw_i * g.tw;
}

// The staged tile (channel rows of ``row_words`` words, position m = r * tw
// + j) to NCHW, the map and the bias added: one run a channel when the tile
// holds whole output rows (at most kMaxRun positions), else one a
// (channel, row).  Lane l takes the elements congruent to l mod 32, so
// each store instruction covers one aligned 32-element run; a warp takes
// kRuns runs at a time and reads all their map values before it stores
// any.  Biases from ``bs`` (shared memory, by the tile's channel).
template <typename OutT, int kMaxRun>
__device__ __forceinline__ void store_tile(OutT* __restrict__ out, const uint32_t* stage,
                                           int row_words, int channels,
                                           const OutT* __restrict__ map, bool has_bias,
                                           const float* bs, const Geometry& g, int b, int n0,
                                           int oh0, int ow0) {
  constexpr int kRuns = 4, kIt = (kMaxRun + 31) / 32 + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int rows = min(g.tr, g.ho - oh0);
  const int cols = min(g.tw, g.wo - ow0);
  const bool whole = g.tw == g.wo;
  const int runs_per_n = whole ? 1 : rows;
  const int len = whole ? rows * g.wo : cols;
  const int runs = channels * runs_per_n;
  const size_t plane = static_cast<size_t>(g.ho) * g.wo;
  for (int run0 = warp * kRuns; run0 < runs; run0 += warps * kRuns) {
    size_t e0[kRuns], m0[kRuns];
    int k0[kRuns], nl[kRuns], r[kRuns];
    float mv[kRuns][kIt];
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      const int run = run0 + u;
      nl[u] = run / runs_per_n;
      r[u] = run - nl[u] * runs_per_n;
      const int n = n0 + nl[u];
      const bool live = run < runs && n < g.cout;
      const size_t at = static_cast<size_t>(oh0 + r[u]) * g.wo + ow0;
      e0[u] = (static_cast<size_t>(b) * g.cout + n) * plane + at;
      m0[u] = static_cast<size_t>(n) * plane + at;
      k0[u] = live ? lane - static_cast<int>(e0[u] & 31) : len;  // len: nothing to store
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int k = k0[u] + it * 32;
        mv[u][it] = map != nullptr && k >= 0 && k < len ? Out<OutT>::value(map + m0[u] + k)
                                                       : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      const uint32_t* src = stage + nl[u] * row_words + r[u] * g.tw;
      const float bias = has_bias && k0[u] < len ? bs[nl[u]] : 0.0f;
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int k = k0[u] + it * 32;
        if (k >= 0 && k < len)
          out[e0[u] + k] = Out<OutT>::finish(src[k], map != nullptr, mv[u][it], has_bias, bias);
      }
    }
  }
}

// MMA route prologue: the codes of the halo (hr x hc positions from input
// row ih0, column iw0) for every channel up to cin_p, channels innermost,
// positions g.stride bytes apart; zero outside the plane and beyond Cin.
// A warp takes 32 consecutive halo positions x 16 channels, a lane one
// position: each load instruction reads 32 neighbouring elements of one
// channel (whole lines), and a lane stores its 16 codes as one 16-byte word
// (positions an odd number of 16-byte slots apart: the 8 lanes of each
// phase hit 8 different slots); kU such blocks loaded before any is
// quantized.
template <int kIn, int kU>
__device__ __forceinline__ void stage_codes(const void* __restrict__ x, const Geometry& g,
                                            int b, int ih0, int iw0, uint8_t* codes) {
  using T = typename In<kIn>::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hp = g.hr * g.hc;
  const int groups = g.cin_p >> 4;
  const int items = ((hp + 31) >> 5) * groups;
  for (int it0 = warp; it0 < items; it0 += 8 * kU) {
    T v[kU][16];
    int dst[kU], cmax[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int it = it0 + u * 8;
      const int pb = it / groups;
      const int pos = pb * 32 + lane, c = (it - pb * groups) * 16;
      const bool live = it < items && pos < hp;
      int hr = 0, hc = 0;
      if (live) {
        hr = pos / g.hc;
        hc = pos - hr * g.hc;
      }
      const int ih = ih0 + hr, iw = iw0 + hc;
      const bool inside = live && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      dst[u] = live ? pos * g.stride + c : -1;
      cmax[u] = inside ? min(16, g.cin - c) : 0;  // channels that hold codes
      const size_t i0 = inside ? In<kIn>::index(g, b, c, ih, iw) : 0, step = In<kIn>::cstep(g);
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (q < cmax[u]) v[u][q] = In<kIn>::load(x, i0 + q * step);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (dst[u] < 0) continue;
      uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (q < cmax[u]) word[q >> 2] |= In<kIn>::code(v[u][q], g.inv) << (8 * (q & 3));
      *reinterpret_cast<uint4*>(codes + dst[u]) = make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
}

// kStageCodes (codes-in mode, Cin % 16 == 0, x on the 16-byte grid): each
// position's codes copied by cp.async, 16 channels a copy, straight into
// their place in the halo; zero outside the plane and beyond Cin.
__device__ __forceinline__ void stage_nhwc_codes(const void* __restrict__ x, const Geometry& g,
                                                 int b, int ih0, int iw0, uint8_t* codes) {
  const int groups = g.cin_p >> 4;
  const int items = g.hr * g.hc * groups;
  const char* xb = static_cast<const char*>(x);
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int pos = i / groups, q = i - pos * groups;
    const int hr = pos / g.hc, hc = pos - hr * g.hc;
    const int ih = ih0 + hr, iw = iw0 + hc;
    uint8_t* dst = codes + pos * g.stride + q * 16;
    if (q * 16 < g.cin && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
      cp_async16(dst, xb + ((static_cast<size_t>(b) * g.h + ih) * g.w + iw) * g.cin + q * 16);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();  // this thread's copies have landed (the K loop syncs the CTA)
}

// kStageRows (site mode, x's rows contiguous along W; the plan takes it
// at an N tile of 32, where the input halo outweighs the output): kRowGroup
// channels at a time, each (channel, halo row)'s columns inside the plane
// copied by cp.async as the 16-byte words that hold them into a raw buffer
// of kRowGroup x hr rows of rows_pitch bytes; two buffers in turn, so the
// next channels' copies are in flight while these are quantized from shared
// memory into the codes, laid out as stage_codes lays them out.  A word that
// holds an element of the row lies in the element's page: the copies read
// no memory the tensor does not touch.
template <int kIn>
__device__ __forceinline__ int rows_pitch(const Geometry& g) {
  return ((g.hc * static_cast<int>(sizeof(typename In<kIn>::T)) + 30) >> 4) << 4;
}

template <int kIn>
__device__ __forceinline__ void stage_rows(const void* __restrict__ x, const Geometry& g, int b,
                                           int ih0, int iw0, uint8_t* codes, uint8_t* raw) {
  using T = typename In<kIn>::T;
  constexpr int kEs = sizeof(T);
  const int tid = threadIdx.x, pitch = rows_pitch<kIn>(g);
  const int groups = g.cin_p / kRowGroup;
  const int lo = max(iw0, 0), hi = min(iw0 + g.hc, g.w);  // the halo's columns in the plane
  const int words = pitch >> 4, rows = kRowGroup * g.hr;
  const int buf_bytes = rows * pitch;
  const char* xb = static_cast<const char*>(x);
  auto row_start = [&](int c, int ih) {  // the address of (c, ih, lo)
    return xb + (b * g.sb + c * g.sc + ih * g.sh + lo) * kEs;
  };
  auto issue = [&](int q) {
    if (q < groups && lo < hi) {
      uint8_t* buf = raw + (q & 1) * buf_bytes;
      for (int i = tid; i < rows * words; i += kThreads) {
        const int rr = i / words, k = i - rr * words;
        const int cl = rr / g.hr;
        const int c = q * kRowGroup + cl, ih = ih0 + rr - cl * g.hr;
        if (c < g.cin && ih >= 0 && ih < g.h) {
          const char* p = row_start(c, ih);
          const char* word = reinterpret_cast<const char*>(
              (reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(15)) + k * 16);
          if (word < p + (hi - lo) * kEs) cp_async16(buf + rr * pitch + k * 16, word);
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  const int hp = g.hr * g.hc;
  for (int q = 0; q < groups; ++q) {
    cp_async_wait<1>();  // this thread's copies of group q have landed
    __syncthreads();     // everyone's
    const uint8_t* buf = raw + (q & 1) * buf_bytes;
    for (int pos = tid; pos < hp; pos += kThreads) {
      const int hr = pos / g.hc, hc = pos - hr * g.hc;
      const int ih = ih0 + hr, iw = iw0 + hc;
      uint32_t word[4] = {0u, 0u, 0u, 0u};
      if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w) {
#pragma unroll
        for (int cl = 0; cl < kRowGroup; ++cl) {
          const int c = q * kRowGroup + cl;
          if (c < g.cin) {
            const int off = static_cast<int>(reinterpret_cast<uintptr_t>(row_start(c, ih)) & 15) +
                            (iw - lo) * kEs;
            const T v = *reinterpret_cast<const T*>(buf + (cl * g.hr + hr) * pitch + off);
            word[cl >> 2] |= In<kIn>::code(v, g.inv) << (8 * (cl & 3));
          }
        }
      }
      *reinterpret_cast<uint4*>(codes + pos * g.stride + q * kRowGroup) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
    __syncthreads();  // buffer q & 1 is free
    issue(q + 2);
  }
}

// The MMA route's prologue, as g.staging asks: the halo's codes (``raw``:
// kStageRows's buffers).
template <int kIn, int kU>
__device__ __forceinline__ void stage_halo(const void* __restrict__ x, const Geometry& g, int b,
                                           int ih0, int iw0, uint8_t* codes, uint8_t* raw) {
  if constexpr (kIn == kInS8) {
    if (g.staging == kStageCodes) return stage_nhwc_codes(x, g, b, ih0, iw0, codes);
  } else {
    if (g.staging == kStageRows) return stage_rows<kIn>(x, g, b, ih0, iw0, codes, raw);
  }
  stage_codes<kIn, kU>(x, g, b, ih0, iw0, codes);
}

// CTAs an SM the register budget allows, by the warp's N width
constexpr int mma_min_blocks(int nf) { return nf >= 8 ? 2 : (nf == 2 ? 4 : 3); }

// Shared memory (bytes): the codes and, after the K loop, the staged tile
// in one region; then the weight ring; then the scales and biases.
template <int kIn, typename OutT, int kNF>
__global__ void __launch_bounds__(kThreads, mma_min_blocks(kNF))
    int8_site_mma_kernel(const void* __restrict__ x, const uint2* __restrict__ wt,
                         const float* __restrict__ s_w, const OutT* __restrict__ map,
                         const OutT* __restrict__ bias, OutT* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kBN = kNF * 16;             // channels a CTA; a warp kNF n8 tiles
  constexpr int kStepBytes = kBN * 32;      // the CTA's weights of one 32-deep step
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int b, oh0, ow0;
  tile_of(g, b, oh0, ow0);
  const int n0 = blockIdx.y * kBN;
  const int codes_bytes = g.hr * g.hc * g.stride;  // a multiple of 16
  const int raw_bytes = g.staging == kStageRows ? 2 * kRowGroup * g.hr * rows_pitch<kIn>(g) : 0;
  const int region = (max(codes_bytes + raw_bytes, kBN * kStageRow * 4) + 15) & ~15;
  uint8_t* ring = smem + region;
  float* sc = reinterpret_cast<float*>(ring + kRing * kStepBytes);
  float* bs = sc + kBN;

  // the weight ring: step s in slot s % kRing, 16 bytes a thread; every
  // thread commits one group a step (empty past the last step)
  const int chunks = g.cin_p >> 5;
  const int steps = g.ksize * g.ksize * chunks;
  const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(wt) + static_cast<size_t>(n0 / 8) * 256;
  const size_t step_src = static_cast<size_t>(g.n_tiles8) * 256;
  auto issue = [&](int s) {
    if (s < steps)
      for (int c = tid; c < kStepBytes / 16; c += kThreads)
        cp_async16(ring + (s % kRing) * kStepBytes + c * 16, wsrc + s * step_src + c * 16);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  for (int i = tid; i < kBN; i += kThreads) {
    const int n = n0 + i;
    sc[i] = s_w != nullptr && n < g.cout ? __fmul_rn(g.s_x, __ldg(s_w + n)) : 0.0f;
    bs[i] = bias != nullptr && n < g.cout ? to_float(bias[n]) : 0.0f;
  }
  stage_halo<kIn, (kNF >= 6 ? 1 : 2)>(x, g, b, oh0 - g.pad, ow0 - g.pad, smem,
                                     smem + codes_bytes);

  const int wm = warp & 3, wn = warp >> 2;
  const int grp = lane >> 2, tig = lane & 3;
  // ldmatrix.x4 of an m16 x k32 A tile: lanes 0-7 give rows 0-7 (bytes
  // 0-15), 8-15 rows 8-15, 16-23 rows 0-7 (bytes 16-31), 24-31 rows 8-15;
  // a row past the tile reads position 0 and is never stored
  const uint32_t codes_s = smem_u32(smem);
  uint32_t a_addr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    int r = m / g.tw, j = m - r * g.tw;
    if (r >= g.tr) r = j = 0;
    a_addr[i] = codes_s + (r * g.hc + j) * g.stride + (lane >> 4) * 16;
  }
  int acc[2][kNF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < kNF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0;

  // B fragment of the warp's n8 tile f: lane's 8 bytes of tile wn * kNF + f
  const int b_off = (wn * kNF * 32 + lane) * 8;
  int chunk = 0;
  uint32_t tap_off = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRing - 2>();  // this thread's copies of step s have landed
    __syncthreads();  // everyone's (and, at s = 0, the codes); slot (s - 1) is free
    issue(s + kRing - 1);
    const uint8_t* slot = ring + (s % kRing) * kStepBytes + b_off;
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], a_addr[i] + tap_off + chunk * 32);
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      const uint2 bf = *reinterpret_cast<const uint2*>(slot + f * 256);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][f], a[i], bf);
    }
    if (++chunk == chunks) {
      chunk = 0;
      const int tap = (s + 1) / chunks;
      const int kh = tap / g.ksize, kw = tap - kh * g.ksize;
      tap_off = (kh * g.dil * g.hc + kw * g.dil) * g.stride;
    }
  }

  // the epilogue: accumulator e of fragment (i, f) is position row grp (+ 8
  // for e >= 2), channel column tig * 2 + (e & 1); scaled here, the map and
  // the bias added in the store pass
  __syncthreads();  // every warp is done with the codes: the stage takes their place
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < kNF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm * 32 + i * 16 + grp + (e >> 1) * 8;
        const int nl = wn * (kNF * 8) + f * 8 + tig * 2 + (e & 1);
        stage[nl * kStageRow + m] = Out<OutT>::scaled(acc[i][f][e], sc[nl]);
      }
  __syncthreads();
  if (g.tw == g.wo)  // whole rows: a channel's run is the tile
    store_tile<OutT, kBM>(out, stage, kStageRow, kBN, map, bias != nullptr, bs, g, b, n0, oh0,
                          ow0);
  else  // a (channel, row)'s run: at most 64 positions
    store_tile<OutT, 64>(out, stage, kStageRow, kBN, map, bias != nullptr, bs, g, b, n0, oh0,
                         ow0);
}

// Cin = 1: a CTA a tile of tr x tw output positions whose output is one
// run per channel (whole rows, or one row), a thread one position, every
// channel of its range.  The position's taps are packed four to a word
// once, in the weights' order (row n of wt: tap kh * ksize + kw at byte
// tap, zero beyond k * k); then kCin1Group channels at a time are finished
// into shared memory (the map read along the positions) and stored with
// lane l on the elements congruent to l mod 32, so each store instruction
// covers one aligned line.
template <int kIn, typename OutT, int kQuads>
__global__ void __launch_bounds__(kCin1MaxThreads)
    int8_site_cin1_kernel(const void* __restrict__ x, const uint4* __restrict__ wt,
                          const float* __restrict__ s_w, const OutT* __restrict__ map,
                          const OutT* __restrict__ bias, OutT* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, threads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = threads >> 5;
  int b, oh0, ow0;
  tile_of(g, b, oh0, ow0);
  const int n0 = blockIdx.y * kCin1MaxN;
  const int nc = min(kCin1MaxN, g.cout - n0);
  const int positions = g.tr * g.tw;
  uint4* ws = reinterpret_cast<uint4*>(smem);
  float* sc = reinterpret_cast<float*>(ws + kCin1MaxN * kQuads);
  float* bs = sc + kCin1MaxN;
  OutT* stage = reinterpret_cast<OutT*>(bs + kCin1MaxN);
  uint8_t* codes = reinterpret_cast<uint8_t*>(stage) + kCin1Group * positions * 4;
  for (int i = tid; i < nc * kQuads; i += threads)
    ws[i] = __ldg(wt + static_cast<size_t>(n0) * kQuads + i);
  for (int i = tid; i < nc; i += threads) {
    sc[i] = s_w != nullptr ? __fmul_rn(g.s_x, __ldg(s_w + n0 + i)) : 0.0f;
    bs[i] = bias != nullptr ? to_float(bias[n0 + i]) : 0.0f;
  }
  const int ih0 = oh0 - g.pad, iw0 = ow0 - g.pad;
  const int hp = g.hr * g.hc;
  // neighbouring threads on neighbouring addresses: along W, or along H
  // where the plane is transposed in memory
  const bool down = g.sh < g.sw;
  for (int p = tid; p < hp; p += threads) {
    int hr, hc;
    if (down) {
      hc = p / g.hr;
      hr = p - hc * g.hr;
    } else {
      hr = p / g.hc;
      hc = p - hr * g.hc;
    }
    const int ih = ih0 + hr, iw = iw0 + hc;
    uint32_t code = 0;
    if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
      code = In<kIn>::code(In<kIn>::load(x, In<kIn>::index(g, b, 0, ih, iw)), g.inv);
    codes[hr * g.hc + hc] = static_cast<uint8_t>(code);
  }
  __syncthreads();

  const int r = tid / g.tw, j = tid - r * g.tw;
  const int oh = oh0 + r, ow = ow0 + j;
  const bool live = tid < positions && oh < g.ho && ow < g.wo;
  const int taps = g.ksize * g.ksize;
  int a[kQuads * 4];
#pragma unroll
  for (int q = 0; q < kQuads * 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tap = q * 4 + e;
      if (live && tap < taps) {
        const int kh = tap / g.ksize, kw = tap - kh * g.ksize;
        word |= static_cast<uint32_t>(codes[(r + kh * g.dil) * g.hc + j + kw * g.dil])
                << (8 * e);
      }
    }
    a[q] = static_cast<int>(word);
  }
  // the run of each channel: rows x cols positions, contiguous in memory
  const int rows = min(g.tr, g.ho - oh0), cols = min(g.tw, g.wo - ow0);
  const int len = rows * cols;
  const size_t plane = static_cast<size_t>(g.ho) * g.wo;
  const size_t at = static_cast<size_t>(oh0) * g.wo + ow0;
  const bool has_map = map != nullptr, has_bias = bias != nullptr;
  for (int c0 = 0; c0 < nc; c0 += kCin1Group) {
    if (live) {
#pragma unroll 4
      for (int c = 0; c < kCin1Group; ++c) {
        const int n = min(c0 + c, nc - 1);
        int acc = 0;
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          const uint4 w = ws[n * kQuads + q];
          acc = __dp4a(a[4 * q], static_cast<int>(w.x), acc);
          acc = __dp4a(a[4 * q + 1], static_cast<int>(w.y), acc);
          acc = __dp4a(a[4 * q + 2], static_cast<int>(w.z), acc);
          acc = __dp4a(a[4 * q + 3], static_cast<int>(w.w), acc);
        }
        const float mv = has_map ? Out<OutT>::value(map + (n0 + n) * plane + at + tid) : 0.0f;
        stage[c * positions + tid] =
            Out<OutT>::finish(Out<OutT>::scaled(acc, sc[n]), has_map, mv, has_bias, bs[n]);
      }
    }
    __syncthreads();
    for (int c = warp; c < min(kCin1Group, nc - c0); c += warps) {
      const size_t e0 = (static_cast<size_t>(b) * g.cout + n0 + c0 + c) * plane + at;
      const OutT* src = stage + c * positions;
      for (int k = lane - static_cast<int>(e0 & 31); k < len; k += 32)
        if (k >= 0) out[e0 + k] = src[k];
    }
    __syncthreads();  // the stage is free for the next channels
  }
}

struct Args {
  const void* x;
  const void* wt;
  const float* s_w;
  const void* map;
  const void* bias;
  void* out;
};

// Once per kernel: the dynamic shared memory it may take, and the largest
// shared-memory carveout (more CTAs an SM; the weights stream through
// shared memory, not L1).
template <typename K>
cudaError_t prepare(K kernel, int smem, int& allowed) {
  if (allowed == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    allowed = 48 * 1024;
  }
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  return cudaSuccess;
}

template <int kIn, typename OutT, int kNF>
int launch_mma(dim3 grid, int, int smem, cudaStream_t s, const Args& a, const Geometry& g) {
  static int allowed = 0;
  auto kernel = int8_site_mma_kernel<kIn, OutT, kNF>;
  const cudaError_t err = prepare(kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, s>>>(
      a.x, static_cast<const uint2*>(a.wt), a.s_w, static_cast<const OutT*>(a.map),
      static_cast<const OutT*>(a.bias), static_cast<OutT*>(a.out), g);
  return static_cast<int>(cudaGetLastError());
}

template <int kIn, typename OutT, int kQuads>
int launch_cin1(dim3 grid, int threads, int smem, cudaStream_t s, const Args& a,
                const Geometry& g) {
  static int allowed = 0;
  auto kernel = int8_site_cin1_kernel<kIn, OutT, kQuads>;
  const cudaError_t err = prepare(kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(
      a.x, static_cast<const uint4*>(a.wt), a.s_w, static_cast<const OutT*>(a.map),
      static_cast<const OutT*>(a.bias), static_cast<OutT*>(a.out), g);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadRoute = 1000;  // no kernel for the route asked (checked by the wrapper)

template <int kIn, typename OutT>
int dispatch(int route, dim3 grid, int threads, int smem, cudaStream_t s, const Args& a,
             const Geometry& g) {
  switch (route) {
    case 2: return launch_mma<kIn, OutT, 2>(grid, threads, smem, s, a, g);
    case 4: return launch_mma<kIn, OutT, 4>(grid, threads, smem, s, a, g);
    case 6: return launch_mma<kIn, OutT, 6>(grid, threads, smem, s, a, g);
    case 8: return launch_mma<kIn, OutT, 8>(grid, threads, smem, s, a, g);
    case -1: return launch_cin1<kIn, OutT, 1>(grid, threads, smem, s, a, g);
    case -2: return launch_cin1<kIn, OutT, 2>(grid, threads, smem, s, a, g);
    case -4: return launch_cin1<kIn, OutT, 4>(grid, threads, smem, s, a, g);
    default: return kBadRoute;
  }
}

}  // namespace

extern "C" {

// The constants the wrapper plans with: 0 MMA-route threads, 1 its
// positions a CTA, 2 its weight ring's steps, 3 the Cin = 1 route's
// threads (positions) a CTA at most, 4 its channels a CTA, 5 its channels
// staged at a time.
int int8_conv_constant(int which) {
  switch (which) {
    case 0: return kThreads;
    case 1: return kBM;
    case 2: return kRing;
    case 3: return kCin1MaxThreads;
    case 4: return kCin1MaxN;
    case 5: return kCin1Group;
    default: return -1;
  }
}

// One launch.  in_kind: 0 float32 NCHW, 1 bfloat16 NCHW (site mode), 2
// int8 codes NHWC (codes-in mode); out_kind: 0 float32, 1 bfloat16, 2 int32
// (codes-in mode only; scale unread).  route: 2, 4, 6, 8 the MMA route with
// N tiles of 16 x route channels; -1, -2, -4 the Cin = 1 route with that
// many 16-tap quads a channel; staging: the MMA route's prologue
// (kStageLoads, kStageCodes, kStageRows).  The
// wrapper plans the tile (tr x tw), the threads a CTA, the halo stride, the
// prologue and the shared memory, and checks the
// geometry; sb .. sw are x's strides in elements (site mode; the codes-in
// mode reads contiguous NHWC); returns the cudaError_t of the launch (0 on
// success), or 1000 for a combination no kernel was built for.
int int8_conv_launch(const void* x, const void* wt, const void* s_w, const void* map,
                     const void* bias, void* out, int in_kind, int out_kind, int route,
                     int batch, int h, int w, int cin, int cout, int ksize, int pad,
                     int dil, int tr, int tw, int cin_p, int stride, int staging,
                     int n_tiles8, int grid_y, long long sb, long long sc, long long sh,
                     long long sw, float inv, float s_x, int threads, int smem, int device,
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
  g.cin_p = cin_p;
  g.tr = tr;
  g.tw = tw;
  g.hr = tr + dil * (ksize - 1);
  g.hc = tw + dil * (ksize - 1);
  g.stride = stride;
  g.staging = staging;
  g.tiles_h = (g.ho + tr - 1) / tr;
  g.tiles_w = (g.wo + tw - 1) / tw;
  g.n_tiles8 = n_tiles8;
  g.sb = sb;
  g.sc = sc;
  g.sh = sh;
  g.sw = sw;
  g.inv = inv;
  g.s_x = s_x;
  const dim3 grid(batch * g.tiles_h * g.tiles_w, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, wt, static_cast<const float*>(s_w), map, bias, out};
  if (in_kind == kInF32 && out_kind == 0)
    return dispatch<kInF32, float>(route, grid, threads, smem, s, a, g);
  if (in_kind == kInBF16 && out_kind == 1)
    return dispatch<kInBF16, __nv_bfloat16>(route, grid, threads, smem, s, a, g);
  if (in_kind == kInS8 && out_kind == 0)
    return dispatch<kInS8, float>(route, grid, threads, smem, s, a, g);
  if (in_kind == kInS8 && out_kind == 1)
    return dispatch<kInS8, __nv_bfloat16>(route, grid, threads, smem, s, a, g);
  if (in_kind == kInS8 && out_kind == 2)
    return dispatch<kInS8, int>(route, grid, threads, smem, s, a, g);
  return kBadRoute;
}

const char* int8_conv_error_string(int err) {
  if (err == kBadRoute) return "no int8 kernel for this input, output and route";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
