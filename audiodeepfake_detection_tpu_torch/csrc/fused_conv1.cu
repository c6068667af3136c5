// First DCNN block in one pass: conv2d(1 -> C, 3x3, zero pad 2) + bias ->
// PReLU (one slope) -> floor-mode 2x2 max-pool, forward and backward.
//
//   x [B, H, W] (f32 or bf16), w [9, C], b [C], alpha [1] (f32)
//     -> out, stored [B, C, h2, w2] (NCHW; x's type), h2 = (H + 2) / 2,
//        w2 = (W + 2) / 2
//   training forward also: a selection code per output element, stored like
//     out (pool phase | negative << 2, one byte), and per-block partial
//     per-channel (sum, sumsq) of the rounded stored output;
//   backward: per-block partials of dW [9, C], db [C] and dalpha from g
//     (stored like out), the code and x.
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/fused_conv1.py::
// _fwd_master and ::_bwd_kernel (reached through fused_conv1_prelu_pool and
// fused_conv1_prelu_pool_stats).  Those kernels split the image into four
// parity phases outside the kernel, materialised 36 tap planes in scratch,
// ran a block-diagonal [4C, 36] matmul per row and stored [B, h2, C, w2] for
// a later transpose; all of that served the TPU's matrix unit and lane
// layout and is not carried over.  Kept: what is computed, and what stays
// out of device memory -- the pre-pool activation [B, H+2, W+2, C] (four
// times the output) in the forward, and its gradient in the backward.  The
// output is stored NCHW because the convolutions behind the block (cuDNN)
// read NCHW: the wrapper hands it out as a [B, h2, w2, C] view, so no
// transposing copy follows the block in either direction.
//
// What bounds it on the H100.  At B=128, H=95, W=256, C=64 in f32 the
// training forward reads 12.5 MB and writes 203 MB of output plus 51 MB of
// codes (~79 us at 3.35 TB/s) and does 36 FMAs per output (3.7 GFLOP, ~55 us
// at 67 TFLOP/s).  But a stored value also costs four PReLUs, a four-way
// first maximum and its moments: some 70 instructions, so the forward is
// bound by issue, and its design keeps the issue for arithmetic.  A thread
// owns four pool windows, holds the 4x4 patch of x under each in registers
// (read once from a halo tile staged by cp.async), and walks the channels:
// a channel's bias and 9 taps are three float4 reads of a shared copy of w
// and b that every lane reads at once (broadcasts), 3 loads for 144 FMAs.
// A block owns a contiguous range of a frame's flattened [h2, w2] plane (of
// a column tile's rows, for planes wider than one tile); neighbouring lanes
// own neighbouring windows, so every per-channel store of out and of the
// code is contiguous across the warp, across row ends too.  Each conv value
// is the bias, then fmaf over the taps with dh ascending and dw ascending
// inside it; phases are compared in the order (0,0), (0,1), (1,0), (1,1)
// with a strict >, so out and code do not depend on the tiling.  Moments: a
// warp shuffle sum per channel (after the first step lanes 0-15 carry the
// sum and lanes 16-31 the sum of squares, so both take five steps), one
// slot per warp, the slots summed in a fixed order.
//
// The backward reads g, the code and x once (~79 us at this shape) and does
// not read out: it rebuilds the selected phase's conv value from the same
// nine taps in the same fmaf order (dalpha needs that value anyway), then
// PReLU and the rounding to the stored type as the forward did, so the
// sumsq cotangent's 2 * out * gq sees the stored value bit for bit.  A lane
// owns one channel and walks a contiguous run of windows of a strip of four
// pooled rows, so its 9 dW sums stay in registers and every lane of a warp
// reads x under the same window (from the halo tile: at most four
// addresses, in distinct banks).  g and the code are NCHW, so a warp's 32
// channels are 32 rows of memory: the warp copies 16 windows of them at a
// time with coalesced loads (where the plane holds a multiple of four
// windows, as the DCNN's 48 x 129 does, four windows a load: 16 bytes of g,
// a word of codes), the next 16 in flight while these are summed, into a
// buffer of its own in shared memory from which each lane reads its row.
// (Lanes on windows instead, as in the forward, pay 21 selects a window
// for the phase's 3x3 of a patch held in registers and a reduction across
// lanes a channel: measured slower, PERF.md.)
//
// dalpha is the true sum of conv * g over negative selected elements, so an
// exactly-zero slope still receives its gradient (the TPU kernel divides by
// alpha and returns 0 there).
//
// Cross-block reductions: Hopper's blocks run in any order, so nothing is
// accumulated across blocks here, and no atomics are used.  Each block
// reduces its own threads in a fixed order and writes one row of partials;
// the wrapper sums the rows with one torch.sum, which is deterministic.
// BatchNorm moments and gradients are therefore bit-for-bit reproducible
// from run to run.
//
// The second kernel pair of this file, fused_conv_mfm_{fwd,bwd}_kernel, is
// the LCNN's first block; its note stands above it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound from Python with ctypes (ops/fused_conv1_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBwdRows = 11;     // 9 dW taps, db, dalpha
constexpr int kFwdThreads = 128;  // forward block
constexpr int kFwdWindows = 4;    // pool windows a forward thread owns
constexpr int kTapFloats = 12;    // a channel's bias, 9 taps, 2 zeros (3 float4s)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

struct Tile {
  int b, i0, j0;  // frame, first pooled row, first pooled column
};

// Blocks are numbered frame-major, then row strip, then column strip.
__device__ __forceinline__ Tile tile_of_block(int h2, int w2, int rows, int wt) {
  const int n_ct = (w2 + wt - 1) / wt;
  const int n_rt = (h2 + rows - 1) / rows;
  int blk = blockIdx.x;
  Tile t;
  t.j0 = (blk % n_ct) * wt;
  blk /= n_ct;
  t.i0 = (blk % n_rt) * rows;
  t.b = blk / n_rt;
  return t;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One element of a zero-padded x tile: f32 by 4-byte cp.async (a padding
// element reads nothing and lands as zero), bf16 by a widening load.  The
// caller commits the copies to a group and waits for it.
__device__ __forceinline__ void stage_x(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void stage_x(float* dst, const __nv_bfloat16* src, bool in) {
  *dst = in ? __bfloat162float(*src) : 0.f;
}

// Four consecutive elements as floats (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// Padded rows [pr0, pr0 + n_rows) by padded columns [pc0, pc0 + n_cols) of
// frame b, where padded (r, c) is x[r - 2][c - 2] (zero outside x; both
// blocks pad by 2), to xs rows of `stride` floats: a warp a row, lanes
// along it (no division per element).  Threads of a last, partial warp
// copy nothing.
template <typename T>
__device__ __forceinline__ void stage_halo(const T* __restrict__ x, float* xs, int b,
                                           int pr0, int n_rows, int pc0, int n_cols,
                                           int h, int w, int stride) {
  const T* frame = x + static_cast<size_t>(b) * h * w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (warp >= n_warps) return;
  for (int lr = warp; lr < n_rows; lr += n_warps) {
    const int r = pr0 + lr - 2;
    const bool row_in = r >= 0 && r < h;
    const T* src = frame + static_cast<size_t>(row_in ? r : 0) * w;
    for (int lc = lane; lc < n_cols; lc += 32) {
      const int c = pc0 + lc - 2;
      const bool in = row_in && c >= 0 && c < w;
      stage_x(xs + lr * stride + lc, src + (in ? c : 0), in);
    }
  }
}

// Forward.  Blocks are numbered frame-major, then column tile, then range:
// block k of a (frame, column tile) owns windows [k * n_w, (k + 1) * n_w) of
// the tile's rows flattened (window (i, j) at i * wt + j; columns past the
// plane's edge own nothing); thread t the windows t, t + kFwdThreads, ... of
// it.  kFlat: one column tile, so a thread's windows lie kFwdThreads apart
// in the plane too and its stores take immediate offsets.
// Dynamic shared memory: the channels' biases and taps (C rows of 12 floats),
// a (sum, sumsq) slot per warp and channel, then the x tile (rows of
// `stride` floats).
template <typename T, bool kFlat>
__global__ void __launch_bounds__(kFwdThreads)
fused_conv1_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ alpha_p, T* __restrict__ out,
                       unsigned char* __restrict__ code,
                       float* __restrict__ stat_partials, int h, int win,
                       int c_total, int wt, int n_ct, int n_w, int stride) {
  extern __shared__ float4 conv1_smem[];
  float* ws = reinterpret_cast<float*>(conv1_smem);
  constexpr int n_warps = kFwdThreads / 32;
  float* red = ws + c_total * kTapFloats;
  float* xs = red + n_warps * c_total * 2;
  const int h2 = (h + 2) / 2, w2 = (win + 2) / 2;
  const int per_tile = (h2 * wt + n_w - 1) / n_w;
  const int k = blockIdx.x % per_tile;
  const int ct = (blockIdx.x / per_tile) % n_ct;
  const int b = blockIdx.x / per_tile / n_ct;
  const int j0 = ct * wt;
  const int q0 = k * n_w, q1 = min(q0 + n_w, h2 * wt);
  const int r0 = q0 / wt, r1 = (q1 - 1) / wt;  // the pooled rows it spans
  for (int i = threadIdx.x; i < c_total * kTapFloats; i += kFwdThreads) {
    const int c = i / kTapFloats, r = i - c * kTapFloats;
    ws[i] = r == 0 ? bias[c] : (r <= 9 ? w[(r - 1) * c_total + c] : 0.f);
  }
  stage_halo(x, xs, b, 2 * r0, 2 * (r1 - r0) + 4, 2 * j0, 2 * wt + 2, h, win, stride);
  cp_async_commit();
  const float alpha = alpha_p[0];
  const size_t plane = static_cast<size_t>(h2) * w2;
  cp_async_wait_all();
  __syncthreads();

  // the 4x4 patch under each window: conv (2i+a, 2j+b), tap (dh, dw) reads
  // patch[a + dh][b + dw]; stride and 2j are even, so float2 reads
  float patch[kFwdWindows][4][4];
  int off[kFwdWindows];  // the window's element in the plane, i * w2 + j
  bool valid[kFwdWindows];
  bool any = false;
#pragma unroll
  for (int kw = 0; kw < kFwdWindows; ++kw) {
    const int p = q0 + threadIdx.x + kw * kFwdThreads;
    int li = p / wt, lj = p - li * wt;
    valid[kw] = p < q1 && j0 + lj < w2;
    any |= valid[kw];
    if (!valid[kw]) li = r0, lj = 0;  // a window inside the tile; nothing stored
    off[kw] = li * w2 + j0 + lj;
    const float* base = xs + 2 * (li - r0) * stride + 2 * lj;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float2 v = reinterpret_cast<const float2*>(base + r * stride)[q];
        patch[kw][r][2 * q] = v.x;
        patch[kw][r][2 * q + 1] = v.y;
      }
  }
  const int off0 = q0 + threadIdx.x;  // kFlat: window kw at off0 + kw * kFwdThreads
  // a warp none of whose lanes owns a window skips the channels
  const bool warp_idle = !__any_sync(0xffffffffu, any);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* taps4 = reinterpret_cast<const float4*>(ws);
  T* out_c = out + static_cast<size_t>(b) * c_total * plane;  // channel c's plane
  unsigned char* code_c =
      code != nullptr ? code + static_cast<size_t>(b) * c_total * plane : nullptr;
#pragma unroll 1
  for (int c = 0; c < c_total; ++c) {
    float s = 0.f, q = 0.f;
    if (!warp_idle) {
      // the same address in every lane: broadcasts
      const float4 t0 = taps4[3 * c], t1 = taps4[3 * c + 1], t2 = taps4[3 * c + 2];
      const float tap[9] = {t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w, t2.x, t2.y};
      // every window computed, invalid ones too (their patch is a real one):
      // no branch between the windows' chains
#pragma unroll
      for (int kw = 0; kw < kFwdWindows; ++kw) {
        float best = 0.f;
        unsigned best_code = 0;
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
          const int a = ph >> 1, bb = ph & 1;
          float conv = t0.x;
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
#pragma unroll
            for (int dw = 0; dw < 3; ++dw)
              conv = fmaf(tap[dh * 3 + dw], patch[kw][a + dh][bb + dw], conv);
          const bool neg = conv < 0.f;
          const float act = neg ? alpha * conv : conv;
          // strict >: ties keep the first phase of (0,0),(0,1),(1,0),(1,1)
          if (ph == 0 || act > best) {
            best = act;
            best_code = neg ? ph | 4 : ph;
          }
        }
        T stored;
        from_float(best, &stored);
        const float rounded = valid[kw] ? to_float(stored) : 0.f;  // what a later pass reads
        s += rounded;
        q = fmaf(rounded, rounded, q);
        const int o = kFlat ? off0 + kw * kFwdThreads : off[kw];
        if (valid[kw]) {
          out_c[o] = stored;
          if (code_c != nullptr) code_c[o] = static_cast<unsigned char>(best_code);
        }
      }
    }
    if (stat_partials != nullptr) {
      // lanes 0-15 go on with the sum, 16-31 with the sum of squares
      const bool lo = lane < 16;
      float keep = lo ? s : q;
      keep += __shfl_xor_sync(0xffffffffu, lo ? q : s, 16);
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1) keep += __shfl_xor_sync(0xffffffffu, keep, sh);
      if ((lane & 15) == 0) red[(warp * c_total + c) * 2 + (lo ? 0 : 1)] = keep;
    }
    out_c += plane;
    if (code_c != nullptr) code_c += plane;
  }
  if (stat_partials != nullptr) {
    __syncthreads();
    float* dst = stat_partials + static_cast<size_t>(blockIdx.x) * 2 * c_total;
    for (int i = threadIdx.x; i < 2 * c_total; i += kFwdThreads) {
      const int c = i % c_total, m = i / c_total;
      float acc = 0.f;
      for (int wp = 0; wp < n_warps; ++wp) acc += red[(wp * c_total + c) * 2 + m];
      dst[m * c_total + c] = acc;
    }
  }
}

// Backward.  Blocks as tile_of_block numbers them: a strip of `rows` pooled
// rows by a column tile of one frame, its n_win windows taken row-major.  A
// lane serves one channel: warp w serves the 32 channels of slab w % slabs
// over the windows of group w / slabs, a contiguous run of whole fours of
// the strip's windows.  g and the codes are NCHW, so a lane's windows lie
// along one row of memory and a warp's 32 lanes would read 32 rows: the
// warp therefore copies each 16 windows' g and codes of its 32 channels
// with coalesced loads (the next 16's in flight while these are summed)
// into a buffer of its own in shared memory, and each lane reads its row
// back.  kAligned: one column tile, a plane of a multiple of four windows
// and strips of four rows, so every four windows start on 16 bytes of g:
// four windows a load, 16 bytes of g and one word of codes; otherwise
// element by element, through each window's offset in the plane.  Per
// window a lane reads the 9 x values under the selected phase from the
// halo tile (the 32 lanes are channels of one window: at most four
// addresses, in distinct banks), rebuilds the conv value and the stored
// output, and adds d * x to its 9 dW sums.
// Dynamic shared memory: the x tile ((2*rows + 2) * stride floats), each
// window's element in the plane and its offset in the tile, then per warp a
// buffer of 32 rows of 16 windows' g (20 floats a row) and codes (5 words a
// row); the reduction (groups * 11 * slabs * 32 floats) reuses it all.
constexpr int kChunk = 16;    // windows a warp stages at a time
constexpr int kGPitch = 20;   // floats between staged rows of g: 5 x 16 bytes, odd
constexpr int kCPitch = 5;    // words between staged rows of codes: odd

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv1_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ alpha_p,
                       const T* __restrict__ g,
                       const unsigned char* __restrict__ code,
                       const float* __restrict__ gs,
                       const float* __restrict__ gq,
                       float* __restrict__ partials, int h, int win,
                       int c_total, int rows, int wt, int stride) {
  extern __shared__ float4 conv1_smem[];
  float* xs = reinterpret_cast<float*>(conv1_smem);
  int* offs = reinterpret_cast<int*>(xs + (2 * rows + 2) * stride);
  int* toffs = offs + rows * wt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* gbuf = reinterpret_cast<float*>(toffs + rows * wt) + warp * 32 * (kGPitch + kCPitch);
  unsigned* cbuf = reinterpret_cast<unsigned*>(gbuf + 32 * kGPitch);
  const int h2 = (h + 2) / 2, w2 = (win + 2) / 2;
  const Tile t = tile_of_block(h2, w2, rows, wt);
  const int wc = min(wt, w2 - t.j0), nr = min(rows, h2 - t.i0);
  const int n_win = nr * wc;
  stage_halo(x, xs, t.b, 2 * t.i0, 2 * nr + 2, 2 * t.j0, 2 * wc + 2, h, win, stride);
  // window v: its element in the plane, and (2i, 2j) in the tile
  for (int v = threadIdx.x; v < n_win; v += blockDim.x) {
    const int li = v / wc, lj = v - li * wc;
    offs[v] = (t.i0 + li) * w2 + t.j0 + lj;
    toffs[v] = 2 * li * stride + 2 * lj;
  }
  cp_async_commit();

  const int slabs = (c_total + 31) / 32, groups = (blockDim.x >> 5) / slabs;
  const int slab = warp % slabs, grp = warp / slabs;
  const int c = slab * 32 + lane;
  const bool live = c < c_total;
  float wk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wk[k] = live ? w[k * c_total + c] : 0.f;
  const float bc = live ? bias[c] : 0.f;
  const float alpha = alpha_p[0];
  // cotangents of the per-channel (sum, sumsq) outputs fold into g
  const float gsc = live && gs != nullptr ? gs[c] : 0.f;
  const float gqc = live && gq != nullptr ? gq[c] : 0.f;
  // this group's windows [wa, wb)
  const int nq = (n_win + 3) / 4;
  const int wa = min(4 * (grp * nq / groups), n_win);
  const int wb = min(4 * ((grp + 1) * nq / groups), n_win);
  const size_t plane = static_cast<size_t>(h2) * w2;
  // channel slab * 32's plane; lane k of a copy reads channel slab * 32 + k
  const size_t slab0 = (static_cast<size_t>(t.b) * c_total + slab * 32) * plane;
  const int n_live = min(32, c_total - slab * 32);
  cp_async_wait_all();
  __syncthreads();

  float acc[kBwdRows];
#pragma unroll
  for (int k = 0; k < kBwdRows; ++k) acc[k] = 0.f;
  auto step = [&](float gv, unsigned cd, int v) {
    // the selected phase (a, b): tile rows 2i + a .., columns 2j + b ..
    const float* base = xs + toffs[v] + ((cd >> 1) & 1) * stride + (cd & 1);
    const bool neg = cd & 4;
    float xv[9];
    float conv = bc;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        xv[dh * 3 + dw] = base[dh * stride + dw];
        conv = fmaf(wk[dh * 3 + dw], xv[dh * 3 + dw], conv);
      }
    // the forward's stored value, bit for bit (the code's sign is conv's)
    T stored;
    from_float(neg ? alpha * conv : conv, &stored);
    const float gt = gv + gsc + 2.f * to_float(stored) * gqc;
    const float d = neg ? alpha * gt : gt;  // through PReLU, selected phase
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = fmaf(d, xv[k], acc[k]);
    acc[9] += d;
    if (neg) acc[10] = fmaf(conv, gt, acc[10]);
  };
  // kAligned: lane l copies four windows (l & 3) of channel 8 * i + (l >> 2),
  // a chunk ahead: its loads fly while the chunk before is summed
  float4 g_next[4];
  unsigned c_next[4];
  auto fetch = [&](int v0, int n) {
    const size_t e0 = slab0 + offs[v0] + 4 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 8 * i + (lane >> 2);
      if (k < n_live && 4 * (lane & 3) < n) {
        const size_t e = e0 + k * plane;
        g_next[i] = load4(g + e);
        c_next[i] = *reinterpret_cast<const unsigned*>(code + e);
      }
    }
  };
  if (kAligned && wa < wb) fetch(wa, min(kChunk, wb - wa));
  for (int w0 = wa; w0 < wb; w0 += kChunk) {
    const int n = min(kChunk, wb - w0);
    if (kAligned) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 8 * i + (lane >> 2);
        if (k < n_live && 4 * (lane & 3) < n) {
          reinterpret_cast<float4*>(gbuf + k * kGPitch)[lane & 3] = g_next[i];
          cbuf[k * kCPitch + (lane & 3)] = c_next[i];
        }
      }
      if (w0 + kChunk < wb) fetch(w0 + kChunk, min(kChunk, wb - w0 - kChunk));
    } else {
      // lane l copies window l & 15 of channels 2 * i + (l >> 4)
      const int j = lane & 15;
      const size_t e0 = slab0 + (j < n ? offs[w0 + j] : 0);
      unsigned char* cbytes = reinterpret_cast<unsigned char*>(cbuf);
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int k = 2 * i + (lane >> 4);
        if (k < n_live && j < n) {
          const size_t e = e0 + k * plane;
          gbuf[k * kGPitch + j] = to_float(g[e]);
          cbytes[k * 4 * kCPitch + j] = code[e];
        }
      }
    }
    __syncwarp();
    if (live) {
      const int pw = w0;  // the chunk's first window
      const float* grow = gbuf + lane * kGPitch;
      const unsigned* crow = cbuf + lane * kCPitch;
      if (kAligned) {
        for (int j = 0; j < n; j += 4) {
          const float4 g4 = reinterpret_cast<const float4*>(grow)[j / 4];
          const unsigned c4 = crow[j / 4];
          step(g4.x, c4 & 0xffu, pw + j);
          step(g4.y, (c4 >> 8) & 0xffu, pw + j + 1);
          step(g4.z, (c4 >> 16) & 0xffu, pw + j + 2);
          step(g4.w, c4 >> 24, pw + j + 3);
        }
      } else {
        const unsigned char* cb = reinterpret_cast<const unsigned char*>(crow);
        for (int j = 0; j < n; ++j) step(grow[j], cb[j], pw + j);
      }
    }
    __syncwarp();  // the buffer is read before the next copy overwrites it
  }
  __syncthreads();  // every window is summed: the tile becomes the reduction buffer
  float* red = xs;
  const int width = slabs * 32;
#pragma unroll
  for (int k = 0; k < kBwdRows; ++k) red[(grp * kBwdRows + k) * width + c] = acc[k];
  __syncthreads();
  if (grp == 0 && live) {
    float* dst = partials + static_cast<size_t>(blockIdx.x) * kBwdRows * c_total;
#pragma unroll
    for (int k = 0; k < kBwdRows; ++k) {
      float sum = 0.f;
      for (int q = 0; q < groups; ++q) sum += red[(q * kBwdRows + k) * width + c];
      dst[k * c_total + c] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// First LCNN block in one pass: conv2d(1 -> C, 5x5, zero pad 2) + bias ->
// MaxFeatureMap (maximum of channel k and channel k + C/2) -> floor-mode 2x2
// max-pool, forward and backward.
//
//   x [B, H, W] (f32 or bf16), w [25, C], b [C] (f32)
//     -> out, stored [B, C/2, H/2, W/2] (NCHW; x's type)
//   training forward also: a selection code per output element, stored like
//     out, the index phase * 2 + half of the FIRST maximal candidate among
//     the eight (phase (0,0), (0,1), (1,0), (1,1)) x (half k, k + C/2);
//   backward: per-block partials of dW [25, C] and db [C] from (g, code),
//     g stored like out.
//
// Replaces the TPU kernels audiodeepfake_detection_tpu/ops/fused_conv1.py::
// _fwd_mfm_kernel and ::_bwd_mfm_kernel (reached through
// fused_conv_mfm_pool).  Their parity-phase planes, the 100 tap planes in
// scratch and the block-diagonal [4C, 100] products served the TPU's matrix
// unit and are not carried over.  Kept: what is computed, the first-match
// tie-break, and what stays out of device memory -- the pre-pool conv output
// [B, C, H, W] (eight times the block's output) and its gradient.  The
// output is stored NCHW because the convolutions behind the block (cuDNN)
// read NCHW: the wrapper hands it out as a [B, H/2, W/2, C/2] view, so no
// transposing copy follows the block in either direction.
//
// What bounds it on the H100: operations, in the forward.  At B=128, H=101,
// W=256, C=64 in f32 it reads 13 MB and writes 105 MB of output plus 26 MB of
// codes (~43 us at 3.35 TB/s) but every stored value is the maximum of eight
// 25-tap sums: 200 FMAs per output, 10.5 GFLOP, ~157 us at 67 TFLOP/s.  So
// the forward's inner loop is FMAs and little else: a thread owns one pool
// window, holds the 6x6 patch of x under it in registers (read once from the
// shared halo tile as aligned float2s; neighbouring lanes own neighbouring
// windows of a row, so the reads are conflict-free), and walks the channel
// pairs: the 50 taps and 2 biases of pair k are 13 float4 reads of a shared
// copy of w and b that every lane of the warp reads at once (broadcasts), 13
// loads for 200 FMAs.  Stores run along the window's row: coalesced.  Each
// conv value is the bias, then fmaf over the taps with dh ascending and dw
// ascending inside it; candidates are compared phase-major, lower half
// first, with a strict >, so out and code do not depend on the tiling.
//
// The backward is bound by bytes (g, code and x read once, ~43 us) in
// principle; in practice by issue: per window and channel pair it makes 25
// shared-memory reads and 50 FMAs.  A thread owns the channel pair (k,
// k + C/2): for each window it takes the code and g of its pair, reads the
// 25 x values under the selected phase (the warp's lanes read at most four
// addresses of the tile, in distinct banks) and adds g * x to the selected
// half's taps.  Both halves' sums live in registers (predicated, no indexed
// local memory) and leave the block as two reductions of 26 rows.  g and the
// codes are NCHW in device memory, so the block stages them: chunks of one
// pooled row (whole 512-byte rows of g at the LCNN's shape; dynamic shared
// memory above 48 KB), all channel pairs, copied coalesced along the row by
// 16-byte cp.async (codes: 4-byte) into a ring of two stages, so the next
// chunk's loads fly while this one is summed.  Staged rows of g lie an odd
// number of 16-byte units apart, rows of codes an odd number of words: a
// warp reading four windows of g (one float4) for 32 channel pairs hits
// distinct banks in each quarter warp, and one word of four codes distinct
// banks.  No global load sits on the chain
// from a code to the x address it selects.
//
// As above: nothing is accumulated across blocks and no atomics are used, so
// dW and db are bit-for-bit reproducible.  No gradient for x.

constexpr int kMfmTaps = 25;
constexpr int kMfmRows = 26;        // 25 dW taps, db
constexpr int kMfmPairFloats = 52;  // per channel pair: ba, bb, (wa_i, wb_i)

// Bytes between staged rows of `bytes` bytes, in units of `unit`: an odd
// number of units, so that the lanes of a warp reading the same unit of
// consecutive rows hit distinct banks (16-byte units: per quarter warp).
// ops/fused_conv1_cuda.py sizes the ring with the same formula.
__device__ __forceinline__ int mfm_pitch(int bytes, int unit) {
  return unit * (((bytes + unit - 1) / unit) | 1);
}

// One element of a staged row, when its row is not aligned for whole units:
// f32 by 4-byte cp.async, the others by an ordinary load and store.
__device__ __forceinline__ void stage_elem(float* dst, const float* src) {
  cp_async4(dst, src);
}
template <typename E>
__device__ __forceinline__ void stage_elem(E* dst, const E* src) {
  *dst = *src;
}

// Stage `n_rows` rows of n elements, row r from src0 + r * row_step, to
// dst + r * pitch bytes, element j at byte j * sizeof(E): a warp a row, its
// lanes on consecutive units (coalesced).  Where every row starts on a UNIT
// boundary the copies are whole UNIT-byte cp.asyncs (16: g; 4: the codes);
// the last may bring bytes past the row, which lie in the same page and
// are never read.  Otherwise element by element.  Threads of a last,
// partial warp copy nothing.
template <int UNIT, typename E>
__device__ __forceinline__ void stage_rows(const E* src0, size_t row_step,
                                           int n, int n_rows,
                                           unsigned char* dst, int pitch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (warp >= n_warps) return;
  const bool whole = (reinterpret_cast<uintptr_t>(src0) % UNIT) == 0 &&
                     (row_step * sizeof(E)) % UNIT == 0;
  const int units = (n * static_cast<int>(sizeof(E)) + UNIT - 1) / UNIT;
  for (int r = warp; r < n_rows; r += n_warps) {
    const E* src = src0 + r * row_step;
    unsigned char* d = dst + r * pitch;
    if (whole) {
      for (int q = lane; q < units; q += 32) {
        if (UNIT == 16)
          cp_async16(d + 16 * q, reinterpret_cast<const char*>(src) + 16 * q);
        else
          cp_async4(d + 4 * q, reinterpret_cast<const char*>(src) + 4 * q);
      }
    } else {
      for (int j = lane; j < n; j += 32) stage_elem(reinterpret_cast<E*>(d) + j, src + j);
    }
  }
}

// Each thread's N values summed over the block's groups of C/2 threads in
// a fixed order, the N * C/2 sums spread over all threads;
// partials[blockIdx.x][k][col0 + channel], rows of `row_len` floats.
template <int N>
__device__ __forceinline__ void mfm_reduce_store(const float (&vals)[N], float* red,
                                                 float* __restrict__ partials,
                                                 int c_half, int row_len, int col0) {
  const int groups = blockDim.x / c_half;
  const int c = threadIdx.x % c_half, pg = threadIdx.x / c_half;
#pragma unroll
  for (int k = 0; k < N; ++k) red[(pg * N + k) * c_half + c] = vals[k];
  __syncthreads();
  float* dst = partials + static_cast<size_t>(blockIdx.x) * N * row_len + col0;
  for (int o = threadIdx.x; o < N * c_half; o += blockDim.x) {
    const int k = o / c_half, cc = o - k * c_half;
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += red[(g * N + k) * c_half + cc];
    dst[k * row_len + cc] = acc;
  }
}

// The zero-padded x tile of padded rows [2*i0, 2*i0 + 2*rows + 4) and
// columns [2*j0, 2*j0 + 2*wt + 4).  The caller commits the copies to a
// group and waits for it.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, float* xs, Tile t,
                                           int h, int w, int rows, int wt, int stride) {
  stage_halo(x, xs, t.b, 2 * t.i0, 2 * rows + 4, 2 * t.j0, 2 * wt + 4, h, w, stride);
}

// Dynamic shared memory: the channel pairs' biases and taps (C/2 * 52
// floats, 16-byte rows), then the x tile ((2*rows + 4) * stride floats).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_conv_mfm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, T* __restrict__ out,
                          unsigned char* __restrict__ code, int h, int win,
                          int c_half, int rows, int wt, int stride) {
  extern __shared__ float4 mfm_smem[];
  float* ws = reinterpret_cast<float*>(mfm_smem);
  float* xs = ws + c_half * kMfmPairFloats;
  const int h2 = h / 2, w2 = win / 2;
  const Tile t = tile_of_block(h2, w2, rows, wt);
  const int c_total = 2 * c_half;
  // pair k's row: ba, bb, then wa_i, wb_i for tap i = 0..24
  for (int i = threadIdx.x; i < c_half * kMfmPairFloats; i += blockDim.x) {
    const int k = i / kMfmPairFloats, r = i - k * kMfmPairFloats;
    const int col = (r & 1) ? c_half + k : k;
    ws[i] = r < 2 ? bias[col] : w[((r - 2) >> 1) * c_total + col];
  }
  stage_tile(x, xs, t, h, win, rows, wt, stride);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const size_t plane = static_cast<size_t>(h2) * w2;
  for (int p = threadIdx.x; p < rows * wt; p += blockDim.x) {
    const int li = p / wt, lj = p - li * wt;
    const int gi = t.i0 + li, gj = t.j0 + lj;
    if (gi >= h2 || gj >= w2) continue;
    // the 6x6 patch under this pool window: conv (2gi+a, 2gj+b), tap
    // (dh, dw) reads patch[a + dh][b + dw]; stride and 2*lj are even
    const float* base = xs + (2 * li) * stride + 2 * lj;
    float patch[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float2 v = reinterpret_cast<const float2*>(base + r * stride)[q];
        patch[r][2 * q] = v.x;
        patch[r][2 * q + 1] = v.y;
      }
    const size_t o0 =
        static_cast<size_t>(t.b) * c_half * plane + static_cast<size_t>(gi) * w2 + gj;
#pragma unroll 1
    for (int k = 0; k < c_half; ++k) {
      const float4* wk = reinterpret_cast<const float4*>(ws + k * kMfmPairFloats);
      float tw[kMfmPairFloats];
#pragma unroll
      for (int i = 0; i < kMfmPairFloats / 4; ++i) {
        const float4 v = wk[i];  // the same address in every lane: a broadcast
        tw[4 * i] = v.x;
        tw[4 * i + 1] = v.y;
        tw[4 * i + 2] = v.z;
        tw[4 * i + 3] = v.w;
      }
      float ca[4], cb[4];  // phase ph of channel k and of k + C/2
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        ca[ph] = tw[0];
        cb[ph] = tw[1];
      }
      // each sum keeps its order: the bias, then dh ascending, dw ascending
#pragma unroll
      for (int dh = 0; dh < 5; ++dh)
#pragma unroll
        for (int dw = 0; dw < 5; ++dw) {
          const float wa = tw[2 + 2 * (dh * 5 + dw)], wb = tw[3 + 2 * (dh * 5 + dw)];
#pragma unroll
          for (int ph = 0; ph < 4; ++ph) {
            const float xv = patch[(ph >> 1) + dh][(ph & 1) + dw];
            ca[ph] = fmaf(wa, xv, ca[ph]);
            cb[ph] = fmaf(wb, xv, cb[ph]);
          }
        }
      float best = 0.f;
      int best_idx = 0;
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        // strict >: a tie keeps the earlier candidate, phase-major and the
        // lower half first
        if (ph == 0 || ca[ph] > best) {
          best = ca[ph];
          best_idx = 2 * ph;
        }
        if (cb[ph] > best) {
          best = cb[ph];
          best_idx = 2 * ph + 1;
        }
      }
      const size_t o = o0 + k * plane;
      from_float(best, &out[o]);
      if (code != nullptr) code[o] = static_cast<unsigned char>(best_idx);
    }
  }
}

// Dynamic shared memory: the x tile ((2*rows + 4) * stride floats), then the
// ring of two stages, each C/2 staged rows of g and C/2 of codes; the
// reduction buffer (blockDim * 26 floats) reuses it all once the chunks are
// summed.
// Three blocks an SM (80 registers, no spills): the loop is bound by issue.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 3)
fused_conv_mfm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const unsigned char* __restrict__ code,
                          float* __restrict__ partials, int h, int win,
                          int c_half, int rows, int wt, int stride,
                          int chunk_cols) {
  extern __shared__ float4 mfm_smem[];
  float* xs = reinterpret_cast<float*>(mfm_smem);
  unsigned char* ring = reinterpret_cast<unsigned char*>(xs + (2 * rows + 4) * stride);
  const int g_pitch = mfm_pitch(chunk_cols * static_cast<int>(sizeof(T)), 16);
  const int c_pitch = mfm_pitch(chunk_cols, 4);
  const int stage_bytes = (c_half * (g_pitch + c_pitch) + 15) & ~15;
  const int h2 = h / 2, w2 = win / 2;
  const Tile t = tile_of_block(h2, w2, rows, wt);
  const int n_cols = min(wt, w2 - t.j0);
  const int pieces = (n_cols + chunk_cols - 1) / chunk_cols;
  const int n_chunks = min(rows, h2 - t.i0) * pieces;
  const size_t plane = static_cast<size_t>(h2) * w2;
  // element offset of channel pair 0 at chunk c's first window
  auto chunk_at = [&](int c, int& li, int& col0, int& n) {
    li = c / pieces;
    col0 = (c - li * pieces) * chunk_cols;
    n = min(chunk_cols, n_cols - col0);
    return static_cast<size_t>(t.b) * c_half * plane +
           static_cast<size_t>(t.i0 + li) * w2 + t.j0 + col0;
  };
  auto issue = [&](int c) {
    int li, col0, n;
    const size_t e0 = chunk_at(c, li, col0, n);
    unsigned char* st = ring + (c & 1) * stage_bytes;
    stage_rows<16>(g + e0, plane, n, c_half, st, g_pitch);
    stage_rows<4>(code + e0, plane, n, c_half, st + c_half * g_pitch, c_pitch);
    cp_async_commit();
  };
  stage_tile(x, xs, t, h, win, rows, wt, stride);
  issue(0);  // one group: the x tile and chunk 0

  const int k = threadIdx.x % c_half, pg = threadIdx.x / c_half;
  const int groups = blockDim.x / c_half;
  float acc_a[kMfmRows], acc_b[kMfmRows];  // channel k, channel k + C/2
#pragma unroll
  for (int i = 0; i < kMfmRows; ++i) acc_a[i] = acc_b[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; chunk c - 1's stage is free
    if (c + 1 < n_chunks) issue(c + 1);
    int li, col0, n;
    (void)chunk_at(c, li, col0, n);
    const unsigned char* st = ring + (c & 1) * stage_bytes;
    const T* gk = reinterpret_cast<const T*>(st + k * g_pitch);
    const unsigned* ck =
        reinterpret_cast<const unsigned*>(st + c_half * g_pitch + k * c_pitch);
    const float* row = xs + (2 * li) * stride + 2 * col0;
    // four windows a step: one 16-byte (bf16: 8-byte) read of g and one
    // word of codes serve them
    for (int q = pg; 4 * q < n; q += groups) {
      float4 g4 = load4(gk + 4 * q);
      unsigned c4 = ck[q];
#pragma unroll
      for (int j = 4 * q; j < min(4 * q + 4, n); ++j) {
        const int cd = c4 & 0xff;
        const int ph = cd >> 1;
        const float gv = g4.x;
        c4 >>= 8;  // the next window's code and cotangent move to the front
        g4 = make_float4(g4.y, g4.z, g4.w, 0.f);
        // the cotangent goes to the selected half alone
        const float da = (cd & 1) ? 0.f : gv;
        const float db = (cd & 1) ? gv : 0.f;
        const float* base = row + (ph >> 1) * stride + 2 * j + (ph & 1);
#pragma unroll
        for (int dh = 0; dh < 5; ++dh)
#pragma unroll
          for (int dw = 0; dw < 5; ++dw) {
            const float xv = base[dh * stride + dw];
            acc_a[dh * 5 + dw] = fmaf(da, xv, acc_a[dh * 5 + dw]);
            acc_b[dh * 5 + dw] = fmaf(db, xv, acc_b[dh * 5 + dw]);
          }
        acc_a[kMfmTaps] += da;
        acc_b[kMfmTaps] += db;
      }
    }
  }
  __syncthreads();  // every stage is read before the reduction reuses it
  float* red = reinterpret_cast<float*>(mfm_smem);
  // partials [blocks, 26, C]: columns [0, C/2) then [C/2, C), one buffer
  mfm_reduce_store(acc_a, red, partials, c_half, 2 * c_half, 0);
  __syncthreads();
  mfm_reduce_store(acc_b, red, partials, c_half, 2 * c_half, c_half);
}

// Column sums of the backward's partials [n_rows, 26 * C] in a fixed order
// (warp w adds rows w, w + 32, ... of its block's 32 columns; then warp 0
// adds the 32 warps' sums in order): dW [25, C] and db [C], bit-equal from
// run to run.  One launch beside the backward, where torch.sum and two
// slices would cost the host more than the sum costs the card.
constexpr int kSumWarps = 32;

__global__ void __launch_bounds__(32 * kSumWarps)
fused_conv_mfm_sum_kernel(const float* __restrict__ partials, int n_rows, int cols,
                        float* __restrict__ dw, float* __restrict__ db, int n_dw) {
  __shared__ float red[kSumWarps][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < cols) {
#pragma unroll 8
    for (int r = warp; r < n_rows; r += kSumWarps)
      acc += partials[static_cast<size_t>(r) * cols + col];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float sum = 0.f;
    for (int w = 0; w < kSumWarps; ++w) sum += red[w][lane];
    if (col < n_dw)
      dw[col] = sum;
    else
      db[col - n_dw] = sum;
  }
}

}  // namespace

extern "C" {

const char* fused_conv1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward on `stream`, no synchronisation; returns cudaGetLastError().
// `code` and `stat_partials` may be null (inference: neither is produced).
// out and code are stored [B, C, h2, w2].  Grid: batch * n_ct * ceil(h2 *
// wt / n_w) blocks of kFwdThreads; stat_partials [blocks, 2, C].
int fused_conv1_fwd_launch(const void* x, const float* w, const float* bias,
                           const float* alpha, void* out, unsigned char* code,
                           float* stat_partials, int h, int win, int c_total,
                           int is_bf16, int wt, int n_ct, int n_w, int stride,
                           int threads, int blocks, int smem_bytes, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (threads != kFwdThreads || n_w != kFwdThreads * kFwdWindows)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV1_FWD(T, F)                                                          \
  fused_conv1_fwd_kernel<T, F><<<blocks, threads, smem_bytes, s>>>(             \
      static_cast<const T*>(x), w, bias, alpha, static_cast<T*>(out), code,      \
      stat_partials, h, win, c_total, wt, n_ct, n_w, stride)
  if (is_bf16) {
    if (n_ct == 1)
      CONV1_FWD(__nv_bfloat16, true);
    else
      CONV1_FWD(__nv_bfloat16, false);
  } else {
    if (n_ct == 1)
      CONV1_FWD(float, true);
    else
      CONV1_FWD(float, false);
  }
#undef CONV1_FWD
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`; `gs` / `gq` may be null (no moment cotangents).  g
// and code are stored [B, C, h2, w2]; `aligned`: see fused_conv1_bwd_kernel.
// Grid: batch * ceil(h2 / rows) * ceil(w2 / wt) blocks of `threads` (32 *
// slabs * groups), with more than 48 KB of shared memory by opting in.
// Writes partials [blocks, 11, C]: rows 0-8 dW taps, 9 db, 10 dalpha.
int fused_conv1_bwd_launch(const void* x, const float* w, const float* bias,
                           const float* alpha, const void* g,
                           const unsigned char* code, const float* gs,
                           const float* gq, float* partials, int h, int win,
                           int c_total, int is_bf16, int rows, int wt,
                           int stride, int aligned, int threads, int blocks,
                           int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV1_BWD(T, A)                                                          \
  do {                                                                           \
    if (smem_bytes > 48 * 1024) {                                                \
      err = cudaFuncSetAttribute(fused_conv1_bwd_kernel<T, A>,                   \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                                 smem_bytes);                                    \
      if (err != cudaSuccess) return static_cast<int>(err);                      \
    }                                                                            \
    fused_conv1_bwd_kernel<T, A><<<blocks, threads, smem_bytes, s>>>(           \
        static_cast<const T*>(x), w, bias, alpha, static_cast<const T*>(g), code, \
        gs, gq, partials, h, win, c_total, rows, wt, stride);                    \
  } while (0)
  if (is_bf16) {
    if (aligned)
      CONV1_BWD(__nv_bfloat16, true);
    else
      CONV1_BWD(__nv_bfloat16, false);
  } else {
    if (aligned)
      CONV1_BWD(float, true);
    else
      CONV1_BWD(float, false);
  }
#undef CONV1_BWD
  return static_cast<int>(cudaGetLastError());
}

// MFM block forward on `stream`; `code` may be null (no parameter needs a
// gradient).  out and code are stored [B, C/2, H/2, W/2].  Grid: batch *
// ceil((H/2) / rows) * ceil((W/2) / wt) blocks of `threads`.
int fused_conv_mfm_fwd_launch(const void* x, const float* w, const float* bias,
                              void* out, unsigned char* code, int h, int win,
                              int c_half, int is_bf16, int rows, int wt,
                              int stride, int threads, int blocks,
                              int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_conv_mfm_fwd_kernel<__nv_bfloat16>
        <<<blocks, threads, smem_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(x), w, bias,
            static_cast<__nv_bfloat16*>(out), code, h, win, c_half, rows, wt,
            stride);
  } else {
    fused_conv_mfm_fwd_kernel<float><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const float*>(x), w, bias, static_cast<float*>(out), code,
        h, win, c_half, rows, wt, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// MFM block backward on `stream`; g and code stored [B, C/2, H/2, W/2].
// Writes per-block partials [blocks, 26, C] (rows 0-24 dW taps, 25 db) to
// the scratch `partials`, then their sums to dw [25, C] and db [C].
int fused_conv_mfm_bwd_launch(const void* x, const void* g,
                              const unsigned char* code, float* partials,
                              float* dw, float* db, int h, int win, int c_half,
                              int is_bf16, int rows, int wt, int stride,
                              int chunk_cols, int threads, int blocks,
                              int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes > 48 * 1024) {
    err = is_bf16 ? cudaFuncSetAttribute(fused_conv_mfm_bwd_kernel<__nv_bfloat16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes)
                  : cudaFuncSetAttribute(fused_conv_mfm_bwd_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (is_bf16) {
    fused_conv_mfm_bwd_kernel<__nv_bfloat16>
        <<<blocks, threads, smem_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), code, partials, h, win,
            c_half, rows, wt, stride, chunk_cols);
  } else {
    fused_conv_mfm_bwd_kernel<float><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), code,
        partials, h, win, c_half, rows, wt, stride, chunk_cols);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = kMfmRows * 2 * c_half;
  fused_conv_mfm_sum_kernel<<<(cols + 31) / 32, 32 * kSumWarps, 0, s>>>(
      partials, blocks, cols, dw, db, kMfmTaps * 2 * c_half);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
