"""Launcher of the int8 convolution site kernel (``csrc/int8_conv.cu``).

Two modes of one kernel source:

* :func:`site_forward`, a whole int8 site: the working-type activation
  (float32 or bfloat16, NCHW) quantized as the kernel loads it, the s8 x s8
  -> s32 product, and the dequantization, the fold's map and the bias in its
  epilogue;
* :func:`forward`, codes in: NHWC int8 codes and a ``[Cout]`` scale, the
  counterpart of the JAX package's ``int8_conv``.

Each checks device, type, shape and contiguity, plans the launch
(:func:`site_plan`: the route, the tiles, the shared memory), allocates the
output with ``torch.empty`` and launches one kernel on the current stream
without synchronising.  The weights are read in the kernel's layout
(:func:`site_weights`), which ``ops/quantize.py::bake_int8_weights`` stores
once per site; a call without it lays the codes out first.  ``LAUNCHES``
and ``SITE_LAUNCHES`` count the kernel launches of each mode made in this
process.  The public functions and the plain PyTorch versions live in
``ops/int8_conv.py``.

The library is compiled at first use (``cuda_build.compile_library``) and
bound with ``ctypes``; nothing here touches the CUDA toolchain at import
time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda_build import CSRC_DIR, compile_library
from .fused_conv1_cuda import _require

#: kernel launches made in this process: codes in (:func:`forward`) and whole
#: sites (:func:`site_forward`)
LAUNCHES = 0
SITE_LAUNCHES = 0

SOURCE = CSRC_DIR / "int8_conv.cu"
WHAT = "int8_conv"
# csrc/int8_conv.cu's constants: the MMA route's threads, positions and
# weight-ring steps a CTA; the Cin = 1 route's threads and channels a CTA
THREADS, MMA_POSITIONS, RING = 256, 128, 6
CIN1_THREADS, CIN1_CHANNELS, CIN1_GROUP = 512, 256, 32
CONSTANTS = (THREADS, MMA_POSITIONS, RING, CIN1_THREADS, CIN1_CHANNELS, CIN1_GROUP)
# the MMA route's prologue: loads into registers (any strides; codes at any
# address or Cin), cp.async of 16-byte NHWC code words (codes-in mode, Cin %
# 16 == 0, codes on the 16-byte grid), or cp.async of NCHW rows contiguous
# along W (site mode, N tiles of 32, where the input halo outweighs the
# output: faster there, slower at wider N tiles, tools/int8_site_probe.py
# compare), 16 channels at a time into two buffers, on runs of ROWS_RUN
STAGE_LOADS, STAGE_CODES, STAGE_ROWS = 0, 1, 2
ROW_GROUP, ROWS_RUN = 16, 32
CIN1_POSITIONS = 256  # the Cin = 1 route: about this many positions a CTA
CHUNK = 32  # MMA route: channels are padded to whole chunks of one k32 step
MAX_RUN = 64  # MMA route: a tile's row run splits Wo evenly into runs of at most this
MAX_SMEM = 232448  # bytes of shared memory a CTA can have on the H100
IN_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOCK = threading.Lock()


def build() -> str:
    """Compile (unless already built) and load the kernel library; returns
    the compiler's ``-Xptxas -v`` report, or ``""`` when nothing compiled."""
    global _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return ""
        lib_path, report = compile_library(SOURCE)
        lib = ctypes.CDLL(str(lib_path))
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.int8_conv_launch.argtypes = ([vp] * 6 + [ci] * 18 + [cl] * 4 + [cf] * 2 + [ci] * 3
                                         + [vp])
        lib.int8_conv_launch.restype = ci
        lib.int8_conv_constant.argtypes = [ci]
        lib.int8_conv_constant.restype = ci
        lib.int8_conv_error_string.argtypes = [ci]
        lib.int8_conv_error_string.restype = ctypes.c_char_p
        built = tuple(lib.int8_conv_constant(i) for i in range(len(CONSTANTS)))
        if built != CONSTANTS:
            raise RuntimeError(f"{WHAT}: the library's constants {built} differ from the launcher's")
        _LIB = lib
        return report


def _lib() -> ctypes.CDLL:
    if _LIB is None:
        build()
    return _LIB


def output_plane(h: int, w: int, ksize: int, padding: int, dilation: int) -> Tuple[int, int]:
    """``(Ho, Wo)`` of a stride-1 convolution."""
    reach = dilation * (ksize - 1)
    return h + 2 * padding - reach, w + 2 * padding - reach


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class SitePlan(NamedTuple):
    """A launch: ``route`` 2, 4, 6 or 8 (MMA, n8 tiles a warp; a CTA 16 x
    route channels) or -1, -2, -4 (Cin = 1, 16-tap quads a channel);
    ``tr x tw`` output positions a CTA; ``cin_p`` and ``stride`` the codes'
    layout in shared memory; ``staging`` the MMA route's prologue (a
    ``STAGE_*``); ``n_tiles8`` the weights' n8 tiles; the threads and bytes
    of shared memory a CTA."""

    route: int
    grid_y: int
    tr: int
    tw: int
    cin_p: int
    stride: int
    staging: int
    n_tiles8: int
    threads: int
    smem: int


def _cin1_quads(ksize: int) -> int:
    taps = ksize * ksize
    for quads in (1, 2, 4):
        if taps <= 16 * quads:
            return quads
    raise ValueError(f"{WHAT}: a {ksize}x{ksize} kernel on one input channel ({taps} taps; the "
                     "Cin = 1 route takes at most 64)")


def _n_tile(cout: int) -> int:
    """Channels a CTA of the MMA route: 32, 64, 96 or 128, the smallest that
    holds Cout (128 beyond it)."""
    return min(128, _ceil(cout, 32) * 32)


def plan_for(x: torch.Tensor, cout: int, ksize: int, padding: int,
             dilation: int) -> SitePlan:
    """The launch on ``x`` (codes in: NHWC int8 codes; else an NCHW
    activation in the working type) of a geometry :func:`check_site` or
    :func:`check_geometry` takes: the prologue the input allows (see
    ``STAGE_*``), then :func:`site_plan`."""
    if x.dtype == torch.int8:
        _, h, w, cin = x.shape
        aligned = cin % 16 == 0 and x.data_ptr() % 16 == 0
        return site_plan(h, w, cin, cout, ksize, padding, dilation,
                         STAGE_CODES if aligned else STAGE_LOADS)
    _, cin, h, w = x.shape
    if cin > 1 and _n_tile(cout) == 32 and x.stride(3) == 1:
        plan = site_plan(h, w, cin, cout, ksize, padding, dilation, STAGE_ROWS,
                         x.element_size())
        if plan.smem <= MAX_SMEM:
            return plan
    return site_plan(h, w, cin, cout, ksize, padding, dilation)


def site_plan(h: int, w: int, cin: int, cout: int, ksize: int, padding: int,
              dilation: int, staging: int = STAGE_LOADS, itemsize: int = 4) -> SitePlan:
    """The launch of one site: its route, tiles, prologue (``staging``, on
    an activation of ``itemsize`` bytes) and shared memory."""
    ho, wo = output_plane(h, w, ksize, padding, dilation)
    reach = dilation * (ksize - 1)
    if cin == 1:
        # a run of whole output rows a CTA (about 256 positions), or a part
        # of one row where a row is longer than a CTA stores
        quads = _cin1_quads(ksize)
        tw = _ceil(wo, _ceil(wo, CIN1_THREADS))
        tr = max(1, min(ho, CIN1_POSITIONS // tw)) if tw == wo else 1
        positions = tr * tw
        smem = (CIN1_CHANNELS * (quads * 16 + 8) + CIN1_GROUP * positions * 4
                + (tr + reach) * (tw + reach))
        return SitePlan(-quads, _ceil(cout, CIN1_CHANNELS), tr, tw, 1, 1, STAGE_LOADS, 0,
                        _ceil(positions, 32) * 32, smem)
    bn = _n_tile(cout)
    n_tiles = _ceil(cout, bn)
    cin_p = _ceil(cin, CHUNK) * CHUNK
    stride = cin_p + 16  # an odd number of 16-byte slots between positions
    tw = _ceil(wo, _ceil(wo, ROWS_RUN if staging == STAGE_ROWS else MAX_RUN))
    tr = max(1, min(ho, MMA_POSITIONS // tw))
    codes = (tr + reach) * (tw + reach) * stride
    # STAGE_ROWS: two buffers of ROW_GROUP x (tr + reach) rows, each the
    # 16-byte words that hold a halo row's columns
    pitch = _ceil((tw + reach) * itemsize + 15, 16) * 16
    raw = 2 * ROW_GROUP * (tr + reach) * pitch if staging == STAGE_ROWS else 0
    stage = bn * (MMA_POSITIONS + 4) * 4
    smem = _ceil(max(codes + raw, stage), 16) * 16 + RING * bn * 32 + 8 * bn
    return SitePlan(bn // 16, n_tiles, tr, tw, cin_p, stride, staging, n_tiles * bn // 8,
                    THREADS, smem)


def weights_shape(cout: int, cin: int, ksize: int) -> Tuple[int, ...]:
    """The shape of :func:`site_weights` for ``[Cout, Cin, k, k]`` codes."""
    if cin == 1:
        return (cout, _cin1_quads(ksize) * 16)
    n_pad = _ceil(cout, _n_tile(cout)) * _n_tile(cout)
    return (ksize * ksize * _ceil(cin, CHUNK), n_pad // 8, 32, 8)


def site_weights(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW codes ``[Cout, Cin, k, k]`` in the kernel's layout.

    Cin = 1: ``[Cout, 16 * quads]``, row ``n`` channel ``n``'s taps in
    ``kh * k + kw`` order, zero beyond ``k * k``.  Otherwise the m16n8k32
    B fragments: ``[steps, n_tiles8, 32 lanes, 8 bytes]``, step ``s`` the
    reduction indices ``32 s .. 32 s + 31`` of ``(kh * k + kw) * cin_p +
    c`` (Cin padded with zero codes to whole chunks, Cout to whole N tiles);
    lane ``4 g + t`` holds channel ``8 n8 + g``'s indices ``4 t .. 4 t + 3``
    and ``16 + 4 t .. 16 + 4 t + 3``."""
    cout, cin, k, _ = w_q.shape
    if cin == 1:
        return F.pad(w_q.reshape(cout, k * k), (0, weights_shape(cout, 1, k)[1] - k * k))
    steps, n8, _, _ = weights_shape(cout, cin, k)
    cin_p = _ceil(cin, CHUNK) * CHUNK
    rows = F.pad(w_q.permute(0, 2, 3, 1), (0, cin_p - cin, 0, 0, 0, 0, 0, n8 * 8 - cout))
    frag = rows.reshape(n8, 8, steps, 2, 4, 4).permute(2, 0, 1, 4, 3, 5)
    return frag.contiguous().reshape(steps, n8, 32, 8)


def _check_plane(x, b, h, w, cin, cout, ksize, padding, dilation):
    if padding < 0 or dilation < 1:
        raise ValueError(f"{WHAT}: padding {padding} and dilation {dilation} (needs >= 0, >= 1)")
    ho, wo = output_plane(h, w, ksize, padding, dilation)
    if min(b, cin, cout, ho, wo) < 1:
        raise ValueError(
            f"{WHAT}: B={b}, Cin={cin}, Cout={cout} and a {ksize}x{ksize} kernel "
            f"(padding {padding}, dilation {dilation}) on {h}x{w} leave an output of "
            f"{ho}x{wo}"
        )
    if b * h * w * cin >= 2**31 or b * cout * ho * wo >= 2**31:
        raise ValueError(
            f"{WHAT}: input {b * h * w * cin} or output {b * cout * ho * wo} values are "
            "beyond the kernel's 32-bit positions"
        )
    plan = plan_for(x, cout, ksize, padding, dilation)
    if plan.smem > MAX_SMEM:
        raise ValueError(
            f"{WHAT}: Cin={cin}, a {ksize}x{ksize} kernel at dilation {dilation} on a "
            f"{plan.tr}x{plan.tw} tile needs {plan.smem} bytes of shared memory (at most "
            f"{MAX_SMEM})"
        )
    return ho, wo, plan


def _check_weights(w_q, cin):
    if w_q.dtype != torch.int8:
        raise TypeError(f"{WHAT} takes int8 weight codes, got {w_q.dtype}")
    if w_q.ndim != 4 or w_q.shape[1] != cin or w_q.shape[2] != w_q.shape[3]:
        raise ValueError(
            f"{WHAT}: weights must be [Cout, {cin}, k, k] (square taps), got "
            f"{tuple(w_q.shape)}"
        )
    return w_q.shape[0], w_q.shape[2]


def check_geometry(x_q, w_q, scale, padding: int, dilation: int, out_dtype):
    """Codes in: ``(B, H, W, Cin, Cout, k, Ho, Wo, plan)`` of a convolution
    the kernel takes; raises, with the numbers, on anything else."""
    if x_q.device.type != "cuda":
        raise ValueError(f"{WHAT} kernel needs a CUDA tensor, got {x_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"{WHAT} takes int8 codes, got x {x_q.dtype}, w {w_q.dtype}")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"{WHAT} writes float32, bfloat16 or int32, not {out_dtype}")
    if x_q.ndim != 4 or not x_q.is_contiguous():
        raise ValueError(
            f"{WHAT} takes contiguous NHWC codes [B, H, W, Cin], got shape "
            f"{tuple(x_q.shape)} (contiguous={x_q.is_contiguous()})"
        )
    b, h, w, cin = x_q.shape
    cout, ksize = _check_weights(w_q, cin)
    ho, wo, plan = _check_plane(x_q, b, h, w, cin, cout, ksize, padding, dilation)
    if out_dtype != torch.int32:
        _require(scale, "scale", torch.float32, (cout,), x_q.device, WHAT)
    return b, h, w, cin, cout, ksize, ho, wo, plan


def check_site(x, s_w, w_q, rows, const, bias, padding: int, dilation: int):
    """A whole site: ``(B, Cin, H, W, Cout, k, Ho, Wo, plan)``; raises, with
    the numbers, on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{WHAT} kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{WHAT} site takes a float32 or bfloat16 activation, got {x.dtype}")
    if x.ndim != 4 or min(x.stride()) < 0:
        raise ValueError(
            f"{WHAT} site takes an NCHW activation [B, Cin, H, W] (any non-negative "
            f"strides), got shape {tuple(x.shape)}, strides {x.stride()}"
        )
    b, cin, h, w = x.shape
    cout, ksize = _check_weights(w_q, cin)
    ho, wo, plan = _check_plane(x, b, h, w, cin, cout, ksize, padding, dilation)
    _require(s_w, "s_w", torch.float32, (cout,), x.device, WHAT)
    if rows is not None:
        _require(rows, "rows", torch.int8, weights_shape(cout, cin, ksize), x.device, WHAT)
        if rows.data_ptr() % 16:
            raise ValueError(f"{WHAT}: rows must start on a 16-byte boundary")
    if const is not None:
        _require(const, "map", x.dtype, (cout, ho, wo), x.device, WHAT)
    if bias is not None:
        _require(bias, "bias", x.dtype, (cout,), x.device, WHAT)
    return b, cin, h, w, cout, ksize, ho, wo, plan


def site_forward(
    x: torch.Tensor,
    act_scale: float,
    w_q: torch.Tensor,
    s_w: torch.Tensor,
    rows: Optional[torch.Tensor],
    const: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    padding: int,
    dilation: int,
) -> torch.Tensor:
    """Launch the kernel on a whole site: ``[B, Cout, Ho, Wo]`` in ``x``'s
    type.  ``rows``: the weights in the kernel's layout (baked), or None to
    lay ``w_q`` out first."""
    b, cin, h, w, cout, ksize, ho, wo, plan = check_site(
        x, s_w, w_q, rows, const, bias, padding, dilation)
    if rows is None:
        rows = site_weights(w_q.to(x.device))
    out = torch.empty((b, cout, ho, wo), dtype=x.dtype, device=x.device)
    inv = 1.0 / max(float(act_scale), 1e-30)
    launch(x, rows, s_w, const, bias, out, (b, h, w, cin), ksize, padding, dilation, plan,
           inv, float(act_scale))
    return out


def forward(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale: Optional[torch.Tensor],
    padding: int,
    dilation: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Codes in: ``[B, Cout, Ho, Wo]`` in ``out_dtype`` (float32, bfloat16,
    or int32 for the accumulators, when ``scale`` is not read)."""
    b, h, w, cin, cout, ksize, ho, wo, plan = check_geometry(
        x_q, w_q, scale, padding, dilation, out_dtype
    )
    rows = site_weights(w_q.to(x_q.device))
    out = torch.empty((b, cout, ho, wo), dtype=out_dtype, device=x_q.device)
    launch(x_q, rows, scale if out_dtype != torch.int32 else None, None, None, out,
           (b, h, w, cin), ksize, padding, dilation, plan, 1.0, 1.0)
    return out


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(x, rows, s_w, const, bias, out, dims, ksize: int, padding: int, dilation: int,
           plan: SitePlan, inv: float, s_x: float) -> None:
    """One launch into ``out`` of what :func:`site_forward` or
    :func:`forward` checked and planned (``dims``: ``(B, H, W, Cin)``)."""
    global LAUNCHES, SITE_LAUNCHES
    b, h, w, cin = dims
    err = _lib().int8_conv_launch(
        x.data_ptr(), rows.data_ptr(), _ptr(s_w), _ptr(const), _ptr(bias), out.data_ptr(),
        IN_KINDS[x.dtype], OUT_KINDS[out.dtype], plan.route, b, h, w, cin, out.shape[1],
        ksize, padding, dilation, plan.tr, plan.tw, plan.cin_p, plan.stride, plan.staging,
        plan.n_tiles8,
        plan.grid_y, *x.stride(), inv, s_x, plan.threads, plan.smem, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = _lib().int8_conv_error_string(err).decode()
        raise RuntimeError(f"{WHAT} launch failed: CUDA error {err} ({msg})")
    if x.dtype == torch.int8:
        LAUNCHES += 1
    else:
        SITE_LAUNCHES += 1
