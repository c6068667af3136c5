"""Launchers of the fused first-block CUDA kernels (``csrc/fused_conv1.cu``).

``forward`` / ``backward`` (the DCNN's conv 3x3 + PReLU + pool) and
``mfm_forward`` / ``mfm_backward`` (the LCNN's conv 5x5 + MaxFeatureMap +
pool) check device, type, shape and contiguity, allocate outputs and scratch
with ``torch.empty``, launch one kernel each on the current stream without
synchronising, and finish the cross-block reductions with one ``torch.sum``
over the per-block partials (fixed order: results are bit-for-bit
reproducible).  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` and ``MFM_FWD_LAUNCHES``
/ ``MFM_BWD_LAUNCHES`` count the kernel launches made in this process.  The
public functions and the plain PyTorch versions live in
``ops/fused_conv1.py``.

The library is compiled at first use (``cuda_build.compile_library``) and
bound with ``ctypes``; nothing here touches the CUDA toolchain at import
time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from .cuda_build import CSRC_DIR, compile_library

#: forward / backward kernel launches made in this process
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
#: the same for the conv 5x5 + MaxFeatureMap + pool kernels
MFM_FWD_LAUNCHES = 0
MFM_BWD_LAUNCHES = 0

SOURCE = CSRC_DIR / "fused_conv1.cu"
MAX_THREADS = 256  # kMaxThreads in the source
MAX_CHANNELS = MAX_THREADS  # one thread per channel of a pixel
ROWS_PER_BLOCK = 4  # pooled rows per block
# Pooled columns per block.  The default 256 packets (level 8) give 129
# columns, one tile; ``--num-of-scales 512`` (level 9) gives 257 and takes
# two, so an image wider than 318 is split into column tiles.
MAX_TILE_COLS = 160
BWD_ROWS = 11  # 9 dW taps, db, dalpha
MFM_TAPS = 25  # 5x5
MFM_BWD_ROWS = MFM_TAPS + 1  # 25 dW taps, db

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
        vp, ci = ctypes.c_void_p, ctypes.c_int
        geometry = [ci] * 11 + [vp]  # h .. device, then the stream
        lib.fused_conv1_fwd_launch.argtypes = [vp] * 7 + geometry
        lib.fused_conv1_fwd_launch.restype = ci
        lib.fused_conv1_bwd_launch.argtypes = [vp] * 10 + geometry
        lib.fused_conv1_bwd_launch.restype = ci
        lib.fused_conv_mfm_fwd_launch.argtypes = [vp] * 5 + geometry
        lib.fused_conv_mfm_fwd_launch.restype = ci
        lib.fused_conv_mfm_bwd_launch.argtypes = [vp] * 4 + geometry
        lib.fused_conv_mfm_bwd_launch.restype = ci
        lib.fused_conv1_error_string.argtypes = [ci]
        lib.fused_conv1_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return report


def _lib() -> ctypes.CDLL:
    if _LIB is None:
        build()
    return _LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().fused_conv1_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


class LaunchPlan(NamedTuple):
    """How one ``[B, H, W] x C`` problem is cut into blocks."""

    h2: int  # pooled rows
    w2: int  # pooled columns
    rows: int  # pooled rows per block
    wt: int  # pooled columns per block
    stride: int  # floats between rows of the shared-memory x tile
    threads: int  # groups * (threads that serve one pixel)
    blocks: int  # B * row strips * column strips
    smem_bytes: int  # x tile + reduction buffer


def launch_plan(b: int, h: int, w: int, c: int) -> LaunchPlan:
    """Tiling of the kernels; raises, with the numbers, on a geometry they
    do not take."""
    if min(b, h, w, c) < 1:
        raise ValueError(
            f"fused_conv1: empty geometry B={b}, H={h}, W={w}, C={c}"
        )
    if c > MAX_CHANNELS:
        raise ValueError(
            f"fused_conv1: C={c} output channels exceed the kernel's "
            f"{MAX_CHANNELS} (one thread per channel of a pixel)"
        )
    h2, w2 = (h + 2) // 2, (w + 2) // 2
    rows = min(ROWS_PER_BLOCK, h2)
    n_ct = -(-w2 // MAX_TILE_COLS)
    wt = -(-w2 // n_ct)
    stride = 2 * wt + 2
    # the backward's lanes read rows one stride apart and columns one
    # apart: keep those four addresses in different banks
    if stride % 32 in (0, 1, 31):
        stride += 2
    threads = (MAX_THREADS // c) * c
    blocks = b * (-(-h2 // rows)) * n_ct
    if blocks >= 2**31:
        raise ValueError(
            f"fused_conv1: B={b}, H={h}, W={w}, C={c} needs {blocks} blocks, "
            "beyond one grid"
        )
    smem = 4 * ((2 * rows + 2) * stride + threads * BWD_ROWS)
    return LaunchPlan(h2, w2, rows, wt, stride, threads, blocks, smem)


def _require(t: torch.Tensor, name: str, dtype, shape, device, what="fused_conv1") -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{what}: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _check_image(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernels need a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(
            f"{what} takes a contiguous [B, H, W] tensor, got shape "
            f"{tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )


def _check_inputs(x, w, bias, alpha) -> Tuple[int, int, int, int]:
    _check_image(x, "fused_conv1")
    if w.ndim != 2 or w.shape[0] != 9:
        raise ValueError(f"fused_conv1: w must be [9, C], got {tuple(w.shape)}")
    c = w.shape[1]
    _require(w, "w", torch.float32, (9, c), x.device)
    _require(bias, "b", torch.float32, (c,), x.device)
    _require(alpha, "alpha", torch.float32, (1,), x.device)
    b, h, win = x.shape
    return b, h, win, c


def _geometry_args(x, h, win, c, plan: LaunchPlan):
    return (
        h, win, c, int(x.dtype == torch.bfloat16), plan.rows, plan.wt,
        plan.stride, plan.threads, plan.blocks, plan.smem_bytes,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )


def forward(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    alpha: torch.Tensor,
    want_code: bool,
    want_stats: bool,
):
    """Launch the forward kernel.

    ``x [B, H, W]`` float32 or bfloat16; ``w [9, C]``, ``bias [C]``,
    ``alpha [1]`` float32.  Returns ``(out [B, h2, w2, C], code, sum,
    sumsq)``; ``code`` (uint8, ``phase | negative << 2``) is ``None``
    unless ``want_code``, the float32 ``[C]`` moments of the stored output
    are ``None`` unless ``want_stats``.
    """
    global FWD_LAUNCHES
    b, h, win, c = _check_inputs(x, w, bias, alpha)
    plan = launch_plan(b, h, win, c)
    shape = (b, plan.h2, plan.w2, c)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    code = torch.empty(shape, dtype=torch.uint8, device=x.device) if want_code else None
    partials = (
        torch.empty((plan.blocks, 2, c), dtype=torch.float32, device=x.device)
        if want_stats
        else None
    )
    err = _lib().fused_conv1_fwd_launch(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), alpha.data_ptr(),
        out.data_ptr(),
        code.data_ptr() if want_code else None,
        partials.data_ptr() if want_stats else None,
        *_geometry_args(x, h, win, c, plan),
    )
    _check(err, "fused_conv1 forward launch")
    FWD_LAUNCHES += 1
    if not want_stats:
        return out, code, None, None
    s, q = partials.sum(dim=0)
    return out, code, s, q


def backward(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    alpha: torch.Tensor,
    g: torch.Tensor,
    out: torch.Tensor,
    code: torch.Tensor,
    gs: Optional[torch.Tensor],
    gq: Optional[torch.Tensor],
):
    """Launch the backward kernel: ``(dW [9, C], db [C], dalpha [1])`` in
    float32.  ``g`` is the cotangent of ``out``; ``gs`` / ``gq`` (float32
    ``[C]`` or ``None``) are those of the moments."""
    global BWD_LAUNCHES
    b, h, win, c = _check_inputs(x, w, bias, alpha)
    plan = launch_plan(b, h, win, c)
    shape = (b, plan.h2, plan.w2, c)
    _require(g, "g", x.dtype, shape, x.device)
    _require(out, "out", x.dtype, shape, x.device)
    _require(code, "code", torch.uint8, shape, x.device)
    for name, t in (("gs", gs), ("gq", gq)):
        if t is not None:
            _require(t, name, torch.float32, (c,), x.device)
    partials = torch.empty(
        (plan.blocks, BWD_ROWS, c), dtype=torch.float32, device=x.device
    )
    err = _lib().fused_conv1_bwd_launch(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), alpha.data_ptr(),
        g.data_ptr(), out.data_ptr(), code.data_ptr(),
        gs.data_ptr() if gs is not None else None,
        gq.data_ptr() if gq is not None else None,
        partials.data_ptr(),
        *_geometry_args(x, h, win, c, plan),
    )
    _check(err, "fused_conv1 backward launch")
    BWD_LAUNCHES += 1
    total = partials.sum(dim=0)  # [11, C]
    return total[:9], total[9], total[10].sum().reshape(1)


# ------------------------------------------ conv 5x5 + MaxFeatureMap + pool


def mfm_launch_plan(b: int, h: int, w: int, c: int) -> LaunchPlan:
    """Tiling of the MaxFeatureMap kernels (``C/2`` threads serve one
    pixel); raises, with the numbers, on a geometry they do not take."""
    if b < 1 or h < 2 or w < 2 or c < 2:
        raise ValueError(
            f"fused_conv_mfm: geometry B={b}, H={h}, W={w}, C={c} leaves no "
            "output (needs B >= 1, H >= 2, W >= 2, C >= 2)"
        )
    if c % 2 or c > MAX_CHANNELS:
        raise ValueError(
            f"fused_conv_mfm: C={c} output channels must be even and at most "
            f"{MAX_CHANNELS} (one thread per channel pair of a pixel)"
        )
    h2, w2 = h // 2, w // 2
    rows = min(ROWS_PER_BLOCK, h2)
    n_ct = -(-w2 // MAX_TILE_COLS)
    wt = -(-w2 // n_ct)
    stride = 2 * wt + 4
    if stride % 32 in (0, 1, 31):  # as in launch_plan
        stride += 2
    c_half = c // 2
    threads = (MAX_THREADS // c_half) * c_half
    blocks = b * (-(-h2 // rows)) * n_ct
    if blocks >= 2**31:
        raise ValueError(
            f"fused_conv_mfm: B={b}, H={h}, W={w}, C={c} needs {blocks} "
            "blocks, beyond one grid"
        )
    smem = 4 * ((2 * rows + 4) * stride + threads * MFM_BWD_ROWS)
    return LaunchPlan(h2, w2, rows, wt, stride, threads, blocks, smem)


def _mfm_check_inputs(x, w, bias) -> Tuple[int, int, int, int]:
    _check_image(x, "fused_conv_mfm")
    if w.ndim != 2 or w.shape[0] != MFM_TAPS:
        raise ValueError(
            f"fused_conv_mfm: w must be [{MFM_TAPS}, C], got {tuple(w.shape)}"
        )
    c = w.shape[1]
    _require(w, "w", torch.float32, (MFM_TAPS, c), x.device, "fused_conv_mfm")
    _require(bias, "b", torch.float32, (c,), x.device, "fused_conv_mfm")
    b, h, win = x.shape
    return b, h, win, c


def mfm_forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, want_code: bool):
    """Launch the MaxFeatureMap forward kernel.

    ``x [B, H, W]`` float32 or bfloat16; ``w [25, C]``, ``bias [C]``
    float32.  Returns ``(out [B, H//2, W//2, C//2], code)``; ``code``
    (uint8, ``phase * 2 + half`` of the first maximal candidate) is ``None``
    unless ``want_code``.
    """
    global MFM_FWD_LAUNCHES
    b, h, win, c = _mfm_check_inputs(x, w, bias)
    plan = mfm_launch_plan(b, h, win, c)
    shape = (b, plan.h2, plan.w2, c // 2)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    code = torch.empty(shape, dtype=torch.uint8, device=x.device) if want_code else None
    err = _lib().fused_conv_mfm_fwd_launch(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        code.data_ptr() if want_code else None,
        *_geometry_args(x, h, win, c // 2, plan),
    )
    _check(err, "fused_conv_mfm forward launch")
    MFM_FWD_LAUNCHES += 1
    return out, code


def mfm_backward(x: torch.Tensor, g: torch.Tensor, code: torch.Tensor, c: int):
    """Launch the MaxFeatureMap backward kernel: ``(dW [25, C], db [C])`` in
    float32 from the cotangent ``g`` of the output and the forward's
    ``code``."""
    global MFM_BWD_LAUNCHES
    _check_image(x, "fused_conv_mfm")
    b, h, win = x.shape
    plan = mfm_launch_plan(b, h, win, c)
    shape = (b, plan.h2, plan.w2, c // 2)
    _require(g, "g", x.dtype, shape, x.device, "fused_conv_mfm")
    _require(code, "code", torch.uint8, shape, x.device, "fused_conv_mfm")
    partials = torch.empty(
        (plan.blocks, MFM_BWD_ROWS, c), dtype=torch.float32, device=x.device
    )
    err = _lib().fused_conv_mfm_bwd_launch(
        x.data_ptr(), g.data_ptr(), code.data_ptr(), partials.data_ptr(),
        *_geometry_args(x, h, win, c // 2, plan),
    )
    _check(err, "fused_conv_mfm backward launch")
    MFM_BWD_LAUNCHES += 1
    total = partials.sum(dim=0)  # [26, C]
    return total[:MFM_TAPS], total[MFM_TAPS]
