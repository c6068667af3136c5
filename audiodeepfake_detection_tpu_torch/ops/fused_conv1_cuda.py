"""Launchers of the fused first-block CUDA kernels (``csrc/fused_conv1.cu``).

``forward`` / ``backward`` (the DCNN's conv 3x3 + PReLU + pool) and
``mfm_forward`` / ``mfm_backward`` (the LCNN's conv 5x5 + MaxFeatureMap +
pool) check device, type, shape and contiguity, allocate outputs and scratch
with ``torch.empty``, launch on the current stream without synchronising,
and finish the cross-block reductions over the per-block partials in a
fixed order (one ``torch.sum``; ``mfm_backward``: a second small kernel in
the same call), so results are bit-for-bit reproducible.  Both kernel pairs
store their output and code, and read the cotangent, as NCHW memory behind
the ``[B, h2, w2, C]`` (MaxFeatureMap: ``C/2``) shape, the layout of the
convolutions behind the block.  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` and
``MFM_FWD_LAUNCHES`` / ``MFM_BWD_LAUNCHES`` count the kernel launches made
in this process.  The public functions and the plain PyTorch versions live
in ``ops/fused_conv1.py``.

The library is compiled at first use (``cuda_build.compile_library``) and
bound with ``ctypes``; nothing here touches the CUDA toolchain at import
time.
"""

from __future__ import annotations

import ctypes
import functools
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
MAX_CHANNELS = MAX_THREADS  # the most output channels the kernels take
ROWS_PER_BLOCK = 4  # pooled rows per block
# Pooled columns per block of the MaxFeatureMap kernels; an image wider than
# 318 is split into column tiles.
MAX_TILE_COLS = 160
# The same for the conv 3x3 block.  The default 256 packets (level 8) give
# 129 columns, ``--num-of-scales 512`` (level 9) 257: one tile each, so its
# kernels walk a frame's whole flattened plane; an image wider than 638 is
# split into column tiles.
CONV1_TILE_COLS = 320
BWD_ROWS = 11  # 9 dW taps, db, dalpha
FWD_THREADS = 128  # kFwdThreads: a forward block of the conv 3x3 block
FWD_WINDOWS = 4  # kFwdWindows: pool windows a forward thread owns
TAP_FLOATS = 12  # kTapFloats: a channel's bias and 9 taps in shared memory
BWD_G_PITCH = 20  # kGPitch: floats of a backward warp's staged row of g
BWD_C_PITCH = 5  # kCPitch: words of its staged row of codes
MFM_TAPS = 25  # 5x5
MFM_BWD_ROWS = MFM_TAPS + 1  # 25 dW taps, db
MFM_PAIR_FLOATS = 52  # a channel pair's two biases and 50 taps in shared memory
MFM_RING_BYTES = 48 * 1024  # the backward's two stages of (g, code)

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
        lib.fused_conv1_fwd_launch.argtypes = [vp] * 7 + [ci] * 12 + [vp]
        lib.fused_conv1_fwd_launch.restype = ci
        lib.fused_conv1_bwd_launch.argtypes = [vp] * 9 + [ci] * 12 + [vp]
        lib.fused_conv1_bwd_launch.restype = ci
        lib.fused_conv_mfm_fwd_launch.argtypes = [vp] * 5 + geometry
        lib.fused_conv_mfm_fwd_launch.restype = ci
        lib.fused_conv_mfm_bwd_launch.argtypes = [vp] * 6 + [ci] + geometry
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
    wt: int  # pooled columns per column tile
    n_ct: int  # column tiles
    stride: int  # floats between rows of the shared-memory x tile
    windows: int  # forward: windows of a column tile's flattened rows per block
    fwd_blocks: int  # B * column tiles * ceil(h2 * wt / windows)
    fwd_smem_bytes: int  # taps and biases + (sum, sumsq) per warp + x tile
    rows: int  # backward: pooled rows per block
    bwd_threads: int  # 32 * slabs of 32 channels * groups of windows
    bwd_blocks: int  # B * row strips * column tiles
    bwd_smem_bytes: int  # x tile, window offsets, per-warp buffers; or the reduction
    aligned: bool  # backward: g and codes copied four windows at a time


@functools.lru_cache(maxsize=64)
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
            f"{MAX_CHANNELS} (a lane per channel of a block's eight warps)"
        )
    h2, w2 = (h + 2) // 2, (w + 2) // 2
    n_ct = -(-w2 // CONV1_TILE_COLS)
    wt = -(-w2 // n_ct)
    # even (the forward's float2 reads), and the backward's lanes read rows
    # one stride apart and columns one apart: keep those in different banks
    stride = 2 * wt + 2
    if stride % 32 == 0:
        stride += 2
    n_w = FWD_THREADS * FWD_WINDOWS
    fwd_blocks = b * n_ct * -(-(h2 * wt) // n_w)
    span = min(h2, (n_w - 1) // wt + 2)  # most pooled rows a block's range spans
    fwd_smem = 4 * (TAP_FLOATS * c + (FWD_THREADS // 32) * 2 * c + (2 * span + 2) * stride)
    rows = min(ROWS_PER_BLOCK, h2)
    slabs = -(-c // 32)
    groups = max(1, MAX_THREADS // 32 // slabs)
    bwd_threads = 32 * slabs * groups
    bwd_blocks = b * (-(-h2 // rows)) * n_ct
    if max(fwd_blocks, bwd_blocks) >= 2**31:
        raise ValueError(
            f"fused_conv1: B={b}, H={h}, W={w}, C={c} needs "
            f"{max(fwd_blocks, bwd_blocks)} blocks, beyond one grid"
        )
    # the x tile, a window's two offsets, each warp's buffer of 32 rows of g
    # and codes (above 48 KB, for tiles wider than 176 columns, by opting in)
    bwd_smem = max(4 * ((2 * rows + 2) * stride + 2 * rows * wt)
                   + bwd_threads * (BWD_G_PITCH + BWD_C_PITCH) * 4,
                   4 * groups * BWD_ROWS * slabs * 32)
    # one column tile and a plane of a multiple of four windows: every strip
    # of four rows starts on a multiple of four, and holds one
    aligned = n_ct == 1 and (h2 * w2) % 4 == 0
    return LaunchPlan(h2, w2, wt, n_ct, stride, n_w, fwd_blocks, fwd_smem, rows,
                      bwd_threads, bwd_blocks, bwd_smem, aligned)


def _require_meta(t: torch.Tensor, name: str, dtype, shape, device, what) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{what}: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _require(t: torch.Tensor, name: str, dtype, shape, device, what="fused_conv1") -> None:
    _require_meta(t, name, dtype, shape, device, what)
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


def _stream(x):
    return x.device.index, torch.cuda.current_stream(x.device).cuda_stream


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
    sumsq)``, ``out`` and ``code`` views of NCHW memory
    (``out.permute(0, 3, 1, 2)`` is contiguous); ``code`` (uint8, ``phase |
    negative << 2``) is ``None`` unless ``want_code``, the float32 ``[C]``
    moments of the stored output are ``None`` unless ``want_stats``.
    """
    global FWD_LAUNCHES
    b, h, win, c = _check_inputs(x, w, bias, alpha)
    plan = launch_plan(b, h, win, c)
    shape = (b, plan.h2, plan.w2, c)
    out = _nchw_empty(shape, x.dtype, x.device)
    code = _nchw_empty(shape, torch.uint8, x.device) if want_code else None
    partials = (
        torch.empty((plan.fwd_blocks, 2, c), dtype=torch.float32, device=x.device)
        if want_stats
        else None
    )
    err = _lib().fused_conv1_fwd_launch(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), alpha.data_ptr(),
        out.data_ptr(),
        code.data_ptr() if want_code else None,
        partials.data_ptr() if want_stats else None,
        h, win, c, int(x.dtype == torch.bfloat16), plan.wt, plan.n_ct,
        plan.windows, plan.stride, FWD_THREADS, plan.fwd_blocks, plan.fwd_smem_bytes,
        *_stream(x),
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
    code: torch.Tensor,
    gs: Optional[torch.Tensor],
    gq: Optional[torch.Tensor],
):
    """Launch the backward kernel: ``(dW [9, C], db [C], dalpha [1])`` in
    float32.  ``g`` is the cotangent of the output, ``code`` the forward's;
    both ``[B, h2, w2, C]`` views of NCHW memory (raises, with the strides,
    on another layout).  ``gs`` / ``gq`` (float32 ``[C]`` or ``None``) are
    the cotangents of the moments.  The output itself is not read: the
    kernel rebuilds it from ``x`` and the code."""
    global BWD_LAUNCHES
    b, h, win, c = _check_inputs(x, w, bias, alpha)
    plan = launch_plan(b, h, win, c)
    shape = (b, plan.h2, plan.w2, c)
    _require_nchw(g, "g", x.dtype, shape, x.device, "fused_conv1")
    _require_nchw(code, "code", torch.uint8, shape, x.device, "fused_conv1")
    for name, t in (("gs", gs), ("gq", gq)):
        if t is not None:
            _require(t, name, torch.float32, (c,), x.device)
    partials = torch.empty(
        (plan.bwd_blocks, BWD_ROWS, c), dtype=torch.float32, device=x.device
    )
    # a view at an odd offset is copied element by element
    aligned = plan.aligned and g.data_ptr() % 16 == 0 and code.data_ptr() % 4 == 0
    err = _lib().fused_conv1_bwd_launch(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), alpha.data_ptr(),
        g.data_ptr(), code.data_ptr(),
        gs.data_ptr() if gs is not None else None,
        gq.data_ptr() if gq is not None else None,
        partials.data_ptr(),
        h, win, c, int(x.dtype == torch.bfloat16), plan.rows, plan.wt, plan.stride,
        int(aligned), plan.bwd_threads, plan.bwd_blocks, plan.bwd_smem_bytes,
        *_stream(x),
    )
    _check(err, "fused_conv1 backward launch")
    BWD_LAUNCHES += 1
    total = partials.sum(dim=0)  # [11, C]
    return total[:9], total[9], total[10].sum().reshape(1)


# ------------------------------------------ conv 5x5 + MaxFeatureMap + pool


class MfmLaunchPlan(NamedTuple):
    """How one ``[B, H, W] x C`` MaxFeatureMap problem is cut into blocks
    (one plan for the forward and the backward)."""

    h2: int  # pooled rows
    w2: int  # pooled columns
    rows: int  # pooled rows per block
    wt: int  # pooled columns per block
    stride: int  # floats between rows of the shared-memory x tile
    threads: int  # groups * C/2 (the backward's lanes serve channel pairs)
    blocks: int  # B * row strips * column strips
    chunk_cols: int  # backward: pooled columns of one staged (g, code) chunk
    fwd_smem: int  # taps and biases + x tile
    bwd_smem: int  # x tile + two stages, or the reduction buffer


def _pitch(n_bytes: int, unit: int) -> int:
    """Bytes between staged rows (``mfm_pitch`` in the source): an odd
    number of ``unit``-byte units."""
    return unit * (-(-n_bytes // unit) | 1)


def mfm_stage_bytes(c: int, chunk_cols: int) -> int:
    """One stage of the backward's ring: C/2 rows of g (sized for f32) and
    C/2 rows of codes, 16-byte aligned."""
    rows = (c // 2) * (_pitch(4 * chunk_cols, 16) + _pitch(chunk_cols, 4))
    return -(-rows // 16) * 16


@functools.lru_cache(maxsize=64)
def mfm_launch_plan(b: int, h: int, w: int, c: int) -> MfmLaunchPlan:
    """Tiling of the MaxFeatureMap kernels; raises, with the numbers, on a
    geometry they do not take."""
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
    n_ct = -(-w2 // MAX_TILE_COLS)
    wt = -(-w2 // n_ct)
    # the forward gives each thread a window: narrow tiles (LFCC's 10
    # columns) take more rows, so a block still holds MAX_THREADS windows.
    # Otherwise 4 to 6 rows, whichever pads the last strip least: a padded
    # row costs a block's worth of idle lanes (stft's 50 rows: 5, no pad)
    if wt * ROWS_PER_BLOCK >= MAX_THREADS:
        rows = min(range(ROWS_PER_BLOCK, ROWS_PER_BLOCK + 3), key=lambda r: -h2 % r)
    else:
        rows = -(-MAX_THREADS // wt)
    rows = min(h2, rows)
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
    tile = 4 * (2 * rows + 4) * stride
    # the backward's ring: two stages of one pooled row by chunk_cols
    # columns (a multiple of 8, so that every chunk of an aligned row starts
    # on 16 bytes); whole rows where they fit
    pieces = 1
    while True:
        chunk_cols = min(wt, 8 * -(-wt // (8 * pieces)))
        stage = mfm_stage_bytes(c, chunk_cols)
        if 2 * stage <= MFM_RING_BYTES or chunk_cols <= 8:
            break
        pieces += 1
    fwd_smem = 4 * c_half * MFM_PAIR_FLOATS + tile
    bwd_smem = max(tile + 2 * stage, 4 * threads * MFM_BWD_ROWS)
    return MfmLaunchPlan(
        h2, w2, rows, wt, stride, threads, blocks, chunk_cols, fwd_smem, bwd_smem
    )


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


def _require_nchw(t: torch.Tensor, name: str, dtype, shape, device,
                  what: str = "fused_conv_mfm") -> None:
    """``t`` has the block's ``[B, h2, w2, channels]`` shape over NCHW
    memory."""
    _require_meta(t, name, dtype, shape, device, what)
    if not t.permute(0, 3, 1, 2).is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a [B, h2, w2, channels] view of NCHW "
            f"memory (strides of a permuted contiguous [B, channels, h2, w2]), "
            f"got strides {t.stride()}"
        )


def _nchw_empty(shape, dtype, device) -> torch.Tensor:
    """``[B, h2, w2, channels]`` over freshly allocated NCHW memory."""
    b, h2, w2, ch = shape
    return torch.empty((b, ch, h2, w2), dtype=dtype, device=device).permute(0, 2, 3, 1)


def _mfm_args(x, h, win, c, plan: MfmLaunchPlan, smem: int, *extra):
    return (
        h, win, c // 2, int(x.dtype == torch.bfloat16), plan.rows, plan.wt,
        plan.stride, *extra, plan.threads, plan.blocks, smem,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )


def mfm_forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, want_code: bool):
    """Launch the MaxFeatureMap forward kernel.

    ``x [B, H, W]`` float32 or bfloat16; ``w [25, C]``, ``bias [C]``
    float32.  Returns ``(out [B, H//2, W//2, C//2], code)``, both views of
    NCHW memory (``out.permute(0, 3, 1, 2)`` is contiguous); ``code``
    (uint8, ``phase * 2 + half`` of the first maximal candidate) is ``None``
    unless ``want_code``.
    """
    global MFM_FWD_LAUNCHES
    b, h, win, c = _mfm_check_inputs(x, w, bias)
    plan = mfm_launch_plan(b, h, win, c)
    shape = (b, plan.h2, plan.w2, c // 2)
    out = _nchw_empty(shape, x.dtype, x.device)
    code = _nchw_empty(shape, torch.uint8, x.device) if want_code else None
    err = _lib().fused_conv_mfm_fwd_launch(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        code.data_ptr() if want_code else None,
        *_mfm_args(x, h, win, c, plan, plan.fwd_smem),
    )
    _check(err, "fused_conv_mfm forward launch")
    MFM_FWD_LAUNCHES += 1
    return out, code


def mfm_backward(x: torch.Tensor, g: torch.Tensor, code: torch.Tensor, c: int):
    """Launch the MaxFeatureMap backward kernel: ``(dW [25, C], db [C])`` in
    float32 from the cotangent ``g`` of the output and the forward's
    ``code``, both ``[B, H//2, W//2, C//2]`` views of NCHW memory (raises,
    with the strides, on another layout)."""
    global MFM_BWD_LAUNCHES
    _check_image(x, "fused_conv_mfm")
    b, h, win = x.shape
    plan = mfm_launch_plan(b, h, win, c)
    shape = (b, plan.h2, plan.w2, c // 2)
    _require_nchw(g, "g", x.dtype, shape, x.device)
    _require_nchw(code, "code", torch.uint8, shape, x.device)
    partials = torch.empty(
        (plan.blocks, MFM_BWD_ROWS, c), dtype=torch.float32, device=x.device
    )
    dw = torch.empty((MFM_TAPS, c), dtype=torch.float32, device=x.device)
    db = torch.empty((c,), dtype=torch.float32, device=x.device)
    err = _lib().fused_conv_mfm_bwd_launch(
        x.data_ptr(), g.data_ptr(), code.data_ptr(), partials.data_ptr(),
        dw.data_ptr(), db.data_ptr(),
        *_mfm_args(x, h, win, c, plan, plan.bwd_smem, plan.chunk_cols),
    )
    _check(err, "fused_conv_mfm backward launch")
    MFM_BWD_LAUNCHES += 1
    return dw, db
