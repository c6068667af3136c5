"""Launchers of the fused conv 3x3 + PReLU + max-pool CUDA kernels
(``csrc/fused_conv2.cu``).

``forward`` launches one kernel.  ``backward`` launches three (``dx``: the
transposed convolution; ``dw``: split over ``B * H * W``; a small one for
``dcorr`` and ``dalpha``) and finishes the cross-block sums with one
``torch.sum`` each over per-block partials (fixed order: results are
bit-for-bit reproducible).  Both check device, type, shape and contiguity,
allocate outputs and scratch with ``torch.empty`` / ``torch.zeros``, run on
the current stream and do not synchronise.  ``CONV2_FWD_LAUNCHES`` counts
forward kernel launches; ``CONV2_BWD_LAUNCHES`` grows by one per ``backward``
call (its two or three kernels together).  The public functions and the
plain PyTorch versions live in ``ops/fused_conv2.py``.

The only tensor work outside the kernels is the re-arrangement of the
``[9 * Cin, Cout]`` weights (a few hundred KB) into the two orders the
kernels read: ``[Cin, 9, Cout]`` for the forward and, taps flipped,
``[Cout, 9, Cin]`` for ``dx``.

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
from .fused_conv1_cuda import _require

#: forward kernel launches / backward calls made in this process
CONV2_FWD_LAUNCHES = 0
CONV2_BWD_LAUNCHES = 0

SOURCE = CSRC_DIR / "fused_conv2.cu"
WHAT = "fused_conv2"

TILE_WINDOWS = 32  # pool windows (lanes) per tile: kTileWindows in the source
CHUNK = 8  # input channels staged at once: kChunk
PLANE = 4 * (2 * TILE_WINDOWS + 2)  # floats per staged channel: kPlane
MAX_GROUPS = 8  # warps (channel groups) per block of the tile kernels
DW_LANES = 32  # input channels per dw block: kDwLanes
DW_CO = 8  # output channels per dw thread: kDwCo
DW_MAX_GROUPS = 6  # warps per dw block
DW_WINDOWS = 16  # pool windows per dw step (kDwCols / 2)
DW_X_PLANE = 137  # kDwXPlane
# dw blocks over the whole grid: two per SM of a 132-SM card.  Each writes a
# [9, 32, <=48] tile of partials, so the buffer stays at a few MB
DW_TARGET_BLOCKS = 264
SMALL_THREADS = 256

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
        lib.fused_conv2_fwd_launch.argtypes = [vp] * 7 + [ci] * 11 + [vp]
        lib.fused_conv2_fwd_launch.restype = ci
        lib.fused_conv2_dx_launch.argtypes = [vp] * 8 + [ci] * 11 + [vp]
        lib.fused_conv2_dx_launch.restype = ci
        lib.fused_conv2_dw_small_launch.argtypes = [vp] * 12 + [ci] * 12 + [vp]
        lib.fused_conv2_dw_small_launch.restype = ci
        lib.fused_conv2_error_string.argtypes = [ci]
        lib.fused_conv2_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return report


def _lib() -> ctypes.CDLL:
    if _LIB is None:
        build()
    return _LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().fused_conv2_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


class TilePlan(NamedTuple):
    """How the forward or the ``dx`` kernel cuts its output."""

    nc: int  # channels a thread owns (8 or 12)
    threads: int  # 32 lanes (pool windows) * channel groups
    grid_x: int  # B * row pairs * column tiles
    grid_y: int  # channel tiles
    smem_bytes: int  # staged input tile + weight slab


class DwPlan(NamedTuple):
    """How the ``dw`` kernel cuts ``dw`` and the ``B * H * W`` sum."""

    threads: int  # 32 lanes (input channels) * groups of 8 output channels
    tiles: int  # grid x: tiles of dw
    splits: int  # grid y: shares of the steps, one row of partials each
    steps: int  # B * H//2 * ceil(W//2 / 16)
    smem_bytes: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tile_plan(b: int, rows: int, cols: int, n_out: int) -> TilePlan:
    """Plan for ``rows`` x ``cols`` output pairs (pool windows in the
    forward, 2x2 pixel blocks of ``dx`` in the backward) and ``n_out``
    output channels."""
    nc = min((12, 8), key=lambda c: (_ceil_div(n_out, c) * c, -c))
    groups = min(MAX_GROUPS, _ceil_div(n_out, nc))
    nt = groups * nc
    grid_x = b * rows * _ceil_div(cols, TILE_WINDOWS)
    if grid_x >= 2**31:
        raise ValueError(
            f"{WHAT}: B={b} with {rows} x {cols} output pairs needs {grid_x} "
            "blocks, beyond one grid"
        )
    return TilePlan(nc, 32 * groups, grid_x, _ceil_div(n_out, nt),
                    4 * CHUNK * (PLANE + 9 * nt))


def dw_plan(b: int, h: int, w: int, c_in: int, c_out: int) -> DwPlan:
    groups = min(DW_MAX_GROUPS, _ceil_div(c_out, DW_CO))
    nco = groups * DW_CO
    tiles = _ceil_div(c_in, DW_LANES) * _ceil_div(c_out, nco)
    steps = b * (h // 2) * _ceil_div(w // 2, DW_WINDOWS)
    splits = max(1, min(steps, DW_TARGET_BLOCKS // tiles, 65535))
    smem = 4 * (DW_LANES * DW_X_PLANE + 4 * DW_WINDOWS * (nco + 4))
    return DwPlan(32 * groups, tiles, splits, steps, smem)


def check_inputs(x, w, corr, alpha) -> Tuple[int, int, int, int, int]:
    """``(B, Cin, Cout, H, W)`` of arguments the kernels take; raises, with
    the numbers, on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"{WHAT} kernels need a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{WHAT} takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(
            f"{WHAT} takes a contiguous [B, Cin, H, W] tensor, got shape "
            f"{tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )
    b, c_in, h, win = x.shape
    if min(b, c_in) < 1 or min(h, win) < 2:
        raise ValueError(
            f"{WHAT}: geometry B={b}, Cin={c_in}, H={h}, W={win} leaves no "
            "output (needs B >= 1, Cin >= 1, H >= 2, W >= 2)"
        )
    if w.ndim != 2 or w.shape[0] != 9 * c_in or w.shape[1] < 1:
        raise ValueError(
            f"{WHAT}: w must be [9 * Cin, Cout] = [{9 * c_in}, Cout], got "
            f"{tuple(w.shape)}"
        )
    c_out = w.shape[1]
    if max(c_in, c_out) * h * win >= 2**31:
        raise ValueError(
            f"{WHAT}: Cin={c_in}, Cout={c_out}, H={h}, W={win}: one frame "
            "is beyond 32-bit offsets"
        )
    _require(w, "w", torch.float32, (9 * c_in, c_out), x.device, WHAT)
    _require(corr, "corr", torch.float32, (c_out, h, win), x.device, WHAT)
    _require(alpha, "alpha", torch.float32, (1,), x.device, WHAT)
    return b, c_in, c_out, h, win


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def forward(
    x: torch.Tensor,
    w: torch.Tensor,
    corr: torch.Tensor,
    alpha: torch.Tensor,
    want_code: bool,
    want_stats: bool,
):
    """Launch the forward kernel.

    ``x [B, Cin, H, W]`` float32 or bfloat16; ``w [9 * Cin, Cout]`` (row
    ``(dh * 3 + dw) * Cin + ci``), ``corr [Cout, H, W]``, ``alpha [1]``
    float32.  Returns ``(out [B, Cout, H//2, W//2], code, sum, sumsq)``;
    ``code`` (uint8, ``phase | negative << 2``) is ``None`` unless
    ``want_code``, the float32 ``[Cout]`` moments of the stored output are
    ``None`` unless ``want_stats``.
    """
    global CONV2_FWD_LAUNCHES
    b, c_in, c_out, h, win = check_inputs(x, w, corr, alpha)
    h2, w2 = h // 2, win // 2
    plan = tile_plan(b, h2, w2, c_out)
    wk = w.view(9, c_in, c_out).permute(1, 0, 2).contiguous()
    shape = (b, c_out, h2, w2)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    code = torch.empty(shape, dtype=torch.uint8, device=x.device) if want_code else None
    partials = (
        torch.empty((plan.grid_x, 2, c_out), dtype=torch.float32, device=x.device)
        if want_stats
        else None
    )
    err = _lib().fused_conv2_fwd_launch(
        x.data_ptr(), wk.data_ptr(), corr.data_ptr(), alpha.data_ptr(),
        out.data_ptr(),
        code.data_ptr() if want_code else None,
        partials.data_ptr() if want_stats else None,
        c_in, c_out, h, win, int(x.dtype == torch.bfloat16), plan.nc,
        plan.grid_x, plan.grid_y, plan.threads, plan.smem_bytes,
        x.device.index, _stream(x),
    )
    _check(err, f"{WHAT} forward launch")
    CONV2_FWD_LAUNCHES += 1
    if not want_stats:
        return out, code, None, None
    s, q = partials.sum(dim=0)
    return out, code, s, q


def backward(
    x: torch.Tensor,
    w: torch.Tensor,
    corr: torch.Tensor,
    alpha: torch.Tensor,
    g: torch.Tensor,
    out: torch.Tensor,
    code: torch.Tensor,
    gs: Optional[torch.Tensor],
    gq: Optional[torch.Tensor],
    need_dx: bool = True,
):
    """Launch the backward kernels: ``(dx [B, Cin, H, W]`` in ``x``'s type
    or ``None``, ``dw [9 * Cin, Cout]``, ``dcorr [Cout, H, W]``, ``dalpha
    [1])``, the last three float32.  ``g`` is the cotangent of ``out``;
    ``gs`` / ``gq`` (float32 ``[Cout]`` or ``None``) are those of the
    moments."""
    global CONV2_BWD_LAUNCHES
    b, c_in, c_out, h, win = check_inputs(x, w, corr, alpha)
    shape = (b, c_out, h // 2, win // 2)
    _require(g, "g", x.dtype, shape, x.device, WHAT)
    _require(out, "out", x.dtype, shape, x.device, WHAT)
    _require(code, "code", torch.uint8, shape, x.device, WHAT)
    for name, t in (("gs", gs), ("gq", gq)):
        if t is not None:
            _require(t, name, torch.float32, (c_out,), x.device, WHAT)
    gs_ptr = gs.data_ptr() if gs is not None else None
    gq_ptr = gq.data_ptr() if gq is not None else None
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _lib()

    dx = None
    if need_dx:
        plan = tile_plan(b, (h + 1) // 2, (win + 1) // 2, c_in)
        w_flipped = (
            w.view(3, 3, c_in, c_out).flip(0, 1).permute(3, 0, 1, 2).contiguous()
        )  # [Cout, 9 (flipped taps), Cin]
        dx = torch.empty_like(x)
        err = lib.fused_conv2_dx_launch(
            w_flipped.data_ptr(), alpha.data_ptr(), g.data_ptr(), out.data_ptr(),
            code.data_ptr(), gs_ptr, gq_ptr, dx.data_ptr(),
            c_in, c_out, h, win, is_bf16, plan.nc,
            plan.grid_x, plan.grid_y, plan.threads, plan.smem_bytes,
            x.device.index, _stream(x),
        )
        _check(err, f"{WHAT} dx launch")

    plan = dw_plan(b, h, win, c_in, c_out)
    wk = w.view(9, c_in, c_out).permute(1, 0, 2).contiguous()
    dw_partials = torch.empty(
        (plan.splits, 9 * c_in, c_out), dtype=torch.float32, device=x.device
    )
    # rows and columns past the pooled region keep their zeros
    dcorr = torch.zeros((c_out, h, win), dtype=torch.float32, device=x.device)
    small_blocks = _ceil_div(c_out * (h // 2) * (win // 2), SMALL_THREADS)
    da_partials = torch.empty((small_blocks,), dtype=torch.float32, device=x.device)
    err = lib.fused_conv2_dw_small_launch(
        x.data_ptr(), wk.data_ptr(), corr.data_ptr(), alpha.data_ptr(),
        g.data_ptr(), out.data_ptr(), code.data_ptr(), gs_ptr, gq_ptr,
        dw_partials.data_ptr(), dcorr.data_ptr(), da_partials.data_ptr(),
        b, c_in, c_out, h, win, is_bf16,
        plan.tiles, plan.splits, plan.threads, plan.smem_bytes, small_blocks,
        x.device.index, _stream(x),
    )
    _check(err, f"{WHAT} dw / dcorr / dalpha launch")
    CONV2_BWD_LAUNCHES += 1
    return dx, dw_partials.sum(dim=0), dcorr, da_partials.sum().reshape(1)
