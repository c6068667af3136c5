"""Launchers of the fused conv 3x3 + PReLU + max-pool CUDA kernels
(``csrc/fused_conv2.cu``).

``forward`` launches one kernel (FMA pipe, a two-stage ``cp.async`` ring).
``backward`` launches three: ``dx`` (the transposed convolution) and ``dw``
(split over ``B * H * W``), both implicit GEMMs on the tensor cores with
split-TF32 products, and a small one for ``dcorr`` and ``dalpha``; it
finishes the cross-block sums with one ``torch.sum`` each over per-block
partials (fixed order: results are bit-for-bit reproducible).  The
launchers check device, type, shape and contiguity,
allocate outputs and scratch with ``torch.empty`` / ``torch.zeros``, run on
the current stream and do not synchronise.  ``CONV2_FWD_LAUNCHES`` counts
forward kernel launches; ``CONV2_BWD_LAUNCHES`` grows by one per
``backward`` call (its two or three kernels together).  The public functions
and the plain PyTorch versions live in ``ops/fused_conv2.py``.

The only tensor work outside the kernels is the re-arrangement of the
``[9 * Cin, Cout]`` weights (a few hundred KB) into the orders the kernels
read, zero-padded to whole tiles so that every slab is one run of 16-byte
copies: ``[channel tiles][Cin_pad][9][nt]`` for the forward, flipped
``[Cin tiles][Cout_pad][9 * 64 + 8]`` for ``dx`` and ``[Cin, 9, Cout]`` for
the small kernel.

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

#: forward kernel launches / backward calls made in this process
CONV2_FWD_LAUNCHES = 0
CONV2_BWD_LAUNCHES = 0

SOURCE = CSRC_DIR / "fused_conv2.cu"
WHAT = "fused_conv2"

CHUNK = 8  # channels of K per ring stage: kChunk in the source
STAGES = 2  # depth of every kernel's ring
# forward
TILE_WINDOWS = 32  # pool windows (lanes) per tile: kTileWindows
PLANE = 4 * (2 * TILE_WINDOWS + 2)  # floats per staged channel: kPlane
MAX_GROUPS = 8  # warps (channel groups) per forward block
# dx: 8 x 32 pixels by 64 input channels a block, 8 warps
DX_ROWS, DX_COLS, DX_CI = 8, 32, 64
DX_PLANE = 440  # kDxPlane: a 12 x 36 ring of d around the 10 x 34 halo, padded
DX_W_ROW = 9 * DX_CI + 8  # kDxWRow: one output channel's flipped taps, padded
DX_THREADS = 256
# dw: (9 taps x 32 input channels) by 96 output channels a block, 12 warps
DW_CI, DW_CO = 32, 96
DW_WINDOWS = 16  # pool windows per step (64 pixels of K)
DW_X_PLANE = 140  # kDwXPlane
DW_D_ROW = 4 * DW_WINDOWS + 4  # kDwDRow
DW_THREADS = 12 * 32
# dw blocks over the whole grid: one per SM of a 132-SM card (one fits an SM:
# 384 threads, 140 KB of shared memory).  Each writes a [9, 32, 96] tile of
# partials, so the buffer stays at a few MB
DW_TARGET_BLOCKS = 132
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
        lib.fused_conv2_fwd_launch.argtypes = [vp] * 7 + [ci] * 12 + [vp]
        lib.fused_conv2_dx_launch.argtypes = [vp] * 8 + [ci] * 10 + [vp]
        lib.fused_conv2_dw_launch.argtypes = [vp] * 8 + [ci] * 10 + [vp]
        lib.fused_conv2_small_launch.argtypes = [vp] * 11 + [ci] * 8 + [vp]
        for fn in ("fwd", "dx", "dw", "small"):
            getattr(lib, f"fused_conv2_{fn}_launch").restype = ci
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
    """How the forward kernel cuts its output."""

    nc: int  # channels a thread owns (8 or 12)
    threads: int  # 32 lanes (pool windows) * channel groups
    grid_x: int  # B * row pairs * column tiles
    grid_y: int  # channel tiles of nt = threads // 32 * nc
    smem_bytes: int  # two stages of the x tile + weight slab


class DxPlan(NamedTuple):
    """How the ``dx`` kernel cuts ``dx``: 8 x 32 pixels by 64 channels a
    block."""

    threads: int
    grid_x: int  # B * ceil(H / 8) * ceil(W / 32)
    grid_y: int  # tiles of 64 input channels
    cout_pad: int  # K channels rounded up to a whole chunk
    smem_bytes: int  # two stages of the split d halo planes + weight slab


class DwPlan(NamedTuple):
    """How the ``dw`` kernel cuts ``dw`` and the ``B * H * W`` sum."""

    threads: int  # 12 warps: 3 tap rows x 4 quarters of 96 output channels
    tiles: int  # grid x: tiles of 32 input by 96 output channels
    splits: int  # grid y: shares of the steps, one row of partials each
    steps: int  # B * H//2 * ceil(W//2 / 16)
    smem_bytes: int  # two stages of the x tile + split d tile, (gs, gq)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _geometry(b: int, h: int, w: int, *channels: int) -> None:
    if min(b, h, w, *channels) < 1 or min(h, w) < 2:
        raise ValueError(
            f"{WHAT}: geometry B={b}, H={h}, W={w}, channels {channels} is not "
            "one the kernels take (needs B >= 1, H >= 2, W >= 2, channels >= 1)"
        )


def _grid(n: int, what: str) -> int:
    if n >= 2**31:
        raise ValueError(f"{WHAT}: {what} needs {n} blocks, beyond one grid")
    return n


def tile_plan(b: int, h: int, w: int, c_out: int) -> TilePlan:
    """Forward plan for ``x [b, *, h, w]``: ``h // 2`` x ``w // 2`` pool
    windows and ``c_out`` output channels."""
    _geometry(b, h, w, c_out)
    nc = min((12, 8), key=lambda c: (_ceil_div(c_out, c) * c, -c))
    groups = min(MAX_GROUPS, _ceil_div(c_out, nc))
    nt = groups * nc
    grid_x = _grid(b * (h // 2) * _ceil_div(w // 2, TILE_WINDOWS),
                   f"B={b} with {h // 2} x {w // 2} pool windows")
    return TilePlan(nc, 32 * groups, grid_x, _ceil_div(c_out, nt),
                    4 * STAGES * CHUNK * (PLANE + 9 * nt))


def dx_plan(b: int, h: int, w: int, c_in: int, c_out: int) -> DxPlan:
    _geometry(b, h, w, c_in, c_out)
    grid_x = _grid(b * _ceil_div(h, DX_ROWS) * _ceil_div(w, DX_COLS),
                   f"dx of B={b}, H={h}, W={w}")
    return DxPlan(DX_THREADS, grid_x, _ceil_div(c_in, DX_CI),
                  _ceil_div(c_out, CHUNK) * CHUNK,
                  4 * STAGES * CHUNK * (2 * DX_PLANE + DX_W_ROW))


def dw_plan(b: int, h: int, w: int, c_in: int, c_out: int) -> DwPlan:
    _geometry(b, h, w, c_in, c_out)
    tiles = _ceil_div(c_in, DW_CI) * _ceil_div(c_out, DW_CO)
    steps = b * (h // 2) * _ceil_div(w // 2, DW_WINDOWS)
    splits = max(1, min(steps, DW_TARGET_BLOCKS // tiles, 65535))
    # d: big and small; then the block's moment cotangents
    smem = 4 * (STAGES * (DW_CI * DW_X_PLANE + 2 * DW_CO * DW_D_ROW) + 2 * DW_CO)
    return DwPlan(DW_THREADS, _grid(tiles, f"dw of Cin={c_in}, Cout={c_out}"), splits,
                  steps, smem)


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


def forward_weights(w: torch.Tensor, c_in: int, c_out: int, nt: int) -> torch.Tensor:
    """``[9 * Cin, Cout]`` -> ``[Cout tiles][Cin_pad][9][nt]``, zero past
    both ends: one chunk's slab is one contiguous run."""
    tiles, cin_pad = _ceil_div(c_out, nt), _ceil_div(c_in, CHUNK) * CHUNK
    wk = F.pad(w.view(9, c_in, c_out), (0, tiles * nt - c_out, 0, cin_pad - c_in))
    return wk.view(9, cin_pad, tiles, nt).permute(2, 1, 0, 3).contiguous()


def dx_weights(w: torch.Tensor, c_in: int, c_out: int, cout_pad: int) -> torch.Tensor:
    """``[9 * Cin, Cout]`` -> flipped ``[Cin tiles][Cout_pad][9 * 64 + 8]``:
    row ``co`` holds ``w`` at tap ``(2 - dh, 2 - dw)``, channels of the tile,
    then 8 zeros (so the rows' stride is 8 banks)."""
    tiles = _ceil_div(c_in, DX_CI)
    wf = w.view(3, 3, c_in, c_out).flip(0, 1).reshape(9, c_in, c_out)
    wf = F.pad(wf, (0, cout_pad - c_out, 0, tiles * DX_CI - c_in))
    wf = wf.view(9, tiles, DX_CI, cout_pad).permute(1, 3, 0, 2)  # [t, co, 9, 64]
    return F.pad(wf.reshape(tiles, cout_pad, 9 * DX_CI), (0, DX_W_ROW - 9 * DX_CI))


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
    plan = tile_plan(b, h, win, c_out)
    nt = plan.threads // 32 * plan.nc
    wk = forward_weights(w, c_in, c_out, nt)
    shape = (b, c_out, h // 2, win // 2)
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
        c_in, wk.shape[1], c_out, h, win, int(x.dtype == torch.bfloat16), plan.nc,
        plan.grid_x, plan.grid_y, plan.threads, plan.smem_bytes,
        x.device.index, _stream(x),
    )
    _check(err, f"{WHAT} forward launch")
    CONV2_FWD_LAUNCHES += 1
    if not want_stats:
        return out, code, None, None
    s, q = partials.sum(dim=0)
    return out, code, s, q


def _dx(x, w, alpha, g, out, code, gs, gq) -> torch.Tensor:
    """The ``dx`` kernel, on arguments ``backward`` has checked."""
    b, c_in, h, win = x.shape
    c_out = w.shape[1]
    plan = dx_plan(b, h, win, c_in, c_out)
    wdx = dx_weights(w, c_in, c_out, plan.cout_pad)
    dx = torch.empty_like(x)
    err = _lib().fused_conv2_dx_launch(
        wdx.data_ptr(), alpha.data_ptr(), g.data_ptr(), out.data_ptr(),
        code.data_ptr(), gs.data_ptr(), gq.data_ptr(), dx.data_ptr(),
        c_in, c_out, plan.cout_pad, h, win, int(x.dtype == torch.bfloat16),
        plan.grid_x, plan.grid_y, plan.smem_bytes, x.device.index, _stream(x),
    )
    _check(err, f"{WHAT} dx launch")
    return dx


def _dw(x, w, alpha, g, out, code, gs, gq) -> torch.Tensor:
    """The ``dw`` kernel: ``[9 * Cin, Cout]`` float32."""
    b, c_in, h, win = x.shape
    c_out = w.shape[1]
    plan = dw_plan(b, h, win, c_in, c_out)
    partials = torch.empty(
        (plan.splits, 9 * c_in, c_out), dtype=torch.float32, device=x.device
    )
    err = _lib().fused_conv2_dw_launch(
        x.data_ptr(), alpha.data_ptr(), g.data_ptr(), out.data_ptr(), code.data_ptr(),
        gs.data_ptr(), gq.data_ptr(), partials.data_ptr(), b, c_in, c_out, h, win,
        int(x.dtype == torch.bfloat16), plan.tiles, plan.splits, plan.smem_bytes,
        x.device.index, _stream(x),
    )
    _check(err, f"{WHAT} dw launch")
    return partials.sum(dim=0)


def _small(x, w, corr, alpha, g, out, code, gs, gq):
    """The ``dcorr`` / ``dalpha`` kernel: ``(dcorr [Cout, H, W],
    dalpha [1])`` float32."""
    b, c_in, h, win = x.shape
    c_out = w.shape[1]
    wk = w.view(9, c_in, c_out).permute(1, 0, 2).contiguous()  # [Cin, 9, Cout]
    # rows and columns past the pooled region keep their zeros
    dcorr = torch.zeros((c_out, h, win), dtype=torch.float32, device=x.device)
    blocks = _ceil_div(c_out * (h // 2) * (win // 2), SMALL_THREADS)
    da_partials = torch.empty((blocks,), dtype=torch.float32, device=x.device)
    err = _lib().fused_conv2_small_launch(
        x.data_ptr(), wk.data_ptr(), corr.data_ptr(), alpha.data_ptr(),
        g.data_ptr(), out.data_ptr(), code.data_ptr(), gs.data_ptr(), gq.data_ptr(),
        dcorr.data_ptr(), da_partials.data_ptr(), b, c_in, c_out, h, win,
        int(x.dtype == torch.bfloat16), blocks, x.device.index, _stream(x),
    )
    _check(err, f"{WHAT} dcorr / dalpha launch")
    return dcorr, da_partials.sum().reshape(1)


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
    # the kernels read the moments' cotangents unconditionally: zeros when
    # the forward returned no moments
    zeros = None if gs is not None and gq is not None else torch.zeros(
        (c_out,), dtype=torch.float32, device=x.device)
    args = (alpha, g, out, code, zeros if gs is None else gs, zeros if gq is None else gq)
    dx = _dx(x, w, *args) if need_dx else None
    dw = _dw(x, w, *args)
    dcorr, da = _small(x, w, corr, *args)
    CONV2_BWD_LAUNCHES += 1
    return dx, dw, dcorr, da
