"""Launchers of the fused PReLU + max-pool CUDA kernels (``csrc/fused_pool.cu``).

``forward`` / ``backward`` check device, type, shape and contiguity, allocate
outputs and scratch with ``torch.empty``, launch one kernel each on the
current stream without synchronising, and finish the cross-block reductions
with one ``torch.sum`` over the per-block partials (the forward's one per
plane, the backward's one per strip of pooled rows; fixed order: results are
bit-for-bit reproducible).  ``POOL_FWD_LAUNCHES`` / ``POOL_BWD_LAUNCHES``
count the kernel launches made in this process.  The public functions and
the plain PyTorch versions live in ``ops/fused_pool.py``.

The library is compiled at first use (``cuda_build.compile_library``) and
bound with ``ctypes``; nothing here touches the CUDA toolchain at import
time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from .cuda_build import CSRC_DIR, compile_library
from .fused_conv1_cuda import _require

#: forward / backward kernel launches made in this process
POOL_FWD_LAUNCHES = 0
POOL_BWD_LAUNCHES = 0

SOURCE = CSRC_DIR / "fused_pool.cu"
WHAT = "fused_prelu_pool"

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
        lib.fused_pool_fwd_launch.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        lib.fused_pool_fwd_launch.restype = ci
        lib.fused_pool_bwd_launch.argtypes = [vp] * 9 + [ci] * 6 + [vp]
        lib.fused_pool_bwd_launch.restype = ci
        lib.fused_pool_bwd_strips.argtypes = [ci] * 3
        lib.fused_pool_bwd_strips.restype = ci
        lib.fused_pool_error_string.argtypes = [ci]
        lib.fused_pool_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return report


def _lib() -> ctypes.CDLL:
    if _LIB is None:
        build()
    return _LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().fused_pool_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def check_geometry(x: torch.Tensor, alpha: torch.Tensor) -> Tuple[int, int, int, int]:
    """``(B, C, H, W)`` of a tensor the kernels take; raises, with the
    numbers, on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"{WHAT} kernels need a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{WHAT} takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(
            f"{WHAT} takes a contiguous [B, C, H, W] tensor, got shape "
            f"{tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )
    b, c, h, w = x.shape
    if min(b, c) < 1 or min(h, w) < 2:
        raise ValueError(
            f"{WHAT}: geometry B={b}, C={c}, H={h}, W={w} leaves no output "
            "(needs B >= 1, C >= 1, H >= 2, W >= 2)"
        )
    if b * c >= 2**31 or h * w >= 2**31:
        raise ValueError(
            f"{WHAT}: B*C={b * c} planes of H*W={h * w} elements are beyond "
            "one grid (2**31 - 1 blocks, 32-bit plane offsets)"
        )
    _require(alpha, "alpha", torch.float32, (1,), x.device, WHAT)
    return b, c, h, w


def forward(x: torch.Tensor, alpha: torch.Tensor, want_code: bool, want_stats: bool):
    """Launch the forward kernel.

    ``x [B, C, H, W]`` float32 or bfloat16, ``alpha [1]`` float32.  Returns
    ``(out [B, C, H//2, W//2], code, sum, sumsq)``; ``code`` (uint8,
    ``phase | negative << 2``) is ``None`` unless ``want_code``, the float32
    ``[C]`` moments of the stored output are ``None`` unless ``want_stats``.
    """
    global POOL_FWD_LAUNCHES
    b, c, h, w = check_geometry(x, alpha)
    shape = (b, c, h // 2, w // 2)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    code = torch.empty(shape, dtype=torch.uint8, device=x.device) if want_code else None
    partials = (
        torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
        if want_stats
        else None
    )
    err = _lib().fused_pool_fwd_launch(
        x.data_ptr(), alpha.data_ptr(), out.data_ptr(),
        code.data_ptr() if want_code else None,
        partials.data_ptr() if want_stats else None,
        b * c, h, w, int(x.dtype == torch.bfloat16),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check(err, f"{WHAT} forward launch")
    POOL_FWD_LAUNCHES += 1
    if not want_stats:
        return out, code, None, None
    s, q = partials.sum(dim=0).unbind(dim=1)
    return out, code, s, q


def backward(
    x: torch.Tensor,
    alpha: torch.Tensor,
    g: torch.Tensor,
    out: torch.Tensor,
    code: torch.Tensor,
    gs: Optional[torch.Tensor],
    gq: Optional[torch.Tensor],
):
    """Launch the backward kernel: ``(dx [B, C, H, W]`` in ``x``'s type,
    ``dalpha [1]`` float32``)``.  ``g`` is the cotangent of ``out``; ``gs`` /
    ``gq`` (float32 ``[C]`` or ``None``) are those of the moments."""
    global POOL_BWD_LAUNCHES
    b, c, h, w = check_geometry(x, alpha)
    shape = (b, c, h // 2, w // 2)
    _require(g, "g", x.dtype, shape, x.device, WHAT)
    _require(out, "out", x.dtype, shape, x.device, WHAT)
    _require(code, "code", torch.uint8, shape, x.device, WHAT)
    for name, t in (("gs", gs), ("gq", gq)):
        if t is not None:
            _require(t, name, torch.float32, (c,), x.device, WHAT)
    # backward blocks per plane: strips of pooled rows, staged in shared memory
    strips = _lib().fused_pool_bwd_strips(h, w, int(x.dtype == torch.bfloat16))
    if strips == 0:
        raise ValueError(
            f"{WHAT}: W={w} is too wide for the backward's staging of one pooled row "
            "(two input rows) in a block's shared memory"
        )
    if b * c * strips >= 2**31:
        raise ValueError(f"{WHAT}: B*C={b * c} planes of {strips} strips are beyond one grid")
    dx = torch.empty_like(x)
    partials = torch.empty((b * c * strips,), dtype=torch.float32, device=x.device)
    err = _lib().fused_pool_bwd_launch(
        x.data_ptr(), alpha.data_ptr(), g.data_ptr(), out.data_ptr(),
        code.data_ptr(),
        gs.data_ptr() if gs is not None else None,
        gq.data_ptr() if gq is not None else None,
        dx.data_ptr(), partials.data_ptr(),
        b * c, c, h, w, int(x.dtype == torch.bfloat16),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check(err, f"{WHAT} backward launch")
    POOL_BWD_LAUNCHES += 1
    return dx, partials.sum().reshape(1)
