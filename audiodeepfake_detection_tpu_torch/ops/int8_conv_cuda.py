"""Launcher of the s8 x s8 -> s32 implicit-GEMM convolution (``csrc/int8_conv.cu``).

``forward`` checks device, type, shape and contiguity, lays the weight codes
out as the kernel reads them (:func:`gemm_weights`), allocates the output
with ``torch.empty`` and launches one kernel on the current stream without
synchronising.  ``LAUNCHES`` counts the kernel launches made in this
process.  The public function and the plain PyTorch version live in
``ops/int8_conv.py``.

The library is compiled at first use (``cuda_build.compile_library``) and
bound with ``ctypes``; nothing here touches the CUDA toolchain at import
time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda_build import CSRC_DIR, compile_library
from .fused_conv1_cuda import _require

#: kernel launches made in this process
LAUNCHES = 0

SOURCE = CSRC_DIR / "int8_conv.cu"
WHAT = "int8_conv"
# the kernel's tiles (csrc/int8_conv.cu kBN, kBK): the weight rows are padded
# to whole 64-channel tiles and 32-deep steps with zero codes
TILE_N, TILE_K = 64, 32
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
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.int8_conv_launch.argtypes = [vp] * 4 + [ci] * 11 + [vp]
        lib.int8_conv_launch.restype = ci
        lib.int8_conv_tile.argtypes = [ci]
        lib.int8_conv_tile.restype = ci
        lib.int8_conv_error_string.argtypes = [ci]
        lib.int8_conv_error_string.restype = ctypes.c_char_p
        if (lib.int8_conv_tile(0), lib.int8_conv_tile(1)) != (TILE_N, TILE_K):
            raise RuntimeError(f"{WHAT}: the library's tiles differ from the launcher's")
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


def gemm_weights(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW codes ``[Cout, Cin, k, k]`` -> ``[Npad, Kpad]``: row ``n`` is
    output channel ``n``, column ``(kh * k + kw) * Cin + c``, zero codes up
    to whole tiles."""
    cout = w_q.shape[0]
    rows = w_q.permute(0, 2, 3, 1).reshape(cout, -1)
    k = rows.shape[1]
    return F.pad(rows, (0, -k % TILE_K, 0, -cout % TILE_N)).contiguous()


def check_geometry(x_q, w_q, scale, padding: int, dilation: int, out_dtype):
    """``(B, H, W, Cin, Cout, k, Ho, Wo)`` of a convolution the kernel takes;
    raises, with the numbers, on anything else."""
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
    if w_q.ndim != 4 or w_q.shape[1] != cin or w_q.shape[2] != w_q.shape[3]:
        raise ValueError(
            f"{WHAT}: weights must be [Cout, {cin}, k, k] (square taps), got "
            f"{tuple(w_q.shape)}"
        )
    cout, ksize = w_q.shape[0], w_q.shape[2]
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
    if out_dtype != torch.int32:
        _require(scale, "scale", torch.float32, (cout,), x_q.device, WHAT)
    return b, h, w, cin, cout, ksize, ho, wo


def forward(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale: Optional[torch.Tensor],
    padding: int,
    dilation: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Launch the kernel: ``[B, Cout, Ho, Wo]`` in ``out_dtype`` (float32,
    bfloat16, or int32 for the accumulators, when ``scale`` is not read)."""
    b, h, w, cin, cout, ksize, ho, wo = check_geometry(
        x_q, w_q, scale, padding, dilation, out_dtype
    )
    rows = gemm_weights(w_q.to(x_q.device))
    out = torch.empty((b, cout, ho, wo), dtype=out_dtype, device=x_q.device)
    launch(x_q, rows, scale, out, ksize, padding, dilation)
    return out


def launch(x_q, rows, scale, out, ksize: int, padding: int, dilation: int) -> None:
    """One launch into ``out`` of what :func:`forward` checked and laid out
    (``rows`` from :func:`gemm_weights`)."""
    global LAUNCHES
    b, h, w, cin = x_q.shape
    err = _lib().int8_conv_launch(
        x_q.data_ptr(), rows.data_ptr(),
        scale.data_ptr() if out.dtype != torch.int32 else None, out.data_ptr(),
        b, h, w, cin, out.shape[1], ksize, padding, dilation, rows.shape[1],
        OUT_KINDS[out.dtype], x_q.device.index,
        torch.cuda.current_stream(x_q.device).cuda_stream,
    )
    if err != 0:
        msg = _lib().int8_conv_error_string(err).decode()
        raise RuntimeError(f"{WHAT} launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
