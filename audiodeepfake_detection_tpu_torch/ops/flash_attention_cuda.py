"""Launchers of the fused attention CUDA kernels (``csrc/flash_mha.cu``).

``forward`` / ``backward`` check device, type, shape and contiguity, allocate
outputs and scratch with ``torch.empty``, and launch on the current stream
without synchronising.  Two hand-written routes, chosen by geometry
(:func:`route_for`): the resident route (``N <= RESIDENT_MAX_N``, scores of
a query tile held for the whole key range: two products forward, seven
backward, bf16 on the tensor cores, fp32 on the FMA pipe) and the streaming
route (any N, and tensors that do not start on a 16-byte boundary: S and P
in registers, every product on the tensor cores, fp32 in split TF32; two
products forward in fp32, three in bf16; seven backward in fp32, whose row
term is ``rowsum(dout * out)`` from the forward's output, nine in bf16).
``route=`` names one explicitly, so the card checks can run the streaming
route at the AST's N; no model or CLI option exposes it.
``MHA_FWD_LAUNCHES`` / ``MHA_BWD_LAUNCHES`` count the resident route's
calls, ``MHA_STREAM_FWD_LAUNCHES`` /
``MHA_STREAM_BWD_LAUNCHES`` the streaming route's (a backward call launches
two kernels, query side then key side, and counts once).  The public
function and the plain PyTorch version live in ``ops/flash_attention.py``.

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

#: forward / backward calls that launched the resident route, in this process
MHA_FWD_LAUNCHES = 0
MHA_BWD_LAUNCHES = 0
#: ... and the streaming route
MHA_STREAM_FWD_LAUNCHES = 0
MHA_STREAM_BWD_LAUNCHES = 0

SOURCE = CSRC_DIR / "flash_mha.cu"
WHAT = "flash_mha_packed"
#: the head width the kernels are written for (``kD`` in the source)
HEAD_DIM = 64
#: the longest token count of the resident route (``kMaxResident``)
RESIDENT_MAX_N = 256
ROUTES = ("resident", "stream")

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
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_mha_fwd_launch.argtypes = [vp] * 3 + [ci] * 3 + [cf, ci, ci, vp]
        lib.flash_mha_fwd_launch.restype = ci
        lib.flash_mha_bwd_launch.argtypes = [vp] * 6 + [ci] * 3 + [cf, ci, ci, vp]
        lib.flash_mha_bwd_launch.restype = ci
        lib.flash_mha_resident_fwd_launch.argtypes = lib.flash_mha_fwd_launch.argtypes
        lib.flash_mha_resident_fwd_launch.restype = ci
        lib.flash_mha_resident_bwd_launch.argtypes = [vp] * 5 + [ci] * 3 + [cf, ci, ci, vp]
        lib.flash_mha_resident_bwd_launch.restype = ci
        lib.flash_mha_resident_max_n.restype = ci
        lib.flash_mha_head_dim.restype = ci
        lib.flash_mha_error_string.argtypes = [ci]
        lib.flash_mha_error_string.restype = ctypes.c_char_p
        if lib.flash_mha_head_dim() != HEAD_DIM:
            raise RuntimeError(f"{SOURCE.name} is built for another head width")
        if lib.flash_mha_resident_max_n() != RESIDENT_MAX_N:
            raise RuntimeError(f"{SOURCE.name} is built for another resident limit")
        _LIB = lib
        return report


def _lib() -> ctypes.CDLL:
    if _LIB is None:
        build()
    return _LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().flash_mha_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def check_geometry(qkv: torch.Tensor, heads: int) -> Tuple[int, int]:
    """``(B, N)`` of a packed ``[B, N, 3 * heads * 64]`` tensor the kernels
    take; raises, with the numbers, on anything else."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{WHAT} kernels need a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{WHAT} takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.ndim != 3 or not qkv.is_contiguous():
        raise ValueError(
            f"{WHAT} takes a contiguous [B, N, 3*H*D] tensor, got shape "
            f"{tuple(qkv.shape)} (contiguous={qkv.is_contiguous()})"
        )
    b, n, c = qkv.shape
    if c % 3 or (c // 3) % heads:
        raise ValueError(
            f"{WHAT}: {c} packed lanes are not 3 * {heads} heads of equal width"
        )
    d = c // 3 // heads
    if d != HEAD_DIM:
        raise ValueError(f"{WHAT}: the kernels take heads of {HEAD_DIM}, got {d}")
    if min(b, n) < 1 or b > 65535 or heads > 65535:
        raise ValueError(
            f"{WHAT}: B={b}, N={n}, H={heads} is outside one grid "
            "(needs 1 <= B, H <= 65535 and N >= 1)"
        )
    return b, n


def route_for(n: int, *tensors: torch.Tensor) -> str:
    """The route a geometry takes: ``"resident"`` for ``N <= RESIDENT_MAX_N``
    when every tensor starts on a 16-byte boundary (its ``cp.async`` copies
    move 16 bytes), else ``"stream"``."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return "resident" if n <= RESIDENT_MAX_N and aligned else "stream"


def _pick(route: Optional[str], n: int, *tensors: torch.Tensor) -> str:
    if route is None:
        return route_for(n, *tensors)
    if route not in ROUTES:
        raise ValueError(f"{WHAT}: route must be one of {ROUTES}, got {route!r}")
    if route == "resident" and route_for(n, *tensors) != "resident":
        raise ValueError(
            f"{WHAT}: the resident route takes N <= {RESIDENT_MAX_N} and 16-byte "
            f"aligned tensors, got N={n}"
        )
    return route


def forward(qkv: torch.Tensor, heads: int, scale: float, want_stats: bool,
            route: Optional[str] = None):
    """Launch the forward kernel: ``(out [B, N, H*D]`` in qkv's type, the
    float32 ``[B, H, N, 2]`` row statistics ``(max, sum)`` or ``None``).
    ``route``: ``None`` (by geometry), ``"resident"`` or ``"stream"``."""
    global MHA_FWD_LAUNCHES, MHA_STREAM_FWD_LAUNCHES
    b, n = check_geometry(qkv, heads)
    route = _pick(route, n, qkv)
    out = torch.empty((b, n, qkv.shape[2] // 3), dtype=qkv.dtype, device=qkv.device)
    stats = (
        torch.empty((b, heads, n, 2), dtype=torch.float32, device=qkv.device)
        if want_stats
        else None
    )
    launch = (_lib().flash_mha_resident_fwd_launch if route == "resident"
              else _lib().flash_mha_fwd_launch)
    err = launch(
        qkv.data_ptr(), out.data_ptr(), stats.data_ptr() if want_stats else None,
        b, n, heads, float(scale), int(qkv.dtype == torch.bfloat16),
        qkv.device.index, torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _check(err, f"{WHAT} {route} forward launch")
    if route == "resident":
        MHA_FWD_LAUNCHES += 1
    else:
        MHA_STREAM_FWD_LAUNCHES += 1
    return out, stats


def backward(
    qkv: torch.Tensor, dout: torch.Tensor, stats: torch.Tensor, heads: int, scale: float,
    route: Optional[str] = None, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the backward kernels: ``dqkv [B, N, 3*H*D]`` in qkv's type.
    ``dout`` is the cotangent of the forward's output ``out``, ``stats`` its
    row statistics; ``route`` as for :func:`forward`.  The fp32 streaming
    route needs ``out`` (its row term is ``rowsum(dout * out)``); the other
    routes and types form the row term from the recomputed probabilities and
    ignore it."""
    global MHA_BWD_LAUNCHES, MHA_STREAM_BWD_LAUNCHES
    b, n = check_geometry(qkv, heads)
    _require(dout, "dout", qkv.dtype, (b, n, qkv.shape[2] // 3), qkv.device, WHAT)
    _require(stats, "stats", torch.float32, (b, heads, n, 2), qkv.device, WHAT)
    route = _pick(route, n, qkv, dout)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    args = [qkv.data_ptr(), dout.data_ptr()]
    if route == "resident":
        launch = _lib().flash_mha_resident_bwd_launch
    else:
        launch = _lib().flash_mha_bwd_launch
        if qkv.dtype == torch.float32:
            if out is None:
                raise ValueError(f"{WHAT}: the fp32 streaming backward takes the forward's out")
            _require(out, "out", qkv.dtype, (b, n, qkv.shape[2] // 3), qkv.device, WHAT)
        args.append(out.data_ptr() if qkv.dtype == torch.float32 else None)
    err = launch(
        *args, stats.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), b, n, heads, float(scale), int(qkv.dtype == torch.bfloat16),
        qkv.device.index, torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _check(err, f"{WHAT} {route} backward launch")
    if route == "resident":
        MHA_BWD_LAUNCHES += 1
    else:
        MHA_STREAM_BWD_LAUNCHES += 1
    return dqkv
