"""Wavelet-packet cascade as hand-written CUDA kernels (``csrc/wpt_cascade.cu``).

Counterpart of ``audiodeepfake_detection_tpu/ops/wpt_pallas.py::
wpt_packets_pallas``: ``[B, T]`` float32 -> ``[B, 2**level, n_level]`` in
Gray-code (frequency) node order, with an optional fused
``log(|x|**power + 1e-12)``.  The kernel's header says what bounds it on
the H100 and how its design answers that.

The library is compiled at first use (``cuda_build.compile_library``) and
bound with ``ctypes``.  Nothing here imports or invokes the CUDA toolchain
at import time.

``wpt_packets_cuda`` takes the plain PyTorch version (``wpt.wpt_analysis``)
only for a CPU tensor.  The same forward is the op ``adfd::wpt_packets``
(``ops/library.py``; :data:`wpt_packets`), which ``wpt.packet_image`` calls:
its CUDA implementation is ``wpt_packets_cuda`` on the plan
:func:`wpt_plan` picks.  A CUDA tensor gets the subtree kernel, a CTA per
(frame, node at the split depth ``k``), or an exception.  :func:`wpt_plan`
picks ``k`` and where each CTA's level-``k`` node comes from (the "top"):
``"frame"`` (``k <= 1``: read from the frames), ``"path"`` (the CTA
recomputes its ancestors from the frame) or ``"levels"`` (the top levels
go through device memory, one ``wpt_level_kernel`` launch a level).
``LAUNCHES`` counts calls that launched the subtree kernel (every CUDA
call), ``LEVEL_LAUNCHES`` the launches of ``wpt_level_kernel``, one per
level written to device memory, so a run can show which kernels its path
went through and that no level below the top ones left the chip.  No
gradient is defined: the transform sits in front of the model under
stop-gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Optional, Tuple

import torch

from . import library
from .cuda_build import CSRC_DIR, compile_library
from .wavelets import get_wavelet
from .wpt import dec_kernel, log_power, wpt_analysis, wpt_output_length

#: calls of :func:`wpt_packets_cuda` that launched the subtree kernel
LAUNCHES = 0
#: launches of the top-level kernel (one per level through device memory)
LEVEL_LAUNCHES = 0

SOURCE = CSRC_DIR / "wpt_cascade.cu"

#: the subtree kernel's ``__launch_bounds__`` (threads), the largest filter
#: it takes (its generic instance's tap arrays) and the deepest level
MAX_THREADS = 1024
MAX_TAPS = 64
MAX_LEVEL = 30

_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOCK = threading.Lock()


class LaunchArgs(ctypes.Structure):
    """What a call passes besides the tensors and the stream (``LaunchArgs``
    in the kernel's source), built once per geometry."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "filt_len", "batch", "level", "split", "in_level", "buf_b_off",
        "smem_bytes", "threads", "log_scale", "device")] + [
        ("power", ctypes.c_float),
        ("len", ctypes.c_int * (MAX_LEVEL + 1)),
        ("taps", ctypes.c_float * (2 * MAX_TAPS)),
    ]


def build() -> str:
    """Compile (unless already built) and load the kernel library.

    Returns the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills), or ``""`` when the library was already built or loaded.
    """
    global _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return ""
        lib_path, report = compile_library(SOURCE)
        lib = ctypes.CDLL(str(lib_path))
        vp, ci, args = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(LaunchArgs)
        lib.wpt_subtree_launch.argtypes = [vp, vp, args, vp]
        lib.wpt_subtree_launch.restype = ci
        lib.wpt_level_launch.argtypes = [vp, vp, args, ci, vp]
        lib.wpt_level_launch.restype = ci
        lib.wpt_cascade_device_limits.argtypes = [ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
        lib.wpt_cascade_device_limits.restype = ci
        lib.wpt_cascade_prepare.argtypes = [ci, ci]
        lib.wpt_cascade_prepare.restype = ci
        lib.wpt_cascade_error_string.argtypes = [ci]
        lib.wpt_cascade_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return report


def _lib() -> ctypes.CDLL:
    if _LIB is None:
        build()
    return _LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().wpt_cascade_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=16)
def device_limits(device_index: int) -> Tuple[int, int]:
    """``(SM count, dynamic shared memory one block may opt into)`` of a
    device; on first use also opts the subtree kernel into that much."""
    smem, sms = ctypes.c_int(), ctypes.c_int()
    _check(_lib().wpt_cascade_device_limits(device_index, smem, sms), "device query")
    _check(_lib().wpt_cascade_prepare(device_index, smem.value), "shared-memory opt-in")
    return sms.value, smem.value


@functools.lru_cache(maxsize=64)
def level_lengths(t: int, filt_len: int, level: int) -> Tuple[int, ...]:
    """Node length at levels 0 .. ``level`` (pywt's rule,
    ``n' = (n + L - 1) // 2``)."""
    n = [t]
    for _ in range(level):
        n.append((n[-1] + filt_len - 1) // 2)
    return tuple(n)


def _row_stride(n: int, filt_len: int) -> int:
    # as row_stride in the kernel: a padded row of n samples
    return (n + 2 * filt_len) & ~3


def subtree_smem(lengths: Tuple[int, ...], filt_len: int, split: int,
                 in_level: int, smem_limit: int = 2**31) -> Tuple[int, int]:
    """Shared memory of one CTA: ``(buffer B's float offset, bytes)``.

    Levels ``in_level + 1 .. L`` alternate between buffer A (the first,
    third, ... of them) and buffer B as padded rows: a level at or above
    the split depth is the CTA's one node, a level below it
    ``2**(level - split)`` rows.  Each buffer ends with the slack that the
    window loads of the last row's masked outputs overrun.  Buffer B is also
    the stage of the first level's samples: if it fits ``smem_limit``, large
    enough for all of them at once, else for chunks of them.
    """
    r = outputs_per_window(filt_len)
    slack = 2 * r + 8
    sizes = [0, 0]
    top = len(lengths) - 1
    for t, lvl in enumerate(range(in_level + 1, top + 1)):
        rows = 1 if lvl <= split else 1 << (lvl - split)
        sizes[t & 1] = max(sizes[t & 1], rows * _row_stride(lengths[lvl], filt_len) + slack)
    buf_b_off = (sizes[0] + 3) & ~3
    # a stage of s floats takes chunks of (s - filt_len - 4r - 8) // 2r
    # windows: at least 32 of them, at best the whole first level
    whole = 2 * r * -(-lengths[in_level + 1] // r) + filt_len + 4 * r + 8
    least = 64 * r + filt_len + 4 * r + 8
    stage = max(sizes[1], least, whole)
    if 4 * (buf_b_off + stage) > smem_limit:
        stage = max(sizes[1], least)
    return buf_b_off, 4 * (buf_b_off + stage)


@dataclasses.dataclass(frozen=True)
class WptPlan:
    """How one call runs: ``batch << split`` CTAs of ``threads``, each with
    ``smem_bytes`` of dynamic shared memory (buffer B at float
    ``buf_b_off``), reading level ``in_level`` from device memory."""

    split: int
    in_level: int
    threads: int
    smem_bytes: int
    buf_b_off: int

    @property
    def top(self) -> str:
        """Where a CTA's level-``split`` node comes from: the frame
        (``"frame"``, ``split <= 1``), its ancestors recomputed from the
        frame (``"path"``), or a top level in device memory (``"levels"``)."""
        if self.in_level > 0:
            return "levels"
        return "frame" if self.split <= 1 else "path"


def outputs_per_window(filt_len: int) -> int:
    """Outputs of each child a thread computes from one window (R in the
    kernel's ``outputs_per_window``)."""
    return 6 if filt_len in (2, 8, 10, 16) else 2


def _threads(lengths: Tuple[int, ...], filt_len: int, split: int, in_level: int,
             ctas: int, sm_count: int) -> int:
    # one thread per window of the busiest step (a path step computes one
    # child, a subtree step both), at most 1024 where each CTA has an SM to
    # itself and 512 where two share one
    r = outputs_per_window(filt_len)
    top = len(lengths) - 1
    items = [-(-lengths[i] // r) for i in range(in_level + 1, split + 1)]
    items += [(1 << (i - split - 1)) * -(-lengths[i] // r) for i in range(split + 1, top + 1)]
    cap = MAX_THREADS if ctas <= sm_count else MAX_THREADS // 2
    return max(64, min(cap, -(-max(items) // 32) * 32))


def make_plan(lengths: Tuple[int, ...], filt_len: int, split: int, top: str,
              batch: int = 1, sm_count: int = 132, smem_limit: int = 232448) -> WptPlan:
    """The plan of one split depth and top route (``"frame"`` / ``"path"``:
    read the frames; ``"levels"``: levels ``1 .. split - 1`` through device
    memory; ``"levels-all"``: levels ``1 .. split``) for ``batch`` frames
    on ``sm_count`` SMs."""
    in_level = {"frame": 0, "path": 0, "levels": max(split - 1, 0),
                "levels-all": split}[top]
    buf_b_off, smem = subtree_smem(lengths, filt_len, split, in_level, smem_limit)
    threads = _threads(lengths, filt_len, split, in_level, batch << split, sm_count)
    return WptPlan(split, in_level, threads, smem, buf_b_off)


#: a launch of the top-level kernel, counted in :func:`plan_load` as this
#: many outputs of the busiest SM: its gap on the card, a few microseconds,
#: is about the time an SM takes for them
LAUNCH_OUTPUTS = 16000
#: :func:`wpt_plan` takes the shallowest split within this factor of the
#: least load: fewer CTAs and less recomputation for about the same time
#: (``tools/wpt_bench.py sweep`` times every split depth and top route)
LOAD_SLACK = 1.2


def plan_load(lengths: Tuple[int, ...], split: int, in_level: int, batch: int,
              sm_count: int) -> int:
    """Outputs the busiest SM computes under a plan: its CTAs' paths of
    ancestors and subtrees, and each top level through device memory
    (spread over every SM) plus ``LAUNCH_OUTPUTS`` for its launch."""
    top = len(lengths) - 1
    path = sum(lengths[i] for i in range(in_level + 1, split + 1))
    subtree = sum((1 << (i - split)) * lengths[i] for i in range(split + 1, top + 1))
    load = -(-(batch << split) // sm_count) * (path + subtree)
    for i in range(1, in_level + 1):
        load += -(-((batch << i) * lengths[i]) // sm_count) + LAUNCH_OUTPUTS
    return load


@functools.lru_cache(maxsize=256)
def wpt_plan(batch: int, t: int, filt_len: int, level: int, sm_count: int,
             smem_limit: int) -> WptPlan:
    """The plan of a call: the split depth ``k`` and the top route.

    Every plan that fits one block's shared memory is a candidate: each
    ``k`` with the CTA reading the frames (``"frame"``, ``"path"``), with
    the top ``k - 1`` levels through device memory (``"levels"``), and, at
    ``k = level - 1``, every level but the last through device memory (it
    always fits).  The rule takes the least :func:`plan_load`, or the
    shallowest split within ``LOAD_SLACK`` of it.
    """
    lengths = level_lengths(t, filt_len, level)
    plans = []
    for k in range(level):
        tops = ["frame" if k <= 1 else "path"] + (["levels"] if k >= 2 else [])
        tops += ["levels-all"] if k == level - 1 else []
        for top in tops:
            plan = make_plan(lengths, filt_len, k, top, batch, sm_count, smem_limit)
            if plan.smem_bytes <= smem_limit:
                plans.append((plan_load(lengths, k, plan.in_level, batch, sm_count), plan))
    if not plans:
        raise ValueError(
            f"wpt_packets_cuda: no plan for B={batch}, T={t}, level {level}, "
            f"{filt_len} taps fits {smem_limit} bytes of shared memory (the "
            f"last level alone takes 2 rows of {lengths[-1]} samples)")
    least = min(load for load, _ in plans)
    return next(plan for load, plan in plans if load <= LOAD_SLACK * least)


@functools.lru_cache(maxsize=32)
def filter_length(wavelet_name: str) -> int:
    return int(dec_kernel(wavelet_name, "cpu").shape[-1])


@functools.lru_cache(maxsize=256)
def launch_args(wavelet_name: str, batch: int, t: int, level: int, log_scale: bool,
                power: float, device_index: int,
                plan: Optional[WptPlan] = None) -> Tuple[LaunchArgs, WptPlan]:
    """The launch arguments of a geometry, and its plan (``plan`` or
    :func:`wpt_plan`'s); raises, with the numbers, on a geometry the
    kernels do not take."""
    taps = dec_kernel(wavelet_name, "cpu").reshape(-1)  # flipped dec_lo, dec_hi
    filt_len = taps.numel() // 2
    if filt_len % 2 or filt_len > MAX_TAPS:
        raise ValueError(
            f"wpt_packets_cuda takes an even filter of at most {MAX_TAPS} taps, "
            f"{wavelet_name} has {filt_len}")
    lengths = level_lengths(t, filt_len, level)
    if (2**level) * lengths[-1] >= 2**31 or level > MAX_LEVEL:
        raise ValueError(f"output rows of {2**level} x {lengths[-1]} overflow int32")
    sms, smem_limit = device_limits(device_index)
    if plan is None:
        plan = wpt_plan(batch, t, filt_len, level, sms, smem_limit)
    if plan.smem_bytes > smem_limit or batch << plan.split >= 2**31:
        raise ValueError(
            f"wpt plan {plan} for B={batch}, T={t}, level {level}, {filt_len} "
            f"taps exceeds {smem_limit} bytes of shared memory or 2**31 CTAs")
    args = LaunchArgs(
        filt_len, batch, level, plan.split, plan.in_level, plan.buf_b_off,
        plan.smem_bytes, plan.threads, int(log_scale), device_index, power)
    args.len[: level + 1] = lengths
    args.taps[: 2 * filt_len] = taps.tolist()
    return args, plan


def wpt_packets_cuda(
    x: torch.Tensor,
    wavelet_name: str,
    level: int = 8,
    log_scale: bool = False,
    power: float = 2.0,
    plan: Optional[WptPlan] = None,
) -> torch.Tensor:
    """Fused WPT: ``[B, T] -> [B, 2**level, n_level]`` (frequency order).

    A CPU tensor runs the plain version (``wpt.wpt_analysis`` plus the same
    log).  A CUDA tensor must be contiguous float32; it launches the top
    levels (if the plan has any) and the subtree kernel on the current
    stream without synchronising, or raises.  There is no fallback to the
    plain version.  ``plan`` overrides :func:`wpt_plan` (every plan gives
    the same bits).
    """
    global LAUNCHES, LEVEL_LAUNCHES
    if x.device.type == "cpu":
        return plain_packets(x, wavelet_name, level, log_scale, power)
    if x.device.type != "cuda":
        raise ValueError(f"wpt_packets_cuda: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"wpt_packets_cuda takes float32, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            "wpt_packets_cuda takes a contiguous [B, T] tensor, got shape "
            f"{tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    b, t = x.shape
    if b == 0:
        n = level_lengths(t, filter_length(wavelet_name), level)[-1]
        return torch.empty((0, 2**level, n), dtype=torch.float32, device=x.device)
    args, plan = launch_args(wavelet_name, b, t, level, bool(log_scale), float(power),
                             x.device.index, plan)
    out = torch.empty((b, 2**level, args.len[level]), dtype=torch.float32,
                      device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    for lvl in range(1, plan.in_level + 1):
        dst = torch.empty((b, 1 << lvl, args.len[lvl]), dtype=torch.float32,
                          device=x.device)
        _check(lib.wpt_level_launch(src.data_ptr(), dst.data_ptr(), args, lvl, stream),
               f"wpt_level launch (level {lvl})")
        LEVEL_LAUNCHES += 1
        src = dst
    _check(lib.wpt_subtree_launch(src.data_ptr(), out.data_ptr(), args, stream),
           f"wpt_subtree launch ({plan})")
    LAUNCHES += 1
    return out


def plain_packets(x: torch.Tensor, wavelet_name: str, level: int, log_scale: bool = False,
                  power: float = 2.0) -> torch.Tensor:
    """The plain PyTorch version: ``wpt.wpt_analysis`` plus the same log."""
    wp = wpt_analysis(x, wavelet_name, level)
    return log_power(wp, power) if log_scale else wp


def _packets_cuda(x, wavelet_name, level, log_scale, power):
    return wpt_packets_cuda(x, wavelet_name, level, log_scale, power)


def _packets_fake(x, wavelet_name, level, log_scale, power):
    n = wpt_output_length(x.shape[1], get_wavelet(wavelet_name).dec_len, level)
    return x.new_empty((x.shape[0], 2**level, n))


#: ``adfd::wpt_packets(x, wavelet, level, log_scale, power)``: ``[B, T] ->
#: [B, 2**level, n_level]``, the kernel on the automatic plan for a CUDA
#: tensor, :func:`plain_packets` for a CPU one
wpt_packets = library.register(
    "wpt_packets", "(Tensor x, str wavelet, int level, bool log_scale, float power) -> Tensor",
    cpu=plain_packets, cuda=_packets_cuda, fake=_packets_fake)
