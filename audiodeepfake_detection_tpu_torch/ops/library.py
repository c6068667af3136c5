"""The ``adfd`` operator namespace: each kernel's forward as a ``torch.library`` op.

A kernel launcher is a ``ctypes`` call that reads ``data_ptr()``, which a
tracer's fake tensors do not have, so ``torch.export`` cannot trace through
one.  Each forward that a scorer reaches is therefore also an op,
``torch.ops.adfd.<name>``, with three implementations:

* ``CUDA``: the launcher (the kernel, or an exception with the numbers);
* ``CPU``: the plain PyTorch version, what a CPU tensor ran before;
* fake: the CUDA output's shape, dtype and strides from the input sizes
  (a symbolic batch stays symbolic), for tracing.

The modules that own the kernels register their ops here with
:func:`register` when they are imported; :func:`load` imports all of them,
which is what an exported artifact needs before ``torch.export.load``.
Where no gradient is needed, the public functions (``fused_conv1_prelu_pool``,
``flash_mha_packed``, ...) call the op on either device, so a traced graph
holds the same ``adfd::`` nodes on the CPU as on the card.  Training keeps
its ``torch.autograd.Function`` around the launchers; backwards are no ops.

Ops are defined with ``Library(..., "DEF")`` rather than
``@torch.library.custom_op``, whose Python wrapper adds to every call; the
op's cost over its direct launcher on the card is in PERF.md.

:func:`tensor_cache` is ``functools.lru_cache`` for functions that make
tensors (taps, windows, index maps, normalization stats): inside a trace it
makes them outside the tracer, since a tensor made there is a fake one that
would outlive the trace and be handed to eager callers later.
"""

from __future__ import annotations

import functools
import importlib
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

NAMESPACE = "adfd"
#: the modules that register ``adfd`` ops when imported
OP_MODULES = ("wpt_cuda", "fused_conv1", "fused_pool", "fused_conv2", "flash_attention",
              "int8_conv")

_LIB = torch.library.Library(NAMESPACE, "DEF")


def register(name: str, schema: str, cpu: Callable, cuda: Callable,
             fake: Callable) -> torch._ops.OpOverload:
    """Define ``adfd::<name><schema>`` with its CPU, CUDA and fake
    implementations; returns the op (``torch.ops.adfd.<name>.default``)."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(torch.ops.adfd, name).default


def load() -> None:
    """Import every module that registers an ``adfd`` op."""
    for mod in OP_MODULES:
        importlib.import_module(f"{__package__}.{mod}")


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on ``tensors``: then the
    public functions take their ``autograd.Function`` instead of the op."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def tensor_cache(maxsize: Optional[int]):
    """``functools.lru_cache(maxsize)`` for functions that make tensors and
    that a trace may call: while ``torch.compiler.is_compiling()``
    (``torch.export``, ``torch.compile``) the function runs with the
    tracer's modes set aside, so the cache holds a real tensor and the graph
    takes it as a constant (made inside the trace, it would be a FakeTensor,
    and the graph would copy it to the device on every call)."""

    def wrap(make: Callable) -> Callable:
        cached = functools.lru_cache(maxsize=maxsize)(make)

        @functools.wraps(make)
        def get(*args):
            if torch.compiler.is_compiling():
                with _disable_current_modes():
                    return cached(*args)
            return cached(*args)

        get.cache_clear = cached.cache_clear
        return get

    return wrap
