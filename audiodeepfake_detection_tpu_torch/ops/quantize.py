"""Post-training int8 quantization for scoring.

Counterpart of ``audiodeepfake_detection_tpu/ops/quantize.py``, the same
symmetric scheme:

* activations: a per-tensor scale ``s_x`` calibrated as the absmax of a
  site's input over a few batches (the input of a BatchNorm-folded conv is
  the raw previous activation: the BatchNorm lives in the weights);
* weights: per-output-channel ``s_w[oc] = max(absmax, 1e-30) / 127`` of the
  effective (folded) weights, computed on the fly or baked once
  (:func:`bake_int8_weights`);
* codes ``clip(round(x * (1 / s)), -127, 127)`` (round half to even, a
  multiply by the float32 inverse as the JAX function takes it), int32
  sums, and the dequantization ``float(acc) * float32(s_x * s_w)`` rounded
  once to the working type.

Convolutions run through ``ops/int8_conv.py`` (the hand-written
implicit-GEMM kernel on the card); Dense layers (the AST's) through
``torch._int_mm``, the plain matrix product the JAX package leaves to
XLA (cuBLASLt's s8 x s8 -> s32 on the card).  Layouts are torch's: conv
weights OIHW (absmax over dims 1-3), Linear weights ``[Out, In]`` (absmax
over the inputs), so a record's ``w_q`` is the JAX record's transposed.

Flax's ``sow`` and variable collections become plain objects here:

* a model's ``quant`` attribute is ``None``, ``"calibrate"`` or a
  ``{site: act_scale}`` dict with the JAX package's site keys (``cnn_4``,
  ``dil_7``, ``lcnn_13``, ``block_0/qkv``), so a scales dict passes between
  the two packages unchanged; its forward asks :class:`Int8Sites` at each
  site;
* in ``"calibrate"`` mode a :class:`QuantObserver` on the model records
  each site's input absmax, the maximum over batches;
* baked records (``{w_q, s_w}``; a conv site's codes also in the
  kernel's layout, and a folded site's map) are non-persistent buffers of
  the int8 model, so they move with ``.to()`` and ``state_dict()`` keeps the
  reference ``.pt`` layout.

:func:`with_quant` is JAX's ``model.clone(quant=...)``: a second model
object that shares every parameter, buffer and submodule with the first,
whose own ``quant`` and baked records leave the first usable as it was.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, Iterable, Optional

import torch

from .int8_conv import int8_conv, quantize_activation_nhwc
from .int8_conv_cuda import site_weights

#: conv sites quantized by default: the DCNN's six front convs carry ~99% of
#: its operations; the dilated block and the head stay in the working type
DEFAULT_INT8_SITES = ("cnn_0", "cnn_4", "cnn_7", "cnn_11", "cnn_14", "cnn_17")
CALIBRATE = "calibrate"
_BAKED = "int8_baked__"  # name prefix of the baked records' buffers
_PARTS = ("w_q", "s_w", "rows", "map")  # what a baked record may hold


def quantize_activation(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric per-tensor int8: ``clip(round(x * (1 / s)), -127, 127)``,
    in ``x``'s layout."""
    inv = 1.0 / max(float(scale), 1e-30)
    q = torch.round(x.float() * inv)
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def quantize_weight_per_channel(w: torch.Tensor):
    """Per-output-channel symmetric int8 of an OIHW kernel: ``(w_q int8
    OIHW, s_w float32 [O])``."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=(1, 2, 3))
    s_w = torch.clamp(absmax, min=1e-30) / 127.0
    q = torch.round(w32 / s_w.reshape(-1, 1, 1, 1))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8), s_w


def dense_int8_weights(weight: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output symmetric int8 of a Linear weight ``[Out, In]``:
    ``{"w_q": int8 [Out, In], "s_w": float32 [Out]}``."""
    w32 = weight.float()
    s_w = torch.clamp(w32.abs().amax(dim=1), min=1e-30) / 127.0
    w_q = torch.clamp(torch.round(w32 / s_w[:, None]), -127.0, 127.0).to(torch.int8)
    return {"w_q": w_q, "s_w": s_w}


def conv_int8_weights(w_eff: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The weight record of an effective (folded) OIHW conv kernel."""
    w_q, s_w = quantize_weight_per_channel(w_eff)
    return {"w_q": w_q, "s_w": s_w}


def conv_site_record(w_eff: torch.Tensor, fold_map: Optional[torch.Tensor] = None):
    """The baked record of an int8 conv site: :func:`conv_int8_weights` of
    the effective kernel, its codes in the kernel's layout (``rows``,
    ``ops/int8_conv_cuda.py::site_weights``) and, for a site with a
    BatchNorm folded in, the fold's ``[Cout, Ho, Wo]`` map in the working
    type (``map``)."""
    rec = conv_int8_weights(w_eff)
    rec["rows"] = site_weights(rec["w_q"])
    if fold_map is not None:
        rec["map"] = fold_map
    return rec


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` of int8 codes into int32 (``torch._int_mm``).
    On the card cuBLASLt needs M > 16 and K, N multiples of 8: fewer rows
    are padded with zero codes (and cut off again), other K or N raise."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(
            f"int8 matmul on the card needs K and N multiples of 8, got K={k}, N={n}"
        )
    if m > 16:
        return torch._int_mm(a, b)
    return torch._int_mm(torch.nn.functional.pad(a, (0, 0, 0, 32 - m)), b)[:m]


def quantized_dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    act_scale: float,
    out_dtype: Optional[torch.dtype] = None,
    baked: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """``x @ weight.T`` on the int8 path (no bias): ``x [..., In]``,
    ``weight [Out, In]``; ``baked`` a :func:`dense_int8_weights` record, or
    ``None`` to quantize ``weight`` on the fly."""
    out_dtype = out_dtype or x.dtype
    x_q = quantize_activation(x, act_scale)
    rec = baked if baked is not None else dense_int8_weights(weight)
    y = int_mm(x_q.reshape(-1, x_q.shape[-1]), rec["w_q"].t())
    scale = float(act_scale) * rec["s_w"]
    return (y.float() * scale).to(out_dtype).reshape(*x.shape[:-1], -1)


def quantized_conv(
    x: torch.Tensor,
    w_eff: torch.Tensor,
    act_scale: float,
    padding: int,
    dilation: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    baked: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Quantize ``x [B, C, H, W]``, the int8 convolution with the effective
    OIHW kernel ``w_eff`` (stride 1), dequantize: ``[B, Cout, Ho, Wo]`` in
    ``out_dtype`` (``x``'s type by default), no bias.  ``baked``: a
    :func:`conv_int8_weights` record, or ``None`` to quantize ``w_eff`` on
    the fly."""
    out_dtype = out_dtype or x.dtype
    x_q = quantize_activation_nhwc(x, act_scale)
    rec = baked if baked is not None else conv_int8_weights(w_eff)
    scale = float(act_scale) * rec["s_w"]
    return int8_conv(x_q, rec["w_q"], scale, padding, dilation, out_dtype)


class QuantObserver:
    """Per-site activation absmax, the maximum over batches (the JAX
    package's ``QuantObserver.reduce``)."""

    def __init__(self) -> None:
        self.absmax: Dict[str, float] = {}

    def record(self, site: str, x: torch.Tensor) -> None:
        v = float(x.detach().float().abs().max())
        self.absmax[site] = max(self.absmax.get(site, 0.0), v)


def _record_name(site: str) -> str:
    return _BAKED + site.replace("/", "__")


class Int8Sites:
    """What a quantizable model's forward consults at its int8 sites.

    ``owner`` is the model whose ``quant`` (``"calibrate"`` or a scales
    dict), observer and baked records count; ``prefix`` is joined to each
    site name (``"cnn_"`` + ``"4"``; ``"block_0/"`` + ``"qkv"``)."""

    def __init__(self, owner: torch.nn.Module, prefix: str = "") -> None:
        self.owner, self.prefix = owner, prefix

    def scope(self, prefix: str) -> "Int8Sites":
        return Int8Sites(self.owner, self.prefix + prefix)

    def scale(self, name: str, x: torch.Tensor) -> Optional[float]:
        """``"calibrate"``: record ``absmax(x)`` for the site, return None
        (the fp path runs).  A scales dict: the site's activation scale, or
        None when the site is not included."""
        quant, site = self.owner.quant, self.prefix + name
        if isinstance(quant, str) and quant == CALIBRATE:
            observer = getattr(self.owner, "int8_observer", None)
            if observer is None:
                observer = self.owner.int8_observer = QuantObserver()
            observer.record(site, x)
            return None
        if isinstance(quant, Mapping):
            v = quant.get(site)
            return None if v is None else float(v)
        return None

    def baked(self, name: str, make_record: Callable[[], Dict[str, torch.Tensor]]):
        """The site's baked record (``{w_q, s_w}``, a dense site's; a conv
        site's also ``rows`` and, if folded, ``map``: :func:`conv_site_record`);
        made by ``make_record`` and stored while :func:`bake_int8_weights`
        runs; otherwise None (the weights quantize on the fly)."""
        owner = self.owner
        key = _record_name(self.prefix + name) + "__"
        if key + "w_q" in owner._buffers:
            return {p: owner._buffers[key + p] for p in _PARTS if key + p in owner._buffers}
        if not getattr(owner, "int8_baking", False):
            return None
        rec = make_record()
        for part, t in rec.items():
            owner.register_buffer(key + part, t.detach(), persistent=False)
        return rec


def int8_sites(model: torch.nn.Module, prefix: str = "") -> Optional[Int8Sites]:
    """The model's :class:`Int8Sites`, or None when ``quant`` is None."""
    quant = getattr(model, "quant", None)
    if quant is None:
        return None
    if not (isinstance(quant, Mapping) or (isinstance(quant, str) and quant == CALIBRATE)):
        raise ValueError(f"quant must be None, {CALIBRATE!r} or a scales dict: {quant!r}")
    return Int8Sites(model, prefix)


def check_quant_eval(model: torch.nn.Module) -> None:
    """Training with int8 sites raises (JAX's "inference-only" refusal)."""
    if model.quant is not None and model.training:
        raise ValueError(
            "quant is inference-only (int8 rounding has no gradient); call the "
            "model in eval mode"
        )


def with_quant(model: torch.nn.Module, quant) -> torch.nn.Module:
    """JAX's ``model.clone(quant=quant)``: a new object of the model's class
    sharing its parameters, buffers and submodules, with its own ``quant``,
    observer and baked records (none yet), so ``model`` stays as it was."""
    clone = type(model).__new__(type(model))
    clone.__dict__.update(model.__dict__)
    clone._buffers = {k: v for k, v in model._buffers.items() if not k.startswith(_BAKED)}
    clone._non_persistent_buffers_set = {
        k for k in model._non_persistent_buffers_set if not k.startswith(_BAKED)
    }
    clone.__dict__.pop("int8_observer", None)
    clone.int8_baking = False
    clone.quant = quant
    return clone


def _run_eval(model: torch.nn.Module, images: Iterable[torch.Tensor]) -> int:
    """Forward ``images`` through ``model`` in eval mode without gradients,
    restoring the training flags after; returns the number of batches."""
    was_training = model.training
    model.eval()
    n = 0
    try:
        with torch.no_grad():
            for img in images:
                model(img)
                n += 1
    finally:
        model.train(was_training)
    return n


def calibrate_model(
    model: torch.nn.Module,
    images: Iterable[torch.Tensor],
    include=None,
    margin: float = 1.0,
) -> Dict[str, float]:
    """Absmax-calibrate the activation scales of any ``quant``-capable model.

    ``images`` iterates model inputs (transform outputs, on the model's
    device).  The model runs in ``"calibrate"`` mode (activations flow
    unquantized, each site's input absmax is recorded, remat off) and the
    result is ``{site: absmax * margin / 127}`` restricted to ``include``
    (None: every observed site)."""
    calib = with_quant(model, CALIBRATE)
    if hasattr(calib, "remat_blocks"):
        calib.remat_blocks = False
    calib.int8_observer = QuantObserver()
    _run_eval(calib, images)
    absmax = calib.int8_observer.absmax
    if not absmax:
        raise ValueError("calibration saw no batches (empty `images`)")
    scales = {k: v * float(margin) / 127.0 for k, v in absmax.items()}
    if include is not None:
        scales = {k: v for k, v in scales.items() if k in include}
    return scales


def quantize_model(model, images, include=None, margin: float = 1.0):
    """Calibrate and return ``(int8 model, scales)``: the int8 model is
    :func:`with_quant` of ``model`` with the scales, its included sites
    on the int8 path; ``model`` itself is unchanged."""
    scales = calibrate_model(model, images, include=include, margin=margin)
    return with_quant(model, scales), scales


def calibrate_dcnn(model, images, include=DEFAULT_INT8_SITES, margin: float = 1.0):
    """DCNN-family alias of :func:`calibrate_model` (the front convs)."""
    return calibrate_model(model, images, include=include, margin=margin)


def quantize_dcnn(model, images, include=DEFAULT_INT8_SITES, margin: float = 1.0):
    """DCNN-family alias of :func:`quantize_model` (the front convs)."""
    return quantize_model(model, images, include=include, margin=margin)


def bake_int8_weights(model: torch.nn.Module, image: torch.Tensor) -> torch.nn.Module:
    """Quantize the weights of every active int8 site once: one forward
    pass of ``image`` stores each site's record (``{w_q, s_w}`` of the
    effective, BatchNorm-folded kernel; a conv site's codes also in the
    kernel's layout, and a folded site's map at ``image``'s plane) as
    non-persistent buffers of ``model``, which later forwards read instead
    of requantizing and laying out.  Records baked before are dropped
    first, so a re-bake after a BatchNorm update refreshes them.  Returns
    ``model``."""
    for name in [k for k in model._buffers if k.startswith(_BAKED)]:
        del model._buffers[name]
        model._non_persistent_buffers_set.discard(name)
    model.int8_baking = True
    try:
        _run_eval(model, [image])
    finally:
        model.int8_baking = False
    return model


def baked_records(model: torch.nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{site: record}`` of the records :func:`bake_int8_weights` stored."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in model._buffers.items():
        if name.startswith(_BAKED):
            site, part = name[len(_BAKED):].rsplit("__", 1)
            out.setdefault(site.replace("__", "/"), {})[part] = t
    return out
