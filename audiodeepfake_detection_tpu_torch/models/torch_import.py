"""Carry DCNN, LCNN and AST weights across: reference ``.pt`` snapshots,
timm DeiT state dicts and JAX variables.

Counterpart of ``audiodeepfake_detection_tpu/models/torch_import.py``.  The
port's modules use the reference ``nn.Sequential`` layout, so a snapshot in
the current reference layout loads directly; two things still need a
translation step:

* **older snapshots.**  The bundled coif4 checkpoint uses other Sequential
  indices than the stft/sym5 ones (an older layer arrangement), so
  :func:`import_dcnn` and :func:`import_lcnn` match layers by their
  *ordered kind sequence* (conv / prelu / batchnorm / linear / lstm) within
  each block (``cnn`` / ``dil_conv`` / ``fc``; ``lcnn`` / ``lstm`` /
  ``fc``) instead of by index, and re-key them onto the port's indices.
* **JAX variables.**  :func:`state_dict_from_jax` turns the JAX package's
  ``{"params", "batch_stats"}`` tree (numpy arrays) into the port's
  ``state_dict``: conv ``[kh, kw, I, O] -> [O, I, kh, kw]``, linear
  ``[in, out] -> [out, in]``, PReLU ``() -> [1]``, the BLSTM's ``w_ih_fw``
  ... ``b_hh_bw`` -> ``l_blstm.weight_ih_l0`` ... ``bias_hh_l0_reverse``,
  ``num_batches_tracked`` int32 -> int64.  :func:`adam_state_from_jax`
  carries optax's Adam state (``count / mu / nu``) into a
  ``torch.optim.Adam`` with the same key map, so both packages can continue
  from one mid-training state.
* **AST.**  The port's ``ASTModel`` is built in the reference's trained-AST
  layout (``v.``-prefixed DeiT + ``mlp_head``), so such a snapshot loads
  directly; :func:`import_timm_deit` does the reference's surgery on a timm
  DeiT state dict, and ``state_dict_from_jax(variables, "ast")`` carries the
  JAX ``ASTModel`` params across.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ast import _SIZES, ast_patch_grid

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """Load a ``.pt`` snapshot as a flat CPU state dict.

    Handles the reference snapshot format ``{"MODEL_STATE": ..., "EPOCHS_RUN":
    ...}`` as well as a bare state dict, and strips any number of leading
    ``module.`` prefixes (the reference saves DDP-wrapped models).
    """
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("MODEL_STATE", blob) if isinstance(blob, dict) else blob
    return strip_module_prefix(state)


def load_epochs_run(path: str) -> int:
    """The 0-based index of the snapshot's last completed epoch.

    Reference semantics (train_classifier.py:997-1008): ``EPOCHS_RUN`` is
    the loop index at save time, i.e. the epoch that had just finished.
    Returns -1 when the blob has no ``EPOCHS_RUN`` (bare state dicts).
    """
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "EPOCHS_RUN" in blob:
        return int(blob["EPOCHS_RUN"])
    return -1


def strip_module_prefix(state) -> StateDict:
    """Drop any number of leading ``module.`` prefixes from every key."""
    out = {}
    for key, val in state.items():
        while key.startswith("module."):
            key = key[len("module.") :]
        out[key] = torch.as_tensor(val).detach().cpu()
    return out


# (flax name, kind, port Sequential index) per block, in forward order; an
# index of None is a module that is no Sequential member (``fc.weight``)
_DCNN_CNN = [
    ("cnn_0", "conv", 0),
    ("cnn_1", "prelu", 1),
    ("cnn_3", "batchnorm", 3),
    ("cnn_4", "conv", 4),
    ("cnn_5", "prelu", 5),
    ("cnn_6", "batchnorm", 6),
    ("cnn_7", "conv", 7),
    ("cnn_8", "prelu", 8),
    ("cnn_10", "batchnorm", 10),
    ("cnn_11", "conv", 11),
    ("cnn_12", "prelu", 12),
    ("cnn_13", "batchnorm", 13),
    ("cnn_14", "conv", 14),
    ("cnn_15", "prelu", 15),
    ("cnn_16", "batchnorm", 16),
    ("cnn_17", "conv", 17),
    ("cnn_18", "prelu", 18),
]
_DCNN_DIL = [
    ("dil_0", "batchnorm", 0),
    ("dil_1", "conv", 1),
    ("dil_2", "prelu", 2),
    ("dil_3", "batchnorm", 3),
    ("dil_4", "conv", 4),
    ("dil_5", "prelu", 5),
    ("dil_6", "batchnorm", 6),
    ("dil_7", "conv", 7),
    ("dil_8", "prelu", 8),
]
_DCNN_FC = [("fc_1", "linear", 1)]
_LCNN_CNN = [
    ("lcnn_0", "conv", 0),
    ("lcnn_3", "conv", 3),
    ("lcnn_5", "batchnorm", 5),
    ("lcnn_6", "conv", 6),
    ("lcnn_9", "batchnorm", 9),
    ("lcnn_10", "conv", 10),
    ("lcnn_12", "batchnorm", 12),
    ("lcnn_13", "conv", 13),
    ("lcnn_16", "conv", 16),
    ("lcnn_18", "batchnorm", 18),
    ("lcnn_19", "conv", 19),
    ("lcnn_21", "batchnorm", 21),
    ("lcnn_22", "conv", 22),
    ("lcnn_24", "batchnorm", 24),
    ("lcnn_25", "conv", 25),
]
_LCNN_LSTM = [("lstm_0", "lstm", 0), ("lstm_1", "lstm", 1)]
_LCNN_FC = [("fc", "linear", None)]
_LAYOUTS = {
    "dcnn": (("cnn", _DCNN_CNN), ("dil_conv", _DCNN_DIL), ("fc", _DCNN_FC)),
    "lcnn": (("lcnn", _LCNN_CNN), ("lstm", _LCNN_LSTM), ("fc", _LCNN_FC)),
    "regression": (("linear", [("linear", "linear", None)]),),
}
# the reference wraps each LSTM in a BLSTMLayer whose member is ``l_blstm``
_LSTM_PREFIX = "l_blstm."
_LSTM_NAMES = (  # (JAX BLSTMLayer parameter, nn.LSTM parameter)
    ("w_ih_fw", "weight_ih_l0"),
    ("w_hh_fw", "weight_hh_l0"),
    ("b_ih_fw", "bias_ih_l0"),
    ("b_hh_fw", "bias_hh_l0"),
    ("w_ih_bw", "weight_ih_l0_reverse"),
    ("w_hh_bw", "weight_hh_l0_reverse"),
    ("b_ih_bw", "bias_ih_l0_reverse"),
    ("b_hh_bw", "bias_hh_l0_reverse"),
)


def _kind_of(tensors: Dict[str, torch.Tensor]) -> str:
    names = set(tensors)
    if any(n.startswith(_LSTM_PREFIX + "weight_ih") for n in names):
        return "lstm"
    if "running_mean" in names:
        return "batchnorm"
    w = tensors.get("weight")
    if w is not None and w.ndim == 4:
        return "conv"
    if w is not None and w.ndim == 2:
        return "linear"
    if w is not None and w.ndim <= 1 and w.numel() == 1:
        return "prelu"
    raise ValueError(f"Unrecognised layer tensors: {sorted(names)}")


def _group_layers(
    state: StateDict, what: str
) -> Dict[str, List[Tuple[str, Dict[str, torch.Tensor]]]]:
    """Group ``block.index.name`` keys (and ``block.name`` keys of a block
    that is one module) into ordered (kind, tensors) lists."""
    blocks: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = defaultdict(
        lambda: defaultdict(dict)
    )
    for key, val in state.items():
        m = re.match(r"^(\w+)\.(\d+)\.(.+)$", key)
        if m is not None:
            blocks[m.group(1)][int(m.group(2))][m.group(3)] = val
            continue
        m = re.match(r"^(\w+)\.(\w+)$", key)
        if m is None:
            raise ValueError(f"unexpected key {key!r} in a {what} state dict")
        blocks[m.group(1)][-1][m.group(2)] = val
    return {
        block: [(_kind_of(layers[i]), layers[i]) for i in sorted(layers)]
        for block, layers in blocks.items()
    }


def _import(state: StateDict, layout: str, optional: Tuple[str, ...] = ()) -> StateDict:
    what = layout.upper()
    groups = _group_layers(strip_module_prefix(state), what)
    unknown = set(groups) - {name for name, _ in _LAYOUTS[layout]}
    if unknown:
        raise ValueError(f"unexpected {what} blocks {sorted(unknown)}")
    out: StateDict = {}
    for block, slots in _LAYOUTS[layout]:
        layers = groups.get(block)
        if layers is None:
            if block in optional:
                continue
            raise ValueError(f"{what} state dict has no {block!r} block")
        if len(layers) != len(slots):
            raise ValueError(
                f"{block}: {len(layers)} layers in the checkpoint for "
                f"{len(slots)} slots (wrong model variant?)"
            )
        for (name, kind, index), (got_kind, tensors) in zip(slots, layers):
            if got_kind != kind:
                raise ValueError(
                    f"Layer kind mismatch at {name}: expected {kind}, "
                    f"checkpoint has {got_kind}"
                )
            prefix = block if index is None else f"{block}.{index}"
            for tname, val in tensors.items():
                out[f"{prefix}.{tname}"] = val
    return out


def import_dcnn(state: StateDict) -> StateDict:
    """Re-key a DCNN state dict onto the port's Sequential indices.

    Layers are matched by their ordered kinds within each block, so both
    the current reference layout and the older coif4 arrangement load.
    Raises on a kind mismatch or on layers left over.
    """
    # DCNNxDilation has no dilated block
    return _import(state, "dcnn", optional=("dil_conv",))


def import_lcnn(state: StateDict) -> StateDict:
    """Re-key an LCNN state dict (``lcnn.N.*``, ``lstm.N.l_blstm.*``,
    ``fc.*``) onto the port's Sequential indices, matching layers by their
    ordered kinds as :func:`import_dcnn` does."""
    return _import(state, "lcnn")


def _ast_state_from_jax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The reference's trained-AST layout (the port's ``ASTModel``) from the
    JAX ``ASTModel`` params: the JAX package's ``_export_ast``."""
    out: Dict[str, np.ndarray] = {}
    kern = np.asarray(params["patch_proj"]["kernel"])  # [16, 16, C, D]
    out["v.patch_embed.proj.weight"] = np.transpose(kern, (3, 2, 0, 1))
    out["v.patch_embed.proj.bias"] = np.asarray(params["patch_proj"]["bias"])
    for name in ("cls_token", "dist_token", "pos_embed"):
        out[f"v.{name}"] = np.asarray(params[name])
    blocks = sorted(int(n.split("_")[1]) for n in params if n.startswith("block_"))
    for i in blocks:
        blk = params[f"block_{i}"]
        pre = f"v.blocks.{i}."
        for ln in ("norm1", "norm2"):
            out[pre + ln + ".weight"] = np.asarray(blk[ln]["scale"])
            out[pre + ln + ".bias"] = np.asarray(blk[ln]["bias"])
        for flax_name, torch_name in _AST_DENSE:
            out[pre + torch_name + ".weight"] = np.asarray(blk[flax_name]["kernel"]).T
            out[pre + torch_name + ".bias"] = np.asarray(blk[flax_name]["bias"])
    out["v.norm.weight"] = np.asarray(params["norm"]["scale"])
    out["v.norm.bias"] = np.asarray(params["norm"]["bias"])
    if "head_norm" in params:
        out["mlp_head.0.weight"] = np.asarray(params["head_norm"]["scale"])
        out["mlp_head.0.bias"] = np.asarray(params["head_norm"]["bias"])
        out["mlp_head.1.weight"] = np.asarray(params["head"]["kernel"]).T
        out["mlp_head.1.bias"] = np.asarray(params["head"]["bias"])
    return out


# (JAX _Block Dense, the reference's module) of every encoder block
_AST_DENSE = (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("fc1", "mlp.fc1"),
              ("fc2", "mlp.fc2"))


def import_timm_deit(
    state,
    fstride: int = 10,
    tstride: int = 10,
    input_fdim: int = 256,
    input_tdim: int = 101,
    model_size: str = "base384",
) -> StateDict:
    """A timm DeiT-distilled state dict (or a trained reference AST ``.pt``)
    as the port's ``ASTModel`` state dict.

    The reference's surgery (models.py:585-651), as the JAX package's
    ``import_timm_deit`` does it: ``module.`` and ``v.`` prefixes go, the
    patch conv is summed over its input channels to one, and the positional
    embedding's square grid is cut from the middle or bilinearly
    interpolated (``align_corners=False``) to the ``(f_dim, t_dim)`` patch
    grid, time axis first, then re-joined with the class and distillation
    embeddings.  ``mlp_head`` is kept when present (a trained AST; timm's
    ImageNet heads are dropped).
    """
    depth = _SIZES[model_size]["depth"]
    f_dim, t_dim = ast_patch_grid(fstride, tstride, input_fdim, input_tdim)
    src = {}
    for key, val in strip_module_prefix(state).items():
        src[key[len("v."):] if key.startswith("v.") else key] = val.float()

    out: StateDict = {
        "v.patch_embed.proj.weight": src["patch_embed.proj.weight"].sum(1, keepdim=True),
        "v.patch_embed.proj.bias": src["patch_embed.proj.bias"],
        "v.cls_token": src["cls_token"],
        "v.dist_token": src["dist_token"],
    }
    pos = src["pos_embed"]  # [1, 2 + P, D]
    if pos.shape[1] - 2 != f_dim * t_dim:
        hw = math.isqrt(pos.shape[1] - 2)
        grid = pos[:, 2:].reshape(1, hw, hw, -1).permute(0, 3, 1, 2)  # [1, D, F, T]
        if t_dim <= hw:
            start = hw // 2 - t_dim // 2
            grid = grid[..., start : start + t_dim]
        else:
            grid = F.interpolate(grid, size=(hw, t_dim), mode="bilinear", align_corners=False)
        if f_dim <= hw:
            start = hw // 2 - f_dim // 2
            grid = grid[:, :, start : start + f_dim]
        else:
            grid = F.interpolate(grid, size=(f_dim, t_dim), mode="bilinear", align_corners=False)
        pos = torch.cat([pos[:, :2], grid.flatten(2).transpose(1, 2)], dim=1)
    out["v.pos_embed"] = pos
    names = ["norm1", "norm2"] + [torch_name for _, torch_name in _AST_DENSE]
    for i in range(depth):
        for name in names:
            for part in ("weight", "bias"):
                key = f"blocks.{i}.{name}.{part}"
                out[f"v.{key}"] = src[key]
    for part in ("weight", "bias"):
        out[f"v.norm.{part}"] = src[f"norm.{part}"]
        for j in (0, 1):
            if f"mlp_head.{j}.{part}" in src:
                out[f"mlp_head.{j}.{part}"] = src[f"mlp_head.{j}.{part}"]
    return {k: v.contiguous().clone() for k, v in out.items()}


def state_dict_from_jax(variables: Dict[str, Any], layout: str = "dcnn") -> StateDict:
    """The port's ``state_dict`` from JAX ``{"params", "batch_stats"}``.

    ``layout`` is ``"dcnn"``, ``"lcnn"``, ``"regression"`` or ``"ast"``.  Inverse of the JAX
    package's ``import_dcnn`` / ``import_lcnn`` / ``import_timm_deit`` and
    equal, key by key and value by value, to its
    ``export_state_dict(variables, layout)``.
    """
    params = variables["params"]
    if layout == "ast":
        return {k: _owned(v) for k, v in _ast_state_from_jax(params).items()}
    batch_stats = variables.get("batch_stats", {})
    out: StateDict = {}
    for block, slots in _LAYOUTS[layout]:
        for name, kind, index in slots:
            if name not in params and name not in batch_stats:
                continue  # e.g. the dilated block of DCNNxDilation
            prefix = block if index is None else f"{block}.{index}"
            if kind == "conv":
                conv = params[name]["Conv_0"]
                kern = np.asarray(conv["kernel"])
                out[f"{prefix}.weight"] = np.transpose(kern, (3, 2, 0, 1))
                if "bias" in conv:
                    out[f"{prefix}.bias"] = np.asarray(conv["bias"])
            elif kind == "prelu":
                out[f"{prefix}.weight"] = np.asarray(params[name]["alpha"]).reshape(1)
            elif kind == "linear":
                out[f"{prefix}.weight"] = np.asarray(params[name]["kernel"]).T
                out[f"{prefix}.bias"] = np.asarray(params[name]["bias"])
            elif kind == "lstm":
                for jax_name, torch_name in _LSTM_NAMES:
                    out[f"{prefix}.{_LSTM_PREFIX}{torch_name}"] = np.asarray(
                        params[name][jax_name]
                    )
            else:  # batchnorm
                if name in params:
                    out[f"{prefix}.weight"] = np.asarray(params[name]["scale"])
                    out[f"{prefix}.bias"] = np.asarray(params[name]["bias"])
                if name not in batch_stats:  # a parameter-only tree
                    continue
                bs = batch_stats[name]
                out[f"{prefix}.running_mean"] = np.asarray(bs["mean"])
                out[f"{prefix}.running_var"] = np.asarray(bs["var"])
                out[f"{prefix}.num_batches_tracked"] = np.asarray(
                    bs["num_batches_tracked"], dtype=np.int64
                )
    return {k: _owned(v) for k, v in out.items()}


def _owned(value) -> torch.Tensor:
    """A tensor that owns its memory (not a view of the caller's array);
    bfloat16 arrays (bf16 Adam moments) come across as exact float32."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def adam_state_from_jax(
    model: nn.Module,
    optimizer: torch.optim.Adam,
    count: int,
    mu: Dict[str, Any],
    nu: Dict[str, Any],
    layout: str = "dcnn",
) -> None:
    """Install optax ``ScaleByAdamState(count, mu, nu)`` in ``optimizer``.

    ``mu`` / ``nu`` are numpy trees shaped like the JAX ``params`` of a
    model of ``layout``; they become ``exp_avg`` / ``exp_avg_sq`` of the
    matching parameter of ``model`` and ``count`` its ``step``, stored in
    the optimizer's ``moment_dtype`` where it has one (the bf16-moment Adam
    of ``train/steps.py``; its ``scale_by_adam_lowp`` state).
    ``optimizer`` must hold exactly ``model``'s parameters.
    """
    exp_avg = state_dict_from_jax({"params": mu}, layout)
    exp_avg_sq = state_dict_from_jax({"params": nu}, layout)
    names = {id(p): name for name, p in model.named_parameters()}
    blob = optimizer.state_dict()
    state = {}
    index = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            moment = dict(device=p.device, dtype=getattr(optimizer, "moment_dtype", p.dtype))
            state[index] = {
                "step": torch.tensor(float(count)),
                "exp_avg": exp_avg[name].to(**moment).reshape(p.shape),
                "exp_avg_sq": exp_avg_sq[name].to(**moment).reshape(p.shape),
            }
            index += 1
    blob["state"] = state
    optimizer.load_state_dict(blob)
