"""Carry DCNN weights across: reference ``.pt`` snapshots and JAX variables.

Counterpart of ``audiodeepfake_detection_tpu/models/torch_import.py``.  The
port's modules use the reference ``nn.Sequential`` layout, so a snapshot in
the current reference layout loads directly; two things still need a
translation step:

* **older snapshots.**  The bundled coif4 checkpoint uses other Sequential
  indices than the stft/sym5 ones (an older layer arrangement), so
  :func:`import_dcnn` matches layers by their *ordered kind sequence*
  (conv / prelu / batchnorm / linear) within each block (``cnn`` /
  ``dil_conv`` / ``fc``) instead of by index, and re-keys them onto the
  port's indices.
* **JAX variables.**  :func:`state_dict_from_jax` turns the JAX package's
  ``{"params", "batch_stats"}`` tree (numpy arrays) into the port's
  ``state_dict``: conv ``[kh, kw, I, O] -> [O, I, kh, kw]``, linear
  ``[in, out] -> [out, in]``, PReLU ``() -> [1]``, ``num_batches_tracked``
  int32 -> int64.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

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


def strip_module_prefix(state) -> StateDict:
    """Drop any number of leading ``module.`` prefixes from every key."""
    out = {}
    for key, val in state.items():
        while key.startswith("module."):
            key = key[len("module.") :]
        out[key] = torch.as_tensor(val).detach().cpu()
    return out


# (flax name, kind, port Sequential index) per block, in forward order
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
_DCNN_BLOCKS = (("cnn", _DCNN_CNN), ("dil_conv", _DCNN_DIL), ("fc", _DCNN_FC))


def _kind_of(tensors: Dict[str, torch.Tensor]) -> str:
    names = set(tensors)
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
    state: StateDict,
) -> Dict[str, List[Tuple[str, Dict[str, torch.Tensor]]]]:
    """Group ``block.index.name`` keys into ordered (kind, tensors) lists."""
    blocks: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = defaultdict(
        lambda: defaultdict(dict)
    )
    for key, val in state.items():
        m = re.match(r"^(\w+)\.(\d+)\.(.+)$", key)
        if m is None:
            raise ValueError(f"unexpected key {key!r} in a DCNN state dict")
        blocks[m.group(1)][int(m.group(2))][m.group(3)] = val
    return {
        block: [(_kind_of(layers[i]), layers[i]) for i in sorted(layers)]
        for block, layers in blocks.items()
    }


def import_dcnn(state: StateDict) -> StateDict:
    """Re-key a DCNN state dict onto the port's Sequential indices.

    Layers are matched by their ordered kinds within each block, so both
    the current reference layout and the older coif4 arrangement load.
    Raises on a kind mismatch or on layers left over.
    """
    groups = _group_layers(strip_module_prefix(state))
    unknown = set(groups) - {name for name, _ in _DCNN_BLOCKS}
    if unknown:
        raise ValueError(f"unexpected DCNN blocks {sorted(unknown)}")
    out: StateDict = {}
    for block, slots in _DCNN_BLOCKS:
        layers = groups.get(block)
        if layers is None:
            if block == "dil_conv":  # DCNNxDilation has no dilated block
                continue
            raise ValueError(f"DCNN state dict has no {block!r} block")
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
            for tname, val in tensors.items():
                out[f"{block}.{index}.{tname}"] = val
    return out


def state_dict_from_jax(variables: Dict[str, Any]) -> StateDict:
    """The port's DCNN ``state_dict`` from JAX ``{"params", "batch_stats"}``.

    Inverse of the JAX package's ``import_dcnn`` and equal, key by key and
    value by value, to its ``export_state_dict(variables, "dcnn")``.
    """
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    out: StateDict = {}
    for block, slots in _DCNN_BLOCKS:
        for name, kind, index in slots:
            if name not in params and name not in batch_stats:
                continue  # e.g. the dilated block of DCNNxDilation
            prefix = f"{block}.{index}"
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
            else:  # batchnorm
                bs = batch_stats[name]
                if name in params:
                    out[f"{prefix}.weight"] = np.asarray(params[name]["scale"])
                    out[f"{prefix}.bias"] = np.asarray(params[name]["bias"])
                out[f"{prefix}.running_mean"] = np.asarray(bs["mean"])
                out[f"{prefix}.running_var"] = np.asarray(bs["var"])
                out[f"{prefix}.num_batches_tracked"] = np.asarray(
                    bs["num_batches_tracked"], dtype=np.int64
                )
    # copy: the tensors must own their memory, not view the caller's arrays
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
