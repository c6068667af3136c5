"""String-defined "grid model": parse layer-spec strings into ``nn.Module``s.

Counterpart of ``audiodeepfake_detection_tpu/models/gridmodel.py`` (the
reference's ``GridModelWrapper`` + ``parse_model*`` + ``parse_sequential``,
src/audiofakedetect/models.py:39-65, 768-1018).  A model is described as a
list of blocks; each block has a ``layers`` list of strings like
``"Conv2d 1 [64,32,128] 2 1 2"`` where a bracketed list means "one variant
per entry" -- the parser expands the grid of variants; inter-block
``transforms`` are callables applied between blocks.

Layer vocabulary (torch's own, so each token is one module):
``Conv2d in out k [stride [padding]]``, ``MaxPool2d k s``,
``SyncBatchNorm n [eps [momentum [affine]]]`` and ``BatchNorm2d`` with the
same positional arguments (both ``nn.BatchNorm2d``; under a mesh the factory
makes each the port's synchronized BatchNorm, ``layers.use_mesh``),
``Dropout p``, ``Linear in out``, ``ReLU``, ``PReLU``, ``Softmax dim``,
``LogSoftmax dim``, ``Flatten [start]``, ``MaxFeatureMap2D``,
``BLSTMLayer in out``, ``Permute a,b,c,d``.
"""

from __future__ import annotations

import ast
from copy import copy
from typing import Any, Callable, List, Sequence, Tuple

import torch
from torch import nn

from .layers import BLSTMLayer, MaxFeatureMap2D


def _layer_alternatives(element) -> List[Any]:
    """All alternatives of ONE layer spec, as normalized token lists.

    A spec is a string ``"Conv2d 1 [64,32] 3"`` (bracketed lists mean "one
    alternative per entry"; all lists in a spec must agree in length) or a
    ``[wrapper, ..., spec]`` pair whose wrapper object is carried through
    untouched.  Tokens are normalized to whitespace-free strings.
    """
    wrapper = None
    if isinstance(element, list):
        wrapper, element = element[0], element[-1]
    if not isinstance(element, str):
        raise RuntimeError(f"Model string invalid at {element}.")
    head, *rest = element.split()
    tokens: List[Any] = [head] + [ast.literal_eval(tok) for tok in rest]
    width = next((len(t) for t in tokens if isinstance(t, list)), 1)

    alternatives = []
    for i in range(width):
        entry: List[str] = []
        for tok in tokens:
            if isinstance(tok, list):
                if len(tok) != width:
                    raise RuntimeError(
                        "Model layers must contain the same amount of "
                        f"elements. Expected {width}, but got {len(tok)}."
                    )
                tok = tok[i]
            entry.append(str(tok).replace(" ", ""))
        alternatives.append([wrapper, entry] if wrapper is not None else entry)
    return alternatives


def parse_model_str(model_str: list) -> list:
    """Expand bracketed alternatives into per-variant layer lists.

    Expansion semantics match the reference contract (models.py:875-966,
    verified against it by oracle tests): alternatives are *zipped*, not
    crossed — variant ``i`` takes the ``i``-th alternative of every
    multi-alternative layer; single-alternative layers go into every
    variant; when a layer introduces more variants than currently exist,
    the new variants start from a snapshot of the last variant's prefix.
    """
    variants: List[list] = []
    for element in model_str:
        alternatives = _layer_alternatives(element)
        if len(alternatives) == 1:
            if variants:
                for variant in variants:
                    variant.append(alternatives[0])
            else:
                variants = [[alternatives[0]]]
            continue
        prefix = copy(variants[-1]) if variants else []
        for i, alt in enumerate(alternatives):
            if i < len(variants):
                variants[i].append(alt)
            else:
                variants.append(list(prefix) + [alt])
    return variants


def parse_model(model_data: list) -> list:
    """Expand every config's per-block layer grids, in place.

    Each config keeps the first variant of every block; further variants
    spawn sibling configs which are appended to ``model_data``.  Variant
    counts are zipped across blocks (mismatched counts beyond the first
    occurrence raise), matching the reference contract (models.py:850-872,
    oracle-tested).
    """
    for config in list(model_data):
        siblings: List[list] = []
        for j, block in enumerate(config):
            trials = parse_model_str(block["layers"])
            block["layers"] = trials[0]
            if len(trials) == 1:
                for sibling in siblings:
                    sibling[j]["layers"] = trials[0]
                continue
            for k, alt in enumerate(trials[1:]):
                if len(siblings) < len(trials) - 1:
                    clone = [dict(b) for b in config]
                    clone[j]["layers"] = alt
                    siblings.append(clone)
                elif len(siblings) == len(trials) - 1:
                    siblings[k][j]["layers"] = alt
                else:
                    raise RuntimeError("Parsing error")
        model_data.extend(siblings)
    return model_data


class Permute(nn.Module):
    """``x.permute(dims)`` as a layer."""

    def __init__(self, dims: Sequence[int]) -> None:
        super().__init__()
        self.dims = tuple(int(d) for d in dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(self.dims)


def _permute_dims(token: str) -> List[int]:
    """The dims token may be ``"0,2,1,3"`` or the literal_eval'd round trip
    ``"(0, 2, 1, 3)"``."""
    token = str(token).strip()
    try:
        return [int(d) for d in ast.literal_eval(token)]
    except (ValueError, SyntaxError, TypeError):
        return [int(d) for d in token.strip("()[]").split(",") if d]


def build_layer(spec: Tuple[str, ...]) -> nn.Module:
    """One parsed layer spec ``(kind, arg, ...)`` as a module."""
    kind = spec[0]
    if kind == "Permute":
        return Permute(_permute_dims(spec[1]))
    args = [ast.literal_eval(a) for a in spec[1:]]
    if kind == "Conv2d":
        stride = args[3] if len(args) > 3 else 1
        padding = args[4] if len(args) > 4 else 0
        return nn.Conv2d(args[0], args[1], args[2], stride=stride, padding=padding)
    if kind == "MaxPool2d":
        return nn.MaxPool2d(args[0], args[1] if len(args) > 1 else args[0])
    if kind in ("SyncBatchNorm", "BatchNorm2d"):
        # torch positional vocabulary: (num_features, eps, momentum, affine)
        return nn.BatchNorm2d(
            int(args[0]),
            eps=float(args[1]) if len(args) > 1 else 1e-5,
            momentum=float(args[2]) if len(args) > 2 else 0.1,
            affine=bool(args[3]) if len(args) > 3 else True,
        )
    if kind == "Dropout":
        return nn.Dropout(float(args[0]))
    if kind == "Linear":
        return nn.Linear(int(args[0]), int(args[1]))
    if kind == "ReLU":
        return nn.ReLU()
    if kind == "PReLU":
        return nn.PReLU()
    if kind == "Softmax":
        return nn.Softmax(dim=int(args[0]) if args else -1)
    if kind == "LogSoftmax":
        return nn.LogSoftmax(dim=int(args[0]) if args else -1)
    if kind == "Flatten":
        return nn.Flatten(int(args[0]) if args else 1)
    if kind == "MaxFeatureMap2D":
        return MaxFeatureMap2D()
    if kind == "BLSTMLayer":
        return BLSTMLayer(int(args[0]), int(args[1]))
    raise RuntimeError(f"Given layer type {kind} not found.")


def _normalize_spec(layer) -> Tuple[str, ...]:
    if isinstance(layer, list) and layer and not isinstance(layer[0], str):
        # [module, [name, args...]] form (e.g. torchvision.ops Permute)
        layer = layer[1]
    if isinstance(layer, list):
        return tuple(str(p) for p in layer)
    return tuple(str(layer).split())


class GridModelWrapper(nn.Module):
    """Sequential blocks with transforms in between (reference
    models.py:39-65).  ``blocks[i][j]`` is layer ``j`` of block ``i``."""

    def __init__(
        self,
        blocks: Sequence[Sequence[Tuple[str, ...]]],
        transforms: Sequence[Sequence[Callable]] = (),
    ) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.Sequential(*(build_layer(spec) for spec in block)) for block in blocks
        )
        self.transforms = tuple(tuple(fns) for fns in transforms)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i < len(self.transforms):
                for fn in self.transforms[i]:
                    x = fn(x)
        return x

    def get_name(self) -> str:
        return "GridModel"


def get_gridsearch_model(model_data: list) -> GridModelWrapper:
    """Build the first expanded variant as a module (reference
    models.py:768-807)."""
    model_data = parse_model([list(md) for md in model_data])
    variant = model_data[0]
    blocks = [
        tuple(_normalize_spec(s) for s in block_cfg["layers"]) for block_cfg in variant
    ]
    transforms = [tuple(block_cfg.get("transforms", ())) for block_cfg in variant]
    return GridModelWrapper(blocks, transforms)
