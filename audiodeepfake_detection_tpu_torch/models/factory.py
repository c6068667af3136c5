"""Model factory: experiment config -> ``nn.Module``.

Counterpart of ``audiodeepfake_detection_tpu/models/factory.py`` (reference
``get_model``, src/audiofakedetect/models.py:710-765) with the same
model-name vocabulary:

* ``"lcnn"``      -- LCNN with ``lstm_channels`` derived from the feature mode
                    (doubledelta 60 / delta 40 / lfcc 20 / else num_of_scales);
* ``"gridmodel"`` -- string-defined model from ``args.model_data``;
* ``"modules"``   -- a DCNN-family class, ``AST`` / ``ASTModel`` or
                    ``Regression`` named by ``args.module`` (a string name
                    or a callable).

``dtype: bfloat16`` reaches the DCNN family, the LCNN and the AST, as in the
JAX package; the grid model is built in float32 under it, as the JAX
package builds it (its ``get_gridsearch_model`` takes no dtype).

``mesh`` (``parallel/mesh.py``) reaches the DCNN family and the LCNN, as in
the JAX package, and under it every model's ``nn.BatchNorm2d`` (the grid
model's ``SyncBatchNorm`` / ``BatchNorm2d`` too) becomes the port's
synchronized BatchNorm (``layers.use_mesh``), which takes the global
batch's moments on the CPU as on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.config import DotDict
from .ast import ASTModel
from .dcnn import DCNN
from .gridmodel import get_gridsearch_model
from .layers import use_mesh
from .lcnn import LCNN
from .regression import Regression

_MODULE_REGISTRY = {
    "DCNN": dict(with_dropout=True, with_dilation=True),
    "DCNNxDropout": dict(with_dropout=False, with_dilation=True),
    "DCNNxDilation": dict(with_dropout=True, with_dilation=False),
}


def _tri_flag(value):
    """Tri-state fused-kernel flag: False / True (train-only) / "always".

    Config files are .py/.json dicts, so string spellings are the expected
    vocabulary: "always" keeps the force-in-eval mode, and the explicit
    off-spellings map to False instead of the truthy-string trap
    ``bool("off") == True``.
    """
    s = str(value).strip().lower()
    if s == "always":
        return "always"
    if s in ("off", "false", "no", "none", "0", ""):
        return False
    if s in ("train", "on", "true", "yes", "1"):
        return True
    return bool(value)


def _compute_dtype(args: DotDict):
    """The compute type of ``args.dtype``: ``None`` (float32) or
    ``torch.bfloat16``."""
    dtypes = {"float32": None, "bfloat16": torch.bfloat16}
    key = str(args.dtype or "float32")
    if key not in dtypes:
        raise ValueError(f"dtype must be float32 or bfloat16: {args.dtype!r}")
    return dtypes[key]


def _build_ast(args: DotDict, nclasses: int) -> ASTModel:
    """The AST through ``get_model``, with the JAX package's geometry rule
    (its factory.py ``_build_ast``; reference models.py:497-536):
    ``input_fdim`` is the probed ``input_dim[-2]`` (256 without one),
    ``input_tdim`` is ``flattend_size`` (the reference repurposes that key),
    else the probed ``input_dim[-1]``, else 101.  ``ast_model_size`` /
    ``ast_drop_*`` / ``ast_fused_attention`` / ``ast_remat`` /
    ``ast_remat_policy`` reach the constructor (which refuses a policy name
    it does not support)."""
    input_dim = args.input_dim
    input_fdim = int(input_dim[-2]) if input_dim else 256
    if args.flattend_size:
        input_tdim = int(args.flattend_size)
    elif input_dim:
        input_tdim = int(input_dim[-1])
    else:
        input_tdim = 101
    return ASTModel(
        label_dim=nclasses,
        input_fdim=input_fdim,
        input_tdim=input_tdim,
        model_size=str(args.ast_model_size or "base384"),
        drop_rate=float(args.ast_drop_rate or 0.0),
        attn_drop_rate=float(args.ast_attn_drop_rate or 0.0),
        drop_path_rate=float(args.ast_drop_path_rate or 0.0),
        fused_attention=bool(args.ast_fused_attention),
        remat_blocks=bool(args.ast_remat),
        remat_policy=args.ast_remat_policy or None,
        dtype=_compute_dtype(args),
    )


def _build_dcnn(args: DotDict, variant: str, nclasses: int, in_channels: int,
                mesh=None) -> DCNN:
    time_dim = int(args.input_dim[-1]) // 8 + int(args.time_dim_add or 0)
    return DCNN(
        dtype=_compute_dtype(args),
        mesh=mesh,
        fused_layer1=_tri_flag(args.fused_layer1),
        fused_pool=_tri_flag(args.fused_pool),
        fused_layer2=_tri_flag(args.fused_layer2),
        in_channels=in_channels,
        ochannels1=args.ochannels1 or 64,
        ochannels2=args.ochannels2 or 64,
        ochannels3=args.ochannels3 or 96,
        ochannels4=args.ochannels4 or 128,
        ochannels5=args.ochannels5 or 32,
        kernel1=args.kernel1 or 3,
        time_dim=time_dim,
        flattend_size=args.flattend_size or 320,
        dropout_cnn=args.dropout_cnn if args.dropout_cnn is not None else 0.6,
        dropout_lstm=args.dropout_lstm if args.dropout_lstm is not None else 0.2,
        nclasses=nclasses,
        **_MODULE_REGISTRY[variant],
    )


def get_model(
    args: DotDict,
    model_name: str,
    nclasses: int = 2,
    in_channels: int = 1,
    lead: bool = False,
    mesh=None,
) -> nn.Module:
    """Build the model named by ``model_name`` from the experiment config
    (on ``mesh``, when one is given)."""
    model = _get_model(args, model_name, nclasses, in_channels, lead, mesh)
    return model if mesh is None else use_mesh(model, mesh)


def _get_model(args: DotDict, model_name: str, nclasses: int, in_channels: int,
               lead: bool, mesh) -> nn.Module:
    if model_name == "lcnn":
        features = args.features or "none"
        if "doubledelta" in features:
            lstm_channels = 60
        elif "delta" in features:
            lstm_channels = 40
        elif "lfcc" in features:
            lstm_channels = 20
        else:
            lstm_channels = int(args.num_of_scales)
        return LCNN(
            classes=nclasses,
            in_channels=in_channels,
            lstm_channels=lstm_channels,
            fused_layer1=_tri_flag(args.fused_layer1),
            dtype=_compute_dtype(args),
            mesh=mesh,
        )
    if model_name == "gridmodel":
        if args.model_data is None:
            raise RuntimeError(
                "Config dict does not contain the key model_data,"
                "which should hold the list like model structure."
            )
        return get_gridsearch_model(args.model_data)
    if model_name == "modules":
        module = args.module
        if callable(module) and not isinstance(module, str):
            name = getattr(module, "__name__", None) or str(module)
        else:
            name = str(module)
        if name in _MODULE_REGISTRY:
            model = _build_dcnn(args, name, nclasses, in_channels, mesh)
        elif name in ("AST", "ASTModel"):
            model = _build_ast(args, nclasses)
        elif name == "Regression":
            model = Regression(nclasses=nclasses)
        elif callable(module):
            model = module(args)
        else:
            raise RuntimeError(f"Unknown module {name!r}.")
        # The reference validates modular models against the probed input
        # shape before accepting them (models.py:760-762)
        if args.input_dim is not None and not check_dimensions(
            model, tuple(args.input_dim[1:]), verbose=lead
        ):
            raise RuntimeError("Model not valid.")
        return model
    raise RuntimeError(f"Model with model string '{model_name}' does not exist.")


def compute_parameter_total(model: nn.Module) -> int:
    """Count trainable parameters (reference models.py:20-36)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def check_dimensions(model: nn.Module, input_shape, verbose: bool = True) -> bool:
    """Validate a model against an input shape (reference models.py:
    1006-1018): one frame of zeros through the model in eval mode, on the
    device its parameters lie on; the model's mode is restored."""
    was_training = model.training
    try:
        param = next(model.parameters(), None)
        device = param.device if param is not None else "cpu"
        x = torch.zeros((1, *input_shape), dtype=torch.float32, device=device)
        model.eval()
        with torch.no_grad():
            out = model(x)
        if verbose:
            print(f"model ok: input {tuple(x.shape)} -> output {tuple(out.shape)}")
        return True
    except (RuntimeError, ValueError) as exc:
        if verbose:
            print(f"Error: {exc}")
        return False
    finally:
        model.train(was_training)
