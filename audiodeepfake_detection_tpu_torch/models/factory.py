"""Model factory: experiment config -> ``nn.Module``.

Counterpart of ``audiodeepfake_detection_tpu/models/factory.py`` (reference
``get_model``, src/audiofakedetect/models.py:710-765) with the same
model-name vocabulary.  Ported so far: ``"modules"`` with a DCNN-family
class named by ``args.module`` (a string name or a callable).  ``"lcnn"``,
``"gridmodel"``, the AST and ``Regression`` raise ``NotImplementedError``
naming the ROADMAP slice that brings them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.config import DotDict
from .dcnn import DCNN

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


def _build_dcnn(args: DotDict, variant: str, nclasses: int, in_channels: int) -> DCNN:
    if str(args.dtype or "float32") != "float32":
        raise NotImplementedError(
            f"dtype={args.dtype!r} (the bf16 autocast mode) is not ported "
            "yet (ROADMAP.md queue 1, slice 5: AST)"
        )
    for flag in ("fused_pool", "fused_layer2"):
        if _tri_flag(args.get(flag)):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md queue 2: TPU kernels "
                "to port)"
            )
    time_dim = int(args.input_dim[-1]) // 8 + int(args.time_dim_add or 0)
    return DCNN(
        fused_layer1=_tri_flag(args.fused_layer1),
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
) -> nn.Module:
    """Build the model named by ``model_name`` from the experiment config."""
    if model_name == "lcnn":
        raise NotImplementedError(
            "the LCNN is not ported yet (ROADMAP.md queue 1, slice 4: LCNN)"
        )
    if model_name == "gridmodel":
        raise NotImplementedError(
            "string-defined grid models are not ported yet (ROADMAP.md "
            "queue 1, slice 4: LCNN)"
        )
    if model_name == "modules":
        module = args.module
        if callable(module) and not isinstance(module, str):
            name = getattr(module, "__name__", None) or str(module)
        else:
            name = str(module)
        if name in _MODULE_REGISTRY:
            model = _build_dcnn(args, name, nclasses, in_channels)
        elif name in ("AST", "ASTModel"):
            raise NotImplementedError(
                "the AST is not ported yet (ROADMAP.md queue 1, slice 5: AST)"
            )
        elif name == "Regression":
            raise NotImplementedError(
                "the Regression model is not ported yet (ROADMAP.md queue 1, "
                "slice 4: LCNN)"
            )
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
