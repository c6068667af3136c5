"""Batched inference: score audio clips with a trained model.

Counterpart of ``audiodeepfake_detection_tpu/train/predict.py``: one scoring
function ``audio -> P(fake)`` on an explicit device, plus a file-level
convenience that handles decode, framing, resampling and aggregation over
frames, and the snapshot loader that rebuilds a scorer from a
config-encoded ``.pt``.  Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

#: dispatches enqueued on the device before the oldest result is fetched:
#: enqueueing ahead keeps the device busy, but enqueueing a whole corpus
#: would hold every input buffer in device memory
MAX_INFLIGHT = 8


def resolve_device(device: torch.device | str) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for but absent.

    There is no silent CPU fallback: a caller that wants the CPU says so.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to score on the CPU"
        )
    return device


def make_score_fn(
    model: nn.Module,
    transform: Callable,
    device: torch.device | str,
    output: str = "prob",
    chunk: int = 0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``[B, 1, T] audio -> [B]`` scorer on ``device``.

    The model moves to ``device`` in eval mode.  The returned function
    takes float or int16 PCM audio on any device (a pinned host tensor is
    copied without blocking) and returns the scores on ``device`` without
    synchronising.

    ``output``: ``"prob"`` = ``P(fake)`` (softmax); ``"margin"`` = the raw
    fake-real logit margin — monotone in ``P(fake)`` but unsaturated.

    ``chunk``: run the model over microbatches of that size inside one
    call.  It must divide the batch; a chunk of 0 (the default) or of at
    least the batch runs the whole batch at once, which on the H100 beats
    every chunk for the AST too (the JAX package's AST chunk of 32 avoids a
    TPU memory knee; PERF.md).
    """
    if output not in ("prob", "margin"):
        raise ValueError(f"output must be prob or margin: {output!r}")
    device = resolve_device(device)
    model = model.to(device).eval()

    def score(audio: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            audio = torch.as_tensor(audio).to(device, non_blocking=True)
            return score_batch(model, transform, audio, output, chunk)

    return score


def score_batch(
    model: nn.Module,
    transform: Callable,
    audio: torch.Tensor,
    output: str = "prob",
    chunk: int = 0,
) -> torch.Tensor:
    """The body of :func:`make_score_fn`'s scorer, and of the exported one
    (``train/export.py``): ``[B, 1, T]`` audio on the model's device ->
    ``[B]`` scores, the model in whatever mode it is in."""
    from .steps import audio_to_float

    image = transform(audio_to_float(audio))
    b = image.shape[0]
    if chunk and chunk < b:
        if b % chunk:
            raise ValueError(f"chunk={chunk} does not divide the batch of {b}")
        logits = torch.cat([model(g) for g in image.split(chunk)])
    else:
        logits = model(image)
    if output == "margin":
        return logits[:, 1] - logits[:, 0]
    return torch.softmax(logits, dim=-1)[:, 1]


def _frames_of(path: str, sample_rate: int, win: int) -> List[np.ndarray]:
    """Decode, downsample to ``sample_rate`` and cut into ``win`` frames."""
    from ..data.wavio import audio_read
    from ..ops.audio import resample

    audio, sr = audio_read(path)
    if sr > sample_rate:
        audio = resample(audio, sr, sample_rate)
    elif sr < sample_rate:
        raise RuntimeError(
            "Sample rate is smaller than desired sample rate. "
            "No upsampling possible here."
        )
    return [audio[i * win : (i + 1) * win] for i in range(len(audio) // win)]


def score_files(
    model: nn.Module,
    transform: Callable,
    paths: Sequence[str],
    device: torch.device | str,
    sample_rate: int = 22050,
    seconds: float = 1.0,
    batch_size: int = 128,
    aggregate: str = "mean",
    self_norm: bool = False,
    output: str = "prob",
    chunk: int = 0,
    int8: bool = False,
) -> Dict[str, float]:
    """Per-file fake probability (or logit margin), aggregated over frames.

    ``self_norm`` estimates the per-channel normalization mean/std from the
    scored frames themselves (one extra transform pass) — an approximation
    of the training-corpus Welford stats for snapshots that ship without a
    ``*_mean_std.pkl``.

    ``int8`` quantizes the model post-training (``ops/quantize.py``): its
    activation scales calibrated on at most 4 batches of the scored frames,
    its weights baked once (:func:`quantize_for_scoring`).
    """
    device = resolve_device(device)
    win = int(seconds * sample_rate)
    frames: List[np.ndarray] = []
    owners: List[int] = []
    for fi, path in enumerate(paths):
        clip = _frames_of(path, sample_rate, win)
        frames += clip
        owners += [fi] * len(clip)
    if not frames:
        return {}

    if self_norm:
        from .transforms import compute_normalization, normalized_transform

        def _batches():
            for start in range(0, len(frames), batch_size):
                yield np.stack(frames[start : start + batch_size])[:, None, :]

        with torch.inference_mode():
            probe = transform(
                torch.as_tensor(frames[0][None, None, :], device=device)
            )
        mean, std = compute_normalization(
            transform, _batches(), probe.shape[1], device
        )
        transform = normalized_transform(transform, mean, std)

    if int8:
        model = quantize_for_scoring(model, transform, frames, device, batch_size)
    score = make_score_fn(model, transform, device, output=output, chunk=chunk)
    scores = np.zeros(len(frames), np.float32)
    outs: list = []

    def drain(until: int) -> None:
        while len(outs) > until:
            start, n, out = outs.pop(0)
            scores[start : start + n] = out.cpu().numpy()[:n]

    for start in range(0, len(frames), batch_size):
        part = frames[start : start + batch_size]
        # pinned when bound for a GPU: the copy then does not block the host
        batch = torch.zeros(
            (batch_size, 1, win), pin_memory=device.type == "cuda"
        )
        batch[: len(part), 0] = torch.from_numpy(np.stack(part))
        outs.append((start, len(part), score(batch)))
        drain(MAX_INFLIGHT)
    drain(0)

    owners_arr = np.asarray(owners)
    agg = np.mean if aggregate == "mean" else np.max
    return {
        paths[fi]: float(agg(scores[owners_arr == fi]))
        for fi in np.unique(owners_arr)
    }


def quantize_for_scoring(
    model: nn.Module,
    transform: Callable,
    frames: Sequence[np.ndarray],
    device: torch.device | str,
    batch_size: int,
    max_batches: int = 4,
) -> nn.Module:
    """The int8 scorer of ``model``: calibrated on the transform of at most
    ``max_batches`` batches of ``frames``, its weights baked from the first
    batch (the JAX package's ``quantize_model`` + ``bake_int8_weights``).
    The DCNN family quantizes its six front convs (``DEFAULT_INT8_SITES``),
    the LCNN its nine convs and the AST its block matmuls (every observed
    site); other models raise.  ``model`` moves to ``device`` in eval mode
    and is otherwise left as it was."""
    from ..models.dcnn import DCNN
    from ..ops.quantize import DEFAULT_INT8_SITES, bake_int8_weights, quantize_model

    if not hasattr(model, "quant"):
        raise ValueError(
            "int8 scoring supports the DCNN, LCNN and AST families only "
            f"(got {type(model).__name__})"
        )
    device = resolve_device(device)
    model = model.to(device).eval()
    include = DEFAULT_INT8_SITES if isinstance(model, DCNN) else None

    def images(n: int):
        with torch.no_grad():
            for start in range(0, min(len(frames), n * batch_size), batch_size):
                chunk = np.stack(frames[start : start + batch_size])[:, None, :]
                yield transform(torch.from_numpy(chunk).to(device))

    qmodel, _ = quantize_model(model, images(max_batches), include=include)
    return bake_int8_weights(qmodel, next(images(1)))


# --------------------------------------------------------------------- CLI


def build_scorer_from_snapshot(
    snapshot: str,
    norm: "str | None" = None,
    mean=None,
    std=None,
    log_scale: bool = True,
    expect_self_norm: bool = False,
    use_kernel: bool = True,
):
    """Rebuild ``(model, normalized transform, cfg)`` from a snapshot.

    The snapshot filename encodes the experiment configuration (decoded by
    ``utils.naming.parse_model_file``); a DCNN's ``time_dim`` and
    ``flattend_size`` are recovered from the tensors, an LCNN's width from
    the encoded features and ``num_of_scales``.  ``norm`` names the ``*_mean_std.pkl``
    written at training time; without it, a ``<snapshot>.norm.pkl``
    sidecar is used when present, and otherwise scoring runs
    UN-normalized (with a warning).  The model comes back on the CPU in
    eval mode; ``make_score_fn`` moves it.  ``use_kernel=False`` builds
    the transform on the plain PyTorch wavelet-packet cascade (what the
    CUDA kernel is timed against).
    """
    from ..models.dcnn import DCNN
    from ..models.factory import get_model
    from ..models.torch_import import import_dcnn, import_lcnn, load_torch_state_dict
    from ..utils.config import default_config
    from ..utils.naming import parse_model_file
    from .transforms import make_transform, normalized_transform

    cfg = default_config()
    cfg.update(parse_model_file(snapshot))
    cfg.log_scale = log_scale
    name = cfg.model_name
    if name != "LCNN" and not name.startswith("DCNN"):
        raise ValueError(
            f"snapshot model {name!r} has no standalone-scoring support "
            "(DCNN family and LCNN checkpoints are)"
        )
    base = make_transform(cfg, use_kernel=use_kernel)

    if norm is None and mean is None and std is None:
        sidecar = snapshot + ".norm.pkl"
        if os.path.exists(sidecar):
            norm = sidecar
    if norm is not None:
        with open(norm, "rb") as fh:
            mean, std = pickle.load(fh)
    if mean is not None and std is not None:
        transform = normalized_transform(
            base,
            np.asarray(mean, np.float32),
            np.asarray(std, np.float32),
        )
    else:
        if not expect_self_norm:
            warnings.warn(
                "no normalization stats (--norm/--mean/--std/--self-norm): "
                "scoring un-normalized inputs; probabilities will be shifted "
                "vs the training-time pipeline"
            )
        transform = base

    if name == "LCNN":
        model = get_model(cfg, "lcnn")
        model.load_state_dict(import_lcnn(load_torch_state_dict(snapshot)), strict=True)
        return model.eval(), transform, cfg
    state = import_dcnn(load_torch_state_dict(snapshot))
    kw = {"flattend_size": int(state["fc.1.weight"].shape[1])}
    if cfg.loss_less == "True":
        kw["in_channels"] = 2  # sign channel (reference wavelet_math.py:212)
    if "dil_conv.1.weight" in state:
        kw["time_dim"] = int(state["dil_conv.1.weight"].shape[1])
    else:
        kw["with_dilation"] = False
    if name == "DCNNxDropout":
        kw["with_dropout"] = False
    model = DCNN(**kw)
    model.load_state_dict(state, strict=True)
    return model.eval(), transform, cfg


def estimate_norm_stats(
    snapshot: str,
    paths: Sequence[str],
    device: torch.device | str,
    out: "str | None" = None,
    batch_size: int = 64,
):
    """Welford per-channel mean/std of the snapshot's own transform over
    ``paths`` (the estimator training uses); optionally written as the
    snapshot's ``.norm.pkl`` sidecar.  Returns ``(mean, std)``."""
    from .transforms import compute_normalization

    device = resolve_device(device)
    _, base, cfg = build_scorer_from_snapshot(snapshot, expect_self_norm=True)
    sr, win = int(cfg.sample_rate), int(cfg.sample_rate * cfg.seconds)
    frames: List[np.ndarray] = []
    for path in _expand_inputs(paths):
        frames += _frames_of(path, sr, win)
    if not frames:
        raise ValueError("no full frames decodable from the given paths")

    def _batches():
        for s in range(0, len(frames), batch_size):
            yield np.stack(frames[s : s + batch_size])[:, None, :]

    with torch.inference_mode():
        probe = base(torch.as_tensor(frames[0][None, None, :], device=device))
    mean, std = compute_normalization(base, _batches(), probe.shape[1], device)
    if out is not None:
        with open(out, "wb") as fh:
            pickle.dump([mean, std], fh)
    return mean, std


def _expand_inputs(inputs) -> list:
    """Audio files from a mix of file and directory arguments."""
    exts = (".wav", ".flac")
    out = []
    for item in inputs:
        if os.path.isdir(item):
            out += sorted(
                os.path.join(item, f)
                for f in os.listdir(item)
                if f.lower().endswith(exts)
            )
        else:
            out.append(item)
    return out


def main(argv=None) -> None:
    """Score audio files with a trained snapshot: ``P(fake)`` per file."""
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="Score audio files with a trained deepfake detector"
    )
    parser.add_argument("snapshot", help=".pt snapshot (config-encoded name)")
    parser.add_argument("inputs", nargs="+", help="audio files or directories")
    parser.add_argument(
        "--norm", default=None, help="*_mean_std.pkl from training"
    )
    parser.add_argument("--mean", type=float, nargs="+", default=None)
    parser.add_argument("--std", type=float, nargs="+", default=None)
    parser.add_argument(
        "--aggregate", choices=["mean", "max"], default="mean",
        help="frame-score aggregation per file",
    )
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument(
        "--no-log-scale", action="store_true",
        help="snapshot was trained without log scaling (not filename-encoded)",
    )
    parser.add_argument(
        "--self-norm", action="store_true",
        help="estimate normalization stats from the scored files "
        "(approximation for snapshots without a *_mean_std.pkl)",
    )
    parser.add_argument(
        "--int8", action="store_true",
        help="post-training int8 quantization, calibrated on the first "
        "scored batches (DCNN, LCNN and AST families)",
    )
    parser.add_argument(
        "--chunk", type=int, default=0,
        help="run the model over microbatches of this size inside each "
        "dispatch (must divide --batch-size; default 0: the whole batch)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to score on (default cuda; cpu must be asked for)",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    args = parser.parse_args(argv)

    if args.self_norm and (args.norm or args.mean or args.std):
        parser.error(
            "--self-norm conflicts with --norm/--mean/--std: the explicit "
            "stats already normalize the transform, and self-norm would "
            "normalize the result a second time"
        )
    # fp32 convolutions, like the JAX reference's HIGHEST precision
    torch.backends.cudnn.allow_tf32 = False

    model, transform, cfg = build_scorer_from_snapshot(
        args.snapshot,
        norm=args.norm,
        mean=args.mean,
        std=args.std,
        log_scale=not args.no_log_scale,
        expect_self_norm=args.self_norm,
    )
    paths = _expand_inputs(args.inputs)
    scores = score_files(
        model,
        transform,
        paths,
        args.device,
        sample_rate=int(cfg.sample_rate),
        seconds=float(cfg.seconds),
        batch_size=args.batch_size,
        aggregate=args.aggregate,
        self_norm=args.self_norm,
        chunk=args.chunk,
        int8=args.int8,
    )
    if args.as_json:
        print(json.dumps(scores, indent=2, sort_keys=True))
    else:
        for path in paths:
            if path in scores:
                print(f"{scores[path]:.4f}\t{path}")
            else:
                print(f"(shorter than {cfg.seconds}s, skipped)\t{path}")


if __name__ == "__main__":
    main()
