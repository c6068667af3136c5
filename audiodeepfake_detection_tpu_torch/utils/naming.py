"""Experiment / checkpoint naming, compatible with the reference scheme.

Copy of ``experiment_model_file``, ``parse_model_file`` and
``norm_cache_prefix`` from
``audiodeepfake_detection_tpu/utils/naming.py``.  The reference encodes the
full experiment configuration into the snapshot filename, which acts as its
checkpoint registry (reference: src/audiofakedetect/train_classifier.py:
1221-1269).
"""

from __future__ import annotations

from .config import DotDict


def experiment_model_file(args: DotDict, base_dir: str, model_name: str) -> str:
    """Build the snapshot path prefix (without the ``.pt`` suffix)."""
    path_name = args.data_prefix.split("/")[-1].split("_")
    loss_less = False if args.loss_less == "False" else True

    model_file = base_dir + "/models/" + path_name[0] + "_"
    if args.transform == "stft":
        model_file += "stft"
    elif args.transform == "packets":
        model_file += "packets" + str(args.wavelet)
    model_file += (
        "_"
        + str(args.features)
        + "_"
        + str(args.hop_length)
        + "_"
        + str(args.sample_rate)
        + "_"
        + str(args.window_size)
        + "_"
        + str(args.num_of_scales)
        + "_"
        + str(int(args.f_min))
        + "-"
        + str(int(args.f_max))
        + "_"
        + path_name[3]
        + "_"
        + str(args.learning_rate)
        + "_"
        + str(args.weight_decay)
        + "_"
        + str(args.batch_size)
        + "_"
        + str(args.nclasses)
        + "_"
        + f"{args.epochs}e"
        + "_"
        + str(model_name)
        + "_signs"
        + str(loss_less)
        + "_augc"
        + str(args.aug_contrast)
        + "_augn"
        + str(args.aug_noise)
        + "_power"
        + str(args.power)
        + "_"
        + str(args.only_use[1])
        + "_"
        + str(args.seconds)
        + "secs_"
        + str(args.seed)
    )
    return model_file


def parse_model_file(path: str) -> DotDict:
    """Inverse of :func:`experiment_model_file`: decode a snapshot filename.

    Parsing anchors on the FIXED 20 trailing fields (the leading
    data-prefix token may itself contain underscores); the model-name field
    must not contain underscores (true for every registry name: DCNN, LCNN,
    AST, Regression, the ablations).

    Not encoded in the filename (caller must supply if non-default):
    ``log_scale`` (True for every bundled/paper config), ``block_norm``,
    ``flattend_size`` (recoverable from the checkpoint tensors),
    ``time_dim_add``.
    """
    import os

    name = os.path.basename(path)
    if name.endswith(".pt"):
        name = name[: -len(".pt")]
    parts = name.split("_")
    if len(parts) < 21:
        raise ValueError(f"not a config-encoded snapshot name: {name!r}")
    tok = parts[-21]
    if tok == "stft":
        transform, wavelet = "stft", None
    elif tok.startswith("packets") and len(tok) > len("packets"):
        transform, wavelet = "packets", tok[len("packets") :]
    else:
        raise ValueError(f"unrecognized transform token {tok!r} in {name!r}")
    f_min, f_max = parts[-15].split("-")
    cfg = DotDict(
        transform=transform,
        features=parts[-20],
        hop_length=int(parts[-19]),
        sample_rate=int(parts[-18]),
        window_size=int(parts[-17]),
        num_of_scales=int(parts[-16]),
        f_min=float(f_min),
        f_max=float(f_max),
        train_ratio=float(parts[-14]),
        learning_rate=float(parts[-13]),
        weight_decay=float(parts[-12]),
        batch_size=int(parts[-11]),
        nclasses=int(parts[-10]),
        epochs=int(parts[-9].rstrip("e")),
        model_name=parts[-8],
        loss_less=parts[-7][len("signs") :],
        aug_contrast=parts[-6][len("augc") :] == "True",
        aug_noise=parts[-5][len("augn") :] == "True",
        power=float(parts[-4][len("power") :]),
        generator=parts[-3],
        seconds=float(parts[-2][: -len("secs")]),
        seed=int(parts[-1]),
    )
    if wavelet is not None:
        cfg.wavelet = wavelet
    return cfg


def norm_cache_prefix(args: DotDict) -> str:
    """Normalization-stats cache path prefix (reference wavelet_math.py:327-347)."""
    loss_less = "_loss_less" if args.loss_less == "True" else ""
    return (
        args.log_dir
        + "/norms/"
        + args.data_path.replace("/", "_")
        + "_"
        + "-".join(args.only_use)
        + "_"
        + args.transform
        + "_"
        + args.wavelet
        + "_"
        + str(args.num_of_scales)
        + "_"
        + str(args.power)
        + loss_less
        + "_"
        + str(args.sample_rate)
        + "_"
        + str(args.seconds)
        + "secs"
    )
