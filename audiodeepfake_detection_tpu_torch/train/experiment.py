"""Experiment runner: config -> grid -> transforms -> model -> Trainer.

Counterpart of ``audiodeepfake_detection_tpu/train/experiment.py`` (the
reference's ``main``, src/audiofakedetect/train_classifier.py:1084-1368):
grid search over a dict-of-lists config with a seed axis, per-experiment
seeding, transform + normalization construction, model factory, five data
loaders (train/val/test/cross-val/cross-test), Trainer with
``only_testing`` / train modes, per-seed result accumulation, true-index
dumps, and LaTeX result emission.

Run as ``python -m audiodeepfake_detection_tpu_torch.train.experiment
[flags] --device cuda``; flag names match the reference CLI.  Everything
runs on one device (``--device``, default ``cuda``; ``cpu`` must be asked
for).  Not ported yet: distributed init (slice 7), the vectorized sweep
(slice 8), integrated gradients and tensorboard (slice 9).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import numpy as np
import torch

from ..data.dataset import get_custom_dataset
from ..data.loader import FrameLoader
from ..models.factory import get_model
from ..utils.config import (
    DotDict,
    build_new_grid,
    default_config,
    load_grid_config,
)
from ..utils.naming import experiment_model_file
from .predict import resolve_device
from .results import print_results
from .trainer import Trainer
from .transforms import get_transforms, normalized_transform


def add_default_parser_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """CLI flags with the reference's names/defaults (utils.py:30-317)."""
    d = default_config()
    parser.add_argument("--log-dir", type=str, default=d.log_dir)
    parser.add_argument("--batch-size", type=int, default=d.batch_size)
    parser.add_argument("--learning-rate", type=float, default=d.learning_rate)
    parser.add_argument("--weight-decay", type=float, default=d.weight_decay)
    parser.add_argument("--epochs", type=int, default=d.epochs)
    parser.add_argument("--transform", choices=["stft", "packets"], default=d.transform)
    parser.add_argument(
        "--features",
        choices=["lfcc", "delta", "doubledelta", "none"],
        default=d.features,
    )
    parser.add_argument("--num-of-scales", type=int, default=d.num_of_scales)
    parser.add_argument("--wavelet", type=str, default=d.wavelet)
    parser.add_argument("--sample-rate", type=int, default=d.sample_rate)
    parser.add_argument("--window-size", type=int, default=d.window_size)
    parser.add_argument("--f-min", type=float, default=d.f_min)
    parser.add_argument("--f-max", type=float, default=d.f_max)
    parser.add_argument("--hop-length", type=int, default=d.hop_length)
    parser.add_argument("--log-scale", action="store_true")
    parser.add_argument("--block-norm", action="store_true")
    parser.add_argument("--power", type=float, default=d.power)
    parser.add_argument("--dropout-cnn", type=float, default=d.dropout_cnn)
    parser.add_argument("--dropout-lstm", type=float, default=d.dropout_lstm)
    parser.add_argument("--loss-less", choices=["True", "False"], default=d.loss_less)
    parser.add_argument("--random-seeds", action="store_true")
    parser.add_argument("--aug-contrast", action="store_true")
    parser.add_argument("--aug-noise", action="store_true")
    parser.add_argument("--calc-normalization", action="store_true")
    parser.add_argument("--mean", type=float, nargs="+", default=d.mean)
    parser.add_argument("--std", type=float, nargs="+", default=d.std)
    parser.add_argument("--data-prefix", type=str, default=d.data_prefix)
    parser.add_argument("--unknown-prefix", type=str, default=None)
    parser.add_argument(
        "--cross-sources", type=str, nargs="+", default=d.cross_sources
    )
    parser.add_argument("--init-seeds", type=int, nargs="+", default=d.init_seeds)
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--flattend-size", type=int, default=d.flattend_size)
    parser.add_argument(
        "--model", choices=["lcnn", "gridmodel", "modules"], default=d.model
    )
    parser.add_argument("--nclasses", type=int, default=d.nclasses)
    parser.add_argument("--enable-gs", action="store_true")
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--pbar", action="store_true")
    parser.add_argument(
        "--validation-interval", type=int, default=d.validation_interval
    )
    parser.add_argument("--only-testing", action="store_true")
    parser.add_argument("--ckpt-every", type=int, default=d.ckpt_every)
    parser.add_argument("--time-dim-add", type=int, default=d.time_dim_add)
    parser.add_argument("--ddp", action="store_true")  # accepted; one device
    parser.add_argument("--frame-cache", action="store_true")
    parser.add_argument("--steps-per-call", type=int, default=d.steps_per_call)
    parser.add_argument("--device-data", action="store_true")
    # gradient accumulation: the train step runs N microbatches of
    # batch_size/N -- full-batch mean gradient, 1/N activation memory
    # (BatchNorm normalises with per-microbatch moments)
    parser.add_argument("--grad-accum", type=int, default=d.grad_accum)
    parser.add_argument(
        "--adam-moments-dtype",
        choices=["float32", "bfloat16"],
        default=d.adam_moments_dtype,
    )
    parser.add_argument("--fsdp", action="store_true")
    parser.add_argument("--fsdp-min-bytes", type=int, default=d.fsdp_min_bytes)
    parser.add_argument("--pp-stages", type=int, default=d.pp_stages)
    parser.add_argument("--pp-microbatches", type=int, default=d.pp_microbatches)
    parser.add_argument("--vmap-seeds", action="store_true")
    parser.add_argument("--vmap-hparams", action="store_true")
    # resume training from an existing snapshot at the experiment's own
    # path (full state when present, .pt weights otherwise); off by default
    # so re-running an experiment retrains from scratch like the reference
    parser.add_argument("--resume", action="store_true")
    parser.add_argument(
        "--dtype", choices=["float32", "bfloat16"], default=d.dtype
    )
    # tri-state: off / train (kernel for training only) / always (eval
    # too); default None = whatever the config file says
    parser.add_argument(
        "--fused-layer1", choices=["off", "train", "always"], default=None
    )
    parser.add_argument(
        "--fused-pool", choices=["off", "train", "always"], default=None
    )
    parser.add_argument("--only-ig", action="store_true")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument(
        "--device", default=d.device,
        help="torch device to train on (default cuda; cpu must be asked for)",
    )
    return parser


def get_input_dims(args: DotDict, transform, device) -> list:
    """Probe the transform output shape (reference utils.py:589-621)."""
    t = int(args.seconds * args.sample_rate)
    with torch.no_grad():
        shape = list(transform(torch.zeros((1, 1, t), device=device)).shape)
    shape[0] = args.batch_size
    return shape


def norm_batches_fn(train_loader):
    """Welford-statistics batch stream over the train set.

    The reference computes stats at batch 4000 over the train set
    (wavelet_math.py:419-426); capped at the dataset size so small sets
    don't process padding.
    """

    def norm_batches():
        bs = max(1, min(4000, len(train_loader.dataset)))
        big = FrameLoader(train_loader.dataset, bs)
        for batch in big.epoch(0, shuffle=False):
            keep = batch["weight"] > 0
            yield batch["audio"][keep]

    return norm_batches


def create_data_loaders(args: DotDict):
    """Five loaders: train/val/test + cross val/test
    (reference train_classifier.py:50-229)."""
    if args.frame_cache:
        raise NotImplementedError(
            "--frame-cache is not ported yet (ROADMAP.md queue 1, slice 8: "
            "sweeps and resident data)"
        )

    def make(ds_type, limit, asv_suffix, data_path, only_use):
        asv = args.asvspoof_name
        if asv is not None and "LA" in str(asv):
            asv = f"{asv}_{asv_suffix}"
        return get_custom_dataset(
            data_path=data_path,
            ds_type=ds_type,
            only_use=only_use,
            save_path=args.save_path,
            limit=limit,
            asvspoof_name=asv,
            file_type=args.file_type,
            resample_rate=args.sample_rate,
            seconds=args.seconds,
        )

    train_ds = make("train", args.limit_train[0], "T", args.data_path, args.only_use)
    val_ds = make("val", args.limit_train[1], "D", args.data_path, args.only_use)
    test_ds = make("test", args.limit_train[2], "E", args.data_path, args.only_use)

    train_loader = FrameLoader(
        train_ds,
        args.batch_size,
        shuffle=True,
        drop_last=True,
        seed=int(args.seed or 0),
    )
    val_loader = FrameLoader(val_ds, args.batch_size)
    test_loader = FrameLoader(
        test_ds, args.batch_size, include_index=bool(args.get_details)
    )

    cross_loader_val = cross_loader_test = None
    if args.cross_data_path is not None:
        cross_kw = dict(
            data_path=args.cross_data_path,
            only_test_folders=args.only_test_folders,
            only_use=args.cross_sources,
            save_path=args.save_path,
            asvspoof_name=args.asvspoof_name_cross,
            file_type=args.file_type,
            resample_rate=args.sample_rate,
            seconds=args.seconds,
        )
        cross_test_ds = get_custom_dataset(
            ds_type="test", limit=args.cross_limit[2], **cross_kw
        )
        cross_val_ds = get_custom_dataset(
            ds_type="val", limit=args.cross_limit[1], **cross_kw
        )
        cross_loader_val = FrameLoader(cross_val_ds, args.batch_size)
        cross_loader_test = FrameLoader(
            cross_test_ds, args.batch_size, include_index=bool(args.get_details)
        )
    return train_loader, val_loader, test_loader, cross_loader_val, cross_loader_test


def run_experiment(args: DotDict, device: "torch.device | str | None" = None) -> Trainer:
    """One grid point: transforms, model, loaders, Trainer, chosen mode.

    ``device`` defaults to ``args.device`` and that to ``"cuda"``.
    """
    device = resolve_device(device or args.device or "cuda")
    if args.features != "none" and args.model != "lcnn":
        raise NotImplementedError(
            f"LFCC features are currently not implemented for {args.model}."
        )
    if args.only_ig:
        raise NotImplementedError(
            "--only-ig (integrated gradients) is not ported yet (ROADMAP.md "
            "queue 1, slice 9: analysis)"
        )
    if args.tensorboard:
        raise NotImplementedError(
            "--tensorboard is not ported yet (ROADMAP.md queue 1, slice 9: "
            "analysis and tooling)"
        )
    loss_less = args.loss_less == "True"
    if args.transform == "stft" and loss_less:
        raise ValueError(
            "Sign channel not possible for stft due to complex data type."
        )

    seed = int(args.seed or 0)
    np.random.seed(seed)
    torch.manual_seed(seed)  # the model's initial weights

    (
        train_loader,
        val_loader,
        test_loader,
        cross_loader_val,
        cross_loader_test,
    ) = create_data_loaders(args)

    transform, mean, std = get_transforms(
        args, train_batches=norm_batches_fn(train_loader), device=device
    )
    args.input_dim = get_input_dims(args, transform, device)
    full_transform = normalized_transform(transform, mean, std)

    model = get_model(
        args,
        args.model,
        nclasses=int(args.nclasses or 2),
        in_channels=2 if loss_less else 1,
    )
    model_name = model.get_name() if args.model == "modules" else "customModel"

    base_dir = args.log_dir
    os.makedirs(base_dir + "/models", exist_ok=True)
    model_file = experiment_model_file(args, base_dir, model_name)

    trainer = Trainer(
        model=model,
        transform=full_transform,
        args=args,
        snapshot_path=model_file,
        train_loader=train_loader,
        val_loader=val_loader,
        test_loader=test_loader,
        cross_loader_val=cross_loader_val,
        cross_loader_test=cross_loader_test,
        label_names=test_loader.dataset.label_names,
        norm_stats=None if args.block_norm else (mean, std),
        device=device,
    )

    if args.only_testing:
        trainer.load_snapshot()
        trainer.test_results = trainer.testing(only_unknown=True)
    else:
        if args.get("resume") and (
            os.path.exists(trainer.state_path)
            or os.path.exists(trainer.snapshot_path)
        ):
            trainer.load_snapshot()
            print(
                f"--resume: restored snapshot, continuing from epoch "
                f"{trainer.epochs_run + 1}"
            )
        trainer.train(args.epochs)
    return trainer


def dump_true_indices(args: DotDict, trainer, model_file: str) -> str:
    """Write the ``--get-details`` correct-index dump for model-diff analysis.

    "dataset" keeps the reference layout (train_classifier.py:1348-1356):
    the cross-test table, which the "unknown" indices index.  The known
    test set's table, which the "known" indices index, goes under
    "dataset_known".  Without a cross set the cross table is absent.
    """
    known = trainer.current_true_indices.get("test known", np.zeros(0))
    unknown = trainer.current_true_indices.get("test unknown", np.zeros(0))
    payload = {"known": np.asarray(known), "unknown": np.asarray(unknown)}
    if trainer.cross_loader_test is not None:
        payload["dataset"] = trainer.cross_loader_test.dataset.audio_data
    if trainer.test_loader is not None:
        payload["dataset_known"] = trainer.test_loader.dataset.audio_data
    out = f"{args.log_dir}/true_ind_{model_file.split('/')[-1]}_{args.seed}.npy"
    np.save(out, payload)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train an audio classifier")
    parser = add_default_parser_args(parser)
    parsed = parser.parse_args(argv)
    args = default_config()
    flags = dict(vars(parsed))
    # tri-state CLI flags: None = keep the config value
    tri = {"off": False, "train": True, "always": "always"}
    for key in ("fused_layer1", "fused_pool"):
        if flags.get(key) is None:
            flags.pop(key, None)
        else:
            flags[key] = tri[flags[key]]
    args.update(flags)

    base_dir = args.log_dir
    for sub in ("models", "norms"):
        os.makedirs(f"{base_dir}/{sub}", exist_ok=True)

    griderator = None
    num_exp = 1
    if args.enable_gs:
        print("--------------- Starting grid search -----------------")
        if not args.config:
            raise RuntimeError("Config file must be provided.")
        config = load_grid_config(args.config)
        griderator = build_new_grid(
            config, random_seeds=args.random_seeds, seeds=args.init_seeds
        )
        num_exp = griderator.get_len()

    exp_results: Dict[Any, list] = {}
    model_file = "defaultmodel"

    for _exp in range(num_exp):
        if griderator is not None:
            print("---------------------------------------------------------")
            print(
                "starting new experiments with "
                f"{griderator.grid_values[griderator.current]}"
            )
            print("---------------------------------------------------------")
            args, _ = griderator.update_step(args)
        trainer = run_experiment(args)
        model_file = trainer.snapshot_path[: -len(".pt")]
        exp_results.setdefault(args.seed, []).append(trainer.test_results)

        if args.get_details and trainer.current_true_indices:
            dump_true_indices(args, trainer, model_file)

    print_results(args, exp_results, griderator, model_file)


if __name__ == "__main__":
    main()
