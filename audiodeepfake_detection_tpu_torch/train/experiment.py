"""Experiment runner: config -> grid -> transforms -> model -> Trainer.

Counterpart of ``audiodeepfake_detection_tpu/train/experiment.py`` (the
reference's ``main``, src/audiofakedetect/train_classifier.py:1084-1368):
grid search over a dict-of-lists config with a seed axis, per-experiment
seeding, transform + normalization construction, model factory, five data
loaders (train/val/test/cross-val/cross-test), Trainer with
``only_testing`` / ``only_ig`` / train modes, per-seed result
accumulation, true-index dumps, and LaTeX result emission.

Run as ``python -m audiodeepfake_detection_tpu_torch.train.experiment
[flags] --device cuda``; flag names match the reference CLI.  A run takes
one device (``--device``, default ``cuda``; ``cpu`` must be asked for), or
one device per rank under torchrun::

    torchrun --nproc-per-node N -m audiodeepfake_detection_tpu_torch.train.experiment \
        [flags] --ddp            # --fsdp for FSDP2; --device cpu: gloo ranks

:func:`maybe_initialize_distributed` reads torchrun's environment and joins
the group (NCCL on ``cuda:<LOCAL_RANK>``, gloo on the CPU); the Trainer
then trains under DDP or FSDP (``train/trainer.py``), rank 0 alone writes
snapshots, results, true-index dumps and TensorBoard events, and the group
is destroyed at the end of :func:`main`.  ``--ddp`` / ``--fsdp`` on one
rank take the distributed path all the same.  ``--vmap-seeds`` / ``--vmap-hparams`` train each group of grid
points that differ only in seed (and lr / wd) as one vectorized sweep
(``train/sweep.py``); ``--frame-cache`` builds the pre-decoded frame cache
and ships int16 PCM; ``--only-ig`` loads the snapshot and writes the
integrated-gradients maps (``analysis/integrated_gradients.py``);
``--tensorboard`` gives each Trainer a ``torch.utils.tensorboard``
writer.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import numpy as np
import torch

from ..data.dataset import get_custom_dataset
from ..data.frame_cache import rank_and_world
from ..data.loader import FrameLoader
from ..models.factory import get_model
from ..parallel.mesh import barrier, is_distributed, is_lead, lead_first
from ..utils.config import (
    DotDict,
    build_new_grid,
    default_config,
    load_grid_config,
)
from ..utils.naming import experiment_model_file, tensorboard_dir
from .predict import resolve_device
from .results import print_results
from .trainer import Trainer, check_modes, default_mesh, wants_distributed
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
    # under torchrun: DDP (and the synchronized BatchNorm) even on one rank
    parser.add_argument("--ddp", action="store_true")
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


def maybe_initialize_distributed(args: DotDict):
    """Join torchrun's process group, the counterpart of JAX
    ``maybe_initialize_distributed`` (the reference's ``ddp_setup``,
    train_classifier.py:44-47).

    With torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``) and two or more ranks, or ``--ddp`` /
    ``--fsdp``, ``init_process_group``: NCCL on ``cuda`` (the rank's device
    becomes ``cuda:<LOCAL_RANK>``), gloo on the CPU.  Without that
    environment nothing happens.  Returns ``(rank, world, device)``.
    """
    device = torch.device(args.device or "cuda")
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return 0, 1, device
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if world < 2 and not wants_distributed(args):
        return rank, world, device
    import torch.distributed as dist

    backend = "gloo"
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card ({torch.cuda.device_count()} visible); "
                "one rank a card")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world,
                                device_id=device if device.type == "cuda" else None)
    return rank, world, device


def mesh_for(args: DotDict, device):
    """The experiment's device mesh (JAX ``mesh_for``): the ``("data",
    "stage")`` mesh of the GPipe pipeline with ``pp_stages > 1``; else the
    world's ``("data",)`` mesh under a process group of two or more ranks,
    or of one with ``--ddp`` / ``--fsdp``; else None (one device).  Built
    per grid point: ``pp_stages`` can be a grid axis."""
    return default_mesh(args, device)


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


def loader_shard_kw(args: DotDict) -> dict:
    """Per-process feeding policy, the one source for every loader the
    serial and the vectorized paths build (they must feed identically, or
    the sweep's data order leaves the serial grid's).  Under the pipeline
    (``pp_stages > 1``) the stages of a data row read the same slice: the
    loaders shard by the data coordinate over the data rows."""
    rank, world = rank_and_world()
    pp = int(args.get("pp_stages") or 1)
    if pp > 1 and world % pp == 0:  # data_stage_mesh's layout: stage fastest
        rank, world = rank // pp, world // pp
    return dict(
        process_index=rank,
        process_count=world,
        # True builds the pre-decoded frame cache up front; None only uses
        # one that already exists (data/frame_cache.py).  With the cache
        # on, batches ship as int16 PCM (converted on the device).
        use_frame_cache=True if args.frame_cache else None,
        emit="int16" if args.frame_cache else "float32",
    )


def create_data_loaders(args: DotDict):
    """Five loaders: train/val/test + cross val/test
    (reference train_classifier.py:50-229)."""

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

    shard_kw = loader_shard_kw(args)
    train_loader = FrameLoader(
        train_ds,
        args.batch_size,
        shuffle=True,
        drop_last=True,
        seed=int(args.seed or 0),
        **shard_kw,
    )
    val_loader = FrameLoader(val_ds, args.batch_size, **shard_kw)
    test_loader = FrameLoader(
        test_ds, args.batch_size, include_index=bool(args.get_details), **shard_kw
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
        cross_loader_val = FrameLoader(cross_val_ds, args.batch_size, **shard_kw)
        cross_loader_test = FrameLoader(
            cross_test_ds, args.batch_size, include_index=bool(args.get_details),
            **shard_kw,
        )
    return train_loader, val_loader, test_loader, cross_loader_val, cross_loader_test


def _check_unported(args: DotDict) -> None:
    if args.features != "none" and args.model != "lcnn":
        raise NotImplementedError(
            f"LFCC features are currently not implemented for {args.model}."
        )
    if args.transform == "stft" and args.loss_less == "True":
        raise ValueError(
            "Sign channel not possible for stft due to complex data type."
        )


def make_writer(args: DotDict, base_dir: str, model_name: str):
    """The ``--tensorboard`` writer of one run, under
    ``utils.naming.tensorboard_dir``.  PyTorch's own writer, whose event
    files read like tensorboardX's; it needs the ``tensorboard`` package."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as exc:
        raise ImportError(
            "--tensorboard needs the `tensorboard` package "
            "(torch.utils.tensorboard's SummaryWriter), which is not installed"
        ) from exc
    return SummaryWriter(tensorboard_dir(args, base_dir, model_name))


def run_experiment(args: DotDict, device: "torch.device | str | None" = None,
                   mesh=None) -> Trainer:
    """One grid point: transforms, model, loaders, Trainer, chosen mode.

    ``device`` defaults to ``args.device`` and that to ``"cuda"``; ``mesh``
    to :func:`mesh_for` (None off a process group).  With
    ``args.tensorboard`` the run's writer (rank 0's) is closed at its end.
    """
    device = resolve_device(device or args.device or "cuda")
    check_modes(args)
    if mesh is None:
        mesh = mesh_for(args, device)
    _check_unported(args)
    if args.only_ig and args.get("fsdp") and mesh is not None:
        # each rank attributes as many frames as its shard holds targets, so
        # ranks would call FSDP's gathering forward different numbers of times
        raise ValueError("--only-ig does not run under --fsdp: use --ddp or one device")
    if args.only_ig and args.get("fused_layer1"):
        # integrated gradients differentiate with respect to the input
        # image; the fused first blocks' backwards return no input
        # gradient (the transform in front is under stop-gradient in
        # training), which would make every attribution map silently zero
        # (the fused pool and second block give the full dx)
        print(
            "only_ig: disabling fused_layer1 (its compact VJP carries no "
            "input gradient; attributions need the unfused first layer)."
        )
        args = args.copy()
        args.fused_layer1 = False
    loss_less = args.loss_less == "True"

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

    # rank 0 computes (and caches) the normalization stats; the others
    # read its cache
    transform, mean, std = lead_first(lambda: get_transforms(
        args, train_batches=norm_batches_fn(train_loader), device=device))
    args.input_dim = get_input_dims(args, transform, device)
    full_transform = normalized_transform(transform, mean, std)

    model = get_model(
        args,
        args.model,
        nclasses=int(args.nclasses or 2),
        in_channels=2 if loss_less else 1,
        mesh=mesh,
    )
    model_name = model.get_name() if args.model == "modules" else "customModel"

    base_dir = args.log_dir
    os.makedirs(base_dir + "/models", exist_ok=True)
    model_file = experiment_model_file(args, base_dir, model_name)
    writer = None
    if args.tensorboard and is_lead():
        writer = make_writer(args, base_dir, model_name)

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
        writer=writer,
        mesh=mesh,
    )

    try:
        if args.only_testing:
            trainer.load_snapshot()
            trainer.test_results = trainer.testing(only_unknown=True)
        elif args.only_ig:
            from ..analysis.integrated_gradients import run_integrated_gradients

            trainer.load_snapshot()
            path = f"{args.transform}_{args.sample_rate}_{args.seconds}"
            path += (
                f"_{args.seed}_{args.only_use[-1]}_{args.wavelet}_{args.power}"
                f"_{str(loss_less)}"
            )
            run_integrated_gradients(trainer, path)
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
    finally:
        if writer is not None:
            writer.close()
    return trainer


def run_experiment_vectorized(args_list, device: "torch.device | str | None" = None,
                              seed_axis: str = "scan"):
    """One grid configuration x S seeds (and, with ``--vmap-hparams``, lr /
    wd points), trained as one vectorized sweep
    (:func:`prepare_vectorized_sweep`).  Returns the per-seed shadow
    Trainers."""
    sweep = prepare_vectorized_sweep(args_list, device, seed_axis)
    train_sweep(sweep)
    return sweep.shadows


def train_sweep(sweep) -> None:
    """Train a prepared sweep, then close its shadows' writers."""
    try:
        sweep.train(sweep.args.epochs)
    finally:
        for sh in sweep.shadows:
            if sh.writer is not None:
                sh.writer.close()


def prepare_vectorized_sweep(args_list, device: "torch.device | str | None" = None,
                             seed_axis: str = "scan"):
    """The :class:`~.sweep.VectorizedSeedSweep` of one grid configuration x
    S seeds, ready to train; ``ValueError`` when the sweep refuses the
    configuration.

    Setup that does not depend on the slice (datasets, normalization
    statistics, transform) happens once.  Each slice's model is built as
    :func:`run_experiment` builds its seed's (``torch.manual_seed(seed)``,
    then ``get_model``), inside a per-seed shadow Trainer that keeps its
    snapshots and metrics.
    """
    from .sweep import VectorizedSeedSweep, check_one_device

    check_one_device(args_list[0])
    base = args_list[0].copy()
    device = resolve_device(device or base.device or "cuda")
    _check_unported(base)
    loss_less = base.loss_less == "True"
    np.random.seed(int(base.seed or 0))

    (
        train_loader,
        val_loader,
        test_loader,
        cross_loader_val,
        cross_loader_test,
    ) = create_data_loaders(base)

    transform, mean, std = get_transforms(
        base, train_batches=norm_batches_fn(train_loader), device=device
    )
    base.input_dim = get_input_dims(base, transform, device)
    full_transform = normalized_transform(transform, mean, std)

    base_dir = base.log_dir
    os.makedirs(base_dir + "/models", exist_ok=True)
    shard_kw = loader_shard_kw(base)
    shadows, train_loaders = [], []
    for a in args_list:
        a = a.copy()
        a.input_dim = base.input_dim
        torch.manual_seed(int(a.seed or 0))  # this seed's initial weights
        model = get_model(
            a, a.model, nclasses=int(a.nclasses or 2), in_channels=2 if loss_less else 1,
        )
        model_name = model.get_name() if a.model == "modules" else "customModel"
        shadows.append(
            Trainer(
                model=model,
                transform=full_transform,
                args=a,
                snapshot_path=experiment_model_file(a, base_dir, model_name),
                train_loader=train_loader,
                val_loader=val_loader,
                test_loader=test_loader,
                cross_loader_val=cross_loader_val,
                cross_loader_test=cross_loader_test,
                label_names=test_loader.dataset.label_names,
                norm_stats=None if base.block_norm else (mean, std),
                device=device,
                writer=make_writer(a, base_dir, model_name) if a.tensorboard else None,
            )
        )
        train_loaders.append(
            FrameLoader(
                train_loader.dataset,
                a.batch_size,
                shuffle=True,
                drop_last=True,
                seed=int(a.seed or 0),
                **shard_kw,
            )
        )
    slices = [
        (int(a.seed or 0), float(a.learning_rate), float(a.weight_decay))
        for a in args_list
    ]
    print(f"vmap_seeds: training (seed, lr, wd) slices {slices} in one vectorized sweep "
          f"(seed axis {seed_axis})")
    return VectorizedSeedSweep(shadows, train_loaders, seed_axis=seed_axis)


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
    joined = not is_distributed()
    _, _, device = maybe_initialize_distributed(args)
    args.device = str(device)
    joined = joined and is_distributed()
    try:
        _main(args)
    finally:
        if joined:  # a group the caller made is the caller's to destroy
            import torch.distributed as dist

            barrier()
            dist.destroy_process_group()


def _main(args: DotDict) -> None:
    base_dir = args.log_dir
    for sub in ("models", "tensorboard", "norms"):
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

    if (
        (args.get("vmap_seeds") or args.get("vmap_hparams"))
        and griderator is not None
        and not (args.only_testing or args.only_ig)
    ):
        # every grid point, grouped by the axes that are not vectorized:
        # each group trains as one vectorized sweep (--vmap-hparams folds
        # the lr / wd axes in as per-slice optimizer groups).  Groups run in
        # order of first appearance, so each seed's result list keeps the
        # serial loop's order of configurations.
        vec_axes = {"seed"}
        if args.get("vmap_hparams"):
            vec_axes |= {"learning_rate", "weight_decay"}
        configs = []
        for _exp in range(num_exp):
            args, _ = griderator.update_step(args)
            configs.append(args.copy())
        groups: Dict[str, list] = {}
        for a in configs:
            key = repr(sorted((k, repr(v)) for k, v in a.items() if k not in vec_axes))
            groups.setdefault(key, []).append(a)
        for group in groups.values():
            try:
                sweep = prepare_vectorized_sweep(group)
            except ValueError as exc:
                # a group the sweep refuses (device_data, fsdp, pp_stages)
                # runs serially, and the sweep goes on
                print(f"vmap_seeds: group not vectorizable ({exc}); "
                      "running its configs serially")
                shadows = [run_experiment(a) for a in group]
            else:
                # outside the try: a kernel that refuses a shape while the
                # sweep trains stops the run
                train_sweep(sweep)
                shadows = sweep.shadows
            for sh in shadows:
                model_file = sh.snapshot_path[: -len(".pt")]
                exp_results.setdefault(sh.args.seed, []).append(sh.test_results)
                if sh.args.get_details and sh.current_true_indices and is_lead():
                    dump_true_indices(sh.args, sh, model_file)
        if is_lead():
            print_results(configs[-1], exp_results, griderator, model_file)
        return

    if args.get("vmap_seeds") or args.get("vmap_hparams"):
        print("vmap_seeds: nothing to vectorize (needs --enable-gs training "
              "mode); running serially.")

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

        if args.get_details and trainer.current_true_indices and is_lead():
            dump_true_indices(args, trainer, model_file)

    if is_lead():
        print_results(args, exp_results, griderator, model_file)


if __name__ == "__main__":
    main()
