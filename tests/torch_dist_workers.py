"""Rank processes for the port's distributed tests (gloo on the CPU).

Not a test module: ``tests/test_torch_parallel.py`` and
``tests/test_torch_distributed_cli.py`` start these with :func:`spawn`, one
process per rank, pinned to one thread; the ranks meet through a
``FileStore`` in the test's temporary directory (or, for the CLI, through
torchrun's environment and a port bound to 0).  This module imports no JAX
(``tests/conftest.py`` does, so the workers run as a script, not under
pytest): each rank saves what it computed with ``torch.save`` and the test
process holds it against the JAX package.

    python tests/torch_dist_workers.py <case> <dir> <rank> <world>
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the narrow DCNN of tests/test_parallel.py's FSDP tests
KW = dict(time_dim=1, ochannels1=8, ochannels2=8, ochannels3=16, ochannels4=16,
          ochannels5=8, with_dropout=False)
#: the JAX package's sequence-parallel cases (tests/test_parallel.py:48-60)
#: plus its level-14 design point: (wavelet, level, T, seed, rows)
SP_CASES = [("haar", 1, 8 * 2**10, 0, 2), ("haar", 3, 8 * 2**10, 0, 2),
            ("haar", 6, 8 * 2**10, 0, 2), ("sym5", 1, 8 * 2**9, 1, 2),
            ("sym5", 3, 8 * 2**9, 1, 2), ("coif4", 3, 8 * 2**9, 1, 2),
            ("db4", 5, 8 * 2**9, 1, 2), ("haar", 14, 8 * 2**14, 2, 1)]
LR = 1e-2  # SGD: the parameters stay linear in the gradients


def spawn(case: str, directory: str, world: int, timeout: float = 240.0, env=None,
          extra=()) -> None:
    """Run ``case`` in ``world`` rank processes and wait for them; raise with
    their output when one fails."""
    procs = []
    for rank in range(world):
        penv = dict(os.environ, OMP_NUM_THREADS="1", **(env(rank) if env else {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, directory, str(rank), str(world),
             *extra],
            env=penv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(
            f"--- rank {r} ---\n{o[-6000:]}" for r, o in enumerate(outs)))


# ------------------------------------------------------------ the models


def _transform(audio):
    from audiodeepfake_detection_tpu_torch.ops.wpt import packet_image

    return packet_image(audio, "haar", level=8, log_scale=True)


def _moment_spy():
    """Record the moments every BatchNorm of the model normalises with:
    the global ones the synchronized BatchNorms and the fused blocks' BNs
    take (``batch_norm_from_moments``)."""
    from audiodeepfake_detection_tpu_torch.models import dcnn, layers

    seen = []
    original = layers.batch_norm_from_moments

    def spy(bn, x, s, q):
        seen.append((s.detach().clone(), q.detach().clone()))
        return original(bn, x, s, q)

    layers.batch_norm_from_moments = dcnn.batch_norm_from_moments = spy

    def stop():
        layers.batch_norm_from_moments = dcnn.batch_norm_from_moments = original
        return seen

    return stop


def _local_moments(model):
    """Forward pre-hooks recording each BatchNorm's input moments over this
    rank's own batch (one-pass float32)."""
    import torch

    from audiodeepfake_detection_tpu_torch.models.layers import one_pass_moments

    seen, hooks = [], []
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: seen.append(tuple(t.detach().clone()
                                                    for t in one_pass_moments(args[0])))))
    return seen, hooks


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _global_loss(loss, mesh):
    from audiodeepfake_detection_tpu_torch.parallel.mesh import all_reduce_sum, mesh_size

    return float(all_reduce_sum((loss.reshape(1),), mesh)[0]) / mesh_size(mesh)


def dcnn_step(inputs, mesh, fused: bool = False):
    """One SGD step of the narrow DCNN: on ``mesh`` under DDP (its BNs
    synchronized, the rank's shard of the batch), or without one on the
    whole batch."""
    import torch
    from torch.nn.parallel import DistributedDataParallel

    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.parallel.mesh import mesh_group, shard_batch
    from audiodeepfake_detection_tpu_torch.train.steps import make_train_step

    flags = dict(fused_layer1=fused, fused_pool=fused, fused_layer2=fused)
    model = DCNN(**KW, **flags, mesh=mesh)
    model.load_state_dict(inputs["dcnn"])
    run = model
    if mesh is not None:
        run = DistributedDataParallel(model, process_group=mesh_group(mesh),
                                      broadcast_buffers=False)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    batch = {"audio": inputs["audio"], "label": inputs["label"]}
    local = shard_batch(mesh, batch) if mesh is not None else batch
    stop = _moment_spy()
    seen, hooks = _local_moments(model)
    stats = make_train_step(run, _transform, opt)(local)
    used = stop()
    for h in hooks:
        h.remove()
    loss = _global_loss(stats["loss"], mesh) if mesh is not None else float(stats["loss"])
    return {"loss": loss, "state": _state(model), "used_moments": used,
            "local_moments": seen}


def lcnn_step(inputs, mesh):
    """One SGD step of an LCNN with kernel 3's block (its plain version on
    the CPU) on a ``[16, 1, 32, 32]`` image batch, DDP on ``mesh`` or the
    whole batch without one."""
    import torch
    from torch.nn.parallel import DistributedDataParallel

    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
    from audiodeepfake_detection_tpu_torch.parallel.mesh import mesh_group, shard_batch
    from audiodeepfake_detection_tpu_torch.train.steps import make_train_step

    model = LCNN(lstm_channels=32, fused_layer1=True, dropout=0.0, mesh=mesh)
    model.load_state_dict(inputs["lcnn"])
    run = model
    if mesh is not None:
        run = DistributedDataParallel(model, process_group=mesh_group(mesh),
                                      broadcast_buffers=False)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    batch = {"audio": inputs["image"], "label": inputs["label"]}
    local = shard_batch(mesh, batch) if mesh is not None else batch
    stats = make_train_step(run, lambda a: a, opt)(local)
    loss = _global_loss(stats["loss"], mesh) if mesh is not None else float(stats["loss"])
    return {"loss": loss, "state": _state(model)}


#: a grid model with both BatchNorm spellings of the vocabulary
GRID_MODEL = [[{"layers": ["Conv2d 1 8 3 1 1", "SyncBatchNorm 8 1e-5 0.1 True", "ReLU",
                           "MaxPool2d 2 2", "BatchNorm2d 8", "Flatten 1", "Linear 2048 2"]}]]


def grid_step(inputs, mesh):
    """One SGD step of a grid model built by the factory (on ``mesh``: its
    BatchNorms synchronized) on the image batch, DDP or one process."""
    import torch
    from torch.nn.parallel import DistributedDataParallel

    from audiodeepfake_detection_tpu_torch.models.factory import get_model
    from audiodeepfake_detection_tpu_torch.models.layers import SyncBatchNorm2d
    from audiodeepfake_detection_tpu_torch.parallel.mesh import mesh_group, shard_batch
    from audiodeepfake_detection_tpu_torch.train.steps import make_train_step
    from audiodeepfake_detection_tpu_torch.utils.config import DotDict

    torch.manual_seed(3)
    spec = [[dict(b, layers=list(b["layers"])) for b in cfg] for cfg in GRID_MODEL]
    model = get_model(DotDict(model_data=spec), "gridmodel", mesh=mesh)  # parses in place
    synced = [isinstance(m, SyncBatchNorm2d) and m.mesh is mesh for m in model.modules()
              if isinstance(m, torch.nn.BatchNorm2d)]
    run = model
    if mesh is not None:
        run = DistributedDataParallel(model, process_group=mesh_group(mesh),
                                      broadcast_buffers=False)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    batch = {"audio": inputs["image"], "label": inputs["label"]}
    local = shard_batch(mesh, batch) if mesh is not None else batch
    stats = make_train_step(run, lambda a: a, opt)(local)
    loss = _global_loss(stats["loss"], mesh) if mesh is not None else float(stats["loss"])
    return {"loss": loss, "state": _state(model), "synced": synced}


def fsdp_step(inputs, mesh, adam: bool = False):
    """One step of the narrow DCNN under FSDP2 over ``mesh`` (min_bytes 0,
    as the JAX test shards every leaf): SGD, or Adam to read the moments'
    shards."""
    import torch

    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.parallel.fsdp import (
        full_model_state,
        local_fraction,
        shard_fsdp,
    )
    from audiodeepfake_detection_tpu_torch.parallel.mesh import shard_batch
    from audiodeepfake_detection_tpu_torch.train.steps import make_optimizer, make_train_step

    model = DCNN(**KW, mesh=mesh)
    model.load_state_dict(inputs["dcnn"])
    shard_fsdp(model, mesh, min_bytes=0)
    opt = (make_optimizer(model.parameters(), 1e-3, 0.0) if adam
           else torch.optim.SGD(model.parameters(), lr=LR))
    local = shard_batch(mesh, {"audio": inputs["audio"], "label": inputs["label"]})
    stats = make_train_step(model, _transform, opt)(local)
    out = {"loss": _global_loss(stats["loss"], mesh), "state": full_model_state(model),
           "buffers": {k: v.clone() for k, v in model.named_buffers()}}
    if adam:
        out["moments"] = {
            name: (tuple(p.shape), opt.state[p]["exp_avg"].to_local().numel(),
                   local_fraction(opt.state[p]["exp_avg_sq"]))
            for name, p in model.named_parameters()}
    return out


def fsdp_resume(inputs, mesh, directory: str):
    """A Trainer under FSDP: two Adam steps, a snapshot, a third step; then
    a fresh Trainer resumed from the snapshot takes the third step again."""
    import torch

    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.parallel.fsdp import full_model_state
    from audiodeepfake_detection_tpu_torch.parallel.mesh import shard_batch
    from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
    from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

    args = default_config()
    args.update(learning_rate=1e-3, weight_decay=1e-3, fsdp=True, fsdp_min_bytes=0, seed=0,
                ckpt_every=1, validation_interval=1)
    path = os.path.join(directory, "fsdp_snapshot")

    def trainer(seed):
        torch.manual_seed(seed)
        return Trainer(DCNN(**KW), _transform, DotDict(args), path, device="cpu", mesh=mesh)

    batches = [shard_batch(mesh, {"audio": inputs["audio"][lo:lo + 8],
                                  "label": inputs["label"][lo:lo + 8]}) for lo in (0, 8, 4)]
    first = trainer(0)
    for b in batches[:2]:
        first.train_step(b)
    first.step_total = 2
    # a copy: the gathered state's buffers are the model's own tensors
    saved = {k: v.clone() for k, v in full_model_state(first.model).items()}
    first.save_snapshot(0)
    first.train_step(batches[2])
    want = full_model_state(first.model)
    second = trainer(5)  # other initial weights: all of them come from the file
    second.load_snapshot()
    resumed = (second.epochs_run, second.step_total)
    second.train_step(batches[2])
    return {"saved": saved, "after": want, "resumed_after": full_model_state(second.model),
            "resumed": resumed, "snapshot": first.snapshot_path}


def refusals(mesh, directory: str):
    """What a world of 2 refuses or declines."""
    import torch

    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.parallel.mesh import shard_batch
    from audiodeepfake_detection_tpu_torch.train import sweep
    from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
    from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

    out = {}
    try:
        shard_batch(mesh, {"audio": torch.zeros(15, 1, 8)})
    except ValueError as exc:
        out["indivisible"] = str(exc)
    args = default_config()
    args.update(learning_rate=1e-3, weight_decay=0.0, device_data=True, seed=0)
    tr = Trainer(DCNN(**KW), _transform, DotDict(args), os.path.join(directory, "dd"),
                 device="cpu", mesh=mesh)
    out["device_data_kept"] = tr._device_data
    try:
        sweep.check_one_device(DotDict(args))
    except ValueError as exc:
        out["sweep"] = str(exc)
    return out


def sp_cases(mesh):
    """Every sequence-parallel case over ``mesh`` and the dense plain
    cascade of its clip, and the routed mean spectrum of a long and a
    short clip (JAX's fingerprint test)."""
    import numpy as np
    import torch

    from audiodeepfake_detection_tpu_torch.analysis.fingerprints import mean_wpt_spectrum
    from audiodeepfake_detection_tpu_torch.parallel.sequence import sp_wpt_analysis

    from audiodeepfake_detection_tpu_torch.ops.wpt import wpt_analysis

    out = {}
    for wavelet, level, t, seed, rows in SP_CASES:
        x = torch.from_numpy(np.random.RandomState(seed).randn(rows, t).astype(np.float32))
        out[(wavelet, level)] = sp_wpt_analysis(x, wavelet, level, mesh).numpy()
        out["dense", wavelet, level] = wpt_analysis(x, wavelet, level).numpy()
    rng = np.random.RandomState(4)
    clips = [rng.randn(8 * 2**10 + 137).astype(np.float32),
             rng.randn(2**10 + 3).astype(np.float32)]
    out["spectrum"] = mean_wpt_spectrum(clips, "haar", 10, device="cpu", mesh=mesh)
    return out


def case_parallel(directory: str, rank: int, world: int) -> dict:
    """Everything ``tests/test_torch_parallel.py`` holds, on 4 ranks: the
    2-rank parts run on each pair ``{0, 1}``, ``{2, 3}`` (the ``"data"``
    dim of a ``(2, 2)`` mesh), the sequence-parallel WPT over 2 and 4."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from audiodeepfake_detection_tpu_torch.parallel.mesh import get_mesh

    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    mesh4 = get_mesh("cpu")
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pair", "data"))["data"]
    out = {
        "ddp": dcnn_step(inputs, mesh2),
        "ddp_fused": dcnn_step(inputs, mesh2, fused=True),
        "single": dcnn_step(inputs, None),
        "lcnn_ddp": lcnn_step(inputs, mesh2),
        "lcnn_single": lcnn_step(inputs, None),
        "grid_ddp": grid_step(inputs, mesh2),
        "grid_single": grid_step(inputs, None),
        "fsdp": fsdp_step(inputs, mesh2),
        "fsdp_adam": fsdp_step(inputs, mesh2, adam=True),
        "resume": fsdp_resume(inputs, mesh2, directory),
        "refusals": refusals(mesh2, directory),
        "sp2": sp_cases(mesh2),
        "sp4": sp_cases(mesh4),
    }
    return out


# ------------------------------------------------- the AST's model parallelism

#: the test size patched into the AST's ``_SIZES`` (embed 64, depth 4, 4
#: heads of 16) and the image geometry of tests/test_torch_model_parallel.py
AST_SIZE = {"test64": dict(embed_dim=64, depth=4, num_heads=4)}
AST_GEOMETRY = dict(input_fdim=64, input_tdim=48, model_size="test64")
MICROBATCHES = 2
PP_LR, PP_WD = 1e-3, 1e-3


def _ast(state, **kw):
    from audiodeepfake_detection_tpu_torch.models import ast

    ast._SIZES.update(AST_SIZE)
    model = ast.ASTModel(**AST_GEOMETRY, fused_attention=True, **kw)
    model.load_state_dict(state)
    return model


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def tp_step(inputs, mesh):
    """The AST tensor-parallel over ``"model"``, its batch over ``"data"``:
    logits of this rank's share, one backward's gradients averaged over
    ``"data"`` and gathered, and the gathered state."""
    import torch.nn.functional as F

    from audiodeepfake_detection_tpu_torch.parallel.mesh import all_reduce_grads, shard_batch
    from audiodeepfake_detection_tpu_torch.parallel.tensor import full_ast_state, shard_ast_params

    model = shard_ast_params(_ast(inputs["state"]), mesh)
    local = shard_batch(mesh, {"image": inputs["image"], "label": inputs["label"]})
    out = model(local["image"])
    F.cross_entropy(out, local["label"].long()).backward()
    all_reduce_grads(model.parameters(), mesh, "data")
    return {"logits": out.detach(), "heads": [b.num_heads for b in model.v.blocks],
            "qkv_rows": model.v.blocks[0].attn.qkv.weight.shape[0],
            "grads": full_ast_state(model, mesh, tensors=_grads(model)),
            "state": full_ast_state(model, mesh)}


def pp_cases(inputs, mesh, directory: str):
    """The pipelined AST over ``("data", "stage")``: logits and combined
    gradients; the divisibility error; ``make_pp_train_step`` over four
    steps on one batch; a Trainer step with its snapshot; the refusals a
    world of 4 gives."""
    import torch
    import torch.nn.functional as F

    from audiodeepfake_detection_tpu_torch.parallel.mesh import data_stage_mesh, shard_batch
    from audiodeepfake_detection_tpu_torch.parallel.pipeline import (
        combine_pp_grads, make_pp_train_step, pp_ast_logits, stage_blocks)
    from audiodeepfake_detection_tpu_torch.train.steps import make_optimizer
    from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
    from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

    out = {}
    local = shard_batch(mesh, {"image": inputs["image"], "label": inputs["label"]})
    model = _ast(inputs["state"])
    out["blocks"] = list(stage_blocks(model, mesh))
    logits = pp_ast_logits(model, local["image"], mesh, MICROBATCHES, data_axis="data")
    F.cross_entropy(logits, local["label"].long()).backward()
    combine_pp_grads(model, mesh, "stage", "data")
    out["logits"], out["grads"] = logits.detach(), _grads(model)
    try:
        pp_ast_logits(model, torch.zeros(6, 1, 64, 48), mesh, 4, data_axis="data")
    except ValueError as exc:
        out["per_shard"] = str(exc)

    model = _ast(inputs["state"])
    step = make_pp_train_step(model, make_optimizer(model.parameters(), 4e-4, 1e-3), mesh,
                              MICROBATCHES, data_axis="data")
    out["learn"] = [float(step(local)["loss"]) for _ in range(4)]

    args = default_config()
    args.update(learning_rate=PP_LR, weight_decay=PP_WD, seed=0, pp_stages=2,
                pp_microbatches=MICROBATCHES, ckpt_every=1)
    trainer = Trainer(_ast(inputs["state"]), lambda a: a, DotDict(args),
                      os.path.join(directory, "pp_snapshot"), device="cpu", mesh=mesh)
    stats = trainer.train_step({"audio": local["image"], "label": local["label"]})
    trainer.save_snapshot(0)
    opt = trainer.optimizer
    out["trainer"] = {
        "loss": float(stats["loss"]), "state": _state(trainer.model),
        "exp_avg_sq": {n: opt.state[p]["exp_avg_sq"].clone()
                       for n, p in trainer.model.named_parameters()},
        "snapshot": trainer.snapshot_path, "rank": trainer.rank}
    try:
        data_stage_mesh(3)
    except ValueError as exc:
        out["not_dividing"] = str(exc)
    return out


def case_model_parallel(directory: str, rank: int, world: int) -> dict:
    """Everything ``tests/test_torch_model_parallel.py`` holds, on 4 ranks:
    tensor parallelism over a ``(2, 2)`` ``("data", "model")`` mesh and the
    pipeline over a ``(2, 2)`` ``("data", "stage")`` mesh."""
    import torch

    from audiodeepfake_detection_tpu_torch.parallel.mesh import data_stage_mesh, get_mesh
    from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
    from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    tp_mesh = get_mesh("cpu", axis_names=("data", "model"), shape=(2, 2))
    out = {"tp": tp_step(inputs, tp_mesh),
           "pp": pp_cases(inputs, data_stage_mesh(2, "cpu"), directory)}
    args = default_config()
    args.update(learning_rate=PP_LR, weight_decay=0.0, pp_stages=2)
    try:
        Trainer(_ast(inputs["state"]), lambda a: a, DotDict(args),
                os.path.join(directory, "no_stage"), device="cpu", mesh=tp_mesh)
    except ValueError as exc:
        out["no_stage_axis"] = str(exc)
    return out


# ------------------------------------------------------------ the CLI


def case_cli(directory: str, rank: int, world: int, *ports: str) -> dict:
    """``main`` with ``--ddp``, then with ``--fsdp``, then ``analysis.cli
    fingerprints --sp``, then ``main --pp-stages 2`` (the ``test64`` AST),
    each under torchrun's environment (a port each); records which rank
    wrote what (the pipeline's launch apart)."""
    from audiodeepfake_detection_tpu_torch.analysis import cli
    from audiodeepfake_detection_tpu_torch.models import ast
    from audiodeepfake_detection_tpu_torch.train import experiment, trainer

    ast._SIZES.update(AST_SIZE)
    spec = json.load(open(os.path.join(directory, "argv.json")))
    writes, pp_writes = [], []
    sink = [writes]
    save, results, dump = trainer._save_atomically, experiment.print_results, \
        experiment.dump_true_indices
    def save_atomically(obj, path):
        sink[0].append(path)
        save(obj, path)

    trainer._save_atomically = save_atomically

    def print_results(args, exp_results, *a):
        sink[0].append(("results", {k: [list(map(float, r)) for r in v]
                                    for k, v in exp_results.items()}))
        return results(args, exp_results, *a)

    experiment.print_results = print_results
    def dump_true_indices(*a):
        path = dump(*a)
        sink[0].append(("true_ind", path))
        return path

    experiment.dump_true_indices = dump_true_indices
    for name, port in zip(("ddp", "fsdp", "sp", "pp"), ports):
        os.environ["MASTER_PORT"] = port
        argv = spec[name]
        if name == "pp":
            sink[0] = pp_writes
        if argv[0] == "fingerprints":
            cli.main(argv)
        else:
            experiment.main(argv)
    import torch.distributed as dist

    return {"writes": writes, "pp_writes": pp_writes, "group_left": dist.is_initialized()}


def main() -> None:
    case, directory, rank, world, *extra = sys.argv[1:]
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    if case == "cli":
        out = case_cli(directory, rank, world, *extra)
    else:
        import torch.distributed as dist

        store = dist.FileStore(os.path.join(directory, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        case_fn = case_model_parallel if case == "model_parallel" else case_parallel
        out = case_fn(directory, rank, world)
        dist.barrier()
        dist.destroy_process_group()
    torch.save(out, os.path.join(directory, f"{case}_rank{rank}.pt"))


if __name__ == "__main__":
    main()
