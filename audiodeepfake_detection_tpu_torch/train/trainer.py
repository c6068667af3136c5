"""Trainer: epoch loop, validation, testing, snapshots.

Counterpart of the single-device path of
``audiodeepfake_detection_tpu/train/trainer.py`` (reference ``Trainer``:
src/audiofakedetect/train_classifier.py:232-1065):

* the model, its optimizer and the random generators live on one explicit
  ``device`` (``"cuda"`` unless the caller asks for the CPU; a missing card
  raises);
* per-step losses and per-batch eval results stay on the device during a
  loop and are fetched once at its end, so the host does not wait for the
  device after every step;
* a snapshot is the reference-layout ``.pt`` (``{"MODEL_STATE",
  "EPOCHS_RUN"}``, which the serving path and the JAX package's
  ``import_dcnn`` / ``import_lcnn`` / ``import_timm_deit`` load) with its
  ``.norm.pkl`` sidecar, plus one ``.state.pt`` holding model, optimizer
  (bf16 Adam moments included), epoch, step and generator states for
  ``--resume``; a weights-only AST ``.pt`` loads through
  ``import_timm_deit`` with the model's geometry;
* EER and the per-label accuracy tables are computed on the host from the
  gathered arrays, with the reference's argmax-EER definition
  (train_classifier.py:479-481).

* ``device_data`` parks the training set (and each eval set that fits the
  budget) in device memory (``train/device_data.py``); an epoch then runs
  in groups of ``steps_per_call`` steps, each group shipping only its
  ``[G, B]`` index block.  With streamed batches ``steps_per_call`` changes
  nothing: each batch is its own copy, which ``device_prefetch`` overlaps
  with the step before (the JAX package's chained streamed steps are not
  ported, ``train/steps.py``).  The seed sweep
  (``vmap_seeds`` / ``vmap_hparams``) drives per-seed Trainers from
  ``train/sweep.py``.

* ``writer`` (a ``torch.utils.tensorboard.SummaryWriter``, or anything
  with ``add_scalar`` / ``add_text``) gets the JAX Trainer's tags at the
  same steps: ``epochs``, ``loss/train``, ``accuracy/train``,
  ``perf/train_frames_per_sec``, ``{accuracy,eer}/{validation,
  cross_validation,test,cross_test}`` and, once, ``model/summary``: a
  table of the model's modules and parameter counts (the JAX Trainer
  logs flax's ``tabulate`` there).

* ``mesh`` (``parallel/mesh.py``; by default the world's when a process
  group of two or more ranks is initialized, or of one with ``ddp`` /
  ``fsdp``) trains across ranks, one process per device as torchrun runs
  it: the model wrapped in DDP (parameters broadcast from rank 0, the
  gradients averaged), or with ``fsdp`` sharded by FSDP2
  (``parallel/fsdp.py``); its BatchNorms take the global batch's moments
  (``models/layers.py::SyncBatchNorm2d``).  Each rank's loader holds its
  own slice of every set.  A step's logged loss and accuracy are the means
  over the ranks, summed once an epoch; eval sums the per-label counts and
  gathers the rows for EER and the true-index dumps, in dataset order;
  every rank checks that the others run as many steps and batches (ranks
  that disagree would deadlock in a collective).  Rank 0 alone writes
  snapshots and ``.state.pt``; the others wait.  Dropout and augmentation
  draw from ``seed + rank``, so ranks draw their own masks (JAX draws the
  global batch's mask from one key).  ``device_data`` streams instead on
  more than one rank, as the JAX package does on several hosts.

* ``pp_stages > 1`` trains the AST with its encoder pipelined over a
  ``("data", "stage")`` mesh (``parallel/pipeline.py``; built by
  ``data_stage_mesh`` when none is given): no DDP wrapper, the gradients
  combined over the stages and averaged over ``"data"`` inside the step,
  the same optimizer step on every rank.  Each data row's ranks read the
  same slice of every set (the loaders shard by the data coordinate),
  draw the same augmentation, and evaluate it with the plain model; the
  eval counts and rows, the logged stats and the random streams gather
  over ``"data"`` alone.  Refused, as in the JAX Trainer: ``fsdp``,
  ``device_data`` and ``grad_accum > 1`` beside it, a model without
  ``embed`` / ``classify``, non-zero dropout rates.
"""

from __future__ import annotations

import os
import pickle
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.loader import batch_to_device, device_prefetch
from ..models.layers import use_mesh
from ..parallel.mesh import (
    agree,
    all_gather_rows,
    all_reduce_sum,
    barrier,
    data_stage_mesh,
    get_mesh,
    has_axis,
    is_lead,
    mesh_group,
    mesh_rank,
    mesh_size,
)
from ..utils.config import DotDict
from .metrics import calculate_acc_label, dense_counts_to_dicts, safe_eer
from .predict import resolve_device
from .profiling import StepTimer
from .steps import (
    make_eval_step,
    make_optimizer,
    make_resident_multi_eval_step,
    make_resident_multi_train_step,
    make_train_step,
)

def wants_distributed(args: DotDict) -> bool:
    """``ddp`` or ``fsdp``: the distributed path even on one rank."""
    return bool(args.get("ddp")) or bool(args.get("fsdp"))


def default_mesh(args: DotDict, device):
    """The mesh a run takes when none is given: the ``("data", "stage")``
    mesh with ``pp_stages > 1``; else the world's, with two or more ranks,
    or with one when ``ddp`` / ``fsdp`` asks for it."""
    pp = int(args.get("pp_stages") or 1)
    if pp > 1:
        return data_stage_mesh(pp, device)
    return get_mesh(device, min_ranks=1 if wants_distributed(args) else 2)


def check_modes(args: DotDict) -> None:
    """The modes that exclude each other (JAX ``Trainer``), refused before
    any mesh is built: ``fsdp`` with ``pp_stages > 1``, ``device_data``
    with either."""
    fsdp, pp = bool(args.get("fsdp")), int(args.get("pp_stages") or 1) > 1
    if fsdp and pp:
        raise ValueError(
            "fsdp and pp_stages>1 are mutually exclusive (ZeRO shards "
            "parameters over the data axis, GPipe splits the encoder over "
            "stages)")
    if bool(args.get("device_data")) and (fsdp or pp):
        raise ValueError(
            "device_data is for the replicated data-parallel path only "
            "(disable fsdp / pp_stages, or stream the data)")


def check_pipeline(model: nn.Module, args: DotDict) -> None:
    """What ``pp_stages > 1`` refuses (JAX ``Trainer``): a model without
    separable ``embed`` / ``classify`` phases, a non-zero dropout rate (the
    pipelined encoder runs without dropout), ``grad_accum > 1``."""
    if not (hasattr(model, "embed") and hasattr(model, "classify")):
        raise ValueError(
            "pp_stages>1 supports encoder-stack models with separable "
            "embed/encode/classify phases (the AST); "
            f"{type(model).__name__} has no embed/classify methods")
    rates = {a: float(getattr(model, a, 0.0) or 0.0)
             for a in ("drop_rate", "attn_drop_rate", "drop_path_rate")}
    nonzero = {a: r for a, r in rates.items() if r > 0.0}
    if nonzero:
        raise ValueError(
            "pp_stages>1 runs the encoder without dropout; set these rates to 0 "
            f"or disable PP: {nonzero}")
    if int(args.get("grad_accum") or 1) > 1:
        raise ValueError(
            "grad_accum>1 and pp_stages>1 are mutually exclusive (the pipeline "
            "already microbatches inside the step)")


def _save_atomically(obj, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class Trainer:
    """Train / evaluate a classifier on one device, or on one rank of a
    mesh."""

    def __init__(
        self,
        model: nn.Module,
        transform: Callable,
        args: DotDict,
        snapshot_path: str,
        train_loader=None,
        val_loader=None,
        test_loader=None,
        cross_loader_val=None,
        cross_loader_test=None,
        label_names: Optional[Dict[int, str]] = None,
        norm_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        device: torch.device | str = "cuda",
        writer=None,
        mesh=None,
    ) -> None:
        check_modes(args)
        self._fsdp = bool(args.get("fsdp"))
        pp = int(args.get("pp_stages") or 1)
        self._pp = pp
        self._pp_microbatches = int(args.get("pp_microbatches") or 2)
        if pp > 1:
            check_pipeline(model, args)
        self.device = resolve_device(device)
        # fp32 convolutions and products, like the JAX reference's HIGHEST
        # precision (TF32 keeps about three decimal digits)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.mesh = mesh if mesh is not None else default_mesh(args, self.device)
        if pp > 1 and not has_axis(self.mesh, "stage"):
            raise ValueError(
                "pp_stages>1 requires a mesh with a 'stage' axis "
                f"(got axes {self.mesh.mesh_dim_names})")
        # the data coordinate: the stages of a data row draw alike
        self.rank = mesh_rank(self.mesh)
        self.model = model.to(self.device)
        self.train_model = self.model
        self._sharded = self._fsdp and self.mesh is not None
        if self.mesh is not None and pp == 1:
            use_mesh(self.model, self.mesh)
            if self._sharded:
                from ..parallel.fsdp import DEFAULT_MIN_BYTES, shard_fsdp

                shard_fsdp(self.model, self.mesh,
                           int(args.get("fsdp_min_bytes") or DEFAULT_MIN_BYTES))
            else:
                from torch.nn.parallel import DistributedDataParallel

                # the buffers need no broadcast: the synchronized BatchNorms
                # move them the same on every rank
                self.train_model = DistributedDataParallel(
                    self.model,
                    device_ids=[self.device] if self.device.type == "cuda" else None,
                    process_group=mesh_group(self.mesh), broadcast_buffers=False)
        self.transform = transform
        self.args = args
        self.snapshot_path = snapshot_path + ".pt"
        self.state_path = snapshot_path + ".state.pt"
        # (mean, std) baked into `transform`; written next to every .pt so
        # a snapshot is a complete serving artifact
        self.norm_stats = norm_stats
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.cross_loader_val = cross_loader_val
        self.cross_loader_test = cross_loader_test
        self.label_names = label_names or {}
        self.writer = writer
        self._summary_logged = False

        grad_accum = int(args.get("grad_accum") or 1)
        if grad_accum > 1 and args.batch_size % grad_accum:
            raise ValueError(
                f"batch_size {args.batch_size} not divisible by "
                f"grad_accum {grad_accum}"
            )
        self.grad_accum = grad_accum
        self.steps_per_call = int(args.get("steps_per_call") or 1)
        # device-resident frames (train/device_data.py): the training set
        # once, each eval set cached by its loader (weakly: a dead loader
        # frees its device memory)
        self._device_data = bool(args.get("device_data"))
        if self._device_data and mesh_size(self.mesh) > 1:
            # JAX trainer.py:390-397: the resident path is one process's;
            # several stream their own slices instead
            print("warning: device_data runs on one rank only; each of the "
                  f"{mesh_size(self.mesh)} ranks streams its own slice instead")
            self._device_data = False
        self._resident = None
        self._resident_eval_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

        self.epochs_run = 0
        self.step_total = 0
        self.loss_list: List[list] = []
        self.accuracy_list: List[list] = []
        self.validation_list: List[list] = []
        self.test_results: tuple = ()
        self.current_true_indices: Dict[str, np.ndarray] = {}
        self.init_state()

    # ------------------------------------------------------------------ init

    def init_state(self) -> None:
        """Fresh optimizer, random streams and steps for the model's current
        parameters.  Dropout draws from the device's default generator and
        augmentation from one of the trainer's own, both seeded with
        ``args.seed`` (plus the rank on a mesh: each rank draws its own)."""
        args = self.args
        seed = int(args.seed or 0) + self.rank
        torch.manual_seed(seed)
        self.aug_generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = make_optimizer(
            self.model.parameters(),
            args.learning_rate,
            args.weight_decay,
            moment_dtype=args.get("adam_moments_dtype") or None,
        )
        step_kw = dict(
            aug_contrast=bool(args.aug_contrast),
            aug_noise=bool(args.aug_noise),
            grad_accum=self.grad_accum,
            generator=self.aug_generator,
        )
        if self._pp > 1:
            from ..parallel.pipeline import make_pp_trainer_step

            self.train_step = make_pp_trainer_step(
                self.model, self.transform, self.optimizer, self.mesh,
                self._pp_microbatches,
                **{k: v for k, v in step_kw.items() if k != "grad_accum"})
        else:
            self.train_step = make_train_step(
                self.train_model, self.transform, self.optimizer, **step_kw)
        self.resident_train_step = make_resident_multi_train_step(
            self.model, self.transform, self.optimizer, **step_kw)
        self.eval_step = make_eval_step(self.model, self.transform)
        self.resident_eval_step = make_resident_multi_eval_step(self.model, self.transform)

    def load_variables(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Install imported weights (e.g. from a ``.pt`` snapshot) and start
        the optimizer afresh (every rank of a mesh loads the same)."""
        if self._sharded:
            from ..parallel.fsdp import load_full_model_state

            load_full_model_state(self.model, state_dict)
        else:
            self.model.load_state_dict(state_dict, strict=True)
        self.init_state()

    # ------------------------------------------------------------- training

    def _run_epoch(self, epoch: int) -> None:
        print(f"+------------------- Epoch {epoch + 1} -------------------+", flush=True)
        if self.writer is not None:
            self.writer.add_scalar("epochs", epoch, self.step_total)
            self._log_model_summary()
        if self._device_data:
            self._run_resident_epoch(epoch)
            return
        agree(len(self.train_loader), self.mesh, "the number of training steps")
        steps = device_prefetch(self.train_loader.epoch(epoch), self.device)
        if self.args.get("pbar"):
            from tqdm import tqdm

            steps = tqdm(
                steps,
                total=len(self.train_loader),
                desc=f"epoch {epoch + 1}",
                unit="batch",
            )
        timer = StepTimer(self.train_loader.batch_size)
        # per-step stats stay on the device during the epoch (a fetch per
        # step would make the host wait for every step)
        pending = []
        for _, device_batch in steps:
            stats = self.train_step(device_batch)
            self.step_total += 1
            timer.step()
            pending.append((self.step_total, stats))
        self._flush_epoch_stats(pending, timer, epoch)

    def _run_resident_epoch(self, epoch: int) -> None:
        """An epoch over device-resident frames (``device_data``): the
        loader's own order, groups of ``steps_per_call`` steps, each
        shipping only its ``[G, B]`` index block (a tail group is shorter)."""
        loader = self.train_loader
        if not loader.drop_last:
            raise ValueError(
                "device_data requires a drop_last training loader (the "
                "train step has no weight mask for pad sentinels)"
            )
        if self._resident is None:
            from .device_data import ResidentData

            self._resident = ResidentData(loader, self.device)
            print(
                f"resident training data: {self._resident.n} frames, "
                f"{self._resident.nbytes / 2**20:.1f} MiB on {self.device}"
            )
        res = self._resident
        bsz = loader.batch_size
        order = loader._order(epoch, loader.shuffle)
        n_full = len(order) // bsz
        idx = order[: n_full * bsz].reshape(n_full, bsz)
        timer = StepTimer(bsz)
        pending = []
        group = max(1, self.steps_per_call)
        for s in range(0, n_full, group):
            device_idx = batch_to_device({"idx": idx[s : s + group]}, self.device)["idx"]
            stats = self.resident_train_step(res.audio, res.labels, device_idx)
            for g in range(len(stats["loss"])):
                self.step_total += 1
                timer.step()
                pending.append((self.step_total, {k: v[g] for k, v in stats.items()}))
        self._flush_epoch_stats(pending, timer, epoch)

    def _flush_epoch_stats(self, pending, timer, epoch) -> None:
        """Fetch the epoch's deferred stats in one transfer."""
        if pending:
            fetched = torch.stack([torch.stack([s["loss"], s["acc"]]) for _, s in pending])
            if self.mesh is not None:
                # each rank's mean over its own batch -> the global batch's
                fetched = all_reduce_sum((fetched,), self.mesh)[0] / mesh_size(self.mesh)
            fetched = fetched.cpu()
            for (step_no, _), (loss, acc) in zip(pending, fetched.tolist()):
                self.loss_list.append([step_no, epoch, loss])
                self.accuracy_list.append([step_no, epoch, acc])
                if self.writer is not None:
                    self.writer.add_scalar("loss/train", loss, step_no)
                    self.writer.add_scalar("accuracy/train", acc, step_no)
        print(f"epoch {epoch + 1}: {timer.summary()}", flush=True)
        if self.writer is not None:
            self.writer.add_scalar(
                "perf/train_frames_per_sec", timer.frames_per_sec, self.step_total
            )

    def _log_model_summary(self) -> None:
        """Once per Trainer: the model's modules, their types and parameter
        counts as a text table under ``model/summary`` (the reference logs
        ``writer.add_graph``, train_classifier.py:994-995)."""
        if self._summary_logged:
            return
        self._summary_logged = True
        rows = [("module", "type", "params")]
        for name, mod in self.model.named_modules():
            count = sum(p.numel() for p in mod.parameters(recurse=False))
            rows.append((name or "(model)", type(mod).__name__, str(count)))
        total = sum(p.numel() for p in self.model.parameters())
        rows.append(("total", "", str(total)))
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        table = "\n".join(
            f"{a:<{widths[0]}}  {b:<{widths[1]}}  {c:>{widths[2]}}" for a, b, c in rows)
        self.writer.add_text("model/summary", f"```\n{table}\n```", 0)

    def train(self, max_epochs: int) -> None:
        """Epoch loop with the reference's ckpt/validation cadence
        (train_classifier.py:1021-1053); resumes from ``self.epochs_run``
        when a snapshot was loaded."""
        for epoch in range(self.epochs_run, max_epochs):
            self._run_epoch(epoch)
            if (
                (epoch > 0 and epoch % self.args.ckpt_every == 0)
                or (epoch == 0 and self.args.ckpt_every == 1)
                or (epoch == max_epochs - 1)  # final epoch always snapshots
            ):
                self.save_snapshot(epoch)
            if (epoch > 0 and epoch % self.args.validation_interval == 0) or (
                epoch == 0 and self.args.validation_interval == 1
            ):
                self._run_validation(epoch)
            if epoch == max_epochs - 1:
                print("Training done, now testing...")
                self.test_results = self.testing()
                tr = self.test_results
                print(
                    f"test results: known acc {tr[0] * 100:2.2f} %, "
                    f"known eer {tr[1]:.3f}, unknown acc {tr[2] * 100:2.2f} %, "
                    f"unknown eer {tr[3]:.3f}"
                )

    # ------------------------------------------------------------ evaluation

    def val_test_loop(self, loader, name: str = "") -> Tuple[float, float]:
        """Evaluate a loader; per-batch results stay on the device and are
        fetched once at the end (the reference syncs per batch).  With
        ``device_data`` a resident eval set runs in one call."""
        if self._device_data:
            out = self._resident_eval_loop(loader, name)
            if out is not None:
                return out
        ok_label = None
        count_label = None
        device_results = []
        host_batches = []
        agree(len(loader), self.mesh, f"the number of {name} batches")
        for batch, device_batch in device_prefetch(
            loader.epoch(0, shuffle=False), self.device
        ):
            res = self.eval_step(device_batch)
            if ok_label is None:
                ok_label = res["ok_per_label"].clone()
                count_label = res["count_per_label"].clone()
            else:
                ok_label += res["ok_per_label"]
                count_label += res["count_per_label"]
            device_results.append(
                (res["y"], res["out_max"], res["ok_mask"], res["scores"])
            )
            host_batches.append(
                (
                    np.asarray(batch.get("weight", np.ones(len(batch["label"])))),
                    batch.get("index"),
                )
            )
        if self.mesh is not None:
            return self._eval_finalize_global(
                name, ok_label, count_label, device_results, loader)
        return self._eval_finalize(
            name, ok_label, count_label, device_results, host_batches
        )

    def _eval_finalize_global(self, name, ok_label, count_label, device_results, loader):
        """:meth:`_eval_finalize` over every rank's share of an eval set: the
        per-label counts summed over the ranks, the rows gathered and put in
        dataset order (each row's dataset index rebuilt from the loader's
        order: a batch's frames in order, then its zero-weight pads), so the
        metrics and the true-index dump are a single process's."""
        if ok_label is None:
            return 0.0, 0.0
        ok_label, count_label = all_reduce_sum((ok_label, count_label), self.mesh)
        bsz = loader.batch_size
        order = loader._order(0, False)
        rows = []
        for g in range(len(device_results)):
            idx = order[g * bsz:(g + 1) * bsz]
            idx = idx[idx >= 0]
            rows.append(np.pad(idx, (0, bsz - len(idx)), constant_values=-1))
        local = torch.stack([
            torch.as_tensor(np.concatenate(rows), dtype=torch.float64, device=self.device),
            *(torch.cat([r[k] for r in device_results]).double() for k in range(4)),
        ], dim=1)
        table = all_gather_rows(local, self.mesh).cpu().numpy()
        table = table[table[:, 0] >= 0]
        table = table[np.argsort(table[:, 0], kind="stable")]
        index, y, out_max, ok_mask, scores = table.T
        arrays = (y.astype(np.int64), out_max.astype(np.int64), scores.astype(np.float32))
        true_index = index[ok_mask > 0].astype(np.int64) if loader.include_index else None
        return self._metrics(name, ok_label, count_label, *arrays, true_index)

    def _resident_eval_data(self, loader):
        """The loader's eval set in device memory (cached), or None to
        stream it: an eval set over the cumulative budget streams, with a
        note, since the results are the same either way."""
        if loader in self._resident_eval_cache:
            return self._resident_eval_cache[loader]
        from .device_data import ResidentData

        reserved = sum(
            r.nbytes
            for r in [self._resident, *self._resident_eval_cache.values()]
            if r is not None
        )
        try:
            res = ResidentData(loader, self.device, reserved_bytes=reserved)
        except (ValueError, torch.cuda.OutOfMemoryError) as exc:
            print(f"(resident eval set skipped, streaming instead: {exc})")
            res = None
        self._resident_eval_cache[loader] = res
        return res

    def _resident_eval_loop(self, loader, name: str):
        """A whole eval pass in one call over the resident eval set; the
        last batch's missing rows are ``-1`` sentinels (zero weight on the
        device, masked out on the host by the same ``idx >= 0``).  None:
        stream instead."""
        res = self._resident_eval_data(loader)
        if res is None:
            return None
        bsz = loader.batch_size
        order = loader._order(0, False)
        n = len(order)
        if loader.drop_last:
            n_batches = n // bsz
            flat = order[: n_batches * bsz]
        else:
            n_batches = -(-n // bsz)
            flat = np.full(n_batches * bsz, -1, np.int64)
            flat[:n] = order
        if n_batches == 0:
            return 0.0, 0.0
        idx = flat.reshape(n_batches, bsz)
        stacked = self.resident_eval_step(
            res.audio, res.labels, batch_to_device({"idx": idx}, self.device)["idx"])
        device_results = [
            tuple(stacked[k][g] for k in ("y", "out_max", "ok_mask", "scores"))
            for g in range(n_batches)
        ]
        host_batches = [
            ((idx[g] >= 0).astype(np.float32), idx[g] if loader.include_index else None)
            for g in range(n_batches)
        ]
        return self._eval_finalize(
            name, stacked["ok_per_label"].sum(0), stacked["count_per_label"].sum(0),
            device_results, host_batches,
        )

    def _eval_finalize(
        self, name, ok_label, count_label, device_results, host_batches
    ) -> Tuple[float, float]:
        """Host-side metric computation from accumulated eval results.

        ``device_results``: per-batch ``(y, out_max, ok_mask, scores)``
        tensors; ``host_batches``: per-batch ``(weight, index)`` arrays.
        """
        if ok_label is None:
            return 0.0, 0.0
        ys: List[np.ndarray] = []
        outs: List[np.ndarray] = []
        scores: List[np.ndarray] = []
        true_indices: List[np.ndarray] = []
        for (y_d, out_d, okm_d, sc_d), (weight, index) in zip(
            device_results, host_batches
        ):
            keep = weight > 0
            ys.append(y_d.cpu().numpy()[keep])
            outs.append(out_d.cpu().numpy()[keep])
            scores.append(sc_d.cpu().numpy()[keep])
            if index is not None:
                ok_mask = okm_d.cpu().numpy()[keep]
                true_indices.append(np.asarray(index)[keep][ok_mask])

        y_arr = np.concatenate(ys) if ys else np.zeros(0)
        out_arr = np.concatenate(outs) if outs else np.zeros(0)
        score_arr = np.concatenate(scores) if scores else np.zeros(0)
        true_index = np.concatenate(true_indices) if true_indices else None
        return self._metrics(name, ok_label, count_label, y_arr, out_arr, score_arr,
                             true_index)

    def _metrics(self, name, ok_label, count_label, y_arr, out_arr, score_arr,
                 true_index) -> Tuple[float, float]:
        """Accuracy tables, EER and the true-index dump of one eval pass
        from its counts and rows."""
        if torch.is_tensor(ok_label):
            ok_label = ok_label.cpu().numpy()
            count_label = count_label.cpu().numpy()
        ok_dict, count_dict = dense_counts_to_dicts(ok_label, count_label)
        acc_list = [
            (
                self.label_names.get(k, f"John Doe Generator {k}"),
                calculate_acc_label([count_dict], [ok_dict], k),
            )
            for k in sorted(count_dict)
        ]
        print(f"{name} - ", acc_list)
        # argmax decisions: parity with the reference
        # (train_classifier.py:479-481); NaN instead of a crash on
        # degenerate (single-class) eval sets.
        eer = safe_eer(y_arr, out_arr, what=f"{name} eer")
        score_eer = safe_eer(y_arr, score_arr, what=f"{name} score-eer")
        val_acc = float(ok_label.sum() / max(count_label.sum(), 1.0))
        print(
            f"{name} - eer: {eer:2.4f} (score eer: {score_eer:2.4f}), "
            f"Val acc: {val_acc * 100:2.2f} %"
        )
        if true_index is not None:
            self.current_true_indices[name] = true_index
        self.validation_list.append([name, val_acc, eer])
        return val_acc, eer

    def _run_validation(self, epoch: int) -> None:
        val_acc, val_eer = self.val_test_loop(self.val_loader, name="val known")
        cr_val_acc = cr_val_eer = 0.0
        if self.cross_loader_val is not None:
            cr_val_acc, cr_val_eer = self.val_test_loop(
                self.cross_loader_val, name="val unknown"
            )
        self.log_validation(epoch, (val_acc, val_eer), (cr_val_acc, cr_val_eer))

    def log_validation(self, epoch: int, known: tuple, unknown: tuple) -> None:
        """The validation tags of one epoch: ``(acc, eer)`` of the known and
        the cross validation sets."""
        if self.writer is None:
            return
        self.writer.add_scalar("accuracy/validation", known[0], self.step_total)
        self.writer.add_scalar("eer/validation", known[1], self.step_total)
        self.writer.add_scalar("accuracy/cross_validation", unknown[0], self.step_total)
        self.writer.add_scalar("eer/cross_validation", unknown[1], self.step_total)
        self.writer.add_scalar("epochs", epoch, self.step_total)

    def log_test(self, results: tuple) -> None:
        """The test tags: ``(acc, eer, cross acc, cross eer)``."""
        if self.writer is None:
            return
        for tag, value in zip(
            ("accuracy/test", "eer/test", "accuracy/cross_test", "eer/cross_test"),
            results,
        ):
            self.writer.add_scalar(tag, value, self.step_total)

    def testing(self, only_unknown: bool = False) -> Tuple[float, float, float, float]:
        if not only_unknown:
            test_acc, test_eer = self.val_test_loop(self.test_loader, name="test known")
        else:
            test_acc = test_eer = 0.0
        if self.cross_loader_test is not None:
            cr_acc, cr_eer = self.val_test_loop(
                self.cross_loader_test, name="test unknown"
            )
        else:
            cr_acc = cr_eer = 0.0
        self.log_test((test_acc, test_eer, cr_acc, cr_eer))
        return test_acc, test_eer, cr_acc, cr_eer

    # ----------------------------------------------------------- checkpoints

    def model_state(self) -> dict:
        """The reference-layout state dict on the CPU (under FSDP gathered
        from the shards: every rank calls it, rank 0 gets it)."""
        if self._sharded:
            from ..parallel.fsdp import full_model_state

            return full_model_state(self.model)
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    def optimizer_state(self) -> dict:
        """``optimizer.state_dict()``, whole (under FSDP gathered: every
        rank calls it, rank 0 gets it, keyed by parameter index as a
        single-device run's)."""
        if self._sharded:
            from ..parallel.fsdp import full_optimizer_state

            return full_optimizer_state(self.model, self.optimizer)
        return self.optimizer.state_dict()

    def _rng_states(self) -> dict:
        states = {"aug_generator": self.aug_generator.get_state(),
                  "torch_rng": torch.get_rng_state()}
        if self.device.type == "cuda":
            states["cuda_rng"] = torch.cuda.get_rng_state(self.device)
        return states

    def save_snapshot(self, epoch: int) -> None:
        """Write the reference-layout ``.pt`` snapshot, its ``.norm.pkl``
        and the full state for ``--resume`` (on a mesh: gathered by every
        rank, written by rank 0 while the others wait)."""
        model_state = self.model_state()
        blob = self.full_state(epoch, model_state, self.optimizer_state())
        if is_lead():
            self._write_snapshot(epoch, model_state, blob)
        barrier()

    def _write_snapshot(self, epoch: int, model_state: dict, blob: dict) -> None:
        _save_atomically(
            {"MODEL_STATE": model_state, "EPOCHS_RUN": epoch}, self.snapshot_path
        )
        if self.norm_stats is not None:
            # build_scorer_from_snapshot loads <snapshot>.norm.pkl by itself
            mean, std = self.norm_stats
            with open(self.snapshot_path + ".norm.pkl", "wb") as fh:
                pickle.dump(
                    [np.asarray(mean, np.float32), np.asarray(std, np.float32)],
                    fh,
                )
        _save_atomically(blob, self.state_path)
        print(f"Epoch {epoch + 1} | Training snapshot saved at {self.snapshot_path}")

    def full_state(self, epoch: int, model_state=None, optimizer_state=None) -> dict:
        """The ``.state.pt`` blob: model, optimizer, epoch, step and the
        random streams (the device's default generators included; on a
        mesh every rank's, as ``rank_rng``)."""
        if model_state is None:
            model_state = self.model_state()
        full_state = {
            "model": model_state,
            "optimizer": self.optimizer_state() if optimizer_state is None else optimizer_state,
            "epoch": epoch,
            "step": self.step_total,
            **self._rng_states(),
        }
        if self.mesh is not None:
            import torch.distributed as dist

            ranks = [None] * mesh_size(self.mesh)
            dist.all_gather_object(ranks, self._rng_states(), group=mesh_group(self.mesh))
            full_state["rank_rng"] = ranks
        return full_state

    def load_full_state(self, blob: dict) -> None:
        """Install a :meth:`full_state` blob; ``train()`` then continues
        from the epoch after the stored one.  Every rank of a mesh loads the
        same blob and takes its own random streams from it when it holds
        one for each rank (else rank 0's)."""
        self.load_variables(blob["model"])
        if self._sharded:
            from ..parallel.fsdp import load_full_optimizer_state

            load_full_optimizer_state(self.model, self.optimizer, blob["optimizer"])
        else:
            self.optimizer.load_state_dict(blob["optimizer"])
        rng = blob
        ranks = blob.get("rank_rng")
        if ranks is not None and len(ranks) == mesh_size(self.mesh):
            rng = ranks[self.rank]
        self.aug_generator.set_state(rng["aug_generator"])
        torch.set_rng_state(rng["torch_rng"])
        if self.device.type == "cuda" and "cuda_rng" in rng:
            torch.cuda.set_rng_state(rng["cuda_rng"], self.device)
        # the stored epoch is the COMPLETED epoch's index: running it
        # again would apply its gradients twice
        self.epochs_run = int(blob["epoch"]) + 1
        self.step_total = int(blob["step"])

    def load_snapshot(self, snapshot_path: Optional[str] = None) -> None:
        """Restore the full state (``.state.pt``) or the weights only
        (``.pt``); ``train()`` then continues from the epoch after the
        stored one.  An explicit ``snapshot_path`` names the ``.pt``; its
        full state is looked for beside it."""
        from ..models.torch_import import (
            import_dcnn,
            import_lcnn,
            import_timm_deit,
            load_epochs_run,
            load_torch_state_dict,
        )

        path = snapshot_path or self.snapshot_path
        base = path[: -len(".pt")] if path.endswith(".pt") else path
        state_path = base + ".state.pt"
        if os.path.exists(state_path):
            self.load_full_state(
                torch.load(state_path, map_location="cpu", weights_only=True))
        else:
            model = self.model
            if self.args.model == "lcnn":
                importer = import_lcnn
            elif getattr(model, "get_name", lambda: "")() == "AST":
                # the reference's surgery with this model's geometry (a
                # trained AST's pos_embed is already adapted and passes)
                def importer(state):
                    return import_timm_deit(
                        state, fstride=model.fstride, tstride=model.tstride,
                        input_fdim=model.input_fdim, input_tdim=model.input_tdim,
                        model_size=model.model_size,
                    )
            else:
                importer = import_dcnn
            self.load_variables(importer(load_torch_state_dict(path)))
            # EPOCHS_RUN holds the completed epoch's index (-1 if absent)
            self.epochs_run = load_epochs_run(path) + 1
