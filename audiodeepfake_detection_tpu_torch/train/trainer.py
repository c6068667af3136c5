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
  ``import_dcnn`` load) with its ``.norm.pkl`` sidecar, plus one
  ``.state.pt`` holding model, optimizer, epoch, step and generator states
  for ``--resume``;
* EER and the per-label accuracy tables are computed on the host from the
  gathered arrays, with the reference's argmax-EER definition
  (train_classifier.py:479-481).

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP slice:
``fsdp`` and ``pp_stages > 1`` (slice 7), ``device_data``,
``steps_per_call > 1``, ``vmap_seeds`` / ``vmap_hparams`` (slice 8), and the
tensorboard writer (slice 9).
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.loader import device_prefetch
from ..utils.config import DotDict
from .metrics import calculate_acc_label, dense_counts_to_dicts, safe_eer
from .predict import resolve_device
from .profiling import StepTimer
from .steps import make_eval_step, make_optimizer, make_train_step

_NOT_PORTED = (
    # (args key, is it switched on, ROADMAP slice)
    ("fsdp", bool, "slice 7: distributed"),
    ("pp_stages", lambda v: int(v or 1) > 1, "slice 7: distributed"),
    ("device_data", bool, "slice 8: sweeps and resident data"),
    ("steps_per_call", lambda v: int(v or 1) > 1, "slice 8: sweeps and resident data"),
    ("vmap_seeds", bool, "slice 8: sweeps and resident data"),
    ("vmap_hparams", bool, "slice 8: sweeps and resident data"),
)


def _save_atomically(obj, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class Trainer:
    """Train / evaluate a classifier on one device."""

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
    ) -> None:
        for key, is_on, where in _NOT_PORTED:
            if is_on(args.get(key)):
                raise NotImplementedError(
                    f"{key}={args.get(key)!r} is not ported yet (ROADMAP.md "
                    f"queue 1, {where})"
                )
        self.device = resolve_device(device)
        # fp32 convolutions and products, like the JAX reference's HIGHEST
        # precision (TF32 keeps about three decimal digits)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.to(self.device)
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

        grad_accum = int(args.get("grad_accum") or 1)
        if grad_accum > 1 and args.batch_size % grad_accum:
            raise ValueError(
                f"batch_size {args.batch_size} not divisible by "
                f"grad_accum {grad_accum}"
            )
        self.grad_accum = grad_accum

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
        ``args.seed``."""
        args = self.args
        seed = int(args.seed or 0)
        torch.manual_seed(seed)
        self.aug_generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = make_optimizer(
            self.model.parameters(),
            args.learning_rate,
            args.weight_decay,
            moment_dtype=args.get("adam_moments_dtype") or None,
        )
        self.train_step = make_train_step(
            self.model,
            self.transform,
            self.optimizer,
            aug_contrast=bool(args.aug_contrast),
            aug_noise=bool(args.aug_noise),
            grad_accum=self.grad_accum,
            generator=self.aug_generator,
        )
        self.eval_step = make_eval_step(self.model, self.transform)

    def load_variables(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Install imported weights (e.g. from a ``.pt`` snapshot) and start
        the optimizer afresh."""
        self.model.load_state_dict(state_dict, strict=True)
        self.init_state()

    # ------------------------------------------------------------- training

    def _run_epoch(self, epoch: int) -> None:
        print(f"+------------------- Epoch {epoch + 1} -------------------+", flush=True)
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

    def _flush_epoch_stats(self, pending, timer, epoch) -> None:
        """Fetch the epoch's deferred stats in one transfer."""
        if pending:
            fetched = torch.stack(
                [torch.stack([s["loss"], s["acc"]]) for _, s in pending]
            ).cpu()
            for (step_no, _), (loss, acc) in zip(pending, fetched.tolist()):
                self.loss_list.append([step_no, epoch, loss])
                self.accuracy_list.append([step_no, epoch, acc])
        print(f"epoch {epoch + 1}: {timer.summary()}", flush=True)

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
        fetched once at the end (the reference syncs per batch)."""
        ok_label = None
        count_label = None
        device_results = []
        host_batches = []
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
        return self._eval_finalize(
            name, ok_label, count_label, device_results, host_batches
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
        ok_label = ok_label.cpu().numpy()
        count_label = count_label.cpu().numpy()
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
        if true_indices:
            self.current_true_indices[name] = np.concatenate(true_indices)
        self.validation_list.append([name, val_acc, eer])
        return val_acc, eer

    def _run_validation(self, epoch: int) -> None:
        self.val_test_loop(self.val_loader, name="val known")
        if self.cross_loader_val is not None:
            self.val_test_loop(self.cross_loader_val, name="val unknown")

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
        return test_acc, test_eer, cr_acc, cr_eer

    # ----------------------------------------------------------- checkpoints

    def save_snapshot(self, epoch: int) -> None:
        """Write the reference-layout ``.pt`` snapshot, its ``.norm.pkl``
        and the full state for ``--resume``."""
        model_state = {
            k: v.detach().cpu() for k, v in self.model.state_dict().items()
        }
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
        full_state = {
            "model": model_state,
            "optimizer": self.optimizer.state_dict(),
            "epoch": epoch,
            "step": self.step_total,
            "aug_generator": self.aug_generator.get_state(),
            "torch_rng": torch.get_rng_state(),
        }
        if self.device.type == "cuda":
            full_state["cuda_rng"] = torch.cuda.get_rng_state(self.device)
        _save_atomically(full_state, self.state_path)
        print(f"Epoch {epoch + 1} | Training snapshot saved at {self.snapshot_path}")

    def load_snapshot(self, snapshot_path: Optional[str] = None) -> None:
        """Restore the full state (``.state.pt``) or the weights only
        (``.pt``); ``train()`` then continues from the epoch after the
        stored one.  An explicit ``snapshot_path`` names the ``.pt``; its
        full state is looked for beside it."""
        from ..models.torch_import import (
            import_dcnn,
            load_epochs_run,
            load_torch_state_dict,
        )

        path = snapshot_path or self.snapshot_path
        base = path[: -len(".pt")] if path.endswith(".pt") else path
        state_path = base + ".state.pt"
        if os.path.exists(state_path):
            blob = torch.load(state_path, map_location="cpu", weights_only=True)
            self.load_variables(blob["model"])
            self.optimizer.load_state_dict(blob["optimizer"])
            self.aug_generator.set_state(blob["aug_generator"])
            torch.set_rng_state(blob["torch_rng"])
            if self.device.type == "cuda" and "cuda_rng" in blob:
                torch.cuda.set_rng_state(blob["cuda_rng"], self.device)
            # the stored epoch is the COMPLETED epoch's index: running it
            # again would apply its gradients twice
            self.epochs_run = int(blob["epoch"]) + 1
            self.step_total = int(blob["step"])
        else:
            self.load_variables(import_dcnn(load_torch_state_dict(path)))
            # EPOCHS_RUN holds the completed epoch's index (-1 if absent)
            self.epochs_run = load_epochs_run(path) + 1
