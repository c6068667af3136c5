"""Vectorized multi-seed sweep runner: train S grid seeds in one run.

Counterpart of ``audiodeepfake_detection_tpu/train/sweep.py``.  The
reference's grid loop runs each seed as a full independent training run
(reference: src/audiofakedetect/train_classifier.py:1147 loops the
cartesian grid whose first axis is the seed list, utils.py:505-513).  This
runner drives the :mod:`train.vectorized` steps through the standard epoch
/ validation / checkpoint cadence, and leaves everything per seed (metrics,
EER tables, snapshots, true-index dumps) to S ordinary per-seed
:class:`~.trainer.Trainer` "shadows": after each epoch every shadow
receives its slice (:func:`~.vectorized.state_for_seed`), so each seed's
``.pt`` / ``.state.pt`` is the serial layout and ``--resume`` of a sweep
goes through ``Trainer.load_snapshot`` unchanged.

Parity: each seed sees its own init, random streams, optimizer moments,
BatchNorm running statistics and data order (per-seed shuffled loaders),
so in ``"scan"`` mode the per-seed states equal the serial grid's bit for
bit, and in ``"vmap"`` mode within the float error of a reordered sum.

The seed axis runs as ``"scan"`` whatever the model, where the JAX sweep
vmaps a model with no fused flag on: ``"scan"`` is exact with dropout on,
never hands a kernel a vmapped tensor, and on the card runs no slower than
the serial runs, where ``"vmap"`` runs slower (see
:mod:`.vectorized`).  ``seed_axis="vmap"`` asks for the JAX package's mode.

With streamed batches ``steps_per_call`` changes nothing: each step takes
its own ``[S, B, ...]`` copy, which ``device_prefetch`` overlaps with the
step before, and G steps a call would evolve exactly as G single steps.

The JAX sweep's zero-slope guard (it moves a fused model to the unfused
path when a PReLU slope is exactly 0) is not ported: the port's kernels
return the true ``dalpha`` at a zero slope, so there is nothing to guard.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch

from ..data.loader import device_prefetch
from .profiling import StepTimer
from .vectorized import (
    make_vectorized_eval_step,
    make_vectorized_train_step,
    multi_seed_epoch,
    stack_seed_states,
    state_for_seed,
)

__all__ = ["VectorizedSeedSweep"]


def check_one_device(args) -> None:
    """The sweep composes with one device only, as JAX's composes with one
    mesh: ``fsdp`` / ``pp_stages`` off, and no process group of more than
    one rank (``ValueError``: main then runs the group serially)."""
    from ..data.frame_cache import rank_and_world

    world = rank_and_world()[1]
    if bool(args.get("fsdp")) or int(args.get("pp_stages") or 1) > 1 or world > 1:
        raise ValueError(
            "vmap_seeds composes with one device only (fsdp / pp_stages must be "
            f"off, and one rank: this world has {world})")


class VectorizedSeedSweep:
    """Drive S shadow Trainers through one vectorized training run.

    ``shadows`` are per-seed Trainers (same model configuration, transform,
    device and hyper-parameters except seed, learning rate and weight
    decay), each holding its seed's initial model; ``train_loaders`` are
    the per-seed shuffled train loaders, index-aligned with ``shadows``;
    ``seed_axis``: ``"scan"`` or ``"vmap"`` (:mod:`.vectorized`).
    """

    def __init__(self, shadows: Sequence, train_loaders: Sequence,
                 seed_axis: str = "scan") -> None:
        if len(shadows) != len(train_loaders):
            raise ValueError("one train loader per shadow Trainer required")
        if not shadows:
            raise ValueError("at least one seed required")
        self.shadows = list(shadows)
        self.train_loaders = list(train_loaders)
        lead = self.shadows[0]
        self.model = lead.model
        self.transform = lead.transform
        self.args = lead.args
        self.device = lead.device
        self.seeds = [int(sh.args.seed or 0) for sh in self.shadows]
        check_one_device(self.args)
        if bool(self.args.get("device_data")):
            # main's serial fallback for the group honours device_data
            raise ValueError(
                "vmap_seeds streams per-seed batch orders; device_data "
                "(device-resident frames) is a serial-trainer feature"
            )
        self.seed_axis = seed_axis
        self.moment_dtype = self.args.get("adam_moments_dtype") or None
        self.vstate = stack_seed_states(
            [self._fresh_state(sh) for sh in self.shadows], self.model,
            seed_axis=self.seed_axis, moment_dtype=self.moment_dtype)
        self.step_total = 0
        self._build_steps()

    @staticmethod
    def _fresh_state(shadow) -> dict:
        """A shadow's initial state, its dropout stream seeded as the serial
        ``Trainer.init_state`` seeds it."""
        torch.manual_seed(int(shadow.args.seed or 0))
        return shadow.full_state(-1)

    def _build_steps(self) -> None:
        aug = dict(
            aug_contrast=bool(self.args.aug_contrast),
            aug_noise=bool(self.args.aug_noise),
            grad_accum=int(self.args.get("grad_accum") or 1),
        )
        self.train_step = make_vectorized_train_step(self.vstate, self.transform, **aug)
        self.eval_step = make_vectorized_eval_step(self.vstate, self.transform)

    # ------------------------------------------------------------- lifecycle

    def _push_states(self, epoch: int) -> None:
        """Install each slice in its shadow Trainer."""
        for i, sh in enumerate(self.shadows):
            with self.vstate.slice_rng(i):
                sh.load_full_state({**state_for_seed(self.vstate, i), "epoch": epoch})

    def _try_resume(self) -> int:
        """Resume an interrupted sweep from the per-seed snapshots (each
        shadow through ``Trainer.load_snapshot``, the serial ladder: full
        state, else weights only).  All slices must sit at one epoch, else
        the sweep starts fresh.  Returns the epoch to resume from."""
        if not all(os.path.exists(sh.state_path) or os.path.exists(sh.snapshot_path)
                   for sh in self.shadows):
            return 0
        try:
            states = []
            for sh in self.shadows:
                sh.load_snapshot()
                # read right after the load: the default generators hold
                # this shadow's streams now
                states.append(sh.full_state(sh.epochs_run - 1))
            epochs = {sh.epochs_run for sh in self.shadows}
            if len(epochs) != 1:
                print("(sweep resume skipped: per-seed snapshots at "
                      f"different epochs {sorted(epochs)})")
                return 0
            vstate = stack_seed_states(states, self.model, seed_axis=self.seed_axis,
                                       moment_dtype=self.moment_dtype)
        except (OSError, RuntimeError, KeyError, ValueError) as exc:
            print(f"(sweep resume skipped: {exc})")
            return 0
        self.vstate = vstate
        self.step_total = vstate.step
        self._build_steps()
        start = epochs.pop()
        print(f"sweep resume: restored {len(self.shadows)} seed snapshots "
              f"({start} completed epoch(s)); continuing")
        return start

    # -------------------------------------------------------------- training

    def _run_epoch(self, epoch: int) -> None:
        print(
            f"+--------------- Epoch {epoch + 1} "
            f"({len(self.seeds)} seeds vectorized) ---------------+",
            flush=True,
        )
        # frames/s: every step advances S seeds x B frames
        timer = StepTimer(self.train_loaders[0].batch_size * len(self.seeds))
        pending: List[tuple] = []
        for _, device_batch in device_prefetch(
            multi_seed_epoch(self.train_loaders, epoch), self.device
        ):
            stats = self.train_step(device_batch)
            self.step_total += 1
            timer.step()
            pending.append((self.step_total, stats))

        # one fetch for the epoch's stats; fan out per seed
        if pending:
            fetched = torch.stack(
                [torch.stack([s["loss"], s["acc"]]) for _, s in pending]).cpu().numpy()
            for (step_no, _), (loss, acc) in zip(pending, fetched):
                for i, sh in enumerate(self.shadows):
                    sh.loss_list.append([step_no, epoch, float(loss[i])])
                    sh.accuracy_list.append([step_no, epoch, float(acc[i])])
                    if sh.writer is not None:
                        sh.writer.add_scalar("loss/train", float(loss[i]), step_no)
                        sh.writer.add_scalar("accuracy/train", float(acc[i]), step_no)
        print(f"epoch {epoch + 1}: {timer.summary()}", flush=True)

    # ------------------------------------------------------------ evaluation

    def _vectorized_eval(self, loader, name: str) -> List[tuple]:
        """ONE pass over ``loader`` evaluates every seed (eval order does
        not depend on the seed, so the batches are shared); each seed's
        metrics go through its shadow's ``_eval_finalize``.  Returns
        per-seed ``(acc, eer)``."""
        ok = cnt = None
        device_results = []  # per batch: (y, out_max, ok_mask, scores), [S, B]
        host_batches = []
        for batch, device_batch in device_prefetch(
            loader.epoch(0, shuffle=False), self.device
        ):
            res = self.eval_step(device_batch)
            ok = res["ok_per_label"] if ok is None else ok + res["ok_per_label"]
            cnt = res["count_per_label"] if cnt is None else cnt + res["count_per_label"]
            device_results.append((res["y"], res["out_max"], res["ok_mask"], res["scores"]))
            host_batches.append((
                np.asarray(batch.get("weight", np.ones(len(batch["label"])))),
                batch.get("index"),
            ))
        if ok is None:
            return [(0.0, 0.0) for _ in self.shadows]
        # fetch once, then slice per seed on the host
        ok, cnt = ok.cpu(), cnt.cpu()
        fetched = [tuple(t.cpu() for t in res) for res in device_results]
        out = []
        for i, sh in enumerate(self.shadows):
            print(f"--- seed {sh.args.seed} ---")
            per_seed = [tuple(t[i] for t in res) for res in fetched]
            out.append(sh._eval_finalize(name, ok[i], cnt[i], per_seed, host_batches))
        return out

    def _run_validation(self, epoch: int) -> None:
        """Trainer._run_validation, one vectorized pass per loader; each
        shadow's writer gets its seed's validation tags."""
        lead = self.shadows[0]
        known = self._vectorized_eval(lead.val_loader, "val known")
        unknown = [(0.0, 0.0)] * len(self.shadows)
        if lead.cross_loader_val is not None:
            unknown = self._vectorized_eval(lead.cross_loader_val, "val unknown")
        for sh, k, u in zip(self.shadows, known, unknown):
            sh.log_validation(epoch, k, u)  # at the step _push_states gave it

    def _testing(self) -> None:
        """Trainer.testing, one vectorized pass per loader."""
        lead = self.shadows[0]
        known = self._vectorized_eval(lead.test_loader, "test known")
        unknown = [(0.0, 0.0)] * len(self.shadows)
        if lead.cross_loader_test is not None:
            unknown = self._vectorized_eval(lead.cross_loader_test, "test unknown")
        for sh, (ta, te), (ca, ce) in zip(self.shadows, known, unknown):
            sh.test_results = (ta, te, ca, ce)
            sh.log_test(sh.test_results)
            print(
                f"seed {sh.args.seed} test results: "
                f"known acc {ta * 100:2.2f} %, known eer {te:.3f}, "
                f"unknown acc {ca * 100:2.2f} %, unknown eer {ce:.3f}"
            )

    def train(self, max_epochs: int) -> None:
        """Epoch loop with the reference's ckpt/validation cadence
        (reference train_classifier.py:1021-1053), vectorized over seeds;
        snapshots go through the shadows, validation and testing through one
        vectorized eval pass per loader.  With the ``resume`` flag an
        interrupted sweep restores the per-seed snapshots and continues."""
        args = self.args
        start_epoch = self._try_resume() if bool(args.get("resume")) else 0
        for epoch in range(start_epoch, max_epochs):
            self._run_epoch(epoch)
            self._push_states(epoch)
            if (
                (epoch > 0 and epoch % args.ckpt_every == 0)
                or (epoch == 0 and args.ckpt_every == 1)
                or (epoch == max_epochs - 1)
            ):
                for i, sh in enumerate(self.shadows):
                    with self.vstate.slice_rng(i):  # the seed's own streams
                        sh.save_snapshot(epoch)
            if (epoch > 0 and epoch % args.validation_interval == 0) or (
                epoch == 0 and args.validation_interval == 1
            ):
                self._run_validation(epoch)
            if epoch == max_epochs - 1:
                print("Training done, now testing...")
                self._testing()
