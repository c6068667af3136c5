"""Training on device-resident batches, back to back through the port's
``make_train_step``.

Mix parameters: ``batch`` (frames a step), ``batches`` (distinct batches
held on the device; the steps cycle through them), ``check_steps`` (the
first steps, which the reference redoes), ``norm_batches`` (batches the
normalization pass reads).

Set-up draws the weights and the audio from the seed, runs the program's
normalization pass, builds one model, optimizer and step, and drives that
step through the first ``check_steps`` batches (all different).  Those
steps warm every shape; their losses, the first gradient as Adam holds it
and the parameters' change after them are what the check compares.  The
window then runs the same step on, and ends on a synchronize after its
last step.
"""

from __future__ import annotations

import time

import torch

from gpubench import cells, inputs, port, stats
from gpubench.reference import _common


class Run:
    def __init__(self, cell: cells.Cell, seed: int, device, seconds: float) -> None:
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.mix = cell.config, cell.mix
        self.batch = int(self.mix["batch"])

    # ------------------------------------------------------------ set-up

    def frames(self, i: int):
        j = i % int(self.mix["batches"])
        s = slice(j * self.batch, (j + 1) * self.batch)
        return {"audio": self.audio[s], "label": self.labels[s]}

    def setup(self) -> None:
        cfg, mix = self.cfg, self.mix
        self.marks = [("start", time.perf_counter())]
        self.model = port.model(cfg, self.device, train=True)
        self.weights = inputs.make_weights(port.shapes(self.model), self.seed, self.device)
        self.model.load_state_dict(self.weights)
        self.marks.append(("model and weights", time.perf_counter()))
        self.audio, self.labels = inputs.make_audio(
            int(mix["batches"]) * self.batch, cfg["frame_samples"], cfg["sample_rate"],
            self.seed, self.device)
        self.marks.append(("audio", time.perf_counter()))
        norm_audio = self.audio[: int(mix["norm_batches"]) * self.batch]
        self.mean, self.std = port.normalization(cfg, norm_audio, self.batch)
        self.marks.append(("normalization", time.perf_counter()))
        self.step, self.optimizer = port.train_step(cfg, self.model, self.mean, self.std)
        self.marks.append(("optimizer and step", time.perf_counter()))
        self.readings = self.first_steps(int(mix["check_steps"]))
        self.next = int(mix["check_steps"])

    def first_steps(self, n: int) -> dict:
        """Run the first ``n`` steps; the losses, the first gradient's leaf
        norms (from Adam's first moment) and the leaves' change norms."""
        params = dict(self.model.named_parameters())
        before = {k: p.detach().clone() for k, p in params.items()}
        losses, grads = [], {}
        for i in range(n):
            losses.append(self.step(self.frames(i))["loss"])
            if i == 0:
                b1 = self.optimizer.param_groups[0]["betas"][0]
                state = self.optimizer.state
                grads = {k: (state[p]["exp_avg"] / (1 - b1)).norm() if p in state else 0.0
                         for k, p in params.items()}
        change = {k: (p.detach() - before[k]).norm() for k, p in params.items()}
        return {"losses": [float(x) for x in losses],
                "grad_norms": {k: float(v) for k, v in grads.items()},
                "change_norms": {k: float(v) for k, v in change.items()}}

    # ------------------------------------------------------------ window

    def window(self, seconds: float, tracer) -> dict:
        steps = 0
        # the profiler takes seconds to start: before the window, not in it
        tracer.start(steps=0)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step(self.frames(self.next + steps))
            steps += 1
            if tracer.due():
                tracer.stop(steps=steps)
        inputs.sync(self.device)
        wall = time.perf_counter() - t0
        tracer.stop(steps=steps)
        return {"metrics": {"train_frames_per_s": steps * self.batch / wall},
                "attempted": steps, "failed": 0}

    def trace_counts(self, tracer) -> dict:
        return {"steps": tracer.delta("steps"), "batch": self.batch}

    # ------------------------------------------------------------ check

    def free(self) -> None:
        del self.step, self.optimizer, self.model
        torch.cuda.empty_cache()

    def reference(self, tf32: bool = False) -> dict:
        ref = cells.reference_module(self.cfg["name"])
        blocks = int(self.mix["norm_batches"])
        with _common.float32_products(), torch.no_grad():
            mean, std = _common.norm_stats(
                lambda i: ref.transform(self.frames(i)["audio"], tf32), blocks)
        batches = [(self.frames(i)["audio"], self.frames(i)["label"])
                   for i in range(int(self.mix["check_steps"]))]
        opt = self.cfg["optimizer"]
        return _common.train_steps(ref.forward, ref.transform, self.weights, batches, mean, std,
                                   opt["learning_rate"], opt["weight_decay"], tf32)

    def numbers(self, got: dict, want: dict) -> dict:
        """The compared numbers of ``got`` against ``want``."""
        return {
            "loss_gap": stats.loss_gap(got["losses"], want["losses"]),
            "grad_gap": stats.worst_leaf_gap(got["grad_norms"], want["grad_norms"]),
            "update_gap": stats.worst_leaf_gap(got["change_norms"], want["change_norms"],
                                               stats.moved_leaves(want["grad_norms"])),
        }

    def detail(self, want: dict) -> dict:
        """The losses of both sides and the three worst leaves of each norm."""
        got = self.readings
        grad = stats.leaf_gaps(got["grad_norms"], want["grad_norms"])
        change = stats.leaf_gaps(got["change_norms"], want["change_norms"],
                                 stats.moved_leaves(want["grad_norms"]))
        return {"losses": [got["losses"], want["losses"]],
                "grad": sorted(grad.items(), key=lambda kv: -kv[1])[:3],
                "update": sorted(change.items(), key=lambda kv: -kv[1])[:3]}

    def check(self, control: bool = False) -> dict:
        """The program's numbers against the reference; with ``control``
        also the control's (the reference in TF32) as ``"control"``."""
        want = self.reference()
        out = {"program": self.numbers(self.readings, want), "detail": self.detail(want)}
        if control:
            out["control"] = self.numbers(self.reference(tf32=True), want)
        return out
