"""Faults planted under the harness, to show that the check catches them.

Each is a context manager that patches the program as the harness reaches
it (``port``), so a run inside it drives the timed path broken underneath:

* ``unchanged``: the optimizer's step does nothing (a step that returns
  its state unchanged);
* ``half_batch``: the step, or the scorer's dispatch, sees only the first
  half of its batch (the mean taken over the rest; the other frames of a
  dispatch scored as silence);
* ``altered``: one answer altered where it is produced (the model's first
  logit row in training, the first score of every dispatch in serving).

One chip holds every cell, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib

import torch

from gpubench import port

TRAIN = ("unchanged", "half_batch", "altered")
SERVE = ("half_batch", "altered")


@contextlib.contextmanager
def _patched(name: str, wrap):
    orig = getattr(port, name)
    setattr(port, name, wrap(orig))
    try:
        yield
    finally:
        setattr(port, name, orig)


def _altered_logits(net):
    """The first row's last logit raised by 1 as the model produces it."""
    def hook(mod, args, out):
        delta = torch.zeros_like(out)
        delta[0, -1] = 1.0
        return out + delta

    net.register_forward_hook(hook)


def planted(fault: str, serve: bool):
    if serve:
        def wrap(service):
            def build(*args, **kw):
                svc = service(*args, **kw)
                if fault == "half_batch":
                    host_batch = svc._host_batch

                    def half(frames):
                        batch = host_batch(frames)
                        batch[batch.shape[0] // 2:] = 0
                        return batch

                    svc._host_batch = half
                elif fault == "altered":
                    score = svc._score
                    svc._score = lambda x: score(x) + torch.nn.functional.pad(
                        torch.full((1,), 0.01, device=svc.device), (0, x.shape[0] - 1))
                else:
                    raise ValueError(f"no serving fault {fault!r}")
                return svc
            return build
        return _patched("service", wrap)

    def wrap(train_step):
        def build(cfg, net, mean, std):
            if fault == "altered":
                _altered_logits(net)
            step, optimizer = train_step(cfg, net, mean, std)
            if fault == "unchanged":
                optimizer.step = lambda closure=None: None
            elif fault == "half_batch":
                full = step

                def step(batch):
                    return full({k: v[: v.shape[0] // 2] for k, v in batch.items()})
            elif fault != "altered":
                raise ValueError(f"no training fault {fault!r}")
            return step, optimizer
        return build
    return _patched("train_step", wrap)
