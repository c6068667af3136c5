"""Grid-vectorized training: S seeds (or lr / wd points) of one
configuration advanced by one step function.

Counterpart of ``audiodeepfake_detection_tpu/train/vectorized.py``.  The
reference's headline result is a grid averaged over 5 seeds (reference:
src/audiofakedetect/utils.py:505-513 prepends the seed list as a grid
axis), trained strictly serially.  Here one step advances every slice.

The contract is the JAX package's: each slice keeps its own initial
weights, parameters, Adam state, BatchNorm buffers, random streams and data
order (each seed's loader shuffles with its own seed), and equals the serial
run of its seed.  A :class:`VectorizedState` holds S models (slice ``i``
built as ``run_experiment`` builds seed ``i``'s), ONE optimizer with a
parameter group per slice over that slice's own leaf tensors
(:func:`make_hyper_optimizer`: per-slice lr / wd with no arithmetic of its
own), a generator per slice for augmentation and per slice the state of the
device's default generator, which dropout draws from.

Two modes for the seed axis (``seed_axis``):

* ``"scan"`` (the default, and the sweep's): a Python loop over the slices
  inside one step, each slice's default-generator state swapped in around
  its forward and backward, so a slice repeats its serial run bit for bit,
  dropout on; the fused kernels run at full width once per slice.  On an
  NVIDIA H100 (700 W) a step of three fused DCNN seeds takes what three
  serial steps take.
* ``"vmap"``: ``torch.func.vmap`` over ``functional_call``, the JAX
  package's mode.  The parameters are stacked each step with
  ``torch.stack`` (differentiable, so the gradients land on the slices' own
  leaves) and the BatchNorm buffers ``[S, ...]`` once, the slices' buffers
  views of them, so the running statistics update in place under the vmap.
  A model with a fused flag on is never vmapped (``ValueError`` naming the
  flag): its CUDA launchers hand raw device pointers to the kernels, which a
  vmapped tensor does not have.  Dropout draws one stream for all slices
  (``randomness="different"``), so with live dropout no slice repeats its
  serial run; without it a slice equals its serial run within the error of
  a reordered sum.  On the same card a step of three unfused DCNN seeds
  takes 1.76x three serial steps, so nothing picks it by itself.

In both modes the transform (kernel 1, no parameters, under ``no_grad``)
runs once a step on the ``[S*B, 1, T]`` audio of all slices, after each
slice's augmentation (drawn from the slice's own generator, slice by
slice).

Batch layout: train batches stack the per-seed streams ``[S, B, ...]``;
eval shares one batch across the slices, since eval order does not depend
on the seed.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.audio import augment
from .predict import resolve_device
from .steps import (
    audio_to_float,
    eval_results,
    forward_backward,
    make_optimizer,
    stack_batches,
    stack_results,
)

__all__ = [
    "VectorizedState",
    "create_vectorized_state",
    "make_hyper_optimizer",
    "make_vectorized_train_step",
    "make_vectorized_eval_step",
    "state_for_seed",
    "stack_seed_states",
    "multi_seed_epoch",
]

SEED_AXES = ("vmap", "scan")
# model attributes that route a layer through a hand-written kernel
FUSED_FLAGS = ("fused_layer1", "fused_pool", "fused_layer2", "fused_attention")

Batch = Dict[str, torch.Tensor]


def fused_flags_on(model: nn.Module) -> List[str]:
    """The fused flags switched on anywhere in ``model``."""
    return [a for a in FUSED_FLAGS if any(getattr(m, a, False) for m in model.modules())]


def check_seed_axis(seed_axis: str, model: Optional[nn.Module] = None) -> None:
    if seed_axis not in SEED_AXES:
        raise ValueError(f"seed_axis must be 'vmap' or 'scan', got {seed_axis!r}")
    if seed_axis == "vmap" and model is not None:
        on = fused_flags_on(model)
        if on:
            raise ValueError(
                f"seed_axis='vmap' cannot run a model with {on[0]} on: its CUDA "
                "kernels take raw device pointers, which a vmapped tensor does "
                "not have; use seed_axis='scan'"
            )


def _rng_state(device: torch.device):
    """The default generators' states: the CPU's, and ``device``'s."""
    cuda = torch.cuda.get_rng_state(device) if device.type == "cuda" else None
    return torch.get_rng_state(), cuda


def _set_rng_state(device: torch.device, state) -> None:
    torch.set_rng_state(state[0])
    if state[1] is not None:
        torch.cuda.set_rng_state(state[1], device)


class VectorizedState:
    """S training states of one configuration, advanced together.

    ``models``: one module per slice (own parameters and buffers);
    ``optimizer``: a parameter group per slice (:func:`make_hyper_optimizer`);
    ``aug_generators``: one per slice on the device; ``rng_states``: per
    slice the (CPU, device) default-generator states its dropout draws from;
    ``step``: optimizer steps taken.
    """

    def __init__(self, models: List[nn.Module], optimizer: torch.optim.Optimizer,
                 aug_generators: List[torch.Generator], rng_states: list, step: int = 0,
                 seed_axis: str = "scan") -> None:
        check_seed_axis(seed_axis, models[0])
        self.models = models
        self.optimizer = optimizer
        self.aug_generators = aug_generators
        self.rng_states = list(rng_states)
        self.step = int(step)
        self.seed_axis = seed_axis
        self.device = next(models[0].parameters()).device
        self.buffers: Dict[str, torch.Tensor] = {}
        if seed_axis == "vmap":
            self._stack_buffers()

    def __len__(self) -> int:
        return len(self.models)

    def _stack_buffers(self) -> None:
        """Stack every buffer ``[S, ...]`` and make each slice's buffer a
        view of its row: an in-place update under the vmap then lands in
        the slices' own modules."""
        per_model = [dict(m.named_buffers()) for m in self.models]
        for name in per_model[0]:
            stacked = torch.stack([bufs[name] for bufs in per_model])
            owner_name, _, leaf = name.rpartition(".")
            for i, m in enumerate(self.models):
                m.get_submodule(owner_name)._buffers[leaf] = stacked[i]
            self.buffers[name] = stacked

    def stacked_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter stacked ``[S, ...]`` from the slices' leaves
        (differentiable: the gradients land on the leaves)."""
        per_model = [dict(m.named_parameters()) for m in self.models]
        return {name: torch.stack([p[name] for p in per_model]) for name in per_model[0]}

    @contextlib.contextmanager
    def slice_rng(self, i: int):
        """Inside the block the default generators hold slice ``i``'s
        streams; on exit slice ``i`` keeps where they got to and the
        previous states come back."""
        saved = _rng_state(self.device)
        _set_rng_state(self.device, self.rng_states[i])
        try:
            yield
        finally:
            self.rng_states[i] = _rng_state(self.device)
            _set_rng_state(self.device, saved)


def make_hyper_optimizer(
    param_lists: Sequence,
    learning_rates: Sequence[float],
    weight_decays: Sequence[float],
    moment_dtype: Optional[str] = None,
) -> torch.optim.Optimizer:
    """:func:`steps.make_optimizer` with a parameter group per slice, each
    with its own lr and weight decay.

    The JAX package moves the two scalars into the optimizer state
    (``optax.inject_hyperparams``) so a vmapped slice carries its own; a
    torch parameter group already carries its own, and each group's update
    is the serial optimizer's on that slice's leaves.
    """
    if not (len(param_lists) == len(learning_rates) == len(weight_decays)):
        raise ValueError("one learning rate and one weight decay per slice")
    groups = [
        {"params": list(params), "lr": float(lr), "weight_decay": float(wd)}
        for params, lr, wd in zip(param_lists, learning_rates, weight_decays)
    ]
    return make_optimizer(groups, float(learning_rates[0]), float(weight_decays[0]),
                          moment_dtype=moment_dtype)


def _per_slice(name: str, values, default: float, n: int) -> List[float]:
    if values is None:
        return [float(default)] * n
    values = [float(v) for v in values]
    if len(values) != n:
        raise ValueError(
            f"hyperparams[{name!r}] must have one value per seed "
            f"(got {len(values)} for {n} seeds)"
        )
    return values


def create_vectorized_state(
    make_model: Callable[[], nn.Module],
    seeds: Sequence[int],
    learning_rate: float,
    weight_decay: float,
    hyperparams: Optional[Dict[str, Sequence[float]]] = None,
    moment_dtype: Optional[str] = None,
    device: torch.device | str = "cuda",
    seed_axis: str = "scan",
) -> VectorizedState:
    """S fresh slices: slice ``i``'s weights are ``make_model()`` right after
    ``torch.manual_seed(seeds[i])`` (as ``run_experiment`` builds its
    model), its generators are seeded with ``seeds[i]`` (as
    ``Trainer.init_state`` seeds them).  ``hyperparams``: per-slice
    ``learning_rate`` / ``weight_decay`` lists."""
    device = resolve_device(device)
    check_seed_axis(seed_axis)
    unknown = set(hyperparams or {}) - {"learning_rate", "weight_decay"}
    if unknown:
        raise ValueError(f"hyperparams may hold learning_rate and weight_decay: {unknown}")
    n = len(seeds)
    lrs = _per_slice("learning_rate", (hyperparams or {}).get("learning_rate"), learning_rate, n)
    wds = _per_slice("weight_decay", (hyperparams or {}).get("weight_decay"), weight_decay, n)
    models, gens, rngs = [], [], []
    for s in seeds:
        torch.manual_seed(int(s))
        models.append(make_model().to(device))
    for s in seeds:
        torch.manual_seed(int(s))
        rngs.append(_rng_state(device))
        gens.append(torch.Generator(device=device).manual_seed(int(s)))
    optimizer = make_hyper_optimizer(
        [m.parameters() for m in models], lrs, wds, moment_dtype=moment_dtype)
    return VectorizedState(models, optimizer, gens, rngs, 0, seed_axis)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def state_for_seed(vstate: VectorizedState, i: int) -> dict:
    """Slice ``i`` as the serial Trainer's ``.state.pt`` blob (``model``,
    ``optimizer`` in a serial optimizer's layout, ``step``,
    ``aug_generator``, ``torch_rng`` and on a card ``cuda_rng``; copies)."""
    sd = vstate.optimizer.state_dict()
    group = sd["param_groups"][i]
    ids = group["params"]
    blob = {
        "model": _clone(vstate.models[i].state_dict()),
        "optimizer": {
            "state": {j: _clone(sd["state"][pid]) for j, pid in enumerate(ids)
                      if pid in sd["state"]},
            "param_groups": [{**group, "params": list(range(len(ids)))}],
        },
        "step": vstate.step,
        "aug_generator": vstate.aug_generators[i].get_state(),
        "torch_rng": vstate.rng_states[i][0].clone(),
    }
    if vstate.rng_states[i][1] is not None:
        blob["cuda_rng"] = vstate.rng_states[i][1].clone()
    return blob


def stack_seed_states(
    states: Sequence[dict],
    template: nn.Module,
    seed_axis: str = "scan",
    moment_dtype: Optional[str] = None,
    device: Optional[torch.device | str] = None,
) -> VectorizedState:
    """Inverse of :func:`state_for_seed`: S serial blobs (e.g. the per-seed
    ``.state.pt`` files) into one :class:`VectorizedState`; ``template`` is
    a model of the configuration (copied, its weights replaced)."""
    device = torch.device(device) if device is not None else next(
        template.parameters()).device
    models = []
    for st in states:
        m = copy.deepcopy(template).to(device)
        m.load_state_dict(st["model"])
        models.append(m)
    groups = [st["optimizer"]["param_groups"][0] for st in states]
    optimizer = make_hyper_optimizer(
        [m.parameters() for m in models], [g["lr"] for g in groups],
        [g["weight_decay"] for g in groups], moment_dtype=moment_dtype)
    stacked_state, stacked_groups, offset = {}, [], 0
    for st, group in zip(states, groups):
        n = len(group["params"])
        stacked_state.update({offset + j: v for j, v in st["optimizer"]["state"].items()})
        stacked_groups.append({**group, "params": list(range(offset, offset + n))})
        offset += n
    optimizer.load_state_dict({"state": stacked_state, "param_groups": stacked_groups})
    gens = []
    for st in states:
        gen = torch.Generator(device=device)
        gen.set_state(st["aug_generator"])
        gens.append(gen)
    rngs = [(st["torch_rng"], st.get("cuda_rng") if device.type == "cuda" else None)
            for st in states]
    return VectorizedState(models, optimizer, gens, rngs, int(states[0]["step"]), seed_axis)


def _images(vstate: VectorizedState, transform, audio: torch.Tensor,
            aug_contrast: bool, aug_noise: bool) -> torch.Tensor:
    """``[S, B, 1, T]`` audio -> ``[S, B, ...]`` images: each slice's
    augmentation from its own generator, in slice order, then one
    transform over all ``S*B`` frames."""
    with torch.no_grad():
        audio = audio_to_float(audio)
        s, b = audio.shape[:2]
        if aug_contrast or aug_noise:
            audio = torch.stack([
                augment(vstate.aug_generators[i], audio[i], aug_contrast, aug_noise)
                for i in range(s)
            ])
        image = transform(audio.reshape(s * b, *audio.shape[2:]))
    return image.reshape(s, b, *image.shape[1:])


def _vmapped_forward_backward(vstate: VectorizedState, images: torch.Tensor,
                              labels: torch.Tensor, grad_accum: int):
    """:func:`steps.forward_backward` of every slice at once under
    ``torch.func.vmap``; returns the ``[S]`` losses and accuracies."""
    template = vstate.models[0]
    for m in vstate.models:
        m.train()

    def loss_fn(params, buffers, image, label):
        out = torch.func.functional_call(template, (params, buffers), (image,))
        return F.cross_entropy(out, label), out

    vmapped = torch.func.vmap(loss_fn, randomness="different")
    b = images.shape[1]
    if grad_accum <= 1:
        loss, out = vmapped(vstate.stacked_params(), vstate.buffers, images, labels)
        loss.sum().backward()  # each slice's gradient lands on its own leaves
        return loss.detach(), (out.argmax(-1) == labels).float().mean(-1)
    if b % grad_accum:
        raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
    mb = b // grad_accum
    loss = torch.zeros(len(vstate), device=images.device)
    correct = torch.zeros(len(vstate), device=images.device)
    for img_mb, lab_mb in zip(images.split(mb, dim=1), labels.split(mb, dim=1)):
        mb_loss, out = vmapped(vstate.stacked_params(), vstate.buffers, img_mb, lab_mb)
        mb_loss.sum().backward()
        loss += mb_loss.detach()
        correct += (out.argmax(-1) == lab_mb).float().sum(-1)
    params = [p for group in vstate.optimizer.param_groups for p in group["params"]]
    inv = 1.0 / grad_accum
    torch._foreach_mul_([p.grad for p in params if p.grad is not None], inv)
    return loss * inv, correct / b


def make_vectorized_train_step(
    vstate: VectorizedState,
    transform: Callable[[torch.Tensor], torch.Tensor],
    aug_contrast: bool = False,
    aug_noise: bool = False,
    grad_accum: int = 1,
) -> Callable[[Batch], Batch]:
    """One optimizer step for every slice: ``batch`` holds ``[S, B, ...]``
    device tensors (per-seed streams); stats are ``[S]``."""

    def train_step(batch: Batch) -> Batch:
        images = _images(vstate, transform, batch["audio"], aug_contrast, aug_noise)
        labels = (batch["label"] != 0).long()
        vstate.optimizer.zero_grad(set_to_none=True)
        if vstate.seed_axis == "vmap":
            loss, acc = _vmapped_forward_backward(vstate, images, labels, grad_accum)
        else:
            stats = []
            for i, model in enumerate(vstate.models):
                with vstate.slice_rng(i):
                    stats.append(forward_backward(
                        model, list(model.parameters()), images[i], labels[i], grad_accum))
            loss = torch.stack([s[0] for s in stats])
            acc = torch.stack([s[1] for s in stats])
        vstate.optimizer.step()
        vstate.step += 1
        return {"loss": loss, "acc": acc}

    return train_step


def make_vectorized_eval_step(
    vstate: VectorizedState,
    transform: Callable[[torch.Tensor], torch.Tensor],
) -> Callable[[Batch], Batch]:
    """Evaluate ONE batch (shared by every slice; the transform runs once)
    under every slice's weights; each result gains a leading ``[S]``."""

    def eval_step(batch: Batch) -> Batch:
        for m in vstate.models:
            m.eval()
        with torch.inference_mode():
            image = transform(audio_to_float(batch["audio"]))
            if vstate.seed_axis == "vmap":
                template = vstate.models[0]

                def logits(params, buffers):
                    return torch.func.functional_call(template, (params, buffers), (image,))

                out = torch.func.vmap(logits)(vstate.stacked_params(), vstate.buffers)
            else:
                out = torch.stack([m(image) for m in vstate.models])
            return stack_results([eval_results(o, batch) for o in out])

    return eval_step


def multi_seed_epoch(loaders: Sequence, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
    """Zip S per-seed loader epochs into ``[S, B, ...]`` stacked host
    batches; stream ``i`` is the serial run of ``seeds[i]``'s data order."""
    iters = [ld.epoch(epoch) for ld in loaders]
    while True:
        batches = [next(it, None) for it in iters]
        stops = [b is None for b in batches]
        if all(stops):
            return
        if any(stops):
            raise RuntimeError("per-seed loaders yielded different batch counts")
        yield stack_batches(batches)
