"""Serving artifacts via ``torch.export``: the whole scorer as one file.

Counterpart of ``audiodeepfake_detection_tpu/train/export.py``.  The
scorer of :func:`predict.make_score_fn` -- transform, normalization, model
in eval mode, softmax (or the logit margin) -- is exported as one
``torch.export.ExportedProgram``, with the weights, the normalization
statistics and any baked int8 records inside, and written as one file::

    ADFX-TORCH1\\n                  magic + version
    <json meta>\\n                  shapes, device, win, source
    <torch.export.save bytes>      the program

The magic differs from the JAX package's ``ADFX1`` (serialized StableHLO):
each loader refuses the other's files.

Loading (:func:`load_artifact`) needs PyTorch and this package's ``adfd``
ops (``ops/library.py``; on the card their kernels build at first call
from ``csrc/``), but neither the model code nor the ``.pt`` snapshot: the
graph calls ``torch.ops.adfd.*`` wherever the scorer reached a kernel,
and :func:`load_artifact` registers those ops before
``torch.export.load``.  An artifact with no ``adfd`` node (``portable`` in
its meta: ``--plain-wpt`` and a model without fused blocks) needs only
PyTorch.  Score with ``ep.module()(audio)`` under ``torch.inference_mode()``,
audio ``[B, 1, win]`` float32 on the artifact's device.

A symbolic batch (the default) keeps the kernels: they take any batch at
run time, and each op's fake implementation gives its output's shape from a
symbolic one.  (The JAX package must fall back to its XLA cascade there: a
Mosaic kernel's grid needs a concrete batch.)  ``chunk`` needs a concrete
batch that it divides; the meta records the chunk the program really runs.
"""

from __future__ import annotations

import io
import json
import os
import time
from collections import Counter
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..ops import library
from .predict import make_score_fn, resolve_device, score_batch

MAGIC = b"ADFX-TORCH1\n"
JAX_MAGIC = b"ADFX1\n"
#: the largest batch of a symbolic export: on the card, eager BatchNorm in
#: eval mode takes cuDNN up to 65535 frames and another kernel beyond
#: (ATen's ``_batch_norm_impl_index``), which the trace must not guess
MAX_BATCH = 65535


class ScoreModule(nn.Module):
    """:func:`make_score_fn`'s scorer as a module: ``[B, 1, win]`` audio ->
    ``[B]`` scores (``output`` ``"prob"`` or ``"margin"``), microbatched by
    ``chunk`` when it is set."""

    def __init__(self, model: nn.Module, transform: Callable, output: str = "prob",
                 chunk: int = 0) -> None:
        super().__init__()
        self.model, self.transform = model, transform
        self.output, self.chunk = output, chunk

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return score_batch(self.model, self.transform, audio, self.output, self.chunk)


def baked_chunk(chunk: int, batch_size: Optional[int]) -> int:
    """The chunk an export at ``batch_size`` runs: 0 (the whole batch) for
    a chunk of 0 or of at least the batch; raises where the chunk needs a
    concrete batch or does not divide it."""
    if not chunk:
        return 0
    if batch_size is None:
        raise ValueError(
            "chunk requires a concrete batch_size: a symbolic batch "
            "dimension cannot prove the b % chunk == 0 the chunked forward needs"
        )
    if chunk >= batch_size:
        return 0
    if batch_size % chunk:
        raise ValueError(f"chunk={chunk} does not divide the batch of {batch_size}")
    return chunk


def export_scorer(
    model: nn.Module,
    transform: Callable,
    win: int,
    device: torch.device | str,
    batch_size: Optional[int] = None,
    chunk: int = 0,
    output: str = "prob",
) -> torch.export.ExportedProgram:
    """Export the ``[B, 1, win]`` float32 audio -> ``[B]`` scorer on ``device``.

    ``batch_size=None`` exports a symbolic batch (any B from 1 to
    :data:`MAX_BATCH`).  The model
    moves to ``device`` in eval mode and is traced without gradients, so
    every kernel on its path enters the graph as its ``adfd`` op.
    """
    if output not in ("prob", "margin"):
        raise ValueError(f"output must be prob or margin: {output!r}")
    chunk = baked_chunk(chunk, batch_size)
    device = resolve_device(device)
    scorer = ScoreModule(model.to(device).eval(), transform, output, chunk)
    # a symbolic batch is traced at 2: torch.export specializes sizes 0 and 1
    example = torch.zeros((batch_size or 2, 1, win), device=device)
    dynamic = None if batch_size else ({0: torch.export.Dim("b", min=1, max=MAX_BATCH)},)
    with torch.no_grad():
        return torch.export.export(scorer, (example,), dynamic_shapes=dynamic)


def adfd_ops(ep: torch.export.ExportedProgram) -> Counter:
    """``{op name: calls}`` of the ``adfd`` ops in the program's graph."""
    return Counter(
        n.target.name() for n in ep.graph.nodes
        if n.op == "call_function" and getattr(n.target, "namespace", None) == library.NAMESPACE
    )


def _audio_input(ep: torch.export.ExportedProgram):
    (name,) = ep.graph_signature.user_inputs
    return next(n for n in ep.graph.nodes if n.name == name).meta["val"]


def save_artifact(ep: torch.export.ExportedProgram, path: str, meta: dict) -> None:
    """Write the single-file artifact: magic, JSON meta line, program."""
    meta = dict(meta)
    audio = _audio_input(ep)
    meta.setdefault("device", audio.device.type)
    meta.setdefault("in_shape", [str(d) if isinstance(d, int) else "b" for d in audio.shape])
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(json.dumps(meta).encode() + b"\n")
        fh.write(buf.getvalue())


def load_artifact(path: str) -> tuple[torch.export.ExportedProgram, dict]:
    """``(program, meta)`` of an artifact; score with ``program.module()``.
    Registers the ``adfd`` ops first (``ops.library.load``)."""
    with open(path, "rb") as fh:
        magic = fh.read(len(MAGIC))
        if magic != MAGIC:
            if magic.startswith(JAX_MAGIC):
                raise ValueError(
                    f"{path}: a JAX package artifact ({JAX_MAGIC.strip().decode()}, "
                    "serialized StableHLO); this loader reads the PyTorch port's "
                    f"{MAGIC.strip().decode()} (torch.export) artifacts"
                )
            raise ValueError(f"{path}: not an ADFX serving artifact")
        meta = json.loads(fh.readline().decode())
        blob = fh.read()
    library.load()
    return torch.export.load(io.BytesIO(blob)), meta


def main(argv=None) -> None:
    """CLI: ``.pt`` snapshot -> single-file ``torch.export`` scorer.

    Example (on the card; ``--device cpu`` on a CPU host)::

        python -m audiodeepfake_detection_tpu_torch.train.export \\
            model_packetssym5_..._0.pt detector.adfx \\
            --norm packets_..._mean_std.pkl --check
    """
    import argparse

    from .predict import build_scorer_from_snapshot

    parser = argparse.ArgumentParser(
        description="Export a snapshot as a single-file torch.export scorer"
    )
    parser.add_argument("snapshot", help=".pt snapshot (config-encoded name)")
    parser.add_argument("output", help="artifact path (e.g. detector.adfx)")
    parser.add_argument(
        "--batch-size", type=int, default=None,
        help="concrete serving batch; default: symbolic (any batch)",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device the artifact runs on (default cuda; cpu must be asked for)",
    )
    parser.add_argument("--norm", default=None, help="*_mean_std.pkl from training")
    parser.add_argument("--mean", type=float, nargs="+", default=None)
    parser.add_argument("--std", type=float, nargs="+", default=None)
    parser.add_argument(
        "--no-log-scale", action="store_true",
        help="snapshot was trained without log scaling (not filename-encoded)",
    )
    parser.add_argument(
        "--plain-wpt", action="store_true",
        help="the plain PyTorch wavelet-packet cascade instead of the adfd op "
        "(with a model without fused blocks: an artifact with no adfd op)",
    )
    parser.add_argument(
        "--check", action="store_true",
        help="reload the artifact and score a random batch against the "
        "in-process scorer",
    )
    parser.add_argument(
        "--chunk", type=int, default=0,
        help="bake a microbatched forward into the artifact (requires "
        "--batch-size, which it must divide)",
    )
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    # fp32 convolutions, like the JAX reference's HIGHEST precision
    torch.backends.cudnn.allow_tf32 = False
    model, transform, cfg = build_scorer_from_snapshot(
        args.snapshot,
        norm=args.norm,
        mean=args.mean,
        std=args.std,
        log_scale=not args.no_log_scale,
        use_kernel=not args.plain_wpt,
    )
    win = int(float(cfg.seconds) * int(cfg.sample_rate))
    t0 = time.perf_counter()
    ep = export_scorer(model, transform, win, device, batch_size=args.batch_size,
                       chunk=args.chunk)
    export_s = time.perf_counter() - t0
    ops = adfd_ops(ep)
    given = args.norm is not None or (args.mean is not None and args.std is not None)
    sidecar = (args.norm is None and args.mean is None and args.std is None
               and os.path.exists(args.snapshot + ".norm.pkl"))
    save_artifact(ep, args.output, {
        "snapshot": args.snapshot,
        "model": cfg.model_name,
        "transform": cfg.transform,
        "win": win,
        "sample_rate": int(cfg.sample_rate),
        "portable": not ops,
        "normalized": given or sidecar,
        "chunk": baked_chunk(args.chunk, args.batch_size),
    })
    size = os.path.getsize(args.output)
    shape = ", ".join(str(d) if isinstance(d, int) else "b" for d in _audio_input(ep).shape)
    print(f"wrote {args.output} ({size} bytes, exported in {export_s:.2f} s, device "
          f"{device.type}, input [{shape}], adfd ops {dict(sorted(ops.items()))})")

    if args.check:
        reloaded, meta = load_artifact(args.output)
        b = args.batch_size or 2
        rng = np.random.RandomState(0)
        audio = torch.from_numpy(rng.randn(b, 1, win).astype(np.float32)).to(device)
        with torch.inference_mode():
            got = reloaded.module()(audio).cpu().numpy()
        want = make_score_fn(model, transform, device, chunk=meta["chunk"])(audio)
        want = want.cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        print(f"check ok: artifact matches in-process scorer "
              f"(max |d| = {np.abs(got - want).max():.2e})")


if __name__ == "__main__":  # pragma: no cover
    main()
