"""Kernel 6's bf16 route (the DCNN's fused second block) on one CUDA card,
for one checkout: this one, or an older commit unpacked under ``build/``
(``git archive``), so that two can be timed in one call in turns (parent,
change, change, parent):

    python tools/conv2_bf16_probe.py --root build/parent --out chiprun_out/p1.json
    python tools/conv2_bf16_probe.py --root . --out chiprun_out/c1.json

For the checkout at ``--root``, with its own package, kernels and
``chip_smoke.py`` helpers, at B = 128, 64 -> 96 channels, 48 x 129
(``CONV2_SHAPE``), bf16 inputs as the bf16 DCNN hands them over: the forward
(with code and moments) and the backward through their launchers
(``chip_smoke.median_ms``: CUDA-event medians, host work included) and as
the device time of their kernels (``chip_smoke.kernel_device_ms``: a
profile, each kernel's mean record); then the bf16 DCNN train step with all
three fused flags at B = 128 (``chip_smoke.step_fns``), a CUDA-event median
and the device time of its kernels (``chip_smoke.profile_train``), and the
bf16 DCNN scorer at B = 64 and 128 (random weights), CUDA-event medians.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SR = 22050


def probe(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.ops import fused_conv2_cuda as fc
    from audiodeepfake_detection_tpu_torch.train.predict import make_score_fn
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    for mod in (cs, fc):
        if not mod.__file__.startswith(root):
            raise AssertionError(f"imported {mod.__file__}, not from {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fc.build()
    # the kernels' names: the tensor-core route's, or the route before it
    new = "fused_conv2_fwd_bf16_kernel" in fc.SOURCE.read_text()
    tag = "_bf16" if new else ""
    fwd_keys = {"fwd": f"fused_conv2_fwd{tag}_kernel"}
    bwd_keys = {"dx": f"fused_conv2_dx{tag}_kernel", "dw": f"fused_conv2_dw{tag}_kernel",
                "small": "fused_conv2_small_kernel"}

    (x, w, corr, alpha), (g, gs, gq) = cs.conv2_case(*cs.CONV2_SHAPE, torch.bfloat16, 0.25,
                                                     113)
    raw = (x.detach(), w.detach().float(), corr.detach().float(), alpha.detach().float())
    y, code, _, _ = fc.forward(*raw, True, True)

    def forward():
        return fc.forward(*raw, True, True)

    def backward():
        return fc.backward(*raw, g, y, code, gs, gq)

    launcher = cs.median_ms({"fwd": forward, "bwd": backward}, reps=5)
    device = cs.kernel_device_ms(forward, fwd_keys)
    device.update(cs.kernel_device_ms(backward, bwd_keys))
    out = {"card": cs.card(), "root": root, "tensor_core_route": new,
           "fwd_launcher_ms": launcher["fwd"], "bwd_launcher_ms": launcher["bwd"],
           "fwd_device_ms": device["fwd"],
           "bwd_device_ms": None if None in (device[k] for k in bwd_keys) else sum(
               device[k] for k in bwd_keys),
           "bwd_device_apart_ms": {k: device[k] for k in bwd_keys}}
    del x, w, corr, alpha, g, gs, gq, raw, y, code

    norm = ([np.float32(-5.0)], [np.float32(4.0)])
    train_step, _ = cs.step_fns(norm, True, dtype=torch.bfloat16, fused_pool=True,
                                fused_layer2=True)
    out["dcnn_b_bf16_step_ms"] = cs.median_ms({"step": train_step}, reps=3)["step"]
    prof = cs.profile_train(train_step)
    out["dcnn_b_bf16_step_device_ms"] = prof["device_ms"]
    out["dcnn_b_bf16_step_fused_conv2_ms"] = prof["groups"]["fused_conv2"]
    del train_step
    transform = normalized_transform(make_transform(cs.train_args("", "", "")),
                                     *[np.asarray(v) for v in norm])
    torch.manual_seed(0)
    scorer = make_score_fn(DCNN(time_dim=12, dtype=torch.bfloat16), transform, "cuda")
    gen = torch.Generator().manual_seed(19)
    out["scorer_bf16_ms"] = {}
    for b in (64, 128):
        audio = (0.3 * torch.randn(b, 1, SR, generator=gen)).cuda()
        out["scorer_bf16_ms"][b] = cs.median_ms({"s": lambda: scorer(audio)}, reps=5)["s"]
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="the checkout to time")
    parser.add_argument("--out", help="also write the result here")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("conv2_bf16_probe: needs a CUDA device")
    result = probe(args.root)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
