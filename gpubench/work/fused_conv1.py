"""Kernel 2, the first block (conv 3x3 + PReLU + 2x2 pool with BatchNorm
moments; ``csrc/fused_conv1.cu``): its least work per launch, copied from
``chip_smoke.py``'s ``fused_bounds``.

Forward: x and the parameters read, out, code and moments written; 36
FMAs per output.  Backward: g, code, x, the parameters and the moments'
cotangents read (out is rebuilt from x and the code), dW, db, dalpha
written; 9 FMAs per output for dW, one add for db.
"""

KERNELS = {"fused_conv1_fwd_kernel": "fused_conv1_cuda.FWD_LAUNCHES",
           "fused_conv1_bwd_kernel": "fused_conv1_cuda.BWD_LAUNCHES"}


def flops_bytes(b: int, h: int, w: int, c: int, itemsize: int = 4):
    n_out = b * ((h + 2) // 2) * ((w + 2) // 2) * c
    params = 4 * (9 * c + c + 1)
    moved = itemsize * b * h * w + params + n_out * (itemsize + 1) + 8 * c
    return {"fwd": (n_out * 72, moved), "bwd": (n_out * 20, moved + params)}


def work(cfg: dict, batch: int) -> dict:
    _, f, t = cfg["image"]  # the model puts time on H, packets on W
    fb = flops_bytes(batch, t, f, cfg["model"]["ochannels1"])
    return {"fused_conv1_cuda.FWD_LAUNCHES": fb["fwd"],
            "fused_conv1_cuda.BWD_LAUNCHES": fb["bwd"]}
