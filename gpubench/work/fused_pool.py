"""Kernel 5, PReLU + 2x2 pool (``csrc/fused_pool.cu``), at the DCNN's last
pool (``cnn[18:20]``; the middle one runs inside kernel 6): its least work
per launch, copied from ``chip_smoke.py``'s ``pool_bounds``.

Forward: x read, out, code and the per-plane moments written; 4
compare-selects per output.  Backward: g, code and out read, dx written;
2 operations per element of dx.  ``chip_smoke.py`` also counted x read at
the selected negative elements; those are ``out / alpha``, so no input
needs them and they are not counted.
"""

KERNELS = {"fused_pool_fwd_kernel": "fused_pool_cuda.POOL_FWD_LAUNCHES",
           "fused_pool_bwd_kernel": "fused_pool_cuda.POOL_BWD_LAUNCHES"}


def flops_bytes(b: int, c: int, h: int, w: int, itemsize: int = 4):
    n_out = b * c * (h // 2) * (w // 2)
    n_in = b * c * h * w
    return {"fwd": (8 * n_out, itemsize * n_in + n_out * (itemsize + 1) + 8 * b * c),
            "bwd": (2 * n_in, n_out * (2 * itemsize + 1) + itemsize * n_in)}


def work(cfg: dict, batch: int) -> dict:
    _, f, t = cfg["image"]
    # conv 3x3 pad 2, then two 2x2 pools ahead of the block
    h, w = (t + 2) // 2 // 2, (f + 2) // 2 // 2
    fb = flops_bytes(batch, 64, h, w)  # cnn[17] has 64 outputs in the published DCNN
    return {"fused_pool_cuda.POOL_FWD_LAUNCHES": fb["fwd"],
            "fused_pool_cuda.POOL_BWD_LAUNCHES": fb["bwd"]}
