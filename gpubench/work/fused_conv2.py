"""Kernel 6, BatchNorm folded into conv 3x3 + PReLU + 2x2 pool
(``csrc/fused_conv2.cu``), at ``cnn[6:10]``: its least work per launch,
copied from ``chip_smoke.py``'s ``conv2_bounds``.

Forward: x, the weights and corr read, out, code and moments written; a
max over four conv values needs all four: 2 * 9 * Cin flops for each of
the 4 * n_out values.  Backward: x, g, out, code and the weights read, dx,
dw and dcorr written; the conv-output cotangent is zero at three of a
window's four positions, so dx and dw need 2 * 9 * Cin flops per pooled
element each (the least work, not the dense products the kernels run).
"""

KERNELS = {"fused_conv2_fwd_kernel": "fused_conv2_cuda.CONV2_FWD_LAUNCHES",
           "fused_conv2_dx_kernel": "fused_conv2_cuda.CONV2_BWD_LAUNCHES",
           "fused_conv2_dw_kernel": "fused_conv2_cuda.CONV2_BWD_LAUNCHES",
           "fused_conv2_small_kernel": "fused_conv2_cuda.CONV2_BWD_LAUNCHES"}


def flops_bytes(b: int, c_in: int, c_out: int, h: int, w: int, itemsize: int = 4):
    n_out = b * c_out * (h // 2) * (w // 2)
    n_x = b * c_in * h * w
    small = 4 * (9 * c_in * c_out + c_out * h * w)
    return {"fwd": (4 * n_out * 18 * c_in, itemsize * n_x + small + n_out * (itemsize + 1)),
            "bwd": (2 * n_out * 18 * c_in,
                    2 * itemsize * n_x + n_out * (2 * itemsize + 1) + 2 * small)}


def work(cfg: dict, batch: int) -> dict:
    _, f, t = cfg["image"]
    m = cfg["model"]
    fb = flops_bytes(batch, m["ochannels2"], m["ochannels3"], (t + 2) // 2, (f + 2) // 2)
    return {"fused_conv2_cuda.CONV2_FWD_LAUNCHES": fb["fwd"],
            "fused_conv2_cuda.CONV2_BWD_LAUNCHES": fb["bwd"]}
