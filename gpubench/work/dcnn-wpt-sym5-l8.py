"""The model FLOPs of a ``dcnn-wpt-sym5-l8`` training step, for ``mfu``.

Dense products at the published widths: each convolution's and the head's
2 flops a multiply-add forward, the same again for its weight gradient and,
for every layer but the first (whose input needs no gradient), for its
input gradient; plus the forward wavelet-packet cascade.  Recomputed work
is not counted, and neither are the elementwise layers.
"""

from gpubench import cells


def conv_flops(cin, cout, k, h_out, w_out):
    return 2 * k * k * cin * cout * h_out * w_out


def layers(cfg: dict):
    """``(flops a frame, input needs a gradient)`` of each product, in
    order."""
    m = cfg["model"]
    _, f, t = cfg["image"]
    h, w = t + 2, f + 2  # conv 3x3, pad 2
    c1, c2, c3, c4, c5 = (m[f"ochannels{i}"] for i in range(1, 6))
    out = [(conv_flops(1, c1, 3, h, w), False)]
    h, w = h // 2, w // 2
    out.append((conv_flops(c1, c2, 1, h, w), True))
    out.append((conv_flops(c2, c3, 3, h, w), True))
    h, w = h // 2, w // 2
    for cin, cout in ((c3, c4), (c4, c5), (c5, 64)):
        out.append((conv_flops(cin, cout, 3, h, w), True))
    h, w = h // 2, w // 2
    d = m["time_dim"]
    # the dilated block: time steps as channels on the (channels, packets) plane
    hh, ww = 64, w
    for k, pad, dil in ((3, 1, 1), (5, 2, 2), (7, 2, 4)):
        hh, ww = hh + 2 * pad - dil * (k - 1), ww + 2 * pad - dil * (k - 1)
        out.append((conv_flops(d, d, k, hh, ww), True))
    out.append((2 * m["flattend_size"] * m["nclasses"] * d, True))
    return out


def model_flops(cfg: dict, batch: int) -> float:
    transform, _ = cells.work_module("wpt").work(cfg, 1)["wpt_cuda.LAUNCHES"]
    step = sum(f * (3 if grad_in else 2) for f, grad_in in layers(cfg))
    return batch * (step + transform)
