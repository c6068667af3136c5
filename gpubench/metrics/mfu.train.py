"""``mfu.train``: the whole training step's share of the card's peak: the
configuration's model FLOPs a step (``work/<config>.py``) times the steps
in the traced window, over the window's seconds times the product peak
(``peaks.json``)."""

from gpubench import cells


def read(view):
    flops = cells.work_module(view.cell["name"]).model_flops(view.cell, view.counts["batch"])
    peak = cells.data("peaks")["product_flop_per_s"]
    return 100.0 * flops * view.counts["steps"] / (view.window_s * peak)
