"""``idle_pct.train``: the share of the traced window in which no kernel,
copy or set ran on the device, while training."""


def read(view):
    return 100.0 * (1.0 - view.busy_s / view.window_s)
