"""``idle_pct.serve``: the share of the traced window in which no kernel,
copy or set ran on the device, while serving."""


def read(view):
    return 100.0 * (1.0 - view.busy_s / view.window_s)
