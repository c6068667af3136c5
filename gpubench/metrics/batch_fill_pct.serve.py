"""``batch_fill_pct.serve``: how full the micro-batcher's dispatches were
over the measured window: frames scored over dispatches times the batch
(the service's ``n_scored`` and ``n_dispatches``)."""


def read(view):
    c = view.counts
    if not c["window_dispatches"]:
        return None
    return 100.0 * c["window_scored"] / (c["window_dispatches"] * c["batch"])
