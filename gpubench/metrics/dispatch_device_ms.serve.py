"""``dispatch_device_ms.serve``: device ms of every record in the traced
window over the service's dispatches in it (``ScoringService.n_dispatches``)."""


def read(view):
    if not view.counts["dispatches"]:
        return None
    total_ms = sum(b - a for _, a, b in view.device) / 1e3
    return total_ms / view.counts["dispatches"]
