"""The program's model for ``dcnn-wpt-sym5-l8``: the port's ``DCNN`` with
the configuration's ``model`` arguments (kernels 2, 5 and 6 in training)."""

from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN


def build(cfg: dict):
    return DCNN(**cfg["model"])
