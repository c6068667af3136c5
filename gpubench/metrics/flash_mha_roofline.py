"""``flash_mha_roofline``: the share of its roofline that kernel 4, fused attention, reaches in
the traced training steps (``metrics/_kernels.py``; work in
``work/flash_mha.py``)."""

from gpubench.metrics._kernels import roofline


def read(view):
    return roofline(view, "flash_mha")
