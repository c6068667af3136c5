"""``fused_conv1_roofline``: the share of its roofline that kernel 2, the DCNN's first block, reaches in
the traced training steps (``metrics/_kernels.py``; work in
``work/fused_conv1.py``)."""

from gpubench.metrics._kernels import roofline


def read(view):
    return roofline(view, "fused_conv1")
