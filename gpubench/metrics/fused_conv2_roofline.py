"""``fused_conv2_roofline``: the share of its roofline that kernel 6, BatchNorm + conv + PReLU + pool, reaches in
the traced training steps (``metrics/_kernels.py``; work in
``work/fused_conv2.py``)."""

from gpubench.metrics._kernels import roofline


def read(view):
    return roofline(view, "fused_conv2")
