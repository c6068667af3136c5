"""``fused_pool_roofline``: the share of its roofline that kernel 5, PReLU + pool, reaches in
the traced training steps (``metrics/_kernels.py``; work in
``work/fused_pool.py``)."""

from gpubench.metrics._kernels import roofline


def read(view):
    return roofline(view, "fused_pool")
