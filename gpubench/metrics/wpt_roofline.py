"""``wpt_roofline``: the share of its roofline that kernel 1, the wavelet-packet cascade, reaches in
the traced training steps (``metrics/_kernels.py``; work in
``work/wpt.py``)."""

from gpubench.metrics._kernels import roofline


def read(view):
    return roofline(view, "wpt")
