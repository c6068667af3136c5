"""PyTorch + CUDA port of the audio deepfake detection framework.

A second package beside the JAX reference ``audiodeepfake_detection_tpu``:
module paths and names mirror the reference so each counterpart is easy to
find.  Plain tensor code is PyTorch; the reference's Pallas TPU kernels
become CUDA kernels written by hand for Hopper (``csrc/``), built from
source at first use.  This package never imports JAX.

Ported so far: the serving path (audio -> wavelet-packet image -> DCNN ->
``P(fake)`` over HTTP).  ROADMAP.md lists the slices still to come.
"""

from .version import __version__  # noqa: F401
