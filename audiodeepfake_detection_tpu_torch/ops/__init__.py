"""Signal-processing ops: filter banks, wavelet packets, normalization,
resampling.  ``wpt_cuda`` holds the hand-written CUDA wavelet-packet kernel;
``wpt`` holds its plain PyTorch version."""
