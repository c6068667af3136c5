"""Offline analysis: attribution, GAN fingerprints, stats, plots, diffs.

Counterpart of ``audiodeepfake_detection_tpu/analysis``; the exports are
the JAX package's.  Nothing here imports matplotlib or a tensorboard
writer at module level: the functions that draw import it.
"""

from .fingerprints import (  # noqa: F401
    fingerprint_audio,
    generator_fingerprints,
    mean_rfft_spectrum,
    mean_wpt_spectrum,
)
from .integrated_gradients import (  # noqa: F401
    Mean,
    integral_approximation,
    integrated_grad,
    interpolate_images,
    run_integrated_gradients,
)
from .model_diffs import diff_indices, export_diff_audio  # noqa: F401
from .stats import average_energy, spectral_centroid, yin_pitch  # noqa: F401
