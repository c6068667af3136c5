"""Step helpers.  Only ``audio_to_float`` is on the serving path; the train
and eval steps (``audiodeepfake_detection_tpu/train/steps.py``) wait for
the training slice."""

from __future__ import annotations

import torch


def audio_to_float(audio: torch.Tensor) -> torch.Tensor:
    """Accept float audio or raw int16 PCM (scale 1/32768) batches.

    The pcm16 serving wire ships int16 frames (half the host-to-device
    bytes) and converts on the device.
    """
    if not torch.is_floating_point(audio):
        return audio.to(torch.float32) * (1.0 / 32768.0)
    return audio
