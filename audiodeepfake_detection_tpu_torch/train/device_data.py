"""Device-resident training data: the whole frame set parked in device memory.

Counterpart of ``audiodeepfake_detection_tpu/train/device_data.py``.  The
reference streams every batch host->device on every step of every epoch
(pinned-memory DataLoader workers + ``.to(rank)``, reference:
src/audiofakedetect/train_classifier.py:910-952).  Audio frames are small
(1 s at 22050 Hz is 43 KB as int16 PCM): the LJSpeech training split at
1 s frames (55,504 frames) is 2.45 GB of int16, about 3 % of an 80 GB
card.  So the ``[N, 1, T]`` frame tensor is uploaded ONCE, and an epoch
ships only a ``[G, B]`` index block per group of steps
(:func:`..train.steps.make_resident_multi_train_step` gathers on the
device).

Epoch-order parity: the per-epoch permutation comes from the loader's own
``_order`` (same seed, the same shuffle the streaming path uses), and
frames are staged through the loader's own ``_make_batch``, so resident
training consumes the same batch sequence as a streamed one.
"""

from __future__ import annotations

import numpy as np
import torch

# share of the card's memory resident data may take: the rest is left to
# the model, the optimizer and the step's activations
BUDGET_SHARE = 0.6


class ResidentData:
    """Stage a ``FrameLoader``'s whole dataset into ``device`` memory.

    ``audio`` is ``[N, 1, T]`` in the loader's emit type (int16 PCM halves
    the footprint; the steps' ``audio_to_float`` converts on the device)
    and ``labels`` is ``[N]`` int32.  ``reserved_bytes``: what other
    resident tensors already hold (the trainer passes the cumulative total
    when it parks eval sets too).
    """

    def __init__(self, loader, device, chunk: int = 512, reserved_bytes: int = 0) -> None:
        self.device = torch.device(device)
        n = len(loader.dataset)
        t = loader.target_len
        dtype = torch.int16 if loader.emit == "int16" else torch.float32
        # gate BEFORE decoding or allocating: an over-budget set fails at
        # once, not after the whole decode
        nbytes = n * t * dtype.itemsize
        check_budget(nbytes + reserved_bytes, self.device)
        self.audio = torch.empty((n, 1, t), dtype=dtype, device=self.device)
        self.labels = torch.empty((n,), dtype=torch.int32, device=self.device)
        for s in range(0, n, chunk):
            idxs = np.arange(s, min(s + chunk, n), dtype=np.int64)
            batch = loader._make_batch(idxs, pad_to=len(idxs))
            self.audio[s : s + len(idxs)].copy_(torch.from_numpy(batch["audio"]))
            self.labels[s : s + len(idxs)].copy_(torch.from_numpy(batch["label"]))
        self.n = n
        self.nbytes = nbytes
        if self.device.type == "cuda":
            # the one-off upload is not billed to the first step
            torch.cuda.synchronize(self.device)


def check_budget(nbytes: int, device: torch.device) -> None:
    """Refuse resident data above ``BUDGET_SHARE`` of the card's memory
    (``torch.cuda.mem_get_info``).  The CPU has no gate."""
    if device.type != "cuda":
        return
    _, total = torch.cuda.mem_get_info(device)
    if nbytes > BUDGET_SHARE * total:
        raise ValueError(
            f"resident data ({nbytes / 2**30:.2f} GiB cumulative) exceeds "
            f"{BUDGET_SHARE:.0%} of device memory ({total / 2**30:.2f} GiB); use "
            "the streaming loader (device_data=False) or emit='int16'"
        )
