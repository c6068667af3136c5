"""Pre-decoded frame cache: serve batches from a memmap, not the decoder.

Copy of ``audiodeepfake_detection_tpu/data/frame_cache.py`` (numpy only),
with the process that builds it elected by ``torch.distributed``'s rank
instead of JAX's process index.  The path (:func:`frame_cache_path`) and
the int16 ``.npy`` layout are the JAX package's, so a cache built by either
package serves the other byte for byte.

The reference hides decode cost behind 10 DataLoader worker processes
(reference: src/audiofakedetect/train_classifier.py:1106).  The cache
stores every dataset frame decoded + resampled exactly once as int16 PCM in
an ``.npy`` memmap keyed like the dataset's index cache; a warm loader then
serves a batch with one memmap gather instead of a decode, byte-exact for
16-bit sources (decode is ``pcm / 32768``, so the int16 round-trip is
lossless; resampled/float sources quantize at ~3e-5, far below the
augmentation noise floor).
"""

from __future__ import annotations

import os

import numpy as np
from numpy.lib.format import open_memmap

_SCALE = 32768.0


def rank_and_world() -> tuple:
    """``torch.distributed``'s rank and world size when a process group is
    initialized, else ``(0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _index_fingerprint(dataset) -> str:
    """Short content hash of the dataset's frame index (paths, frame
    numbers, window sizes, labels).  Keys the frame cache to the exact
    index it was decoded from: a rebuilt/changed index with a coincidentally
    matching (n, target_len) shape must not silently reuse stale PCM.
    Memoized on the dataset (the Python hash loop is O(frames) and the path
    is derived several times per loader setup)."""
    cached = getattr(dataset, "_frame_fingerprint", None)
    if cached is not None:
        return cached
    import hashlib

    h = hashlib.sha1()
    for row in dataset.audio_data:
        h.update(repr(tuple(row)).encode())
    fp = h.hexdigest()[:10]
    dataset._frame_fingerprint = fp
    return fp


def frame_cache_path(dataset) -> str:
    """Cache file path, derived from the dataset's own identity + a content
    fingerprint of its frame index."""
    names = "-".join(
        sorted({str(v) for v in dataset.label_names.values()})
    )
    return os.path.join(
        dataset.save_path,
        f"frames_{names}_{dataset.seconds}sec_{dataset.ds_type}"
        f"_{dataset.resample_rate}hz_{_index_fingerprint(dataset)}.npy",
    )


def build_frame_cache(
    dataset,
    num_threads: int = 8,
    batch_size: int = 256,
    verbose: bool = False,
) -> str:
    """Decode + resample every frame once into an int16 memmap.

    Returns the cache path; a pre-existing cache of the right shape is
    reused.  The write goes to a temp file and is renamed atomically so a
    crashed build never leaves a truncated cache behind.
    """
    from .loader import FrameLoader

    path = frame_cache_path(dataset)
    n = len(dataset)
    target_len = int(dataset.seconds * dataset.resample_rate)
    if os.path.exists(path):
        existing = np.load(path, mmap_mode="r")
        if existing.shape == (n, target_len):
            return path
        del existing

    # several processes: the corpus decode is expensive and byte-identical
    # on every process -- rank 0 builds it, the others poll for the
    # atomic rename (fall through to building if it never appears)
    proc, nproc = rank_and_world()
    if nproc > 1 and proc != 0:
        import time

        for _ in range(3600):
            if os.path.exists(path):
                return path
            time.sleep(1.0)
        print(
            f"frame cache: process 0 never published {path}; "
            f"building locally on process {proc}"
        )

    loader = FrameLoader(
        dataset, batch_size, num_threads=num_threads, prefetch=0,
        use_frame_cache=False,
    )
    # per-process temp name: processes building at once must not
    # interleave writes into one file; the atomic rename makes last-wins safe
    tmp = f"{path}.{os.getpid()}.tmp"
    mm = open_memmap(tmp, mode="w+", dtype=np.int16, shape=(n, target_len))
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        batch = loader._make_batch(np.arange(lo, hi), hi - lo)
        pcm = np.clip(
            batch["audio"][:, 0, :] * _SCALE, -32768, 32767
        ).astype(np.int16)
        mm[lo:hi] = pcm
        if verbose and lo % (50 * batch_size) == 0:
            print(f"frame cache: {hi}/{n}", flush=True)
    mm.flush()
    del mm
    os.replace(tmp, path)
    return path


def open_frame_cache(dataset):
    """Return the memmap for a valid cache, else None."""
    path = frame_cache_path(dataset)
    if not os.path.exists(path):
        return None
    mm = np.load(path, mmap_mode="r")
    target_len = int(dataset.seconds * dataset.resample_rate)
    if mm.shape != (len(dataset), target_len):
        return None
    return mm


def decode_frames(cache, indices: np.ndarray, out=None) -> np.ndarray:
    """Gather frames from the cache as float32 in [-1, 1).

    One fused gather-multiply pass (one pass instead of a gather, a cast and
    a division).
    """
    if out is None:
        out = np.empty((len(indices), cache.shape[1]), np.float32)
    np.multiply(cache[indices], np.float32(1.0 / _SCALE), out=out)
    return out


def gather_frames_int16(cache, indices: np.ndarray, out=None) -> np.ndarray:
    """Gather raw int16 frames (scale ``1/32768``) — for loaders that ship
    PCM to the device and convert there (half the host-to-device bytes;
    ``train/steps.py::audio_to_float`` converts on the device)."""
    if out is None:
        return cache[indices]
    np.take(cache, indices, axis=0, out=out)
    return out
