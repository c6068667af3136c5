"""Batched frame loader with native decode, prefetch and host sharding.

Copy of ``audiodeepfake_detection_tpu/data/loader.py`` (numpy only there),
which replaces torch ``DataLoader`` + ``DistributedSampler`` (reference:
src/audiofakedetect/train_classifier.py:119-159): batches are read by the
C++ thread-pool reader and resampled on the host, as numpy arrays.  With
several processes each reads only its ``process_index``-strided slice (the
``DistributedSampler`` equivalent).  Eval batches are zero-padded to a
fixed shape with a ``weight`` mask, so the batches of this loader and of
the JAX package's are equal byte for byte.

:func:`device_prefetch` takes the place of the JAX package's
``parallel.mesh.device_prefetch``: it enqueues the next batch's copy to the
device from pinned host memory before the current batch is consumed, so the
host never waits for a copy.

``use_frame_cache`` serves frames from the pre-decoded int16 memmap of
``data/frame_cache.py``: ``True`` builds it, ``None`` uses one that already
exists, ``False`` never uses one.  A warm cache serves batches inline,
with no prefetch thread.
"""

from __future__ import annotations

import math
import queue
import threading
from collections import deque
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.audio import resample
from .dataset import CustomDataset
from .wavio import wav_read_batch


class FrameLoader:
    """Iterates shuffled, fixed-shape batches of audio frames."""

    def __init__(
        self,
        dataset: CustomDataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_threads: int = 8,
        include_index: bool = False,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        use_frame_cache: Optional[bool] = None,
        emit: str = "float32",
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.include_index = include_index
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.target_len = int(dataset.seconds * dataset.resample_rate)
        # emit="int16" ships raw PCM batches (scale 1/32768), half the
        # host-to-device bytes; the steps convert on the device
        if emit not in ("float32", "int16"):
            raise ValueError(f"emit must be float32 or int16, got {emit}")
        self.emit = emit
        # pre-decoded frame cache: None = use it if present, True = build
        # if missing, False = always decode
        self._frame_cache = None
        if use_frame_cache is not False and getattr(dataset, "save_path", None):
            from .frame_cache import build_frame_cache, open_frame_cache

            if use_frame_cache:
                build_frame_cache(dataset, num_threads=num_threads)
            self._frame_cache = open_frame_cache(dataset)

    def __len__(self) -> int:
        per_proc = math.ceil(len(self.dataset) / self.process_count)
        if self.drop_last:
            return per_proc // self.batch_size
        return math.ceil(per_proc / self.batch_size)

    def _order(self, epoch: int, shuffle: bool) -> np.ndarray:
        """Per-process index sequence, equal length on EVERY process.

        Multi-host collectives desync if hosts disagree on batch count, so
        the global order is padded up to ``ceil(n / process_count) *
        process_count`` before the strided split (the ``DistributedSampler``
        role, reference train_classifier.py:119-127):

        * ``drop_last`` (training): wrap-pad by repeating the head of the
          order — every row is genuine, like ``DistributedSampler``'s
          repeat padding, so the unweighted loss mean stays unbiased;
        * otherwise (eval): pad with ``-1`` sentinels that become
          zero-weight rows, so metrics are exact.
        """
        n = len(self.dataset)
        idx = np.arange(n, dtype=np.int64)
        if shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(idx)
        total = math.ceil(n / self.process_count) * self.process_count
        if total > n:
            if self.drop_last:
                # tile (not slice): when n < process_count - n the single
                # slice is too short and processes would see unequal batch
                # counts, desyncing the collectives this pad exists for
                pad = np.resize(idx, total - n)
            else:
                pad = np.full(total - n, -1, dtype=np.int64)
            idx = np.concatenate([idx, pad])
        return idx[self.process_index :: self.process_count]

    def _make_batch(self, indices: np.ndarray, pad_to: int) -> Dict[str, np.ndarray]:
        indices = indices[indices >= 0]  # drop -1 pad sentinels (zero-weight)
        if self._frame_cache is not None:
            return self._cached_batch(indices, pad_to)
        rows = self.dataset.audio_data[indices]
        paths = [str(r[0]) for r in rows]
        wins = np.asarray([int(r[2]) for r in rows], dtype=np.int64)
        offsets = np.asarray(
            [int(r[1]) * int(r[2]) for r in rows], dtype=np.int64
        )
        labels = np.asarray([int(r[3]) for r in rows], dtype=np.int32)
        max_win = int(wins.max()) if len(wins) else self.target_len
        if len(paths) == 0:
            raw = np.zeros((0, max_win), dtype=np.float32)
        elif any(p.lower().endswith(".flac") for p in paths):
            from .wavio import audio_read

            raw = np.zeros((len(paths), max_win), dtype=np.float32)
            for i, (p, off, w) in enumerate(zip(paths, offsets, wins)):
                clip, _ = audio_read(p, int(off), int(w))
                raw[i, : len(clip)] = clip
        else:
            raw = wav_read_batch(paths, offsets, wins, max_win, self.num_threads)
        audio = np.zeros((pad_to, self.target_len), dtype=np.float32)
        for i, win in enumerate(wins):
            # round, not truncate (win = int(seconds*rate); see dataset.py)
            src_rate = round(win / self.dataset.seconds)
            clip = raw[i, :win]
            if src_rate > self.dataset.resample_rate:
                clip = resample(clip, src_rate, self.dataset.resample_rate)
            audio[i, : min(len(clip), self.target_len)] = clip[: self.target_len]
        if self.emit == "int16":
            audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        batch = {
            "audio": audio[:, None, :],  # [B, 1, T] like torchaudio.load
            "label": np.pad(labels, (0, pad_to - len(labels))),
            "weight": np.pad(
                np.ones(len(labels), np.float32), (0, pad_to - len(labels))
            ),
        }
        if self.include_index:
            batch["index"] = np.pad(
                indices.astype(np.int64),
                (0, pad_to - len(indices)),
                constant_values=-1,
            )
        return batch

    def _cached_batch(self, indices: np.ndarray, pad_to: int) -> Dict[str, np.ndarray]:
        """``_make_batch`` from the frame cache: one memmap gather."""
        from .frame_cache import decode_frames, gather_frames_int16

        n = len(indices)
        labels = self.dataset.audio_data[indices, 3].astype(np.int32)
        dtype = np.int16 if self.emit == "int16" else np.float32
        audio = np.empty((pad_to, self.target_len), dtype=dtype)
        if self.emit == "int16":
            gather_frames_int16(self._frame_cache, indices, out=audio[:n])
        else:
            decode_frames(self._frame_cache, indices, out=audio[:n])
        audio[n:] = 0
        batch = {
            "audio": audio[:, None, :],
            "label": np.pad(labels, (0, pad_to - n)),
            "weight": np.pad(np.ones(n, np.float32), (0, pad_to - n)),
        }
        if self.include_index:
            batch["index"] = np.pad(
                indices.astype(np.int64), (0, pad_to - n), constant_values=-1
            )
        return batch

    def _batches(self, epoch: int, shuffle: bool) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order(epoch, shuffle)
        n = len(order)
        n_full = n // self.batch_size
        for b in range(n_full):
            yield self._make_batch(
                order[b * self.batch_size : (b + 1) * self.batch_size],
                self.batch_size,
            )
        rem = n - n_full * self.batch_size
        if rem and not self.drop_last:
            yield self._make_batch(order[n_full * self.batch_size :], self.batch_size)

    def epoch(
        self, epoch: int = 0, shuffle: Optional[bool] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield one epoch of batches, decoded ahead by a prefetch thread
        (the C++ decoder releases the GIL).  A warm frame cache serves a
        batch with one gather, where a thread's handoff would cost more, so
        cached epochs run inline."""
        shuffle = self.shuffle if shuffle is None else shuffle
        if self.prefetch <= 0 or self._frame_cache is not None:
            yield from self._batches(epoch, shuffle)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for batch in self._batches(epoch, shuffle):
                    q.put(batch)
                q.put(sentinel)
            except BaseException as exc:  # re-raised in the consumer: a
                # swallowed decode error would silently truncate the epoch
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                thread.join()
                raise item
            yield item
        thread.join()


def batch_to_device(
    batch: Dict[str, np.ndarray], device: torch.device
) -> Dict[str, torch.Tensor]:
    """Copy a host batch to ``device``.  For a CUDA device each array goes
    through pinned memory and the copy does not block the host (PyTorch's
    pinned-memory allocator keeps the buffer alive until the copy ran)."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


def device_prefetch(
    batches: Iterable[Dict[str, np.ndarray]], device: torch.device, depth: int = 1
) -> Iterator[Tuple[Dict[str, np.ndarray], Dict[str, torch.Tensor]]]:
    """Yield ``(host batch, device batch)`` pairs, ``depth`` batches ahead:
    the copy of batch ``i + depth`` is enqueued (without blocking the host)
    before batch ``i`` is handed out."""
    ahead: deque = deque()
    for batch in batches:
        ahead.append((batch, batch_to_device(batch, device)))
        if len(ahead) > depth:
            yield ahead.popleft()
    while ahead:
        yield ahead.popleft()
