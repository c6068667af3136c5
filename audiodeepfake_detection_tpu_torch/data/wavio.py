"""ctypes bindings for the native WAV reader (csrc/libwavio.so).

Copy of ``audiodeepfake_detection_tpu/data/wavio.py``.  ``_CSRC`` resolves
to the repository-root ``csrc/``, so both packages share one build of
``libwavio.so`` / ``libflacdec.so`` and one copy of their C++ sources.

Replaces ``torchaudio.info`` / ``torchaudio.load`` in the data path
(reference: src/audiofakedetect/data_loader.py:174, 336-340).  The batch
reader decodes a whole training batch with a C++ thread pool (the GIL is
released inside the ctypes call), replacing torch DataLoader worker
processes.  A pure-Python fallback via the stdlib ``wave`` module keeps the
pipeline alive if the shared library is missing; the Makefile build is
attempted automatically once.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_LIB_PATH = os.path.abspath(os.path.join(_CSRC, "libwavio.so"))
_LIB: Optional[ctypes.CDLL] = None
_BUILD_TRIED = False


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_TRIED
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_LIB_PATH) and not _BUILD_TRIED:
        _BUILD_TRIED = True
        try:
            subprocess.run(
                ["make", "-C", os.path.abspath(_CSRC)],
                check=True,
                capture_output=True,
            )
        except Exception:
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.wav_read_f32.restype = ctypes.c_int
    lib.wav_read_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.wav_read_batch_f32.restype = ctypes.c_int
    _LIB = lib
    return lib


def wav_info(path: str) -> Tuple[int, int, int, int]:
    """Return (sample_rate, num_frames, channels, bits) for a WAV file."""
    lib = _load_lib()
    if lib is not None:
        sr = ctypes.c_int()
        nf = ctypes.c_int64()
        ch = ctypes.c_int()
        bits = ctypes.c_int()
        rc = lib.wav_info(path.encode(), sr, nf, ch, bits)
        if rc != 0:
            raise RuntimeError(f"wav_info failed ({rc}) for {path}")
        return sr.value, nf.value, ch.value, bits.value
    import wave

    with wave.open(path, "rb") as w:
        return (
            w.getframerate(),
            w.getnframes(),
            w.getnchannels(),
            8 * w.getsampwidth(),
        )


def wav_read(
    path: str, frame_offset: int = 0, num_frames: int = -1
) -> Tuple[np.ndarray, int]:
    """Read (channel-0) samples as float32 in [-1, 1]; returns (audio, sr)."""
    lib = _load_lib()
    if lib is not None:
        if num_frames < 0:
            _, total, _, _ = wav_info(path)
            num_frames = total - frame_offset
        out = np.zeros(num_frames, dtype=np.float32)
        fr = ctypes.c_int64()
        sr = ctypes.c_int()
        rc = lib.wav_read_f32(
            path.encode(),
            frame_offset,
            num_frames,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            fr,
            sr,
        )
        if rc != 0:
            raise RuntimeError(f"wav_read failed ({rc}) for {path}")
        return out, sr.value
    import wave

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        w.setpos(min(frame_offset, w.getnframes()))
        n = num_frames if num_frames >= 0 else w.getnframes() - frame_offset
        raw = w.readframes(n)
        width = w.getsampwidth()
        ch = w.getnchannels()
        if width == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif width == 4:
            data = (
                np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
            )
        elif width == 1:
            data = (
                np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
        else:  # 24-bit
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            v = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            v = np.where(v & 0x800000, v - (1 << 24), v)
            data = v.astype(np.float32) / 8388608.0
        data = data.reshape(-1, ch)[:, 0]
        if len(data) < n:
            data = np.pad(data, (0, n - len(data)))
        return data.astype(np.float32), sr


_FLAC_LIB: Optional[ctypes.CDLL] = None


def _load_flac_lib() -> Optional[ctypes.CDLL]:
    global _FLAC_LIB
    if _FLAC_LIB is not None:
        return _FLAC_LIB
    path = os.path.abspath(os.path.join(_CSRC, "libflacdec.so"))
    if not os.path.exists(path):
        _load_lib()  # triggers the make build (builds both libs)
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.flac_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.flac_info.restype = ctypes.c_int
    lib.flac_read_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.flac_read_f32.restype = ctypes.c_int
    _FLAC_LIB = lib
    return lib


def flac_info(path: str) -> Tuple[int, int, int, int]:
    """(sample_rate, num_frames, channels, bits) from a FLAC STREAMINFO."""
    lib = _load_flac_lib()
    if lib is None:
        raise RuntimeError("libflacdec.so unavailable (run make -C csrc)")
    sr = ctypes.c_int()
    nf = ctypes.c_int64()
    ch = ctypes.c_int()
    bits = ctypes.c_int()
    rc = lib.flac_info(path.encode(), sr, nf, ch, bits)
    if rc != 0:
        raise RuntimeError(f"flac_info failed ({rc}) for {path}")
    return sr.value, nf.value, ch.value, bits.value


def flac_read(
    path: str, frame_offset: int = 0, num_frames: int = -1
) -> Tuple[np.ndarray, int]:
    """Decode (channel-0) FLAC samples as float32; returns (audio, sr)."""
    lib = _load_flac_lib()
    if lib is None:
        raise RuntimeError("libflacdec.so unavailable (run make -C csrc)")
    if num_frames < 0:
        _, total, _, _ = flac_info(path)
        num_frames = total - frame_offset
    out = np.zeros(max(num_frames, 0), dtype=np.float32)
    fr = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.flac_read_f32(
        path.encode(),
        frame_offset,
        num_frames,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fr,
        sr,
    )
    if rc != 0:
        raise RuntimeError(f"flac_read failed ({rc}) for {path}")
    return out, sr.value


def audio_info(path: str) -> Tuple[int, int, int, int]:
    """Dispatch header scan by extension (wav / flac)."""
    if path.lower().endswith(".flac"):
        return flac_info(path)
    return wav_info(path)


def audio_read(
    path: str, frame_offset: int = 0, num_frames: int = -1
) -> Tuple[np.ndarray, int]:
    """Dispatch sample read by extension (wav / flac)."""
    if path.lower().endswith(".flac"):
        return flac_read(path, frame_offset, num_frames)
    return wav_read(path, frame_offset, num_frames)


def wav_read_batch(
    paths: Sequence[str],
    frame_offsets: Sequence[int],
    num_frames: Sequence[int],
    out_len: int,
    num_threads: int = 8,
) -> np.ndarray:
    """Read a batch of frames into ``[n, out_len]`` float32 (zero-padded)."""
    n = len(paths)
    out = np.zeros((n, out_len), dtype=np.float32)
    lib = _load_lib()
    if lib is not None and n > 0:
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        c_off = (ctypes.c_int64 * n)(*[int(o) for o in frame_offsets])
        c_num = (ctypes.c_int64 * n)(*[min(int(m), out_len) for m in num_frames])
        failures = lib.wav_read_batch_f32(
            c_paths,
            c_off,
            c_num,
            None,
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_len,
            num_threads,
        )
        if failures:
            # the C layer zero-fills failed rows; surface the error like
            # the single-file path does instead of training on silence
            raise RuntimeError(
                f"wav_read_batch: {failures}/{n} file reads failed "
                f"(first paths: {list(paths)[:3]})"
            )
        return out
    for i, (p, off, m) in enumerate(zip(paths, frame_offsets, num_frames)):
        audio, _ = wav_read(p, int(off), min(int(m), out_len))
        out[i, : len(audio)] = audio
    return out
