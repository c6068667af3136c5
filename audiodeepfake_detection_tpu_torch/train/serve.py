"""HTTP scoring microservice with cross-request micro-batching.

Counterpart of ``audiodeepfake_detection_tpu/train/serve.py``: a trained
snapshot becomes a long-lived HTTP endpoint that scores raw wav/flac
uploads on one device.

* ONE scorer at a fixed batch size: every dispatch is padded to the same
  ``[B, 1, T]`` shape, so the device sees one shape and cuDNN one plan.
* cross-request micro-batching: concurrent HTTP requests land in one
  queue; a single dispatcher thread coalesces their frames (up to
  ``batch_size``, waiting at most ``max_wait_ms`` for stragglers) into
  shared device batches.
* frames travel host -> device from pinned memory without blocking, and at
  most 8 dispatches are in flight before the oldest result is fetched.
* decode/framing/resampling run host-side in the HTTP worker threads
  (the C++ decoder releases the GIL), overlapping the device dispatches.

Endpoints::

    POST /score[?aggregate=mean|max]   body = wav or flac bytes
        -> {"p_fake": float, "frames": int, "frame_scores": [float, ...]}
    GET  /healthz
        -> {"status": "ok", "model": ..., "batch_size": ..., ...}

CLI::

    python -m audiodeepfake_detection_tpu_torch.train.serve snapshot.pt \
        --port 8417 [--norm stats.pkl | --mean .. --std ..] \
        [--batch-size 64] [--max-wait-ms 5] [--device cuda]
"""

from __future__ import annotations

import json
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .predict import MAX_INFLIGHT, resolve_device


@dataclass
class _Request:
    frames: np.ndarray  # [n, win] float32 or int16
    aggregate: str
    future: Future = field(default_factory=Future)


class ScoringService:
    """Micro-batching scorer: many concurrent clips, one dispatch stream.

    Usable directly (``submit`` / ``score_clip``) or behind the HTTP
    front-end (``serve`` / ``make_server``).  ``start``/``stop`` manage the
    dispatcher thread; the constructor runs one warm-up batch so the first
    real request pays no kernel build or cuDNN plan search.
    """

    def __init__(
        self,
        model,
        transform: Callable,
        device: torch.device | str = "cuda",
        sample_rate: int = 22050,
        seconds: float = 1.0,
        batch_size: int = 64,
        max_wait_ms: float = 5.0,
        output: str = "prob",
        warmup: bool = True,
        max_body_bytes: int = 64 << 20,
        request_timeout_s: float = 120.0,
        pcm16: bool = False,
        chunk: int = 0,
    ) -> None:
        from .predict import make_score_fn

        self.device = resolve_device(device)
        self.sample_rate = int(sample_rate)
        self.win = int(seconds * sample_rate)
        self.batch_size = int(batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.max_body_bytes = int(max_body_bytes)
        self.request_timeout_s = float(request_timeout_s)
        # ship frames as int16 PCM, converting on the device: half the
        # host->device bytes per dispatch.  Bit-exact for 16-bit wav
        # uploads (decode is pcm/32768, the re-round is exact); float
        # submissions quantize to 16 bits (~96 dB SNR).
        self.pcm16 = bool(pcm16)
        self._wire_dtype = torch.int16 if pcm16 else torch.float32
        # 0: the whole batch, the fastest for every model on the H100
        self.chunk = int(chunk)
        if self.chunk and self.chunk < self.batch_size and self.batch_size % self.chunk:
            # a chunk that silently fell back to whole batches would hide
            # the setting from the operator: refuse it up front
            raise ValueError(
                f"chunk={self.chunk} does not divide batch_size={self.batch_size}"
            )
        self._score = make_score_fn(
            model, transform, self.device, output=output, chunk=self.chunk
        )
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = object()
        self.model = model  # the scoring model (an int8 one carries its scales)
        self.model_name = type(model).__name__
        self.n_scored = 0
        self.n_dispatches = 0
        if warmup:
            self._score(
                torch.zeros((self.batch_size, 1, self.win), dtype=self._wire_dtype)
            ).cpu()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ScoringService":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._dispatch_loop, daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._queue.put(self._stop)
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "ScoringService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- scoring

    def frame_clip(self, audio: np.ndarray, in_rate: int) -> np.ndarray:
        """Resample + cut a 1-D clip into ``[n, win]`` scoring frames."""
        from ..ops.audio import resample

        if in_rate > self.sample_rate:
            audio = resample(audio, in_rate, self.sample_rate)
        elif in_rate < self.sample_rate:
            raise ValueError(
                f"clip sample rate {in_rate} < service rate "
                f"{self.sample_rate}; no upsampling here"
            )
        n = len(audio) // self.win
        if n == 0:
            raise ValueError(
                f"clip shorter than one {self.win}-sample frame"
            )
        frames = np.asarray(audio[: n * self.win], np.float32).reshape(
            n, self.win
        )
        return self._to_wire(frames)

    def _to_wire(self, frames: np.ndarray) -> np.ndarray:
        """Convert float frames to the wire dtype (int16 when pcm16)."""
        if not self.pcm16 or frames.dtype == np.int16:
            return frames
        return np.clip(
            np.round(frames.astype(np.float32) * 32768.0), -32768, 32767
        ).astype(np.int16)

    def submit(self, frames: np.ndarray, aggregate: str = "mean") -> Future:
        """Queue pre-framed audio ``[n, win]``; resolves to the clip score.

        The future's result is ``(clip_score, frame_scores)``.
        """
        if self.pcm16:
            frames = self._to_wire(np.ascontiguousarray(frames))
        else:
            frames = np.ascontiguousarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[1] != self.win:
            raise ValueError(
                f"expected [n, {self.win}] frames, got {frames.shape}"
            )
        if frames.shape[0] == 0:  # empty slice would mean() to NaN p_fake
            raise ValueError("no frames to score (empty clip)")
        if aggregate not in ("mean", "max"):
            raise ValueError(f"aggregate must be mean or max: {aggregate}")
        if self._thread is None:
            raise RuntimeError("service not started (call start())")
        req = _Request(frames, aggregate)
        self._queue.put(req)
        return req.future

    def score_clip(
        self, audio: np.ndarray, in_rate: int, aggregate: str = "mean"
    ):
        """Blocking decode-side entry: 1-D clip -> (score, frame_scores)."""
        return self.submit(self.frame_clip(audio, in_rate), aggregate).result()

    # ------------------------------------------------------------ dispatcher

    def _collect(self) -> Optional[List[_Request]]:
        """Block for one request, then coalesce stragglers until one device
        batch is pending or ``max_wait_ms`` passes.  None on shutdown."""
        import time

        first = self._queue.get()
        if first is self._stop:
            return None
        pending = [first]
        n = len(first.frames)
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while n < self.batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is self._stop:
                self._queue.put(self._stop)  # re-queue for the outer loop
                break
            pending.append(nxt)
            n += len(nxt.frames)
        return pending

    def _host_batch(self, frames: np.ndarray) -> torch.Tensor:
        """One zero-padded ``[batch_size, 1, win]`` host batch, pinned when
        it goes to a GPU so the copy does not block the dispatcher."""
        batch = torch.zeros(
            (self.batch_size, 1, self.win),
            dtype=self._wire_dtype,
            pin_memory=self.device.type == "cuda",
        )
        batch[: len(frames), 0] = torch.from_numpy(frames)
        return batch

    def _dispatch_loop(self) -> None:
        while True:
            pending = self._collect()
            if pending is None:
                return
            # The loop must survive any per-batch failure (device OOM, a
            # kernel error): fail THESE requests, keep serving the next —
            # a dead dispatcher would leave every future pending forever
            # while /healthz still answered ok.
            try:
                frames = np.concatenate([r.frames for r in pending])
                scores = np.empty(len(frames), np.float32)
                outs = []

                def drain(until):
                    while len(outs) > until:
                        s, n, out = outs.pop(0)
                        scores[s : s + n] = out.cpu().numpy()[:n]

                for s in range(0, len(frames), self.batch_size):
                    part = frames[s : s + self.batch_size]
                    out = self._score(self._host_batch(part))
                    outs.append((s, len(part), out))
                    self.n_dispatches += 1
                    drain(MAX_INFLIGHT)
                drain(0)
            except Exception as exc:
                for req in pending:
                    if not req.future.done():
                        req.future.set_exception(exc)
                continue
            off = 0
            for req in pending:
                fs = scores[off : off + len(req.frames)]
                off += len(req.frames)
                agg = float(fs.max() if req.aggregate == "max" else fs.mean())
                req.future.set_result((agg, fs.copy()))
                self.n_scored += len(req.frames)

    # ----------------------------------------------------------------- http

    def serve(self, host: str = "127.0.0.1", port: int = 8417) -> None:
        """Run the HTTP front-end (blocking; ``make_server`` is the
        non-blocking variant used by tests and embedders)."""
        server = self.make_server(host, port)
        print(
            f"serving {self.model_name} on http://{host}:{server.server_port}"
            f"  (batch {self.batch_size}, frame {self.win} samples, "
            f"device {self.device})"
        )
        try:
            server.serve_forever()
        finally:
            server.server_close()

    def make_server(self, host: str = "127.0.0.1", port: int = 0):
        """Build (don't run) the threaded HTTP server."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: one line per request is noise
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.split("?")[0] != "/healthz":
                    return self._reply(404, {"error": "unknown path"})
                self._reply(
                    200,
                    {
                        "status": "ok",
                        "model": service.model_name,
                        "device": str(service.device),
                        "batch_size": service.batch_size,
                        "sample_rate": service.sample_rate,
                        "frame_samples": service.win,
                        "pcm16": service.pcm16,
                        "chunk": service.chunk,
                        "frames_scored": service.n_scored,
                        "dispatches": service.n_dispatches,
                    },
                )

            def do_POST(self):
                import urllib.parse

                path, _, query = self.path.partition("?")
                if path != "/score":
                    return self._reply(404, {"error": "unknown path"})
                params = urllib.parse.parse_qs(query)
                aggregate = params.get("aggregate", ["mean"])[0]
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length <= 0:
                        raise ValueError("empty body (expected audio bytes)")
                    if length > service.max_body_bytes:
                        # drain (bounded) before replying: closing with
                        # unread data in the receive buffer sends a TCP
                        # RST and the client never sees the 413 JSON
                        remaining = min(length, 8 << 20)
                        while remaining > 0:
                            got = self.rfile.read(min(remaining, 1 << 16))
                            if not got:
                                break
                            remaining -= len(got)
                        self.close_connection = True
                        return self._reply(
                            413,
                            {
                                "error": "body too large "
                                f"({length} > {service.max_body_bytes} bytes)"
                            },
                        )
                    raw = self.rfile.read(length)
                    frames = service._decode_upload(raw)
                    score, frame_scores = service.submit(
                        frames, aggregate
                    ).result(timeout=service.request_timeout_s)
                except ValueError as exc:
                    return self._reply(400, {"error": str(exc)})
                except Exception as exc:  # dispatch failure / timeout: 5xx
                    return self._reply(
                        503, {"error": f"scoring failed: {exc}"}
                    )
                self._reply(
                    200,
                    {
                        "p_fake": score,
                        "frames": len(frame_scores),
                        "frame_scores": [float(x) for x in frame_scores],
                        "aggregate": aggregate,
                    },
                )

        return ThreadingHTTPServer((host, port), Handler)

    def _decode_upload(self, raw: bytes) -> np.ndarray:
        """Decode an uploaded wav/flac body into scoring frames."""
        import os
        import tempfile

        from ..data.wavio import audio_read

        if raw[:4] == b"RIFF":
            suffix = ".wav"
        elif raw[:4] == b"fLaC":
            suffix = ".flac"
        else:
            raise ValueError(
                "unrecognized audio container (expected RIFF/WAVE or fLaC)"
            )
        fd, path = tempfile.mkstemp(suffix=suffix)
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(raw)
            try:
                audio, rate = audio_read(path)
            except Exception as exc:  # corrupt body: client error, not 500
                raise ValueError(f"undecodable audio: {exc}") from exc
            return self.frame_clip(audio, rate)
        finally:
            os.unlink(path)


def service_from_snapshot(
    snapshot: str,
    norm: Optional[str] = None,
    mean=None,
    std=None,
    batch_size: int = 64,
    max_wait_ms: float = 5.0,
    int8: bool = False,
    calibrate: Sequence[str] = (),
    output: str = "prob",
    pcm16: bool = False,
    chunk: int = 0,
    device: torch.device | str = "cuda",
    use_kernel: bool = True,
) -> ScoringService:
    """Build a ready-to-start service from a config-encoded ``.pt``.

    ``int8`` quantizes post-training (``ops/quantize.py``) with activation
    scales calibrated on ``calibrate`` (files/dirs; at most 4 batches of
    their frames) through the same normalized transform the service scores
    with, and bakes the int8 weights once.  ``use_kernel`` (the JAX
    package's ``use_pallas``): the wavelet-packet transform through its op
    (the CUDA kernel on the card, the plain cascade on the CPU), or, when
    False, the plain PyTorch cascade on any device.
    """
    from ..data.wavio import audio_read
    from ..ops.audio import resample
    from .predict import _expand_inputs, build_scorer_from_snapshot, quantize_for_scoring

    model, transform, cfg = build_scorer_from_snapshot(
        snapshot, norm=norm, mean=mean, std=std, use_kernel=use_kernel
    )
    sr, sec = int(cfg.sample_rate), float(cfg.seconds)
    if int8:
        paths = _expand_inputs(list(calibrate))
        if not paths:
            raise ValueError("--int8 needs --calibrate files/dirs")
        win = int(sr * sec)
        frames: List[np.ndarray] = []
        for path in paths:
            audio, in_sr = audio_read(path)
            if in_sr > sr:
                audio = resample(audio, in_sr, sr)
            frames += [audio[i * win : (i + 1) * win] for i in range(len(audio) // win)]
        if not frames:
            raise ValueError("calibration clips shorter than one frame")
        model = quantize_for_scoring(model, transform, frames, device, batch_size)
    return ScoringService(
        model,
        transform,
        device=device,
        sample_rate=sr,
        seconds=sec,
        batch_size=batch_size,
        max_wait_ms=max_wait_ms,
        output=output,
        pcm16=pcm16,
        chunk=chunk,
    )


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Serve a trained deepfake detector over HTTP"
    )
    parser.add_argument("snapshot", help=".pt snapshot (config-encoded name)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8417)
    parser.add_argument("--norm", default=None, help="*_mean_std.pkl")
    parser.add_argument("--mean", type=float, nargs="+", default=None)
    parser.add_argument("--std", type=float, nargs="+", default=None)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument(
        "--max-wait-ms", type=float, default=5.0,
        help="micro-batcher straggler wait",
    )
    parser.add_argument(
        "--int8", action="store_true",
        help="post-training int8 quantization (needs --calibrate)",
    )
    parser.add_argument(
        "--calibrate", nargs="+", default=[],
        help="clips/dirs for int8 activation calibration",
    )
    parser.add_argument(
        "--output", default="prob", choices=("prob", "margin"),
        help="score head (see predict.make_score_fn)",
    )
    parser.add_argument(
        "--pcm16", action="store_true",
        help="ship frames to the device as int16 PCM (halved host->device "
        "bytes; bit-exact for 16-bit wav uploads)",
    )
    parser.add_argument(
        "--chunk", type=int, default=0,
        help="run the model over microbatches of this size inside each "
        "dispatch (must divide --batch-size; default 0: the whole batch)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to score on (default cuda; cpu must be asked for)",
    )
    parser.add_argument(
        "--no-kernel", dest="use_kernel", action="store_false",
        help="the plain PyTorch wavelet-packet cascade instead of its CUDA kernel",
    )
    args = parser.parse_args(argv)
    # fp32 convolutions, like the JAX reference's HIGHEST precision
    torch.backends.cudnn.allow_tf32 = False
    service = service_from_snapshot(
        args.snapshot,
        norm=args.norm,
        mean=args.mean,
        std=args.std,
        batch_size=args.batch_size,
        max_wait_ms=args.max_wait_ms,
        int8=args.int8,
        calibrate=args.calibrate,
        output=args.output,
        pcm16=args.pcm16,
        chunk=args.chunk,
        device=args.device,
        use_kernel=args.use_kernel,
    )
    with service:
        service.serve(args.host, args.port)


if __name__ == "__main__":
    main()
