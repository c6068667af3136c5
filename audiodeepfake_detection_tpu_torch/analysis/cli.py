"""Offline-analysis command line, covering the reference's script entry points.

Sub-commands (reference counterparts):

* ``attribution``   — plot saved integrated-gradients scores
  (reference: scripts/attribution.py).
* ``fingerprints``  — per-generator mean WPT/rFFT spectra + diffs + audible
  reconstruction (reference: scripts/freq_visual/fingerprints.py).
* ``spectrogram`` / ``scalogram`` — single-utterance figures across
  generators (reference: scripts/freq_visual/spectrograms.py,
  scalograms.py).
* ``energy``        — average STFT energy / spectral centroid / YIN pitch
  (reference: scripts/freq_visual/avg_energy_stft.py).
* ``modeldiff``     — misclassification set-diff of two true-index dumps
  (reference: scripts/analyze_model_diffs.py).

Counterpart of ``audiodeepfake_detection_tpu/analysis/cli.py``, with its
sub-commands, flags and file names.  ``--device`` (default ``cuda``; the
CPU must be asked for) says where the transforms of ``fingerprints``,
``spectrogram``, ``scalogram`` and ``energy`` run.  ``fingerprints --sp``
shards each clip's time axis over the ranks (``parallel/sequence.py``):
run it under torchrun (``torchrun --nproc-per-node N -m
audiodeepfake_detection_tpu_torch.analysis.cli fingerprints --sp ...``;
gloo ranks with ``--device cpu``); rank 0 writes the files.  With one rank
it is the dense transform, as JAX's one-device mesh is.

Run ``python -m audiodeepfake_detection_tpu_torch.analysis.cli <cmd> --help``.
"""

from __future__ import annotations

import argparse
import os
import wave

import numpy as np

from ..train.predict import resolve_device


def _cmd_attribution(args) -> None:
    from .plots import plot_attribution

    plot_attribution(
        transformations=args.transforms,
        wavelets=args.wavelets,
        cross_sources=args.cross_sources,
        plot_path=args.plot_path,
        seconds=args.seconds,
        sample_rate=args.sample_rate,
        num_of_scales=args.num_of_scales,
    )


def _cmd_fingerprints(args) -> None:
    from .fingerprints import generator_fingerprints

    from ..parallel.mesh import is_distributed, is_lead

    mesh, joined = None, False
    if args.sp:
        # shard each clip's time axis over the ranks for the deep (level-14)
        # transform -- parallel/sequence.py
        from ..parallel.mesh import get_mesh
        from ..train.experiment import maybe_initialize_distributed
        from ..utils.config import DotDict

        joined = not is_distributed()
        _, _, args.device = maybe_initialize_distributed(DotDict(device=str(args.device)))
        joined = joined and is_distributed()
        mesh = get_mesh(args.device)
    try:
        out = generator_fingerprints(
            args.data_path,
            args.generators,
            real_name=args.real_name,
            wavelet=args.wavelet,
            level=args.level,
            max_files=args.max_files,
            device=args.device,
            mesh=mesh,
        )
        if is_lead():
            _write_fingerprints(args, out)
    finally:
        if joined:  # a group the caller made is the caller's to destroy
            import torch.distributed as dist

            dist.barrier()
            dist.destroy_process_group()


def _write_fingerprints(args, out) -> None:
    from .fingerprints import fingerprint_audio

    os.makedirs(args.out_dir, exist_ok=True)
    for gen, spectra in out.items():
        for key, spec in spectra.items():
            np.save(os.path.join(args.out_dir, f"{gen}_{key}.npy"), spec)
        if "rfft" in spectra:
            audio = fingerprint_audio(spectra["rfft"])
            audio = audio / max(np.abs(audio).max(), 1e-9) * 0.5
            with wave.open(
                os.path.join(args.out_dir, f"{gen}_fingerprint.wav"), "wb"
            ) as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(args.sample_rate)
                w.writeframes((audio * 32767).astype("<i2").tobytes())
    print(f"wrote fingerprints for {sorted(out)} to {args.out_dir}")


def _cmd_spectrogram(args) -> None:
    from .plots import compute_spectrogram, load_audio, plot_spectrogram

    audio, sr = load_audio(args.wav, args.from_frame, args.num_frames)
    spec = compute_spectrogram(audio, n_fft=args.n_fft, hop=args.hop, device=args.device)
    plot_spectrogram(spec, sr, args.hop, args.out)
    print(f"wrote {args.out}.jpg")


def _cmd_scalogram(args) -> None:
    from .plots import compute_scalogram, load_audio, plot_scalogram

    audio, sr = load_audio(args.wav, args.from_frame, args.num_frames)
    scal, freqs = compute_scalogram(audio, sr, num_scales=args.num_scales,
                                    device=args.device)
    plot_scalogram(scal[:, 0] if scal.ndim == 3 else scal, freqs, sr, args.out)
    print(f"wrote {args.out}.jpg")


def _cmd_energy(args) -> None:
    from ..data.wavio import audio_read
    from .stats import average_energy, corpus_stats

    # filter by extension BEFORE slicing (a dir whose first entries are
    # metadata/subdirs would otherwise yield fewer clips than asked for)
    names = [
        f
        for f in sorted(os.listdir(args.data_dir))
        if f.endswith((".wav", ".flac"))
    ][: args.max_files]
    if not names:
        raise SystemExit(f"no wav/flac files under {args.data_dir}")
    clips, rates = [], []
    for f in names:
        audio, sr = audio_read(os.path.join(args.data_dir, f))
        clips.append(audio)
        rates.append(sr)
    energy = average_energy(clips, device=args.device)
    np.save(args.out + "_energy.npy", energy)
    # per-clip centroid/pitch statistics over the WHOLE corpus, like the
    # reference's avg_energy_stft aggregation (it collects mean centroid
    # and mean/std pitch per clip, then summarizes)
    stats = corpus_stats(clips, rates, device=args.device)
    np.save(args.out + "_centroid.npy", stats["centroids"])
    np.save(
        args.out + "_pitch.npy",
        np.stack([stats["pitch_means"], stats["pitch_stds"]], axis=1),
    )
    print(
        f"energy[{energy.shape}] over {len(clips)} clips, "
        f"centroid mean {stats['centroid_mean']:.1f} Hz, "
        f"pitch mean {stats['pitch_mean']:.1f} "
        f"+- {stats['pitch_std_mean']:.1f} Hz -> {args.out}_*.npy"
    )


def _cmd_modeldiff(args) -> None:
    from .model_diffs import export_diff_audio

    diff = export_diff_audio(
        args.model_a, args.model_b, args.out_dir, key=args.key, count=args.count
    )
    print(f"{len(diff)} differing samples; exported {min(len(diff), args.count)}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Offline analysis tools")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("attribution")
    p.add_argument("--plot-path", required=True)
    p.add_argument("--transforms", nargs="+", default=["packets", "stft"])
    p.add_argument("--wavelets", nargs="+", default=["sym5"])
    p.add_argument("--cross-sources", nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--num-of-scales", type=int, default=256)
    p.set_defaults(fn=_cmd_attribution)

    p = sub.add_parser("fingerprints")
    p.add_argument("--data-path", required=True)
    p.add_argument("--generators", nargs="+", required=True)
    p.add_argument("--real-name", default="real")
    p.add_argument("--wavelet", default="haar")
    p.add_argument("--level", type=int, default=14)
    p.add_argument("--max-files", type=int, default=128)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--out-dir", default="./plots/fingerprints")
    p.add_argument(
        "--sp", action="store_true",
        help="sequence-parallel WPT over the ranks of a torchrun launch",
    )
    p.set_defaults(fn=_cmd_fingerprints)

    p = sub.add_parser("spectrogram")
    p.add_argument("wav")
    p.add_argument("--out", default="./plots/spectrogram")
    p.add_argument("--n-fft", type=int, default=1024)
    p.add_argument("--hop", type=int, default=256)
    p.add_argument("--from-frame", type=int, default=0)
    p.add_argument("--num-frames", type=int, default=-1)
    p.set_defaults(fn=_cmd_spectrogram)

    p = sub.add_parser("scalogram")
    p.add_argument("wav")
    p.add_argument("--out", default="./plots/scalogram")
    p.add_argument("--num-scales", type=int, default=512)
    p.add_argument("--from-frame", type=int, default=0)
    p.add_argument("--num-frames", type=int, default=-1)
    p.set_defaults(fn=_cmd_scalogram)

    p = sub.add_parser("energy")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", default="./plots/stats")
    p.add_argument("--max-files", type=int, default=32)
    p.set_defaults(fn=_cmd_energy)

    p = sub.add_parser("modeldiff")
    p.add_argument("model_a")
    p.add_argument("model_b")
    p.add_argument("--out-dir", default="./plots/diffs")
    p.add_argument("--key", default="unknown")
    p.add_argument("--count", type=int, default=10)
    p.set_defaults(fn=_cmd_modeldiff)

    for name in ("fingerprints", "spectrogram", "scalogram", "energy"):
        sub.choices[name].add_argument(
            "--device", default="cuda",
            help="torch device of the transforms (default cuda; cpu must be asked for)",
        )
    args = parser.parse_args(argv)
    if "device" in args:
        args.device = resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
