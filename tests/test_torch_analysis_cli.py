"""The port's analysis CLI, ``--only-ig`` and ``--tensorboard`` (CPU).

Each sub-command of ``analysis.cli`` runs beside the JAX package's CLI on
the same inputs: the same file names, and the arrays within the stated
tolerances.  ``--only-ig`` and ``--tensorboard`` run through the port's
``run_experiment`` / ``main`` on a tiny wav corpus and a narrow DCNN.
"""

import ast
import os
import pathlib
import struct
import sys
import wave

import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.analysis import cli as jax_cli
from audiodeepfake_detection_tpu_torch.analysis import cli
from audiodeepfake_detection_tpu_torch.train.experiment import main, run_experiment
from audiodeepfake_detection_tpu_torch.utils.config import default_config

SR = 22050
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread for the file: the suite runs several workers
    on the same cores, and their intra-op threads would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_wav(path, samples, sr=SR):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(samples * 32767, -32768, 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Tones against noise, 4 clips of 4 s per source (``A_real``,
    ``B_fbmelgan``): what the CLI reads and what the runs train on."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    for dirname, kind in (("A_real", "tone"), ("B_fbmelgan", "noise")):
        (root / dirname).mkdir()
        for i in range(4):
            t = np.arange(4 * SR) / SR
            x = (0.5 * np.sin(2 * np.pi * (300 + 50 * i) * t) if kind == "tone"
                 else 0.3 * rng.randn(4 * SR))
            _write_wav(root / dirname / f"clip{i}.wav", x.astype(np.float32))
    return root


def _files(path):
    return sorted(p.relative_to(path).as_posix() for p in pathlib.Path(path).rglob("*")
                  if p.is_file())


def _both(tmp_path, argv):
    """Run the JAX CLI and the port's CLI (``--device cpu``) with ``argv``,
    each writing under its own directory; ``{out}`` in an argument names
    that directory."""
    out = {}
    for name, fn, extra in (("jax", jax_cli.main, []), ("port", cli.main, None)):
        d = tmp_path / name
        d.mkdir()
        args = [a.replace("{out}", str(d)) for a in argv]
        if extra is None:
            args += ["--device", "cpu"] if args[0] in (
                "fingerprints", "spectrogram", "scalogram", "energy") else []
        fn(args)
        out[name] = d
    assert _files(out["jax"]) == _files(out["port"]) != []
    return out["jax"], out["port"]


def test_fingerprints_cli_matches_jax(corpus, tmp_path):
    """Level-14 haar packets of two 4 s clips per source: the same files;
    WPT spectra within 1e-6 relative, rFFT spectra (numpy) equal, the
    fingerprint wavs the same bytes."""
    theirs, ours = _both(tmp_path, [
        "fingerprints", "--data-path", str(corpus), "--generators", "fbmelgan",
        "--max-files", "2", "--out-dir", "{out}"])
    for name in _files(theirs):
        if name.endswith(".npy"):
            want, got = np.load(theirs / name), np.load(ours / name)
            if "wpt" in name:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
            else:
                np.testing.assert_array_equal(got, want)
        else:
            assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    # --sp outside a process group: one rank, the dense transform (as JAX's
    # one-device mesh), the same files and bits
    cli.main(["fingerprints", "--data-path", str(corpus), "--generators", "fbmelgan",
              "--max-files", "2", "--sp", "--device", "cpu", "--out-dir", str(tmp_path / "sp")])
    assert _files(tmp_path / "sp") == _files(ours)
    for name in _files(ours):
        assert (tmp_path / "sp" / name).read_bytes() == (ours / name).read_bytes(), name


def test_energy_cli_matches_jax(corpus, tmp_path):
    """Pure tones, where most STFT bins hold only roundoff: energy within
    2e-6 of its largest bin (read: 1.1e-6; the FFT against JAX's DFT
    matrix product, each ~1e-7 of a frame's peak per bin), centroids within
    5e-5 relative (read: 1.4e-5; that roundoff weighted by up to 11 kHz),
    YIN pitch (numpy) equal."""
    theirs, ours = _both(tmp_path, [
        "energy", "--data-dir", str(corpus / "A_real"), "--max-files", "2",
        "--out", "{out}/stats"])
    for name in _files(theirs):
        want, got = np.load(theirs / name), np.load(ours / name)
        if name.endswith("_pitch.npy"):
            np.testing.assert_array_equal(got, want)
        elif name.endswith("_energy.npy"):
            assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
        else:
            np.testing.assert_allclose(got, want, rtol=5e-5)


@pytest.mark.parametrize("cmd", ["spectrogram", "scalogram"])
def test_figure_clis_write_the_jax_files(corpus, tmp_path, cmd):
    """The same figure files; the arrays behind them are held against JAX
    in ``test_torch_analysis.py`` (the STFT and the CWT)."""
    extra = ["--num-scales", "16"] if cmd == "scalogram" else []
    _both(tmp_path, [cmd, str(corpus / "A_real" / "clip0.wav"), "--num-frames", "4096",
                     "--out", "{out}/fig", *extra])


def test_attribution_and_modeldiff_clis_write_the_jax_files(tmp_path):
    """``attribution`` plots the three target maps that ``--only-ig``
    saves; ``modeldiff`` exports the differing clips (the same bytes)."""
    plots = tmp_path / "plots"
    plots.mkdir()
    stem = "packets_22050_1_0_fbmelgan_sym5_2.0_False_ljspeech-melganx2500_target"
    rng = np.random.RandomState(1)
    for tgt in ("0", "1", "01"):
        np.save(plots / f"{stem}-{tgt}_integrated_gradients.npy",
                rng.randn(8, 12).astype(np.float32))
    for name, fn in (("jax", jax_cli.main), ("port", cli.main)):
        fn(["attribution", "--plot-path", str(plots), "--transforms", "packets",
            "--cross-sources", "melgan", "--num-of-scales", "8"])
        assert (plots / f"{stem}_integrated_gradients.jpg").exists()
        (plots / f"{stem}_integrated_gradients.jpg").rename(plots / f"{name}.jpg")

    wav = tmp_path / "clip.wav"
    _write_wav(wav, 0.2 * rng.randn(3000))
    table = np.asarray([[str(wav), i, 1000, i % 2] for i in range(3)], dtype=object)
    np.save(tmp_path / "a.npy", {"unknown": np.asarray([0, 2]), "dataset": table})
    np.save(tmp_path / "b.npy", {"unknown": np.asarray([2]), "dataset": table})
    theirs, ours = _both(tmp_path, [
        "modeldiff", str(tmp_path / "a.npy"), str(tmp_path / "b.npy"), "--out-dir", "{out}"])
    for name in _files(theirs):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()


# ----------------------------------------------- run_experiment and main


def _args(corpus, log_dir, **extra):
    """A narrow DCNN on level-8 haar packets of 1 s frames, batch 8."""
    a = default_config()
    a.update(
        data_path=str(corpus), save_path=str(log_dir / "meta"),
        data_prefix=str(corpus) + "/fake_22050_22050_0.7_fbmelgan",
        log_dir=str(log_dir), transform="packets", wavelet="haar", num_of_scales=256,
        log_scale=True, batch_size=8, epochs=1, learning_rate=4e-4, weight_decay=1e-3,
        model="modules", module="DCNN", ochannels1=8, ochannels2=8, ochannels3=12,
        ochannels4=16, ochannels5=4, flattend_size=320, time_dim_add=1,
        calc_normalization=True, only_use=["real", "fbmelgan"],
        limit_train=(100, 100, 100), cross_data_path=str(corpus),
        cross_sources=["real", "fbmelgan"], cross_limit=(100, 100, 4), seed=0,
        device="cpu",
    )
    a.update(extra)
    return a


def test_only_ig_writes_the_three_maps(corpus, tmp_path, capsys):
    """``--only-ig`` after a training run (target 1, one frame): the JAX
    package's three ``.npy`` names under ``<log_dir>/plots/``, finite and
    non-zero.  With ``fused_layer1`` set the run switches it off with JAX's
    message and writes the same maps bit for bit (kernel 2's backward has
    no input gradient, so left on, every map would read zero)."""
    kw = dict(ig_times_per_target=1, target="1")
    run_experiment(_args(corpus, tmp_path, **kw))
    stem = "packets_22050_1_0_fbmelgan_haar_2.0_False_real-fbmelganx1_target-1"
    maps = {}
    for fused in (False, True):
        run_experiment(_args(corpus, tmp_path, only_ig=True, fused_layer1=fused, **kw))
        names = sorted(os.listdir(tmp_path / "plots"))
        assert names == [f"{stem}_{kind}.npy" for kind in (
            "integrated_gradients", "last_image", "mean_images")]
        maps[fused] = {n: np.load(tmp_path / "plots" / n) for n in names}
    assert "only_ig: disabling fused_layer1" in capsys.readouterr().out
    ig = maps[False][f"{stem}_integrated_gradients.npy"]
    assert ig.shape == (256, 87) and np.isfinite(ig).all() and np.abs(ig).max() > 0
    for name, value in maps[False].items():
        np.testing.assert_array_equal(maps[True][name], value)


def _jax_tags(relpath, cls):
    """Every tag a JAX class writes: the string literals it hands to
    ``add_scalar`` / ``add_text`` (``add_text`` stores under
    ``<tag>/text_summary``).  Running the JAX Trainer here to read its
    event file would cost ~55 s of this file's budget."""
    tree = ast.parse((ROOT / "audiodeepfake_detection_tpu" / relpath).read_text())
    (node,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls]
    tags = set()
    for call in ast.walk(node):
        if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                and call.func.attr in ("add_scalar", "add_text")):
            tag = call.args[0].value
            tags.add(tag + "/text_summary" if call.func.attr == "add_text" else tag)
    return tags


def _event_tags(log_dir):
    """The tags of every event file under ``<log_dir>/tensorboard``, by run
    directory, read record by record (TFRecord framing: length, its CRC,
    an ``Event`` protobuf, its CRC) without TensorFlow."""
    from tensorboard.compat.proto import event_pb2

    runs = {}
    for path in pathlib.Path(log_dir, "tensorboard").rglob("events.out.tfevents.*"):
        data, i, tags = path.read_bytes(), 0, set()
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i : i + 8])
            event = event_pb2.Event.FromString(data[i + 12 : i + 12 + n])
            tags |= {v.tag for v in event.summary.value}
            i += 12 + n + 4
        runs[path.parent.relative_to(log_dir).as_posix()] = tags
    return runs


def test_tensorboard_writes_the_jax_trainer_tags(corpus, tmp_path):
    """``--tensorboard`` through ``run_experiment``: one event file under
    the JAX package's ``tensorboard_dir``, holding exactly the tags the JAX
    Trainer writes (validation every epoch, a cross set)."""
    trainer = run_experiment(_args(corpus, tmp_path, tensorboard=True,
                                   validation_interval=1))
    runs = _event_tags(tmp_path)
    assert list(runs) == ["tensorboard/DCNN/packets/haar/none/8_0.0004_0.001_1/1000.0-11025.0/"
                          "256/signsFalse/augcFalse/augnFalse/power2.0/fbmelgan/0"]
    assert runs.popitem()[1] == _jax_tags("train/trainer.py", "Trainer")
    assert len(trainer.loss_list) == 2


def test_tensorboard_sweep_writes_the_jax_sweep_tags(corpus, tmp_path):
    """``main --vmap-seeds --tensorboard``: one event file per seed, each
    holding exactly the tags the JAX sweep writes through its shadows."""
    config = tmp_path / "grid.py"
    config.write_text(
        "def get_config():\n"
        "    return {'ochannels1': [8], 'ochannels2': [8], 'ochannels3': [12],\n"
        "            'ochannels4': [16], 'ochannels5': [4], 'module': ['DCNN'],\n"
        "            'time_dim_add': [1], 'flattend_size': [320],\n"
        f"            'data_path': [{str(corpus)!r}], 'save_path': [{str(tmp_path / 'meta')!r}],\n"
        f"            'cross_data_path': [{str(corpus)!r}], 'cross_limit': [(100, 100, 4)],\n"
        "            'only_use': [['real', 'fbmelgan']], 'limit_train': [(100, 100, 100)]}\n"
    )
    main(["--enable-gs", "--config", str(config), "--init-seeds", "0", "1", "--vmap-seeds",
          "--tensorboard", "--device", "cpu", "--epochs", "1", "--batch-size", "8",
          "--validation-interval", "1", "--model", "modules", "--transform", "packets",
          "--wavelet", "haar", "--log-scale", "--calc-normalization",
          "--cross-sources", "real", "fbmelgan", "--log-dir", str(tmp_path),
          "--data-prefix", str(corpus) + "/fake_22050_22050_0.7_fbmelgan"])
    runs = _event_tags(tmp_path)
    assert sorted(r.rsplit("/", 1)[-1] for r in runs) == ["0", "1"]
    want = _jax_tags("train/sweep.py", "VectorizedSeedSweep")
    assert all(tags == want for tags in runs.values())


def test_tensorboard_without_the_package_names_it(corpus, tmp_path, monkeypatch):
    """On a machine without ``tensorboard`` (the GPU machine) the flag
    raises an ImportError that names the package, before any training."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="`tensorboard` package"):
        run_experiment(_args(corpus, tmp_path, tensorboard=True))
