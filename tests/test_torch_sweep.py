"""The port's vectorized seed sweep (``train/sweep.py``) through ``main``.

A grid with ``--vmap-seeds`` trains its seeds as one sweep; each seed's
snapshot (``.pt`` and ``.state.pt``) equals the serial run of that seed,
bit for bit: the sweep's seed axis is ``"scan"`` (with the fused first
block and dropout on; ``--vmap-hparams``: lr and seed as the slices).
Also: resume of an interrupted sweep in ``"scan"`` and in ``"vmap"``, the
guards, the serial fallback of a group the sweep refuses, each slice's
initial weights against ``run_experiment``'s, and no CPU fallback when the
card is missing.
"""

import types
import wave

import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.factory import get_model
from audiodeepfake_detection_tpu_torch.train import sweep as tsweep
from audiodeepfake_detection_tpu_torch.train import vectorized as tvec
from audiodeepfake_detection_tpu_torch.train.experiment import (
    main,
    run_experiment,
    run_experiment_vectorized,
)
from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

SR = 22050
SEEDS = [0, 1, 7]
WIDTHS = dict(ochannels1=8, ochannels2=8, ochannels3=12, ochannels4=16, ochannels5=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread: a sweep and the serial runs repeat each other bit for bit
    (PyTorch's split of a sum between threads is not fixed)."""
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
    root = tmp_path_factory.mktemp("fake")
    rng = np.random.RandomState(0)
    for dirname, kind in (("A_real", "tone"), ("B_fbmelgan", "noise")):
        (root / dirname).mkdir()
        for i in range(4):
            t = np.arange(4 * SR) / SR
            x = (0.5 * np.sin(2 * np.pi * (300 + 50 * i) * t) if kind == "tone"
                 else 0.3 * rng.randn(4 * SR))
            _write_wav(root / dirname / f"clip{i}.wav", x.astype(np.float32))
    return root


@pytest.fixture(scope="module")
def meta(tmp_path_factory):
    return tmp_path_factory.mktemp("meta")  # the index and norm caches, shared


def _args(corpus, meta, log_dir, **extra):
    """Narrow DCNN, fused first block, dropout and noise augmentation on,
    batch 8: 22 training frames are 2 steps an epoch."""
    a = default_config()
    a.update(
        data_path=str(corpus), save_path=str(meta),
        data_prefix=str(corpus) + "/fake_22050_22050_0.7_fbmelgan",
        log_dir=str(log_dir), transform="packets", wavelet="haar",
        num_of_scales=256, log_scale=True, batch_size=8, epochs=2,
        learning_rate=4e-4, weight_decay=1e-3, model="modules", module="DCNN",
        flattend_size=320, time_dim_add=1, calc_normalization=True,
        only_use=["real", "fbmelgan"], limit_train=(100, 100, 100),
        fused_layer1=True, aug_noise=True, seed=0, device="cpu", **WIDTHS,
    )
    a.update(extra)
    return a


def _grid(tmp_path, corpus, meta, **axes):
    config = tmp_path / "grid.py"
    grid = {"module": ["DCNN"], "time_dim_add": [1], "flattend_size": [320],
            "data_path": [str(corpus)], "save_path": [str(meta)],
            "only_use": [["real", "fbmelgan"]], "limit_train": [(100, 100, 100)],
            "learning_rate": [4e-4], "weight_decay": [1e-3],
            **{k: [v] for k, v in WIDTHS.items()}, **axes}
    config.write_text(f"def get_config():\n    return {grid!r}\n")
    return str(config)


def _main(config, corpus, log_dir, seeds, *flags):
    main(["--enable-gs", "--config", config, "--init-seeds", *map(str, seeds),
          "--device", "cpu", "--epochs", "2", "--batch-size", "8", "--model", "modules",
          "--transform", "packets", "--wavelet", "haar", "--log-scale", "--aug-noise",
          "--calc-normalization", "--log-dir", str(log_dir),
          "--data-prefix", str(corpus) + "/fake_22050_22050_0.7_fbmelgan", *flags])


def _states(trainer, other_log):
    """``(sweep, serial)`` snapshot and full state of one serial trainer."""
    def load(path):
        return torch.load(path, weights_only=True)

    swap = lambda p: p.replace(str(trainer.args.log_dir), str(other_log))  # noqa: E731
    return ((load(swap(trainer.snapshot_path)), load(swap(trainer.state_path))),
            (load(trainer.snapshot_path), load(trainer.state_path)))


def _assert_blobs_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_blobs_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_blobs_equal(g, w, f"{where}/{i}")
    else:
        assert got == want, where


def test_vmap_seeds_grid_equals_serial_runs(corpus, meta, tmp_path, capsys):
    """Fused first block and dropout, ``--steps-per-call 2`` (streamed: no
    effect): the sweep takes ``"scan"``; every seed's ``.pt`` and
    ``.state.pt`` (weights, Adam, step, the augmentation and dropout
    streams) equal its serial run's bit for bit, and so do its test
    metrics."""
    _main(_grid(tmp_path, corpus, meta), corpus, tmp_path / "logv", SEEDS,
          "--fused-layer1", "train", "--vmap-seeds", "--steps-per-call", "2")
    out = capsys.readouterr().out
    assert "in one vectorized sweep (seed axis scan)" in out
    assert out.count("Training done, now testing...") == 1
    assert "Best config:" in out
    for s in SEEDS:
        serial = run_experiment(_args(corpus, meta, tmp_path / "logs", seed=s))
        (pt, state), (want_pt, want_state) = _states(serial, tmp_path / "logv")
        _assert_blobs_equal(pt, want_pt, f"seed {s} .pt")
        _assert_blobs_equal(state, want_state, f"seed {s} .state.pt")
        assert f"seed {s} test results: known acc {serial.test_results[0] * 100:2.2f} %" in out


def test_vmap_hparams_grid_folds_lr_into_one_sweep(corpus, meta, tmp_path, capsys):
    """``--vmap-hparams`` with two seeds x two learning rates, dropout off
    and unfused: one ``"scan"`` sweep of four slices, each slice's
    ``.pt`` and ``.state.pt`` bit for bit its serial run's (the optimizer
    groups carry each slice's lr)."""
    _main(_grid(tmp_path, corpus, meta, learning_rate=[4e-4, 1e-3], dropout_cnn=[0.0],
                dropout_lstm=[0.0]),
          corpus, tmp_path / "logv", [0, 1], "--vmap-hparams")
    out = capsys.readouterr().out
    assert out.count("in one vectorized sweep (seed axis scan)") == 1
    for lr in (4e-4, 1e-3):
        for s in (0, 1):
            serial = run_experiment(_args(
                corpus, meta, tmp_path / "logs", seed=s, learning_rate=lr, fused_layer1=False,
                dropout_cnn=0.0, dropout_lstm=0.0))
            (pt, state), (want_pt, want_state) = _states(serial, tmp_path / "logv")
            _assert_blobs_equal(pt, want_pt, f"seed {s} lr {lr} .pt")
            _assert_blobs_equal(state, want_state, f"seed {s} lr {lr} .state.pt")


@pytest.mark.parametrize("seed_axis", ["scan", "vmap"])
def test_interrupted_sweep_resumes_from_per_seed_snapshots(corpus, meta, tmp_path,
                                                           monkeypatch, capsys, seed_axis):
    """A sweep stopped after its first epoch continues from the per-seed
    snapshots (``--resume``) and ends where an uninterrupted one does, bit
    for bit; ``"vmap"`` (asked for) with the first block unfused and
    dropout off."""
    kw = {} if seed_axis == "scan" else dict(fused_layer1=False, dropout_cnn=0.0,
                                             dropout_lstm=0.0)
    args = [_args(corpus, meta, tmp_path / "whole", seed=s, **kw) for s in SEEDS]
    whole = run_experiment_vectorized(args, seed_axis=seed_axis)
    run_epoch = tsweep.VectorizedSeedSweep._run_epoch

    def stop_at_second_epoch(self, epoch):
        if epoch == 1:
            raise KeyboardInterrupt
        run_epoch(self, epoch)

    monkeypatch.setattr(tsweep.VectorizedSeedSweep, "_run_epoch", stop_at_second_epoch)
    args = [_args(corpus, meta, tmp_path / "cut", seed=s, resume=True, **kw) for s in SEEDS]
    with pytest.raises(KeyboardInterrupt):
        run_experiment_vectorized(args, seed_axis=seed_axis)
    monkeypatch.setattr(tsweep.VectorizedSeedSweep, "_run_epoch", run_epoch)
    resumed = run_experiment_vectorized(args, seed_axis=seed_axis)
    assert "sweep resume: restored 3 seed snapshots (1 completed epoch(s))" in (
        capsys.readouterr().out)
    for sh, want in zip(resumed, whole):
        assert [row[:2] for row in sh.loss_list] == [[3, 1], [4, 1]]
        assert sh.loss_list == want.loss_list[2:]
        assert sh.test_results == want.test_results
        _assert_blobs_equal(torch.load(sh.state_path, weights_only=True),
                            torch.load(want.state_path, weights_only=True))


def test_guards_and_serial_fallback(corpus, meta, tmp_path, capsys):
    """The sweep refuses ``device_data``, ``fsdp``, ``pp_stages`` and
    mismatched loaders; ``main`` runs a refused group serially and goes on."""
    model = DCNN(time_dim=12, fused_layer1=True, **WIDTHS)

    def shadow(**extra):
        return types.SimpleNamespace(model=model, transform=None, device=torch.device("cpu"),
                                     args=DotDict(_args(corpus, meta, tmp_path, **extra)))

    for extra, match in ((dict(fsdp=True), "fsdp"), (dict(pp_stages=2), "pp_stages"),
                         (dict(device_data=True), "device_data")):
        with pytest.raises(ValueError, match=match):
            tsweep.VectorizedSeedSweep([shadow(**extra)], [None])
    with pytest.raises(ValueError, match="one train loader"):
        tsweep.VectorizedSeedSweep([shadow()], [])
    with pytest.raises(ValueError, match="at least one seed"):
        tsweep.VectorizedSeedSweep([], [])

    _main(_grid(tmp_path, corpus, meta), corpus, tmp_path / "log", [0, 1],
          "--vmap-seeds", "--device-data", "--epochs", "1")
    out = capsys.readouterr().out
    assert "group not vectorizable (vmap_seeds streams per-seed batch orders" in out
    assert out.count("resident training data: 22 frames") == 2
    assert "Best config:" in out


def test_slice_init_equals_run_experiment(corpus, meta, tmp_path):
    """Slice i's initial weights are ``run_experiment``'s for ``seeds[i]``,
    bit for bit."""
    built = {}
    for s in SEEDS:
        trainer = run_experiment(_args(corpus, meta, tmp_path / "log", seed=s, epochs=0))
        built[s] = (trainer.model.state_dict(), trainer.args)
    args = built[SEEDS[0]][1]
    vstate = tvec.create_vectorized_state(
        lambda: get_model(args, "modules"), SEEDS, 4e-4, 1e-3, device="cpu", seed_axis="scan")
    for i, s in enumerate(SEEDS):
        _assert_blobs_equal(vstate.models[i].state_dict(), built[s][0], f"seed {s}")


def test_sweep_on_cuda_without_a_card_raises(corpus, meta, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="is_available"):
        run_experiment_vectorized(
            [_args(corpus, meta, tmp_path, seed=s, device="cuda") for s in (0, 1)])
