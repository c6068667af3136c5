"""The port's training entry point end to end on the CPU.

A tiny wav corpus (tones against noise) goes through ``run_experiment``:
native decode, frame index, wavelet-packet transform with computed
normalization, full-width DCNN with the fused first block, Adam, validation,
testing, snapshot.  The snapshot is then resumed, and loaded by the port's
serving path and by the JAX package's ``import_dcnn``.
"""

import os
import pickle
import shutil
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.models.torch_import import import_dcnn as jax_import_dcnn
from audiodeepfake_detection_tpu.train import predict as jax_predict
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.factory import (
    check_dimensions,
    compute_parameter_total,
    get_model,
)
from audiodeepfake_detection_tpu_torch.train import predict
from audiodeepfake_detection_tpu_torch.train.experiment import (
    add_default_parser_args,
    main,
    run_experiment,
)
from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

SR = 22050


def _write_wav(path, samples, sr=SR):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(samples * 32767, -32768, 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """How PyTorch splits an fp32 sum between its CPU threads is not fixed
    from run to run on a busy host (a first-step loss read 1.6e-7 apart),
    and Adam grows that to 1e-3 within three steps.  On one thread a
    trajectory repeats bit for bit, which the resume test relies on."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _args(corpus, log_dir, meta, **extra):
    a = default_config()
    a.update(
        data_path=str(corpus), save_path=str(meta),
        data_prefix=str(corpus) + "/fake_22050_22050_0.7_fbmelgan",
        log_dir=str(log_dir), transform="packets", wavelet="haar",
        num_of_scales=256, log_scale=True, batch_size=8, epochs=2,
        learning_rate=4e-4, weight_decay=1e-3, model="modules", module="DCNN",
        flattend_size=320, time_dim_add=1, calc_normalization=True,
        only_use=["real", "fbmelgan"], limit_train=(100, 100, 100),
        fused_layer1=True, seed=0, device="cpu",
    )
    a.update(extra)
    return a


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """Two epochs at full DCNN width: 22 train frames // batch 8 = 2 steps
    per epoch."""
    args = _args(corpus, tmp_path_factory.mktemp("log"), tmp_path_factory.mktemp("meta"))
    return run_experiment(args), args


def test_two_epochs_train_validate_test_and_snapshot(trained):
    trainer, args = trained
    assert [row[:2] for row in trainer.loss_list] == [[1, 0], [2, 0], [3, 1], [4, 1]]
    assert all(np.isfinite(row[2]) for row in trainer.loss_list)
    assert len(trainer.accuracy_list) == 4
    assert [row[0] for row in trainer.validation_list] == [
        "val known", "val known", "test known"]
    acc, eer, cross_acc, cross_eer = trainer.test_results
    assert 0.0 <= acc <= 1.0 and 0.0 <= eer <= 1.0 and cross_acc == cross_eer == 0.0
    assert trainer.model.fused_layer1 is True and trainer.device.type == "cpu"
    assert int(trainer.model.cnn[3].num_batches_tracked) == 4
    blob = torch.load(trainer.snapshot_path, weights_only=True)
    assert set(blob) == {"MODEL_STATE", "EPOCHS_RUN"} and blob["EPOCHS_RUN"] == 1
    assert set(blob["MODEL_STATE"]) == set(trainer.model.state_dict())
    assert os.path.exists(trainer.state_path)
    assert any(f.endswith("_mean_std.pkl") for f in os.listdir(args.log_dir + "/norms"))
    with open(trainer.snapshot_path + ".norm.pkl", "rb") as fh:
        mean, std = pickle.load(fh)
    assert np.isfinite(mean).all() and (np.asarray(std) > 0).all()


def test_resume_continues_from_the_stored_epoch(trained, corpus, tmp_path_factory):
    """A 3-epoch run interrupted after epoch 2 (the 2-epoch snapshot under
    the 3-epoch name) trains epoch 3 only, with the loss an uninterrupted
    3-epoch run shows there: weights, Adam moments, step count and the
    dropout generator's state all come back."""
    trainer, args = trained
    whole = run_experiment(_args(
        corpus, tmp_path_factory.mktemp("log3"), args.save_path, epochs=3))
    assert [row[2] for row in whole.loss_list[:4]] == [row[2] for row in trainer.loss_list]

    base = trainer.snapshot_path[: -len(".pt")]
    base3 = base.replace("_2e_", "_3e_")
    assert base3 != base
    for suffix in (".pt", ".state.pt", ".pt.norm.pkl"):
        shutil.copy(base + suffix, base3 + suffix)
    args3 = args.copy()
    args3.update(epochs=3, resume=True)
    resumed = run_experiment(args3)
    assert [row[:2] for row in resumed.loss_list] == [[5, 2], [6, 2]]
    np.testing.assert_allclose(
        [row[2] for row in resumed.loss_list],
        [row[2] for row in whole.loss_list[4:]], rtol=1e-6,
    )
    assert resumed.step_total == 6 and resumed.test_results == whole.test_results

    # --resume on a completed run trains nothing more
    again = run_experiment(args3)
    assert again.loss_list == [] and again.epochs_run == 3 and again.step_total == 6

    # weights only (.pt without its .state.pt): EPOCHS_RUN still counts
    os.remove(base3 + ".state.pt")
    only = args3.copy()
    only.update(only_testing=True)
    tested = run_experiment(only)
    assert tested.epochs_run == 3 and len(tested.test_results) == 4


def test_snapshot_loads_in_both_serving_paths_and_scores_alike(trained):
    trainer, _ = trained
    clip = (0.3 * np.tanh(np.random.RandomState(5).randn(2, 1, SR))).astype(np.float32)

    model, transform, cfg = predict.build_scorer_from_snapshot(trainer.snapshot_path)
    assert (cfg.wavelet, cfg.model_name) == ("haar", "DCNN")
    got = predict.make_score_fn(model, transform, "cpu")(torch.from_numpy(clip)).numpy()

    variables = jax_import_dcnn(trainer.snapshot_path)
    assert variables["params"]["cnn_0"]["Conv_0"]["kernel"].shape == (3, 3, 1, 64)
    jmodel, jtransform, jvars, _ = jax_predict.build_scorer_from_snapshot(
        trainer.snapshot_path)
    want = np.asarray(
        jax_predict.make_score_fn(jmodel, jtransform, jvars)(jnp.asarray(clip)))
    # P(fake) in fp32 through two frameworks from the same file
    np.testing.assert_allclose(got, want, atol=1e-5)

    # ... and equal to the trainer's own eval score of the same clip
    own = trainer.eval_step(
        {"audio": torch.from_numpy(clip), "label": torch.zeros(2, dtype=torch.int32)}
    )["scores"].numpy()
    np.testing.assert_allclose(got, own, atol=1e-6)


def test_zero_alpha_trains_on_the_fused_path(tmp_path):
    """A PReLU slope of exactly 0 (fresh or imported) keeps the fused first
    block: the port's fused backward returns the true ``dalpha`` there, so
    one train step moves the slope exactly as the unfused block moves it."""
    kw = dict(time_dim=1, ochannels1=8, ochannels2=8, ochannels3=12,
              ochannels4=16, ochannels5=4, dropout_cnn=0.0, dropout_lstm=0.0)
    args = _args("unused", tmp_path, tmp_path)
    torch.manual_seed(3)
    state = DCNN(**kw).state_dict()
    state["cnn.1.weight"] = torch.zeros(1)
    rs = np.random.RandomState(4)
    batch = {"audio": torch.from_numpy(rs.randn(8, 1, 256, 8).astype(np.float32)),
             "label": torch.from_numpy(rs.randint(0, 3, 8).astype(np.int32))}

    stepped = {}
    for fused in (True, False):
        trainer = Trainer(DCNN(**kw, fused_layer1=fused), lambda a: a, args,
                          str(tmp_path / f"snap{fused}"), device="cpu")
        trainer.load_variables(state)
        assert trainer.model.fused_layer1 is fused
        loss = trainer.train_step(batch)["loss"].item()
        stepped[fused] = (loss, trainer.model.cnn[1].weight.item(),
                          trainer.optimizer.state[trainer.model.cnn[1].weight]["exp_avg"].item())
    # Adam's first step is lr * sign(gradient): a zero dalpha would leave
    # the slope (and its first moment) at 0
    assert abs(stepped[True][1]) == pytest.approx(args.learning_rate, rel=1e-3)
    assert stepped[True][1] == pytest.approx(stepped[False][1], rel=1e-3)
    # one-pass vs centred BN moments and reordered fp32 sums: the loss
    # reads 8e-8 apart, the slope's first moment (0.1 * dalpha) 1.5e-6
    assert stepped[True][0] == pytest.approx(stepped[False][0], rel=1e-5)
    assert stepped[True][2] == pytest.approx(stepped[False][2], rel=1e-4)


@pytest.mark.parametrize(
    "flag,value,where",
    [("fsdp", True, "slice 7"), ("pp_stages", 2, "slice 7"),
     ("device_data", True, "slice 8"), ("steps_per_call", 4, "slice 8"),
     ("vmap_seeds", True, "slice 8"), ("vmap_hparams", True, "slice 8"),
     ("adam_moments_dtype", "bfloat16", "slice 5")],
)
def test_unsupported_trainer_flags_name_their_slice(tmp_path, flag, value, where):
    args = _args("unused", tmp_path, tmp_path, **{flag: value})
    model = DCNN(time_dim=1, ochannels1=8, ochannels2=8, ochannels3=12,
                 ochannels4=16, ochannels5=4)
    with pytest.raises(NotImplementedError, match=f"{flag}.*{where}|{where}"):
        Trainer(model, lambda a: a, args, str(tmp_path / "snap"), device="cpu")


@pytest.mark.parametrize(
    "extra,where",
    [(dict(only_ig=True), "slice 9"), (dict(tensorboard=True), "slice 9"),
     (dict(frame_cache=True), "slice 8"), (dict(dtype="bfloat16"), "slice 5"),
     (dict(fused_pool=True), "queue 2"), (dict(model="lcnn"), "slice 4"),
     (dict(module="AST"), "slice 5"), (dict(transform="stft"), "slice 3")],
)
def test_unsupported_experiment_flags_name_their_slice(corpus, tmp_path, extra, where):
    with pytest.raises(NotImplementedError, match=where):
        run_experiment(_args(corpus, tmp_path / "log", tmp_path / "meta", **extra))


def test_missing_cuda_raises_unless_cpu_asked(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_experiment(_args(corpus, tmp_path / "log", tmp_path / "meta", device="cuda"))
    import argparse

    parsed = add_default_parser_args(argparse.ArgumentParser()).parse_args([])
    assert parsed.device == "cuda" and parsed.fused_layer1 is None


def test_factory_builds_checks_and_counts():
    args = DotDict(input_dim=[8, 1, 256, 95], module="DCNNxDropout", fused_layer1="train",
                   flattend_size=320, time_dim_add=1)
    model = get_model(args, "modules")
    assert model.get_name() == "DCNNxDropout" and model.fused_layer1 is True
    assert compute_parameter_total(model) == sum(p.numel() for p in model.parameters())
    assert check_dimensions(model, (1, 256, 95), verbose=False)
    assert not check_dimensions(model, (1, 256, 40), verbose=False)
    assert model.training  # the check restores the mode
    with pytest.raises(RuntimeError, match="Model not valid"):
        get_model(DotDict(input_dim=[8, 1, 256, 95], module="DCNN", time_dim_add=1,
                          flattend_size=7), "modules")
    with pytest.raises(RuntimeError, match="does not exist"):
        get_model(args, "nonsense")


def test_cli_grid_search_runs_every_point(corpus, tmp_path, capsys):
    """``main`` with ``--enable-gs``: two seeds x two learning rates, one
    epoch each; the grid config also carries the data paths and the narrow
    widths (every key of a grid point lands in the experiment's args)."""
    config = tmp_path / "grid.py"
    config.write_text(
        "def get_config():\n"
        "    return {'learning_rate': [1e-4, 4e-4], 'ochannels1': [8], 'ochannels2': [8],\n"
        "            'ochannels3': [12], 'ochannels4': [16], 'ochannels5': [4],\n"
        "            'module': ['DCNN'], 'time_dim_add': [1], 'flattend_size': [320],\n"
        f"            'data_path': [{str(corpus)!r}], 'save_path': [{str(tmp_path / 'meta')!r}],\n"
        "            'only_use': [['real', 'fbmelgan']], 'limit_train': [(100, 100, 100)]}\n"
    )
    main([
        "--enable-gs", "--config", str(config), "--init-seeds", "0", "1",
        "--device", "cpu", "--epochs", "1", "--batch-size", "8", "--model", "modules",
        "--transform", "packets", "--wavelet", "haar", "--log-scale",
        "--calc-normalization", "--fused-layer1", "train",
        "--log-dir", str(tmp_path / "log"),
        "--data-prefix", str(corpus) + "/fake_22050_22050_0.7_fbmelgan",
    ])
    out = capsys.readouterr().out
    assert out.count("starting new experiments with") == 4
    assert out.count("Training done, now testing...") == 4
    assert "Best config:" in out
    snapshots = [f for f in os.listdir(tmp_path / "log" / "models") if f.endswith("e_DCNN_signsFalse_augcFalse_augnFalse_power2.0_fbmelgan_1secs_0.pt")]
    assert len(snapshots) == 2  # one per learning rate for seed 0
    results = [f for f in os.listdir(tmp_path / "log") if f.endswith("_results.npy")]
    assert len(results) == 1
    assert np.load(tmp_path / "log" / results[0]).shape == (2, 2, 4)
