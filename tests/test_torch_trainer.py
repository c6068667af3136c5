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
from audiodeepfake_detection_tpu.models.torch_import import import_lcnn as jax_import_lcnn
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
    [("fsdp", True, "slice 7"), ("pp_stages", 2, "slice 7")],
)
def test_unsupported_trainer_flags_name_their_slice(tmp_path, ast_test_size, flag, value,
                                                    where):
    """What the Trainer refuses beside ``fsdp`` and ``pp_stages`` (both
    ported, slice 7a and 7b), as the JAX Trainer does: ``fsdp`` without a
    process group is the one-device path and refuses ``pp_stages`` beside
    it; ``pp_stages > 1`` refuses a DCNN (no ``embed`` / ``classify``),
    dropout rates and ``grad_accum``, and a world it does not divide (one
    rank without a process group)."""
    from audiodeepfake_detection_tpu_torch.models.ast import ASTModel

    args = _args("unused", tmp_path, tmp_path, **{flag: value})
    model = DCNN(time_dim=1, ochannels1=8, ochannels2=8, ochannels3=12,
                 ochannels4=16, ochannels5=4)
    if flag == "fsdp":
        assert Trainer(model, lambda a: a, args, str(tmp_path / "snap"),
                       device="cpu").mesh is None
        args.pp_stages = 2
        with pytest.raises(ValueError, match="mutually exclusive"):
            Trainer(model, lambda a: a, args, str(tmp_path / "snap"), device="cpu")
        return
    refusals = [
        (model, {}, "DCNN has no embed/classify methods"),
        (ASTModel(input_fdim=64, input_tdim=48, model_size="test32", drop_path_rate=0.1), {},
         r"without dropout; set these rates to 0 or disable PP: \{'drop_path_rate': 0.1\}"),
        (ASTModel(input_fdim=64, input_tdim=48, model_size="test32"), {"grad_accum": 2},
         "grad_accum>1 and pp_stages>1 are mutually exclusive"),
        (ASTModel(input_fdim=64, input_tdim=48, model_size="test32"), {},
         "pp_stages=2 does not divide 1 devices"),
    ]
    for net, extra, match in refusals:
        with pytest.raises(ValueError, match=match):
            Trainer(net, lambda a: a, DotDict(args, **extra), str(tmp_path / "snap"),
                    device="cpu")


@pytest.mark.parametrize(
    "extra,where",
    [(dict(fsdp=True), "slice 7"), (dict(pp_stages=2), "slice 7")],
)
def test_unsupported_experiment_flags_name_their_slice(corpus, tmp_path, extra, where):
    """What ``run_experiment`` refuses beside ``fsdp`` and ``pp_stages``
    (both ported: ``tests/test_torch_parallel.py``,
    ``tests/test_torch_model_parallel.py``): ``fsdp`` beside ``pp_stages``,
    and ``pp_stages`` that does not divide the world, as JAX's
    ``data_stage_mesh`` refuses it (one rank without a process group).
    (Slice 9's ``only_ig``, ``tensorboard`` and ``block_norm`` statistics
    run: ``tests/test_torch_analysis*.py``.)"""
    if extra.get("fsdp"):
        with pytest.raises(ValueError, match="mutually exclusive"):
            run_experiment(_args(corpus, tmp_path / "log", tmp_path / "meta",
                                 pp_stages=2, **extra))
        return
    with pytest.raises(ValueError, match="pp_stages=2 does not divide 1 devices"):
        run_experiment(_args(corpus, tmp_path / "log", tmp_path / "meta", **extra))


def test_dcnn_bf16_mode_trains_through_run_experiment(corpus, tmp_path):
    """``dtype: bfloat16`` with all three fused flags (their plain versions
    on the CPU) and bf16 Adam moments: the full-width DCNN trains, keeps
    float32 parameters and buffers, and scores through ``make_score_fn`` as
    its eval step does.  The snapshot is the float32 state dict, and the
    scorer built from it runs float32, as in the JAX package."""
    extra = dict(dtype="bfloat16", adam_moments_dtype="bfloat16", fused_pool=True,
                 fused_layer2=True, epochs=1, dropout_cnn=0.0, dropout_lstm=0.0)
    trainer = run_experiment(_args(corpus, tmp_path / "log", tmp_path / "meta", **extra))
    model = trainer.model
    assert model.dtype == torch.bfloat16 and model.fused_layer1 is True
    losses = [row[2] for row in trainer.loss_list]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert all(v.dtype != torch.bfloat16 for v in model.state_dict().values())
    moments = trainer.optimizer.state[model.cnn[0].weight]
    assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.bfloat16
    clip = (0.3 * np.tanh(np.random.RandomState(5).randn(2, 1, SR))).astype(np.float32)
    own = trainer.eval_step(
        {"audio": torch.from_numpy(clip), "label": torch.zeros(2, dtype=torch.int32)}
    )["scores"].numpy()
    got = predict.make_score_fn(model, trainer.transform, "cpu")(torch.from_numpy(clip))
    np.testing.assert_array_equal(got.numpy(), own)
    scorer, transform, _ = predict.build_scorer_from_snapshot(trainer.snapshot_path)
    assert scorer.dtype is None
    fp32 = predict.make_score_fn(scorer, transform, "cpu")(torch.from_numpy(clip)).numpy()
    assert np.abs(fp32 - own).max() < 0.05  # the same weights, bf16 against float32


@pytest.mark.parametrize(
    "flags",
    [dict(fused_pool=True), dict(fused_layer2="train"),
     dict(fused_layer1=True, fused_pool="always", fused_layer2=True)],
    ids=["pool", "layer2", "all"],
)
def test_fused_mid_blocks_train_through_run_experiment(corpus, tmp_path, flags):
    """One epoch (2 steps) of the full-width DCNN with the fused mid blocks
    (their plain versions on the CPU), validation and test included; the
    snapshot loads into an unflagged model and scores like the trainer."""
    extra = dict(fused_layer1=False, epochs=1, dropout_cnn=0.0, dropout_lstm=0.0)
    extra.update(flags)
    trainer = run_experiment(_args(corpus, tmp_path / "log", tmp_path / "meta", **extra))
    model = trainer.model
    assert (bool(model.fused_pool), bool(model.fused_layer2)) == (
        "fused_pool" in flags, "fused_layer2" in flags)
    losses = [row[2] for row in trainer.loss_list]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert int(model.cnn[6].num_batches_tracked) == int(model.cnn[10].num_batches_tracked) == 2
    plain = run_experiment(_args(corpus, tmp_path / "plain", tmp_path / "meta",
                                 **{**extra, **{k: False for k in flags}}))
    # the same seed, batches and layers: one-pass against centred BatchNorm
    # moments and reordered fp32 sums, then Adam
    np.testing.assert_allclose(losses, [row[2] for row in plain.loss_list], rtol=1e-4)
    scorer, transform, _ = predict.build_scorer_from_snapshot(trainer.snapshot_path)
    assert scorer.fused_pool is False and scorer.fused_layer2 is False
    clip = (0.3 * np.tanh(np.random.RandomState(5).randn(2, 1, SR))).astype(np.float32)
    got = predict.make_score_fn(scorer, transform, "cpu")(torch.from_numpy(clip)).numpy()
    own = trainer.eval_step(
        {"audio": torch.from_numpy(clip), "label": torch.zeros(2, dtype=torch.int32)}
    )["scores"].numpy()
    np.testing.assert_allclose(got, own, atol=1e-6)


@pytest.mark.parametrize("flag", ["fused_pool", "fused_layer2"])
def test_zero_alpha_trains_on_the_fused_mid_blocks(tmp_path, flag):
    """PReLU slopes of exactly 0 behind the second and third pool keep the
    fused blocks: their backward returns the true ``dalpha`` there, so one
    train step moves each slope exactly as the unfused layers move it (the
    JAX package's kernels return 0 and its Trainer falls back instead)."""
    kw = dict(time_dim=1, ochannels1=8, ochannels2=8, ochannels3=12,
              ochannels4=16, ochannels5=4, dropout_cnn=0.0, dropout_lstm=0.0)
    args = _args("unused", tmp_path, tmp_path)
    torch.manual_seed(3)
    state = DCNN(**kw).state_dict()
    state["cnn.8.weight"] = torch.zeros(1)
    state["cnn.18.weight"] = torch.zeros(1)
    rs = np.random.RandomState(4)
    batch = {"audio": torch.from_numpy(rs.randn(8, 1, 256, 8).astype(np.float32)),
             "label": torch.from_numpy(rs.randint(0, 3, 8).astype(np.int32))}
    stepped = {}
    for fused in (True, False):
        trainer = Trainer(DCNN(**kw, **{flag: fused}), lambda a: a, args,
                          str(tmp_path / f"snap{fused}"), device="cpu")
        trainer.load_variables(state)
        assert getattr(trainer.model, flag) is fused
        loss = trainer.train_step(batch)["loss"].item()
        slopes = [trainer.model.cnn[i].weight for i in (8, 18)]
        stepped[fused] = (loss, [p.item() for p in slopes],
                          [trainer.optimizer.state[p]["exp_avg"].item() for p in slopes])
    # Adam's first step is lr * sign(gradient): a zero dalpha would leave a
    # slope (and its first moment) at 0
    for i in range(2):
        assert abs(stepped[True][1][i]) == pytest.approx(args.learning_rate, rel=1e-3)
        assert stepped[True][1][i] == pytest.approx(stepped[False][1][i], rel=1e-3)
        assert stepped[True][2][i] == pytest.approx(stepped[False][2][i], rel=1e-4)
    assert stepped[True][0] == pytest.approx(stepped[False][0], rel=1e-5)


def test_cli_fused_pool_flag_and_config_fused_layer2(corpus, tmp_path, monkeypatch):
    """``--fused-pool train`` comes from the command line, ``fused_layer2``
    from the config file (as in the JAX package); both reach the model."""
    from audiodeepfake_detection_tpu_torch.train import experiment

    trainers = []
    real = experiment.run_experiment
    monkeypatch.setattr(
        experiment, "run_experiment", lambda a: trainers.append(real(a)) or trainers[-1])
    config = tmp_path / "grid.py"
    config.write_text(
        "def get_config():\n"
        "    return {'fused_layer2': ['train'], 'ochannels1': [8], 'ochannels2': [8],\n"
        "            'ochannels3': [12], 'ochannels4': [16], 'ochannels5': [4],\n"
        "            'module': ['DCNN'], 'time_dim_add': [1], 'flattend_size': [320],\n"
        f"            'data_path': [{str(corpus)!r}], 'save_path': [{str(tmp_path / 'meta')!r}],\n"
        "            'only_use': [['real', 'fbmelgan']], 'limit_train': [(100, 100, 100)]}\n"
    )
    main([
        "--enable-gs", "--config", str(config), "--init-seeds", "0", "--device", "cpu",
        "--epochs", "1", "--batch-size", "8", "--model", "modules",
        "--transform", "packets", "--wavelet", "haar", "--log-scale",
        "--calc-normalization", "--fused-pool", "train",
        "--log-dir", str(tmp_path / "log"),
        "--data-prefix", str(corpus) + "/fake_22050_22050_0.7_fbmelgan",
    ])
    (trainer,) = trainers
    model = trainer.model
    assert (model.fused_layer1, model.fused_pool, model.fused_layer2) == (False, True, True)
    assert len(trainer.loss_list) == 2 and all(np.isfinite(r[2]) for r in trainer.loss_list)


def _lcnn_args(corpus, log_dir, meta, **extra):
    """The LCNN path: ``--model lcnn --transform stft --hop-length 220``."""
    kw = dict(model="lcnn", transform="stft", hop_length=220, wavelet="sym8",
              module=None, epochs=1, fused_layer1=True)
    kw.update(extra)
    return _args(corpus, log_dir, meta, **kw)


@pytest.fixture(scope="module")
def trained_lcnn(corpus, tmp_path_factory):
    args = _lcnn_args(corpus, tmp_path_factory.mktemp("lcnn_log"), tmp_path_factory.mktemp("lcnn_meta"))
    return run_experiment(args), args


def test_lcnn_stft_trains_validates_and_snapshots(trained_lcnn):
    trainer, args = trained_lcnn
    assert args.input_dim == [8, 1, 256, 101]
    assert trainer.model.get_name() == "LCNN" and trainer.model.fused_layer1 is True
    assert trainer.model.lstm_channels == 256
    assert [row[:2] for row in trainer.loss_list] == [[1, 0], [2, 0]]
    assert all(np.isfinite(row[2]) for row in trainer.loss_list)
    assert [row[0] for row in trainer.validation_list] == ["val known", "test known"]
    acc, eer = trainer.test_results[:2]
    assert 0.0 <= acc <= 1.0 and 0.0 <= eer <= 1.0
    # every non-"modules" model is named customModel, as in the JAX package
    assert "_stft_none_220_" in trainer.snapshot_path and "_customModel_" in trainer.snapshot_path
    blob = torch.load(trainer.snapshot_path, weights_only=True)
    assert set(blob["MODEL_STATE"]) == set(trainer.model.state_dict())
    assert "lstm.0.l_blstm.weight_ih_l0" in blob["MODEL_STATE"] and "fc.weight" in blob["MODEL_STATE"]
    assert int(trainer.model.lcnn[5].num_batches_tracked) == 2
    with pytest.raises(ValueError, match="no standalone-scoring support"):
        predict.build_scorer_from_snapshot(trainer.snapshot_path)


def test_lcnn_snapshot_scores_alike_in_both_packages_and_resumes(trained_lcnn):
    trainer, args = trained_lcnn
    # to serve it, the snapshot takes a name whose model token is LCNN
    served = trainer.snapshot_path.replace("_customModel_", "_LCNN_")
    for suffix in ("", ".norm.pkl"):
        shutil.copy(trainer.snapshot_path + suffix, served + suffix)
    clip = (0.3 * np.tanh(np.random.RandomState(5).randn(2, 1, SR))).astype(np.float32)
    model, transform, cfg = predict.build_scorer_from_snapshot(served)
    assert (cfg.transform, cfg.hop_length, cfg.model_name) == ("stft", 220, "LCNN")
    assert model.fused_layer1 is False and not model.training
    got = predict.make_score_fn(model, transform, "cpu")(torch.from_numpy(clip)).numpy()
    jmodel, jtransform, jvars, _ = jax_predict.build_scorer_from_snapshot(served)
    want = np.asarray(jax_predict.make_score_fn(jmodel, jtransform, jvars)(jnp.asarray(clip)))
    # P(fake) in fp32 through two frameworks from the same file; measured 0.0 at 7 digits
    np.testing.assert_allclose(got, want, atol=1e-5)
    own = trainer.eval_step(
        {"audio": torch.from_numpy(clip), "label": torch.zeros(2, dtype=torch.int32)}
    )["scores"].numpy()
    np.testing.assert_allclose(got, own, atol=1e-6)
    variables = jax_import_lcnn(served)
    assert variables["params"]["lcnn_0"]["Conv_0"]["kernel"].shape == (5, 5, 1, 64)

    # --resume on the completed run trains nothing more; weights only
    # (.pt without its .state.pt) go through import_lcnn
    again_args = args.copy()
    again_args.update(resume=True)
    again = run_experiment(again_args)
    assert again.loss_list == [] and again.epochs_run == 1
    os.remove(trainer.state_path)
    only = args.copy()
    only.update(only_testing=True)
    tested = run_experiment(only)
    assert tested.epochs_run == 1
    torch.testing.assert_close(
        tested.model.state_dict()["lstm.1.l_blstm.weight_hh_l0"],
        trainer.model.state_dict()["lstm.1.l_blstm.weight_hh_l0"], rtol=0, atol=0)


GRID_MODEL = [[
    {"layers": ["Conv2d 1 4 3 2 1", "MaxFeatureMap2D", "BatchNorm2d 2", "MaxPool2d 4 4",
                "Flatten 1", "Linear 768 2"]},
]]


@pytest.mark.parametrize(
    "extra,input_dim,name",
    [(dict(transform="packets", wavelet="haar"), [8, 1, 256, 87], "LCNN"),
     (dict(features="lfcc", f_min=1000.0), [8, 1, 20, 101], "LCNN"),
     (dict(model="gridmodel", model_data=GRID_MODEL, fused_layer1=False), [8, 1, 256, 101], "GridModel"),
     (dict(model="modules", module="Regression", fused_layer1=False), [8, 1, 256, 101], "Regression")],
    ids=["packets-lcnn", "stft-lfcc-lcnn", "stft-gridmodel", "stft-regression"],
)
def test_other_front_ends_and_models_train(corpus, tmp_path, extra, input_dim, name):
    trainer = run_experiment(_lcnn_args(corpus, tmp_path / "log", tmp_path / "meta", **extra))
    assert trainer.args.input_dim == input_dim and trainer.model.get_name() == name
    assert len(trainer.loss_list) == 2 and all(np.isfinite(r[2]) for r in trainer.loss_list)
    assert os.path.exists(trainer.snapshot_path)
    if extra.get("features") == "lfcc":
        assert trainer.model.lstm_channels == 20 and "_stft_lfcc_220_" in trainer.snapshot_path


def test_feature_guards(corpus, tmp_path):
    """LFCC features need the LCNN; delta features build an LCNN whose
    BLSTM width (the reference's 40 / 60 rule) does not fit the 20-row delta
    image, which raises with the numbers; stft has no sign channel."""
    with pytest.raises(NotImplementedError, match="LFCC features are currently not implemented"):
        run_experiment(_args(corpus, tmp_path / "a", tmp_path / "meta", features="lfcc"))
    for features, channels in (("delta", 40), ("doubledelta", 60)):
        with pytest.raises(ValueError, match=f"lstm_channels={channels}"):
            run_experiment(_lcnn_args(corpus, tmp_path / features, tmp_path / "meta", features=features))
    with pytest.raises(ValueError, match="Sign channel not possible"):
        run_experiment(_lcnn_args(corpus, tmp_path / "c", tmp_path / "meta", loss_less="True"))


def test_lcnn_cli_defaults_are_the_jax_package_defaults(corpus, tmp_path, capsys):
    """``main`` with no ``--model`` / ``--transform`` trains stft + LCNN."""
    import argparse

    parsed = add_default_parser_args(argparse.ArgumentParser()).parse_args([])
    assert (parsed.model, parsed.transform, parsed.features, parsed.hop_length) == (
        "lcnn", "stft", "none", 1)
    config = tmp_path / "grid.py"
    config.write_text(
        "def get_config():\n"
        f"    return {{'data_path': [{str(corpus)!r}], 'save_path': [{str(tmp_path / 'meta')!r}],\n"
        "            'only_use': [['real', 'fbmelgan']], 'limit_train': [(100, 100, 100)]}\n"
    )
    main([
        "--enable-gs", "--config", str(config), "--init-seeds", "0", "--device", "cpu",
        "--epochs", "1", "--batch-size", "8", "--hop-length", "220", "--log-scale",
        "--calc-normalization", "--fused-layer1", "train", "--log-dir", str(tmp_path / "log"),
        "--data-prefix", str(corpus) + "/fake_22050_22050_0.7_fbmelgan",
    ])
    out = capsys.readouterr().out
    assert out.count("Training done, now testing...") == 1
    (snapshot,) = [f for f in os.listdir(tmp_path / "log" / "models") if f.endswith("_0.pt")]
    assert "_stft_none_220_" in snapshot and "_customModel_" in snapshot


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
    assert model.fused_pool is False and model.fused_layer2 is False  # off by default
    flagged = get_model(DotDict(input_dim=[8, 1, 256, 95], module="DCNN", time_dim_add=1,
                                flattend_size=320, fused_pool="train", fused_layer2="always"),
                        "modules")
    assert (flagged.fused_layer1, flagged.fused_pool, flagged.fused_layer2) == (
        False, True, "always")
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


# ------------------------------------------------------------------ the AST


@pytest.fixture
def ast_test_size(monkeypatch):
    from audiodeepfake_detection_tpu_torch.models import ast

    monkeypatch.setitem(ast._SIZES, "test32", dict(embed_dim=32, depth=2, num_heads=2))


def _ast_args(corpus, tmp_path, **extra):
    """stft (n_fft 511, hop 220, log): the [B, 1, 256, 101] image of the
    AST's cells, with a test-size encoder."""
    args = dict(
        module="AST", ast_model_size="test32", ast_fused_attention=True,
        transform="stft", num_of_scales=256, hop_length=220, flattend_size=None,
        fused_layer1=False, epochs=1)
    args.update(extra)
    return _args(corpus, tmp_path / "log", tmp_path / "meta", **args)


def test_ast_trains_snapshots_and_reloads_from_the_pt(corpus, tmp_path, ast_test_size):
    """As the JAX package's end-to-end AST test: one epoch through ``run_experiment``,
    the snapshot in the trained-AST layout, and ``only_testing`` reloading
    it from the ``.pt`` alone (through ``import_timm_deit``)."""
    trainer = run_experiment(_ast_args(corpus, tmp_path))
    model = trainer.model
    assert model.get_name() == "AST" and model.fused_attention
    assert (model.input_fdim, model.input_tdim, model.num_patches) == (256, 101, 225)
    losses = [row[2] for row in trainer.loss_list]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert 0.0 <= trainer.test_results[0] <= 1.0
    assert "_AST_" in os.path.basename(trainer.snapshot_path)
    state = torch.load(trainer.snapshot_path, weights_only=True)["MODEL_STATE"]
    assert "v.patch_embed.proj.weight" in state and "mlp_head.1.weight" in state
    os.remove(trainer.state_path)
    again = run_experiment(_ast_args(corpus, tmp_path, only_testing=True))
    assert len(again.test_results) == 4
    for key, val in again.model.state_dict().items():
        assert torch.equal(val.cpu(), state[key]), key


def test_ast_bf16_mode_with_bf16_moments_resumes_bit_for_bit(corpus, tmp_path, ast_test_size):
    """``dtype: bfloat16`` and ``adam_moments_dtype: bfloat16``: the moments
    are stored in bf16, go through ``.state.pt``, and a resumed second epoch
    equals an uninterrupted one."""
    extra = dict(dtype="bfloat16", adam_moments_dtype="bfloat16", epochs=2)
    whole = run_experiment(_ast_args(corpus, tmp_path / "whole", **extra))
    assert whole.model.dtype == torch.bfloat16
    moments = whole.optimizer.state[next(whole.model.parameters())]
    assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.bfloat16
    first = run_experiment(_ast_args(corpus, tmp_path / "parts", **dict(extra, epochs=1)))
    assert [r[2] for r in first.loss_list] == [r[2] for r in whole.loss_list[:2]]
    # the snapshot name encodes --epochs: continue under the two-epoch name
    base = first.snapshot_path[: -len(".pt")]
    for suffix in (".pt", ".state.pt", ".pt.norm.pkl"):
        shutil.copy(base + suffix, base.replace("_1e_", "_2e_") + suffix)
    resumed = run_experiment(_ast_args(corpus, tmp_path / "parts", resume=True, **extra))
    assert [r[2] for r in resumed.loss_list] == [r[2] for r in whole.loss_list[2:]]
    for (name, p), q in zip(resumed.model.named_parameters(), whole.model.parameters()):
        assert torch.equal(p, q), name


def test_auto_chunk_serves_the_ast_in_divisors_of_the_batch(ast_test_size):
    """The default is the whole batch for the AST too (the fastest on the
    H100 at B = 64, 128 and 512); a chunk that divides the batch runs the
    model in microbatches of that size and scores the same."""
    from audiodeepfake_detection_tpu_torch.models.ast import ASTModel
    from audiodeepfake_detection_tpu_torch.train.serve import ScoringService

    torch.manual_seed(0)
    model = ASTModel(input_fdim=64, input_tdim=48, model_size="test32")

    def transform(audio):  # [B, 1, 3072] -> a [B, 1, 64, 48] image
        return audio.reshape(audio.shape[0], 1, 64, 48)

    svc = ScoringService(model, transform, device="cpu", sample_rate=3072, batch_size=48,
                         warmup=False)
    assert svc.chunk == 0
    calls = []
    model.register_forward_hook(lambda m, i, o: calls.append(i[0].shape[0]))
    audio = torch.from_numpy(np.random.RandomState(1).randn(48, 1, 3072).astype(np.float32))
    whole = predict.make_score_fn(model, transform, "cpu")(audio)
    assert calls == [48]
    chunked = predict.make_score_fn(model, transform, "cpu", chunk=24)(audio)
    assert calls == [48, 24, 24]
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="does not divide"):
        ScoringService(model, transform, device="cpu", batch_size=48, chunk=32, warmup=False)
