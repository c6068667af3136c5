"""Device-resident data (``device_data``, ``train/device_data.py``) and
``steps_per_call`` in the port, on the CPU.

The resident steps (G steps a call over a ``[G, B]`` index block) are held
against G single steps of the port bit for bit, and the resident train
and eval steps against the JAX package's ``make_resident_multi_train_step``
/ ``make_resident_multi_eval_step`` on the same index blocks (``-1``
sentinels included).  Through ``run_experiment``, a Trainer with
``steps_per_call = 2`` (streamed: single steps), and one with
``device_data`` as well (resident groups of 2, a shorter tail), trains and
evaluates as a streamed one, bit for bit.  The card's budget gate refuses
before any decode.
"""

import wave

import jax
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.models import DCNN as JaxDCNN
from audiodeepfake_detection_tpu.models.torch_import import import_dcnn as jax_import_dcnn
from audiodeepfake_detection_tpu.ops.wpt import packet_image as jax_packet_image
from audiodeepfake_detection_tpu.train import steps as jsteps
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.torch_import import state_dict_from_jax
from audiodeepfake_detection_tpu_torch.ops.wpt import packet_image
from audiodeepfake_detection_tpu_torch.train import device_data
from audiodeepfake_detection_tpu_torch.train import steps as tsteps
from audiodeepfake_detection_tpu_torch.train.experiment import run_experiment
from audiodeepfake_detection_tpu_torch.utils.config import default_config

SR = 22050
LR, WD = 4e-4, 1e-3
T = 2048
WIDTHS = dict(time_dim=1, ochannels1=4, ochannels2=4, ochannels3=6, ochannels4=8,
              ochannels5=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread: a resident and a streamed run repeat each other bit for
    bit (PyTorch's split of a sum between threads is not fixed)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _transform(audio):
    return packet_image(audio, "haar", level=8, log_scale=True)


def _jax_transform(audio):
    return jax_packet_image(audio, "haar", level=8, log_scale=True)


def _frames(n=24, seed=3):
    rng = np.random.RandomState(seed)
    audio = np.clip(0.3 * rng.randn(n, 1, T), -1, 1 - 2**-15)
    pcm = (audio * 32768).astype(np.int16)  # int16 frames, as a cache ships them
    return pcm, rng.randint(0, 3, n).astype(np.int32)


def _port_model(seed=0, **kw):
    torch.manual_seed(seed)
    return DCNN(**WIDTHS, with_dropout=False, **kw)


def _batch(pcm, labels, rows):
    return {"audio": torch.from_numpy(pcm[rows]), "label": torch.from_numpy(labels[rows])}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_chained_and_resident_steps_equal_single_steps(fused):
    """G = 3 resident steps chained in one call, gathering from
    ``[N, 1, T]`` int16 frames by a ``[G, B]`` index block, bit for bit
    equal to 3 single steps (augmentation on)."""
    pcm, labels = _frames()
    idx = np.random.RandomState(4).permutation(len(pcm))[:12].reshape(3, 4)
    runs = {}
    for kind in ("single", "resident"):
        model = _port_model(fused_layer1=fused)
        opt = tsteps.make_optimizer(model.parameters(), LR, WD)
        kw = dict(aug_noise=True, generator=torch.Generator().manual_seed(9))
        if kind == "single":
            step = tsteps.make_train_step(model, _transform, opt, **kw)
            losses = torch.stack([step(_batch(pcm, labels, row))["loss"] for row in idx])
        else:
            step = tsteps.make_resident_multi_train_step(model, _transform, opt, **kw)
            losses = step(torch.from_numpy(pcm), torch.from_numpy(labels),
                          torch.from_numpy(idx))["loss"]
        assert losses.shape == (3,)
        runs[kind] = (losses, model.state_dict())
    assert torch.equal(runs["resident"][0], runs["single"][0])
    for key, val in runs["single"][1].items():
        assert torch.equal(runs["resident"][1][key], val), key


def test_resident_steps_match_jax_resident_steps():
    """The resident train step (2 steps of 4 over an index block) and the
    resident eval pass (an index block padded with ``-1``) against the JAX
    package's on the same int16 frames, from the same weights."""
    pcm, labels = _frames()
    model = _port_model(seed=5)
    jmodel = JaxDCNN(**WIDTHS, with_dropout=False)
    variables = jax_import_dcnn({k: v.clone() for k, v in model.state_dict().items()})
    tx = jsteps.make_optimizer(LR, WD)
    state = jsteps.create_train_state(jmodel, tx, None, variables=variables)
    idx = np.random.RandomState(6).permutation(len(pcm))[:8].reshape(2, 4).astype(np.int32)

    jstep = jsteps.make_resident_multi_train_step(jmodel, _jax_transform, tx)
    state, jstats = jstep(state, pcm, labels, idx)
    opt = tsteps.make_optimizer(model.parameters(), LR, WD)
    stats = tsteps.make_resident_multi_train_step(model, _transform, opt)(
        torch.from_numpy(pcm), torch.from_numpy(labels), torch.from_numpy(idx))
    np.testing.assert_allclose(stats["loss"].numpy(), np.asarray(jstats["loss"]), rtol=5e-4)
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, state.params),
                                "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    for key, val in model.state_dict().items():
        got, ref = val.numpy(), want[key].numpy()
        if key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got, ref, err_msg=key)
        elif "running_" in key:
            assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref), key
        else:  # Adam's sign noise on near-zero gradients: ~2 lr per step at most
            assert np.abs(got - ref).max() <= 2 * 2 * LR, key

    # eval: 11 frames in batches of 4, the last padded with -1 sentinels
    eval_idx = np.full(12, -1, np.int32)
    eval_idx[:11] = np.arange(11)
    eval_idx = eval_idx.reshape(3, 4)
    jres = jsteps.make_resident_multi_eval_step(jmodel, _jax_transform)(
        state.params, state.batch_stats, pcm, labels, eval_idx)
    res = tsteps.make_resident_multi_eval_step(model, _transform)(
        torch.from_numpy(pcm), torch.from_numpy(labels), torch.from_numpy(eval_idx))
    assert res["scores"].shape == (3, 4)
    for key in ("count_per_label", "total", "ok_mask", "y"):
        np.testing.assert_array_equal(res[key].numpy(), np.asarray(jres[key]), err_msg=key)
    assert float(res["total"].sum()) == 11.0 and res["y"][2, 3] == (labels[0] != 0)
    np.testing.assert_allclose(res["scores"].numpy(), np.asarray(jres["scores"]), atol=2e-3)


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


def _args(corpus, log_dir, meta, **extra):
    """Narrow DCNN with the fused first block and dropout on; batch 4: 22
    training frames are 5 steps an epoch (two groups of 2 and a tail)."""
    a = default_config()
    a.update(
        data_path=str(corpus), save_path=str(meta),
        data_prefix=str(corpus) + "/fake_22050_22050_0.7_fbmelgan",
        log_dir=str(log_dir), transform="packets", wavelet="haar",
        num_of_scales=256, log_scale=True, batch_size=4, epochs=2,
        learning_rate=4e-4, weight_decay=1e-3, model="modules", module="DCNN",
        ochannels1=8, ochannels2=8, ochannels3=12, ochannels4=16, ochannels5=4,
        flattend_size=320, time_dim_add=1, calc_normalization=True,
        only_use=["real", "fbmelgan"], limit_train=(100, 100, 100),
        fused_layer1=True, aug_noise=True, seed=3, device="cpu",
    )
    a.update(extra)
    return a


@pytest.fixture(scope="module")
def streamed(corpus, tmp_path_factory):
    meta = tmp_path_factory.mktemp("meta")
    return run_experiment(_args(corpus, tmp_path_factory.mktemp("log"), meta)), meta


@pytest.mark.parametrize("extra", [dict(steps_per_call=2),
                                   dict(device_data=True, steps_per_call=2),
                                   dict(frame_cache=True, device_data=True, steps_per_call=2)],
                         ids=["chained", "resident-chained", "frame-cache-resident-chained"])
def test_trainer_equals_streamed_run_bit_for_bit(streamed, corpus, tmp_path, extra, capsys):
    """``steps_per_call = 2`` on streamed batches (single steps), and with
    the frames parked on the device (resident groups of 2 and a shorter
    tail), also from the int16 frame cache (16-bit sources survive it
    exactly): the same losses, validation and test metrics and snapshot as
    the streamed run, bit for bit."""
    want, meta = streamed
    got = run_experiment(_args(corpus, tmp_path / "log", meta, **extra))
    assert [row[:2] for row in got.loss_list] == [[s, (s - 1) // 5] for s in range(1, 11)]
    assert got.loss_list == want.loss_list
    assert got.accuracy_list == want.accuracy_list
    assert got.validation_list == want.validation_list
    assert got.test_results == want.test_results
    a = torch.load(got.snapshot_path, weights_only=True)["MODEL_STATE"]
    b = torch.load(want.snapshot_path, weights_only=True)["MODEL_STATE"]
    assert all(torch.equal(a[k], b[k]) for k in b)
    out = capsys.readouterr().out
    if extra.get("device_data"):
        assert "resident training data: 22 frames" in out
        assert got._resident.audio.shape == (22, 1, SR)
        want_type = torch.int16 if extra.get("frame_cache") else torch.float32
        assert got._resident.audio.dtype == want_type
        assert len(got._resident_eval_cache) == 2  # val and test, parked once each
    else:
        assert got._resident is None


def test_resident_eval_over_budget_streams(streamed, corpus, tmp_path, monkeypatch, capsys):
    """An eval set over the cumulative budget streams instead, with a note;
    the results do not change."""
    want, meta = streamed

    def gate(nbytes, device):  # room for the training set only
        if nbytes > 22 * SR * 4:
            raise ValueError("over budget")

    monkeypatch.setattr(device_data, "check_budget", gate)
    got = run_experiment(_args(corpus, tmp_path / "log", meta, device_data=True))
    assert "resident eval set skipped, streaming instead: over budget" in capsys.readouterr().out
    assert got.validation_list == want.validation_list
    assert got.loss_list == want.loss_list


def test_budget_gate_refuses_before_any_decode(monkeypatch):
    """Over 60 % of the card's memory (``mem_get_info`` patched: an 80 GB
    card) is refused before a frame is decoded or a byte allocated; on the
    CPU there is no gate, and ``device_data`` needs a drop_last loader."""

    class Loader:
        dataset = range(55_504)  # the LJSpeech train split at 1 s frames
        target_len = SR
        emit = "float32"

        def _make_batch(self, *a, **k):
            raise AssertionError("decoded before the budget gate")

    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (79 << 30, 80 << 30))
    with pytest.raises(ValueError, match="exceeds 60% of device memory"):
        device_data.ResidentData(Loader(), "cuda", reserved_bytes=44 << 30)
    device_data.check_budget(2_447_726_400, torch.device("cuda"))  # the int16 split: 2.45 GB
    device_data.check_budget(10**15, torch.device("cpu"))


def test_device_data_needs_drop_last(streamed, corpus, tmp_path):
    want, meta = streamed
    trainer = run_experiment(_args(corpus, tmp_path / "log", meta, epochs=0, device_data=True))
    trainer.train_loader.drop_last = False
    with pytest.raises(ValueError, match="drop_last"):
        trainer.train(1)


def test_resident_run_on_cuda_without_a_card_raises(corpus, tmp_path):
    """No CPU fallback: asked for the card where there is none, a resident
    run raises, and so does parking frames on it."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")

    class Loader:
        dataset = range(4)
        target_len = 8
        emit = "int16"

        def _make_batch(self, *a, **k):
            raise AssertionError("decoded without a card")

    with pytest.raises(RuntimeError, match="is_available"):
        run_experiment(_args(corpus, tmp_path / "log", tmp_path / "meta", device="cuda",
                             device_data=True, steps_per_call=2))
    with pytest.raises((RuntimeError, AssertionError)):
        device_data.ResidentData(Loader(), "cuda")
