"""The port's numpy-side modules vs the JAX package's, on the same inputs.

``utils/config.py`` (Griderator), ``data/dataset.py``, ``data/loader.py``,
``train/metrics.py`` and ``train/results.py`` are numpy-only in the JAX
package; the port keeps its own copies (it imports nothing of that
package), and these tests hold the copies to the originals: same grid
points, same index tables and splits, byte-equal batches, same metrics,
same printed tables.
"""

import os
import wave

import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.data import dataset as jdataset
from audiodeepfake_detection_tpu.data import loader as jloader
from audiodeepfake_detection_tpu.train import metrics as jmetrics
from audiodeepfake_detection_tpu.train import results as jresults
from audiodeepfake_detection_tpu.utils import config as jconfig
from audiodeepfake_detection_tpu_torch.data import dataset as tdataset
from audiodeepfake_detection_tpu_torch.data import loader as tloader
from audiodeepfake_detection_tpu_torch.train import metrics as tmetrics
from audiodeepfake_detection_tpu_torch.train import results as tresults
from audiodeepfake_detection_tpu_torch.utils import config as tconfig

SR = 22050


def _write_wav(path, samples, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(samples * 32767, -32768, 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three labelled directories; one holds 44.1 kHz files (resampled by
    the loader), one is a second fake generator."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    for dirname, rate, n_files in (
        ("A_ljspeech", SR, 4), ("B_melgan", 2 * SR, 3), ("C_fbmelgan", SR, 4),
    ):
        (root / dirname).mkdir()
        for i in range(n_files):
            _write_wav(root / dirname / f"clip{i}.wav", 0.3 * rng.randn(5 * rate + 100 * i), rate)
    return root


def _datasets(corpus, tmp_path_factory, ds_type, **kw):
    out = []
    for mod in (jdataset, tdataset):
        out.append(mod.get_custom_dataset(
            data_path=str(corpus), ds_type=ds_type,
            save_path=str(tmp_path_factory.mktemp("meta")),
            resample_rate=SR, seconds=1, limit=100, **kw,
        ))
    return out


# ------------------------------------------------------------------- config


def test_default_config_has_the_same_keys_plus_device():
    want, got = jconfig.default_config(), tconfig.default_config()
    assert got.pop("device") == "cuda"
    assert got == want
    assert got.missing_key is None


@pytest.mark.parametrize("seeds", [[0, 1, 2], [7]])
def test_griderator_visits_the_same_points(seeds):
    config = {"wavelet": ["sym5", "haar", "db4"], "learning_rate": [1e-4, 4e-4],
              "cross_sources": [["melgan"], ["pwg", "waveglow"]]}
    grids = [mod.build_new_grid(config, seeds=seeds) for mod in (jconfig, tconfig)]
    assert grids[0].get_len() == grids[1].get_len() == len(seeds) * 12
    assert grids[0].grid_values == grids[1].grid_values
    args = [jconfig.default_config(), tconfig.default_config()]
    for _ in range(grids[0].get_len()):
        outs = [g.update_step(a) for g, a in zip(grids, args)]
        assert outs[0][1] == outs[1][1]  # next point, or the StopIteration class
        for key in ("seed", *config):
            assert outs[0][0][key] == outs[1][0][key]
    assert outs[1][1] is StopIteration


def test_load_grid_config_py_and_json(tmp_path):
    (tmp_path / "grid.py").write_text("def get_config():\n    return {'wavelet': ['sym5']}\n")
    (tmp_path / "grid.json").write_text('{"wavelet": ["haar"]}')
    assert tconfig.load_grid_config(str(tmp_path / "grid.py")) == {"wavelet": ["sym5"]}
    assert tconfig.load_grid_config(str(tmp_path / "grid.json")) == {"wavelet": ["haar"]}
    (tmp_path / "bad.py").write_text("x = 1\n")
    with pytest.raises(RuntimeError, match="get_config"):
        tconfig.load_grid_config(str(tmp_path / "bad.py"))


# ---------------------------------------------------------- dataset, loader


@pytest.mark.parametrize("ds_type", ["train", "val", "test"])
def test_dataset_index_labels_and_splits_equal(corpus, tmp_path_factory, ds_type):
    want, got = _datasets(corpus, tmp_path_factory, ds_type)
    assert len(got) == len(want) > 0
    assert got.label_names == want.label_names == {0: "ljspeech", 1: "melgan", 2: "fbmelgan"}
    assert got.audio_data.tolist() == want.audio_data.tolist()
    assert sorted(os.listdir(got.save_path)) == sorted(os.listdir(want.save_path))


def test_dataset_only_use_and_only_test_folders(corpus, tmp_path_factory):
    want, got = _datasets(
        corpus, tmp_path_factory, "test",
        only_use=["ljspeech", "melgan"], only_test_folders=["melgan"],
    )
    assert got.audio_data.tolist() == want.audio_data.tolist()
    assert {int(r[3]) for r in got.audio_data} == {0, 1}
    with pytest.raises(RuntimeError, match="No real training data"):
        tdataset.get_custom_dataset(
            data_path=str(corpus), ds_type="train", only_use=["melgan"],
            save_path=str(tmp_path_factory.mktemp("meta")),
        )


@pytest.mark.parametrize(
    "kw",
    [dict(shuffle=True, drop_last=True, seed=3),
     dict(include_index=True),
     dict(emit="int16"),
     dict(process_index=1, process_count=2, prefetch=0)],
    ids=["train-shuffled", "eval-indexed", "int16", "second-of-two-processes"],
)
def test_frame_loader_batches_equal_byte_for_byte(corpus, tmp_path_factory, kw):
    jds, tds = _datasets(corpus, tmp_path_factory, "train" if kw.get("shuffle") else "test")
    want = jloader.FrameLoader(jds, 5, **kw)
    got = tloader.FrameLoader(tds, 5, **kw)
    assert len(got) == len(want)
    for epoch in (0, 1):
        wb, gb = list(want.epoch(epoch)), list(got.epoch(epoch))
        assert len(gb) == len(wb) > 0
        for w, g in zip(wb, gb):
            assert set(g) == set(w)
            for key in w:
                assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
                assert g[key].tobytes() == w[key].tobytes(), key
    if not kw.get("drop_last"):
        assert gb[-1]["weight"].min() == 0.0  # padded tail of the last batch


def test_frame_cache_names_its_slice(corpus, tmp_path_factory):
    _, tds = _datasets(corpus, tmp_path_factory, "val")
    with pytest.raises(NotImplementedError, match="slice 8"):
        tloader.FrameLoader(tds, 4, use_frame_cache=True)
    with pytest.raises(ValueError, match="emit"):
        tloader.FrameLoader(tds, 4, emit="float64")


def test_device_prefetch_keeps_order_and_values(corpus, tmp_path_factory):
    _, tds = _datasets(corpus, tmp_path_factory, "test")
    loader = tloader.FrameLoader(tds, 5, include_index=True)
    host = list(loader.epoch(0))
    pairs = list(tloader.device_prefetch(iter(host), torch.device("cpu"), depth=2))
    assert len(pairs) == len(host)
    for want, (batch, device_batch) in zip(host, pairs):
        assert batch is want
        for key, val in want.items():
            assert device_batch[key].device.type == "cpu"
            np.testing.assert_array_equal(device_batch[key].numpy(), val)
    assert list(tloader.device_prefetch(iter([]), torch.device("cpu"))) == []


# ------------------------------------------------------------------ metrics


def test_metrics_equal_on_the_same_arrays():
    rng = np.random.RandomState(1)
    y = rng.randint(0, 2, 500)
    scores = np.clip(0.3 * y + 0.6 * rng.rand(500), 0, 1)
    pred = (scores > 0.5).astype(int)
    # the port draws its ROC curve in numpy, the JAX package through
    # scikit-learn (which drops collinear points): the same curve, and the
    # same root to brentq's tolerance
    ties = np.round(scores, 1)
    for s in (scores, pred, ties):
        assert tmetrics.calculate_eer(y, s) == pytest.approx(jmetrics.calculate_eer(y, s), abs=1e-10)
        assert tmetrics.safe_eer(y, s) == pytest.approx(jmetrics.safe_eer(y, s), abs=1e-10)
    assert tmetrics.calculate_eer(np.array([0, 0, 1, 1]), np.array([0.1, 0.2, 0.8, 0.9])) == (
        pytest.approx(0.0, abs=1e-9))
    assert np.isnan(tmetrics.safe_eer(np.ones(8, int), rng.rand(8)))
    ok = rng.randint(0, 20, 32)
    tot = ok + rng.randint(0, 5, 32) * (rng.rand(32) > 0.3)
    want, got = jmetrics.dense_counts_to_dicts(ok, tot), tmetrics.dense_counts_to_dicts(ok, tot)
    assert got == want
    for key in want[1]:
        assert tmetrics.calculate_acc_label([got[1]], [got[0]], key) == (
            jmetrics.calculate_acc_label([want[1]], [want[0]], key))
    names = {k: f"gen{k}" for k in want[1]}
    assert tmetrics.calculate_acc_dict(names, sorted(want[1]), [got[0]], [got[1]]) == (
        jmetrics.calculate_acc_dict(names, sorted(want[1]), [want[0]], [want[1]]))
    with pytest.raises(KeyError):
        tmetrics.calculate_acc_label([{1: 1}, {2: 1}], [{1: [False], 2: []}], key=2)


# ------------------------------------------------------------------ results


def test_print_results_emits_the_same_tables(tmp_path, capsys):
    rng = np.random.RandomState(2)
    config = {"wavelet": ["sym5", "haar"], "cross_sources": [["melgan"], ["pwg"]]}
    exp_results = {seed: [tuple(rng.rand(4)) for _ in range(4)] for seed in (0, 1, 2)}
    outs = []
    for cfg_mod, res_mod, sub in ((jconfig, jresults, "j"), (tconfig, tresults, "t")):
        args = cfg_mod.default_config()
        os.makedirs(tmp_path / sub)
        args.update(transform="packets", enable_gs=True, log_dir=str(tmp_path / sub))
        grid = cfg_mod.build_new_grid(config, seeds=[0, 1, 2])
        best = res_mod.print_results(args, exp_results, grid, "models/m")
        outs.append((best, capsys.readouterr().out,
                     np.load(tmp_path / sub / "m_sym5,haar_results.npy")))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1] and "Best unknown eer" in outs[1][1]
    np.testing.assert_array_equal(outs[0][2], outs[1][2])
    res = rng.rand(12, 3)
    assert tresults.print_paper_tables(res, 1 - res) == jresults.print_paper_tables(res, 1 - res)
