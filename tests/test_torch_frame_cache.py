"""The port's frame cache (``data/frame_cache.py``), its cached loader and
``data/prepare.py``, against the JAX package's.

A cache built by either package is found by the other at the same path and
read byte for byte; the port's cached loader yields the JAX cached loader's
batches byte for byte (float32 and int16 emit, padded tails, indices) and
the decoding loader's audio exactly (16-bit sources); a warm cache is read
inline, with no prefetch thread.  ``prepare_ljspeech`` writes the JAX
package's index files.
"""

import os
import threading
import wave

import numpy as np
import pytest

from audiodeepfake_detection_tpu.data import dataset as jdataset
from audiodeepfake_detection_tpu.data import frame_cache as jcache
from audiodeepfake_detection_tpu.data import loader as jloader
from audiodeepfake_detection_tpu.data import prepare as jprepare
from audiodeepfake_detection_tpu_torch.data import dataset as tdataset
from audiodeepfake_detection_tpu_torch.data import frame_cache as tcache
from audiodeepfake_detection_tpu_torch.data import loader as tloader
from audiodeepfake_detection_tpu_torch.data import prepare as tprepare

SR = 4000


def _write_wav(path, samples, sr=SR):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(samples * 32767, -32768, 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two labelled directories of 16-bit clips, one at twice the rate
    (resampled by the loader, so its cached frames are quantized)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    for dirname, rate in (("A_ljspeech", SR), ("B_fbmelgan", 2 * SR)):
        (root / dirname).mkdir()
        for i in range(3):
            _write_wav(root / dirname / f"clip{i}.wav", 0.3 * rng.randn(5 * rate + 50 * i), rate)
    return root


def _pair(corpus, meta, ds_type="test"):
    """The JAX and the port dataset of one index, in one ``save_path``."""
    return [mod.get_custom_dataset(data_path=str(corpus), ds_type=ds_type,
                                   save_path=str(meta), resample_rate=SR, seconds=1, limit=100)
            for mod in (jdataset, tdataset)]


@pytest.mark.parametrize("built_by", ["jax", "port"])
def test_cache_built_by_one_package_serves_the_other(corpus, tmp_path, built_by):
    jds, tds = _pair(corpus, tmp_path)
    assert tcache.frame_cache_path(tds) == jcache.frame_cache_path(jds)
    build, other = (jcache, tcache) if built_by == "jax" else (tcache, jcache)
    path = build.build_frame_cache(jds if built_by == "jax" else tds, num_threads=2,
                                   batch_size=4)
    opened = other.open_frame_cache(tds if built_by == "jax" else jds)
    assert opened is not None and opened.dtype == np.int16
    assert opened.shape == (len(tds), SR)
    # the other package's build finds it and leaves it as it is
    before = os.path.getmtime(path)
    assert other.build_frame_cache(tds if built_by == "jax" else jds) == path
    assert os.path.getmtime(path) == before
    # byte for byte what the other package would have written
    again = tmp_path / "again"
    again.mkdir()
    jds2, tds2 = _pair(corpus, again)
    rebuilt = other.build_frame_cache(tds2 if built_by == "jax" else jds2, num_threads=2)
    assert open(rebuilt, "rb").read() == open(path, "rb").read()


@pytest.mark.parametrize("emit", ["float32", "int16"])
@pytest.mark.parametrize("drop_last", [False, True])
def test_cached_loader_batches_equal_the_jax_cached_loader(corpus, tmp_path, emit, drop_last):
    jds, tds = _pair(corpus, tmp_path, "train")
    kw = dict(shuffle=True, drop_last=drop_last, seed=5, include_index=True, emit=emit)
    want = jloader.FrameLoader(jds, 6, use_frame_cache=True, **kw)
    got = tloader.FrameLoader(tds, 6, use_frame_cache=True, **kw)  # 20 frames
    assert got._frame_cache is not None
    assert len(got) == len(want)
    for epoch in (0, 1):
        wb, gb = list(want.epoch(epoch)), list(got.epoch(epoch))
        assert len(gb) == len(wb) > 0
        for w, g in zip(wb, gb):
            assert set(g) == set(w)
            for key in w:
                assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
                assert g[key].tobytes() == w[key].tobytes(), key
    if not drop_last:
        assert gb[-1]["weight"].min() == 0.0  # the padded tail of the last batch


def test_cached_loader_reads_inline_and_matches_decoding(corpus, tmp_path, monkeypatch):
    """``None`` uses a cache that exists (``False`` never does); a warm cache
    starts no prefetch thread; 16-bit frames come back exactly as decoded."""
    _, tds = _pair(corpus, tmp_path)
    decoded = tloader.FrameLoader(tds, 4, use_frame_cache=None)
    assert decoded._frame_cache is None  # nothing built yet
    raw = list(decoded.epoch(0))
    tcache.build_frame_cache(tds, num_threads=2)
    cached = tloader.FrameLoader(tds, 4, use_frame_cache=None)
    assert cached._frame_cache is not None
    assert tloader.FrameLoader(tds, 4, use_frame_cache=False)._frame_cache is None

    def no_thread(*a, **k):
        raise AssertionError("a warm cache needs no prefetch thread")

    monkeypatch.setattr(threading, "Thread", no_thread)
    got = list(cached.epoch(0))
    assert len(got) == len(raw)
    rates = {round(int(r[2]) / tds.seconds) for r in tds.audio_data}
    assert rates == {SR, 2 * SR}
    for g, r in zip(got, raw):
        np.testing.assert_array_equal(g["label"], r["label"])
        np.testing.assert_array_equal(g["weight"], r["weight"])
        # 16-bit sources exactly; resampled ones quantized to int16 steps
        np.testing.assert_allclose(g["audio"], r["audio"], rtol=0, atol=2.0 ** -15)
    native = [i for i, row in enumerate(tds.audio_data) if int(row[2]) == SR]
    flat_got = np.concatenate([g["audio"][g["weight"] > 0] for g in got])
    flat_raw = np.concatenate([r["audio"][r["weight"] > 0] for r in raw])
    np.testing.assert_array_equal(flat_got[native], flat_raw[native])


def test_stale_cache_and_bad_emit_are_refused(corpus, tmp_path):
    _, tds = _pair(corpus, tmp_path)
    path = tcache.frame_cache_path(tds)
    np.save(path, np.zeros((len(tds) + 1, SR), np.int16))  # a cache of another index
    assert tcache.open_frame_cache(tds) is None
    assert tcache.build_frame_cache(tds) == path  # rebuilt over it
    assert tcache.open_frame_cache(tds).shape == (len(tds), SR)
    assert tcache.rank_and_world() == (0, 1)  # no process group: this process builds
    with pytest.raises(ValueError, match="emit"):
        tloader.FrameLoader(tds, 4, emit="float64")


def test_prepare_ljspeech_writes_the_jax_index_files(tmp_path):
    """Both packages' ``prepare_ljspeech`` on one corpus (a generator and
    two cross-test folders): the same index files, byte for byte."""
    data = tmp_path / "fake"
    rng = np.random.RandomState(1)
    for dirname in ("A_ljspeech", "B_fbmelgan", "C_conformer", "D_jsutpwg"):
        (data / dirname).mkdir(parents=True)
        for i in range(2):
            _write_wav(data / dirname / f"clip{i}.wav", 0.3 * rng.randn(4 * SR), SR)
    outs = {}
    for name, mod in (("jax", jprepare), ("port", tprepare)):
        out = tmp_path / name
        mod.prepare_ljspeech(
            str(data), str(out), limit_train=(10, 4, 4), cross_limit=(10, 4, 4),
            only_test_folders=("conformer", "jsutpwg"),
            cross_sources=("ljspeech", "conformer", "jsutpwg"), resample_rate=SR)
        outs[name] = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
    assert outs["port"].keys() == outs["jax"].keys() and len(outs["jax"]) >= 5
    for f, blob in outs["jax"].items():
        assert outs["port"][f] == blob, f
    tprepare.main(["ljspeech", "--data-path", str(data), "--save-path",
                   str(tmp_path / "jax"), "--sample-rate", str(SR)])
