"""Port LFCC / delta features and the transform factory vs the JAX package
(CPU): the same numpy arrays through both.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.train import transforms as jtransforms
from audiodeepfake_detection_tpu.utils.config import default_config as jax_default_config
from audiodeepfake_detection_tpu_torch.ops import lfcc as tlfcc
from audiodeepfake_detection_tpu_torch.train import transforms as ttransforms
from audiodeepfake_detection_tpu_torch.utils.config import default_config

# the JAX ops package exports the function ``lfcc`` over its module's name
jlfcc = importlib.import_module("audiodeepfake_detection_tpu.ops.lfcc")
SR = 22050


def test_filterbank_and_dct_equal_jax():
    for args in ((256, 1000.0, 11025.0, 20, SR), (150, 0.0, 11025.0, 20, SR), (64, 0.0, 8000.0, 12, 16000)):
        np.testing.assert_array_equal(tlfcc.linear_fbanks(*args), jlfcc.linear_fbanks(*args))
    for args in ((20, 20, "ortho"), (12, 20, "ortho"), (20, 20, None)):
        np.testing.assert_array_equal(tlfcc.create_dct(*args), jlfcc.create_dct(*args))
    with pytest.raises(ValueError, match="ortho"):
        tlfcc.create_dct(4, 4, "other")


def test_amplitude_to_db_matches_jax():
    x = np.abs(np.random.RandomState(0).randn(3, 1, 20, 40)).astype(np.float32) ** 6
    x[0, 0, 0, 0] = 0.0  # clamped at amin, then at peak - top_db
    got = tlfcc.amplitude_to_db(torch.from_numpy(x)).numpy()
    want = np.asarray(jlfcc.amplitude_to_db(jnp.asarray(x)))
    # 10 * log10 in two libraries
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert got.min() >= got.reshape(3, -1).max(1).min() - 80.0 - 1e-4


@pytest.mark.parametrize("log_lf", [True, False])
@pytest.mark.parametrize("shape,scales", [((2, 1, 256, 101), 256), ((3, 64, 30), 64)])
def test_lfcc_matches_jax(shape, scales, log_lf):
    spec = (np.random.RandomState(1).randn(*shape).astype(np.float32) ** 2) * 50.0
    kw = dict(sample_rate=SR, f_min=1000.0, f_max=11025.0, num_of_scales=scales, log_lf=log_lf)
    want = np.asarray(jlfcc.lfcc(jnp.asarray(spec), **kw))
    got = tlfcc.lfcc(torch.from_numpy(spec), **kw)
    assert got.shape == want.shape == (int(np.prod(shape[:-2])), 1, 20, shape[-1])
    # two fp32 contractions (256 and 20 terms) around a log: values reach
    # ~30 (log) or ~126 (dB), measured max |diff| 1.9e-6 and 3.1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("win_length", [5, 3, 9])
def test_compute_deltas_matches_jax(win_length):
    x = np.random.RandomState(2).randn(2, 1, 20, 101).astype(np.float32)
    want = np.asarray(jlfcc.compute_deltas(jnp.asarray(x), win_length=win_length))
    got = tlfcc.compute_deltas(torch.from_numpy(x), win_length=win_length)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    ramp = torch.arange(50.0).repeat(3, 1)
    d = tlfcc.compute_deltas(ramp, win_length=win_length)
    n = (win_length - 1) // 2
    torch.testing.assert_close(d[:, n:-n], torch.ones(3, 50 - 2 * n))  # slope 1 inside


def _both_args(**kw):
    base = dict(sample_rate=SR, num_of_scales=256, hop_length=220, power=2.0,
                f_min=1000.0, f_max=11025.0, wavelet="sym5", log_scale=True)
    base.update(kw)
    targs, jargs = default_config(), jax_default_config()
    targs.update(base)
    jargs.update(base)
    return targs, jargs


CASES = [
    (dict(transform="stft"), (2, 1, 256, 101)),
    (dict(transform="stft", log_scale=False), (2, 1, 256, 101)),
    (dict(transform="stft", features="lfcc"), (2, 1, 20, 101)),
    (dict(transform="stft", features="delta"), (2, 1, 20, 101)),
    (dict(transform="stft", features="doubledelta"), (2, 1, 20, 101)),
    (dict(transform="packets", features="lfcc"), (2, 1, 20, 95)),
    (dict(transform="packets", features="doubledelta", wavelet="haar", num_of_scales=64), (2, 1, 20, 345)),
]


@pytest.mark.parametrize("kw,shape", CASES, ids=lambda v: "-".join(map(str, v.values())) if isinstance(v, dict) else None)
def test_make_transform_matches_jax(kw, shape):
    targs, jargs = _both_args(**kw)
    audio = (0.3 * np.random.RandomState(3).randn(2, 1, SR)).astype(np.float32)
    want = np.asarray(jtransforms.make_transform(jargs, use_pallas=False)(jnp.asarray(audio)))
    got = ttransforms.make_transform(targs)(torch.from_numpy(audio))
    assert got.shape == want.shape == shape
    if kw["transform"] == "packets":
        # both packages feed SIGNED packet coefficients to the filterbank, so
        # the LFCC's log sees negative sums: every value is NaN, in the JAX
        # package and here alike (the reference's semantics, kept)
        assert np.isnan(want).all() and torch.isnan(got).all()
    elif kw.get("features", "none") == "none" and kw.get("log_scale", True):
        # the log image: log(x + 1e-12) amplifies roundoff near empty bins
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=5e-3)
    else:
        # the LFCC's filterbank sums 256 bins before its log, so no bin
        # near zero is amplified: measured 7.6e-6 at a peak of 24 (3e-4 at a
        # peak of 236 for the raw power image)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0, atol=5e-6)


def test_log_scale_is_dropped_when_features_follow():
    targs, _ = _both_args(transform="stft", features="lfcc", log_scale=True)
    other, _ = _both_args(transform="stft", features="lfcc", log_scale=False)
    audio = torch.from_numpy((0.3 * np.random.RandomState(4).randn(1, 1, SR)).astype(np.float32))
    torch.testing.assert_close(
        ttransforms.make_transform(targs)(audio), ttransforms.make_transform(other)(audio),
        rtol=0, atol=0)


def test_stft_with_sign_channel_and_unknown_transform_raise():
    targs, jargs = _both_args(transform="stft", loss_less="True")
    with pytest.raises(ValueError, match="Sign channel not possible"):
        ttransforms.make_transform(targs)
    with pytest.raises(ValueError, match="Sign channel not possible"):
        jtransforms.make_transform(jargs)
    targs, _ = _both_args(transform="cwt")
    with pytest.raises(ValueError, match="Unknown transform"):
        ttransforms.make_transform(targs)


@pytest.mark.parametrize("kw", [dict(transform="stft"), dict(transform="stft", features="lfcc")],
                         ids=["stft", "stft-lfcc"])
def test_get_transforms_normalization_matches_jax(kw, tmp_path):
    """The Welford pass over the same batches gives the JAX mean/std, and
    the cache file is written under the reference's name and read back."""
    rs = np.random.RandomState(5)
    batches = [(0.3 * rs.randn(3, 1, SR)).astype(np.float32) for _ in range(2)]
    extra = dict(data_path="/corpus/x", only_use=["ljspeech", "fbmelgan"], calc_normalization=True)
    targs, jargs = _both_args(log_dir=str(tmp_path / "t"), **kw, **extra)
    jargs.log_dir = str(tmp_path / "j")
    _, jmean, jstd = jtransforms.get_transforms(jargs, lambda: iter(batches), verbose=False)
    transform, mean, std = ttransforms.get_transforms(
        targs, lambda: iter(batches), device="cpu", verbose=False)
    assert mean.shape == std.shape == (1,)
    # Welford over 1.5e5 (stft) or 1.2e4 (lfcc) fp32 values on both sides
    np.testing.assert_allclose(mean, jmean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(std, jstd, rtol=1e-4)
    cached = list((tmp_path / "t" / "norms").iterdir())
    assert len(cached) == 1 and cached[0].name.endswith("_stft_sym5_256_2.0_22050_1secs_mean_std.pkl")
    _, mean2, std2 = ttransforms.get_transforms(targs, None, device="cpu", verbose=False)
    np.testing.assert_array_equal(mean2, mean)
    image = ttransforms.normalized_transform(transform, mean, std)(torch.from_numpy(batches[0]))
    assert abs(image.mean().item()) < 0.2 and abs(image.std().item() - 1.0) < 0.2
