"""Port ``spectrogram`` (``torch.stft``) vs the JAX package's, on the CPU.

The same numpy audio goes through both.  The JAX function is run in both of
its methods: the matrix-product DFT (float64 matrix rounded to float32,
``Precision.HIGHEST``) and ``jnp.fft.rfft``; the port runs pocketfft here
and cuFFT on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.ops import stft as jstft
from audiodeepfake_detection_tpu_torch.ops import stft as tstft

# Power and magnitude images of unit-variance audio, relative to the image's
# peak (~5e4 for power at n_fft=511): fp32 FFT against an fp32 matrix DFT of
# 511 terms.  Measured here: at most 1.3e-6 of the peak (power 2 against the
# matrix DFT; 5e-7 against jnp.fft), 6e-4 absolute in the log image.
PEAK_RTOL = 5e-6
# log(x + 1e-12) amplifies the same absolute error where a bin is near zero
LOG_RTOL, LOG_ATOL = 1e-3, 5e-3


def _audio(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("power", [1.0, 2.0])
@pytest.mark.parametrize("n_fft,hop,t", [(511, 220, 22050), (127, 50, 4000)])
def test_spectrogram_matches_jax(n_fft, hop, t, power, center, method):
    x = _audio((2, 1, t), seed=n_fft)
    kw = dict(n_fft=n_fft, hop_length=hop, power=power, center=center)
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), method=method, **kw))
    got = tstft.spectrogram(torch.from_numpy(x), **kw)
    n_frames = 1 + (t + (2 * (n_fft // 2) if center else 0) - n_fft) // hop
    assert got.shape == want.shape == (2, 1, n_fft // 2 + 1, n_frames)
    if (n_fft, hop, t, center) == (511, 220, 22050, True):
        assert got.shape == (2, 1, 256, 101)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy() / peak, want / peak, rtol=0, atol=PEAK_RTOL)

    want_log = np.asarray(
        jstft.spectrogram(jnp.asarray(x), method=method, log_scale=True, **kw))
    got_log = tstft.spectrogram(torch.from_numpy(x), log_scale=True, **kw)
    np.testing.assert_allclose(got_log.numpy(), want_log, rtol=LOG_RTOL, atol=LOG_ATOL)


def test_other_power_and_leading_axes():
    x = _audio((3, 2, 2, 1500), seed=3)
    kw = dict(n_fft=63, hop_length=16, power=0.5)
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), **kw))
    got = tstft.spectrogram(torch.from_numpy(x), **kw)
    assert got.shape == want.shape == (3, 2, 2, 32, 94)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    flat = tstft.spectrogram(torch.from_numpy(x.reshape(12, 1500)), **kw)
    torch.testing.assert_close(flat.reshape(got.shape), got, rtol=0, atol=0)


def test_hann_window_matches_jax_and_torch():
    for n in (511, 128, 7):
        got = tstft.hann_window(n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jstft.hann_window(n)))
        # torch builds its window in float32: one ulp (1.2e-7) apart
        torch.testing.assert_close(got, torch.hann_window(n, periodic=True), rtol=0, atol=2e-7)
    assert tstft.hann_window(16, torch.float64).dtype == torch.float64
    assert tstft.hann_window(16) is tstft.hann_window(16)  # one copy per size


def test_silence_gives_the_log_floor():
    got = tstft.spectrogram(torch.zeros(1, 1, 2048), n_fft=127, hop_length=50, log_scale=True)
    assert torch.all(got == np.log(np.float32(1e-12)))
