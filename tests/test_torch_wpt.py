"""Port wavelet packets vs the JAX reference (CPU).

The port's plain PyTorch cascade is held against the JAX XLA cascade and
against the JAX Pallas kernel in interpret mode; the port's CUDA wrapper
must take that plain version for CPU tensors without counting a launch.
Inputs are made with numpy from a seed and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.ops import wavelets as jax_wavelets
from audiodeepfake_detection_tpu.ops.wpt import packet_image as jax_packet_image
from audiodeepfake_detection_tpu.ops.wpt import wpt_analysis as jax_wpt_analysis
from audiodeepfake_detection_tpu.ops.wpt_pallas import wpt_packets_pallas
from audiodeepfake_detection_tpu_torch.ops import wpt_cuda
from audiodeepfake_detection_tpu_torch.ops.wavelets import get_wavelet
from audiodeepfake_detection_tpu_torch.ops.wpt import (
    graycode_permutation,
    packet_image,
    reflect_indices,
    wpt_analysis,
    wpt_output_length,
)

# plain cascade vs the XLA cascade: both fp32 FIR sums of the same taps;
# the same bound the JAX package holds its Pallas kernel to
WPT_ATOL = 5e-6
# log(|x|**2 + 1e-12) amplifies fp32 roundoff near zero (as in
# tests/test_wpt_pallas.py)
LOG_RTOL, LOG_ATOL = 1e-3, 5e-3


def _audio(b, t, seed=0):
    return np.random.RandomState(seed).randn(b, t).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_tf32():
    # TF32 does not exist on the CPU; set the switch anyway so the parity
    # contract (full fp32 convolutions) is stated where it is relied on
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("name", ["haar", "db4", "sym5", "coif4"])
def test_filters_equal_jax(name):
    ours, ref = get_wavelet(name), jax_wavelets.get_wavelet(name)
    for attr in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr))


@pytest.mark.parametrize(
    "wavelet,level,t",
    [
        ("haar", 3, 1024),
        ("sym5", 4, 1024),
        ("db4", 5, 2048),
        ("haar", 8, 4096),
        ("coif4", 4, 2048),
        # padl = 22 >= n = 16: the pad reflects back and forth
        ("coif4", 2, 16),
    ],
)
def test_wpt_analysis_matches_jax(wavelet, level, t):
    x = _audio(4, t)
    want = np.asarray(jax_wpt_analysis(jnp.asarray(x), wavelet, level))
    got = wpt_analysis(torch.from_numpy(x), wavelet, level).numpy()
    assert got.shape == want.shape
    assert got.shape[-1] == wpt_output_length(t, get_wavelet(wavelet).dec_len, level)
    np.testing.assert_allclose(got, want, atol=WPT_ATOL)


def test_reflect_indices_repeat_like_numpy_pad():
    # numpy's reflect pad is the whole-point reflection the kernel uses,
    # including pads longer than the signal
    n, padl, padr = 5, 12, 13
    sig = np.arange(n)
    np.testing.assert_array_equal(
        reflect_indices(n, padl, padr), np.pad(sig, (padl, padr), mode="reflect")
    )


def test_plain_matches_pallas_interpret_main_geometry():
    """The main path's geometry: sym5, level 8, one second at 22050 Hz.

    Measured Pallas-vs-XLA gap is 5.7e-6 at a peak of 16.5, hence 1e-5.
    """
    x = _audio(2, 22050, seed=5)
    want = np.asarray(wpt_packets_pallas(jnp.asarray(x), "sym5", 8, b_tile=2))
    got = wpt_analysis(torch.from_numpy(x), "sym5", 8).numpy()
    assert got.shape == want.shape == (2, 256, 95)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "kw",
    [
        dict(log_scale=False),
        dict(log_scale=True),
        dict(log_scale=True, loss_less=True),
        dict(log_scale=True, block_norm=True),
        dict(log_scale=False, block_norm=True, loss_less=True),
    ],
    ids=["raw", "log", "log-sign", "log-blocknorm", "raw-blocknorm"],
)
def test_packet_image_matches_jax(kw):
    x = _audio(3, 2048, seed=1)
    want = np.asarray(
        jax_packet_image(jnp.asarray(x), "sym5", 5, use_pallas=False, **kw)
    )
    got = packet_image(torch.from_numpy(x), "sym5", 5, **kw).numpy()
    assert got.shape == want.shape
    if kw.get("log_scale"):
        np.testing.assert_allclose(got, want, rtol=LOG_RTOL, atol=LOG_ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=WPT_ATOL)


def test_packet_image_kernel_flag_same_on_cpu():
    x = torch.from_numpy(_audio(2, 4096, seed=2)[:, None, :])
    a = packet_image(x, "db4", 6, log_scale=True, use_kernel=True)
    b = packet_image(x, "db4", 6, log_scale=True, use_kernel=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu_without_launch():
    before = wpt_cuda.LAUNCHES
    x = torch.from_numpy(_audio(2, 2048, seed=3))
    got = wpt_cuda.wpt_packets_cuda(x, "sym5", 4, log_scale=True)
    want = torch.log(torch.abs(wpt_analysis(x, "sym5", 4)) ** 2 + 1e-12)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert wpt_cuda.LAUNCHES == before == 0


def test_graycode_permutation():
    np.testing.assert_array_equal(graycode_permutation(3), [0, 1, 3, 2, 6, 7, 5, 4])


def test_smem_plan_fits_main_path_and_refuses_two_seconds():
    """One frame's level buffers fit the H100's 232,448-byte opt-in shared
    memory for 1 s of sym5 and coif4, so those frames take the one-block
    kernel; a 2 s clip at 22050 Hz and 1 s at 32 kHz do not, and take the
    long-frame route (one launch per level) instead of a refusal."""
    limit = 232448
    _, _, sym5 = wpt_cuda.cascade_smem_plan(22050, 10, 8)
    _, _, coif4 = wpt_cuda.cascade_smem_plan(22050, 24, 8)
    _, _, two_s = wpt_cuda.cascade_smem_plan(44100, 10, 8)
    assert sym5 <= limit and coif4 <= limit < two_s
    assert wpt_cuda.wpt_route(22050, 10, 8, limit) == "block"
    assert wpt_cuda.wpt_route(22050, 24, 8, limit) == "block"
    for t, filt_len, level in ((44100, 10, 8), (44100, 24, 8), (44100, 2, 8),
                               (44100, 16, 8), (32000, 10, 8), (8 * 2**14, 2, 14)):
        assert wpt_cuda.wpt_route(t, filt_len, level, limit) == "long", (t, filt_len, level)
    # buffer A holds the larger of levels 1, 3, 5, 7 (as 0-based outputs
    # 0, 2, 4, 6), buffer B of levels 2, 4, 6
    a_off, b_off, total = wpt_cuda.cascade_smem_plan(22050, 10, 8)
    lengths = [wpt_output_length(22050, 10, k) for k in range(1, 8)]
    sizes = [(2**k) * n for k, n in enumerate(lengths, start=1)]
    assert a_off == 20
    assert b_off - a_off == max(sizes[0::2])
    assert total == 4 * (b_off + max(sizes[1::2]))


@pytest.mark.parametrize("log_scale", [False, True], ids=["raw", "log"])
def test_two_second_frames_match_jax(log_scale):
    """2 s at 22050 Hz, sym5 level 8 (what the long-frame route computes on
    the card): the plain cascade and the packet image against the JAX
    package's XLA cascade."""
    x = _audio(2, 44100, seed=6)
    if not log_scale:
        want = np.asarray(jax_wpt_analysis(jnp.asarray(x), "sym5", 8))
        got = wpt_analysis(torch.from_numpy(x), "sym5", 8).numpy()
        assert got.shape == want.shape == (2, 256, wpt_output_length(44100, 10, 8))
        np.testing.assert_allclose(got, want, atol=WPT_ATOL)
        return
    want = np.asarray(
        jax_packet_image(jnp.asarray(x), "sym5", 8, log_scale=True, use_pallas=False)
    )
    got = packet_image(torch.from_numpy(x), "sym5", 8, log_scale=True).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LOG_RTOL, atol=LOG_ATOL)
