"""The port's analysis layer against the JAX package's (CPU).

Integrated gradients, fingerprints, corpus statistics, the CWT, the inverse
wavelet-packet transform, per-node block-norm statistics, model diffs, the
tensorboard directory and the profiler trace.  Inputs are made with numpy
from a seed and fed to both packages; each comparison states its
tolerance.  The JAX side stays unfused (no Pallas kernel is interpreted).
"""

import os
import pickle
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.analysis import fingerprints as jax_fp
from audiodeepfake_detection_tpu.analysis import integrated_gradients as jax_ig
from audiodeepfake_detection_tpu.analysis import model_diffs as jax_md
from audiodeepfake_detection_tpu.analysis import stats as jax_stats
from audiodeepfake_detection_tpu.models.dcnn import DCNN as JaxDCNN
from audiodeepfake_detection_tpu.models.torch_import import import_dcnn as jax_import_dcnn
from audiodeepfake_detection_tpu.ops import wpt as jax_wpt
from audiodeepfake_detection_tpu.train import transforms as jax_transforms
from audiodeepfake_detection_tpu.utils import naming as jax_naming
from audiodeepfake_detection_tpu_torch.analysis import fingerprints, model_diffs, stats
from audiodeepfake_detection_tpu_torch.analysis.integrated_gradients import (
    Mean,
    integral_approximation,
    integrated_grad,
    interpolate_images,
)
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.torch_import import state_dict_from_jax
from audiodeepfake_detection_tpu_torch.ops import cwt as port_cwt
from audiodeepfake_detection_tpu_torch.ops import wpt
from audiodeepfake_detection_tpu_torch.train import profiling, transforms
from audiodeepfake_detection_tpu_torch.utils import naming
from audiodeepfake_detection_tpu_torch.utils.config import default_config

jax_cwt = __import__("audiodeepfake_detection_tpu.ops.cwt", fromlist=["cwt"])

SR = 22050
# the small DCNN geometry of __graft_entry__.dryrun_multichip: haar level 8
# over 2048 samples -> [1, 256, 8], time_dim 1
SMALL_KW = dict(time_dim=1, ochannels1=8, ochannels2=8, ochannels3=12,
                ochannels4=16, ochannels5=4)
IMAGE = (1, 256, 8)


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


# ----------------------------------------------------- integrated gradients


@pytest.fixture(scope="module")
def dcnn_pair():
    """A test-size DCNN with random BN statistics in both packages: the
    port's seeded weights through JAX's ``import_dcnn`` and back through
    ``state_dict_from_jax`` (JAX's own init would cost ~10 s to trace)."""
    torch.manual_seed(0)
    seed_model = DCNN(**SMALL_KW)
    rng = np.random.RandomState(100)
    state = {k: v.numpy().copy() for k, v in seed_model.state_dict().items()}
    for key in state:
        if key.endswith("running_mean"):
            state[key] = rng.uniform(-0.5, 0.5, state[key].shape).astype(np.float32)
        elif key.endswith("running_var"):
            state[key] = rng.uniform(0.5, 2.0, state[key].shape).astype(np.float32)
    variables = jax_import_dcnn(state)
    back = state_dict_from_jax(variables, "dcnn")
    jmodel = JaxDCNN(**SMALL_KW)

    def port(**flags):
        model = DCNN(**SMALL_KW, **flags)
        model.load_state_dict(back)
        return model.eval()

    image = np.random.RandomState(1).randn(*IMAGE).astype(np.float32)
    return jmodel, variables, port, image


def test_interpolate_and_trapezoid_match_jax():
    """The interpolation is the same elementwise float32 arithmetic on both
    sides: 0.0.  The trapezoid's mean over the steps sums them in another
    order (XLA adds 9 rows one after another and 201 rows otherwise,
    ``torch.mean`` pairs them): within 1e-6 of the largest entry, a few
    fp32 roundings of sums of unit-size values."""
    rng = np.random.RandomState(2)
    base, img = rng.randn(2, 3, 5, 7).astype(np.float32)
    alphas = np.linspace(0, 1, 9).astype(np.float32)
    got = interpolate_images(torch.from_numpy(base), torch.from_numpy(img),
                             torch.from_numpy(alphas))
    want = jax_ig.interpolate_images(jnp.asarray(base), jnp.asarray(img), jnp.asarray(alphas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for steps in (9, 201):
        g = rng.randn(steps, 3, 5, 7).astype(np.float32)
        got = integral_approximation(torch.from_numpy(g)).numpy()
        want = np.asarray(jax_ig.integral_approximation(jnp.asarray(g)))
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_mean_keeps_the_reference_contract():
    """``finalize`` averages axis 0 and divides by the update count, as the
    JAX (and reference) accumulator does; before an update it raises."""
    rng = np.random.RandomState(3)
    ours, theirs = Mean(), jax_ig.Mean()
    for _ in range(3):
        v = rng.randn(1, 4, 5).astype(np.float32)
        ours.update(v)
        theirs.update(v)
    np.testing.assert_array_equal(ours.finalize(), theirs.finalize())
    with pytest.raises(ValueError):
        Mean().finalize()


def test_integrated_grad_matches_jax(dcnn_pair):
    """Unfused on both sides, m_steps 8: the port's one batched backward of
    the path against JAX's vmapped ``jax.grad``, within 1e-5 of the largest
    attribution, once each side's baseline row is taken out.

    At the all-zero baseline (alpha = 0) every max-pool window after the
    first block holds a near-tie that each framework's fp32 roundoff
    decides, so the two gradients there differ (ROADMAP.md section 3); the
    trapezoid weighs that row 1 / (2 m_steps).  Each side's own gradient
    at the zero image is removed from its own result, which leaves every
    other row, the trapezoid and the scaling held against JAX."""
    jmodel, variables, port, image = dcnn_pair
    m_steps, target = 8, 1

    def jax_prob(img):
        logits = jmodel.apply(variables, img[None], train=False)[0]
        return jax.nn.softmax(logits)[target]

    want = np.asarray(jax_ig.integrated_grad(
        jmodel.apply, variables, jnp.asarray(image), jnp.asarray(target), m_steps=m_steps))
    jax_g0 = np.asarray(jax.jit(jax.grad(jax_prob))(jnp.zeros(IMAGE, jnp.float32)))
    model = port()
    got = integrated_grad(model, torch.from_numpy(image), target, m_steps=m_steps).numpy()
    zero = torch.zeros((1, *IMAGE), requires_grad=True)
    (port_g0,) = torch.autograd.grad(torch.softmax(model(zero), -1)[0, target], zero)
    port_g0 = port_g0[0].numpy()
    scale = np.abs(want).max()
    assert scale > 0
    got_rest = got - image * port_g0 / (2 * m_steps)
    want_rest = want - image * jax_g0 / (2 * m_steps)
    assert np.abs(got_rest - want_rest).max() <= 1e-5 * scale


def test_integrated_grad_completeness():
    """sum(IG) = P(x) - P(0) for the target's softmax probability, up to
    the trapezoid's error at the production m_steps of 200: within 5e-3,
    the JAX package's own bound on the same Regression model."""
    from audiodeepfake_detection_tpu_torch.models.regression import Regression

    torch.manual_seed(0)
    model = Regression()
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 8, 8).astype(np.float32) * 3)
    model(x[None])  # materialize the lazy layer
    model.eval()
    ig = integrated_grad(model, x, 1, m_steps=200)
    with torch.no_grad():
        p = torch.softmax(model(torch.stack([x, torch.zeros_like(x)])), -1)[:, 1]
    delta = float(p[0] - p[1])
    assert abs(delta) > 0.05
    assert abs(float(ig.sum()) - delta) < 5e-3


def test_integrated_grad_fused_flags_match_unfused(dcnn_pair):
    """The DCNN with ``fused_pool`` and ``fused_layer2`` at ``"always"``
    (their plain versions on the CPU, the second block with its BatchNorm
    folded into its weights) against the unfused DCNN: the gradient at the
    image itself within 1e-5 of its largest entry (fp32 sums in another
    order), the attributions within 2e-3 of the largest (read: 5.2e-4).
    The folded block's values differ from the unfused ones by fp32
    roundoff, so a max-pool window whose two largest values lie within it
    chooses differently: 6 of the 201 path images hold one (rows 1-17,
    near the zero baseline, where the image is nearly constant), such a
    row's gradient moves by up to a tenth of the largest, and it weighs
    1 / 200 in the trapezoid."""
    _, _, port, image = dcnn_pair
    x = torch.from_numpy(image)
    plain, fused = port(), port(fused_pool="always", fused_layer2="always")
    grads = []
    for model in (plain, fused):
        img = x[None].clone().requires_grad_(True)
        grads.append(torch.autograd.grad(torch.softmax(model(img), -1)[0, 0], img)[0])
    assert (grads[1] - grads[0]).abs().max() <= 1e-5 * grads[0].abs().max()
    want = integrated_grad(plain, x, 0, m_steps=200)
    got = integrated_grad(fused, x, 0, m_steps=200)
    assert (got - want).abs().max() <= 2e-3 * want.abs().max()


def test_integrated_grad_refuses_training_mode(dcnn_pair):
    _, _, port, image = dcnn_pair
    with pytest.raises(ValueError, match="eval"):
        integrated_grad(port().train(), torch.from_numpy(image), 0, m_steps=2)


# ---------------------------------------------------- fingerprints and stats


@pytest.fixture(scope="module")
def clips():
    rng = np.random.RandomState(4)
    t = np.arange(3 * 2**14) / SR
    tone = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(t.size)).astype(np.float32)
    noise = (0.3 * rng.randn(2 * 2**14 + 777)).astype(np.float32)
    return [tone, noise]


def test_mean_wpt_spectrum_level14_matches_jax(clips):
    """Level-14 haar packets of two clips (3 and 2 x 2**14 samples, the
    second cropped): within 1e-6 relative of JAX's; the op's CPU
    implementation and ``use_kernel=False`` are the same plain cascade."""
    want = jax_fp.mean_wpt_spectrum(clips, "haar", 14)
    got = fingerprints.mean_wpt_spectrum(clips, "haar", 14, device="cpu")
    assert got.shape == (2**14,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    plain = fingerprints.mean_wpt_spectrum(clips, "haar", 14, device="cpu", use_kernel=False)
    np.testing.assert_array_equal(plain, got)
    with pytest.raises(ValueError, match="level"):
        fingerprints.mean_wpt_spectrum([clips[0][:100]], "haar", 14, device="cpu")


def test_rfft_spectrum_and_fingerprint_audio_equal_jax(clips):
    """Both are numpy on both sides: 0.0."""
    spec = fingerprints.mean_rfft_spectrum(clips)
    np.testing.assert_array_equal(spec, jax_fp.mean_rfft_spectrum(clips))
    np.testing.assert_array_equal(fingerprints.fingerprint_audio(spec),
                                  jax_fp.fingerprint_audio(spec))


def test_stats_match_jax(clips):
    """STFT energy and centroid within 1e-5 relative (``torch.stft``
    against JAX's DFT matrix product, both fp32); YIN (numpy) equal."""
    rates = [SR, 16000]
    np.testing.assert_allclose(stats.average_energy(clips, device="cpu"),
                               jax_stats.average_energy(clips), rtol=1e-5)
    np.testing.assert_allclose(stats.spectral_centroid(clips[0], SR, device="cpu"),
                               jax_stats.spectral_centroid(clips[0], SR), rtol=1e-5)
    got = stats.corpus_stats(clips, rates, device="cpu")
    want = jax_stats.corpus_stats(clips, rates)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    np.testing.assert_array_equal(stats.yin_pitch(clips[0], SR),
                                  jax_stats.yin_pitch(clips[0], SR))


def test_cwt_matches_jax_and_the_float64_oracle():
    """complex64 FFTs: within 1e-5 of the largest coefficient of JAX's
    ``cwt``, 1e-4 of the float64 ``cwt_reference``; frequencies equal."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 700).astype(np.float32)
    scales = np.geomspace(1.0, 60.0, 24)
    got, freqs = port_cwt.cwt(x, scales, "shan0.0001-0.87", sampling_period=1 / SR,
                              device="cpu")
    want, jfreqs = jax_cwt.cwt(x, scales, "shan0.0001-0.87", sampling_period=1 / SR)
    ref, _ = jax_cwt.cwt_reference(x, scales, "shan0.0001-0.87", sampling_period=1 / SR)
    assert got.shape == want.shape == (24, 2, 700)
    np.testing.assert_array_equal(freqs, jfreqs)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("wavelet,level,t", [("sym5", 3, 1000), ("haar", 6, 2048),
                                             ("db8", 2, 333), ("db4", 4, 777)])
def test_wpt_synthesis_matches_jax_and_round_trips(wavelet, level, t):
    """The inverse of the port's analysis gives back the signal (within
    2e-6, fp32 filter sums over the levels), and equals JAX's synthesis of
    the same packets within 2e-6 (other summation orders)."""
    x = np.random.RandomState(level).randn(2, t).astype(np.float32)
    packets = wpt.wpt_analysis(torch.from_numpy(x), wavelet, level)
    got = wpt.wpt_synthesis(packets, wavelet, level, t).numpy()
    want = np.asarray(jax_wpt.wpt_synthesis(jnp.asarray(packets.numpy()), wavelet, level, t))
    np.testing.assert_allclose(got, x, atol=2e-6)
    np.testing.assert_allclose(got, want, atol=2e-6)
    natural = wpt.wpt_analysis(torch.from_numpy(x), wavelet, level, natural_order=True)
    back = wpt.wpt_synthesis(natural, wavelet, level, t, natural_order=True).numpy()
    np.testing.assert_allclose(back, x, atol=2e-6)


def test_block_norm_stats_match_jax():
    """Per-node Welford statistics of the raw level-8 sym5 packets over two
    batches: within 1e-5 relative of JAX's (the same Welford update order
    on fp32 packets of two cascades)."""
    args = default_config()
    args.update(num_of_scales=256, wavelet="sym5")
    rng = np.random.RandomState(6)
    batches = [rng.randn(3, 1, 4096).astype(np.float32) * 0.3 for _ in range(2)]
    got = transforms.compute_block_norm_stats(args, iter(batches), "cpu")
    want = jax_transforms.compute_block_norm_stats(args, iter(batches))
    assert sorted(got) == sorted(want) == list(range(256))
    for key in ("mean", "std"):
        g = np.asarray([got[n][key] for n in range(256)])
        w = np.asarray([want[n][key] for n in range(256)])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_export_diff_audio_writes_jax_bytes(tmp_path):
    """One dump pair, the unknown and the known key: the same file names
    and the same wav bytes as the JAX function."""
    rng = np.random.RandomState(7)
    wav = tmp_path / "clip.wav"
    _write_wav(wav, 0.3 * rng.randn(3 * 1000), sr=16000)
    table = np.asarray([[str(wav), i, 1000, i % 2] for i in range(3)], dtype=object)
    a = {"unknown": np.asarray([0, 1, 2]), "known": np.asarray([1]),
         "dataset": table, "dataset_known": table[::-1]}
    b = {"unknown": np.asarray([1]), "known": np.asarray([]), "dataset": table}
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    for key in ("unknown", "known"):
        ours, theirs = tmp_path / f"ours_{key}", tmp_path / f"theirs_{key}"
        got = model_diffs.export_diff_audio(str(tmp_path / "a.npy"), str(tmp_path / "b.npy"),
                                            str(ours), key=key)
        want = jax_md.export_diff_audio(str(tmp_path / "a.npy"), str(tmp_path / "b.npy"),
                                        str(theirs), key=key)
        np.testing.assert_array_equal(got, want)
        assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) != []
        for name in os.listdir(theirs):
            assert (ours / name).read_bytes() == (theirs / name).read_bytes()


def test_tensorboard_dir_is_the_jax_name():
    args = default_config()
    args.update(data_prefix="/d/fake_22050_22050_0.7_fbmelgan", transform="packets",
                wavelet="sym5", seed=3)
    assert naming.tensorboard_dir(args, "/log", "DCNN") == jax_naming.tensorboard_dir(
        args, "/log", "DCNN")


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with pytest.raises(RuntimeError, match="body"):
        with profiling.trace(str(tmp_path)):
            with profiling.annotate("ig_phase"):
                torch.ones(4).sum()
            raise RuntimeError("body")
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".json") and "ig_phase" in (tmp_path / name).read_text()


def test_block_norm_cache_is_written_once(tmp_path):
    """``get_transforms`` with ``block_norm`` and ``calc_normalization``
    writes the per-node pickle, returns zeros / ones, and reads nothing
    back (the reference keeps the file for analysis)."""
    args = default_config()
    args.update(num_of_scales=256, wavelet="haar", transform="packets", block_norm=True,
                calc_normalization=True, data_path=str(tmp_path), log_dir=str(tmp_path),
                log_scale=True)
    batch = np.random.RandomState(8).randn(2, 1, 2048).astype(np.float32)
    _, mean, std = transforms.get_transforms(args, lambda: iter([batch]), device="cpu")
    np.testing.assert_array_equal(mean, [0.0])
    np.testing.assert_array_equal(std, [1.0])
    cache = transforms.norm_cache_prefix(args) + "_mean_std_bn.pkl"
    with open(cache, "rb") as fh:
        blob = pickle.load(fh)
    assert sorted(blob) == list(range(256)) and set(blob[0]) == {"mean", "std"}
    transforms.get_transforms(args, lambda: pytest.fail("stats computed twice"), device="cpu")
