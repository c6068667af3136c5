"""The port's serving export (``train/export.py``) on the CPU.

* Against the JAX package: JAX's own tiny scorer (level-4 sym5 packets +
  ``Regression``, ``tests/test_export.py``), its weights carried across by
  ``state_dict_from_jax``; JAX's ``export_scorer`` artifact and the port's,
  on the same numpy audio.
* Against ``make_score_fn``: each artifact, reloaded from its file, scores
  bit for bit as the in-process scorer, at a concrete batch and a symbolic
  one (b = 1, 2 and 5), chunked and whole; the full-width DCNN snapshot
  through the CLI, the DCNN with its fused blocks and int8-baked, the LCNN
  with its fused block, a test-size AST with the fused attention, each
  graph holding its ``adfd`` ops.
* ``torch.library.opcheck`` of every ``adfd`` op (schema, fake
  implementation with strides, tracing), the export leaving the eager
  caches real, and the refusals.

No JAX model runs through an interpreted Pallas kernel here.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.models.regression import Regression as JaxRegression
from audiodeepfake_detection_tpu.ops.wpt import packet_image as jax_packet_image
from audiodeepfake_detection_tpu.train import export as jax_export
from audiodeepfake_detection_tpu_torch.models import ast
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
from audiodeepfake_detection_tpu_torch.models.regression import Regression
from audiodeepfake_detection_tpu_torch.models.torch_import import state_dict_from_jax
from audiodeepfake_detection_tpu_torch.ops import int8_conv_cuda, lfcc, library, stft, wpt
from audiodeepfake_detection_tpu_torch.ops.quantize import (
    DEFAULT_INT8_SITES,
    bake_int8_weights,
    baked_records,
    quantize_model,
)
from audiodeepfake_detection_tpu_torch.train import export, predict
from audiodeepfake_detection_tpu_torch.train.transforms import (
    make_transform,
    normalized_transform,
)
from audiodeepfake_detection_tpu_torch.utils.config import default_config
from audiodeepfake_detection_tpu_torch.utils.naming import experiment_model_file

WIN = 2048  # JAX's tiny scorer (tests/test_export.py)
SR = 22050
# the slice's tolerance, port against JAX (tests/test_torch_slice.py)
PROB_ATOL = 1e-5
# the narrow DCNN of the JAX package's int8 gate (as tests/test_torch_int8.py)
NARROW = dict(ochannels1=8, ochannels2=8, ochannels3=12, ochannels4=16, ochannels5=4,
              time_dim=12, flattend_size=320)
AST_SIZE = dict(embed_dim=32, depth=2, num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread for the whole file: the suite runs several
    workers on the same cores (as tests/test_torch_int8.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def test_size():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ast._SIZES, "test32", AST_SIZE)
        yield


def _audio(b, win, seed):
    return np.random.RandomState(seed).randn(b, 1, win).astype(np.float32)


def _roundtrip(ep, path, meta=None):
    export.save_artifact(ep, str(path), meta or {})
    return export.load_artifact(str(path))


def _call(ep, audio: np.ndarray) -> torch.Tensor:
    with torch.inference_mode():
        return ep.module()(torch.from_numpy(audio))


def _equal(got: torch.Tensor, want: torch.Tensor) -> None:
    assert type(got) is torch.Tensor and type(want) is torch.Tensor
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ------------------------------------------------------------ against JAX


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX's tiny scorer, its artifact (batch 3) and the port's twin."""
    def jax_transform(audio):
        return jax_packet_image(audio, "sym5", level=4, log_scale=True, power=2.0,
                                use_pallas=False)

    jmodel = JaxRegression()
    variables = jmodel.init(jax.random.key(0), jax_transform(jnp.zeros((1, 1, WIN))))
    jax_path = str(tmp_path_factory.mktemp("jax") / "scorer.adfx")
    jax_export.save_artifact(
        jax_export.export_scorer(jmodel, jax_transform, variables, WIN, batch_size=3),
        jax_path, {"win": WIN})

    def transform(audio):
        return wpt.packet_image(audio, "sym5", level=4, log_scale=True, power=2.0)

    model = Regression()
    with torch.no_grad():
        model(transform(torch.zeros(1, 1, WIN)))  # fixes the lazy width
    state = state_dict_from_jax(jax.tree.map(np.asarray, variables), "regression")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True)
    return model.eval(), transform, jax_path


def test_artifact_matches_the_jax_artifact(tiny, tmp_path):
    """The two artifacts, each reloaded from its file, on the same audio:
    the port's packets run through ``adfd::wpt_packets`` (the plain cascade
    on the CPU), JAX's through its XLA cascade."""
    model, transform, jax_path = tiny
    audio = _audio(3, WIN, seed=0)
    jep, jmeta = jax_export.load_artifact(jax_path)
    want = np.asarray(jep.call(jnp.asarray(audio)))
    ep, meta = _roundtrip(export.export_scorer(model, transform, WIN, "cpu", batch_size=3),
                          tmp_path / "port.adfx", {"win": WIN})
    assert meta["in_shape"] == jmeta["in_shape"] == ["3", "1", str(WIN)]
    assert meta["device"] == "cpu" and export.adfd_ops(ep) == {"adfd::wpt_packets": 1}
    got = _call(ep, audio).numpy()
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    _equal(_call(ep, audio), predict.make_score_fn(model, transform, "cpu")(
        torch.from_numpy(audio)))


def test_chunked_artifact_equals_whole(tiny, tmp_path):
    """``chunk=2`` of a batch of 4 bakes two microbatches: bit for bit the
    chunked in-process scorer, and the whole-batch artifact within a
    product's rounding; a chunk of the whole batch bakes none."""
    model, transform, _ = tiny
    ep, meta = _roundtrip(
        export.export_scorer(model, transform, WIN, "cpu", batch_size=4, chunk=2),
        tmp_path / "chunked.adfx", {"chunk": export.baked_chunk(2, 4)})
    assert meta["chunk"] == 2 and export.baked_chunk(4, 4) == 0
    whole = export.export_scorer(model, transform, WIN, "cpu", batch_size=4)
    audio = _audio(4, WIN, seed=1)
    got = _call(ep, audio)
    _equal(got, predict.make_score_fn(model, transform, "cpu", chunk=2)(torch.from_numpy(audio)))
    np.testing.assert_allclose(got.numpy(), _call(whole, audio).numpy(), rtol=1e-6, atol=0)


# ------------------------------------------- the full-width DCNN snapshot


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A config-encoded full-width DCNN snapshot with a ``.norm.pkl``
    sidecar (the layout of tests/test_torch_slice.py); seeded weights and
    BatchNorm statistics."""
    root = tmp_path_factory.mktemp("snap")
    (root / "models").mkdir()
    args = default_config()
    args.update(data_prefix="x/fake_22050_22050_0.7_fbmelgan", transform="packets",
                wavelet="sym5", num_of_scales=256, only_use=["ljspeech", "fbmelgan"])
    path = experiment_model_file(args, str(root), "DCNN") + ".pt"
    torch.manual_seed(3)
    state = DCNN(time_dim=12).state_dict()
    rng = np.random.RandomState(103)
    for k, v in state.items():
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, v.shape).astype(np.float32)))
    torch.save(state, path)
    with open(path + ".norm.pkl", "wb") as fh:
        pickle.dump([np.asarray([-5.0], np.float32), np.asarray([4.0], np.float32)], fh)
    return path


def test_cli_exports_the_snapshot_and_checks_it(snapshot, tmp_path, capsys):
    """``main([... "--check"])``: a symbolic batch through the WPT op, its
    meta, and b = 1, 2 and 5 bit for bit against the snapshot's in-process
    scorer."""
    out = str(tmp_path / "dcnn.adfx")
    export.main([snapshot, out, "--device", "cpu", "--check"])
    assert "check ok" in capsys.readouterr().out
    ep, meta = export.load_artifact(out)
    assert meta == {
        "snapshot": snapshot, "model": "DCNN", "transform": "packets", "win": SR,
        "sample_rate": SR, "portable": False, "normalized": True, "chunk": 0,
        "device": "cpu", "in_shape": ["b", "1", str(SR)],
    }
    assert export.adfd_ops(ep) == {"adfd::wpt_packets": 1}
    model, transform, _ = predict.build_scorer_from_snapshot(snapshot)
    score = predict.make_score_fn(model, transform, "cpu")
    for b in (1, 2, 5):
        audio = _audio(b, SR, seed=b)
        _equal(_call(ep, audio), score(torch.from_numpy(audio)))


def test_cli_plain_wpt_gives_a_portable_artifact(snapshot, tmp_path):
    out = str(tmp_path / "plain.adfx")
    export.main([snapshot, out, "--device", "cpu", "--plain-wpt", "--batch-size", "2"])
    ep, meta = export.load_artifact(out)
    assert meta["portable"] is True and meta["in_shape"] == ["2", "1", str(SR)]
    assert not export.adfd_ops(ep)
    model, transform, _ = predict.build_scorer_from_snapshot(snapshot)
    audio = _audio(2, SR, seed=7)
    _equal(_call(ep, audio), predict.make_score_fn(model, transform, "cpu")(
        torch.from_numpy(audio)))


# ------------------------------------- each kernel's model, with its ops


def _packets():
    cfg = default_config()
    cfg.update(transform="packets", wavelet="sym5", num_of_scales=256, log_scale=True)
    return normalized_transform(make_transform(cfg), np.asarray([-5.0], np.float32),
                                np.asarray([4.0], np.float32))


def _image(shape):
    """A stand-in transform: the raw frame reshaped to the model's image
    (as the JAX package's int8 export test does)."""
    return lambda audio: audio.reshape(audio.shape[0], *shape)


def _dcnn_fused():
    flags = dict(fused_layer1="always", fused_pool="always", fused_layer2="always")
    return DCNN(**NARROW, **flags), _packets(), SR, {
        "adfd::wpt_packets": 1, "adfd::fused_conv1_prelu_pool": 1,
        "adfd::fused_conv2_prelu_pool": 1, "adfd::fused_prelu_pool": 1}


def _dcnn_int8():
    model, transform = DCNN(**NARROW).eval(), _packets()
    with torch.no_grad():
        img = transform(torch.from_numpy(_audio(3, SR, seed=11)))
    qmodel, _ = quantize_model(model, [img], include=DEFAULT_INT8_SITES)
    return bake_int8_weights(qmodel, img), transform, SR, {
        "adfd::wpt_packets": 1, "adfd::int8_conv_site": len(DEFAULT_INT8_SITES)}


def _lcnn():
    return LCNN(lstm_channels=64, fused_layer1="always"), _image((1, 64, 37)), 64 * 37, {
        "adfd::fused_conv_mfm_pool": 1}


def _ast():
    model = ast.ASTModel(input_fdim=64, input_tdim=48, model_size="test32",
                         fused_attention=True)
    return model, _image((1, 64, 48)), 64 * 48, {
        "adfd::flash_mha_packed": AST_SIZE["depth"]}


@pytest.mark.parametrize("make", [_dcnn_fused, _dcnn_int8, _lcnn, _ast],
                         ids=["dcnn-fused", "dcnn-int8", "lcnn-fused", "ast-fused"])
def test_model_artifacts_equal_make_score_fn(make, tmp_path):
    """Symbolic batch (b = 1, 2, 5) and a concrete batch of 3, each reloaded
    from its file, bit for bit the in-process scorer; the graph calls the
    model's ``adfd`` ops, and the int8 model's baked records ride along."""
    torch.manual_seed(5)
    model, transform, win, ops = make()
    score = predict.make_score_fn(model, transform, "cpu")
    ep, meta = _roundtrip(export.export_scorer(model, transform, win, "cpu"),
                          tmp_path / "sym.adfx")
    assert meta["in_shape"] == ["b", "1", str(win)] and export.adfd_ops(ep) == ops
    if "adfd::int8_conv_site" in ops:
        # w_q, s_w and the kernel's layout at each site, the map at the five folded ones
        baked = [k for k in ep.constants if "int8_baked__" in k]
        assert len(baked) == sum(map(len, baked_records(model).values())) == 3 * 6 + 5
    for b in (1, 2, 5):
        audio = _audio(b, win, seed=20 + b)
        _equal(_call(ep, audio), score(torch.from_numpy(audio)))
    ep, _ = _roundtrip(export.export_scorer(model, transform, win, "cpu", batch_size=3),
                       tmp_path / "b3.adfx")
    audio = _audio(3, win, seed=30)
    _equal(_call(ep, audio), score(torch.from_numpy(audio)))


# ------------------------------------------------------------ the ops


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _r(*shape, seed=0, dtype=torch.float32):
    return torch.randn(*shape, generator=_gen(seed)).to(dtype)


def _codes(*shape, seed=0):
    return torch.randint(-127, 128, shape, dtype=torch.int8, generator=_gen(seed))


_OP_CASES = {
    "wpt_packets": lambda: (_r(3, 300), "sym5", 3, True, 2.0),
    "wpt_packets-raw": lambda: (_r(2, 64, seed=1), "haar", 4, False, 2.0),
    "fused_conv1_prelu_pool": lambda: (_r(2, 9, 11), _r(9, 8, seed=1), _r(8, seed=2),
                                       torch.tensor([0.25])),
    "fused_conv1_prelu_pool-bf16": lambda: (_r(2, 8, 7, dtype=torch.bfloat16),
                                            _r(9, 4, seed=1), _r(4, seed=2), torch.tensor([-0.5])),
    "fused_conv_mfm_pool": lambda: (_r(2, 9, 11), _r(25, 8, seed=1), _r(8, seed=2)),
    "fused_conv_mfm_pool-bf16": lambda: (_r(2, 6, 9, dtype=torch.bfloat16), _r(25, 4, seed=1),
                                         _r(4, seed=2)),
    "flash_mha_packed": lambda: (_r(2, 5, 3 * 2 * 4), 2, 0.5),
    "fused_prelu_pool": lambda: (_r(2, 3, 7, 9), torch.tensor([0.25])),
    "fused_conv2_prelu_pool": lambda: (_r(2, 3, 6, 7), _r(27, 4, seed=1), _r(4, 6, 7, seed=2),
                                       torch.tensor([0.25])),
    "int8_conv": lambda: (_codes(2, 6, 7, 3), _codes(4, 3, 3, 3, seed=1),
                          torch.rand(4, generator=_gen(2)), 1, 2, torch.float32),
    "int8_conv-int32": lambda: (_codes(2, 5, 5, 2), _codes(3, 2, 1, 1, seed=1), None, 0, 1,
                                torch.int32),
    "int8_conv_site": lambda: (_r(2, 3, 6, 7), 0.02, _codes(4, 3, 3, 3, seed=1),
                               torch.rand(4, generator=_gen(2)), None, None, _r(4, seed=3), 1, 2),
    "int8_conv_site-bf16-baked": lambda: (
        _r(2, 1, 5, 6, dtype=torch.bfloat16), 0.01, _codes(3, 1, 3, 3, seed=1),
        torch.rand(3, generator=_gen(2)), int8_conv_cuda.site_weights(_codes(3, 1, 3, 3, seed=1)),
        _r(3, 5, 6, seed=4, dtype=torch.bfloat16), _r(3, seed=5, dtype=torch.bfloat16), 1, 1),
}


@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_every_op_passes_opcheck(case):
    """Schema, CPU against fake (shape, dtype and strides), and tracing with
    a dynamic batch; kernels 2 and 3 store NCHW memory behind ``[B, h2, w2,
    C]``, in both implementations."""
    op = getattr(torch.ops.adfd, case.split("-")[0]).default
    args = _OP_CASES[case]()
    torch.library.opcheck(op, args)
    if case.startswith(("fused_conv1", "fused_conv_mfm")):
        out = op(*args)
        with torch._subclasses.FakeTensorMode() as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                        for a in args))
        assert out.stride() == fake.stride() and out.permute(0, 3, 1, 2).is_contiguous()


def test_every_forward_a_scorer_reaches_is_an_op():
    library.load()
    assert sorted(n for n in dir(torch.ops.adfd) if not n.startswith("_") and n != "name") == [
        "flash_mha_packed", "fused_conv1_prelu_pool", "fused_conv2_prelu_pool",
        "fused_conv_mfm_pool", "fused_prelu_pool", "int8_conv", "int8_conv_site",
        "wpt_packets"]


# ----------------------------------------------- the caches after a trace


_TRANSFORMS = {
    "packets-plain": dict(transform="packets", wavelet="sym5", num_of_scales=256,
                          log_scale=True),
    "stft-lfcc": dict(transform="stft", num_of_scales=256, hop_length=220, features="lfcc"),
}


@pytest.mark.parametrize("name", sorted(_TRANSFORMS))
def test_export_leaves_the_eager_caches_real(name):
    """The taps, index maps, window, LFCC matrices and normalization stats
    are cached per device; a trace must not leave its fake tensors there.
    Export first (the caches empty), then the eager scorer in the same
    process gives real tensors, equal to what it gave before the export;
    the graph takes the cached tensors as constants."""
    cfg = default_config()
    cfg.update(**_TRANSFORMS[name])
    mean, std = np.asarray([-5.0], np.float32), np.asarray([4.0], np.float32)

    def scorer():
        """Regression's width fixed by a first call, and a transform never
        called (its normalization stats not yet on the device)."""
        torch.manual_seed(0)
        model = Regression()
        with torch.no_grad():
            model(make_transform(cfg, use_kernel=False)(torch.zeros(1, 1, SR)))
        return model, normalized_transform(make_transform(cfg, use_kernel=False), mean, std)

    audio = torch.from_numpy(_audio(2, SR, seed=4))
    model, transform = scorer()
    want = predict.make_score_fn(model, transform, "cpu")(audio)
    model, transform = scorer()
    for cache in (wpt._reflect_index_tensor, wpt.dec_kernel, wpt._gray_index_tensor,
                  stft._window, lfcc._matrices):
        cache.cache_clear()
    ep = export.export_scorer(model, transform, SR, "cpu")
    _equal(predict.make_score_fn(model, transform, "cpu")(audio), want)
    assert type(wpt.dec_kernel("sym5", "cpu")) is torch.Tensor
    # the graph reads the cached tensors as constants: it copies none per
    # call (on the card, a pageable copy to the device and a stream sync)
    copies = [n for n in ep.graph.nodes if "lift_fresh" in str(n.target)]
    assert not copies, copies


# -------------------------------------------------------------- refusals


def test_junk_is_not_an_artifact(tmp_path):
    path = tmp_path / "junk.adfx"
    path.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an ADFX"):
        export.load_artifact(str(path))


def test_a_jax_artifact_is_refused_by_name(tiny):
    with pytest.raises(ValueError, match="ADFX1.*ADFX-TORCH1"):
        export.load_artifact(tiny[2])


def test_chunk_needs_a_concrete_batch_it_divides(tiny):
    model, transform, _ = tiny
    with pytest.raises(ValueError, match="concrete batch_size"):
        export.export_scorer(model, transform, WIN, "cpu", chunk=2)
    with pytest.raises(ValueError, match="chunk=3 does not divide the batch of 4"):
        export.export_scorer(model, transform, WIN, "cpu", batch_size=4, chunk=3)


def test_cli_refuses_cuda_without_a_card(snapshot, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.adfx"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        export.main([snapshot, str(out), "--device", "cuda"])
    assert not os.path.exists(out)
