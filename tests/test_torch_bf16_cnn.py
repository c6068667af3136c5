"""The CNNs' bf16 mode (``dtype=torch.bfloat16``) against the JAX package's
bf16 models on the CPU.

The JAX models are built as its factory's ``_dtype_precision`` builds them
for ``dtype: bfloat16``: ``dtype=jnp.bfloat16``, ``precision=DEFAULT``.
Weights are JAX variables (random, with random BatchNorm running stats)
carried over by ``state_dict_from_jax``; inputs come from numpy with a seed.

The tolerance is a measured criterion, not a constant: the port's bf16
result must lie closer to the JAX bf16 result than a stated fraction of the
distance between the JAX bf16 and the JAX fp32 results on the same inputs
(bf16's own error).  Casts are mirrored, so what is left is the order of
the float32 sums inside each convolution; where such a sum lands on the
other side of a bf16 rounding boundary the difference is one ulp, and the
max-pools, MaxFeatureMaps and batch statistics behind it carry it on.
Each test states the distances it measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.models.dcnn import DCNN as JaxDCNN
from audiodeepfake_detection_tpu.models.lcnn import LCNN as JaxLCNN
from audiodeepfake_detection_tpu.train.predict import make_score_fn as jax_make_score_fn
from audiodeepfake_detection_tpu_torch.models import factory
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
from audiodeepfake_detection_tpu_torch.models.torch_import import state_dict_from_jax
from audiodeepfake_detection_tpu_torch.train.predict import make_score_fn
from audiodeepfake_detection_tpu_torch.utils.config import DotDict
from test_torch_dcnn import MID, SMALL, jax_variables

# what the JAX factory's _dtype_precision gives for dtype: bfloat16
JAX_BF16 = dict(dtype=jnp.bfloat16, precision=jax.lax.Precision.DEFAULT)
LCNN_SHAPE = (4, 1, 64, 37)  # lstm_channels 64 -> 128 features, 2 time steps

EVAL_CASES = {  # name: (JAX class, port class, constructor kwargs, input shape, kind)
    "DCNN": (JaxDCNN, DCNN, dict(SMALL["kw"]), SMALL["shape"], "dcnn"),
    "DCNNxDropout": (JaxDCNN, DCNN, dict(SMALL["kw"], with_dropout=False),
                     SMALL["shape"], "dcnn"),
    "DCNNxDilation": (JaxDCNN, DCNN, dict(SMALL["kw"], with_dilation=False,
                                          flattend_size=2048), SMALL["shape"], "dcnn"),
    "LCNN": (JaxLCNN, LCNN, dict(lstm_channels=64), LCNN_SHAPE, "lcnn"),
}


def _max_dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _rel_dist(tensors, want, ref) -> float:
    """Distance of a set of tensors (a state dict): the L2 norm of all
    their differences together over the L2 norm of ``ref``, the relative
    error of the whole vector."""
    def flat(d):
        return np.concatenate([np.asarray(d[k], np.float64).ravel() for k in want])

    return float(np.linalg.norm(flat(tensors) - flat(want)) / np.linalg.norm(flat(ref)))


def _variables(model, shape, seed):
    """``jax_variables``, and every PReLU slope drawn from [0.1, 0.4]: float32
    values that bf16 cannot hold (the initial 0.25 it can), so a slope
    rounded where the JAX model keeps it would show."""
    variables = jax_variables(model, shape, seed)
    rng = np.random.RandomState(seed + 200)
    for p in variables["params"].values():
        if "alpha" in p:
            p["alpha"] = np.float32(rng.uniform(0.1, 0.4))
    return variables


def _port(port_cls, kw, variables, kind):
    port = port_cls(**kw, dtype=torch.bfloat16)
    port.load_state_dict(state_dict_from_jax(variables, kind), strict=True)
    return port


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_eval_logits_and_scores_match_jax_bf16(name):
    """Eval logits of each bf16 model, and ``make_score_fn`` on the bf16
    model object against the JAX package's scorer.  Measured (max abs): the
    three DCNNs 0.0 from JAX bf16 (JAX bf16 to fp32: 3.0e-4, 3.0e-4,
    3.3e-3); the LCNN 4.9e-4 (1.1e-3: a few of its convolutions' float32
    sums, run in another order, round to the other bf16 neighbour)."""
    jcls, pcls, kw, shape, kind = EVAL_CASES[name]
    j32, j16 = jcls(**kw), jcls(**kw, **JAX_BF16)
    variables = _variables(j32, shape, seed=1)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want32, want = (np.asarray(jax.jit(m.apply)(variables, jnp.asarray(x))) for m in (j32, j16))
    port = _port(pcls, kw, variables, kind).eval()
    assert port.get_name() == name
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    bf16_error = _max_dist(want, want32)
    assert 1e-4 < bf16_error  # the bf16 mode is not float32
    assert _max_dist(got.numpy(), want) < 0.5 * bf16_error

    # the scorers: [B, 1, F * T] "audio" and a reshape for a transform
    audio = x.reshape(shape[0], 1, -1)
    jscore = jax_make_score_fn(j16, lambda a: a.reshape(shape), variables, output="margin")
    score = make_score_fn(port, lambda a: a.reshape(shape), "cpu", output="margin")
    got_margin = score(torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(got_margin, got.numpy()[:, 1] - got.numpy()[:, 0])
    want_margin = np.asarray(jscore(jnp.asarray(audio)))
    assert _max_dist(got_margin, want_margin) < 0.5 * _max_dist(want_margin,
                                                                   want32[:, 1] - want32[:, 0])


def _jax_train(jmodel, variables, x, kind):
    """Train-mode logits, moved BatchNorm buffers and the gradients of
    ``sum(logits**2)``, as port state dicts; traced once."""

    def loss_fn(params):
        out, updates = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out**2), (out, updates)

    (_, (out, updates)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    buffers = state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])}, kind)
    grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)}, kind)
    return np.asarray(out), buffers, grads


def _port_train(port, x):
    port.train()
    out = port(torch.from_numpy(x))
    out.square().sum().backward()
    buffers = {k: v for k, v in port.state_dict().items() if "running_" in k}
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    return out.detach().numpy(), buffers, grads


def _assert_train_close(got, want, ref, limits):
    """``got`` / ``want`` / ``ref``: (logits, buffers, gradients) of the
    port, the JAX bf16 model and the JAX fp32 model.  Each of the three
    distances from JAX bf16 must be below its fraction in ``limits`` of
    JAX bf16's distance from fp32."""
    (out, bufs, grads), (w_out, w_bufs, w_grads), (r_out, r_bufs, r_grads) = got, want, ref
    w_bufs = {k: w_bufs[k] for k in bufs}
    r_bufs = {k: r_bufs[k] for k in bufs}
    measured = {
        "logits": (_max_dist(out, w_out), _max_dist(w_out, r_out)),
        "buffers": (_rel_dist(bufs, w_bufs, r_bufs), _rel_dist(w_bufs, r_bufs, r_bufs)),
        "gradients": (_rel_dist(grads, w_grads, r_grads), _rel_dist(w_grads, r_grads, r_grads)),
    }
    for what, (port_dist, bf16_error) in measured.items():
        assert bf16_error > 0, what
        assert port_dist < limits[what] * bf16_error, (what, port_dist, bf16_error)


# DCNN with the dilated block (every kind of layer) and the LCNN, unfused,
# dropout 0 (the two frameworks' random streams cannot be equated)
TRAIN_CASES = {
    "dcnn": (JaxDCNN, DCNN, dict(SMALL["kw"], dropout_cnn=0.0, dropout_lstm=0.0),
             SMALL["shape"]),
    "lcnn": (JaxLCNN, LCNN, dict(lstm_channels=64, dropout=0.0), LCNN_SHAPE),
}
# Measured, port to JAX bf16 against JAX bf16 to fp32 (logits: max abs;
# buffers and gradients: the relative L2 distance of all of them together):
# dcnn logits 0.0 / 3.4e-2, buffers 7.7e-8 / 1.9e-4, gradients 6.4e-3 /
# 0.19; lcnn logits 2.2e-3 / 6.4e-3, buffers 2.8e-4 / 3.9e-4, gradients
# 0.22 / 0.38.  The LCNN's buffers and gradients lie at 0.73 and 0.57 of
# bf16's own error, not below half of it: in eval one value of the 73,728
# behind its second MaxFeatureMap differs by an ulp (its convolutions'
# float32 sums run in another order), 830 of the 8,192 behind its sixth, and
# in training the batch statistics spread such flips into every folded
# weight's rounding.  Its limit is bf16's own error.
TRAIN_LIMITS = {
    "dcnn": dict(logits=0.5, buffers=0.5, gradients=0.5),
    "lcnn": dict(logits=0.5, buffers=1.0, gradients=1.0),
}


@pytest.mark.parametrize("kind", sorted(TRAIN_CASES))
def test_train_logits_buffers_and_gradients_match_jax_bf16(kind):
    jcls, pcls, kw, shape = TRAIN_CASES[kind]
    j32, j16 = jcls(**kw), jcls(**kw, **JAX_BF16)
    variables = _variables(j32, shape, seed=5)
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    port = _port(pcls, kw, variables, kind)
    got = _port_train(port, x)
    _assert_train_close(got, _jax_train(j16, variables, x, kind),
                        _jax_train(j32, variables, x, kind), TRAIN_LIMITS[kind])
    for key, val in port.state_dict().items():
        assert val.dtype != torch.bfloat16, key  # parameters and buffers stay float32


ALL_FLAGS = dict(fused_layer1=True, fused_pool=True, fused_layer2=True)


def test_all_flags_dcnn_bf16_matches_the_jax_fused_bf16_model():
    """The DCNN with all three flags in bf16 training (the port's plain
    versions of kernels 2, 5 and 6) against the JAX DCNN with the same flags
    (its Pallas kernels in interpret mode, traced once).  bf16's own error
    is read against the JAX fp32 model without flags: with them it is the
    same function, and its trace costs no interpreted kernel."""
    kw = MID["kw"]
    jflag = JaxDCNN(**kw, **ALL_FLAGS, **JAX_BF16)
    variables = _variables(JaxDCNN(**kw), MID["shape"], seed=5)
    x = np.random.RandomState(6).randn(*MID["shape"]).astype(np.float32)
    port = _port(DCNN, dict(kw, **ALL_FLAGS), variables, "dcnn")
    got = _port_train(port, x)
    # measured: logits 0.0 / 5.6e-3, buffers 1.8e-8 / 2.2e-4, gradients
    # 2.3e-3 / 8.1e-2
    _assert_train_close(got, _jax_train(jflag, variables, x, "dcnn"),
                        _jax_train(JaxDCNN(**kw), variables, x, "dcnn"),
                        dict(logits=0.5, buffers=0.5, gradients=0.5))
    assert int(port.cnn[3].num_batches_tracked) == int(port.cnn[10].num_batches_tracked) == 8


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_fused_bf16_path_matches_the_unfused_bf16_path(mode):
    """The port's fused bf16 path against its unfused bf16 path (both on
    the CPU, the kernels' plain versions).  The fused blocks round once
    where the layers round after the convolution and again after the
    PReLU, so the two differ by bf16 roundings: measured 1.2e-2 (train) and
    2.0e-3 (eval) against bf16's own error of the unfused path, 1.5e-2 and
    4.7e-3; the limit is that error."""
    kw = MID["kw"]
    variables = _variables(JaxDCNN(**kw), MID["shape"], seed=9)
    x = torch.from_numpy(np.random.RandomState(10).randn(*MID["shape"]).astype(np.float32))
    flags = ALL_FLAGS if mode == "train" else {k: "always" for k in ALL_FLAGS}
    fused = _port(DCNN, dict(kw, **flags), variables, "dcnn")
    plain = _port(DCNN, kw, variables, "dcnn")
    ref = DCNN(**kw)
    ref.load_state_dict(state_dict_from_jax(variables, "dcnn"), strict=True)
    with torch.no_grad():
        got, want, want32 = (m.train(mode == "train")(x) for m in (fused, plain, ref))
    assert got.dtype == torch.float32
    assert 0 < _max_dist(got, want) < _max_dist(want, want32)


def test_factory_builds_bf16_cnns():
    """The grid model under ``dtype: bfloat16`` is float32:
    ``test_torch_gridmodel.py``."""
    base = dict(input_dim=[8, 1, 256, 95], flattend_size=320, time_dim_add=1,
                dtype="bfloat16")
    for module in ("DCNN", "DCNNxDropout", "DCNNxDilation"):
        extra = dict(flattend_size=2048) if module == "DCNNxDilation" else {}
        model = factory.get_model(DotDict(base, module=module, **extra), "modules")
        assert model.get_name() == module and model.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
    model = factory.get_model(DotDict(features="none", num_of_scales=256, dtype="bfloat16"),
                              "lcnn")
    assert isinstance(model, LCNN) and model.dtype == torch.bfloat16
    assert factory.get_model(DotDict(base, module="DCNN", dtype="float32"),
                             "modules").dtype is None
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        factory.get_model(DotDict(base, module="DCNN", dtype="float16"), "modules")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        DCNN(dtype=torch.float16)
