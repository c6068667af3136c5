"""Port LCNN (layers, model, weight converter, train step) vs the JAX
package on the CPU.

JAX variables are randomly initialised, their BatchNorm running stats
replaced with random values, and carried to the port through
``state_dict_from_jax(..., "lcnn")``.  With ``fused_layer1`` the JAX model
runs its Pallas kernels in interpret mode and the port its plain first
block.  Dropout is 0 on both sides wherever the model runs in train mode:
the two frameworks' random streams cannot be equated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiodeepfake_detection_tpu.models import layers as jlayers
from audiodeepfake_detection_tpu.models.lcnn import LCNN as JaxLCNN
from audiodeepfake_detection_tpu.models.torch_import import export_state_dict
from audiodeepfake_detection_tpu.models.torch_import import import_lcnn as jax_import_lcnn
from audiodeepfake_detection_tpu.train import steps as jsteps
from audiodeepfake_detection_tpu_torch.models.layers import BLSTMLayer, MaxFeatureMap2D
from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
from audiodeepfake_detection_tpu_torch.models.torch_import import (
    adam_state_from_jax,
    import_lcnn,
    state_dict_from_jax,
)
from audiodeepfake_detection_tpu_torch.train import steps as tsteps
from test_torch_dcnn import jax_variables

# logits: fp32 convolutions and two BLSTMs in two frameworks (JAX at HIGHEST
# with folded BN, the port with BN then conv); sums differ in order only.
# Measured at logits of ~0.1: at most 7.5e-8 in eval and 1.2e-6 in train mode.
RTOL, ATOL = 1e-4, 1e-5
LR, WD = 4e-4, 1e-3
SMALL = (4, 1, 64, 37)  # [B, C, F, T]: lstm_channels 64 -> 128 features, 2 time steps


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_max_feature_map_matches_jax():
    x = np.random.RandomState(0).randn(2, 6, 5, 4).astype(np.float32)  # NCHW
    want = np.asarray(jlayers.max_feature_map_2d(jnp.asarray(x.transpose(0, 2, 3, 1))))
    got = MaxFeatureMap2D()(torch.from_numpy(x))
    assert got.shape == (2, 3, 5, 4)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))
    with pytest.raises(ValueError, match="even channel count"):
        MaxFeatureMap2D()(torch.zeros(1, 3, 2, 2))


def test_blstm_layer_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 32).astype(np.float32)
    jlayer = jlayers.BLSTMLayer(32, 32)
    params = jax.tree.map(np.asarray, jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jlayer.apply(params, jnp.asarray(x)))
    layer = BLSTMLayer(32, 32)
    state = state_dict_from_jax({"params": {"lstm_0": params["params"]}}, "lcnn")
    layer.load_state_dict({k[len("lstm.0."):]: v for k, v in state.items()}, strict=True)
    got = layer(torch.from_numpy(x))
    assert got.shape == want.shape == (3, 7, 32)
    # 7 recurrent steps of fp32 products and sigmoids: measured 1.2e-7
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    # gradients through the recurrence
    g = rng.randn(3, 7, 32).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jlayer.apply(p, jnp.asarray(x)) * g))(params)
    want_g = state_dict_from_jax({"params": {"lstm_0": jax.tree.map(np.asarray, jgrads)["params"]}}, "lcnn")
    got.backward(torch.from_numpy(g))
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want_g["lstm.0." + name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="must be even"):
        BLSTMLayer(8, 7)


CASES = [  # (lstm_channels, image shape, fused_layer1)
    (256, (2, 1, 256, 101), False),
    (256, (2, 1, 256, 101), "always"),
    (20, (2, 1, 20, 101), "always"),
    (64, SMALL, False),
    (64, SMALL, "always"),
]


def _pair(lstm_channels, shape, fused, seed=0):
    jmodel = JaxLCNN(lstm_channels=lstm_channels, fused_layer1=fused, dropout=0.0)
    variables = jax_variables(jmodel, shape, seed)
    port = LCNN(lstm_channels=lstm_channels, fused_layer1=fused, dropout=0.0)
    port.load_state_dict(state_dict_from_jax(variables, "lcnn"), strict=True)
    return jmodel, variables, port


@pytest.mark.parametrize("lstm_channels,shape,fused", CASES)
def test_eval_and_train_logits_match_jax(lstm_channels, shape, fused):
    jmodel, variables, port = _pair(lstm_channels, shape, fused)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    # jitted: one compilation instead of one per primitive
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, x))
    port.eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (shape[0], 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    want, updates = jax.jit(lambda v, a: jmodel.apply(
        v, a, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)},
    ))(variables, x)
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    carried = state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])}, "lcnn")
    for key, val in port.state_dict().items():
        if "running_" in key or "num_batches" in key:
            np.testing.assert_allclose(
                val.numpy(), carried[key].numpy(), rtol=1e-4, atol=1e-5, err_msg=key)
    assert int(port.lcnn[5].num_batches_tracked) == 8


def test_flatten_order_is_channels_then_frequency():
    """With F' > 1 the per-step features are (32 channels, F') flattened in
    that order: swapping two frequency rows of the last activation must
    change the logits like the same swap does in JAX."""
    jmodel, variables, port = _pair(64, SMALL, False, seed=1)
    x = np.random.RandomState(3).randn(*SMALL).astype(np.float32)
    flipped = x[:, :, ::-1].copy()  # reverse the frequency axis
    port.eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(flipped)).numpy()
        straight = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(flipped), train=False))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(got - straight).max() > 1e-3


def test_state_dict_is_the_reference_layout():
    jmodel, variables, port = _pair(64, SMALL, False, seed=2)
    want = export_state_dict(variables, "lcnn")
    got = state_dict_from_jax(variables, "lcnn")
    assert list(got) == list(want) and set(got) == set(port.state_dict())
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
        assert got[key].dtype == torch.from_numpy(np.array(want[key])).dtype
    assert "lstm.1.l_blstm.bias_hh_l0_reverse" in got and "fc.weight" in got
    assert got["lcnn.5.num_batches_tracked"].dtype == torch.int64
    # and back through the JAX importer
    back = jax_import_lcnn({k: v.numpy() for k, v in port.state_dict().items()})
    np.testing.assert_array_equal(
        back["params"]["lstm_1"]["w_hh_bw"], variables["params"]["lstm_1"]["w_hh_bw"])


def test_import_lcnn_round_trip_and_kind_order():
    _, variables, port = _pair(64, SMALL, False, seed=3)
    state = state_dict_from_jax(variables, "lcnn")
    # DDP prefixes and shifted Sequential indices: matched by ordered kinds
    shifted = {}
    for key, val in state.items():
        block, _, rest = key.partition(".")
        if block == "lcnn":
            idx, _, name = rest.partition(".")
            key = f"lcnn.{int(idx) + 2}.{name}"
        shifted["module.module." + key] = val
    back = import_lcnn(shifted)
    assert set(back) == set(state)
    for key in state:
        torch.testing.assert_close(back[key], state[key], rtol=0, atol=0)
    port.load_state_dict(back, strict=True)
    bad = dict(state)
    bad["lcnn.5.weight"] = torch.zeros(4, 4, 1, 1)  # a conv where a BatchNorm belongs
    for key in [k for k in bad if k.startswith("lcnn.5.running") or k.startswith("lcnn.5.num")]:
        del bad[key]
    with pytest.raises(ValueError, match="kind mismatch"):
        import_lcnn(bad)
    with pytest.raises(ValueError, match="no 'lstm' block"):
        import_lcnn({k: v for k, v in state.items() if not k.startswith("lstm.")})
    with pytest.raises(ValueError, match="unexpected LCNN blocks"):
        import_lcnn({**state, "cnn.0.weight": torch.zeros(1)})


def test_constructor_refuses_what_the_fused_block_cannot_take():
    with pytest.raises(ValueError, match="in_channels == 1"):
        LCNN(in_channels=2, fused_layer1=True)
    with pytest.raises(ValueError, match="False, True or 'always'"):
        LCNN(fused_layer1="sometimes")
    assert LCNN(in_channels=2).get_name() == "LCNN"


def test_width_mismatch_raises_with_the_numbers():
    """``features=delta`` builds the LCNN for 40 frequency rows (the
    reference's rule) while the delta image still has 20: the JAX model
    fails in its first BLSTM product, the port says which numbers disagree."""
    x = np.zeros((1, 1, 20, 101), np.float32)
    with pytest.raises(ValueError, match="lstm_channels=40 .64 features.*leaves 32"):
        LCNN(lstm_channels=40)(torch.from_numpy(x))
    with pytest.raises(Exception):
        JaxLCNN(lstm_channels=40).init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)


def _batches(n, seed, shape=SMALL):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape).astype(np.float32), rs.randint(0, 3, shape[0]).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("fused", [False, True])
def test_first_step_gradients_match_jax(fused):
    jmodel, variables, port = _pair(64, SMALL, fused, seed=4)
    (x, labels), = _batches(1, seed=5)
    y = (labels != 0).astype(np.int32)

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)},
        )
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)}, "lcnn")
    port.train()
    loss = torch.nn.functional.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    # relative l2 per parameter; measured at most 5.7e-5 (loss 5e-7 apart)
    for name, p in port.named_parameters():
        assert _rel_l2(p.grad.numpy(), want[name].numpy()) <= 5e-3, name


@pytest.mark.parametrize("fused", [False, True])
def test_four_step_trajectory_matches_jax(fused):
    steps = 4
    jmodel, variables, port = _pair(64, SMALL, fused, seed=5)
    batches = _batches(steps, seed=6)
    tx = jsteps.make_optimizer(LR, WD)
    state = jsteps.create_train_state(jmodel, tx, batches[0][0], variables=variables)
    jstep = jsteps.make_train_step(jmodel, lambda a: a, tx)
    want = []
    for x, labels in batches:
        state, s = jstep(state, {"audio": x, "label": labels})
        want.append(float(s["loss"]))
    optimizer = tsteps.make_optimizer(port.parameters(), LR, WD)
    tstep = tsteps.make_train_step(port, lambda a: a, optimizer)
    got = [tstep({"audio": torch.from_numpy(x), "label": torch.from_numpy(labels)})["loss"].item()
           for x, labels in batches]
    np.testing.assert_allclose(got, want, rtol=5e-4)
    final = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, state.params),
         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}, "lcnn")
    # near-zero gradients make m/sqrt(v) sign-noisy across frameworks:
    # elementwise drift up to ~2*lr per step while the loss stays tight
    for key, val in port.state_dict().items():
        g, w = val.numpy(), final[key].numpy()
        if key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif "running_" in key:
            assert _rel_l2(g, w) <= 1e-3, key
        else:
            assert np.abs(g - w).max() <= 2 * steps * LR, key

    # the Adam state of the JAX run installs under the LCNN's names
    adam = state.opt_state[1]
    mu, nu = jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu)
    fresh = tsteps.make_optimizer(port.parameters(), LR, WD)
    adam_state_from_jax(port, fresh, int(adam.count), mu, nu, layout="lcnn")
    carried = fresh.state_dict()["state"]
    names = [n for n, _ in port.named_parameters()]
    assert len(carried) == len(names) == 18 + 16 + 2
    i = names.index("lstm.1.l_blstm.bias_hh_l0_reverse")
    np.testing.assert_array_equal(carried[i]["exp_avg"].numpy(), mu["lstm_1"]["b_hh_bw"])
    assert float(carried[i]["step"]) == steps


def test_whole_slice_audio_to_adam_matches_jax():
    """One seed -> audio -> stft -> normalize -> LCNN -> loss -> Adam, four
    steps, through both packages' ``make_transform`` and
    ``make_train_step``: num_of_scales 64 (n_fft 127), hop 50, 4000 samples
    -> ``[B, 1, 64, 80]``."""
    from audiodeepfake_detection_tpu.train import transforms as jtransforms
    from audiodeepfake_detection_tpu.utils.config import default_config as jax_default_config
    from audiodeepfake_detection_tpu_torch.train import transforms as ttransforms
    from audiodeepfake_detection_tpu_torch.utils.config import default_config

    steps, shape = 4, (4, 1, 64, 80)
    cfg = dict(transform="stft", num_of_scales=64, hop_length=50, power=2.0, log_scale=True)
    targs, jargs = default_config(), jax_default_config()
    targs.update(cfg)
    jargs.update(cfg)
    mean, std = np.asarray([-2.0], np.float32), np.asarray([2.5], np.float32)
    jtransform = jtransforms.normalized_transform(jtransforms.make_transform(jargs), mean, std)
    ttransform = ttransforms.normalized_transform(ttransforms.make_transform(targs), mean, std)
    rs = np.random.RandomState(7)
    batches = [((0.3 * rs.randn(4, 1, 4000)).astype(np.float32), rs.randint(0, 3, 4).astype(np.int32))
               for _ in range(steps)]
    image = ttransform(torch.from_numpy(batches[0][0]))
    assert image.shape == shape
    # the log image: the tolerance of log(x + 1e-12) near empty bins
    np.testing.assert_allclose(
        image.numpy(), np.asarray(jtransform(jnp.asarray(batches[0][0]))), rtol=1e-3, atol=5e-3)

    # unfused here: the fused trajectory is held on images above
    jmodel, variables, port = _pair(64, shape, False, seed=6)
    tx = jsteps.make_optimizer(LR, WD)
    state = jsteps.create_train_state(jmodel, tx, np.zeros(shape, np.float32), variables=variables)
    jstep = jsteps.make_train_step(jmodel, jtransform, tx)
    tstep = tsteps.make_train_step(port, ttransform, tsteps.make_optimizer(port.parameters(), LR, WD))
    want, got = [], []
    for x, labels in batches:
        state, s = jstep(state, {"audio": x, "label": labels})
        want.append(float(s["loss"]))
        got.append(tstep({"audio": torch.from_numpy(x), "label": torch.from_numpy(labels)})["loss"].item())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)  # before any update
    np.testing.assert_allclose(got, want, rtol=5e-4)
    final = state_dict_from_jax({"params": jax.tree.map(np.asarray, state.params)}, "lcnn")
    for name, p in port.named_parameters():
        assert np.abs(p.detach().numpy() - final[name].numpy()).max() <= 2 * steps * LR, name
