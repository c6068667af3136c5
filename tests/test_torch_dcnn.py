"""Port DCNN family + weight converter vs the JAX reference (CPU).

JAX variables are randomly initialised and their BatchNorm running stats
replaced with random values (so BN is not the identity); the same
variables reach the port through ``state_dict_from_jax``.  Inputs are made
with numpy from a seed and fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.models.dcnn import DCNN as JaxDCNN
from audiodeepfake_detection_tpu.models.torch_import import export_state_dict
from audiodeepfake_detection_tpu_torch.models.dcnn import (
    DCNN,
    DCNNxDilation,
    DCNNxDropout,
)
from audiodeepfake_detection_tpu_torch.models.torch_import import (
    import_dcnn,
    state_dict_from_jax,
)

# eval logits: fp32 convolutions in two frameworks (JAX at HIGHEST with
# folded BN, the port with BN then conv); sums differ in order only
RTOL = ATOL = 1e-4

# the small dry-run geometry of __graft_entry__.dryrun_multichip: haar
# level 8 over 2048 samples -> [B, 1, 256, 8], time_dim 1
SMALL = dict(
    kw=dict(time_dim=1, ochannels1=8, ochannels2=8, ochannels3=12,
            ochannels4=16, ochannels5=4),
    shape=(2, 1, 256, 8),
)
# full width: 1 s of sym5 level 8 -> [B, 1, 256, 95], time_dim 12
FULL = dict(kw=dict(time_dim=12), shape=(2, 1, 256, 95))

VARIANTS = {
    "DCNN": ({}, DCNN),
    "DCNNxDropout": ({"with_dropout": False}, DCNNxDropout),
    "DCNNxDilation": ({"with_dilation": False, "flattend_size": 2048}, DCNNxDilation),
}


@pytest.fixture(autouse=True)
def _no_tf32():
    # no TF32 on the CPU; stated anyway for the fp32 parity contract
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


def jax_variables(model, shape, seed=0):
    """Random init, then random BN running stats (numpy, from ``seed``)."""
    variables = model.init(
        jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32), train=False
    )
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.RandomState(seed + 100)
    for stats in variables["batch_stats"].values():
        c = stats["mean"].shape[0]
        stats["mean"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        stats["num_batches_tracked"] = np.asarray(7, np.int32)
    for name, p in variables["params"].items():
        if "scale" in p:  # affine BN of the dilated block
            c = p["scale"].shape[0]
            p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    return variables


def _jax_logits(model, variables, x):
    return np.asarray(model.apply(variables, jnp.asarray(x), train=False))


def _port_logits(model, x):
    model.eval()
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def test_state_dict_from_jax_equals_export():
    model = JaxDCNN(**SMALL["kw"])
    variables = jax_variables(model, SMALL["shape"])
    want = export_state_dict(variables, "dcnn")
    got = state_dict_from_jax(variables)
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == torch.from_numpy(np.array(val)).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)
    assert got["cnn.3.num_batches_tracked"].dtype == torch.int64


@pytest.mark.parametrize("prefix", ["", "module.module."])
def test_load_state_dict_strict(prefix):
    model = JaxDCNN(**SMALL["kw"])
    state = state_dict_from_jax(jax_variables(model, SMALL["shape"]))
    port = DCNN(**SMALL["kw"])
    port.load_state_dict(
        import_dcnn({prefix + k: v for k, v in state.items()}), strict=True
    )
    if not prefix:
        port.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(
        port.cnn[0].weight.detach().numpy(), state["cnn.0.weight"].numpy()
    )


def test_import_dcnn_matches_layers_by_kind_order():
    """An older Sequential arrangement (other indices, same kind order) is
    re-keyed onto the port's indices (the bundled coif4 checkpoint)."""
    model = JaxDCNN(**SMALL["kw"])
    state = state_dict_from_jax(jax_variables(model, SMALL["shape"]))
    shifted = {}
    for key, val in state.items():
        block, idx, rest = key.split(".", 2)
        shifted[f"{block}.{int(idx) * 2 + 5}.{rest}"] = val
    back = import_dcnn(shifted)
    assert set(back) == set(state)
    for key in state:
        assert torch.equal(back[key], state[key])
    bad = dict(state)
    bad["cnn.1.weight"] = torch.zeros(3, 3, 3, 3)
    with pytest.raises(ValueError, match="kind mismatch"):
        import_dcnn(bad)


@pytest.mark.parametrize(
    "variant,geometry",
    [(v, "small") for v in sorted(VARIANTS)] + [("DCNN", "full")],
)
def test_eval_logits_match_jax(variant, geometry):
    geo = SMALL if geometry == "small" else FULL
    extra, ctor = VARIANTS[variant]
    kw = {**geo["kw"], **extra}
    jmodel = JaxDCNN(**kw)
    variables = jax_variables(jmodel, geo["shape"], seed=1)
    x = np.random.RandomState(2).randn(*geo["shape"]).astype(np.float32)
    want = _jax_logits(jmodel, variables, x)

    port_kw = {k: v for k, v in kw.items() if k not in ("with_dropout", "with_dilation")}
    port = ctor(**port_kw)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert port.get_name() == variant
    got = _port_logits(port, x)
    assert got.shape == want.shape == (geo["shape"][0], 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flattend_size_mismatch_raises():
    port = DCNN(**SMALL["kw"], flattend_size=321)
    with pytest.raises(ValueError, match="flattend_size=321"):
        _port_logits(port, np.zeros(SMALL["shape"], np.float32))


def test_load_torch_state_dict_reference_format(tmp_path):
    """``{"MODEL_STATE": ...}`` with DDP's ``module.module.`` prefixes."""
    from audiodeepfake_detection_tpu_torch.models.torch_import import (
        load_torch_state_dict,
    )

    model = JaxDCNN(**SMALL["kw"])
    state = state_dict_from_jax(jax_variables(model, SMALL["shape"]))
    path = tmp_path / "snap.pt"
    torch.save(
        {"MODEL_STATE": {"module.module." + k: v for k, v in state.items()},
         "EPOCHS_RUN": 3},
        path,
    )
    loaded = load_torch_state_dict(str(path))
    assert set(loaded) == set(state)
    port = DCNN(**SMALL["kw"])
    port.load_state_dict(loaded, strict=True)


# ---------------------------------------------- the fused mid blocks
# narrow widths, no dilated block: [2, 1, 32, 24] reaches the second pool as
# 13 x 17 (odd both ways) and the third as 6 x 8
MID = dict(
    kw=dict(with_dilation=False, flattend_size=256, ochannels1=8, ochannels2=8,
            ochannels3=12, ochannels4=16, ochannels5=8, dropout_cnn=0.0),
    shape=(2, 1, 32, 24),
)
MID_FLAGS = {
    "pool": dict(fused_pool="always"),
    "layer2": dict(fused_layer2="always"),
    "both": dict(fused_pool="always", fused_layer2="always"),
}


def _mid_pair(flags, seed=3):
    """The JAX DCNN (its Pallas kernels in interpret mode) and the port
    (plain versions on the CPU) with the same flags and weights."""
    jmodel = JaxDCNN(**MID["kw"], **flags)
    variables = jax_variables(jmodel, MID["shape"], seed=seed)
    port = DCNN(**{k: v for k, v in MID["kw"].items() if k != "with_dilation"},
                with_dilation=False, **flags)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.RandomState(seed + 1).randn(*MID["shape"]).astype(np.float32)
    return jmodel, variables, port, x


@pytest.mark.parametrize("flags", sorted(MID_FLAGS))
def test_fused_mid_blocks_eval_logits_match_jax(flags):
    jmodel, variables, port, x = _mid_pair(MID_FLAGS[flags])
    # the same layers in fp32 on both sides, sums in another order
    np.testing.assert_allclose(
        _port_logits(port, x), _jax_logits(jmodel, variables, x), rtol=0, atol=1e-5)


# "layer2" alone differs from "both" by the third pool only, and tracing the
# JAX model with its kernels in interpret mode takes ~20 s: not repeated here
@pytest.mark.parametrize("flags", ["pool", "both"])
def test_fused_mid_blocks_train_logits_buffers_and_gradients_match_jax(flags):
    jmodel, variables, port, x = _mid_pair(MID_FLAGS[flags], seed=5)

    def loss_fn(params):
        out, updates = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out**2), (out, updates)

    # traced once: the Pallas kernels in interpret mode are slow to trace
    (_, (want, updates)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    port.train()
    got = port(torch.from_numpy(x))
    got.square().sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    carried = state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])})
    for key, val in port.state_dict().items():
        if "running_" in key or "num_batches" in key:
            np.testing.assert_allclose(
                val.numpy(), carried[key].numpy(), rtol=0, atol=1e-5, err_msg=key)
    assert int(port.cnn[6].num_batches_tracked) == int(port.cnn[10].num_batches_tracked) == 8
    want_grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("flags", sorted(MID_FLAGS))
def test_fused_mid_blocks_train_only_flag_is_unfused_in_eval(flags):
    """``True`` runs the fused blocks in training only: in eval the model is
    the plain ``nn.Sequential``, bit for bit."""
    train_only = {k: True for k in MID_FLAGS[flags]}
    _, variables, plain, x = _mid_pair({}, seed=7)
    fused = DCNN(**{k: v for k, v in MID["kw"].items()}, **train_only)
    fused.load_state_dict(plain.state_dict(), strict=True)
    np.testing.assert_array_equal(_port_logits(fused, x), _port_logits(plain, x))
    fused.train()
    plain.train()
    got, want = fused(torch.from_numpy(x)), plain(torch.from_numpy(x))
    # in training the flagged model leaves the Sequential: close, not equal
    assert not torch.equal(got, want)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=1e-5)


def test_every_state_dict_loads_under_every_flag():
    """The flags add no parameter and no buffer."""
    kw = {k: v for k, v in MID["kw"].items()}
    keys = set(DCNN(**kw).state_dict())
    model = JaxDCNN(**MID["kw"], fused_layer2="always")
    from_jax = state_dict_from_jax(jax_variables(model, MID["shape"]))
    assert set(from_jax) == keys
    for flags in ({}, *MID_FLAGS.values(), dict(fused_pool=True, fused_layer2=True)):
        port = DCNN(**kw, **flags)
        assert set(port.state_dict()) == keys
        port.load_state_dict(from_jax, strict=True)
        port.load_state_dict(import_dcnn({"module." + k: v for k, v in from_jax.items()}),
                             strict=True)
    with pytest.raises(ValueError, match="fused_pool must be False, True or 'always'"):
        DCNN(**kw, fused_pool="sometimes")
