"""The port's AST against the JAX package's, at a test size.

Both ``_SIZES`` tables get a ``test32`` entry (embed 32, depth 2, 2 heads),
as the JAX package's own end-to-end AST test does; the input is a ``[B, 1, 64, 48]``
image (5 x 4 patches + the class and distillation tokens).  The JAX model
runs its einsum attention (its own tests hold that equal to the Pallas
kernel); JAX weights reach the port through ``state_dict_from_jax(...,
"ast")``.  Inputs come from numpy seeds.  Also here: the timm DeiT import,
the bf16-moment Adam against ``scale_by_adam_lowp``, and the factory.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiodeepfake_detection_tpu.models import ast as jax_ast
from audiodeepfake_detection_tpu.models.torch_import import export_state_dict
from audiodeepfake_detection_tpu.train.steps import scale_by_adam_lowp
from audiodeepfake_detection_tpu_torch.models import ast
from audiodeepfake_detection_tpu_torch.models.factory import get_model
from audiodeepfake_detection_tpu_torch.models.torch_import import (
    adam_state_from_jax,
    import_timm_deit,
    state_dict_from_jax,
)
from audiodeepfake_detection_tpu_torch.train.steps import AdamLowPrecisionMoments, make_optimizer
from audiodeepfake_detection_tpu_torch.utils.config import DotDict

TEST_SIZE = dict(embed_dim=32, depth=2, num_heads=2)
GEOMETRY = dict(input_fdim=64, input_tdim=48, model_size="test32")


@pytest.fixture(scope="module", autouse=True)
def test_size():
    """``test32`` in both ``_SIZES`` tables for the whole file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_ast._SIZES, "test32", TEST_SIZE)
        mp.setitem(ast._SIZES, "test32", TEST_SIZE)
        yield


@pytest.fixture(scope="module")
def jax_model():
    """The JAX AST (einsum attention), its variables with a non-trivial
    head and tokens, and a seeded batch."""
    model = jax_ast.ASTModel(**GEOMETRY)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 1, 64, 48).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    # nonzero tokens and head, so that every parameter is exercised
    for name in ("cls_token", "dist_token"):
        params[name] = 0.02 * rng.randn(*params[name].shape).astype(np.float32)
    params["head_norm"]["scale"] = 1.0 + 0.1 * rng.randn(32).astype(np.float32)
    return model, {"params": params}, x, np.asarray([0, 1, 1])


def _port_model(variables, **kw):
    model = ast.ASTModel(**GEOMETRY, **kw)
    model.load_state_dict(state_dict_from_jax(variables, "ast"), strict=True)
    return model


def _loss(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


def test_state_dict_is_the_reference_ast_layout(jax_model):
    _, variables, _, _ = jax_model
    model = ast.ASTModel(**GEOMETRY)
    want = export_state_dict(variables, "ast")
    assert set(model.state_dict()) == set(want)
    for key, val in state_dict_from_jax(variables, "ast").items():
        np.testing.assert_array_equal(val.numpy(), want[key])
        assert tuple(model.state_dict()[key].shape) == want[key].shape, key
    assert "v.patch_embed.proj.weight" in want and "mlp_head.1.weight" in want
    assert model.get_name() == "AST" and model.num_patches == 20


def test_eval_logits_match_jax(jax_model):
    model, variables, x, _ = jax_model
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = _port_model(variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_train_mode_first_step_gradients_match_jax(jax_model):
    model, variables, x, y = jax_model

    def loss_fn(params):
        return _loss(model.apply({"params": params}, jnp.asarray(x), train=True), y)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)}, "ast")
    port = _port_model(variables).train()
    loss = torch.nn.functional.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    for name, p in port.named_parameters():
        w = want[name]
        err = (p.grad - w).abs().max() / w.abs().max().clamp(min=1e-12)
        assert err.item() <= 1e-4, name


def test_fused_attention_and_remat_equal_the_plain_path_on_cpu(jax_model):
    """On the CPU the fused path is the plain version of kernel 4; with
    ``remat_blocks`` each block is recomputed in the backward."""
    _, variables, x, y = jax_model
    grads, losses = [], []
    for kw in (dict(), dict(fused_attention=True), dict(fused_attention=True, remat_blocks=True)):
        port = _port_model(variables, **kw).train()
        loss = torch.nn.functional.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in port.named_parameters()})
    for other, other_loss in zip(grads[1:], losses[1:]):
        assert other_loss == pytest.approx(losses[0], rel=1e-6)
        for name, g in grads[0].items():
            torch.testing.assert_close(other[name], g, rtol=1e-4, atol=1e-6, msg=name)


@pytest.mark.parametrize("policy", sorted(ast.REMAT_POLICIES))
def test_remat_policy_matches_plain_and_jax(jax_model, policy):
    """Each supported policy against no remat and against JAX's
    ``remat_policy`` model, with JAX's ``test_remat_policy_matches_plain``
    criteria: loss within 1e-6, gradients within 1e-4 (measured 0.0 against
    no remat on the CPU)."""
    model, variables, x, y = jax_model
    jmodel = jax_ast.ASTModel(**GEOMETRY, remat_policy=policy)

    def loss_fn(params):
        return _loss(jmodel.apply({"params": params}, jnp.asarray(x), train=True), y)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)}, "ast")
    results = []
    for kw in (dict(), dict(remat_policy=policy)):
        port = _port_model(variables, fused_attention=True, **kw).train()
        loss = torch.nn.functional.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        results.append((loss.item(), {n: p.grad for n, p in port.named_parameters()}))
    (plain_loss, plain), (loss, grads) = results
    assert abs(loss - plain_loss) < 1e-6 and abs(loss - float(jloss)) < 1e-6
    for name, g in grads.items():
        assert (g - plain[name]).abs().max().item() < 1e-4, name
        assert (g - want[name]).abs().max().item() < 1e-4, name


def test_remat_policy_keeps_what_it_names(jax_model):
    """The ops each policy leaves to the backward: counted as they run in
    the backward, the products of no remat (``mm`` for the Linears' gradients,
    ``bmm`` for the attention's einsums, kernel 4's plain version here) plus
    those the recomputation repeats (a Linear's forward is an ``addmm``).  ``everything_saveable`` repeats none;
    ``nothing_saveable`` every one."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    _, variables, x, y = jax_model

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for policy in (None, *ast.REMAT_POLICIES):
        port = _port_model(variables, fused_attention=True, remat_policy=policy).train()
        loss = torch.nn.functional.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y))
        with Count() as count:
            loss.backward()
        counts[policy] = (count.ops["mm"] + count.ops["addmm"], count.ops["bmm"])
    mm, bmm = counts[None]
    assert counts["everything_saveable"] == (mm, bmm)
    assert counts["nothing_saveable"][0] > mm and counts["nothing_saveable"][1] > bmm
    assert counts["dots_saveable"] == counts["checkpoint_dots"] == (mm, bmm)
    no_batch = counts["dots_with_no_batch_dims_saveable"]
    assert no_batch == counts["checkpoint_dots_with_no_batch_dims"]
    assert no_batch[0] == mm and no_batch[1] == counts["nothing_saveable"][1]


def test_bfloat16_mode_matches_the_jax_bf16_model(jax_model):
    """bf16 Dense / Conv from f32 weights, bf16 token stream, f32 head."""
    _, variables, x, _ = jax_model
    jmodel = jax_ast.ASTModel(**GEOMETRY, dtype=jnp.bfloat16,
                              precision=jax.lax.Precision.DEFAULT)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    port = _port_model(variables, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        h = port.embed(torch.from_numpy(x))
        got = port(torch.from_numpy(x))
    assert h.dtype == torch.bfloat16 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)
    assert all(p.dtype == torch.float32 for p in port.parameters())


@pytest.mark.parametrize(
    "geometry",
    [dict(input_fdim=128, input_tdim=100), dict(input_fdim=256, input_tdim=101),
     dict(input_fdim=100, input_tdim=200, fstride=8, tstride=12)],
    ids=["cut", "interpolate-freq", "interpolate-time"],
)
def test_import_timm_deit_matches_jax(geometry):
    """A synthetic timm DeiT dict (3-channel patch conv, 14 x 14 grid,
    ``module.`` prefix and ImageNet heads) through both importers."""
    rng = np.random.RandomState(5)
    d = TEST_SIZE["embed_dim"]
    state = {
        "patch_embed.proj.weight": rng.randn(d, 3, 16, 16), "patch_embed.proj.bias": rng.randn(d),
        "cls_token": rng.randn(1, 1, d), "dist_token": rng.randn(1, 1, d),
        "pos_embed": rng.randn(1, 2 + 14 * 14, d), "norm.weight": rng.randn(d),
        "norm.bias": rng.randn(d), "head.weight": rng.randn(1000, d),
        "head_dist.weight": rng.randn(1000, d),
    }
    for i in range(TEST_SIZE["depth"]):
        for name, shape in (("norm1", (d,)), ("norm2", (d,)), ("attn.qkv", (3 * d, d)),
                            ("attn.proj", (d, d)), ("mlp.fc1", (4 * d, d)),
                            ("mlp.fc2", (d, 4 * d))):
            state[f"blocks.{i}.{name}.weight"] = rng.randn(*shape)
            state[f"blocks.{i}.{name}.bias"] = rng.randn(shape[0])
    state = {"module." + k: torch.from_numpy(v.astype(np.float32)) for k, v in state.items()}
    geometry = dict(geometry, model_size="test32")
    got = import_timm_deit(state, **geometry)
    jparams = jax_ast.import_timm_deit(state, **geometry)["params"]
    want = export_state_dict({"params": jparams}, "ast")
    assert set(got) == set(want) and "mlp_head.0.weight" not in got
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), val, rtol=1e-6, atol=1e-6, err_msg=key)
    f_dim, t_dim = ast.ast_patch_grid(geometry.get("fstride", 10), geometry.get("tstride", 10),
                                      geometry["input_fdim"], geometry["input_tdim"])
    assert got["v.pos_embed"].shape == (1, 2 + f_dim * t_dim, d)
    # a trained AST passes through unchanged, its head included
    model = ast.ASTModel(**geometry)
    again = import_timm_deit(model.state_dict(), **geometry)
    assert set(again) == set(model.state_dict())
    for key, val in model.state_dict().items():
        assert torch.equal(again[key], val), key


def test_bf16_moment_adam_matches_scale_by_adam_lowp(jax_model):
    """Four steps from the same gradients: moments within one bf16 ulp,
    parameters within 1e-6 relative; the JAX state carries across.  The
    JAX update runs eagerly on purpose: compiled whole by ``jax.jit`` it
    rounds differently, and a parameter lay more than 1e-6 apart."""
    _, variables, _, _ = jax_model
    lr, wd = 4e-4, 1e-3
    tx = optax.chain(optax.add_decayed_weights(wd), scale_by_adam_lowp(), optax.scale(-lr))
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    port = _port_model(variables)
    opt = make_optimizer(port.parameters(), lr, wd, moment_dtype="bfloat16")
    assert isinstance(opt, AdamLowPrecisionMoments)
    rng = np.random.RandomState(7)
    for _ in range(4):
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32) * 0.01, params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = state_dict_from_jax({"params": grads}, "ast")
        for name, p in port.named_parameters():
            p.grad = tgrads[name]
        opt.step()
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, params)}, "ast")
    mu = state_dict_from_jax({"params": jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), opt_state[1].mu)}, "ast")
    for name, p in port.named_parameters():
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
        assert int(st["step"]) == 4
        torch.testing.assert_close(st["exp_avg"].float(), mu[name], rtol=2.0**-7, atol=0)
        torch.testing.assert_close(p.detach(), want[name], rtol=1e-6, atol=1e-9, msg=name)
    # the JAX state into a fresh optimizer, moments kept in bf16
    fresh = make_optimizer(port.parameters(), lr, wd, moment_dtype="bfloat16")
    adam_state_from_jax(port, fresh, 4, jax.tree.map(np.asarray, opt_state[1].mu),
                        jax.tree.map(np.asarray, opt_state[1].nu), layout="ast")
    for p in port.parameters():
        assert torch.equal(fresh.state[p]["exp_avg"], opt.state[p]["exp_avg"])
        assert fresh.state[p]["exp_avg_sq"].dtype == torch.bfloat16


def test_bf16_moments_survive_a_state_dict_round_trip():
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(5, 3))
    opt = make_optimizer([w], 1e-3, 1e-3, moment_dtype="bfloat16")
    w.grad = torch.randn(5, 3)
    opt.step()
    buf = io.BytesIO()  # through a file, as --resume reads it
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    blob = torch.load(buf, weights_only=True)
    w2 = torch.nn.Parameter(w.detach().clone())
    opt2 = make_optimizer([w2], 1e-3, 1e-3, moment_dtype="bfloat16")
    opt2.load_state_dict(blob)
    assert opt2.state[w2]["exp_avg"].dtype == torch.bfloat16
    g = torch.randn(5, 3)
    w.grad, w2.grad = g, g.clone()
    opt.step()
    opt2.step()
    assert torch.equal(w, w2)  # resume is bit-invisible
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make_optimizer([w], 1e-3, 0.0, moment_dtype="float16")


def test_factory_geometry_and_knobs():
    base = dict(input_dim=[8, 1, 64, 48], module="AST", flattend_size=48,
                ast_model_size="test32")
    model = get_model(DotDict(base), "modules")
    assert model.get_name() == "AST" and (model.input_fdim, model.input_tdim) == (64, 48)
    assert model.model_size == "test32" and model.label_dim == 2
    assert not model.fused_attention and not model.remat_blocks and model.dtype is None
    model = get_model(DotDict(base, module="ASTModel", flattend_size=None, dtype="bfloat16",
                              ast_fused_attention=True, ast_remat=True), "modules")
    assert model.input_tdim == 48 and model.fused_attention and model.remat_blocks
    assert model.dtype == torch.bfloat16
    assert ast.ast_patch_grid(10, 10, 256, 101) == (25, 9)  # the stft image [256, 101]
    with pytest.raises(RuntimeError, match="Model not valid"):
        get_model(DotDict(base, flattend_size=101), "modules")
    # the policy reaches the model and implies remat (JAX
    # tests/test_more_models.py::test_remat_and_fused_attention_knobs)
    model = get_model(DotDict(base, ast_remat_policy="dots_saveable"), "modules")
    assert model.remat_policy == "dots_saveable" and model.remat_blocks
    with pytest.raises(ValueError, match="supported jax.checkpoint_policies names"):
        get_model(DotDict(base, ast_remat_policy="save_only_these_names"), "modules")
    assert ast.ASTModel(**GEOMETRY, quant="calibrate").quant == "calibrate"  # int8 sites
    dcnn = get_model(DotDict(input_dim=[8, 1, 256, 95], module="DCNN", dtype="bfloat16",
                             flattend_size=320, time_dim_add=1), "modules")
    assert dcnn.get_name() == "DCNN" and dcnn.dtype == torch.bfloat16


def test_initialisation_follows_flax():
    torch.manual_seed(0)
    model = ast.ASTModel(**GEOMETRY)
    v = model.v
    assert not v.cls_token.any() and not v.dist_token.any()
    assert v.pos_embed.abs().max() <= 0.04 and 0.01 < v.pos_embed.std() < 0.02
    w = v.blocks[0].mlp.fc1.weight  # lecun normal: std sqrt(1 / fan_in)
    assert w.std().item() == pytest.approx((1 / 32) ** 0.5, rel=0.1)
    assert w.abs().max() <= 2 * (1 / 32) ** 0.5 / 0.87962566103423978
    assert not v.blocks[0].attn.qkv.bias.any()
    assert torch.equal(v.norm.weight, torch.ones(32)) and model.mlp_head[0].eps == 1e-5
    assert v.blocks[0].norm1.eps == 1e-6
