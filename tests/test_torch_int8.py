"""The port's post-training int8 path against the JAX package's, on the CPU.

Inputs come from numpy seeds; the port's seeded weights reach the JAX
models through the JAX package's own ``.pt`` importers.  No Pallas kernel runs here (the JAX int8 path
has none, and the JAX models run unfused).  On the CPU the port's int8
convolution is its plain version (a float64 convolution of the codes,
exact), so the mechanics (codes, weight records, convolutions at every
site kind, dense products) must read 0.0 against XLA's s8 convolution and
s8 dot.  Those JAX functions run op by op, as written: under ``jax.jit``
XLA's algebraic simplifier folds the constant activation scale into the
weight scales' division by 127, which moves the dequantized output by one
float32 ulp in ~6 % of the values (measured at the 1x1 site).  The whole
JAX models are traced once each (``jax.jit``).

Whole models differ from JAX int8 where their float paths differ (BatchNorm
scale rounding, summation order), which moves a few codes by one step; the
criterion there is measured: the port's int8 logits, given JAX's scales,
lie closer to JAX int8 than half of JAX int8's own distance from JAX fp32
(the bf16 port's criterion).  The metric gate is the JAX package's
(``tests/test_int8_quality.py``): after int8, accuracy and EER within 0.02
of fp32 and P(fake) within 0.1, on tiny models trained here with the
port's own train step.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.models import ast as jax_ast
from audiodeepfake_detection_tpu.models.dcnn import DCNN as JaxDCNN
from audiodeepfake_detection_tpu.models.lcnn import LCNN as JaxLCNN
from audiodeepfake_detection_tpu.models import torch_import as jax_import
from audiodeepfake_detection_tpu.ops import quantize as jq
from audiodeepfake_detection_tpu_torch.models import ast
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
from audiodeepfake_detection_tpu_torch.models.regression import Regression
from audiodeepfake_detection_tpu_torch.ops import int8_conv_cuda
from audiodeepfake_detection_tpu_torch.ops import quantize as pq
from audiodeepfake_detection_tpu_torch.ops.int8_conv import int8_conv, int8_conv_site
from audiodeepfake_detection_tpu_torch.train import predict
from audiodeepfake_detection_tpu_torch.train.metrics import calculate_eer
from audiodeepfake_detection_tpu_torch.train.serve import service_from_snapshot
from audiodeepfake_detection_tpu_torch.train.steps import make_optimizer, make_train_step
from audiodeepfake_detection_tpu_torch.utils.config import default_config
from audiodeepfake_detection_tpu_torch.utils.naming import experiment_model_file
from test_torch_slice import _pcm, _wav_bytes

# the narrow DCNN of the JAX package's int8 gate (test_int8_quality.py:150)
NARROW = dict(ochannels1=8, ochannels2=8, ochannels3=12, ochannels4=16, ochannels5=4,
              time_dim=12, flattend_size=320)
DCNN_SHAPE = (3, 1, 256, 95)
LCNN_KW, LCNN_SHAPE = dict(lstm_channels=64), (3, 1, 64, 37)
AST_SIZE = dict(embed_dim=32, depth=2, num_heads=2)
AST_KW, AST_SHAPE = dict(input_fdim=64, input_tdim=48, model_size="test32"), (3, 1, 64, 48)
# JAX's int8 budget (test_int8_quality.py:209-211)
ACC_BUDGET, EER_BUDGET, P_BUDGET = 0.02, 0.02, 0.1


@pytest.fixture(scope="module", autouse=True)
def test_size():
    """``test32`` in both AST ``_SIZES`` tables for the whole file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_ast._SIZES, "test32", AST_SIZE)
        mp.setitem(ast._SIZES, "test32", AST_SIZE)
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread for the whole file: the suite runs several
    workers on the same cores, and PyTorch's intra-op threads of each then
    contend (the two training tests took 139 s and 255 s that way, a few
    seconds alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(got: torch.Tensor, want) -> None:
    """Bit-equal, whatever the type (bf16 read through float32)."""
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_quantize_activation_is_jax_bit_for_bit():
    """Half cases round to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2), beyond
    +-127 clips; random fp32 and bf16 inputs give JAX's codes."""
    x = np.asarray([0.25, 0.75, 1.25, -0.25, -1.25, 63.75, -70.0, 100.0, 0.0], np.float32)
    got = pq.quantize_activation(torch.from_numpy(x), 0.5)
    want = np.asarray(jq.quantize_activation(jnp.asarray(x), 0.5))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [0, 2, 2, 0, -2, 127, -127, 127, 0])
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6, 5, 7).astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0 * 0.8  # clips the top of the range
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dt)
        want = np.asarray(jq.quantize_activation(jnp.asarray(x).astype(jdt), scale))
        np.testing.assert_array_equal(pq.quantize_activation(xt, scale).numpy(), want)
        nhwc = pq.quantize_activation_nhwc(xt, scale)
        assert nhwc.is_contiguous() and nhwc.shape == (4, 5, 7, 6)
        np.testing.assert_array_equal(nhwc.numpy(), want.transpose(0, 2, 3, 1))


def test_weight_records_are_jax_bit_for_bit():
    """Per-output-channel conv records (OIHW here, HWIO in JAX) and dense
    records (``[Out, In]`` here, ``[In, Out]`` in JAX), a zero channel too."""
    rng = np.random.RandomState(1)
    w = rng.randn(6, 5, 3, 3).astype(np.float32)
    w[2] = 0.0  # absmax 0: the 1e-30 floor
    w_q, s_w = pq.quantize_weight_per_channel(torch.from_numpy(w))
    jw_q, js_w = jq.quantize_weight_per_channel(jnp.asarray(w.transpose(2, 3, 1, 0)))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js_w))
    rec = pq.conv_int8_weights(torch.from_numpy(w))
    assert torch.equal(rec["w_q"], w_q) and torch.equal(rec["s_w"], s_w)
    kernel = rng.randn(24, 16).astype(np.float32)  # flax [In, Out]
    rec = pq.dense_int8_weights(torch.from_numpy(kernel.T.copy()))
    jrec = jq.dense_int8_weights(jnp.asarray(kernel))
    np.testing.assert_array_equal(rec["w_q"].numpy(), np.asarray(jrec["w_q"]).T)
    np.testing.assert_array_equal(rec["s_w"].numpy(), np.asarray(jrec["s_w"]))


# (Cin, Cout, k, padding, dilation, H, W): one geometry per site kind
SITE_KINDS = {
    "cin1-3x3-pad2": (1, 8, 3, 2, 1, 11, 13),   # cnn_0
    "1x1": (8, 16, 1, 0, 1, 6, 9),               # cnn_4, lcnn_3, lcnn_10, ...
    "3x3": (16, 24, 3, 1, 1, 7, 10),             # cnn_7 .. cnn_17
    "cin1-5x5-pad2": (1, 16, 5, 2, 1, 12, 9),    # lcnn_0
    "cin48-3x3": (48, 32, 3, 1, 1, 5, 6),        # lcnn_13
    "dil2-5x5": (12, 12, 5, 2, 2, 9, 8),         # dil_4
    "dil4-7x7": (12, 12, 7, 2, 4, 30, 28),       # dil_7
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(SITE_KINDS))
def test_quantized_conv_is_jax_bit_for_bit(kind, dtype):
    """The int32 accumulators against XLA's s8 convolution, and the whole
    quantize -> convolve -> dequantize pipeline, on the fly and baked: 0.0."""
    cin, cout, k, pad, dil, h, w = SITE_KINDS[kind]
    rng = np.random.RandomState(cin * 100 + k)
    x = rng.randn(2, cin, h, w).astype(np.float32)
    wt = (0.3 * rng.randn(cout, cin, k, k)).astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0
    jdt = jnp.dtype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
    w_hwio = jnp.asarray(wt.transpose(2, 3, 1, 0))

    want = jq.quantized_conv(x_nhwc, w_hwio, scale, pad, dil)
    got = pq.quantized_conv(xt, torch.from_numpy(wt), scale, pad, dil)
    assert got.dtype == xt.dtype and got.shape == (2, cout, *want.shape[1:3])
    _bits(got, np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2))
    rec = pq.conv_int8_weights(torch.from_numpy(wt))
    assert torch.equal(pq.quantized_conv(xt, None, scale, pad, dil, baked=rec), got)

    x_q = pq.quantize_activation_nhwc(xt, scale)
    acc = int8_conv(x_q, rec["w_q"], None, pad, dil, torch.int32)
    jacc = jq.int8_conv(
        jnp.asarray(x_q.numpy()), jnp.asarray(rec["w_q"].numpy().transpose(2, 3, 1, 0)), pad, dil)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc).transpose(0, 3, 1, 2))
    assert int8_conv_cuda.LAUNCHES == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(SITE_KINDS))
def test_int8_site_is_the_composition_it_replaces(kind, dtype):
    """The whole-site entry against what the layers computed before it: the
    codes-in ``quantized_conv``, then ``+ map`` and ``+ bias`` in the
    working type; folded (with a map) and not, on the fly and baked; and
    against JAX's ``quantized_conv`` plus map plus bias, op by op: 0.0."""
    cin, cout, k, pad, dil, h, w = SITE_KINDS[kind]
    rng = np.random.RandomState(cin * 10 + k + 7)
    ho, wo = h + 2 * pad - dil * (k - 1), w + 2 * pad - dil * (k - 1)
    x = rng.randn(2, cin, h, w).astype(np.float32)
    wt = (0.3 * rng.randn(cout, cin, k, k)).astype(np.float32)
    fold_map = rng.randn(cout, ho, wo).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0 * 0.9  # clips the top of the range
    tdt = getattr(torch, dtype)
    xt, mt, bt = (torch.from_numpy(a).to(tdt) for a in (x, fold_map, bias))
    w32 = torch.from_numpy(wt)
    records = (pq.conv_int8_weights(w32), pq.conv_site_record(w32, mt))
    composed = pq.quantized_conv(xt, w32, scale, pad, dil)
    for const in (None, mt):
        want = (composed if const is None else composed + const[None]) + bt.reshape(-1, 1, 1)
        for rec in records:
            got = int8_conv_site(xt, scale, rec, pad, dil, const=const, bias=bt)
            assert got.dtype == tdt and got.is_contiguous() and torch.equal(got, want)
    jdt = jnp.dtype(dtype)
    jy = jq.quantized_conv(jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt),
                           jnp.asarray(wt.transpose(2, 3, 1, 0)), scale, pad, dil)
    jy = jy + jnp.asarray(fold_map.transpose(1, 2, 0)).astype(jdt) + jnp.asarray(bias).astype(jdt)
    got = int8_conv_site(xt, scale, records[1], pad, dil, const=mt, bias=bt)
    _bits(got, np.asarray(jy.astype(jnp.float32)).transpose(0, 3, 1, 2))
    assert int8_conv_cuda.SITE_LAUNCHES == 0


@pytest.mark.parametrize("kind", sorted(SITE_KINDS))
def test_site_weights_are_the_kernels_layout(kind):
    """``site_weights`` read back index by index as the kernel reads it
    (Cin = 1: taps in ``kh * k + kw`` order; otherwise lane ``4 g + t`` of
    step ``s``, n8 tile ``j`` holds channel ``8 j + g``'s reduction indices
    ``32 s + 16 h + 4 t + e``, tap-major over Cin padded to 32), zero
    codes beyond Cout and Cin; N tiles shaped to Cout."""
    cin, cout, k, pad, dil, h, w = SITE_KINDS[kind]
    w_q = torch.from_numpy(np.random.RandomState(k).randint(-127, 128, (cout, cin, k, k))
                           ).to(torch.int8)
    rows = int8_conv_cuda.site_weights(w_q)
    assert rows.dtype == torch.int8 and rows.is_contiguous()
    assert tuple(rows.shape) == int8_conv_cuda.weights_shape(cout, cin, k)
    plan = int8_conv_cuda.site_plan(h, w, cin, cout, k, pad, dil)
    wn = w_q.numpy()
    if cin == 1:
        want = np.zeros(rows.shape, np.int8)
        want[:, :k * k] = wn.reshape(cout, k * k)
        np.testing.assert_array_equal(rows.numpy(), want)
        assert plan.route == -rows.shape[1] // 16 and plan.grid_y == 1
        assert plan.tr * plan.tw <= plan.threads <= int8_conv_cuda.CIN1_THREADS
        return
    steps, n8, lanes, nbytes = rows.shape
    cin_p = -(-cin // 32) * 32
    s, j, lane, e = np.meshgrid(*(np.arange(n) for n in rows.shape), indexing="ij")
    n = 8 * j + lane // 4
    kidx = 32 * s + 16 * (e // 4) + 4 * (lane % 4) + e % 4
    tap, c = kidx // cin_p, kidx % cin_p
    live = (n < cout) & (c < cin)
    want = np.where(live, wn[np.minimum(n, cout - 1), np.minimum(c, cin - 1), tap // k, tap % k], 0)
    np.testing.assert_array_equal(rows.numpy(), want)
    bn = {2: 32, 4: 64, 6: 96, 8: 128}[plan.route]  # channels a CTA
    assert bn == min(128, -(-cout // 32) * 32) and plan.grid_y * bn == n8 * 8 >= cout
    assert plan.tr * plan.tw <= int8_conv_cuda.MMA_POSITIONS and plan.tw <= int8_conv_cuda.MAX_RUN
    assert steps == k * k * cin_p // 32 and plan.smem <= int8_conv_cuda.MAX_SMEM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_dense_is_jax_bit_for_bit(dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 32).astype(np.float32)
    kernel = (0.2 * rng.randn(32, 24)).astype(np.float32)  # flax [In, Out]
    scale = float(np.abs(x).max()) / 127.0
    want = jq.quantized_dense(jnp.asarray(x).astype(jnp.dtype(dtype)), jnp.asarray(kernel), scale)
    weight = torch.from_numpy(kernel.T.copy())
    got = pq.quantized_dense(torch.from_numpy(x).to(getattr(torch, dtype)), weight, scale)
    assert got.shape == (3, 5, 24)
    _bits(got, np.asarray(want.astype(jnp.float32)))
    baked = pq.quantized_dense(torch.from_numpy(x).to(getattr(torch, dtype)), None, scale,
                               baked=pq.dense_int8_weights(weight))
    assert torch.equal(baked, got)


# ---- whole models

MODELS = {  # name: (JAX class, port class, kwargs, input shape)
    "DCNN": (JaxDCNN, DCNN, NARROW, DCNN_SHAPE),
    "LCNN": (JaxLCNN, LCNN, LCNN_KW, LCNN_SHAPE),
    "AST": (jax_ast.ASTModel, ast.ASTModel, AST_KW, AST_SHAPE),
}


def _seeded_port(name: str, seed: int):
    """The port's model from a seed, with random BatchNorm statistics and
    affine parameters (and AST tokens), and the JAX variables of the same
    weights (the JAX package's own ``.pt`` importers: no JAX init)."""
    pcls, kw = MODELS[name][1:3]
    torch.manual_seed(seed)
    port = pcls(**kw)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for mod in port.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.running_mean.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, c)))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
                if mod.affine:
                    mod.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
                    mod.bias.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, c)))
        if name == "AST":
            port.v.cls_token.normal_(0.0, 0.02)
            port.v.dist_token.normal_(0.0, 0.02)
    state = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()}
    if name == "DCNN":
        variables = jax_import.import_dcnn(state)
    elif name == "LCNN":
        variables = jax_import.import_lcnn(state)
    else:
        variables = jax_ast.import_timm_deit(
            state, input_fdim=AST_KW["input_fdim"], input_tdim=AST_KW["input_tdim"],
            model_size=AST_KW["model_size"])
    return port.eval(), variables


def _jax_scales(jmodel, variables, jx, include=None):
    """``jq.calibrate_model(jmodel, variables, [jx], include)`` on one
    batch with its ``apply`` traced once: the same observation collection,
    flattening and ``absmax / 127`` (a maximum, so tracing changes no bit);
    ``calibrate_model`` itself runs op by op, 4-7 s a model here."""
    calib = jmodel.clone(quant="calibrate")
    _, mut = jax.jit(lambda v, x: calib.apply(v, x, train=False, mutable=["quant_obs"]))(
        variables, jx)
    absmax = jq._flatten_obs(mut["quant_obs"])
    return {k: v * 1.0 / 127.0 for k, v in absmax.items() if include is None or k in include}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """A port model with seeded weights and BatchNorm statistics, the JAX
    model with the same variables, a seeded batch, and the JAX fp32 logits,
    JAX scales over all sites and JAX int8 logits with them."""
    jcls, _, kw, shape = MODELS[request.param]
    jmodel = jcls(**kw)
    port, variables = _seeded_port(request.param, seed=4)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jx = jnp.asarray(x)
    fp = np.asarray(jax.jit(jmodel.apply)(variables, jx))
    scales = _jax_scales(jmodel, variables, jx)
    q8 = np.asarray(jax.jit(jmodel.clone(quant=scales).apply)(variables, jx))
    return dict(name=request.param, jmodel=jmodel, variables=variables, port=port, x=x,
                fp=fp, scales=scales, q8=q8)


def _max_dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_site_sets_and_scales_match_jax(pair):
    """Every site JAX observes, the port observes (the DCNN's dilated ones
    too), with the same scale within 1e-5 relative."""
    port, x = pair["port"], torch.from_numpy(pair["x"])
    scales = pq.calibrate_model(port, [x])
    assert sorted(scales) == sorted(pair["scales"])
    for site, want in pair["scales"].items():
        assert scales[site] == pytest.approx(want, rel=1e-5), site
    if pair["name"] == "DCNN":
        assert {"dil_1", "dil_4", "dil_7"} <= set(scales)
        front = pq.calibrate_dcnn(port, [x])
        assert sorted(front) == sorted(jq.DEFAULT_INT8_SITES) == sorted(pq.DEFAULT_INT8_SITES)
        assert front == {k: scales[k] for k in pq.DEFAULT_INT8_SITES}
    assert port.quant is None  # calibration leaves the model as it was


def test_int8_logits_with_jax_scales_lie_near_jax_int8(pair):
    """The port's int8 model, given JAX's scales for every site: closer to
    JAX int8 than half of JAX int8's distance from JAX fp32.  The fp model
    stays the fp model."""
    port, x = pair["port"], torch.from_numpy(pair["x"])
    qmodel = pq.with_quant(port, pair["scales"])
    with torch.inference_mode():
        got = qmodel(x).numpy()
        fp = port(x).numpy()
    int8_error = _max_dist(pair["q8"], pair["fp"])
    assert int8_error > 1e-5  # int8 is not fp32
    assert _max_dist(got, pair["q8"]) < 0.5 * int8_error
    assert _max_dist(fp, pair["fp"]) < 1e-4 and port.quant is None


def test_baked_equals_on_the_fly_and_keeps_the_state_dict(pair):
    """Baked records give the on-the-fly logits bit for bit, are not in the
    state dict, and a re-bake after a BatchNorm update refreshes them."""
    port, x = pair["port"], torch.from_numpy(pair["x"])
    qmodel = pq.with_quant(port, pair["scales"])
    with torch.inference_mode():
        fly = qmodel(x)
    pq.bake_int8_weights(qmodel, x[:1])
    records = pq.baked_records(qmodel)
    assert sorted(records) == sorted(pair["scales"])
    with torch.inference_mode():
        assert torch.equal(qmodel(x), fly)
    assert list(qmodel.state_dict()) == list(port.state_dict())
    bns = [m for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    if not bns:
        return
    site = next(s for s in sorted(records) if s not in ("cnn_0", "lcnn_0", "lcnn_3", "lcnn_16"))
    stale = records[site]["w_q"].clone()
    with torch.no_grad():
        for bn in bns:  # a uniform factor would leave the per-channel codes as they are
            bn.running_var.mul_(torch.linspace(0.5, 2.0, bn.num_features))
    pq.bake_int8_weights(qmodel, x[:1])
    assert not torch.equal(pq.baked_records(qmodel)[site]["w_q"], stale)
    fresh = pq.with_quant(port, pair["scales"])
    with torch.inference_mode():
        assert torch.equal(qmodel(x), fresh(x))


def test_baked_site_records_are_the_call_time_layout_and_map():
    """Every baked conv record holds the kernel's layout of its codes and,
    at a folded site, the map the un-baked call computes at that input's
    plane; a re-bake after a BatchNorm update refreshes both; a call at
    another plane computes its map anew."""
    from audiodeepfake_detection_tpu_torch.models import layers

    port = _seeded_port("DCNN", seed=6)[0]
    scales = {s: 0.02 for s in ("cnn_0", "cnn_4", "cnn_7", "dil_4")}
    qmodel = pq.with_quant(port, scales)
    x = torch.from_numpy(np.random.RandomState(8).randn(*DCNN_SHAPE).astype(np.float32))
    seen = []
    site = layers.int8_conv_site

    def spy(x, act_scale, record, padding, dilation=1, const=None, bias=None):
        seen.append((record, const))
        return site(x, act_scale, record, padding, dilation, const=const, bias=bias)

    def sites_of(model):
        seen.clear()
        with torch.inference_mode():
            model(x)
        return list(seen)

    maps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "int8_conv_site", spy)
        for _ in range(2):
            fly = sites_of(pq.with_quant(port, scales))  # un-baked: made at call time
            pq.bake_int8_weights(qmodel, x[:1])
            baked = sites_of(qmodel)
            records = pq.baked_records(qmodel)
            assert len(fly) == len(baked) == len(records) == 4
            for (frec, fconst), (brec, bconst) in zip(fly, baked):
                assert "rows" not in frec and any(brec["w_q"] is r["w_q"] for r in records.values())
                assert torch.equal(brec["w_q"], frec["w_q"]) and torch.equal(brec["s_w"], frec["s_w"])
                assert torch.equal(brec["rows"], int8_conv_cuda.site_weights(frec["w_q"]))
                assert (fconst is None) == ("map" not in brec)
                if fconst is not None:
                    assert bconst is brec["map"] and torch.equal(bconst, fconst)
            with torch.no_grad():  # a BatchNorm update: the next bake refreshes the maps
                for bn in (m for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d)):
                    bn.running_mean.add_(0.25)
            maps.append(records["cnn_4"]["map"])
    bn, conv = port.cnn[3], port.cnn[4]  # site cnn_4: the BatchNorm in front, the 1x1 conv
    other = torch.randn(1, conv.in_channels, 5, 7)  # a plane the baked map does not fit
    rec = pq.baked_records(qmodel)["cnn_4"]
    with torch.inference_mode():
        got = layers.folded_bn_conv(bn, conv, other, act_scale=0.02, baked=lambda make: rec)
        want = layers.folded_bn_conv(bn, conv, other, act_scale=0.02)
    assert got.shape[-2:] == (5, 7) and torch.equal(got, want)
    assert not torch.equal(maps[0], maps[1])


def test_refusals():
    model = DCNN(**NARROW)
    qmodel = pq.with_quant(model, {"cnn_4": 0.01})
    with pytest.raises(ValueError, match="inference-only"):
        qmodel.train()(torch.zeros(DCNN_SHAPE))
    lcnn = pq.with_quant(LCNN(**LCNN_KW), "calibrate")
    with pytest.raises(ValueError, match="inference-only"):
        lcnn.train()(torch.zeros(LCNN_SHAPE))
    tr = pq.with_quant(ast.ASTModel(**AST_KW), {"block_0/qkv": 0.01})
    with pytest.raises(ValueError, match="inference-only"):
        tr.train()(torch.zeros(AST_SHAPE))
    with pytest.raises(ValueError, match="DCNN, LCNN and AST families only"):
        predict.quantize_for_scoring(Regression(), lambda a: a, [np.zeros(8, np.float32)],
                                     "cpu", 1)
    with pytest.raises(ValueError, match="no batches"):
        pq.calibrate_model(model, [])


# ---- the metric gate on trained tiny models


def _band_images(rng, n, label, shape, bands):
    img = 0.1 * rng.randn(n, *shape).astype(np.float32)
    img[:, :, bands[label], :] += 1.0
    return img


def _train(model, shape, bands, steps, lr, seed):
    """The port's train step on batches of 4 + 4 synthetic band images."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    step = make_train_step(model, lambda a: a.reshape(-1, *shape),
                           make_optimizer(model.parameters(), lr, 1e-4 if lr < 1e-3 else 0.0))
    for _ in range(steps):
        x = np.concatenate([_band_images(rng, 4, 0, shape, bands),
                            _band_images(rng, 4, 1, shape, bands)])
        step({"audio": torch.from_numpy(x.reshape(8, 1, -1)),
              "label": torch.from_numpy(np.repeat([0, 1], 4))})
    er = np.random.RandomState(99)
    x = np.concatenate([_band_images(er, 16, 0, shape, bands),
                        _band_images(er, 16, 1, shape, bands)])
    return model.eval(), torch.from_numpy(x), np.repeat([0, 1], 16)


def _metrics(model, x, y):
    with torch.inference_mode():
        logits = model(x).numpy().astype(np.float64)
    p_fake = np.exp(logits[:, 1]) / np.exp(logits).sum(-1)
    return float((logits.argmax(-1) == y).mean()), float(calculate_eer(y, p_fake)), p_fake


@pytest.mark.parametrize("name", ["DCNN", "AST"])
def test_trained_tiny_model_int8_within_budget(name):
    """JAX's metric gate (test_int8_quality.py:189-275): a tiny DCNN (40
    steps, as the JAX gate trains it) and a tiny AST (10 steps) trained to
    separate two frequency bands, then calibrated on 8 clips and baked."""
    if name == "DCNN":
        torch.manual_seed(0)
        model, shape = DCNN(**NARROW), (1, 256, 95)
        bands, steps, lr = (slice(20, 60), slice(180, 220)), 40, 2e-3
        quantize = pq.quantize_dcnn
    else:
        torch.manual_seed(1)
        model = ast.ASTModel(model_size="tiny224", input_fdim=64, input_tdim=48)
        shape, bands, steps, lr = (1, 64, 48), (slice(5, 20), slice(40, 55)), 10, 3e-4
        quantize = pq.quantize_model
    model, x, y = _train(model, shape, bands, steps, lr, seed=0)
    acc_fp, eer_fp, p_fp = _metrics(model, x, y)
    assert acc_fp == 1.0 and eer_fp <= 0.05  # the synthetic task trains to separation
    qmodel, scales = quantize(model, [x[:8]])
    pq.bake_int8_weights(qmodel, x[:2])
    acc_q, eer_q, p_q = _metrics(qmodel, x, y)
    assert abs(acc_q - acc_fp) <= ACC_BUDGET, (acc_fp, acc_q)
    assert abs(eer_q - eer_fp) <= EER_BUDGET, (eer_fp, eer_q)
    assert np.abs(p_q - p_fp).max() < P_BUDGET
    assert np.abs(p_q - p_fp).max() > 0.0  # the int8 path ran


# ---- the entry points


@pytest.fixture(scope="module")
def int8_snapshot(tmp_path_factory):
    """A full-width packets-sym5 DCNN snapshot (JAX variables, random BN
    statistics) with a ``.norm.pkl`` sidecar; two clips of 2 s and 1.5 s
    (three frames) and one of 0.5 s."""
    root = tmp_path_factory.mktemp("int8")
    (root / "models").mkdir()
    args = default_config()
    args.update(data_prefix="x/fake_22050_22050_0.7_fbmelgan", transform="packets",
                wavelet="sym5", num_of_scales=256, only_use=["ljspeech", "fbmelgan"])
    path = experiment_model_file(args, str(root), "DCNN") + ".pt"
    torch.manual_seed(3)
    model = DCNN(time_dim=12)
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, mod.num_features)))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, mod.num_features)))
    torch.save(model.state_dict(), path)
    with open(path + ".norm.pkl", "wb") as fh:
        pickle.dump([np.asarray([-5.0], np.float32), np.asarray([4.0], np.float32)], fh)
    clips = []
    for i, sec in enumerate((2.0, 1.5, 0.5)):
        pcm = _pcm(int(sec * 22050), seed=20 + i)
        clips.append((str(root / f"clip{i}.wav"), pcm))
        (root / f"clip{i}.wav").write_bytes(_wav_bytes(pcm))
    return path, clips


def test_predict_int8_cli_and_int8_service_score_on_cpu(int8_snapshot, capsys):
    """``predict --int8`` and ``service_from_snapshot(int8=True, calibrate=)``
    on the CPU: the int8 scores lie within the int8 budget of the fp ones,
    and the service scores as ``score_files(int8=True)`` does."""
    snapshot, clips = int8_snapshot
    wavs = [p for p, _ in clips[:2]]
    predict.main([snapshot, *wavs, "--device", "cpu", "--int8", "--json", "--batch-size", "2"])
    got = json.loads(capsys.readouterr().out)
    model, transform, _ = predict.build_scorer_from_snapshot(snapshot)
    fp = predict.score_files(model, transform, wavs, "cpu", batch_size=2)
    assert sorted(got) == sorted(fp)
    for path in wavs:
        assert 0.0 < got[path] < 1.0 and abs(got[path] - fp[path]) < P_BUDGET
    assert model.quant is None  # the fp model is left as it was

    svc = service_from_snapshot(snapshot, device="cpu", int8=True, calibrate=wavs,
                                batch_size=2)
    with svc:
        scored = [svc.score_clip(pcm.astype(np.float32) / 32768.0, 22050)[0]
                  for _, pcm in clips[:2]]
    assert scored == pytest.approx([got[p] for p in wavs], abs=1e-6)
    with pytest.raises(ValueError, match="--int8 needs --calibrate"):
        service_from_snapshot(snapshot, device="cpu", int8=True, calibrate=[])
    with pytest.raises(ValueError, match="shorter than one frame"):
        service_from_snapshot(snapshot, device="cpu", int8=True, calibrate=[clips[2][0]])


# (Cin, Cout, k, padding, dilation, H, W) -> the MMA route's tile (tr, tw)
_DCNN_TILES = {
    (64, 96, 3, 1, 1, 48, 129): (2, 43),   # cnn_7: Wo 129 in runs of 43
    (96, 128, 3, 1, 1, 24, 64): (2, 64),   # cnn_11: whole rows
    (128, 32, 3, 1, 1, 24, 64): (4, 32),   # cnn_14: N tile 32, rows by cp.async
    (32, 64, 3, 1, 1, 24, 64): (2, 64),    # cnn_17
}


@pytest.mark.parametrize("geo", sorted(_DCNN_TILES))
def test_site_plan_splits_wo_into_even_runs(geo):
    """The MMA route's tile on a contiguous activation: whole rows where
    Wo fits ``MAX_RUN``, else Wo split evenly into runs of at most
    ``MAX_RUN`` columns; at an N tile of 32 the rows by cp.async, on runs of
    ``ROWS_RUN``; at most ``MMA_POSITIONS`` positions.  A transposed view
    loads into registers."""
    cin, cout, k, pad, dil, h, w = geo
    x = torch.zeros(1, cin, h, w)
    plan = int8_conv_cuda.plan_for(x, cout, k, pad, dil)
    assert (plan.tr, plan.tw) == _DCNN_TILES[geo]
    rows = int8_conv_cuda.STAGE_ROWS if cout == 32 else int8_conv_cuda.STAGE_LOADS
    assert plan.staging == rows
    assert plan.tr * plan.tw <= int8_conv_cuda.MMA_POSITIONS
    view = torch.zeros(1, cin, w, h).permute(0, 1, 3, 2)
    assert int8_conv_cuda.plan_for(view, cout, k, pad, dil).staging == int8_conv_cuda.STAGE_LOADS


def test_plan_copies_aligned_code_words_only():
    """The codes-in prologue copies 16-byte code words by cp.async where Cin
    is a multiple of 16 and the codes lie on the 16-byte grid, else loads
    them into registers; the rows' prologue falls back to register loads
    where its buffers leave no room in shared memory."""
    plan = int8_conv_cuda.plan_for
    codes = torch.zeros(2, 5, 6, 64, dtype=torch.int8)
    shifted = torch.zeros(codes.numel() + 1, dtype=torch.int8)[1:].view(codes.shape)
    assert codes.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 != 0
    assert plan(codes, 32, 3, 1, 1).staging == int8_conv_cuda.STAGE_CODES
    assert plan(shifted, 32, 3, 1, 1).staging == int8_conv_cuda.STAGE_LOADS
    assert plan(codes[..., :12].contiguous(), 32, 3, 1, 1).staging == int8_conv_cuda.STAGE_LOADS
    wide = torch.zeros(1, 12, 64, 32)  # dil_7: 7x7 at dilation 4, N tile 32
    assert plan(wide, 12, 5, 2, 2).staging == int8_conv_cuda.STAGE_ROWS
    fallback = plan(wide, 12, 7, 2, 4)
    assert fallback.staging == int8_conv_cuda.STAGE_LOADS
    assert fallback.smem <= int8_conv_cuda.MAX_SMEM
