"""Port grid model, ``Regression`` and the model factory vs the JAX package
(CPU): equal parser output, equal shapes and, with weights carried across,
equal outputs on the JAX tests' model strings.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.models import factory as jfactory
from audiodeepfake_detection_tpu.models import gridmodel as jgrid
from audiodeepfake_detection_tpu.models.regression import Regression as JaxRegression
from audiodeepfake_detection_tpu_torch.models import factory, gridmodel
from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
from audiodeepfake_detection_tpu_torch.models.regression import Regression
from audiodeepfake_detection_tpu_torch.models.torch_import import _LSTM_NAMES
from audiodeepfake_detection_tpu_torch.utils.config import DotDict

# the JAX tests' battery (tests/test_more_models.py::TestGridModelParser)
STR_CASES = [
    ["Conv2d 1 8 3"],
    ["Conv2d 1 [8,16] 3"],
    ["Conv2d [1,2,3] 8 3", "ReLU", "Linear [10,20,30] 2"],
    ["ReLU", "Conv2d 1 [8,16] 3 [1,2] 0", "MaxPool2d 2 2"],
    ["Conv2d 1 [8,16] 3", "Conv2d [8,16,32] 4 3"],
    ["Conv2d 1 [8,16,32] 3", "Linear [1,2] 2"],
    [["W", "Permute 0,2,1,3"], "Conv2d 1 [8,16] 3"],
    ["Conv2d 1 [64,32,128] 2 1 2", "MaxPool2d 2 2", "Conv2d [64,32,128] 64 1 1 0"],
]


@pytest.mark.parametrize("case", STR_CASES, ids=[str(i) for i in range(len(STR_CASES))])
def test_parse_model_str_equals_jax(case):
    fresh = lambda: [list(e) if isinstance(e, list) else e for e in case]  # noqa: E731
    assert gridmodel.parse_model_str(fresh()) == jgrid.parse_model_str(fresh())


def test_parse_model_equals_jax_and_mismatch_raises():
    def model_data():
        return [
            [{"layers": ["Conv2d 1 [8,16] 3", "ReLU"], "input_shape": (1, 4)},
             {"layers": ["Linear [4,8] 2"], "transforms": ["t"]}],
            [{"layers": ["Conv2d 1 4 3"]}],
        ]

    assert gridmodel.parse_model(model_data()) == jgrid.parse_model(model_data())
    with pytest.raises(RuntimeError, match="same amount of elements"):
        gridmodel.parse_model_str(["Conv2d 1 [64,32] [3,5,7] 1 2"])
    with pytest.raises(RuntimeError, match="invalid"):
        gridmodel.parse_model_str([7])


def _carry(jparams, jstats, model):
    """JAX grid-model variables -> the port's ``state_dict`` (``blocks.i.j``
    is JAX's ``block_i / l{j}_{kind}``)."""
    state = {}
    for bname, block in jparams.items():
        bi = int(bname.split("_")[1])
        for lname, p in block.items():
            li, kind = lname[1:].split("_", 1)
            pre = f"blocks.{bi}.{li}"
            if kind == "Conv2d":
                conv = p["Conv_0"]
                state[f"{pre}.weight"] = np.transpose(conv["kernel"], (3, 2, 0, 1))
                state[f"{pre}.bias"] = conv["bias"]
            elif kind == "Linear":
                state[f"{pre}.weight"], state[f"{pre}.bias"] = p["kernel"].T, p["bias"]
            elif kind == "PReLU":
                state[f"{pre}.weight"] = p["alpha"].reshape(1)
            elif kind == "BLSTMLayer":
                for jname, tname in _LSTM_NAMES:
                    state[f"{pre}.l_blstm.{tname}"] = p[jname]
            else:  # affine BatchNorm
                state[f"{pre}.weight"], state[f"{pre}.bias"] = p["scale"], p["bias"]
    for bname, block in jstats.items():
        bi = int(bname.split("_")[1])
        for lname, s in block.items():
            pre = f"blocks.{bi}.{lname[1:].split('_', 1)[0]}"
            state[f"{pre}.running_mean"], state[f"{pre}.running_var"] = s["mean"], s["var"]
            state[f"{pre}.num_batches_tracked"] = np.asarray(s["num_batches_tracked"], np.int64)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, strict=True)


MODELS = {
    # tests/test_more_models.py::test_gridmodel_forward, with the Linear's
    # true input width: the JAX Dense infers it and ignores the string's
    # 2048, torch's Linear (here and in the reference) holds it to 8*8*16
    "conv-pool-linear": (
        [[{"layers": ["Conv2d 1 8 3 2 1", "ReLU", "MaxPool2d 2 2", "Flatten 1", "Linear 1024 2"]}]],
        (2, 1, 32, 64), (2, 2)),
    # every other token of the vocabulary, two blocks with a transform between
    "lcnn-like": (
        [[{"layers": ["Permute 0,1,3,2", "Conv2d 1 8 3 1 1", "MaxFeatureMap2D", "SyncBatchNorm 4 1e-3 0.2 True",
                      "PReLU", "MaxPool2d 2", "BatchNorm2d 4", "Dropout 0.5", "Permute 0,2,1,3", "Flatten 2"],
           "transforms": [lambda t: t * 2.0]},
          {"layers": ["BLSTMLayer 32 32", "Linear 32 3", "LogSoftmax 2", "Softmax 1"]}]],
        (2, 1, 16, 12), (2, 6, 3)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_grid_model_matches_jax(name):
    model_data, shape, out_shape = MODELS[name]
    fresh = lambda: [[dict(b, layers=list(b["layers"])) for b in cfg] for cfg in model_data]  # noqa: E731
    jmodel = jgrid.get_gridsearch_model(fresh())
    model = gridmodel.get_gridsearch_model(fresh())
    assert model.get_name() == jmodel.get_name() == "GridModel"
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(1)
    for block in variables.get("batch_stats", {}).values():
        for s in block.values():
            s["mean"] = rng.uniform(-0.5, 0.5, s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    _carry(variables["params"], variables.get("batch_stats", {}), model)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == want.shape == out_shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_unknown_layer_raises():
    with pytest.raises(RuntimeError, match="Given layer type Conv3d not found"):
        gridmodel.get_gridsearch_model([[{"layers": ["Conv3d 1 2 3"]}]])


def test_regression_matches_jax():
    x = np.random.RandomState(0).randn(3, 1, 256, 101).astype(np.float32)
    jmodel = JaxRegression()
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = Regression()
    assert model.get_name() == "Regression"
    with torch.no_grad():
        model(torch.from_numpy(x))  # the lazy width is fixed by the first batch
    lin = variables["params"]["linear"]
    model.load_state_dict({"linear.weight": torch.from_numpy(lin["kernel"].T.copy()),
                           "linear.bias": torch.from_numpy(lin["bias"].copy())}, strict=True)
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, 2)
    # one 25856-term fp32 product, then log-softmax
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("features,want", [("none", 256), ("lfcc", 20), ("delta", 40), ("doubledelta", 60)])
def test_factory_lcnn_lstm_channels_rule(features, want):
    args = DotDict(features=features, num_of_scales=256, fused_layer1="train")
    model = factory.get_model(args, "lcnn")
    jmodel = jfactory.get_model(args, "lcnn")
    assert isinstance(model, LCNN) and model.fused_layer1 is True
    assert model.lstm_channels == jmodel.lstm_channels == want
    assert model.feat == (want // 16) * 32


def test_factory_gridmodel_regression_and_what_stays_unported():
    # building a grid model parses its spec in place, as in the JAX package
    model_data, shape, _ = copy.deepcopy(MODELS["conv-pool-linear"])
    with pytest.raises(RuntimeError, match="model_data"):
        factory.get_model(DotDict(), "gridmodel")
    model = factory.get_model(DotDict(model_data=MODELS["conv-pool-linear"][0]), "gridmodel")
    assert model.get_name() == "GridModel"
    reg = factory.get_model(DotDict(module="Regression", input_dim=[4, 1, 16, 9]), "modules")
    assert reg.get_name() == "Regression" and reg.linear.weight.shape == (2, 144)
    assert factory.compute_parameter_total(reg) == 2 * 144 + 2
    # the policy reaches the AST (JAX tests/test_more_models.py:466-472)
    ast = factory.get_model(DotDict(module="AST", input_dim=[8, 1, 64, 48],
                                    ast_model_size="tiny224",
                                    ast_remat_policy="dots_saveable"), "modules")
    assert ast.remat_policy == "dots_saveable" and ast.remat_blocks
    # dtype: bfloat16 reaches the LCNN; the grid model ignores it and runs
    # float32, as the JAX package's (its get_gridsearch_model takes no dtype)
    lcnn = factory.get_model(DotDict(features="none", num_of_scales=256, dtype="bfloat16"),
                             "lcnn")
    assert lcnn.dtype == torch.bfloat16
    grid = factory.get_model(DotDict(model_data=model_data, dtype="bfloat16"), "gridmodel")
    assert grid.get_name() == "GridModel"
    assert all(p.dtype == torch.float32 for p in grid.parameters())
    assert grid(torch.zeros(shape)).dtype == torch.float32
    with pytest.raises(ValueError, match="in_channels == 1"):
        factory.get_model(DotDict(num_of_scales=256, fused_layer1=True), "lcnn", in_channels=2)
