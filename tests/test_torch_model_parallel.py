"""The AST's model-parallel modes against the JAX package's (gloo, CPU).

One spawn of 4 rank processes (``tests/torch_dist_workers.py``, one thread
each) builds a ``(2, 2)`` ``("data", "model")`` mesh and a ``(2, 2)``
``("data", "stage")`` mesh; meanwhile this process runs JAX's
``shard_ast_params`` forward and ``pp_ast_logits`` on 4 of its 8 virtual
devices.  The AST is a ``test64`` size (embed 64, depth 4, 4 heads of 16)
patched into both ``_SIZES`` tables, on a ``[8, 1, 64, 48]`` image batch
(5 x 4 patches + the two tokens); the JAX weights reach the port through
``state_dict_from_jax``, with non-trivial tokens and head so that every
gradient is exercised.  The port runs kernel 4's path (its plain version
on the CPU), JAX its einsum attention (its own tests hold the two equal).

Held here: tensor-parallel logits and gradients against JAX's sharded
forward, the specs against JAX's, the shards gathered back; pipelined
logits and gradients against JAX's pipeline and the sequential model,
JAX's per-shard divisibility error, ``make_pp_train_step`` learning, a
Trainer step over the pipeline against a one-process Trainer step (the
Adam criterion of ``tests/test_torch_vectorized.py``), the ranks
bit-equal, the snapshot, the refusals.
"""

import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_workers as workers
from audiodeepfake_detection_tpu.models import ast as jax_ast
from audiodeepfake_detection_tpu.parallel.mesh import batch_sharding, get_mesh
from audiodeepfake_detection_tpu.parallel.pipeline import pp_ast_logits
from audiodeepfake_detection_tpu.parallel.tensor import ast_param_specs as jax_specs
from audiodeepfake_detection_tpu.parallel.tensor import shard_ast_params as jax_shard
from audiodeepfake_detection_tpu_torch.models import ast
from audiodeepfake_detection_tpu_torch.models.torch_import import state_dict_from_jax
from audiodeepfake_detection_tpu_torch.parallel import tensor
from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

B = 8


@pytest.fixture(scope="module", autouse=True)
def test_size():
    """``test64`` in both ``_SIZES`` tables for the whole file."""
    with pytest.MonkeyPatch.context() as mp:
        for name, size in workers.AST_SIZE.items():
            mp.setitem(jax_ast._SIZES, name, size)
            mp.setitem(ast._SIZES, name, size)
        yield


def _loss(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


def _jax_side(model, params, x, labels, devices):
    """JAX's tensor-parallel and pipelined forward and gradients on 4
    devices, the sequential ones, and its per-shard divisibility error."""
    def value_and_grad(logits_fn):
        def loss(p):
            out = logits_fn(p)
            return _loss(out, labels), out
        return jax.jit(jax.value_and_grad(loss, has_aux=True))

    def as_torch(grads):
        return state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)}, "ast")

    out = {}
    (_, logits), grads = value_and_grad(lambda p: model.apply({"params": p}, x))(params)
    out["plain"] = (np.asarray(logits), as_torch(grads))
    mesh = get_mesh(devices[:4], axis_names=("data", "model"), shape=(2, 2))
    xs = jax.device_put(x, batch_sharding(mesh, 4, axis="data"))
    (_, logits), grads = value_and_grad(
        lambda p: model.apply({"params": p}, xs))(jax_shard(params, mesh))
    out["tp"] = (np.asarray(logits), as_torch(grads))
    mesh = get_mesh(devices[:4], axis_names=("data", "stage"), shape=(2, 2))
    (_, logits), grads = value_and_grad(lambda p: pp_ast_logits(
        model, p, x, mesh, workers.MICROBATCHES, data_axis="data"))(params)
    out["pp"] = (np.asarray(logits), as_torch(grads))
    with pytest.raises(ValueError) as exc:
        pp_ast_logits(model, params, jnp.zeros((12, 1, 64, 48)), mesh, 4, data_axis="data")
    out["per_shard"] = str(exc.value)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices, test_size):
    """``(ranks, jax, inputs)``: the 4 ranks' results and JAX's."""
    directory = tmp_path_factory.mktemp("model_parallel")
    model = jax_ast.ASTModel(**workers.AST_GEOMETRY)
    rng = np.random.RandomState(0)
    x = rng.randn(B, 1, 64, 48).astype(np.float32)
    labels = np.asarray([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(0), x)["params"])
    for name in ("cls_token", "dist_token"):
        params[name] = 0.02 * rng.randn(*params[name].shape).astype(np.float32)
    params["head_norm"]["scale"] = 1.0 + 0.1 * rng.randn(64).astype(np.float32)
    inputs = {"state": state_dict_from_jax({"params": params}, "ast"),
              "image": torch.from_numpy(x), "label": torch.from_numpy(labels)}
    torch.save(inputs, directory / "inputs.pt")
    failure = []

    def run():
        try:
            workers.spawn("model_parallel", str(directory), 4)
        except Exception as exc:  # re-raised below, with the ranks' output
            failure.append(exc)

    thread = threading.Thread(target=run)
    thread.start()
    jax_out = _jax_side(model, params, jnp.asarray(x), jnp.asarray(labels), eight_devices)
    thread.join()
    if failure:
        raise failure[0]
    ranks = [torch.load(directory / f"model_parallel_rank{r}.pt", weights_only=False)
             for r in range(4)]
    return ranks, jax_out, inputs


def _rows(rank: int):
    """The batch rows of a rank's data row: ranks 0, 1 hold the first half
    on both meshes (the last dim is the fast one)."""
    d = rank // 2
    return slice(d * B // 2, (d + 1) * B // 2)


def _assert_grads(got, want, rtol, atol, scaled=False):
    """Each gradient within ``rtol`` / ``atol`` (``scaled``: ``atol`` times
    the tensor's largest entry)."""
    for key in want:
        w = want[key].numpy()
        np.testing.assert_allclose(got[key].numpy(), w, rtol=rtol,
                                   atol=atol * np.abs(w).max() if scaled else atol, err_msg=key)


# ---------------------------------------------------------- tensor parallel


def test_tp_logits_match_jax_tensor_parallel(runs):
    ranks, jax_out, _ = runs
    want = jax_out["tp"][0]
    for r, out in enumerate(ranks):
        # JAX's own TP bound (tests/test_parallel.py); measured 6e-7
        np.testing.assert_allclose(out["tp"]["logits"].numpy(), want[_rows(r)], rtol=2e-4,
                                   atol=2e-4)


def test_tp_grads_match_jax_tensor_parallel(runs):
    ranks, jax_out, _ = runs
    want = jax_out["tp"][1]
    for out in ranks:  # averaged over "data", gathered over "model"
        # XLA sums the sharded products in its own order: an entry near
        # zero misses rtol alone; measured 2.3e-6 of each tensor's largest
        _assert_grads(out["tp"]["grads"], want, rtol=2e-4, atol=1e-5, scaled=True)


def test_tp_shards_are_head_aligned_and_gather_back(runs):
    ranks, _, inputs = runs
    for out in ranks:
        assert out["tp"]["heads"] == [2] * 4  # 4 heads over 2 ranks
        assert out["tp"]["qkv_rows"] == 3 * 2 * 16  # [3, H / tp, 16] packed
        for key, val in inputs["state"].items():
            assert torch.equal(out["tp"]["state"][key], val), key


def test_tp_shard_layout():
    """Rank r's qkv rows are its heads of q, then of k, then of v; proj
    takes the matching input columns; fc1 / fc2 split contiguously."""
    full = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(48, 1)  # 3 x 8 heads x 2
    shard = tensor._shard(full, 0, 3, 1, 4)  # rank 1 of 4: heads 2 and 3
    q, k, v = full.reshape(3, 8, 2)[:, 2:4].unbind(0)
    assert torch.equal(shard.reshape(3, 2, 2), torch.stack([q, k, v]))
    gathered = torch.stack([tensor._shard(full, 0, 3, r, 4) for r in range(4)])
    assert torch.equal(tensor._unshard(gathered, 0, 3), full)
    w = torch.randn(5, 12)
    gathered = torch.stack([tensor._shard(w, 1, 1, r, 3) for r in range(3)])
    assert torch.equal(gathered[2], w[:, 8:]) and torch.equal(tensor._unshard(gathered, 1, 1), w)


def test_param_specs_match_jax():
    """The same parameters sharded along the matching dims: torch ``[out,
    in]`` weights against flax ``[in, out]`` kernels."""
    model = jax_ast.ASTModel(**workers.AST_GEOMETRY)
    params = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 1, 64, 48)))["params"]
    want = jax_specs(params)
    got = tensor.ast_param_specs(ast.ASTModel(**workers.AST_GEOMETRY))
    sharded = {k for k, v in got.items() if "model" in v}
    assert sharded == {f"v.blocks.{i}.{n}" for i in range(4) for n in (
        "attn.qkv.weight", "attn.qkv.bias", "mlp.fc1.weight", "mlp.fc1.bias",
        "attn.proj.weight", "mlp.fc2.weight")}
    for i in range(4):
        for flax_name, torch_name in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                                      ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            spec = want[f"block_{i}"][flax_name]
            key = f"v.blocks.{i}.{torch_name}"
            assert got[key + ".weight"] == tuple(spec["kernel"])[::-1], key
            assert got[key + ".bias"] == tuple(spec["bias"]), key
    assert all(got[k] == () for k in got if "blocks" not in k)
    assert all(tuple(s) == () for s in jax.tree.leaves(
        {k: v for k, v in want.items() if not k.startswith("block_")},
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))


def test_shard_ast_params_refuses_indivisible_heads():
    mesh = SimpleNamespace(mesh_dim_names=("model",), size=lambda i: 3,
                           get_local_rank=lambda axis: 0, get_group=lambda axis: None)
    with pytest.raises(ValueError, match="4 heads of block 0 do not split over the 3 ranks"):
        tensor.shard_ast_params(ast.ASTModel(**workers.AST_GEOMETRY), mesh)


# ------------------------------------------------------------------ pipeline


def test_pp_logits_match_jax_pipeline(runs):
    ranks, jax_out, _ = runs
    for r, out in enumerate(ranks):
        assert out["pp"]["blocks"] == [[0, 1], [2, 3]][r % 2]
        rows = _rows(r)
        # JAX's pipeline bound (tests/test_parallel.py); measured 0.0 on
        # the port's own sequential model
        np.testing.assert_allclose(out["pp"]["logits"].numpy(), jax_out["pp"][0][rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["pp"]["logits"].numpy(), jax_out["plain"][0][rows],
                                   rtol=1e-5, atol=1e-5)


def test_pp_grads_match_jax_pipeline_and_sequential(runs):
    ranks, jax_out, _ = runs
    for out in ranks:
        # JAX's bound for its pipeline against its sequential model;
        # measured 1.4e-6 of each tensor's largest entry
        _assert_grads(out["pp"]["grads"], jax_out["pp"][1], rtol=2e-4, atol=1e-6)
        _assert_grads(out["pp"]["grads"], jax_out["plain"][1], rtol=2e-4, atol=1e-6)
    for out in ranks[1:]:  # every rank holds the whole gradient, the same bits
        for key, val in ranks[0]["pp"]["grads"].items():
            assert torch.equal(out["pp"]["grads"][key], val), key


def test_pp_per_shard_divisibility_error_is_jax(runs):
    ranks, jax_out, _ = runs
    assert jax_out["per_shard"] == "per-shard batch 6 (= 12 / data 2) not divisible by " \
                                   "n_microbatches 4"
    assert all(out["pp"]["per_shard"] == jax_out["per_shard"] for out in ranks)


def test_pp_train_step_runs_and_learns(runs):
    """JAX's ``test_train_step_runs_and_learns``: four steps on one batch."""
    ranks, _, _ = runs
    for out in ranks:
        losses = out["pp"]["learn"]
        assert np.isfinite(losses[0]) and losses[-1] < losses[0]
    assert ranks[0]["pp"]["learn"] == ranks[1]["pp"]["learn"]  # one data row


def test_pp_trainer_step_matches_one_process(runs, tmp_path):
    """A Trainer step over the pipeline (each data row's 4 frames) against a
    one-process Trainer step on all 8: the Adam criterion of
    ``tests/test_torch_vectorized.py`` (near-zero
    gradients flip m / sqrt(v): up to ~2 lr a step, the median far below),
    the second moments by relative L2; the ranks bit-equal."""
    ranks, _, inputs = runs
    args = default_config()
    args.update(learning_rate=workers.PP_LR, weight_decay=workers.PP_WD, seed=0)
    one = Trainer(workers._ast(inputs["state"]), lambda a: a, DotDict(args),
                  str(tmp_path / "one"), device="cpu")
    stats = one.train_step({"audio": inputs["image"], "label": inputs["label"]})
    got = ranks[0]["pp"]["trainer"]
    losses = [r["pp"]["trainer"]["loss"] for r in ranks]
    # the logged loss is the mean over the data rows
    assert (losses[0] + losses[2]) / 2 == pytest.approx(float(stats["loss"]), rel=1e-6)
    lr = workers.PP_LR
    for name, p in one.model.named_parameters():
        diff = (got["state"][name] - p.detach()).abs()
        assert diff.max() <= 2 * lr and diff.median() <= lr / 4, name
        want = one.optimizer.state[p]["exp_avg_sq"]
        rel = float((got["exp_avg_sq"][name] - want).norm() / want.norm().clamp_min(1e-30))
        assert rel <= 1e-3, (name, rel)
    for r in ranks[1:]:
        for key, val in got["state"].items():
            assert torch.equal(r["pp"]["trainer"]["state"][key], val), key
    assert [r["pp"]["trainer"]["rank"] for r in ranks] == [0, 0, 1, 1]  # the data coordinate
    snapshot = torch.load(got["snapshot"], weights_only=True)
    assert snapshot["EPOCHS_RUN"] == 0
    for key, val in got["state"].items():
        assert torch.equal(snapshot["MODEL_STATE"][key], val), key


def test_model_parallel_refusals_on_a_world(runs):
    ranks, _, _ = runs
    assert ranks[0]["pp"]["not_dividing"] == "pp_stages=3 does not divide 4 devices"
    assert "requires a mesh with a 'stage' axis" in ranks[0]["no_stage_axis"]
