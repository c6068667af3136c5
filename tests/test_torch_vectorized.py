"""The port's seed-vectorized training (``train/vectorized.py``) on the CPU.

Held against the JAX package's ``make_vectorized_train_step`` /
``make_vectorized_multi_train_step`` (what the JAX sweep runs with
``steps_per_call = 2``; the port's sweep runs single steps) /
``make_vectorized_eval_step`` and ``make_hyper_optimizer``: the same
per-seed JAX initial states, carried across by ``state_for_seed`` +
``state_dict_from_jax``, and the same batches.  And held against the port's own serial runs: ``"scan"`` with the
fused first block, dropout and augmentation on equals S serial runs bit for
bit, ``"vmap"`` within a stated tolerance.

The model is the JAX package's test DCNN (``tests/test_vectorized.py``):
widths 4-8, haar level 8 on T = 2048 (JAX's transform runs XLA on the CPU,
no Pallas kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.models import DCNN as JaxDCNN
from audiodeepfake_detection_tpu.ops.wpt import packet_image as jax_packet_image
from audiodeepfake_detection_tpu.train import steps as jsteps
from audiodeepfake_detection_tpu.train import vectorized as jvec
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.torch_import import state_dict_from_jax
from audiodeepfake_detection_tpu_torch.ops.wpt import packet_image
from audiodeepfake_detection_tpu_torch.train import steps as tsteps
from audiodeepfake_detection_tpu_torch.train import vectorized as tvec

SEEDS = [0, 1, 7]
LR, WD = 4e-4, 1e-3
BATCH, T = 4, 2048
WIDTHS = dict(time_dim=1, ochannels1=4, ochannels2=4, ochannels3=6, ochannels4=8,
              ochannels5=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """How PyTorch splits an fp32 sum between its CPU threads is not fixed
    from run to run on a busy host; on one thread a serial and a
    vectorized run of a seed repeat each other bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_model(**kw):
    return DCNN(**WIDTHS, **kw)


def _transform(audio):
    return packet_image(audio, "haar", level=8, log_scale=True)


def _jax_transform(audio):
    return jax_packet_image(audio, "haar", level=8, log_scale=True)


def _streams(n_steps, seeds=SEEDS):
    """Per-seed numpy batch streams, distinct per seed (like per-seed
    shuffles); labels 0..2, so ``label != 0`` matters."""
    out = []
    for s in seeds:
        rng = np.random.RandomState(100 + s)
        out.append([{"audio": (0.3 * rng.randn(BATCH, 1, T)).astype(np.float32),
                     "label": rng.randint(0, 3, BATCH).astype(np.int32)}
                    for _ in range(n_steps)])
    return out


def _stacked(streams, t):
    return {k: np.stack([st[t][k] for st in streams]) for k in streams[0][t]}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's vectorized init of SEEDS, made once (its jitted
    init is most of this file's time); copied before each use, since the
    JAX steps donate their state."""
    jmodel = JaxDCNN(**WIDTHS, with_dropout=False)
    img = _jax_transform(jnp.zeros((2, 1, T)))
    tx = jsteps.make_optimizer(LR, WD)
    return jmodel, tx, jvec.create_vectorized_state(jmodel, tx, img, SEEDS)


def _copy(tree):
    return jax.tree.map(jnp.copy, tree)


def _host(jvstate):
    """``jvstate`` as numpy, so ``state_for_seed`` slices on the host (its
    per-leaf device gathers cost seconds in eager JAX)."""
    return jax.device_get(jvstate._replace(rng=None))


def _jax_hyper_vstate(jvstate, hyper):
    """Slice 0 of ``jvstate`` three times over, each with the state of JAX's
    ``make_hyper_optimizer`` holding its own lr / wd, as
    ``create_vectorized_state(..., hyperparams=)`` builds it."""
    tx = jvec.make_hyper_optimizer(LR, WD)
    slices = []
    host = _host(jvstate)
    for lr, wd in zip(hyper["learning_rate"], hyper["weight_decay"]):
        st = jvec.state_for_seed(host, 0)._replace(rng=jvstate.rng[0])
        opt = tx.init(st.params)
        opt = opt._replace(hyperparams={**opt.hyperparams, "learning_rate": jnp.float32(lr),
                                        "weight_decay": jnp.float32(wd)})
        slices.append(st._replace(opt_state=opt))
    return tx, jvec.stack_seed_states(slices)


def _port_vstate_from_jax(jvstate, seeds, seed_axis="vmap", hyper=None):
    """The port's slices with the JAX slices' initial weights."""
    states = []
    jvstate = _host(jvstate)
    for i, s in enumerate(seeds):
        jst = jvec.state_for_seed(jvstate, i)
        model = _port_model(with_dropout=False)
        model.load_state_dict(state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, jst.params),
             "batch_stats": jax.tree.map(np.asarray, jst.batch_stats)}))
        lr = hyper["learning_rate"][i] if hyper else LR
        wd = hyper["weight_decay"][i] if hyper else WD
        opt = tsteps.make_optimizer(model.parameters(), lr, wd)
        torch.manual_seed(s)
        states.append({"model": model.state_dict(), "optimizer": opt.state_dict(), "step": 0,
                       "aug_generator": torch.Generator().manual_seed(s).get_state(),
                       "torch_rng": torch.get_rng_state()})
    return tvec.stack_seed_states(states, _port_model(with_dropout=False), seed_axis=seed_axis)


def _adam_of(jopt_state, hyper):
    inner = jopt_state.inner_state if hyper else jopt_state
    return inner[1]  # chain(add_decayed_weights, scale_by_adam, scale)


def _assert_slices_match_jax(vstate, jvstate, steps, hyper=None):
    """Parameters within Adam's sign-noise cap (near-zero gradients make
    m / sqrt(v) flip between frameworks: up to ~2 lr per step, the median
    far below), BatchNorm buffers and Adam moments by relative L2."""
    max_lr = max(hyper["learning_rate"]) if hyper else LR
    jvstate = _host(jvstate)
    for i in range(len(vstate)):
        jst = jvec.state_for_seed(jvstate, i)
        want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jst.params),
                                    "batch_stats": jax.tree.map(np.asarray, jst.batch_stats)})
        for key, val in vstate.models[i].state_dict().items():
            got, ref = val.numpy(), want[key].numpy()
            if key.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(got, ref, err_msg=key)
            elif "running_" in key:
                assert _rel_l2(got, ref) <= 1e-3, (i, key, _rel_l2(got, ref))
            else:
                assert np.abs(got - ref).max() <= 2 * steps * max_lr, (i, key)
                if ref.size > 1:
                    assert np.median(np.abs(got - ref)) <= max_lr / 4, (i, key)
        adam = _adam_of(jst.opt_state, hyper)
        assert int(adam.count) == steps
        mu = state_dict_from_jax({"params": jax.tree.map(np.asarray, adam.mu)})
        nu = state_dict_from_jax({"params": jax.tree.map(np.asarray, adam.nu)})
        opt_state = vstate.optimizer.state
        for name, p in vstate.models[i].named_parameters():
            st = opt_state[p]
            assert int(st["step"]) == steps
            # the first moment is a signed gradient sum (cancellation in
            # the shared slopes and the biases, as in test_torch_train.py);
            # the second moment has no sign to lose
            cap = 0.15 if p.numel() == 1 else 0.05
            assert _rel_l2(st["exp_avg"].numpy(), mu[name].numpy()) <= cap, (i, name)
            assert _rel_l2(st["exp_avg_sq"].numpy(), nu[name].numpy()) <= 2 * cap, (i, name)


@pytest.mark.parametrize("chained", [False, True], ids=["single", "chained"])
def test_vmap_steps_match_jax_vectorized(jax_init, chained):
    """Two vmapped steps against the JAX package's vectorized steps (two
    single calls, or one chained call of two), then the shared-batch eval."""
    jmodel, tx, jvstate = jax_init
    jvstate = _copy(jvstate)
    vstate = _port_vstate_from_jax(jvstate, SEEDS)
    streams = _streams(2)
    step = tvec.make_vectorized_train_step(vstate, _transform)
    stats = tsteps.stack_results([step(_torch(_stacked(streams, t))) for t in range(2)])
    assert stats["loss"].shape == (2, len(SEEDS))
    if chained:
        jstep = jvec.make_vectorized_multi_train_step(jmodel, _jax_transform, tx)
        group = {k: np.stack([_stacked(streams, t)[k] for t in range(2)])
                 for k in streams[0][0]}
        jvstate, jstats = jstep(jvstate, group)
    else:
        jstep = jvec.make_vectorized_train_step(jmodel, _jax_transform, tx)
        jruns = []
        for t in range(2):
            jvstate, jst = jstep(jvstate, _stacked(streams, t))  # donates the old state
            jruns.append(jst)
        jstats = {k: np.stack([np.asarray(s[k]) for s in jruns]) for k in ("loss", "acc")}
    np.testing.assert_allclose(stats["loss"].numpy(), np.asarray(jstats["loss"]), rtol=5e-4)
    np.testing.assert_allclose(stats["acc"].numpy(), np.asarray(jstats["acc"]), atol=1e-6)
    assert vstate.step == 2
    _assert_slices_match_jax(vstate, jvstate, 2)
    if chained:
        return
    batch = streams[0][0]
    jeval = jvec.make_vectorized_eval_step(jmodel, _jax_transform)(
        jvstate.params, jvstate.batch_stats, batch)
    res = tvec.make_vectorized_eval_step(vstate, _transform)(_torch(batch))
    assert res["scores"].shape == (len(SEEDS), BATCH)
    np.testing.assert_allclose(res["scores"].numpy(), np.asarray(jeval["scores"]), atol=2e-3)
    np.testing.assert_array_equal(res["count_per_label"].numpy(),
                                  np.asarray(jeval["count_per_label"]))


def test_per_slice_lr_wd_match_jax_hyper_optimizer(jax_init):
    """One parameter group per slice with its own lr / wd against the JAX
    package's ``inject_hyperparams`` optimizer; the slices share an init,
    so only the optimizer tells them apart."""
    hyper = {"learning_rate": [4e-4, 1e-3, 2e-4], "weight_decay": [1e-3, 0.0, 1e-2]}
    seeds = [0, 0, 0]
    jmodel, _, jvstate = jax_init
    tx, jvstate = _jax_hyper_vstate(_copy(jvstate), hyper)
    vstate = _port_vstate_from_jax(jvstate, seeds, hyper=hyper)
    assert [g["lr"] for g in vstate.optimizer.param_groups] == hyper["learning_rate"]
    streams = _streams(2, seeds)
    jstep = jvec.make_vectorized_train_step(jmodel, _jax_transform, tx)
    step = tvec.make_vectorized_train_step(vstate, _transform)
    for t in range(2):
        jvstate, _ = jstep(jvstate, _stacked(streams, t))
        step(_torch(_stacked(streams, t)))
    _assert_slices_match_jax(vstate, jvstate, 2, hyper)
    w0, w1 = (vstate.models[i].cnn[0].weight for i in (0, 1))
    assert not torch.equal(w0, w1)  # the slices diverged


def _serial_runs(n_steps, moment_dtype=None, **model_kw):
    """Each seed alone, as ``run_experiment`` + ``Trainer`` run it: the
    model built right after ``torch.manual_seed(seed)``, the default
    generator seeded again before training, augmentation from a generator
    of its own."""
    finals = []
    for i, s in enumerate(SEEDS):
        torch.manual_seed(s)
        model = _port_model(**model_kw)
        torch.manual_seed(s)
        opt = tsteps.make_optimizer(model.parameters(), LR, WD, moment_dtype=moment_dtype)
        step = tsteps.make_train_step(model, _transform, opt, aug_contrast=True, aug_noise=True,
                                      generator=torch.Generator().manual_seed(s))
        losses = [step(_torch(b))["loss"] for b in _streams(n_steps)[i]]
        finals.append((model, opt, torch.stack(losses)))
    return finals


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_scan_fused_equals_serial_runs_bit_for_bit(moments):
    """``"scan"`` with the fused first block, dropout and both augmentations
    on: every slice's losses, weights, BatchNorm buffers, Adam state and
    random streams equal its serial run's, bit for bit."""
    kw = dict(fused_layer1=True, with_dropout=True)
    finals = _serial_runs(3, moment_dtype=moments, **kw)
    vstate = tvec.create_vectorized_state(
        lambda: _port_model(**kw), SEEDS, LR, WD, moment_dtype=moments, device="cpu",
        seed_axis="scan")
    step = tvec.make_vectorized_train_step(vstate, _transform, aug_contrast=True,
                                           aug_noise=True)
    streams = _streams(3)
    losses = torch.stack([step(_torch(_stacked(streams, t)))["loss"] for t in range(3)])
    for i, (model, opt, want_losses) in enumerate(finals):
        assert torch.equal(losses[:, i], want_losses)
        got_sd, want_sd = vstate.models[i].state_dict(), model.state_dict()
        for key in want_sd:
            assert torch.equal(got_sd[key], want_sd[key]), (i, key)
        blob = tvec.state_for_seed(vstate, i)
        want_opt = opt.state_dict()
        assert blob["optimizer"]["param_groups"] == want_opt["param_groups"]
        for j, st in want_opt["state"].items():
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(blob["optimizer"]["state"][j][key], st[key]), (i, j, key)
        assert blob["optimizer"]["state"][0]["exp_avg"].dtype == getattr(torch, moments)
    # slice 0's dropout stream went on from where seed 0's serial run left it
    torch.manual_seed(SEEDS[0])
    assert not torch.equal(vstate.rng_states[0][0], torch.get_rng_state())


def test_vmap_matches_serial_runs_within_tolerance():
    """``"vmap"`` (unfused, dropout off) against the serial runs.  Measured
    on this host: losses within 2e-7 relative, weights and buffers within
    2.4e-7 after three steps (the batched convolutions sum in another
    order); the bounds below are 10x that."""
    finals = _serial_runs(3, with_dropout=False)
    vstate = tvec.create_vectorized_state(
        lambda: _port_model(with_dropout=False), SEEDS, LR, WD, device="cpu",
        seed_axis="vmap")
    step = tvec.make_vectorized_train_step(vstate, _transform, aug_contrast=True,
                                           aug_noise=True)
    streams = _streams(3)
    losses = torch.stack([step(_torch(_stacked(streams, t)))["loss"] for t in range(3)])
    for i, (model, _, want_losses) in enumerate(finals):
        torch.testing.assert_close(losses[:, i], want_losses, rtol=2e-6, atol=0)
        got_sd, want_sd = vstate.models[i].state_dict(), model.state_dict()
        for key in want_sd:
            torch.testing.assert_close(got_sd[key], want_sd[key], rtol=0, atol=2.4e-6)
        assert int(got_sd["cnn.3.num_batches_tracked"]) == 3


def test_fused_model_is_never_vmapped():
    """``"vmap"`` on a fused model raises naming the flag; the seed axis is
    ``"scan"`` unless ``"vmap"`` is asked for, fused or not."""
    with pytest.raises(ValueError, match="fused_layer2"):
        tvec.create_vectorized_state(
            lambda: _port_model(fused_layer2=True, with_dropout=False), [0, 1], LR, WD,
            device="cpu", seed_axis="vmap")
    with pytest.raises(ValueError, match="seed_axis"):
        tvec.create_vectorized_state(lambda: _port_model(), [0], LR, WD, device="cpu",
                                     seed_axis="pmap")
    for kw in (dict(fused_pool=True), dict(fused_pool=False)):
        vstate = tvec.create_vectorized_state(
            lambda kw=kw: _port_model(with_dropout=False, **kw), [0, 1], LR, WD, device="cpu")
        assert vstate.seed_axis == "scan" and not vstate.buffers
    with pytest.raises(ValueError, match="one value per seed"):
        tvec.create_vectorized_state(lambda: _port_model(), [0, 1, 2], LR, WD, device="cpu",
                                     hyperparams={"learning_rate": [4e-4, 1e-3]})


@pytest.mark.parametrize("seed_axis", ["vmap", "scan"])
def test_state_for_seed_and_stack_round_trip(seed_axis):
    """``stack_seed_states`` of the ``state_for_seed`` blobs rebuilds the
    state, and the rebuilt state steps on like the original."""
    kw = dict(with_dropout=False)
    vstate = tvec.create_vectorized_state(lambda: _port_model(**kw), SEEDS, LR, WD,
                                          device="cpu", seed_axis=seed_axis)
    streams = _streams(2)
    tvec.make_vectorized_train_step(vstate, _transform)(_torch(_stacked(streams, 0)))
    blobs = [tvec.state_for_seed(vstate, i) for i in range(len(SEEDS))]
    again = tvec.stack_seed_states(blobs, _port_model(**kw), seed_axis=seed_axis)
    assert again.step == 1
    batch = _torch(_stacked(streams, 1))
    a = tvec.make_vectorized_train_step(vstate, _transform)(batch)["loss"]
    b = tvec.make_vectorized_train_step(again, _transform)(batch)["loss"]
    assert torch.equal(a, b)
    for m, n in zip(vstate.models, again.models):
        for (k, u), (_, v) in zip(m.state_dict().items(), n.state_dict().items()):
            assert torch.equal(u, v), k


class _FakeLoader:
    def __init__(self, seed, n_batches):
        self.seed, self.n = seed, n_batches

    def epoch(self, epoch):
        rng = np.random.RandomState(self.seed * 1000 + epoch)
        for _ in range(self.n):
            yield {"audio": rng.randn(2, 1, 8).astype(np.float32),
                   "label": rng.randint(0, 2, 2).astype(np.int32)}


def test_multi_seed_epoch_stacks_per_seed_streams():
    got = list(tvec.multi_seed_epoch([_FakeLoader(s, 3) for s in SEEDS], epoch=0))
    want = list(jvec.multi_seed_epoch([_FakeLoader(s, 3) for s in SEEDS], epoch=0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].tobytes() == w[key].tobytes()
    with pytest.raises(RuntimeError, match="different batch counts"):
        list(tvec.multi_seed_epoch([_FakeLoader(0, 3), _FakeLoader(1, 2)], epoch=0))
