"""Port training step vs the JAX package's (CPU, narrow DCNN, dropout 0).

Both sides start from the same JAX-initialised variables (carried across by
``state_dict_from_jax``) and see the same numpy batches.  The transform is
the identity (images are fed directly), so what is compared is the model in
train mode, the loss, the gradients, Adam with L2, BatchNorm's running
statistics, gradient accumulation and the eval step.  With
``fused_layer1=True`` the JAX model runs its Pallas kernels in interpret
mode and the port its plain first block with BatchNorm fed from moments.

Dropout rates are 0 on both sides (the layers stay in place): the two
frameworks' random streams cannot be equated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiodeepfake_detection_tpu.models.dcnn import DCNN as JaxDCNN
from audiodeepfake_detection_tpu.ops import audio as jaudio
from audiodeepfake_detection_tpu.train import steps as jsteps
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.torch_import import (
    adam_state_from_jax,
    state_dict_from_jax,
)
from audiodeepfake_detection_tpu_torch.ops import audio as taudio
from audiodeepfake_detection_tpu_torch.train import steps as tsteps

LR, WD = 4e-4, 1e-3  # the reference headline config
STEPS, BATCH = 4, 8
SHAPE = (BATCH, 1, 256, 16)  # [B, C, F, T]: time_dim (16 + 2) // 8 = 2
KW = dict(time_dim=2, ochannels1=8, ochannels2=8, ochannels3=12, ochannels4=16,
          ochannels5=4, dropout_cnn=0.0, dropout_lstm=0.0)
FUSED = [False, True]


def _variables(jmodel, seed=0):
    variables = jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros(SHAPE, jnp.float32), train=False
    )
    return jax.tree.map(np.asarray, variables)


def _pair(fused, seed=0):
    jmodel = JaxDCNN(**KW, fused_layer1=fused)
    variables = _variables(jmodel, seed)
    port = DCNN(**KW, fused_layer1=fused)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, port


def _batches(n, seed=1, batch=BATCH):
    rs = np.random.RandomState(seed)
    return [
        (rs.randn(batch, *SHAPE[1:]).astype(np.float32),
         rs.randint(0, 3, batch).astype(np.int32))  # labels 0..2: "!= 0" matters
        for _ in range(n)
    ]


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _port_batch(x, labels, **extra):
    out = {"audio": torch.from_numpy(x), "label": torch.from_numpy(labels)}
    out.update({k: torch.from_numpy(v) for k, v in extra.items()})
    return out


@pytest.mark.parametrize("fused", FUSED)
def test_train_mode_logits_and_running_stats_match_jax(fused):
    jmodel, variables, port = _pair(fused)
    (x, _), = _batches(1)
    want, updates = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    port.train()
    got = port(torch.from_numpy(x))
    # fp32 convolutions in two frameworks; BN batch moments are one-pass
    # E[x^2]-E[x]^2 in JAX (and in the port's fused path), centred in
    # nn.BatchNorm2d: equal to fp32 roundoff
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    carried = state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])}
    )
    for key, val in port.state_dict().items():
        if "running_" in key or "num_batches" in key:
            np.testing.assert_allclose(
                val.numpy(), carried[key].numpy(), rtol=1e-4, atol=1e-5, err_msg=key
            )
    assert int(port.cnn[3].num_batches_tracked) == 1


@pytest.mark.parametrize("fused", FUSED)
def test_first_step_gradients_match_jax(fused):
    jmodel, variables, port = _pair(fused)
    (x, labels), = _batches(1)
    y = (labels != 0).astype(np.int32)

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
        )
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})

    port.train()
    loss = torch.nn.functional.cross_entropy(
        port(torch.from_numpy(x)), torch.from_numpy(y).long()
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    # same caps as the JAX package's own parity test against torch
    # (tests/test_train_parity.py): sums with heavy cancellation (one
    # shared PReLU slope, conv biases) amplify fp32 activation noise
    for name, p in port.named_parameters():
        cap = 0.15 if p.numel() == 1 else 0.05
        assert _rel_l2(p.grad.numpy(), want[name].numpy()) <= cap, name


def _jax_trajectory(jmodel, variables, batches, grad_accum=1):
    tx = jsteps.make_optimizer(LR, WD)
    state = jsteps.create_train_state(jmodel, tx, batches[0][0], variables=variables)
    step = jsteps.make_train_step(jmodel, lambda a: a, tx, grad_accum=grad_accum)
    stats = []
    for x, labels in batches:
        state, s = step(state, {"audio": x, "label": labels})
        stats.append((float(s["loss"]), float(s["acc"])))
    return state, stats


def _port_trajectory(port, batches, grad_accum=1, optimizer=None):
    optimizer = optimizer or tsteps.make_optimizer(port.parameters(), LR, WD)
    step = tsteps.make_train_step(port, lambda a: a, optimizer, grad_accum=grad_accum)
    stats = []
    for x, labels in batches:
        s = step(_port_batch(x, labels))
        assert s["loss"].ndim == 0 and s["acc"].ndim == 0
        stats.append((s["loss"].item(), s["acc"].item()))
    return stats


def _assert_states_close(port, state, steps):
    final = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, state.params),
         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}
    )
    # near-zero gradients make m/sqrt(v) sign-noisy across frameworks:
    # elementwise drift up to ~2*lr per step while the loss stays tight
    cap = 2 * steps * LR
    for key, val in port.state_dict().items():
        got, want = val.numpy(), final[key].numpy()
        if key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got, want, err_msg=key)
        elif "running_" in key:
            assert _rel_l2(got, want) <= 1e-3 and np.abs(got - want).max() <= 1e-3, key
        else:
            assert np.abs(got - want).max() <= cap, key
            if want.size > 1:
                assert np.median(np.abs(got - want)) <= LR / 4, key


@pytest.mark.parametrize("fused", FUSED)
def test_four_step_trajectory_matches_jax(fused):
    jmodel, variables, port = _pair(fused, seed=1)
    batches = _batches(STEPS, seed=2)
    state, want = _jax_trajectory(jmodel, variables, batches)
    got = _port_trajectory(port, batches)
    np.testing.assert_allclose([l for l, _ in got], [l for l, _ in want], rtol=5e-4)
    np.testing.assert_allclose([a for _, a in got], [a for _, a in want], atol=1e-6)
    _assert_states_close(port, state, STEPS)
    assert int(state.step) == STEPS


def test_grad_accum_two_matches_jax():
    """Two microbatches of 4: per-microbatch BN moments (running stats
    move twice per step) and the mean of the microbatch gradients."""
    jmodel, variables, port = _pair(True, seed=2)
    batches = _batches(2, seed=3)
    state, want = _jax_trajectory(jmodel, variables, batches, grad_accum=2)
    got = _port_trajectory(port, batches, grad_accum=2)
    np.testing.assert_allclose([l for l, _ in got], [l for l, _ in want], rtol=5e-4)
    np.testing.assert_allclose([a for _, a in got], [a for _, a in want], atol=1e-6)
    _assert_states_close(port, state, 2)
    assert int(port.cnn[3].num_batches_tracked) == 4
    with pytest.raises(ValueError, match="not divisible"):
        tsteps.make_train_step(
            port, lambda a: a, tsteps.make_optimizer(port.parameters(), LR, WD),
            grad_accum=3,
        )(_port_batch(*batches[0]))


def test_optimizer_state_carries_over():
    """Two JAX steps, then both packages continue from that mid-training
    state (parameters, BN statistics, Adam count/mu/nu) for two more."""
    jmodel, variables, _ = _pair(False, seed=3)
    batches = _batches(4, seed=4)
    tx = jsteps.make_optimizer(LR, WD)
    state = jsteps.create_train_state(jmodel, tx, batches[0][0], variables=variables)
    step = jsteps.make_train_step(jmodel, lambda a: a, tx)
    for x, labels in batches[:2]:
        state, _ = step(state, {"audio": x, "label": labels})
    mid = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    adam = state.opt_state[1]  # add_decayed_weights, scale_by_adam, scale
    count, mu, nu = int(adam.count), jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu)

    port = DCNN(**KW)
    port.load_state_dict(state_dict_from_jax(mid), strict=True)
    optimizer = tsteps.make_optimizer(port.parameters(), LR, WD)
    adam_state_from_jax(port, optimizer, count, mu, nu)
    carried = optimizer.state_dict()["state"]
    assert len(carried) == len(list(port.parameters()))
    assert all(float(s["step"]) == 2.0 for s in carried.values())
    np.testing.assert_array_equal(
        carried[0]["exp_avg"].numpy(),
        np.transpose(mu["cnn_0"]["Conv_0"]["kernel"], (3, 2, 0, 1)),
    )

    want = []
    for x, labels in batches[2:]:
        state, s = step(state, {"audio": x, "label": labels})
        want.append(float(s["loss"]))
    got = _port_trajectory(port, batches[2:], optimizer=optimizer)
    np.testing.assert_allclose([l for l, _ in got], want, rtol=5e-4)
    _assert_states_close(port, state, 2)
    assert float(optimizer.state_dict()["state"][0]["step"]) == 4.0


def test_eval_step_every_output_matches_jax():
    jmodel, variables, port = _pair("always", seed=4)
    (x, labels), = _batches(1, seed=5)
    labels = np.asarray([0, 1, 2, 13, 0, 5, 0, 0], np.int32)
    weight = np.asarray([1, 1, 1, 1, 1, 1, 0, 0], np.float32)  # padded tail
    jstep = jsteps.make_eval_step(jmodel, lambda a: a)
    tstep = tsteps.make_eval_step(port, lambda a: a)
    for extra in ({}, {"weight": weight}):
        want = jstep(variables["params"], variables["batch_stats"],
                     {"audio": x, "label": labels, **extra})
        got = tstep(_port_batch(x, labels, **extra))
        assert set(got) == set(want)
        for key in want:
            w, g = np.asarray(want[key]), got[key].numpy()
            assert g.shape == w.shape, key
            if key == "scores":
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=key)
            else:
                np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=key)
    assert got["count_per_label"].shape == (tsteps.MAX_LABELS,)
    assert got["total"].item() == 6.0
    assert not port.training


def test_int16_audio_converts_like_jax():
    pcm = np.random.RandomState(0).randint(-32768, 32767, (2, 1, 64)).astype(np.int16)
    np.testing.assert_array_equal(
        tsteps.audio_to_float(torch.from_numpy(pcm)).numpy(),
        np.asarray(jsteps.audio_to_float(jnp.asarray(pcm))),
    )


def test_contrast_and_add_noise_match_jax():
    rs = np.random.RandomState(6)
    wave = (0.4 * rs.randn(3, 1, 2048)).astype(np.float32)
    noise = rs.randn(3, 1, 2048).astype(np.float32)
    snr = rs.uniform(30, 40, (3, 1)).astype(np.float32)
    # elementwise sin / log10 / pow in two libraries: last-digit differences
    np.testing.assert_allclose(
        taudio.contrast(torch.from_numpy(wave), 12.5).numpy(),
        np.asarray(jaudio.contrast(jnp.asarray(wave), 12.5)), rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        taudio.add_noise(*map(torch.from_numpy, (wave, noise, snr))).numpy(),
        np.asarray(jaudio.add_noise(*map(jnp.asarray, (wave, noise, snr)))),
        rtol=1e-5, atol=1e-6,
    )


def test_augment_in_distribution():
    """The generators differ, so ``augment`` is checked by what it promises:
    noise at 30-40 dB SNR, contrast as ``contrast(wave, U(5, 20))``, and
    the same draws from the same generator state."""
    wave = torch.from_numpy((0.3 * np.random.RandomState(7).randn(4, 1, 8192)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    noisy = taudio.augment(gen, wave, use_noise=True)
    snr = 10 * torch.log10(wave.pow(2).sum(-1) / (noisy - wave).pow(2).sum(-1))
    assert ((snr > 29.9) & (snr < 40.1)).all()
    assert torch.allclose(snr, snr[0])  # one SNR draw per call
    shaped = taudio.augment(gen, wave, use_contrast=True)
    lo, hi = taudio.contrast(wave, 5.0), taudio.contrast(wave, 20.0)
    assert ((shaped - lo) * (shaped - hi) <= 1e-9).all()  # between the extremes
    assert torch.equal(taudio.augment(gen, wave), wave)
    gen.set_state(state)
    assert torch.equal(taudio.augment(gen, wave, use_noise=True), noisy)


def test_augmented_train_step_runs_and_needs_a_generator():
    _, _, port = _pair(False)
    (x, labels), = _batches(1)
    optimizer = tsteps.make_optimizer(port.parameters(), LR, WD)
    with pytest.raises(ValueError, match="torch.Generator"):
        tsteps.make_train_step(port, lambda a: a, optimizer, aug_noise=True)
    step = tsteps.make_train_step(
        port, lambda a: a, optimizer, aug_contrast=True, aug_noise=True,
        generator=torch.Generator().manual_seed(0),
    )
    assert np.isfinite(step(_port_batch(np.tanh(x), labels))["loss"].item())


def test_low_precision_adam_moments_name_their_slice():
    _, _, port = _pair(False)
    with pytest.raises(NotImplementedError, match="slice 5"):
        tsteps.make_optimizer(port.parameters(), LR, WD, moment_dtype="bfloat16")
    opt = tsteps.make_optimizer(port.parameters(), LR, WD, moment_dtype="float32")
    group = opt.param_groups[0]
    assert (group["lr"], group["weight_decay"], group["betas"], group["eps"]) == (
        LR, WD, (0.9, 0.999), 1e-8)
    assert len(group["params"]) == len(list(port.parameters()))  # decay on all
