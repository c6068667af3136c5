"""The port's data parallelism against the JAX package's (gloo, CPU).

One spawn of 4 rank processes (``tests/torch_dist_workers.py``, one thread
each) computes everything; the 2-rank parts run on each pair of a ``(2,
2)`` mesh.  Meanwhile this process runs the JAX side on its 8 virtual
devices, at ``tests/test_parallel.py``'s sizes: the narrow DCNN, a
``[16, 1, 2048]`` batch through the haar level-8 log packets, one SGD step
(the parameters stay linear in the gradients), dropout off.  Both sides
start from the same weights (the port's, carried into JAX by its
``import_dcnn``).

Held here:

* the port's DDP step (unfused) against JAX's ``make_train_step`` on a
  2-device mesh: loss, parameters, BatchNorm buffers; the moments each
  synchronized BatchNorm normalised with against the sum of the ranks'
  own and against one process's on the whole batch;
* the fused DDP step (kernels 2, 5 and 6's plain versions, their moments
  summed over the ranks) against the unfused one, as JAX's
  ``TestShardMappedFusedKernels`` holds its shard-mapped kernels;
* DDP against one process on the whole batch; the LCNN with kernel 3's
  block and its six synchronized BatchNorms the same way;
* parameters and buffers bit-equal across the ranks;
* FSDP2 against DDP and against JAX's ``make_fsdp_train_step``; Adam's
  moments sharded; the snapshot in the ``.pt`` layout and ``--resume``;
* ``sp_wpt_analysis`` over 2 and 4 ranks against JAX's on 2 and 4
  devices and against the dense plain WPT, and the fingerprint routing;
* the refusals.

Tolerances are stated beside each check with the error measured here.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_dist_workers as workers
from audiodeepfake_detection_tpu.analysis.fingerprints import mean_wpt_spectrum as jax_spectrum
from audiodeepfake_detection_tpu.models import DCNN as JaxDCNN
from audiodeepfake_detection_tpu.models.torch_import import import_dcnn
from audiodeepfake_detection_tpu.ops.wpt import packet_image as jax_packet_image
from audiodeepfake_detection_tpu.parallel.fsdp import make_fsdp_train_step, shard_fsdp
from audiodeepfake_detection_tpu.parallel.mesh import get_mesh, replicate, shard_batch
from audiodeepfake_detection_tpu.parallel.sequence import sp_wpt_analysis as jax_sp_wpt
from audiodeepfake_detection_tpu.parallel.sequence import sp_wpt_min_len as jax_min_len
from audiodeepfake_detection_tpu.train.steps import create_train_state, make_train_step
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
from audiodeepfake_detection_tpu_torch.models.torch_import import state_dict_from_jax
from audiodeepfake_detection_tpu_torch.parallel import sequence
from audiodeepfake_detection_tpu_torch.parallel.fsdp import shard_dim
from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

SP_IDS = [f"{w}-L{lv}" for w, lv, *_ in workers.SP_CASES]


def _inputs():
    torch.manual_seed(0)
    dcnn = DCNN(**workers.KW).state_dict()
    torch.manual_seed(1)
    lcnn = LCNN(lstm_channels=32, fused_layer1=True, dropout=0.0).state_dict()
    rng = np.random.RandomState(0)
    audio = rng.randn(16, 1, 2048).astype(np.float32)
    label = rng.randint(0, 2, 16).astype(np.int32)
    image = np.random.RandomState(5).randn(16, 1, 32, 32).astype(np.float32)
    return {"dcnn": dcnn, "lcnn": lcnn, "audio": torch.from_numpy(audio),
            "label": torch.from_numpy(label), "image": torch.from_numpy(image)}


def _jax_side(inputs, devices):
    """JAX's DP and FSDP steps on 2 devices and its sequence-parallel WPT
    on 2 and 4, from the same weights and batch."""
    variables = import_dcnn({k: v.numpy() for k, v in inputs["dcnn"].items()})
    model = JaxDCNN(**workers.KW)
    tx = optax.sgd(workers.LR)
    batch = {"audio": inputs["audio"].numpy(), "label": inputs["label"].numpy()}

    def transform(audio):
        return jax_packet_image(audio, "haar", level=8, log_scale=True)

    mesh = get_mesh(devices[:2])
    db = shard_batch(mesh, batch)
    s = create_train_state(model, tx, None, variables=variables)
    s = s._replace(params=replicate(mesh, s.params),
                   batch_stats=replicate(mesh, s.batch_stats),
                   opt_state=replicate(mesh, s.opt_state))
    dp_state, dp_stats = make_train_step(model, transform, tx)(s, db)
    s = create_train_state(model, tx, None, variables=variables)
    s = s._replace(params=shard_fsdp(s.params, mesh, min_bytes=0),
                   batch_stats=replicate(mesh, s.batch_stats),
                   opt_state=shard_fsdp(s.opt_state, mesh, min_bytes=0))
    fsdp_state, fsdp_stats = make_fsdp_train_step(model, transform, tx, mesh, min_bytes=0)(s, db)

    def as_torch(state):
        return state_dict_from_jax(jax.tree.map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))

    sp = {}
    for n in (2, 4):
        m = get_mesh(devices[:n])
        for wavelet, level, t, seed, rows in workers.SP_CASES:
            x = jnp.asarray(np.random.RandomState(seed).randn(rows, t).astype(np.float32))
            # the first coif4 call builds its taps (~20 s here, in both
            # packages: a root-finding solve); the rest compile in < 1 s
            sp[n, wavelet, level] = np.asarray(jax_sp_wpt(x, wavelet, level, m))
    rng = np.random.RandomState(4)
    clips = [rng.randn(8 * 2**10 + 137).astype(np.float32),
             rng.randn(2**10 + 3).astype(np.float32)]
    spectra = {n: jax_spectrum(clips, "haar", 10, mesh=get_mesh(devices[:n])) for n in (2, 4)}
    return {"dp": (float(dp_stats["loss"]), as_torch(dp_state)),
            "fsdp": (float(fsdp_stats["loss"]), as_torch(fsdp_state)),
            "sp": sp, "spectra": spectra}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    """``(ranks, jax)``: the 4 ranks' results and JAX's, computed at once."""
    directory = tmp_path_factory.mktemp("parallel")
    inputs = _inputs()
    torch.save(inputs, directory / "inputs.pt")
    failure = []

    def run():
        try:
            workers.spawn("parallel", str(directory), 4)
        except Exception as exc:  # re-raised below, with the ranks' output
            failure.append(exc)

    thread = threading.Thread(target=run)
    thread.start()
    jax_out = _jax_side(inputs, eight_devices)
    thread.join()
    if failure:
        raise failure[0]
    ranks = [torch.load(directory / f"parallel_rank{r}.pt", weights_only=False)
             for r in range(4)]
    return ranks, jax_out, inputs


def _max_abs(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) if a.size else 0.0


def _assert_states(got: dict, want: dict, rtol: float, atol: float, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol, err_msg=k)


def _buffers(state):
    return [k for k in state if "running_" in k]


def _params(state):
    return [k for k in state if "running_" not in k and "num_batches" not in k]


# ------------------------------------------------------------------ DDP


def test_ddp_step_matches_jax_two_device_step(runs):
    ranks, jax_out, _ = runs
    loss, want = jax_out["dp"]
    got = ranks[0]["ddp"]
    # two frameworks' fp32 sums (the WPT, every convolution, the one-pass
    # moments over 2 ranks); measured: loss 0.0, parameters 3.0e-8 and
    # buffers 2.4e-7 absolute (the running variances 1.9e-5 relative)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    _assert_states(got["state"], want, rtol=1e-4, atol=2e-6, keys=_params(want))
    _assert_states(got["state"], want, rtol=1e-4, atol=2e-5, keys=_buffers(want))


def test_synchronized_moments_are_the_global_batchs(runs):
    """Every BatchNorm of the DDP step normalised with the sum of the two
    ranks' own moments (the all-reduce), which are the moments of one
    process on the whole batch; a rank's own moments are not."""
    ranks, _, _ = runs
    used = ranks[0]["ddp"]["used_moments"]
    whole = ranks[0]["single"]["local_moments"]
    own = [ranks[r]["ddp"]["local_moments"] for r in (0, 1)]
    assert len(used) == len(whole) == len(own[0]) == 8  # every BN of the DCNN
    for i, ((s, q), (ws, wq)) in enumerate(zip(used, whole)):
        s_sum = own[0][i][0] + own[1][i][0]
        q_sum = own[0][i][1] + own[1][i][1]
        # the sum of the ranks' own moments: measured 0.0; one process's on
        # the whole batch, fp32 sums in another grouping: 4.2e-6 of the
        # largest sum; a rank's own half alone: >= 0.499 off
        scale = float(ws.abs().max())
        assert _max_abs(s, s_sum) <= 1e-6 * scale, i
        assert _max_abs(q, q_sum) <= 1e-6 * float(wq.abs().max()), i
        assert _max_abs(s, ws) <= 1e-5 * scale, i
        assert _max_abs(q, wq) <= 1e-5 * float(wq.abs().max()), i
        # without the all-reduce a rank normalises with its own half
        assert _max_abs(own[0][i][0], ws) > 1e-3 * scale, i


def test_ddp_step_matches_one_process_on_the_whole_batch(runs):
    ranks, _, _ = runs
    got, want = ranks[0]["ddp"], ranks[0]["single"]
    # reduction order between one process and two ranks (JAX measured
    # ~2e-4 between one device and many, tests/test_parallel.py:150-157);
    # measured here: loss 0.0, parameters 3.0e-8, buffers 1.2e-7
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_states(got["state"], want["state"], rtol=1e-4, atol=2e-6,
                   keys=_params(want["state"]))
    _assert_states(got["state"], want["state"], rtol=1e-4, atol=2e-5,
                   keys=_buffers(want["state"]))


def test_fused_ddp_step_matches_unfused_ddp_step(runs):
    ranks, _, _ = runs
    got, want = ranks[0]["ddp_fused"], ranks[0]["ddp"]
    # JAX's own tolerances for its shard-mapped kernels against the
    # unfused step (tests/test_parallel.py:200-211); measured here: loss
    # 0.0, parameters 3.0e-8, buffers 6.0e-8
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_states(got["state"], want["state"], rtol=1e-3, atol=2e-5)
    # the BNs behind kernels 2, 5 and 6 took the all-reduced moments (7:
    # kernel 6 folds cnn[6] into its weights from the global moments, whose
    # running buffers the state comparison holds)
    assert len(got["used_moments"]) == 7


@pytest.mark.parametrize("part,what", [("ddp", "state"), ("ddp_fused", "state"),
                                       ("lcnn_ddp", "state"), ("grid_ddp", "state"),
                                       ("fsdp", "buffers")])
def test_ranks_hold_the_same_bits(runs, part, what):
    """Parameters and BatchNorm buffers (under FSDP the buffers: its
    parameters are shards) are the same on every rank."""
    ranks, _, _ = runs
    a, b = ranks[0][part][what], ranks[1][part][what]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the other pair ran the same computation
    for k in a:
        assert torch.equal(a[k], ranks[2][part][what][k]), k


def test_lcnn_ddp_with_kernel_3_matches_one_process(runs):
    ranks, _, _ = runs
    got, want = ranks[0]["lcnn_ddp"], ranks[0]["lcnn_single"]
    bns = [k for k in want["state"] if "running_var" in k]
    assert len(bns) == 6
    # measured: loss 1.7e-7 relative, parameters 1.5e-8, buffers 6.0e-8
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_states(got["state"], want["state"], rtol=1e-4, atol=2e-6,
                   keys=_params(want["state"]))
    _assert_states(got["state"], want["state"], rtol=1e-4, atol=2e-5,
                   keys=_buffers(want["state"]))


def test_grid_model_batchnorms_are_synchronized(runs):
    """The factory makes the grid model's ``SyncBatchNorm`` and
    ``BatchNorm2d`` the port's synchronized BatchNorm under a mesh: the DDP
    step equals one process on the whole batch."""
    ranks, _, _ = runs
    got, want = ranks[0]["grid_ddp"], ranks[0]["grid_single"]
    assert got["synced"] == [True, True] and want["synced"] == [False, False]
    # measured: loss 0.0, parameters 4.7e-8, buffers 6.0e-8
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_states(got["state"], want["state"], rtol=1e-4, atol=2e-6,
                   keys=_params(want["state"]))
    _assert_states(got["state"], want["state"], rtol=1e-4, atol=2e-5,
                   keys=_buffers(want["state"]))


# ----------------------------------------------------------------- FSDP


def test_fsdp_step_matches_ddp_and_jax_fsdp(runs):
    ranks, jax_out, _ = runs
    got = ranks[0]["fsdp"]
    # the same math as DDP: measured loss 0.0, parameters 0.0, buffers 0.0
    np.testing.assert_allclose(got["loss"], ranks[0]["ddp"]["loss"], rtol=1e-5)
    _assert_states(got["state"], ranks[0]["ddp"]["state"], rtol=1e-4, atol=2e-6)
    loss, want = jax_out["fsdp"]
    # JAX's FSDP test against its DP step: loss rtol 1e-5, parameters rtol
    # 1e-4 / atol 2e-6 (tests/test_parallel.py:462-472); measured: loss
    # 8.5e-8 relative, parameters 1.5e-8, buffers 2.4e-7
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    _assert_states(got["state"], want, rtol=1e-4, atol=2e-6, keys=_params(want))
    _assert_states(got["state"], want, rtol=1e-4, atol=2e-5, keys=_buffers(want))


def test_fsdp_adam_moments_are_sharded(runs):
    """Each Adam moment lives in shards: a rank holds its chunk of the
    parameter's largest dim that divides by the ranks (JAX ``fsdp_specs``),
    or of dim 0 (padded), and the ranks' chunks make up the leaf."""
    ranks, _, _ = runs
    halves = 0
    for name, (shape, local0, frac0) in ranks[0]["fsdp_adam"]["moments"].items():
        _, local1, frac1 = ranks[1]["fsdp_adam"]["moments"][name]
        numel = int(np.prod(shape))
        dim = shard_dim(shape, 2)
        chunk = -(-shape[dim] // 2) * numel // shape[dim]
        assert (local0, local1) == (chunk, numel - chunk), name
        assert frac0 == local0 / numel and frac1 == local1 / numel, name
        halves += shape[dim] % 2 == 0
    assert halves >= 14  # 14 of the leaves split in halves


def test_fsdp_snapshot_is_the_pt_layout_and_resumes(runs):
    ranks, _, _ = runs
    res = ranks[0]["resume"]
    snap = torch.load(res["snapshot"], weights_only=True)
    assert set(snap) == {"MODEL_STATE", "EPOCHS_RUN"} and snap["EPOCHS_RUN"] == 0
    single = DCNN(**workers.KW)
    single.load_state_dict(snap["MODEL_STATE"], strict=True)  # the reference keys
    for k, v in res["saved"].items():
        assert torch.equal(snap["MODEL_STATE"][k], v), k
    assert res["resumed"] == (1, 2)
    # the full optimizer state came back: the third step repeats bit for bit
    for k, v in res["after"].items():
        assert torch.equal(res["resumed_after"][k], v), k


# --------------------------------------------------------- sequence WPT


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", workers.SP_CASES, ids=SP_IDS)
def test_sp_wpt_matches_jax_and_the_dense_cascade(runs, shards, case):
    ranks, jax_out, _ = runs
    wavelet, level, t, seed, rows = case
    got = ranks[0][f"sp{shards}"][(wavelet, level)]
    assert np.array_equal(got, ranks[1][f"sp{shards}"][(wavelet, level)])  # every rank
    # the port's dense plain cascade of the same clip, computed by the rank
    # (which has built the wavelet's taps already)
    dense = ranks[0][f"sp{shards}"]["dense", wavelet, level]
    assert got.shape == dense.shape == (rows, 2**level, dense.shape[-1])
    # JAX's tolerances for its sharded cascade against its dense one
    # (tests/test_parallel.py: 1e-5 haar, 2e-5 long filters, 2e-4 at level
    # 14); measured here 0.0 at every case against both
    atol = 2e-4 if level == 14 else (1e-5 if wavelet == "haar" else 2e-5)
    np.testing.assert_allclose(got, dense, atol=atol)
    np.testing.assert_allclose(got, jax_out["sp"][shards, wavelet, level], atol=atol)


@pytest.mark.parametrize("shards", [2, 4])
def test_fingerprint_spectrum_routes_through_the_sharded_cascade(runs, shards):
    ranks, jax_out, _ = runs
    got = ranks[0][f"sp{shards}"]["spectrum"]
    assert got.shape == (2**10,)
    # JAX's own test of the routed spectrum: rtol 1e-5, atol 1e-6;
    # measured 5.6e-8 of the largest entry
    np.testing.assert_allclose(got, jax_out["spectra"][shards], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wavelet,level,shards", [
    ("haar", 14, 2), ("sym5", 3, 4), ("db4", 3, 2), ("db4", 5, 8), ("db8", 8, 4)])
def test_sp_wpt_min_len_is_jaxs(wavelet, level, shards):
    assert sequence.sp_wpt_min_len(wavelet, level, shards) == jax_min_len(
        wavelet, level, shards)


# ------------------------------------------------------------- refusals


def test_refusals_on_a_world_of_two(runs):
    ranks, _, _ = runs
    out = ranks[0]["refusals"]
    assert "not divisible by the 2 ranks" in out["indivisible"]
    assert out["device_data_kept"] is False  # streams, as JAX does on hosts
    assert "one rank: this world has 4" in out["sweep"]


def _args(**extra):
    args = default_config()
    args.update(learning_rate=1e-3, weight_decay=0.0, seed=0, **extra)
    return DotDict(args)


@pytest.mark.parametrize("extra,error,match", [
    (dict(fsdp=True, pp_stages=2), ValueError, "mutually exclusive"),
    (dict(device_data=True, fsdp=True), ValueError, "device_data is for"),
    (dict(pp_stages=2), ValueError, "DCNN has no embed/classify methods"),
])
def test_trainer_refusals(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        Trainer(DCNN(**workers.KW), lambda a: a, _args(**extra), str(tmp_path / "m"),
                device="cpu")


def test_sp_wpt_refuses_unaligned_and_short_clips():
    with pytest.raises(ValueError, match="must divide"):
        sequence.sp_wpt_analysis(torch.zeros(1, 1001), "haar", 3, None)
    with pytest.raises(ValueError, match="too short"):
        sequence.sp_wpt_analysis(torch.zeros(1, 2**5), "db4", 5, None)
