"""The ported serving slice as a whole vs the JAX reference (CPU).

One config-encoded packets-sym5 DCNN snapshot (``.pt`` written from JAX
variables with ``export_state_dict``) plus a ``.norm.pkl`` sidecar is
loaded by both packages' ``build_scorer_from_snapshot``; their scorers get
the same frames.  Then the port's ``ScoringService`` answers HTTP requests
on the CPU.
"""

import io
import json
import pickle
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from audiodeepfake_detection_tpu.models.dcnn import DCNN as JaxDCNN
from audiodeepfake_detection_tpu.models.torch_import import export_state_dict
from audiodeepfake_detection_tpu.train import predict as jax_predict
from audiodeepfake_detection_tpu_torch.ops import wpt_cuda
from audiodeepfake_detection_tpu_torch.train import predict
from audiodeepfake_detection_tpu_torch.train.serve import (
    ScoringService,
    service_from_snapshot,
)
from audiodeepfake_detection_tpu_torch.utils.config import default_config
from audiodeepfake_detection_tpu_torch.utils.naming import experiment_model_file
from test_torch_dcnn import jax_variables

SR = 22050
# Scores of the whole slice, port vs JAX, on 1 s frames: the transforms
# agree to fp32 roundoff except where log(|x|^2 + 1e-12) meets a
# coefficient near zero, and the DCNN sums in another order.  Measured on
# this test's inputs: max |diff| 6e-8 in P(fake), 1.8e-7 in the margin.
PROB_ATOL = 1e-5
MARGIN_ATOL, MARGIN_RTOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    # no TF32 on the CPU; stated anyway for the fp32 parity contract
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """Full-width DCNN snapshot with random weights and BN stats."""
    root = tmp_path_factory.mktemp("snap")
    (root / "models").mkdir()
    args = default_config()
    args.update(
        data_prefix="x/fake_22050_22050_0.7_fbmelgan",
        transform="packets",
        wavelet="sym5",
        num_of_scales=256,
        only_use=["ljspeech", "fbmelgan"],
    )
    path = experiment_model_file(args, str(root), "DCNN") + ".pt"
    variables = jax_variables(JaxDCNN(time_dim=12), (1, 1, 256, 95), seed=3)
    state = export_state_dict(variables, "dcnn")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, path)
    # log-packet images of this test's audio: mean -4.7, std 2.3 (measured)
    with open(path + ".norm.pkl", "wb") as fh:
        pickle.dump([np.asarray([-5.0], np.float32), np.asarray([4.0], np.float32)], fh)
    return path


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    return (0.3 * np.tanh(rng.randn(n, SR))).astype(np.float32)


@pytest.mark.parametrize("output", ["prob", "margin"])
def test_scorer_matches_jax(snapshot, output):
    frames = _frames(2, seed=0)[:, None, :]
    jmodel, jtransform, jvars, jcfg = jax_predict.build_scorer_from_snapshot(
        snapshot
    )
    want = np.asarray(
        jax_predict.make_score_fn(jmodel, jtransform, jvars, output=output)(
            jnp.asarray(frames)
        )
    )
    model, transform, cfg = predict.build_scorer_from_snapshot(snapshot)
    assert (cfg.wavelet, cfg.model_name) == (jcfg.wavelet, jcfg.model_name) == ("sym5", "DCNN")
    got = predict.make_score_fn(model, transform, "cpu", output=output)(
        torch.from_numpy(frames)
    ).numpy()
    assert got.shape == want.shape == (2,)
    if output == "prob":
        assert ((got > 0) & (got < 1)).all()
        np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=MARGIN_RTOL, atol=MARGIN_ATOL)
    assert wpt_cuda.LAUNCHES == 0  # CPU tensors never reach the kernel


def test_chunked_scorer_equals_whole_batch(snapshot):
    model, transform, _ = predict.build_scorer_from_snapshot(snapshot)
    frames = torch.from_numpy(_frames(4, seed=1)[:, None, :])
    whole = predict.make_score_fn(model, transform, "cpu")(frames)
    chunked = predict.make_score_fn(model, transform, "cpu", chunk=2)(frames)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="does not divide"):
        predict.make_score_fn(model, transform, "cpu", chunk=3)(frames)


def test_missing_cuda_raises_unless_cpu_asked(snapshot):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        service_from_snapshot(snapshot)  # device defaults to cuda


def _wav_bytes(pcm: np.ndarray, sr: int = SR) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


@pytest.fixture(scope="module")
def http_service(snapshot):
    svc = service_from_snapshot(snapshot, batch_size=2, device="cpu")
    server = svc.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    with svc:
        thread.start()
        yield svc, f"http://127.0.0.1:{server.server_port}"
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def _pcm(n, seed):
    return np.random.RandomState(seed).randint(-12000, 12000, size=n).astype(np.int16)


def _direct_scores(svc, frames):
    """The service's scorer on batches padded exactly like serving."""
    out = np.empty(len(frames), np.float32)
    for s in range(0, len(frames), svc.batch_size):
        part = frames[s : s + svc.batch_size]
        batch = np.zeros((svc.batch_size, 1, svc.win), np.float32)
        batch[: len(part), 0] = part
        out[s : s + len(part)] = svc._score(torch.from_numpy(batch)).numpy()[: len(part)]
    return out


def test_http_score_matches_direct_path(http_service):
    svc, url = http_service
    pcm = _pcm(3 * SR + 100, seed=4)  # 3 frames + a tail that is dropped
    code, payload = _post(url + "/score", _wav_bytes(pcm))
    assert code == 200, payload
    assert payload["frames"] == 3 and payload["aggregate"] == "mean"
    frames = (pcm[: 3 * SR].astype(np.float32) / 32768.0).reshape(3, SR)
    direct = _direct_scores(svc, frames)
    np.testing.assert_allclose(payload["frame_scores"], direct, rtol=1e-6)
    assert payload["p_fake"] == pytest.approx(float(direct.mean()), rel=1e-6)
    assert all(0.0 <= p <= 1.0 for p in payload["frame_scores"])


def test_healthz(http_service):
    svc, url = http_service
    with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
        assert resp.status == 200
        payload = json.loads(resp.read())
    assert payload["status"] == "ok"
    assert payload["model"] == "DCNN"
    assert payload["device"] == "cpu"
    assert payload["batch_size"] == 2
    assert payload["sample_rate"] == SR and payload["frame_samples"] == SR
    assert payload["pcm16"] is False and payload["chunk"] == 0
    assert payload["dispatches"] == svc.n_dispatches


def test_http_errors(http_service):
    svc, url = http_service
    code, payload = _post(url + "/score", b"\x00\x01notaudio" * 16)
    assert code == 400 and "unrecognized" in payload["error"]
    code, _ = _post(url + "/nope", b"x")
    assert code == 404
    old = svc.max_body_bytes
    svc.max_body_bytes = 1024
    try:
        code, payload = _post(url + "/score", _wav_bytes(_pcm(SR, seed=5)))
    finally:
        svc.max_body_bytes = old
    assert code == 413 and "too large" in payload["error"]


def test_pcm16_bit_exact_vs_float_service(http_service, snapshot):
    """A 16-bit wav decodes to pcm/32768; the pcm16 wire re-rounds to the
    same ints, so the scores equal the float service's exactly."""
    svc, _ = http_service
    pcm = _pcm(2 * SR, seed=6)
    audio = pcm.astype(np.float32) / 32768.0
    with service_from_snapshot(
        snapshot, batch_size=2, device="cpu", pcm16=True
    ) as pcm_svc:
        s_p, fs_p = pcm_svc.score_clip(audio, SR)
    s_f, fs_f = svc.score_clip(audio, SR)
    assert s_p == s_f
    np.testing.assert_array_equal(fs_p, fs_f)


def test_chunk_must_divide_batch(snapshot):
    model, transform, _ = predict.build_scorer_from_snapshot(snapshot)
    with pytest.raises(ValueError, match="does not divide"):
        ScoringService(model, transform, device="cpu", batch_size=4, chunk=3, warmup=False)


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    """Two clips: 2.5 s at 22050 Hz and 2 s at 44100 Hz (resampled)."""
    root = tmp_path_factory.mktemp("wavs")
    paths = []
    for i, (sec, rate) in enumerate([(2.5, SR), (2.0, 2 * SR)]):
        path = root / f"clip{i}.wav"
        path.write_bytes(_wav_bytes(_pcm(int(sec * rate), seed=10 + i), rate))
        paths.append(str(path))
    return paths


def test_score_files_and_norm_stats_match_jax(snapshot, wav_files, tmp_path):
    jmodel, jtransform, jvars, _ = jax_predict.build_scorer_from_snapshot(snapshot)
    want = jax_predict.score_files(
        jmodel, jtransform, jvars, wav_files, batch_size=2
    )
    model, transform, _ = predict.build_scorer_from_snapshot(snapshot)
    got = predict.score_files(model, transform, wav_files, "cpu", batch_size=2)
    assert set(got) == set(want) == set(wav_files)
    for path in wav_files:
        assert got[path] == pytest.approx(want[path], abs=PROB_ATOL)

    want_m, want_s = jax_predict.estimate_norm_stats(snapshot, wav_files)
    out = str(tmp_path / "stats.pkl")
    got_m, got_s = predict.estimate_norm_stats(snapshot, wav_files, "cpu", out=out)
    # Welford over ~1e5 log-packet values in float32 on both sides
    np.testing.assert_allclose(got_m, np.asarray(want_m), rtol=1e-5)
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=1e-5)
    with open(out, "rb") as fh:
        saved = pickle.load(fh)
    np.testing.assert_array_equal(saved[0], got_m)


def test_predict_cli_scores_files(snapshot, wav_files, capsys):
    predict.main([snapshot, *wav_files, "--device", "cpu", "--batch-size", "2", "--json"])
    scores = json.loads(capsys.readouterr().out)
    model, transform, _ = predict.build_scorer_from_snapshot(snapshot)
    direct = predict.score_files(model, transform, wav_files, "cpu", batch_size=2)
    assert scores == pytest.approx(direct, abs=1e-7)
    # post-training int8 (calibrated on the scored frames): within the JAX
    # package's int8 budget of the fp scores (test_int8_quality.py:211)
    predict.main([snapshot, *wav_files, "--device", "cpu", "--batch-size", "2", "--json",
                  "--int8"])
    int8 = json.loads(capsys.readouterr().out)
    assert sorted(int8) == sorted(scores)
    assert all(abs(int8[p] - scores[p]) < 0.1 and int8[p] != scores[p] for p in scores)


def test_service_kernel_switch_scores_through_the_plain_cascade(snapshot, monkeypatch):
    """``use_kernel=False`` (serve's ``--no-kernel``, JAX's ``--no-pallas``)
    scores through the plain wavelet-packet cascade, never the op, as
    ``make_score_fn`` does through the plain transform; the default goes
    through the op; the CLI flag reaches the builder."""
    from audiodeepfake_detection_tpu_torch.train import serve

    calls = []
    op = wpt_cuda.wpt_packets
    monkeypatch.setattr(wpt_cuda, "wpt_packets", lambda *a: calls.append(a) or op(*a))
    audio = (_pcm(2 * SR, seed=7).astype(np.float32) / 32768.0)
    with service_from_snapshot(snapshot, batch_size=2, device="cpu", use_kernel=False) as svc:
        calls.clear()
        score, frame_scores = svc.score_clip(audio, SR)
    assert not calls
    model, transform, _ = predict.build_scorer_from_snapshot(snapshot, use_kernel=False)
    direct = predict.make_score_fn(model, transform, "cpu")(
        torch.from_numpy(audio.reshape(2, 1, SR))).numpy()
    np.testing.assert_array_equal(frame_scores, direct)
    with service_from_snapshot(snapshot, batch_size=2, device="cpu") as default:
        calls.clear()
        _, op_scores = default.score_clip(audio, SR)
    assert calls  # the default goes through the op (its plain version here)
    np.testing.assert_allclose(op_scores, frame_scores, atol=1e-6)

    seen = []

    def builder(snapshot, **kw):
        seen.append(kw["use_kernel"])
        raise KeyboardInterrupt

    monkeypatch.setattr(serve, "service_from_snapshot", builder)
    for flags in ([], ["--no-kernel"]):
        with pytest.raises(KeyboardInterrupt):
            serve.main([snapshot, "--device", "cpu", *flags])
    assert seen == [True, False]
