"""Each frozen plain reference agrees with the port at a tiny size, on the
CPU (the port's kernels run their plain versions here)."""

import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu_torch.models.ast import ASTModel
from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
from audiodeepfake_detection_tpu_torch.ops.stft import spectrogram
from audiodeepfake_detection_tpu_torch.ops.wavelets import get_wavelet
from audiodeepfake_detection_tpu_torch.ops.wpt import packet_image
from gpubench import cells, inputs
from gpubench.reference import _common

DCNN_REF = cells.reference_module("dcnn-wpt-sym5-l8")
AST_REF = cells.reference_module("ast-base384-stft")


def _weights(model, seed):
    shapes = {n: (tuple(t.shape), t.dtype) for n, t in model.state_dict().items()}
    weights = inputs.make_weights(shapes, seed, "cpu")
    model.load_state_dict(weights)
    return weights


def test_frozen_sym5_taps_are_pywts():
    w = get_wavelet("sym5")
    np.testing.assert_allclose(DCNN_REF.DEC_LO, w.dec_lo, rtol=0, atol=1e-12)
    np.testing.assert_allclose(DCNN_REF.DEC_HI, w.dec_hi, rtol=0, atol=1e-12)


def test_packet_image_matches_the_port():
    audio, _ = inputs.make_audio(2, 22050, 22050, 3, "cpu")
    want = packet_image(audio, "sym5", level=8, log_scale=True, use_kernel=False)
    got = DCNN_REF.transform(audio)
    assert got.shape == want.shape == (2, 1, 256, 95)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_spectrogram_matches_the_port():
    audio, _ = inputs.make_audio(2, 22050, 22050, 4, "cpu")
    want = spectrogram(audio, n_fft=511, hop_length=220, log_scale=True)
    got = AST_REF.transform(audio)
    assert got.shape == want.shape == (2, 1, 256, 101)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_dcnn_forward_matches_the_port(train):
    torch.manual_seed(0)
    model = DCNN(time_dim=12, dropout_cnn=0.0, dropout_lstm=0.0)
    weights = _weights(model, 11)
    image = torch.randn(3, 1, 256, 95)
    want = model.train(train)(image)
    got = DCNN_REF.forward(weights, image, train)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_ast_forward_matches_the_port(fused):
    model = ASTModel(model_size="tiny224", fused_attention=fused)
    weights = _weights(model, 12)
    image = torch.randn(2, 1, 256, 101)
    want = model.eval()(image)
    got = AST_REF.forward(weights, image, False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_adam_steps_match_torch_adam():
    torch.manual_seed(1)
    w0 = {"lin.weight": torch.randn(2, 5), "lin.bias": torch.randn(2)}
    x = [torch.randn(4, 5) for _ in range(3)]
    y = [torch.tensor([0, 1, 1, 0])] * 3

    def forward(p, image, train, tf32=False):
        return _common.linear(image, p["lin.weight"], p["lin.bias"], tf32)

    got = _common.train_steps(forward, lambda a, tf32: a, w0, list(zip(x, y)),
                              torch.zeros(1), torch.ones(1), 1e-2, 1e-3)
    lin = torch.nn.Linear(5, 2)
    lin.load_state_dict({"weight": w0["lin.weight"], "bias": w0["lin.bias"]})
    opt = torch.optim.Adam(lin.parameters(), lr=1e-2, weight_decay=1e-3)
    losses = []
    for xi, yi in zip(x, y):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(lin(xi), yi)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert got["losses"] == pytest.approx(losses, rel=1e-6)
    assert got["change_norms"]["lin.weight"] == pytest.approx(
        float((lin.weight.detach() - w0["lin.weight"]).norm()), rel=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -10, -2.5])
    want = torch.tensor([1.0, 1.0, 1 + 2 ** -9, 1 + 2 ** -10, -2.5])
    assert torch.equal(_common.tf32_round(x), want)
