"""The hand-written CUDA kernels on the card (marked ``cuda``).

These tests import neither JAX nor the JAX package, so they run on a GPU
machine without JAX, from the repository root:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu_torch.ops import fused_conv1, fused_conv1_cuda, wpt_cuda
from audiodeepfake_detection_tpu_torch.ops.wpt import log_power, wpt_analysis

pytestmark = pytest.mark.cuda

# unit-variance input: both sides are fp32 FIR sums of the same taps, and
# peaks reach ~17 where one fp32 ulp is ~2e-6
RAW_ATOL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain side in full fp32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = old


def _audio(b, t, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(b, t).astype(np.float32))


@pytest.mark.parametrize(
    "wavelet,level,b,t",
    [("sym5", 8, 64, 22050), ("haar", 8, 3, 4096), ("db4", 5, 5, 2048),
     ("coif4", 4, 4, 2048), ("coif4", 2, 2, 16), ("sym5", 8, 1, 22050)],
)
def test_kernel_matches_plain(card, wavelet, level, b, t):
    x = _audio(b, t, seed=level).to(card)
    before = wpt_cuda.LAUNCHES
    got = wpt_cuda.wpt_packets_cuda(x, wavelet, level)
    want = wpt_analysis(x, wavelet, level)
    torch.cuda.synchronize()
    assert wpt_cuda.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=RAW_ATOL)
    got = wpt_cuda.wpt_packets_cuda(x, wavelet, level, log_scale=True)
    torch.cuda.synchronize()
    # log(|x|^2 + 1e-12) amplifies roundoff near zero coefficients
    torch.testing.assert_close(got, log_power(want, 2.0), rtol=1e-3, atol=5e-3)


def test_kernel_refuses_what_it_does_not_take(card):
    x = _audio(2, 4096, seed=0).to(card)
    with pytest.raises(TypeError, match="float32"):
        wpt_cuda.wpt_packets_cuda(x.double(), "haar", 3)
    with pytest.raises(ValueError, match="contiguous"):
        wpt_cuda.wpt_packets_cuda(x.t().contiguous().t(), "haar", 3)
    # two seconds of sym5 need more shared memory than a block may have
    with pytest.raises(ValueError, match="shared memory"):
        wpt_cuda.wpt_packets_cuda(_audio(1, 44100, seed=1).to(card), "sym5", 8)


def test_empty_batch(card):
    out = wpt_cuda.wpt_packets_cuda(torch.zeros(0, 22050, device=card), "sym5", 8)
    assert out.shape == (0, 256, 95)


# --------------------------------------------- fused conv1 + PReLU + pool

# forward: 9 fp32 FMAs per conv value on both sides, in another order
FUSED_FWD_ATOL = 2e-5
# moments and gradients are fp32 sums of up to 12k terms per channel taken
# in another order: relative to the largest entry of each tensor
FUSED_SUM_RTOL = 1e-4


def _fused_inputs(b, h, w, c, dtype, device, alpha=0.25, seed=0):
    rng = np.random.RandomState(seed)
    make = lambda a: torch.from_numpy(a.astype(np.float32)).to(device).to(dtype)  # noqa: E731
    x = make(rng.randn(b, h, w))
    params = [make(rng.randn(9, c) * 0.3), make(rng.randn(c) * 0.1),
              make(np.asarray([alpha]))]
    cot = [make(rng.randn(b, (h + 2) // 2, (w + 2) // 2, c)),
           make(rng.randn(c) * 0.5).float(), make(rng.randn(c) * 0.05).float()]
    return x, [p.requires_grad_() for p in params], cot


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1)).item()


@pytest.mark.parametrize("h,w,c", [(95, 256, 16), (101, 256, 8), (87, 256, 4), (7, 5, 12), (40, 700, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv1_matches_plain(card, h, w, c, dtype):
    x, params, cot = _fused_inputs(2, h, w, c, dtype, card)
    before = (fused_conv1_cuda.FWD_LAUNCHES, fused_conv1_cuda.BWD_LAUNCHES)
    out, s, q = fused_conv1.fused_conv1_prelu_pool_stats(x, *params)
    grads = torch.autograd.grad([out, s, q], params, cot)
    torch.cuda.synchronize()
    assert (fused_conv1_cuda.FWD_LAUNCHES, fused_conv1_cuda.BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want, ws, wq = fused_conv1.plain_conv1_prelu_pool_stats(x, *params)
    wgrads = torch.autograd.grad([want, ws, wq], params, cot)
    assert out.dtype == dtype and out.shape == want.shape and out.is_contiguous()
    # bf16: the same fp32 value rounded once on both sides; a sum landing on
    # a rounding boundary may fall either way (one bf16 ulp)
    atol = FUSED_FWD_ATOL if dtype == torch.float32 else want.float().abs().max().item() * 2.0**-7
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    assert _rel(s, ws) <= FUSED_SUM_RTOL and _rel(q, wq) <= FUSED_SUM_RTOL
    # bf16 gradients are returned in bf16 on both sides: 2**-8 of the largest
    tol = FUSED_SUM_RTOL if dtype == torch.float32 else 1e-2
    for name, g, wg in zip(("dW", "db", "dalpha"), grads, wgrads):
        assert g.dtype == dtype and g.shape == wg.shape, name
        assert _rel(g, wg) <= tol, name


def test_fused_conv1_is_deterministic_and_skips_the_code_in_eval(card):
    x, params, cot = _fused_inputs(4, 95, 256, 64, torch.float32, card, seed=1)
    runs = []
    for _ in range(2):
        out, s, q = fused_conv1.fused_conv1_prelu_pool_stats(x, *params)
        runs.append((out, s, q, *torch.autograd.grad([out, s, q], params, cot)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)  # per-block partials, fixed order: no atomics
    with torch.no_grad():
        before = fused_conv1_cuda.BWD_LAUNCHES
        eval_out = fused_conv1.fused_conv1_prelu_pool(x, *params)
        assert torch.equal(eval_out, runs[0][0]) and not eval_out.requires_grad
        assert fused_conv1_cuda.BWD_LAUNCHES == before


def test_fused_conv1_alpha_zero_and_ties(card):
    """True dalpha at a zero slope; first-phase selection on a constant
    image (both as the plain version)."""
    x, params, cot = _fused_inputs(2, 21, 30, 4, torch.float32, card, alpha=0.0, seed=2)
    grads = torch.autograd.grad(fused_conv1.fused_conv1_prelu_pool(x, *params), params, cot[0])
    wgrads = torch.autograd.grad(fused_conv1.plain_conv1_prelu_pool(x, *params), params, cot[0])
    assert wgrads[2].abs().item() > 0.1
    for g, wg in zip(grads, wgrads):
        assert _rel(g, wg) <= FUSED_SUM_RTOL
    ones = torch.ones(1, 12, 16, device=card)
    w = torch.zeros(9, 4, device=card)
    w[4] = 1.0
    params = [w.requires_grad_(), torch.full((4,), 0.5, device=card).requires_grad_(),
              torch.tensor([0.25], device=card).requires_grad_()]
    g = torch.randn(1, 7, 9, 4, device=card)
    grads = torch.autograd.grad(fused_conv1.fused_conv1_prelu_pool(ones, *params), params, g)
    cpu_params = [p.detach().cpu().requires_grad_() for p in params]
    wgrads = torch.autograd.grad(
        fused_conv1.plain_conv1_prelu_pool(ones.cpu(), *cpu_params), cpu_params, g.cpu())
    for got, want in zip(grads, wgrads):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_fused_conv1_refuses_what_it_does_not_take(card):
    x, params, _ = _fused_inputs(2, 9, 12, 4, torch.float32, card)
    with pytest.raises(ValueError, match="no gradient for x"):
        fused_conv1.fused_conv1_prelu_pool(x.clone().requires_grad_(), *params)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_conv1.fused_conv1_prelu_pool(x.half(), *params)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv1.fused_conv1_prelu_pool(x.transpose(1, 2), *params)
    wide = torch.zeros(9, 300, device=card)
    with pytest.raises(ValueError, match="C=300"):
        fused_conv1.fused_conv1_prelu_pool(x, wide, torch.zeros(300, device=card), params[2])


def test_dcnn_fused_train_step_matches_unfused_on_the_card(card):
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN

    torch.manual_seed(0)
    kw = dict(time_dim=12, dropout_cnn=0.0, dropout_lstm=0.0)
    plain, fused = DCNN(**kw).to(card), DCNN(**kw, fused_layer1=True).to(card)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(8, 1, 256, 95, device=card)
    y = torch.randint(0, 2, (8,), device=card)
    losses = []
    for model in (plain, fused):
        model.train()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        losses.append(loss.item())
    # centred (cuDNN BatchNorm) vs one-pass moments; fp32 sums reordered
    assert abs(losses[0] - losses[1]) <= 1e-5
    # Gradients of two fp32 runs, relative l2 per parameter.  Read on an
    # NVIDIA H100 80GB HBM3 over seeds 0-3: at most 6.1e-3 for a tensor and
    # 4.0e-2 for a single PReLU slope (cnn.8, a sum with heavy cancellation:
    # the unfused fp32 gradient itself lies 3.5e-2 from a float64 run, and
    # both lie ~1e-3 from it on the conv weights).  A wrong term in the
    # backward kernel moves the first block's gradients by its own size.
    for (name, p), (_, f) in zip(plain.named_parameters(), fused.named_parameters()):
        denom = p.grad.norm().clamp(min=1e-30)
        assert ((p.grad - f.grad).norm() / denom).item() <= (0.1 if p.numel() == 1 else 0.02), name


# --------------------------------------- fused conv 5x5 + MaxFeatureMap + pool


def _mfm_inputs(b, h, w, c, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    make = lambda a: torch.from_numpy(a.astype(np.float32)).to(device).to(dtype)  # noqa: E731
    x = make(rng.randn(b, h, w))
    params = [make(rng.randn(25, c) * 0.1), make(rng.randn(c) * 0.1)]
    g = make(rng.randn(b, h // 2, w // 2, c // 2))
    return x, [p.requires_grad_() for p in params], g


@pytest.mark.parametrize(
    "h,w,c", [(101, 256, 8), (95, 256, 4), (101, 20, 64), (21, 30, 6), (40, 700, 64), (7, 5, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mfm_matches_plain(card, h, w, c, dtype):
    x, params, g = _mfm_inputs(2, h, w, c, dtype, card)
    before = (fused_conv1_cuda.MFM_FWD_LAUNCHES, fused_conv1_cuda.MFM_BWD_LAUNCHES)
    out = fused_conv1.fused_conv_mfm_pool(x, *params)
    grads = torch.autograd.grad(out, params, g)
    torch.cuda.synchronize()
    assert (fused_conv1_cuda.MFM_FWD_LAUNCHES, fused_conv1_cuda.MFM_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = fused_conv1.plain_conv_mfm_pool(x, *params)
    wgrads = torch.autograd.grad(want, params, g)
    assert out.dtype == dtype and out.shape == want.shape == (2, h // 2, w // 2, c // 2)
    assert out.is_contiguous()
    # bf16: the same fp32 value rounded once on both sides (one bf16 ulp)
    atol = FUSED_FWD_ATOL if dtype == torch.float32 else want.float().abs().max().item() * 2.0**-7
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    tol = FUSED_SUM_RTOL if dtype == torch.float32 else 1e-2
    for name, got, wg in zip(("dW", "db"), grads, wgrads):
        assert got.dtype == dtype and got.shape == wg.shape, name
        assert _rel(got, wg) <= tol, name


def test_fused_mfm_is_deterministic_and_skips_the_code_in_eval(card):
    x, params, g = _mfm_inputs(4, 101, 256, 64, torch.float32, card, seed=1)
    runs = []
    for _ in range(2):
        out = fused_conv1.fused_conv_mfm_pool(x, *params)
        runs.append((out, *torch.autograd.grad(out, params, g)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)  # per-block partials, fixed order: no atomics
    with torch.no_grad():
        before = fused_conv1_cuda.MFM_BWD_LAUNCHES
        eval_out = fused_conv1.fused_conv_mfm_pool(x, *params)
        assert torch.equal(eval_out, runs[0][0]) and not eval_out.requires_grad
        assert fused_conv1_cuda.MFM_BWD_LAUNCHES == before


def test_fused_mfm_ties_go_to_the_first_candidate(card):
    """Silence, duplicated rows and equal channel halves: the kernel's code
    selects what the plain version's ``where(a >= b)`` + first-max pool do."""
    h, w, c = 12, 16, 6
    rng = np.random.RandomState(4)
    x = np.zeros((3, h, w), np.float32)
    x[1] = np.repeat(rng.randn(h // 2, w), 2, axis=0)
    x[2] = rng.randn(h, w)
    wgt = rng.randn(25, c).astype(np.float32) * 0.1
    wgt[:, c // 2 :] = wgt[:, : c // 2]
    b = np.zeros(c, np.float32)
    g = rng.randn(3, h // 2, w // 2, c // 2).astype(np.float32)
    grads = {}
    for device in (card, torch.device("cpu")):
        params = [torch.from_numpy(wgt).to(device).requires_grad_(),
                  torch.from_numpy(b).to(device).requires_grad_()]
        out = fused_conv1.fused_conv_mfm_pool(torch.from_numpy(x).to(device), *params)
        grads[device.type] = [t.cpu() for t in torch.autograd.grad(out, params, torch.from_numpy(g).to(device))]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(grads["cuda"][1][c // 2 :] == 0)  # the upper half never wins a tie


def test_fused_mfm_takes_a_hop_length_1_image(card):
    """``--hop-length 1`` (the CLI default) gives 22051 time steps: 2757 row
    strips of one frame, no other path."""
    x, params, g = _mfm_inputs(1, 22051, 256, 64, torch.float32, card, seed=2)
    out = fused_conv1.fused_conv_mfm_pool(x, *params)
    grads = torch.autograd.grad(out, params, g)
    want = fused_conv1.plain_conv_mfm_pool(x, *params)
    wgrads = torch.autograd.grad(want, params, g)
    assert out.shape == (1, 11025, 128, 32)
    torch.testing.assert_close(out, want, rtol=0, atol=FUSED_FWD_ATOL)
    for got, wg in zip(grads, wgrads):
        # cuDNN sums 5.6 M fp32 terms per tap on the plain side: measured
        # 1.1e-3 of the largest entry here (chip_smoke.py holds the kernel to
        # 2e-5 of a float64 rebuild from its own code)
        assert _rel(got, wg) <= 5e-3


def test_lcnn_takes_a_hop_length_1_image(card):
    """The whole LCNN on the ``--hop-length 1`` image ``[1, 1, 256, 22051]``
    (1378 BLSTM steps), first block fused and unfused."""
    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN

    torch.manual_seed(0)
    plain, fused = LCNN().to(card).eval(), LCNN(fused_layer1="always").to(card).eval()
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(1, 1, 256, 22051, device=card)
    with torch.inference_mode():
        want, got = plain(x), fused(x)
    assert got.shape == (1, 2) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_fused_mfm_refuses_what_it_does_not_take(card):
    x, params, _ = _mfm_inputs(2, 9, 12, 4, torch.float32, card)
    with pytest.raises(ValueError, match="no gradient for x"):
        fused_conv1.fused_conv_mfm_pool(x.clone().requires_grad_(), *params)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_conv1.fused_conv_mfm_pool(x.half(), *params)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv1.fused_conv_mfm_pool(x.transpose(1, 2), *params)
    with pytest.raises(ValueError, match="C=300"):
        fused_conv1.fused_conv_mfm_pool(
            x, torch.zeros(25, 300, device=card), torch.zeros(300, device=card))
    with pytest.raises(ValueError, match=r"w must be \[25, C\]"):
        fused_conv1.fused_conv_mfm_pool(x, torch.zeros(9, 4, device=card), params[1])


def test_lcnn_fused_train_step_matches_unfused_on_the_card(card):
    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN

    torch.manual_seed(0)
    plain, fused = LCNN(dropout=0.0).to(card), LCNN(dropout=0.0, fused_layer1=True).to(card)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(8, 1, 256, 101, device=card)
    y = torch.randint(0, 2, (8,), device=card)
    losses = []
    for model in (plain, fused):
        model.train()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        losses.append(loss.item())
    # the first block's 25-term sums in another order; everything behind it
    # is the same code
    assert abs(losses[0] - losses[1]) <= 1e-5
    for (name, p), (_, f) in zip(plain.named_parameters(), fused.named_parameters()):
        denom = p.grad.norm().clamp(min=1e-30)
        assert ((p.grad - f.grad).norm() / denom).item() <= 0.02, name
