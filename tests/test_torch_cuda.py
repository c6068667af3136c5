"""The hand-written CUDA kernels on the card (marked ``cuda``).

These tests import neither JAX nor the JAX package, so they run on a GPU
machine without JAX, from the repository root:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu_torch.ops import (
    flash_attention,
    flash_attention_cuda,
    fused_conv1,
    fused_conv1_cuda,
    fused_conv2,
    fused_conv2_cuda,
    fused_pool,
    fused_pool_cuda,
    int8_conv,
    int8_conv_cuda,
    wpt_cuda,
)
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


def _run_counted(x, wavelet, level, **kw):
    """One call; returns (out, subtree launches, level launches) it made."""
    before = (wpt_cuda.LAUNCHES, wpt_cuda.LEVEL_LAUNCHES)
    got = wpt_cuda.wpt_packets_cuda(x, wavelet, level, **kw)
    torch.cuda.synchronize()
    return got, wpt_cuda.LAUNCHES - before[0], wpt_cuda.LEVEL_LAUNCHES - before[1]


def _auto_plan(x, wavelet, level):
    filt_len = wpt_cuda.filter_length(wavelet)
    return wpt_cuda.wpt_plan(*x.shape, filt_len, level, *wpt_cuda.device_limits(x.device.index))


@pytest.mark.parametrize(
    "wavelet,level,b,t",
    [("sym5", 8, 64, 22050), ("haar", 8, 3, 4096), ("db4", 5, 5, 2048),
     ("coif4", 4, 4, 2048), ("coif4", 2, 2, 16), ("sym5", 8, 1, 22050),
     ("sym5", 8, 3, 22050), ("sym5", 8, 133, 22050), ("db8", 6, 300, 4096),
     ("db2", 6, 3, 3001)],
)
def test_kernel_matches_plain(card, wavelet, level, b, t):
    """The automatic plan: one subtree launch and as many top-level launches
    as the plan reads levels from device memory; the raw packets equal the
    plain cascade (the same fmaf chain over the same samples); a repeat
    gives the same bits."""
    x = _audio(b, t, seed=level).to(card)
    plan = _auto_plan(x, wavelet, level)
    got, subtree, levels = _run_counted(x, wavelet, level)
    assert (subtree, levels) == (1, plan.in_level)
    want = wpt_analysis(x, wavelet, level)
    torch.testing.assert_close(got, want, rtol=0, atol=RAW_ATOL)
    assert torch.equal(got, wpt_cuda.wpt_packets_cuda(x, wavelet, level))
    got = wpt_cuda.wpt_packets_cuda(x, wavelet, level, log_scale=True)
    torch.cuda.synchronize()
    # log(|x|^2 + 1e-12) amplifies roundoff near zero coefficients
    torch.testing.assert_close(got, log_power(want, 2.0), rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize(
    "wavelet,level,b,t",
    [("sym5", 8, 3, 22050), ("coif4", 5, 2, 2048), ("haar", 6, 2, 999),
     ("coif2", 4, 1, 301)],
)
def test_every_split_depth_gives_the_same_bits(card, wavelet, level, b, t):
    """Every split depth k and top route that fits, forced: the same bits
    as the automatic plan (every output is the same fmaf chain), and the
    counters move by one subtree launch and the plan's top levels."""
    x = _audio(b, t, seed=t).to(card)
    ref = wpt_cuda.wpt_packets_cuda(x, wavelet, level, log_scale=True)
    filt_len = wpt_cuda.filter_length(wavelet)
    lengths = wpt_cuda.level_lengths(t, filt_len, level)
    seen = set()
    for k in range(level):
        for top in ("frame", "path", "levels", "levels-all"):
            plan = wpt_cuda.make_plan(lengths, filt_len, k, top)
            if plan in seen or plan.smem_bytes > wpt_cuda.device_limits(0)[1]:
                continue
            seen.add(plan)
            got, subtree, levels = _run_counted(
                x, wavelet, level, log_scale=True, plan=plan)
            assert (subtree, levels) == (1, plan.in_level), plan
            assert torch.equal(got, ref), plan
    assert {p.split for p in seen} == set(range(level))


def test_kernel_refuses_what_it_does_not_take(card):
    x = _audio(2, 4096, seed=0).to(card)
    with pytest.raises(TypeError, match="float32"):
        wpt_cuda.wpt_packets_cuda(x.double(), "haar", 3)
    with pytest.raises(ValueError, match="contiguous"):
        wpt_cuda.wpt_packets_cuda(x.t().contiguous().t(), "haar", 3)
    # 2**31 rows of one coefficient do not fit the kernels' int32 indexing
    with pytest.raises(ValueError, match="overflow int32"):
        wpt_cuda.wpt_packets_cuda(x, "haar", 31)
    # a plan whose buffers exceed the card's shared memory raises with them
    lengths = wpt_cuda.level_lengths(4096, 2, 3)
    big = dataclasses.replace(wpt_cuda.make_plan(lengths, 2, 0, "frame"),
                              smem_bytes=10**6)
    with pytest.raises(ValueError, match="shared memory"):
        wpt_cuda.wpt_packets_cuda(x, "haar", 3, plan=big)


@pytest.mark.parametrize(
    "wavelet,level,b,t",
    [("sym5", 8, 64, 44100), ("sym5", 8, 4, 44100), ("coif4", 8, 2, 44100),
     ("haar", 8, 2, 44100), ("db8", 8, 2, 44100), ("sym5", 8, 3, 32000),
     ("haar", 14, 2, 8 * 2**14)],
)
def test_long_frames_take_the_long_route_and_equal_plain(card, wavelet, level, b, t):
    """Frames longer than one CTA's shared memory: subtrees on chip below
    the split depth, so only the top levels (level 1 alone for 2 s at
    B=64, the DCNN's batch) cross device memory."""
    x = _audio(b, t, seed=t % 97).to(card)
    plan = _auto_plan(x, wavelet, level)
    got, subtree, levels = _run_counted(x, wavelet, level)
    assert (subtree, levels) == (1, plan.in_level)
    assert plan.in_level < level - 1
    if (b, t) == (64, 44100):
        assert plan.in_level <= 1
    want = wpt_analysis(x, wavelet, level)
    torch.testing.assert_close(got, want, rtol=0, atol=RAW_ATOL)
    got = wpt_cuda.wpt_packets_cuda(x, wavelet, level, log_scale=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, log_power(want, 2.0), rtol=1e-3, atol=5e-3)


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


# at B=128 the sums hold up to 792,576 terms per channel, and of 50.7 M pool
# windows the few whose two best phases lie within an ulp select another
# phase on the two sides, each moving one g*x term of dW (chip_smoke.py's
# FUSED_SUM_RTOL, read 3e-4)
FUSED_SUM_RTOL_B128 = 1e-3


@pytest.mark.parametrize("b,h,w,c", [
    (128, 95, 256, 64),  # the DCNN's: a 48 x 129 plane, read four windows at a time
    (2, 95, 256, 16), (2, 101, 256, 8), (2, 87, 256, 4), (2, 7, 5, 12), (2, 40, 700, 64),
    (2, 101, 256, 256),  # an odd plane, the most channels
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv1_matches_plain(card, b, h, w, c, dtype):
    x, params, cot = _fused_inputs(b, h, w, c, dtype, card)
    before = (fused_conv1_cuda.FWD_LAUNCHES, fused_conv1_cuda.BWD_LAUNCHES)
    out, s, q = fused_conv1.fused_conv1_prelu_pool_stats(x, *params)
    grads = torch.autograd.grad([out, s, q], params, cot)
    torch.cuda.synchronize()
    assert (fused_conv1_cuda.FWD_LAUNCHES, fused_conv1_cuda.BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want, ws, wq = fused_conv1.plain_conv1_prelu_pool_stats(x, *params)
    wgrads = torch.autograd.grad([want, ws, wq], params, cot)
    assert out.dtype == dtype and out.shape == want.shape
    assert out.permute(0, 3, 1, 2).is_contiguous()  # NCHW memory, as plain's
    # bf16: the same fp32 value rounded once on both sides; a sum landing on
    # a rounding boundary may fall either way (one bf16 ulp)
    atol = FUSED_FWD_ATOL if dtype == torch.float32 else want.float().abs().max().item() * 2.0**-7
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    sum_tol = FUSED_SUM_RTOL if b <= 2 else FUSED_SUM_RTOL_B128
    assert _rel(s, ws) <= sum_tol and _rel(q, wq) <= sum_tol
    # bf16 gradients are returned in bf16 on both sides: 2**-8 of the largest
    tol = sum_tol if dtype == torch.float32 else 1e-2
    for name, g, wg in zip(("dW", "db", "dalpha"), grads, wgrads):
        assert g.dtype == dtype and g.shape == wg.shape, name
        assert _rel(g, wg) <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv1_stores_nchw_and_takes_either_cotangent_layout(card, dtype):
    """out and code are views of NCHW memory; a cotangent in NHWC memory
    (one copy in the autograd glue) and one in NCHW memory (none) give
    bit-equal gradients; the launcher takes NCHW alone, and no output."""
    import inspect

    x, params, cot = _fused_inputs(2, 95, 256, 64, dtype, card, seed=3)
    raw = [p.detach().float() for p in params]
    out, code, _, _ = fused_conv1_cuda.forward(x, *raw, True, False)
    for t in (out, code):
        assert t.shape == (2, 48, 129, 64) and t.permute(0, 3, 1, 2).is_contiguous()
        assert not t.is_contiguous()
    g = cot[0]
    g_nchw = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert g.is_contiguous() and torch.equal(g_nchw, g)
    grads = [torch.autograd.grad(fused_conv1.fused_conv1_prelu_pool_stats(x, *params),
                                 params, [gg, cot[1], cot[2]]) for gg in (g, g_nchw)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="view of NCHW memory"):
        fused_conv1_cuda.backward(x, *raw, g, code, None, None)
    assert "out" not in inspect.signature(fused_conv1_cuda.backward).parameters


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
    assert out.permute(0, 3, 1, 2).is_contiguous()  # NCHW memory, as plain's
    # bf16: the same fp32 value rounded once on both sides (one bf16 ulp)
    atol = FUSED_FWD_ATOL if dtype == torch.float32 else want.float().abs().max().item() * 2.0**-7
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    tol = FUSED_SUM_RTOL if dtype == torch.float32 else 1e-2
    for name, got, wg in zip(("dW", "db"), grads, wgrads):
        assert got.dtype == dtype and got.shape == wg.shape, name
        assert _rel(got, wg) <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mfm_stores_nchw_and_takes_either_cotangent_layout(card, dtype):
    """out and code are views of NCHW memory; a cotangent in NHWC memory
    (one copy in the autograd glue) and one in NCHW memory (none) give
    bit-equal dW and db; the launcher itself takes NCHW alone."""
    x, params, g = _mfm_inputs(2, 101, 256, 64, dtype, card, seed=3)
    out, code = fused_conv1_cuda.mfm_forward(x, *[p.detach().float() for p in params], True)
    for t in (out, code):
        assert t.shape == (2, 50, 128, 32) and t.permute(0, 3, 1, 2).is_contiguous()
        assert not t.is_contiguous()
    g_nchw = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert g.is_contiguous() and torch.equal(g_nchw, g)
    grads = [torch.autograd.grad(fused_conv1.fused_conv_mfm_pool(x, *params), params, gg)
             for gg in (g, g_nchw)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="view of NCHW memory"):
        fused_conv1_cuda.mfm_backward(x, g, code, 64)


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


def _transposing_copies(fn, numel):
    """Copies of ``numel`` elements into new memory (``contiguous``,
    ``clone``, ``to``) that one call of ``fn`` makes, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    n = 0
    for e in prof.events():
        if e.name != "aten::copy_" or not e.input_shapes or not e.input_shapes[0]:
            continue
        parent = e.cpu_parent
        if int(np.prod(e.input_shapes[0])) == numel and parent is not None and (
                parent.name in ("aten::clone", "aten::_to_copy")):
            n += 1
    return n


def test_dcnn_fused_train_step_makes_no_transposing_copy(card):
    """At B=128 on the 1 s packet image the first block's output is
    [128, 64, 48, 129]: 50,724,864 elements.  The train step with
    ``fused_layer1`` copies neither it nor its cotangent into another
    layout (a deliberate copy of that size counts)."""
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN

    torch.manual_seed(0)
    model = DCNN(time_dim=12, fused_layer1=True).to(card).train()
    x = torch.randn(128, 1, 256, 95, device=card)
    y = torch.randint(0, 2, (128,), device=card)

    def step():
        torch.nn.functional.cross_entropy(model(x), y).backward()

    numel = 128 * 64 * 48 * 129
    step()
    probe = torch.empty(128, 48, 129, 64, device=card)
    assert _transposing_copies(lambda: probe.permute(0, 3, 1, 2).contiguous(), numel) == 1
    assert _transposing_copies(step, numel) == 0


def test_lcnn_fused_train_step_makes_no_transposing_copy(card):
    """At B=128 on the stft image the block's output is [128, 32, 50, 128]:
    26,214,400 elements.  The fused train step copies neither it nor its
    cotangent into another layout (a deliberate copy of that size counts)."""
    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN

    torch.manual_seed(0)
    model = LCNN(fused_layer1=True).to(card).train()
    x = torch.randn(128, 1, 256, 101, device=card)
    y = torch.randint(0, 2, (128,), device=card)

    def step():
        torch.nn.functional.cross_entropy(model(x), y).backward()

    numel = 128 * 32 * 50 * 128
    step()
    probe = torch.empty(128, 50, 128, 32, device=card)
    assert _transposing_copies(lambda: probe.permute(0, 3, 1, 2).contiguous(), numel) == 1
    assert _transposing_copies(step, numel) == 0


# ------------------------------------------------------ fused PReLU + pool


def _pool_inputs(b, c, h, w, dtype, device, alpha=0.25, seed=0):
    rng = np.random.RandomState(seed)
    make = lambda a: torch.from_numpy(a.astype(np.float32)).to(device).to(dtype)  # noqa: E731
    args = [make(rng.randn(b, c, h, w)), make(np.asarray([alpha]))]
    cot = [make(rng.randn(b, c, h // 2, w // 2)),
           make(rng.randn(c) * 0.5).float(), make(rng.randn(c) * 0.05).float()]
    return [a.requires_grad_() for a in args], cot


@pytest.mark.parametrize(
    "c,h,w,alpha", [(96, 48, 129, 0.25), (64, 24, 64, -0.5), (5, 7, 9, 0.25), (4, 51, 8, 0.0),
                    (3, 2, 700, -0.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_pool_matches_plain(card, c, h, w, alpha, dtype):
    args, cot = _pool_inputs(3, c, h, w, dtype, card, alpha=alpha)
    before = (fused_pool_cuda.POOL_FWD_LAUNCHES, fused_pool_cuda.POOL_BWD_LAUNCHES)
    out, s, q = fused_pool.fused_prelu_pool_stats(*args)
    grads = torch.autograd.grad([out, s, q], args, cot)
    torch.cuda.synchronize()
    assert (fused_pool_cuda.POOL_FWD_LAUNCHES, fused_pool_cuda.POOL_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want, ws, wq = fused_pool.plain_prelu_pool_stats(*args)
    wgrads = torch.autograd.grad([want, ws, wq], args, cot)
    assert out.dtype == dtype and out.shape == want.shape and out.is_contiguous()
    # elementwise on both sides: the same float32 value, rounded once
    assert torch.equal(out, want)
    assert _rel(s, ws) <= FUSED_SUM_RTOL and _rel(q, wq) <= FUSED_SUM_RTOL
    # dx is elementwise (bf16: one rounding of the same value, which a fused
    # multiply-add may move by an ulp); dalpha an fp32 sum in another order
    assert grads[0].dtype == dtype and grads[1].dtype == dtype
    assert _rel(grads[0], wgrads[0]) <= (1e-6 if dtype == torch.float32 else 1e-2)
    assert _rel(grads[1], wgrads[1]) <= (FUSED_SUM_RTOL if dtype == torch.float32 else 1e-2)
    if h % 2:
        assert not grads[0][:, :, -1].any()
    if w % 2:
        assert not grads[0][..., -1].any()


def test_fused_pool_ties_zero_slope_and_determinism(card):
    """A constant negative plane: every window ties (at 0 under a zero
    slope), the gradient goes to position (0, 0) and ``dalpha`` is the true
    sum, as in the plain version; two runs are bit-equal; eval saves no
    code."""
    x = torch.randn(2, 3, 8, 10, device=card)
    x[0] = -1.5
    for alpha in (0.0, 0.25, -0.5):
        args = [x.clone().requires_grad_(), torch.tensor([alpha], device=card).requires_grad_()]
        g = torch.randn(2, 3, 4, 5, device=card)
        runs = []
        for _ in range(2):
            out = fused_pool.fused_prelu_pool(*args)
            runs.append((out, *torch.autograd.grad(out, args, g)))
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        want = fused_pool.plain_prelu_pool(*args)
        wgrads = torch.autograd.grad(want, args, g)
        assert torch.equal(runs[0][0], want)
        torch.testing.assert_close(runs[0][1], wgrads[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(runs[0][2], wgrads[1], rtol=1e-5, atol=1e-5)
        dx0 = runs[0][1][0]
        assert not dx0[:, 1::2].any() and not dx0[:, :, 1::2].any()
        assert wgrads[1].abs().item() > 0.1
    with torch.no_grad():
        before = fused_pool_cuda.POOL_BWD_LAUNCHES
        assert torch.equal(fused_pool.fused_prelu_pool(*args), runs[0][0])
        assert fused_pool_cuda.POOL_BWD_LAUNCHES == before


@pytest.mark.parametrize("shape", [(128, 96, 48, 129), (128, 64, 24, 64)], ids=["pool2", "pool3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_pool_dx_is_bit_equal_to_plain_without_moments(card, shape, dtype):
    """The DCNN's two pool shapes (B=128; the second has an odd W): with no
    moment cotangent the cotangent of a window is g itself on both sides,
    times alpha at a negative selection, so the backward's ``dx`` equals
    plain's bit for bit (with moments, autograd sums g + gs + 2 out gq in
    another order: the tolerance above).  ``dalpha`` is an fp32 sum in
    another order; two runs are bit-equal."""
    b, c, h, w = shape
    args, cot = _pool_inputs(b, c, h, w, dtype, card, alpha=0.25, seed=3)
    runs = []
    for _ in range(2):
        before = fused_pool_cuda.POOL_BWD_LAUNCHES
        runs.append(torch.autograd.grad(fused_pool.fused_prelu_pool(*args), args, cot[0]))
        torch.cuda.synchronize()
        assert fused_pool_cuda.POOL_BWD_LAUNCHES == before + 1
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    want = torch.autograd.grad(fused_pool.plain_prelu_pool(*args), args, cot[0])
    assert runs[0][0].dtype == dtype and torch.equal(runs[0][0], want[0])
    assert _rel(runs[0][1], want[1]) <= (FUSED_SUM_RTOL if dtype == torch.float32 else 1e-2)
    if w % 2:
        assert not runs[0][0][..., -1].any()


def test_fused_pool_refuses_what_it_does_not_take(card):
    (x, alpha), _ = _pool_inputs(2, 4, 8, 10, torch.float32, card)
    x = x.detach()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_pool.fused_prelu_pool(x.half(), alpha)
    with pytest.raises(ValueError, match="contiguous"):
        fused_pool.fused_prelu_pool(x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2), alpha)
    with pytest.raises(ValueError, match="H=1, W=10 leaves no output"):
        fused_pool.fused_prelu_pool(x[:, :, :1].contiguous(), alpha)
    # the backward stages two input rows of a strip in shared memory
    wide = torch.randn(1, 1, 2, 20000, device=card, requires_grad=True)
    out = fused_pool.fused_prelu_pool(wide, alpha)
    with pytest.raises(ValueError, match="W=20000 is too wide"):
        out.backward(torch.ones_like(out))


# ------------------------------------- fused conv 3x3 (Cin -> Cout) + PReLU + pool

# forward: 9 * Cin fp32 FMAs per conv value on both sides
CONV2_FWD_ATOL = 2e-5
# moments and gradients: fp32 sums taken in another order than cuDNN's,
# relative to the largest entry of each tensor
CONV2_SUM_RTOL = 1e-4
CONV2_NAMES = ("dx", "dw", "dcorr", "dalpha")


def _chip_smoke():
    """``chip_smoke.py`` (imports neither JAX nor the JAX package): its
    checks of kernel 6's bf16 codes and its HMMA count."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _conv2_plain_grads(args, cot, want_out):
    """The plain side's gradients: autograd of the plain version, or under
    bf16, where a code of the kernel differs from the plain version's first
    maximum (a near-tie, within ``chip_smoke.CONV2_TIE_UNITS``), the plain
    gradients at the kernel's selection (``chip_smoke.py``'s near-tie
    rule)."""
    wgrads = torch.autograd.grad(want_out, args, cot, retain_graph=True)
    if args[0].dtype == torch.bfloat16:
        _, wgrads = _chip_smoke().conv2_near_tie_rule(fused_conv2, args, cot, wgrads)
    return wgrads


def _conv2_inputs(b, c_in, c_out, h, w, dtype, device, alpha=0.25, seed=0):
    rng = np.random.RandomState(seed)
    make = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    args = [make(rng.randn(b, c_in, h, w)).to(dtype), make(rng.randn(9 * c_in, c_out) * 0.1).to(dtype),
            make(rng.randn(c_out, h, w) * 0.1), make(np.asarray([alpha])).to(dtype)]
    cot = [make(rng.randn(b, c_out, h // 2, w // 2)).to(dtype),
           make(rng.randn(c_out) * 0.5), make(rng.randn(c_out) * 0.05)]
    return [a.requires_grad_() for a in args], cot


@pytest.mark.parametrize(
    "c_in,c_out,h,w,alpha",
    [(64, 96, 48, 129, 0.25), (3, 5, 7, 9, -0.3), (8, 12, 25, 33, 0.25), (8, 160, 4, 70, -0.3),
     (40, 12, 51, 8, 0.0), (2, 4, 2, 2, 0.25),
     # neither width a multiple of the tensor-core tiles (16 rows, 8 columns, 64
     # channels a dx block, 32 and 96 a dw block)
     (72, 100, 48, 129, 0.25)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv2_matches_plain(card, c_in, c_out, h, w, alpha, dtype):
    _conv2_matches_plain(card, 2, c_in, c_out, h, w, alpha, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv2_matches_plain_with_dw_split_over_blocks(card, dtype):
    """The headline widths at B=8: dw's B * H * W sum runs in many blocks,
    each over several steps, and one torch.sum finishes it."""
    plan = fused_conv2_cuda.dw_plan(8, 48, 129, 64, 96)
    assert 1 < plan.splits < plan.steps
    _conv2_matches_plain(card, 8, 64, 96, 48, 129, 0.25, dtype)


def _conv2_matches_plain(card, b, c_in, c_out, h, w, alpha, dtype):
    args, cot = _conv2_inputs(b, c_in, c_out, h, w, dtype, card, alpha=alpha)
    before = (fused_conv2_cuda.CONV2_FWD_LAUNCHES, fused_conv2_cuda.CONV2_BWD_LAUNCHES)
    out, s, q = fused_conv2.fused_conv2_prelu_pool_stats(*args)
    grads = torch.autograd.grad([out, s, q], args, cot)
    torch.cuda.synchronize()
    assert (fused_conv2_cuda.CONV2_FWD_LAUNCHES, fused_conv2_cuda.CONV2_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want, ws, wq = fused_conv2.plain_conv2_prelu_pool_stats(*args)
    wgrads = _conv2_plain_grads(args, cot, [want, ws, wq])
    assert out.dtype == dtype and out.shape == want.shape and out.is_contiguous()
    atol = CONV2_FWD_ATOL if dtype == torch.float32 else want.float().abs().max().item() * 2.0**-7
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    assert _rel(s, ws) <= CONV2_SUM_RTOL and _rel(q, wq) <= CONV2_SUM_RTOL
    # bf16 gradients are returned in bf16 on both sides: 2**-8 of the largest
    tol = CONV2_SUM_RTOL if dtype == torch.float32 else 1e-2
    for name, g, wg, arg in zip(CONV2_NAMES, grads, wgrads, args):
        assert g.dtype == arg.dtype and g.shape == wg.shape, name
        # bf16 dalpha: the kernel takes the conv value back from the stored
        # bf16 output (out / alpha, 2**-9 per term, as the JAX kernel does)
        # and the few hundred terms here cancel to a sum near 1
        cap = CONV2_SUM_RTOL if name == "dcorr" else (
            3e-2 if name == "dalpha" and dtype == torch.bfloat16 else tol)
        assert _rel(g, wg) <= cap, name
    if h % 2:
        assert not grads[2][:, -1].any() and grads[0][:, :, -1].any()
    if w % 2:
        assert not grads[2][..., -1].any() and grads[0][..., -1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv2_ties_zero_slope_and_determinism(card, dtype):
    """Channel 0 has zero weights and a constant negative ``corr``: every
    window ties (at 0 under a zero slope), the gradient goes to position
    (0, 0) and ``dalpha`` is the true sum, as in the plain version; two runs
    are bit-equal; eval saves no code and skips ``dx`` when ``x`` needs
    none.  bf16: out within one bf16 ulp, the gradients within the bf16
    tolerances of ``_conv2_matches_plain``."""
    bf16 = dtype == torch.bfloat16
    caps = {"dx": 1e-2, "dw": 1e-2, "dcorr": CONV2_SUM_RTOL, "dalpha": 3e-2} if bf16 else {}
    for alpha in (0.0, 0.25, -0.3):
        args, cot = _conv2_inputs(3, 3, 4, 8, 10, dtype, card, alpha=alpha, seed=3)
        with torch.no_grad():
            args[1][:, 0] = 0.0
            args[2][0] = -0.75
        runs = []
        for _ in range(2):
            out, s, q = fused_conv2.fused_conv2_prelu_pool_stats(*args)
            runs.append((out, s, q, *torch.autograd.grad([out, s, q], args, cot)))
        for a, b in zip(*runs):
            assert torch.equal(a, b)  # per-block partials, fixed order: no atomics
        want = fused_conv2.plain_conv2_prelu_pool_stats(*args)
        wgrads = _conv2_plain_grads(args, cot, want)
        atol = want[0].float().abs().max().item() * 2.0**-7 if bf16 else CONV2_FWD_ATOL
        torch.testing.assert_close(runs[0][0].float(), want[0].float(), rtol=0, atol=atol)
        for name, g, wg in zip(CONV2_NAMES, runs[0][3:], wgrads):
            assert _rel(g, wg) <= caps.get(name, CONV2_SUM_RTOL), name
        dcorr0 = runs[0][5][0]
        assert not dcorr0[1::2].any() and not dcorr0[:, 1::2].any()
        assert wgrads[3].abs().item() > 0.1
    with torch.no_grad():
        before = fused_conv2_cuda.CONV2_BWD_LAUNCHES
        assert torch.equal(fused_conv2.fused_conv2_prelu_pool(*args), runs[0][0])
        assert fused_conv2_cuda.CONV2_BWD_LAUNCHES == before
    params_only = [args[0].detach()] + args[1:]
    out = fused_conv2.fused_conv2_prelu_pool(*params_only)
    for name, g, wg in zip(CONV2_NAMES[1:], torch.autograd.grad(out, params_only[1:], cot[0]),
                           torch.autograd.grad(want[0], args[1:], cot[0])):
        assert _rel(g, wg) <= caps.get(name, CONV2_SUM_RTOL)


def test_fused_conv2_tensor_cores_by_route(card):
    """HMMA instructions in the built library (``cuobjdump -sass``, through
    ``chip_smoke.conv2_mma_count``): the bf16 forward runs on the tensor
    cores, the float32 forward on the FMA pipe (none), dx and dw on the
    tensor cores in both types."""
    fused_conv2_cuda.build()
    found = _chip_smoke().conv2_mma_count(fused_conv2_cuda)
    assert min(v for k, v in found.items() if k.startswith("fwd-bfloat16")) > 0


def test_fused_conv2_refuses_what_it_does_not_take(card):
    (x, w, corr, alpha), _ = _conv2_inputs(2, 3, 5, 8, 10, torch.float32, card)
    x, w, corr, alpha = x.detach(), w.detach(), corr.detach(), alpha.detach()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_conv2.fused_conv2_prelu_pool(x.half(), w, corr, alpha)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv2.fused_conv2_prelu_pool(
            x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2), w, corr, alpha)
    with pytest.raises(ValueError, match=r"w must be \[9 \* Cin, Cout\] = \[27, Cout\]"):
        fused_conv2.fused_conv2_prelu_pool(x, w[:18].contiguous(), corr, alpha)
    with pytest.raises(ValueError, match="corr must be"):
        fused_conv2.fused_conv2_prelu_pool(x, w, corr[:, :7].contiguous(), alpha)


@pytest.mark.parametrize(
    "flags", [dict(fused_pool=True), dict(fused_layer2=True),
              dict(fused_layer1=True, fused_pool=True, fused_layer2=True)],
    ids=["pool", "layer2", "all"])
def test_dcnn_fused_mid_blocks_train_step_matches_unfused_on_the_card(card, flags):
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN

    torch.manual_seed(0)
    kw = dict(time_dim=12, dropout_cnn=0.0, dropout_lstm=0.0)
    plain, fused = DCNN(**kw).to(card), DCNN(**kw, **flags).to(card)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(8, 1, 256, 95, device=card)
    y = torch.randint(0, 2, (8,), device=card)
    counts = (fused_pool_cuda.POOL_FWD_LAUNCHES, fused_conv2_cuda.CONV2_FWD_LAUNCHES)
    losses = []
    for model in (plain, fused):
        model.train()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        losses.append(loss.item())
    assert fused_pool_cuda.POOL_FWD_LAUNCHES - counts[0] == (
        0 if "fused_pool" not in flags else 1 if "fused_layer2" in flags else 2)
    assert fused_conv2_cuda.CONV2_FWD_LAUNCHES - counts[1] == int("fused_layer2" in flags)
    # centred (cuDNN BatchNorm) vs one-pass moments; fp32 sums reordered
    assert abs(losses[0] - losses[1]) <= 1e-5
    # relative l2 per parameter, the caps of the first block's test above
    for (name, p), (_, f) in zip(plain.named_parameters(), fused.named_parameters()):
        denom = p.grad.norm().clamp(min=1e-30)
        assert ((p.grad - f.grad).norm() / denom).item() <= (0.1 if p.numel() == 1 else 0.02), name
    for (name, p), (_, f) in zip(plain.named_buffers(), fused.named_buffers()):
        torch.testing.assert_close(f, p, rtol=1e-4, atol=1e-5, msg=name)


# ------------------------------------------ fused attention (packed qkv)

# forward, float32: 64-term fp32 dot products and softmax sums over N keys on
# both sides, in another order than cuBLAS's (outputs are O(1))
MHA_FWD_ATOL = 1e-5
# dqkv, float32: sums over N keys or queries of products of those, relative
# to the largest entry
MHA_GRAD_RTOL = 1e-4


def _mha_inputs(b, n, heads, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * heads * 64).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, n, heads * 64).astype(np.float32))
    return qkv.to(device).to(dtype).requires_grad_(), g.to(device).to(dtype)


_MHA_SHAPES = [(2, 227, 12), (1, 99, 3), (3, 18, 3), (1, 1, 1), (2, 64, 2), (1, 130, 2),
               (1, 256, 2), (1, 300, 2)]


@pytest.mark.parametrize("b,n,heads", _MHA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mha_matches_plain(card, b, n, heads, dtype):
    """The kernels, as the autograd Function takes them, against the plain
    version at every token count (one route serves them all)."""
    qkv, g = _mha_inputs(b, n, heads, dtype, card, seed=n)
    scale = 1.0 / 8.0
    before = (flash_attention_cuda.MHA_FWD_LAUNCHES, flash_attention_cuda.MHA_BWD_LAUNCHES)
    out = flash_attention.flash_mha_packed(qkv, heads, scale)
    (dqkv,) = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.MHA_FWD_LAUNCHES, flash_attention_cuda.MHA_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention.plain_mha_packed(qkv, heads, scale)
    (wgrad,) = torch.autograd.grad(want, qkv, g)
    assert out.dtype == dtype and out.shape == (b, n, heads * 64) and dqkv.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=MHA_FWD_ATOL)
        assert _rel(dqkv, wgrad) <= MHA_GRAD_RTOL
    else:
        # both round the output to bf16 (2**-8 relative); the probabilities
        # rounded to bf16 on both sides may land one ulp apart
        assert _rel(out, want) <= 2.0**-7
        assert _rel(dqkv, wgrad) <= 1e-2


def test_flash_mha_repeats_bit_for_bit_and_skips_statistics_without_grad(card):
    qkv, g = _mha_inputs(2, 227, 12, torch.float32, card, seed=1)
    runs = []
    for _ in range(2):
        out = flash_attention.flash_mha_packed(qkv, 12, 0.125)
        runs.append((out, *torch.autograd.grad(out, qkv, g)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)  # no atomics: one thread writes each element
    for dtype in (torch.float32, torch.bfloat16):  # and through the launchers
        x, gx = qkv.detach().to(dtype), g.to(dtype)
        outs = []
        for _ in range(2):
            out, stats = flash_attention_cuda.forward(x, 12, 0.125, True)
            outs.append((out, flash_attention_cuda.backward(x, gx, stats, 12, 0.125, out=out)))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    before = flash_attention_cuda.MHA_BWD_LAUNCHES
    with torch.no_grad():
        out, stats = flash_attention_cuda.forward(qkv.detach(), 12, 0.125, False)
        assert stats is None and torch.equal(out, runs[0][0])
        assert torch.equal(flash_attention.flash_mha_packed(qkv, 12, 0.125), runs[0][0])
    assert flash_attention_cuda.MHA_BWD_LAUNCHES == before


def _misaligned(t):
    """A copy of ``t`` whose data starts one element (4 bytes in fp32, 2 in
    bf16) past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view_as(t)
    view.copy_(t.detach())
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mha_streaming_route_takes_misaligned_tensors(card, dtype):
    """cp.async moves 16 bytes: a qkv or dout that does not start on a
    16-byte boundary takes the kernels' element-wise variant, which equals
    plain and counts one launch each way."""
    names = ("MHA_FWD_LAUNCHES", "MHA_BWD_LAUNCHES")
    for n, odd_dout in ((99, False), (300, True)):
        qkv, g = _mha_inputs(1, n, 3, dtype, card, seed=n)
        want = flash_attention.plain_mha_packed(qkv, 3, 0.125)
        (wgrad,) = torch.autograd.grad(want, qkv, g)
        before = [getattr(flash_attention_cuda, name) for name in names]
        if odd_dout:  # aligned qkv, misaligned cotangent, through the launchers
            raw = qkv.detach()
            out, stats = flash_attention_cuda.forward(raw, 3, 0.125, True)
            dqkv = flash_attention_cuda.backward(raw, _misaligned(g), stats, 3, 0.125, out=out)
        else:
            x = _misaligned(qkv).requires_grad_()
            out = flash_attention.flash_mha_packed(x, 3, 0.125)
            (dqkv,) = torch.autograd.grad(out, x, g)
        torch.cuda.synchronize()
        moved = [getattr(flash_attention_cuda, name) - v for name, v in zip(names, before)]
        assert moved == [1, 1], (n, moved)
        if dtype == torch.float32:
            torch.testing.assert_close(out, want, rtol=0, atol=MHA_FWD_ATOL)
            assert _rel(dqkv, wgrad) <= MHA_GRAD_RTOL
        else:
            assert _rel(out, want) <= 2.0**-7
            assert _rel(dqkv, wgrad) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mha_at_the_ast_token_count_repeats_and_equals_plain(card, dtype):
    """N = 227 (the AST's 1 s frames) at B = 2, 12 heads, through
    ``_FlashMHA``: two runs bit for bit, each within the tolerances the
    kernels are held to against plain."""
    qkv, g = _mha_inputs(2, 227, 12, dtype, card, seed=5)
    runs = []
    for _ in range(2):
        out = flash_attention._FlashMHA.apply(qkv, 12, 0.125)
        runs.append((out, *torch.autograd.grad(out, qkv, g)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, dqkv = runs[0]
    want = flash_attention.plain_mha_packed(qkv, 12, 0.125)
    (wgrad,) = torch.autograd.grad(want, qkv, g)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=MHA_FWD_ATOL)
        assert _rel(dqkv, wgrad) <= MHA_GRAD_RTOL
    else:
        assert _rel(out, want) <= 2.0**-7
        assert _rel(dqkv, wgrad) <= 1e-2


def test_flash_mha_refuses_what_it_does_not_take(card):
    qkv, _ = _mha_inputs(2, 20, 2, torch.float32, card)
    qkv = qkv.detach()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_mha_packed(qkv.half(), 2, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_mha_packed(qkv.transpose(0, 1), 2, 0.125)
    with pytest.raises(ValueError, match="heads of 64"):
        flash_attention.flash_mha_packed(qkv, 4, 0.125)
    with pytest.raises(ValueError, match="equal width"):
        flash_attention.flash_mha_packed(qkv[..., :-1].contiguous(), 2, 0.125)
    with pytest.raises(ValueError, match="dout must be"):
        _, stats = flash_attention_cuda.forward(qkv, 2, 0.125, True)
        flash_attention_cuda.backward(qkv, qkv[..., :128].contiguous().double(), stats, 2, 0.125)
    # the fp32 backward's row term is rowsum(dout * out)
    out, stats = flash_attention_cuda.forward(qkv, 2, 0.125, True)
    with pytest.raises(ValueError, match="takes the forward's out"):
        flash_attention_cuda.backward(qkv, out, stats, 2, 0.125)


def test_ast_train_step_fused_matches_unfused_on_the_card(card, monkeypatch):
    from audiodeepfake_detection_tpu_torch.models import ast

    monkeypatch.setitem(ast._SIZES, "test128", dict(embed_dim=128, depth=2, num_heads=2))
    torch.manual_seed(0)
    kw = dict(input_fdim=64, input_tdim=48, model_size="test128")
    plain, fused = ast.ASTModel(**kw).to(card), ast.ASTModel(**kw, fused_attention=True).to(card)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(8, 1, 64, 48, device=card)
    y = torch.randint(0, 2, (8,), device=card)
    before = (flash_attention_cuda.MHA_FWD_LAUNCHES, flash_attention_cuda.MHA_BWD_LAUNCHES)
    losses = []
    for model in (plain, fused):
        model.train()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        losses.append(loss.item())
    assert (flash_attention_cuda.MHA_FWD_LAUNCHES - before[0],
            flash_attention_cuda.MHA_BWD_LAUNCHES - before[1]) == (2, 2)
    assert abs(losses[0] - losses[1]) <= 1e-5
    for (name, p), (_, f) in zip(plain.named_parameters(), fused.named_parameters()):
        assert _rel(f.grad, p.grad) <= 1e-4, name


# ---- the int8 convolution (csrc/int8_conv.cu)

# (B, Cin, Cout, k, padding, dilation, H, W): the port's int8 site kinds
_INT8_SITES = {
    "cnn_0": (2, 1, 64, 3, 2, 1, 95, 256),      # Cin 1, K = 9: byte loads
    "cnn_4": (2, 64, 64, 1, 0, 1, 48, 129),     # 1x1
    "cnn_7": (2, 64, 96, 3, 1, 1, 48, 129),     # 3x3, Cout not a tile multiple
    "cnn_14": (2, 128, 32, 3, 1, 1, 24, 64),    # K = 1152 (past 2**24 in fp32)
    "lcnn_0": (2, 1, 64, 5, 2, 1, 101, 256),    # 5x5, K = 25
    "lcnn_13": (2, 48, 128, 3, 1, 1, 25, 64),   # Cin 48, K = 432
    "dil_4": (2, 12, 12, 5, 2, 2, 64, 32),      # dilation 2, Cin 12
    "dil_7": (2, 12, 12, 7, 2, 4, 64, 32),      # dilation 4
    "odd": (3, 16, 40, 3, 1, 1, 7, 13),         # odd plane, partial tiles
}


def _int8_case(b, c_in, c_out, k, h, w, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, (b, h, w, c_in), generator=gen, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (c_out, c_in, k, k), generator=gen, dtype=torch.int8)
    scale = torch.rand(c_out, generator=gen) * 1e-4 + 1e-6
    return x_q.to(device), w_q.to(device), scale.to(device)


@pytest.mark.parametrize("site", sorted(_INT8_SITES))
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
def test_int8_conv_is_plain_bit_for_bit(card, site, dtype):
    """Accumulators and dequantized outputs (fp32, bf16) equal the plain
    version (a float64 convolution of the codes, exact) bit for bit; a
    repeat gives the same bits; one launch a call."""
    b, c_in, c_out, k, pad, dil, h, w = _INT8_SITES[site]
    x_q, w_q, scale = _int8_case(b, c_in, c_out, k, h, w, card)
    before = int8_conv_cuda.LAUNCHES
    got = int8_conv.int8_conv(x_q, w_q, scale, pad, dil, dtype)
    again = int8_conv.int8_conv(x_q, w_q, scale, pad, dil, dtype)
    want = int8_conv.int8_conv_plain(x_q, w_q, scale, pad, dil, dtype)
    torch.cuda.synchronize()
    assert int8_conv_cuda.LAUNCHES - before == 2
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want) and torch.equal(got, again)


def test_int8_conv_takes_an_input_off_the_16_byte_grid(card):
    """Cin = 64 at an odd address: the byte loads (not the cp.async of
    16-byte code words), the same bits."""
    b, c_in, c_out, k, pad, dil, h, w = _INT8_SITES["cnn_7"]
    x_q, w_q, scale = _int8_case(b, c_in, c_out, k, h, w, card, seed=1)
    flat = torch.empty(x_q.numel() + 1, dtype=torch.int8, device=card)
    shifted = flat[1:].view(x_q.shape)
    shifted.copy_(x_q)
    assert shifted.data_ptr() % 16 != 0
    plan = int8_conv_cuda.plan_for
    assert plan(shifted, c_out, k, pad, dil).staging == int8_conv_cuda.STAGE_LOADS
    assert plan(x_q, c_out, k, pad, dil).staging == int8_conv_cuda.STAGE_CODES
    got = int8_conv.int8_conv(shifted, w_q, scale, pad, dil)
    assert torch.equal(got, int8_conv.int8_conv_plain(x_q, w_q, scale, pad, dil))


def test_int8_conv_refuses_what_it_does_not_take(card):
    x_q, w_q, scale = _int8_case(1, 8, 16, 3, 5, 6, card)
    with pytest.raises(ValueError, match="square"):
        int8_conv.int8_conv(x_q, w_q[:, :, :, :2].contiguous(), scale, 1)
    with pytest.raises(ValueError, match="leave an output"):
        int8_conv.int8_conv(x_q, w_q, scale, 0, dilation=3)  # 5x6 plane, reach 6
    with pytest.raises(TypeError, match="int8"):
        int8_conv.int8_conv(x_q.float(), w_q, scale, 1)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        int8_conv.int8_conv(x_q.permute(0, 2, 1, 3), w_q, scale, 1)
    with pytest.raises(ValueError, match="scale"):
        int8_conv.int8_conv(x_q, w_q, scale[:8], 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_conv_cuda.forward(x_q.cpu(), w_q.cpu(), scale.cpu(), 1, 1, torch.float32)


# ---- the whole int8 site (the same kernel source, site mode)


def _site_case(b, c_in, c_out, k, pad, dil, h, w, device, dtype, seed=0):
    """A working-type activation, its scale (clipping the top of the range),
    a weight record (baked layout too), a map and a bias in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c_in, h, w, generator=gen)
    ho, wo = h + 2 * pad - dil * (k - 1), w + 2 * pad - dil * (k - 1)
    rec = {"w_q": torch.randint(-127, 128, (c_out, c_in, k, k), generator=gen, dtype=torch.int8),
           "s_w": torch.rand(c_out, generator=gen) * 1e-2 + 1e-4}
    rec["rows"] = int8_conv_cuda.site_weights(rec["w_q"])
    const = torch.randn(c_out, ho, wo, generator=gen).to(dtype)
    bias = torch.randn(c_out, generator=gen).to(dtype)
    scale = float(x.abs().max()) / 127.0 * 0.8
    to = lambda t: t.to(device)  # noqa: E731
    return (to(x.to(dtype)), scale, {n: to(t) for n, t in rec.items()}, to(const), to(bias))


@pytest.mark.parametrize("folded", [False, True], ids=["bias", "map-bias"])
@pytest.mark.parametrize("site", sorted(_INT8_SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_site_is_plain_bit_for_bit(card, site, dtype, folded):
    """The whole site (quantize on load, product, scale, map, bias) equals
    its plain version bit for bit, baked and with the layout made at call
    time; a repeat gives the same bits; one launch a call."""
    b, c_in, c_out, k, pad, dil, h, w = _INT8_SITES[site]
    x, scale, rec, const, bias = _site_case(b, c_in, c_out, k, pad, dil, h, w, card, dtype)
    const = const if folded else None
    before = int8_conv_cuda.SITE_LAUNCHES
    got = int8_conv.int8_conv_site(x, scale, rec, pad, dil, const=const, bias=bias)
    fly = int8_conv.int8_conv_site(x, scale, {"w_q": rec["w_q"], "s_w": rec["s_w"]}, pad, dil,
                                   const=const, bias=bias)
    want = int8_conv.int8_conv_site_plain(x, scale, rec["w_q"], rec["s_w"], const, bias, pad, dil)
    torch.cuda.synchronize()
    assert int8_conv_cuda.SITE_LAUNCHES - before == 2
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want) and torch.equal(fly, want)


@pytest.mark.parametrize("site", ["cnn_0", "cnn_4", "lcnn_13", "dil_7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_site_codes_are_quantize_activation_nhwc(card, site, dtype):
    """The codes the kernel makes, read back through an identity 1x1
    product at a power-of-two scale (every output is its code exactly),
    equal ``quantize_activation_nhwc``'s, ties (x * inv = n + 0.5) and the
    clipped range included."""
    b, c_in, _, _, _, _, h, w = _INT8_SITES[site]
    gen = torch.Generator().manual_seed(5)
    s_x = 2.0 ** -6  # inv = 64 exactly
    x = torch.randn(b, c_in, h, w, generator=gen) * 2.5  # |x * 64| beyond 127 too
    x[:, :, ::3] = (torch.randint(-140, 140, x[:, :, ::3].shape, generator=gen) + 0.5) * s_x
    x = x.to(dtype).to(card)
    rec = {"w_q": torch.eye(c_in, dtype=torch.int8).reshape(c_in, c_in, 1, 1).to(card),
           "s_w": torch.full((c_in,), 64.0, device=card)}
    got = int8_conv.int8_conv_site(x, s_x, rec, 0, 1)
    codes = int8_conv.quantize_activation_nhwc(x, s_x)
    assert torch.equal(got.float(), codes.permute(0, 3, 1, 2).float())


def test_int8_site_takes_an_input_off_the_16_byte_grid(card):
    b, c_in, c_out, k, pad, dil, h, w = _INT8_SITES["cnn_7"]
    x, scale, rec, const, bias = _site_case(b, c_in, c_out, k, pad, dil, h, w, card,
                                            torch.float32, seed=2)
    flat = torch.empty(x.numel() + 1, device=card)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    got = int8_conv.int8_conv_site(shifted, scale, rec, pad, dil, const=const, bias=bias)
    want = int8_conv.int8_conv_site_plain(x, scale, rec["w_q"], rec["s_w"], const, bias, pad, dil)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_site_stages_rows_of_a_strided_view_off_the_grid(card, dtype):
    """The cp.async prologue (N tile 32, rows contiguous along W) on a
    view whose rows start off the 16-byte grid and whose channels are
    strided (one element in, every other channel of a wider tensor): the
    same bits as plain."""
    b, c_in, c_out, k, pad, dil, h, w = _INT8_SITES["cnn_14"]
    x, scale, rec, const, bias = _site_case(b, c_in, c_out, k, pad, dil, h, w, card, dtype,
                                            seed=4)
    wide = torch.zeros(b, 2 * c_in, h, w + 3, dtype=dtype, device=card)
    view = wide[:, ::2, :, 1:w + 1]
    view.copy_(x)
    assert view.stride(3) == 1 and not view.is_contiguous()
    plan = int8_conv_cuda.plan_for(view, c_out, k, pad, dil)
    assert plan.staging == int8_conv_cuda.STAGE_ROWS
    got = int8_conv.int8_conv_site(view, scale, rec, pad, dil, const=const, bias=bias)
    want = int8_conv.int8_conv_site_plain(x, scale, rec["w_q"], rec["s_w"], const, bias, pad, dil)
    assert torch.equal(got, want)


@pytest.mark.parametrize("site", ["cnn_0", "odd"])
def test_int8_site_reads_a_transposed_view(card, site):
    """The DCNN hands its first site a transposed view of the transform's
    [B, 1, F, T] image: any strides, the same bits as plain."""
    b, c_in, c_out, k, pad, dil, h, w = _INT8_SITES[site]
    x, scale, rec, const, bias = _site_case(b, c_in, c_out, k, pad, dil, w, h, card,
                                            torch.float32, seed=3)
    view = x.permute(0, 1, 3, 2)
    ho, wo = h + 2 * pad - dil * (k - 1), w + 2 * pad - dil * (k - 1)
    const = torch.randn(c_out, ho, wo, device=card)
    got = int8_conv.int8_conv_site(view, scale, rec, pad, dil, const=const, bias=bias)
    want = int8_conv.int8_conv_site_plain(view, scale, rec["w_q"], rec["s_w"], const, bias, pad,
                                          dil)
    assert not view.is_contiguous() and torch.equal(got, want)


def test_int8_site_refuses_what_it_does_not_take(card):
    x, scale, rec, const, bias = _site_case(1, 8, 16, 3, 1, 1, 5, 6, card, torch.float32)
    site = int8_conv.int8_conv_site
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        site(x.half(), scale, rec, 1)
    with pytest.raises(ValueError, match="NCHW activation"):
        site(x[0], scale, rec, 1)
    with pytest.raises(ValueError, match="rows"):
        site(x, scale, {**rec, "rows": rec["rows"][:1]}, 1)
    with pytest.raises(ValueError, match="map"):
        site(x, scale, rec, 1, const=const[:, :2])
    with pytest.raises(ValueError, match="bias"):
        site(x, scale, rec, 1, bias=bias.bfloat16())
    with pytest.raises(ValueError, match="leave an output"):
        site(x, scale, rec, 0, dilation=3)
    with pytest.raises(ValueError, match="taps"):
        wide = {"w_q": torch.zeros(4, 1, 9, 9, dtype=torch.int8, device=card),
                "s_w": torch.ones(4, device=card)}
        site(torch.zeros(1, 1, 20, 20, device=card), scale, wide, 4)
    with pytest.raises(ValueError, match="shared memory"):
        deep = {"w_q": torch.zeros(8, 2048, 3, 3, dtype=torch.int8, device=card),
                "s_w": torch.ones(8, device=card)}
        site(torch.zeros(1, 2048, 8, 64, device=card), scale, deep, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_conv_cuda.site_forward(x.cpu(), scale, rec["w_q"].cpu(), rec["s_w"].cpu(), None,
                                    None, None, 1, 1)


# ------------------------------------------------- the adfd ops (serving export)


def _op_cases(device):
    """``{case: (op, args, launcher call, launch counter)}`` at the scorers'
    shapes: each op against the launcher its CUDA implementation calls."""
    gen = torch.Generator().manual_seed(40)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(device)

    x1 = r(8, 22050)
    x2, w2, b2, a2 = r(4, 95, 256), r(9, 64, scale=0.3), r(64, scale=0.1), r(1).abs()
    x3, w3, b3 = r(4, 101, 256), r(25, 64, scale=0.2), r(64, scale=0.1)
    x4 = r(2, 227, 3 * 12 * 64)
    x5, a5 = r(4, 96, 48, 129), torch.tensor([0.25], device=device)
    x6, w6, c6 = r(4, 64, 48, 129), r(576, 96, scale=0.05), r(96, 48, 129, scale=0.1)
    xq, wq, sq = _int8_case(4, 64, 96, 3, 48, 129, device, seed=3)
    xs, ss, rs, cs, bs = _site_case(4, 64, 96, 3, 1, 1, 48, 129, device, torch.float32, seed=4)
    site_args = (xs, ss, rs["w_q"], rs["s_w"], rs["rows"], cs, bs, 1, 1)
    ops = torch.ops.adfd
    return {
        "wpt_packets": (ops.wpt_packets.default, (x1, "sym5", 8, True, 2.0),
                        lambda: wpt_cuda.wpt_packets_cuda(x1, "sym5", 8, log_scale=True),
                        (wpt_cuda, "LAUNCHES")),
        "wpt_packets-raw": (ops.wpt_packets.default, (x1, "db4", 6, False, 2.0),
                            lambda: wpt_cuda.wpt_packets_cuda(x1, "db4", 6),
                            (wpt_cuda, "LAUNCHES")),
        "fused_conv1_prelu_pool": (
            ops.fused_conv1_prelu_pool.default, (x2, w2, b2, a2),
            lambda: fused_conv1_cuda.forward(x2, w2, b2, a2, False, False)[0],
            (fused_conv1_cuda, "FWD_LAUNCHES")),
        "fused_conv1_prelu_pool-bf16": (
            ops.fused_conv1_prelu_pool.default, (x2.bfloat16(), w2, b2, a2),
            lambda: fused_conv1_cuda.forward(
                x2.bfloat16(), *(t.bfloat16().float() for t in (w2, b2, a2)), False, False)[0],
            (fused_conv1_cuda, "FWD_LAUNCHES")),
        "fused_conv_mfm_pool": (
            ops.fused_conv_mfm_pool.default, (x3, w3, b3),
            lambda: fused_conv1_cuda.mfm_forward(x3, w3, b3, False)[0],
            (fused_conv1_cuda, "MFM_FWD_LAUNCHES")),
        "flash_mha_packed": (
            ops.flash_mha_packed.default, (x4, 12, 0.125),
            lambda: flash_attention_cuda.forward(x4, 12, 0.125, False)[0],
            (flash_attention_cuda, "MHA_FWD_LAUNCHES")),
        "flash_mha_packed-bf16": (
            ops.flash_mha_packed.default, (x4.bfloat16(), 12, 0.125),
            lambda: flash_attention_cuda.forward(x4.bfloat16(), 12, 0.125, False)[0],
            (flash_attention_cuda, "MHA_FWD_LAUNCHES")),
        "fused_prelu_pool": (
            ops.fused_prelu_pool.default, (x5, a5),
            lambda: fused_pool_cuda.forward(x5, a5, False, False)[0],
            (fused_pool_cuda, "POOL_FWD_LAUNCHES")),
        "fused_conv2_prelu_pool": (
            ops.fused_conv2_prelu_pool.default, (x6, w6, c6, a5),
            lambda: fused_conv2_cuda.forward(x6, w6, c6, a5, False, False)[0],
            (fused_conv2_cuda, "CONV2_FWD_LAUNCHES")),
        "int8_conv": (ops.int8_conv.default, (xq, wq, sq, 1, 1, torch.float32),
                      lambda: int8_conv_cuda.forward(xq, wq, sq, 1, 1, torch.float32),
                      (int8_conv_cuda, "LAUNCHES")),
        "int8_conv_site": (ops.int8_conv_site.default, site_args,
                           lambda: int8_conv_cuda.site_forward(*site_args),
                           (int8_conv_cuda, "SITE_LAUNCHES")),
    }


_OP_CASE_NAMES = ("wpt_packets", "wpt_packets-raw", "fused_conv1_prelu_pool",
                  "fused_conv1_prelu_pool-bf16", "fused_conv_mfm_pool", "flash_mha_packed",
                  "flash_mha_packed-bf16", "fused_prelu_pool", "fused_conv2_prelu_pool",
                  "int8_conv", "int8_conv_site")


@pytest.mark.parametrize("case", _OP_CASE_NAMES)
def test_each_op_is_its_launcher_bit_for_bit(card, case):
    """The op's CUDA implementation is the launcher: the same bits, shape,
    type and strides (kernels 2 and 3: NCHW memory behind ``[B, h2, w2,
    C]``), one launch a call."""
    op, args, launcher, (mod, counter) = _op_cases(card)[case]
    before = getattr(mod, counter)
    with torch.inference_mode():
        got = op(*args)
    torch.cuda.synchronize()
    assert getattr(mod, counter) - before == 1
    want = launcher()
    assert got.dtype == want.dtype and got.stride() == want.stride()
    assert torch.equal(got, want)


def test_public_functions_call_the_ops_without_gradients(card):
    """Where no gradient is needed the public functions give the op's bits
    (the forward without code, moments or statistics)."""
    op, args, _, _ = _op_cases(card)["fused_conv1_prelu_pool"]
    with torch.no_grad():
        assert torch.equal(fused_conv1.fused_conv1_prelu_pool(*args), op(*args))
    op, args, _, _ = _op_cases(card)["flash_mha_packed"]
    with torch.no_grad():
        assert torch.equal(flash_attention.flash_mha_packed(*args), op(*args))


# ------------------------------------------------- analysis (slice 9)


def test_level14_fingerprint_takes_the_top_level_route_and_equals_plain(card):
    """``mean_wpt_spectrum`` over two 10 s clips at level-14 haar: kernel 1
    on its top-level route (``wpt_level_kernel`` launches, then the
    subtree kernel) against the plain cascade on the card.  The raw packets
    read 0.0 from plain on every plan, so the mean spectra are the same
    bits; the bound takes a mean summed in another order."""
    from audiodeepfake_detection_tpu_torch.analysis.fingerprints import mean_wpt_spectrum

    rng = np.random.RandomState(14)
    clips = [(0.3 * rng.randn(220500)).astype(np.float32) for _ in range(2)]
    before = (wpt_cuda.LAUNCHES, wpt_cuda.LEVEL_LAUNCHES)
    got = mean_wpt_spectrum(clips, "haar", 14, device=card)
    subtree, levels = wpt_cuda.LAUNCHES - before[0], wpt_cuda.LEVEL_LAUNCHES - before[1]
    want = mean_wpt_spectrum(clips, "haar", 14, device=card, use_kernel=False)
    assert subtree == 2 and levels > 0
    assert got.shape == (2**14,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_integrated_grad_through_kernels_5_and_6_equals_plain(card, monkeypatch):
    """The full-width DCNN in eval with ``fused_pool`` and ``fused_layer2``
    at ``"always"``: one forward and one ``dx`` backward of kernels 5 and 6
    at B = 201 per image.  The attributions within 1e-4 of the largest of
    the same model's with the blocks' plain versions in the kernels' place
    (the same folded math: kernel 6 sums its forward in cuDNN's order and
    kernel 5's is elementwise, so the pools choose alike; what is left is
    the kernels' fp32 dx).  The gradient at the image within 1e-4 of its
    largest entry of the unfused (cuDNN) model's; the unfused attributions
    are not held here: where a max-pool window's two largest values lie
    within the roundoff between the folded and the unfolded BatchNorm, the
    two models choose differently (``chip_smoke.py`` phase 25)."""
    from audiodeepfake_detection_tpu_torch.analysis.integrated_gradients import integrated_grad
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN

    torch.manual_seed(0)
    plain = DCNN(time_dim=12).to(card).eval()
    fused = DCNN(time_dim=12, fused_pool="always", fused_layer2="always").to(card).eval()
    fused.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 256, 95).astype(np.float32)).to(card)
    grads = []
    for model in (plain, fused):
        img = x[None].clone().requires_grad_(True)
        grads.append(torch.autograd.grad(torch.softmax(model(img), -1)[0, 1], img)[0])
    assert (grads[1] - grads[0]).abs().max() <= 1e-4 * grads[0].abs().max()
    counters = [(fused_pool_cuda, "POOL_FWD_LAUNCHES"), (fused_pool_cuda, "POOL_BWD_LAUNCHES"),
                (fused_conv2_cuda, "CONV2_FWD_LAUNCHES"), (fused_conv2_cuda, "CONV2_BWD_LAUNCHES")]
    before = [getattr(m, c) for m, c in counters]
    got = integrated_grad(fused, x, 1)
    assert [getattr(m, c) - b for (m, c), b in zip(counters, before)] == [1, 1, 1, 1]

    def pool(x, alpha, want_stats):
        assert not want_stats
        return fused_pool.plain_prelu_pool(x, alpha), None, None

    def conv2(x, w, corr, alpha, want_stats):
        assert not want_stats
        return fused_conv2.plain_conv2_prelu_pool(x, w, corr, alpha), None, None

    monkeypatch.setattr(fused_pool, "_run", pool)
    monkeypatch.setattr(fused_conv2, "_run", conv2)
    want = integrated_grad(fused, x, 1)
    assert [getattr(m, c) - b for (m, c), b in zip(counters, before)] == [1, 1, 1, 1]
    assert torch.isfinite(got).all() and want.abs().max() > 0
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
