"""Port fused first block (plain version, CPU) vs the JAX Pallas kernels.

The same numpy arrays go through ``fused_conv1_prelu_pool[_stats]`` of both
packages.  The JAX functions reach their Pallas kernels in interpret mode on
the CPU by themselves; the port's wrapper takes its plain PyTorch version
because the tensors lie on the CPU.  The CUDA kernels are held against the
same plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.ops import fused_conv1 as jfc
from audiodeepfake_detection_tpu_torch.ops import fused_conv1 as tfc
from audiodeepfake_detection_tpu_torch.ops import fused_conv1_cuda

GEOMETRIES = [(95, 256, 16), (101, 256, 8), (87, 256, 4)]
# forward: both sides sum 9 fp32 products per output, in another order
FWD_ATOL = 2e-5
# gradients and moments are fp32 sums over up to 2*51*129 terms taken in
# another order: relative to the largest entry of each tensor
SUM_RTOL = 2e-5


def _inputs(h, w, c, seed=0, b=2, alpha=0.25):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(b, h, w).astype(np.float32),
        (rng.randn(9, c) * 0.1).astype(np.float32),
        (rng.randn(c) * 0.1).astype(np.float32),
        np.asarray([alpha], np.float32),
    )


def _t(arrays, dtype=torch.float32, grad=True):
    x, *params = [torch.from_numpy(a).to(dtype) for a in arrays]
    return [x] + [p.requires_grad_(grad) for p in params]


def _close(got, want, rtol=SUM_RTOL, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol, err_msg=err_msg)


@pytest.mark.parametrize("h,w,c", GEOMETRIES)
def test_forward_matches_jax(h, w, c):
    arrays = _inputs(h, w, c)
    want = np.asarray(jfc.fused_conv1_prelu_pool(*map(jnp.asarray, arrays)))
    got = tfc.fused_conv1_prelu_pool(*_t(arrays, grad=False))
    assert got.shape == want.shape == (2, *tfc.pad_geometry(h, w), c)
    assert got.permute(0, 3, 1, 2).is_contiguous()  # NCHW memory, as the kernel's
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("h,w,c", GEOMETRIES)
def test_gradients_match_jax(h, w, c):
    arrays = _inputs(h, w, c, seed=1)
    g = np.random.RandomState(7).randn(2, *tfc.pad_geometry(h, w), c).astype(np.float32)

    def loss(w_, b_, a_):
        return jnp.sum(
            jfc.fused_conv1_prelu_pool(jnp.asarray(arrays[0]), w_, b_, a_) * g
        )

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays[1:]))
    x, *params = _t(arrays)
    out = tfc.fused_conv1_prelu_pool(x, *params)
    got = torch.autograd.grad(out, params, torch.from_numpy(g))
    for name, gt, wt in zip(("dW", "db", "dalpha"), got, want):
        _close(gt.numpy(), wt, err_msg=name)


@pytest.mark.parametrize("h,w,c", GEOMETRIES)
def test_stats_variant_moments_and_gradients_match_jax(h, w, c):
    """Cotangents on all three outputs (out, sum, sumsq)."""
    arrays = _inputs(h, w, c, seed=2)
    rng = np.random.RandomState(8)
    g = rng.randn(2, *tfc.pad_geometry(h, w), c).astype(np.float32)
    gs = (rng.randn(c) * 0.5).astype(np.float32)
    gq = (rng.randn(c) * 0.05).astype(np.float32)

    # one pass of the interpreted kernel gives the outputs and, from the
    # same residuals, the gradients
    (jy, js, jq), vjp = jax.vjp(
        lambda *p: jfc.fused_conv1_prelu_pool_stats(jnp.asarray(arrays[0]), *p),
        *map(jnp.asarray, arrays[1:]))
    want = vjp((jnp.asarray(g), jnp.asarray(gs), jnp.asarray(gq)))

    x, *params = _t(arrays)
    y, s, q = tfc.fused_conv1_prelu_pool_stats(x, *params)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=FWD_ATOL)
    assert s.dtype == q.dtype == torch.float32 and s.shape == q.shape == (c,)
    _close(s.detach().numpy(), js, err_msg="sum")
    _close(q.detach().numpy(), jq, err_msg="sumsq")
    got = torch.autograd.grad(
        [y, s, q], params, [torch.from_numpy(g), torch.from_numpy(gs), torch.from_numpy(gq)]
    )
    for name, gt, wt in zip(("dW", "db", "dalpha"), got, want):
        _close(gt.numpy(), wt, err_msg=name)


def test_bf16_io_matches_jax():
    """bf16 in -> bf16 out: x and the parameters rounded to bf16, fp32
    accumulation.  Both packages round at the same places in the forward,
    so outputs agree to one bf16 ulp of the largest value (a sum that lands
    on a rounding boundary may fall either way); the JAX backward also
    rounds the per-element gradient to bf16 before its dot, the port does
    not: 2**-8 relative per term, far less on the sums."""
    h, w, c = 95, 256, 8
    arrays = _inputs(h, w, c, seed=3)
    rng = np.random.RandomState(9)
    g = rng.randn(2, *tfc.pad_geometry(h, w), c).astype(np.float32)
    gs = (rng.randn(c) * 0.5).astype(np.float32)
    gq = (rng.randn(c) * 0.05).astype(np.float32)
    j16 = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    g16 = jnp.asarray(g).astype(jnp.bfloat16)

    (jy, js, jq), vjp = jax.vjp(
        lambda *p: jfc.fused_conv1_prelu_pool_stats(j16[0], *p), *j16[1:])
    want = vjp((g16, jnp.asarray(gs), jnp.asarray(gq)))

    x, *params = _t(arrays, dtype=torch.bfloat16)
    y, s, q = tfc.fused_conv1_prelu_pool_stats(x, *params)
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    jy32 = np.asarray(jy.astype(jnp.float32))
    ulp = float(np.abs(jy32).max()) * 2.0**-7
    np.testing.assert_allclose(y.float().detach().numpy(), jy32, rtol=0, atol=ulp)
    _close(s.detach().numpy(), js, rtol=1e-3, err_msg="sum")
    _close(q.detach().numpy(), jq, rtol=1e-3, err_msg="sumsq")
    got = torch.autograd.grad(
        [y, s, q], params,
        [torch.from_numpy(g).bfloat16(), torch.from_numpy(gs), torch.from_numpy(gq)],
    )
    for name, gt, wt in zip(("dW", "db", "dalpha"), got, want):
        assert gt.dtype == torch.bfloat16, name
        # both sides return bf16 gradients: 2**-8 of the largest entry
        _close(gt.float().numpy(), np.asarray(wt.astype(jnp.float32)), rtol=1e-2, err_msg=name)


def test_constant_image_ties_pick_phase_00():
    """Every pool window of a constant interior ties; the gradient must go
    to phase (0, 0) alone, as in the JAX kernel (strict ``>``)."""
    h, w, c = 12, 16, 4
    x = np.ones((1, h, w), np.float32)
    wgt = np.zeros((9, c), np.float32)
    wgt[4] = 1.0  # centre tap only: conv == x (padded) + b
    b = np.full(c, 0.5, np.float32)
    alpha = np.asarray([0.25], np.float32)
    g = np.random.RandomState(0).randn(1, *tfc.pad_geometry(h, w), c).astype(np.float32)

    def loss(w_, b_, a_):
        return jnp.sum(jfc.fused_conv1_prelu_pool(jnp.asarray(x), w_, b_, a_) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(wgt), jnp.asarray(b), jnp.asarray(alpha))
    tx, *params = _t((x, wgt, b, alpha))
    got = torch.autograd.grad(
        tfc.fused_conv1_prelu_pool(tx, *params), params, torch.from_numpy(g)
    )
    for name, gt, wt in zip(("dW", "db", "dalpha"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-5, atol=1e-5, err_msg=name)
    # an interior window's four conv values are all 1.5: routing to any
    # other phase than (0, 0) would move weight between the taps of dW
    assert not np.allclose(got[0].numpy()[0], got[0].numpy()[8])


def test_negative_alpha_matches_jax():
    """PReLU before the pool: with a negative slope, pooling first would
    pick other elements."""
    arrays = _inputs(33, 40, 4, seed=4, alpha=-0.5)
    g = np.random.RandomState(1).randn(2, *tfc.pad_geometry(33, 40), 4).astype(np.float32)

    want_y, vjp = jax.vjp(
        lambda *p: jfc.fused_conv1_prelu_pool(jnp.asarray(arrays[0]), *p),
        *map(jnp.asarray, arrays[1:]))
    want = vjp(jnp.asarray(g))
    want_y = np.asarray(want_y)
    x, *params = _t(arrays)
    y = tfc.fused_conv1_prelu_pool(x, *params)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0, atol=FWD_ATOL)
    for name, gt, wt in zip(
        ("dW", "db", "dalpha"), torch.autograd.grad(y, params, torch.from_numpy(g)), want
    ):
        _close(gt.numpy(), wt, err_msg=name)


def _first_match_dalpha(x, wgt, b, alpha, g):
    """``sum(conv * g)`` over the selected elements with ``conv < 0``, in
    float64 numpy: the selection is the first maximum of the PReLU'd window
    in the order (0,0), (0,1), (1,0), (1,1)."""
    bsz, h, w = x.shape
    xp = np.pad(x.astype(np.float64), ((0, 0), (2, 2), (2, 2)))
    conv = sum(
        xp[:, dh : dh + h + 2, dw : dw + w + 2, None] * wgt[dh * 3 + dw].astype(np.float64)
        for dh in range(3) for dw in range(3)
    ) + b.astype(np.float64)
    act = np.where(conv >= 0, conv, float(alpha[0]) * conv)
    h2, w2 = (h + 2) // 2, (w + 2) // 2
    win = lambda t: np.stack(  # noqa: E731
        [t[:, a : 2 * h2 : 2, c : 2 * w2 : 2] for a in (0, 1) for c in (0, 1)]
    )
    sel = np.argmax(win(act), axis=0)  # first maximum
    pre = np.take_along_axis(win(conv), sel[None], axis=0)[0]
    return float(np.sum(np.where(pre < 0, pre * g, 0.0)))


def test_alpha_zero_returns_true_dalpha():
    """At ``alpha == 0`` exactly the JAX kernel returns ``dalpha = 0`` (it
    recovers the gradient as ``sum(out * g) / alpha``); the port returns the
    true ``sum(conv * g)`` over negative selected elements.  (Windows whose
    four values are all negative tie at 0 there; the first one is selected,
    as the JAX kernel's code does.)  ``dW`` and ``db`` agree."""
    arrays = _inputs(21, 30, 4, seed=5, alpha=0.0)
    g = np.random.RandomState(2).randn(2, *tfc.pad_geometry(21, 30), 4).astype(np.float32)

    def fused_loss(w_, b_, a_):
        return jnp.sum(jfc.fused_conv1_prelu_pool(jnp.asarray(arrays[0]), w_, b_, a_) * g)

    fused = jax.grad(fused_loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays[1:]))
    assert float(fused[2][0]) == 0.0  # the JAX kernel's known limit
    true_dalpha = _first_match_dalpha(*arrays, g)
    assert abs(true_dalpha) > 0.1
    x, *params = _t(arrays)
    got = torch.autograd.grad(
        tfc.fused_conv1_prelu_pool(x, *params), params, torch.from_numpy(g)
    )
    _close(got[0].numpy(), fused[0], err_msg="dW")
    _close(got[1].numpy(), fused[1], err_msg="db")
    np.testing.assert_allclose(got[2].item(), true_dalpha, rtol=1e-4)


def test_input_requiring_grad_raises():
    x, *params = _t(_inputs(9, 12, 4))
    with pytest.raises(ValueError, match="no gradient for x"):
        tfc.fused_conv1_prelu_pool(x.requires_grad_(), *params)
    with pytest.raises(ValueError, match="no gradient for x"):
        tfc.fused_conv1_prelu_pool_stats(x, *params)


def _forward_cover(plan):
    """How often the forward's blocks of one frame own each window, and the
    most x-tile rows a block stages (the kernel's index arithmetic)."""
    hits = np.zeros((plan.h2, plan.w2), np.int64)
    per_tile = -(-(plan.h2 * plan.wt) // plan.windows)
    most_rows = 0
    for ct in range(plan.n_ct):
        j0 = ct * plan.wt
        for k in range(per_tile):
            q0 = k * plan.windows
            q1 = min(q0 + plan.windows, plan.h2 * plan.wt)
            most_rows = max(most_rows, 2 * ((q1 - 1) // plan.wt - q0 // plan.wt) + 4)
            p = np.arange(q0, q1)
            i, j = p // plan.wt, j0 + p % plan.wt
            keep = j < plan.w2
            np.add.at(hits, (i[keep], j[keep]), 1)
    return hits, most_rows


def _backward_cover(plan, c):
    """How often the backward's lanes of one channel own each window, and
    whether every run of four windows a warp copies at once starts on a
    multiple of four elements of the NCHW plane (its 16-byte loads)."""
    hits = np.zeros((plan.h2, plan.w2), np.int64)
    groups = plan.bwd_threads // 32 // -(-c // 32)
    aligned = True
    for i0 in range(0, plan.h2, plan.rows):
        for j0 in range(0, plan.w2, plan.wt):
            wc, nr = min(plan.wt, plan.w2 - j0), min(plan.rows, plan.h2 - i0)
            n_win = nr * wc
            nq = -(-n_win // 4)
            for grp in range(groups):
                wa = min(4 * (grp * nq // groups), n_win)
                wb = min(4 * ((grp + 1) * nq // groups), n_win)
                v = np.arange(wa, wb)
                i, j = i0 + v // wc, j0 + v % wc
                np.add.at(hits, (i, j), 1)
                e = i * plan.w2 + j  # the window's element in the plane
                aligned &= bool(np.all(e[::4] % 4 == 0)) and (wb - wa) % 4 == 0
    return hits, aligned


@pytest.mark.parametrize(
    "b,h,w,c,fwd_blocks,bwd_blocks,bwd_threads,aligned",
    [(128, 95, 256, 64, 128 * 13, 128 * 12, 256, True),  # the DCNN at 1 s: 48 x 129
     (64, 181, 256, 64, 64 * 23, 64 * 23, 256, False),  # 2 s: 91 x 129, odd plane
     (2, 87, 256, 4, 2 * 12, 2 * 11, 256, True),  # 44 x 129 = 4 * 1419
     (2, 101, 256, 8, 2 * 13, 2 * 13, 256, False),  # 51 x 129: odd plane
     (3, 101, 256, 256, 3 * 13, 3 * 13, 256, False),
     (2, 95, 512, 96, 2 * 25, 2 * 12, 192, True),  # level 9: 48 x 257, three slabs
     (3, 7, 5, 12, 3 * 1, 3 * 1, 256, True),  # 4 x 3
     (2, 40, 700, 64, 2 * 2 * 8, 2 * 6 * 2, 256, False)],  # two column tiles
)
def test_launch_plan_covers_the_output(b, h, w, c, fwd_blocks, bwd_blocks, bwd_threads,
                                       aligned):
    """The tiling the CUDA kernels are given (computed on the host): each
    kernel owns every window of the NCHW plane exactly once, the forward's
    x tile fits what the plan allocates, and the backward copies four
    windows at a time only where each run starts on 16 bytes of g."""
    plan = fused_conv1_cuda.launch_plan(b, h, w, c)
    assert (plan.h2, plan.w2) == tfc.pad_geometry(h, w)
    assert (plan.fwd_blocks, plan.bwd_blocks, plan.bwd_threads, plan.aligned) == (
        fwd_blocks, bwd_blocks, bwd_threads, aligned)
    assert plan.bwd_threads % 32 == 0 and plan.bwd_threads <= fused_conv1_cuda.MAX_THREADS
    assert plan.n_ct * plan.wt >= plan.w2 and plan.wt <= fused_conv1_cuda.CONV1_TILE_COLS
    # even: the forward's float2 reads; not a multiple of 32: the backward's
    # lanes read x at offsets 0, 1, stride and stride + 1, in distinct banks
    assert plan.stride >= 2 * plan.wt + 2 and plan.stride % 2 == 0 and plan.stride % 32
    hits, most_rows = _forward_cover(plan)
    assert (hits == 1).all()
    tables = 4 * (fused_conv1_cuda.TAP_FLOATS * c + fused_conv1_cuda.FWD_THREADS // 32 * 2 * c)
    assert tables + 4 * most_rows * plan.stride <= plan.fwd_smem_bytes
    hits, every_run_aligned = _backward_cover(plan, c)
    assert (hits == 1).all()
    assert every_run_aligned or not plan.aligned
    staged = 4 * ((2 * plan.rows + 2) * plan.stride + 2 * plan.rows * plan.wt) + (
        plan.bwd_threads * 4 * (fused_conv1_cuda.BWD_G_PITCH + fused_conv1_cuda.BWD_C_PITCH))
    assert plan.bwd_smem_bytes >= staged
    # the forward takes no opt-in to large shared memory, nor the backward at
    # the DCNN's 129 columns; wider tiles opt in, within the card's 227 KB
    assert plan.fwd_smem_bytes <= 48 * 1024
    assert plan.bwd_smem_bytes <= (48 if plan.wt <= 129 else 227) * 1024


def test_dcnn_fused_first_block_makes_no_copy(monkeypatch):
    """The DCNN hands the block's own memory on: the NCHW view of its
    output, contiguous, to BatchNorm ``cnn[3]`` (training: the moments'
    BatchNorm; eval: the module), with no copy between them."""
    from audiodeepfake_detection_tpu_torch.models import dcnn

    made, seen = [], []
    for name in ("fused_conv1_prelu_pool", "fused_conv1_prelu_pool_stats"):
        real = getattr(dcnn, name)

        def spy(*args, real=real):
            got = real(*args)
            made.append((got[0] if isinstance(got, tuple) else got).data_ptr())
            return got

        monkeypatch.setattr(dcnn, name, spy)
    real_bn = dcnn.batch_norm_from_moments
    monkeypatch.setattr(dcnn, "batch_norm_from_moments",
                        lambda bn, x, s, q: seen.append(x) or real_bn(bn, x, s, q))
    torch.manual_seed(0)
    model = dcnn.DCNN(fused_layer1="always")
    model.cnn[3].register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    x = torch.randn(2, 1, 9, 16)  # [B, 1, T, F]
    for training, nxt in ((True, 4), (False, 3)):
        made.clear()
        seen.clear()
        model.train(training)
        act, at = model._fused_first_block(x)
        if not training:
            model.cnn[3](act)
        assert at == nxt and len(made) == len(seen) == 1
        assert seen[0].shape == (2, 64, 5, 9) and seen[0].is_contiguous()
        assert seen[0].data_ptr() == made[0]


def test_launch_plan_refuses_with_the_numbers():
    with pytest.raises(ValueError, match="C=300 output channels exceed"):
        fused_conv1_cuda.launch_plan(2, 95, 256, 300)
    with pytest.raises(ValueError, match="empty geometry B=0"):
        fused_conv1_cuda.launch_plan(0, 95, 256, 64)
