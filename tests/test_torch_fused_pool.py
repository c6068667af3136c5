"""Port fused PReLU + pool (plain version, CPU) vs the JAX Pallas kernels.

The same numpy arrays go through ``fused_prelu_pool[_stats]`` of both
packages.  The JAX functions (NHWC) reach their Pallas kernels in interpret
mode on the CPU by themselves; the port's functions (NCHW) take their plain
PyTorch version because the tensors lie on the CPU, so the arrays are
permuted on the way in and out.  The CUDA kernels are held against the same
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.ops import fused_pool as jfp
from audiodeepfake_detection_tpu_torch.ops import fused_pool as tfp
from audiodeepfake_detection_tpu_torch.ops import fused_pool_cuda

# (H, W, C): even, odd both ways, the stft-like tall one, odd W alone
GEOMETRIES = [(8, 10, 6), (7, 9, 5), (51, 8, 4), (12, 33, 16)]
# each geometry with one slope, negative ones among them
SLOPED = [(*g, a) for g, a in zip(GEOMETRIES, (0.25, -0.5, 0.25, -0.5))]
# forward: a select and at most one fp32 product per element on both sides
FWD_ATOL = 2e-5
# gradients: dx is elementwise, dalpha an fp32 sum of a few thousand terms
GRAD_ATOL = 5e-5
# through the moments: one more fp32 product chain per element
STATS_ATOL = 1e-4


def _nhwc(t):
    """Port NCHW tensor -> the JAX layout, as numpy."""
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _inputs(h, w, c, seed=0, b=2, alpha=0.25):
    rng = np.random.RandomState(seed)
    return rng.randn(b, h, w, c).astype(np.float32), np.asarray([alpha], np.float32)


def _port(x, alpha, dtype=torch.float32):
    """Leaf tensors of the port's layout that require grad."""
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype).requires_grad_()
    return tx, torch.from_numpy(alpha).to(dtype).requires_grad_()


@pytest.mark.parametrize("h,w,c,alpha", SLOPED)
def test_forward_matches_jax(h, w, c, alpha):
    x, a = _inputs(h, w, c, alpha=alpha)
    want = np.asarray(jfp.fused_prelu_pool(jnp.asarray(x), jnp.asarray(a)))
    tx, ta = _port(x, a)
    got = tfp.fused_prelu_pool(tx, ta)
    assert got.shape == (2, c, h // 2, w // 2) and got.is_contiguous()
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("h,w,c,alpha", SLOPED)
def test_gradients_match_jax(h, w, c, alpha):
    """``dx`` (zero in a dropped odd row or column) and ``dalpha``."""
    x, a = _inputs(h, w, c, seed=1, alpha=alpha)
    g = np.random.RandomState(7).randn(2, h // 2, w // 2, c).astype(np.float32)
    want = jax.grad(
        lambda x_, a_: jnp.sum(jfp.fused_prelu_pool(x_, a_) * g), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(a))
    tx, ta = _port(x, a)
    out = tfp.fused_prelu_pool(tx, ta)
    dx, da = torch.autograd.grad(out, (tx, ta), torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(dx), np.asarray(want[0]), rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(da.numpy(), np.asarray(want[1]), rtol=GRAD_ATOL, atol=GRAD_ATOL)
    if h % 2:
        assert not dx[:, :, -1].any()
    if w % 2:
        assert not dx[..., -1].any()


@pytest.mark.parametrize("h,w,c", GEOMETRIES)
def test_stats_variant_moments_and_gradients_match_jax(h, w, c):
    """Cotangents on all three outputs (out, sum, sumsq)."""
    x, a = _inputs(h, w, c, seed=2)
    rng = np.random.RandomState(8)
    g = rng.randn(2, h // 2, w // 2, c).astype(np.float32)
    gs = (rng.randn(c) * 0.5).astype(np.float32)
    gq = (rng.randn(c) * 0.05).astype(np.float32)

    def loss(x_, a_):
        y, s, q = jfp.fused_prelu_pool_stats(x_, a_)
        return jnp.sum(y * g) + jnp.sum(s * gs) + jnp.sum(q * gq)

    jy, js, jq = jfp.fused_prelu_pool_stats(jnp.asarray(x), jnp.asarray(a))
    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(a))
    tx, ta = _port(x, a)
    y, s, q = tfp.fused_prelu_pool_stats(tx, ta)
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=0, atol=FWD_ATOL)
    assert s.dtype == q.dtype == torch.float32 and s.shape == q.shape == (c,)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
    dx, da = torch.autograd.grad(
        [y, s, q], (tx, ta),
        [torch.from_numpy(g).permute(0, 3, 1, 2), torch.from_numpy(gs), torch.from_numpy(gq)],
    )
    np.testing.assert_allclose(_nhwc(dx), np.asarray(want[0]), rtol=0, atol=STATS_ATOL)
    np.testing.assert_allclose(da.numpy(), np.asarray(want[1]), rtol=STATS_ATOL, atol=STATS_ATOL)


def test_bf16_io_matches_jax():
    """bf16 in -> bf16 out: PReLU in float32, one rounding at the store, on
    both sides; outputs agree to one bf16 ulp of the largest value.  ``dx``
    comes back in bf16 on both sides."""
    h, w, c = 12, 33, 16
    x, a = _inputs(h, w, c, seed=3)
    rng = np.random.RandomState(9)
    g = rng.randn(2, h // 2, w // 2, c).astype(np.float32)
    gs = (rng.randn(c) * 0.5).astype(np.float32)
    gq = (rng.randn(c) * 0.05).astype(np.float32)
    jx, ja = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(a).astype(jnp.bfloat16)
    g16 = jnp.asarray(g).astype(jnp.bfloat16)

    def loss(x_, a_):
        y, s, q = jfp.fused_prelu_pool_stats(x_, a_)
        return (jnp.sum(y.astype(jnp.float32) * g16.astype(jnp.float32))
                + jnp.sum(s * gs) + jnp.sum(q * gq))

    jy, js, jq = jfp.fused_prelu_pool_stats(jx, ja)
    want = jax.grad(loss, argnums=(0, 1))(jx, ja)
    tx, ta = _port(x, a, torch.bfloat16)
    y, s, q = tfp.fused_prelu_pool_stats(tx, ta)
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    jy32 = np.asarray(jy.astype(jnp.float32))
    ulp = float(np.abs(jy32).max()) * 2.0**-7
    np.testing.assert_allclose(_nhwc(y), jy32, rtol=0, atol=ulp)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=1e-3, atol=1e-3)
    dx, da = torch.autograd.grad(
        [y, s, q], (tx, ta),
        [torch.from_numpy(g).permute(0, 3, 1, 2).bfloat16(), torch.from_numpy(gs),
         torch.from_numpy(gq)],
    )
    assert dx.dtype == da.dtype == torch.bfloat16
    want_dx = np.asarray(want[0].astype(jnp.float32))
    # both sides return bf16 gradients: 2**-8 of the largest entry
    np.testing.assert_allclose(_nhwc(dx), want_dx, rtol=0, atol=np.abs(want_dx).max() * 1e-2)
    np.testing.assert_allclose(
        da.float().numpy(), np.asarray(want[1].astype(jnp.float32)), rtol=2e-2)


def _first_match(x, alpha, g):
    """Float64 numpy reference on NHWC: ``(out, dx, dalpha)`` with the first
    maximum of each PReLU'd window in the order (0,0), (0,1), (1,0), (1,1)."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x64 = x.astype(np.float64)
    act = np.where(x64 >= 0, x64, float(alpha[0]) * x64)
    win = lambda t: np.stack(  # noqa: E731
        [t[:, p : 2 * h2 : 2, q : 2 * w2 : 2] for p in (0, 1) for q in (0, 1)])
    sel = np.argmax(win(act), axis=0)  # first maximum
    out = np.take_along_axis(win(act), sel[None], axis=0)[0]
    pre = np.take_along_axis(win(x64), sel[None], axis=0)[0]
    d = np.where(pre < 0, float(alpha[0]), 1.0) * g
    dx = np.zeros_like(x64)
    for ph in range(4):
        dx[:, ph >> 1 : 2 * h2 : 2, ph & 1 : 2 * w2 : 2] = np.where(sel == ph, d, 0.0)
    return out, dx, float(np.sum(np.where(pre < 0, pre * g, 0.0)))


def _tie_case():
    """Constant and duplicated planes: ties in every window of frame 0; with
    a zero slope every all-negative window ties at 0 as well."""
    rng = np.random.RandomState(11)
    x = rng.randn(3, 8, 10, 4).astype(np.float32)
    x[0] = -1.5  # all negative, all equal
    x[1] = np.repeat(np.repeat(rng.randn(4, 5, 4), 2, axis=0), 2, axis=1)
    g = rng.randn(3, 4, 5, 4).astype(np.float32)
    return x, g


@pytest.mark.parametrize("alpha", [0.25, 0.0, -0.5])
def test_ties_and_zero_slope_match_the_jax_kernel_and_first_match(alpha):
    """The JAX kernel, the port and a float64 first-match reference agree on
    which element of a tied window receives the gradient.  (The JAX
    package's unfused ``reference_prelu_pool`` splits a tie's gradient, so
    it is no yardstick here.)  At ``alpha == 0`` the JAX kernel returns
    ``dalpha = 0``; the port returns the true sum."""
    x, g = _tie_case()
    a = np.asarray([alpha], np.float32)
    want_out, want_dx, want_da = _first_match(x, a, g)
    jout = jfp.fused_prelu_pool(jnp.asarray(x), jnp.asarray(a))
    jdx, jda = jax.grad(
        lambda x_, a_: jnp.sum(jfp.fused_prelu_pool(x_, a_) * g), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(a))
    tx, ta = _port(x, a)
    out = tfp.fused_prelu_pool(tx, ta)
    dx, da = torch.autograd.grad(out, (tx, ta), torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_nhwc(out), want_out, rtol=0, atol=1e-6)
    np.testing.assert_allclose(_nhwc(dx), np.asarray(jdx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_nhwc(dx), want_dx, rtol=0, atol=1e-6)
    # frame 0 is constant: every window's gradient sits at position (0, 0)
    assert not dx[0, :, 1::2].any() and not dx[0, :, :, 1::2].any()
    assert abs(want_da) > 0.1
    np.testing.assert_allclose(da.item(), want_da, rtol=1e-5)
    if alpha == 0.0:
        assert float(jda[0]) == 0.0  # the JAX kernel's known limit
    else:
        np.testing.assert_allclose(float(jda[0]), want_da, rtol=1e-4)


def test_launcher_refuses_with_the_numbers():
    """The CUDA launcher's host-side checks (no card needed to fail them)."""
    a = torch.tensor([0.25])
    with pytest.raises(ValueError, match="need a CUDA tensor, got cpu"):
        fused_pool_cuda.forward(torch.zeros(2, 3, 4, 4), a, False, False)
    assert fused_pool_cuda.POOL_FWD_LAUNCHES == fused_pool_cuda.POOL_BWD_LAUNCHES == 0


# the CUDA backward's strips: pooled rows a block takes (kBwdRows in
# csrc/fused_pool.cu, at widths as narrow as these); one dalpha partial per
# (plane, strip)
BWD_ROWS = 16


def _emulated_forward(x, aq, want_code, want_stats):
    """The forward kernel's contract: the first maximum of each PReLU'd
    window (strict ``>`` in the order (0,0), (0,1), (1,0), (1,1)), its code
    ``phase | negative << 2``, the stored output and its moments."""
    b, c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    x32 = x.float()
    act = torch.where(x32 >= 0, x32, aq * x32)
    pos = [(p >> 1, p & 1) for p in range(4)]
    best, pre = act[:, :, 0:2 * h2:2, 0:2 * w2:2], x32[:, :, 0:2 * h2:2, 0:2 * w2:2]
    sel = torch.zeros(b, c, h2, w2, dtype=torch.uint8)
    for ph, (dh, dw) in enumerate(pos[1:], start=1):
        cand = act[:, :, dh:2 * h2:2, dw:2 * w2:2]
        upd = cand > best
        best = torch.where(upd, cand, best)
        pre = torch.where(upd, x32[:, :, dh:2 * h2:2, dw:2 * w2:2], pre)
        sel = torch.where(upd, torch.tensor(ph, dtype=torch.uint8), sel)
    out = best.to(x.dtype)
    code = sel | ((pre < 0).to(torch.uint8) << 2)
    o32 = out.float()
    s, q = (o32.sum(dim=(0, 2, 3)), (o32 * o32).sum(dim=(0, 2, 3))) if want_stats else (None, None)
    return out, code if want_code else None, s, q


def _emulated_backward(x, aq, g, out, code, gs, gq):
    """The backward kernel's algorithm, a window at a time in its order:
    strips of ``BWD_ROWS`` pooled rows of each plane; per window gt = g +
    gs[c] + 2 out gq[c] (the kernel's expression), times alpha where the
    selected input was negative, written at the selected position of its
    2x2 block, zeros elsewhere and in a dropped odd row or column; one dalpha
    partial (x * gt over the strip's negative selections) per strip, summed
    at the end."""
    b, c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    gsc = gs.view(1, c, 1, 1) if gs is not None else torch.zeros(1, c, 1, 1)
    gqc = gq.view(1, c, 1, 1) if gq is not None else torch.zeros(1, c, 1, 1)
    dx = torch.zeros(b, c, h, w)
    partials = []
    for i0 in range(0, h2, BWD_ROWS):
        rows = slice(i0, min(i0 + BWD_ROWS, h2))
        cd = code[:, :, rows].long()
        ph, neg = cd & 3, cd >= 4
        gt = (g[:, :, rows].float() + gsc) + (2.0 * out[:, :, rows].float()) * gqc
        d = torch.where(neg, aq * gt, gt)
        xs = torch.zeros_like(gt)
        for p in range(4):
            dh, dw = p >> 1, p & 1
            block = dx[:, :, 2 * rows.start + dh:2 * rows.stop:2, dw:2 * w2:2]
            block.copy_(torch.where(ph == p, d, torch.zeros_like(d)))
            xs = torch.where(ph == p, x[:, :, 2 * rows.start + dh:2 * rows.stop:2,
                                         dw:2 * w2:2].float(), xs)
        partials.append(torch.where(neg, xs * gt, torch.zeros_like(gt)).sum(dim=(2, 3)))
    return dx.to(x.dtype), torch.stack(partials, -1).sum().reshape(1)


@pytest.mark.parametrize("h,w,c,alpha", [(7, 9, 5, -0.5), (35, 33, 6, 0.25), (18, 12, 4, 0.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_with_the_kernels_algorithm_equals_plain(monkeypatch, h, w, c, alpha,
                                                                   dtype):
    """``_FusedPreluPool`` with the kernels' algorithm as its launchers
    against the plain version, at odd H and W (one strip and several, the
    last one short) and a zero slope.  Without moments, ``dx`` is bit-equal
    (the cotangent is g itself, scaled by alpha at a negative selection, on
    both sides); with them, the kernel forms g + gs + 2 out gq in its own
    order where autograd sums the three in another, so ``dx`` is held to the
    tolerances above.  ``dalpha`` is a sum in another order either way."""
    monkeypatch.setattr(fused_pool_cuda, "forward", _emulated_forward)
    monkeypatch.setattr(fused_pool_cuda, "backward", _emulated_backward)
    x, a = _inputs(h, w, c, seed=12, b=3, alpha=alpha)
    x[0, :4, :4] = -1.5  # tied all-negative windows: at a zero slope they tie at 0
    rng = np.random.RandomState(13)
    cot = [torch.from_numpy(rng.randn(3, c, h // 2, w // 2).astype(np.float32)).to(dtype),
           torch.from_numpy((rng.randn(c) * 0.5).astype(np.float32)),
           torch.from_numpy((rng.randn(c) * 0.05).astype(np.float32))]
    tx, ta = _port(x, a, dtype)
    fused = tfp._FusedPreluPool.apply
    da_tol = GRAD_ATOL if dtype == torch.float32 else 2e-2
    for stats in (False, True):
        n = 3 if stats else 1
        got = torch.autograd.grad(list(fused(tx, ta, stats)[:n]), (tx, ta), cot[:n])
        want = torch.autograd.grad(
            list(tfp.plain_prelu_pool_stats(tx, ta) if stats else [tfp.plain_prelu_pool(tx, ta)]),
            (tx, ta), cot[:n])
        assert got[0].dtype == want[0].dtype == dtype
        if stats:
            ref = want[0].float().abs().max().item()
            np.testing.assert_allclose(got[0].float().numpy(), want[0].float().numpy(), rtol=0,
                                       atol=(STATS_ATOL if dtype == torch.float32 else 1e-2) * ref)
        else:
            assert torch.equal(got[0], want[0])
        np.testing.assert_allclose(got[1].float().numpy(), want[1].float().numpy(),
                                   rtol=da_tol, atol=da_tol)
        if alpha == 0.0:
            assert abs(got[1].item()) > 0.1  # the true sum, not 0
        if h % 2:
            assert not got[0][:, :, -1].any()
        if w % 2:
            assert not got[0][..., -1].any()
