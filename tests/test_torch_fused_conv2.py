"""Port fused conv 3x3 + PReLU + pool (plain version, CPU) vs the JAX Pallas
kernels.

The same numpy arrays go through ``fused_conv2_prelu_pool[_stats]`` of both
packages.  The JAX functions (NHWC) reach their Pallas kernels in interpret
mode on the CPU by themselves; the port's functions (NCHW) take their plain
PyTorch version because the tensors lie on the CPU, so ``x``, ``corr`` and
the results are permuted on the way (``w [9 * Cin, Cout]`` is the same array
on both sides).  The CUDA kernels are held against the same plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.ops import fused_conv2 as jf2
from audiodeepfake_detection_tpu_torch.ops import fused_conv2 as tf2
from audiodeepfake_detection_tpu_torch.ops import fused_conv2_cuda

# (H, W): even, odd both ways, the stft-like tall one, odd W alone
GEOMETRIES = [(8, 10), (7, 9), (51, 8), (6, 13)]
CIN, COUT = 3, 5
# each geometry with one slope, negative ones among them
SLOPED = [(h, w, a) for (h, w), a in zip(GEOMETRIES, (0.25, -0.3, 0.25, -0.3))]
# tracing a Pallas kernel in interpret mode takes seconds however small the
# image, so the variant without moments runs at the two odd geometries only
# (the tie cases add (8, 10)); the variant with moments runs at all four
PLAIN_VARIANT = [SLOPED[1], SLOPED[3]]
# forward: both sides sum 9 * Cin fp32 products per conv value, in another order
FWD_ATOL = 2e-5
# gradients: fp32 sums of up to a few thousand terms taken in another order
GRAD_ATOL = 5e-5
# through the moments: one more fp32 product chain per element
STATS_ATOL = 1e-4
NAMES = ("dx", "dw", "dcorr", "dalpha")


def _inputs(h, w, c_in=CIN, c_out=COUT, seed=0, b=2, alpha=0.25):
    """Arrays in the JAX layout: x NHWC, w [9*Cin, Cout], corr [H, W, Cout]."""
    rng = np.random.RandomState(seed)
    return (
        rng.randn(b, h, w, c_in).astype(np.float32),
        (rng.randn(9 * c_in, c_out) * 0.1).astype(np.float32),
        (rng.randn(h, w, c_out) * 0.1).astype(np.float32),
        np.asarray([alpha], np.float32),
    )


def _port(arrays, dtype=torch.float32):
    """Leaf tensors of the port's layout that require grad; ``corr`` stays
    float32."""
    x, w, corr, a = arrays
    return (
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype).requires_grad_(),
        torch.from_numpy(w).to(dtype).requires_grad_(),
        torch.from_numpy(corr).permute(2, 0, 1).contiguous().requires_grad_(),
        torch.from_numpy(a).to(dtype).requires_grad_(),
    )


def _to_jax_layout(grads):
    """Port gradients ``(dx NCHW, dw, dcorr [Cout,H,W], dalpha)`` as numpy
    arrays in the JAX layout."""
    dx, dw, dcorr, da = [t.detach().float() for t in grads]
    return (dx.permute(0, 2, 3, 1).numpy(), dw.numpy(), dcorr.permute(1, 2, 0).numpy(),
            da.numpy())


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _weighted(y, g):
    """``(sum(y * g), y)``: a loss with the output as auxiliary value."""
    return jnp.sum(y.astype(jnp.float32) * g), y


def _jax_value_and_grad(loss, arrays):
    """``((loss, aux), grads)`` of a JAX loss with an auxiliary output, for
    all four arguments, traced once (the Pallas kernels in interpret mode
    are slow to trace, so the forward is not run a second time)."""
    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))
    return fn(*map(jnp.asarray, arrays))


@functools.lru_cache(maxsize=None)
def _jax_weighted_fn():
    """One traced function for every tie case: the cotangent ``g`` and the
    slope are arguments, the shapes are the same."""
    return jax.jit(jax.value_and_grad(
        lambda x, w, corr, a, g: _weighted(jf2.fused_conv2_prelu_pool(x, w, corr, a), g),
        argnums=(0, 1, 2, 3), has_aux=True))


@pytest.mark.parametrize("h,w,alpha", PLAIN_VARIANT)
def test_forward_and_gradients_match_jax(h, w, alpha):
    """The output and all four gradients; rows and columns past the pooled
    region get a zero ``dcorr`` but still a ``dx`` from their neighbours'
    windows."""
    arrays = _inputs(h, w, seed=1, alpha=alpha)
    g = np.random.RandomState(7).randn(2, h // 2, w // 2, COUT).astype(np.float32)
    (_, want_out), want = _jax_value_and_grad(
        lambda *a: _weighted(jf2.fused_conv2_prelu_pool(*a), g), arrays)
    args = _port(arrays)
    out = tf2.fused_conv2_prelu_pool(*args)
    assert out.shape == (2, COUT, h // 2, w // 2) and out.is_contiguous()
    np.testing.assert_allclose(_nhwc(out), np.asarray(want_out), rtol=0, atol=FWD_ATOL)
    got = torch.autograd.grad(out, args, torch.from_numpy(g).permute(0, 3, 1, 2))
    for name, gt, wt in zip(NAMES, _to_jax_layout(got), want):
        np.testing.assert_allclose(gt, np.asarray(wt), rtol=0, atol=GRAD_ATOL, err_msg=name)
    dx, dcorr = got[0], got[2]
    if h % 2:
        assert not dcorr[:, -1].any() and dx[:, :, -1].any()
    if w % 2:
        assert not dcorr[..., -1].any() and dx[..., -1].any()


@pytest.mark.parametrize("h,w,alpha", SLOPED)
def test_stats_variant_moments_and_gradients_match_jax(h, w, alpha):
    """Cotangents on all three outputs (out, sum, sumsq)."""
    arrays = _inputs(h, w, seed=2, alpha=alpha)
    rng = np.random.RandomState(8)
    g = rng.randn(2, h // 2, w // 2, COUT).astype(np.float32)
    gs = (rng.randn(COUT) * 0.5).astype(np.float32)
    gq = (rng.randn(COUT) * 0.05).astype(np.float32)

    def loss(*a):
        y, s, q = jf2.fused_conv2_prelu_pool_stats(*a)
        return jnp.sum(y * g) + jnp.sum(s * gs) + jnp.sum(q * gq), (y, s, q)

    (_, (jy, js, jq)), want = _jax_value_and_grad(loss, arrays)
    args = _port(arrays)
    y, s, q = tf2.fused_conv2_prelu_pool_stats(*args)
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=0, atol=FWD_ATOL)
    assert s.dtype == q.dtype == torch.float32 and s.shape == q.shape == (COUT,)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(
        [y, s, q], args,
        [torch.from_numpy(g).permute(0, 3, 1, 2), torch.from_numpy(gs), torch.from_numpy(gq)],
    )
    for name, gt, wt in zip(NAMES, _to_jax_layout(got), want):
        np.testing.assert_allclose(gt, np.asarray(wt), rtol=0, atol=STATS_ATOL, err_msg=name)
    if h % 2:
        assert not got[2][:, -1].any() and got[0][:, :, -1].any()


def test_bf16_io_matches_jax():
    """bf16 ``x``, ``w`` and ``alpha``, float32 ``corr``: bf16 products,
    float32 sums, one rounding at the store, on both sides; outputs agree to
    one bf16 ulp of the largest value.  Gradients come back in each
    argument's type.  The JAX backward also rounds the conv-output cotangent
    to bf16 before its dots, the port does not: 2**-8 relative per term."""
    h, w, c_in, c_out = 8, 10, 4, 6
    arrays = _inputs(h, w, c_in, c_out, seed=3)
    g = np.random.RandomState(9).randn(2, h // 2, w // 2, c_out).astype(np.float32)
    b16 = lambda v: jnp.asarray(v).astype(jnp.bfloat16)  # noqa: E731
    jargs = (b16(arrays[0]), b16(arrays[1]), jnp.asarray(arrays[2]), b16(arrays[3]))
    g16 = b16(g).astype(jnp.float32)
    (_, jy), want = _jax_value_and_grad(
        lambda *a: _weighted(jf2.fused_conv2_prelu_pool(*a), g16), jargs)
    args = _port(arrays, torch.bfloat16)
    y = tf2.fused_conv2_prelu_pool(*args)
    assert y.dtype == torch.bfloat16
    jy32 = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(_nhwc(y), jy32, rtol=0, atol=float(np.abs(jy32).max()) * 2.0**-7)
    got = torch.autograd.grad(y, args, torch.from_numpy(g).permute(0, 3, 1, 2).bfloat16())
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.bfloat16]
    for name, gt, wt in zip(NAMES, _to_jax_layout(got), want):
        wt = np.asarray(wt.astype(jnp.float32))
        np.testing.assert_allclose(
            gt, wt, rtol=0, atol=max(float(np.abs(wt).max()), 1.0) * 2e-2, err_msg=name)


def _first_match(arrays, g):
    """Float64 numpy reference in the JAX layout: ``(out, dx, dw, dcorr,
    dalpha)`` with the first maximum of each PReLU'd window in the order
    (0,0), (0,1), (1,0), (1,1)."""
    x, wgt, corr, alpha = [a.astype(np.float64) for a in arrays]
    b, h, w, c_in = x.shape
    c_out = wgt.shape[1]
    h2, w2 = h // 2, w // 2
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    kern = wgt.reshape(3, 3, c_in, c_out)
    conv = corr[None] + sum(
        np.einsum("bhwi,io->bhwo", xp[:, dh : dh + h, dw : dw + w], kern[dh, dw])
        for dh in range(3) for dw in range(3)
    )
    act = np.where(conv >= 0, conv, alpha[0] * conv)
    win = lambda t: np.stack(  # noqa: E731
        [t[:, p : 2 * h2 : 2, q : 2 * w2 : 2] for p in (0, 1) for q in (0, 1)])
    sel = np.argmax(win(act), axis=0)  # first maximum
    out = np.take_along_axis(win(act), sel[None], axis=0)[0]
    pre = np.take_along_axis(win(conv), sel[None], axis=0)[0]
    d_sel = np.where(pre < 0, alpha[0], 1.0) * g
    d = np.zeros_like(conv)
    for ph in range(4):
        d[:, ph >> 1 : 2 * h2 : 2, ph & 1 : 2 * w2 : 2] = np.where(sel == ph, d_sel, 0.0)
    dxp = np.zeros_like(xp)
    dw_ = np.zeros_like(kern)
    for dh in range(3):
        for dw in range(3):
            dxp[:, dh : dh + h, dw : dw + w] += np.einsum("bhwo,io->bhwi", d, kern[dh, dw])
            dw_[dh, dw] = np.einsum("bhwi,bhwo->io", xp[:, dh : dh + h, dw : dw + w], d)
    return (out, dxp[:, 1:-1, 1:-1], dw_.reshape(9 * c_in, c_out), d.sum(axis=0),
            float(np.sum(np.where(pre < 0, pre * g, 0.0))))


def _tie_case(alpha):
    """Zero weights in frame-independent channels make every conv value of
    channel 0 equal its ``corr`` (a constant, negative map: every window
    ties, and at a zero slope ties at 0); channel 1 sees duplicated rows and
    columns; the rest is random."""
    rng = np.random.RandomState(11)
    x, wgt, corr, a = _inputs(8, 10, 3, 4, seed=12, b=3, alpha=alpha)
    x[1] = np.repeat(np.repeat(rng.randn(4, 5, 3), 2, axis=0), 2, axis=1)
    wgt[:, 0] = 0.0
    corr[..., 0] = -0.75
    wgt[:, 1] = 0.0
    wgt[4 * 3 : 5 * 3, 1] = 0.2  # centre tap only: conv == 0.2 * sum_ci x
    corr[..., 1] = 0.0
    g = rng.randn(3, 4, 5, 4).astype(np.float32)
    return (x, wgt, corr, a), g


@pytest.mark.parametrize("alpha", [0.25, 0.0, -0.3])
def test_ties_and_zero_slope_match_the_jax_kernel_and_first_match(alpha):
    """The JAX kernel, the port and a float64 first-match reference agree on
    which element of a tied window receives the gradient.  (The JAX
    package's unfused ``reference_conv2_prelu_pool`` splits a tie's
    gradient, so it is no yardstick here.)  At ``alpha == 0`` the JAX kernel
    returns ``dalpha = 0``; the port returns the true sum."""
    arrays, g = _tie_case(alpha)
    want = _first_match(arrays, g)
    (_, jout), jgrads = _jax_weighted_fn()(*map(jnp.asarray, arrays), jnp.asarray(g))
    args = _port(arrays)
    out = tf2.fused_conv2_prelu_pool(*args)
    got = _to_jax_layout(
        torch.autograd.grad(out, args, torch.from_numpy(g).permute(0, 3, 1, 2)))
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(_nhwc(out), want[0], rtol=0, atol=FWD_ATOL)
    for name, gt, jt, wt in zip(NAMES[:3], got, jgrads, want[1:4]):
        np.testing.assert_allclose(gt, np.asarray(jt), rtol=0, atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(gt, wt, rtol=0, atol=GRAD_ATOL, err_msg=name)
    # channel 0 is constant: every window's gradient sits at position (0, 0)
    dcorr0 = got[2][..., 0]
    assert not dcorr0[1::2].any() and not dcorr0[:, 1::2].any()
    assert dcorr0[0::2, 0::2].all() == (alpha != 0.0)  # a zero slope passes nothing on
    assert abs(want[4]) > 0.1
    np.testing.assert_allclose(got[3][0], want[4], rtol=1e-4)
    if alpha == 0.0:
        assert float(jgrads[3][0]) == 0.0  # the JAX kernel's known limit
    else:
        np.testing.assert_allclose(float(jgrads[3][0]), want[4], rtol=1e-3)


@pytest.mark.parametrize(
    "b,h,w,c_in,c_out,fwd,dx,dw",
    [
        # the headline geometry: 12 channels a thread forward, 8 for dx
        (128, 48, 129, 64, 96, (12, 256, 128 * 24 * 2, 1), (8, 256, 128 * 24 * 3, 1),
         (192, 4, 66)),
        # narrow widths: one warp each; dw takes all 3 steps' worth of splits
        (2, 7, 9, 3, 5, (8, 32, 2 * 3 * 1, 1), (8, 32, 2 * 4 * 1, 1), (32, 1, 6)),
        # wide Cout: two channel tiles of 96
        (1, 4, 70, 8, 160, (8, 256, 1 * 2 * 2, 3), (8, 32, 1 * 2 * 2, 1), (192, 4, 6)),
    ],
)
def test_launch_plans_cover_the_outputs(b, h, w, c_in, c_out, fwd, dx, dw):
    """The tilings the CUDA kernels are given (computed on the host)."""
    plan = fused_conv2_cuda.tile_plan(b, h // 2, w // 2, c_out)
    assert plan[:4] == fwd
    assert plan.grid_y * (plan.threads // 32) * plan.nc >= c_out
    plan_dx = fused_conv2_cuda.tile_plan(b, (h + 1) // 2, (w + 1) // 2, c_in)
    assert plan_dx[:4] == dx
    plan_dw = fused_conv2_cuda.dw_plan(b, h, w, c_in, c_out)
    assert (plan_dw.threads, plan_dw.tiles, plan_dw.splits) == dw
    assert plan_dw.splits <= plan_dw.steps == b * (h // 2) * -(-(w // 2) // 16)
    # no opt-in to large shared memory
    assert max(plan.smem_bytes, plan_dx.smem_bytes, plan_dw.smem_bytes) <= 48 * 1024
    # the dw partials stay at a few MB
    assert plan_dw.splits * 9 * c_in * c_out * 4 <= 16 * 2**20


def test_launcher_refuses_with_the_numbers():
    """The CUDA launcher's host-side checks (no card needed to fail them)."""
    x, w, corr, a = [t.detach() for t in _port(_inputs(8, 10))]
    with pytest.raises(ValueError, match="need a CUDA tensor, got cpu"):
        fused_conv2_cuda.forward(x, w, corr, a, False, False)
    assert fused_conv2_cuda.CONV2_FWD_LAUNCHES == fused_conv2_cuda.CONV2_BWD_LAUNCHES == 0
