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
        # the headline geometry: 12 channels a thread forward; dx in 8 x 32
        # pixel tiles; dw one block per SM (2 tiles x 66 splits)
        (128, 48, 129, 64, 96, (12, 256, 128 * 24 * 2, 1), (256, 128 * 6 * 5, 1, 96),
         (384, 2, 66)),
        # narrow widths: one warp forward; dw takes all 6 steps as splits
        (2, 7, 9, 3, 5, (8, 32, 2 * 3 * 1, 1), (256, 2 * 1 * 1, 1, 8), (384, 1, 6)),
        # wide Cout: three forward channel tiles of 64, two dw tiles of 96
        (1, 4, 70, 8, 160, (8, 256, 1 * 2 * 2, 3), (256, 1 * 1 * 3, 1, 160), (384, 2, 6)),
    ],
)
def test_launch_plans_cover_the_outputs(b, h, w, c_in, c_out, fwd, dx, dw):
    """The tilings the CUDA kernels are given (computed on the host)."""
    plan = fused_conv2_cuda.tile_plan(b, h, w, c_out)
    assert plan[:4] == fwd
    assert plan.grid_y * (plan.threads // 32) * plan.nc >= c_out
    plan_dx = fused_conv2_cuda.dx_plan(b, h, w, c_in, c_out)
    assert plan_dx[:4] == dx
    assert plan_dx.grid_x == b * -(-h // 8) * -(-w // 32) and plan_dx.grid_y * 64 >= c_in
    assert plan_dx.cout_pad % 8 == 0 and plan_dx.cout_pad >= c_out
    plan_dw = fused_conv2_cuda.dw_plan(b, h, w, c_in, c_out)
    assert (plan_dw.threads, plan_dw.tiles, plan_dw.splits) == dw
    assert plan_dw.tiles == -(-c_in // 32) * -(-c_out // 96)
    assert plan_dw.splits <= plan_dw.steps == b * (h // 2) * -(-(w // 2) // 16)
    # above 48 KB the kernels opt in (cudaFuncSetAttribute) up to the H100's 227 KB
    smem = (plan.smem_bytes, plan_dx.smem_bytes, plan_dw.smem_bytes)
    assert max(smem) <= 227 * 1024
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in fused_conv2_cuda.SOURCE.read_text()
    # the dw partials stay at a few MB
    assert plan_dw.splits * 9 * c_in * c_out * 4 <= 16 * 2**20


@pytest.mark.parametrize("plan", ["tile", "dx", "dw"])
@pytest.mark.parametrize("h,w", [(1, 10), (8, 1), (0, 0)])
def test_plans_refuse_geometries_the_kernels_do_not_take(plan, h, w):
    """No silent fallback: a plan raises, with the numbers, for a geometry
    that leaves no pooled output."""
    fn = {"tile": lambda: fused_conv2_cuda.tile_plan(2, h, w, 5),
          "dx": lambda: fused_conv2_cuda.dx_plan(2, h, w, 3, 5),
          "dw": lambda: fused_conv2_cuda.dw_plan(2, h, w, 3, 5)}[plan]
    with pytest.raises(ValueError, match=f"B=2, H={h}, W={w}"):
        fn()


@pytest.mark.parametrize("c_in,c_out,nt", [(64, 96, 96), (3, 5, 8), (70, 100, 96)])
def test_host_weight_layouts_hold_each_weight_where_the_kernels_read_it(c_in, c_out, nt):
    """The forward's ``[Cout tiles][Cin_pad][9][nt]`` and the flipped
    ``[Cin tiles][Cout_pad][9 * 64 + 8]`` of ``dx``: every entry of ``w``
    once at its place, zeros in the padding."""
    w = torch.from_numpy(np.random.RandomState(4).randn(9 * c_in, c_out).astype(np.float32))
    w9 = w.view(9, c_in, c_out)
    wk = fused_conv2_cuda.forward_weights(w, c_in, c_out, nt)
    tiles, cin_pad = -(-c_out // nt), -(-c_in // 8) * 8
    assert wk.shape == (tiles, cin_pad, 9, nt) and wk.is_contiguous()
    full = wk.permute(1, 2, 0, 3).reshape(cin_pad, 9, tiles * nt)
    assert torch.equal(full[:c_in, :, :c_out], w9.permute(1, 0, 2))
    assert not full[c_in:].any() and not full[:, :, c_out:].any()
    cout_pad = -(-c_out // 8) * 8
    wdx = fused_conv2_cuda.dx_weights(w, c_in, c_out, cout_pad)
    ci_tiles = -(-c_in // 64)
    assert wdx.shape == (ci_tiles, cout_pad, 9 * 64 + 8) and wdx.is_contiguous()
    assert not wdx[..., 9 * 64:].any()
    taps = wdx[..., : 9 * 64].reshape(ci_tiles, cout_pad, 9, 64)
    taps = taps.permute(1, 2, 0, 3).reshape(cout_pad, 9, ci_tiles * 64)
    flipped = w9.flip(0)  # tap (dh, dw) -> (2 - dh, 2 - dw): the flat tap order reversed
    assert torch.equal(taps[:c_out, :, :c_in], flipped.permute(2, 0, 1))
    assert not taps[c_out:].any() and not taps[:, :, c_in:].any()


def _tf32(a):
    """Round float32 to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped
    13 bits to the magnitude (the int32 view is sign-magnitude), then clear
    them."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)


def _split(a):
    big = _tf32(a)
    return big, _tf32(np.asarray(a, np.float32) - big)


def test_split_tf32_backward_is_fp32_accurate_and_one_pass_is_not():
    """The arithmetic of the ``dx`` / ``dw`` kernels: each operand split into
    TF32 big + small parts, ``small * big + big * small + big * big`` summed
    in float32, lies within 1e-5 of the largest entry of a float64
    reference; one TF32 pass (``big * big``) is 100x worse.  The GEMM
    formulations (``dx``: im2col of the padded cotangent with flipped taps
    against ``w``; ``dw``: im2col(x)^T . d, rows (tap, ci)) are first held to
    torch's float64 convolution gradients, and the conv-output cotangent is
    built from a seeded selection code, as the kernels rebuild it."""
    b, c_in, c_out, h, w = 2, 64, 96, 8, 10
    rng = np.random.RandomState(5)
    x = rng.randn(b, h, w, c_in).astype(np.float32)
    wt = (rng.randn(9 * c_in, c_out) * 0.05).astype(np.float32)
    code = rng.randint(0, 8, (b, h // 2, w // 2, c_out))  # phase | negative << 2
    g = rng.randn(b, h // 2, w // 2, c_out).astype(np.float32)
    sel = np.where(code >= 4, np.float32(0.25) * g, g)
    d = np.zeros((b, h, w, c_out), np.float32)
    for ph in range(4):
        d[:, ph >> 1 :: 2, ph & 1 :: 2] = np.where((code & 3) == ph, sel, 0.0)
    dp, xp = (np.pad(t, ((0, 0), (1, 1), (1, 1), (0, 0))) for t in (d, x))
    taps = [(dh, dw) for dh in range(3) for dw in range(3)]
    gemms = {
        "dx": (np.concatenate([dp[:, 2 - dh : 2 - dh + h, 2 - dw : 2 - dw + w] for dh, dw in taps],
                              -1).reshape(-1, 9 * c_out),
               np.concatenate([wt[(3 * dh + dw) * c_in : (3 * dh + dw + 1) * c_in].T
                               for dh, dw in taps])),
        "dw": (np.concatenate([xp[:, dh : dh + h, dw : dw + w] for dh, dw in taps],
                              -1).reshape(-1, 9 * c_in).T.copy(),
               d.reshape(-1, c_out)),
    }
    # the formulations are the block's gradients
    weight = torch.from_numpy(wt).double().reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1)
    d_t = torch.from_numpy(d).double().permute(0, 3, 1, 2)
    x_t = torch.from_numpy(x).double().permute(0, 3, 1, 2)
    want = {
        "dx": torch.nn.grad.conv2d_input(x_t.shape, weight, d_t, padding=1)
        .permute(0, 2, 3, 1).reshape(-1, c_in).numpy(),
        "dw": torch.nn.grad.conv2d_weight(x_t, weight.shape, d_t, padding=1)
        .permute(2, 3, 1, 0).reshape(9 * c_in, c_out).numpy(),
    }
    for name, (a, bm) in gemms.items():
        ref = a.astype(np.float64) @ bm.astype(np.float64)
        np.testing.assert_allclose(ref, want[name], rtol=0, atol=1e-12, err_msg=name)
        scale = np.abs(ref).max()
        (a_big, a_small), (b_big, b_small) = _split(a), _split(bm)
        three = (a_small @ b_big) + (a_big @ b_small) + (a_big @ b_big)
        one = a_big @ b_big
        err3, err1 = (float(np.abs(t - ref).max() / scale) for t in (three, one))
        assert err3 <= 1e-5, (name, err3)
        assert err1 >= 100 * err3 and err1 >= 1e-4, (name, err1, err3)
        # bf16 inputs: x and w are exact in TF32, only d is split (two products)
        if name == "dx":
            b16 = torch.from_numpy(bm).bfloat16().float().numpy()
            assert np.array_equal(_tf32(b16), b16)


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("alpha", [0.25, -0.3])
def test_chip_smokes_float64_rebuild_is_the_blocks_gradient(alpha):
    """``chip_smoke.py`` holds the kernels' fp32 ``dx`` / ``dw`` against a
    float64 rebuild from their own code (``conv2_cotangent`` then
    ``conv2_dense_grads``) and a one-pass TF32 model (``tf32``).  Here, from
    a float64 forward's own selection, that rebuild is float64 autograd's
    gradient of the block with its moments, odd H and W included, and
    ``tf32`` rounds as the numpy model above does."""
    import torch.nn.functional as F

    cs = _chip_smoke()
    b, c_in, c_out, h, w = 2, 8, 12, 7, 9
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(b, c_in, h, w, generator=gen)
    wt = 0.1 * torch.randn(9 * c_in, c_out, generator=gen)
    corr = 0.1 * torch.randn(c_out, h, w, generator=gen)
    g = torch.randn(b, c_out, h // 2, w // 2, generator=gen)
    gs, gq = 0.01 * torch.randn(c_out, generator=gen), 0.001 * torch.randn(c_out, generator=gen)
    a = torch.tensor([alpha], dtype=torch.float64)
    xd, wd = x.double().requires_grad_(), wt.double().requires_grad_()
    conv = F.conv2d(xd, wd.view(3, 3, c_in, c_out).permute(3, 2, 0, 1), padding=1) + corr.double()
    act = torch.where(conv >= 0, conv, a * conv)
    y = F.max_pool2d(act, 2)
    dx, dw = torch.autograd.grad([y, y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))], [xd, wd],
                                 [g.double(), gs.double(), gq.double()])
    h2, w2 = h // 2, w // 2
    phases = [(p >> 1, p & 1) for p in range(4)]
    cands = torch.stack([act[:, :, r:2 * h2:2, c:2 * w2:2] for r, c in phases]).detach()
    pre = torch.stack([conv[:, :, r:2 * h2:2, c:2 * w2:2] for r, c in phases]).detach()
    first = cands.argmax(0)  # the first of several maxima, as the kernel keeps it
    neg = pre.gather(0, first[None])[0] < 0
    code = (first | neg.long() << 2).to(torch.uint8)
    d = cs.conv2_cotangent(y.detach(), code, g, gs, gq, a, h, w)
    got = cs.conv2_dense_grads(x, wt, d)
    for name, want, have in zip(("dx", "dw"), (dx, dw), got):
        torch.testing.assert_close(have, want, rtol=0, atol=1e-12, msg=name)
    assert torch.equal(cs.tf32(x), torch.from_numpy(_tf32(x.numpy())))


def test_launcher_refuses_with_the_numbers():
    """The CUDA launcher's host-side checks (no card needed to fail them)."""
    x, w, corr, a = [t.detach() for t in _port(_inputs(8, 10))]
    with pytest.raises(ValueError, match="need a CUDA tensor, got cpu"):
        fused_conv2_cuda.forward(x, w, corr, a, False, False)
    assert fused_conv2_cuda.CONV2_FWD_LAUNCHES == fused_conv2_cuda.CONV2_BWD_LAUNCHES == 0
