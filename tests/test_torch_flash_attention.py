"""The port's fused attention (kernel 4) against the JAX package's.

The JAX ``flash_mha_packed`` runs its Pallas kernels in interpret mode here,
forward and ``custom_vjp`` backward, on the same numpy inputs as the port's
plain PyTorch version (what a CPU tensor takes, and what the CUDA kernels
are held against on the card).  The autograd Function's plumbing (row
statistics saved by the forward, P recomputed from them in the backward) is
run on the CPU through launchers that follow the kernels' algorithm in
PyTorch.
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.ops.flash_attention import flash_mha_packed as jax_flash
from audiodeepfake_detection_tpu_torch.ops import flash_attention, flash_attention_cuda

HIGHEST = jax.lax.Precision.HIGHEST


def _inputs(b, n, heads, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3 * heads * d).astype(np.float32),
            rng.randn(b, n, heads * d).astype(np.float32))


def _jax(qkv, g, heads, scale, dtype=jnp.float32, precision=HIGHEST):
    x = jnp.asarray(qkv).astype(dtype)
    out, vjp = jax.vjp(lambda a: jax_flash(a, heads, scale, precision), x)
    (dqkv,) = vjp(jnp.asarray(g).astype(dtype))
    return np.asarray(out.astype(jnp.float32)), np.asarray(dqkv.astype(jnp.float32))


def _port(qkv, g, heads, scale, dtype=torch.float32, fn=flash_attention.plain_mha_packed):
    x = torch.from_numpy(qkv).to(dtype).requires_grad_()
    out = fn(x, heads, scale)
    (dqkv,) = torch.autograd.grad(out, x, torch.from_numpy(g).to(dtype))
    assert out.dtype == dqkv.dtype == dtype
    return out.detach().float().numpy(), dqkv.float().numpy()


def test_forward_matches_jax_at_the_ast_token_count():
    """N = 227 tokens (25 x 9 patches + cls + dist), four heads of 64."""
    qkv, g = _inputs(2, 227, 4)
    x = jnp.asarray(qkv)
    want = np.asarray(jax_flash(x, 4, 0.125, HIGHEST))
    got = flash_attention.plain_mha_packed(torch.from_numpy(qkv), 4, 0.125)
    assert got.shape == (2, 227, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_gradients_match_jax_on_a_ragged_token_count():
    """N = 99 (the JAX package's own kernel test), H = 3: dq, dk and dv."""
    qkv, g = _inputs(1, 99, 3, seed=1)
    want = _jax(qkv, g, 3, 0.125)
    got = _port(qkv, g, 3, 0.125)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=5e-6)


def test_bfloat16_rounds_where_the_jax_kernel_rounds():
    """bf16 in: P rounded before P.V, dS before dQ / dK, f32 sums; the JAX
    kernel at its speed-mode precision (DEFAULT)."""
    qkv, g = _inputs(1, 40, 2, seed=2)
    want = _jax(qkv, g, 2, 0.125, jnp.bfloat16, jax.lax.Precision.DEFAULT)
    got = _port(qkv, g, 2, 0.125, torch.bfloat16)
    # one bf16 ulp of each output (8 bits of mantissa)
    np.testing.assert_allclose(got[0], want[0], rtol=2.0**-8, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-2 * np.abs(want[1]).max())


def test_cpu_tensors_take_the_plain_version_and_the_launcher_refuses_them():
    qkv, g = _inputs(1, 9, 1, seed=4)
    got = _port(qkv, g, 1, 0.125, fn=flash_attention.flash_mha_packed)
    want = _port(qkv, g, 1, 0.125)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert flash_attention_cuda.MHA_FWD_LAUNCHES == flash_attention_cuda.MHA_BWD_LAUNCHES == 0
    with pytest.raises(ValueError, match="need a CUDA tensor"):
        flash_attention_cuda.forward(torch.from_numpy(qkv), 1, 0.125, True)


def test_route_follows_the_token_count_and_alignment(monkeypatch):
    """One route for every token count and alignment: the launchers take no
    ``route`` and know no resident limit, and aligned and misaligned views
    at N = 18, 227 and 300 reach the one C entry point each way, which picks
    the element-wise variant itself.  The ``ctypes`` entry points are replaced by recorders,
    so this runs on the CPU; the fp32 backward passes the forward's output
    for its row term, bf16 passes none."""
    calls = []

    def record(name):
        return lambda *args: calls.append((name, args)) or 0

    lib = types.SimpleNamespace(flash_mha_fwd_launch=record("fwd"),
                                flash_mha_bwd_launch=record("bwd"))
    monkeypatch.setattr(flash_attention_cuda, "_LIB", lib)
    monkeypatch.setattr(flash_attention_cuda, "check_geometry",
                        lambda qkv, heads: tuple(qkv.shape[:2]))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for name in ("RESIDENT_MAX_N", "ROUTES", "route_for", "_pick",
                 "MHA_STREAM_FWD_LAUNCHES", "MHA_STREAM_BWD_LAUNCHES"):
        assert not hasattr(flash_attention_cuda, name), name
    for fn in (flash_attention_cuda.forward, flash_attention_cuda.backward):
        assert "route" not in inspect.signature(fn).parameters
    for name in ("MHA_FWD_LAUNCHES", "MHA_BWD_LAUNCHES"):  # restored after the test
        monkeypatch.setattr(flash_attention_cuda, name, 0)
    cases = [(n, dtype, offset) for n in (18, 227, 300)
             for dtype in (torch.float32, torch.bfloat16) for offset in (0, 1)]
    for n, dtype, offset in cases:
        flat = torch.zeros(2 * n * 3 * 64 + 8, dtype=dtype)
        qkv = flat[offset:offset + 2 * n * 3 * 64].view(2, n, 3 * 64)
        dout = torch.zeros(2 * n * 64 + 8, dtype=dtype)[offset:offset + 2 * n * 64].view(2, n, 64)
        assert (qkv.data_ptr() % 16 == 0) == (offset == 0)
        calls.clear()
        out, stats = flash_attention_cuda.forward(qkv, 1, 0.125, True)
        assert stats.shape == (2, 1, n, 2) and out.shape == (2, n, 64) and out.dtype == dtype
        flash_attention_cuda.backward(qkv, dout, stats, 1, 0.125, out=out)
        (fwd, fargs), (bwd, bargs) = calls
        assert (fwd, bwd) == ("fwd", "bwd")
        assert fargs[0] == bargs[0] == qkv.data_ptr() and bargs[1] == dout.data_ptr()
        assert fargs[3:8] == (2, n, 1, 0.125, int(dtype == torch.bfloat16))
        assert bargs[2] == (out.data_ptr() if dtype == torch.float32 else None)
        if dtype == torch.float32:
            with pytest.raises(ValueError, match="takes the forward's out"):
                flash_attention_cuda.backward(qkv, dout, stats, 1, 0.125)
    assert (flash_attention_cuda.MHA_FWD_LAUNCHES,
            flash_attention_cuda.MHA_BWD_LAUNCHES) == (len(cases), len(cases))


def _stream_forward(qkv, heads, scale, want_stats):
    """The forward kernel's algorithm in PyTorch, over 64-key
    tiles in the kernel's order.  float32: one pass with the online softmax
    (the row max grows tile by tile, O and the row sum are rescaled by
    exp(m_old - m), O / l at the end).  bfloat16: pass 1 gives the row max
    and sum, pass 2 rounds the exact p = exp(s - m) / l to bf16 before P.V."""
    b, n, c = qkv.shape
    dt = qkv.dtype
    q, k, v = qkv.float().view(b, n, 3, heads, c // 3 // heads).unbind(2)
    m = torch.full((b, heads, n), -torch.inf)
    l = torch.zeros(b, heads, n)
    acc = torch.zeros(b, heads, n, q.shape[-1])
    for t in range(0, n, 64):
        s = torch.einsum("bnhd,bmhd->bhnm", q, k[:, t:t + 64]) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if dt == torch.float32:
            acc = acc * alpha[..., None] + torch.einsum("bhnm,bmhd->bhnd", p, v[:, t:t + 64])
        m = m_new
    if dt == torch.float32:
        acc = acc / l[..., None]
    else:
        for t in range(0, n, 64):
            s = torch.einsum("bnhd,bmhd->bhnm", q, k[:, t:t + 64]) * scale
            p = (torch.exp(s - m[..., None]) / l[..., None]).to(dt).float()
            acc = acc + torch.einsum("bhnm,bmhd->bhnd", p, v[:, t:t + 64])
    out = acc.permute(0, 2, 1, 3).reshape(b, n, c // 3).to(dt)
    return out, torch.stack([m, l], -1) if want_stats else None


def _stream_backward(qkv, dout, stats, heads, scale, out=None):
    """The backward kernels' algorithm in PyTorch.  Query side:
    the row term, in float32 rowsum(dO * O) from the forward's output, in
    bfloat16 rowsum(dP * P) from a walk over the 64-key tiles (P from the
    saved statistics); then dS = P * (dP - rowterm) * scale rounded to the
    input type and dQ += dS K tile by tile.  Key side,
    per 64-query tile in order: S^T and dP^T with the keys as rows, P^T and
    dS^T from the tile's statistics and row term, dV += P^T dO with P
    rounded, dK += dS^T Q."""
    b, n, c = qkv.shape
    dt = qkv.dtype
    q, k, v = qkv.float().view(b, n, 3, heads, c // 3 // heads).unbind(2)
    do = dout.float().view(b, n, heads, -1)
    m, l = stats[..., 0], stats[..., 1]
    tiles = [slice(t, t + 64) for t in range(0, n, 64)]

    def p_dp(rows, keys):
        s = torch.einsum("bnhd,bmhd->bhnm", q[:, rows], k[:, keys]) * scale
        p = torch.exp(s - m[:, :, rows, None]) / l[:, :, rows, None]
        return p, torch.einsum("bnhd,bmhd->bhnm", do[:, rows], v[:, keys])

    if dt == torch.float32:
        rowterm = (do * out.view(b, n, heads, -1)).sum(-1).transpose(1, 2)
    else:
        rowterm = torch.zeros(b, heads, n)
        for keys in tiles:
            p, dp = p_dp(slice(None), keys)
            rowterm = rowterm + (dp * p).sum(-1)
    dq = torch.zeros_like(q)
    for keys in tiles:
        p, dp = p_dp(slice(None), keys)
        ds = (p * (dp - rowterm[..., None]) * scale).to(dt).float()
        dq = dq + torch.einsum("bhnm,bmhd->bnhd", ds, k[:, keys])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for rows in tiles:
        p, dp = p_dp(rows, slice(None))
        ds = (p * (dp - rowterm[:, :, rows, None]) * scale).to(dt).float()
        dv = dv + torch.einsum("bhnm,bnhd->bmhd", p.to(dt).float(), do[:, rows])
        dk = dk + torch.einsum("bhnm,bnhd->bmhd", ds, q[:, rows])
    return torch.stack([dq, dk, dv], 2).reshape(b, n, c).to(dt)


@pytest.mark.parametrize("n,seed", [(150, 3), (300, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_with_the_streaming_algorithm_equals_plain(monkeypatch, dtype, n,
                                                                      seed):
    """N = 150 (three 64-key tiles) and 300 (five), the last tile ragged,
    through ``_FlashMHA`` with the kernels' algorithm as its launchers; no
    statistics are made without a gradient."""
    monkeypatch.setattr(flash_attention_cuda, "forward", _stream_forward)
    monkeypatch.setattr(flash_attention_cuda, "backward", _stream_backward)
    qkv, g = _inputs(2, n, 2, seed=seed)
    apply = flash_attention._FlashMHA.apply
    got = _port(qkv, g, 2, 0.125, dtype, fn=apply)
    want = _port(qkv, g, 2, 0.125, dtype)
    if dtype == torch.float32:
        # the online rescale and the tile order change only fp32 rounding
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-6)
    else:
        # P from exp(s - m) / l against torch's softmax: a probability that
        # rounds to the other bf16 neighbour moves an output by about an ulp
        # beside the output's own rounding (2**-8 relative each)
        np.testing.assert_allclose(got[0], want[0], rtol=0,
                                   atol=2.0**-7 * np.abs(want[0]).max())
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-2 * np.abs(want[1]).max())
    seen = []
    monkeypatch.setattr(flash_attention_cuda, "forward",
                        lambda *args: seen.append(args[-1]) or _stream_forward(*args))
    with torch.no_grad():
        out = apply(torch.from_numpy(qkv).to(dtype), 2, 0.125)
    assert seen == [False]
    np.testing.assert_array_equal(out.float().numpy(), got[0])


def _tf32(a):
    """Round float32 to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped
    13 bits to the magnitude (the int32 view is sign-magnitude), then clear
    them."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)


def _split_product(a, b):
    """``a @ b`` as the fp32 streaming kernels form it: each operand split
    into TF32 big + small parts, ``small * big + big * small + big * big``
    summed in float32 (``small * small`` dropped); and one TF32 pass."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return (a_small @ b_big) + (a_big @ b_small) + (a_big @ b_big), a_big @ b_big


def test_split_tf32_attention_products_are_fp32_accurate_and_one_pass_is_not():
    """The fp32 streaming kernels' two kinds of product at the AST's head
    width: S = Q K^T over 64 dims and P V over 300 keys (P the softmax of the
    scaled S), summed as the kernels sum them.  Three TF32 products lie within 1e-6 of the largest entry of
    a float64 reference; one TF32 pass does not (it is ~2**-11 a product)."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(300, 64).astype(np.float32) for _ in range(3))
    s = q @ k.T
    e = np.exp((s - s.max(1, keepdims=True)) * np.float32(0.125))
    p = (e / e.sum(1, keepdims=True)).astype(np.float32)
    for name, (a, bm) in {"QK^T": (q, k.T.copy()), "PV": (p, v)}.items():
        ref = a.astype(np.float64) @ bm.astype(np.float64)
        scale = np.abs(ref).max()
        # a 64-deep tile product from zero, the tiles added in fp32 (nn_add)
        three, one = (sum(parts) for parts in zip(*(
            _split_product(a[:, t:t + 64], bm[t:t + 64]) for t in range(0, a.shape[1], 64))))
        err3, err1 = (float(np.abs(t - ref).max() / scale) for t in (three, one))
        assert err3 <= 1e-6, (name, err3)
        assert err1 > 1e-6 and err1 >= 100 * err3, (name, err1, err3)
