"""The port's fused attention (kernel 4) against the JAX package's.

The JAX ``flash_mha_packed`` runs its Pallas kernels in interpret mode here,
forward and ``custom_vjp`` backward, on the same numpy inputs as the port's
plain PyTorch version (what a CPU tensor takes, and what the CUDA kernels
are held against on the card).  The autograd Function's plumbing (row
statistics saved by the forward, P recomputed from them in the backward) is
run on the CPU through launchers that follow the kernels' algorithm in
PyTorch.
"""

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


def _emulated_forward(qkv, heads, scale, want_stats):
    """The forward kernel's contract in PyTorch: the output and the float32
    per-row (max, sum of exp(s - max)) statistics."""
    b, n, c = qkv.shape
    q, k, _ = qkv.float().view(b, n, 3, heads, c // 3 // heads).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    m = s.amax(-1)
    stats = torch.stack([m, torch.exp(s - m[..., None]).sum(-1)], -1)
    with torch.no_grad():
        out = flash_attention.plain_mha_packed(qkv, heads, scale)
    return out, stats if want_stats else None


def _emulated_backward(qkv, dout, stats, heads, scale):
    """The resident backward's algorithm in PyTorch.  Query side: P
    recomputed from qkv and the saved statistics, dP, the row term
    rowsum(dP * P) from those resident rows, dS rounded to the input type,
    dQ = dS K summed over the 64-key tiles of each parity and the two halves
    added.  Key side: per 64-query tile in order, P and dS again (dS from the
    query side's row term), dV += P^T dO with P rounded, dK += dS^T Q."""
    b, n, c = qkv.shape
    dt = qkv.dtype
    q, k, v = qkv.float().view(b, n, 3, heads, c // 3 // heads).unbind(2)
    do = dout.float().view(b, n, heads, -1)

    def probs(rows):
        s = torch.einsum("bnhd,bmhd->bhnm", q[:, rows], k) * scale
        return torch.exp(s - stats[:, :, rows, :1]) / stats[:, :, rows, 1:]

    def score_grad(rows, p, rowterm):
        dp = torch.einsum("bnhd,bmhd->bhnm", do[:, rows], v)
        if rowterm is None:
            rowterm = (dp * p).sum(-1, keepdim=True)
        return (p * (dp - rowterm) * scale).to(dt).float(), rowterm

    ds, rowterm = score_grad(slice(None), probs(slice(None)), None)
    dq = [torch.zeros_like(q), torch.zeros_like(q)]
    for t in range(0, n, 64):
        keys = slice(t, t + 64)
        dq[(t // 64) % 2] += torch.einsum("bhnm,bmhd->bnhd", ds[..., keys], k[:, keys])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for t in range(0, n, 64):
        rows = slice(t, t + 64)
        p = probs(rows)
        ds_t, _ = score_grad(rows, p, rowterm[:, :, rows])
        dv += torch.einsum("bhnm,bnhd->bmhd", p.to(dt).float(), do[:, rows])
        dk += torch.einsum("bhnm,bnhd->bmhd", ds_t, q[:, rows])
    return torch.stack([dq[0] + dq[1], dk, dv], 2).reshape(b, n, c).to(dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_with_the_kernels_algorithm_equals_plain(monkeypatch, dtype):
    monkeypatch.setattr(flash_attention_cuda, "forward", _emulated_forward)
    monkeypatch.setattr(flash_attention_cuda, "backward", _emulated_backward)
    qkv, g = _inputs(2, 150, 2, seed=3)  # three 64-row tiles, the last ragged
    apply = flash_attention._FlashMHA.apply
    got = _port(qkv, g, 2, 0.125, dtype, fn=apply)
    want = _port(qkv, g, 2, 0.125, dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-6)
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-2 * np.abs(want[1]).max())
    with torch.no_grad():  # no statistics without a gradient
        out = apply(torch.from_numpy(qkv), 2, 0.125)
    np.testing.assert_array_equal(out.numpy(), _port(qkv, g, 2, 0.125)[0])


def test_cpu_tensors_take_the_plain_version_and_the_launcher_refuses_them():
    qkv, g = _inputs(1, 9, 1, seed=4)
    got = _port(qkv, g, 1, 0.125, fn=flash_attention.flash_mha_packed)
    want = _port(qkv, g, 1, 0.125)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert flash_attention_cuda.MHA_FWD_LAUNCHES == flash_attention_cuda.MHA_BWD_LAUNCHES == 0
    with pytest.raises(ValueError, match="need a CUDA tensor"):
        flash_attention_cuda.forward(torch.from_numpy(qkv), 1, 0.125, True)


def test_route_follows_the_token_count_and_alignment():
    """The resident route up to RESIDENT_MAX_N tokens on 16-byte aligned
    tensors, the streaming route beyond; a route can be named, and the
    resident one is refused where it does not apply."""
    qkv = torch.zeros(2, 300, 3 * 64)
    limit = flash_attention_cuda.RESIDENT_MAX_N
    assert limit >= 227  # the AST's token count
    assert flash_attention_cuda.route_for(227, qkv) == "resident"
    assert flash_attention_cuda.route_for(limit, qkv) == "resident"
    assert flash_attention_cuda.route_for(limit + 1, qkv) == "stream"
    odd = qkv.view(-1)[1:].view(1, 1, -1)  # 4 bytes past an aligned start
    assert flash_attention_cuda.route_for(18, odd) == "stream"
    assert flash_attention_cuda._pick(None, 99, qkv) == "resident"
    assert flash_attention_cuda._pick("stream", 99, qkv) == "stream"
    with pytest.raises(ValueError, match="resident route takes"):
        flash_attention_cuda._pick("resident", limit + 1, qkv)
    with pytest.raises(ValueError, match="route must be one of"):
        flash_attention_cuda._pick("tiled", 99, qkv)
