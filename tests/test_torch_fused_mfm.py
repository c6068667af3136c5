"""Port fused LCNN block (plain version, CPU) vs the JAX Pallas kernels.

The same numpy arrays go through ``fused_conv_mfm_pool`` of both packages
and through the JAX package's unfused ``reference_conv_mfm_pool``.  The JAX
function reaches its Pallas kernels in interpret mode on the CPU by itself;
the port's wrapper takes its plain PyTorch version because the tensors lie
on the CPU.  The CUDA kernels are held against the same plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.ops import fused_conv1 as jfc
from audiodeepfake_detection_tpu_torch.ops import fused_conv1 as tfc
from audiodeepfake_detection_tpu_torch.ops import fused_conv1_cuda

# (H, W, C): the stft image, the packet image, the LFCC image, an odd one
GEOMETRIES = [(101, 256, 8), (95, 256, 4), (101, 20, 64), (21, 30, 6)]
# forward: both sides sum 25 fp32 products per conv value, in another order
FWD_ATOL = 2e-5
# gradients are fp32 sums over up to 2*50*128 terms taken in another order:
# relative to the largest entry of each tensor
SUM_RTOL = 2e-5


def _inputs(h, w, c, seed=0, b=2):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(b, h, w).astype(np.float32),
        (rng.randn(25, c) * 0.1).astype(np.float32),
        (rng.randn(c) * 0.1).astype(np.float32),
    )


def _t(arrays, dtype=torch.float32, grad=True):
    x, *params = [torch.from_numpy(a).to(dtype) for a in arrays]
    return [x] + [p.requires_grad_(grad) for p in params]


def _close(got, want, rtol=SUM_RTOL, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol, err_msg=err_msg)


def _jax_grads(fn, arrays, g):
    def loss(w_, b_):
        return jnp.sum(fn(jnp.asarray(arrays[0]), w_, b_) * g)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(*map(jnp.asarray, arrays[1:]))


@pytest.mark.parametrize("h,w,c", GEOMETRIES)
def test_forward_matches_jax_kernel_and_reference(h, w, c):
    arrays = _inputs(h, w, c)
    got = tfc.fused_conv_mfm_pool(*_t(arrays, grad=False))
    assert got.shape == (2, h // 2, w // 2, c // 2)  # pad 2 keeps H, W; floor pooling
    assert got.permute(0, 3, 1, 2).is_contiguous()  # NCHW memory, as the kernel's
    for fn in (jfc.fused_conv_mfm_pool, jfc.reference_conv_mfm_pool):
        want = np.asarray(fn(*map(jnp.asarray, arrays)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("h,w,c", GEOMETRIES)
def test_gradients_match_jax_kernel_and_reference(h, w, c):
    arrays = _inputs(h, w, c, seed=1)
    g = np.random.RandomState(7).randn(2, h // 2, w // 2, c // 2).astype(np.float32)
    x, *params = _t(arrays)
    got = torch.autograd.grad(tfc.fused_conv_mfm_pool(x, *params), params, torch.from_numpy(g))
    for fn in (jfc.fused_conv_mfm_pool, jfc.reference_conv_mfm_pool):
        for name, gt, wt in zip(("dW", "db"), got, _jax_grads(fn, arrays, g)):
            assert gt.shape == wt.shape, name
            _close(gt.numpy(), wt, err_msg=f"{name} vs {fn.__name__}")


def test_bf16_io_matches_jax():
    """bf16 in -> bf16 out: x and the parameters rounded to bf16, fp32
    accumulation, one rounding of the maximum.  Both packages round at the
    same places, so outputs agree to one bf16 ulp of the largest value (a
    sum that lands on a rounding boundary may fall either way); both return
    bf16 gradients (2**-8 of the largest entry)."""
    h, w, c = 95, 256, 8
    arrays = _inputs(h, w, c, seed=3)
    g = np.random.RandomState(9).randn(2, h // 2, w // 2, c // 2).astype(np.float32)
    j16 = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    g16 = jnp.asarray(g).astype(jnp.bfloat16)

    def loss(w_, b_):
        y = jfc.fused_conv_mfm_pool(j16[0], w_, b_)
        return jnp.sum(y.astype(jnp.float32) * g16.astype(jnp.float32))

    jy = np.asarray(jfc.fused_conv_mfm_pool(*j16).astype(jnp.float32))
    want = jax.grad(loss, argnums=(0, 1))(*j16[1:])
    x, *params = _t(arrays, dtype=torch.bfloat16)
    y = tfc.fused_conv_mfm_pool(x, *params)
    assert y.dtype == torch.bfloat16
    ulp = float(np.abs(jy).max()) * 2.0**-7
    np.testing.assert_allclose(y.float().detach().numpy(), jy, rtol=0, atol=ulp)
    got = torch.autograd.grad(y, params, torch.from_numpy(g).bfloat16())
    for name, gt, wt in zip(("dW", "db"), got, want):
        assert gt.dtype == torch.bfloat16, name
        _close(gt.float().numpy(), np.asarray(wt.astype(jnp.float32)), rtol=1e-2, err_msg=name)


def _first_match_grads(x, wgt, b, g):
    """dW, db in float64 numpy with the first maximal candidate selected in
    the order phase-major ((0,0), (0,1), (1,0), (1,1)), lower half first."""
    bsz, h, w = x.shape
    c = wgt.shape[1]
    xp = np.pad(x.astype(np.float64), ((0, 0), (2, 2), (2, 2)))
    conv = sum(
        xp[:, dh : dh + h, dw : dw + w, None] * wgt[dh * 5 + dw].astype(np.float64)
        for dh in range(5) for dw in range(5)
    ) + b.astype(np.float64)
    h2, w2 = h // 2, w // 2
    cands = np.stack([
        conv[:, a : 2 * h2 : 2, q : 2 * w2 : 2, half * (c // 2) : (half + 1) * (c // 2)]
        for a in (0, 1) for q in (0, 1) for half in (0, 1)
    ])  # [8, B, h2, w2, C/2]
    sel = np.argmax(cands, axis=0)  # first maximum
    dw_out, db_out = np.zeros((25, c)), np.zeros(c)
    for idx in range(8):
        ph, half = idx >> 1, idx & 1
        a, q = ph >> 1, ph & 1
        d = np.where(sel == idx, g, 0.0)  # [B, h2, w2, C/2]
        cols = slice(half * (c // 2), (half + 1) * (c // 2))
        db_out[cols] += d.sum(axis=(0, 1, 2))
        for dh in range(5):
            for dwi in range(5):
                patch = xp[:, a + dh : a + dh + 2 * h2 : 2, q + dwi : q + dwi + 2 * w2 : 2]
                dw_out[dh * 5 + dwi, cols] += np.einsum("bhw,bhwc->c", patch, d)
    return dw_out, db_out


def test_ties_go_to_the_first_candidate_like_the_jax_kernel():
    """A silent frame makes every candidate of a window equal to a bias; a
    frame of duplicated rows and equal halves ties across phases and halves.
    The JAX kernel's code, the float64 first-match reference and the port
    give the gradient to the same single candidate; ``jnp.maximum`` /
    ``jnp.max`` in the JAX package's unfused reference split it."""
    h, w, c = 12, 16, 6
    rng = np.random.RandomState(4)
    x = np.zeros((3, h, w), np.float32)  # frame 0: silence
    x[1] = np.repeat(rng.randn(h // 2, w), 2, axis=0)  # frame 1: duplicated rows
    x[2] = rng.randn(h, w)  # frame 2: no ties
    wgt = (rng.randn(25, c) * 0.1).astype(np.float32)
    wgt[:, c // 2 :] = wgt[:, : c // 2]  # halves tie everywhere
    b = (rng.randn(c) * 0.1).astype(np.float32)
    b[c // 2 :] = b[: c // 2]
    b[0] = b[c // 2] = 0.0
    g = rng.randn(3, h // 2, w // 2, c // 2).astype(np.float32)
    arrays = (x, wgt, b)

    want_dw, want_db = _first_match_grads(x, wgt, b, g)
    kernel = _jax_grads(jfc.fused_conv_mfm_pool, arrays, g)
    tx, *params = _t(arrays)
    got = torch.autograd.grad(tfc.fused_conv_mfm_pool(tx, *params), params, torch.from_numpy(g))
    np.testing.assert_allclose(got[0].numpy(), want_dw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want_db, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(kernel[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(kernel[1]), rtol=1e-5, atol=1e-5)
    # the upper halves tie with the lower ones everywhere and never win
    assert np.all(got[1].numpy()[c // 2 :] == 0.0) and np.all(got[0].numpy()[:, c // 2 :] == 0.0)
    split = _jax_grads(jfc.reference_conv_mfm_pool, arrays, g)
    assert np.abs(np.asarray(split[1])[c // 2 :]).max() > 0.1  # the reference splits ties


def test_input_requiring_grad_raises():
    x, *params = _t(_inputs(9, 12, 4))
    with pytest.raises(ValueError, match="no gradient for x"):
        tfc.fused_conv_mfm_pool(x.requires_grad_(), *params)


def test_cpu_tensors_never_launch():
    x, *params = _t(_inputs(9, 12, 4))
    tfc.fused_conv_mfm_pool(x, *params).sum().backward()
    assert fused_conv1_cuda.MFM_FWD_LAUNCHES == fused_conv1_cuda.MFM_BWD_LAUNCHES == 0
    with pytest.raises(ValueError, match="need a CUDA tensor"):
        fused_conv1_cuda.mfm_forward(x, params[0].detach(), params[1].detach(), False)


@pytest.mark.parametrize(
    "b,h,w,c,blocks,threads",
    [(128, 101, 256, 64, 128 * 10, 256), (128, 95, 256, 64, 128 * 12, 256),
     (8, 101, 20, 64, 8 * 2, 256), (3, 7, 5, 12, 3, 252), (2, 40, 700, 64, 2 * 5 * 3, 256),
     (1, 22051, 256, 64, 2205, 256), (2, 9, 12, 256, 2, 256)],
)
def test_launch_plan_covers_the_output(b, h, w, c, blocks, threads):
    """The tiling the CUDA kernels are given (computed on the host)."""
    plan = fused_conv1_cuda.mfm_launch_plan(b, h, w, c)
    assert (plan.h2, plan.w2) == (h // 2, w // 2)
    assert plan.blocks == blocks and plan.threads == threads
    assert plan.threads % (c // 2) == 0 and plan.threads <= fused_conv1_cuda.MAX_THREADS
    assert -(-plan.w2 // plan.wt) * plan.wt >= plan.w2
    assert plan.wt <= fused_conv1_cuda.MAX_TILE_COLS
    assert plan.stride >= 2 * plan.wt + 4 and plan.stride % 32 not in (0, 1, 31)
    # the backward opts in to more than 48 KB for two stages of whole rows
    assert max(plan.fwd_smem, plan.bwd_smem) <= 64 * 1024
    # the forward has a window for every thread where the image allows it
    assert plan.rows * plan.wt >= min(plan.threads, plan.h2 * plan.wt)
    # the backward's chunks tile a block's columns; two stages fit the ring
    assert 1 <= plan.chunk_cols <= plan.wt
    assert plan.chunk_cols % 8 == 0 or plan.chunk_cols == plan.wt
    stage = fused_conv1_cuda.mfm_stage_bytes(c, plan.chunk_cols)
    assert 2 * stage <= fused_conv1_cuda.MFM_RING_BYTES
    assert plan.bwd_smem >= 4 * (2 * plan.rows + 4) * plan.stride + 2 * stage


def test_staged_rows_read_distinct_banks():
    """Staged rows of the backward's ring are an odd number of units apart:
    the lanes of a warp reading the same 16 bytes of g from consecutive rows
    hit distinct banks in each quarter warp, and the same word of codes
    distinct banks in the whole warp."""
    for cols in range(1, 170):
        g = fused_conv1_cuda._pitch(4 * cols, 16)
        assert g >= 4 * cols and len({(r * g // 16) % 8 for r in range(8)}) == 8
        code = fused_conv1_cuda._pitch(cols, 4)
        assert code >= cols and len({(r * code // 4) % 32 for r in range(32)}) == 32


def test_plain_version_returns_nchw_memory():
    """Both dtypes: the plain version's ``[B, h2, w2, C/2]`` output is a view
    of NCHW memory (what the kernel stores), with the JAX kernel's values."""
    arrays = _inputs(21, 30, 6, seed=5)
    want = np.asarray(jfc.fused_conv_mfm_pool(*map(jnp.asarray, arrays)))
    for dtype in (torch.float32, torch.bfloat16):
        got = tfc.plain_conv_mfm_pool(*_t(arrays, dtype=dtype, grad=False))
        assert got.dtype == dtype and got.shape == (2, 10, 15, 3)
        assert got.permute(0, 3, 1, 2).is_contiguous() and not got.is_contiguous()
        atol = FWD_ATOL if dtype == torch.float32 else float(np.abs(want).max()) * 2.0**-7
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def _transposing_copies(fn, numel):
    """Copies of ``numel`` elements into new memory (``contiguous``,
    ``clone``, ``to``) that one call of ``fn`` makes, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    n = 0
    for e in prof.events():
        if e.name != "aten::copy_" or not e.input_shapes or not e.input_shapes[0]:
            continue
        parent = e.cpu_parent
        if int(np.prod(e.input_shapes[0])) == numel and parent is not None and (
                parent.name in ("aten::clone", "aten::_to_copy")):
            n += 1
    return n


def test_fused_lcnn_equals_unfused_on_the_cpu_without_a_copy():
    """``LCNN(fused_layer1="always")`` on the CPU (the plain version behind
    the wrapper) equals the unfused LCNN, in eval and through a train step,
    and makes no copy of the block's output or of its cotangent: the block
    stores NCHW, so nothing chooses a layout behind it."""
    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN

    torch.manual_seed(0)
    plain = LCNN(lstm_channels=32, dropout=0.0)
    fused = LCNN(lstm_channels=32, dropout=0.0, fused_layer1="always")
    fused.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 1, 32, 20).astype(np.float32))
    y = torch.tensor([0, 1])
    with torch.no_grad():
        torch.testing.assert_close(fused.eval()(x), plain.eval()(x), rtol=0, atol=1e-5)
    grads = []
    for model in (plain, fused):
        model.train()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for (name, _), gp, gf in zip(plain.named_parameters(), *grads):
        torch.testing.assert_close(gf, gp, rtol=1e-4, atol=1e-5, msg=name)
    block_numel = 2 * 32 * 10 * 16  # [B, 32, T/2, F/2]

    def step():
        torch.nn.functional.cross_entropy(fused(x), y).backward()

    assert _transposing_copies(step, block_numel) == 0


def test_launch_plan_refuses_with_the_numbers():
    with pytest.raises(ValueError, match="C=300 output channels must be even and at most 256"):
        fused_conv1_cuda.mfm_launch_plan(2, 101, 256, 300)
    with pytest.raises(ValueError, match="C=7 output channels must be even"):
        fused_conv1_cuda.mfm_launch_plan(2, 101, 256, 7)
    with pytest.raises(ValueError, match="H=1, W=256"):
        fused_conv1_cuda.mfm_launch_plan(2, 1, 256, 64)
