"""Port wavelet packets vs the JAX reference (CPU).

The port's plain PyTorch cascade is held against the JAX XLA cascade and
against the JAX Pallas kernel in interpret mode; the port's CUDA wrapper
must take that plain version for CPU tensors without counting a launch.
Inputs are made with numpy from a seed and fed to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu.ops import wavelets as jax_wavelets
from audiodeepfake_detection_tpu.ops.wpt import packet_image as jax_packet_image
from audiodeepfake_detection_tpu.ops.wpt import wpt_analysis as jax_wpt_analysis
from audiodeepfake_detection_tpu.ops.wpt_pallas import wpt_packets_pallas
from audiodeepfake_detection_tpu_torch.ops import wpt_cuda
from audiodeepfake_detection_tpu_torch.ops.wavelets import get_wavelet
from audiodeepfake_detection_tpu_torch.ops.wpt import (
    dec_kernel,
    graycode_permutation,
    packet_image,
    reflect_indices,
    wpt_analysis,
    wpt_output_length,
)

# plain cascade vs the XLA cascade: both fp32 FIR sums of the same taps;
# the same bound the JAX package holds its Pallas kernel to
WPT_ATOL = 5e-6
# log(|x|**2 + 1e-12) amplifies fp32 roundoff near zero (as in
# tests/test_wpt_pallas.py)
LOG_RTOL, LOG_ATOL = 1e-3, 5e-3


def _audio(b, t, seed=0):
    return np.random.RandomState(seed).randn(b, t).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_tf32():
    # TF32 does not exist on the CPU; set the switch anyway so the parity
    # contract (full fp32 convolutions) is stated where it is relied on
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("name", ["haar", "db4", "sym5", "coif4"])
def test_filters_equal_jax(name):
    ours, ref = get_wavelet(name), jax_wavelets.get_wavelet(name)
    for attr in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr))


@pytest.mark.parametrize(
    "wavelet,level,t",
    [
        ("haar", 3, 1024),
        ("sym5", 4, 1024),
        ("db4", 5, 2048),
        ("haar", 8, 4096),
        ("coif4", 4, 2048),
        # padl = 22 >= n = 16: the pad reflects back and forth
        ("coif4", 2, 16),
    ],
)
def test_wpt_analysis_matches_jax(wavelet, level, t):
    x = _audio(4, t)
    want = np.asarray(jax_wpt_analysis(jnp.asarray(x), wavelet, level))
    got = wpt_analysis(torch.from_numpy(x), wavelet, level).numpy()
    assert got.shape == want.shape
    assert got.shape[-1] == wpt_output_length(t, get_wavelet(wavelet).dec_len, level)
    np.testing.assert_allclose(got, want, atol=WPT_ATOL)


def test_reflect_indices_repeat_like_numpy_pad():
    # numpy's reflect pad is the whole-point reflection the kernel uses,
    # including pads longer than the signal
    n, padl, padr = 5, 12, 13
    sig = np.arange(n)
    np.testing.assert_array_equal(
        reflect_indices(n, padl, padr), np.pad(sig, (padl, padr), mode="reflect")
    )


def test_plain_matches_pallas_interpret_main_geometry():
    """The main path's geometry: sym5, level 8, one second at 22050 Hz.

    Measured Pallas-vs-XLA gap is 5.7e-6 at a peak of 16.5, hence 1e-5.
    """
    x = _audio(2, 22050, seed=5)
    want = np.asarray(wpt_packets_pallas(jnp.asarray(x), "sym5", 8, b_tile=2))
    got = wpt_analysis(torch.from_numpy(x), "sym5", 8).numpy()
    assert got.shape == want.shape == (2, 256, 95)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "kw",
    [
        dict(log_scale=False),
        dict(log_scale=True),
        dict(log_scale=True, loss_less=True),
        dict(log_scale=True, block_norm=True),
        dict(log_scale=False, block_norm=True, loss_less=True),
    ],
    ids=["raw", "log", "log-sign", "log-blocknorm", "raw-blocknorm"],
)
def test_packet_image_matches_jax(kw):
    x = _audio(3, 2048, seed=1)
    want = np.asarray(
        jax_packet_image(jnp.asarray(x), "sym5", 5, use_pallas=False, **kw)
    )
    got = packet_image(torch.from_numpy(x), "sym5", 5, **kw).numpy()
    assert got.shape == want.shape
    if kw.get("log_scale"):
        np.testing.assert_allclose(got, want, rtol=LOG_RTOL, atol=LOG_ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=WPT_ATOL)


def test_packet_image_kernel_flag_same_on_cpu():
    x = torch.from_numpy(_audio(2, 4096, seed=2)[:, None, :])
    a = packet_image(x, "db4", 6, log_scale=True, use_kernel=True)
    b = packet_image(x, "db4", 6, log_scale=True, use_kernel=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu_without_launch():
    before = wpt_cuda.LAUNCHES
    x = torch.from_numpy(_audio(2, 2048, seed=3))
    got = wpt_cuda.wpt_packets_cuda(x, "sym5", 4, log_scale=True)
    want = torch.log(torch.abs(wpt_analysis(x, "sym5", 4)) ** 2 + 1e-12)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert wpt_cuda.LAUNCHES == before == 0


def test_graycode_permutation():
    np.testing.assert_array_equal(graycode_permutation(3), [0, 1, 3, 2, 6, 7, 5, 4])


# the H100's SMs and the shared memory one block may opt into
H100 = (132, 232448)


@pytest.mark.parametrize(
    "batch,split,top,threads,smem_bytes",
    [(1, 4, "path", 1024, 132712), (8, 4, "path", 1024, 132712),
     (64, 1, "frame", 1024, 139720), (128, 0, "frame", 1024, 217248),
     (133, 1, "frame", 512, 139720)],
)
def test_plan_one_second(batch, split, top, threads, smem_bytes):
    """1 s of sym5 level 8: the split depth, the top route, threads and
    bytes that the plan picks for the serving and training batches.  A
    small batch splits deeper so that its CTAs reach more SMs; B >= 64
    keeps one CTA per frame node at depth <= 1, the CTA reading its frame."""
    plan = wpt_cuda.wpt_plan(batch, 22050, 10, 8, *H100)
    assert (plan.split, plan.top, plan.threads, plan.smem_bytes) == (
        split, top, threads, smem_bytes)
    assert plan.in_level == 0  # no level through device memory


def _plan_reads_fit(lengths, filt_len, plan):
    """Every level the CTA holds fits its buffer as padded rows (the
    samples, padl + padl + 1 reflected ones, the windows' overrun)."""
    r = wpt_cuda.outputs_per_window(filt_len)
    level = len(lengths) - 1
    total = plan.smem_bytes // 4
    for t, lvl in enumerate(range(plan.in_level + 1, level + 1)):
        rows = 1 if lvl <= plan.split else 2 ** (lvl - plan.split)
        stride = wpt_cuda._row_stride(lengths[lvl], filt_len)
        assert stride % 4 == 0 and stride >= lengths[lvl] + 2 * filt_len - 3
        room = plan.buf_b_off if t % 2 == 0 else total - plan.buf_b_off
        assert rows * stride + 2 * r + 8 <= room, (lvl, rows, stride, room)
    # the first level's stage (buffer B) takes at least 32 windows a chunk
    assert total - plan.buf_b_off >= 64 * r + filt_len + 4 * r + 8


@pytest.mark.parametrize(
    "t,filt_len,level",
    [(44100, 10, 8), (44100, 24, 8), (44100, 2, 8), (44100, 16, 8),
     (32000, 10, 8), (8 * 2**14, 2, 14)],
    ids=["2s-sym5", "2s-coif4", "2s-haar", "2s-db8", "32kHz-sym5", "L14-haar"],
)
@pytest.mark.parametrize("batch", [1, 64])
def test_plan_long_frames_stay_on_chip(t, filt_len, level, batch):
    """Frames longer than one CTA's shared memory split into subtrees that
    fit: at most the top levels cross device memory, never the last two;
    2 s at B = 64 (phase 20's DCNN batch) none at all."""
    plan = wpt_cuda.wpt_plan(batch, t, filt_len, level, *H100)
    assert plan.smem_bytes <= H100[1]
    assert plan.in_level < level - 1
    if (t, batch, filt_len) == (44100, 64, 10):
        assert (plan.split, plan.in_level) == (1, 0)
    _plan_reads_fit(wpt_cuda.level_lengths(t, filt_len, level), filt_len, plan)


@pytest.mark.parametrize("wavelet", ["haar", "db4", "sym5", "db8", "coif4", "db2"])
@pytest.mark.parametrize("t", [16, 301, 4096, 22050, 44100, 131072])
def test_no_plan_exceeds_the_opt_in_limit(wavelet, t):
    """Every candidate the plan considers and the one it picks, at every
    split depth and top route: within 227 KB, buffers large enough."""
    filt_len = get_wavelet(wavelet).dec_len
    level = 8 if t > 300 else 3
    lengths = wpt_cuda.level_lengths(t, filt_len, level)
    for batch in (1, 3, 64, 128, 133):
        plan = wpt_cuda.wpt_plan(batch, t, filt_len, level, *H100)
        assert plan.smem_bytes <= H100[1] and 32 <= plan.threads <= 1024
        _plan_reads_fit(lengths, filt_len, plan)
    for k in range(level):
        for top in ("frame", "levels", "levels-all"):
            plan = wpt_cuda.make_plan(lengths, filt_len, k, top, 1, H100[0], H100[1])
            _plan_reads_fit(lengths, filt_len, plan)


def test_plan_coif4_pads_longer_than_the_node():
    """coif4 from 16 samples: padl = 22 exceeds every node (16 .. 22
    samples), so the reflected pads fold back and forth; the padded rows
    still hold every sample a window reads."""
    lengths = wpt_cuda.level_lengths(16, 24, 4)
    assert max(lengths) <= 22
    for k in range(4):
        for top in ("frame", "path", "levels", "levels-all"):
            _plan_reads_fit(lengths, 24, wpt_cuda.make_plan(lengths, 24, k, top))
    plan = wpt_cuda.wpt_plan(2, 16, 24, 4, *H100)
    _plan_reads_fit(lengths, 24, plan)


def _freq_row(node):
    # inverse Gray code: the frequency-ordered row of a natural node
    for shift in (1, 2, 4, 8, 16):
        node ^= node >> shift
    return node


@pytest.mark.parametrize("t", [1000, 1001], ids=["even", "odd"])
@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("wavelet", ["haar", "sym5", "coif4"])
def test_subtrees_from_their_roots_equal_the_full_transform(wavelet, split, t):
    """What the kernel's CTAs compute: node c at level k alone gives its
    2**(L-k) descendants at level L, which are the frequency rows f0 ..
    f0 + 2**(L-k) - 1 of the full transform (f0 = the Gray row of c's
    first descendant, rounded down), row f holding natural node
    f ^ (f >> 1).  The plain cascade from each node against the plain
    cascade from the frame: expected 0.0 (the same sums), tolerance 1e-6."""
    level = 5
    m = level - split
    x = torch.from_numpy(_audio(2, t, seed=split))
    full = wpt_analysis(x, wavelet, level)
    nodes = wpt_analysis(x, wavelet, split, natural_order=True)
    worst = 0.0
    for c in range(2**split):
        sub = wpt_analysis(nodes[:, c], wavelet, m, natural_order=True)
        f0 = _freq_row(c << m) & ~(2**m - 1)
        for q in range(2**m):
            f = f0 + q
            natural = f ^ (f >> 1)
            assert natural >> m == c
            err = (sub[:, natural & (2**m - 1)] - full[:, f]).abs().max().item()
            worst = max(worst, err)
    assert worst <= 1e-6


def _reflect(i, n):
    if n == 1:
        return 0
    while i < 0 or i >= n:
        i = -i if i < 0 else 2 * (n - 1) - i
    return i


def _run_schedule(x, taps, level, plan):
    """The subtree kernel's schedule (csrc/wpt_cascade.cu) in float64 numpy:
    the top levels through memory, then per CTA the first level staged in
    chunks through buffer B, padded rows in two buffers of exactly
    ``plan.smem_bytes``, the last level's rows copied out in frequency
    order.  Shared memory starts as NaN and every read is bounds-checked,
    so a buffer too small or a pad not filled shows up as an error."""
    filt_len = taps.shape[1]
    r = wpt_cuda.outputs_per_window(filt_len)
    padl = filt_len - 2
    w4 = 4 * ((2 * r + filt_len - 2 + 3) // 4)
    lengths = wpt_cuda.level_lengths(x.shape[1], filt_len, level)
    k, j = plan.split, plan.in_level

    def outputs(win, c):  # r outputs of child c from a window of samples
        return np.array([win[2 * q: 2 * q + filt_len] @ taps[c] for q in range(r)])

    def read(mem, lo, hi, limit):
        assert 0 <= lo and hi <= limit, (lo, hi, limit)
        return mem[lo:hi]

    src = x[:, None, :]
    for lvl in range(1, j + 1):
        n_in, n = lengths[lvl - 1], lengths[lvl]
        idx = np.array([[_reflect(2 * s - padl + i, n_in) for i in range(filt_len)]
                        for s in range(n)])
        win = src[:, :, idx]  # [B, rows, n, F]
        src = np.stack([win @ taps[0], win @ taps[1]], axis=2).reshape(x.shape[0], -1, n)
    out = np.full((x.shape[0], 2**level, lengths[level]), np.nan)
    total = plan.smem_bytes // 4
    for cta in range(x.shape[0] << k):
        c, frame = cta & (2**k - 1), cta >> k
        smem = np.full(total, np.nan)
        bufs = (0, plan.buf_b_off)
        limits = (plan.buf_b_off, total)
        row = src[frame, c >> (k - j)]
        n = lengths[j + 1]
        stride = wpt_cuda._row_stride(n, filt_len)
        kids = (0, 1) if j == k else ((c >> (k - j - 1)) & 1,)
        stage = total - plan.buf_b_off
        chunk = ((stage - filt_len - 4 * r - 8) // (2 * r)) * r
        for c0 in range(0, n, chunk):
            nblk = -(-min(chunk, n - c0) // r)
            span = 2 * r * nblk + filt_len + 2 * r
            assert span <= stage
            smem[bufs[1]: bufs[1] + span] = [
                row[_reflect(2 * c0 - padl + i, lengths[j])] for i in range(span)]
            for blk in range(nblk):
                lo = bufs[1] + 2 * r * blk
                win = read(smem, lo, lo + w4, total)
                for slot, kid in enumerate(kids):
                    s0 = c0 + r * blk
                    keep = min(r, n - s0)
                    d = slot * stride + padl + s0
                    assert d + keep <= limits[0]
                    smem[d: d + keep] = outputs(win, kid)[:keep]
        at, t = 0, 0
        for lvl in range(j + 2, level + 1):
            rows_in = 1 if lvl - 1 <= k else 2 ** (lvl - 1 - k)
            for q in range(rows_in):  # the reflected pads
                base = bufs[at] + q * stride + padl
                for e in range(2 * padl + 1):
                    i = e - padl if e < padl else n + e - padl
                    smem[base + i] = smem[base + _reflect(i, n)]
            t += 1
            n_out = lengths[lvl]
            dst_stride = wpt_cuda._row_stride(n_out, filt_len)
            dst = t & 1
            for p in range(rows_in):
                kid_list = ((0, 1) if lvl > k else ((c >> (k - lvl)) & 1,))
                for blk in range(-(-n_out // r)):
                    lo = bufs[at] + p * stride + 2 * r * blk
                    win = read(smem, lo, lo + w4, limits[at])
                    for slot, kid in enumerate(kid_list):
                        s0 = r * blk
                        keep = min(r, n_out - s0)
                        d = bufs[dst] + ((2 * p + slot) if lvl > k else 0) * dst_stride + padl + s0
                        assert d + keep <= limits[dst]
                        smem[d: d + keep] = outputs(win, kid)[:keep]
            at, n, stride = dst, n_out, dst_stride
        m = level - k
        f0 = _freq_row(c << m) & ~(2**m - 1)
        for q in range(2**m):
            f = f0 + q
            base = bufs[at] + ((f ^ (f >> 1)) & (2**m - 1)) * stride + padl
            out[frame, f] = smem[base: base + n]
    return out


@pytest.mark.parametrize(
    "wavelet,level,batch,t",
    [("haar", 4, 2, 64), ("sym5", 4, 1, 301), ("db2", 3, 1, 101), ("coif4", 2, 1, 16)],
)
def test_kernel_schedule_computes_the_transform(wavelet, level, batch, t):
    """The kernel's schedule and buffer layout, run in numpy under every
    split depth and top route (and with buffer B cut to the smallest stage,
    so the first level goes in chunks), equals the plain cascade: what the
    card runs is this schedule, so a layout fault shows here first."""
    x = _audio(batch, t, seed=t).astype(np.float64)
    taps = dec_kernel(wavelet, "cpu").reshape(2, -1).double().numpy()
    filt_len = taps.shape[1]
    want = wpt_analysis(torch.from_numpy(x), wavelet, level).numpy()
    lengths = wpt_cuda.level_lengths(t, filt_len, level)
    for k in range(level):
        for top in ("frame", "path", "levels", "levels-all"):
            plan = wpt_cuda.make_plan(lengths, filt_len, k, top, batch)
            off, smem = wpt_cuda.subtree_smem(lengths, filt_len, k, plan.in_level, 1)
            for p in (plan, dataclasses.replace(plan, buf_b_off=off, smem_bytes=smem)):
                got = _run_schedule(x, taps, level, p)
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("log_scale", [False, True], ids=["raw", "log"])
def test_two_second_frames_match_jax(log_scale):
    """2 s at 22050 Hz, sym5 level 8 (what the long-frame route computes on
    the card): the plain cascade and the packet image against the JAX
    package's XLA cascade."""
    x = _audio(2, 44100, seed=6)
    if not log_scale:
        want = np.asarray(jax_wpt_analysis(jnp.asarray(x), "sym5", 8))
        got = wpt_analysis(torch.from_numpy(x), "sym5", 8).numpy()
        assert got.shape == want.shape == (2, 256, wpt_output_length(44100, 10, 8))
        np.testing.assert_allclose(got, want, atol=WPT_ATOL)
        return
    want = np.asarray(
        jax_packet_image(jnp.asarray(x), "sym5", 8, log_scale=True, use_pallas=False)
    )
    got = packet_image(torch.from_numpy(x), "sym5", 8, log_scale=True).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LOG_RTOL, atol=LOG_ATOL)
