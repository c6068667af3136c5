"""The wavelet-packet CUDA kernel on the card (marked ``cuda``).

These tests import neither JAX nor the JAX package, so they run on a GPU
machine without JAX, from the repository root:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from audiodeepfake_detection_tpu_torch.ops import wpt_cuda
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
