"""Kernel 1, the wavelet-packet cascade (``csrc/wpt_cascade.cu``): its
least work per launch, copied from ``chip_smoke.py``'s ``wpt_bound``.

The frame is read once and the last level written once; every level's
outputs cost 2 flops a tap (either route: the long-frame route's round
trips through device memory are its own cost, not the function's).
"""

#: kernel name -> the program counter of its launches
KERNELS = {"wpt_subtree_kernel": "wpt_cuda.LAUNCHES",
           "wpt_level_kernel": "wpt_cuda.LEVEL_LAUNCHES"}
TAPS = {"sym5": 10}


def lengths(t: int, taps: int, level: int):
    out = [t]
    for _ in range(level):
        out.append((out[-1] + taps - 1) // 2)
    return out


def flops_bytes(batch: int, t: int, taps: int, level: int):
    """One whole transform of ``batch`` frames of ``t`` samples."""
    n = lengths(t, taps, level)
    flops = sum((2 << lvl) * n[lvl + 1] * 2 * taps for lvl in range(level))
    return batch * flops, 4 * batch * (t + (2 ** level) * n[-1])


def work(cfg: dict, batch: int) -> dict:
    tf = cfg["transform"]
    level = int(tf["num_of_scales"]).bit_length() - 1
    # a call is one subtree launch; the top-level kernel's launches are
    # part of the same transform and add no least work of their own
    return {"wpt_cuda.LAUNCHES": flops_bytes(batch, cfg["frame_samples"], TAPS[tf["wavelet"]],
                                             level),
            "wpt_cuda.LEVEL_LAUNCHES": (0, 0)}
