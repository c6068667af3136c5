"""Kernel 4, fused multi-head attention on the packed ``[B, N, 3HD]``
projection (``csrc/flash_mha.cu``): its least work per launch, copied from
``chip_smoke.py``'s ``mha_bounds``.

Forward: qkv read, out and the row statistics written; q.k^T and p.v,
2 N^2 D flops each per head.  Backward: qkv, dout and the statistics read,
dqkv written; five such products (q.k^T, dO.v^T, p^T.dO, dS.k, dS^T.q).
"""

KERNELS = {"flash_mha_stream_fwd_kernel": "flash_attention_cuda.MHA_FWD_LAUNCHES",
           "flash_mha_stream_dq_kernel": "flash_attention_cuda.MHA_BWD_LAUNCHES",
           "flash_mha_stream_dkv_kernel": "flash_attention_cuda.MHA_BWD_LAUNCHES"}


def flops_bytes(b: int, n: int, heads: int, head_dim: int = 64, itemsize: int = 4):
    product = 2 * n * n * head_dim * heads * b
    qkv = itemsize * b * n * 3 * heads * head_dim
    out = itemsize * b * n * heads * head_dim
    stats = 4 * b * heads * n * 2
    return {"fwd": (2 * product, qkv + out + stats), "bwd": (5 * product, 2 * qkv + out + stats)}


def tokens(cfg: dict) -> int:
    m, w = cfg["model"], cfg["widths"]
    f = (m["input_fdim"] - w["patch"]) // m["fstride"] + 1
    t = (m["input_tdim"] - w["patch"]) // m["tstride"] + 1
    return f * t + 2


def work(cfg: dict, batch: int) -> dict:
    w = cfg["widths"]
    fb = flops_bytes(batch, tokens(cfg), w["num_heads"], w["head_dim"])
    return {"flash_attention_cuda.MHA_FWD_LAUNCHES": fb["fwd"],
            "flash_attention_cuda.MHA_BWD_LAUNCHES": fb["bwd"]}
