"""The model FLOPs of an ``ast-base384-stft`` training step, for ``mfu``.

Dense products at the published widths, 2 flops a multiply-add: the patch
embedding, every block's four Linears and its two attention products, the
head; the backward twice the forward except the patch embedding's input
gradient, which is not needed.  The STFT, the norms and the elementwise
layers are not counted, nor is recomputed work.
"""

from gpubench import cells


def model_flops(cfg: dict, batch: int) -> float:
    w = cfg["widths"]
    d, hid, depth = w["embed_dim"], w["mlp_hidden"], w["depth"]
    n = cells.work_module("flash_mha").tokens(cfg)
    patches = n - 2
    embed = 2 * w["patch"] ** 2 * d * patches
    block = 2 * n * d * (3 * d + d + 2 * hid) + 2 * 2 * n * n * d
    head = 2 * d * cfg["model"]["label_dim"]
    fwd = embed + depth * block + head
    return batch * (3 * fwd - embed)
