"""The program's model for ``ast-base384-stft``: the port's ``ASTModel``
with the configuration's ``model`` arguments (kernel 4 for attention)."""

from audiodeepfake_detection_tpu_torch.models.ast import ASTModel


def build(cfg: dict):
    return ASTModel(**cfg["model"])
