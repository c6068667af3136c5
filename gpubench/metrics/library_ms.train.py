"""``library_ms.train``: device ms a training step in cuDNN's and cuBLAS's
kernels: the groups ``kernel_groups.json`` names as the library's for the
configuration's group table."""

from gpubench import cells


def read(view):
    table = cells.data("kernel_groups")[view.cell["kernel_groups"]]
    groups = view.groups_ms(table["groups"])
    return sum(groups.get(g, 0.0) for g in table["library"]) / view.counts["steps"]
