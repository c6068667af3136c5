"""Result aggregation and LaTeX table emission.

Copy of ``audiodeepfake_detection_tpu/train/results.py`` (numpy only).

Output parity target: reference ``print_results``
(src/audiofakedetect/train_classifier.py:1371-1446) — per-config LaTeX rows
``max acc / mean±std acc / min EER / mean±std EER``, saved results tensor of
shape (seeds, configs, 4), "Best unknown eer" and best-config selection —
plus the paper-table helper (src/audiofakedetect/utils.py:412-479).  The
emitted bytes are locked by golden tests (tests/test_results.py); the code
below is organized around two cell formatters rather than the reference's
inline string accumulation.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..utils.config import DotDict, Griderator

# result-tuple columns, as produced by Trainer.testing()
_KNOWN_ACC, _KNOWN_EER, _UNKNOWN_ACC, _UNKNOWN_EER = range(4)


def _fixed_cell(extreme: float, mu: float, sigma: float, scale: float, prec: int) -> str:
    """``$extreme$ & $mu \\pm sigma$`` with fixed decimal places."""
    return (
        rf"${extreme * scale:.{prec}f}$ & "
        rf"${mu * scale:.{prec}f} \pm {sigma * scale:.{prec}f}$"
    )


def _rounded_cell(extreme: float, mu: float, sigma: float, scale: float, prec: int) -> str:
    """Same cell but via ``round()`` (drops trailing zeros) — the paper-table
    style."""
    return (
        f"&${round(extreme * scale, prec)}$ & "
        rf"${round(mu * scale, prec)} \pm {round(sigma * scale, prec)}$ "
    )


def _config_of(griderator: Griderator, index: int) -> dict:
    return dict(zip(griderator.get_keys(), griderator.grid_values[index]))


def print_results(
    args: DotDict,
    exp_results: Dict,
    griderator: Optional[Griderator],
    model_file: str = "defaultmodel",
) -> Optional[dict]:
    """Aggregate per-seed results, emit LaTeX rows, pick the best config."""
    results = np.asarray(list(exp_results.values()), dtype=np.float64)
    if results.shape[0] == 0:
        return None
    if results.ndim == 2:
        results = results[:, None, :]  # single config -> (seeds, 1, 4)
    if results.shape[-1] < 4:
        # no testing ran (e.g. only_ig mode): nothing to tabulate
        print("(no test results to aggregate)")
        return None

    if args.transform == "packets":
        if griderator is not None and "wavelet" in griderator.init_config:
            wavelets = griderator.init_config["wavelet"]
        elif args.wavelet is not None:
            wavelets = [args.wavelet]
        else:
            wavelets = ["default"]
    else:
        wavelets = ["stft"]

    if args.log_dir:
        tag = ",".join(map(str, wavelets))
        np.save(
            f"{args.log_dir}/{model_file.split('/')[-1]}_{tag}_results.npy",
            results,
        )

    # reduce over the seed axis
    mean, std = results.mean(0), results.std(0)
    mins, maxs = results.min(0), results.max(0)
    print("results:", results)
    print(mean)
    print(std)

    print("evaluating results:")
    sep = "-" * 66
    rows = []
    for cfg in range(mean.shape[0]):
        print(sep)
        acc = _fixed_cell(
            maxs[cfg, _UNKNOWN_ACC], mean[cfg, _UNKNOWN_ACC],
            std[cfg, _UNKNOWN_ACC], scale=100, prec=2,
        )
        eer = _fixed_cell(
            mins[cfg, _UNKNOWN_EER], mean[cfg, _UNKNOWN_EER],
            std[cfg, _UNKNOWN_EER], scale=1, prec=3,
        )
        rows.append(rf"& {acc} & {eer} \\")
    rows_arr = np.asarray(rows, dtype=object)
    print(rows_arr)

    # wavelet x cross-source matrix view, when the grid spans exactly that
    if griderator is not None and "cross_sources" in griderator.init_config:
        cross_dirs = griderator.init_config["cross_sources"]
        if len(rows_arr) == len(wavelets) * len(cross_dirs):
            table = rows_arr.reshape((len(wavelets), len(cross_dirs)))
            for c, cross_dir in enumerate(cross_dirs):
                print("+---------------------+")
                print(cross_dir)
                for w, wavelet in enumerate(wavelets):
                    print(rf"{wavelet} & {table[w][c]}")
            print("+---------------------+")
    print(sep)

    best = int(np.argmin(mean[:, _UNKNOWN_EER]))
    print(
        f"Best unknown eer: {mean[best, _UNKNOWN_EER]:.4f} "
        f"+- {std[best, _UNKNOWN_EER]:.4f}"
    )
    if args.enable_gs and griderator is not None:
        best_config = _config_of(griderator, best)
        print(f"Best config: {best_config}")
        return best_config
    return None


# Fixed cross-source row order assumed by the reference's paper tables
# (utils.py:412-479): rows 0-5 and 9-11 are the WaveFake generators,
# 6-7 the two BigVGAN variants, 8 is Avocodo.
_WAVEFAKE_ROWS = (0, 1, 2, 3, 4, 5, 9, 10, 11)
_BIGVGAN_ROWS = (6, 7)
_AVOCODO_ROW = 8


def print_paper_tables(res_eer: np.ndarray, res_acc: np.ndarray) -> dict:
    """WaveFake / avocodo / bigvgan aggregate rows (reference utils.py:412-479).

    ``res_eer``/``res_acc`` are (num_cross_dirs, seeds) arrays in the
    reference's fixed cross-source order.  Accuracy cells report the best
    per-seed mean; EER cells the best per-seed mean EER (for grouped rows)
    or best raw EER (single-generator rows), exactly as the reference does.
    """

    def acc_cell(per_seed: np.ndarray) -> str:
        return (
            _rounded_cell(per_seed.max(), per_seed.mean(), per_seed.std(), 100, 2)
            .rstrip()
            + " &"
        )

    def eer_cell(best: float, mu: float, sigma: float) -> str:
        return f"${round(best, 3)}$ & " + rf"${round(mu, 3)} \pm {round(sigma, 3)}$ "

    wf_acc = res_acc[list(_WAVEFAKE_ROWS)].mean(0)
    wf_eer = res_eer[list(_WAVEFAKE_ROWS)]
    out = {
        "all": (
            acc_cell(res_acc.mean(0))
            + eer_cell(res_eer.mean(0).min(), res_eer.mean(), res_eer.mean(0).std())
        ),
        "wavefake": (
            acc_cell(wf_acc)
            + eer_cell(wf_eer.mean(0).min(), wf_eer.mean(), wf_eer.mean(0).std())
        ),
    }
    av_acc, av_eer = res_acc[_AVOCODO_ROW], res_eer[_AVOCODO_ROW]
    bv_acc = res_acc[list(_BIGVGAN_ROWS)].mean(0)
    bv_eer = res_eer[list(_BIGVGAN_ROWS)].mean(0)
    out["avbigvgan"] = (
        acc_cell(av_acc)
        + eer_cell(av_eer.min(), av_eer.mean(), av_eer.std())
        # second column group joins with a bare "& " and no leading "&"
        + "& "
        + acc_cell(bv_acc)[1:]
        + eer_cell(bv_eer.min(), bv_eer.mean(), bv_eer.std())
    )
    for key in ("all", "wavefake", "avbigvgan"):
        print(key)
        print(out[key])
    return out
