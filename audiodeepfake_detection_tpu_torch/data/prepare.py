"""Dataset preparation: index prebuilds and protocol-file splitters.

Copy of ``audiodeepfake_detection_tpu/data/prepare.py`` on the port's
``data/dataset.py``: the index files it writes are the JAX package's.

Parity targets:

* ``prepare_ljspeech``  — reference scripts/prepare_ljspeech.py: builds the
  train/val/test indexes for LJSpeech-vs-generator pairs plus the
  cross-generator val/test indexes with ``only_test_folders``.
* ``prepare_asvspoof``  — reference scripts/prepare_asvspoof.py: ASVspoof
  2019-LA (LA_T/D/E prefixes) and 2021-DF (DF_E), flac @16 kHz, 2 s frames,
  custom train/val ratios.
* ``prepare_inthewild`` — reference scripts/prepare_inthewild.py: 4 s @
  16 kHz.
* ``split_asvspoof`` / ``split_inthewild`` — reference
  scripts/split_*.py: move files into ``<X>_real`` / ``<Y>_fake`` dirs based
  on the protocol/metadata files.

Run e.g. ``python -m audiodeepfake_detection_tpu_torch.data.prepare ljspeech
--data-path ./data/fake --save-path ./data/run1``.
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
from typing import Sequence

from .dataset import get_custom_dataset

CROSS_SOURCES_DEFAULT = [
    "ljspeech",
    "melgan",
    "lmelgan",
    "mbmelgan",
    "pwg",
    "waveglow",
    "hifigan",
    "conformer",
    "jsutmbmelgan",
    "jsutpwg",
]


def prepare_ljspeech(
    data_path: str,
    save_path: str,
    gans: Sequence[str] = ("fbmelgan",),
    limit_train=(55504, 7504, 15504),
    cross_limit=(55500, 7304, 14600),
    only_test_folders=("conformer", "jsutmbmelgan", "jsutpwg"),
    cross_sources: Sequence[str] = tuple(CROSS_SOURCES_DEFAULT),
    seconds: float = 1,
    resample_rate: int = 22050,
) -> None:
    for gan in gans:
        only_use = ["ljspeech", gan]
        for ds_type, limit in zip(("train", "val", "test"), limit_train):
            get_custom_dataset(
                data_path=data_path,
                ds_type=ds_type,
                only_use=only_use,
                save_path=save_path,
                limit=limit,
                seconds=seconds,
                resample_rate=resample_rate,
            )
    for ds_type, limit in zip(("val", "test"), cross_limit[1:]):
        get_custom_dataset(
            data_path=data_path,
            ds_type=ds_type,
            only_test_folders=list(only_test_folders),
            only_use=list(cross_sources),
            save_path=save_path,
            limit=limit,
            seconds=seconds,
            resample_rate=resample_rate,
        )


def prepare_asvspoof(
    data_path: str,
    save_path: str,
    seconds: float = 2,
    resample_rate: int = 16000,
) -> None:
    # ASVspoof 2019-LA: disjoint official train/dev/eval partitions selected
    # by filename prefix; ratios force each partition into one split.
    for ds_type, limit, prefix, ratios in (
        ("train", 7472, "LA_T", (1.0, 0.0)),
        ("val", 7672, "LA_D", (0.0, 1.0)),
        ("test", 21320, "LA_E", (0.0, 0.0)),
    ):
        get_custom_dataset(
            data_path=data_path,
            ds_type=ds_type,
            only_use=["asv2019real", "asv2019fake"],
            save_path=save_path,
            limit=limit,
            asvspoof_name=prefix,
            train_ratio=ratios[0],
            val_ratio=ratios[1],
            file_type="flac",
            resample_rate=resample_rate,
            seconds=seconds,
        )
    # ASVspoof 2021-DF eval set, standard 70/10/20
    for ds_type, limit in zip(("train", "val", "test"), (44368, 6336, 12672)):
        get_custom_dataset(
            data_path=data_path,
            ds_type=ds_type,
            only_use=["asv2021real", "asv2021fake"],
            save_path=save_path,
            limit=limit,
            asvspoof_name="DF_E",
            file_type="flac",
            resample_rate=resample_rate,
            seconds=seconds,
        )


def prepare_inthewild(
    data_path: str,
    save_path: str,
    seconds: float = 4,
    resample_rate: int = 16000,
    limit_train=(38968, 5568, 11136),
) -> None:
    for ds_type, limit in zip(("train", "val", "test"), limit_train):
        get_custom_dataset(
            data_path=data_path,
            ds_type=ds_type,
            only_use=["inthewildReal", "inthewildFake"],
            save_path=save_path,
            limit=limit,
            resample_rate=resample_rate,
            seconds=seconds,
        )


def split_asvspoof(
    protocol_file: str,
    audio_dir: str,
    out_real: str,
    out_fake: str,
    file_type: str = "flac",
    move: bool = True,
) -> None:
    """Split an ASVspoof corpus into real/fake dirs from its protocol file.

    Protocol lines look like ``SPK FILE - A07 spoof`` (2019) or the 2021 DF
    keys format; the 'bonafide'/'spoof' token decides the destination.
    """
    os.makedirs(out_real, exist_ok=True)
    os.makedirs(out_fake, exist_ok=True)
    with open(protocol_file) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 2:
                continue
            file_id = parts[1]
            is_real = "bonafide" in parts
            src = os.path.join(audio_dir, f"{file_id}.{file_type}")
            if not os.path.exists(src):
                continue
            dst = os.path.join(out_real if is_real else out_fake, f"{file_id}.{file_type}")
            (shutil.move if move else shutil.copy)(src, dst)


def split_inthewild(
    meta_csv: str,
    audio_dir: str,
    out_real: str,
    out_fake: str,
    move: bool = True,
) -> None:
    """Split the In-the-Wild corpus via its meta.csv (file,speaker,label)."""
    os.makedirs(out_real, exist_ok=True)
    os.makedirs(out_fake, exist_ok=True)
    with open(meta_csv, newline="") as fh:
        for row in csv.DictReader(fh):
            label = row.get("label", "").strip().lower()
            fname = row.get("file") or row.get("filename")
            if fname is None:
                raise ValueError(
                    f"{meta_csv}: no 'file'/'filename' column "
                    f"(columns: {sorted(row)})"
                )
            src = os.path.join(audio_dir, fname)
            if not os.path.exists(src):
                continue
            dst_dir = out_real if label in ("bona-fide", "bonafide", "real") else out_fake
            (shutil.move if move else shutil.copy)(src, os.path.join(dst_dir, fname))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Prepare dataset indexes")
    parser.add_argument("corpus", choices=["ljspeech", "asvspoof", "inthewild"])
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--save-path", required=True)
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--sample-rate", type=int, default=None)
    args = parser.parse_args(argv)
    kw = {}
    if args.seconds is not None:
        kw["seconds"] = args.seconds
    if args.sample_rate is not None:
        kw["resample_rate"] = args.sample_rate
    {
        "ljspeech": prepare_ljspeech,
        "asvspoof": prepare_asvspoof,
        "inthewild": prepare_inthewild,
    }[args.corpus](args.data_path, args.save_path, **kw)


if __name__ == "__main__":
    main()
