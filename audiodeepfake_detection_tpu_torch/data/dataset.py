"""Dataset index builder: directory scan, frame cutting, splits, caching.

Copy of ``audiodeepfake_detection_tpu/data/dataset.py`` (numpy only).

Behavioral parity with the reference's ``CustomDataset`` /
``get_costum_dataset`` (reference: src/audiofakedetect/data_loader.py:74-507):

* labels come from the directory-name prefix letter (``ord(c) - 65``) with
  the collision-bump rule (data_loader.py:459-467);
* every audio file is cut into ``seconds * file_sample_rate`` frames;
* 70/10/20 train/val/test split per directory, ``only_test_folders``
  routing with the previous-folder-size rule, per-label equalization to the
  shortest directory (data_loader.py:195-242);
* the index is cached as ``dataset_<names>_meta_<sec>sec_<type>.npy`` with
  the same object-array layout ``[dirs, n, (path, frame_idx, win_size,
  label)]`` so caches interoperate with the reference.

The per-file header scan uses the native reader (csrc/wavio.cpp) — the
reference's "this may take more than 45 minutes" pass
(data_loader.py:147-151) is a C++ header walk here.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

import numpy as np


class CustomDataset:
    """Frame-level dataset over labeled audio directories."""

    def __init__(
        self,
        paths: list,
        labels: list,
        save_path: str,
        only_test_folders: Optional[list] = None,
        abort_on_save: bool = False,
        ds_type: str = "train",
        seconds: float = 1,
        resample_rate: int = 16000,
        train_ratio: float = 0.7,
        val_ratio: float = 0.1,
        key: Optional[str] = "audio",
        limit: int = 555000,
        verbose: Optional[bool] = False,
        filetype: str = "wav",
        asvspoof_name: Optional[str] = None,
    ):
        if verbose:
            print("Loading ", ds_type, paths, flush=True)

        names = []
        self.label_names = {}
        for i in range(len(paths)):
            names.append(str(paths[i]).split("/")[-1].split("_")[-1])
            self.label_names[labels[i]] = names[-1]

        destination = f"{save_path}/dataset_{'-'.join(names)}_meta_{seconds}sec"
        cache_file = f"{destination}_{ds_type}.npy"
        if ds_type not in ("train", "val", "test"):
            raise RuntimeError("Dataset type does not exists.")

        if os.path.exists(cache_file):
            result_set = np.load(cache_file, allow_pickle=True)
        else:
            result_set = self._build_index(
                paths,
                labels,
                ds_type,
                seconds,
                train_ratio,
                val_ratio,
                limit,
                filetype,
                asvspoof_name,
                only_test_folders,
            )
            os.makedirs(save_path, exist_ok=True)
            # atomic publish: concurrent multi-host builds or a crash
            # mid-save must never leave a truncated cache that every later
            # run trusts (a reader never sees a half-written file)
            tmp_file = f"{cache_file}.tmp.{os.getpid()}"
            np.save(tmp_file, result_set, allow_pickle=True)
            os.replace(tmp_file + ".npy", cache_file)  # np.save appends .npy
            if abort_on_save:
                print("Aborting on dataset saving.")
                raise SystemExit(0)

        # limit per label, then flatten [dirs, n, 4] -> [dirs*n, 4].
        # limit=-1 means unlimited (matching _build_index's sentinel) — a
        # raw [:, :-1] slice would silently drop one frame per directory
        if limit is not None and limit >= 0:
            result_set = result_set[:, :limit]

        if ds_type == "train" and only_test_folders:
            raise ValueError(
                "Since there are folders in only_test_folders this cannot "
                "be a train dataset."
            )

        if result_set.size:
            win_sizes = result_set[:, :, 2].astype(np.int64)
            # round, not truncate: win = int(seconds*rate) makes
            # win/seconds fractionally below the true rate for float
            # seconds (e.g. 0.1 s @ 16 kHz -> 15999.999 -> int() = 15999)
            min_file_rate = round(float(win_sizes.min()) / seconds)
            if resample_rate > min_file_rate:
                raise RuntimeError(
                    "Sample rate is smaller than desired sample rate. "
                    "No upsampling possible here."
                )
            audio_data = result_set.reshape(-1, result_set.shape[-1])
        else:
            audio_data = np.zeros((0, 4), dtype=object)

        self.audio_data = audio_data  # (N, 4): path, frame_idx, win_size, label
        self.ds_type = ds_type
        self.key = key
        self.resample_rate = resample_rate
        self.seconds = seconds
        self.save_path = save_path

    @staticmethod
    def _build_index(
        paths,
        labels,
        ds_type,
        seconds,
        train_ratio,
        val_ratio,
        limit,
        filetype,
        asvspoof_name,
        only_test_folders,
    ) -> np.ndarray:
        train_data, val_data, test_data = [], [], []
        sample_count: List[List[int]] = []
        for path_num, path in enumerate(paths):
            name = str(path).split("/")[-1].split("_")[-1]
            pattern = (
                f"{asvspoof_name}*.{filetype}"
                if asvspoof_name is not None
                else f"*.{filetype}"
            )
            path_list = sorted(Path(path).glob(pattern))
            rows = []
            for file_name in path_list:
                from .wavio import audio_info

                sr, num_frames, _, _ = audio_info(str(file_name))
                win = int(seconds * sr)
                for i in range(num_frames // win):
                    rows.append((str(file_name), i, win, labels[path_num]))
            frames_array = np.asarray(rows, dtype=object).reshape(-1, 4)
            num_samples = frames_array.shape[0]

            if only_test_folders is None or name not in only_test_folders:
                num_train = int(train_ratio * num_samples)
                num_val = int(val_ratio * num_samples)
                num_test = num_samples - num_train - num_val
            else:
                num_train = 0
                if (
                    len(sample_count) != 0
                    and num_samples >= sample_count[-1][1] + sample_count[-1][2]
                ):
                    num_val = sample_count[-1][1]
                    num_test = sample_count[-1][2]
                else:
                    num_val = int(val_ratio / (1.0 - train_ratio) * num_samples)
                    num_test = num_samples - num_val

            train_data.append(frames_array[:num_train])
            val_data.append(frames_array[num_train : num_train + num_val])
            test_data.append(frames_array[num_train + num_val :])

            if only_test_folders is not None and name in only_test_folders:
                if len(sample_count) != 0:
                    num_train = sample_count[-1][0]
                else:
                    print(
                        "Warning: Only test folder came first. Defaulting to "
                        "given limit for train set."
                    )
                    num_train = 55500 if limit == -1 else limit
            sample_count.append([num_train, num_val, num_test])

        min_len = np.asarray(sample_count).T.min(axis=1)
        if ds_type == "train":
            if only_test_folders:
                return np.zeros([0, 0, 0])
            chosen, n = train_data, min_len[0]
        elif ds_type == "val":
            chosen, n = val_data, min_len[1]
        else:
            chosen, n = test_data, min_len[2]
        return np.stack([arr[:n] for arr in chosen])

    def get_label_name(self, key) -> str:
        if key in self.label_names:
            return self.label_names[key]
        return f"John Doe Generator {key}"

    def __len__(self) -> int:
        return int(len(self.audio_data))

    def __getitem__(self, idx: int) -> dict:
        from .wavio import audio_read
        from ..ops.audio import resample

        path, frame_idx, win, label = self.audio_data[idx]
        audio, sr = audio_read(str(path), int(frame_idx) * int(win), int(win))
        if sr > self.resample_rate:
            audio = resample(audio, sr, self.resample_rate)
        elif sr < self.resample_rate:
            raise RuntimeError(
                "Sample rate is smaller than desired sample rate. "
                "No upsampling possible here."
            )
        return {self.key: audio[None, :], "label": int(label), "index": idx}


def get_custom_dataset(
    data_path: str,
    save_path: str,
    ds_type: str,
    only_test_folders: Optional[list] = None,
    only_use: Optional[list] = None,
    seconds: float = 1,
    resample_rate: int = 22050,
    limit: int = 55504,
    abort_on_save: bool = False,
    asvspoof_name: Optional[str] = None,
    train_ratio: float = 0.7,
    val_ratio: float = 0.1,
    file_type: str = "wav",
    get_details: bool = False,
) -> CustomDataset:
    """Directory discovery + labeling (reference data_loader.py:396-507).

    ``get_details`` is accepted for reference-API parity but is a no-op
    here: the reference switches to ``CustomDatasetDetailed`` to add a
    per-sample ``"index"`` field (data_loader.py:356-393), which this
    dataset's ``__getitem__``/loader ALWAYS provides (the misclassified-
    sample dumps need it and it costs nothing).
    """
    paths = sorted(Path(data_path).glob("./*_*"))
    if len(paths) == 0:
        raise RuntimeError("Given data_path is empty.")

    labels: list = []
    str_paths = []
    for path in paths:
        if (
            only_use is not None
            and str(path).split("/")[-1].split("_")[-1] not in only_use
        ):
            continue
        desired_label = ord(path.name.split("_")[0]) - 65
        if desired_label in labels:
            for i in range(len(labels)):
                new_des_label = desired_label + i + 1
                if new_des_label in labels:
                    continue
                desired_label = new_des_label
                break
        labels.append(desired_label)
        str_paths.append(str(path))

    if 0 not in labels and ds_type == "train":
        raise RuntimeError("No real training data. Aborting...")

    return CustomDataset(
        paths=str_paths,
        labels=labels,
        save_path=save_path,
        abort_on_save=abort_on_save,
        seconds=seconds,
        resample_rate=resample_rate,
        verbose=False,
        limit=limit,
        ds_type=ds_type,
        only_test_folders=only_test_folders,
        asvspoof_name=asvspoof_name,
        train_ratio=train_ratio,
        val_ratio=val_ratio,
        filetype=file_type,
    )


def get_ds_label(labels):
    """First non-zero label of a binary dataset (reference data_loader.py:19-24)."""
    for label in labels:
        if label != 0:
            return label
    return np.int64(0)
