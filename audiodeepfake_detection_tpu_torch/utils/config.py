"""Experiment configuration and cartesian grid-search iterator.

Copy of ``audiodeepfake_detection_tpu/utils/config.py`` (reference:
src/audiofakedetect/utils.py):

* ``DotDict``      -- dict with attribute access; missing keys read as None.
* ``Griderator``   -- cartesian product over a dict-of-lists config with the
  seed list prepended as the first grid axis, and the reference's
  ``update_step`` semantics: apply the *current* grid point to the args,
  then advance.
* ``default_config`` -- the reference CLI's defaults, plus ``device``.
* ``load_grid_config`` -- loads a grid config from a ``.py`` file exposing
  ``get_config()`` or from JSON.
"""

from __future__ import annotations

import importlib.util
import json
import random
from typing import Any, Dict, List, Optional


class DotDict(dict):
    """Dot-notation access to dictionary attributes; missing keys -> None."""

    __getattr__ = dict.get  # type: ignore[assignment]
    __setattr__ = dict.__setitem__  # type: ignore[assignment]
    __delattr__ = dict.__delitem__  # type: ignore[assignment]

    def copy(self) -> "DotDict":
        return DotDict(dict.copy(self))


def default_config() -> DotDict:
    """Defaults matching the reference CLI (reference utils.py:30-317)."""
    return DotDict(
        log_dir="./exp/log",
        batch_size=128,
        learning_rate=1e-4,
        weight_decay=0.01,
        epochs=10,
        transform="stft",
        features="none",
        num_of_scales=256,
        wavelet="sym8",
        sample_rate=22050,
        window_size=11025,
        f_min=1000.0,
        f_max=11025.0,
        hop_length=1,
        log_scale=False,
        block_norm=False,
        power=2.0,
        dropout_cnn=0.6,
        dropout_lstm=0.3,
        loss_less="False",
        random_seeds=False,
        aug_contrast=False,
        aug_noise=False,
        calc_normalization=False,
        mean=[0.0],
        std=[1.0],
        data_prefix="../data/fake",
        unknown_prefix=None,
        cross_sources=[
            "avocodo",
            "bigvgan",
            "bigvganl",
            "conformer",
            "hifigan",
            "melgan",
            "lmelgan",
            "mbmelgan",
            "pwg",
            "waveglow",
            "jsutmbmelgan",
            "jsutpwg",
        ],
        init_seeds=[0, 1, 2, 3, 4],
        seed=0,
        flattend_size=9600,
        model="lcnn",
        nclasses=2,
        enable_gs=False,
        tensorboard=False,
        pbar=False,
        validation_interval=1,
        only_testing=False,
        ckpt_every=1,
        time_dim_add=0,
        ddp=False,
        only_ig=False,
        config=None,
        num_workers=10,
        seconds=1,
        file_type="wav",
        asvspoof_name=None,
        asvspoof_name_cross=None,
        get_details=False,
        target=None,
        ig_times_per_target=None,
        only_test_folders=None,
        cross_data_path=None,
        cross_limit=(55500, 7304, 14600),
        limit_train=(55504, 7504, 15504),
        only_use=["ljspeech", "fbmelgan"],
        save_path=None,
        data_path=None,
        dtype="float32",
        adam_moments_dtype=None,
        grad_accum=1,
        fused_layer1=False,
        fused_pool=False,
        fused_layer2=False,
        frame_cache=False,
        steps_per_call=1,
        device_data=False,
        fsdp=False,
        fsdp_min_bytes=2**14,
        pp_stages=1,
        pp_microbatches=2,
        vmap_seeds=False,
        vmap_hparams=False,
        resume=False,
        device="cuda",
    )


class Griderator:
    """Cartesian sweep over a dict-of-lists config, seeds as the first axis.

    Sweep semantics match the reference's contract (utils.py:482-562):
    ``update_step`` applies the *current* grid point to the args and then
    advances, returning ``StopIteration`` (the class itself, not an
    instance) once the final point has been applied.  Internally the grid
    is a mixed-radix counter over the config axes — points are decoded
    from an integer index on demand rather than materialized up front, so
    huge sweeps cost nothing until visited.
    """

    def __init__(
        self,
        config: Dict[str, List[Any]],
        init_seeds: Optional[list] = None,
        num_exp: int = 5,
    ) -> None:
        if not isinstance(config, dict):
            raise TypeError(
                f"Config file must be of type dict but is {type(config)}."
            )
        if init_seeds is None:
            rand = random.SystemRandom()
            seeds = [rand.randrange(10000) for _ in range(num_exp)]
        else:
            seeds = list(init_seeds)
        self.init_config: Dict[str, Any] = {"seed": seeds, **config}
        self._axes: List[List[Any]] = [
            list(v) for v in self.init_config.values()
        ]
        self.current = 0

    def _point(self, index: int) -> tuple:
        """Decode grid point ``index`` (row-major, last axis fastest)."""
        coords: List[Any] = []
        for values in reversed(self._axes):
            index, digit = divmod(index, len(values))
            coords.append(values[digit])
        return tuple(reversed(coords))

    @property
    def grid_values(self) -> List[tuple]:
        # materialized once: experiment.py reads this per grid step, and
        # re-decoding the full product each access made an N-point sweep
        # cost O(N^2) point decodes
        cached = getattr(self, "_grid_values_cache", None)
        if cached is None or len(cached) != self.get_len():
            cached = [self._point(i) for i in range(self.get_len())]
            self._grid_values_cache = cached
        return cached

    def get_keys(self):
        return self.init_config.keys()

    def get_len(self) -> int:
        n = 1
        for values in self._axes:
            n *= len(values)
        return n

    def __iter__(self):
        return self

    def __next__(self) -> tuple:
        self.current += 1
        if self.current >= self.get_len():
            raise StopIteration
        return self._point(self.current)

    def next(self) -> tuple:
        return self.__next__()

    def reset(self) -> None:
        self.current = 0

    def update_args(self, args: DotDict) -> DotDict:
        for key, value in zip(self.get_keys(), self._point(self.current)):
            args[key] = value
        return args

    def update_step(self, args: DotDict):
        """Apply current grid values to args, then advance one step."""
        new_args = self.update_args(args)
        try:
            return new_args, self.__next__()
        except StopIteration:
            return new_args, StopIteration


def build_new_grid(
    config: dict,
    random_seeds: bool = False,
    seeds: Optional[list] = None,
) -> Griderator:
    """Grid with a seed axis prepended (reference utils.py:565-586)."""
    if random_seeds:
        return Griderator(config, num_exp=3)
    init_seeds = [0, 1, 2, 3, 4]
    if isinstance(seeds, list):
        init_seeds = [int(s) for s in seeds]
    return Griderator(config, init_seeds=init_seeds)


def load_grid_config(path: str) -> dict:
    """Load a grid config: ``.py`` with ``get_config()`` or ``.json``."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    spec = importlib.util.spec_from_file_location("grid_config", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # type: ignore[union-attr]
    get_config = getattr(module, "get_config", None)
    if get_config is None:
        raise RuntimeError(f"{path} does not define get_config()")
    return get_config()
