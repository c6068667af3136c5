"""Experiment configuration: ``DotDict`` and the reference CLI defaults.

Copy of ``audiodeepfake_detection_tpu/utils/config.py`` (``DotDict`` and
``default_config``); the grid-search iterator waits for the training slice.
"""

from __future__ import annotations


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
    )
