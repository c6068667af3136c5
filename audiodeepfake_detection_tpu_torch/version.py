"""Version of the PyTorch/CUDA port of audiodeepfake-detection-tpu."""

__version__ = "0.1.0"
