"""MANSY ImmersiveVideoStreaming — PyTorch + CUDA port for NVIDIA Hopper.

The JAX package ``mansy_immersivevideostreaming_tpu`` is the reference this
port is held against; the layout mirrors it module for module (``config``,
``data``, ``ops``, ``sim``, ``models``, ``rl``, ``utils``, ``cli``).  The hot
functions of the bitrate-selection rollout run as hand-written CUDA kernels
(``kernels``); each kernel's plain PyTorch version sits beside it and runs
only for tensors that lie on the CPU.  This package imports torch and numpy,
never JAX.
"""

import torch

from mansy_immersivevideostreaming_torch.config import Config, default_config, load_config

# Full float32 everywhere: the JAX reference tests pin matmul precision to
# "highest" (tests/conftest.py), so TF32 (about three decimal digits) is off
# for matmuls and for cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# bf16 products (run_models --bf16) sum in f32 as XLA's do: cuBLAS may not
# reduce split sums in bf16.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"

__all__ = ["Config", "default_config", "load_config", "__version__"]
