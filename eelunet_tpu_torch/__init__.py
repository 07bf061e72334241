"""eelunet_tpu_torch — the PyTorch + CUDA port of ``eelunet_tpu``.

It serves the seven model families of the JAX package (the flagship
EELUnet, U-Net, U-Net++, UNeXt, UNeXt-S, EGE-UNet and MALUNet; binary, BN
folded where the family folds, bf16 compute), trains them (bf16 autocast on
f32 weights), with or without the Canny augmentations, and evaluates them
on an NVIDIA H100. Every kernel that the JAX package writes
in Pallas for the TPU is a hand-written CUDA C++ kernel here: the FFT
high-pass forward and backward (``csrc/highpass.cu``,
``csrc/highpass_bwd.cu``), the fused Canny stencil (``csrc/canny.cu``) and
the direct 3x3 convolution (``csrc/conv3x3.cu``), each with a plain PyTorch
twin that runs on the CPU.
Modules mirror the JAX package's file names; the public surfaces keep its
layout (``Predictor`` takes (B,H,W,3) numpy and returns (B,H,W,1)) so the
two packages can be compared on the same inputs.

This package imports ``torch`` and never ``jax``: only the tests import both.
"""

__version__ = "0.1.0"

from eelunet_tpu_torch.registry import MODEL_REGISTRY, ModelOutput, create_model

__all__ = ["ModelOutput", "create_model", "MODEL_REGISTRY", "__version__"]
