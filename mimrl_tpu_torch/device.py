"""Device resolution and the dtype policy.

- ``resolve_device``: entry points run on CUDA by default and raise when
  it is missing; the CPU is used only when the caller asks for it.
- Dtype policy (the counterpart of ``mimrl_tpu.models.bert.BertConfig.dtype``):
  parameters stay float32; the inputs of BERT's matmuls are cast to the
  compute dtype; LayerNorm and softmax run in float32.
- TF32: a float32 matmul or cuDNN call on the card may round its inputs
  to TF32 (10-bit mantissa). The port turns both switches OFF on every
  CUDA device it resolves, so float32 means float32, as it does in the
  JAX reference on the CPU. The bf16 path is unaffected (its matmul
  inputs are bf16 already); the GRU, ``W_t`` and CubeMLP, which run in
  float32 under either compute dtype, stay at full float32 precision.
"""

from __future__ import annotations

import torch

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def set_tf32(enabled: bool) -> None:
    """Set both TF32 switches (matmul and cuDNN) to ``enabled``."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda[:n]"`` -> a CUDA device (raises when CUDA is
    unavailable); ``"cpu"`` -> the CPU, only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mimrl_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        set_tf32(False)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``MimrlConfig.compute_dtype`` string -> torch dtype."""
    if name not in _COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype={name!r}; choose from {tuple(_COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[name]
