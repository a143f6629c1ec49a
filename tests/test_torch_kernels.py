"""The port's kernel wrappers: input checks, the CPU route, and each
CUDA kernel against its plain PyTorch version on the card.

This file imports no JAX, so it also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

Tests marked ``gpu`` skip here, where there is no card.
"""

import numpy as np
import pytest
import torch

from mimrl_tpu_torch.ops import flash_attention as fa_mod
from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)

torch.set_num_threads(1)


def _inputs(bs=3, nh=2, t=16, hd=8, seed=0):
    """q, k, v, bias from a numpy seed; random key padding and one batch
    row whose keys are all padded."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(bs, nh, t, hd)).astype(np.float32))
               for _ in range(3))
    mask = (rng.uniform(size=(bs, t)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    mask[bs - 1] = 0.0
    bias = torch.from_numpy(((1.0 - mask[:, None, None, :]) * -1e9).astype(np.float32))
    return q, k, v, bias


def test_wrapper_takes_plain_route_on_cpu():
    q, k, v, bias = _inputs(seed=2)
    before = flash_attention.launches
    got = flash_attention(q, k, v, bias)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, bias),
                               rtol=0, atol=0)
    assert flash_attention.launches == before  # no kernel ran
    # the fully padded row is the uniform average of v
    torch.testing.assert_close(got[-1], v[-1].mean(dim=1, keepdim=True)
                               .expand_as(got[-1]), rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_dropout():
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(*_inputs(), dropout_p=0.1)


@pytest.mark.parametrize("case", ["dtype", "bias_shape", "bias_dtype",
                                  "kv_shape", "head_dim", "contiguous"])
def test_wrapper_checks_inputs(case):
    q, k, v, bias = _inputs()
    if case == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif case == "bias_shape":
        bias = bias[:, :, :, :-1]
    elif case == "bias_dtype":
        bias = bias.double()
    elif case == "kv_shape":
        k = k[:, :1]
    elif case == "head_dim":
        q, k, v = (x[..., :6].contiguous() for x in (q, k, v))
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        fa_mod._check(q, k, v, bias)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mimrl_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,hd", [(16, 8), (100, 64), (150, 64), (37, 16),
                                  (65, 32), (512, 64), (100, 128)])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, tol, t, hd):
    """Tolerances: float32 2e-5 (summation order, online softmax); bf16
    2e-2 (P and the output are rounded to bf16 on both sides, and the
    kernel rounds the unnormalised P of its online softmax)."""
    q, k, v, bias = (x.to(cuda) for x in _inputs(bs=4, nh=3, t=t, hd=hd, seed=t))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, bias)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
