"""The port's attention forward against the JAX Pallas kernel.

``flash_attention_plain`` (the kernel's math in PyTorch ops, and the CPU
route of the wrapper) is held against
``mimrl_tpu.ops.pallas.flash_attention.flash_attention`` run as the JAX
tests run it on the CPU (interpret mode). Inputs come from a numpy seed,
with random key padding and one batch row whose keys are all padded
(JAX returns the uniform average of v there).

The wrapper's checks and the CUDA kernel against the plain version are
in test_torch_kernels.py, which imports no JAX so that it runs on the
card's machine too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimrl_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from mimrl_tpu_torch.ops.flash_attention import flash_attention_plain

torch.set_num_threads(1)

BS, NH, T, HD = 3, 2, 16, 8


def _inputs(bs=BS, nh=NH, t=T, hd=HD, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bs, nh, t, hd)).astype(np.float32)
               for _ in range(3))
    mask = (rng.uniform(size=(bs, t)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    mask[bs - 1] = 0.0  # a row whose keys are all padded
    bias = ((1.0 - mask[:, None, None, :]) * np.float32(-1e9)).astype(np.float32)
    return q, k, v, bias


def _jax(q, k, v, bias, dtype):
    return np.asarray(jax_fa(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                             jnp.asarray(bias), jnp.zeros((1,), jnp.int32),
                             0.0).astype(jnp.float32))


def _torch(q, k, v, bias, dtype):
    out = flash_attention_plain(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        torch.from_numpy(bias))
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("t,hd", [(T, HD), (37, 16)])
def test_plain_matches_jax_f32(t, hd):
    q, k, v, bias = _inputs(t=t, hd=hd)
    got = _torch(q, k, v, bias, torch.float32)
    np.testing.assert_allclose(got, _jax(q, k, v, bias, jnp.float32),
                               rtol=1e-5, atol=1e-5)
    # the fully padded row is the uniform average of v
    np.testing.assert_allclose(
        got[-1], np.broadcast_to(v[-1].mean(axis=1, keepdims=True), got[-1].shape),
        rtol=1e-5, atol=1e-5)


def test_plain_matches_jax_bf16():
    """bf16 inputs, compared in float32. Tolerance 2e-2: both sides round
    P and the output to bf16 (8-bit mantissa, 2^-8 relative), and their
    float32 sums in another order can flip one such rounding."""
    q, k, v, bias = _inputs(seed=1)
    got = _torch(q, k, v, bias, torch.bfloat16)
    np.testing.assert_allclose(got, _jax(q, k, v, bias, jnp.bfloat16),
                               rtol=2e-2, atol=2e-2)
