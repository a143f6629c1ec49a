"""The port's attention forward and backward against the JAX Pallas
kernels.

``flash_attention_plain`` (the kernel's math in PyTorch ops, and the CPU
route of the wrapper) is held against
``mimrl_tpu.ops.pallas.flash_attention.flash_attention`` run as the JAX
tests run it on the CPU (interpret mode). Inputs come from a numpy seed,
with random key padding and one batch row whose keys are all padded
(JAX returns the uniform average of v there).

``flash_attention_bwd_plain`` (the backward kernel's algebra written out)
is held against ``autograd`` through the plain forward and against
``jax.grad`` of the JAX ``flash_attention``. With dropout the two packages
draw different bits, so the forward and the backward are checked to use
one mask (the v = I trick of ``test_dropout_backward_uses_same_mask``) and
only statistics are compared with JAX.

The wrapper's checks and the CUDA kernels against the plain versions are
in test_torch_kernels.py, which imports no JAX so that it runs on the
card's machine too.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimrl_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from mimrl_tpu_torch.ops import flash_attention as fa_mod
from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

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


def _rel(got, want):
    """Largest error relative to the largest magnitude of ``want``."""
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dropout_p", [0.0, 0.3])
@pytest.mark.parametrize("t,hd", [(T, HD), (37, 16)])
def test_plain_backward_matches_autograd(t, hd, dropout_p):
    """The written-out algebra against autograd through the plain forward,
    float32, with the same mask. Relative 1e-5: two orders of summation."""
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(t=t, hd=hd, seed=2))
    d_out = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(q.shape)).astype(np.float32))
    seed = torch.tensor([17])
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = flash_attention_plain(q, k, v, bias, seed, dropout_p)
    want = torch.autograd.grad(out, (q, k, v), d_out)
    got = flash_attention_bwd_plain(q, k, v, bias, seed, d_out, dropout_p)
    for g, w in zip(got, want):
        assert _rel(g.detach().numpy(), w.numpy()) < 1e-5


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_backward_matches_jax_grad(dtype, tol):
    """dq, dk, dv against jax.grad of the JAX flash_attention (interpret
    mode, dropout_p = 0), relative to the largest gradient. float32 1e-5
    (summation order); bf16 2e-2 (P, dS and the outputs are rounded to
    bf16 on both sides)."""
    q, k, v, bias = _inputs(seed=4)
    d_out = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(q, k, v):
        out = jax_fa(q, k, v, jnp.asarray(bias), jnp.zeros((1,), jnp.int32), 0.0)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(d_out, jdt))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    got = flash_attention_bwd_plain(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(bias), None, torch.from_numpy(d_out).to(tdt), 0.0)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        assert _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32))) < tol


def test_function_gradient_matches_jax_grad():
    """The autograd Function on CPU tensors (plain forward, plain backward)
    against jax.grad of sum(out^2), as tests/test_flash_attention.py
    checks the JAX kernel against XLA."""
    q, k, v, bias = _inputs(seed=6)

    def loss(q, k, v):
        return jnp.sum(jax_fa(q, k, v, jnp.asarray(bias),
                              jnp.zeros((1,), jnp.int32), 0.0) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(bias))
    got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_dropout_backward_uses_same_mask():
    """d/dv sum(Pd . v) equals the column sums of Pd only if the backward
    regenerates the forward's mask (v = I makes the output Pd itself)."""
    t = 16
    q, k, _, _ = _inputs(t=t, hd=t, seed=7)
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    bias0 = torch.zeros(BS, 1, 1, t)
    eye = torch.eye(t).expand(BS, NH, t, t).contiguous().requires_grad_()
    seed = torch.tensor([11])
    pd = flash_attention(q, k, eye, bias0, seed, 0.3)
    (gv,) = torch.autograd.grad(pd.sum(), eye)
    want = pd.detach().sum(dim=2)[..., None].expand(BS, NH, t, t)
    torch.testing.assert_close(gv, want, rtol=1e-5, atol=1e-5)
    # and another seed's mask would not do
    pd2 = flash_attention(q, k, eye, bias0, seed + 1, 0.3).detach()
    assert not torch.allclose(pd2.sum(dim=2), pd.detach().sum(dim=2))


def test_dropout_statistics_match_jax():
    """Different bit streams, same statistics: the share of dropped
    probabilities and the mean row sum of Pd, on both sides, with v = I."""
    t, p = 16, 0.5
    q, k, _, _ = _inputs(t=t, hd=t, seed=8)
    eye = np.broadcast_to(np.eye(t, dtype=np.float32), (BS, NH, t, t)).copy()
    bias0 = np.zeros((BS, 1, 1, t), np.float32)
    pd_j = np.asarray(jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(eye),
                             jnp.asarray(bias0), jnp.array([11], jnp.int32), p))
    pd_t = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(eye),
        torch.from_numpy(bias0), torch.tensor([11]), p).numpy()
    for pd in (pd_j, pd_t):
        assert 0.4 < (pd == 0.0).mean() < 0.6
        assert 0.8 < pd.sum(axis=-1).mean() < 1.2
    # kept probabilities are the undropped ones scaled by 1 / (1 - p)
    full = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(eye),
        torch.from_numpy(bias0)).numpy()
    kept = pd_t != 0.0
    np.testing.assert_allclose(pd_t[kept], full[kept] / (1.0 - p), rtol=1e-6)


@pytest.mark.parametrize("dtype,t,hd,backward,want", [
    (torch.bfloat16, 100, 64, False, "tensor_core"),
    (torch.bfloat16, 100, 64, True, "tensor_core"),
    (torch.bfloat16, 150, 64, True, "tensor_core"),
    (torch.bfloat16, 352, 64, True, "tensor_core"),
    (torch.bfloat16, 353, 64, True, "simt"),
    (torch.bfloat16, 512, 64, False, "tensor_core"),
    (torch.bfloat16, 512, 64, True, "simt"),
    (torch.bfloat16, 192, 128, True, "tensor_core"),
    (torch.bfloat16, 193, 128, True, "simt"),
    (torch.bfloat16, 752, 8, True, "tensor_core"),
    (torch.float32, 100, 64, False, "tensor_core"),
    (torch.float32, 16, 8, True, "tensor_core"),
])
def test_instance_choice(dtype, t, hd, backward, want):
    """The wrapper's choice of kernel instance: both input types run on the
    tensor cores (float32 in 3xTF32), the backward only while the head fits
    in shared memory (a limit that falls with hd, and is lower for float32's
    wider rows)."""
    assert fa_mod._instance(dtype, t, hd, backward) == want
    assert fa_mod.max_t_tensor_core_bwd(64, torch.bfloat16) == 352
    assert fa_mod.max_t_tensor_core_bwd(64, torch.float32) == 192


@pytest.mark.parametrize("hd", fa_mod.HEAD_DIMS)
def test_tensor_core_bwd_limit_fills_shared_memory(hd):
    """The backward's T limit is the last multiple of 16 whose staged head
    fits the H100's 227 KB a block (the same constant as the CUDA source's
    ``kTcSmemLimit``): q, k, v, dO as rows of max(hd, 16) + 8 bf16 elements
    (bfloat16) or hd + 4 floats (float32), bias and three softmax
    statistics as float32, one mask bit per (query, key). The AVEC length
    150 is within the bf16 limit at every head dim, and within float32's
    at hd 64 and below; one past a limit takes the SIMT instance."""
    source = (Path(fa_mod.__file__).parent / "csrc" / fa_mod.SOURCE_BWD).read_text()
    assert int(re.search(r"kTcSmemLimit = (\d+);", source).group(1)) == \
        fa_mod.SMEM_LIMIT

    for dtype, row in ((torch.bfloat16, (max(hd, 16) + 8) * 2),
                       (torch.float32, (hd + 4) * 4)):
        def staged(t_pad):
            return 4 * t_pad * row + 4 * t_pad * 4 + t_pad * t_pad // 8

        limit = fa_mod.max_t_tensor_core_bwd(hd, dtype)
        assert limit % 16 == 0 and limit >= (150 if dtype == torch.bfloat16
                                             or hd <= 64 else 96)
        assert staged(limit) <= fa_mod.SMEM_LIMIT < staged(limit + 16)
        assert fa_mod._instance(dtype, limit, hd, True) == "tensor_core"
        assert fa_mod._instance(dtype, limit + 1, hd, True) == "simt"
        assert fa_mod._instance(dtype, limit + 1, hd, False) == "tensor_core"


def test_tensor_core_alignment_check():
    """The tensor-core instances copy rows by 16 bytes: an input whose data
    starts off a 16-byte boundary is refused before any launch."""
    base = torch.zeros(4 * 16 + 1, dtype=torch.bfloat16)
    fa_mod._check_aligned(base[:64])
    with pytest.raises(ValueError, match="16-byte"):
        fa_mod._check_aligned(base[1:])
