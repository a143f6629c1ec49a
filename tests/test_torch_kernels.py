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
from mimrl_tpu_torch.ops.cubemlp_kernel import (fused_axis_mlp,
                                                fused_axis_mlp_plain)
from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from mimrl_tpu_torch.ops import int8_matmul as im
from mimrl_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
from mimrl_tpu_torch.ops.philox import dropout_keep_mask

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


@pytest.mark.parametrize("p", [-0.1, 1.0, 1.5])
def test_wrapper_refuses_dropout(p):
    """A rate outside [0, 1) raises, and so does dropout without a seed."""
    seed = torch.tensor([3])
    with pytest.raises(ValueError, match="dropout_p"):
        flash_attention(*_inputs(), seed, dropout_p=p)
    with pytest.raises(ValueError, match="seed"):
        flash_attention(*_inputs(), dropout_p=0.1)


def test_wrapper_backward_takes_plain_route_on_cpu():
    """On CPU tensors the autograd Function runs the plain forward and the
    plain backward, with one mask for both, and counts no launch."""
    q, k, v, bias = _inputs(seed=4)
    seed = torch.tensor([11])
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, bias, seed, 0.25)
    torch.testing.assert_close(
        out, flash_attention_plain(q, k, v, bias, seed, 0.25), rtol=0, atol=0)
    d_out = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(out.shape)).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), d_out)
    want = flash_attention_bwd_plain(q, k, v, bias, seed, d_out, 0.25)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


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


def _rel_err(got, want):
    """Largest error relative to the largest magnitude of the plain
    result: gradients are not O(1)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,hd", [(16, 8), (100, 64), (37, 16), (65, 32),
                                  (512, 64), (100, 128)])
def test_flash_dropout_kernel_matches_plain_on_card(cuda, dtype, tol, t, hd):
    """The forward with dropout against the plain version with the same
    seed (same Philox mask); same seed, same bits; another seed, other
    bits. Tolerances as without dropout."""
    q, k, v, bias = (x.to(cuda) for x in _inputs(bs=4, nh=3, t=t, hd=hd, seed=t))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    seed = torch.tensor([1234567 + t], device=cuda)
    got = flash_attention(q, k, v, bias, seed, 0.1)
    again = flash_attention(q, k, v, bias, seed, 0.1)
    other = flash_attention(q, k, v, bias, seed + 1, 0.1)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, bias, seed, 0.1)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, again)
    assert not torch.equal(got, other)


@pytest.mark.gpu
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,hd", [(16, 8), (100, 64), (150, 64), (37, 16),
                                  (65, 32), (512, 64), (100, 128)])
def test_flash_backward_kernel_matches_plain_on_card(cuda, dtype, tol, t, hd,
                                                     dropout_p):
    """dq, dk, dv of the backward kernel against the plain backward, error
    relative to the largest magnitude of the plain result. float32 2e-5
    (summation order, online statistics); bf16 2e-2 (Pd, dS and the outputs
    are rounded to bf16 on both sides, a bf16 step is 2^-8)."""
    q, k, v, bias = (x.to(cuda) for x in _inputs(bs=4, nh=3, t=t, hd=hd, seed=t))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    d_out = torch.randn(q.shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(t)).to(dtype)
    seed = torch.tensor([99 + t], device=cuda)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, bias, seed, d_out, dropout_p)
    again = flash_attention_bwd(q, k, v, bias, seed, d_out, dropout_p)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    want = flash_attention_bwd_plain(q, k, v, bias, seed, d_out, dropout_p)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == q.shape
        assert torch.equal(g, a), f"{name}: two runs differ"
        assert _rel_err(g, w) <= tol, f"{name}: {_rel_err(g, w)} > {tol}"


# T of the tensor-core cases: ragged and canonical lengths, then the
# backward's shared-memory limit at the case's head dim and one past it
# (the backward there is the SIMT instance)
_TC_T = [16, 37, 100, 150, "limit", "limit+1"]


@pytest.mark.gpu
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("t", _TC_T)
def test_flash_tensor_core_matches_plain_on_card(cuda, t, hd, dropout_p):
    """The bf16 instances the wrapper picks (the tensor-core ones up to the
    backward's T limit) against the plain versions, with random key padding
    and a fully padded row: the forward within 2e-2 (P and the output are
    rounded to bf16 on both sides; the kernel rounds the unnormalised P),
    dq, dk, dv within 2e-2 of the plain result's largest magnitude (Pd, dS
    and the outputs rounded to bf16), and two backward runs bit-equal."""
    limit = fa_mod.max_t_tensor_core_bwd(hd)
    t = {"limit": limit, "limit+1": limit + 1}.get(t, t)
    bs, nh = (4, 3) if t <= 150 else (2, 2)
    assert fa_mod._instance(torch.bfloat16, t, hd, False) == "tensor_core"
    assert (fa_mod._instance(torch.bfloat16, t, hd, True) == "tensor_core") == (
        t <= limit)
    q, k, v, bias = (x.to(cuda) for x in _inputs(bs=bs, nh=nh, t=t, hd=hd, seed=t))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    seed = torch.tensor([4242 + t], device=cuda)
    d_out = torch.randn(q.shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(t)).to(q.dtype)
    before = flash_attention.launches, flash_attention_bwd.launches
    got = flash_attention(q, k, v, bias, seed, dropout_p)
    grads = flash_attention_bwd(q, k, v, bias, seed, d_out, dropout_p)
    again = flash_attention_bwd(q, k, v, bias, seed, d_out, dropout_p)
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0],
            flash_attention_bwd.launches - before[1]) == (1, 2)
    want = flash_attention_plain(q, k, v, bias, seed, dropout_p)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    wants = flash_attention_bwd_plain(q, k, v, bias, seed, d_out, dropout_p)
    for name, g, a, w in zip(("dq", "dk", "dv"), grads, again, wants):
        assert torch.equal(g, a), f"{name}: two runs differ"
        assert _rel_err(g, w) <= 2e-2, f"{name}: {_rel_err(g, w)}"


@pytest.mark.gpu
@pytest.mark.parametrize("t", [16, 37, 100, 128])
def test_flash_tensor_core_dropout_mask_on_card(cuda, t):
    """Both tensor-core instances keep exactly ``dropout_keep_mask``. With
    q = k = 0 and no padding P is 1 / T everywhere: v = one-hot in the head
    dim (v[key, key] = 1) makes out[query, key] nonzero where the pair is
    kept, and dO = one-hot (dO[query, query] = 1) does the same for
    dv[key, query]."""
    bs, nh, hd, p = 2, 3, 128, 0.1
    z = torch.zeros(bs, nh, t, hd, device=cuda, dtype=torch.bfloat16)
    eye = torch.eye(t, hd, device=cuda, dtype=torch.bfloat16).expand(
        bs, nh, t, hd).contiguous()
    bias = torch.zeros(bs, 1, 1, t, device=cuda)
    seed = torch.tensor([77 + t], device=cuda)
    want = dropout_keep_mask(seed, bs, nh, t, t, p)
    out = flash_attention(z, z, eye, bias, seed, p)
    _, _, dv = flash_attention_bwd(z, z, eye, bias, seed, eye, p)
    torch.cuda.synchronize()
    assert torch.equal(out[..., :t] != 0, want)
    assert torch.equal(dv[..., :t].transpose(-1, -2) != 0, want)
    assert abs(want.float().mean().item() - (1 - p)) < 0.02


@pytest.mark.gpu
def test_tensor_core_bwd_limit_matches_source_on_card(cuda):
    """The wrapper's T limit is the one the CUDA source computes, and the
    source refuses one past it (a launch error, not a fallback)."""
    from mimrl_tpu_torch.ops import _build

    lib = _build.load(fa_mod.SOURCE_BWD, "bfloat16")
    for hd in fa_mod.HEAD_DIMS:
        assert lib.mimrl_flash_attention_bwd_tc_max_t(hd) == \
            fa_mod.max_t_tensor_core_bwd(hd)
    hd, t = 64, fa_mod.max_t_tensor_core_bwd(64) + 1
    q = torch.zeros(1, 1, t, hd, device=cuda, dtype=torch.bfloat16)
    fn = fa_mod._entry(fa_mod.SOURCE_BWD, "mimrl_flash_attention_bwd_tc", 9,
                       torch.bfloat16)
    bias = torch.zeros(1, 1, 1, t, device=cuda)
    rc = fn(*([q.data_ptr()] * 3), bias.data_ptr(), q.data_ptr(), None,
            *([q.data_ptr()] * 3), 1, 1, t, hd, 0.125, 0, 0, 1.0,
            torch.cuda.current_stream().cuda_stream)
    assert rc != 0


@pytest.mark.gpu
def test_autograd_function_runs_both_kernels_on_card(cuda):
    q, k, v, bias = (x.to(cuda) for x in _inputs(bs=2, nh=2, t=50, hd=32, seed=8))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    seed = torch.tensor([5], device=cuda)
    before = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, bias, seed, 0.1)
    d_out = torch.ones_like(out)
    got = torch.autograd.grad(out, (q, k, v), d_out)
    torch.cuda.synchronize()
    assert flash_attention.launches == before[0] + 1
    assert flash_attention_bwd.launches == before[1] + 1
    want = flash_attention_bwd_plain(q, k, v, bias, seed, d_out, 0.1)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 2e-5


# --------------------------------------------------------------------- #
# the fused CubeMLP axis MLP
# --------------------------------------------------------------------- #

def _axis_mlp_inputs(shape, axis, d_hidden, d_out, use_bias, seed=0,
                     linear_layout=False):
    """x and the weights in the JAX layout ([d_in, d_hidden],
    [d_hidden, d_out]) from a numpy seed; with ``linear_layout`` the weights
    are transposed views, as an ``nn.Linear`` weight enters."""
    rng = np.random.default_rng(seed)

    def t(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    d_in = shape[axis]
    x = t(*shape)
    w1, w2 = t(d_in, d_hidden) / d_in ** 0.5, t(d_hidden, d_out) / d_hidden ** 0.5
    if linear_layout:
        w1, w2 = w1.t().contiguous().t(), w2.t().contiguous().t()
    b1, b2 = (t(d_hidden), t(d_out)) if use_bias else (None, None)
    return x, w1, w2, b1, b2


@pytest.mark.parametrize("axis", [1, 2, 3])
@pytest.mark.parametrize("use_bias", [True, False])
def test_axis_mlp_wrapper_takes_plain_route_on_cpu(axis, use_bias):
    """On CPU tensors the autograd Function runs the plain forward and its
    einsum backward equals autograd through the plain version; no launch
    is counted."""
    args = _axis_mlp_inputs((3, 7, 3, 10), axis, 5, 4, use_bias, seed=axis)
    leaves = [a.requires_grad_() for a in args if a is not None]
    before = fused_axis_mlp.launches
    got = fused_axis_mlp(*args, axis, "gelu")
    want = fused_axis_mlp_plain(*args, axis, "gelu")
    assert torch.equal(got, want)
    d_y = torch.from_numpy(np.random.default_rng(9).normal(
        size=tuple(got.shape)).astype(np.float32))
    for g, w in zip(torch.autograd.grad(got, leaves, d_y),
                    torch.autograd.grad(want, leaves, d_y)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert fused_axis_mlp.launches == before


@pytest.mark.parametrize("case", ["activation", "axis", "dtype", "chain",
                                  "one_bias", "bias_shape", "x_rank"])
def test_axis_mlp_wrapper_checks_inputs(case):
    x, w1, w2, b1, b2 = _axis_mlp_inputs((2, 6, 3, 8), 1, 5, 4, True)
    axis, act = 1, "gelu"
    if case == "activation":
        act = "swish"
    elif case == "axis":
        axis = 0
    elif case == "dtype":
        x = x.to(torch.bfloat16)
    elif case == "chain":
        w2 = w2[:-1]
    elif case == "one_bias":
        b2 = None
    elif case == "bias_shape":
        b1 = b1[:-1]
    else:
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        fused_axis_mlp(x, w1, w2, b1, b2, axis, act)


# [bs, L, K, D], axis, d_hidden, d_out: the canonical six at a small batch,
# then ragged sizes (positions not a multiple of 64, units not a multiple of
# 8 or 32, a contraction of 1, more than 32 units over a strided axis)
_AXIS_MLP_CASES = [
    ((4, 100, 3, 128), 1, 50, 50), ((4, 50, 3, 128), 2, 3, 3),
    ((4, 50, 3, 128), 3, 128, 128), ((4, 50, 3, 128), 1, 10, 10),
    ((4, 10, 3, 128), 2, 3, 3), ((4, 10, 3, 128), 3, 128, 128),
    ((3, 37, 3, 50), 1, 33, 41), ((3, 7, 5, 70), 2, 9, 2),
    ((3, 7, 5, 70), 3, 45, 130), ((2, 1, 1, 5), 3, 1, 1),
    ((5, 1, 3, 2), 1, 4, 6), ((2, 130, 3, 17), 1, 70, 130),
]


@pytest.mark.gpu
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("shape,axis,d_hidden,d_out", _AXIS_MLP_CASES)
def test_axis_mlp_kernel_matches_plain_on_card(cuda, shape, axis, d_hidden,
                                               d_out, use_bias):
    """Tolerance 2e-5 of the largest magnitude of the plain result: both
    sides are float32 and differ by summation order, FMA contraction and
    the last bits of erf."""
    args = [a if a is None else a.to(cuda) for a in _axis_mlp_inputs(
        shape, axis, d_hidden, d_out, use_bias, seed=sum(shape),
        linear_layout=True)]
    before = fused_axis_mlp.launches
    got = fused_axis_mlp(*args, axis, "gelu")
    torch.cuda.synchronize()
    assert fused_axis_mlp.launches == before + 1
    want = fused_axis_mlp_plain(*args, axis, "gelu")
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel_err(got, want) <= 2e-5
    # contiguous weights in the JAX layout give the same bits
    again = fused_axis_mlp(args[0], args[1].contiguous(), args[2].contiguous(),
                           *args[3:], axis, "gelu")
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("activate", ["elu", "gelu", "hardshrink", "hardtanh",
                                      "leakyrelu", "prelu", "relu", "rrelu",
                                      "tanh"])
def test_axis_mlp_kernel_has_every_activation_on_card(cuda, activate):
    """Every activation of the registry, against the registry's own
    function in the plain version (2e-5 of the largest magnitude)."""
    args = [a.to(cuda) for a in _axis_mlp_inputs((3, 20, 3, 40), 3, 24, 40,
                                                 True, seed=3)]
    args[0] = args[0] * 3.0  # reach the saturated and the negative branches
    got = fused_axis_mlp(*args, 3, activate)
    want = fused_axis_mlp_plain(*args, 3, activate)
    assert _rel_err(got, want) <= 2e-5


@pytest.mark.gpu
def test_axis_mlp_gradients_on_card(cuda):
    """Kernel forward + einsum backward against autograd through the plain
    version, for every input (2e-5 of each gradient's largest magnitude)."""
    for axis in (1, 2, 3):
        args = [a.to(cuda).requires_grad_() for a in _axis_mlp_inputs(
            (4, 12, 3, 16), axis, 7, 5, True, seed=axis)]
        got = fused_axis_mlp(*args, axis, "gelu")
        want = fused_axis_mlp_plain(*args, axis, "gelu")
        d_y = torch.randn(got.shape, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(axis))
        for g, w in zip(torch.autograd.grad(got, args, d_y),
                        torch.autograd.grad(want, args, d_y)):
            assert _rel_err(g, w) <= 2e-5


# --------------------------------------------------------------------- #
# the int8 GEMM with its dequantisation epilogue
# --------------------------------------------------------------------- #

def _int8_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
    sa = torch.from_numpy(rng.uniform(0.001, 0.02, size=(m, 1)).astype(np.float32))
    sb = torch.from_numpy(rng.uniform(0.001, 0.02, size=(1, n)).astype(np.float32))
    return a, b, sa, sb


def test_int8_matmul_wrapper_takes_plain_route_on_cpu():
    a, b, sa, sb = _int8_inputs(9, 300, 7)
    before = int8_matmul.launches
    got = int8_matmul(a, b, sa, sb, torch.float32)
    want = (a.long() @ b.long()).float() * sa * sb  # exact integer sums
    assert torch.equal(got, want) and got.dtype == torch.float32
    assert torch.equal(int8_matmul(a, b, sa, sb, torch.bfloat16),
                       want.to(torch.bfloat16))
    assert int8_matmul.launches == before
    # the extreme sum: every product 127 * 127, past one float64 chunk
    ones = torch.full((2, 5000), 127, dtype=torch.int8)
    got = int8_matmul_plain(ones, ones.t(), torch.ones(2, 1), torch.ones(1, 2),
                            torch.float32)
    assert torch.equal(got, torch.full((2, 2), float(5000 * 127 * 127)))


@pytest.mark.parametrize("case", ["a_dtype", "out_dtype", "inner", "sa_size",
                                  "sb_dtype", "rank", "k_overflow"])
def test_int8_matmul_wrapper_checks_inputs(case):
    a, b, sa, sb = _int8_inputs(4, 6, 5)
    out_dtype = torch.float32
    if case == "a_dtype":
        a = a.int()
    elif case == "out_dtype":
        out_dtype = torch.float16
    elif case == "inner":
        b = b[:-1]
    elif case == "sa_size":
        sa = sa[:-1]
    elif case == "sb_dtype":
        sb = sb.double()
    elif case == "rank":
        a = a[None]
    else:
        a, b = a[:, :1].expand(4, 140000), b[:1].expand(140000, 5)
    with pytest.raises((TypeError, ValueError)):
        int8_matmul(a, b, sa, sb, out_dtype)


# (M, K, N) of a BERT-base layer's eight int8 products at bs 128, T 100:
# the four forward shapes and the four weight-gradient (dw) shapes
_CANONICAL_INT8 = [(12800, k, n) for k, n in
                   ((768, 2304), (768, 768), (768, 3072), (3072, 768))]
_CANONICAL_INT8 += [(k, 12800, n) for _, k, n in _CANONICAL_INT8]


def _covers_each_k_block_once(p):
    """The segments of ``schedule(p)``: each tile's K blocks exactly once,
    the blocks' work equal to one unit, slots as the split tiles list."""
    blocks, fixes, slots = im.schedule(p)
    assert len(blocks) == p.grid and all(blocks)
    pieces = {}
    for segments in blocks:
        for tile, k0, k1, slot in segments:
            assert 0 <= k0 < k1 <= p.k_blocks
            pieces.setdefault(tile, []).append((k0, k1, slot))
    assert sorted(pieces) == list(range(p.tiles))
    for tile, ranges in pieces.items():
        ranges.sort()
        ends = [0] + [k1 for _, k1, _ in ranges]
        assert [k0 for k0, _, _ in ranges] == ends[:-1]
        assert ends[-1] == p.k_blocks
    unit = p.k_blocks if not p.stream_k else 1
    work = [sum(k1 - k0 for _, k0, k1, _ in segments) for segments in blocks]
    assert max(work) - min(work) <= unit
    split = {t: sorted(s for *_, s in r) for t, r in pieces.items()
             if len(r) > 1}
    assert [(t, split[t][0], len(split[t])) for t in sorted(split)] == fixes
    assert all(r == list(range(r[0], r[0] + len(r))) for r in split.values())
    assert sorted(s for r in split.values() for s in r) == list(range(slots))
    assert all(s == -1 for t, r in pieces.items() if t not in split
               for *_, s in r)
    return max((len(r) for r in pieces.values()), default=1)


def test_int8_plan_fills_the_card_on_the_canonical_shapes():
    """Every int8 product of the canonical path takes the wgmma instance
    with one block on each of the H100's 132 SMs; the forward shapes take
    whole tiles, the dw shapes (18-72 tiles) cut K by stream-K into at
    most MAX_PIECES pieces a tile, and every K block is computed once."""
    for m, k, n in _CANONICAL_INT8:
        p = im.plan(m, n, k, 132)
        assert p.instance == "wgmma" and p.grid == 132, (m, k, n, p)
        assert p.stream_k == (m != 12800) and p.tiles == (
            -(-m // im.TILE_M) * -(-n // im.TILE_N))
        assert _covers_each_k_block_once(p) <= im.MAX_PIECES


def test_int8_schedule_covers_k_once():
    """Ragged M, N and K tails, a single element, few SMs: the blocks'
    segments still cover each tile's K once, in equal shares."""
    for m, k, n, sms in ((200, 12800 + 48, 136, 132), (1, 16, 1, 132),
                         (64, 4096 + 48, 72, 132), (300, 768, 2304, 132),
                         (700, 1024, 1000, 16), (129, 4096, 257, 7)):
        p = im.plan(m, n, k, sms)
        assert p.instance == "wgmma" and p.grid <= sms
        assert _covers_each_k_block_once(p) <= im.MAX_PIECES


def test_int8_plan_takes_mma_sync_for_ragged_k_or_misaligned_bases():
    for m, k, n in ((333, 1000, 77), (77, 100, 45), (1, 1, 1), (130, 33, 7),
                    (12800, 768 + 8, 768)):
        assert im.plan(m, n, k, 132).instance == "mma_sync"
    assert im.plan(12800, 768, 768, 132, aligned=False).instance == "mma_sync"
    assert im.plan(12800, 768, 768, 132, aligned=True).instance == "wgmma"


# M, K, N: tile multiples, ragged edges in every dimension, K not a
# multiple of 16 (the mma_sync instance), a single element, a long K; a
# stream-K shape ragged in M and N with a K tail of 48 bytes; a reduced
# dw-like shape (K = 12800, 6 tiles: stream-K over the whole card)
_INT8_CASES = [(256, 128, 256), (128, 64, 128), (200, 96, 136), (77, 100, 45),
               (1, 1, 1), (130, 33, 7), (64, 4096 + 48, 72), (300, 768, 2304),
               (200, 12800 + 48, 136), (384, 12800, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["kernel", "transposed"])
@pytest.mark.parametrize("m,k,n", _INT8_CASES)
def test_int8_matmul_kernel_equals_plain_on_card(cuda, m, k, n, layout):
    """Integer accumulation is exact and both sides compute
    ``(float(acc) * sa) * sb`` in float32, so the kernel equals the plain
    version bit for bit with float32 output, and after the one
    round-to-nearest-even with bfloat16 output. 'kernel' hands over the
    layouts the kernel reads (a row-major, b as a transposed view of a
    row-major [N, K]); 'transposed' hands over the opposite ones, which the
    wrapper copies as int8."""
    a, b, sa, sb = (x.to(cuda) for x in _int8_inputs(m, k, n, seed=m + k + n))
    if layout == "kernel":
        b = b.t().contiguous().t()
    else:
        a = a.t().contiguous().t()
    instance = im.plan(m, n, k, torch.cuda.get_device_properties(
        cuda).multi_processor_count).instance
    before = int8_matmul.launches
    before_instance = int8_matmul.instance_launches[instance]
    for out_dtype in (torch.float32, torch.bfloat16):
        got = int8_matmul(a, b, sa, sb, out_dtype)
        torch.cuda.synchronize()
        want = int8_matmul_plain(a, b, sa, sb, out_dtype)
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert torch.equal(got, want), (
            f"{out_dtype}: {(got.float() - want.float()).abs().max().item()}")
    assert int8_matmul.launches == before + 2
    assert int8_matmul.instance_launches[instance] == before_instance + 2


@pytest.mark.gpu
def test_int8_matmul_schedules_agree_on_card(cuda, monkeypatch):
    """One product of 6 tiles and 100 K blocks under forced wgmma plans:
    whole tiles on 6 and on 2 blocks, stream-K on 132, 37 and 5 blocks
    (pieces from one K block to several tiles). Integer sums are exact in
    any order, so every schedule equals the plain version bit for bit."""
    m, k, n = 384, 12800, 512
    a, b, sa, sb = (x.to(cuda) for x in _int8_inputs(m, k, n, seed=3))
    b = b.t().contiguous().t()
    base = im.plan(m, n, k, 132)
    wants = {d: int8_matmul_plain(a, b, sa, sb, d)
             for d in (torch.float32, torch.bfloat16)}
    for grid, stream_k in ((6, False), (2, False), (132, True), (37, True),
                           (5, True)):
        forced = base._replace(grid=grid, stream_k=stream_k)
        monkeypatch.setattr(im, "plan", lambda *_, p=forced, **__: p)
        for out_dtype, want in wants.items():
            got = int8_matmul(a, b, sa, sb, out_dtype)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (grid, stream_k, out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,launches", [("int8_fwd", 1), ("int8", 2),
                                           ("int8_all", 3)])
def test_int8_dot_launches_and_gradients_on_card(cuda, mode, launches):
    """``int8_dot`` on the card: the mode's launch count (forward, dw, dx),
    and values and gradients bit-equal to the same function through the
    kernel's plain version (the int8 route is exact; the full-precision
    products of a mode are the same torch calls on both sides)."""
    from mimrl_tpu_torch.ops import quant

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 50, 40)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(3, 50, 24)).astype(np.float32)).to(cuda)
    results = []
    for route in ("kernel", "plain"):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = int8_matmul.launches
        if route == "plain":
            quant.int8_matmul = int8_matmul_plain
        try:
            y = quant.int8_dot(xr, wr.t(), mode, torch.float32)
            dx, dw = torch.autograd.grad(y, (xr, wr), g)
        finally:
            quant.int8_matmul = int8_matmul
        torch.cuda.synchronize()
        assert int8_matmul.launches - before == (launches if route == "kernel" else 0)
        results.append((y.detach(), dx, dw))
    for got, want in zip(*results):
        assert torch.equal(got, want)
