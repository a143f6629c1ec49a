"""The port's fused CubeMLP axis MLP against the JAX package on the CPU.

The same numpy arrays go through ``mimrl_tpu.ops.pallas.cubemlp_kernel.
fused_axis_mlp`` in interpret mode (all three axes, as
``tests/test_pallas.py`` runs it) and through the port's plain version,
which is what the port's wrapper runs on a CPU tensor and what
``chip_smoke.py`` and ``tests/test_torch_kernels.py`` hold the CUDA kernel
to on the card.

Tolerances. With ``relu`` or ``tanh`` both sides compute the same function
in float32 and differ by summation order: 1e-5. With ``gelu`` the Pallas
kernel uses the tanh approximation (exact gelu has no Mosaic lowering) and
the port the exact erf form, the documented difference of at most ~1e-3 per
hidden unit: 5e-3, the tolerance ``tests/test_pallas.py`` gives the Pallas
kernel against the einsum path. Against the einsum ``AxisMLP``, whose gelu
is exact too, ``gelu`` is held to 1e-5. Gradients against ``jax.grad`` of
the einsum path: 1e-4 (sums over all positions, float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mimrl_tpu.models import cubemlp as jcube
from mimrl_tpu.ops.pallas import cubemlp_kernel as jkernel
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.models.cubemlp import AxisMLP, MLPEncoder
from mimrl_tpu_torch.ops.cubemlp_kernel import (ACTIVATIONS, fused_axis_mlp,
                                                fused_axis_mlp_plain)
from mimrl_tpu_torch.utils.activations import _ACTIVATIONS

torch.set_num_threads(1)

SHAPE = (4, 10, 3, 16)  # [bs, L, K, D]
D_HIDDEN, D_OUT = 7, 5


def _inputs(axis, use_bias, seed=0):
    rng = np.random.default_rng(seed)

    def a(*s):
        return rng.normal(size=s).astype(np.float32)

    d_in = SHAPE[axis]
    x = a(*SHAPE)
    w1, w2 = a(d_in, D_HIDDEN) / np.sqrt(d_in), a(D_HIDDEN, D_OUT) / np.sqrt(D_HIDDEN)
    b1, b2 = (a(D_HIDDEN), a(D_OUT)) if use_bias else (None, None)
    return x, w1.astype(np.float32), w2.astype(np.float32), b1, b2


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("activate,tol", [("relu", 1e-5), ("tanh", 1e-5),
                                          ("gelu", 5e-3)])
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("axis", [1, 2, 3])
def test_plain_matches_pallas_interpret(axis, use_bias, activate, tol):
    args = _inputs(axis, use_bias, seed=axis)
    want = jkernel.fused_axis_mlp(*map(_j, args), axis, activate,
                                  interpret=True)
    got = fused_axis_mlp_plain(*map(_t, args), axis, activate)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("axis", [1, 2, 3])
def test_gelu_matches_the_einsum_axis_mlp(axis, use_bias):
    """Exact gelu on both sides: the port's kernel route equals the JAX
    einsum path to float32 rounding (1e-5), which the Pallas kernel does
    not."""
    x, w1, w2, b1, b2 = _inputs(axis, use_bias, seed=10 + axis)
    ref = jcube.AxisMLP(axis, SHAPE[axis], D_HIDDEN, D_OUT, "gelu", use_bias)
    params = {"w1": w1, "w2": w2}
    if use_bias:
        params.update(b1=b1, b2=b2)
    want = ref.apply({"params": params}, jnp.asarray(x))
    got = fused_axis_mlp(*map(_t, (x, w1, w2, b1, b2)), axis, "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("axis", [1, 2, 3])
def test_gradients_match_jax_grad_of_the_einsum_path(axis, use_bias):
    """x, w1, w2, b1, b2: the port's autograd Function (plain forward on the
    CPU, the einsum backward of ``_fused_bwd``) against ``jax.grad`` of the
    einsum ``AxisMLP`` under a random cotangent (1e-4)."""
    args = _inputs(axis, use_bias, seed=20 + axis)
    names = ("x", "w1", "w2", "b1", "b2")[:5 if use_bias else 3]
    ref = jcube.AxisMLP(axis, SHAPE[axis], D_HIDDEN, D_OUT, "gelu", use_bias)
    out_shape = list(SHAPE)
    out_shape[axis] = D_OUT
    d_y = np.random.default_rng(5).normal(size=out_shape).astype(np.float32)

    def loss(x, params):
        return jnp.sum(ref.apply({"params": params}, x) * d_y)

    params = dict(zip(names[1:], map(jnp.asarray, args[1:])))
    want_x, want_p = jax.grad(loss, argnums=(0, 1))(jnp.asarray(args[0]), params)
    want = dict(want_p, x=want_x)

    leaves = [t.requires_grad_() for t in map(_t, args) if t is not None]
    y = fused_axis_mlp(*leaves, *([None, None] if not use_bias else []),
                       axis, "gelu")
    got = torch.autograd.grad(y, leaves, _t(d_y))
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


ENC_KW = dict(activate="gelu", d_in=(10, 3, 16), d_hiddens=((6, 3, 12), (4, 3, 8)),
              d_outs=((5, 3, 12), (3, 3, 8)), dropouts=(0.0, 0.0, 0.0),
              use_bias=True, res_project=(True, True))


@pytest.mark.parametrize("ln_first", [False, True])
def test_encoder_with_and_without_the_flag_agree(ln_first):
    """``MLPEncoder(use_pallas=True)`` equals ``use_pallas=False`` in the
    port, output and every gradient (1e-5 / 1e-4): same parameters, same
    names, exact gelu on both routes."""
    torch.manual_seed(1)
    plain = MLPEncoder(**ENC_KW, ln_first=ln_first)
    fused = MLPEncoder(**ENC_KW, ln_first=ln_first, use_pallas=True)
    assert list(plain.state_dict()) == list(fused.state_dict())
    fused.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(2)
    x = _t(rng.normal(size=(4, 10, 3, 16)).astype(np.float32)).requires_grad_()
    d_y = _t(rng.normal(size=(4, 3, 3, 8)).astype(np.float32))
    outs, grads = [], []
    for m in (plain, fused):
        y = m(x)
        outs.append(y)
        grads.append(torch.autograd.grad(y, [x, *m.parameters()], d_y))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    for g, w in zip(grads[1], grads[0]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_converted_jax_weights_serve_the_flagged_encoder():
    """``state_dict_from_jax`` has nothing new to map: a JAX
    ``MLPEncoder(use_pallas=True)`` tree loads strictly into the port's
    flagged encoder, and the two agree (relu, so the Pallas kernel in
    interpret mode computes the registry's function: 1e-4, as
    test_torch_model.py holds the einsum route)."""
    kw = dict(ENC_KW, activate="relu", ln_first=False)
    x = np.random.default_rng(1).normal(size=(4, 10, 3, 16)).astype(np.float32)
    jm = jcube.MLPEncoder(**kw, use_pallas=True)
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    want = jm.apply({"params": jp}, jnp.asarray(x))
    holder = nn.Module()
    holder.mlp_encoder = MLPEncoder(**kw, use_pallas=True)
    holder.load_state_dict(state_dict_from_jax({"mlp_encoder": jp}, holder),
                           strict=True)
    with torch.no_grad():
        got = holder.mlp_encoder.eval()(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_the_kernel_has_every_activation_of_the_registry():
    """The kernel route never switches to the einsum route quietly: it has
    every activation the registry has, and a module built with the flag
    raises at construction for a name the kernel lacks."""
    assert set(ACTIVATIONS) == set(_ACTIVATIONS)
    with pytest.raises(ValueError, match="activation"):
        AxisMLP(3, 8, 4, 8, "swish", True, use_pallas=True)
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(2, 4, 3, 8)).astype(np.float32)) * 3.0
    for name in ACTIVATIONS:
        torch.manual_seed(0)
        m = AxisMLP(3, 8, 6, 8, name, True, use_pallas=True)
        ref = AxisMLP(3, 8, 6, 8, name, True)
        ref.load_state_dict(m.state_dict())
        torch.testing.assert_close(m(x), ref(x), rtol=1e-6, atol=1e-6)
