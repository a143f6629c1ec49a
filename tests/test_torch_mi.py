"""The port's MI stack against the JAX package: every bound, both critics,
the baselines, ``VMIEstimator`` and ``VCMIEstimator``, on the same numpy
inputs and, where there are weights, on flax-initialised weights carried
over by ``state_dict_from_jax``. Float32 on the CPU; tolerance 1e-5
(absolute and relative): the two sides differ by the order of their sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mimrl_tpu.mi import bounds as jbounds
from mimrl_tpu.mi import critics as jcritics
from mimrl_tpu.mi import estimators as jest
from mimrl_tpu_torch.mi import bounds, critics, estimators
from mimrl_tpu_torch.models.convert import state_dict_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BS, DX, DY = 10, 12, 8


def _np(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _carry(name, jparams, module):
    """flax params of one module -> the port module, through the converter
    (the module sits under an estimator-group name, as in the model)."""
    holder = nn.Module()
    setattr(holder, f"vmi_{name}", module)
    tree = jax.tree_util.tree_map(np.asarray, {f"vmi_{name}": jparams})
    holder.load_state_dict(state_dict_from_jax(tree, holder), strict=True)
    return module


SCORE_FNS = ["logmeanexp_diag", "logmeanexp_nodiag", "dv_lower_bound",
             "tuba_lower_bound", "nwj_lower_bound", "infonce_lower_bound",
             "js_fgan_lower_bound", "js_lower_bound", "smile_lower_bound"]


@pytest.mark.parametrize("name", SCORE_FNS)
def test_bound_matches_jax(name):
    scores = 2.0 * _np(0, BS, BS)
    want = getattr(jbounds, name)(jnp.asarray(scores))
    got = getattr(bounds, name)(_t(scores))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bound_helpers_match_jax():
    scores, base = 2.0 * _np(1, BS, BS), _np(2, BS, 1)
    np.testing.assert_allclose(
        bounds.exp_nodiag(_t(scores)).numpy(),
        np.asarray(jbounds.exp_nodiag(jnp.asarray(scores))), **TOL)
    np.testing.assert_allclose(
        bounds.compute_log_loomean(_t(scores)).numpy(),
        np.asarray(jbounds.compute_log_loomean(jnp.asarray(scores))), **TOL)
    np.testing.assert_allclose(
        bounds.log_interpolate(_t(scores), _t(base).repeat(1, BS), 0.3).numpy(),
        np.asarray(jbounds.log_interpolate(
            jnp.asarray(scores), jnp.tile(jnp.asarray(base), (1, BS)), 0.3)),
        **TOL)
    np.testing.assert_allclose(
        bounds.tuba_lower_bound(_t(scores), _t(base)).numpy(),
        np.asarray(jbounds.tuba_lower_bound(jnp.asarray(scores),
                                            jnp.asarray(base))), **TOL)
    np.testing.assert_allclose(
        bounds.interp_lower_bound(_t(scores), _t(base), 0.01).numpy(),
        np.asarray(jbounds.interp_lower_bound(
            jnp.asarray(scores), jnp.asarray(base), 0.01)), **TOL)


def test_club_matches_jax():
    mu, logvar, y = _np(3, BS, DY), 0.5 * _np(4, BS, DY), _np(5, BS, DY)
    want = jbounds.club_bound_and_nll(*map(jnp.asarray, (mu, logvar, y)))
    got = bounds.club_bound_and_nll(_t(mu), _t(logvar), _t(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("bound_type", jbounds.SCORE_BOUND_NAMES)
def test_mi_and_loss_matches_jax_with_gradient(bound_type):
    """(mi, mi_loss) and d mi_loss / d scores: the detached terms of js,
    smile and mine must detach the same things."""
    scores, base = _np(6, BS, BS), _np(7, BS, 1)
    needs_base = bound_type in ("tuba", "interpolate")

    def jloss(s):
        return jbounds.mi_and_loss(
            bound_type, s, jnp.asarray(base) if needs_base else None)

    (w_mi, w_loss) = jloss(jnp.asarray(scores))
    w_grad = jax.grad(lambda s: jloss(s)[1])(jnp.asarray(scores))
    s = _t(scores).requires_grad_()
    mi, loss = bounds.mi_and_loss(bound_type, s, _t(base) if needs_base else None)
    (grad,) = torch.autograd.grad(loss, s)
    np.testing.assert_allclose(mi.detach().numpy(), np.asarray(w_mi), **TOL)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(w_loss), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(w_grad), **TOL)


def test_mi_and_loss_refuses_unknown_bound():
    with pytest.raises(NotImplementedError):
        bounds.mi_and_loss("nope", _t(_np(0, 4, 4)))
    with pytest.raises(ValueError, match="log-baseline"):
        bounds.mi_and_loss("interpolate", _t(_np(0, 4, 4)))


@pytest.mark.parametrize("critic_type", ["separate", "concat"])
def test_critic_matches_jax(critic_type):
    x, y = _np(8, BS, DX), _np(9, BS, DY)
    jm = jcritics.CriticModel(critic_type, hidden_dim=16, embed_dim=6, layers=2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    pm = _carry("c", params, critics.CriticModel(
        critic_type, DX, DY, hidden_dim=16, embed_dim=6, layers=2))
    got = pm(_t(x), _t(y))
    assert got.shape == (BS, BS)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("baseline_type", ["constant", "unnormalized", "gaussain"])
def test_baseline_matches_jax(baseline_type):
    y = _np(10, BS, DY)
    jm = jcritics.BaselineModel(baseline_type, hidden_dim=16, layers=1,
                                mu=0.2, rho=1.5)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(y))
    want = jm.apply(variables, jnp.asarray(y))
    pm = critics.BaselineModel(baseline_type, DY, hidden_dim=16, layers=1,
                               mu=0.2, rho=1.5)
    if baseline_type == "unnormalized":
        _carry("b", variables["params"], pm)
    got = pm(_t(y))
    assert got.shape == (BS, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("critic_type,baseline_type,bound_type", [
    ("separate", "constant", "infonce"), ("concat", "constant", "nwj"),
    ("separate", "unnormalized", "tuba"), ("separate", "gaussain", "interpolate"),
    ("separate", "constant", "mine"), ("separate", "constant", "smile"),
    ("separate", "constant", "club")])
def test_vmi_estimator_matches_jax(critic_type, baseline_type, bound_type):
    x, y = _np(11, BS, DX), _np(12, BS, DY)
    kw = dict(hidden_dim=16, embed_dim=6, layers=2)
    jm = jest.VMIEstimator(critic_type, baseline_type, bound_type, **kw)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(y))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    pm = _carry("e", params, estimators.VMIEstimator(
        critic_type, baseline_type, bound_type, DX, DY, **kw))
    got = pm(_t(x), _t(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("bs,k,last,cmi_type", [
    (8, 2, "sigmoid", "nwj"), (9, 2, "sigmoid", "nwj"),   # bs % k != 0
    (10, 3, "hardtanh", "nwj"), (8, 2, "sigmoid", "dv")])
def test_vcmi_estimator_matches_jax(bs, k, last, cmi_type):
    """Features of width 4 are tiled to embed_dim 8; with bs % k != 0 the
    product set has (bs // k) * k rows and the joint set is cut to it."""
    n = (bs // k) * k
    fx, fy, fz = _np(13, bs, 4), _np(14, bs, 4), _np(15, bs, 8)
    kx, ky, kz = _np(16, n, 8), _np(17, n, 8), _np(18, n, 8)
    args = (fx, fy, fz, kx, ky, kz)
    jm = jest.VCMIEstimator(embed_dim=8, hidden_dim=16, last_activate=last,
                            cmi_type=cmi_type)
    params = jm.init(jax.random.PRNGKey(3), *map(jnp.asarray, args))["params"]
    want = jm.apply({"params": params}, *map(jnp.asarray, args))
    pm = _carry("v", params, estimators.VCMIEstimator(
        embed_dim=8, hidden_dim=16, last_activate=last, cmi_type=cmi_type))
    got = pm(*map(_t, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_cmi_head_clamps_and_bce_clamps_its_log():
    head = estimators.MLPForCMI(4, 8, 2)
    with torch.no_grad():
        head.fc_out.bias.fill_(1e4)
    out = head(torch.zeros(3, 4))
    assert torch.allclose(out, torch.sigmoid(torch.tensor(10.0)))
    probs = torch.tensor([[0.0, 1.0]])
    loss = estimators._binary_cross_entropy(probs, torch.tensor([[1.0, 0.0]]))
    want = jest._binary_cross_entropy(jnp.array([[0.0, 1.0]]),
                                      jnp.array([[1.0, 0.0]]))
    assert float(loss) == pytest.approx(100.0) == float(want)
