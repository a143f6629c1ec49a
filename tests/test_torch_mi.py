"""The port's MI stack against the JAX package: every bound, both critics,
the baselines, ``VMIEstimator`` and ``VCMIEstimator``, on the same numpy
inputs and, where there are weights, on flax-initialised weights carried
over by ``state_dict_from_jax``. Float32 on the CPU; tolerance 1e-5
(absolute and relative): the two sides differ by the order of their sums.
The model's estimator bank, batched (``--fused_estimators``) against
sequential and against JAX's fused bank, at JAX's own limits
(``tests/test_fused_estimators.py``).
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
    _check_standalone_helpers()


def _check_standalone_helpers():
    """``mi/standalone.py``: ``compute_mi``'s max / mean / smooth on one
    fixed history against JAX's (its ``train_mine`` replaced by the
    history); the correlated Gaussian's moments against what
    ``rho_to_mi`` assumes (unit variances, correlation rho per
    coordinate, independent coordinates); ``rho_to_mi`` against JAX's."""
    from mimrl_tpu.mi import standalone as jsa
    from mimrl_tpu_torch.mi import standalone

    history = np.cumsum(_np(30, 80)) / 10.0
    real = jsa.train_mine
    jsa.train_mine = lambda *a, **k: history
    try:
        for mode in ("max", "mean", "smooth"):
            want = jsa.compute_mi(None, "separate", "constant", "infonce",
                                  None, None, estimation=mode)[0]
            got = standalone.estimate_from_history(history, mode)
            assert got == pytest.approx(want, rel=1e-12), mode
    finally:
        jsa.train_mine = real
    with pytest.raises(NotImplementedError):
        standalone.estimate_from_history(history, "median")
    x, y = standalone.sample_correlated_gaussian(
        torch.Generator().manual_seed(0), rho=0.6, dim=4,
        num_samples=200_000)
    assert x.shape == y.shape == (200_000, 4)
    cov = np.cov(torch.cat([x, y], 1).numpy().T)
    np.testing.assert_allclose(np.diag(cov), 1.0, atol=0.01)
    np.testing.assert_allclose(np.diag(cov[:4, 4:]), 0.6, atol=0.01)
    off = cov - np.diag(np.diag(cov))
    off[:4, 4:] -= np.diag(np.diag(cov[:4, 4:]))
    off[4:, :4] -= np.diag(np.diag(cov[4:, :4]))
    assert np.abs(off).max() < 0.01
    assert standalone.rho_to_mi(5, 0.7) == pytest.approx(jsa.rho_to_mi(5, 0.7))
    assert standalone.rho_to_mi(5, 0.7) == pytest.approx(-2.5 * np.log(0.51))


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
    # a stack of matrices [E, bs, bs] (the batched bank): one value each
    stack = torch.stack([_t(scores), 0.5 * _t(scores).t()])
    base2 = torch.stack([_t(base), -_t(base)]) if needs_base else None
    mis, losses = bounds.mi_and_loss(bound_type, stack, base2)
    assert mis.shape == losses.shape == (2,)
    for e in range(2):
        want = bounds.mi_and_loss(bound_type, stack[e],
                                  base2[e] if needs_base else None)
        np.testing.assert_allclose(mis[e].numpy(), want[0].numpy(),
                                   rtol=2e-6, atol=1e-6)
        np.testing.assert_allclose(losses[e].numpy(), want[1].numpy(),
                                   rtol=2e-6, atol=1e-6)


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


# the estimator bank of the model: 5 VMI estimators and 6 classifiers at
# the model's hard-coded widths, on small features (as
# tests/test_fused_estimators.py)
BANK_BS, BANK_DC = 8, 16
BANK_TOL = dict(rtol=2e-5, atol=1e-6)  # JAX's limits for the fused bank
BANK_GRAD_TOL = dict(rtol=5e-5, atol=1e-6)


def _bank_models(critic_type, baseline_type, bound_type, d_f):
    """The JAX model (sequential and fused) and the port's model (batched
    and sequential) of one estimator configuration, on the JAX bank's
    weights; the fused features are d_f wide (d_f > d_common: a cat
    compose)."""
    from mimrl_tpu.models import model as jmodel
    from mimrl_tpu.models.bert import BertConfig as JBertConfig
    from mimrl_tpu_torch.models.bert import BertConfig
    from mimrl_tpu_torch.models.model import CMI_KEYS, VMI_KEYS, MimrlModel

    T, d_c = 4, BANK_DC
    compose = "cat" if d_f > d_c else "mean"
    kw = dict(d_a=3, d_v=2, d_common=d_c, time_len=T,
              d_hiddens=((T, 2, d_c), (2, 2, d_c)),
              d_outs=((T, 2, d_c), (2, 2, d_c // 2 if d_f > d_c else d_c)),
              features_compose_k=compose, features_compose_t=compose,
              critic_type=critic_type, baseline_type=baseline_type,
              bound_type=bound_type)
    jm = {fused: jmodel.MimrlModel(d_t=8, bert_config=JBertConfig.tiny(),
                                   fused_estimators=fused, **kw)
          for fused in (False, True)}
    est_kw = dict(hidden_dim=jmodel.EST_HIDDEN_DIM,
                  embed_dim=jmodel.EST_EMBED_DIM, layers=jmodel.EST_LAYERS)
    feats, labels, knn = _bank_inputs(d_f)
    xs = {"f": feats[0], "t": feats[1], "a": feats[2], "v": feats[3]}
    params = {}
    for i, key in enumerate(VMI_KEYS):
        params[f"vmi_estimator_{key}"] = jest.VMIEstimator(
            critic_type, baseline_type, bound_type, **est_kw).init(
                jax.random.PRNGKey(10 + i), xs[key[0]], xs[key[2]])["params"]
    lab = jnp.tile(labels[:, None], (1, d_c))
    for i, key in enumerate(CMI_KEYS):
        params[f"vcmi_estimator_{key}"] = jest.VCMIEstimator(
            embed_dim=jmodel.EST_EMBED_DIM,
            hidden_dim=jmodel.EST_HIDDEN_DIM).init(
                jax.random.PRNGKey(20 + i), lab, lab, lab, *knn[key])["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    pm = {}
    for fused in (True, False):
        m = MimrlModel(d_t=8, raw_text=False, bert_config=BertConfig.tiny(),
                       fused_estimators=fused, **kw)
        _bank_of(m).load_state_dict(state_dict_from_jax(params, _bank_of(m)),
                                    strict=True)
        assert m.classify_dim == d_f
        pm[fused] = m
    return jm, params, pm


def _bank_of(model):
    """The model's 11 estimators under their names, alone."""
    holder = nn.Module()
    for name, child in model.named_children():
        if name.startswith(("vmi_", "vcmi_")):
            setattr(holder, name, child)
    return holder


def _bank_inputs(d_f):
    rng = np.random.default_rng(0)
    feats = tuple(jnp.asarray(rng.normal(size=(BANK_BS, d)), jnp.float32)
                  for d in (d_f, BANK_DC, BANK_DC, BANK_DC))
    labels = jnp.asarray(rng.normal(size=(BANK_BS,)), jnp.float32)
    knn = {k: tuple(jnp.asarray(rng.normal(size=(BANK_BS, BANK_DC)),
                                jnp.float32) for _ in range(3))
           for k in ("ac_t", "ta_c", "vc_t", "tv_c", "tc_a", "tc_v")}
    return feats, labels, knn


def _port_bank(m, stage, labels, feats, knn):
    """(mis, losses, gradients of the summed losses by parameter name)."""
    method = (m.compute_vmi_loss_stage1 if stage == 1
              else m.compute_vmi_loss_stage2)
    mis, losses = method(_t(labels), *map(_t, feats),
                         {k: tuple(map(_t, v)) for k, v in knn.items()})
    names = [n for n, _ in m.named_parameters()
             if n.startswith(("vmi_", "vcmi_"))]
    params = dict(m.named_parameters())
    grads = torch.autograd.grad(sum(losses), [params[n] for n in names],
                                allow_unused=True)
    return (torch.stack(mis).detach().numpy(),
            torch.stack(losses).detach().numpy(),
            {n: (torch.zeros_like(params[n]) if g is None else g).numpy()
             for n, g in zip(names, grads)})


def _check_bank(monkeypatch, critic_type, baseline_type, bound_type,
                d_f=BANK_DC, against_jax=True):
    """The port's batched bank (``fused_estimators``) against its
    sequential bank at JAX's limits: values of both stages and the
    stage-1 gradients, element by element. Against JAX's fused bank
    (``against_jax``): the values at JAX's limits; the gradients at JAX's
    limits for a critic with a constant baseline, and otherwise by their
    largest error over the tensor's largest gradient, within JAX's rtol:
    TUBA's gradients reach 8.7 at these weights, and the port's sequential
    bank already differs from JAX's by 1.7e-6 of that (float32 sums in
    another order), past an elementwise atol of 1e-6 on elements that
    cancel. CLUB takes the sequential path in both packages."""
    from mimrl_tpu.models import model as jmodel
    from mimrl_tpu_torch.models import model as pmodel

    jm, params, pm = _bank_models(critic_type, baseline_type, bound_type, d_f)
    feats, labels, knn = _bank_inputs(d_f)
    calls = []
    for name in ("batched_vmi", "batched_vcmi"):
        def counted(*a, fn=getattr(pmodel, name)):
            calls.append(fn.__name__)
            return fn(*a)
        monkeypatch.setattr(pmodel, name, counted)
    got = {stage: _port_bank(pm[True], stage, labels, feats, knn)
           for stage in (1, 2)}
    monkeypatch.undo()
    groups = len(pm[True].vmi_groups) + len(pm[True].cmi_groups)
    assert len(calls) == (0 if bound_type == "club" else 2 * groups)
    assert list(pm[True].state_dict()) == list(pm[False].state_dict())
    seq = {stage: _port_bank(pm[False], stage, labels, feats, knn)
           for stage in (1, 2)}
    for stage in (1, 2):
        for g, w in zip(got[stage][:2], seq[stage][:2]):
            np.testing.assert_allclose(g, w, **BANK_TOL)
    for n, w in seq[1][2].items():
        np.testing.assert_allclose(got[1][2][n], w, err_msg=n,
                                   **BANK_GRAD_TOL)
    if not against_jax:
        return
    if d_f != BANK_DC:  # JAX's fused bank stacks F_F with T_F (ROADMAP §3)
        with pytest.raises(ValueError):
            jm[True].apply({"params": params}, labels, *feats, knn,
                           method=jmodel.MimrlModel.compute_vmi_loss_stage1)
        return
    for stage in (1, 2):
        method = (jmodel.MimrlModel.compute_vmi_loss_stage1 if stage == 1
                  else jmodel.MimrlModel.compute_vmi_loss_stage2)
        want = jax.jit(lambda p: jm[True].apply(
            {"params": p}, labels, *feats, knn, method=method))(params)
        for g, w in zip(got[stage][:2], want):
            np.testing.assert_allclose(g, np.stack(w), **BANK_TOL)

    def total(p):
        return sum(jm[True].apply(
            {"params": p}, labels, *feats, knn,
            method=jmodel.MimrlModel.compute_vmi_loss_stage1)[1])

    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(total))(params))
    want = state_dict_from_jax(jgrads, _bank_of(pm[True]))
    for n, g in got[1][2].items():
        w = want[n].numpy()
        if baseline_type == "constant":
            np.testing.assert_allclose(g, w, err_msg=n, **BANK_GRAD_TOL)
        else:
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= BANK_GRAD_TOL["rtol"], (n, err)


@pytest.mark.parametrize("critic_type,baseline_type,bound_type", [
    ("separate", "constant", "infonce"), ("concat", "constant", "nwj"),
    ("separate", "unnormalized", "tuba"), ("separate", "gaussain", "interpolate"),
    ("separate", "constant", "mine"), ("separate", "constant", "smile"),
    ("separate", "constant", "club")])
def test_vmi_estimator_matches_jax(monkeypatch, critic_type, baseline_type,
                                   bound_type):
    """One estimator against JAX's; then the model's bank of this
    configuration, batched against sequential and (InfoNCE, the concat
    critic, TUBA) against JAX's fused bank, and with fused features wider
    than d_common (``_check_bank``)."""
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
    _check_bank(monkeypatch, critic_type, baseline_type, bound_type,
                against_jax=bound_type in ("infonce", "nwj", "tuba"))
    if bound_type == "infonce":
        _check_bank(monkeypatch, critic_type, baseline_type, bound_type,
                    d_f=2 * BANK_DC)
    _check_train_mine(critic_type, baseline_type, bound_type)


def _check_train_mine(critic_type, baseline_type, bound_type):
    """Two epochs of ``mi/standalone.py::train_mine`` (Adamax, the EMA
    shadow after every step) against JAX's, from the weights JAX's draws
    (carried by the converter) and with one row order injected on both
    sides; the epochs' MI within 1e-5."""
    from mimrl_tpu.mi import standalone as jsa
    from mimrl_tpu_torch.mi import standalone

    rng = np.random.default_rng(21)
    n, d, bs = 64, 3, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (0.7 * x + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    perm = rng.permutation(n)
    kw = dict(hidden_dim=16, embed_dim=8, layers=1)
    train = dict(epochs=2, batch_size=bs, lr=1e-2, weight_decay=0.9, **kw)
    key = jax.random.PRNGKey(3)
    want = jsa.train_mine(key, critic_type, baseline_type, bound_type,
                          x[perm], y[perm], **train)
    # JAX's train_mine draws its weights so (mimrl_tpu/mi/standalone.py:110)
    _, k_critic, k_base = jax.random.split(key, 3)
    xj, yj = jnp.asarray(x[perm][:2]), jnp.asarray(y[perm][:2])
    if bound_type == "club":
        tree = {"critic_model": jcritics.ClubCritic(
            y_dim=d, hidden_dim=16, layers=1).init(k_critic, xj)["params"]}
    else:
        tree = {"critic_model": jcritics.CriticModel(critic_type, **kw).init(
            k_critic, xj, yj)["params"]}
    if baseline_type == "unnormalized":  # the other baselines hold none
        tree["baseline_model"] = jcritics.BaselineModel(
            baseline_type, hidden_dim=16, layers=1).init(k_base, yj)["params"]
    est = _carry("e", tree, estimators.VMIEstimator(
        critic_type, baseline_type, bound_type, d, d, **kw))
    got = standalone.train_mine(
        None, critic_type, baseline_type, bound_type, x, y, device="cpu",
        init_state=est.state_dict(), batch_order=torch.as_tensor(perm),
        **train)
    np.testing.assert_allclose(got, want, **TOL)


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
    # two classifiers batched (the second on reversed rows) against each
    torch.manual_seed(0)
    other = estimators.VCMIEstimator(embed_dim=8, hidden_dim=16,
                                     last_activate=last, cmi_type=cmi_type)
    inputs = [torch.stack([_t(f), _t(f).flip(0)]) for f in args]
    cmi, bce = estimators.batched_vcmi([pm, other], inputs[:3], inputs[3:])
    for e, est in enumerate((pm, other)):
        want = est(*(f[e] for f in inputs))
        np.testing.assert_allclose(cmi[e].detach().numpy(),
                                   want[0].detach().numpy(), **BANK_TOL)
        np.testing.assert_allclose(bce[e].detach().numpy(),
                                   want[1].detach().numpy(), **BANK_TOL)


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
