"""The training slice as a whole: one ``critic_step`` and one
``train_step`` (with and without MI) and one ``eval_step`` of the port
against ``StepFactory``'s jitted steps, from identical weights
(``init_full`` -> ``state_dict_from_jax``), batch, feature bank and kNN
anchors (the JAX package's, injected), with every dropout rate 0, float32
on the CPU. The JAX side runs BERT with ``flash_attn='on'``: its forward
and its ``jax.grad`` go through the Pallas kernels in interpret mode; the
port goes through its autograd Function and the kernels' plain versions.

Tolerances. Loss, MI vector, outputs: 1e-4 (the summation-order reasons of
test_torch_model.py, through 2 BERT layers, the GRUs and the estimators).
Updated parameters: 2e-6 (a few float32 steps of weights of order 0.1-1).
Under SGD the update is linear in the gradient and every entry is held. Under Adam the first update is ``lr * g / (|g| + 1e-8)``: where a
gradient is of the order of eps (the estimators of near-independent
features have such gradients), float32 noise in it is amplified up to
``lr / eps``-fold and the two sides cannot agree. So under Adam the
parameters are compared where the update is saturated (at least 0.999 of
the group's learning rate, |g| > 1000 eps); Adam's arithmetic
itself is held to optax on identical gradients in test_torch_optim.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimrl_tpu.core.config import MimrlConfig as JaxConfig
from mimrl_tpu.models import bert as jbert
from mimrl_tpu.models.model import CMI_KEYS
from mimrl_tpu.models.model import MimrlModel as JaxMimrlModel
from mimrl_tpu.models.model import init_full
from mimrl_tpu.train import optim as joptim
from mimrl_tpu.train import steps as jsteps
from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.models.model import build_model
from mimrl_tpu_torch.train import optim, steps

torch.set_num_threads(1)

BS, T, D_A, D_V, D_C, N_BANK, N_VALID, K = 8, 12, 5, 6, 16, 24, 20, 2
VOCAB = 128
TOL = dict(rtol=1e-4, atol=1e-4)
INPUTS = ("bert_sentences", "bert_sentence_types", "bert_sentence_att_mask",
          "audio", "video")


def _cfg(cls, **kw):
    base = dict(
        dataset="mosi_Dec", batch_size=BS, time_len=T, d_common=D_C,
        d_hiddens=[[T, 3, D_C], [4, 3, D_C]], d_outs=[[T, 3, D_C], [4, 3, D_C]],
        dropout_mlp=[0.0, 0.0, 0.0], dropout=[0.0, 0.0, 0.0, 0.0], bias=True,
        bert_layers=2, bert_heads=2, bert_hidden=32, bert_intermediate=64,
        bert_dropout=0.0, k_neighbor=K, gradient_clip=1.5, bert_lr_rate=0.01,
        loss_mi_coefficient1=[1.0] * 11, loss_mi_coefficient2=[0.01] * 8,
        moment_dtype="float32", flash_attn="on", fused_estimators=False)
    base.update(kw)
    return cls(**base)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(BS, T)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    a = rng.normal(size=(BS, T, D_A)).astype(np.float32)
    v = rng.normal(size=(BS, T, D_V)).astype(np.float32)
    a[2, 7:], v[5, 3:] = 0.0, 0.0
    sample_mask = np.ones(BS, np.float32)
    sample_mask[-1] = 0.0  # a cycle-padded row
    return dict(
        bert_sentences=rng.integers(0, VOCAB, (BS, T)).astype(np.int32),
        bert_sentence_types=np.zeros((BS, T), np.int32),
        bert_sentence_att_mask=mask, audio=a, video=v,
        sample_mask=sample_mask), rng.normal(size=BS).astype(np.float32)


def _bank_arrays(seed=1):
    rng = np.random.default_rng(seed)
    return dict(C=rng.normal(size=(N_BANK, 1)).astype(np.float32),
                **{f: rng.normal(size=(N_BANK, D_C)).astype(np.float32)
                   for f in "FTAV"})


def _jax_anchors(key):
    """The anchors ``sample_all_knn`` draws from this key
    (steps.py:93-98, knn.py:73-74)."""
    valid = (jnp.arange(N_BANK) < N_VALID).astype(jnp.float32)
    keys = jax.random.split(key, len(CMI_KEYS))
    return {name: np.asarray(jax.random.choice(
        keys[i], N_BANK, shape=(BS // K,), replace=False,
        p=valid / jnp.sum(valid))).astype(np.int64)
        for i, name in enumerate(CMI_KEYS)}


class Pair:
    """Both packages' training state from one set of weights."""

    def __init__(self, **cfg_kw):
        self.jcfg, self.cfg = _cfg(JaxConfig, **cfg_kw), _cfg(MimrlConfig, **cfg_kw)
        self.batch, self.labels = _batch()
        c = self.jcfg
        bert = dataclasses.replace(
            jbert.BertConfig.tiny(), vocab_size=VOCAB, flash_attn=c.flash_attn,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=512, quant=c.quant)
        self.jmodel = JaxMimrlModel(
            d_t=768, d_a=D_A, d_v=D_V, d_common=D_C, time_len=T,
            d_hiddens=tuple(map(tuple, c.d_hiddens)),
            d_outs=tuple(map(tuple, c.d_outs)), dropout_mlp=(0.0,) * 3,
            dropout=(0.0,) * 4, bias=True, k_neighbor=K,
            activate=c.activate, use_pallas=c.use_pallas,
            fused_estimators=False, bert_config=bert)
        inputs = [jnp.asarray(self.batch[k]) for k in INPUTS]
        params = init_full(self.jmodel, {"params": jax.random.PRNGKey(0)},
                           *inputs)["params"]
        self.params_np = jax.tree_util.tree_map(np.asarray, params)
        main, bert_p, _ = joptim.partition_params(params)
        self.jopt_main = joptim.make_main_optimizer(c, main, bert_p)
        self.jopt_vmi = joptim.make_vmi_optimizer(c)
        self.factory = jsteps.StepFactory(self.jmodel, c, self.jopt_main,
                                          self.jopt_vmi)
        self.bank_np = _bank_arrays()

    def jax_state(self):
        params = jax.tree_util.tree_map(jnp.asarray, self.params_np)
        main, bert_p, vmi = joptim.partition_params(params)
        bank = jsteps.FeatureBank.create(N_BANK, N_VALID, D_C).replace(
            **{k: jnp.asarray(v) for k, v in self.bank_np.items()})
        return main, bert_p, vmi, bank

    def jax_batch(self):
        return ({k: jnp.asarray(v) for k, v in self.batch.items()},
                jnp.asarray(self.labels))

    def port_state(self):
        model = build_model(self.cfg, VOCAB, D_A, D_V, "cpu")
        model.load_state_dict(state_dict_from_jax(self.params_np, model),
                              strict=True)
        main, bert_p, vmi = optim.partition_params(model)
        bank = steps.FeatureBank(N_BANK, N_VALID, D_C, model.classify_dim)
        for k, v in self.bank_np.items():
            getattr(bank, k).copy_(torch.from_numpy(v))
        new_bank = steps.FeatureBank(N_BANK, N_VALID, D_C, model.classify_dim)
        mb, labels = steps.to_device(self.batch, self.labels, "regression", "cpu")
        return (model, optim.make_main_optimizer(self.cfg, main, bert_p),
                optim.make_vmi_optimizer(self.cfg, vmi), bank, new_bank, mb,
                labels)

    def assert_params(self, model, jparams, names):
        """Port parameters against a JAX tree, through the converter."""
        tree = dict(self.params_np)
        tree.update(jax.tree_util.tree_map(np.asarray, jparams))
        want = state_dict_from_jax(tree, model)
        start = state_dict_from_jax(self.params_np, model)
        got = model.state_dict()
        checked = 0
        for name in want:
            if name.split(".")[0] not in names:
                continue
            g, w = got[name].numpy(), want[name].numpy()
            if self.cfg.optm == "Adam":
                lr = self.cfg.learning_rate * (
                    self.cfg.bert_lr_rate if name.startswith("bert") else 1.0)
                where = np.abs(w - start[name].numpy()) >= 0.999 * lr
                if not where.any():  # e.g. a key bias: its gradient is 0
                    continue
                g, w = g[where], w[where]
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=name)
            checked += 1
        assert checked >= len(names)


_PAIRS = {}


def _pair(optm):
    if optm not in _PAIRS:
        _PAIRS[optm] = Pair(optm=optm)
    return _PAIRS[optm]


@pytest.fixture(scope="module")
def pair():
    return _pair("Adam")


MAIN_GROUPS = ("bertmodel", "W_t", "rnn_a", "rnn_v", "ln_a", "ln_v",
               "mlp_encoder", "classifier")


def _vmi_groups(model):
    return tuple(n for n, _ in model.named_children()
                 if n.startswith(("vmi_", "vcmi_")))


@pytest.mark.parametrize("optm", ["Adam", "SGD"])
def test_critic_step_matches_jax(optm):
    pair = _pair(optm)
    rng = jax.random.PRNGKey(5)
    main, bert_p, vmi, bank = pair.jax_state()
    batch, labels = pair.jax_batch()
    state = pair.jopt_vmi.init(vmi)
    new_vmi, _, want_loss, want_mis = pair.factory.critic_step(
        main, bert_p, vmi, state, batch, labels, bank, rng)
    anchors = _jax_anchors(jax.random.split(rng)[1])

    model, _, opt_vmi, pbank, _, mb, plabels = pair.port_state()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, mis = steps.critic_step(
        model, opt_vmi, pair.cfg, mb, plabels, pbank, None,
        anchors={k: torch.from_numpy(v) for k, v in anchors.items()})
    assert mis.shape == (11,) and not loss.requires_grad
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(mis.numpy(), np.asarray(want_mis), **TOL)
    pair.assert_params(model, new_vmi, _vmi_groups(model))
    after = model.state_dict()
    for name in before:  # stage 1 leaves the main model alone
        if name.split(".")[0] in MAIN_GROUPS:
            assert torch.equal(before[name], after[name]), name
    assert any(not torch.equal(before[n], after[n]) for n in before
               if n.startswith("vcmi_"))


@pytest.mark.parametrize("optm,use_mi", [("Adam", True), ("Adam", False),
                                         ("SGD", True)])
def test_train_step_matches_jax(optm, use_mi):
    p = _pair(optm)
    rng = jax.random.PRNGKey(6)
    main, bert_p, vmi, bank = p.jax_state()
    batch, labels = p.jax_batch()
    state = p.jopt_main.init(joptim.merge_params(main, bert_p))
    new_bank = jsteps.FeatureBank.create(N_BANK, N_VALID, D_C)
    (new_main, new_bert, _, want_loss, want_mis, want_out,
     want_bank) = p.factory.train_step(
        main, bert_p, vmi, state, batch, labels, bank, new_bank, BS, rng,
        use_mi=use_mi)
    anchors = _jax_anchors(jax.random.split(rng)[1])

    model, opt_main, _, pbank, pnew, mb, plabels = p.port_state()
    vmi_before = {k: v.clone() for k, v in model.state_dict().items()
                  if k.startswith(("vmi_", "vcmi_"))}
    loss, mis, out = steps.train_step(
        model, opt_main, p.cfg, mb, plabels, pbank, pnew, BS, None, use_mi,
        anchors={k: torch.from_numpy(v) for k, v in anchors.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(mis.numpy(), np.asarray(want_mis), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    if not use_mi:
        assert not mis.any()
    p.assert_params(model, joptim.merge_params(new_main, new_bert),
                    MAIN_GROUPS)
    for name, old in vmi_before.items():  # stage 2 leaves the critics alone
        assert torch.equal(old, model.state_dict()[name]), name
    # the batch's features went into rows [BS, 2 BS) of the new bank only
    for field in "CFTAV":
        got = getattr(pnew, field).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(want_bank, field)),
                                   **TOL)
        assert not got[:BS].any() and not got[2 * BS:].any()
        assert got[BS:2 * BS].any()


def test_eval_step_matches_jax(pair):
    rng = jax.random.PRNGKey(7)
    main, bert_p, vmi, bank = pair.jax_state()
    batch, labels = pair.jax_batch()
    want_loss, want_mis, want_out, want_feats = pair.factory.eval_step(
        main, bert_p, vmi, batch, labels, bank, rng, use_mi=True)
    anchors = _jax_anchors(rng)  # eval_step hands its key to the sampler whole
    model, _, _, pbank, _, mb, plabels = pair.port_state()
    loss, mis, out, feats = steps.eval_step(
        model, pair.cfg, mb, plabels, pbank, None, True,
        anchors={k: torch.from_numpy(v) for k, v in anchors.items()})
    assert not model.training
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(mis.numpy(), np.asarray(want_mis), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    for g, w in zip(feats, want_feats):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("poisoned", [True, False])
def test_guard_keeps_parameters_and_bank_on_a_nan_label(pair, poisoned):
    """--skip_nonfinite_updates: a NaN label gives a NaN loss; parameters,
    optimizer state and the new bank keep their values, with no flag read
    back. A clean batch under the same flag updates all three."""
    cfg = pair.cfg.replace(skip_nonfinite_updates=True)
    model, opt_main, opt_vmi, bank, new_bank, mb, labels = pair.port_state()
    if poisoned:
        labels = labels.clone()
        labels[3] = float("nan")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    loss, _, _ = steps.train_step(model, opt_main, cfg, mb, labels, bank,
                                  new_bank, 0, gen, True)
    c_loss, _ = steps.critic_step(model, opt_vmi, cfg, mb, labels, bank, gen)
    after = model.state_dict()
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    state_moved = any(bool(t.any()) for o in (opt_main, opt_vmi) for t in o.state())
    if poisoned:
        assert torch.isnan(loss) and torch.isnan(c_loss)
        assert not changed and not state_moved
        assert not any(bool(t.any()) for t in new_bank.tensors())
    else:
        assert torch.isfinite(loss) and torch.isfinite(c_loss)
        assert any(k.startswith("bertmodel") for k in changed)
        assert any(k.startswith("vmi_") for k in changed)
        assert state_moved and bool(new_bank.T[:BS].any())


def test_bank_holds_fused_features_of_any_width():
    """F_F has the classifier's input width, which a 'cat' compose makes
    wider than d_common; rows are written in place, labels as a column."""
    bank = steps.FeatureBank(6, 5, d_common=4, d_fused=12)
    assert bank.valid.tolist() == [True] * 5 + [False]
    feats = [torch.full((2, d), float(i + 1)) for i, d in enumerate((12, 4, 4, 4))]
    bank.write(2, torch.tensor([7.0, 8.0]), *feats)
    assert bank.F.shape == (6, 12) and bank.C[2:4, 0].tolist() == [7.0, 8.0]
    assert bank.F[2:4].eq(1.0).all() and bank.V[2:4].eq(4.0).all()
    assert not bank.F[:2].any() and not bank.F[4:].any()
    # the offset as a device tensor (one captured train_step serves every
    # batch position) writes the same rows, and copy_ carries them over
    other = steps.FeatureBank(6, 5, d_common=4, d_fused=12)
    other.write(torch.tensor(2), torch.tensor([7.0, 8.0]), *feats)
    assert all(torch.equal(a, b) for a, b in zip(other.tensors(), bank.tensors()))
    assert all(torch.equal(a, b) for a, b in zip(
        steps.FeatureBank(6, 5, 4, 12).copy_(bank).tensors(), bank.tensors()))
    bank.write(2, torch.zeros(2), *[torch.zeros_like(f) for f in feats],
               ok=torch.tensor(False))
    assert bank.F[2:4].eq(1.0).all()  # a refused write keeps the rows
    assert not bank.zero_().T.any()


def test_training_mode_dropout_draws_from_the_generator(pair):
    """With dropout on, two steps of one generator differ, and the same
    seed repeats the attention masks (hidden dropout draws from torch's
    default generator, which the Solver seeds)."""
    cfg = pair.cfg.replace(bert_dropout=0.5)
    model = build_model(cfg, VOCAB, D_A, D_V, "cpu")
    model.load_state_dict(state_dict_from_jax(pair.params_np, model))
    model.train()
    mb, _ = steps.to_device(pair.batch, pair.labels, "regression", "cpu")
    ids, types, mask = (mb[k] for k in INPUTS[:3])

    def run(seed):
        torch.manual_seed(1)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model.bertmodel(ids, types, mask, gen)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
