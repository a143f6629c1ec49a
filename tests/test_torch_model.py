"""The port's modules against the JAX package on the same converted
weights and the same batch (CPU, float32, deterministic).

JAX weights come from ``init_full``; ``state_dict_from_jax`` carries them
into the port. BERT runs with ``flash_attn='on'``, so the JAX side goes
through the Pallas kernel in interpret mode and the port through its
plain attention route. Tolerance atol = rtol = 1e-4: the two sides sum
in different orders in the 2 BERT layers, the GRU and LSTM scans (XLA
scan vs the torch RNN per direction), the Conv1d and the LayerNorms
(flax's fast variance vs torch's).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from mimrl_tpu.models import bert as jbert
from mimrl_tpu.models import cubemlp as jcube
from mimrl_tpu.models import encoders as jenc
from mimrl_tpu.models.model import MimrlModel as JaxMimrlModel
from mimrl_tpu.models.model import init_full
from mimrl_tpu_torch.models.bert import BertConfig
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.models.cubemlp import MLPEncoder
from mimrl_tpu_torch.models import encoders
from mimrl_tpu_torch.models.encoders import (BiRnnEncoder,
                                             lengths_from_sequence,
                                             prefix_mask)
from mimrl_tpu_torch.models.model import MimrlModel

torch.set_num_threads(1)

BS, T, D_A, D_V, D_C = 6, 10, 6, 4, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _model_kw(d_outs):
    return dict(d_a=D_A, d_v=D_V, d_common=D_C, encoders="gru",
                num_class=1, activate="gelu", time_len=T,
                d_hiddens=((T, 2, D_C), d_outs), d_outs=((T, 2, D_C), d_outs),
                dropout_mlp=(0.0, 0.0, 0.0), dropout=(0.0, 0.0, 0.0, 0.0),
                bias=True, ln_first=False, res_project=(True, True))


def _jax_model(d_outs=(4, 2, D_C), compose=("mean", "mean"), flash="on"):
    return JaxMimrlModel(
        d_t=32, features_compose_t=compose[0], features_compose_k=compose[1],
        bert_config=dataclasses.replace(jbert.BertConfig.tiny(),
                                        flash_attn=flash),
        **_model_kw(d_outs))


def _port_model(jparams, d_outs=(4, 2, D_C), compose=("mean", "mean"),
                flash="on"):
    m = MimrlModel(features_compose_t=compose[0],
                   features_compose_k=compose[1],
                   bert_config=dataclasses.replace(BertConfig.tiny(),
                                                   flash_attn=flash),
                   **_model_kw(d_outs))
    # a forward-only JAX tree carries no estimator bank; nothing else may
    # be missing
    missing, unexpected = m.load_state_dict(state_dict_from_jax(jparams, m),
                                            strict=False)
    assert not unexpected
    assert all(k.startswith(("vmi_", "vcmi_")) for k in missing)
    assert not missing or not any(k.startswith("vmi_") for k in jparams)
    return m.eval()


def _zero_tail(x, lengths):
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    return x


def _batch(seed=0):
    """Ragged a/v (one interior all-zero row, one all-zero sequence) and
    a text row whose keys are all padded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 100, (BS, T)).astype(np.int32)
    types = np.zeros((BS, T), np.int32)
    mask = (rng.uniform(size=(BS, T)) > 0.3).astype(np.int32)
    mask[1] = 0
    a = _zero_tail(rng.normal(size=(BS, T, D_A)).astype(np.float32),
                   [T, 7, 3, 1, 6, 0])
    a[4, 2] = 0.0  # interior all-zero row: counted out of the length
    v = _zero_tail(rng.normal(size=(BS, T, D_V)).astype(np.float32),
                   [5, T, 1, 8, 0, 4])
    return ids, types, mask, a, v


def _jit_apply(jm, params, batch, return_features):
    fn = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, deterministic=True,
                                        return_features=return_features))
    return fn(params, *map(jnp.asarray, batch))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, batch), built once."""
    jm = _jax_model()
    batch = _batch()
    params = init_full(jm, {"params": jax.random.PRNGKey(0)},
                       *map(jnp.asarray, batch))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, _port_model(params), batch


def test_bert_matches_jax(pair):
    _, params, pm, (ids, types, mask, _, _) = pair
    jb = jbert.BertModel(dataclasses.replace(jbert.BertConfig.tiny(),
                                             flash_attn="on"))
    want = jax.jit(lambda p, *a: jb.apply({"params": p}, *a))(
        params["bertmodel"], ids, types, mask)
    with torch.no_grad():
        got = pm.bertmodel(_t(ids), _t(types), _t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the token-type table, looked up by a chain of torch.where (a fixed
    # summation order on the card): both rows in use, its gradient as JAX's
    types = np.random.default_rng(5).integers(0, 2, ids.shape).astype(np.int32)
    cot = np.random.default_rng(6).normal(size=got.shape).astype(np.float32)
    p_bert = params["bertmodel"]
    table = p_bert["embeddings"]["token_type_embeddings"]["embedding"]

    def jloss(tab):
        emb = dict(p_bert["embeddings"],
                   token_type_embeddings={"embedding": tab})
        out = jb.apply({"params": dict(p_bert, embeddings=emb)}, ids, types,
                       mask)
        return jnp.sum(out * cot)

    want = jax.jit(jax.grad(jloss))(jnp.asarray(table))
    emb = pm.bertmodel.embeddings.token_type_embeddings
    assert isinstance(emb, nn.Embedding) and emb.weight.shape == (2, 32)
    pm.bertmodel.zero_grad()
    (pm.bertmodel(_t(ids), _t(types), _t(mask)) * _t(cot)).sum().backward()
    np.testing.assert_allclose(emb.weight.grad.numpy(), np.asarray(want),
                               **TOL)
    pm.bertmodel.zero_grad()


def test_lengths_and_mask_match_jax(pair):
    *_, (_, _, _, a, v) = pair
    for x in (a, v):
        want = jenc.lengths_from_sequence(jnp.asarray(x))
        got = lengths_from_sequence(_t(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            prefix_mask(got, T).numpy(),
            np.asarray(jenc.prefix_mask(want, T)))
    # count of non-zero rows, not the last one's index; empty -> 1
    assert lengths_from_sequence(_t(a)).tolist() == [10, 7, 3, 1, 5, 1]


@pytest.mark.parametrize("name,d_in", [("rnn_a", D_A), ("rnn_v", D_V)])
def test_bigru_matches_jax(pair, name, d_in):
    _, params, pm, (_, _, _, a, v) = pair
    x = a if name == "rnn_a" else v
    xj = jnp.asarray(x)
    mask = jenc.prefix_mask(jenc.lengths_from_sequence(xj), T)
    enc_j = jenc.BiRnnEncoder("gru", D_C, 2)
    want = jax.jit(lambda p, *a: enc_j.apply({"params": p}, *a))(
        params[name], xj, mask)
    enc = getattr(pm, name)
    assert isinstance(enc, BiRnnEncoder)
    with torch.no_grad():
        got = enc(_t(x), lengths_from_sequence(_t(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the lengths stay on the device: the same GRU over packed sequences
    # (which needs them on the host) gives the same outputs, and the
    # encoder's source copies nothing to the host
    lengths = lengths_from_sequence(_t(x))
    packed = pack_padded_sequence(_t(x), lengths, batch_first=True,
                                  enforce_sorted=False)
    with torch.no_grad():
        out, _ = nn.GRU.forward(enc, packed)
    fwd, bwd = pad_packed_sequence(out, batch_first=True, total_length=T)[0].chunk(2, -1)
    np.testing.assert_allclose(got.numpy(), (fwd + bwd).numpy(), rtol=0,
                               atol=1e-6)
    source = inspect.getsource(encoders)
    assert not any(s in source for s in (".cpu()", ".item()", "pack_padded"))


@pytest.mark.parametrize("ln_first", [False, True])
def test_cubemlp_matches_jax(ln_first):
    # K axes of width 3, as in the canonical 50-3-128=10-3-128: a
    # LayerNorm over 2 elements is ill-conditioned near ties, and turns
    # float32 summation-order noise into more than the tolerance
    d_in, d_h, d_o = (T, 3, D_C), ((6, 3, 12), (4, 3, 8)), ((5, 3, 12), (3, 3, 8))
    kw = dict(activate="gelu", d_in=d_in, d_hiddens=d_h, d_outs=d_o,
              dropouts=(0.0, 0.0, 0.0), use_bias=True, ln_first=ln_first,
              res_project=(True, True))
    x = np.random.default_rng(1).normal(size=(BS,) + d_in).astype(np.float32)
    jm = jcube.MLPEncoder(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    # non-trivial LayerNorm affine params
    rng = np.random.default_rng(3)
    for blk in jp.values():
        for name, sub in blk.items():
            if name.startswith("ln_"):
                for leaf, base in (("scale", 1.0), ("bias", 0.0)):
                    sub[leaf] = (base + 0.1 * rng.normal(
                        size=sub[leaf].shape)).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(jp, jnp.asarray(x))

    holder = nn.Module()
    holder.mlp_encoder = MLPEncoder(**kw)
    holder.load_state_dict(state_dict_from_jax({"mlp_encoder": jp}, holder),
                           strict=True)
    with torch.no_grad():
        got = holder.mlp_encoder.eval()(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_full_model_matches_jax(pair):
    jm, params, pm, batch = pair
    want = _jit_apply(jm, params, batch, return_features=True)
    with torch.no_grad():
        got = pm(*map(_t, batch), return_features=True)
        (out_only,) = pm(*map(_t, batch), return_features=False)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(out_only.numpy(), got[0].numpy())
    # --fused_av_scan: the towers through encoders.run_pair (two streams
    # on the card, one after the other here), bit for bit the same
    calls = []

    def counted(*args):
        calls.append(len(args))
        return encoders.run_pair(*args)

    import mimrl_tpu_torch.models.model as pmodel
    assert not pm.fused_av_scan
    pm.fused_av_scan = True
    try:
        real, pmodel.run_pair = pmodel.run_pair, counted
        with torch.no_grad():
            paired = pm(*map(_t, batch), return_features=True)
    finally:
        pmodel.run_pair = real
        pm.fused_av_scan = False
    assert calls == [6]
    for g, p in zip(got, paired):
        np.testing.assert_array_equal(p.numpy(), g.numpy())


def test_wide_classifier_branch_matches_jax(pair):
    """classify_dim > 128: classifier_hidden + ReLU + classifier (with
    the XLA attention path on the JAX side, to keep the test cheap)."""
    *_, batch = pair
    d_outs, compose = (5, 2, D_C), ("cat", "cat")  # 5 * 2 * 16 = 160
    jm = _jax_model(d_outs, compose, flash="off")
    # the forward's params only (no estimator bank): a cheaper init
    init = jax.jit(lambda key, *a: jm.init(key, *a, deterministic=True))
    params = jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(4), *map(jnp.asarray, batch))["params"])
    assert {"classifier_hidden", "classifier"} <= set(params)
    pm = _port_model(params, d_outs, compose, flash="off")
    assert pm.classify_dim == 160
    want = _jit_apply(jm, params, batch, return_features=False)[0]
    with torch.no_grad():
        got = pm(*map(_t, batch), return_features=False)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


D_T = 12  # dense text width


def test_encoders_and_dense_text_match_jax():
    """The 1-layer bi-LSTM, the Conv1d encoder and the 2-layer bi-GRU, each
    on the dense-text route (glove-like text into W_t, no BERT), against
    the JAX model on the same converted weights: output and the four
    features within TOL. A dense-text model has no ``bertmodel`` on either
    side and a ``W_t`` of [d_common, d_t]; the LSTM's device-side form
    equals torch's LSTM over packed sequences; the converted weights go
    back exactly by the JAX package's own import rules (``_import_rnn``,
    and the Conv1d kernel transpose of ``reference_state_dict_to_params``)."""
    for encoders in ("lstm", "conv", "gru"):
        _check_encoder_and_dense_text(encoders)


def _check_encoder_and_dense_text(encoders):
    from mimrl_tpu.utils.torch_import import _import_rnn

    # K axes of width 3 (see test_cubemlp_matches_jax)
    cube = ((T, 3, D_C), (4, 3, D_C))
    kw = dict(_model_kw(cube[1]), encoders=encoders, d_hiddens=cube,
              d_outs=cube)
    jm = JaxMimrlModel(d_t=D_T, bert_config=jbert.BertConfig.tiny(), **kw)
    ids, types, mask, a, v = _batch(seed=4)
    text = np.random.default_rng(5).normal(size=(BS, T, D_T)).astype(np.float32)
    params = init_full(jm, {"params": jax.random.PRNGKey(6)},
                       *map(jnp.asarray, (ids, types, mask, a, v)),
                       text_features=jnp.asarray(text))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    assert "bertmodel" not in params
    assert params["W_t"]["kernel"].shape == (D_T, D_C)
    want = jax.jit(lambda p, *x: jm.apply(
        {"params": p}, *x[:5], deterministic=True, return_features=True,
        text_features=x[5]))(params, ids, types, mask, a, v, text)

    pm = MimrlModel(d_t=D_T, raw_text=False, bert_config=BertConfig.tiny(),
                    **kw)
    sd = state_dict_from_jax(params, pm)
    pm.load_state_dict(sd, strict=True)
    pm.eval()
    assert not any(k.startswith("bertmodel") for k in pm.state_dict())
    assert pm.W_t.weight.shape == (D_C, D_T)
    with torch.no_grad():
        got = pm(None, None, None, _t(a), _t(v), text_features=_t(text))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pytest.raises(ValueError, match="text_features"):
        pm(None, None, None, _t(a), _t(v))

    sd = {k: x.numpy() for k, x in sd.items()}
    np.testing.assert_array_equal(sd["W_t.weight"].T, params["W_t"]["kernel"])
    if encoders == "conv":
        assert not any(k.startswith("rnn_") for k in sd)
        for name in ("conv_a", "conv_v"):
            assert sd[f"{name}.weight"].shape[2] == 3
            np.testing.assert_array_equal(sd[f"{name}.weight"].transpose(2, 1, 0),
                                          params[name]["conv"]["kernel"])
            np.testing.assert_array_equal(sd[f"{name}.bias"],
                                          params[name]["conv"]["bias"])
        return
    layers = 1 if encoders == "lstm" else 2
    for name in ("rnn_a", "rnn_v"):
        _assert_tree_equal(_import_rnn(sd, name, layers), params[name])
    enc = pm.rnn_a
    assert enc.mode == encoders.upper() and enc.num_layers == layers
    lengths = lengths_from_sequence(_t(a))
    packed = pack_padded_sequence(_t(a), lengths, batch_first=True,
                                  enforce_sorted=False)
    ref = getattr(nn, encoders.upper())(D_A, D_C, num_layers=layers,
                                         batch_first=True, bidirectional=True)
    ref.load_state_dict(enc.state_dict())
    with torch.no_grad():
        out, _ = ref(packed)
        mine = enc(_t(a), lengths)
    fwd, bwd = pad_packed_sequence(out, batch_first=True,
                                   total_length=T)[0].chunk(2, -1)
    np.testing.assert_allclose(mine.numpy(), (fwd + bwd).numpy(), rtol=0,
                               atol=1e-6)


def _assert_tree_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
