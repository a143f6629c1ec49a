"""The weight converter ``state_dict_from_jax``: coverage of the JAX
params tree, refusal of extra, missing or misshapen leaves, and an exact
round trip back through the JAX package's own importers
(``convert_hf_torch_state_dict``, ``_import_rnn``, ``_import_mlp_encoder``).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimrl_tpu.models import bert as jbert
from mimrl_tpu.models.model import MimrlModel as JaxMimrlModel
from mimrl_tpu.models.model import init_full
from mimrl_tpu.utils.torch_import import _import_mlp_encoder, _import_rnn
from mimrl_tpu_torch.models.bert import BertConfig
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.models.model import MimrlModel

torch.set_num_threads(1)

BS, T, D_A, D_V, D_C = 4, 8, 6, 4, 16
KW = dict(d_a=D_A, d_v=D_V, d_common=D_C, encoders="gru", num_class=2,
          activate="gelu", time_len=T,
          d_hiddens=((T, 3, D_C), (4, 3, D_C)), d_outs=((T, 3, D_C), (4, 3, D_C)),
          dropout_mlp=(0.0, 0.0, 0.0), dropout=(0.0, 0.0, 0.0, 0.0),
          bias=True, ln_first=False, res_project=(True, True))


@pytest.fixture(scope="module")
def params():
    jm = JaxMimrlModel(d_t=32, bert_config=dataclasses.replace(
        jbert.BertConfig.tiny(), flash_attn="off"), **KW)
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 100, (BS, T)).astype(np.int32),
             np.zeros((BS, T), np.int32), np.ones((BS, T), np.int32),
             rng.normal(size=(BS, T, D_A)).astype(np.float32),
             rng.normal(size=(BS, T, D_V)).astype(np.float32))
    p = init_full(jm, {"params": jax.random.PRNGKey(0)},
                  *map(jnp.asarray, batch))["params"]
    return jax.tree_util.tree_map(np.asarray, p)


def _port():
    with torch.device("meta"):
        return MimrlModel(bert_config=BertConfig.tiny(), **KW)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_every_leaf_is_carried(params):
    model = _port()
    sd = state_dict_from_jax(params, model)
    assert set(sd) == set(model.state_dict())
    # every leaf of init_full's tree, the estimator groups included
    assert sum(v.size for _, v in _leaves(params)) == sum(
        t.numel() for t in sd.values())
    assert sum(k.startswith(("vmi_", "vcmi_")) for k in sd) == 5 * 16 + 6 * 8
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               for t in sd.values())


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_refuses_a_mismatched_tree(params, fault):
    p = copy.deepcopy(params)
    if fault == "extra":
        p["W_t"]["bias"] = np.zeros((D_C,), np.float32)
    elif fault == "missing":
        del p["rnn_v"]["l1_bwd"]
    else:
        p["ln_a"]["scale"] = np.ones((D_C + 1,), np.float32)
    with pytest.raises(ValueError):
        state_dict_from_jax(p, _port())


def test_estimator_groups_are_carried(params):
    sd = state_dict_from_jax(params, _port())
    g = params["vmi_estimator_t_a"]["critic_model"]["MLP_g"]["fc_0"]
    np.testing.assert_array_equal(
        sd["vmi_estimator_t_a.critic_model.MLP_g.fc_0.weight"].numpy().T,
        g["kernel"])
    c = params["vcmi_estimator_tc_v"]["classifier"]["fc_out"]
    np.testing.assert_array_equal(
        sd["vcmi_estimator_tc_v.classifier.fc_out.weight"].numpy().T,
        c["kernel"])
    np.testing.assert_array_equal(
        sd["vcmi_estimator_tc_v.classifier.fc_out.bias"].numpy(), c["bias"])
    p = copy.deepcopy(params)
    p["vmi_estimator_f_t"]["critic_model"]["MLP_x"] = {
        "fc_in": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError):
        state_dict_from_jax(p, _port())


def _assert_tree_equal(got, want):
    for path, w in _leaves(want):
        g = got
        for k in path:
            g = g[k]
        np.testing.assert_array_equal(np.asarray(g), w, err_msg="/".join(path))
    assert len(list(_leaves(got))) == len(list(_leaves(want)))


def test_bert_round_trip_is_exact(params):
    sd = state_dict_from_jax(params, _port())
    hf = {k[len("bertmodel."):]: v.numpy() for k, v in sd.items()
          if k.startswith("bertmodel.")}
    back = jbert.convert_hf_torch_state_dict(hf, jbert.BertConfig.tiny())
    _assert_tree_equal(back["params"], params["bertmodel"])


def test_rnn_and_cubemlp_round_trip_is_exact(params):
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params, _port()).items()}
    for name in ("rnn_a", "rnn_v"):
        _assert_tree_equal(_import_rnn(sd, name, 2), params[name])
    _assert_tree_equal(_import_mlp_encoder(sd, 2, True, None), params["mlp_encoder"])
    for name in ("ln_a", "ln_v"):
        np.testing.assert_array_equal(sd[f"{name}.weight"], params[name]["scale"])
    np.testing.assert_array_equal(sd["W_t.weight"].T, params["W_t"]["kernel"])
    np.testing.assert_array_equal(sd["classifier.weight"].T,
                                  params["classifier"]["kernel"])
