"""The port's serving path end to end, held against the JAX package.

A hermetic run: the port's ``make_dec_fixture`` writes a DeclareLab
split, JAX-initialised weights are converted and saved as a port
checkpoint with a ``config.json`` written by ``mimrl_tpu``, and
``Predictor(..., device="cpu")`` serves the test split. Its predictions
equal the JAX model's on the same batches (atol = rtol = 1e-4, float32;
the summation-order reasons of test_torch_model.py), and its metrics
equal ``mimrl_tpu.eval.metrics.get_score_from_result`` (scikit-learn) on
the same predictions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimrl_tpu.core.config import MimrlConfig as JaxConfig
from mimrl_tpu.data.universal import get_data_loader as jax_loaders
from mimrl_tpu.eval import metrics as jmetrics
from mimrl_tpu.models.bert import BertConfig as JaxBertConfig
from mimrl_tpu.models.model import MimrlModel as JaxMimrlModel
from mimrl_tpu.models.model import init_full
from mimrl_tpu_torch.core.checkpoint import CheckpointManager
from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.data.synthetic import make_dec_fixture
from mimrl_tpu_torch.eval import metrics
from mimrl_tpu_torch.eval.predict import Predictor
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.models.model import build_model

torch.set_num_threads(1)

TIME_LEN, D_C = 12, 16
N_TEST = 11  # 3 batches of 4: the last one is cycle-padded


def _cfg(data_dir):
    return JaxConfig(
        dataset="mosi_Dec", batch_size=4, time_len=TIME_LEN, d_common=D_C,
        d_hiddens=[[TIME_LEN, 3, D_C], [4, 3, D_C]],
        d_outs=[[TIME_LEN, 3, D_C], [4, 3, D_C]],
        dropout_mlp=[0.0, 0.0, 0.0], dropout=[0.0, 0.0, 0.0, 0.0],
        bias=True, bert_layers=2, bert_heads=2, bert_hidden=32,
        bert_intermediate=64, bert_dropout=0.0, data_dir=data_dir)


def _jax_model(cfg, vocab_size):
    """The model mimrl_tpu's Solver builds for this config."""
    bert = JaxBertConfig(
        vocab_size=max(vocab_size, 64), hidden_size=cfg.bert_hidden,
        num_hidden_layers=cfg.bert_layers,
        num_attention_heads=cfg.bert_heads,
        intermediate_size=cfg.bert_intermediate,
        max_position_embeddings=max(512, cfg.time_len),
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return JaxMimrlModel(
        d_t=768, d_a=5, d_v=20, d_common=cfg.d_common,
        time_len=cfg.time_len, d_hiddens=tuple(map(tuple, cfg.d_hiddens)),
        d_outs=tuple(map(tuple, cfg.d_outs)),
        dropout_mlp=tuple(cfg.dropout_mlp), dropout=tuple(cfg.dropout),
        bias=cfg.bias, res_project=tuple(cfg.res_project), bert_config=bert)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(task dir, JAX predictions, JAX targets, port Predictor)."""
    root = tmp_path_factory.mktemp("serve")
    data = str(root / "data")
    make_dec_fixture(data, "mosi", n_per_split=(6, 5, N_TEST),
                     max_len=TIME_LEN + 3, seed=3)
    cfg = _cfg(data)
    _, _, test_loader, *_ = jax_loaders(cfg)
    jm = _jax_model(cfg, test_loader.tokenizer.vocab_size)
    batches = list(test_loader)
    inputs = [jnp.asarray(batches[0][k]) for k in (
        "bert_sentences", "bert_sentence_types", "bert_sentence_att_mask",
        "audio", "video")]
    params = init_full(jm, {"params": jax.random.PRNGKey(5)}, *inputs)["params"]
    forward = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, deterministic=True, return_features=False)[0])
    preds, targets = [], []
    for b in batches:
        out = forward(params, b["bert_sentences"], b["bert_sentence_types"],
                      b["bert_sentence_att_mask"], b["audio"], b["video"])
        keep = b["sample_mask"] > 0.5
        preds.append(np.asarray(out)[keep])
        targets.append(b["labels"][0][keep])

    task = root / "run"
    ckpt = CheckpointManager(str(task))
    ckpt.save_config(cfg.to_json())  # written by mimrl_tpu's config
    # only 'latest' exists: Predictor(slot='best_valid') falls back to it
    shape_model = build_model(MimrlConfig.from_json(cfg.to_json()),
                              test_loader.tokenizer.vocab_size, 5, 20, "meta")
    params_np = jax.tree_util.tree_map(np.asarray, params)
    ckpt.save("latest", state_dict_from_jax(params_np, shape_model))
    return (str(task), np.concatenate(preds), np.concatenate(targets),
            Predictor(str(task), device="cpu"))


def test_predictions_match_jax(run):
    _, want, targets, predictor = run
    assert next(predictor.model.parameters()).device.type == "cpu"
    preds, targs = predictor.predict_loader(predictor.test_loader)
    assert preds.shape == (N_TEST, 1)
    np.testing.assert_array_equal(targs, targets)
    np.testing.assert_allclose(preds, want, rtol=1e-4, atol=1e-4)


def test_metrics_match_jax(run):
    _, _, targets, predictor = run
    preds, _ = predictor.predict_loader(predictor.test_loader)
    got = predictor.evaluate_split("test")
    want = jmetrics.get_score_from_result(preds, targets, "mosi_Dec",
                                          "regression", 1)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


def test_predictor_needs_cuda_unless_asked(run, monkeypatch):
    task = run[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(task)


def test_missing_checkpoint_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_config(JaxConfig(dataset="mosi_Dec").to_json())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Predictor(str(tmp_path), device="cpu")


@pytest.mark.parametrize("dataset,task,num_class", [
    ("mosi_Dec", "regression", 1), ("mosi_20", "regression", 1),
    ("mosei_50", "regression", 1), ("pom_SDK", "regression", 1),
    ("pom", "regression", 1), ("mmmo", "regression", 1),
    ("youtube", "regression", 1), ("avec2019", "regression", 1),
    ("mosi_Dec", "classification", 1), ("mosi_Dec", "classification", 3),
])
def test_metric_battery_matches_sklearn(dataset, task, num_class):
    """The numpy accuracy / weighted F1 / MAE against scikit-learn's, via
    the JAX package's battery, on every routing branch."""
    rng = np.random.default_rng(7)
    n = 40
    if task == "classification":
        preds = rng.normal(size=(n, num_class)).astype(np.float32)
        targets = rng.integers(0, max(num_class, 2), n)
    else:
        scale = 3.0 if dataset != "pom" else 1.0
        offset = 4.0 if dataset in ("pom", "mmmo") else 0.0
        preds = (offset + scale * rng.normal(size=(n, 1))).astype(np.float32)
        targets = (offset + np.round(scale * rng.normal(size=n))).astype(np.float32)
    got = metrics.get_score_from_result(preds, targets, dataset, task, num_class)
    want = jmetrics.get_score_from_result(preds, targets, dataset, task,
                                          num_class)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
