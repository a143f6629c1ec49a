"""The port reads what ``mimrl_tpu`` writes: its msgpack checkpoint slots
(without flax or msgpack) and the two pretrained-BERT formats of
``--bert_weights``.

- ``mimrl_tpu.core.checkpoint.CheckpointManager`` writes a slot of the
  JAX Solver's full schema (three parameter groups, both optax states, one
  with bfloat16 first moments and one with float32, the feature bank, the
  schedule factor and step), with seeded values. The port's reader returns
  every leaf bit for bit against ``flax.serialization.msgpack_restore`` on
  the same bytes, also when flax splits the arrays into chunks, and the
  port's ``Predictor`` serves the slot as the JAX ``Predictor`` does.
- A HuggingFace-layout torch file and a flax-layout ``.npz`` load into the
  port's BERT exactly as ``mimrl_tpu.models.bert.load_bert_weights``
  followed by ``state_dict_from_jax`` gives them, and a Solver built with
  ``--bert_weights`` holds them.
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from torch import nn

from mimrl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from mimrl_tpu.eval.predict import Predictor as JaxPredictor
from mimrl_tpu.models import bert as jbert
from mimrl_tpu.train.optim import make_vmi_optimizer
from mimrl_tpu.train.solver import Solver as JaxSolver
from mimrl_tpu_torch.core import flax_msgpack
from mimrl_tpu_torch.core.config import parse_args
from mimrl_tpu_torch.data.synthetic import make_dec_fixture
from mimrl_tpu_torch.eval.predict import Predictor
from mimrl_tpu_torch.models.bert import BertConfig, BertModel, load_bert_weights
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.train.solver import Solver
from test_torch_predict import N_TEST, _cfg
from test_torch_solver import N_VALID, _argv

torch.set_num_threads(1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bits(x):
    """(dtype name, shape, raw bytes) of an array leaf of either reader."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
    return x.dtype.name, x.shape, x.tobytes()


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if isinstance(w, (np.ndarray, np.generic)):
            assert _bits(g) == _bits(w), path
        else:
            assert type(g) is type(w) and g == w, path


def test_reads_mimrl_tpu_msgpack_slots(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    make_dec_fixture(data, "mosi", n_per_split=(6, 5, N_TEST),
                     max_len=15, seed=3)
    cfg = _cfg(data)
    solver = JaxSolver(cfg.replace(task_dir=str(tmp_path / "jax_runs"),
                                   task_name="writer"))
    assert cfg.moment_dtype == "bfloat16"
    state = solver._state_dict(4)
    state["opt_vmi_state"] = make_vmi_optimizer(
        cfg.replace(moment_dtype="float32")).init(solver.params_vmi)
    rng = np.random.default_rng(0)

    def seeded(x):  # moments and bank get values of their own dtype
        if jnp.issubdtype(x.dtype, jnp.floating) and x.size > 1:
            return np.asarray(jnp.asarray(rng.normal(size=x.shape), x.dtype))
        return x

    for key in ("opt_main_state", "opt_vmi_state", "bank"):
        state[key] = jax.tree_util.tree_map(seeded, state[key])
    state.update(lr_factor=0.1, global_step=17)

    run = str(tmp_path / "run")
    jax_ckpt = JaxCheckpointManager(run)
    jax_ckpt.save_config(cfg.to_json())
    jax_ckpt.save("best_valid", state)
    with open(f"{run}/best_valid_model.msgpack", "rb") as f:
        raw = f.read()
    want = serialization.msgpack_restore(raw)
    _assert_same_tree(flax_msgpack.msgpack_restore(raw), want)
    dtypes = {_bits(w)[0] for _, w in _leaves(want) if hasattr(w, "dtype")}
    assert {"bfloat16", "float32", "int32"} <= dtypes
    assert (want["epoch"], want["global_step"], want["lr_factor"]) == (4, 17, 0.1)

    # flax splits arrays above MAX_CHUNK_SIZE bytes into flat chunks
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    chunked_dir = str(tmp_path / "chunked")
    JaxCheckpointManager(chunked_dir).save("latest", state)
    with open(f"{chunked_dir}/latest_model.msgpack", "rb") as f:
        chunked = f.read()
    monkeypatch.undo()
    assert b"__msgpack_chunked_array__" in chunked
    _assert_same_tree(flax_msgpack.read(f"{chunked_dir}/latest_model.msgpack"),
                      want)

    # flax's other extension types and msgpack's other widths
    extra = {"scalar": np.float32(2.5), "complex": 1.5 - 2j, "none": None,
             "flags": [True, False], "bytes": b"\x00" * 300,
             "ints": [-1, -33, -200, -40000, -2 ** 40, 255, 70000, 2 ** 40],
             "long": "x" * 70000, "bf16": jnp.full((3,), 1.5, jnp.bfloat16)}
    packed = serialization.msgpack_serialize(extra)
    got = flax_msgpack.msgpack_restore(packed)
    assert isinstance(got["scalar"], np.float32) and got["scalar"] == 2.5
    assert {k: got[k] for k in ("complex", "none", "flags", "bytes", "ints",
                                "long")} == {k: extra[k] for k in (
        "complex", "none", "flags", "bytes", "ints", "long")}
    assert got["bf16"].dtype == torch.bfloat16 and got["bf16"].tolist() == [1.5] * 3
    for bad in (packed[:-1], packed + b"\x00",
                msgpack.packb(msgpack.ExtType(9, b"")), b"\xc1"):
        with pytest.raises(ValueError, match="msgpack"):
            flax_msgpack.msgpack_restore(bad)

    # the port's Predictor serves the mimrl_tpu run directory
    assert {f for f in os.listdir(run) if not f.endswith(".json")} == {
        "best_valid_model.msgpack"}
    predictor = Predictor(run, device="cpu")
    preds, targets = predictor.predict_loader(predictor.test_loader)
    jax_predictor = JaxPredictor(run)
    jax_preds, jax_targets = jax_predictor.predict_loader(
        jax_predictor._solver.test_loader)
    assert preds.shape == (N_TEST, 1)
    np.testing.assert_array_equal(targets, jax_targets)
    np.testing.assert_allclose(preds, jax_preds, rtol=1e-4, atol=1e-4)


def _hf_file(path, c: BertConfig, seed: int):
    """A seeded BertForPreTraining-style state_dict: the port's BERT
    tensors under ``bert.``, plus the keys both loaders ignore."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        names = BertModel(c).state_dict()
    sd = {f"bert.{k}": torch.randn(v.shape, generator=gen)
          for k, v in names.items()}
    sd["bert.embeddings.position_ids"] = torch.arange(
        c.max_position_embeddings)[None]
    sd["bert.pooler.dense.weight"] = torch.randn(
        c.hidden_size, c.hidden_size, generator=gen)
    sd["cls.predictions.bias"] = torch.randn(c.vocab_size, generator=gen)
    torch.save(sd, path)
    return sd


def test_bert_weights(tmp_path):
    # the BERT of the Solver's tiny argv (vocabulary of the hash tokenizer)
    c = BertConfig(vocab_size=30522, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=128)
    jc = jbert.BertConfig(vocab_size=30522, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=128)
    hf = str(tmp_path / "pytorch_model.bin")
    _hf_file(hf, c, seed=0)
    # the flax layout: another seeded file, converted by the JAX package
    flat = {}
    tree = jbert.convert_hf_torch_state_dict(
        {k: v.numpy() for k, v in _hf_file(str(tmp_path / "other.bin"), c,
                                           seed=1).items()}, jc)["params"]
    for path, leaf in _leaves(tree):
        flat[path[1:]] = np.asarray(leaf)
    npz = str(tmp_path / "bert.npz")
    np.savez(npz, **flat)

    with torch.device("meta"):
        holder = nn.ModuleDict({"bertmodel": BertModel(c)})
    loaded = {}
    for path in (hf, npz):
        want = state_dict_from_jax(
            {"bertmodel": jax.tree_util.tree_map(
                np.asarray, jbert.load_bert_weights(path, jc)["params"])},
            holder)
        model = BertModel(c)
        load_bert_weights(path, model)
        got = {f"bertmodel.{k}": v for k, v in model.state_dict().items()}
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), (path, k)
        loaded[path] = got
    assert not torch.equal(loaded[hf]["bertmodel.embeddings.word_embeddings.weight"],
                           loaded[npz]["bertmodel.embeddings.word_embeddings.weight"])

    # a Solver built with --bert_weights holds the file's tensors
    make_dec_fixture(f"{tmp_path}/data", "mosi", n_per_split=(9, N_VALID, 4),
                     d_audio=5, d_video=20, max_len=15, seed=2)
    solver = Solver(parse_args(_argv(str(tmp_path), "--task_name", "bw",
                                     "--bert_weights", hf)))
    solver.writer.close()
    for k, v in solver.model.state_dict().items():
        if k.startswith("bertmodel."):
            assert torch.equal(v, loaded[hf][k]), k

    # a missing tensor or another shape raises, in both formats
    sd = torch.load(hf, weights_only=True)
    del sd["bert.encoder.layer.1.output.dense.bias"]
    torch.save(sd, hf)
    with pytest.raises(KeyError, match="encoder.layer.1.output.dense.bias"):
        load_bert_weights(hf, BertModel(c))
    sd["bert.encoder.layer.1.output.dense.bias"] = torch.zeros(31)
    torch.save(sd, hf)
    with pytest.raises(ValueError, match="shape"):
        load_bert_weights(hf, BertModel(c))
    del flat["layer_1/output_dense/bias"]
    np.savez(npz, **flat)
    with pytest.raises(ValueError, match="unfilled"):
        load_bert_weights(npz, BertModel(c))
