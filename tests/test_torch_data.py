"""The port's copies of the JAX package's host modules give the same
results: config (a file written by ``mimrl_tpu`` loads unchanged), CLI
parsing, tokenizer, synthetic Dec fixture, Dec loader and batch pipeline
(cycle-pad and sample mask), and the activation registry.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimrl_tpu.core import config as jconfig
from mimrl_tpu.data import pipeline as jpipe
from mimrl_tpu.data import synthetic as jsyn
from mimrl_tpu.data import tokenizer as jtok
from mimrl_tpu.data.declab import load_dec_dataset as jax_load_dec
from mimrl_tpu.utils.activations import get_activation_fn as jax_act
from mimrl_tpu_torch.core import config
from mimrl_tpu_torch.data import pipeline, synthetic, tokenizer
from mimrl_tpu_torch.data.declab import load_dec_dataset
from mimrl_tpu_torch.data.universal import get_data_loader
from mimrl_tpu_torch.utils.activations import _ACTIVATIONS, get_activation_fn

torch.set_num_threads(1)

README_MOSI = (
    "--task_name mosiDec52.1 --dataset mosi_Dec --log_scale 0-0-0 "
    "--normalize 0-1-1 --batch_size 128 --d_common 128 --encoders gru "
    "--activate gelu --time_len 100 --d_hiddens 50-3-128=10-3-128 "
    "--d_outs 50-3-128=10-3-128 --dropout_mlp 0.0-0.0-0.0 "
    "--dropout 0.1-0.1-0.1-0.1 --bias --res_project 1-1 "
    "--critic_type separate --baseline_type constant --bound_type infonce "
    "--loss_mi_coefficient1 1-1-1-1-1-1-1-1-1-1-1 "
    "--loss_mi_coefficient2 0.01-0.01-0.01-0.01-0.01-0.01-0.01-0.01 "
    "--k_neighbor 2 --radius 1.0 --cmi_last_acticate sigmoid --stage1_n 2 "
    "--seed 0 --loss MAE --gradient_clip 1.5 --epochs_num 70 --optm Adam "
    "--learning_rate 4e-3 --bert_freeze no --bert_lr_rate 0.01 "
    "--lr_decrease multi_step --lr_decrease_iter 9-60 "
    "--lr_decrease_rate 0.1 --save_best_features --parallel "
    "--compute_dtype bfloat16").split()


@pytest.mark.parametrize("argv", [[], README_MOSI])
def test_config_matches_jax(argv):
    want = dataclasses.asdict(jconfig.parse_args(argv))
    got = dataclasses.asdict(config.parse_args(argv))
    # the port's one addition: where its entry points run (None = CUDA)
    assert got.pop("device") is None
    assert got == want
    loaded = config.MimrlConfig.from_json(jconfig.parse_args(argv).to_json())
    assert dataclasses.asdict(loaded) == dict(want, device=None)
    assert loaded.replace(seed=3).seed == 3
    assert config.parse_args(argv + ["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("bad", [dict(encoders="rnn"), dict(flash_attn="yes"),
                                 dict(d_outs=[[1, 1, 1]]),
                                 dict(loss_mi_coefficient2=[0.1])])
def test_config_rejects_invalid_values(bad):
    with pytest.raises(ValueError):
        config.MimrlConfig(**bad)


@pytest.mark.parametrize("vocab_file", [False, True])
def test_tokenizer_matches_jax(tmp_path, vocab_file):
    texts = ["The movie was GOOD, really good!", "badness and sadness",
             "", "an unknownword here " * 30]
    if vocab_file:
        words = jtok.SPECIAL_TOKENS + ["the", "movie", "was", "good", ",",
                                       "!", "bad", "##ness", "sad", "and"]
        path = tmp_path / "vocab.txt"
        path.write_text("\n".join(words) + "\n")
        want = jtok.WordPieceTokenizer({w: i for i, w in enumerate(words)})
        got = tokenizer.WordPieceTokenizer.from_vocab_file(str(path))
    else:
        want = jtok.WordPieceTokenizer.hash_fallback()
        got = tokenizer.build_tokenizer()
    assert got.vocab_size == want.vocab_size
    for a, b in zip(got.batch_encode(texts, 16), want.batch_encode(texts, 16)):
        np.testing.assert_array_equal(a, b)


def test_dec_fixture_is_byte_identical(tmp_path):
    for mod, d in ((synthetic, "port"), (jsyn, "jax")):
        mod.make_dec_fixture(str(tmp_path / d), "mosei", n_per_split=(5, 3, 4),
                             max_len=9, seed=11)
    for split in ("train", "valid", "test"):
        name = f"mosei_{split}.pkl"
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


@pytest.mark.parametrize("shuffle", [False, True])
def test_pipeline_matches_jax(tmp_path, shuffle):
    synthetic.make_dec_fixture(str(tmp_path), "mosi", n_per_split=(11, 3, 3),
                               max_len=14, seed=2)
    tok_p, tok_j = tokenizer.build_tokenizer(), jtok.build_tokenizer()
    kw = dict(batch_size=4, time_len=10, shuffle=shuffle, seed=5)
    got = pipeline.BatchPipeline(
        load_dec_dataset("mosi_Dec", "train", str(tmp_path)), tokenizer=tok_p, **kw)
    want = jpipe.BatchPipeline(
        jax_load_dec("mosi_Dec", "train", str(tmp_path)), tokenizer=tok_j, **kw)
    assert len(got) == len(want) == 3
    for _epoch in range(2):
        batches = list(zip(got, want))
        for g, w in batches:
            for key in ("bert_sentences", "bert_sentence_types",
                        "bert_sentence_att_mask", "audio", "video",
                        "sample_mask"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            np.testing.assert_array_equal(g["labels"][0], w["labels"][0])
        # 11 samples in batches of 4: the last batch is cycle-padded
        assert batches[-1][0]["sample_mask"].tolist() == [1, 1, 1, 0]
    # prefetch (--num_workers): the same batches through the background
    # thread as through JAX's; an iterator's error is raised in the
    # consumer; a consumer that leaves early stops the thread
    for g, w in zip(pipeline.prefetch(iter(got), 2), jpipe.prefetch(iter(want), 2)):
        np.testing.assert_array_equal(g["audio"], w["audio"])

    def failing():
        yield 1
        raise ValueError("loader")

    with pytest.raises(ValueError, match="loader"):
        list(pipeline.prefetch(failing()))
    threads = threading.active_count()
    early = pipeline.prefetch(iter(range(100)), 2)
    assert next(early) == 0
    early.close()
    assert threading.active_count() == threads


def test_loader_refuses_unported_families():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_data_loader(config.MimrlConfig(dataset="mosi_SDK"))
    with pytest.raises(ValueError):
        get_data_loader(config.MimrlConfig(dataset="nope"))


@pytest.mark.parametrize("name", sorted(_ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.random.default_rng(0).normal(scale=2.0, size=257).astype(np.float32)
    got = get_activation_fn(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_act(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
