"""The port's copies of the JAX package's host modules give the same
results: config (a file written by ``mimrl_tpu`` loads unchanged), CLI
parsing, tokenizer, synthetic fixtures, every dataset family's loader and
the batch pipeline (cycle-pad and sample mask, dense text, AVEC2019's
random words), and the activation registry.
"""

import dataclasses
import importlib
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
    _preflight_matches_jax(tmp_path)


def _preflight_matches_jax(tmp_path):
    """``data/preflight.py`` against the JAX package's, finding for
    finding (level, code and message), on a good fixture, on the one above
    (the wrong feature widths for MOSEI) and on broken copies: a missing pickle, a wrong Dec schema, the wrong label
    width, a missing or a wrong vocab, BERT weights of the wrong width,
    an SDK feature name, an AVEC directory; and its CLI's exit codes."""
    import pickle

    from mimrl_tpu.data import preflight as jpre
    from mimrl_tpu_torch.data import preflight

    good = str(tmp_path / "good")  # Dec-MOSEI's feature widths
    synthetic.make_dec_fixture(good, "mosei", n_per_split=(3, 2, 2),
                               d_audio=74, d_video=35, max_len=9, seed=11)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
                               + [f"w{i}" for i in range(1200)]))
    bad_vocab = tmp_path / "bad_vocab.txt"
    bad_vocab.write_text("a\nb\n")
    weights = str(tmp_path / "bert.bin")
    torch.save({"bert.embeddings.word_embeddings.weight": torch.zeros(8, 32)},
               weights)
    broken, missing = tmp_path / "broken", tmp_path / "missing"
    for d, splits in ((broken, ("train", "valid", "test")),
                      (missing, ("train", "valid"))):
        d.mkdir()
        for split in splits:
            (d / f"mosei_{split}.pkl").write_bytes(
                (tmp_path / "good" / f"mosei_{split}.pkl").read_bytes())
    with open(broken / "mosei_valid.pkl", "rb") as f:
        entries = pickle.load(f)
    (features, label, sid) = entries[0]
    with open(broken / "mosei_valid.pkl", "wb") as f:  # 1 label, not 7
        pickle.dump([(features, np.asarray(label).reshape(-1)[:1], sid)]
                    + entries[1:], f)
    schema = tmp_path / "schema"
    schema.mkdir()
    for split, data in (("train", [("a", "b", "c")]), ("valid", {"x": 1}),
                        ("test", [])):
        with open(schema / f"mosei_{split}.pkl", "wb") as f:
            pickle.dump(data, f)
    cases = [
        ("mosei_Dec", good, dict(bert_vocab=str(vocab), bert_weights=weights,
                                 bert_hidden=32)),
        ("mosei_Dec", good, {}),
        ("mosei_Dec", str(tmp_path / "port"), {}),
        ("mosei_Dec", good, dict(bert_vocab=str(bad_vocab),
                                 bert_weights=weights)),
        ("mosei_Dec", good, dict(bert_vocab=str(tmp_path / "none.txt"),
                                 bert_weights=str(tmp_path / "none.bin"))),
        ("mosei_Dec", str(broken), {}),
        ("mosei_Dec", str(missing), {}),
        ("mosei_Dec", str(schema), {}),
        ("mosei_Dec", str(tmp_path / "nowhere"), {}),
        ("mosi_SDK", good, dict(audio="opensmile", text="glove")),
        ("avec2019", good, {}),
    ]
    seen = set()
    for dataset, root, kw in cases:
        got = preflight.run_preflight(dataset, root, **kw)
        seen |= {f.code for f in got}
        want = jpre.run_preflight(dataset, root, **kw)
        assert [(f.level, f.code, f.message) for f in got] == [
            (f.level, f.code, f.message) for f in want], (dataset, root, kw)
        assert [str(f) for f in got] == [str(f) for f in want]
    assert seen == {
        "pickle_missing", "vocab_missing", "weights_missing", "dec_schema",
        "dec_label_cols", "dec_audio_dim", "dec_video_dim", "vocab_specials",
        "vocab_small", "weights_hidden_mismatch", "vocab_not_found",
        "weights_not_found", "data_dir_not_found"}, seen
    assert preflight.main(["--dataset", "mosei_Dec", "--data_dir", good,
                           "--bert_vocab", str(vocab), "--bert_weights",
                           weights, "--bert_hidden", "32"]) == []
    with pytest.raises(SystemExit) as stop:
        preflight.main(["--dataset", "mosei_Dec", "--data_dir", str(schema)])
    assert stop.value.code == 1


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


# (dataset, flags, fixture writer and its arguments); a/v widths as the
# registry's, text narrowed
FAMILIES = [
    ("mosi_SDK", dict(text="text", audio="covarep", video="facet41"),
     "make_sdk_fixture", dict(dataset="mosi", d_text=12, d_audio=74, d_video=47)),
    ("mosi_SDK", dict(text="glove", audio="covarep", video="facet42",
                      log_scale=[True, True, True]),
     "make_sdk_fixture", dict(dataset="mosi", d_text=300, d_audio=74, d_video=35)),
    ("mosei_SDK", dict(text="glove", audio="covarep", video="facet42"),
     "make_sdk_fixture", dict(dataset="mosei", d_text=300, d_audio=74, d_video=35)),
    ("pom_SDK", dict(text="text", audio="covarep", video="facet42"),
     "make_sdk_fixture", dict(dataset="pom", d_text=12, d_audio=43, d_video=35)),
    ("pom_SDK", dict(text="glove", audio="covarep", video="facet42",
                     normalize=[True, False, True]),
     "make_sdk_fixture", dict(dataset="pom", d_text=300, d_audio=43, d_video=35)),
    ("avec2019", dict(text="text", audio="mfcc", video="au"),
     "make_avec_fixture", dict(d_mfcc=39, d_au=49)),
    ("avec2019", dict(text="ege", audio="ds", video="resnet",
                      log_scale=[False, True, True]),
     "make_avec_fixture", dict(d_mfcc=39, d_au=49)),
    ("mosi_50", dict(log_scale=[False, True, True]),
     "make_local_fixture", dict(dataset="mosi_50", dims=(300, 5, 20))),
    ("pom", dict(), "make_local_fixture", dict(dataset="pom", dims=(300, 43, 43))),
]


def _family_loaders(pkg, cfg_cls, root, dataset, flags):
    """The JAX package's or the port's three pipelines and dims. AVEC with
    dense text has no registry width, so its loaders are built by hand."""
    cfg = cfg_cls(dataset=dataset, data_dir=root, batch_size=4, time_len=9,
                  seed=3, **flags)
    if dataset == "avec2019" and flags["text"] != "text":
        load = importlib.import_module(f"{pkg}.data.avec").load_avec_dataset
        pipe = importlib.import_module(f"{pkg}.data.pipeline").BatchPipeline
        splits = [load(mode, text=cfg.text, audio=cfg.audio, video=cfg.video,
                       normalize=cfg.normalize, log_scale=cfg.log_scale,
                       data_path=root) for mode in ("train", "valid", "test")]
        return [pipe(ds, batch_size=4, time_len=9, shuffle=mode == "train",
                     seed=3) for mode, ds in zip(("train", "valid", "test"),
                                                 splits)]
    return importlib.import_module(f"{pkg}.data.universal").get_data_loader(cfg)


def test_families_match_jax(tmp_path):
    """Every family's batches (the SDK family with words and with dense
    glove, AVEC2019 with random words and with dense text, the local
    family), two passes of each split, bit for bit against the JAX
    package's pipelines on fixtures that both packages' writers make from
    one seed (and that are byte-identical); AVEC's random words are drawn
    anew each pass. The dispatcher also routes raw against dense text as
    JAX does, and refuses an unknown dataset."""
    from mimrl_tpu.data.universal import uses_raw_text as jax_raw
    from mimrl_tpu_torch.data.universal import uses_raw_text

    with pytest.raises(ValueError, match="unknown dataset"):
        get_data_loader(config.MimrlConfig(dataset="nope"))
    for n, (dataset, flags, writer, args) in enumerate(FAMILIES):
        roots = {}
        for mod, pkg in ((synthetic, "mimrl_tpu_torch"), (jsyn, "mimrl_tpu")):
            roots[pkg] = str(tmp_path / f"{n}_{pkg}")
            getattr(mod, writer)(roots[pkg], n_per_split=(7, 3, 5), seed=n,
                                 **args)
        files = sorted(p.relative_to(roots["mimrl_tpu"]) for p in
                       (tmp_path / f"{n}_mimrl_tpu").rglob("*.pkl"))
        assert len(files) == 3
        for f in files:
            assert ((tmp_path / f"{n}_mimrl_tpu_torch" / f).read_bytes()
                    == (tmp_path / f"{n}_mimrl_tpu" / f).read_bytes()), f
        got = _family_loaders("mimrl_tpu_torch", config.MimrlConfig,
                              roots["mimrl_tpu_torch"], dataset, flags)
        want = _family_loaders("mimrl_tpu", jconfig.MimrlConfig,
                               roots["mimrl_tpu"], dataset, flags)
        assert tuple(got[3:]) == tuple(want[3:])
        cfg = config.MimrlConfig(dataset=dataset, **flags)
        raw = uses_raw_text(cfg)
        assert raw == jax_raw(jconfig.MimrlConfig(dataset=dataset, **flags))
        for g_pipe, w_pipe, n_split in zip(got[:3], want[:3], (7, 3, 5)):
            assert len(g_pipe) == len(w_pipe) == -(-n_split // 4)
            assert g_pipe.static_tensors == w_pipe.static_tensors
            for _pass in range(2):
                for g, w in zip(g_pipe, w_pipe):
                    assert sorted(g) == sorted(w)
                    assert ("text" in g) == (not raw)
                    assert ("bert_sentences" in g) == raw
                    for key in g:
                        if key != "labels":
                            np.testing.assert_array_equal(g[key], w[key],
                                                          err_msg=key)
                    assert len(g["labels"]) == len(w["labels"])
                    for gl, wl in zip(g["labels"], w["labels"]):
                        assert gl.dtype == wl.dtype
                        np.testing.assert_array_equal(gl, wl)
        avec_words = dataset == "avec2019" and raw
        assert got[0].static_tensors == (not avec_words)
        if avec_words:  # the two passes drew other words
            first, second = (got[0].next_epoch()[2][0] for _ in range(2))
            assert (first != second).any()


@pytest.mark.parametrize("name", sorted(_ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.random.default_rng(0).normal(scale=2.0, size=257).astype(np.float32)
    got = get_activation_fn(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_act(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
