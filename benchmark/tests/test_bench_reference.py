"""The benchmark's plain reference against the system's CPU path at tiny
sizes, the sound tiny runs, and (on the card) the controls that the limits
were set against."""

import json
import statistics

import pytest
import torch

from benchmark import fixture, harness
from benchmark.reference import data as rdata
from benchmark.reference import model as M
from benchmark.reference import train as rtrain
from benchmark.reference.rng import Draws, attention_keep
from benchmark.tests import tiny

TINY = {"--batch_size": 4, "--time_len": 12, "--d_common": 32,
        "--bert_hidden": 32, "--bert_layers": 2, "--bert_heads": 2,
        "--bert_intermediate": 64, "--dropout": "0.1-0.1-0.1-0.1",
        "--dropout_mlp": "0.0-0.0-0.0", "--d_hiddens": "6-3-32=4-3-32",
        "--d_outs": "6-3-32=4-3-32", "--res_project": "1-1", "--bias": True,
        "--k_neighbor": 2, "--loss_mi_coefficient1": "1-1-1-1-1-1-1-1-1-1-1",
        "--loss_mi_coefficient2": "0.01-0.01-0.01-0.01-0.01-0.01-0.01-0.01",
        "--gradient_clip": 1.5, "--learning_rate": 4e-3,
        "--bert_lr_rate": 0.01, "--stage1_n": 2}


def _model_and_batch(seed=3):
    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.models.model import build_model
    spec = M.Spec(TINY, 5, 20)
    flags = dict(TINY, **{"--dataset": "mosi_Dec", "--encoders": "gru",
                          "--activate": "gelu"})
    model = build_model(parse_args(harness.flag_argv(flags)), 30522, 5, 20,
                        "cpu")
    weights = harness.make_weights(M.param_shapes(spec), seed, "cpu")
    model.load_state_dict(weights, strict=True)
    g = torch.Generator().manual_seed(seed)
    bs, T = 4, 12
    ids = torch.randint(5, 30522, (bs, T), generator=g)
    mask = torch.ones(bs, T, dtype=torch.long)
    mask[:, 9:] = 0
    lengths = torch.tensor([12, 3, 7, 10])
    audio = torch.randn(bs, T, 5, generator=g)
    video = torch.randn(bs, T, 20, generator=g)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0
        video[b, n:] = 0
    batch = {"bert_sentences": ids, "bert_sentence_types": torch.zeros_like(ids),
             "bert_sentence_att_mask": mask, "audio": audio, "video": video}
    return spec, model, weights, batch


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_system(train):
    from mimrl_tpu_torch.models.model import forward_batch
    spec, model, weights, batch = _model_and_batch()
    model.train(train)
    torch.manual_seed(11)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        got = forward_batch(model, batch, generator=g if train else None)
        want = M.forward(weights, spec, batch,
                         Draws("cpu", 11) if train else None)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_attention_mask_is_the_systems():
    from mimrl_tpu_torch.ops.philox import dropout_keep_mask
    seed = torch.tensor([123456789012], dtype=torch.int64)
    assert torch.equal(attention_keep(seed, 2, 3, 9, 0.1),
                       dropout_keep_mask(seed, 2, 3, 9, 9, 0.1))


def test_estimates_match_the_systems_bank():
    from mimrl_tpu_torch.train.steps import FeatureBank, sample_all_knn
    spec, model, weights, batch = _model_and_batch(5)
    g = torch.Generator().manual_seed(2)
    feats = [torch.randn(4, 32, generator=g) for _ in range(4)]
    labels = torch.randn(4, generator=g)
    bank = FeatureBank(12, 10, 32)
    for t in bank.tensors():
        t.copy_(torch.randn(t.shape, generator=g))
    own = torch.Generator().manual_seed(9)
    knn = sample_all_knn(own, bank, 4, 2, 1.0)
    got_mi, got_loss = model.compute_vmi_loss_stage1(labels, *feats, knn)
    ref_bank = {f: getattr(bank, f) for f in "CFTAV"}
    ref_bank["valid"] = bank.valid
    draws = Draws("cpu", default_state=torch.get_rng_state(),
                  own_state=torch.Generator().manual_seed(9).get_state())
    ref_knn = M.knn_all(ref_bank, spec, draws)
    for k in M.CMI_KEYS:
        for a, b in zip(knn[k], ref_knn[k]):
            assert torch.equal(a, b)
    est = M.estimates(weights, spec, labels, *feats, ref_knn)
    for i, k in enumerate(M.VMI_KEYS + M.CMI_KEYS):
        torch.testing.assert_close(got_mi[i], est[k][0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_loss[i], est[k][1], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_sound_tiny_run_is_correct(tmp_path, kind):
    copy = str(tmp_path)
    tiny.make_copy(copy)
    rc, result, err = tiny.run_cell(copy, f"tiny_mosi_bert_f32.{kind}",
                                    seed=2_300_000_017)
    assert rc == 0, err[-3000:]
    assert result["correct"], err[-3000:]
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs the system's "
                    "kernels or TF32, which the CPU has not")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["mosi_bert_f32.train",
                                  "mosi_bert_f32.serve"])
def test_the_control_fails_the_limits(card, cell, capsys):
    """The configuration's control (the reference in TF32 for float32) in
    the system's place, at the cell's own size: its readings fail the
    cell's limits."""
    for seed in (2_400_000_001, 2_400_000_002, 2_400_000_003):
        assert harness.main(["--workload", cell, "--seed", str(seed),
                             "--seconds", "1", "--control", "1"]) == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert not result["correct"], result["checks"]


@pytest.mark.gpu
def test_bf16_rounding_witness(card):
    """The plain reference in bfloat16 (autocast) against itself in float32
    on eight MOSEI test batches at the bfloat16 configuration's sizes, with
    CubeMLP's K-mix biases at zero and at the configuration's
    ``weights_fixed``: rounding alone parts the outputs as far as the
    system's bfloat16 path at zero biases, and the fixed biases, which keep
    the LayerNorm over the three modalities from near-equal values, narrow
    the median gap over the seeds (not each seed's: BERT's bfloat16
    rounding stays)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = harness.load("configs", "mosei_bert_bf16")
    ds = cfg["dataset"]
    spec = M.Spec(cfg["flags"], ds["d_audio"], ds["d_video"])
    gaps = {}
    for seed in (2_300_000_021, 2_300_000_022, 2_300_000_023,
                 2_300_000_031, 2_300_000_032, 2_300_000_033):
        split = rdata.Split(fixture.utterances(ds, seed)["test"], spec.T,
                            spec.vocab)
        idx, mask = rdata.plan(split.n, spec.bs, 0, False)
        batches = [split.batch(idx[i], mask[i], "cuda") for i in range(8)]
        for fixed in ("zero", "fixed"):
            P = harness.make_weights(M.param_shapes(spec), seed, "cuda",
                                     cfg["weights_fixed"] if fixed == "fixed"
                                     else None)
            ref = rtrain.outputs(P, spec, batches)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                low = [o.float() for o in rtrain.outputs(P, spec, batches)]
            a, b = torch.cat(low), torch.cat(ref)
            gaps[seed, fixed] = (
                max(float((x - y).abs().max() / y.square().mean().sqrt())
                    for x, y in zip(low, ref)),
                float((a - b).square().mean().sqrt()
                      / b.square().mean().sqrt()))
            print(f"witness seed {seed} {fixed}: widest {gaps[seed, fixed][0]!r}"
                  f" rms {gaps[seed, fixed][1]!r}", flush=True)
    seeds = {k[0] for k in gaps}
    assert max(gaps[s, "zero"][0] for s in seeds) > 0.1

    def median(fixed):
        return statistics.median(gaps[s, fixed][1] for s in seeds)

    assert median("fixed") < 0.5 * median("zero")
