"""The benchmark's operation and byte counts against hand-worked values."""

import pytest

from benchmark import counts

CANON = {"--batch_size": 128, "--time_len": 100, "--d_common": 128,
         "--bert_hidden": 768, "--bert_layers": 12, "--bert_intermediate": 3072,
         "--d_hiddens": "50-3-128=10-3-128", "--d_outs": "50-3-128=10-3-128",
         "--stage1_n": 2}


def test_bert_dense_products_per_token():
    # 12 x (4 * 768^2 + 2 * 768 * 3072) multiply-adds: 2 x 84.93 MFLOP
    assert counts.bert_dense_macs_per_token(768, 3072, 12) == 84_934_656


@pytest.mark.parametrize("dtype,backward,ms", [
    ("bfloat16", False, 0.02349), ("bfloat16", True, 0.04110),
    ("float32", False, 0.04697), ("float32", True, 0.08219)])
def test_attention_bound_by_bytes(dtype, backward, ms):
    # [128, 12, 100, 64]: bf16 q, k, v, o = 4 x 19.66 MB plus the 51 kB mask
    # bias over 3.35 TB/s is 0.0235 ms; the backward's 7 tensors 0.0411
    got = counts.attention_bound_s((128, 12, 100, 64), dtype, backward) * 1e3
    assert got == pytest.approx(ms, rel=2e-4)


def test_attention_bound_by_operations_at_long_sequences():
    # T 2048: bf16 2 products of 2 * bs * nh * T^2 * hd over 989 TFLOP/s
    shape = (1, 12, 2048, 64)
    ops = 2 * 2 * 12 * 2048 ** 2 * 64
    assert counts.attention_bound_s(shape, "bfloat16", False) == pytest.approx(
        ops / 989e12)
    # float32 at 3xTF32 on the tensor cores, faster than the FP32 pipes
    assert counts.attention_bound_s(shape, "float32", False) == pytest.approx(
        3 * ops / 495e12)


def test_model_macs_by_part():
    m = counts.model_macs(CANON, 5, 20)
    tokens = 128 * 100
    assert m["bert"] == tokens * (84_934_656 + 12 * 2 * 100 * 768)
    gru = 2 * tokens * 3 * 128 * ((5 + 128) + (256 + 128) + (20 + 128)
                                   + (256 + 128))
    # CubeMLP block 0 on [128, 100, 3, 128]: L 100->50->50 (+ 100->50
    # residual) over 128 * 3 * 128 rows, K 3->3->3 (+3) over 128 * 50 * 128,
    # D 128->128->128 (+128) over 128 * 50 * 3; block 1 likewise from L 50
    cube = (128 * 3 * 128 * (100 * 50 + 50 * 50 + 100 * 50)
            + 128 * 50 * 128 * (9 + 9 + 9)
            + 128 * 50 * 3 * (3 * 128 * 128)
            + 128 * 3 * 128 * (50 * 10 + 10 * 10 + 50 * 10)
            + 128 * 10 * 128 * 27
            + 128 * 10 * 3 * (3 * 128 * 128))
    assert m["towers"] == tokens * 768 * 128 + gru + cube + 128 * 128
    critic = 2 * 128 * (128 * 256 + 2 * 256 * 256 + 256 * 128) + 128 * 128 * 128
    assert m["critics"] == 5 * critic
    assert m["classifiers"] == 6 * 2 * 128 * (384 * 256 + 2 * 256 * 256 + 512)


def test_epoch_flops_compose_the_stages():
    m = counts.model_macs(CANON, 5, 20)
    fwd, bank = m["bert"] + m["towers"], m["critics"] + m["classifiers"]
    want = 2 * (2 * 11 * (fwd + 3 * bank) + 11 * 3 * (fwd + bank)
                + 8 * (fwd + bank))
    assert counts.train_epoch_flops(CANON, 5, 20, 11, 8) == want
    assert counts.serve_batch_flops(CANON, 5, 20) == 2 * fwd
