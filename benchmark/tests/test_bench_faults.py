"""A run with the timed path broken underneath comes out not correct:
a step that leaves the state unchanged, half of the batch left out of the
mean, the attention's backward kernel returning half of dV, and an answer
altered where it is produced."""

import shutil

import pytest
import torch

from benchmark.tests import tiny

UNCHANGED = """
from mimrl_tpu_torch.train import optim
optim.ChainOptimizer.step = lambda self, grads: None
"""
HALF_BATCH = """
from mimrl_tpu_torch.train import steps
full = steps.compute_task_loss
def half(name, n, out, labels, mask=None):
    h = out.shape[0] // 2
    return full(name, n, out[:h], labels[:h], None if mask is None else mask[:h])
steps.compute_task_loss = half
"""
ATTENTION_BWD = """
from mimrl_tpu_torch.ops import flash_attention as fa
backward = fa._FlashAttention.backward
def half_dv(ctx, d_out):
    dq, dk, dv, *rest = backward(ctx, d_out)
    return (dq, dk, dv * 0.5, *rest)
fa._FlashAttention.backward = staticmethod(half_dv)
"""
ANSWER = """
from mimrl_tpu_torch.models import model as m
forward = m.MimrlModel.forward
def altered(self, *a, **k):
    out = forward(self, *a, **k)
    if self.training:
        return out
    return (out[0] + 0.5,) + tuple(out[1:])
m.MimrlModel.forward = altered
"""


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench"))
    tiny.make_copy(path)
    return path


@pytest.mark.parametrize("cell,fault", [
    ("tiny_mosi_bert_f32.train", UNCHANGED),
    ("tiny_mosi_bert_f32.train", HALF_BATCH),
    ("tiny_mosi_bert_f32.train", ATTENTION_BWD),
    ("tiny_mosi_bert_f32.train", ANSWER),
    ("tiny_mosi_bert_f32.serve", ANSWER)],
    ids=["unchanged", "half_batch", "attention_bwd", "answer_train",
         "answer_serve"])
def test_a_fault_is_not_correct(copy, cell, fault):
    rc, result, err = tiny.run_cell(copy, cell, seed=2_500_000_001,
                                    fault=fault)
    assert rc == 0, err[-3000:]
    assert not result["correct"], result["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes")


def _at_the_cells_own_size(tmp_path, cell, seed, fault):
    copy = str(tmp_path)
    shutil.copytree(tiny.BENCH, copy + "/benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT + "/BENCHMARK.json", copy)
    rc, result, err = tiny.run_cell(copy, cell, seed=seed, fault=fault,
                                    timeout=900, device=None)
    assert rc == 0, err[-3000:]
    print(cell, seed, {k: v["value"] for k, v in result["checks"].items()})
    assert not result["correct"], result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2_600_000_001, 2_600_000_002, 2_600_000_003])
@pytest.mark.parametrize("cell", ["mosi_bert_f32.train"])
def test_half_the_batch_fails_at_the_cells_own_size(card, tmp_path, cell,
                                                     seed):
    """The readings of the half-batch fault at the cell's own size, which
    the cell's limits must fail."""
    _at_the_cells_own_size(tmp_path, cell, seed, HALF_BATCH)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2_600_000_011, 2_600_000_012, 2_600_000_013])
@pytest.mark.parametrize("cell", ["mosi_bert_f32.train"])
def test_an_attention_backward_fault_fails_at_the_cells_own_size(
        card, tmp_path, cell, seed):
    """The attention's backward kernel returning half of dV (BERT's
    backward, the float32 instance) at the cell's own size: the cell's
    limits must fail it."""
    _at_the_cells_own_size(tmp_path, cell, seed, ATTENTION_BWD)
