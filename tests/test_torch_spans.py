"""The port's layer spans (``core/spans.py``) on the CPU.

With no profiler running a span is a shared null context and no record
function is made (a whole epoch runs with the record functions made to
raise). Under ``torch.profiler`` a tiny eager epoch of the Solver (3 train
batches of 8, 1 valid, 2 test, ``--stage1_n 2``, ``--num_workers 2``)
holds the spans nested as the layers are: the data copies inside the
stages, BERT, the kNN sampling and the optimizer inside the train step,
the MI bank inside the critic step; its ``sync/*`` spans are the host's
waits on the device that the code makes, counted by hand. A
``Predictor.forward`` holds its input copies and its model call. The mesh
and pipeline ranges keep their names (``mimrl/pipe_hop``,
``mimrl/grad_reduce``, ``mimrl/pipe_output``) on two gloo ranks.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mimrl_tpu_torch.core import spans
from mimrl_tpu_torch.core.config import parse_args
from mimrl_tpu_torch.data.synthetic import make_dec_fixture
from mimrl_tpu_torch.eval.predict import Predictor
from mimrl_tpu_torch.parallel import check
from mimrl_tpu_torch.train.solver import Solver

torch.set_num_threads(1)

N_TRAIN, N_VALID, N_TEST, BS = 21, 8, 11, 8
STAGE1_N = 2


def _argv(root):
    return ("--task_name spans --dataset mosi_Dec --normalize 0-1-1 "
            f"--batch_size {BS} --d_common 16 --time_len 12 "
            "--d_hiddens 12-3-16=4-3-16 --d_outs 12-3-16=4-3-16 "
            "--dropout_mlp 0.0-0.0-0.0 --dropout 0.1-0.1-0.1-0.1 --bias "
            f"--stage1_n {STAGE1_N} --epochs_num 2 --num_workers 2 "
            "--bert_layers 2 --bert_heads 2 --bert_hidden 32 "
            "--save_best_features "
            f"--data_dir {root}/data --task_dir {root}/runs --device cpu"
            ).split()


@pytest.fixture(scope="module")
def solver(tmp_path_factory):
    """A Solver after its epoch 0 (the bank is filled)."""
    root = str(tmp_path_factory.mktemp("spans"))
    make_dec_fixture(f"{root}/data", "mosi",
                     n_per_split=(N_TRAIN, N_VALID, N_TEST), d_audio=5,
                     d_video=20, max_len=15, seed=2)
    s = Solver(parse_args(_argv(root)), device="cpu")
    s.train(0)
    return s


def _epoch(s):
    s.train(1)
    s.evaluate(s.valid_loader)
    s.evaluate(s.test_loader)


def _spans(prof):
    """[(name without the prefix, start ns, end ns, thread)]."""
    return [(e.name()[len(spans.PREFIX):], e.start_ns(), e.end_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(spans.PREFIX)]


def _holds(got, outer, inner):
    """Every ``outer`` span (there is one at least) holds an ``inner`` span
    of its thread."""
    outers = [x for x in got if x[0] == outer]
    assert outers, f"no {outer}"
    for _, s, e, th in outers:
        assert any(x[0] == inner and x[3] == th and s <= x[1] and x[2] <= e
                   for x in got), f"a {outer} without {inner}"


def test_span_off_makes_no_record_function(solver, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a record function with no profiler running")

    monkeypatch.setattr(spans, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("a") is spans.span("b")
    _epoch(solver)


def test_epoch_spans_nest_as_the_layers(solver):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _epoch(solver)
    got = _spans(prof)
    names = {x[0] for x in got}
    assert {"solver/stage1", "solver/stage2", "solver/eval", "data/batch",
            "data/wait", "data/copy", "step/critic", "step/features",
            "step/train", "step/eval", "model/text", "mi/knn",
            "mi/estimates", "optim/step"} <= names, names
    for outer, inner in (
            ("solver/stage1", "data/batch"), ("solver/stage1", "data/copy"),
            ("solver/stage1", "step/critic"), ("solver/stage2", "data/wait"),
            ("solver/stage2", "data/copy"), ("solver/stage2", "step/train"),
            ("solver/eval", "data/batch"), ("solver/eval", "data/copy"),
            ("solver/eval", "step/eval"), ("step/critic", "mi/estimates"),
            ("step/critic", "mi/knn"), ("step/critic", "optim/step"),
            ("step/features", "model/text"), ("step/train", "model/text"),
            ("step/train", "mi/knn"), ("step/train", "mi/estimates"),
            ("step/train", "optim/step"), ("step/eval", "model/text")):
        _holds(got, outer, inner)
    # the main thread's spans; stage 2's batches are made on the prefetch
    # thread, which the profiler does not follow
    main = {x[3] for x in got if x[0] == "solver/stage1"}
    assert {x[3] for x in got} == main


def test_sync_spans_are_the_host_waits(solver):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _epoch(solver)
    syncs = collections.Counter(x[0] for x in _spans(prof)
                                if x[0].startswith("sync/"))
    nb, nv, nt = (len(solver.train_loader), len(solver.valid_loader),
                  len(solver.test_loader))
    assert (nb, nv, nt) == (3, 1, 2)
    # an eval split: each batch's outputs and its four features, the loss
    # and the MI channels; stage 2: its outputs, the loss, the MI channels
    assert syncs == {"sync/stage1_loss": STAGE1_N, "sync/stage1_end": 1,
                     "sync/stage2_end": 1, "sync/train_readback": nb + 2,
                     "sync/eval_readback": 5 * nv + 2 + 5 * nt + 2}


def test_predictor_forward_spans(solver):
    task = solver.task_path  # config.json is there
    torch.save(solver.model.state_dict(), f"{task}/best_valid_model.pt")
    pred = Predictor(task, device="cpu")
    batch = next(iter(pred.test_loader))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pred.forward(batch)
    assert out.shape == (BS, 1)
    got = _spans(prof)
    assert [x[0] for x in got if not x[0].startswith("model/")] == [
        "data/copy", "step/predict"]
    _holds(got, "step/predict", "model/text")


PIPE_BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=16)


def _mesh_spans(rank, device, n_rows):
    """One pipelined forward and backward of a tiny BERT on data 1 x pipe
    2, its gradients reduced, under the profiler: the span names."""
    from mimrl_tpu_torch.models.bert import BertConfig, BertModel
    from mimrl_tpu_torch.parallel import mesh as pmesh
    from mimrl_tpu_torch.parallel.pipeline import bert_forward_pipelined

    del rank, device
    torch.manual_seed(0)
    model = BertModel(BertConfig(**PIPE_BERT, flash_attn="off")).eval()
    mesh = pmesh.make_mesh(1, 1, 2)
    mesh.set_batch(n_rows)
    pmesh.shard_params(mesh, model)
    ids = torch.randint(0, PIPE_BERT["vocab_size"], (n_rows, 8))
    rows = pmesh.shard_batch(mesh, [ids, torch.zeros_like(ids),
                                    torch.ones_like(ids)])
    params = list(model.parameters())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = bert_forward_pipelined(model, mesh, *rows, n_microbatches=2,
                                   n_virtual=1, remat=False)
        grads = torch.autograd.grad(y.sum(), params, allow_unused=True)
        pmesh.reduce_gradients(mesh, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)], params)
    return sorted({x[0] for x in _spans(prof)})


def test_mesh_and_pipeline_ranges_keep_their_names(tmp_path):
    names = check.run_ranks(2, _mesh_spans, (4,), store_dir=str(tmp_path))
    assert {"pipe_hop", "grad_reduce", "pipe_output"} <= set(names), names
