"""The port's optimizer chain and schedules against the JAX package's
(optax): three steps from the same parameters and the same gradients, made
with numpy from a seed, for Adam and SGD, with value clipping, weight
decay, ``bert_lr_rate``, the 'part' freeze and both ``moment_dtype``s.

Tolerances: float32 moments 1e-6 (elementwise reassociation and the bias
correction computed in another precision); bf16 moments 2e-5 on parameters
whose updates are of order ``learning_rate`` = 4e-3: both sides compute
``b1 * m`` in bf16, but a float32 sum one ulp apart can round the stored
moment to the next bf16 value (2^-8 relative) in later steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from mimrl_tpu.core.config import MimrlConfig as JaxConfig
from mimrl_tpu.train import optim as joptim
from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.train import optim

torch.set_num_threads(1)

SHAPES = {
    # JAX tree path -> (port name, shape)
    ("W_t", "kernel"): ("W_t.weight", (6, 4)),
    ("classifier", "bias"): ("classifier.bias", (3,)),
    ("bertmodel", "embeddings", "w"): ("bertmodel.embeddings.w", (5, 4)),
    ("bertmodel", "layer_3", "w"): ("bertmodel.encoder.layer.3.w", (4, 4)),
    ("bertmodel", "layer_8", "w"): ("bertmodel.encoder.layer.8.w", (4, 4)),
    ("bertmodel", "layer_9", "w"): ("bertmodel.encoder.layer.9.w", (4, 4)),
    ("bertmodel", "layer_11", "w"): ("bertmodel.encoder.layer.11.w", (4, 4)),
}


def _tree(values):
    tree = {}
    for path, v in values.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(v)
    return tree


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _values(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {p: (scale * rng.normal(size=s)).astype(np.float32)
            for p, (_, s) in SHAPES.items()}


KW = dict(learning_rate=4e-3, gradient_clip=1.5, weight_decay=0.01,
          bert_lr_rate=0.01, bert_freeze="part")


@pytest.mark.parametrize("optm,moment_dtype,tol", [
    ("Adam", "float32", 1e-6), ("Adam", "bfloat16", 2e-5),
    ("SGD", "float32", 1e-6), ("SGD", "bfloat16", 2e-5)])
def test_main_optimizer_matches_optax(optm, moment_dtype, tol):
    kw = dict(KW, optm=optm, moment_dtype=moment_dtype)
    jcfg, cfg = JaxConfig(**kw), MimrlConfig(**kw)
    start = _values(0)
    grads = [_values(s, scale=2.0) for s in (1, 2, 3)]  # some beyond the clip

    jparams = _tree(start)
    jmain, jbert, _ = joptim.partition_params(jparams)
    jopt = joptim.make_main_optimizer(jcfg, jmain, jbert)
    state = jopt.init(jparams)
    step = jax.jit(lambda g, s, p: jopt.update(g, s, p))
    for g in grads:
        updates, state = step(_tree(g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    params = {name: nn.Parameter(torch.from_numpy(start[path].copy()))
              for path, (name, _) in SHAPES.items()}
    main = {n: p for n, p in params.items() if not n.startswith("bert")}
    bert = {n: p for n, p in params.items() if n.startswith("bert")}
    opt = optim.make_main_optimizer(cfg, main, bert)
    order = list(main) + list(bert)
    by_name = {name: path for path, (name, _) in SHAPES.items()}
    for g in grads:
        opt.step([torch.from_numpy(g[by_name[n]]) for n in order])

    for path, (name, _) in SHAPES.items():
        np.testing.assert_allclose(params[name].detach().numpy(),
                                   _leaf(jparams, path), rtol=0, atol=tol,
                                   err_msg=name)
    # 'part' freezes encoder layers 0-8 and nothing else
    for path, (name, _) in SHAPES.items():
        moved = not np.array_equal(params[name].detach().numpy(), start[path])
        frozen = name.startswith("bertmodel.encoder.layer.") and int(
            name.split(".")[3]) <= 8
        assert moved != frozen, name
    assert opt.mu.dtype == getattr(torch, moment_dtype)


def test_vmi_optimizer_matches_optax():
    kw = dict(learning_rate=4e-3, gradient_clip=1.0, mi_lr_rate=0.5,
              moment_dtype="bfloat16")
    jcfg, cfg = JaxConfig(**kw), MimrlConfig(**kw)
    rng = np.random.default_rng(4)
    start = rng.normal(size=(7, 5)).astype(np.float32)
    grads = [rng.normal(size=(7, 5)).astype(np.float32) for _ in range(3)]
    jparams = {"vmi_estimator_f_t": {"w": jnp.asarray(start)}}
    jopt = joptim.make_vmi_optimizer(jcfg)
    state = jopt.init(jparams)
    for g in grads:
        updates, state = jopt.update(
            {"vmi_estimator_f_t": {"w": jnp.asarray(g)}}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    p = nn.Parameter(torch.from_numpy(start.copy()))
    opt = optim.make_vmi_optimizer(cfg, {"vmi_estimator_f_t.w": p})
    assert opt.learning_rate == pytest.approx(2e-3)
    for g in grads:
        opt.step([torch.from_numpy(g)])
    np.testing.assert_allclose(p.detach().numpy(),
                               np.asarray(jparams["vmi_estimator_f_t"]["w"]),
                               rtol=0, atol=2e-5)


def test_injected_learning_rate_takes_effect():
    cfg = MimrlConfig(learning_rate=1e-2, gradient_clip=0.0, optm="SGD",
                      moment_dtype="float32")
    p = nn.Parameter(torch.zeros(3))
    opt = optim.make_vmi_optimizer(cfg, {"vmi_x.w": p})
    opt.step([torch.ones(3)])
    opt.learning_rate = 1e-3
    # the rate is a tensor on the parameters' device that the step reads
    # (a CUDA graph replays the step with the rate of its epoch)
    assert opt._neg_lr.device == p.device and opt._neg_lr.item() == pytest.approx(-1e-3)
    opt.step([torch.zeros(3)])  # momentum 0.9 of the first gradient
    torch.testing.assert_close(p.detach(), torch.full((3,), -1e-2 - 0.9e-3))


def test_partition_is_by_top_level_name():
    model = nn.Module()
    for name in ("bertmodel", "W_t", "vmi_estimator_f_t", "vcmi_estimator_ac_t",
                 "classifier"):
        setattr(model, name, nn.Linear(2, 2))
    main, bert, vmi = optim.partition_params(model)
    assert set(main) == {"W_t.weight", "W_t.bias", "classifier.weight",
                         "classifier.bias"}
    assert set(bert) == {"bertmodel.weight", "bertmodel.bias"}
    assert len(vmi) == 4
    want = joptim.partition_params({n: 0 for n, _ in model.named_children()})
    assert [sorted(d) for d in want] == [
        ["W_t", "classifier"], ["bertmodel"],
        ["vcmi_estimator_ac_t", "vmi_estimator_f_t"]]


def test_sam_raises_as_in_the_reference():
    with pytest.raises(NotImplementedError, match="SAM"):
        optim.make_vmi_optimizer(MimrlConfig(optm="SAM"),
                                 {"vmi_x.w": nn.Parameter(torch.zeros(1))})


@pytest.mark.parametrize("kind,iters", [("step", "3"), ("multi_step", "2-5"),
                                        ("exp", "1"), ("plateau", "1")])
def test_lr_scheduler_matches_jax(kind, iters):
    kw = dict(lr_decrease=kind, lr_decrease_iter=iters, lr_decrease_rate=0.5)
    js, ps = joptim.LRScheduler(JaxConfig(**kw)), optim.LRScheduler(MimrlConfig(**kw))
    losses = [1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7, 0.8]
    for loss in losses:
        assert ps.step(loss) == js.step(loss)
    assert ps.needs_metric == js.needs_metric == (kind == "plateau")
    assert ps.factor < 1.0
    if kind == "plateau":
        _plateau_on_the_device_matches_jax(iters)


def _plateau_on_the_device_matches_jax(iters):
    """``PlateauState`` (``--epoch_group``'s schedule on the device) over a
    seeded sequence of float32 valid-loss sums of 3 batches, with ties,
    against the JAX package's schedule stepped on ``float(sum) / 3``: the
    same factor after every epoch, exactly, and rates written on the
    device equal to the host setter's; its state equals the port's host
    schedule's after the same steps. Both modes (regression: min,
    classification: max), a factor of 0.1 (inexact products)."""
    rng = np.random.default_rng(5)
    sums = rng.normal(3.0, 0.2, size=12).astype(np.float32)
    sums[[4, 9]] = sums[[3, 8]]  # ties do not count as better
    for task in ("regression", "classification"):
        kw = dict(task=task, lr_decrease="plateau", lr_decrease_iter=iters,
                  lr_decrease_rate=0.1)
        js = joptim.LRScheduler(JaxConfig(**kw))
        ps = optim.LRScheduler(MimrlConfig(**kw))
        dev = optim.PlateauState(ps, "cpu")
        params = [nn.Parameter(torch.zeros(2))]
        on_dev, on_host = (optim.ChainOptimizer(MimrlConfig(), params)
                           for _ in range(2))
        for epoch, loss_sum in enumerate(sums, 1):
            want = js.step(float(loss_sum) / 3)
            ps.step(float(loss_sum) / 3)
            got = dev.step(torch.tensor(loss_sum), 3)
            assert got.dtype == torch.float64 and got.item() == want
            on_dev.learning_rate_from(got * 4e-3)
            on_host.learning_rate = 4e-3 * want
            assert torch.equal(on_dev._neg_lr, on_host._neg_lr)
            values = {k: v.numpy() for k, v in dev.values().items()}
            assert dev.state_dict(values, epoch) == ps.state_dict()
        assert js.factor < 0.05  # decayed at least twice
