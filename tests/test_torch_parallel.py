"""The port's mesh (``mimrl_tpu_torch/parallel/``) on the CPU.

``test_mesh_rules`` needs no process: mesh shapes and rank layout,
``batch_axes`` and ``shard_batch`` against ``mimrl_tpu.parallel.mesh`` on
the 8 virtual CPU devices, ``param_sharding_rule``'s decision on every
parameter of the tiny model (CubeMLP and MoE fusions) against JAX's rule
on the flax tree (through ``models/convert.py``'s map), and
``shard_params``'s blocks; for the pipeline, BERT whole and marked for the
sum over ``pipe``, the chunks against JAX's ``stack_layer_params`` order,
every stage's ticks (each unit once, a bank read one round after it was
written), and JAX's three ``ValueError``s.

``test_mesh_steps_and_cli`` starts gloo groups of CPU ranks, one group per
mesh shape, and runs ``parallel/check.py::equality_gap`` (one critic_step
+ train_step on the mesh against the port's unsharded step, from the same
weights, bank, batch and seeds) in each, at tiny shapes as
``tests/test_distributed.py``: bs 8, T 8, 4 BERT layers of width 64.

| what | against | limit |
| 2-rank data step, SGD, dropout on | unsharded | 1e-5 |
| the same, batch of 7 (not divisible: whole on every rank) | unsharded | 1e-5 |
| data 2 x model 2, --seq_shard (sequence parallel BERT), SGD | unsharded | 1e-5 |
| the same with dropout on | unsharded | 1e-5 |
| the same mesh step | JAX's step on make_mesh(2, 2, 1) | TOL (1e-4) |
| dcn 2 x data 2 | unsharded | 1e-5 |
| --fusion moe, model 2 | unsharded | 1e-5 |
| Adam in float64 on data 2 x model 2 | unsharded | 1e-6 |
| critic scores from data-sharded features | unsharded | 1e-4 |

The three fault controls of the data group (a rank skips one parameter's
gradient average; the average's division left out; a rank draws its
dropout rows from row 0) and the one of the --seq_shard step (the
row-parallel products' reduce-scatter without its sum) must miss 1e-5 by
more than tenfold.

``test_pipeline_steps`` does the same for the pipeline
(``parallel/pipeline.py``), at ``tests/test_pipeline.py``'s tiny BERT
(4 layers of width 16, bs 8, T 12) and at the steps' shapes above:

| what | against | limit |
| pipelined forward, dropout off: (data 1, pipe 2, M 2), (data 2, pipe 2, M 4, v 2), (data 1, pipe 4, M 4, remat) | the port's sequential BertModel | 2e-5 |
| the same forward | JAX's bert_forward_pipelined on make_mesh(data, 1, pipe) | 2e-5 |
| the same forwards in training mode, dropout on | the sequential BertModel | bit for bit |
| gradients of (data 2, pipe 2, M 4, v 2, remat) | the sequential stack | 5e-4 / 5e-3 (JAX's) |
| data 2 x pipe 2 x model 2, M 2, v 2, remat, SGD, dropout on | unsharded | 1e-5 |
| Adam in float64 on that mesh (GPipe, M 2) | unsharded | 1e-6 |

Its three fault controls (BERT's gradients not summed over pipe; the
output's cotangent summed over pipe; stage 0's bank read before it is
written, M = S) must miss 1e-5 by more than tenfold. BERT runs at the main
learning rate there, so the SGD update shows BERT's gradient. Then
``cli.main --distributed --device cpu --mesh_pipe 2 --pipe_microbatches
2`` over two ranks trains one epoch as below.

Then ``cli.main --distributed --device cpu`` under a two-rank torchrun
environment trains one epoch of test_torch_solver.py's run: rank 0 alone
writes (every ``torch.save``, ``np.save`` and log line of rank 1 is
counted: none), its scores agree with the single-process run's to 1e-3
relative (the float32 sums of the split batch differ in order; over an
epoch this tiny model moves a gap of 1e-7 into the 1e-5 range, as a 1e-7
relative perturbation of its weights does; the one-step gate above holds
1e-5), and its ``best_valid`` slot serves in ``Predictor`` and its
``latest`` slot resumes a single-process run.
"""

import json
import os

import numpy as np
import pytest
import torch

from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.mi.critics import CriticModel
from mimrl_tpu_torch.models.model import build_model, init_weights
from mimrl_tpu_torch.parallel import check
from mimrl_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

BS, T, D_A, D_V, D_C, VOCAB = 8, 8, 6, 4, 16, 128
N_BANK, N_VALID, K = 24, 20, 2
LIMIT, LIMIT_F64, LIMIT_SCORES = 1e-5, 1e-6, 1e-4
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_steps.py
DROP = dict(dropout=[0.1] * 4, dropout_mlp=[0.1] * 3, bert_dropout=0.1)
MOE = dict(fusion="moe", fusion_layers=1, fusion_heads=2, mesh_model=2,
           mesh_data=1)
TP = dict(mesh_data=2, mesh_model=2, seq_shard=True)


def _cfg_kw(**kw):
    base = dict(
        dataset="mosi_Dec", batch_size=BS, time_len=T, d_common=D_C,
        d_hiddens=[[T, 3, D_C], [4, 3, D_C]], d_outs=[[T, 3, D_C], [4, 3, D_C]],
        dropout_mlp=[0.0] * 3, dropout=[0.0] * 4, bias=True, bert_layers=4,
        bert_heads=2, bert_hidden=64, bert_dropout=0.0, k_neighbor=K,
        gradient_clip=1.5, bert_lr_rate=0.01, optm="SGD",
        loss_mi_coefficient1=[1.0] * 11, loss_mi_coefficient2=[0.01] * 8,
        moment_dtype="float32", flash_attn="off", fused_estimators=False)
    base.update(kw)
    return base


def _data(bs=BS, seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(bs, T)) > 0.3).astype(np.int64)
    mask[:, 0] = 1
    sample_mask = np.ones(bs, np.float32)
    sample_mask[-1] = 0.0  # a cycle-padded row
    batch = dict(
        bert_sentences=rng.integers(0, VOCAB, (bs, T)),
        bert_sentence_types=np.zeros((bs, T), np.int64),
        bert_sentence_att_mask=mask,
        audio=rng.normal(size=(bs, T, D_A)).astype(np.float32),
        video=rng.normal(size=(bs, T, D_V)).astype(np.float32),
        sample_mask=sample_mask)
    bank = dict(C=rng.normal(size=(N_BANK, 1)).astype(np.float32),
                **{f: rng.normal(size=(N_BANK, D_C)).astype(np.float32)
                   for f in "FTAV"})
    return batch, rng.normal(size=bs).astype(np.float32), bank


def _port_state(**kw):
    model = build_model(MimrlConfig(**_cfg_kw(**kw)), VOCAB, D_A, D_V, "cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    return model.state_dict()


# ---------------------------------------------------------------------- #


def test_mesh_rules():
    import jax
    import jax.numpy as jnp

    from mimrl_tpu.parallel import mesh as jmesh
    from mimrl_tpu_torch.models.convert import _flatten, _rules

    # shapes, the data=-1 rule and the assert
    assert pmesh.make_mesh(n_ranks=8).shape["data"] == 8
    m = pmesh.make_mesh(4, 2, n_ranks=8)
    assert (m.shape["data"], m.shape["model"]) == (4, 2)
    assert pmesh.make_mesh(-1, 2, n_ranks=8).shape["data"] == 4
    with pytest.raises(AssertionError, match="needs 16 devices"):
        pmesh.make_mesh(8, 2, n_ranks=8)
    # the rank layout is JAX's device layout; batch_axes and shard_batch
    host = {"x": np.arange(64.0).reshape(16, 4),
            "odd": np.ones((3, 4), np.float32)}
    for args in ((8, 1, 1, 1), (4, 2, 1, 1), (2, 2, 1, 2)):
        jm = jmesh.make_mesh(*args)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        sharded = jmesh.shard_batch(jm, host)
        for rank in range(8):
            pm = pmesh.make_mesh(*args, n_ranks=8, rank=rank)
            np.testing.assert_array_equal(pm.ranks, ids)
            assert pmesh.batch_axes(pm) == jmesh.batch_axes(jm)
            mine = pmesh.shard_batch(pm, host)
            shard = next(s for s in sharded["x"].addressable_shards
                         if s.device.id == rank)
            np.testing.assert_array_equal(mine["x"], np.asarray(shard.data))
            assert mine["odd"] is host["odd"]

    # the rule: every parameter of the tiny model against JAX's rule on
    # the flax tree, for the CubeMLP and the MoE fusions
    for fusion_kw in ({}, dict(fusion="moe", fusion_layers=1,
                               fusion_heads=2)):
        params_np = _jax_params(**fusion_kw)[0]
        port = build_model(MimrlConfig(**_cfg_kw(**fusion_kw)), VOCAB, D_A,
                           D_V, "meta")
        leaves = dict(_flatten(params_np))
        for shape in ((4, 2), (8, 1), (1, 4)):
            jm = jmesh.make_mesh(*shape)
            jrule = jmesh.param_sharding_rule(jm)
            pm = pmesh.make_mesh(*shape, n_ranks=8)
            specs = pmesh.param_specs(pm, port)
            seen, sharded = set(), 0
            for path, name, _ in _rules(params_np):
                keys = tuple(jax.tree_util.DictKey(k) for k in path)
                want = tuple(jrule(keys, jnp.asarray(leaves[path])).spec)
                got = specs[name]
                assert got + (None,) * (len(want) - len(got)) == want, name
                seen.add(name)
                sharded += pmesh.MODEL_AXIS in got
            assert seen == set(specs)
            assert (sharded > 0) == (shape[1] > 1)
        if fusion_kw:
            assert specs["mlp_encoder.moe_0.w1"] == ("model", None, None)
            assert specs["mlp_encoder.moe_0.router.weight"] == ()

    # shard_params: BERT's four dense kernels and the experts as blocks
    model = build_model(MimrlConfig(**_cfg_kw(**MOE)), VOCAB, D_A, D_V, "cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    pm = pmesh.make_mesh(1, 2, n_ranks=2, rank=1)
    held = pmesh.shard_params(pm, model)
    assert len(held) == 4 * 6 + 4, held
    for name in held:
        p = dict(model.named_parameters())[name]
        n = whole[name].shape[0] // 2
        assert pmesh.shard_dim(p) == 0
        torch.testing.assert_close(p.detach(), whole[name][n:], rtol=0,
                                   atol=0)
    assert all(pmesh.mesh_of(m) is pm for m in model.modules())

    # the pipe axis: BERT's layers stay whole on model and are marked for
    # the sum over pipe; the chunks are JAX's; the schedules' ticks; JAX's
    # three ValueErrors
    from mimrl_tpu.parallel.pipeline import stack_layer_params
    from mimrl_tpu_torch.parallel import pipeline

    model = build_model(MimrlConfig(**_cfg_kw(**MOE)), VOCAB, D_A, D_V, "cpu")
    held = pmesh.shard_params(pmesh.make_mesh(1, 2, 2, n_ranks=4, rank=3),
                              model)
    assert held and all("moe_" in name for name in held), held
    for name, p in model.named_parameters():
        assert pmesh.pipe_summed(p) == name.startswith("bertmodel."), name
    for L, S, v in ((4, 2, 1), (4, 2, 2), (4, 4, 1), (12, 2, 2), (12, 3, 1),
                    (12, 2, 3)):
        tree = {f"layer_{i}": {"w": np.full((1,), i)} for i in range(L)}
        want = np.asarray(stack_layer_params(tree, L, S * v)["w"])
        np.testing.assert_array_equal(
            pipeline.chunk_layers(L, S, v), want.reshape(v, S, L // (S * v)))
        for M in (S, S + 1, 2 * S):
            for stage in range(S):
                ticks = pipeline.rank_ticks(S, M, v, stage)
                assert len(ticks) == v * M + S - 1
                # each unit once, in order, at tick unit + stage
                units = [(t - stage,) + op[1:3] for t, ops in
                         enumerate(ticks) for op in ops if op[0] == "unit"]
                assert units == [(u, u % M, u // M) for u in range(v * M)]
                banked = {}
                for t, ops in enumerate(ticks):
                    for op in ops:
                        if op[0] == "bank":
                            banked[op[1]] = t - S  # the unit it keeps
                        elif stage == 0 and op[2] > 0:
                            # the previous round's unit of this microbatch
                            assert banked[op[1]] == t - M, (S, M, v, t)
    with pytest.raises(ValueError, match="not divisible by pipe"):
        pipeline.check_schedule(3, 2, 2, 1, 8, 2)
    with pytest.raises(ValueError, match="pipe_microbatches"):
        pipeline.check_schedule(4, 2, 3, 1, 8, 2)
    with pytest.raises(ValueError, match="interleaved schedule needs "
                       "pipe_microbatches>=2"):
        pipeline.check_schedule(4, 2, 1, 2, 8, 2)
    pipeline.check_schedule(4, 2, 2, 2, 8, 2)


# ---------------------------------------------------------------------- #


def _group(rank, device, shape, cases, state, data):
    """One mesh shape: every case's gap (and the mesh step's values where
    asked)."""
    mesh = pmesh.make_mesh(**shape)
    out = {}
    for name, cfg_kw, kw in cases:
        kw = dict(kw)
        keep = kw.pop("keep", False)
        bs = kw.pop("bs", BS)
        batch, labels, bank = data[bs]
        cfg = MimrlConfig(**_cfg_kw(batch_size=bs, **cfg_kw))
        gap, got, _ = check.equality_gap(
            cfg, mesh, state[cfg.fusion], batch, labels, bank, N_VALID,
            vocab=VOCAB, d_a=D_A, d_v=D_V, device=device, **kw)
        out[name] = {"gap": gap["abs"], "got": got if keep else None}
    if shape.get("data") == 2 and shape.get("model", 1) == 1:
        critic = CriticModel("separate", 4, 4, hidden_dim=16, embed_dim=8,
                             layers=1)
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in critic.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        x, y = (torch.randn(16, 4, generator=gen) for _ in range(2))
        out["scores"] = {"gap": check.critic_scores_gap(mesh, critic, x, y)}
    return out


def _cli_rank(rank, argv, env, out_dir):
    """One torchrun-style rank of ``cli.main --distributed``; records what
    it writes."""
    import logging

    from mimrl_tpu_torch.cli.main import main

    torch.set_num_threads(1)
    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    writes = []
    save = torch.save
    torch.save = lambda obj, f, *a, **k: (writes.append(str(f)),
                                          save(obj, f, *a, **k))[1]
    np_save = np.save
    np.save = lambda f, *a, **k: (writes.append(str(f)),
                                  np_save(f, *a, **k))[1]
    scores = main(argv)
    handlers = len(logging.getLogger("mimrl_torch").handlers)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"scores": scores, "writes": writes,
                   "handlers": handlers}, f)


def _cli_fixture(tmp_path) -> str:
    """test_torch_solver.py's run's data under ``tmp_path/cli``."""
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from test_torch_solver import N_TEST, N_TRAIN, N_VALID as NV

    root = str(tmp_path / "cli")
    make_dec_fixture(f"{root}/data", "mosi", n_per_split=(N_TRAIN, NV, N_TEST),
                     d_audio=5, d_video=20, max_len=15, seed=2)
    return root


def _distributed(tmp_path, root, tag, *flags):
    """``cli.main --distributed`` of test_torch_solver.py's run over two
    torchrun-style ranks: each rank's record (``_cli_rank``)."""
    import torch.multiprocessing as mp

    from mimrl_tpu_torch.cli.main import free_port
    from test_torch_solver import _argv

    env = dict(WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    out = tmp_path / tag
    out.mkdir()
    mp.start_processes(_cli_rank, args=(
        _argv(root, "--task_name", tag, "--distributed", *flags), env,
        str(out)), nprocs=2, start_method="spawn")
    return [json.load(open(out / f"rank{r}.json")) for r in (0, 1)]


def _close(got, want):
    """Scores within 1e-3 relative (or absolute)."""
    for g, w in zip(got, want):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-3, abs=1e-3), k


def _jax_params(**fusion_kw):
    """(numpy params of JAX's tiny model (``init_full``), its BertConfig,
    its model kwargs)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mimrl_tpu.models import bert as jbert
    from mimrl_tpu.models.model import MimrlModel as JaxModel, init_full

    cfg = MimrlConfig(**_cfg_kw())
    bert = dataclasses.replace(
        jbert.BertConfig.tiny(), vocab_size=VOCAB, hidden_size=64,
        num_hidden_layers=4, num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=512, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, flash_attn="off")
    kw = dict(d_t=768, d_a=D_A, d_v=D_V, d_common=D_C, time_len=T,
              d_hiddens=tuple(map(tuple, cfg.d_hiddens)),
              d_outs=tuple(map(tuple, cfg.d_outs)), dropout_mlp=(0.0,) * 3,
              dropout=(0.0,) * 4, bias=True, k_neighbor=K,
              fused_estimators=False, **fusion_kw)
    batch = _data()[0]
    inputs = [jnp.asarray(batch[k]) for k in (
        "bert_sentences", "bert_sentence_types", "bert_sentence_att_mask",
        "audio", "video")]
    params = init_full(JaxModel(bert_config=bert, **kw),
                       {"params": jax.random.PRNGKey(0)}, *inputs)["params"]
    return jax.tree_util.tree_map(np.asarray, params), bert, kw


def _jax_mesh_step(anchors_keys):
    """JAX's critic_step + train_step on make_mesh(2, 2, 1) with
    --seq_shard, from the weights of ``_jax_params()``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mimrl_tpu.core.config import MimrlConfig as JaxConfig
    from mimrl_tpu.models.model import MimrlModel as JaxModel
    from mimrl_tpu.parallel import mesh as jmesh
    from mimrl_tpu.train import optim as joptim
    from mimrl_tpu.train import steps as jsteps

    cfg = JaxConfig(**_cfg_kw(**TP))
    mesh = jmesh.make_mesh(2, 2, 1)
    params_np, bert, kw = _jax_params()
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    batch, labels, bank_np = _data()
    seq_bert = dataclasses.replace(bert, seq_sharding=NamedSharding(
        mesh, P(jmesh.DATA_AXIS, jmesh.MODEL_AXIS, None)))
    model = JaxModel(bert_config=seq_bert, **kw)
    main_p, bert_p, vmi_p = joptim.partition_params(params)
    opt_main = joptim.make_main_optimizer(cfg, main_p, bert_p)
    opt_vmi = joptim.make_vmi_optimizer(cfg)
    factory = jsteps.StepFactory(model, cfg, opt_main, opt_vmi, mesh=mesh)
    bank = jsteps.FeatureBank.create(N_BANK, N_VALID, D_C).replace(
        **{k: jnp.asarray(v) for k, v in bank_np.items()})
    sh = lambda t: jmesh.shard_params(mesh, t)  # noqa: E731
    jbatch = jmesh.shard_batch(mesh, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    jlabels = jnp.asarray(labels)
    new_vmi, _, l1, mis1 = factory.critic_step(
        sh(main_p), sh(bert_p), sh(vmi_p), opt_vmi.init(vmi_p), jbatch,
        jlabels, bank, anchors_keys[0])
    state = opt_main.init(joptim.merge_params(main_p, bert_p))
    new_bank = jsteps.FeatureBank.create(N_BANK, N_VALID, D_C)
    new_main, new_bert, _, l2, mis2, out, _ = factory.train_step(
        sh(main_p), sh(bert_p), new_vmi, state, jbatch, jlabels, bank,
        new_bank, 0, anchors_keys[1], use_mi=True)
    merged = joptim.merge_params(new_main, new_bert, new_vmi)
    return (params_np, jax.tree_util.tree_map(np.asarray, merged),
            {"critic_loss": l1, "critic_mis": mis1, "loss": l2, "mis": mis2,
             "out": out})


def test_mesh_steps_and_cli(tmp_path):
    import jax

    from mimrl_tpu_torch.cli.main import main
    from mimrl_tpu_torch.core.checkpoint import CheckpointManager
    from mimrl_tpu_torch.eval.predict import Predictor
    from mimrl_tpu_torch.models.convert import state_dict_from_jax
    from test_torch_steps import _jax_anchors

    keys = [jax.random.PRNGKey(5), jax.random.PRNGKey(6)]
    anchors = [_jax_anchors(jax.random.split(k)[1]) for k in keys]
    params0, jax_params, jax_vals = _jax_mesh_step(keys)
    cubemlp = build_model(MimrlConfig(**_cfg_kw()), VOCAB, D_A, D_V, "meta")
    state = {"cubemlp": state_dict_from_jax(params0, cubemlp),
             "moe": _port_state(**MOE)}
    data = {BS: _data(), 7: _data(bs=7, seed=1)}
    store = str(tmp_path)

    def group(world, shape, cases):
        return check.run_ranks(world, _group, (shape, cases, state, data),
                               store_dir=store)

    faults = {"skip_reduce": dict(faults={"skip_reduce": 3}),
              "no_scaling": dict(faults={"sum_gradients": True}),
              "dropout_rows": dict(faults={"dropout_from_zero": True})}
    dp = group(2, dict(data=2), [
        ("dropout_on", dict(mesh_data=2, **DROP), {}),
        ("not_divisible", dict(mesh_data=2, **DROP), dict(bs=7)),
        *[(name, dict(mesh_data=2, **DROP), kw)
          for name, kw in faults.items()]])
    tp = group(4, dict(data=2, model=2), [
        ("seq_shard", TP, dict(keep=True, anchors=anchors)),
        ("seq_shard_dropout", dict(TP, **DROP), {}),
        ("scatter_no_sum", TP, dict(faults={"scatter_no_sum": True})),
        ("adam_f64", dict(TP, optm="Adam"), dict(float64=True))])
    dcn = group(4, dict(data=2, dcn=2), [("dcn", dict(mesh_dcn=2), {})])
    moe = group(2, dict(data=1, model=2), [("moe", MOE, {})])
    gaps = {name: r["gap"] for g in (dp, tp, dcn, moe) for name, r in
            g.items()}
    for name in ("dropout_on", "not_divisible", "seq_shard",
                 "seq_shard_dropout", "dcn", "moe"):
        assert gaps[name] <= LIMIT, (name, gaps)
    assert gaps["adam_f64"] <= LIMIT_F64, gaps
    assert gaps["scores"] <= LIMIT_SCORES, gaps
    for name in list(faults) + ["scatter_no_sum"]:
        assert gaps[name] > 10 * LIMIT, (name, gaps)

    # the control for the order of summation (the limit on the card): the
    # unsharded step with the forward in two row blocks, dropout on
    cfg = MimrlConfig(**_cfg_kw(**DROP))
    args = (cfg, *data[BS], N_VALID, "cpu")
    ref = check.one_step(check.build(cfg, VOCAB, D_A, D_V, state["cubemlp"],
                                     "cpu"), *args)
    split = check.split_batch_step(check.build(
        cfg, VOCAB, D_A, D_V, state["cubemlp"], "cpu"), *args)
    assert 0 < check.absolute_gap(ref, split, {})["abs"] <= LIMIT
    # --seq_shard's: BERT's second products summed over two blocks of
    # their input axis (the row-parallel products' arithmetic)
    ksplit = check.ksplit_step(check.build(
        cfg, VOCAB, D_A, D_V, state["cubemlp"], "cpu"), cfg.replace(
            mesh_model=2), *args[1:])
    assert 0 < check.absolute_gap(ref, ksplit, {})["abs"] <= LIMIT
    # the row-parallel partial sums of bf16 inputs (models/bert.py's
    # _PartialSums, the form the card runs) against the float32 product
    # of the same values: the sums equal, the gradients within bf16's
    # rounding (2^-8 of the largest magnitude)
    from mimrl_tpu_torch.models import bert
    g = torch.Generator().manual_seed(3)
    h = torch.randn(4, 6, 64, generator=g).bfloat16().requires_grad_()
    w = torch.randn(32, 64, generator=g).requires_grad_()
    dy = torch.randn(4, 6, 32, generator=g)
    y = bert._partial_sums(h, w, torch.bfloat16)
    hf = h.detach().float().requires_grad_()
    wf = w.detach().bfloat16().float().requires_grad_()
    yf = torch.nn.functional.linear(hf, wf)
    assert y.dtype == torch.float32 and torch.equal(y, yf)
    for got_g, want_g in zip(torch.autograd.grad(y, (h, w), dy),
                             torch.autograd.grad(yf, (hf, wf),
                                                 dy.bfloat16().float())):
        gap = (got_g.float() - want_g).abs().max() / want_g.abs().max()
        assert 0 < gap <= 2.0 ** -8, gap

    # the data 2 x model 2 --seq_shard step against JAX's on its mesh
    got = tp["seq_shard"]["got"]
    for key, want in jax_vals.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want),
                                   err_msg=key, **TOL)
    tree = dict(params0)
    tree.update(jax_params)
    for name, want in state_dict_from_jax(tree, cubemlp).items():
        np.testing.assert_allclose(got[f"model/{name}"].numpy(),
                                   want.numpy(), err_msg=name, **TOL)

    # cli.main --distributed --device cpu over two gloo ranks
    from test_torch_solver import _argv

    root = _cli_fixture(tmp_path)

    def distributed(tag, *flags):
        return _distributed(tmp_path, root, tag, *flags)

    close = _close

    # one epoch on data 2 against the single-process epoch
    single = main(_argv(root, "--task_name", "single", "--epochs_num", "1"))
    ranks = distributed("dp", "--mesh_data", "2", "--epochs_num", "1")
    assert ranks[1]["writes"] == [] and ranks[1]["handlers"] == 0
    assert any(w.endswith("latest_model.pt.tmp") for w in ranks[0]["writes"])
    for r in ranks:
        close(r["scores"], single)
    log = open(f"{root}/runs/dp/Running.log").read()
    assert "Mesh: Mesh(dcn 1 x data 2 x pipe 1 x model 1, rank 0" in log
    assert "4 rows of 8 per rank" in log
    served = Predictor(f"{root}/runs/dp", device="cpu").evaluate_split("test")
    assert np.isfinite(served["mae"])
    # the single run's slot resumes on model 2 (BERT's kernels as blocks)
    # and that run's slot, of whole tensors, resumes unsharded
    again = main(_argv(root, "--task_name", "again", "--epochs_num", "2",
                       "--resume", f"{root}/runs/single"))
    ranks = distributed("tp", "--mesh_data", "1", "--mesh_model", "2",
                        "--epochs_num", "2", "--resume", f"{root}/runs/single")
    assert ranks[1]["writes"] == []
    close(ranks[0]["scores"], again)
    log = open(f"{root}/runs/tp/Running.log").read()
    # per layer q, k, v (the fused [32, 96] kernel) and the FFN's two;
    # the [32, 32] attention output is below the rule's 2048 elements
    assert "10 parameters held as blocks over model" in log
    assert "Resumed from" in log
    whole = CheckpointManager(f"{root}/runs/again").restore("latest")
    slot = CheckpointManager(f"{root}/runs/tp").restore("latest")
    assert slot["opt_main"]["sizes"] == whole["opt_main"]["sizes"]
    for name, t in whole["model"].items():
        assert slot["model"][name].shape == t.shape, name
    resumed = main(_argv(root, "--task_name", "resumed", "--epochs_num", "3",
                         "--resume", f"{root}/runs/tp"))
    assert all(np.isfinite(s["mae"]) for s in resumed)
    assert "Resumed from" in open(f"{root}/runs/resumed/Running.log").read()


# ---------------------------------------------------------------------- #
# The pipeline (parallel/pipeline.py)

# tests/test_pipeline.py's tiny BERT and data
PIPE_BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=4,
                 num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=16)
PIPE_BS, PIPE_T = 8, 12
# {(data, pipe): [(microbatches, virtual, remat), ...]}
PIPE_FORWARDS = {(1, 2): [(2, 1, False)], (2, 2): [(4, 2, False)],
                 (1, 4): [(4, 1, True)]}
PIPE_GRADS = (4, 2, True)  # on (2, 2), JAX's test_interleaved_grads_...
PIPE_GRAD_TOL = dict(atol=5e-4, rtol=5e-3)
PIPE_STEP = dict(mesh_data=2, mesh_pipe=2, mesh_model=2, pipe_microbatches=2,
                 bert_lr_rate=1.0, **DROP)
PIPE_FAULTS = {"no_pipe_sum": {"no_pipe_sum": True},
               "output_sum": {"output_sum": True},
               "bank_late": {"bank_late": True}}


def _pipe_data():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, PIPE_BERT["vocab_size"], (PIPE_BS, PIPE_T))
    types = np.zeros((PIPE_BS, PIPE_T), np.int64)
    mask = (np.arange(PIPE_T)[None, :]
            < rng.integers(4, PIPE_T + 1, (PIPE_BS, 1))).astype(np.int64)
    cot = np.random.default_rng(1).normal(
        size=(PIPE_BS, PIPE_T, PIPE_BERT["hidden_size"])).astype(np.float32)
    return ids, types, mask, cot


def _pipe_forwards(rank, device, shape, state):
    """One mesh shape's pipelined forwards (and on (2, 2) the gradients,
    on (1, 2) the hop): per schedule the eval-mode output of the global
    batch and its gap to the sequential stack, the gap of the
    training-mode output with dropout on."""
    from mimrl_tpu_torch.models.bert import BertConfig, BertModel
    from mimrl_tpu_torch.parallel.pipeline import bert_forward_pipelined

    ids, types, mask, cot = (torch.from_numpy(a) for a in _pipe_data())
    mesh = pmesh.make_mesh(shape[0], 1, shape[1])
    out = {}

    def bert(train):
        model = BertModel(BertConfig(**PIPE_BERT, flash_attn="off"))
        model.load_state_dict(state)
        return model.train(train)

    def pipelined(model, schedule, seed):
        M, v, remat = schedule
        mesh.set_batch(PIPE_BS)
        pmesh.shard_params(mesh, model)
        rows = pmesh.shard_batch(mesh, [ids, types, mask])
        torch.manual_seed(seed)
        return bert_forward_pipelined(
            model, mesh, *rows, n_microbatches=M, n_virtual=v, remat=remat,
            generator=torch.Generator().manual_seed(seed))

    for schedule in PIPE_FORWARDS[shape]:
        with torch.no_grad():
            want = bert(False)(ids, types, mask)
            got = pmesh.gather_rows(pipelined(bert(False), schedule, 0), mesh)
            seq = bert(True)
            torch.manual_seed(3)
            drop = seq(ids, types, mask, torch.Generator().manual_seed(3))
            got_drop = pmesh.gather_rows(pipelined(bert(True), schedule, 3),
                                         mesh)
        out[schedule] = dict(got=got.numpy(),
                             gap=float((got - want).abs().max()),
                             dropout_equal=torch.equal(got_drop, drop))
    if shape == (2, 2):
        seq = bert(False)
        want = torch.autograd.grad((seq(ids, types, mask) * cot).sum(),
                                   list(seq.parameters()))
        model = bert(False)
        params = list(model.parameters())
        y = pipelined(model, PIPE_GRADS, 0)
        grads = torch.autograd.grad(
            (y * pmesh.shard_batch(mesh, cot)).sum(), params,
            allow_unused=True)
        grads = pmesh.reduce_gradients(mesh, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)], params)
        n = mesh.size(pmesh.BATCH_AXES)  # the average of the rows' sums
        out["grads"] = [(name, (g * n).numpy(), w.numpy()) for
                        (name, _), g, w in zip(model.named_parameters(),
                                               grads, want)]
    if shape == (1, 2):
        x = torch.full((3,), rank + 1.0, requires_grad=True)
        y = pmesh.hop(x, mesh)
        y.backward(torch.full((3,), 10.0 * (rank + 1)))
        out["hop"] = (y.detach().tolist(), x.grad.tolist())
    return out


def _jax_pipelined(params, schedules):
    """JAX's ``bert_forward_pipelined`` of tests/test_pipeline.py's tiny
    BERT, eval mode, per (data, pipe, M, v, remat)."""
    import jax
    import jax.numpy as jnp

    from mimrl_tpu.models.bert import BertConfig as JaxBertConfig
    from mimrl_tpu.parallel.mesh import make_mesh
    from mimrl_tpu.parallel.pipeline import bert_forward_pipelined

    cfg = JaxBertConfig(**PIPE_BERT)
    ids, types, mask = (jnp.asarray(a, jnp.int32) for a in _pipe_data()[:3])
    out = {}
    for (data, pipe), (M, v, remat) in schedules:
        mesh = make_mesh(data, 1, pipe)
        out[(data, pipe), (M, v, remat)] = np.asarray(jax.jit(
            lambda p: bert_forward_pipelined(
                p, cfg, mesh, ids, types, mask, n_microbatches=M,
                n_virtual=v, remat=remat, deterministic=True))(params))
    return out


def test_pipeline_steps(tmp_path):
    import jax

    from mimrl_tpu.models.bert import BertConfig as JaxBertConfig
    from mimrl_tpu.models.bert import BertModel as JaxBertModel
    from mimrl_tpu_torch.cli.main import main
    from mimrl_tpu_torch.eval.predict import Predictor
    from mimrl_tpu_torch.models.bert import BertConfig, BertModel
    from mimrl_tpu_torch.models.convert import state_dict_from_jax

    # the tiny BERT's weights from JAX's init, in the port's names
    ids, types, mask, _ = _pipe_data()
    jparams = JaxBertModel(JaxBertConfig(**PIPE_BERT)).init(
        jax.random.PRNGKey(0), ids.astype(np.int32), types.astype(np.int32),
        mask.astype(np.int32))["params"]
    port = torch.nn.ModuleDict({"bertmodel": BertModel(BertConfig(
        **PIPE_BERT))})
    state = {k[len("bertmodel."):]: v for k, v in state_dict_from_jax(
        {"bertmodel": jax.tree_util.tree_map(np.asarray, jparams)},
        port).items()}
    store = str(tmp_path)

    got = {shape: check.run_ranks(shape[0] * shape[1], _pipe_forwards,
                                  (shape, state), store_dir=store)
           for shape in PIPE_FORWARDS}
    jax_out = _jax_pipelined(jparams, [(shape, sch) for shape, schedules in
                                       PIPE_FORWARDS.items()
                                       for sch in schedules])
    for shape, schedules in PIPE_FORWARDS.items():
        for sch in schedules:
            r = got[shape][sch]
            assert r["gap"] <= 2e-5, (shape, sch, r["gap"])
            np.testing.assert_allclose(r["got"], jax_out[shape, sch],
                                       atol=2e-5, rtol=2e-5)
            assert r["dropout_equal"], (shape, sch)
    for name, g, w in got[(2, 2)]["grads"]:
        np.testing.assert_allclose(g, w, err_msg=name, **PIPE_GRAD_TOL)
    # rank 0 takes rank 1's value, and rank 1's gradient back
    assert got[(1, 2)]["hop"] == ([2.0] * 3, [20.0] * 3)

    # one critic_step + train_step on data 2 x pipe 2 x model 2
    step_state = {"cubemlp": _port_state(**PIPE_STEP)}
    cases = [("sgd", dict(PIPE_STEP, pipe_virtual=2, pipe_remat=True), {}),
             ("adam_f64", dict(PIPE_STEP, optm="Adam"), dict(float64=True))]
    cases += [(name, dict(PIPE_STEP, pipe_virtual=2), dict(faults=spec))
              for name, spec in PIPE_FAULTS.items()]
    gaps = {name: r["gap"] for name, r in check.run_ranks(
        8, _group, (dict(data=2, pipe=2, model=2), cases, step_state,
                    {BS: _data()}), store_dir=store).items()}
    assert gaps["sgd"] <= LIMIT, gaps
    assert gaps["adam_f64"] <= LIMIT_F64, gaps
    for name in PIPE_FAULTS:
        assert gaps[name] > 10 * LIMIT, (name, gaps)

    # cli.main --distributed --device cpu --mesh_pipe 2 over two gloo ranks
    from test_torch_solver import _argv

    root = _cli_fixture(tmp_path)
    single = main(_argv(root, "--task_name", "single", "--epochs_num", "1"))
    ranks = _distributed(tmp_path, root, "pipe", "--mesh_data", "1",
                         "--mesh_pipe", "2", "--pipe_microbatches", "2",
                         "--epochs_num", "1")
    assert ranks[1]["writes"] == [] and ranks[1]["handlers"] == 0
    assert any(w.endswith("latest_model.pt.tmp") for w in ranks[0]["writes"])
    for r in ranks:
        _close(r["scores"], single)
    log = open(f"{root}/runs/pipe/Running.log").read()
    assert "Mesh: Mesh(dcn 1 x data 1 x pipe 2 x model 1, rank 0" in log
    assert "pipeline 2 stages x 2 microbatches, virtual 1, remat off" in log
    served = Predictor(f"{root}/runs/pipe", device="cpu").evaluate_split(
        "test")
    assert np.isfinite(served["mae"])
