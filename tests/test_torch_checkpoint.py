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

import json
import os
import shutil
import unittest.mock

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
from mimrl_tpu_torch import native
from mimrl_tpu_torch.core import flax_msgpack, orbax_slot
from mimrl_tpu_torch.core.checkpoint import CheckpointManager
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
    _reads_mimrl_tpu_orbax_slots(tmp_path, cfg, state, want, jax_preds)
    _resumes_a_mimrl_tpu_latest(tmp_path, data, monkeypatch)


def _same_jax_tree(got, want):
    """Bit-equal JAX trees (arrays by dtype and bytes, scalars by value)."""
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert (g.dtype, g.shape, g.tobytes()) == (w.dtype, w.shape, w.tobytes())


def _zstd_frames():
    """(name, content, frame) for the decoder's check: levels 1, 3, 19
    and -5; 0 B, 1 B, 1 KB, 200 KB (several blocks) and 5 MB; random and
    repetitive data; with and without the content checksum."""
    import zstandard

    rng = np.random.default_rng(5)
    contents = {"0B": b"", "1B": b"\x07"}
    for n, tag in ((1024, "1KB"), (200_000, "200KB"), (5_000_000, "5MB")):
        contents[f"random{tag}"] = rng.bytes(n)
        contents[f"repetitive{tag}"] = (b"mimrl %d " * n)[:n]
    for name, content in contents.items():
        for level in (1, 3, 19, -5):
            for checksum in (False, True):
                frame = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum).compress(content)
                yield f"{name}/{level}/{checksum}", content, frame


def _reads_mimrl_tpu_orbax_slots(tmp_path, cfg, state, want, jax_preds):
    """``mimrl_tpu``'s ``--ckpt_backend orbax`` slot of the same state:
    the port's reader returns the msgpack reader's tree bit for bit (also
    with arrays over several chunks), ``Predictor`` serves it, orbax
    restores the port's writer's directory bit for bit, the committed
    fixture matches its leaf list and JAX's restore, faults raise by name,
    the sidecar picks between two formats as JAX does, and the native
    zstd decoder equals ``zstandard``."""
    import orbax.checkpoint as ocp

    run_o = str(tmp_path / "run_orbax")
    jax_o = JaxCheckpointManager(run_o, backend="orbax")
    jax_o.save_config(cfg.to_json())
    jax_o.save("best_valid", state)
    jax_o.wait_until_finished()
    slot_dir = f"{run_o}/best_valid_model.orbax"
    decoded = native.calls["zstd"]
    _assert_same_tree(orbax_slot.read(slot_dir), want)
    assert native.calls["zstd"] > decoded

    # arrays over several chunks (ragged at the edges of a 2 KB chunk)
    chunked_dir = str(tmp_path / "orbax_chunked")
    checkpointer = ocp.AsyncCheckpointer(ocp.StandardCheckpointHandler())
    checkpointer.save(chunked_dir, args=ocp.args.StandardSave(
        state, save_args=jax.tree_util.tree_map(
            lambda _: ocp.SaveArgs(chunk_byte_size=2048), state)))
    checkpointer.wait_until_finished()
    names = {k.split(b"/")[0] for k in orbax_slot.read_kv(chunked_dir)
             if k.endswith(b"/1.0") or k.endswith(b"/1")}
    assert len(names) > 10
    _assert_same_tree(orbax_slot.read(chunked_dir), want)

    # the port's Predictor serves the orbax-only run directory
    assert {f for f in os.listdir(run_o) if not f.endswith(".json")} == {
        "best_valid_model.orbax"}
    predictor = Predictor(run_o, device="cpu")
    preds, _ = predictor.predict_loader(predictor.test_loader)
    np.testing.assert_allclose(preds, jax_preds, rtol=1e-4, atol=1e-4)

    # the writer's directories (zstd frames of Raw blocks, or none) restore
    # in JAX bit for bit
    for compress in (True, False):
        out = str(tmp_path / f"written_{compress}")
        os.makedirs(out)
        orbax_slot.write(f"{out}/best_valid_model.orbax", want, compress)
        _same_jax_tree(JaxCheckpointManager(out, backend="orbax").restore(
            "best_valid", state), state)
        _assert_same_tree(orbax_slot.read(f"{out}/best_valid_model.orbax"),
                          want)

    # the committed fixture: its leaf list and JAX's own restore
    with open(f"{ORBAX_FIXTURE}/leaves.json") as f:
        listed = sorted(json.load(f), key=lambda leaf: leaf["path"])
    fixture = orbax_slot.read(f"{ORBAX_FIXTURE}/latest_model.orbax")
    assert sorted(orbax_slot.leaf_digests(fixture),
                  key=lambda leaf: leaf["path"]) == listed
    restored = JaxCheckpointManager(ORBAX_FIXTURE, backend="orbax").restore(
        "latest", _orbax_fixture_state())
    _same_jax_tree(restored, _orbax_fixture_state())
    assert sorted(orbax_slot.leaf_digests(flax_msgpack.msgpack_restore(
        serialization.to_bytes(restored))), key=lambda leaf: leaf["path"]) == listed

    # faults raise by name: an uncommitted save, a truncated data file, a
    # flipped checksum
    bad = str(tmp_path / "bad_model.orbax")
    shutil.copytree(slot_dir, bad)
    os.remove(f"{bad}/_CHECKPOINT_METADATA")
    with pytest.raises(ValueError, match="uncommitted"):
        orbax_slot.read(bad)
    tmp_named = slot_dir + ".orbax-checkpoint-tmp-1"
    shutil.copytree(slot_dir, tmp_named)
    with pytest.raises(ValueError, match="uncommitted"):
        orbax_slot.read(tmp_named)
    shutil.rmtree(bad)
    shutil.copytree(slot_dir, bad)
    data = max((os.path.join(d, f) for d, _, fs in os.walk(
        f"{bad}/ocdbt.process_0/d") for f in fs), key=os.path.getsize)
    with open(data, "r+b") as f:
        f.truncate(os.path.getsize(data) // 2)
    with pytest.raises(ValueError, match=f"{os.path.basename(data)}.*truncated"):
        orbax_slot.read(bad)
    shutil.rmtree(bad)
    shutil.copytree(slot_dir, bad)
    with open(f"{bad}/manifest.ocdbt", "r+b") as f:
        raw = bytearray(f.read())
        raw[-1] ^= 0x40
        f.seek(0)
        f.write(raw)
    with pytest.raises(ValueError, match="manifest.ocdbt: bad crc32c"):
        orbax_slot.read(bad)

    # both formats in one run directory: the sidecar decides, else mtime
    both = str(tmp_path / "both")
    JaxCheckpointManager(both).save("best_valid", state)
    jax_both = JaxCheckpointManager(both, backend="orbax")
    jax_both.save("best_valid", {**state, "epoch": 9})
    jax_both.wait_until_finished()
    mgr = CheckpointManager(both)
    sidecar = f"{both}/best_valid_model.meta.json"
    assert json.load(open(sidecar))["backend"] == "orbax"
    assert mgr.restore_jax("best_valid")["epoch"] == 9
    with open(sidecar, "w") as f:
        json.dump({"backend": "msgpack", "counter": 3}, f)
    assert mgr.restore_jax("best_valid")["epoch"] == 4
    os.remove(sidecar)
    os.utime(mgr.jax_path("best_valid"), (1, 1))
    assert mgr.jax_slot_path("best_valid") == mgr.jax_orbax_path("best_valid")

    # the native zstd decoder against zstandard
    for name, content, frame in _zstd_frames():
        got = native.zstd_decompress(frame, len(content))
        assert got.tobytes() == content, name
    frame = frame[:-5] + bytes([frame[-5] ^ 1]) + frame[-4:]
    with pytest.raises(ValueError, match="zstd: .* at input byte"):
        native.zstd_decompress(frame, len(content))


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mimrl_tpu_slot")
ORBAX_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                             "mimrl_tpu_orbax")
PATHS = ("task_name", "data_dir", "task_dir")  # the run's own, not the config's
STEP_TOL = 1e-4  # losses and MI values, relative to 1 + |value|
PARAM_TOL = 3e-5  # absolute, after stage 2's steps of up to 7.5e-3 (Adam, 4e-3)
# a gradient that is zero in exact arithmetic (softmax over the keys does
# not move with the key bias) leaves Adam stepping on rounding noise
NOISE_STEPPED = "attention.self.key.bias"


def steps_to_device(batch, labels):
    from mimrl_tpu_torch.train import steps

    return steps.to_device(batch, labels, "regression", "cpu")


def _jax_anchors(key, n_bank, n_valid, bs, k):
    """The kNN anchors ``sample_all_knn`` of the JAX package draws from
    ``key`` (steps.py:93-98, knn.py:73-74)."""
    from mimrl_tpu.models.model import CMI_KEYS

    valid = (jnp.arange(n_bank) < n_valid).astype(jnp.float32)
    keys = jax.random.split(key, len(CMI_KEYS))
    return {name: torch.from_numpy(np.asarray(jax.random.choice(
        keys[i], n_bank, shape=(bs // k,), replace=False,
        p=valid / jnp.sum(valid))).astype(np.int64))
        for i, name in enumerate(CMI_KEYS)}


def _jax_next_epoch(jax_solver, port, batches):
    """The epoch after the slot on the JAX side, from its resumed state:
    stage 2 (train steps with MI) first, from the resumed critics, then
    stage 1 (critic steps) on its parameters; dropout is off in this
    config. Returns per step (kNN anchors, loss, MI values or None), and
    the main and BERT parameters after stage 2 as the port's state_dict."""
    from mimrl_tpu.train import optim as joptim
    from mimrl_tpu.train import steps as jsteps

    cfg, j = port.opt, jax_solver
    bs, n_bank = cfg.batch_size, port.n_bank
    n_valid = int(port.bank.valid.sum())
    new_bank = jsteps.FeatureBank.create(n_bank, n_valid, cfg.d_common)
    main, bert, opt_state = j.params_main, j.params_bert, j.opt_main_state
    records = []
    for i, (batch, _) in enumerate(batches):
        rng = j._next_rng()
        knn = _jax_anchors(jax.random.split(rng)[1], n_bank, n_valid, bs,
                           cfg.k_neighbor)
        (main, bert, opt_state, loss, mis, _, new_bank) = j.steps.train_step(
            main, bert, j.params_vmi, opt_state, *batch, j.bank, new_bank,
            i * bs, rng, use_mi=True)
        records.append((knn, np.asarray(loss), np.asarray(mis)))
    params = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, joptim.merge_params(main, bert, j.params_vmi)), port.model)
    vmi, vmi_state = j.params_vmi, j.opt_vmi_state
    for batch, _ in batches:
        rng = j._next_rng()
        knn = _jax_anchors(jax.random.split(rng)[1], n_bank, n_valid, bs,
                           cfg.k_neighbor)
        vmi, vmi_state, loss, _ = j.steps.critic_step(
            main, bert, vmi, vmi_state, *batch, j.bank, rng)
        records.append((knn, np.asarray(loss), None))
    return records, params


def _port_gaps(port, batches, records, want):
    """The port's same epoch from its resumed state, on the anchors of
    ``records``: (max relative gap of the losses and MI values, max
    absolute gap of the main and BERT parameters after stage 2,
    ``NOISE_STEPPED`` aside)."""
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.optim import partition_params

    cfg, bs, gaps = port.opt, port.opt.batch_size, []
    port.new_bank.zero_()

    def gap(w, g):
        return float(np.abs(w - g.numpy()).max() / (1 + np.abs(w).max()))

    for i, (_, inputs) in enumerate(batches):
        knn, loss, mis = records[i]
        got = steps.train_step(port.model, port.opt_main, cfg, *inputs,
                               port.bank, port.new_bank, i * bs, None, True,
                               anchors=knn)
        gaps += [gap(loss, got[0]), gap(mis, got[1])]
    now = port.model.state_dict()
    main_p, bert_p, _ = partition_params(port.model)
    param_gap = max(float((now[k] - want[k]).abs().max())
                    for k in list(main_p) + list(bert_p)
                    if not k.endswith(NOISE_STEPPED))
    for (_, inputs), (knn, loss, _) in zip(batches, records[len(batches):]):
        got = steps.critic_step(port.model, port.opt_vmi, cfg, *inputs,
                                port.bank, None, anchors=knn)
        gaps.append(gap(loss, got[0]))
    gaps = np.asarray(gaps)
    return (float(gaps.max()) if np.isfinite(gaps).all() else np.inf,
            param_gap if np.isfinite(param_gap) else np.inf)


def _resumes_a_mimrl_tpu_latest(tmp_path, data, monkeypatch):
    """``--resume`` of a ``mimrl_tpu`` run: a 2-epoch JAX run writes
    ``latest`` (epoch 1, Adam with bfloat16 first moments), JAX resumes it
    (its own ``_resume``) and so does the port, which starts at epoch 2
    with the weights, both optimizers' count, mu (bfloat16) and nu, the
    bank, the rate and the derived loader passes; the next epoch's steps
    agree (losses and MI within STEP_TOL, parameters within PARAM_TOL:
    Adam's resumed moments set every step, so only the key biases, whose
    gradient is rounding noise, are left out),
    and a resume that takes optax's nu as mu is caught. The port's writer
    gives the slot's bytes back, and the committed fixture
    ``tests/fixtures/mimrl_tpu_slot`` (the layout that ``chip_smoke.py``
    fills from a seed and resumes on the card: a slot of this config is
    41 MB) is this run's slot and config, paths aside."""
    import json

    from mimrl_tpu_torch.core.config import MimrlConfig
    from mimrl_tpu_torch.data.universal import get_label_from_datas
    from mimrl_tpu_torch.models import convert

    cfg = _cfg(data).replace(task_dir=str(tmp_path / "jax_runs"),
                             task_name="mimrl_tpu_slot", epochs_num=2,
                             save_latest_every=1)
    jax_solver = JaxSolver(cfg)
    jax_solver.solve()
    run = f"{cfg.task_dir}/{cfg.task_name}"
    raw = open(f"{run}/latest_model.msgpack", "rb").read()
    slot = flax_msgpack.msgpack_restore(raw)
    assert flax_msgpack.msgpack_serialize(slot) == raw
    with open(f"{FIXTURE}/skeleton.json") as f:
        assert flax_msgpack.skeleton(slot) == json.load(f)
    with open(f"{FIXTURE}/config.json") as f:
        fixture_cfg = json.load(f)
    written = json.load(open(f"{run}/config.json"))
    assert ({k: v for k, v in written.items() if k not in PATHS}
            == {k: v for k, v in fixture_cfg.items() if k not in PATHS})
    seeded = flax_msgpack.seeded_tree(flax_msgpack.skeleton(slot), 0)
    assert flax_msgpack.skeleton(seeded) == flax_msgpack.skeleton(slot)
    assert (serialization.msgpack_restore(flax_msgpack.msgpack_serialize(
        seeded))["opt_main_state"]["count"] == slot["opt_main_state"]["count"])

    jax_solver._resume(run)
    assert jax_solver.start_epoch == 2
    port_cfg = MimrlConfig.from_json(cfg.to_json()).replace(
        task_name="port", resume=run, device="cpu")

    def resumed():
        port = Solver(port_cfg)
        port.writer.close()
        return port

    port = resumed()
    log = open(f"{cfg.task_dir}/port/Running.log").read()
    assert ("latest_model.msgpack is a mimrl_tpu slot; state it does not "
            "hold: loader_passes = 3, schedule epoch = 2, generators = "
            "seeded from --seed 0") in log
    assert port.start_epoch == 2 and port.have_bank
    assert port.train_loader.passes == 3 and port.lr_schedule.epoch == 2
    assert port.opt_main.mu.dtype == torch.bfloat16
    for opt, state in ((port.opt_main, slot["opt_main_state"]),
                       (port.opt_vmi, slot["opt_vmi_state"])):
        inner = state["inner_state"]["1"]
        assert opt.count.item() == int(inner["count"]) > 0
        assert opt.learning_rate == pytest.approx(
            float(state["hyperparams"]["learning_rate"]))
    for f in "CFTAV":
        np.testing.assert_array_equal(getattr(port.bank, f).numpy(),
                                      np.asarray(jax_solver.bank.__getattribute__(f)))
    batches = []
    for b in port.train_loader:
        labels = np.asarray(get_label_from_datas(port_cfg, b), np.float32)
        jb = {k: jnp.asarray(b[k]) for k in (
            "bert_sentences", "bert_sentence_types", "bert_sentence_att_mask",
            "audio", "video", "sample_mask")}
        batches.append(((jb, jnp.asarray(labels)),
                        steps_to_device(b, labels)))
    records, want = _jax_next_epoch(jax_solver, port, batches)
    step_gap, param_gap = _port_gaps(port, batches, records, want)
    assert step_gap <= STEP_TOL, step_gap
    assert param_gap <= PARAM_TOL, param_gap

    # on a model axis (one process per rank: the cut needs no collective)
    # the slot converts whole and each rank takes its blocks, column and,
    # under --seq_shard, row blocks
    from mimrl_tpu_torch.core.checkpoint import local_slot
    from mimrl_tpu_torch.parallel.mesh import Mesh, shard_dim

    whole = port._slot_from_jax(slot, run)
    for seq, rank in ((False, 1), (True, 0)):
        mesh = Mesh({"model": 2}, rank)
        ranked = Solver(port_cfg.replace(task_name=f"rank{rank}", mesh_model=2,
                                         seq_shard=seq), mesh=mesh)
        ranked.writer.close()
        dims = {n: shard_dim(p) for n, p in ranked.model.named_parameters()}
        assert sorted(set(dims.values()) - {None}) == ([0, 1] if seq else [0])
        blocks = local_slot(mesh, ranked.model, ranked._optimizers(), whole)
        held = ranked.model.state_dict()
        for name, t in blocks["model"].items():
            assert torch.equal(held[name], t), name
        for name in ("opt_main", "opt_vmi"):
            opt = getattr(ranked, name)
            assert opt.sizes == blocks[name]["sizes"]
            assert torch.equal(opt.mu, blocks[name]["mu"])
            assert torch.equal(opt.nu, blocks[name]["nu"])

    moment_trees = convert._moment_trees

    def nu_as_mu(opt_state, what):
        count, mu, nu = moment_trees(opt_state, what)
        return count, mu, jax.tree_util.tree_map(
            lambda x: x.float() if isinstance(x, torch.Tensor) else x, mu)

    with monkeypatch.context() as m:
        m.setattr(convert, "_moment_trees", nu_as_mu)
        faulty = resumed()
    step_gap, param_gap = _port_gaps(faulty, batches, records, want)
    assert step_gap > STEP_TOL or param_gap > 10 * PARAM_TOL, (
        step_gap, param_gap)


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


def _orbax_fixture_state():
    """The tree of ``tests/fixtures/mimrl_tpu_orbax``: every kind of leaf
    a ``mimrl_tpu`` slot holds (float32, bfloat16 and int32 arrays, Python
    scalars, an optax chain state with its ``EmptyState`` and namedtuples),
    random data that does not compress beside smooth data that does."""
    import optax

    rng = np.random.default_rng(17)
    params = {"dense": {"kernel": rng.normal(size=(40, 24)).astype(np.float32),
                        "bias": np.round(np.linspace(-1, 1, 24), 2).astype(
                            np.float32)},
              "embed.table": np.asarray(jnp.asarray(
                  rng.normal(size=(32, 16)), jnp.bfloat16))}
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)).init(
        params)
    opt = jax.tree_util.tree_map(  # moments with values of their own dtype
        lambda x: (np.asarray(jnp.asarray(1e-3 * rng.normal(size=x.shape),
                                          x.dtype)) if x.ndim else
                   np.asarray(x)), opt)
    wave = np.sin(np.arange(64 * 48) / 7.0).reshape(64, 48)
    return {"params": params, "opt_state": opt,
            "bank": {"F": np.round(wave, 3).astype(np.float32),
                     "ids": (np.arange(512) % 11).astype(np.int32)},
            "epoch": 3, "global_step": 120, "lr_factor": 0.25}


def _write_orbax_fixture(root):
    """Writes the fixture with ``mimrl_tpu``'s ``CheckpointManager(backend=
    "orbax")`` (``bank/F`` over several chunks of at most 2 KB), and
    ``leaves.json`` from the state itself: ``python
    tests/test_torch_checkpoint.py`` rewrites it."""
    import orbax.checkpoint as ocp

    standard_save = ocp.args.StandardSave

    def chunked(item):
        args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(), item)
        args["bank"]["F"] = ocp.SaveArgs(chunk_byte_size=2048)
        return standard_save(item, save_args=args)

    state = _orbax_fixture_state()
    with unittest.mock.patch.object(ocp.args, "StandardSave", chunked):
        mgr = JaxCheckpointManager(root, backend="orbax")
        mgr.save("latest", state)
        mgr.wait_until_finished()
    leaves = orbax_slot.leaf_digests(flax_msgpack.msgpack_restore(
        serialization.to_bytes(state)))
    with open(os.path.join(root, "leaves.json"), "w") as f:
        json.dump(leaves, f, indent=1)


if __name__ == "__main__":
    shutil.rmtree(ORBAX_FIXTURE, ignore_errors=True)
    _write_orbax_fixture(ORBAX_FIXTURE)
