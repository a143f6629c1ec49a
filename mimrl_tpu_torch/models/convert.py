"""Carry ``mimrl_tpu`` weights into the port: a params tree (nested
dicts with numpy leaves, as ``init_full`` or a restored checkpoint gives
after ``np.asarray``, or a slot read by ``core/flax_msgpack.py``) becomes
the port's ``state_dict``.

Layouts translated (the inverse of ``mimrl_tpu/utils/torch_import.py``
and ``mimrl_tpu/models/bert.py::convert_hf_torch_state_dict``):

- flax ``Dense.kernel`` [in, out] -> ``nn.Linear.weight`` [out, in];
- BERT's fused ``qkv`` kernel [H, 3H] / bias [3H] -> HF's separate
  ``attention.self.{query,key,value}``;
- ``rnn_*/l{k}_{fwd,bwd}/w_ih`` [in, GH] -> ``weight_ih_l{k}[_reverse]``
  [GH, in] (same gate order; G = 3 for the GRU, 4 for the LSTM), likewise
  ``w_hh``/``b_ih``/``b_hh``;
- ``conv_*/conv/kernel`` [3, in, out] -> ``conv_*.weight`` [out, in, 3]
  (``mimrl_tpu/utils/torch_import.py:160-165``);
- CubeMLP ``block_{i}/mlp_{x}/w1`` [in, hidden] ->
  ``mlp_encoder.layers_stack.{i}.mlp_{x}.fc1.weight``;
- LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
- the other fusions (``models/fusion.py``, the same names as the flax
  tree): ``nn.MultiHeadDotProductAttention``'s ``DenseGeneral`` kernels
  ``query``/``key``/``value`` [d, H, hd] (bias [H, hd]) and ``out``
  [H, hd, d] -> ``nn.Linear`` weights [d, d] (bias [d]); ``nn.Dense``
  kernels transposed; the position tables and the experts' ``w1``,
  ``b1``, ``w2``, ``b2`` as they are.

The classifier keeps the names ``MimrlModel`` creates (model.py:190-195):
``classifier``, or ``classifier_hidden`` + ``classifier``. A dense-text
model has no ``bertmodel``, and its ``W_t`` kernel is [d_t, d_common].

``optimizer_states_from_jax`` carries a slot's optax states onto
``ChainOptimizer``'s flat moments: optax's ``mu`` and ``nu`` are trees in
the parameters' layout, so they go through the same rules as the
parameters (a transpose or a column block is as exact for a moment as for
a weight), and are then laid out in the optimizer's parameter order, each
in its own dtype (a bfloat16 ``mu`` stays bfloat16: the rules only move
values). ``bank_state_from_jax`` carries the feature bank.

The ``vmi_*``/``vcmi_*`` estimator groups are trees of Dense layers whose
flax names are the port's module names
(``vmi_estimator_f_t/critic_model/MLP_g/fc_in/kernel`` ->
``vmi_estimator_f_t.critic_model.MLP_g.fc_in.weight``). Any JAX leaf left
unmapped, any port tensor left unfilled, and any shape mismatch raises;
only a tree with no estimator group at all (a forward-only flax init)
leaves the port's estimator tensors out of the result.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_ESTIMATOR_PREFIXES = ("vmi_", "vcmi_")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def _dense(name: str, node: Dict, path: Tuple[str, ...]):
    yield path + ("kernel",), name + ".weight", lambda x: x.T
    if "bias" in node:
        yield path + ("bias",), name + ".bias", None


def _layer_norm(name: str, path: Tuple[str, ...]):
    yield path + ("scale",), name + ".weight", None
    yield path + ("bias",), name + ".bias", None


def _bert_rules(p: Dict, prefix: str):
    emb = ("bertmodel", "embeddings")
    for n in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        yield emb + (n, "embedding"), f"{prefix}embeddings.{n}.weight", None
    yield from _layer_norm(f"{prefix}embeddings.LayerNorm", emb + ("layer_norm",))
    n_layers = sum(1 for k in p if k.startswith("layer_"))
    for i in range(n_layers):
        f = ("bertmodel", f"layer_{i}")
        t = f"{prefix}encoder.layer.{i}."
        for j, n in enumerate(("query", "key", "value")):
            def cut(x, j=j):  # column block j of the fused [H, 3H] / [3H]
                h = x.shape[-1] // 3
                blk = x[..., j * h:(j + 1) * h]
                return blk.T if blk.ndim == 2 else blk
            yield f + ("attention", "qkv", "kernel"), t + f"attention.self.{n}.weight", cut
            yield f + ("attention", "qkv", "bias"), t + f"attention.self.{n}.bias", cut
        yield from _dense(t + "attention.output.dense",
                          p[f"layer_{i}"]["attention"]["output_dense"],
                          f + ("attention", "output_dense"))
        yield from _layer_norm(t + "attention.output.LayerNorm",
                               f + ("attention", "output_layer_norm"))
        yield from _dense(t + "intermediate.dense",
                          p[f"layer_{i}"]["intermediate_dense"],
                          f + ("intermediate_dense",))
        yield from _dense(t + "output.dense", p[f"layer_{i}"]["output_dense"],
                          f + ("output_dense",))
        yield from _layer_norm(t + "output.LayerNorm", f + ("output_layer_norm",))


def _rnn_rules(p: Dict, name: str):
    for layer_dir in p:
        k, direction = layer_dir[1:].split("_")
        suffix = "" if direction == "fwd" else "_reverse"
        for leaf, tname in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                            ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            yield ((name, layer_dir, leaf), f"{name}.{tname}_l{k}{suffix}",
                   (lambda x: x.T) if leaf.startswith("w") else None)


def _mlp_encoder_rules(p: Dict):
    for blk in p:
        i = int(blk[len("block_"):])
        t = f"mlp_encoder.layers_stack.{i}."
        f = ("mlp_encoder", blk)
        for sub in p[blk]:
            if sub.startswith("mlp_"):
                for leaf, tname in (("w1", "fc1.weight"), ("w2", "fc2.weight"),
                                    ("b1", "fc1.bias"), ("b2", "fc2.bias")):
                    yield (f + (sub, leaf), f"{t}{sub}.{tname}",
                           (lambda x: x.T) if leaf.startswith("w") else None)
            elif sub.startswith("ln_"):
                yield from _layer_norm(t + sub, f + (sub,))
            elif sub.startswith("res_projection_"):
                yield f + (sub, "w"), f"{t}{sub}.weight", lambda x: x.T


def _fusion_rules(node: Dict, path: Tuple[str, ...] = ("mlp_encoder",)):
    """The transformer, TFN and MoE fusions' trees, leaf by leaf."""
    for key, sub in node.items():
        p, name = path + (key,), ".".join(path + (key,))
        if not isinstance(sub, dict):  # position tables, expert weights
            yield p, name, None
        elif "scale" in sub:
            yield from _layer_norm(name, p)
        elif "kernel" not in sub:
            yield from _fusion_rules(sub, p)
        elif np.ndim(sub["kernel"]) == 2:  # nn.Dense
            yield from _dense(name, sub, p)
        elif key == "out":  # DenseGeneral over (H, hd): [H, hd, d]
            yield (p + ("kernel",), name + ".weight",
                   lambda x: x.reshape(-1, x.shape[-1]).T)
            yield p + ("bias",), name + ".bias", None
        else:  # DenseGeneral to (H, hd): [d, H, hd], bias [H, hd]
            yield (p + ("kernel",), name + ".weight",
                   lambda x: x.reshape(x.shape[0], -1).T)
            yield p + ("bias",), name + ".bias", lambda x: x.reshape(-1)


def _estimator_rules(name: str, node: Dict, path: Tuple[str, ...] = ()):
    """Every Dense of an estimator's tree, by its own path."""
    path = path or (name,)
    if "kernel" in node:
        yield from _dense(".".join(path), node, path)
        return
    for key, sub in node.items():
        if isinstance(sub, dict):
            yield from _estimator_rules(name, sub, path + (key,))


def _rules(params: Dict):
    """(JAX path, port name, transform) for every mapped leaf."""
    if "bertmodel" in params:
        yield from _bert_rules(params["bertmodel"], "bertmodel.")
    for name in ("rnn_a", "rnn_v"):
        if name in params:
            yield from _rnn_rules(params[name], name)
    for name in ("conv_a", "conv_v"):
        if name in params:
            yield ((name, "conv", "kernel"), f"{name}.weight",
                   lambda x: x.transpose(2, 1, 0))
            yield (name, "conv", "bias"), f"{name}.bias", None
    for name in ("ln_a", "ln_v"):
        if name in params:
            yield from _layer_norm(name, (name,))
    for name in ("W_t", "classifier", "classifier_hidden"):
        if name in params:
            yield from _dense(name, params[name], (name,))
    if "mlp_encoder" in params:
        fusion = params["mlp_encoder"]
        if "pos_time" in fusion or "factor_0" in fusion:
            yield from _fusion_rules(fusion)
        else:  # CubeMLP
            yield from _mlp_encoder_rules(fusion)
    for name in params:
        if name.startswith(_ESTIMATOR_PREFIXES):
            yield from _estimator_rules(name, params[name])


def state_dict_from_jax(params: Dict, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a ``mimrl_tpu`` params tree (``variables["params"]``) onto the
    state_dict of ``model`` (a port module; its tensors may live on the
    meta device, only names and shapes are read). Subtrees convert too:
    pass e.g. ``{"bertmodel": p}`` with a model whose state_dict keys
    are ``bertmodel.*``."""
    leaves = dict(_flatten(params))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for path, name, fn in _rules(params):
        if path not in leaves:
            continue  # optional leaf (e.g. a bias-free CubeMLP)
        used.add(path)
        x = leaves[path]
        x = fn(x) if fn is not None else x
        if name not in want:
            raise ValueError(f"JAX leaf {'/'.join(path)} maps to {name}, "
                             "which the port model does not have")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name}: JAX leaf {'/'.join(path)} gives "
                             f"shape {tuple(x.shape)}, the port expects "
                             f"{want[name]}")
        out[name] = torch.from_numpy(np.array(x, np.float32, order="C"))
    unmapped = [p for p in leaves if p not in used]
    if unmapped:
        raise ValueError("unmapped JAX leaves: "
                         + ", ".join("/".join(p) for p in unmapped[:8])
                         + f" ({len(unmapped)} in all)")
    missing = sorted(set(want) - set(out))
    if not any(name.startswith(_ESTIMATOR_PREFIXES) for name in params):
        # a tree from a forward-only init has no estimator bank: the
        # port's estimators then keep their own initialisation
        missing = [k for k in missing if not k.startswith(_ESTIMATOR_PREFIXES)]
    if missing:
        raise ValueError(f"port tensors left unfilled: {missing[:8]} "
                         f"({len(missing)} in all)")
    return out


def state_dict_from_jax_slot(slot: Dict, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The state_dict of ``model`` from a restored ``mimrl_tpu`` slot
    (``CheckpointManager.restore_jax``): its three parameter groups
    ``params_main``, ``params_bert`` and ``params_vmi``, merged as
    ``mimrl_tpu/train/optim.py::merge_params`` does, then
    ``state_dict_from_jax``. The slot's optimizer states and bank are not
    read."""
    groups = ("params_main", "params_bert", "params_vmi")
    missing = [g for g in groups if g not in slot]
    if missing:
        raise ValueError(f"not a mimrl_tpu slot: no {missing} among "
                         f"{sorted(slot)}")
    params: Dict = {}
    for g in groups:
        params.update(slot[g])
    return state_dict_from_jax(params, model)


def _as_numpy(tree):
    """A slot subtree with its bfloat16 leaves (torch tensors from
    ``core/flax_msgpack.py``) widened to float32 numpy, which is exact."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _moment_trees(opt_state: Dict, what: str):
    """(count, mu tree, nu tree or None, mu dtype) of an optax state as
    ``mimrl_tpu/train/optim.py`` builds it: ``inject_hyperparams`` around
    a chain holding ``scale_by_adam`` (count, mu, nu) or, for SGD,
    ``trace`` (its count is the outer one)."""
    inner = opt_state.get("inner_state", {})
    for node in inner.values() if isinstance(inner, dict) else ():
        if not isinstance(node, dict):
            continue
        if "mu" in node and "nu" in node:
            return node["count"], node["mu"], node["nu"]
        if "trace" in node:
            return opt_state["count"], node["trace"], None
    raise ValueError(f"{what}: no scale_by_adam (count, mu, nu) or trace "
                     f"state among {sorted(inner) if isinstance(inner, dict) else inner}")


def _leaf_dtype(tree) -> torch.dtype:
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(leaf).dtype)).dtype


def optimizer_states_from_jax(slot: Dict, model: nn.Module,
                              optimizers: Dict) -> Dict[str, Dict]:
    """``ChainOptimizer.state_dict()`` of each optimizer of ``optimizers``
    ({"opt_main": ..., "opt_vmi": ...}) from a ``mimrl_tpu`` slot's
    ``opt_main_state`` / ``opt_vmi_state``, in the layout of the
    parameter shapes that ``model.state_dict()`` gives (whole ones on a
    mesh: ``core/checkpoint.py::WholeShapes``). Each moment keeps the
    dtype the optimizer holds it in; a moment that the slot holds in
    another dtype, or an optimizer of another kind, raises."""
    keys = {"opt_main": "opt_main_state", "opt_vmi": "opt_vmi_state"}
    trees = {name: _moment_trees(slot[keys[name]], keys[name])
             for name in optimizers}
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {}
    for m in (1, 2):
        merged: Dict = {}
        for tree in trees.values():
            if tree[m] is not None:
                merged.update(_as_numpy(tree[m]))
        moments[m] = state_dict_from_jax(merged, model) if merged else {}
    out = {}
    for name, opt in optimizers.items():
        count, mu, nu = trees[name]
        kind = "Adam" if nu is not None else "SGD"
        if kind != opt.kind:
            raise ValueError(f"{keys[name]} holds {kind} moments, this run's "
                             f"optimizer is {opt.kind}")
        state = {"kind": opt.kind,
                 "sizes": [moments[1][names[id(p)]].numel()
                           for p in opt.params],
                 "count": torch.tensor(float(np.asarray(count)),
                                       dtype=opt.count.dtype)}
        for m, (field, dst) in enumerate((("mu", opt.mu), ("nu", opt.nu)), 1):
            tree = (mu, nu)[m - 1]
            if tree is None:
                state[field] = torch.zeros(0, dtype=dst.dtype)
                continue
            if _leaf_dtype(tree) != dst.dtype:
                raise ValueError(f"{keys[name]} {field} is {_leaf_dtype(tree)}, "
                                 f"this run keeps it in {dst.dtype} "
                                 "(--moment_dtype)")
            state[field] = torch.cat([moments[m][names[id(p)]].reshape(-1)
                                      for p in opt.params]).to(dst.dtype)
        out[name] = state
    return out


def bank_state_from_jax(slot: Dict, bank) -> Dict[str, torch.Tensor]:
    """``FeatureBank.state_dict()`` from a ``mimrl_tpu`` slot's ``bank``
    (C, F, T, A, V in the bank's dtype; ``valid``, float32 in JAX, as the
    port's bool). JAX's ``F`` is ``d_common`` wide, the port's
    ``classify_dim`` wide; they are one width whenever the JAX run could
    write its bank (the fused features are ``classify_dim`` wide), and a
    slot of another width raises."""
    src = _as_numpy(slot["bank"])
    state = {}
    for f in bank.FIELDS:
        dst = getattr(bank, f)
        x = torch.from_numpy(np.asarray(src[f])).to(dst.dtype)
        if x.shape != dst.shape:
            raise ValueError(f"bank field {f}: the slot's {tuple(x.shape)}, "
                             f"this run's {tuple(dst.shape)}")
        state[f] = x
    state["valid"] = torch.from_numpy(np.asarray(src["valid"]) > 0.5)
    return state
