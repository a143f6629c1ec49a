"""Checkpoint slots and the run config.

A slot (``best_valid``, ``best_test``, ``latest``) is one file,
``{slot}_model.pt``, written with ``torch.save`` to a temporary file and
moved into place with ``os.replace``, and read with
``torch.load(weights_only=True)``, so it holds only tensors and plain
Python containers. All three slots have one schema, the whole training
state at the end of an epoch (``train/solver.py::Solver._snapshot``)::

    {"format": SLOT_FORMAT, "epoch": int,
     "model": the model's state_dict (the estimator bank included),
     "opt_main", "opt_vmi": ChainOptimizer.state_dict() (count, mu, nu),
     "bank": FeatureBank.state_dict(), "have_bank": bool,
     "lr_schedule": LRScheduler.state_dict(),
     "loader_passes": the train loader's passes,
     "rng": {"solver": the Solver generator's state, "cpu": torch's CPU
             default state, and on a CUDA run "cuda": the CUDA default
             state}}

``Solver._resume`` continues a run from ``latest``; ``restore_model``
gives the model's state_dict for serving, from this schema or from a bare
state_dict (the slots of earlier versions of this package).

``save`` takes a host copy of the slot before it returns (device tensors
are copied into page-locked buffers, in the current stream's order, so
the steps that follow cannot change what is written) and writes it with
``torch.save``. Under ``--ckpt_backend orbax`` (``backend="orbax"``),
as in ``mimrl_tpu``, the write runs on a background thread, so the epoch
loop is not blocked while a slot of the parameters and both optimizers'
moments is written: a save first waits for the one before, an error of
the thread is raised by the next ``save`` or by ``wait_until_finished``,
and the Solver waits before its run returns or stops. Both backends
write the same ``.pt`` bytes; the port writes neither of ``mimrl_tpu``'s
formats.

``mimrl_tpu``'s slots are read by ``restore_jax`` with neither flax,
msgpack, orbax nor tensorstore installed: its msgpack slots
(``{slot}_model.msgpack``) through ``core/flax_msgpack.py``, its orbax
slots (``{slot}_model.orbax/``) through ``core/orbax_slot.py``, and where
a run directory holds both, the one ``mimrl_tpu`` would restore (the
sidecar ``{slot}_model.meta.json``'s backend, else the newer);
``models/convert.py::state_dict_from_jax_slot`` turns one into the
model's state_dict.

``config.json`` is the ``MimrlConfig`` as JSON, the same file the JAX
package writes.

A mesh run (``parallel/mesh.py``) writes from rank 0 alone
(``CheckpointManager(write=False)`` on the others), and its slots hold
whole tensors: ``whole_slot`` gathers the model-sharded parameters and
rebuilds each optimizer's flat moments in the whole parameters' layout,
so a mesh run's slot serves and resumes unsharded; ``local_slot`` takes a
rank's blocks back, so any slot resumes on a mesh.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import torch

from mimrl_tpu_torch.core import flax_msgpack, orbax_slot
from mimrl_tpu_torch.parallel.mesh import gather_blocks, shard_dim, take_block

SLOT_FORMAT = "mimrl_tpu_torch.slot/1"


def is_full_slot(state: Dict) -> bool:
    """True for a slot of the full schema, False for a bare state_dict."""
    return state.get("format") == SLOT_FORMAT


def _convert(slot: Dict, model, optimizers: Dict, mesh, to_whole: bool
             ) -> Dict:
    """``slot`` with each model-sharded parameter, and its segment of the
    optimizers' flat moments, gathered whole (``to_whole``) or cut to this
    rank's block."""
    dims = {name: shard_dim(p) for name, p in model.named_parameters()}

    def fn(t, d):
        return gather_blocks(t, mesh, d) if to_whole else take_block(t, mesh, d)

    out = dict(slot)
    out["model"] = {k: (fn(v, dims[k]) if dims.get(k) is not None else v)
                    for k, v in slot["model"].items()}
    n_model = mesh.shape["model"]
    for name, opt in optimizers.items():
        state = dict(slot[name])
        pdims = [shard_dim(p) for p in opt.params]
        local = [torch.Size(p.shape) for p in opt.params]
        whole = [s if d is None else
                 torch.Size(n_model * n if i == d else n
                            for i, n in enumerate(s))
                 for s, d in zip(local, pdims)]
        src, dst = (local, whole) if to_whole else (whole, local)
        for key in ("mu", "nu"):
            if state[key].numel() == 0:
                continue
            parts = state[key].split([s.numel() for s in src])
            state[key] = torch.cat([
                part if d is None else fn(part.view(shape), d).reshape(-1)
                for part, d, shape in zip(parts, pdims, src)])
        state["sizes"] = [s.numel() for s in dst]
        out[name] = state
    return out


def whole_slot(mesh, model, optimizers: Dict, slot: Dict) -> Dict:
    """A mesh rank's slot (``Solver._snapshot``) with whole tensors: the
    model-sharded parameters gathered over ``model`` and the optimizers'
    (``{"opt_main": ..., "opt_vmi": ...}``) flat moments and sizes in the
    whole parameters' layout. Collective: every rank calls it."""
    return _convert(slot, model, optimizers, mesh, True)


def local_slot(mesh, model, optimizers: Dict, slot: Dict) -> Dict:
    """The inverse of ``whole_slot``: this rank's blocks of a slot of
    whole tensors (a mesh run's or an unsharded run's)."""
    return _convert(slot, model, optimizers, mesh, False)


class WholeShapes:
    """The model as ``models/convert.py`` reads it (``state_dict()`` for
    names and shapes, ``named_parameters()`` for the parameters), with
    the model-sharded parameters at their whole shapes: a ``mimrl_tpu``
    slot converts to a slot of whole tensors, which ``local_slot`` cuts."""

    def __init__(self, mesh, model) -> None:
        self.model, self.n = model, mesh.shape["model"]

    def named_parameters(self):
        return self.model.named_parameters()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        dims = {k: shard_dim(p) for k, p in self.model.named_parameters()}
        out = {}
        for k, v in self.model.state_dict().items():
            shape = list(v.shape)
            if dims.get(k) is not None:
                shape[dims[k]] *= self.n
            out[k] = torch.empty(shape, device="meta")
        return out


def host_copy(state: Any):
    """``state`` with every tensor copied to the host, and the CUDA event
    after which the copies are complete (None when no tensor was on the
    card). Tensors that share a storage share their copy, with the same
    offsets and strides, so ``torch.save`` writes the same records as for
    the originals. Device copies go into page-locked buffers in the
    current stream's order: the steps that follow cannot change them."""
    copies: Dict[Any, torch.Tensor] = {}
    event = None

    def copy(t: torch.Tensor) -> torch.Tensor:
        nonlocal event
        storage = t.untyped_storage()
        key = (t.device, storage.data_ptr())
        host = copies.get(key)
        if host is None:
            src = torch.empty(0, dtype=torch.uint8, device=t.device).set_(
                storage, 0, (storage.nbytes(),), (1,))
            host = torch.empty(storage.nbytes(), dtype=torch.uint8,
                               pin_memory=t.is_cuda)
            host.copy_(src, non_blocking=t.is_cuda)
            if t.is_cuda and event is None:
                event = torch.cuda.Event()
            copies[key] = host
        return torch.empty(0, dtype=t.dtype).set_(
            host.untyped_storage(), t.storage_offset(), t.size(), t.stride())

    def walk(x):
        if isinstance(x, torch.Tensor):
            return copy(x.detach())
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    out = walk(state)
    if event is not None:
        event.record()
    return out, event


class CheckpointManager:
    """The slots and config of one run directory; ``write=False`` (a mesh
    rank other than 0) reads and writes nothing. ``backend`` is the run's
    ``--ckpt_backend``: ``"orbax"`` writes on a background thread."""

    def __init__(self, task_path: str, write: bool = True,
                 backend: str = "msgpack"):
        if backend not in ("msgpack", "orbax"):
            raise ValueError(f"checkpoint backend {backend!r}, not msgpack "
                             "or orbax")
        self.task_path = task_path
        self.write = write
        self.backend = backend
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = ""

    def _path(self, slot: str) -> str:
        return os.path.join(self.task_path, f"{slot}_model.pt")

    def jax_path(self, slot: str) -> str:
        """Where ``mimrl_tpu`` writes the slot (flax msgpack)."""
        return os.path.join(self.task_path, f"{slot}_model.msgpack")

    def jax_orbax_path(self, slot: str) -> str:
        """Where ``mimrl_tpu`` writes the slot under ``--ckpt_backend
        orbax`` (a directory)."""
        return os.path.join(self.task_path, f"{slot}_model.orbax")

    def _write_file(self, slot: str, host: Dict, event) -> None:
        if event is not None:
            event.synchronize()
        tmp = self._path(slot) + ".tmp"
        torch.save(host, tmp)
        os.replace(tmp, self._path(slot))

    def _background(self, slot: str, host: Dict, event) -> None:
        try:
            self._write_file(slot, host, event)
        except BaseException as e:  # raised by the next save or wait
            self._error = e

    def save(self, slot: str, state: Dict[str, Any]) -> None:
        """Write the slot; under the orbax backend the write is left to a
        background thread once the host copy is taken."""
        if not self.write:
            return
        self.wait_until_finished()
        os.makedirs(self.task_path, exist_ok=True)
        host, event = host_copy(state)
        if self.backend == "msgpack":
            self._write_file(slot, host, event)
            return
        self._pending = slot
        self._thread = threading.Thread(
            target=self._background, args=(slot, host, event),
            name=f"save-{slot}")
        self._thread.start()

    def wait_until_finished(self) -> None:
        """Block until the background save is written; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"the background save of slot "
                               f"{self._pending!r} in {self.task_path} "
                               f"failed: {error!r}") from error

    def restore(self, slot: str, map_location=None) -> Optional[Dict[str, Any]]:
        """The slot as it was written, or None when it was never written."""
        path = self._path(slot)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=map_location, weights_only=True)

    def restore_model(self, slot: str, map_location=None
                      ) -> Optional[Dict[str, torch.Tensor]]:
        """The model's state_dict from the slot, of either schema; None
        when the slot was never written."""
        state = self.restore(slot, map_location)
        if state is not None and is_full_slot(state):
            return state["model"]
        return state

    def jax_slot_path(self, slot: str) -> Optional[str]:
        """The ``mimrl_tpu`` slot that ``restore_jax`` reads: its msgpack
        file or its orbax directory; where both exist, the one that
        ``mimrl_tpu``'s ``CheckpointManager.restore`` takes (the sidecar's
        ``backend``, else the newer by mtime); None when there is none."""
        path, opath = self.jax_path(slot), self.jax_orbax_path(slot)
        has_msgpack, has_orbax = os.path.exists(path), os.path.isdir(opath)
        if has_msgpack and has_orbax:
            meta = None
            try:
                with open(os.path.join(self.task_path,
                                       f"{slot}_model.meta.json")) as f:
                    meta = json.load(f)
            except (OSError, json.JSONDecodeError):
                pass
            if isinstance(meta, dict) and meta.get("backend") in (
                    "msgpack", "orbax"):
                has_msgpack = meta["backend"] == "msgpack"
            else:
                has_msgpack = os.path.getmtime(path) >= os.path.getmtime(opath)
        if has_msgpack:
            return path
        return opath if has_orbax else None

    def restore_jax(self, slot: str) -> Optional[Dict[str, Any]]:
        """``mimrl_tpu``'s slot (``jax_slot_path``) as nested dicts of
        arrays, or None when there is none."""
        path = self.jax_slot_path(slot)
        if path is None:
            return None
        if path.endswith(".msgpack"):
            return flax_msgpack.read(path)
        return orbax_slot.read(path)

    def save_config(self, cfg_json: str) -> None:
        if not self.write:
            return
        os.makedirs(self.task_path, exist_ok=True)
        with open(os.path.join(self.task_path, "config.json"), "w") as f:
            f.write(cfg_json)

    def load_config(self) -> Optional[dict]:
        p = os.path.join(self.task_path, "config.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)
