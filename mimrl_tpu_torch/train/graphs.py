"""CUDA graphs for the ``--epoch_scan`` rung: each step body is captured
once and replayed for every batch, the port's counterpart of the JAX
package's ``lax.scan`` epoch programs (``mimrl_tpu/train/steps.py:340-578``).

``StepGraphs`` is the ``run`` argument of the epoch functions in
``train/steps.py``: ``run(name, body, **inputs)``.

- On the CPU, or with ``enabled=False``, it calls the body. The only
  difference between the two devices is capture versus call.
- On CUDA, the first call of a name runs the body eagerly on the capture
  stream. That call is a real step (its results are returned) and the
  warm-up that capture needs: cuBLAS and cuDNN set up their handles and
  workspaces, the kernels' libraries are built and loaded, and the int8
  GEMM resolves `cuTensorMapEncodeTiled` and uploads its schedules, all
  outside the capture. The body is then captured into a graph whose
  inputs are static buffers. Capture runs no kernel, so it leaves the
  training state where the eager step left it; it raises if it moved a
  generator. Every later call copies its inputs into the buffers on the
  device, replays the graph and returns clones of its outputs.
- The caller's generators (the Solver's, which draws the attention seeds
  and the kNN anchors) are registered with every graph, so a replay draws
  from the generator's current offset and advances it as the eager body
  would. torch refuses to capture a CUDA generator that is not
  registered. Torch registers its default CUDA generator, which
  ``nn.Dropout`` draws from, itself.
- All graphs of one ``StepGraphs`` share one memory pool. That is safe
  while no two graphs replay concurrently and no graph's outputs are read
  after another graph replayed: the outputs are cloned right after each
  replay, on the same stream.
- A body reads and writes the training state through tensors that stay in
  place (parameters, optimizer moments and learning rates, the feature
  banks): a graph holds their addresses.
- The kernel wrappers count launches in Python, which a replay does not
  run. The launches a capture recorded are taken off the counts and added
  back at each replay, so the counts are launches on the device.
- A body that cannot be captured raises with its name. Nothing falls back
  to eager execution on the card.
- On a mesh (``parallel/mesh.py``) a body holds its collectives (the
  gathers of the batch and over ``model``, the gradient average). NCCL's
  are captured with the step and replay with it; the first, eager call
  creates the communicators, outside the capture. gloo's cannot be
  captured, so the Solver turns capture off on a gloo group: the CPU
  tests, and two ranks sharing one card, run the bodies eagerly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import torch

from mimrl_tpu_torch.core.spans import span
from mimrl_tpu_torch.ops.cubemlp_kernel import fused_axis_mlp
from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from mimrl_tpu_torch.ops.int8_matmul import int8_matmul

_COUNTED = (flash_attention, flash_attention_bwd, fused_axis_mlp, int8_matmul)


def _launch_counts() -> Dict:
    """Every launch counter of the four kernel wrappers: {(wrapper index,
    instance or None): count}."""
    out = {}
    for i, wrapper in enumerate(_COUNTED):
        out[(i, None)] = wrapper.launches
        for key, n in getattr(wrapper, "instance_launches", {}).items():
            out[(i, key)] = n
    return out


def _add_launches(delta: Dict, sign: int = 1) -> None:
    for (i, instance), n in delta.items():
        wrapper = _COUNTED[i]
        if instance is None:
            wrapper.launches += sign * n
        else:
            wrapper.instance_launches[instance] += sign * n


def _map(fn: Callable, tree):
    """fn over the tensors of nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _fill(name: str, static, value) -> None:
    """Copy ``value`` into the static buffers of the same structure."""
    if isinstance(static, torch.Tensor):
        if static.shape != value.shape or static.dtype != value.dtype:
            raise ValueError(
                f"step {name!r} was captured for {static.dtype} "
                f"{tuple(static.shape)}, given {value.dtype} "
                f"{tuple(value.shape)}")
        static.copy_(value)
    elif isinstance(static, dict):
        if static.keys() != value.keys():
            raise ValueError(f"step {name!r} was captured with inputs "
                             f"{sorted(static)}, given {sorted(value)}")
        for k in static:
            _fill(name, static[k], value[k])
    elif isinstance(static, (list, tuple)):
        for s, v in zip(static, value, strict=True):
            _fill(name, s, v)


@dataclass
class CapturedStep:
    graph: torch.cuda.CUDAGraph
    inputs: Dict
    outputs: object
    launches: Dict  # the kernel launches of one replay
    capture_s: float  # capture and instantiation, host seconds
    replays: int = 0


class StepGraphs:
    """Capture-and-replay runner of step bodies on one device.

    ``generators``: the CUDA generators that bodies draw from besides
    torch's default one. ``enabled=False`` calls every body eagerly on the
    card too (the reference that graphs must equal)."""

    def __init__(self, device, generators: Sequence[torch.Generator] = (),
                 enabled: bool = True):
        self.device = torch.device(device)
        self.capture = enabled and self.device.type == "cuda"
        self.generators = list(generators)
        self.steps: Dict[str, CapturedStep] = {}
        self._stream = None
        self._pool = None

    def __call__(self, name: str, body: Callable, **inputs):
        if not self.capture:
            return body(**inputs)
        # step/critic, step/train, ...; the selection's graph: step/select
        with span("step/" + name.split("_")[0]):
            step = self.steps.get(name)
            if step is None:
                return self._first_call(name, body, inputs)
            _fill(name, step.inputs, inputs)
            step.graph.replay()
            _add_launches(step.launches)
            step.replays += 1
            return _map(torch.Tensor.clone, step.outputs)

    def _first_call(self, name: str, body: Callable, inputs: Dict):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            result = body(**inputs)
        current.wait_stream(self._stream)

        static = _map(torch.Tensor.clone, inputs)
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        rng = self._rng_states()
        before = _launch_counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                outputs = body(**static)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of step {name!r} failed: {e}") from e
        finally:
            after = _launch_counts()
            delta = {k: after[k] - before[k] for k in before}
            _add_launches(delta, -1)
        capture_s = time.perf_counter() - t0
        moved = [i for i, (a, b) in enumerate(zip(rng, self._rng_states()))
                 if not torch.equal(a, b)]
        if moved:
            raise RuntimeError(f"capturing step {name!r} moved generators "
                               f"{moved} (0: torch's default CUDA one)")
        self.steps[name] = CapturedStep(graph, static, outputs, delta,
                                        capture_s)
        return result

    def _rng_states(self):
        return [torch.cuda.get_rng_state(self.device)] + [
            g.get_state() for g in self.generators]

    def stats(self) -> Dict[str, Dict]:
        """Per captured step: capture seconds, replays, and the launches of
        one replay by kernel wrapper (flash forward, flash backward, axis
        MLP, int8 GEMM)."""
        return {name: dict(capture_s=s.capture_s, replays=s.replays,
                           launches=[s.launches[(i, None)]
                                     for i in range(len(_COUNTED))])
                for name, s in self.steps.items()}
