"""mimrl_tpu_torch: the PyTorch / CUDA (H100) port of ``mimrl_tpu``.

The package mirrors ``mimrl_tpu``'s layout (``core``, ``data``,
``models``, ``ops``, ``eval``) and imports nothing from it: host modules
it needs are kept here as its own copies. Every TPU (Pallas) kernel on a
ported path is a hand-written CUDA kernel under ``ops/csrc``, built with
``nvcc`` at first use.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they raise when CUDA is absent instead of falling back.
"""
