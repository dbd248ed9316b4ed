"""repro_torch — the push/pull graph framework on PyTorch and CUDA.

A port of the JAX package ``repro`` to one NVIDIA H100: the same graph
layouts, cost counters, direction policies, engine and algorithms on
tensors, with each Pallas TPU kernel of the path rewritten by hand in
CUDA C++ for sm_90a (``repro_torch.kernels``). Entry points build on the
card unless given ``device="cpu"``. This package imports neither JAX nor
anything of ``repro``.
"""

from . import api
from .graphs import build_graph, graph_from_arrays

__all__ = ["api", "build_graph", "graph_from_arrays"]
