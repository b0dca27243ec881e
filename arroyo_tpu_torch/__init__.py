"""arroyo-tpu on PyTorch and CUDA: the port of the ``arroyo_tpu`` stream
processor to one NVIDIA H100.

This package imports torch and numpy and never JAX or ``arroyo_tpu``; it
keeps its own copy of every module it needs, each named as its JAX
counterpart. This slice runs the Nexmark q7 path: nexmark source ->
projection/filter -> watermark -> key -> shuffle -> tumbling aggregate ->
vec sink, with the window state on the GPU, updated and read by
hand-written CUDA kernels (ops/kernels.py, csrc/slot_agg.cu).

Entry point: ``arroyo_tpu_torch.engine.run_graph(graph, device=None)``; the
device defaults to CUDA and the CPU is used only when asked for by name.
"""

__version__ = "0.1.0"

from .batch import Batch, Field, Schema  # noqa: F401
from .graph import EdgeType, Graph, Node, OpName  # noqa: F401
from .types import Signal, SignalKind, TaskInfo, Watermark  # noqa: F401
