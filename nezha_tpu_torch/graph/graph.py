"""Graph IR: nodes, ops, graph construction (counterpart of
``nezha_tpu/graph/graph.py``, copied op for op: a graph built by the same
calls has the same nodes, attrs, SSA order and ``repr`` in both packages).

A deliberately small SSA-ish IR: `Node`s name an op with input nodes and
static attributes; a `Graph` owns nodes, placeholders (inputs), and outputs.
No shapes are inferred here — shape/dtype checking happens when the graph is
evaluated by torch ops (`nezha_tpu_torch.graph.lower`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# The op names; lower.py evaluates each.
OP_SET = (
    "placeholder", "constant",
    "add", "sub", "mul", "div", "neg", "pow",
    "matmul", "conv2d",
    "relu", "gelu", "tanh", "exp", "log", "sigmoid",
    "softmax", "log_softmax", "layernorm", "batchnorm",
    "max_pool2d", "avg_pool2d",
    "reshape", "transpose", "broadcast_to", "sum", "mean", "max",
    "cast", "concat", "slice", "take", "take_along",
    "all_reduce", "reduce_scatter", "all_gather",  # collective graph ops
    "flash_attention",  # fused-attention node -> the flash kernels
)


@dataclasses.dataclass
class Node:
    id: int
    op: str
    inputs: Tuple[int, ...]
    attrs: Dict[str, Any]
    name: str

    def __repr__(self):
        ins = ", ".join(f"%{i}" for i in self.inputs)
        return f"%{self.id} = {self.op}({ins}) {self.attrs or ''}".rstrip()


class Graph:
    """Builder + container. Methods return `Node`s; operators are overloaded
    on a thin `Sym` wrapper for ergonomic construction."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: List[Node] = []
        self.placeholders: List[int] = []
        self.outputs: List[int] = []

    # -- construction ------------------------------------------------------

    def _add(self, op: str, inputs: Sequence["Sym | Node | int"],
             attrs: Optional[dict] = None, name: str = "") -> "Sym":
        if op not in OP_SET:
            raise ValueError(f"unknown op {op!r}")
        ids = tuple(self._node_id(i) for i in inputs)
        node = Node(len(self.nodes), op, ids, attrs or {}, name or op)
        self.nodes.append(node)
        return Sym(self, node.id)

    @staticmethod
    def _node_id(x) -> int:
        if isinstance(x, Sym):
            return x.id
        if isinstance(x, Node):
            return x.id
        return int(x)

    def placeholder(self, shape: Sequence[int], dtype: str = "float32",
                    name: str = "") -> "Sym":
        sym = self._add("placeholder", [],
                        {"shape": tuple(shape), "dtype": dtype}, name or "input")
        self.placeholders.append(sym.id)
        return sym

    def constant(self, value, name: str = "") -> "Sym":
        return self._add("constant", [], {"value": np.asarray(value)}, name or "const")

    def output(self, *syms: "Sym") -> None:
        self.outputs.extend(self._node_id(s) for s in syms)

    # -- op helpers --------------------------------------------------------

    def matmul(self, a, b):
        return self._add("matmul", [a, b])

    def conv2d(self, x, w, stride=(1, 1), padding="SAME", groups=1):
        return self._add("conv2d", [x, w],
                         {"stride": tuple(stride), "padding": padding,
                          "groups": groups})

    def flash_attention(self, q, k, v, causal: bool = True, scale=None,
                        impl: str = "auto"):
        """Fused scaled-dot-product attention over [B, H, S, D] operands.

        The one IR node that lowers to hand-written kernels rather than
        composed tensor ops: ``impl="auto"`` and ``"pallas"`` run the
        flash kernels (``ops/cuda/flash_attention.py``: the forward, and
        the delta pre-pass, dQ and dK/dV kernels in the backward) on CUDA
        tensors and their plain versions on CPU tensors; ``"xla"`` is the
        composed softmax(QK^T)V (the S x S scores materialized)."""
        if impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown flash_attention impl {impl!r}")
        return self._add("flash_attention", [q, k, v],
                         {"causal": causal, "scale": scale, "impl": impl})

    def relu(self, x):
        return self._add("relu", [x])

    def gelu(self, x, approximate: bool = True):
        return self._add("gelu", [x], {"approximate": approximate})

    def softmax(self, x, axis=-1):
        return self._add("softmax", [x], {"axis": axis})

    def log_softmax(self, x, axis=-1):
        return self._add("log_softmax", [x], {"axis": axis})

    def layernorm(self, x, scale, bias, eps=1e-5):
        return self._add("layernorm", [x, scale, bias], {"eps": eps})

    def batchnorm(self, x, scale, bias, eps=1e-5):
        """Training-mode batch norm over N,H,W (NHWC): batch statistics
        computed in-graph; running-stat tracking is the trainer's concern."""
        return self._add("batchnorm", [x, scale, bias], {"eps": eps})

    def max_pool2d(self, x, window: int, stride: int, padding="SAME"):
        return self._add("max_pool2d", [x],
                         {"window": int(window), "stride": int(stride),
                          "padding": padding})

    def avg_pool2d(self, x, window: int, stride: int, padding="SAME"):
        return self._add("avg_pool2d", [x],
                         {"window": int(window), "stride": int(stride),
                          "padding": padding})

    def concat(self, xs, axis: int = 0):
        return self._add("concat", list(xs), {"axis": axis})

    def take(self, table, ids, axis=0):
        return self._add("take", [table, ids], {"axis": axis})

    def take_along(self, x, idx, axis):
        """Pick one element along ``axis`` per position of ``idx`` (the
        target-logit gather of a CE loss); output drops ``axis``."""
        return self._add("take_along", [x, idx], {"axis": axis})

    def slice(self, x, start, limit, strides=None):
        return self._add("slice", [x], {"start": tuple(start),
                                        "limit": tuple(limit),
                                        "strides": strides})

    def reshape(self, x, shape):
        return self._add("reshape", [x], {"shape": tuple(shape)})

    def transpose(self, x, perm):
        return self._add("transpose", [x], {"perm": tuple(perm)})

    def sum(self, x, axis=None, keepdims=False):
        return self._add("sum", [x], {"axis": axis, "keepdims": keepdims})

    def mean(self, x, axis=None, keepdims=False):
        return self._add("mean", [x], {"axis": axis, "keepdims": keepdims})

    def max(self, x, axis=None, keepdims=False):
        return self._add("max", [x], {"axis": axis, "keepdims": keepdims})

    def exp(self, x):
        return self._add("exp", [x])

    def log(self, x):
        return self._add("log", [x])

    def cast(self, x, dtype: str):
        return self._add("cast", [x], {"dtype": dtype})

    def all_reduce(self, x, axis_name: str = "dp"):
        return self._add("all_reduce", [x], {"axis_name": axis_name})

    def reduce_scatter(self, x, axis_name: str = "dp"):
        return self._add("reduce_scatter", [x], {"axis_name": axis_name})

    def all_gather(self, x, axis_name: str = "dp"):
        return self._add("all_gather", [x], {"axis_name": axis_name})

    # -- introspection -----------------------------------------------------

    def __repr__(self):
        lines = [f"graph {self.name}:"]
        lines += [f"  {n!r}" for n in self.nodes]
        lines.append(f"  outputs: {['%%%d' % o for o in self.outputs]}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class Sym:
    """Handle to a node within a graph, with operator sugar."""
    graph: Graph
    id: int

    def _bin(self, op, other):
        if not isinstance(other, Sym):
            other = self.graph.constant(other)
        return self.graph._add(op, [self, other])

    def __add__(self, other):
        return self._bin("add", other)

    def __sub__(self, other):
        return self._bin("sub", other)

    def __mul__(self, other):
        return self._bin("mul", other)

    def __truediv__(self, other):
        return self._bin("div", other)

    def __matmul__(self, other):
        return self._bin("matmul", other)

    def __pow__(self, other):
        return self._bin("pow", other)

    def __neg__(self):
        return self.graph._add("neg", [self])
