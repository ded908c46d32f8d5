"""Internal op graph IR (counterpart of ``nezha_tpu/graph``).

A small explicit graph IR (`Graph`, `Node`) whose programs evaluate as
torch ops on an explicit device (`to_callable`), lower to a ``torch.fx``
program whose code is their text form (`lower_fx`, the counterpart of
JAX's ``lower_stablehlo``) bound to example shapes by `compile_graph`, and
derive their backward from the same graph (`grad_callable`, through
``torch.autograd.grad``). Its ``flash_attention`` node runs the port's
hand-written flash kernels on CUDA tensors.
"""

from nezha_tpu_torch.graph.graph import OP_SET, Graph, Node, Sym
from nezha_tpu_torch.graph.lower import (compile_graph, grad_callable,
                                         lower_fx, to_callable,
                                         to_sharded_callable,
                                         value_and_grad_callable)

__all__ = ["Graph", "Node", "OP_SET", "Sym", "compile_graph",
           "grad_callable", "lower_fx", "to_callable", "to_sharded_callable",
           "value_and_grad_callable"]
