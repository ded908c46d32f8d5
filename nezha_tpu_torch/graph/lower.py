"""Lowering: Graph IR -> torch ops on an explicit device (counterpart of
``nezha_tpu/graph/lower.py``).

The graph interprets into torch ops, one node at a time (the graph is
already in SSA order); autograd comes from ``torch.autograd.grad`` over
the placeholders (:func:`grad_callable`), so the backward is derived from
the same IR. Each op has JAX's semantics:

- binary ops promote as ``jnp`` does (``torch.promote_types`` of the two
  dtypes, whatever their ranks: a bf16 tensor times an fp32 scalar
  constant is fp32); constants take JAX's 32-bit dtypes;
- ``conv2d`` takes NHWC activations and HWIO weights, with "SAME" padding
  split as XLA splits it (explicit pads where the sides differ);
- ``layernorm`` and ``batchnorm`` take fp32 statistics and the biased
  variance, and cast back to the input dtype; ``batchnorm`` normalizes
  over N, H, W with the batch's statistics;
- ``flash_attention`` with ``impl`` "auto" or "pallas" runs the flash
  kernels (``ops/cuda/flash_attention.py``): on CUDA tensors the forward
  kernel, and in the backward the delta pre-pass, the dQ and the dK/dV
  kernels; on CPU tensors their plain versions. ``impl="xla"`` is the
  composed ``ops/attention.py`` path under the causal mask;
- ``all_reduce``, ``reduce_scatter`` and ``all_gather`` act over the
  shards of a one-process mesh (:func:`to_sharded_callable`): every
  shard evaluates a node, then the collective runs across them
  (``parallel/mesh.py``: reduced in rank order on shard 0's device).

:func:`lower_fx` is the counterpart of JAX's ``lower_stablehlo``: the
program as a ``torch.fx.GraphModule``, whose ``.code`` is its text form
and whose constants are buffers on the device; :func:`compile_graph`
binds it to its example shapes. Nothing here calls ``torch.compile``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nezha_tpu_torch.graph.graph import Graph
from nezha_tpu_torch.nn.layers import avg_pool, max_pool, resolve_pads
from nezha_tpu_torch.ops import activations
from nezha_tpu_torch.ops.attention import causal_mask, dot_product_attention

COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather")
# numpy dtypes JAX (without x64) narrows.
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def torch_dtype(name) -> torch.dtype:
    """A JAX dtype string ("float32", "bfloat16", "int32", ...) -> the
    torch dtype."""
    return getattr(torch, str(name))


def constant_tensor(value, device=None) -> torch.Tensor:
    """A constant node's value as JAX holds it: 64-bit numpy narrowed to
    32 bits."""
    arr = np.asarray(value)
    arr = arr.astype(_NARROW.get(arr.dtype, arr.dtype))
    return torch.as_tensor(arr, device=device)


def _promote(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x if x.dtype == dt else x.to(dt) for x in xs]


def _binary(fn):
    def op(a, b):
        a, b = _promote(a, b)
        return fn(a, b)
    op.__name__ = fn.__name__
    return op


def _axes(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _nhwc(fn, x, *args):
    return fn(x.permute(0, 3, 1, 2), *args).permute(0, 2, 3, 1)


def conv2d(x, w, stride=(1, 1), padding="SAME", groups=1):
    """NHWC ``x`` by HWIO ``w`` (``lax.conv_general_dilated``)."""
    x, w = _promote(x, w)
    xc = x.permute(0, 3, 1, 2)
    pads = resolve_pads(padding, xc.shape[2:], w.shape[:2], tuple(stride))
    (lh, hh), (lw, hw) = pads
    if lh == hh and lw == hw:
        sym = (lh, lw)
    else:
        xc, sym = F.pad(xc, (lw, hw, lh, hh)), (0, 0)
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(stride),
                   padding=sym, groups=groups)
    return out.permute(0, 2, 3, 1)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    return F.layer_norm(xf, xf.shape[-1:], scale.float(), bias.float(),
                        eps).to(x.dtype)


def batchnorm(x, scale, bias, eps=1e-5):
    """Training-mode batch norm over N, H, W of NHWC ``x``."""
    return _nhwc(lambda t: F.batch_norm(t.float(), None, None, scale.float(),
                                        bias.float(), training=True,
                                        eps=eps), x).to(x.dtype)


def flash_attention(q, k, v, causal=True, scale=None, impl="auto"):
    """The fused-attention node: the flash kernels ("auto", "pallas") or
    the composed path ("xla")."""
    if impl in ("auto", "pallas"):
        from nezha_tpu_torch.ops.cuda import flash_attention as flash
        return flash(q, k, v, causal=causal, scale=scale)
    mask = (causal_mask(q.shape[2], k.shape[2], device=q.device)
            if causal else None)
    return dot_product_attention(q, k, v, mask=mask, scale=scale)


def _take(table, ids, axis=0):
    flat = torch.index_select(table, axis, ids.reshape(-1).long())
    shape = (tuple(table.shape[:axis]) + tuple(ids.shape)
             + tuple(table.shape[axis + 1:]))
    return flat.reshape(shape)


def _slice(x, start, limit, strides=None):
    strides = strides or (1,) * len(start)
    return x[tuple(slice(s, e, st) for s, e, st in zip(start, limit, strides))]


def _reduce(fn):
    def op(x, axis=None, keepdims=False):
        return fn(x, dim=_axes(x, axis), keepdim=keepdims)
    return op


# op name -> fn(*inputs, **attrs): every op of OP_SET but placeholder,
# constant and the collectives.
OPS: Dict[str, Callable] = {
    "add": _binary(torch.add), "sub": _binary(torch.sub),
    "mul": _binary(torch.mul), "div": _binary(torch.div),
    "neg": torch.neg, "pow": _binary(torch.pow),
    "matmul": _binary(torch.matmul), "conv2d": conv2d,
    "relu": activations.relu,
    "gelu": lambda x, approximate=True: activations.gelu(
        x, approximate=approximate),
    "tanh": torch.tanh, "exp": torch.exp, "log": torch.log,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x, axis=-1: torch.softmax(x, dim=axis),
    "log_softmax": lambda x, axis=-1: torch.log_softmax(x, dim=axis),
    "layernorm": layernorm, "batchnorm": batchnorm,
    "max_pool2d": lambda x, window, stride, padding="SAME": _nhwc(
        max_pool, x, window, stride, padding),
    "avg_pool2d": lambda x, window, stride, padding="SAME": _nhwc(
        avg_pool, x, window, stride, padding),
    "reshape": lambda x, shape: x.reshape(shape),
    "transpose": lambda x, perm: x.permute(perm),
    "broadcast_to": lambda x, shape: x.expand(shape),
    "sum": _reduce(torch.sum), "mean": _reduce(torch.mean),
    "max": _reduce(torch.amax),
    "cast": lambda x, dtype: x.to(torch_dtype(dtype)),
    "concat": lambda *xs, axis=0: torch.cat(_promote(*xs), dim=axis),
    "slice": _slice, "take": _take,
    "take_along": lambda x, idx, axis: torch.gather(
        x, axis, idx.long().unsqueeze(axis)).squeeze(axis),
    "flash_attention": flash_attention,
}


def _named(name: str, fn: Callable) -> Callable:
    """``fn`` under the name ``ir_<op>``, the name a node's call carries
    in :func:`lower_fx`'s code."""
    def op(*args, **attrs):
        return fn(*args, **attrs)
    op.__name__ = op.__qualname__ = f"ir_{name}"
    return op


OPS = {name: _named(name, fn) for name, fn in OPS.items()}


def _collective(op: str, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    from nezha_tpu_torch.parallel.mesh import all_gather, psum, psum_scatter
    if op == "all_reduce":
        return psum(xs)
    if op == "reduce_scatter":
        return psum_scatter(xs)
    return all_gather(xs)


class _Constants:
    """Each constant node's tensor, made once per device."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self._by_device: Dict[torch.device, Dict[int, torch.Tensor]] = {}

    def on(self, device) -> Dict[int, torch.Tensor]:
        device = torch.device(device)
        if device not in self._by_device:
            self._by_device[device] = {
                n.id: constant_tensor(n.attrs["value"], device)
                for n in self.graph.nodes if n.op == "constant"}
        return self._by_device[device]


def _device_of(args, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    for a in args:
        if torch.is_tensor(a):
            return a.device
    return torch.device("cpu")


def _as_tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    arr = np.asarray(x)
    return torch.as_tensor(arr.astype(_NARROW.get(arr.dtype, arr.dtype)),
                           device=device)


def _evaluate(graph: Graph, shard_args: Sequence[Sequence], devices,
              consts: _Constants) -> List[tuple]:
    """Evaluate ``graph`` on every shard in lockstep: ``shard_args[r]``
    the placeholders' values on shard r. -> each shard's outputs."""
    m = len(shard_args)
    for args in shard_args:
        if len(args) != len(graph.placeholders):
            raise TypeError(
                f"graph {graph.name} takes {len(graph.placeholders)} inputs, "
                f"got {len(args)}")
    vals: List[List] = [[None] * len(graph.nodes) for _ in range(m)]
    feeds = [dict(zip(graph.placeholders,
                      [_as_tensor(a, d) for a in args]))
             for args, d in zip(shard_args, devices)]
    cs = [consts.on(d) for d in devices]
    for node in graph.nodes:
        if node.op in COLLECTIVES:
            outs = _collective(node.op, [v[node.inputs[0]] for v in vals])
            for r in range(m):
                vals[r][node.id] = outs[r]
            continue
        for r in range(m):
            if node.op == "placeholder":
                vals[r][node.id] = feeds[r][node.id]
            elif node.op == "constant":
                vals[r][node.id] = cs[r][node.id]
            else:
                vals[r][node.id] = OPS[node.op](
                    *[vals[r][i] for i in node.inputs], **node.attrs)
    return [tuple(v[i] for i in graph.outputs) for v in vals]


def to_callable(graph: Graph, device=None) -> Callable:
    """Interpret the graph as a pure function of its placeholders (in
    declaration order), on ``device`` (default: the first tensor
    argument's, else the CPU). Single output -> value; multiple ->
    tuple. A collective node raises ``ValueError`` (it needs a mesh:
    :func:`to_sharded_callable`)."""
    consts = _Constants(graph)

    def fn(*args):
        dev = _device_of(args, device)
        for node in graph.nodes:
            if node.op in COLLECTIVES:
                raise ValueError(f"graph {graph.name}: {node.op} needs a "
                                 f"mesh (to_sharded_callable)")
        outs = _evaluate(graph, [args], [dev], consts)[0]
        return outs[0] if len(outs) == 1 else outs

    fn.__name__ = graph.name
    return fn


def to_sharded_callable(graph: Graph, mesh) -> Callable:
    """The graph over the shards of a one-process mesh (``parallel.mesh.
    Mesh``), JAX's ``shard_map`` of ``to_callable``: each argument is a
    list of per-shard tensors (shard r's on ``mesh.devices[r]``); ->
    per-shard lists, a tuple of them for several outputs. Collective
    nodes reduce, scatter and gather across the shards."""
    consts = _Constants(graph)

    def fn(*args):
        m = mesh.size
        for a in args:
            if len(a) != m:
                raise ValueError(f"graph {graph.name}: an argument holds "
                                 f"{len(a)} shards, the mesh {m}")
        per_shard = [[a[r] for a in args] for r in range(m)]
        outs = _evaluate(graph, per_shard, list(mesh.devices), consts)
        lists = tuple(list(o) for o in zip(*outs))
        return lists[0] if len(lists) == 1 else lists

    fn.__name__ = graph.name
    return fn


def _example_shapes(graph: Graph):
    return [(tuple(graph.nodes[p].attrs["shape"]),
             torch_dtype(graph.nodes[p].attrs["dtype"]))
            for p in graph.placeholders]


def lower_fx(graph: Graph, device=None) -> torch.fx.GraphModule:
    """Graph -> ``torch.fx.GraphModule`` (the counterpart of JAX's
    ``lower_stablehlo``: ``.code`` is the program's text form, one call
    per IR node). Constants are buffers on ``device`` (default CPU).
    Collective nodes need a mesh and raise ``ValueError``."""
    root = torch.nn.Module()
    fx = torch.fx.Graph()
    env: Dict[int, torch.fx.Node] = {}
    for node in graph.nodes:
        if node.op in COLLECTIVES:
            raise ValueError(f"graph {graph.name}: {node.op} needs a mesh")
        if node.op == "placeholder":
            stem = re.sub(r"\W+", "_", node.name).strip("_") or "input"
            env[node.id] = fx.placeholder(f"{stem}_{node.id}")
        elif node.op == "constant":
            name = f"const{node.id}"
            root.register_buffer(name, constant_tensor(node.attrs["value"],
                                                       device))
            env[node.id] = fx.get_attr(name)
        else:
            env[node.id] = fx.call_function(
                OPS[node.op], tuple(env[i] for i in node.inputs),
                dict(node.attrs))
    outs = [env[i] for i in graph.outputs]
    fx.output(outs[0] if len(outs) == 1 else tuple(outs))
    return torch.fx.GraphModule(root, fx, class_name=graph.name)


class CompiledGraph:
    """A graph bound to its example shapes and dtypes, its constants on
    ``device`` once (the counterpart of JAX's compiled executable):
    calling it with other shapes raises ``TypeError``."""

    def __init__(self, graph: Graph, example_args: Sequence = None,
                 device=None):
        if example_args is None:
            self.shapes = _example_shapes(graph)
        else:
            self.shapes = [(tuple(a.shape), a.dtype if torch.is_tensor(a)
                            else torch_dtype(np.asarray(a).dtype))
                           for a in example_args]
        self.device = _device_of(example_args or (), device)
        self.module = lower_fx(graph, self.device)
        self.name = graph.name

    def __call__(self, *args):
        got = [(tuple(a.shape), a.dtype) for a in
               (_as_tensor(a, self.device) for a in args)]
        if got != self.shapes:
            raise TypeError(f"graph {self.name} was compiled for "
                            f"{self.shapes}, got {got}")
        return self.module(*[_as_tensor(a, self.device) for a in args])


def compile_graph(graph: Graph, example_args: Sequence = None,
                  device=None) -> CompiledGraph:
    """Graph -> a program bound to ``example_args``' shapes (default:
    the placeholders' declared shapes and dtypes) with its constants on
    the device (``device``, else the examples' device, else the CPU)."""
    return CompiledGraph(graph, example_args, device)


def _check_scalar(loss, graph: Graph):
    if getattr(loss, "ndim", 0) != 0:
        raise ValueError(
            f"grad_callable needs a scalar first output, got shape "
            f"{tuple(getattr(loss, 'shape', ()))} from graph {graph.name!r}")


def value_and_grad_callable(graph: Graph, wrt: Sequence[int] = (0,),
                            device=None) -> Callable:
    """-> fn(*args) = (first output, d(first output)/d(placeholders
    ``wrt``) as a tuple): ``jax.value_and_grad`` with a tuple
    ``argnums``. The first output must be a scalar; a placeholder the
    loss does not reach gets zeros."""
    fn = to_callable(graph, device)
    wrt = tuple(wrt)

    def vg(*args):
        args = list(args)
        with torch.enable_grad():
            for i in wrt:
                args[i] = _as_tensor(args[i], _device_of(args, device)
                                     ).detach().requires_grad_(True)
            out = fn(*args)
            loss = out[0] if isinstance(out, tuple) else out
            _check_scalar(loss, graph)
            grads = torch.autograd.grad(loss, [args[i] for i in wrt],
                                        allow_unused=True)
        grads = tuple(torch.zeros_like(args[i]) if g is None else g
                      for i, g in zip(wrt, grads))
        return loss.detach(), grads

    return vg


def grad_callable(graph: Graph, wrt: Sequence[int] = (0,)) -> Callable:
    """d(first output)/d(placeholders[wrt]) by ``torch.autograd.grad``
    over the placeholders; one ``wrt`` gives the gradient, several a
    tuple (``jax.grad``'s ``argnums``). The first output must be a scalar
    (a loss); raises ``ValueError`` otherwise."""
    vg = value_and_grad_callable(graph, wrt)
    single = len(tuple(wrt)) == 1

    def grad(*args):
        grads = vg(*args)[1]
        return grads[0] if single else grads

    return grad


__all__ = ["COLLECTIVES", "CompiledGraph", "OPS", "compile_graph",
           "constant_tensor", "grad_callable", "lower_fx", "to_callable",
           "to_sharded_callable", "torch_dtype", "value_and_grad_callable"]
