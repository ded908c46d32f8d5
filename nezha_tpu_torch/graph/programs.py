"""Training programs authored in the Graph IR (counterpart of
``nezha_tpu/graph/programs.py``).

The forward, the loss and the optimizer update of each config are built
as graphs, the backward comes from ``torch.autograd.grad`` over the
interpreted IR (``graph/lower.py``: :func:`value_and_grad_callable`), and
the whole step runs through the runtime ``Executor``'s cache. The GPT-2
program's attention is the IR's ``flash_attention`` node, which runs the
port's flash kernels on CUDA tensors (BERT's too, non-causal); "xla"
keeps attention composed of IR ops.

State layouts are JAX's, so a checkpoint crosses between the packages:
nested dicts keyed as the JAX parameter tree (``{"params", "vel"}`` for
the momentum programs, ``{"params", "mu", "nu", "step"}`` for AdamW,
ZeRO-1's ``{"flat", "vel"}``), flattened in JAX's order (dict keys
sorted at every level, :func:`tree_flatten_with_path`). The leaves are
torch tensors on the state's device; ZeRO-1's ``flat`` and ``vel`` are
lists of per-shard chunks (``[n_pad / M]`` on shard r's device), the
optimizer state never whole on a device.

The data-parallel programs run on a one-process mesh
(``parallel/mesh.py``: ``[cpu] * M`` in tests, ``[cuda:0] * M`` on one
card): every shard evaluates its loss graph on its rows of the batch,
then the update graphs run in lockstep over the shards
(:func:`~nezha_tpu_torch.graph.lower.to_sharded_callable`), their
``all_reduce`` / ``reduce_scatter`` / ``all_gather`` nodes crossing the
shards. The state is replicated: shard 0's copy is the state kept.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from nezha_tpu_torch.graph.graph import Graph
from nezha_tpu_torch.graph.lower import (to_callable, to_sharded_callable,
                                         value_and_grad_callable)
from nezha_tpu_torch.runtime.executor import Executor

# Parameter order for an L-layer MLP: w0, b0, w1, b1, ..., wH, bH (head last)
# — matches models.MLP's {"fc0": {"w","b"}, ..., "head": {"w","b"}} layout.


# -- trees: JAX's flatten order over nested dicts -----------------------------

def tree_flatten_with_path(tree) -> Tuple[List[Tuple[tuple, object]], object]:
    """-> ([(path, leaf)], treedef): dict keys sorted at every level, as
    ``jax.tree_util.tree_flatten_with_path`` orders them."""
    if isinstance(tree, dict):
        out, skel = [], {}
        for k in sorted(tree):
            sub, skel[k] = tree_flatten_with_path(tree[k])
            out += [((k,) + p, leaf) for p, leaf in sub]
        return out, skel
    return [((), tree)], None


def tree_flatten(tree) -> Tuple[list, object]:
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef, leaves) -> object:
    it = iter(leaves)

    def build(skel):
        if isinstance(skel, dict):
            return {k: build(skel[k]) for k in sorted(skel)}
        return next(it)

    return build(treedef)


def tree_map(fn: Callable, *trees):
    leaves = [tree_flatten(t)[0] for t in trees]
    return tree_unflatten(tree_flatten(trees[0])[1],
                          [fn(*xs) for xs in zip(*leaves)])


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a dict path: ``['h0']['attn']``."""
    return "".join(f"[{k!r}]" for k in path)


def _leaf_dtype(leaf) -> str:
    """A leaf's dtype as JAX names it ("float32", "bfloat16", ...)."""
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _feed(x, device) -> torch.Tensor:
    """A batch array on ``device`` in JAX's 32-bit dtypes."""
    if not torch.is_tensor(x):
        arr = np.asarray(x)
        if arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        elif arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(arr))
    return x.to(device)


def _state_device(state) -> torch.device:
    for leaf in tree_leaves(state):
        if torch.is_tensor(leaf):
            return leaf.device
        if isinstance(leaf, list) and leaf and torch.is_tensor(leaf[0]):
            return leaf[0].device
    return torch.device("cpu")


# -- module <-> JAX parameter tree -------------------------------------------

def module_param_tree(model: torch.nn.Module) -> dict:
    """A port module's parameters as the JAX parameter tree (nested dicts
    keyed ``h0``/``attn``/``qkv``/``w``, conv kernels HWIO): fp32 copies
    on the module's device, the graph engine's initial params."""
    from nezha_tpu_torch.models.convert import jax_leaf_names

    sd = model.state_dict()
    tree: dict = {}
    for name, (key, conv) in jax_leaf_names(model).items():
        if not key.startswith("params/"):
            continue
        t = sd[name].detach().float()
        t = t.permute(2, 3, 1, 0) if conv else t
        node = tree
        *heads, leaf = key[len("params/"):].split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t.contiguous().clone()
    return tree


def load_param_tree(model: torch.nn.Module, params: dict) -> None:
    """Copy a JAX-layout parameter tree into a port module's parameters
    (the inverse of :func:`module_param_tree`)."""
    from nezha_tpu_torch.models.convert import jax_leaf_names

    flat = {"/".join(p): leaf
            for p, leaf in tree_flatten_with_path(params)[0]}
    sd = model.state_dict()
    with torch.no_grad():
        for name, (key, conv) in jax_leaf_names(model).items():
            if not key.startswith("params/"):
                continue
            t = torch.as_tensor(flat[key[len("params/"):]])
            t = t.permute(3, 2, 0, 1) if conv else t
            sd[name].copy_(t)


# -- the MLP ------------------------------------------------------------------

def mlp_param_names(n_layers: int) -> Sequence[str]:
    names = [f"fc{i}" for i in range(n_layers - 1)] + ["head"]
    return names


def _mlp_layout(dims: Sequence[int]):
    """Shared param-layout scaffolding for the MLP step builders (single and
    dp must agree exactly or their parity guarantee is meaningless):
    (param shapes, flatten tree->list, unflatten list->tree)."""
    names = mlp_param_names(len(dims) - 1)
    shapes = [(din, dout) for din, dout in zip(dims[:-1], dims[1:])]
    shapes += [(dout,) for dout in dims[1:]]

    def flatten(tree) -> list:
        return [tree[n][k] for n in names for k in ("w", "b")]

    def unflatten(flat) -> dict:
        it = iter(flat)
        return {n: {"w": next(it), "b": next(it)} for n in names}

    return shapes, flatten, unflatten


def mlp_loss_graph(dims: Sequence[int], batch: int) -> Graph:
    """IR graph: (w0, b0, ..., image[B, in], onehot[B, classes]) -> loss.

    The label one-hot is a placeholder (host-side data transform), keeping
    the graph free of integer gather ops.
    """
    g = Graph("mlp_loss")
    ws, bs = [], []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        ws.append(g.placeholder((din, dout), name=f"w{i}"))
        bs.append(g.placeholder((dout,), name=f"b{i}"))
    x = g.placeholder((batch, dims[0]), name="image")
    onehot = g.placeholder((batch, dims[-1]), name="onehot")

    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = (h @ w) + b
        if i < len(ws) - 1:
            h = g.relu(h)
    logp = g.log_softmax(h, axis=-1)
    nll = -g.mean(g.sum(logp * onehot, axis=1))
    g.output(nll)
    return g


def momentum_update_graph(shape: Sequence[int], lr: float,
                          beta: float) -> Graph:
    """IR graph: (param, velocity, grad) -> (new_param, new_velocity)."""
    g = Graph("momentum_update")
    p = g.placeholder(shape, name="param")
    v = g.placeholder(shape, name="velocity")
    grad = g.placeholder(shape, name="grad")
    v_new = v * beta + grad
    p_new = p - v_new * lr
    g.output(p_new, v_new)
    return g


def clip_scale_graph(shapes: Sequence[Tuple[int, ...]],
                     clip_norm: float) -> Graph:
    """IR graph: (*flat_grads) -> clip scale = min(1, C / (||g|| + 1e-6)).

    ``optim.clip_by_global_norm``'s exact math (same eps) authored as IR
    nodes. The IR has no min op; min(1, r) = 1 - relu(1 - r), exact for
    every r down to ~2^-24 and for all r >= 1 — including huge
    clip_norms, where the algebraically-equal r - relu(r - 1) collapses to
    0 (r-1 rounds to r once r > 2^24, so the subtraction cancels)."""
    g = Graph("clip_scale")
    total = None
    for i, s in enumerate(shapes):
        gr = g.placeholder(s, name=f"g{i}")
        sq = g.sum(gr * gr)
        total = sq if total is None else total + sq
    norm = total ** 0.5
    r = g.constant(np.float32(clip_norm)) / (norm + 1e-6)
    g.output(-g.relu(-r + 1.0) + 1.0)
    return g


def scale_grad_graph(shape: Sequence[int]) -> Graph:
    """IR graph: (grad, scale) -> grad * scale (scalar broadcast)."""
    g = Graph("scale_grad")
    gr = g.placeholder(shape, name="grad")
    sc = g.placeholder((), name="scale")
    g.output(gr * sc)
    return g


def _make_clip(ordered_shapes, clip_norm):
    """(clip_fn, per-shape scale_fns); both None when clipping is off.
    ``ordered_shapes`` must match the flat-gradient order the step passes
    to clip_fn."""
    if clip_norm is None:
        return None, None
    ordered_shapes = [tuple(s) for s in ordered_shapes]
    clip_fn = to_callable(clip_scale_graph(ordered_shapes, clip_norm))
    scale_fns = {s: to_callable(scale_grad_graph(s))
                 for s in set(ordered_shapes)}
    return clip_fn, scale_fns


def _apply_clip(clip_fn, scale_fns, grads):
    if clip_fn is None:
        return grads
    sc = clip_fn(*grads)
    return [scale_fns[tuple(g_.shape)](g_, sc) for g_ in grads]


def _dp_world(mesh, global_batch: int) -> Tuple[int, int]:
    """(world, local_batch) for a dp graph engine; loud on ragged batch."""
    world = mesh.size
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"mesh axis {mesh.axis_name}={world}")
    return world, global_batch // world


def _shard_rows(x, mesh) -> List[torch.Tensor]:
    """Shard r's rows of a batch array (the leading dim split M ways),
    on its device."""
    m = mesh.size
    n = _shape(x)[0] // m
    return [_feed(x[r * n:(r + 1) * n], d) for r, d in
            enumerate(mesh.devices)]


def _replicas(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    return [t if t.device == d else t.to(d) for d in mesh.devices]


def _pmean(losses: List[torch.Tensor]) -> torch.Tensor:
    """The mean of the shards' losses (a metric), summed in rank order on
    shard 0's device."""
    from nezha_tpu_torch.parallel.mesh import psum
    return psum(losses)[0] / len(losses)


def _dp_step(vg, upd_fns, feed_keys, mesh, n_slots: int):
    """Shared dp body (MLP, ResNet and the AdamW programs must not drift):
    each shard's loss and gradients from its rows, then the per-shape dp
    update graphs in lockstep over the shards (the all_reduce is an IR
    node inside them), the loss a pmean'd metric.

    ``step(flat_state, extra, b) -> (new slot lists, loss)``:
    ``flat_state`` is ``n_slots`` lists of leaves (params first),
    ``extra`` the scalars every update takes after the gradient."""

    def step(flat_state, extra, b):
        params = flat_state[0]
        feeds = [_shard_rows(b[k], mesh) for k in feed_keys]
        losses, grads = [], []
        for r, dev in enumerate(mesh.devices):
            ps = [p if p.device == dev else p.to(dev) for p in params]
            loss, gr = vg(*ps, *[f[r] for f in feeds])
            losses.append(loss)
            grads.append(gr)
        new = [[] for _ in range(n_slots)]
        with torch.no_grad():
            for i, leaves in enumerate(zip(*flat_state)):
                args = [_replicas(x, mesh) for x in leaves]
                args.append([grads[r][i] for r in range(mesh.size)])
                args += [_replicas(e, mesh) for e in extra]
                outs = upd_fns[tuple(leaves[0].shape)](*args)
                for k, out in enumerate(outs):
                    new[k].append(out[0])   # replicated: shard 0's copy
        return new, _pmean(losses)

    return step


def dp_momentum_update_graph(shape: Sequence[int], lr: float, beta: float,
                             axis_name: str, world: int) -> Graph:
    """IR graph: (param, velocity, LOCAL grad) -> (new_param, new_velocity)
    with the gradient all-reduce authored as an IR node.

    ``all_reduce(grad) * (1/world)`` is the mean over the ``axis_name`` mesh
    axis (the IR ships a sum collective; the static world size makes it a
    mean) — backward -> collective all-reduce -> optimizer, expressed
    entirely inside the op graph."""
    g = Graph("dp_momentum_update")
    p = g.placeholder(shape, name="param")
    v = g.placeholder(shape, name="velocity")
    grad_local = g.placeholder(shape, name="grad_local")
    grad = g.all_reduce(grad_local, axis_name=axis_name) * (1.0 / world)
    v_new = v * beta + grad
    p_new = p - v_new * lr
    g.output(p_new, v_new)
    return g


def make_mlp_graph_dp_train_step(dims: Sequence[int], global_batch: int,
                                 lr: float, mesh, beta: float = 0.9,
                                 axis: str = "dp",
                                 executor: Executor = None):
    """Data-parallel IR engine on a one-process mesh: each shard's IR loss
    graph -> autograd -> IR update graphs whose ``all_reduce`` nodes cross
    the shards, the batch leading-dim split over ``mesh``, params and
    velocity replicated. Equal to the single-device graph engine on the
    same global batch up to the order of the gradient sum
    (mean-of-shard-means == the global mean).

    ``state``/``batch`` layouts match :func:`make_mlp_graph_train_step`."""
    executor = executor or Executor()
    world, local_batch = _dp_world(mesh, global_batch)
    loss_graph = mlp_loss_graph(dims, local_batch)
    n_params = 2 * (len(dims) - 1)
    vg = value_and_grad_callable(loss_graph, tuple(range(n_params)))

    shapes, flatten, unflatten = _mlp_layout(dims)
    upd_fns = {s: to_sharded_callable(
        dp_momentum_update_graph(s, lr, beta, axis, world), mesh)
        for s in {tuple(s) for s in shapes}}
    body = _dp_step(vg, upd_fns, ("image", "onehot"), mesh, 2)

    def mapped(state, b):
        (new_p, new_v), loss = body(
            [flatten(state["params"]), flatten(state["vel"])], [], b)
        return {"params": unflatten(new_p), "vel": unflatten(new_v)}, loss

    def step(state, b):
        new_state, loss = executor.run(mapped, state, b)
        return new_state, {"loss": loss}

    step.loss_graph = loss_graph
    step.update_graph = dp_momentum_update_graph(
        tuple(shapes[0]), lr, beta, axis, world)  # introspection/tests
    step.executor = executor
    return step


# ---------------------------------------------------------------------------
# ZeRO-1 authored in the IR: "grad reduce-scatter + weight all-gather" as
# graph nodes. The optimizer state lives as ONE flat fp32 vector sharded
# over dp; each step is three IR programs composed per shard:
#
#   gather:  param_chunk --all_gather--> flat --slice/reshape--> tensors
#   flatten: grad tensors --reshape/concat(+zero pad)--> flat grads
#   update:  flat grads --reduce_scatter * 1/world--> local mean-grad
#            chunk -> momentum update on the LOCAL param/velocity chunk


def zero1_flatten_grads_graph(shapes: Sequence[Tuple[int, ...]],
                              n_pad: int) -> Graph:
    """IR graph: (*grad tensors) -> flat [n_pad] (zero-padded)."""
    g = Graph("zero1_flatten")
    pieces = []
    total = 0
    for i, s in enumerate(shapes):
        size = int(np.prod(s))
        total += size
        p = g.placeholder(s, name=f"g{i}")
        pieces.append(g.reshape(p, (size,)))
    if n_pad > total:
        pieces.append(g.constant(np.zeros(n_pad - total, np.float32)))
    g.output(g.concat(pieces, axis=0))
    return g


def zero1_gather_params_graph(shapes: Sequence[Tuple[int, ...]],
                              chunk_size: int, axis_name: str) -> Graph:
    """IR graph: (param_chunk [chunk_size]) --all_gather--> per-tensor
    params (the ZeRO-1 weight all-gather as an IR node)."""
    g = Graph("zero1_gather")
    chunk = g.placeholder((chunk_size,), name="param_chunk")
    flat = g.all_gather(chunk, axis_name=axis_name)
    outs, off = [], 0
    for s in shapes:
        size = int(np.prod(s))
        outs.append(g.reshape(g.slice(flat, (off,), (off + size,)), s))
        off += size
    g.output(*outs)
    return g


def zero1_update_graph(chunk_size: int, n_pad: int, lr: float, beta: float,
                       axis_name: str, world: int) -> Graph:
    """IR graph: (param_chunk, vel_chunk, flat_grads [n_pad]) ->
    (param_chunk', vel_chunk'): reduce_scatter to this rank's mean-grad
    chunk, then the momentum update on the LOCAL shard only — the
    optimizer state never exists unsharded (ZeRO-1's defining property)."""
    g = Graph("zero1_update")
    p = g.placeholder((chunk_size,), name="param_chunk")
    v = g.placeholder((chunk_size,), name="vel_chunk")
    fg = g.placeholder((n_pad,), name="flat_grads")
    gs = g.reduce_scatter(fg, axis_name=axis_name) * (1.0 / world)
    v2 = v * beta + gs
    p2 = p - v2 * lr
    g.output(p2, v2)
    return g


def _mlp_grad_shapes(dims: Sequence[int]):
    """Gradient order w0,b0,w1,b1,... (the loss graph's placeholder
    order)."""
    return [s for din, dout in zip(dims[:-1], dims[1:])
            for s in ((din, dout), (dout,))]


def zero1_chunks(flat, mesh) -> List[torch.Tensor]:
    """A whole flat vector (array or tensor, ``[n_pad]``) -> its M
    dp-shards, chunk r on shard r's device."""
    t = _feed(flat, "cpu") if not torch.is_tensor(flat) else flat
    return [c.to(d).clone() for c, d in
            zip(t.chunk(mesh.size), mesh.devices)]


def init_graph_mlp_zero1_state(dims: Sequence[int], mesh,
                               model: torch.nn.Module = None,
                               seed: int = 0) -> dict:
    """{"flat": M chunks of [n_pad], "vel": same} — module-identical init
    values (``model``'s, else an MLP seeded with ``seed``), flattened in
    gradient order, zero-padded to a world multiple, sharded over the
    mesh."""
    params = init_graph_mlp_state(dims, model, seed)["params"]
    _, flatten, _ = _mlp_layout(dims)
    flat = np.concatenate([p.detach().cpu().numpy().reshape(-1)
                           for p in flatten(params)])
    world = mesh.size
    n_pad = -(-flat.size // world) * world
    flat = np.pad(flat, (0, n_pad - flat.size)).astype(np.float32)
    return {"flat": zero1_chunks(flat, mesh),
            "vel": zero1_chunks(np.zeros_like(flat), mesh)}


def make_mlp_graph_zero1_train_step(dims: Sequence[int], global_batch: int,
                                    lr: float, mesh, beta: float = 0.9,
                                    axis: str = "dp",
                                    executor: Executor = None):
    """ZeRO-1 IR engine over ``init_graph_mlp_zero1_state`` state: the
    gather/flatten/update programs above in lockstep over ``mesh``, the
    state 1-D-sharded and the batch leading-dim split. Equal to the
    single-device graph engine on the same global batch up to the order
    of the gradient sum (reduce-scattered mean grads == the global
    mean, chunk by chunk)."""
    executor = executor or Executor()
    world, local_batch = _dp_world(mesh, global_batch)
    shapes = _mlp_grad_shapes(dims)
    n = sum(int(np.prod(s)) for s in shapes)
    n_pad = -(-n // world) * world
    chunk = n_pad // world

    n_params = 2 * (len(dims) - 1)
    vg = value_and_grad_callable(mlp_loss_graph(dims, local_batch),
                                 tuple(range(n_params)))
    gather_fn = to_sharded_callable(
        zero1_gather_params_graph(shapes, chunk, axis), mesh)
    flatten_fn = to_callable(zero1_flatten_grads_graph(shapes, n_pad))
    upd_fn = to_sharded_callable(
        zero1_update_graph(chunk, n_pad, lr, beta, axis, world), mesh)

    def mapped(state, b):
        params = gather_fn(state["flat"])          # weight all-gather (IR)
        images = _shard_rows(b["image"], mesh)
        onehots = _shard_rows(b["onehot"], mesh)
        losses, flat_g = [], []
        for r in range(mesh.size):
            loss, grads = vg(*[p[r] for p in params], images[r], onehots[r])
            losses.append(loss)
            with torch.no_grad():
                flat_g.append(flatten_fn(*grads))
        with torch.no_grad():
            p2, v2 = upd_fn(state["flat"], state["vel"], flat_g)
        return {"flat": p2, "vel": v2}, _pmean(losses)

    def step(state, b):
        new_state, loss = executor.run(mapped, state, b)
        return new_state, {"loss": loss}

    step.executor = executor
    step.update_graph = zero1_update_graph(chunk, n_pad, lr, beta, axis,
                                           world)
    step.gather_graph = zero1_gather_params_graph(shapes, chunk, axis)
    return step


def zero1_flat(chunks) -> np.ndarray:
    """ZeRO-1's per-shard chunks -> the whole flat vector (host)."""
    if isinstance(chunks, (list, tuple)):
        return np.concatenate([c.detach().cpu().numpy() for c in chunks])
    return np.asarray(chunks)


def materialize_graph_zero1_params(dims: Sequence[int], state) -> dict:
    """Host-side: sharded flat state -> the module-layout param tree (for
    checkpoints-to-eval/export interchange)."""
    flat = zero1_flat(state["flat"])
    shapes = _mlp_grad_shapes(dims)
    _, _, unflatten = _mlp_layout(dims)
    leaves, off = [], 0
    for s in shapes:
        size = int(np.prod(s))
        leaves.append(flat[off:off + size].reshape(s))
        off += size
    return unflatten(leaves)


def make_mlp_graph_train_step(dims: Sequence[int], batch: int, lr: float,
                              beta: float = 0.9,
                              clip_norm: float = None,
                              executor: Executor = None):
    """Trainer-compatible ``step(state, batch) -> (state, metrics)`` whose
    forward/loss/update are Graph IR programs.

    ``state`` = {"params": {fcN/head: {"w","b"}}, "vel": same-shaped}.
    ``batch`` = {"image": [B, in], "onehot": [B, classes]} (see
    :func:`onehot_shard_fn`). ``clip_norm``: IR-authored global-norm
    gradient clipping (:func:`clip_scale_graph`).
    """
    executor = executor or Executor()
    loss_graph = mlp_loss_graph(dims, batch)
    n_params = 2 * (len(dims) - 1)
    vg = value_and_grad_callable(loss_graph, tuple(range(n_params)))

    # One update graph per distinct parameter shape (placeholders are
    # shape-typed).
    shapes, flatten, unflatten = _mlp_layout(dims)
    upd_fns: Dict[Tuple[int, ...], Callable] = {}
    for s in {tuple(s) for s in shapes}:
        upd_fns[s] = to_callable(momentum_update_graph(s, lr, beta))
    # Gradient order is w0,b0,w1,b1,... (flatten order), not `shapes` order.
    clip_fn, scale_fns = _make_clip(_mlp_grad_shapes(dims), clip_norm)

    def whole_step(*flat_and_batch):
        flat = flat_and_batch[:2 * n_params]
        params, vels = flat[:n_params], flat[n_params:]
        image, onehot = flat_and_batch[-2:]
        loss, grads = vg(*params, image, onehot)
        with torch.no_grad():
            grads = _apply_clip(clip_fn, scale_fns, grads)
            new_p, new_v = [], []
            for p, v, gr in zip(params, vels, grads):
                pn, vn = upd_fns[tuple(p.shape)](p, v, gr)
                new_p.append(pn)
                new_v.append(vn)
        return (loss, *new_p, *new_v)

    def step(state, b):
        flat_p = flatten(state["params"])
        flat_v = flatten(state["vel"])
        dev = _state_device(state)
        out = executor.run(whole_step, *flat_p, *flat_v,
                           _feed(b["image"], dev), _feed(b["onehot"], dev))
        loss, rest = out[0], out[1:]
        return ({"params": unflatten(rest[:n_params]),
                 "vel": unflatten(rest[n_params:])},
                {"loss": loss})

    step.loss_graph = loss_graph  # for introspection/tests
    step.executor = executor
    return step


# ---------------------------------------------------------------------------
# GPT-2 authored in the IR: attention is the fused flash_attention node (or
# composed from IR ops with an additive causal-mask constant), the loss is
# log_softmax + take_along (no [B,S,V] one-hot), and AdamW is an update
# graph with bias correction done via the IR's pow op on a step
# placeholder.


def _param_placeholders(g: Graph, param_template):
    pairs, treedef = tree_flatten_with_path(param_template)
    syms = [g.placeholder(_shape(leaf), _leaf_dtype(leaf),
                          name=keystr(path)) for path, leaf in pairs]
    return tree_unflatten(treedef, syms)


def gpt2_loss_graph(cfg, param_template, batch: int, seq: int,
                    compute_dtype: str = "float32") -> Graph:
    """IR graph: (*flat_params, inputs[B,S] i32, targets[B,S] i32) -> loss.

    ``flat_params`` follows JAX's flatten order of the parameter tree
    (:func:`tree_flatten_with_path`), its placeholders named by JAX's
    ``keystr``. Mirrors the module's forward (dropout=0).
    ``cfg.attn_impl`` auto/flash emits the fused ``flash_attention`` IR
    node (the flash kernels on CUDA tensors); "xla" keeps attention fully
    composed in the IR. ``compute_dtype="bfloat16"`` authors the module
    bf16 policy in the IR: fp32 master params cast to bf16 at each use,
    activations bf16, layernorm statistics fp32 (the ``layernorm`` node
    upcasts internally), logits fp32 for the CE — gradients flow back to
    the fp32 placeholders through the cast nodes.
    """
    if cfg.dropout:
        raise ValueError("graph GPT-2 has no dropout path; build with "
                         "dropout=0")
    if seq > cfg.max_positions:
        # The position-embedding gather below would silently clamp past
        # the table's last row.
        raise ValueError(f"sequence length {seq} exceeds max_positions "
                         f"{cfg.max_positions}")
    g = Graph("gpt2_loss")
    p = _param_placeholders(g, param_template)
    inputs = g.placeholder((batch, seq), "int32", name="inputs")
    targets = g.placeholder((batch, seq), "int32", name="targets")

    bf16 = compute_dtype == "bfloat16"
    cc = (lambda t: g.cast(t, compute_dtype)) if bf16 else (lambda t: t)

    h_dim, nh = cfg.hidden_size, cfg.num_heads
    hd = h_dim // nh
    x = g.take(cc(p["wte"]["embedding"]), inputs, axis=0)      # [B,S,H]
    x = x + g.take(cc(p["wpe"]["embedding"]),
                   g.constant(np.arange(seq)), axis=0)          # + [S,H]
    # Attention: the fused node (cfg.attn_impl auto/flash — the flash
    # kernels on CUDA tensors) or fully composed ops ("xla").
    use_flash_node = cfg.attn_impl in ("auto", "flash")
    if not use_flash_node:
        causal = np.where(np.tri(seq, dtype=bool), 0.0,
                          -np.inf).astype(np.float32)
        mask = g.constant(causal)

    def heads(t):  # [B,S,H] -> [B,nh,S,hd]
        return g.transpose(g.reshape(t, (batch, seq, nh, hd)), (0, 2, 1, 3))

    for i in range(cfg.num_layers):
        blk = p[f"h{i}"]
        y = g.layernorm(x, cc(blk["ln_1"]["scale"]),
                        cc(blk["ln_1"]["bias"]))
        qkv = (y @ cc(blk["attn"]["qkv"]["w"])) + cc(blk["attn"]["qkv"]["b"])
        q = heads(g.slice(qkv, (0, 0, 0), (batch, seq, h_dim)))
        k = heads(g.slice(qkv, (0, 0, h_dim), (batch, seq, 2 * h_dim)))
        v = heads(g.slice(qkv, (0, 0, 2 * h_dim), (batch, seq, 3 * h_dim)))
        if use_flash_node:
            att = g.flash_attention(
                q, k, v, causal=True,
                impl="auto" if cfg.attn_impl == "auto" else "pallas")
        else:
            scores = (q @ g.transpose(k, (0, 1, 3, 2))) * (1.0 / hd ** 0.5)
            if bf16:
                # fp32 softmax stats, bf16 P·V — the module policy.
                att = g.cast(g.softmax(g.cast(scores, "float32") + mask,
                                       axis=-1), compute_dtype) @ v
            else:
                att = g.softmax(scores + mask, axis=-1) @ v
        o = g.reshape(g.transpose(att, (0, 2, 1, 3)),
                      (batch, seq, h_dim))
        x = x + (o @ cc(blk["attn"]["proj"]["w"])) \
            + cc(blk["attn"]["proj"]["b"])
        y = g.layernorm(x, cc(blk["ln_2"]["scale"]),
                        cc(blk["ln_2"]["bias"]))
        y = g.gelu((y @ cc(blk["mlp"]["fc"]["w"]))
                   + cc(blk["mlp"]["fc"]["b"]))
        x = x + (y @ cc(blk["mlp"]["proj"]["w"])) \
            + cc(blk["mlp"]["proj"]["b"])

    x = g.layernorm(x, cc(p["ln_f"]["scale"]), cc(p["ln_f"]["bias"]))
    logits = x @ g.transpose(cc(p["wte"]["embedding"]), (1, 0))  # tied head
    if bf16:
        # The module's fused-head discipline: the logit GEMM stays bf16
        # and the fp32 upcast feeds only the logsumexp reductions and the
        # target gather.
        xf = g.cast(logits, "float32")
        m = g.max(xf, axis=-1, keepdims=True)              # [B,S,1]
        lse = g.log(g.sum(g.exp(xf - m), axis=-1,
                          keepdims=True)) + m              # [B,S,1]
        tgt = g.take_along(xf, targets, axis=2)            # [B,S]
        nll = g.mean(g.reshape(lse, (batch, seq)) - tgt)
    else:
        logp = g.log_softmax(logits, axis=-1)
        nll = -g.mean(g.take_along(logp, targets, axis=2))
    g.output(nll)
    return g


def adamw_update_graph(shape: Sequence[int], b1=0.9, b2=0.999, eps=1e-8,
                       weight_decay=0.1, axis_name: str = None,
                       world: int = 1) -> Graph:
    """IR graph: (param, mu, nu, grad, step_f32, lr) -> (p', mu', nu').

    Matches ``optim.adamw``'s math (bias correction from the
    post-increment step, decoupled weight decay on every leaf). With
    ``axis_name`` set, the incoming gradient is a LOCAL shard and the
    all-reduce mean over the mesh axis is authored as an IR node — ONE
    body for both engines so single-device and dp AdamW cannot drift."""
    g = Graph("dp_adamw_update" if axis_name else "adamw_update")
    p = g.placeholder(shape, name="param")
    m = g.placeholder(shape, name="mu")
    v = g.placeholder(shape, name="nu")
    grad = g.placeholder(shape, name="grad")
    t = g.placeholder((), name="step")   # post-increment, fp32
    lr = g.placeholder((), name="lr")
    if axis_name is not None:
        grad = g.all_reduce(grad, axis_name=axis_name) * (1.0 / world)
    m2 = m * b1 + grad * (1 - b1)
    v2 = v * b2 + (grad * grad) * (1 - b2)
    c1 = -(g.constant(np.float32(b1)) ** t) + 1.0
    c2 = -(g.constant(np.float32(b2)) ** t) + 1.0
    d = (m2 / c1) / ((v2 / c2) ** 0.5 + eps) + p * weight_decay
    g.output(p - d * lr, m2, v2)
    return g


def dp_adamw_update_graph(shape: Sequence[int], axis_name: str, world: int,
                          b1=0.9, b2=0.999, eps=1e-8,
                          weight_decay=0.1) -> Graph:
    """The dp AdamW engine (GPT-2, BERT): :func:`adamw_update_graph` with
    the collective enabled. ``axis_name`` and ``world`` are required
    together (a defaulted world would turn the mean into a silent sum)."""
    return adamw_update_graph(shape, b1=b1, b2=b2, eps=eps,
                              weight_decay=weight_decay,
                              axis_name=axis_name, world=world)


def init_graph_gpt2_state(model) -> dict:
    """Graph-engine GPT-2 state from a port module: its weights (the
    module's init) as the JAX parameter tree, zero AdamW slots, step 0."""
    params = module_param_tree(model)
    zeros = lambda t: tree_map(torch.zeros_like, t)
    return {"params": params, "mu": zeros(params), "nu": zeros(params),
            "step": np.zeros((), np.int32)}


def _make_adamw_ir_step(build_loss_graph, feed_keys: Tuple[str, ...],
                        shape_key: str, lr_schedule,
                        weight_decay: float, clip_norm: float = None,
                        mesh=None, axis: str = "dp",
                        executor: Executor = None, check_batch=None):
    """Shared IR-engine AdamW trainer: ``build_loss_graph(template, batch,
    seq) -> Graph`` whose placeholders are (*flat_params, *feed_keys
    tensors); state = {"params", "mu", "nu", "step"}; graphs built per
    (batch, seq) of ``b[shape_key]`` on first use. ``clip_norm``:
    IR-authored global-norm clipping before the update graphs.

    ``mesh``: data-parallel over a one-process mesh — the loss graph
    builds at the LOCAL batch, the update graphs become
    :func:`dp_adamw_update_graph` (all_reduce as an IR node) in lockstep
    over the shards. Mutually exclusive with ``clip_norm`` (the clip must
    see reduced gradients)."""
    executor = executor or Executor()
    world = mesh.size if mesh is not None else 1
    if mesh is not None and clip_norm is not None:
        raise ValueError("clip_norm under graph-dp is unsupported (the "
                         "all_reduce lives inside the update graphs)")
    _built: Dict[Tuple[int, int], dict] = {}

    def build(params_template, batch, seq):
        loss_graph = build_loss_graph(params_template, batch, seq)
        leaves = tree_leaves(params_template)
        n_params = len(leaves)
        vg = value_and_grad_callable(loss_graph, tuple(range(n_params)))
        shapes = {tuple(_shape(l)) for l in leaves}
        if mesh is None:
            upd = {s: to_callable(adamw_update_graph(
                s, weight_decay=weight_decay)) for s in shapes}
        else:
            upd = {s: to_sharded_callable(dp_adamw_update_graph(
                s, weight_decay=weight_decay, axis_name=axis, world=world),
                mesh) for s in shapes}
            body = _dp_step(vg, upd, feed_keys, mesh, 3)

            def whole_step(ps, ms, vs, t_f32, lr, b):
                (new_p, new_m, new_v), loss = body([ps, ms, vs],
                                                   [t_f32, lr], b)
                return (loss, *new_p, *new_m, *new_v)

            return {"whole_step": whole_step, "n_params": n_params,
                    "loss_graph": loss_graph}
        clip_fn, scale_fns = _make_clip([_shape(l) for l in leaves],
                                        clip_norm)

        def whole_step(*args):
            flat = args[:3 * n_params]
            ps, ms, vs = (flat[:n_params], flat[n_params:2 * n_params],
                          flat[2 * n_params:])
            t_f32, lr = args[3 * n_params:3 * n_params + 2]
            feeds = args[3 * n_params + 2:]
            loss, grads = vg(*ps, *feeds)
            with torch.no_grad():
                grads = _apply_clip(clip_fn, scale_fns, grads)
                new = [upd[tuple(x.shape)](x, m, v, gr, t_f32, lr)
                       for x, m, v, gr in zip(ps, ms, vs, grads)]
            new_p, new_m, new_v = zip(*new)
            return (loss, *new_p, *new_m, *new_v)

        return {"whole_step": whole_step, "n_params": n_params,
                "loss_graph": loss_graph}

    def step(state, b):
        if check_batch is not None:
            check_batch(b)
        batch, seq = _shape(b[shape_key])[:2]
        if batch % world:
            raise ValueError(f"global batch {batch} not divisible by "
                             f"mesh axis {axis}={world}")
        if (batch, seq) not in _built:
            _built[(batch, seq)] = build(state["params"], batch // world,
                                         seq)
        so = _built[(batch, seq)]
        n = so["n_params"]
        flat_p, treedef = tree_flatten(state["params"])
        flat_m = tree_leaves(state["mu"])
        flat_v = tree_leaves(state["nu"])
        dev = _state_device(state)
        t = int(state["step"])
        # The module's lr comes from the PRE-increment step; the bias
        # correction from the post-increment one.
        lr = torch.tensor(np.float32(lr_schedule(t)), device=dev)
        t_f32 = torch.tensor(np.float32(t + 1), device=dev)
        if mesh is None:
            out = executor.run(so["whole_step"], *flat_p, *flat_m, *flat_v,
                               t_f32, lr, *[_feed(b[k], dev)
                                            for k in feed_keys])
        else:
            out = executor.run(so["whole_step"], flat_p, flat_m, flat_v,
                               t_f32, lr, {k: b[k] for k in feed_keys})
        loss, rest = out[0], out[1:]
        unf = lambda leaves: tree_unflatten(treedef, list(leaves))
        return ({"params": unf(rest[:n]), "mu": unf(rest[n:2 * n]),
                 "nu": unf(rest[2 * n:]),
                 "step": np.asarray(t + 1, np.int32)},
                {"loss": loss})

    step.executor = executor
    step._built = _built  # introspection/tests
    return step


def make_gpt2_graph_train_step(model, lr_schedule, weight_decay: float = 0.1,
                               clip_norm: float = None, mesh=None,
                               executor: Executor = None,
                               compute_dtype: str = "float32"):
    """Trainer-compatible step over ``init_graph_gpt2_state`` state; batches
    are {"inputs": [B,S] i32, "targets": [B,S] i32} (see
    :func:`lm_shard_fn`). Graphs are built per batch shape on first use.
    ``mesh``: dp over a one-process mesh (IR all_reduce).
    ``compute_dtype="bfloat16"``: the module bf16 policy authored in the
    IR (fp32 master params; see :func:`gpt2_loss_graph`)."""
    cfg = model.cfg
    return _make_adamw_ir_step(
        lambda tmpl, batch, seq: gpt2_loss_graph(
            cfg, tmpl, batch, seq, compute_dtype=compute_dtype),
        feed_keys=("inputs", "targets"), shape_key="inputs",
        lr_schedule=lr_schedule, weight_decay=weight_decay,
        clip_norm=clip_norm, mesh=mesh, executor=executor)


def lm_shard_fn():
    """Host-side batch transform: {"tokens": [B,S+1]} -> inputs/targets."""

    def shard(b):
        toks = np.asarray(b["tokens"], np.int32)
        return {"inputs": toks[:, :-1],
                "targets": np.ascontiguousarray(toks[:, 1:])}

    return shard


# ---------------------------------------------------------------------------
# BERT authored in the IR: post-LN encoder, erf GELU, additive padding mask
# fed as a placeholder, MLM loss masked via host-prepared safe-labels +
# mask (the IR needs no comparison ops that way). Attention is the
# non-causal flash_attention node under attn_impl auto/flash (a batch with
# padding then refuses, as the module's flash path does), composed with
# the additive mask under "xla".


def bert_loss_graph(cfg, param_template, batch: int, seq: int) -> Graph:
    """IR graph: (*flat_params, tokens[B,S] i32, segment_ids[B,S] i32,
    attn_mask[B,1,1,S] f32 additive, safe_labels[B,S] i32,
    label_mask[B,S] f32) -> masked-mean MLM loss.

    Mirrors the module's forward + ``mlm_loss`` (ignore_index=-100
    becomes the host-side safe_labels/label_mask pair). ``cfg.attn_impl``
    auto/flash attends through the non-causal ``flash_attention`` node
    (``attn_mask`` then stays unread: :func:`make_bert_graph_train_step`
    refuses a batch with padding); "xla" composes softmax(QK^T +
    attn_mask)V."""
    if cfg.dropout:
        raise ValueError("graph BERT has no dropout path; build with "
                         "dropout=0")
    if seq > cfg.max_positions:
        raise ValueError(f"sequence length {seq} exceeds max_positions "
                         f"{cfg.max_positions}")
    g = Graph("bert_mlm_loss")
    p = _param_placeholders(g, param_template)
    tokens = g.placeholder((batch, seq), "int32", name="tokens")
    segment_ids = g.placeholder((batch, seq), "int32", name="segment_ids")
    attn_mask = g.placeholder((batch, 1, 1, seq), name="attn_mask")
    safe_labels = g.placeholder((batch, seq), "int32", name="safe_labels")
    label_mask = g.placeholder((batch, seq), name="label_mask")

    h_dim, nh = cfg.hidden_size, cfg.num_heads
    hd = h_dim // nh
    eps = cfg.ln_eps
    use_flash_node = bert_uses_flash(cfg)

    def ln(prm, x):
        return g.layernorm(x, prm["scale"], prm["bias"], eps=eps)

    x = g.take(p["tok_emb"]["embedding"], tokens, axis=0)
    x = x + g.take(p["pos_emb"]["embedding"], g.constant(np.arange(seq)),
                   axis=0)
    x = x + g.take(p["type_emb"]["embedding"], segment_ids, axis=0)
    x = ln(p["emb_ln"], x)

    def heads(t):
        return g.transpose(g.reshape(t, (batch, seq, nh, hd)), (0, 2, 1, 3))

    for i in range(cfg.num_layers):
        lyr = p[f"layers{i}"]
        qkv = (x @ lyr["qkv"]["w"]) + lyr["qkv"]["b"]
        q = heads(g.slice(qkv, (0, 0, 0), (batch, seq, h_dim)))
        k = heads(g.slice(qkv, (0, 0, h_dim), (batch, seq, 2 * h_dim)))
        v = heads(g.slice(qkv, (0, 0, 2 * h_dim), (batch, seq, 3 * h_dim)))
        if use_flash_node:
            ctx = g.flash_attention(
                q, k, v, causal=False,
                impl="auto" if cfg.attn_impl == "auto" else "pallas")
        else:
            scores = (q @ g.transpose(k, (0, 1, 3, 2))) * (1.0 / hd ** 0.5)
            ctx = g.softmax(scores + attn_mask, axis=-1) @ v
        att = g.reshape(g.transpose(ctx, (0, 2, 1, 3)),
                        (batch, seq, h_dim))
        att = (att @ lyr["attn_out"]["w"]) + lyr["attn_out"]["b"]
        x = ln(lyr["attn_ln"], x + att)               # post-LN topology
        y = g.gelu((x @ lyr["fc"]["w"]) + lyr["fc"]["b"], approximate=False)
        y = (y @ lyr["fc_out"]["w"]) + lyr["fc_out"]["b"]
        x = ln(lyr["out_ln"], x + y)

    y = g.gelu((x @ p["mlm_dense"]["w"]) + p["mlm_dense"]["b"],
               approximate=False)
    y = ln(p["mlm_ln"], y)
    logits = (y @ g.transpose(p["tok_emb"]["embedding"], (1, 0))
              ) + p["mlm_bias"]
    logp = g.log_softmax(logits, axis=-1)
    picked = g.take_along(logp, safe_labels, axis=2)
    # masked mean; max(count, 1) = relu(count - 1) + 1 for count >= 0.
    count = g.sum(label_mask)
    nll = -(g.sum(picked * label_mask) / (g.relu(count + (-1.0)) + 1.0))
    g.output(nll)
    return g


def bert_uses_flash(cfg) -> bool:
    """Whether the BERT program attends through the flash node."""
    return cfg.attn_impl in ("auto", "flash")


def bert_shard_fn():
    """Host-side transform of BERT MLM batches into the graph's feeds.

    ``segment_ids`` is required (the IR program always adds type
    embeddings). ``padding_mask`` may be absent: all-attendable ==
    additive zeros."""

    def shard(b):
        tokens = np.asarray(b["tokens"], np.int32)
        labels = np.asarray(b["labels"], np.int32)
        pad = np.asarray(b.get("padding_mask",
                               np.ones_like(tokens, bool)), bool)
        attn = np.where(pad, 0.0, -1e30).astype(np.float32)
        return {
            "tokens": tokens,
            "segment_ids": np.asarray(b["segment_ids"], np.int32),
            "attn_mask": attn[:, None, None, :],
            "safe_labels": np.where(labels == -100, 0, labels).astype(
                np.int32),
            "label_mask": (labels != -100).astype(np.float32),
        }

    return shard


def init_graph_bert_state(model) -> dict:
    """Graph-engine BERT state (AdamW slots), module-identical init."""
    return init_graph_gpt2_state(model)


def make_bert_graph_train_step(model, lr_schedule,
                               weight_decay: float = 0.01,
                               clip_norm: float = None, mesh=None,
                               executor: Executor = None):
    """Trainer-compatible step over ``init_graph_bert_state`` state;
    batches from :func:`bert_shard_fn`. ``mesh``: dp (IR all_reduce).
    Under the flash node a batch with padding raises ``ValueError``."""
    cfg = model.cfg

    def no_padding(b):
        m = b["attn_mask"]
        if torch.is_tensor(m):
            m = m.detach().cpu().numpy()
        if np.any(np.asarray(m) != 0):
            raise ValueError(f"attn_impl={cfg.attn_impl!r} attends through "
                             f"the flash node, which cannot apply a padding "
                             f"mask; use attn_impl='xla'")

    return _make_adamw_ir_step(
        lambda tmpl, batch, seq: bert_loss_graph(cfg, tmpl, batch, seq),
        feed_keys=("tokens", "segment_ids", "attn_mask", "safe_labels",
                   "label_mask"),
        shape_key="tokens", lr_schedule=lr_schedule,
        weight_decay=weight_decay, clip_norm=clip_norm, mesh=mesh,
        executor=executor,
        check_batch=no_padding if bert_uses_flash(cfg) else None)


# ---------------------------------------------------------------------------
# ResNet authored in the IR: conv2d/batchnorm/max_pool2d/relu/mean IR ops
# compose the bottleneck topology of models.resnet.ResNet; training-mode
# batch statistics only (running stats for eval are the module engine's
# concern).


def resnet_loss_graph(stage_sizes: Sequence[int], param_template,
                      batch: int, size: int) -> Graph:
    """IR graph: (*flat_params, image[B,H,W,3], labels[B] i32) -> loss.

    Mirrors the module's forward in training mode (batch-stat batchnorm;
    the s2d stem is the same 7x7 stride-2 conv). ``flat_params`` follows
    JAX's flatten order of the parameter tree.
    """
    g = Graph("resnet_loss")
    p = _param_placeholders(g, param_template)
    image = g.placeholder((batch, size, size, 3), name="image")
    labels = g.placeholder((batch,), "int32", name="labels")

    def conv(prm, x, stride):
        return g.conv2d(x, prm["w"], stride=(stride, stride), padding="SAME")

    def bn(prm, x):
        return g.batchnorm(x, prm["scale"], prm["bias"])

    x = g.relu(bn(p["stem_bn"], conv(p["stem_conv"], image, 2)))
    x = g.max_pool2d(x, 3, 2, "SAME")

    # Same block/channel bookkeeping as ResNet.__init__.
    in_ch, idx = 64, 0
    for stage, n_blocks in enumerate(stage_sizes):
        base = 64 * (2 ** stage)
        out_ch = base * 4
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            blk = p[f"blocks{idx}"]
            y = g.relu(bn(blk["bn1"], conv(blk["conv1"], x, 1)))
            y = g.relu(bn(blk["bn2"], conv(blk["conv2"], y, stride)))
            y = bn(blk["bn3"], conv(blk["conv3"], y, 1))
            if (in_ch != out_ch) or (stride != 1):
                sc = bn(blk["proj_bn"], conv(blk["proj"], x, stride))
            else:
                sc = x
            x = g.relu(y + sc)
            in_ch = out_ch
            idx += 1

    x = g.mean(x, axis=(1, 2))                       # global average pool
    logits = (x @ p["head"]["w"]) + p["head"]["b"]
    logp = g.log_softmax(logits, axis=-1)
    nll = -g.mean(g.take_along(logp, labels, axis=1))
    g.output(nll)
    return g


def init_graph_resnet_state(model) -> dict:
    """Graph-engine ResNet state, the module's weights (including the
    zero-init of each block's last BN scale) with zero velocity."""
    params = module_param_tree(model)
    return {"params": params, "vel": tree_map(torch.zeros_like, params)}


def make_resnet_graph_dp_train_step(model, global_batch: int, lr: float,
                                    mesh, beta: float = 0.9,
                                    axis: str = "dp",
                                    executor: Executor = None):
    """Data-parallel IR ResNet: each shard's loss graph -> autograd ->
    :func:`dp_momentum_update_graph` (the gradient all-reduce as an IR
    node) in lockstep over ``mesh`` — the conv path through the same op
    graph + collectives shape as the MLP dp engine.

    BatchNorm uses per-shard batch statistics (the standard DP-BN
    semantics): a dp run equals a single-device run only when every shard
    sees identical rows, and statistically otherwise.

    ``state`` layouts match :func:`make_resnet_graph_train_step`; batch =
    {"image": [B,H,W,3], "labels": [B]}; graphs build per image size on
    first use."""
    executor = executor or Executor()
    world, local_batch = _dp_world(mesh, global_batch)
    _built: Dict[int, Callable] = {}

    def build(params_template, size):
        loss_graph = resnet_loss_graph(model.stage_sizes, params_template,
                                       local_batch, size)
        leaves = tree_leaves(params_template)
        vg = value_and_grad_callable(loss_graph, tuple(range(len(leaves))))
        upd = {s: to_sharded_callable(
            dp_momentum_update_graph(s, lr, beta, axis, world), mesh)
            for s in {tuple(_shape(l)) for l in leaves}}
        body = _dp_step(vg, upd, ("image", "labels"), mesh, 2)

        def mapped(state, b):
            flat_p, treedef = tree_flatten(state["params"])
            (new_p, new_v), loss = body(
                [flat_p, tree_leaves(state["vel"])], [], b)
            return ({"params": tree_unflatten(treedef, new_p),
                     "vel": tree_unflatten(treedef, new_v)}, loss)

        return mapped

    def step(state, b):
        size = _shape(b["image"])[1]
        if size not in _built:
            _built[size] = build(state["params"], size)
        new_state, loss = executor.run(_built[size], state, b)
        return new_state, {"loss": loss}

    step.executor = executor
    return step


def make_resnet_graph_train_step(model, lr: float, beta: float = 0.9,
                                 clip_norm: float = None,
                                 executor: Executor = None):
    """Trainer-compatible step over ``init_graph_resnet_state`` state;
    batches are {"image": [B,H,W,3] f32, "labels": [B] i32} (see
    :func:`image_shard_fn`). SGD-momentum update graphs, one per shape."""
    executor = executor or Executor()
    _built: Dict[Tuple[int, int], dict] = {}

    def build(params_template, batch, size):
        loss_graph = resnet_loss_graph(model.stage_sizes, params_template,
                                       batch, size)
        leaves = tree_leaves(params_template)
        n_params = len(leaves)
        vg = value_and_grad_callable(loss_graph, tuple(range(n_params)))
        upd = {s: to_callable(momentum_update_graph(s, lr, beta))
               for s in {tuple(_shape(l)) for l in leaves}}
        clip_fn, scale_fns = _make_clip([_shape(l) for l in leaves],
                                        clip_norm)

        def whole_step(*args):
            flat = args[:2 * n_params]
            ps, vs = flat[:n_params], flat[n_params:]
            image, labels = args[2 * n_params:]
            loss, grads = vg(*ps, image, labels)
            with torch.no_grad():
                grads = _apply_clip(clip_fn, scale_fns, grads)
                new = [upd[tuple(x.shape)](x, v, gr)
                       for x, v, gr in zip(ps, vs, grads)]
            new_p, new_v = zip(*new)
            return (loss, *new_p, *new_v)

        return {"whole_step": whole_step, "n_params": n_params,
                "loss_graph": loss_graph}

    def step(state, b):
        batch, size = _shape(b["image"])[0], _shape(b["image"])[1]
        if (batch, size) not in _built:
            _built[(batch, size)] = build(state["params"], batch, size)
        so = _built[(batch, size)]
        n = so["n_params"]
        flat_p, treedef = tree_flatten(state["params"])
        flat_v = tree_leaves(state["vel"])
        dev = _state_device(state)
        out = executor.run(so["whole_step"], *flat_p, *flat_v,
                           _feed(b["image"], dev), _feed(b["labels"], dev))
        loss, rest = out[0], out[1:]
        unf = lambda leaves: tree_unflatten(treedef, list(leaves))
        return ({"params": unf(rest[:n]), "vel": unf(rest[n:])},
                {"loss": loss})

    step.executor = executor
    step._built = _built
    return step


def image_shard_fn():
    """Host-side batch transform for the graph ResNet step."""

    def shard(b):
        return {"image": np.asarray(b["image"], np.float32),
                "labels": np.asarray(b["label"], np.int32)}

    return shard


def init_graph_mlp_state(dims: Sequence[int], model: torch.nn.Module = None,
                         seed: int = 0) -> dict:
    """IR-engine state with the SAME values as the module: ``model``'s
    weights, else those of an MLP of ``dims`` built on the CPU from a
    generator seeded with ``seed``; zero velocity."""
    if model is None:
        from nezha_tpu_torch.models.mlp import MLP
        gen = torch.Generator()
        gen.manual_seed(seed)
        model = MLP(in_features=dims[0], hidden=tuple(dims[1:-1]),
                    num_classes=dims[-1], generator=gen)
    params = module_param_tree(model)
    return {"params": params, "vel": tree_map(torch.zeros_like, params)}


def onehot_shard_fn(num_classes: int):
    """Host-side batch transform: integer labels -> one-hot floats."""
    eye = np.eye(num_classes, dtype=np.float32)

    def shard(b):
        img = np.asarray(b["image"], np.float32)
        return {"image": img.reshape(img.shape[0], -1),
                "onehot": eye[np.asarray(b["label"])]}

    return shard
