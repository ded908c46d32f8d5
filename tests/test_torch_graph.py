"""The port's graph IR (``nezha_tpu_torch/graph``, ``runtime/executor.py``)
against the JAX package's, on the CPU at tiny sizes:

- every op of ``OP_SET``: the same builder calls make the same ``repr``
  in both packages, and the port's interpreter gives JAX's values
  (fp32 to 1e-5 relative, 1e-6 absolute; the bf16 cast bitwise);
- the ``flash_attention`` node's three impls against JAX's ("pallas" in
  interpret mode), forward and gradients (5e-4 / 5e-5, the JAX test's
  own flash-against-composed tolerance);
- ``grad_callable`` against ``jax.grad`` (1e-5 / 1e-6), and its
  scalar-output check with JAX's message;
- the fx lowering (the counterpart of ``lower_stablehlo``) and
  ``compile_graph``'s shape binding;
- the Executor's fingerprint (stable, structure-sensitive: JAX's
  ``test_graph_property.py`` and ``test_runtime.py`` cases), its cache
  hits and misses and the ``compile_cache.*`` telemetry;
- the collective nodes on ``[cpu] * M``, M = 2 and 4, against JAX's
  ``shard_map`` on its host devices (bitwise on these integer-valued
  inputs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from nezha_tpu import graph as jgraph
from nezha_tpu.runtime.executor import _graph_fingerprint as jfingerprint
from nezha_tpu_torch import graph as tgraph
from nezha_tpu_torch import obs
from nezha_tpu_torch.graph.graph import OP_SET
from nezha_tpu_torch.parallel.mesh import make_mesh
from nezha_tpu_torch.runtime import Executor
from nezha_tpu_torch.runtime.executor import _graph_fingerprint

RTOL, ATOL = 1e-5, 1e-6
FLASH_RTOL, FLASH_ATOL = 5e-4, 5e-5


def _r(*shape, lo=-1.0, hi=1.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


# op -> (builder(g) -> list of syms to output, inputs). The builder makes
# the same calls on either package's Graph.
def _unary(op, lo=-1.0, hi=1.0, **kw):
    def build(g):
        x = g.placeholder((3, 5), name="x")
        return [g._add(op, [x], kw or None)]
    return build, [_r(3, 5, lo=lo, hi=hi)]


def _binary(op, lo=-1.0, hi=1.0):
    def build(g):
        a = g.placeholder((3, 5), name="a")
        b = g.placeholder((3, 5), name="b")
        return [g._add(op, [a, b])]
    return build, [_r(3, 5, lo=lo, hi=hi, seed=1), _r(3, 5, lo=lo, hi=hi,
                                                      seed=2)]


def _case(op):
    if op == "placeholder":
        return (lambda g: [g.placeholder((2, 3), name="x")]), [_r(2, 3)]
    if op == "constant":
        return (lambda g: [g.constant(np.arange(6.0).reshape(2, 3)),
                           g.constant(np.arange(4))]), []
    if op in ("add", "sub", "mul", "matmul"):
        if op == "matmul":
            def build(g):
                a = g.placeholder((3, 4), name="a")
                b = g.placeholder((4, 5), name="b")
                return [a @ b, (a @ b) * 0.5]
            return build, [_r(3, 4), _r(4, 5, seed=1)]
        return _binary(op)
    if op in ("div", "pow"):
        return _binary(op, lo=0.5, hi=2.0)
    if op in ("neg", "relu", "tanh", "exp", "sigmoid"):
        return _unary(op)
    if op == "log":
        return _unary(op, lo=0.1, hi=3.0)
    if op == "gelu":
        def build(g):
            x = g.placeholder((3, 5), name="x")
            return [g.gelu(x), g.gelu(x, approximate=False)]
        return build, [_r(3, 5, lo=-3, hi=3)]
    if op in ("softmax", "log_softmax"):
        def build(g):
            x = g.placeholder((3, 5), name="x")
            return [getattr(g, op)(x, axis=-1), getattr(g, op)(x, axis=0)]
        return build, [_r(3, 5, lo=-3, hi=3)]
    if op == "conv2d":
        def build(g):
            x = g.placeholder((2, 7, 7, 3), name="x")
            w = g.placeholder((3, 3, 3, 4), name="w")
            w2 = g.placeholder((3, 3, 1, 3), name="w2")
            return [g.conv2d(x, w, stride=(2, 2)),
                    g.conv2d(x, w, padding="VALID"),
                    g.conv2d(x, w2, groups=3)]
        return build, [_r(2, 7, 7, 3), _r(3, 3, 3, 4, seed=1),
                       _r(3, 3, 1, 3, seed=2)]
    if op in ("layernorm", "batchnorm"):
        shape = (2, 5, 8) if op == "layernorm" else (4, 5, 5, 8)

        def build(g):
            x = g.placeholder(shape, name="x")
            s = g.placeholder((8,), name="scale")
            b = g.placeholder((8,), name="bias")
            return [getattr(g, op)(x, s, b, eps=1e-3),
                    getattr(g, op)(g.cast(x, "bfloat16"), s, b)]
        return build, [_r(*shape, lo=-2, hi=3), _r(8, seed=1),
                       _r(8, seed=2)]
    if op in ("max_pool2d", "avg_pool2d"):
        def build(g):
            x = g.placeholder((2, 7, 7, 3), name="x")
            return [getattr(g, op)(x, 3, 2, "SAME"),
                    getattr(g, op)(x, 2, 2, "VALID")]
        return build, [_r(2, 7, 7, 3)]
    if op == "reshape":
        def build(g):
            return [g.reshape(g.placeholder((2, 6), name="x"), (3, 4))]
        return build, [_r(2, 6)]
    if op == "transpose":
        def build(g):
            return [g.transpose(g.placeholder((2, 3, 4), name="x"),
                                (2, 0, 1))]
        return build, [_r(2, 3, 4)]
    if op == "broadcast_to":
        def build(g):
            x = g.placeholder((1, 4), name="x")
            return [g._add("broadcast_to", [x], {"shape": (3, 4)})]
        return build, [_r(1, 4)]
    if op in ("sum", "mean", "max"):
        def build(g):
            x = g.placeholder((2, 3, 4), name="x")
            f = getattr(g, op)
            return [f(x), f(x, axis=1, keepdims=True), f(x, axis=(0, 2))]
        return build, [_r(2, 3, 4)]
    if op == "cast":
        def build(g):
            x = g.placeholder((3, 5), name="x")
            return [g.cast(g.cast(x, "bfloat16"), "float32"),
                    g.cast(x, "int32")]
        return build, [_r(3, 5, lo=-9, hi=9)]
    if op == "concat":
        def build(g):
            a = g.placeholder((2, 3), name="a")
            b = g.placeholder((2, 2), name="b")
            return [g.concat([a, b], axis=1)]
        return build, [_r(2, 3), _r(2, 2, seed=1)]
    if op == "slice":
        def build(g):
            x = g.placeholder((4, 6), name="x")
            return [g.slice(x, (1, 0), (3, 6)),
                    g.slice(x, (0, 1), (4, 6), (2, 2))]
        return build, [_r(4, 6)]
    if op == "take":
        def build(g):
            t = g.placeholder((10, 4), name="table")
            ids = g.placeholder((2, 3), "int32", name="ids")
            return [g.take(t, ids, axis=0), g.take(t, ids, axis=1)]
        ids = np.array([[0, 3, 2], [1, 1, 3]], np.int32)
        return build, [_r(10, 4), ids]
    if op == "take_along":
        def build(g):
            x = g.placeholder((2, 3, 5), name="x")
            idx = g.placeholder((2, 3), "int32", name="idx")
            return [g.take_along(x, idx, axis=2)]
        return build, [_r(2, 3, 5), np.array([[0, 4, 2], [1, 3, 3]],
                                             np.int32)]
    if op == "flash_attention":
        def build(g):
            q, k, v = (g.placeholder((2, 2, 16, 8), name=n) for n in "qkv")
            return [g.flash_attention(q, k, v, causal=True, impl="xla"),
                    g.flash_attention(q, k, v, causal=False, impl="xla",
                                      scale=0.3)]
        return build, [_r(2, 2, 16, 8, seed=s) for s in range(3)]
    return None


def _both(build):
    out = []
    for mod in (jgraph, tgraph):
        g = mod.Graph("case")
        g.output(*build(g))
        out.append(g)
    return out


def _close(a, b, rtol=RTOL, atol=ATOL):
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if torch.is_tensor(b) else np.asarray(b)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("op", OP_SET)
def test_op_matches_jax(op):
    """Each op, built by the same calls: the same IR (``repr``), and the
    port's interpreter gives JAX's values. The collective ops run over a
    mesh here too (2 shards); test_collectives_match_shard_map runs them
    at M = 2 and 4."""
    assert tuple(OP_SET) == tuple(jgraph.graph.OP_SET)
    if op in ("all_reduce", "reduce_scatter", "all_gather"):
        _check_collective(op, 2)
        return
    build, args = _case(op)
    jg, tg = _both(build)
    assert repr(jg) == repr(tg)
    want = _tuple(jgraph.to_callable(jg)(*args))
    got = _tuple(tgraph.to_callable(tg)(*[torch.from_numpy(a)
                                          for a in args]))
    assert len(got) == len(want)
    for w, g_ in zip(want, got):
        assert tuple(g_.shape) == tuple(np.shape(w))
        if op == "cast":
            assert str(g_.dtype).replace("torch.", "") == str(w.dtype)
        _close(w, g_)


def _check_collective(op, m):
    """``op`` over m shards of 4 integer-valued rows each, against JAX's
    shard_map over m host devices."""
    from nezha_tpu.parallel._compat import shard_map
    from jax.sharding import Mesh

    per = 4 * m
    builders = {
        "all_reduce": lambda g, x: g.all_reduce(x, axis_name="dp"),
        "reduce_scatter": lambda g, x: g.reduce_scatter(x, axis_name="dp"),
        "all_gather": lambda g, x: g.all_gather(x, axis_name="dp"),
    }
    graphs = []
    for mod in (jgraph, tgraph):
        g = mod.Graph(op)
        x = g.placeholder((per, 3), name="x")
        g.output(builders[op](g, x) * 2.0)
        graphs.append(g)
    assert repr(graphs[0]) == repr(graphs[1])
    full = np.arange(m * per * 3, dtype=np.float32).reshape(m * per, 3)
    jmesh = Mesh(np.array(jax.devices()[:m]), ("dp",))
    want = np.asarray(jax.jit(shard_map(
        jgraph.to_callable(graphs[0]), mesh=jmesh, in_specs=P("dp"),
        out_specs=P("dp")))(jnp.asarray(full)))
    mesh = make_mesh({"dp": m}, device_type="cpu")
    shards = [torch.from_numpy(full[r * per:(r + 1) * per])
              for r in range(m)]
    got = tgraph.to_sharded_callable(graphs[1], mesh)(shards)
    assert len(got) == m
    assert np.array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("op", ["all_reduce", "reduce_scatter",
                                "all_gather"])
def test_collectives_match_shard_map(op, m):
    _check_collective(op, m)


def test_collective_outside_a_mesh_raises():
    g = tgraph.Graph("ar")
    g.output(g.all_reduce(g.placeholder((4,), name="x")))
    with pytest.raises(ValueError, match="needs a mesh"):
        tgraph.to_callable(g)(torch.zeros(4))


def _attn(mod, impl, causal):
    g = mod.Graph(f"attn_{impl}")
    q, k, v = (g.placeholder((2, 2, 16, 8), name=n) for n in "qkv")
    g.output(g.flash_attention(q, k, v, causal=causal, impl=impl))
    return g


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_flash_node_matches_jax(impl, causal):
    """The flash node's impls ("auto" and "pallas" run the flash kernels'
    plain versions on CPU tensors, "xla" the composed path) against
    JAX's ("pallas" in interpret mode), forward and the gradients of
    sum(out**2)."""
    q, k, v = (_r(2, 2, 16, 8, seed=s) for s in range(3))
    jf = jgraph.to_callable(_attn(jgraph, impl, causal))
    tf = tgraph.to_callable(_attn(tgraph, impl, causal))
    want = jf(q, k, v)
    jgrads = jax.grad(lambda *a: jnp.sum(jf(*a) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tf(*ts)
    _close(want, out.detach(), FLASH_RTOL, FLASH_ATOL)
    tgrads = torch.autograd.grad((out ** 2).sum(), ts)
    for a, b in zip(jgrads, tgrads):
        _close(a, b, FLASH_RTOL, FLASH_ATOL)


def _mlp_graph(mod):
    g = mod.Graph("loss")
    x = g.placeholder((4, 6), name="x")
    w = g.placeholder((6, 3), name="w")
    b = g.placeholder((3,), name="b")
    h = g.gelu((x @ w) + b)
    g.output(g.mean(g.log_softmax(h, axis=-1) * h), h)
    return g


def test_grad_callable_matches_jax_grad():
    args = [_r(4, 6), _r(6, 3, seed=1), _r(3, seed=2)]
    jg = jgraph.grad_callable(_mlp_graph(jgraph), wrt=(1, 2))(*args)
    tg = tgraph.grad_callable(_mlp_graph(tgraph), wrt=(1, 2))(
        *[torch.from_numpy(a) for a in args])
    assert isinstance(tg, tuple) and len(tg) == 2
    for a, b in zip(jg, tg):
        _close(a, b)
    one = tgraph.grad_callable(_mlp_graph(tgraph), wrt=(1,))(
        *[torch.from_numpy(a) for a in args])
    assert torch.is_tensor(one)
    _close(jg[0], one)


def test_grad_callable_needs_a_scalar_first_output():
    def vec(mod):
        g = mod.Graph("vec")
        x = g.placeholder((3,), name="x")
        g.output(x * x)
        return g

    x = _r(3)
    with pytest.raises(ValueError) as je:
        jgraph.grad_callable(vec(jgraph))(x)
    with pytest.raises(ValueError) as te:
        tgraph.grad_callable(vec(tgraph))(torch.from_numpy(x))
    assert str(te.value) == str(je.value)


def test_to_callable_checks_its_arity():
    g = _mlp_graph(tgraph)
    with pytest.raises(TypeError, match="takes 3 inputs, got 1"):
        tgraph.to_callable(g)(torch.zeros(4, 6))


def test_fx_lowering_and_compile_graph():
    """``lower_fx`` is the program's text form (one call per node,
    constants as buffers) and runs as the interpreter does;
    ``compile_graph`` binds the declared shapes and refuses others."""
    g = _mlp_graph(tgraph)
    args = [torch.from_numpy(a) for a in (_r(4, 6), _r(6, 3, seed=1),
                                          _r(3, seed=2))]
    mod = tgraph.lower_fx(g)
    assert "ir_gelu" in mod.code and "ir_log_softmax" in mod.code
    want = tgraph.to_callable(g)(*args)
    for got in (mod(*args), tgraph.compile_graph(g)(*args)):
        for a, b in zip(want, got):
            assert torch.equal(a, b)
    with pytest.raises(TypeError, match="compiled for"):
        tgraph.compile_graph(g)(torch.zeros(5, 6), *args[1:])
    c = tgraph.Graph("c")
    c.output(c.placeholder((2,), name="x") + 1.0)
    assert any(name.startswith("const") for name, _ in
               tgraph.lower_fx(c).named_buffers())


def _random_graph(mod, seed):
    """A random SSA DAG over [4, 4] tensors ending in a scalar mean
    (JAX's test_graph_property strategy, drawn from a seed)."""
    rng = np.random.default_rng(seed)
    g = mod.Graph("prop")
    n = int(rng.integers(1, 4))
    syms = [g.placeholder((4, 4), name=f"x{i}") for i in range(n)]
    for _ in range(int(rng.integers(2, 9))):
        if rng.random() < 0.5:
            op = ("add", "sub", "mul", "matmul")[int(rng.integers(4))]
            a, b = (syms[int(rng.integers(len(syms)))] for _ in range(2))
            syms.append(g._add(op, [a, b]))
        else:
            op = ("relu", "tanh", "sigmoid", "neg", "softmax")[
                int(rng.integers(5))]
            a = syms[int(rng.integers(len(syms)))]
            syms.append(g._add(op, [a]) if op != "softmax"
                        else g.softmax(a, axis=-1))
    g.output(g.mean(syms[-1]))
    return g, n


@pytest.mark.parametrize("seed", range(6))
def test_fingerprint_stable_and_structure_sensitive(seed):
    """A separately built identical graph has the same fingerprint (the
    same key as JAX's), one more op changes it; the interpreter, the
    compiled program and JAX agree on it, and autograd takes it."""
    g, n = _random_graph(tgraph, seed)
    jg, _ = _random_graph(jgraph, seed)
    assert _graph_fingerprint(g) == _graph_fingerprint(
        _random_graph(tgraph, seed)[0])
    assert _graph_fingerprint(g) == jfingerprint(jg)
    g2, _ = _random_graph(tgraph, seed)
    g2._add("neg", [g2.nodes[-1].id])
    assert _graph_fingerprint(g) != _graph_fingerprint(g2)
    args = [_r(4, 4, seed=s) for s in range(n)]
    targs = [torch.from_numpy(a) for a in args]
    eager = tgraph.to_callable(g)(*targs)
    assert torch.equal(eager, tgraph.compile_graph(g)(*targs))
    _close(jgraph.to_callable(jg)(*args), eager)
    for gr in _tuple(tgraph.grad_callable(g, tuple(range(n)))(*targs)):
        assert torch.isfinite(gr).all()


def test_executor_caches_and_counts(tmp_path):
    """One build per (graph structure, argument shapes): same-shaped
    graphs of different structure are two entries (JAX's
    test_executor_distinguishes_same_shaped_graphs); the counters and the
    compile histogram reach a run's summary."""
    g1 = tgraph.Graph("g")
    x1 = g1.placeholder((4,))
    g1.output(x1 + x1)
    g2 = tgraph.Graph("g")
    x2 = g2.placeholder((4,))
    g2.output(x2 * x2)
    obs.start_run(str(tmp_path), meta={"test": "executor"})
    try:
        ex = Executor(donate_argnums=(0,))
        three = torch.full((4,), 3.0)
        assert torch.equal(ex.run(g1, three), torch.full((4,), 6.0))
        assert torch.equal(ex.run(g2, three), torch.full((4,), 9.0))
        ex.run(g1, three)
        ex.run(g1, torch.full((5,), 1.0))   # another shape: a build
        fn = lambda a, b: {"s": a + b}
        ex.run(fn, three, b=three)
        ex.run(fn, three, b=three)
        assert ex.stats() == {"entries": 4, "hits": 2, "misses": 4}
    finally:
        summary = obs.end_run()
    import json
    summary = json.loads((tmp_path / "summary.json").read_text())
    cc = summary["compile_cache"]
    assert (cc["hits"], cc["misses"]) == (2, 4)
    assert cc["compile_seconds"]["count"] == 4
    spans = [json.loads(l) for l in
             (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert sum(s["name"] == "executor.compile" for s in spans) == 4
