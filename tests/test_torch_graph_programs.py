"""The port's graph-IR training programs (``nezha_tpu_torch/graph/
programs.py``) against the JAX package's, step for step from the same
state, on the CPU at tiny sizes (inputs from seeded numpy):

- the MLP: single-device (also with the IR clip), dp at M = 2 and 4 on
  ``[cpu] * M`` against JAX's shard_map over M host devices, and ZeRO-1
  at M = 2 (its flat dp-sharded state);
- GPT-2 in fp32 (the composed attention and the flash node) and under
  the bf16 policy authored in the IR (``compute_dtype="bfloat16"``), and
  with ``clip_norm``; dp at M = 2;
- BERT (the composed attention against JAX's; the flash node, non-causal,
  against JAX's composed program);
- the ResNet, single-device and dp at M = 2.

Tolerances: fp32 losses to 1e-5 relative and the state to 2e-5
absolute; the bf16 policy's losses to 1e-3 and its parameter update to
1.5 times the distance between JAX's bf16 and fp32 updates (the bf16
products round differently, and AdamW turns a near-zero gradient's sign
into a full step); the flash node against the composed
attention at the JAX test's 5e-4 / 5e-5 on the loss and 1e-4 on the
state. The learning rate is the configs' warmup schedule (its first
steps move each AdamW weight by ~lr), so the state comparison checks the
update's direction and size.
"""

import numpy as np
import pytest
import torch

import jax

from nezha_tpu import models as jmodels
from nezha_tpu import parallel as jparallel
from nezha_tpu.graph import programs as jp
from nezha_tpu_torch.cli.common import TINY_BERT_KW, TINY_GPT2_KW
from nezha_tpu_torch.graph import programs as tp
from nezha_tpu_torch.models.bert import Bert, BertConfig
from nezha_tpu_torch.models.gpt2 import GPT2, GPT2Config
from nezha_tpu_torch.models.resnet import ResNet
from nezha_tpu_torch.parallel.mesh import make_mesh

MLP_DIMS = [784, 32, 32, 10]


def _np_tree(tree):
    return tp.tree_map(lambda t: t.detach().cpu().numpy().copy()
                       if torch.is_tensor(t) else np.asarray(t), tree)


def _max_diff(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = tp.tree_leaves(ttree)
    assert len(jl) == len(tl)
    return max(float(np.max(np.abs(np.asarray(a, np.float32)
                                   - b.detach().float().numpy())))
               for a, b in zip(jl, tl))


def _mlp_batch(seed, n=8):
    rng = np.random.default_rng(seed)
    b = {"image": rng.random((n, 784), dtype=np.float32),
         "label": rng.integers(0, 10, n)}
    return jp.onehot_shard_fn(10)(b)


def _jmesh(m):
    return jparallel.make_mesh({"dp": m}, devices=jax.devices()[:m])


def _run(jstep, jstate, tstep, tstate, batches, jshard=None):
    jl, tl = [], []
    for b in batches:
        jstate, jm = jstep(jstate, jshard(b) if jshard else b)
        tstate, tm = tstep(tstate, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jstate, tstate, np.asarray(jl), np.asarray(tl)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_mlp_single_matches_jax(clip):
    st = tp.init_graph_mlp_state(MLP_DIMS, seed=0)
    js = _np_tree(st)
    js, st, jl, tl = _run(
        jp.make_mlp_graph_train_step(MLP_DIMS, 8, 0.1, clip_norm=clip), js,
        tp.make_mlp_graph_train_step(MLP_DIMS, 8, 0.1, clip_norm=clip), st,
        [_mlp_batch(s) for s in range(3)])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert _max_diff(js, st) < 2e-5


@pytest.mark.parametrize("m", [2, 4])
def test_mlp_dp_matches_jax(m):
    """The dp program on ``[cpu] * m``: JAX's dp losses and state, and the
    executor built once."""
    mesh = make_mesh({"dp": m}, device_type="cpu")
    jmesh = _jmesh(m)
    st = tp.init_graph_mlp_state(MLP_DIMS, seed=1)
    step = tp.make_mlp_graph_dp_train_step(MLP_DIMS, 8, 0.1, mesh)
    js, st, jl, tl = _run(
        jp.make_mlp_graph_dp_train_step(MLP_DIMS, 8, 0.1, jmesh),
        _np_tree(st), step, st, [_mlp_batch(s) for s in range(3)],
        jshard=lambda b: jparallel.shard_batch(jmesh, b))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert _max_diff(js, st) < 2e-5
    assert step.executor.stats() == {"entries": 1, "hits": 2, "misses": 1}


def test_mlp_zero1_matches_jax_and_single():
    mesh = make_mesh({"dp": 2}, device_type="cpu")
    jmesh = _jmesh(2)
    single = tp.init_graph_mlp_state(MLP_DIMS, seed=2)
    model_state = tp.init_graph_mlp_zero1_state(
        MLP_DIMS, mesh, seed=2)
    assert [c.shape for c in model_state["flat"]] == \
        [model_state["flat"][0].shape] * 2
    jstate = jp.init_graph_mlp_zero1_state(MLP_DIMS, jax.random.PRNGKey(0),
                                           jmesh)
    # The same values in both: the port's init, placed on JAX's mesh.
    from jax.sharding import NamedSharding
    sh = NamedSharding(jmesh, jax.sharding.PartitionSpec("dp"))
    jstate = {k: jax.device_put(tp.zero1_flat(v), sh)
              for k, v in model_state.items()}
    batches = [_mlp_batch(s) for s in range(3)]
    js, zs, jl, tl = _run(
        jp.make_mlp_graph_zero1_train_step(MLP_DIMS, 8, 0.1, jmesh),
        jstate, tp.make_mlp_graph_zero1_train_step(MLP_DIMS, 8, 0.1, mesh),
        model_state, batches,
        jshard=lambda b: jparallel.shard_batch(jmesh, b))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tp.zero1_flat(zs["flat"]),
                               np.asarray(js["flat"]), atol=2e-5)
    s1 = tp.make_mlp_graph_train_step(MLP_DIMS, 8, 0.1)
    for b in batches:
        single, _ = s1(single, b)
    np.testing.assert_allclose(
        _flat_params(tp.materialize_graph_zero1_params(MLP_DIMS, zs)),
        _flat_params(single["params"]), atol=2e-5)


def _flat_params(tree):
    return np.concatenate([np.asarray(x.numpy() if torch.is_tensor(x)
                                      else x).ravel()
                           for x in tp.tree_leaves(tree)])


def _gpt2(attn_impl="auto", **kw):
    gen = torch.Generator()
    gen.manual_seed(0)
    return GPT2(GPT2Config(**TINY_GPT2_KW, attn_impl=attn_impl, **kw),
                generator=gen, device="cpu")


def _jgpt2(attn_impl):
    return jmodels.GPT2(jmodels.GPT2Config(**TINY_GPT2_KW,
                                           attn_impl=attn_impl))


def _lm_batches(n=2, b=2, s=32):
    rng = np.random.default_rng(0)
    return [tp.lm_shard_fn()({"tokens": rng.integers(0, 512, (b, s + 1))})
            for _ in range(n)]


def _sched(t):
    # The gpt2 config's warmup, from a later step (a larger lr).
    return 6e-4 * min(1.0, (t + 20) / 100)


def _jstate(st):
    out = _np_tree(st)
    out["step"] = np.asarray(st["step"], np.int32)
    return out


@pytest.mark.parametrize("attn,dtype,clip", [
    ("xla", "float32", None), ("auto", "float32", None),
    ("auto", "bfloat16", None), ("xla", "bfloat16", None),
    ("xla", "float32", 0.05)])
def test_gpt2_matches_jax(attn, dtype, clip):
    """The GPT-2 program against JAX's: the flash node ("auto": the flash
    kernels' plain versions here) against JAX's composed CPU path at the
    flash tolerances; "xla" node for node."""
    st = tp.init_graph_gpt2_state(_gpt2(attn))
    assert st["step"] == 0 and st["params"]["h0"]["attn"]["qkv"]["w"].shape \
        == (64, 192)
    tstep = tp.make_gpt2_graph_train_step(_gpt2(attn), _sched,
                                          clip_norm=clip,
                                          compute_dtype=dtype)
    jstep = jp.make_gpt2_graph_train_step(_jgpt2(attn), _sched,
                                          clip_norm=clip,
                                          compute_dtype=dtype)
    p0 = _flat_params(st["params"])
    js, st, jl, tl = _run(jstep, _jstate(st), tstep, st, _lm_batches())
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(tl, jl, rtol=1e-3 if bf16 else (
        5e-4 if attn == "auto" else 1e-5))
    if bf16:
        # AdamW moves a weight with a near-zero gradient by ~lr in the
        # sign of its bf16-rounded gradient, so two bf16 runs differ by
        # as much as bf16 differs from fp32: the port's update must lie
        # within 1.5 times the distance of JAX's bf16 update from JAX's
        # fp32 update (about 7.6% of its norm here).
        want = _flat_params(js["params"]) - p0
        got = _flat_params(st["params"]) - p0
        j32 = _jstate(tp.init_graph_gpt2_state(_gpt2(attn)))
        for b in _lm_batches():
            j32, _ = jp.make_gpt2_graph_train_step(
                _jgpt2(attn), _sched, clip_norm=clip)(j32, b)
        spread = np.linalg.norm(want - (_flat_params(j32["params"]) - p0))
        assert np.linalg.norm(got - want) < 1.5 * spread
    for key in ("params", "mu", "nu") if not bf16 else ():
        assert _max_diff(js[key], st[key]) < (1e-4 if attn == "auto"
                                              else 2e-5), key
    assert int(st["step"]) == int(js["step"]) == 2
    # Placeholders: JAX's flatten order under JAX's leaf names.
    tg = tstep._built[(2, 32)]["loss_graph"]
    jg = jstep._built[(2, 32)]["loss_graph"]
    names = lambda g: [g.nodes[p].name for p in g.placeholders]
    assert names(tg) == names(jg)
    assert repr(tg) == repr(jg)


def test_gpt2_dp_matches_jax():
    mesh = make_mesh({"dp": 2}, device_type="cpu")
    jmesh = _jmesh(2)
    st = tp.init_graph_gpt2_state(_gpt2("xla"))
    js, st, jl, tl = _run(
        jp.make_gpt2_graph_train_step(_jgpt2("xla"), _sched, mesh=jmesh),
        _jstate(st),
        tp.make_gpt2_graph_train_step(_gpt2("xla"), _sched, mesh=mesh), st,
        _lm_batches(b=4),
        jshard=lambda b: jparallel.shard_batch(jmesh, b))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert _max_diff(js["params"], st["params"]) < 2e-5


def _bert_batches(n=2, b=2, s=32):
    from nezha_tpu.data import synthetic_mlm_batches
    it = synthetic_mlm_batches(b, seq_len=s, vocab_size=512, mask_token=1)
    return [tp.bert_shard_fn()(next(it)) for _ in range(n)]


@pytest.mark.parametrize("attn", ["xla", "auto"])
def test_bert_matches_jax(attn):
    gen = torch.Generator()
    gen.manual_seed(0)
    model = Bert(BertConfig(**TINY_BERT_KW, attn_impl=attn), generator=gen,
                 device="cpu")
    st = tp.init_graph_bert_state(model)
    jmodel = jmodels.Bert(jmodels.BertConfig(**TINY_BERT_KW))
    tstep = tp.make_bert_graph_train_step(model, _sched)
    js, st, jl, tl = _run(jp.make_bert_graph_train_step(jmodel, _sched),
                          _jstate(st), tstep, st, _bert_batches())
    flash = attn == "auto"
    np.testing.assert_allclose(tl, jl, rtol=5e-4 if flash else 1e-5)
    assert _max_diff(js["params"], st["params"]) < (1e-4 if flash
                                                    else 2e-5)
    g = tstep._built[(2, 32)]["loss_graph"]
    assert any(n.op == "flash_attention" and not n.attrs["causal"]
               for n in g.nodes) == flash
    if flash:   # the flash node cannot apply a padding mask
        b = dict(_bert_batches(1)[0])
        b["attn_mask"] = b["attn_mask"].copy()
        b["attn_mask"][0, ..., -1] = -1e30
        with pytest.raises(ValueError, match="padding mask"):
            tstep(st, b)


def _resnet():
    gen = torch.Generator()
    gen.manual_seed(0)
    return ResNet((1, 1), num_classes=10, generator=gen)


def _image_batches(n=2, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [tp.image_shard_fn()({
        "image": rng.random((b, 32, 32, 3), dtype=np.float32),
        "label": rng.integers(0, 10, b)}) for _ in range(n)]


@pytest.mark.parametrize("mode", ["single", "dp"])
def test_resnet_matches_jax(mode):
    model = _resnet()
    st = tp.init_graph_resnet_state(model)
    jmodel = jmodels.ResNet((1, 1), num_classes=10)
    if mode == "single":
        tstep = tp.make_resnet_graph_train_step(model, lr=0.1)
        jstep = jp.make_resnet_graph_train_step(jmodel, lr=0.1)
        jshard = None
    else:
        jmesh = _jmesh(2)
        tstep = tp.make_resnet_graph_dp_train_step(
            model, 4, lr=0.1, mesh=make_mesh({"dp": 2}, device_type="cpu"))
        jstep = jp.make_resnet_graph_dp_train_step(jmodel, 4, lr=0.1,
                                                   mesh=jmesh)
        jshard = lambda b: jparallel.shard_batch(jmesh, b)
    js, st, jl, tl = _run(jstep, _np_tree(st), tstep, st, _image_batches(),
                          jshard=jshard)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert _max_diff(js, st) < 1e-4
    # The HWIO kernels round-trip into the module.
    tp.load_param_tree(model, st["params"])
    again = tp.module_param_tree(model)
    assert all(torch.equal(a, b) for a, b in
               zip(tp.tree_leaves(again), tp.tree_leaves(st["params"])))
