"""Sequence parallelism in the port (``parallel/ring.py``'s ring attention,
``parallel/sequence_parallel.py``'s Ulysses attention and train step,
the train CLI's ``--parallel sp``) against the JAX package on the CPU.
The port's meshes are the CPU repeated, JAX's the suite's forced host
devices; JAX's flash paths run in interpret mode (``use_flash=True``),
the port's on its kernels' plain versions. fp32 unless said:

- ring (composed and flash) and Ulysses (composed and flash) at sp=8,
  causal and non-causal: the output and the gradients of a weighted sum
  against JAX's under ``shard_map`` at JAX's own tolerances
  (``tests/test_sequence_parallel.py``: rtol 2e-4, atol 2e-5; bf16 ring
  flash rtol 0.1, atol 0.1), and the flash ring's per-shard lse
  (``ring_attention_lse(use_flash=True)``) within 2e-5;
- the sp step against JAX's ``make_sp_train_step`` for 3 steps at
  ``{dp: 2, sp: 4}`` and ``{dp: 1, sp: 2}``, ring and Ulysses, flash on
  and off: loss rtol 1e-4, parameters rtol 5e-4 and atol 5e-5 (JAX's
  sp-against-single tolerances); SGD with momentum, since AdamW turns the
  k bias's rounding-noise gradient (zero in exact arithmetic) into
  +-lr steps that differ between the packages;
- the MoE GPT-2 and remat under sp against JAX's sp step with those
  knobs (the MoE routes each shard's own tokens, as ``shard_map`` does);
- dropout 0.1: every shard's masks differ, remat replays them bitwise;
- the refusals: ``shard_lm_batch``'s ragged sequence and Ulysses' heads,
  each with JAX's message;
- the CLI: from JAX's step-1 sp checkpoint the port's step 2 (rtol
  1e-5), its save resumed bitwise, and JAX's refusals in JAX's words."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nezha_tpu import data as jax_data
from nezha_tpu import optim as jax_optim
from nezha_tpu import parallel as jax_parallel
from nezha_tpu.cli import train as jax_train_cli
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.parallel import ring as jax_ring
from nezha_tpu.parallel import sequence_parallel as jax_sp
from nezha_tpu.parallel._compat import shard_map
from nezha_tpu.train.loop import init_train_state
from nezha_tpu_torch import optim
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.cli.common import gpt2_for_preset
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.nn.layers import Dropout
from nezha_tpu_torch.parallel import (make_sp_mesh, make_sp_train_step,
                                      ring_attention, ring_attention_lse,
                                      shard_lm_batch, ulysses_attention)
from nezha_tpu_torch.parallel.mesh import Mesh
from nezha_tpu_torch.parallel.ring import ring_self_attention
from nezha_tpu_torch.train import Trainer

KW = dict(vocab_size=128, max_positions=64, num_layers=2, num_heads=4,
          hidden_size=32)


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


# ------------------------------------------------------ the attentions
def _qkv(h, seed):
    r = np.random.RandomState(seed)
    return [r.randn(2, h, 64, 16).astype(np.float32) for _ in range(3)], \
        r.randn(2, h, 64, 16).astype(np.float32)


def _jax_attention(fn, q, k, v, w):
    mesh = jax_parallel.make_mesh({"sp": 8})
    mapped = shard_map(fn, mesh=mesh,
                       in_specs=(P(None, None, "sp", None),) * 3,
                       out_specs=P(None, None, "sp", None))

    def loss(q, k, v):
        return jnp.sum(mapped(q, k, v).astype(jnp.float32) * w)

    out = jax.jit(mapped)(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x, np.float32) for x in (out,) + tuple(grads)]


def _port_attention(fn, q, k, v, w, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    split = [list(t.chunk(8, dim=2)) for t in ts]
    out = torch.cat(fn(*split), dim=2)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [x.detach().float().numpy() for x in [out] + [t.grad for t in ts]]


@pytest.mark.parametrize("impl,flash,causal", [
    ("ring", False, True), ("ring", False, False), ("ring", True, True),
    ("ring", True, False), ("ulysses", False, True),
    ("ulysses", True, True), ("ulysses", True, False)])
def test_attention_matches_jax_shard_map(devices8, impl, flash, causal):
    h = 8 if impl == "ulysses" else 4
    (q, k, v), w = _qkv(h, seed=int(flash))
    jfn = jax_ring.ring_attention if impl == "ring" \
        else jax_sp.ulysses_attention
    want = _jax_attention(
        lambda a, b, c: jfn(a, b, c, "sp", causal=causal, use_flash=flash),
        q, k, v, w)
    tfn = ring_attention if impl == "ring" else ulysses_attention
    got = _port_attention(
        lambda a, b, c: tfn(a, b, c, causal=causal, use_flash=flash),
        q, k, v, w)
    for name, g, x in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, x, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_ring_flash_bf16_and_lse_match_jax(devices8):
    """bf16 through the flash ring at JAX's bf16 tolerances; the flash
    lse variant's per-shard lse against JAX's; ``use_flash=None`` is the
    flash path; the whole-tensor wrapper equals the per-shard call."""
    (q, k, v), w = _qkv(4, seed=3)
    bf = jnp.bfloat16
    want = _jax_attention(
        lambda a, b, c: jax_ring.ring_attention(a, b, c, "sp",
                                                use_flash=True),
        *(jnp.asarray(x, bf) for x in (q, k, v)), w)
    got = _port_attention(lambda a, b, c: ring_attention(a, b, c),
                          q, k, v, w, dtype=torch.bfloat16)
    for name, g, x in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, x, rtol=0.1, atol=0.1, err_msg=name)
    mesh = jax_parallel.make_mesh({"sp": 8})
    jl = shard_map(lambda a, b, c: jax_ring.ring_attention_lse(
        a, b, c, "sp", use_flash=True)[1], mesh=mesh,
        in_specs=(P(None, None, "sp", None),) * 3,
        out_specs=P(None, None, "sp"))
    want_lse = np.asarray(jax.jit(jl)(q, k, v))
    split = [list(torch.from_numpy(x).chunk(8, dim=2)) for x in (q, k, v)]
    outs, lses = ring_attention_lse(*split, use_flash=True)
    np.testing.assert_allclose(torch.cat(lses, dim=2).numpy(), want_lse,
                               rtol=2e-5, atol=2e-5)
    whole = ring_self_attention(Mesh((torch.device("cpu"),) * 8, "sp"),
                                *(torch.from_numpy(x) for x in (q, k, v)))
    assert torch.equal(whole, torch.cat(outs, dim=2))


def test_refusals_carry_jaxs_messages(devices8):
    """Ulysses over heads the world does not divide, and a sequence the
    sp axis does not divide, each JAX's ValueError."""
    (q, k, v), _ = _qkv(4, seed=0)
    mesh = jax_parallel.make_mesh({"sp": 8})
    with pytest.raises(ValueError) as want:
        shard_map(lambda a, b, c: jax_sp.ulysses_attention(a, b, c, "sp"),
                  mesh=mesh, in_specs=(P(None, None, "sp", None),) * 3,
                  out_specs=P(None, None, "sp", None))(q, k, v)
    split = [list(torch.from_numpy(x).chunk(8, dim=2)) for x in (q, k, v)]
    with pytest.raises(ValueError) as got:
        ulysses_attention(*split)
    assert str(got.value) == str(want.value)
    tokens = {"tokens": np.zeros((4, 31), np.int32)}
    with pytest.raises(ValueError) as want:
        jax_sp.shard_lm_batch(jax_parallel.make_mesh({"dp": 2, "sp": 4}),
                              tokens)
    with pytest.raises(ValueError) as got:
        shard_lm_batch(make_sp_mesh({"dp": 2, "sp": 4}, device_type="cpu"),
                       tokens)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------- the sp step
def _models(impl, flash, **kw):
    jm = JaxGPT2(JaxGPT2Config(**KW, attn_impl=impl, sp_use_flash=flash,
                               **kw))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = GPT2(GPT2Config(**KW, attn_impl=impl, sp_use_flash=flash, **kw),
              device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


def _run_both(impl, flash, axes, steps=3, **kw):
    jm, jv, tm = _models(impl, flash, **kw)
    jopt = jax_optim.momentum(0.1, 0.9)
    mesh = jax_parallel.make_mesh(
        axes, devices=jax.devices()[:axes["dp"] * axes["sp"]])
    jstate = jax_parallel.replicate(mesh, init_train_state(
        jm, jopt, jax.random.PRNGKey(0)))
    jstep = jax_sp.make_sp_train_step(jm, jopt, mesh, donate=False)
    step = make_sp_train_step(tm, optim.momentum(0.1, 0.9),
                              make_sp_mesh(axes, device_type="cpu"))
    batches = jax_data.synthetic_token_batches(8, seq_len=32,
                                               vocab_size=128)
    for _ in range(steps):
        batch = next(batches)
        jstate, jmet = jstep(jstate, jax_sp.shard_lm_batch(mesh, batch))
        met = step(batch)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, atol=1e-5)
    want = params_from_jax(_flatten(jax.device_get(
        jstate["variables"]["params"])))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 4}, {"dp": 1, "sp": 2}],
                         ids=["dp2sp4", "dp1sp2"])
@pytest.mark.parametrize("impl,flash", [("ring", True), ("ring", False),
                                        ("ulysses", True),
                                        ("ulysses", False)])
def test_sp_step_matches_jax(devices8, impl, flash, axes):
    _run_both(impl, flash, axes)


@pytest.mark.parametrize("knob", [{"moe_experts": 4}, {"remat": True}],
                         ids=["moe", "remat"])
def test_sp_step_knobs_match_jax(devices8, knob):
    """The composed ring on both sides (the knobs are the ring's
    neighbours, not its hops)."""
    _run_both("ring", False, {"dp": 1, "sp": 2}, steps=2, **knob)


def _recorded_masks(step, batch):
    """The dropout masks of one step's forward, by call, with the
    replica's seeds: -> [(shape, mask)] in call order."""
    masks = []
    orig = Dropout.forward

    def record(self, x):
        y = orig(self, x)
        if self.training and self.rate:
            masks.append(y != 0)
        return y

    Dropout.forward = record
    try:
        loss, grads = step.loss_and_grads(batch)
    finally:
        Dropout.forward = orig
    return masks, loss, grads


def test_dropout_masks_differ_per_shard_and_remat_replays():
    """Dropout 0.1 at dp=1,sp=2: the two shards' embedding masks, and
    their masks of each layer's two dropouts, differ; a second forward at
    the same step seed draws the same masks; with remat the loss and
    every gradient equal the plain step's bitwise."""
    batch = {"tokens": np.random.RandomState(0).randint(0, 128, (2, 33))}
    runs = []
    for remat in (False, True):
        tm = GPT2(GPT2Config(**KW, attn_impl="ring", dropout=0.1,
                             remat=remat), device="cpu")
        step = make_sp_train_step(tm, optim.sgd(0.1),
                                  make_sp_mesh({"dp": 1, "sp": 2},
                                               device_type="cpu"))
        masks, loss, grads = _recorded_masks(step, batch)
        runs.append((masks, loss, grads))
    masks = runs[0][0]
    # embed s0, embed s1, then per layer: s0 attn, s0 mlp, s1 attn, s1 mlp
    assert len(masks) == 2 + 4 * KW["num_layers"]
    assert not torch.equal(masks[0], masks[1])
    for i in range(KW["num_layers"]):
        s0, s1 = masks[2 + 4 * i:2 + 4 * i + 2], masks[4 + 4 * i:6 + 4 * i]
        for a, b in zip(s0, s1):
            assert not torch.equal(a, b)
    again, _, _ = _recorded_masks(step, batch)
    assert all(torch.equal(a, b) for a, b in zip(runs[1][0], again))
    (m0, l0, g0), (_, l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_sp_step_refuses_a_plain_model_and_plain_forward_refuses_sp():
    with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
        make_sp_train_step(GPT2(GPT2Config(**KW), device="cpu"),
                           optim.sgd(0.1),
                           make_sp_mesh({"dp": 1, "sp": 2},
                                        device_type="cpu"))
    ring = GPT2(GPT2Config(**KW, attn_impl="ring"), device="cpu")
    with pytest.raises(ValueError, match="sequence-parallel step"):
        ring(torch.zeros((1, 8), dtype=torch.long))
    with pytest.raises(NotPortedError, match="A7"):
        make_sp_mesh({"dp": 2, "sp": 1}, devices=["cpu", "meta"],
                     device_type="cpu")


# ------------------------------------------------------------ the CLI
BASE = ["--config", "gpt2_124m", "--model-preset", "tiny", "--batch-size",
        "4", "--seq-len", "32", "--parallel", "sp", "--mesh", "dp=1,sp=2"]


def _port(argv):
    return train_cli.run(train_cli.parse_args(argv + ["--device", "cpu"]))


def test_cli_sp_from_jax_checkpoint_then_resume_bitwise(devices8, tmp_path,
                                                        capsys):
    """JAX's CLI trains two sp steps, saving each; from its step-1 save
    the port's CLI trains step 2 (rtol 1e-5) with the flash ring, and
    again with Ulysses composed; its save, installed into a fresh step
    as a resume installs it, reads back bitwise; a resume trains on and
    evaluates."""
    jd = tmp_path / "jax"
    jax_train_cli.main(BASE + ["--steps", "2", "--ckpt-dir", str(jd),
                               "--ckpt-every", "1", "--log-every", "1",
                               "--metrics-file", str(tmp_path / "m.jsonl")])
    want = {r["step"]: r["loss"] for r in map(
        json.loads, (tmp_path / "m.jsonl").read_text().splitlines())
        if "loss" in r}
    for extra in ([], ["--attn-impl", "ulysses", "--sp-flash", "off"]):
        mine = tmp_path / ("port" + "".join(extra))
        mine.mkdir()
        shutil.copy(jd / "step_00000001.npz", mine)
        last = _port(BASE + extra + ["--steps", "1", "--ckpt-dir",
                                     str(mine), "--log-every", "0"])
        assert "resumed from step 1" in capsys.readouterr().err
        assert last["step"] == 2
        np.testing.assert_allclose(last["loss"], want[2], rtol=1e-5)
    tm = gpt2_for_preset("tiny", device="cpu", max_positions=32,
                         attn_impl="ring", fused_loss_chunk=-1)
    step = make_sp_train_step(tm, optim.adamw(1e-3),
                              make_sp_mesh({"dp": 1, "sp": 2},
                                           device_type="cpu"))
    trainer = Trainer(tm, step.optimizer, None, step_fn=step,
                      checkpoint_dir=str(mine))
    assert trainer.initialize() == 2
    with np.load(mine / "step_00000002.npz") as z:
        for key, arr in trainer.state_dict().items():
            assert np.array_equal(np.asarray(arr), z[key]), key
    last = _port(BASE + ["--steps", "1", "--ckpt-dir", str(mine),
                         "--mesh", "dp=2,sp=2", "--eval", "--eval-batches",
                         "1"])
    assert last["step"] == 3 and np.isfinite(last["eval_perplexity"])


@pytest.mark.parametrize("argv", [
    ["--config", "bert_base_zero1", "--model-preset", "tiny", "--parallel",
     "sp", "--mesh", "dp=1,sp=2"],
    BASE[:-2] + ["--mesh", "dp=1,tp=2"],
    BASE[:-2] + ["--mesh", "sp=2"],
    ["--config", "gpt2_124m", "--model-preset", "tiny", "--parallel",
     "gspmd", "--mesh", "dp=1,tp=2", "--sp-flash", "on"],
    BASE + ["--grad-allreduce", "int8"],
])
def test_cli_sp_refusals_are_jax_words(devices8, argv, capsys):
    with pytest.raises(SystemExit) as e:
        jax_train_cli.main(argv + ["--steps", "1"])
    want = str(e.value.code)
    assert want and not want.isdigit()
    with pytest.raises(SystemExit) as e:
        _port(argv + ["--steps", "1"])
    assert want in str(e.value.code) + capsys.readouterr().err


def test_cli_sp_port_refusals():
    """sp across processes is refused typed before the rendezvous (and
    with it --on-failure rejoin under sp); ring/ulysses ask for
    --parallel sp; sp takes no other attention."""
    with pytest.raises(NotPortedError, match="across processes"):
        train_cli._run_world(train_cli.parse_args(
            BASE + ["--device", "cpu", "--coordinator", "127.0.0.1:1",
                    "--on-failure", "rejoin", "--ckpt-dir", "/x"]))
    with pytest.raises(SystemExit, match="needs --parallel sp"):
        train_cli.parse_args(["--config", "gpt2_124m", "--attn-impl",
                              "ulysses"])
    with pytest.raises(SystemExit, match="ring or ulysses"):
        train_cli.parse_args(BASE + ["--attn-impl", "flash"])
    with pytest.raises(SystemExit, match="batch of 3 rows"):
        _port(BASE + ["--batch-size", "3", "--mesh", "dp=2,sp=2",
                      "--steps", "1"])
