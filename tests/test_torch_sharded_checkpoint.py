"""Per-shard checkpoints across packages on the CPU: a ZeRO-1 save of the
JAX package (one process, dp=2 over its host devices) restored by the
port at world 2 (two gloo processes, tests/torch_dist_worker.py), and the
port's world-2 save restored by JAX, each followed by one more step on
both sides; a world-2 save restored at world 1; torn saves, retention,
the bf16 byte view, the padding of ZeRO-1's flat state across world
sizes, and the asynchronous writer.

One AdamW step after the restore: the weights' change is held, in
relative L2 norm, to 2e-4 of JAX's (test_torch_parallel.py: AdamW
magnifies rounding where a gradient is near zero), the loss to rtol
1e-5; a restore itself is bitwise.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import optim as jax_optim
from nezha_tpu import parallel as jax_parallel
from nezha_tpu.train import sharded_checkpoint as jsc
from nezha_tpu_torch.train import sharded_checkpoint as tsc
from test_torch_parallel import (_batches, _flatten, _jax_model, _JAX_LOSS,
                                 _unflatten)
from torch_dist_worker import run_world

SPEC = {"model": "bert", "opt": ("adamw", 1e-3), "mode": "zero1",
        "clip": None}


def _jax_zero1(setup):
    """JAX's ZeRO-1 state at dp=2 from the setup's weights, and its
    step."""
    mesh, opt = setup["mesh"], jax_optim.adamw(1e-3)
    variables = {"params": _unflatten(setup["params"]), "state": {}}
    state = {"variables": jax_parallel.replicate(mesh, variables),
             "opt_state": jax_parallel.zero1_init_opt_state(
                 opt, variables["params"], mesh),
             "rng": jax_parallel.replicate(mesh, jax.random.PRNGKey(3))}
    step = jax_parallel.make_zero1_train_step(
        setup["jm"], opt, _JAX_LOSS["bert"], mesh, donate=False)
    return state, step


def _jax_step(mesh, step, state, batch):
    return step(state, jax_parallel.shard_batch(
        mesh, {k: jnp.asarray(v) for k, v in batch.items()}))


def _params(state):
    return {f"variables/params/{k}": v for k, v in
            _flatten(state["variables"]["params"]).items()}


def _assert_change_close(got, want, before, tol=2e-4):
    for k, w in want.items():
        ref = w - before[k]
        rel = np.linalg.norm(got[k] - w) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= tol, (k, rel)


@pytest.fixture(scope="module")
def setup():
    jm, params, _, sd = _jax_model("bert")
    mesh = jax_parallel.make_mesh({"dp": 2}, devices=jax.devices()[:2])
    return {"jm": jm, "params": params, "sd": sd, "mesh": mesh,
            "batches": _batches("bert", 2, 4)}


def test_jax_save_restores_in_port_at_world2(setup, tmp_path):
    mesh, b0, b1 = setup["mesh"], *setup["batches"]
    state, step = _jax_zero1(setup)
    state, _ = _jax_step(mesh, step, state, b0)
    jsc.save_sharded(str(tmp_path), state, step=1)
    before = _params(state)
    state2, m = _jax_step(mesh, step, state, b1)
    ranks = run_world("train", 2, dict(SPEC, state_dict=setup["sd"],
                                       batches=[b1],
                                       restore_dir=str(tmp_path)), tmp_path)
    for r in ranks:
        assert r["restored_step"] == 1
        np.testing.assert_allclose(r["losses"], [float(m["loss"])],
                                   rtol=1e-5)
        _assert_change_close(r["state"], _params(state2), before)
        np.testing.assert_array_equal(
            r["state"]["variables/params/mlm_bias"],
            ranks[0]["state"]["variables/params/mlm_bias"])


def test_port_save_restores_in_jax_and_at_world1(setup, tmp_path):
    mesh, b0, b1 = setup["mesh"], *setup["batches"]
    ck = tmp_path / "ck"
    saved = run_world("train", 2, dict(SPEC, state_dict=setup["sd"],
                                       batches=[b0], save_dir=str(ck)),
                      tmp_path / "w2")
    d = ck / "step_00000001.sharded"
    metas = [json.loads((d / f"meta_p{p}.json").read_text())
             for p in (0, 1)]
    assert all(m["world"] == 2 for m in metas)
    # The replicated leaves are rank 0's; each rank wrote its chunk.
    assert metas[1]["leaves"]["variables/params/mlm_bias"]["shards"] == []
    assert metas[1]["leaves"]["opt_state/mu/mlm_bias"]["shards"][0][
        "index"] == [[256, 512]]
    # JAX restores it into its dp=2 layout and takes the next step.
    template, step = _jax_zero1(setup)
    restored, at = jsc.restore_sharded(str(ck), template)
    assert at == 1 and int(restored["opt_state"]["step"]) == 1
    for k, v in _params(restored).items():
        np.testing.assert_array_equal(v, saved[0]["state"][k], err_msg=k)
    for key, chunk in saved[1]["chunks"].items():
        full = _flatten(restored["opt_state"])[key[len("opt_state/"):]]
        np.testing.assert_array_equal(full[full.size // 2:], chunk)
    state2, m = _jax_step(mesh, step, restored, b1)
    again = run_world("train", 2, dict(SPEC, state_dict=setup["sd"],
                                       batches=[b1], restore_dir=str(ck)),
                      tmp_path / "again")
    np.testing.assert_allclose(again[0]["losses"], [float(m["loss"])],
                               rtol=1e-5)
    _assert_change_close(again[0]["state"], _params(state2),
                         _params(restored))
    # The same save at world 1: every leaf bitwise, the chunks joined.
    one = run_world("train", 1, dict(SPEC, state_dict=setup["sd"],
                                     batches=[], restore_dir=str(ck)),
                    tmp_path / "w1")[0]
    assert one["restored_step"] == 1
    for k, v in saved[0]["state"].items():
        np.testing.assert_array_equal(one["state"][k], v, err_msg=k)
    for key, chunk in one["chunks"].items():
        np.testing.assert_array_equal(chunk, np.concatenate(
            [saved[0]["chunks"][key], saved[1]["chunks"][key]]))


def _leaf(data, index, shape):
    return tsc.ShardedLeaf(shape, "float32", [(index, data)])


def test_torn_save_retention_and_world_padding(tmp_path):
    ck = str(tmp_path)
    # A world-2 save of a 9-element flat leaf padded to 10, both ranks.
    x = np.arange(1, 10, dtype=np.float32)
    padded = np.concatenate([x, [0.0]]).astype(np.float32)
    for step in (2, 5):
        for proc in (0, 1):
            tsc.save_sharded(ck, {"opt_state/mu/w": _leaf(
                padded[5 * proc:5 * proc + 5], ((5 * proc, 5 * proc + 5),),
                (10,))}, step, proc=proc, world=2)
    (tmp_path / "step_00000005.sharded" / "COMPLETE_p1").unlink()
    with pytest.warns(UserWarning, match="torn"):
        assert tsc.latest_step(ck) == 2
    assert jsc.latest_step(ck) == 2
    # World 1 reads 9 elements (the cut tail is padding); world 4 pads to
    # 12 with zeros; a cut that is not padding raises, and so does a
    # weight (not flat optimizer state) of another shape.
    got, _ = tsc.restore_sharded(ck, {"opt_state/mu/w": ((9,), None)},
                                 step=2)
    np.testing.assert_array_equal(got["opt_state/mu/w"][0], x)
    got, _ = tsc.restore_sharded(ck, {"opt_state/mu/w": ((12,), ((9, 12),))},
                                 step=2)
    np.testing.assert_array_equal(got["opt_state/mu/w"][0], [0, 0, 0])
    with pytest.raises(ValueError, match="not padding"):
        tsc.restore_sharded(ck, {"opt_state/mu/w": ((8,), None)}, step=2)
    tsc.save_sharded(ck, {"variables/params/b": _leaf(padded, ((0, 10),),
                                                      (10,))}, 3, proc=0,
                     world=1)
    with pytest.raises(ValueError, match="shape mismatch"):
        tsc.restore_sharded(ck, {"variables/params/b": ((9,), None)},
                            step=3)
    # Retention counts complete saves only and never touches torn ones.
    tsc.save_sharded(ck, {"opt_state/mu/w": _leaf(padded, ((0, 10),),
                                                  (10,))}, 7, keep_last=1,
                     proc=0, world=1)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000005.sharded", "step_00000007.sharded"]
    assert tsc.latest_step(ck) == 7


def test_bf16_byte_view_and_async_round_trip(tmp_path):
    t = torch.randn(3, 5).to(torch.bfloat16)
    arr, dt = tsc.host_array(t)
    assert dt == "bfloat16" and arr.dtype == np.uint16
    leaves = {"variables/params/w": tsc.whole(arr, dt),
              "opt_state/step": tsc.whole(np.asarray(4, np.int32)),
              "rng": tsc.whole(np.asarray([0, 3], np.uint32))}
    ck = tsc.AsyncCheckpointer()
    gate = threading.Event()
    real = tsc.save_sharded

    def slow(*a, **k):
        gate.wait(30)
        return real(*a, **k)

    tsc.save_sharded = slow
    try:
        ck.save(str(tmp_path), leaves, 4, proc=0, world=1)
        assert tsc.latest_step(str(tmp_path)) is None   # still writing
        gate.set()
        ck.wait()
    finally:
        tsc.save_sharded = real
    got, step = tsc.restore_sharded(str(tmp_path), {
        "variables/params/w": ((3, 5), None), "opt_state/step": ((), None),
        "rng": ((2,), None)})
    assert step == 4 and int(got["opt_state/step"][0]) == 4
    assert torch.equal(tsc.to_tensor(*got["variables/params/w"]), t)
    # The JAX package reads the byte view back as bfloat16.
    jax_got, _ = jsc.restore_sharded(str(tmp_path), {
        "variables": {"params": {"w": jnp.zeros((3, 5), jnp.bfloat16)}},
        "opt_state": {"step": jnp.zeros((), jnp.int32)},
        "rng": jnp.zeros((2,), jnp.uint32)})
    np.testing.assert_array_equal(
        np.asarray(jax_got["variables"]["params"]["w"], np.float32),
        t.float().numpy())
