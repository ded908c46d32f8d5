"""One rank of a multi-process test of the port's distributed training
(tests/test_torch_dist.py, test_torch_parallel.py, test_torch_quantized.py,
test_torch_sharded_checkpoint.py), in a process of its own: it imports
neither jax nor nezha_tpu.

    python tests/torch_dist_worker.py TASK PORT PAYLOAD OUT_DIR

joins the coordinator at 127.0.0.1:PORT, starts torch.distributed over
gloo through ``init_torch_distributed``, runs TASK on the pickled
PAYLOAD and pickles the result as OUT_DIR/rank<r>.pkl. :func:`run_world`
starts a coordinator on a free port and a world of such processes, and
fails (never hangs) when one does not finish in time.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run_world(task: str, world: int, payload, tmp_path, timeout=120,
              env=None):
    """Run ``task`` on ``world`` worker processes; -> their results in
    rank order."""
    sys.path.insert(0, str(ROOT))
    from nezha_tpu_torch import dist

    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    pin = tmp_path / f"{task}.payload.pkl"
    pin.write_bytes(pickle.dumps(payload))
    out = tmp_path / f"{task}.out"
    out.mkdir(exist_ok=True)
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    with dist.Coordinator(world_size=world) as coord:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__)), task, str(coord.port),
             str(pin), str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
            for _ in range(world)]
        try:
            logs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-4000:]
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


# --------------------------------------------------------------- tasks
def _np(t):
    return t.detach().cpu().numpy().copy()


def task_launch(payload, rank, world, group):
    import torch
    import torch.distributed as tdist
    x = torch.full((3,), float(rank + 1))
    tdist.all_reduce(x)
    return {"sum": _np(x), "backend": tdist.get_backend(),
            "world": tdist.get_world_size(), "rank": tdist.get_rank(),
            "coord_rank": group.rank}


def task_collectives(payload, rank, world, group):
    import torch

    from nezha_tpu_torch import obs
    from nezha_tpu_torch.parallel import collectives as c
    x = {k: torch.from_numpy(v[rank]) for k, v in payload.items()}
    obs.enable()
    out = {"sum": c.all_reduce_sum(x), "mean": c.all_reduce_mean(x),
           "gather0": c.all_gather(x), "gather1": c.all_gather(
               x["m"], axis=1), "stack": c.all_gather(x["m"], tiled=False),
           "rs": c.reduce_scatter(c.all_gather(x)),
           "rs1": c.reduce_scatter(c.all_gather(x["m"], axis=1), axis=1)}
    c.barrier()
    res = {}
    for k, v in out.items():
        res[k] = {n: _np(t) for n, t in v.items()} if isinstance(v, dict) \
            else _np(v)
    res["collectives"] = obs.REGISTRY.snapshot()["collectives"]
    res["bytes"] = {op: row["payload_bytes"]
                    for op, row in res["collectives"].items()}
    obs.disable()
    return res


def task_quantized(payload, rank, world, group):
    import torch

    from nezha_tpu_torch.parallel import quantized as q
    tree = {k: torch.from_numpy(v[rank]) for k, v in payload["tree"].items()}
    block, min_numel = payload["block"], payload["min_numel"]
    out = q.quantized_all_reduce_mean(tree, block=block, min_numel=min_numel)
    flat = torch.from_numpy(payload["flat"][rank])
    rs = q.quantized_reduce_scatter_mean(flat, block=block)
    ag = q.quantized_all_gather(rs, block=block)
    return {"tree": {k: _np(v) for k, v in out.items()}, "rs": _np(rs),
            "ag": _np(ag)}


def build_model(spec):
    """The port model of a test spec, on the CPU."""
    from nezha_tpu_torch.cli.common import TINY_BERT_KW, TINY_GPT2_KW
    from nezha_tpu_torch.models.bert import Bert, BertConfig
    from nezha_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from nezha_tpu_torch.models.resnet import ResNet
    from nezha_tpu_torch.tensor.policy import f32_policy
    if spec in ("gpt2", "gpt2_moe"):
        moe = {"moe_experts": 4} if spec == "gpt2_moe" else {}
        return GPT2(GPT2Config(**TINY_GPT2_KW, **moe), policy=f32_policy(),
                    device="cpu")
    if spec == "bert":
        return Bert(BertConfig(**TINY_BERT_KW), device="cpu")
    if spec == "resnet":
        return ResNet((1, 1), num_classes=10, stem="s2d", device="cpu")
    raise ValueError(spec)


def loss_of(spec):
    from nezha_tpu_torch.models.bert import mlm_loss
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.ops.losses import \
        softmax_cross_entropy_with_integer_labels as ce
    if spec in ("gpt2", "gpt2_moe"):
        return lm_loss
    if spec == "bert":
        return mlm_loss
    return lambda logits, b: ce(logits, b["label"])


def build_optimizer(spec, group=None):
    from nezha_tpu_torch import optim
    kind, *args = spec["opt"]
    opt = {"sgd": optim.sgd, "momentum": optim.momentum,
           "adamw": optim.adamw, "lars": optim.lars, "lamb": optim.lamb,
           "adafactor": optim.adafactor}[kind](*args)
    if spec.get("clip"):
        opt = optim.with_grad_clipping(opt, spec["clip"], group=group)
    if spec.get("accum"):
        opt = optim.accumulate_gradients(opt, spec["accum"])
    return opt


def task_train(payload, rank, world, group):
    """dp or zero1 steps from the payload's weights on this rank's rows
    of each global batch; optionally restore a sharded save first and
    save one after."""
    import torch
    import torch.distributed as tdist

    from nezha_tpu_torch.models.convert import (load_train_state,
                                                train_state_to_jax)
    from nezha_tpu_torch.parallel.data_parallel import (DPTrainStep,
                                                        local_rows,
                                                        replicate)
    from nezha_tpu_torch.parallel.zero1 import Zero1TrainStep
    from nezha_tpu_torch.train import sharded_checkpoint as sck

    torch.manual_seed(rank)   # replicate() must make the ranks agree
    model = build_model(payload["model"])
    if rank == 0:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               payload["state_dict"].items()})
    replicate(model)
    zero1 = payload["mode"] == "zero1"
    opt = build_optimizer(payload, tdist.group.WORLD if zero1 else None)
    build = Zero1TrainStep if zero1 else DPTrainStep
    step = build(model, opt, loss_of(payload["model"]),
                 grad_reduce=payload.get("grad_reduce", "fp32"))
    res = {"restored_step": None}
    if payload.get("restore_dir"):
        got, at = sck.restore_sharded(payload["restore_dir"],
                                      step.restore_request())
        load_train_state({k: a for k, (a, _) in got.items()
                          if k.startswith("variables/")}, model)
        step.load_chunks({k: a for k, (a, _) in got.items()
                          if k.startswith("opt_state/")})
        res["restored_step"] = at
    from nezha_tpu_torch import obs
    if payload.get("telemetry"):
        obs.REGISTRY.reset()
        obs.enable()
    losses = []
    for b in payload["batches"]:
        losses.append(float(step(local_rows(b, rank, world))["loss"]))
    if payload.get("telemetry"):
        res["collectives"] = obs.REGISTRY.snapshot()["collectives"]
        obs.disable()
    if payload.get("save_dir"):
        sck.save_sharded(payload["save_dir"],
                         step.shard_leaves(np.asarray([0, 7], np.uint32)),
                         payload.get("save_step", len(losses)))
    res.update(losses=losses, state=train_state_to_jax(model),
               opt_state_bytes=step.opt_state_bytes())
    if zero1:
        res["chunks"] = {key: _np(t) for key, t in
                         step.state_chunks().items()}
    return res


def task_eval(payload, rank, world, group):
    """The train CLI's eval at world > 1: this rank's rows of each global
    batch through ``evaluate``, the sums added over the group; -> the
    metrics and the rows this rank evaluated."""
    import torch
    import torch.distributed as tdist

    from nezha_tpu_torch.cli.train import _split_rows
    from nezha_tpu_torch.train.eval import evaluate, lm_token_stats

    model = build_model("gpt2")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           payload["state_dict"].items()})
    rows = []

    def stat(out, batch):
        rows.append(len(batch["tokens"]))
        return lm_token_stats(out, batch)

    res = evaluate(model, _split_rows(iter(payload["batches"]), rank, world),
                   stat, max_batches=payload["max_batches"],
                   group=tdist.group.WORLD)
    return {"metrics": res, "rows": rows}


TASKS = {"launch": task_launch, "collectives": task_collectives,
         "quantized": task_quantized, "train": task_train,
         "eval": task_eval}


def main(argv):
    task, port, pin, out = argv
    sys.path.insert(0, str(ROOT))
    from nezha_tpu_torch import dist
    from nezha_tpu_torch.dist import init_torch_distributed

    payload = pickle.loads(Path(pin).read_bytes())
    group = dist.join("127.0.0.1", int(port), timeout_s=60)
    try:
        init_torch_distributed(group, "gloo", timeout_s=60)
        result = TASKS[task](payload, group.rank, group.world_size, group)
        (Path(out) / f"rank{group.rank}.pkl").write_bytes(
            pickle.dumps(result))
        group.barrier(timeout_s=60)
    finally:
        import torch.distributed as tdist
        if tdist.is_initialized():
            tdist.destroy_process_group()
        group.leave()


if __name__ == "__main__":
    main(sys.argv[1:])
