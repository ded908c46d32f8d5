"""The training step and the host-side loop (counterpart of
``nezha_tpu/train/loop.py``).

JAX compiles forward, backward and update into one program over an
immutable state. PyTorch runs them eagerly: the step holds the model's
parameters (updated in place) and the optimizer state, so ``step(batch)``
takes only the batch. Module state — BatchNorm's running statistics —
lives in the model's buffers and is updated by the training forward
itself, where JAX's step threads the new state out of ``apply`` and
merges it (``merge_state``).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from nezha_tpu_torch import obs
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.nn.layers import Dropout
from nezha_tpu_torch.obs.metrics import StepTimer
from nezha_tpu_torch.optim.optimizers import (Optimizer, apply_updates_,
                                              state_leaves)


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A dict of arrays or tensors on ``device``, integers as int64."""
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def grads_of(loss: torch.Tensor, params: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """``{name: d loss / d param}``; a parameter the loss does not reach
    (BERT's segment table on a batch without segments) gets zeros, as
    JAX's gradient gives it."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}


class TrainStep:
    """``step(batch) -> {"loss"}``: forward in training mode (which also
    updates the model's BatchNorm buffers), ``loss_fn(out, batch)``,
    gradients of every parameter, one optimizer update applied in place.
    Batches are dicts of arrays or tensors; they move to the model's
    device (:func:`batch_to_device`)."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_fn: Callable):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.params = dict(model.named_parameters())
        self.opt_state = optimizer.init(self.params)
        self.device = next(model.parameters()).device

    def loss_and_grads(self, batch: dict):
        """-> (fp32 loss, ``{name: gradient}``) of the training forward,
        without an optimizer update (the forward still updates the
        BatchNorm buffers, as the step does)."""
        batch = batch_to_device(batch, self.device)
        self.model.train()
        loss = self.loss_fn(self.model(batch), batch).float()
        return loss.detach(), grads_of(loss, self.params)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer update from ``grads``, applied in place."""
        updates, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params)
        apply_updates_(self.params, updates)

    def __call__(self, batch: dict) -> Dict[str, torch.Tensor]:
        loss, grads = self.loss_and_grads(batch)
        self.apply_gradients(grads)
        return {"loss": loss}

    def opt_state_bytes(self) -> int:
        """Bytes of the optimizer state this process holds."""
        return sum(t.numel() * t.element_size()
                   for _, t in state_leaves(self.opt_state)
                   if torch.is_tensor(t))


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    loss_fn: Callable) -> TrainStep:
    """Build the train step: ``step(batch) -> {"loss"}``; see
    :class:`TrainStep`."""
    return TrainStep(model, optimizer, loss_fn)


# Trainer options of the JAX package not ported, with the value that
# means "off": custom batch sharding and save functions (a sharded
# step_fn, ZeRO-1's or gspmd's, splits its batch and picks the per-shard
# format itself).
_NOT_PORTED = {"shard_fn": None, "save_fn": None, "save_wait": None}


def prng_key(seed: int) -> np.ndarray:
    """The layout of JAX's ``PRNGKey(seed)``: ``uint32 [0, seed]`` (a
    seed below 2**32)."""
    return np.asarray([0, seed], np.uint32)


def dropout_seed(rng, step: int, rank: int = 0) -> int:
    """The seed of a step's dropout masks, from the run's key, the step
    and the data-parallel rank (JAX folds ``axis_index`` into the key):
    a resumed run draws the masks an unbroken one would, and each rank
    its own. Rank 0 draws the single-device masks."""
    h = hashlib.sha256(np.asarray(rng, np.uint32).tobytes()
                       + int(step).to_bytes(8, "little")
                       + (int(rank).to_bytes(8, "little") if rank else b""))
    return int.from_bytes(h.digest()[:8], "little") & (2 ** 63 - 1)


class Trainer:
    """Host-side loop: pulls batches, runs steps, and every ``log_every``
    steps reads the loss (the device barrier of the window) and logs
    ``steps_per_sec``, ``examples_per_sec(_per_chip)`` and
    ``tokens_per_sec(_per_chip)`` through ``metric_logger(step,
    metrics)``; ``examples_per_step`` (the global batch: images for the
    image configs) and ``tokens_per_step`` scale the step rate, and per
    chip divides by the step's world size (one device a process). Each
    window closes with :class:`~nezha_tpu_torch.obs.metrics.StepTimer`'s
    ``lap``, whose barrier is the host read of the loss; a checkpoint's
    save is left out of its window. While a telemetry run is active
    (``obs.start_run``) the window also adds its steps to the
    ``train.steps`` counter and goes to ``obs.record_metrics``; the
    first step, each save and each rejoin are the ``train.first_step``,
    ``checkpoint.save`` and ``train.rejoin`` spans.

    ``step_fn`` replaces the single-device step: a
    :class:`~nezha_tpu_torch.parallel.data_parallel.DPTrainStep`,
    :class:`~nezha_tpu_torch.parallel.zero1.Zero1TrainStep` or
    :class:`~nezha_tpu_torch.parallel.gspmd.GSPMDTrainStep` built on the
    same model and optimizer, or a step that owns its state (the graph
    engine's :class:`~nezha_tpu_torch.graph.step.GraphTrainStep`), whose
    ``state_leaves``/``state_template``/``load_state_leaves`` are then
    the dense checkpoint's leaves (no ``rng`` leaf). With
    ``checkpoint_dir``, :meth:`initialize` resumes from the newest
    checkpoint there that verifies, and every ``checkpoint_every`` steps
    (of the global step count) :meth:`save` writes one in the JAX
    package's format, keeping the newest ``checkpoint_keep`` (None: all):
    a dense npz, written by rank 0 alone, or for a sharded step (ZeRO-1,
    gspmd) the per-shard layout, each rank its own shards, on a
    background thread (:meth:`wait_saves` commits): the step gives the
    leaves (``shard_leaves``), names what a restore reads
    (``restore_request``) and installs it (``load_restored``).
    ``rng`` is the run's JAX PRNG key (``uint32[2]``, :func:`prng_key` of
    0 when None), saved as the ``rng`` leaf and replaced by a restored
    one. The port cannot split JAX keys: it keeps the key it has and
    draws each step's dropout masks from (key, step, rank)
    (:func:`dropout_seed`), so a run resumed from the other package
    draws other masks than that package would.

    ``process_group`` (a coordinator :class:`~nezha_tpu_torch.dist.
    ProcessGroup`) is polled every ``failure_check_every`` steps for dead
    peers; on one the trainer saves (with ``checkpoint_dir``), then calls
    ``on_failure(failed)`` or raises RuntimeError naming the ranks
    (``failure_mode="stop"``). With ``failure_mode="rejoin"`` (which needs
    ``checkpoint_dir`` and excludes ``on_failure``) it saves, then waits
    up to ``rejoin_timeout_s`` for the coordinator to report no dead rank
    (a replacement's join clears the mark), reloads the rescue
    checkpoint through :meth:`initialize` (or calls ``recover_fn``) and
    trains on. ``tracer`` (an :class:`~nezha_tpu_torch.obs.trace.Tracer`)
    is told the global step after every step (``maybe_trace``). Custom
    sharding or save functions raise :class:`NotPortedError`."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, rng=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, log_every: int = 10,
                 metric_logger: Optional[Callable[[int, dict], None]] = None,
                 checkpoint_keep: Optional[int] = None,
                 examples_per_step: int = 0, tokens_per_step: int = 0,
                 step_fn: Optional[TrainStep] = None, process_group=None,
                 failure_check_every: int = 0,
                 on_failure: Optional[Callable[[list], None]] = None,
                 failure_mode: str = "stop", rejoin_timeout_s: float = 300.0,
                 recover_fn: Optional[Callable[[], None]] = None,
                 tracer=None, **options):
        for name, value in options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Trainer got an unexpected option {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotPortedError(f"Trainer option {name} is not ported "
                                     f"(ROADMAP A7: custom sharding and "
                                     f"save functions)")
        if failure_mode not in ("stop", "rejoin"):
            raise ValueError(f"failure_mode must be stop|rejoin, got "
                             f"{failure_mode!r}")
        if failure_mode == "rejoin":
            if not checkpoint_dir:
                raise ValueError("failure_mode='rejoin' needs a "
                                 "checkpoint_dir: recovery reloads the "
                                 "rescue checkpoint")
            if on_failure is not None:
                raise ValueError("failure_mode='rejoin' and on_failure are "
                                 "mutually exclusive (rejoin continues "
                                 "in-process; the callback would never "
                                 "fire)")
        self.failure_mode = failure_mode
        self.rejoin_timeout_s = rejoin_timeout_s
        self.recover_fn = recover_fn
        self.model = model
        self.step_fn = step_fn if step_fn is not None else make_train_step(
            model, optimizer, loss_fn)
        self.rank = getattr(self.step_fn, "rank", 0)
        self.world = getattr(self.step_fn, "world", 1)
        self.sharded = getattr(self.step_fn, "sharded", False)
        self.rng = prng_key(0) if rng is None else np.asarray(rng, np.uint32)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.checkpoint_keep = checkpoint_keep
        self.log_every = log_every
        self.metric_logger = metric_logger
        self.examples_per_step = examples_per_step
        # Tokens per step, as the JAX loop counts them: the size of the
        # batch's "tokens" array times the world when not given.
        self.tokens_per_step = tokens_per_step
        self.process_group = process_group
        self.failure_check_every = failure_check_every
        self.on_failure = on_failure
        self.tracer = tracer
        self.global_step = 0
        # Rate windows close on the loop's own log edges (a resume can
        # land inside a window), so the timer runs explicit laps.
        self._timer = StepTimer(window=max(log_every, 1))
        self._first_step = True   # the next step builds the kernels
        self._dropout_gens = list({id(m.generator): m.generator
                                   for m in model.modules()
                                   if isinstance(m, Dropout) and m.rate
                                   and m.generator is not None}.values())
        self._async = None
        # {"step", "seconds", "bytes"} of each save this process wrote
        # (sharded: "seconds" blocked the loop; "write_seconds" after
        # wait_saves), and of the restore.
        self.saves: list = []
        self.last_restore = None
        # Each heal: {"step", "failed", "detect_step", "detected_at" (the
        # wall clock when the dead peer was seen), "wait_s", "reload_s"}
        # (the seconds waited for the replacement and those of the
        # reload).
        self.rejoins: list = []

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The flat JAX-keyed train state (host copies) of a dense step; a
        step that owns its state (the graph engine's) names its own
        leaves (``state_leaves``)."""
        if hasattr(self.step_fn, "state_leaves"):
            return self.step_fn.state_leaves()
        from nezha_tpu_torch.models.convert import train_state_to_jax
        return train_state_to_jax(self.model, self.step_fn.opt_state,
                                  self.rng)

    def load_state_dict(self, flat: Dict[str, np.ndarray]) -> None:
        """Load a flat JAX-keyed train state: weights, BatchNorm
        statistics, optimizer state and key (a step that owns its state:
        ``load_state_leaves``)."""
        if hasattr(self.step_fn, "load_state_leaves"):
            self.step_fn.load_state_leaves(flat)
            return
        from nezha_tpu_torch.models.convert import load_train_state
        self.step_fn.opt_state = load_train_state(
            flat, self.model, self.step_fn.opt_state)
        self.rng = np.asarray(flat["rng"], np.uint32)

    def initialize(self, resume: bool = True) -> int:
        """Resume from ``checkpoint_dir``'s newest intact checkpoint, if
        any; -> the step the run stands at."""
        if resume and self.checkpoint_dir:
            t0 = time.perf_counter()
            got = (self._restore_sharded() if self.sharded
                   else self._restore_dense())
            if got is not None:
                step, nbytes = got
                self.global_step = step
                if self.step_fn.device.type == "cuda":
                    torch.cuda.synchronize(self.step_fn.device)
                self.last_restore = {"step": step,
                                     "seconds": time.perf_counter() - t0,
                                     "bytes": nbytes}
        return self.global_step

    def _restore_dense(self):
        from nezha_tpu_torch.models.convert import train_state_template
        from nezha_tpu_torch.train import checkpoint as ckpt
        template = (self.step_fn.state_template()
                    if hasattr(self.step_fn, "state_template")
                    else train_state_template(self.model,
                                              self.step_fn.opt_state))
        flat, step = ckpt.try_restore(self.checkpoint_dir, template)
        if flat is None:
            return None
        self.load_state_dict(flat)
        return step, os.path.getsize(ckpt.checkpoint_path(
            self.checkpoint_dir, step))

    def _restore_sharded(self):
        from nezha_tpu_torch.train import sharded_checkpoint as sck
        got, step = sck.try_restore_sharded(self.checkpoint_dir,
                                            self.step_fn.restore_request())
        if got is None:
            return None
        self.step_fn.load_restored({k: a for k, (a, _) in got.items()})
        self.rng = np.asarray(got["rng"][0], np.uint32)
        return step, sum(a.nbytes for a, _ in got.values())

    def save(self, step: Optional[int] = None) -> Optional[str]:
        """Write a checkpoint of the current state at ``step`` (default:
        the global step) into ``checkpoint_dir``; -> its path, or None on
        a rank that writes nothing (dense saves are rank 0's)."""
        step = self.global_step if step is None else step
        with obs.span("checkpoint.save", step=step):
            return self._save(step)

    def _save(self, step: int) -> Optional[str]:
        from nezha_tpu_torch.train import checkpoint as ckpt
        from nezha_tpu_torch.train import sharded_checkpoint as sck
        t0 = time.perf_counter()
        if self.sharded:
            if self._async is None:
                self._async = sck.AsyncCheckpointer()
            self.wait_saves()   # one save in flight
            leaves = self.step_fn.shard_leaves(self.rng)
            self._async.save(self.checkpoint_dir, leaves, step,
                             keep_last=self.checkpoint_keep,
                             proc=self.rank, world=self.world)
            self.saves.append({
                "step": step, "seconds": time.perf_counter() - t0,
                "bytes": sum(a.nbytes for leaf in leaves.values()
                             for _, a in leaf.shards)})
            return str(sck.step_dir(self.checkpoint_dir, step))
        if self.rank != 0:
            return None
        path = ckpt.save_checkpoint(self.checkpoint_dir, self.state_dict(),
                                    step, keep_last=self.checkpoint_keep)
        self.saves.append({"step": step,
                           "seconds": time.perf_counter() - t0,
                           "bytes": os.path.getsize(path)})
        return path

    def wait_saves(self) -> None:
        """Commit a sharded save still being written (raising its error),
        and record its write time."""
        if self._async is not None:
            pending = self._async.pending
            self._async.wait()
            if pending and self.saves:
                self.saves[-1]["write_seconds"] = \
                    self._async.last_write_seconds

    def _check_peers(self) -> bool:
        """Poll for dead peers; -> True when the world was healed (the
        rescue checkpoint reloaded), False when every peer is alive."""
        failed = self.process_group.failed_ranks()
        if not failed:
            return False
        detected_at = time.time()
        if self.checkpoint_dir:   # keep the progress first
            self.save(self.global_step)
            self.wait_saves()
        if self.failure_mode == "rejoin":   # checkpoint_dir guaranteed
            with obs.span("train.rejoin", failed=failed):
                self._rejoin_and_reload(failed, detected_at)
            return True
        if self.on_failure is not None:
            self.on_failure(failed)
        else:
            raise RuntimeError(f"peer rank(s) {failed} failed at step "
                               f"{self.global_step}")
        return False

    def _rejoin_and_reload(self, failed: list, detected_at: float) -> None:
        """The survivor's half of elastic recovery, after the rescue save
        has committed: poll every 0.2 s until the coordinator reports no
        dead rank (a replacement's join clears the mark), then reload the
        rescue checkpoint, so survivor and replacement go on from one step
        with the same state. Raises RuntimeError when no replacement joins
        within ``rejoin_timeout_s``."""
        step = self.global_step
        print(f"peer rank(s) {failed} failed at step {step}; checkpoint "
              f"committed; waiting for rejoin (timeout "
              f"{self.rejoin_timeout_s:.0f}s)", file=sys.stderr, flush=True)
        t0 = time.monotonic()
        deadline = t0 + self.rejoin_timeout_s
        while True:
            still = self.process_group.failed_ranks()
            if not still:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"peer rank(s) {still} failed at step {step}; no "
                    f"replacement rejoined within "
                    f"{self.rejoin_timeout_s:.0f}s")
            time.sleep(0.2)
        t1 = time.monotonic()
        if self.recover_fn is not None:
            self.recover_fn()
        else:
            self.initialize(resume=True)
        self.rejoins.append({"step": self.global_step, "failed": failed,
                             "detect_step": step, "detected_at": detected_at,
                             "wait_s": t1 - t0,
                             "reload_s": time.monotonic() - t1})
        print(f"world healed; resumed from step {self.global_step}",
              file=sys.stderr, flush=True)

    def fit(self, batches: Iterator[dict], steps: int) -> Dict[str, float]:
        last: Dict[str, float] = {}
        metrics: Dict[str, torch.Tensor] = {}
        n_chips = self.world
        self._timer.start()
        window_steps = 0   # the steps of this window (a resume can land
        # inside one, so log_every would overstate the first rate)
        for _ in range(steps):
            batch = next(batches)
            if not self.tokens_per_step and "tokens" in batch:
                tokens = batch["tokens"]
                self.tokens_per_step = self.world * int(
                    tokens.numel() if torch.is_tensor(tokens)
                    else np.size(tokens))
            for i, gen in enumerate(self._dropout_gens):
                gen.manual_seed(dropout_seed(self.rng, self.global_step,
                                             self.rank) + i)
            if self._first_step:
                # The first step builds and loads the kernels it
                # launches: as a span it is the run's start-up record.
                self._first_step = False
                with obs.span("train.first_step",
                              step=self.global_step + 1):
                    metrics = self.step_fn(batch)
            else:
                metrics = self.step_fn(batch)
            self.global_step += 1
            window_steps += 1
            if self.tracer is not None:
                self.tracer.maybe_trace(self.global_step)
            if (self.failure_check_every and self.process_group is not None
                    and self.global_step % self.failure_check_every == 0
                    and self._check_peers()):
                # Rate windows do not count the heal wait.
                self._timer.start()
                window_steps = 0
                continue
            if self.log_every and self.global_step % self.log_every == 0:
                # The float() reads are the window's barrier: every step
                # launched has finished before the lap closes.
                last = {k: float(v) for k, v in metrics.items()}
                rate = self._timer.lap(last.get("loss", 0.0), window_steps)
                last["steps_per_sec"] = rate if rate is not None else 0.0
                if self.examples_per_step:
                    eps = last["steps_per_sec"] * self.examples_per_step
                    last["examples_per_sec"] = eps
                    last["examples_per_sec_per_chip"] = eps / n_chips
                if self.tokens_per_step:
                    tps = last["steps_per_sec"] * self.tokens_per_step
                    last["tokens_per_sec"] = tps
                    last["tokens_per_sec_per_chip"] = tps / n_chips
                last["step"] = self.global_step
                obs.counter("train.steps").inc(window_steps)
                obs.record_metrics(self.global_step, last)
                window_steps = 0
                if self.metric_logger:
                    self.metric_logger(self.global_step, last)
            if (self.checkpoint_every and self.checkpoint_dir
                    and self.global_step % self.checkpoint_every == 0):
                n = len(self.saves)
                self.save()
                # The save's host copy and write are not the steps' time.
                if len(self.saves) > n:
                    self._timer.exclude(self.saves[-1]["seconds"])
        if not last and steps:
            last = {k: float(v) for k, v in metrics.items()}
            last["step"] = self.global_step
        return last
