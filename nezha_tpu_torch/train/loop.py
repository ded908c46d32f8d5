"""The training step and the host-side loop (counterpart of
``nezha_tpu/train/loop.py``).

JAX compiles forward, backward and update into one program over an
immutable state. PyTorch runs them eagerly: the step holds the model's
parameters (updated in place) and the optimizer state, so ``step(batch)``
takes only the batch.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.optim.optimizers import Optimizer, apply_updates_


class TrainStep:
    """``step(batch) -> {"loss"}``: forward in training mode, ``loss_fn(
    out, batch)``, gradients of every parameter, one optimizer update
    applied in place. Batches are dicts of arrays or tensors; they move
    to the model's device, integer arrays as int64."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_fn: Callable):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.params = dict(model.named_parameters())
        self.opt_state = optimizer.init(self.params)
        self.device = next(model.parameters()).device

    def to_device(self, batch: dict) -> dict:
        out = {}
        for k, x in batch.items():
            t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                else x)
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(self.device)
        return out

    def loss_and_grads(self, batch: dict):
        """-> (fp32 loss, ``{name: gradient}``), without an update."""
        batch = self.to_device(batch)
        self.model.train()
        loss = self.loss_fn(self.model(batch), batch).float()
        grads = torch.autograd.grad(loss, list(self.params.values()))
        return loss.detach(), dict(zip(self.params, grads))

    def __call__(self, batch: dict) -> Dict[str, torch.Tensor]:
        loss, grads = self.loss_and_grads(batch)
        updates, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params)
        apply_updates_(self.params, updates)
        return {"loss": loss}


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    loss_fn: Callable) -> TrainStep:
    """Build the train step: ``step(batch) -> {"loss"}``; see
    :class:`TrainStep`."""
    return TrainStep(model, optimizer, loss_fn)


# Trainer options of the JAX package not ported yet, with the value that
# means "off" (checkpointing, failure detection and rejoin, profiling,
# custom step / sharding / save functions).
_NOT_PORTED = {"checkpoint_dir": None, "checkpoint_every": 0,
               "tracer": None, "process_group": None,
               "failure_check_every": 0, "on_failure": None,
               "failure_mode": "stop", "rejoin_timeout_s": 300.0,
               "recover_fn": None, "step_fn": None, "shard_fn": None,
               "save_fn": None, "save_wait": None, "checkpoint_keep": None}


class Trainer:
    """Host-side loop: pulls batches, runs steps, and every ``log_every``
    steps reads the loss (the device barrier of the window) and logs
    ``steps_per_sec``, ``examples_per_sec(_per_chip)`` and
    ``tokens_per_sec(_per_chip)`` through ``metric_logger(step,
    metrics)``. The port trains on one device, so per chip is per run.
    The JAX Trainer's checkpoint, failure, profiling and custom-step
    options raise :class:`NotPortedError` when set."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, log_every: int = 10,
                 metric_logger: Optional[Callable[[int, dict], None]] = None,
                 examples_per_step: int = 0, tokens_per_step: int = 0,
                 **options):
        for name, value in options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Trainer got an unexpected option {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotPortedError(f"Trainer option {name} is not ported "
                                     f"(ROADMAP A4/A6)")
        self.model = model
        self.step_fn = make_train_step(model, optimizer, loss_fn)
        self.log_every = log_every
        self.metric_logger = metric_logger
        self.examples_per_step = examples_per_step
        # Tokens per step, as the JAX loop counts them: the size of the
        # batch's "tokens" array when not given.
        self.tokens_per_step = tokens_per_step
        self.global_step = 0

    def fit(self, batches: Iterator[dict], steps: int) -> Dict[str, float]:
        last: Dict[str, float] = {}
        metrics: Dict[str, torch.Tensor] = {}
        n_chips = 1
        window_start = time.perf_counter()
        window_steps = 0
        for _ in range(steps):
            batch = next(batches)
            if not self.tokens_per_step and "tokens" in batch:
                self.tokens_per_step = int(np.size(batch["tokens"]))
            metrics = self.step_fn(batch)
            self.global_step += 1
            window_steps += 1
            if self.log_every and self.global_step % self.log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                rate = window_steps / (now - window_start)
                window_start, window_steps = now, 0
                last["steps_per_sec"] = rate
                if self.examples_per_step:
                    eps = rate * self.examples_per_step
                    last["examples_per_sec"] = eps
                    last["examples_per_sec_per_chip"] = eps / n_chips
                if self.tokens_per_step:
                    tps = rate * self.tokens_per_step
                    last["tokens_per_sec"] = tps
                    last["tokens_per_sec_per_chip"] = tps / n_chips
                last["step"] = self.global_step
                if self.metric_logger:
                    self.metric_logger(self.global_step, last)
        if not last and steps:
            last = {k: float(v) for k, v in metrics.items()}
            last["step"] = self.global_step
        return last
