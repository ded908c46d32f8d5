"""The fault-point call-site API — the obs-registry shape applied to
failure: production code registers NAMED points, a process-wide plan
decides what (if anything) happens there, and with no plan installed
every site is a branch-only no-op (one attribute load + None check —
cheap enough for the serving hot path, same contract as
``obs.counter().inc()`` while telemetry is disabled).

Two site kinds:

- a control-flow site calls the point function with a name and may get a
  typed :class:`~nezha_tpu_torch.faults.plan.InjectedFault` raised or a delay
  slept at it;
- a data site calls the corrupt function with a name and a float tensor
  and gets back either the same tensor (no rule fired) or a copy with a
  seeded-chosen row (or the whole tensor) poisoned to nan/inf/zero —
  how the NaN-logit-burst failure mode is manufactured on demand.

Every injection counts into the ``faults.injected_total`` obs counter
(schema-pinned for serving runs), so a chaos run's artifact records how
much chaos it actually received.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from nezha_tpu_torch import obs
from nezha_tpu_torch.faults.plan import (CORRUPT_ACTIONS, FaultPlan, FaultRule,
                                   InjectedFault)

ENV_PLAN = "NEZHA_FAULT_PLAN"
ENV_SEED = "NEZHA_FAULT_SEED"


class _State:
    __slots__ = ("plan",)

    def __init__(self):
        self.plan: Optional[FaultPlan] = None


_state = _State()


# ------------------------------------------------------------- lifecycle
def enabled() -> bool:
    return _state.plan is not None


def active() -> Optional[FaultPlan]:
    return _state.plan


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Make ``plan`` the process-wide plan (None = disable). Returns it."""
    _state.plan = plan
    return plan


def clear() -> None:
    _state.plan = None


def install_from_env(env=None) -> Optional[FaultPlan]:
    """Install a plan from ``NEZHA_FAULT_PLAN`` (seed:
    ``NEZHA_FAULT_SEED``, default 0). With the variable unset or empty
    the current plan is left untouched and None is returned — callers
    (the CLIs) can't accidentally clear a programmatic plan."""
    env = os.environ if env is None else env
    spec = env.get(ENV_PLAN)
    if not spec:
        return None
    return install(FaultPlan.parse(spec, seed=int(env.get(ENV_SEED, "0"))))


# ------------------------------------------------------------ call sites
def point(name: str) -> None:
    """A control-flow fault point. No-op without a plan; with one, an
    ``error`` rule raises :class:`InjectedFault` here and a ``delay``
    rule sleeps (corruption rules are ignored — there is no tensor)."""
    plan = _state.plan
    if plan is None:
        return
    rule = plan.hit(name)
    if rule is not None and rule.action not in CORRUPT_ACTIONS:
        _execute(name, rule, plan)


def corrupt(name: str, x, rows: Union[None, Sequence[int],
                                      Callable[[], Sequence[int]]] = None):
    """A data fault point: returns ``x`` untouched unless a rule fires.

    Corruption rules (``nan``/``inf``/``zero``) poison a COPY of ``x`` —
    one seeded-chosen row from ``rows`` when given (``rows`` may be a
    callable, evaluated only on injection, so hot paths don't pay for
    the candidate list), else the whole tensor. ``error``/``delay``
    rules behave as at :func:`point`. ``x`` is a torch tensor (poisoned
    on its own device, never copied to the host) or a numpy array.
    """
    plan = _state.plan
    if plan is None:
        return x
    rule = plan.hit(name)
    if rule is None:
        return x
    if rule.action not in CORRUPT_ACTIONS:
        _execute(name, rule, plan)
        return x
    if callable(rows):
        rows = rows()
    if rows is not None:
        rows = list(rows)
        if not rows:          # nothing eligible (e.g. no active slots)
            return x
    plan.record_injection(name)
    obs.counter("faults.injected_total").inc()
    poison = {"nan": math.nan, "inf": math.inf, "zero": 0.0}[rule.action]
    if isinstance(x, np.ndarray):
        arr = np.array(x, copy=True)
        if rows is None:
            arr[...] = poison
        else:
            arr[rows[plan.choose(len(rows))]] = poison
        return arr
    # A torch tensor: the poisoned copy is made on the tensor's own
    # device (no host round trip), the victim row by index_fill_.
    if rows is None:
        return torch.full_like(x, poison)
    row = rows[plan.choose(len(rows))]
    idx = torch.tensor([row], device=x.device, dtype=torch.long)
    return x.clone().index_fill_(0, idx, poison)


def _execute(name: str, rule: FaultRule, plan: FaultPlan) -> None:
    plan.record_injection(name)
    obs.counter("faults.injected_total").inc()
    if rule.action == "delay":
        time.sleep(rule.delay_s)
        return
    raise InjectedFault(
        f"injected fault at point {name!r} "
        f"(hit {plan.hit_counts.get(name, 0)}, rule {rule.action!r})")
