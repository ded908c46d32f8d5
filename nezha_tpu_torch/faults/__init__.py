"""Deterministic fault injection — the failure-mode mirror of
``nezha_tpu_torch.obs``.

The obs registry made every subsystem permanently *observable* at
near-zero disabled cost; this package makes the same subsystems
permanently *breakable* on demand: named fault points stay in the
production code (serving admission, prefill, decode, the KV wire, the
replica fleet; the names and sites match the JAX package's, point for
point), and a seeded
:class:`FaultPlan` — built in code or parsed from ``NEZHA_FAULT_PLAN`` —
decides which hits raise a typed :class:`InjectedFault`, sleep a delay,
or poison a tensor with nan/inf/zero. With no plan installed every site
is a branch-only no-op.

This is what lets the resilience claims be tested instead of asserted:
seeded failure schedules drive the serving loop and the fleet and show
isolation (an error retires one request, never the batch), recovery
(step retry, replica restart) and zero slot leaks.
"""

from nezha_tpu_torch.faults.injector import (
    ENV_PLAN,
    ENV_SEED,
    active,
    clear,
    corrupt,
    enabled,
    install,
    install_from_env,
    point,
)
from nezha_tpu_torch.faults.plan import (
    ACTIONS,
    CORRUPT_ACTIONS,
    FaultPlan,
    FaultRule,
    InjectedFault,
    parse_rule,
)

__all__ = [
    "FaultPlan", "FaultRule", "InjectedFault", "parse_rule",
    "ACTIONS", "CORRUPT_ACTIONS", "ENV_PLAN", "ENV_SEED",
    "point", "corrupt", "install", "install_from_env", "clear",
    "active", "enabled",
]
