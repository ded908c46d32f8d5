"""Fault plans: what to inject, where, and when.

A :class:`FaultPlan` is a seeded, deterministic schedule of failures over
named fault points (the ``serve.prefill`` / ``checkpoint.save`` call
sites registered across the tree — the fault-point checker pins the
registry). Plans come from code (tests build them directly) or from the
environment (``NEZHA_FAULT_PLAN`` — the operator's chaos knob, parsed by
:meth:`FaultPlan.parse`). The compact rule grammar::

    plan  := rule [ ";" rule ]...
    rule  := point ":" action [ "@" N ] [ "x" M | "x*" ] [ "%" P ]
    action := "error" | "delay=SECONDS" | "nan" | "inf" | "zero"

``@N`` arms the rule on the Nth hit of the point (1-based, default 1);
``xM`` keeps it firing for M consecutive hits (default 1, ``x*`` =
every hit from N on); ``%P`` instead fires each hit independently with
probability P drawn from the plan's seeded RNG (exclusive with ``@``/
``x`` — the probabilistic form a load generator's fault rate uses).
``error``/``delay`` apply at any point; the corruption actions
(``nan``/``inf``/``zero``) only take effect at ``faults.corrupt(...)``
sites, which pass the tensor to poison.

Hit counting and the RNG live behind one lock, so concurrently-driven
points (HTTP handler threads over one scheduler) see a consistent
schedule. Determinism contract: same plan string + same seed + same
sequence of point hits = same injections.
"""

from __future__ import annotations

import dataclasses
import math
import random
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple


class InjectedFault(RuntimeError):
    """The typed error a fault plan raises at an ``error`` rule — distinct
    from every organic exception so tests (and operators reading logs)
    can tell injected failures from real ones."""


ACTIONS = ("error", "delay", "nan", "inf", "zero")
CORRUPT_ACTIONS = ("nan", "inf", "zero")

_RULE_RE = re.compile(
    r"^(?P<point>[A-Za-z0-9_]+(?:\.[A-Za-z0-9_]+)*)"
    r":(?P<action>[a-z]+)"
    r"(?:=(?P<arg>[0-9.eE+-]+))?"
    r"(?:@(?P<at>\d+))?"
    r"(?:x(?P<times>\d+|\*))?"
    r"(?:%(?P<p>[0-9.eE+-]+))?$")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule. ``at``/``times`` select hits positionally
    (fire on hits ``[at, at + times)``); ``p`` selects probabilistically
    instead (per-hit coin flip from the plan's seeded RNG)."""

    point: str
    action: str
    at: int = 1
    times: float = 1          # math.inf = every hit from `at` on
    p: Optional[float] = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"fault action must be one of {ACTIONS}, got "
                f"{self.action!r}")
        if self.action == "delay" and not self.delay_s > 0:
            raise ValueError("delay rules need delay=SECONDS > 0")
        if self.at < 1:
            raise ValueError(f"@N must be >= 1 (1-based hits), got {self.at}")
        if self.times < 1:
            raise ValueError(f"xM must be >= 1, got {self.times}")
        if self.p is not None:
            if not 0.0 < self.p <= 1.0:
                raise ValueError(f"%P must be in (0, 1], got {self.p}")
            if self.at != 1 or self.times != 1:
                raise ValueError(
                    "%P (probabilistic) is exclusive with @N/xM "
                    "(positional) — pick one firing mode per rule")


def parse_rule(token: str) -> FaultRule:
    """One ``point:action[@N][xM][%P]`` token -> :class:`FaultRule`."""
    m = _RULE_RE.match(token.strip())
    if m is None:
        raise ValueError(
            f"bad fault rule {token!r}: expected "
            f"point:action[=arg][@N][xM|x*][%P] with action one of "
            f"{ACTIONS}")
    action, arg = m.group("action"), m.group("arg")
    if arg is not None and action != "delay":
        raise ValueError(
            f"bad fault rule {token!r}: only delay takes =SECONDS")
    times: float = 1
    if m.group("times") is not None:
        times = math.inf if m.group("times") == "*" \
            else int(m.group("times"))
    return FaultRule(
        point=m.group("point"), action=action,
        at=int(m.group("at")) if m.group("at") else 1,
        times=times,
        p=float(m.group("p")) if m.group("p") else None,
        delay_s=float(arg) if arg else 0.0)


class FaultPlan:
    """A set of rules + seeded RNG + per-point hit accounting.

    ``hit(point)`` is the injector's single entry: it counts the hit and
    returns the first rule that fires on it (or None). ``injected_counts``
    / ``hit_counts`` expose what actually happened — benchmarks record
    them alongside the latency percentiles.
    """

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules: Tuple[FaultRule, ...] = tuple(rules)
        self.seed = seed
        self._by_point: Dict[str, List[FaultRule]] = {}
        for r in self.rules:
            self._by_point.setdefault(r.point, []).append(r)
        self._rng = random.Random(seed)
        self._hits: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``;``-separated rule grammar (module docstring)."""
        rules = [parse_rule(tok) for tok in spec.split(";") if tok.strip()]
        if not rules:
            raise ValueError(f"fault plan {spec!r} contains no rules")
        return cls(rules, seed=seed)

    # ------------------------------------------------------------ firing
    def hit(self, point: str) -> Optional[FaultRule]:
        """Count one hit of ``point``; -> the rule that fires on it, if
        any (first match wins; positional windows and coin flips are
        evaluated under the plan lock). Firing is only SELECTION — the
        injector calls :meth:`record_injection` once it actually does
        something, so ``injected_counts`` never claims chaos that a
        call site discarded (e.g. a corruption rule at a control-flow
        point, or a corrupt site with no eligible rows)."""
        with self._lock:
            n = self._hits[point] = self._hits.get(point, 0) + 1
            for rule in self._by_point.get(point, ()):
                if rule.p is not None:
                    fired = self._rng.random() < rule.p
                else:
                    fired = rule.at <= n < rule.at + rule.times
                if fired:
                    return rule
        return None

    def record_injection(self, point: str) -> None:
        """Account one injection that actually HAPPENED at ``point``
        (raise/delay executed, tensor poisoned)."""
        with self._lock:
            self._injected[point] = self._injected.get(point, 0) + 1

    def choose(self, n: int) -> int:
        """Seeded pick in ``[0, n)`` — corruption sites use it to select
        the victim row, so "which request gets the NaN burst" is part of
        the deterministic schedule."""
        with self._lock:
            return self._rng.randrange(n)

    # --------------------------------------------------------- accounting
    @property
    def hit_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hits)

    @property
    def injected_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._injected)

    @property
    def num_injected(self) -> int:
        with self._lock:
            return sum(self._injected.values())

    def __repr__(self) -> str:
        return (f"FaultPlan(rules={len(self.rules)}, seed={self.seed}, "
                f"injected={self.num_injected})")
