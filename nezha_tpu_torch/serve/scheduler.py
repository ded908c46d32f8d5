"""Admission, retirement and the serving loop (counterpart of
``nezha_tpu/serve/scheduler.py``, FIFO admission only).

One iteration: admit queued requests into free slots (while the pool's
free-plus-reclaimable blocks cover the head request's prefill) -> decode
one block for every live row -> retire rows on EOS, max-new-tokens or
deadline -> admit again, so a slot freed by retirement is refilled in the
same iteration. ``submit`` fails fast with :class:`QueueFull` past the
queue's capacity and with ``ValueError`` for a request that can never be
served. Failures are request-scoped: a prefill error or non-finite
logits retire only that request (``FinishReason.ERROR``); KV block
exhaustion during decode retires the row that could not grow and the
block is re-dispatched for the rest.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from nezha_tpu_torch.serve.engine import Engine
from nezha_tpu_torch.serve.slots import KVBlocksExhausted


class QueueFull(Exception):
    """Admission queue at capacity — the backpressure signal."""


class FinishReason:
    EOS = "eos"
    LENGTH = "length"          # max_new_tokens reached
    DEADLINE = "deadline"      # expired, queued or mid-decode
    ERROR = "error"            # prefill failure, non-finite logits, or no
                               # KV blocks — only this request is retired


@dataclasses.dataclass
class Request:
    """One generation request; ``deadline_s`` is a wall-clock budget in
    seconds from submit."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    seed: int = 0
    deadline_s: Optional[float] = None
    request_id: Optional[str] = None


@dataclasses.dataclass
class RequestResult:
    request_id: str
    tokens: List[int]
    finish_reason: str
    ttft_s: Optional[float]    # None when it ended before a first token
    latency_s: float
    error: Optional[str] = None


@dataclasses.dataclass
class _Live:
    req: Request
    request_id: str
    submit_t: float
    deadline_t: Optional[float]
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None


class Scheduler:
    """Bounded-FIFO continuous batching over an :class:`Engine`.

    ``on_token(request_id, token)`` streams each token and
    ``on_finish(result)`` fires at retirement, both on the thread driving
    :meth:`step`. ``submit`` is thread-safe."""

    step_retry_backoff_s = 0.05

    def __init__(self, engine: Engine,
                 on_token: Optional[Callable[[str, int], None]] = None,
                 on_finish: Optional[Callable[[RequestResult], None]] = None):
        self.engine = engine
        self.on_token = on_token
        self.on_finish = on_finish
        self.queue_capacity = engine.cfg.queue_capacity
        self._queue: Deque[_Live] = collections.deque()
        self._live: Dict[int, _Live] = {}          # slot -> request state
        self._lock = threading.RLock()
        self._ids = itertools.count()
        self.results: Dict[str, RequestResult] = {}

    # ------------------------------------------------------- admission
    def submit(self, req: Request) -> str:
        """Enqueue; -> the request id."""
        cfg = self.engine.cfg
        n = len(req.prompt)
        if n < 1:
            raise ValueError("prompt must be non-empty")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if n + req.max_new_tokens > cfg.max_len:
            raise ValueError(
                f"prompt ({n}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds max_len {cfg.max_len}")
        pool = self.engine.pool
        need = max(self.engine.prefill_blocks_needed(n),
                   pool.blocks_for_span(n + req.max_new_tokens))
        if need > pool.max_request_blocks:
            raise ValueError(
                f"request needs {need} KV blocks (block_size "
                f"{pool.block_size}) but the pool can bind at most "
                f"{pool.max_request_blocks} per request")
        vocab = self.engine.vocab
        if not all(0 <= int(t) < vocab for t in req.prompt):
            raise ValueError(f"prompt ids must be in [0, {vocab})")
        with self._lock:
            if len(self._queue) >= self.queue_capacity:
                raise QueueFull(
                    f"admission queue at capacity {self.queue_capacity}")
            rid = req.request_id or f"req-{next(self._ids)}"
            now = time.monotonic()
            self._queue.append(_Live(
                req=req, request_id=rid, submit_t=now,
                deadline_t=None if req.deadline_s is None
                else now + req.deadline_s))
        return rid

    # ------------------------------------------------------- iteration
    def step(self) -> int:
        """One serving iteration. -> tokens decoded (0 when idle)."""
        with self._lock:
            self._expire_queued()
            self._admit()
            emitted = self._decode() if self._live else 0
            self._admit()
            return emitted

    def run_until_idle(self, max_iters: Optional[int] = None) -> int:
        """Drive :meth:`step` until queue and slots are empty. -> iters."""
        iters = 0
        while self.has_work():
            self.step()
            iters += 1
            if max_iters is not None and iters >= max_iters:
                break
        return iters

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue or self._live)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -------------------------------------------------------- internals
    def _expire_queued(self) -> None:
        now = time.monotonic()
        kept: Deque[_Live] = collections.deque()
        for live in self._queue:
            if live.deadline_t is not None and now >= live.deadline_t:
                self._finish(live, FinishReason.DEADLINE)
            else:
                kept.append(live)
        self._queue = kept

    def _admit(self) -> None:
        """Grant free slots to the queue head while its worst-case (no
        prefix hit) prefill fits the free plus reclaimable blocks; if it
        cannot fit and nothing in flight will ever free a block, retire it
        with a typed error instead of waiting forever."""
        pool = self.engine.pool
        while self._queue and pool.num_free:
            head = self._queue[0]
            need = self.engine.prefill_blocks_needed(len(head.req.prompt))
            if pool.available_blocks() < need:
                if self._live:
                    break
                self._queue.popleft()
                self._finish(head, FinishReason.ERROR,
                             error=f"kv blocks exhausted: need {need}, "
                                   f"{pool.available_blocks()} reclaimable")
                continue
            self._admit_one(self._queue.popleft())

    def _admit_one(self, live: _Live) -> None:
        pool = self.engine.pool
        slot = pool.alloc()
        req = live.req
        try:
            self.engine.prefill(
                slot, req.prompt, seed=req.seed,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, eos_id=req.eos_id,
                max_new_tokens=req.max_new_tokens)
        except Exception as e:
            # One bad request must not kill the loop with others in
            # flight: free its slot, retire it, keep admitting.
            pool.free(slot)
            self._finish(live, FinishReason.ERROR,
                         error=f"prefill failed: {type(e).__name__}: {e}")
            return
        self._live[slot] = live

    def _dispatch(self, active: np.ndarray):
        """``engine.step`` with block exhaustion as backpressure: retire
        the row that could not grow, free its blocks, re-dispatch the
        rest. None when that retired every row."""
        while True:
            try:
                return self.engine.step(active)
            except KVBlocksExhausted as e:
                slot = e.slot
                if slot is None or slot not in self._live:
                    raise
                victim = self._live.pop(slot)
                self.engine.pool.free(slot)
                active[slot] = False
                self._finish(victim, FinishReason.ERROR,
                             error=f"kv blocks exhausted: {e}")
                if not self._live:
                    return None

    def _decode(self) -> int:
        horizon = self.engine.cfg.decode_horizon
        active = np.zeros((self.engine.cfg.max_batch_size,), bool)
        for slot in self._live:
            active[slot] = True
        t0 = time.monotonic()
        try:
            out = self._dispatch(active)
        except Exception:
            # One bounded retry: a transient step failure must not retire
            # every request; a second failure surfaces.
            time.sleep(self.step_retry_backoff_s)
            out = self._dispatch(active)
        if out is None:
            return 0
        tokens, block_emitted = out
        now = time.monotonic()
        dt = now - t0
        ok = self.engine.step_ok
        emitted = 0
        for slot in list(self._live):
            live = self._live[slot]
            e = int(block_emitted[slot])
            reason = None
            for i in range(e):
                tok = int(tokens[slot, i])
                live.tokens.append(tok)
                emitted += 1
                if live.ttft_s is None:
                    # The first token lands at its step within the block.
                    live.ttft_s = (t0 - live.submit_t) + dt * (i + 1) / horizon
                if self.on_token is not None:
                    self.on_token(live.request_id, tok)
                if live.req.eos_id is not None and tok == live.req.eos_id:
                    reason = FinishReason.EOS
                elif len(live.tokens) >= live.req.max_new_tokens:
                    reason = FinishReason.LENGTH
                elif live.deadline_t is not None and now >= live.deadline_t:
                    reason = FinishReason.DEADLINE
                if reason is not None:
                    break
            error = None
            if reason is None and ok is not None and not ok[slot]:
                reason, error = FinishReason.ERROR, "non-finite logits"
            if reason is not None:
                del self._live[slot]
                self.engine.pool.free(slot)
                self._finish(live, reason, error=error)
        return emitted

    def _finish(self, live: _Live, reason: str,
                error: Optional[str] = None) -> None:
        result = RequestResult(
            request_id=live.request_id, tokens=live.tokens,
            finish_reason=reason, ttft_s=live.ttft_s,
            latency_s=time.monotonic() - live.submit_t, error=error)
        self.results[live.request_id] = result
        if self.on_finish is not None:
            self.on_finish(result)
