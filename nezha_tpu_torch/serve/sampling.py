"""Per-row sampling for the batched decode step (counterpart of
``nezha_tpu/serve/sampling.py``).

Temperature, top-k and top-p arrive as ``[B]`` tensors, so one step
serves every mix of requests:

- temperature ``<= 0`` selects greedy ``argmax`` for the row and draws no
  random number;
- top-k masks by per-row k against the row's k-th largest value under a
  static cap ``k_max`` (``top_k <= 0`` disables it);
- top-p keeps the exclusive-cumsum nucleus (``p >= 1`` keeps everything,
  ``p <= 0`` keeps only the top token).

Randomness: JAX gives each row its own PRNG key; here each request owns a
``torch.Generator`` on the engine's device (Philox on CUDA) seeded with
the request's ``seed``. A sampled row draws one uniform per decode step
from its own generator, and the engine draws only for rows that are
still decoding — a live row emits a token every step — so a request's
stream depends on its seed and its emitted-token count alone, never on
its batch neighbours or the decode horizon. The streams are not JAX's
threefry numbers: the same seed samples different tokens in the two
packages.

Speculative decoding composes the rest (the engine's draft -> verify ->
accept window): :func:`filtered_probs` is the distribution the accept
test and the residual are computed over; :func:`accept_mask` the
per-position decision (greedy: exact match against the target argmax;
sampled: ``u * q(d) < p(d)``); :func:`residual_logits` the rejection
resample ``norm(max(p - q, 0))`` in log space, which the engine carries
as the row's next distribution; :func:`categorical_rows` draws from it.
The speculative step's draws come from :func:`keyed_uniforms`, a
counter-based hash of (seed, emitted count, purpose, index) computed on
the device: JAX keys them the same way (``split`` for the window's first
token, ``fold_in(1 + j)`` for draft proposal j, ``fold_in(k + 2)`` for
the accept uniforms), so a request's speculative stream does not change
with the decode horizon. The classic step keeps its generators.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """``[B, V]`` -> ``[B]`` bool: True where the whole row is finite (the
    decode step's NaN/inf tripwire)."""
    return torch.isfinite(logits).all(dim=-1)


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  k_max: int) -> torch.Tensor:
    """Per-row temperature/top-k/top-p truncation: ``[B, V]`` logits ->
    ``[B, V]`` scaled logits with truncated entries at ``-inf``."""
    _, v = logits.shape
    if not 1 <= k_max <= v:
        raise ValueError(f"k_max must be in [1, {v}], got {k_max}")
    neg_inf = torch.full((), float("-inf"), device=logits.device)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    kth_vals = torch.topk(scaled, k_max, dim=-1).values       # [B, k_max]
    k_eff = top_k.long().clamp(1, k_max)
    kth = kth_vals.gather(1, (k_eff - 1)[:, None])
    apply_k = (top_k > 0)[:, None]
    scaled = torch.where(apply_k & (scaled < kth), neg_inf, scaled)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    exclusive_cum = torch.cumsum(probs, dim=-1) - probs
    rank = torch.arange(v, device=logits.device)[None, :]
    # p >= 1 keeps every token outright: an fp32 cumsum can reach 1.0
    # before the tail, and where it does depends on the summation order.
    keep = ((exclusive_cum < top_p[:, None]) | (rank == 0)
            | (top_p >= 1.0)[:, None])
    threshold = torch.where(keep, sorted_logits,
                            torch.full((), float("inf"),
                                       device=logits.device)
                            ).amin(dim=-1, keepdim=True)
    return torch.where(scaled < threshold, neg_inf, scaled)


def sample_tokens(logits: torch.Tensor, uniforms: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, k_max: int) -> torch.Tensor:
    """logits ``[B, V]``, ``uniforms [B]`` in ``[0, 1)`` (one per row; a
    greedy row's is ignored), temperature/top_p ``[B]`` float, top_k
    ``[B]`` int -> token ids ``[B]`` int32. A sampled row inverts the CDF
    of its filtered distribution at its uniform; a zero-probability token
    is never picked."""
    greedy = temperature <= 0.0
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p,
                                        k_max), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    target = (uniforms.float() * cdf[:, -1])[:, None]
    sampled = torch.searchsorted(cdf, target, right=True)[:, 0]
    sampled = sampled.clamp(max=logits.shape[1] - 1)
    return torch.where(greedy, torch.argmax(logits, dim=-1),
                       sampled).to(torch.int32)


def draw_uniforms(generators: Sequence[Optional[torch.Generator]],
                  rows: Sequence[int], batch: int,
                  device) -> torch.Tensor:
    """One uniform per listed row from that row's generator (the "split":
    each listed row's stream advances by one); ``[batch]`` with zeros
    elsewhere."""
    u = torch.zeros(batch, dtype=torch.float32, device=device)
    for r in rows:
        u[r] = torch.rand((), generator=generators[r], device=device)
    return u


def split_and_sample(generators: Sequence[Optional[torch.Generator]],
                     rows: Sequence[int], logits: torch.Tensor,
                     temperature: torch.Tensor, top_k: torch.Tensor,
                     top_p: torch.Tensor, k_max: int) -> torch.Tensor:
    """One decode step's sampling move: advance the generators of the
    sampled rows that are still decoding (``rows``) by one draw, then
    sample every row from the carried logits -> ``[B]`` int32. With no
    sampled row every row's token is its argmax, so the filtering is
    skipped."""
    if not rows:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = draw_uniforms(generators, rows, logits.shape[0], logits.device)
    return sample_tokens(logits, u, temperature, top_k, top_p, k_max)


# ------------------------------------------------- speculative decoding
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 lanes holding ``[0, 2^32)``;
    its multipliers stay below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def keyed_uniforms(seeds: torch.Tensor, counts: torch.Tensor, purpose: int,
                   n: int) -> torch.Tensor:
    """``[B, n]`` uniforms in ``(0, 1)``: entry ``(r, i)`` is a hash of
    (``seeds[r]``, ``counts[r]``, ``purpose``, ``i``) alone, computed on the
    device with no generator state. ``seeds``/``counts`` ``[B]`` int64.
    Never exactly 0, so ``u * q < p`` rejects a zero-probability token
    and an inverse-CDF draw never lands on a zero-mass entry."""
    h = _mix32((seeds & _M32) ^ 0x3C6EF372)
    h = _mix32(h ^ ((seeds >> 32) & _M32))
    h = _mix32(h ^ (counts & _M32))
    h = _mix32(h ^ ((purpose * 0x2545F491) & _M32))
    idx = torch.arange(n, device=seeds.device, dtype=torch.int64)
    h = _mix32(h[:, None] ^ ((idx * 0x1B873593 + 0x165667B1) & _M32))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def filtered_probs(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor,
                   k_max: int) -> torch.Tensor:
    """``softmax(filter_logits(...))``: the probabilities the accept test
    and the residual are computed over, ``[B, V]``."""
    return torch.softmax(filter_logits(logits, temperature, top_k, top_p,
                                       k_max), dim=-1)


def categorical_rows(uniforms: torch.Tensor,
                     logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` (``[B, V]``) at its
    uniform (``[B]``), by the inverse CDF as :func:`sample_tokens` draws
    -> ``[B]`` int32. The logits are taken as they are: the residual's
    are already filtered log-probabilities, and filtering them again
    would bend the rejection-sampling law."""
    cdf = torch.cumsum(torch.softmax(logits.float(), dim=-1), dim=-1)
    target = (uniforms.float() * cdf[:, -1])[:, None]
    tok = torch.searchsorted(cdf, target, right=True)[:, 0]
    return tok.clamp(max=logits.shape[1] - 1).to(torch.int32)


def accept_mask(draft_tokens: torch.Tensor, p_probs: torch.Tensor,
                q_probs: torch.Tensor, u: torch.Tensor, greedy: torch.Tensor,
                target_argmax: torch.Tensor) -> torch.Tensor:
    """Per-position speculative accept decision: ``draft_tokens [B, K]``,
    target/draft distributions ``p_probs``/``q_probs [B, K, V]`` (both
    filtered with the row's own parameters), uniforms ``u [B, K]``,
    ``greedy [B]``, ``target_argmax [B, K]`` (of the unfiltered target
    logits) -> ``[B, K]`` bool. A greedy row accepts a proposal equal to
    the target's argmax; a sampled row accepts when ``u * q(d) < p(d)``
    (strict: a token the target gives zero probability never passes), and
    a non-finite draft distribution rejects outright."""
    idx = draft_tokens.long()[..., None]
    psel = p_probs.gather(2, idx)[..., 0]
    qsel = q_probs.gather(2, idx)[..., 0]
    q_ok = torch.isfinite(q_probs).all(dim=-1)
    sampled_acc = q_ok & (u * qsel < psel)
    greedy_acc = draft_tokens == target_argmax
    return torch.where(greedy[:, None], greedy_acc, sampled_acc)


def residual_logits(p_probs: torch.Tensor,
                    q_probs: torch.Tensor) -> torch.Tensor:
    """The rejection resample in log space, ``log(max(p - q, 0) + 1e-30)``
    per row (``[B, V]``). The floor keeps zero-mass entries finite (the
    carried logits pass the engine's non-finite tripwire) and is a normal
    fp32 number, which no backend flushes to zero."""
    return torch.log(torch.clamp(p_probs - q_probs, min=0.0) + 1e-30)
