"""Trie digests: bounded prefix-hash summaries of a replica's KV
cache, advertised to the Router over ``/healthz``.

A digest maps ``hash_prefix(tokens[:k*block_size])`` -> tier tag
(``"device"`` or ``"host"``) for a bounded number of cached prefixes.
The hash is ``blake2b`` (8-byte digest) over each token encoded as a
little-endian signed 64-bit integer — a canonical byte encoding, so
the replica building the digest and the Router hashing an incoming
prompt agree without ever shipping tokens.  Python's builtin ``hash``
is per-process salted and must never be used here.

Digests are *advisory*: a stale entry costs one wasted peer probe (the
export side returns an empty wire for zero coverage), never
correctness.  That is what lets the rebuild be lazy and the bound be
small.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Wire-format version of the ``fleet_digest`` healthz payload.  Bump
# on any change to the hash encoding or entry shape; the Router
# ignores digests whose version it does not recognise.
DIGEST_VERSION = 1

_TIERS = ("device", "host")


def _token_bytes(tok: int) -> bytes:
    return int(tok).to_bytes(8, "little", signed=True)


def hash_prefix(tokens: Sequence[int]) -> str:
    """Canonical hash of one token prefix (hex, 16 chars)."""
    h = hashlib.blake2b(digest_size=8)
    for t in tokens:
        h.update(_token_bytes(t))
    return h.hexdigest()


def prefix_hashes(tokens: Sequence[int], block_size: int) -> List[str]:
    """Hashes of every block-aligned prefix of ``tokens``, one pass.

    Element ``k`` is ``hash_prefix(tokens[:(k+1)*block_size])``; the
    incremental update makes hashing an L-token prompt O(L) rather
    than O(L^2 / block_size).
    """
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    h = hashlib.blake2b(digest_size=8)
    out: List[str] = []
    nblocks = len(tokens) // block_size
    for k in range(nblocks):
        for t in tokens[k * block_size:(k + 1) * block_size]:
            h.update(_token_bytes(t))
        out.append(h.hexdigest())
    return out


def build_digest(pool, max_entries: int) -> Dict[str, str]:
    """-> ``{prefix_hash: tier}`` for up to ``max_entries`` cached
    prefixes of ``pool`` (a PagedSlotPool), recency-first.

    ``pool.digest_entries()`` yields ``(path_tokens, tier)`` with
    device-trie paths first (hottest first), then host-tier keys (MRU
    first).  Device wins on a hash collision between tiers — a device
    hit is strictly cheaper than a host promote, and the Router only
    uses the tag for telemetry-grade expectations, not correctness.
    """
    if max_entries < 1:
        raise ValueError(f"max_entries must be >= 1, got {max_entries}")
    out: Dict[str, str] = {}
    for path_tokens, tier in pool.digest_entries():
        if tier not in _TIERS:
            raise ValueError(f"unknown digest tier {tier!r}")
        key = hash_prefix(path_tokens)
        prev = out.get(key)
        if prev is None:
            if len(out) >= max_entries:
                # Entries arrive recency-first, so truncation drops
                # the coldest prefixes — keep scanning only to let a
                # device tag upgrade an already-admitted host tag.
                continue
            out[key] = tier
        elif prev == "host" and tier == "device":
            out[key] = tier
    return out


class DigestCache:
    """Lazily rebuilt digest + the healthz payload that carries it.

    The scheduler owns one of these (under its lock); every
    ``/healthz`` hit calls :meth:`payload`, which rebuilds at most
    once per ``interval_s`` — a bounded trie walk, never a device op.
    """

    def __init__(self, interval_s: float = 2.0,
                 max_entries: int = 256) -> None:
        if interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0, got {interval_s}")
        if max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {max_entries}")
        self.interval_s = float(interval_s)
        self.max_entries = int(max_entries)
        self._entries: Dict[str, str] = {}
        self._built_t: float = 0.0

    def payload(self, pool) -> Dict[str, object]:
        """-> healthz fields: ``fleet_digest`` (versioned entry map),
        ``digest_size`` and ``digest_age_s``."""
        now = time.monotonic()
        if self._built_t <= 0.0 or now - self._built_t >= self.interval_s:
            self._entries = build_digest(pool, self.max_entries)
            self._built_t = now
        return {
            "fleet_digest": {
                "v": DIGEST_VERSION,
                "block_size": int(pool.block_size),
                "entries": dict(self._entries),
            },
            "digest_size": len(self._entries),
            "digest_age_s": max(0.0, now - self._built_t),
        }


def digest_entries_of(
        payload: Optional[dict],
) -> Optional[Tuple[int, Dict[str, str]]]:
    """-> ``(block_size, entries)`` from one replica's healthz
    payload, or ``None`` if absent / malformed / wrong version."""
    if not isinstance(payload, dict):
        return None
    dig = payload.get("fleet_digest")
    if not isinstance(dig, dict) or dig.get("v") != DIGEST_VERSION:
        return None
    bs = dig.get("block_size")
    entries = dig.get("entries")
    if not isinstance(bs, int) or bs < 1 or not isinstance(entries, dict):
        return None
    return bs, entries


__all__ = [
    "DIGEST_VERSION",
    "DigestCache",
    "build_digest",
    "digest_entries_of",
    "hash_prefix",
    "prefix_hashes",
]
