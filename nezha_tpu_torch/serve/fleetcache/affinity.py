"""Affinity scoring: turn cached digests into a routing decision.

Pure functions — the Router owns all state (digest snapshots live in
``Replica.last_health``, staleness is judged against the prober
clock).  Keeping this transport- and lock-free is what makes the
scorer unit-testable without a cluster.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from nezha_tpu_torch.serve.fleetcache.digest import hash_prefix


def coverage(entries: Dict[str, str],
             hashes: Sequence[str]) -> Tuple[int, Optional[str]]:
    """-> ``(blocks, tier)``: how many leading block-aligned prefixes
    of the prompt (pre-hashed into ``hashes``) this digest covers, and
    the tier tag of the longest covering entry.

    Scans longest-first: the longest covered prefix determines both
    the score and the tier a hit is expected to land in, and prompts
    shorter than the digest's reach exit after one lookup.
    """
    for k in range(len(hashes) - 1, -1, -1):
        tier = entries.get(hashes[k])
        if tier is not None:
            return k + 1, tier
    return 0, None


def score(cover_blocks: int, block_size: int,
          in_flight: int, queued: int) -> float:
    """Expected-prefix-hit tokens discounted by candidate load.

    ``cover_blocks * block_size`` tokens of prefill are avoided on a
    hit; each in-flight or queued request on the candidate delays the
    new arrival by roughly one decode round, hence the harmonic
    discount.  A zero-coverage candidate scores 0.0 regardless of
    load — cold placement is :func:`place_cold`'s job, not a
    tie-break inside the scorer.
    """
    if cover_blocks <= 0:
        return 0.0
    return (cover_blocks * block_size) / (1.0 + in_flight + queued)


def place_cold(tokens: Sequence[int], block_size: int,
               rids: Sequence[int]) -> Optional[int]:
    """Consistent-hash placement when no candidate covers anything.

    Hashes the first block of the prompt (the whole prompt when
    shorter) and picks among ``rids`` — the caller passes only the
    candidates tied at minimal load, so this never overrides the
    least-loaded invariant, it only breaks its ties deterministically
    per prefix.  Without this, zero-load ties always resolve to the
    lowest rid and repeat users never grow an owner replica.
    """
    if not rids:
        return None
    head = list(tokens[:max(1, block_size)])
    if not head:
        return None
    ordered: List[int] = sorted(rids)
    return ordered[int(hash_prefix(head), 16) % len(ordered)]


__all__ = ["coverage", "place_cold", "score"]
