"""Fleet cache coordination: turn N replicas' private KV caches into
one logical three-tier cache.

Two halves, each deliberately tiny and transport-free:

``digest``
    Replica side.  A bounded prefix-hash summary of what a replica's
    paged pool currently holds — device trie nodes *and*
    host-tier entries, tagged per tier — rebuilt lazily at a pinned
    interval and piggybacked on the ``/healthz`` payload the
    router's prober already collects.  Hashes are ``blake2b`` over a canonical
    little-endian token encoding, so two processes that cached the
    same prefix advertise the same hash without exchanging tokens.

``affinity``
    Router side.  Pure functions that turn cached digests into a
    routing decision: ``coverage`` (how many leading blocks of this
    prompt does a candidate's digest cover, and from which tier),
    ``score`` (expected hit length discounted by load) and
    ``place_cold`` (consistent-hash placement among load-tied
    candidates when nobody covers anything, so repeat users grow an
    owner instead of piling onto the lowest rid).

The Router combines the two into a three-tier lookup per prefill:
own device trie -> own host tier -> peer replica (``pull_from``
pointer resolved over the ``/kv_export`` int8 wire) -> cold
prefill.
"""

from nezha_tpu_torch.serve.fleetcache.digest import (
    DIGEST_VERSION,
    DigestCache,
    build_digest,
    digest_entries_of,
    hash_prefix,
    prefix_hashes,
)
from nezha_tpu_torch.serve.fleetcache.affinity import (
    coverage,
    place_cold,
    score,
)

__all__ = [
    "DIGEST_VERSION",
    "DigestCache",
    "build_digest",
    "digest_entries_of",
    "hash_prefix",
    "prefix_hashes",
    "coverage",
    "place_cold",
    "score",
]
