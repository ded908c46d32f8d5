"""Errors the port raises where it refuses what the JAX package does."""


class NotPortedError(ValueError):
    """A setting the JAX package supports that this port does not run
    yet: in serving, int8 KV, the host tier, speculative decoding,
    sequence-sharded prefill, long-prefill buckets, the dense layout,
    priorities, tenants and preemption; in the model and the trainer,
    the knobs listed in ``ROADMAP.md`` as later slices."""
