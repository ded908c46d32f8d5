"""Errors the port raises where it refuses what the JAX package does."""


class NotPortedError(ValueError):
    """A setting the JAX package supports that this port does not run
    yet: in serving, the host tier, speculative decoding, the dense
    layout, priorities, tenants, preemption and resharding a training
    checkpoint onto the serve mesh; in the models, the trainer and the
    train CLI, the knobs and configs listed in ``ROADMAP.md`` as later
    slices."""
