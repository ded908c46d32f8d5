"""Errors the port raises where it refuses what the JAX package does."""


class NotPortedError(ValueError):
    """A setting the JAX package supports that this port does not run
    yet: in serving, what the mesh-sharded engine does not run
    (speculative decoding, the host tier, the block wire's export and
    install); in the models, the trainer and the train CLI, the knobs and
    configs listed in ``ROADMAP.md`` as later slices."""
