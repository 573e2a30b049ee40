"""Training launch (counterpart of ``repro.launch``): ``steps`` (train,
sharded train, compressed data-parallel train, prefill and serve steps),
``collectives`` (the posit16-compressed gradient sum over a ``dist``
grid), ``train`` (the CLI), ``mesh`` (the ("data", "model") mesh on a
``dist`` grid's process groups and its autograd collectives),
``context`` (``DistContext``), ``sharding`` (the logical-axis rules and
the per-rank blocks they name) and ``dryrun`` (each cell's plan on the
meta device).

Not here.  ``compat.py`` and ``hlo_analysis.py`` are never ported (they
work on jax internals and XLA HLO text).
"""
