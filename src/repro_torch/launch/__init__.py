"""Training launch (counterpart of ``repro.launch``, single device and
data-parallel): ``steps`` (train, compressed data-parallel train, prefill
and serve steps), ``collectives`` (the posit16-compressed gradient sum
over a ``dist`` grid) and ``train`` (the CLI).

Not here.  ``compat.py`` and ``hlo_analysis.py`` are never ported (they
work on jax internals and XLA HLO text).  The sharded half (``sharding``:
FSDP/TP partition specs, ``mesh``, ``context``, ``dryrun``, the MoE's
expert-parallel ``moe_apply_ep`` and the vocab-parallel embedding) comes
in a later slice.
"""
