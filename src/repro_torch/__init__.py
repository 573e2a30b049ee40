"""PyTorch/CUDA port of ``repro`` (posit arithmetic with accelerators).

The JAX package ``repro`` is the reference; this package mirrors its
module layout and function names, written in PyTorch, with every Pallas
TPU kernel replaced by a kernel written by hand for NVIDIA Hopper
(``kernels/csrc/``).  It imports ``torch`` and never ``jax`` or ``repro``.

Ported so far: ``core.formats``, ``core.posit`` (codec, exact and fast
backends, fused-chain ops, ``pconvert``, ``rounding_eps``), ``quire``
(the exact accumulator, ``quire_dot``, ``quire_gemm``), ``kernels.ref``,
``kernels.posit_gemm`` (CUDA kernel + plain versions), ``kernels.ops``
(``rgemm`` with every backend, ``quire_exact`` included),
``lapack.blas``/``decomp``/``solve`` (plain and quire sweeps, the
``_loop`` word-domain and ``_batched`` drivers; the GEMM kernel takes a
batch axis), ``lapack.qr`` (Householder QR, ``rormqr``/``rorgqr``,
``rgels``/``rgels_ir``/``rgels_mp``/``rgels_batched``, ``sgels``),
``lapack.refine`` (``rgesv_ir``/``rposv_ir``/``rgesv_mp``/``rposv_mp``,
the monitored refinement and the guarded ``rgesv_guarded`` ladder),
``lapack.error_eval`` (the §5.1 study and its batched ensemble, the
refinement, mixed-precision, least-squares and golden-zone studies),
``obs`` (positscope: counters, histograms, series, Chrome-trace spans and
posit-word telemetry, hooked into ``rgemm``, the factorizations and the
refinement where the reference records), ``ft`` (exact-ABFT checksums,
seeded fault injection, the protected GEMMs and the ``_ft``
factorizations), ``dist`` (the block-cyclic distributed path over
``torch.distributed``: a P x Q grid of ranks, ``pdgemm``, ``p_rpotrf`` /
``p_rgetrf``, the distributed refinement and the protected drivers),
``checkpoint`` (the reference's on-disk form), the LM serving stack:
``core.policy`` (the straight-through codec on the encode and decode
kernels), ``configs`` (the ten architectures, shape cells, smoke and
tiny configs), ``models`` (every family's training forward with the
chunked cross-entropy and remat, prefill and decode step, one dict per
layer; the flash attention's and the grouped GEMM's hand-written VJPs),
``serving`` (``quantize`` with the GEMM kernel behind
``quant_matmul(backend="pallas")``, the paged posit KV cache, the
continuous-batching ``Engine``, ``traffic``, ``study``), training
(``optim``: AdamW with p16e1 moments; ``data``: the seeded synthetic
batches; ``launch``: the train, compressed data-parallel train, prefill
and serve steps, the p16e1-compressed gradient sum over a ``dist`` grid
and the ``python -m repro_torch.launch.train`` CLI; sharded training:
the ("data", "model") mesh and ``DistContext`` over
``torch.distributed``, the sharding rules as per-rank blocks, the
expert-parallel MoE, the vocab-parallel embedding, the sharded train
step and the meta-device dry run), ``tree`` (the param/state trees) and
``interop`` (words, pivots, quires, the reference's model params,
gradients and training state both ways).

The reference's ten example scripts have their counterparts in
``examples/torch_<name>.py``.  Not yet ported (ROADMAP.md, queue A): the
port's benches (A14).  Never to be ported: ``launch/compat.py`` and
``launch/hlo_analysis.py``, which work on jax internals and XLA HLO
text.

Functions that take tensors run where the tensors live; entry points that
build tensors take ``device="cuda"`` by default and raise when no GPU is
present.
"""
