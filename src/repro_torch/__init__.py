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
``lapack.blas``/``decomp``/``solve`` (plain and quire sweeps),
``lapack.refine`` (``rgesv_ir``/``rposv_ir``/``rgesv_mp``/``rposv_mp``),
``lapack.error_eval`` (the §5.1 study and the refinement and
mixed-precision studies) and ``interop``.  Not yet ported: the batched
and fault-tolerant drivers, QR, observability, the monitored/guarded
refinement drivers, the distributed stack, models, serving and training
(ROADMAP.md, queue A).

Functions that take tensors run where the tensors live; entry points that
build tensors take ``device="cuda"`` by default and raise when no GPU is
present.
"""
