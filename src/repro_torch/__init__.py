"""PyTorch/CUDA port of ``repro`` (posit arithmetic with accelerators).

The JAX package ``repro`` is the reference; this package mirrors its
module layout and function names, written in PyTorch, with every Pallas
TPU kernel replaced by a kernel written by hand for NVIDIA Hopper
(``kernels/csrc/``).  It imports ``torch`` and never ``jax`` or ``repro``.

Ported so far (the paper's §5.1 path): ``core.formats``, ``core.posit``
(codec, fast backend, fused-chain ops), ``kernels.ref``,
``kernels.posit_gemm`` (CUDA kernel + plain versions), ``kernels.ops``
(``rgemm``), ``lapack.blas``/``decomp``/``solve``/``error_eval`` and
``interop``.  Not yet ported: the int64 ``exact`` posit backend,
``pconvert``, ``rounding_eps``, the quire, refinement, QR,
observability, fault tolerance, the distributed stack, models, serving
and training (ROADMAP.md, queue A).

Functions that take tensors run where the tensors live; entry points that
build tensors take ``device="cuda"`` by default and raise when no GPU is
present.
"""
