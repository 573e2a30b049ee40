"""Posit GEMM: the Hopper CUDA kernel (``csrc/``) with its plain PyTorch
versions (``posit_gemm.py``), the oracles (``ref.py``) and the BLAS-3
interface ``rgemm`` (``ops.py``)."""
