"""Exact-ABFT fault tolerance for the posit linear algebra (counterpart of
``repro.ft``).

Three legs:

* ``ft.abft``   — quire-exact ones-weighted checksums (canonical integer
                  limbs) and verification by exact equality;
                  ``rgemm_ft`` / ``quire_gemm_ft`` protected GEMMs.
* ``ft.inject`` — deterministic, seeded fault injection: word/limb XOR
                  transforms driven by a static schedule (site, step,
                  lane), the same faults as the reference's for the same
                  seed.
* ``ft.report`` — outcome records (``FtReport`` for the protected
                  drivers, ``SolveReport`` for the guarded solve ladder in
                  ``lapack.refine``).

The protected factorizations (``rpotrf_ft`` / ``rgetrf_ft`` /
``rgeqrf_ft``) live beside their unprotected originals in
``lapack.decomp`` / ``lapack.qr``.  Nothing here changes the unprotected
entry points.
"""
from repro_torch.ft.abft import (AbftError, Checksums, checksum, locate,
                                 quire_gemm_ft, rgemm_ft, verify)
from repro_torch.ft.inject import Fault, FaultPlan, make_plan
from repro_torch.ft.report import FtReport, SolveReport

__all__ = [
    "Checksums", "checksum", "verify", "locate", "rgemm_ft",
    "quire_gemm_ft", "Fault", "FaultPlan", "make_plan", "FtReport",
    "SolveReport", "AbftError",
]
