"""Posit BLAS-2/3 building blocks: triangular solves and the Householder
reflector (counterpart of ``repro.lapack.blas``).

Every scalar operation is a rounded posit op (fast backend) in the working
format ``fmt``, in the operation order of reference-BLAS dtrsm/dtrsv
(rank-1 / axpy form) and LAPACK dlarfg.  The sweeps run in fused-chain
form: the operands decode to f64 once, every op is rounded with
``chain_round``, and words are encoded once at exit — the same words as
per-op fast-backend ops.

The reference computes each step's update over the whole array and masks
the rows (or columns) that are already solved; the port updates only the
unsolved slice, in place in its own f64 working copy.  The rounding is
elementwise, so the words are the same.

Every plain sweep also takes a leading batch axis (matrices (B, n, n),
right-hand sides (B, n[, m])): the reference ``vmap``s them; here the same
body indexes with ``...``, so a 2-D call is the batch-free case of the
same code and B matrices cost one matrix's launches.

``chain_sum`` is the chained-add scan of the QR panels and of ``potf2``;
on a GPU each of its steps replays a CUDA graph of one rounded add.

The quire sweeps (``rtrsv_*_quire``) give each solved component ONE
rounding before the divide: its row's inner product is an exact fused dot
(``repro_torch.quire``), as in the reference.  They are n sequential
steps, each a ``quire_dot`` of the whole row against x (whose unsolved
entries are zero words) and a fast-backend divide, queued without a host
sync.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.quire import quire_dot


def rtrsm_left_lower(l_p: torch.Tensor, b_p: torch.Tensor,
                     unit_diag: bool = True,
                     fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve L X = B, L ([B,] n, n) lower-triangular posit, B ([B,] n, m)
    posit, by forward substitution in rank-1-update order."""
    n = l_p.shape[-1]
    lv = posit.chain_decode(l_p, fmt)
    b = posit.chain_decode(b_p, fmt)
    for k in range(n):
        xk = b[..., k, :]
        if not unit_diag:
            xk = posit.chain_div(xk, lv[..., k, k, None], fmt)
        if k + 1 < n:
            b[..., k + 1:, :] = posit.chain_sub(
                b[..., k + 1:, :],
                posit.chain_mul(lv[..., k + 1:, k, None], xk[..., None, :],
                                fmt), fmt)
        b[..., k, :] = xk
    return posit.chain_encode(b, fmt)


def rtrsm_left_upper(u_p: torch.Tensor, b_p: torch.Tensor,
                     unit_diag: bool = False,
                     fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve U X = B, U ([B,] n, n) upper-triangular posit, B ([B,] n, m),
    by backward substitution in rank-1-update order (Rgels' final
    R x = Q^T b solve).  The strict lower triangle of U is never read, so
    a QR-factored matrix (reflector tails below the diagonal) can be
    passed as it is."""
    n = u_p.shape[-1]
    uv = posit.chain_decode(u_p, fmt)
    b = posit.chain_decode(b_p, fmt)
    for k in range(n - 1, -1, -1):
        xk = b[..., k, :]
        if not unit_diag:
            xk = posit.chain_div(xk, uv[..., k, k, None], fmt)
        if k > 0:
            b[..., :k, :] = posit.chain_sub(
                b[..., :k, :],
                posit.chain_mul(uv[..., :k, k, None], xk[..., None, :], fmt),
                fmt)
        b[..., k, :] = xk
    return posit.chain_encode(b, fmt)


def rtrsm_right_lowerT(b_p: torch.Tensor, l_p: torch.Tensor,
                       fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve X L^T = B (right, lower-transpose, non-unit diag): Cholesky's
    panel update A21 <- A21 * L11^{-T}, right-looking column order."""
    n = l_p.shape[-1]
    lv = posit.chain_decode(l_p, fmt)
    b = posit.chain_decode(b_p, fmt)
    for k in range(n):
        xk = posit.chain_div(b[..., k], lv[..., k, k, None], fmt)
        if k + 1 < n:
            b[..., k + 1:] = posit.chain_sub(
                b[..., k + 1:],
                posit.chain_mul(xk[..., None], lv[..., None, k + 1:, k], fmt),
                fmt)
        b[..., k] = xk
    return posit.chain_encode(b, fmt)


def rtrsv_lower(l_p: torch.Tensor, b_p: torch.Tensor,
                unit_diag: bool = False,
                fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve L x = b (vector; ([B,] n)), forward substitution with posit
    axpy steps."""
    n = l_p.shape[-1]
    lv = posit.chain_decode(l_p, fmt)
    b = posit.chain_decode(b_p, fmt)
    for k in range(n):
        xk = b[..., k]
        if not unit_diag:
            xk = posit.chain_div(xk, lv[..., k, k], fmt)
        if k + 1 < n:
            b[..., k + 1:] = posit.chain_sub(
                b[..., k + 1:],
                posit.chain_mul(lv[..., k + 1:, k], xk[..., None], fmt), fmt)
        b[..., k] = xk
    return posit.chain_encode(b, fmt)


def rtrsv_upper(u_p: torch.Tensor, b_p: torch.Tensor,
                unit_diag: bool = False,
                fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve U x = b (vector; ([B,] n)), backward substitution with posit
    axpy steps."""
    n = u_p.shape[-1]
    uv = posit.chain_decode(u_p, fmt)
    b = posit.chain_decode(b_p, fmt)
    for k in range(n - 1, -1, -1):
        xk = b[..., k]
        if not unit_diag:
            xk = posit.chain_div(xk, uv[..., k, k], fmt)
        if k > 0:
            b[..., :k] = posit.chain_sub(
                b[..., :k], posit.chain_mul(uv[..., :k, k], xk[..., None],
                                            fmt), fmt)
        b[..., k] = xk
    return posit.chain_encode(b, fmt)


class _AddStep:
    """One rounded add ``acc <- chain_add(acc, term)`` captured as a CUDA
    graph over fixed buffers (one lane shape, device and format), on
    ``like``'s device.  The graphs of a device share one memory pool: a
    step's temporaries are dead once its replay ends, and replays queue on
    one stream, so the pool holds one step's temporaries, not one set per
    cached graph."""

    def __init__(self, like: torch.Tensor, fmt: PositFormat):
        dev = like.device
        with torch.cuda.device(dev):
            self.acc = torch.zeros_like(
                like, memory_format=torch.contiguous_format)
            self.term = torch.zeros_like(self.acc)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):      # warm-up outside the capture
                self.acc.copy_(posit.chain_add(self.acc, self.term, fmt))
            torch.cuda.current_stream(dev).wait_stream(side)
            if dev not in _GRAPH_POOLS:
                _GRAPH_POOLS[dev] = torch.cuda.graph_pool_handle()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=_GRAPH_POOLS[dev]):
                self.acc.copy_(posit.chain_add(self.acc, self.term, fmt))


# The most recently used steps, at most _ADD_STEPS_MAX of them (a QR or a
# potf2 sweep uses one lane shape per panel column, a few dozen in all).
_ADD_STEPS: OrderedDict[tuple, _AddStep] = OrderedDict()
_ADD_STEPS_MAX = 256
_GRAPH_POOLS: dict[torch.device, tuple] = {}


def chain_sum(init: torch.Tensor, terms: torch.Tensor, dim: int,
              fmt: PositFormat = P32E2) -> torch.Tensor:
    """``init`` plus the slices of ``terms`` along ``dim``, added one
    rounded step at a time in ascending order: the chained-add scans of
    the reference's QR panels (and ``potf2``'s column chain, with the
    products negated: x - p is x + (-p) in IEEE arithmetic).  The terms
    are computed beforehand in one vectorized op (each is its own
    rounding), so only the adds are sequential.

    On a CUDA device a step is a copy of the term and the replay of a CUDA
    graph of one rounded add (captured once per lane shape and format and
    kept, up to ``_ADD_STEPS_MAX`` graphs): two launches a step instead of
    the few dozen small ones of ``chain_add``, which make an eager scan
    host-bound.  The same ops run, so the words are the same as on the
    CPU, where the scan runs eagerly.
    """
    if not init.is_cuda or init.numel() == 0:
        s = init
        for t in terms.unbind(dim):
            s = posit.chain_add(s, t, fmt)
        return s
    key = (tuple(init.shape), init.dtype, init.device, fmt.name)
    step = _ADD_STEPS.get(key)
    if step is None:
        step = _ADD_STEPS[key] = _AddStep(init, fmt)
        if len(_ADD_STEPS) > _ADD_STEPS_MAX:
            _ADD_STEPS.popitem(last=False)
    _ADD_STEPS.move_to_end(key)
    step.acc.copy_(init)
    for t in terms.unbind(dim):
        step.term.copy_(t)
        step.graph.replay()
    return step.acc.clone()


def rlarfg_chain(col: torch.Tensor, k: int, fmt: PositFormat = P32E2):
    """The Householder reflector H = I - tau v v^T annihilating ``col``
    ([B,] m; fused-chain values) below index ``k`` (dlarfg, every scalar
    op posit-rounded).  Returns chain-domain ``(newcol, v, tau)``:

    * ``newcol`` — beta = -sign(alpha) * ||col[k:]|| at k (``alpha > 0``
      picks the sign, so alpha == 0 gives beta = +norm), the reflector
      tail v[k+1:] below it, rows < k untouched;
    * ``v``      — the full reflector: 0 above k, exactly 1 at k;
    * ``tau``    — (beta - alpha) / beta, or 0 where the tail is all zero
      (H = I, the dlarfg trivial case, which the last column of a square
      panel also gives): posit rounding saturates at minpos and never
      flushes, so s2 == 0 exactly then and only then.

    The reference scans every row and masks those <= k; the port squares
    only the tail, in one op, and chains the adds over it.
    """
    tail_in = col[..., k + 1:]
    zero = torch.zeros_like(col[..., k])
    s2 = chain_sum(zero, posit.chain_mul(tail_in, tail_in, fmt), -1, fmt)
    alpha = col[..., k]
    norm = posit.chain_sqrt(
        posit.chain_add(posit.chain_mul(alpha, alpha, fmt), s2, fmt), fmt)
    trivial = s2 == 0.0
    beta = torch.where(alpha > 0, -norm, norm)
    tau = torch.where(trivial, 0.0, posit.chain_div(
        posit.chain_sub(beta, alpha, fmt), beta, fmt))
    tail = posit.chain_div(tail_in, posit.chain_sub(alpha, beta, fmt)[
        ..., None], fmt)
    keep = trivial[..., None]
    v = torch.zeros_like(col)
    v[..., k] = 1.0
    v[..., k + 1:] = torch.where(keep, 0.0, tail)
    newcol = col.clone()
    newcol[..., k] = torch.where(trivial, alpha, beta)
    newcol[..., k + 1:] = torch.where(keep, tail_in, tail)
    return newcol, v, tau


# --------------------------------------------------------------------------
# quire-backed substitutions: one rounding per solved component before the
# divide (the building block of lapack/refine.py)
# --------------------------------------------------------------------------

def _div(a, b, fmt: PositFormat = P32E2):
    """Word-domain rounded divide, for the quire dots' posit results."""
    return posit.div(a, b, fmt, backend="fast")


def _rtrsv_quire(t_p, b_p, unit_diag, fmt, order):
    t_p = t_p.to(torch.int32)
    b_p = b_p.to(torch.int32)
    x = torch.zeros_like(b_p)
    for k in order:
        # x[j] is the zero word for every unsolved j, so the full-row
        # fused dot picks up only the solved part (and a NaR anywhere in
        # the row, as in the reference).
        rk = quire_dot(t_p[k], x, fmt, init_p=b_p[k], negate=True)
        x[k] = rk if unit_diag else _div(rk, t_p[k, k], fmt)
    return x


def rtrsv_lower_quire(l_p: torch.Tensor, b_p: torch.Tensor,
                      unit_diag: bool = False,
                      fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve L x = b with quire-exact rows:
    x_k = round(b_k - fdp(L[k, :k], x[:k])) / L_kk."""
    return _rtrsv_quire(l_p, b_p, unit_diag, fmt, range(l_p.shape[0]))


def rtrsv_upper_quire(u_p: torch.Tensor, b_p: torch.Tensor,
                      unit_diag: bool = False,
                      fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve U x = b, backward substitution with quire-exact rows."""
    return _rtrsv_quire(u_p, b_p, unit_diag, fmt,
                        range(u_p.shape[0] - 1, -1, -1))
