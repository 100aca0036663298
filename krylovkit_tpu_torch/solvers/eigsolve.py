"""``eigsolve``, ``schursolve`` and ``realeigsolve`` front-ends (counterpart
of ``krylovkit_tpu/solvers/eigsolve.py``).

The ``eigselector`` picks Lanczos for Hermitian problems (``ishermitian=True``
or a concrete matrix that is Hermitian by a numerical probe) and Arnoldi
otherwise; a :class:`Block` start (or a ``BlockLanczos`` algorithm) runs
Block Lanczos.  When gradients are enabled and ``x0`` or a tensor the
operator holds requires grad, the Lanczos or Arnoldi solve goes through the
differentiable ``ad.eigsolve_vjp`` (backward with ``alg_rrule``); otherwise
straight to the driver.  ``schursolve``, ``realeigsolve`` and Block Lanczos
have no differentiation rule, as in the JAX package, and refuse an input
that requires grad.  The solve runs on the device of ``x0``; ``x0`` may be
a pytree vector (``ops/vector.py``), and a :class:`Block` of them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..algorithms import Arnoldi, BlockLanczos, Lanczos
from ..ops.block import Block
from ..ad._common import needs_grad, refuse_grad
from ..ops.operator import as_operator, concrete_start, probe_dtype
from ..ops.vector import STANDARD, VectorSpace, device_of, tree_leaves
from .arnoldi import eigsolve_arnoldi, realeigsolve_arnoldi
from .arnoldi import schursolve as _schursolve_arnoldi
from .blocklanczos import eigsolve_blocklanczos
from .lanczos import eigsolve_lanczos

__all__ = ["eigsolve", "schursolve", "realeigsolve"]


def _eigsolve_impl(op, x0, howmany, which, alg, space):
    """Driver dispatch, undifferentiated (the forward of ``ad.eigsolve_vjp``)."""
    if isinstance(alg, Lanczos):
        return eigsolve_lanczos(op, x0, howmany, which, alg, space)
    return eigsolve_arnoldi(op, x0, howmany, which, alg, space)


def _is_concrete(A) -> bool:
    return isinstance(A, (np.ndarray, torch.Tensor))


def _probe_hermitian(A) -> bool:
    An = A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
    return An.shape[0] == An.shape[1] and bool(
        np.allclose(An, An.conj().T, atol=1e-12 * max(1.0, float(np.max(np.abs(An)))))
    )


def _default_x0(A, x0, space: VectorSpace = STANDARD):
    if x0 is not None:
        # breakdown guard for concrete starts (reference raises on β₀ == 0,
        # src/factorizations/lanczos.jl:184).  On a sharded space x0 is this
        # rank's block: the norm comes through the space (one all-reduce),
        # so every rank raises or none does
        if space.psum_axis is not None:
            zero = float(space.norm(x0)) == 0.0
        else:
            zero = sum(float(torch.sum(torch.abs(l.detach()) ** 2)) for l in tree_leaves(x0)) == 0.0
        if zero:
            raise ValueError("starting vector x0 has zero norm")
        return x0
    if _is_concrete(A) and A.ndim == 2:
        return concrete_start(A)
    raise ValueError("x0 is required unless the operator is a concrete matrix")


def _select_alg(A, ishermitian, alg, **kw):
    """``eigselector`` (reference src/eigsolve/eigsolve.jl:238-283)."""
    if alg is not None:
        return alg
    if ishermitian is None:
        ishermitian = _probe_hermitian(A) if _is_concrete(A) else False
    cls = Lanczos if ishermitian else Arnoldi
    return cls(**{k: v for k, v in kw.items() if v is not None})


def eigsolve(
    A,
    x0: Optional[torch.Tensor] = None,
    howmany: int = 1,
    which="LM",
    *,
    ishermitian: Optional[bool] = None,
    alg=None,
    space: VectorSpace = STANDARD,
    tol: Optional[float] = None,
    krylovdim: Optional[int] = None,
    maxiter: Optional[int] = None,
    orth=None,
    eager: Optional[bool] = None,
    verbosity: Optional[int] = None,
    alg_rrule=None,
):
    """Find ``howmany`` extremal eigenvalues of a linear map.

    Returns ``(vals, vecs, info)``: ``vals`` of length ``howmany``, ``vecs``
    stacked along a leading axis, ``info`` a :class:`ConvergenceInfo`
    (reference ``eigsolve``, ``src/eigsolve/eigsolve.jl:1-185``).  ``A`` is
    a matrix (tensor or numpy array), a callable or a ``LinearOperator``;
    a numpy matrix is moved to ``x0``'s device.  A :class:`Block` ``x0``
    runs Block Lanczos (reference ``eigselector``,
    ``src/eigsolve/eigsolve.jl:238-283``) and needs no Hermitian probe.

    Differentiable in ``x0`` (zero gradient) and in the tensors the
    operator holds (a matrix, a :class:`ParametricOperator`'s ``params``,
    banded or ELL planes): the backward runs ``alg_rrule``, by default
    ``GMRES`` with the primal's ``tol``, ``krylovdim``, ``maxiter`` and
    ``orth`` (bordered systems per eigenpair); an ``Arnoldi`` ``alg_rrule``
    takes the Sylvester route.  A bare callable's adjoint, which the
    backward needs, is derived by ``with_adjoint_from``."""
    if isinstance(x0, Block) or isinstance(alg, BlockLanczos):
        if not isinstance(x0, Block):
            raise ValueError("BlockLanczos requires a Block starting value x0")
        if not isinstance(alg, BlockLanczos):
            kw = dict(tol=tol, krylovdim=krylovdim, maxiter=maxiter, orth=orth,
                      eager=eager, verbosity=verbosity)
            alg = BlockLanczos(**{k: v for k, v in kw.items() if v is not None})
        op = as_operator(A, device=device_of(x0.stacked))
        refuse_grad("eigsolve with a Block start (Block Lanczos)", op, x0.stacked)
        return eigsolve_blocklanczos(op, x0.stacked, howmany, which, alg, space)
    x0 = _default_x0(A, x0, space)
    op = as_operator(A, device=device_of(x0))
    alg = _select_alg(
        A, ishermitian, alg, tol=tol, krylovdim=krylovdim, maxiter=maxiter,
        orth=orth, eager=eager, verbosity=verbosity,
    )
    if isinstance(which, str) and which.upper() in ("LI", "SI"):
        if isinstance(alg, Lanczos):
            raise ValueError("which=LI/SI invalid for Hermitian problems")
        # real maps have conjugate-symmetric spectra: selecting by imaginary
        # part cannot separate a conjugate pair (reference requires a
        # conj-symmetric `by`, src/eigsolve/eigsolve.jl:209-236)
        try:
            pdt = probe_dtype(op, x0)
        except Exception:
            pdt = None
        if pdt is not None and not pdt.is_complex:
            raise ValueError(
                "which=LI/SI invalid for real linear maps (conjugate-symmetric "
                "spectrum) — reference src/eigsolve/eigsolve.jl:209-236"
            )
    if needs_grad(op, x0):
        from ..ad.eigsolve import eigsolve_vjp

        return eigsolve_vjp(howmany, which, alg, alg_rrule, space,
                            op.with_adjoint_from(x0), x0)
    return _eigsolve_impl(op, x0, howmany, which, alg, space)


def _arnoldi_alg(alg, kw):
    if alg is None:
        alg = Arnoldi(**{k: v for k, v in kw.items() if v is not None})
    return alg


def schursolve(
    A,
    x0: Optional[torch.Tensor] = None,
    howmany: int = 1,
    which="LM",
    alg: Optional[Arnoldi] = None,
    *,
    space: VectorSpace = STANDARD,
    **kw,
):
    """Partial Schur decomposition ``(T, vecs, vals, info)`` (reference
    ``schursolve``, ``src/eigsolve/arnoldi.jl:1-150``).  Keywords other than
    ``space`` are the fields of :class:`Arnoldi`."""
    x0 = _default_x0(A, x0, space)
    op = as_operator(A, device=device_of(x0))
    refuse_grad("schursolve", op, x0)
    return _schursolve_arnoldi(op, x0, howmany, which, _arnoldi_alg(alg, kw), space)


def realeigsolve(
    A,
    x0: Optional[torch.Tensor] = None,
    howmany: int = 1,
    which="LM",
    alg: Optional[Arnoldi] = None,
    *,
    imag_tol: Optional[float] = None,
    space: VectorSpace = STANDARD,
    **kw,
):
    """Eigsolve for real linear maps asserting real eigenvalues (reference
    ``realeigsolve``, ``src/eigsolve/arnoldi.jl:293-349``).

    Runs the fully REAL Arnoldi solver (real basis, real Schur form with 2x2
    blocks, real eigenvectors).  If a complex conjugate pair enters the
    wanted window the result is invalid and this raises, like the
    reference: ``max |imag|`` above ``imag_tol`` (default ``sqrt(eps)``)
    times ``max(1, max |vals|)``."""
    kw.pop("ishermitian", None)
    x0 = _default_x0(A, x0, space)
    op = as_operator(A, device=device_of(x0))
    refuse_grad("realeigsolve", op, x0)
    vals, vecs, info, maximag = realeigsolve_arnoldi(
        op, x0, howmany, which, _arnoldi_alg(alg, kw), space
    )
    tol = imag_tol
    if tol is None:
        tol = float(torch.finfo(vals.dtype).eps ** 0.5)
    scalemax = max(1.0, float(torch.max(torch.abs(vals))))
    if float(maximag) > tol * scalemax:
        raise ValueError(
            f"realeigsolve: requested eigenvalues are not real "
            f"(max |imag| = {float(maximag):.3e}); use eigsolve instead"
        )
    return vals, vecs, info
