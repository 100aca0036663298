"""``linsolve`` front-end: keyword API and algorithm selection (counterpart of
``krylovkit_tpu/solvers/linsolve.py``; reference ``src/linsolve/linsolve.jl``).

Solves ``(a0 + a1·A) x = b`` and returns ``(x, info)`` on ``b``'s device.
The selector picks CG for Hermitian positive-definite combined operators,
MINRES for Hermitian indefinite ones and GMRES otherwise
(``src/linsolve/linsolve.jl:123-180``).  Tolerance resolution
``tol = max(atol, rtol·‖b‖)`` (``:130-132``).  ``reallinsolve`` restricts the
inner product to its real part, so R-linear maps on complex vectors can be
solved (``:250-258``).

When gradients are enabled and ``b``, ``x0``, a shift or a tensor the
operator holds requires grad, the solve goes through the differentiable
``ad.linsolve_vjp``, whose backward solves the adjoint system with
``alg_rrule`` (default ``alg``); a bare callable's adjoint is then derived
by ``with_adjoint_from``.  Otherwise the front-end calls
:func:`_linsolve_impl` directly.  ``b`` and ``x0`` may be pytree vectors
(``ops/vector.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..algorithms import CG, GMRES, MINRES, BiCGStab, KrylovDefaults
from ..ad._common import needs_grad
from ..ops.operator import as_operator
from ..ops.vector import (REAL, STANDARD, VectorSpace, device_of, scalartype,
                          tree_leaves, zerovector)
from .bicgstab import linsolve_bicgstab
from .cg import linsolve_cg
from .gmres import linsolve_gmres
from .minres import linsolve_minres

__all__ = ["linsolve", "reallinsolve"]


def _linsolve_impl(op, b, x0, a0, a1, alg, space):
    """Driver dispatch."""
    if isinstance(alg, CG):
        return linsolve_cg(op, b, x0, a0, a1, alg, space)
    if isinstance(alg, MINRES):
        return linsolve_minres(op, b, x0, a0, a1, alg, space)
    if isinstance(alg, BiCGStab):
        return linsolve_bicgstab(op, b, x0, a0, a1, alg, space)
    if isinstance(alg, GMRES):
        return linsolve_gmres(op, b, x0, a0, a1, alg, space)
    raise TypeError(f"unsupported linsolve algorithm {alg!r}")


def _host(a) -> np.ndarray:
    """A matrix or scalar (tensor, numpy or Python) as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _probe_matrix(A):
    """Hermiticity / positive-definiteness probe for concrete matrices
    (reference ``linselector`` matrix path, src/linsolve/linsolve.jl:152-180)."""
    An = _host(A)
    if An.ndim != 2 or An.shape[0] != An.shape[1]:
        return False, False
    herm = bool(
        np.allclose(An, An.conj().T, atol=1e-12 * max(1.0, float(np.max(np.abs(An)))))
    )
    posdef = False
    if herm:
        try:
            np.linalg.cholesky((An + An.conj().T) / 2)
            posdef = True
        except np.linalg.LinAlgError:
            posdef = False
    return herm, posdef


def _resolve_tol(b, atol, rtol, tol, space: VectorSpace = STANDARD):
    if tol is not None:
        return float(tol)
    atol = KrylovDefaults.tol if atol is None else atol
    rtol = KrylovDefaults.tol if rtol is None else rtol
    if rtol != 0:
        if space.psum_axis is not None:
            # b is this rank's block: ‖b‖ through the space, the same on every rank
            nb = float(space.norm(b))
        else:
            nb = float(np.sqrt(sum(float(np.sum(np.abs(_host(l)) ** 2)) for l in tree_leaves(b))))
        return max(float(atol), float(rtol) * nb)
    return float(atol)


def _select_alg(A, a0, a1, ishermitian, isposdef, alg, tol, **kw):
    if alg is not None:
        if tol is not None and getattr(alg, "tol", None) != tol:
            alg = dataclasses.replace(alg, tol=tol)
        return alg
    herm, posdef = (None, None)
    if ishermitian is None or (ishermitian and isposdef is None):
        if isinstance(A, (np.ndarray, torch.Tensor)):
            herm, posdef = _probe_matrix(A)
    ishermitian = herm if ishermitian is None else ishermitian
    isposdef = posdef if isposdef is None else isposdef
    # shift legality: CG/MINRES require a real shift keeping hermiticity
    a0h, a1h = _host(a0), _host(a1)
    real_shift = np.isrealobj(a0h) and np.isrealobj(a1h) and float(np.real(a1h)) > 0
    fields = {k: v for k, v in kw.items() if v is not None}
    if tol is not None:
        fields["tol"] = tol
    if ishermitian and real_shift and float(np.real(a0h)) >= 0 and isposdef:
        fields.pop("krylovdim", None)
        fields.pop("orth", None)
        return CG(**fields)
    if ishermitian and real_shift:
        fields.pop("krylovdim", None)
        fields.pop("orth", None)
        return MINRES(**fields)
    return GMRES(**fields)


def linsolve(
    A,
    b,
    x0=None,
    a0=0.0,
    a1=1.0,
    *,
    ishermitian: Optional[bool] = None,
    isposdef: Optional[bool] = None,
    alg=None,
    space: VectorSpace = STANDARD,
    atol: Optional[float] = None,
    rtol: Optional[float] = None,
    tol: Optional[float] = None,
    krylovdim: Optional[int] = None,
    maxiter: Optional[int] = None,
    orth=None,
    verbosity: Optional[int] = None,
    alg_rrule=None,
):
    """Solve ``(a0 + a1·A) x = b`` on ``b``'s device; returns ``(x, info)``.

    Reference: ``linsolve`` (``src/linsolve/linsolve.jl:1-122``).  ``A`` may
    be a matrix (tensor, or numpy array placed on ``b``'s device), a
    callable, an ``(f, fadjoint)`` tuple or a ``LinearOperator``; ``b`` is a
    tensor or a pytree of them.  ``x0`` defaults to the zero vector
    (reference ``:112-118``).  The shift scalars take ``b``'s type (complex
    if either shift is), so a Python float never widens a float32 solve.
    Differentiable in ``b``, ``a0``, ``a1`` and the tensors the operator
    holds (``x0`` gets a zero gradient): the backward is one solve of the
    adjoint system with ``alg_rrule`` (default ``alg``)."""
    dev = device_of(b)
    op = as_operator(A, device=dev)
    if x0 is None:
        x0 = zerovector(b)
    # an explicit algorithm object carries its own tol; only re-resolve when
    # the caller passed tolerance keywords (or no alg at all)
    if alg is not None and atol is None and rtol is None and tol is None:
        tolv = None
    else:
        tolv = _resolve_tol(b, atol, rtol, tol, space)
    alg = _select_alg(
        A, a0, a1, ishermitian, isposdef, alg, tolv,
        maxiter=maxiter, krylovdim=krylovdim, orth=orth, verbosity=verbosity,
    )
    cdt = scalartype(b)
    if any(np.iscomplexobj(_host(a)) for a in (a0, a1)):
        cdt = torch.promote_types(cdt, torch.complex64)
    a0 = torch.as_tensor(a0, dtype=cdt, device=dev)
    a1 = torch.as_tensor(a1, dtype=cdt, device=dev)
    if needs_grad(op, b, x0, a0, a1):
        from ..ad.linsolve import linsolve_vjp

        return linsolve_vjp(alg, alg_rrule or alg, space, op.with_adjoint_from(b), b, x0, a0, a1)
    return _linsolve_impl(op, b, x0, a0, a1, alg, space)


def reallinsolve(A, b, x0=None, a0=0.0, a1=1.0, **kw):
    """``linsolve`` over the *real* inner product: the complex vector space
    is treated as a real one, so ``A`` need only be R-linear (reference
    ``reallinsolve``, ``src/linsolve/linsolve.jl:250-258``)."""
    space = kw.pop("space", None)
    if space is None:
        space = REAL
    elif not space.real_inner:
        space = dataclasses.replace(space, real_inner=True)
    return linsolve(A, b, x0, a0, a1, space=space, **kw)
