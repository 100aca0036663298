"""``eigsolve`` front-end (counterpart of ``krylovkit_tpu/solvers/eigsolve.py``),
Lanczos branch only.

The ``eigselector`` picks Lanczos for Hermitian problems (``ishermitian=True``
or a concrete matrix that is Hermitian by a numerical probe) and Arnoldi
otherwise; Arnoldi, BlockLanczos and differentiation through the solve are
not ported yet and raise ``NotImplementedError``.  The solve runs on the
device of ``x0``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..algorithms import Arnoldi, BlockLanczos, Lanczos
from ..ops.operator import as_operator, resolve_device
from ..ops.vector import STANDARD, VectorSpace
from .lanczos import eigsolve_lanczos

__all__ = ["eigsolve", "eigsolve_vjp"]


def _is_concrete(A) -> bool:
    return isinstance(A, (np.ndarray, torch.Tensor))


def _probe_hermitian(A) -> bool:
    An = A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
    return An.shape[0] == An.shape[1] and bool(
        np.allclose(An, An.conj().T, atol=1e-12 * max(1.0, float(np.max(np.abs(An)))))
    )


def _default_x0(A, x0):
    if x0 is not None:
        # breakdown guard for concrete starts (reference raises on β₀ == 0,
        # src/factorizations/lanczos.jl:184)
        if float(torch.sum(torch.abs(x0) ** 2)) == 0.0:
            raise ValueError("starting vector x0 has zero norm")
        return x0
    if _is_concrete(A) and A.ndim == 2:
        n = A.shape[1]
        if isinstance(A, torch.Tensor):
            dt, dev = A.dtype, A.device
        else:
            dt, dev = torch.from_numpy(np.asarray(A)).dtype, resolve_device("cuda")
        x = np.random.default_rng(42).standard_normal(n)
        return torch.as_tensor(x, device=dev).to(dt.to_real()).to(dt)
    raise ValueError("x0 is required unless the operator is a concrete matrix")


def _select_alg(A, ishermitian, alg, **kw):
    """``eigselector`` (reference src/eigsolve/eigsolve.jl:238-283)."""
    if alg is not None:
        return alg
    if ishermitian is None:
        ishermitian = _probe_hermitian(A) if _is_concrete(A) else False
    cls = Lanczos if ishermitian else Arnoldi
    return cls(**{k: v for k, v in kw.items() if v is not None})


def eigsolve_vjp(*args, **kwargs):
    """Differentiation through ``eigsolve`` (the JAX package's custom VJP)."""
    raise NotImplementedError(
        "eigsolve_vjp is not ported yet (ROADMAP.md queue 1, item 11: AD as "
        "torch.autograd.Function)"
    )


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
):
    """Find ``howmany`` extremal eigenvalues of a Hermitian linear map.

    Returns ``(vals, vecs, info)``: ``vals`` of length ``howmany``, ``vecs``
    stacked along a leading axis, ``info`` a :class:`ConvergenceInfo`
    (reference ``eigsolve``, ``src/eigsolve/eigsolve.jl:1-185``).  ``A`` is
    a matrix (tensor or numpy array), a callable or a ``LinearOperator``;
    a numpy matrix is moved to ``x0``'s device."""
    if isinstance(alg, BlockLanczos):
        raise NotImplementedError(
            "BlockLanczos is not ported yet (ROADMAP.md queue 1, item 10)"
        )
    if (x0 is not None and x0.requires_grad) or (
        isinstance(A, torch.Tensor) and A.requires_grad
    ):
        eigsolve_vjp()
    x0 = _default_x0(A, x0)
    op = as_operator(A, device=x0.device)
    alg = _select_alg(
        A, ishermitian, alg, tol=tol, krylovdim=krylovdim, maxiter=maxiter,
        orth=orth, eager=eager, verbosity=verbosity,
    )
    if not isinstance(alg, Lanczos):
        raise NotImplementedError(
            f"{type(alg).__name__} eigsolve is not ported yet (ROADMAP.md queue 1, "
            "item 8: Arnoldi); pass ishermitian=True for a Hermitian map"
        )
    if isinstance(which, str) and which.upper() in ("LI", "SI"):
        raise ValueError("which=LI/SI invalid for Hermitian problems")
    return eigsolve_lanczos(op, x0, howmany, which, alg, space)
