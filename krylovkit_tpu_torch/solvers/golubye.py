"""Generalized Hermitian eigensolver: Golub-Ye inverse-free Krylov
(counterpart of ``krylovkit_tpu/solvers/golubye.py``; reference
``src/eigsolve/golubye.jl``).

Lanczos on the shifted operator ``A − ρ·B`` around the current Rayleigh
quotient ``ρ = ⟨x, Ax⟩/⟨x, Bx⟩``, with the previous outer iterate appended
to the search space (LOCG correction, ``:62-76``), the converged Ritz
vectors re-appended every cycle (deflation, ``:77-91``), and the projected
pencil solved as a dense generalized Hermitian problem
(``dense.geneigh_active``).  As in the JAX package, stacked ``AV``/``BV``
bases beside ``V`` make the pencil two Gram products and the Ritz data
basis products, with no further operator applies.  Vectors may be pytrees
(``ops/vector.py``; the bases work leaf by leaf), and on a sharded space
(``psum_axis``) every reduction, the Gram matrices included, is all-reduced,
so every rank solves the same small pencil.

The JAX package's ``while_loop``\\ s are host loops over host ints here,
reading ``β`` per step and ``nconv`` per cycle; the bases are updated in
place.  Every operator apply goes through the operators (the banded
kernel for a ``BandedOperator``); the orthonormalizations are the unfused
sweeps of ``ops/orthonormal.py`` (the projection kernels with
``ops.basis.use_pallas_projections`` on).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import dense
from ..ad._common import refuse_grad
from ..algorithms import GolubYe
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ops.operator import LinearOperator, as_generalized_pair, concrete_start, probe_dtype
from ..ops.vector import STANDARD, VectorSpace, astype, device_of, rounded, scale, tree_map

__all__ = ["geneigsolve", "geneigsolve_golubye"]


def _shifted(av, shift, bv):
    """``A v − ρ·B v``, leaf by leaf."""
    return tree_map(lambda la, lb: la - shift * lb, av, bv)


def _append(op_a, op_b, V, AV, BV, k: int, w, orth, space, numops: int):
    """Orthonormalize ``w`` against ``V[:k]`` and append it with its ``A``
    and ``B`` images at row ``k`` (in place); nothing is appended if the
    orthogonalized vector vanishes, but both operators are applied and
    counted either way, as in the JAX package.  Returns ``(k, numops)``."""
    v, beta, _ = on.orthonormalize(w, V, k, orth, space)
    av = op_a(v)
    bv = op_b(v)
    if float(beta) > 0:
        for basis, vec in ((V, v), (AV, av), (BV, bv)):
            bs.set(basis, k, vec)
        k += 1
    return k, numops + 1


def _ritz(V, AV, BV, k: int, howmany: int, which, tol: float, space: VectorSpace, cdt):
    """The projected pencil on the first ``k`` rows of the bases and its
    Ritz data, products of the bases with no applies: ``(nconv, rhos,
    betas, Rv, Rav, Rbv, Rres)``."""
    hm1 = howmany + 1
    dev = device_of(V)
    idx = torch.arange(bs.capacity(V), device=dev)
    D, Z, valid = dense.geneigh_active(bs.gram(V, AV, space), bs.gram(V, BV, space), k)
    perm = dense.sort_perm(D.to(cdt), valid, which)
    Z = Z[:, perm]
    Zm = torch.where((idx[:, None] < k) & (idx[None, :] < hm1), Z.to(cdt),
                     torch.zeros((), dtype=cdt, device=dev))
    Rv, Rav, Rbv = bs.transform(V, Zm), bs.transform(AV, Zm), bs.transform(BV, Zm)
    num = torch.real(bs.batch_inner(Rv, Rav, space))
    den = torch.real(bs.batch_inner(Rv, Rbv, space))
    rhos = num / torch.where(torch.abs(den) > 0, den, torch.ones_like(den))
    Rres = tree_map(lambda la, lb: la - rhos.reshape((-1,) + (1,) * (la.ndim - 1))
                    .to(la.dtype) * lb, Rav, Rbv)
    betas = torch.sqrt(torch.clamp(torch.real(bs.batch_inner(Rres, Rres, space)), min=0))
    znorm = torch.sqrt(torch.sum(torch.abs(Zm) ** 2, dim=0))
    flags = betas[:howmany] <= tol * torch.clamp(znorm[:howmany], min=1e-30)
    nconv = int(torch.sum(torch.cumprod(flags.to(torch.int64), 0)))
    return nconv, rhos, betas, Rv, Rav, Rbv, Rres


def _restart(V, AV, BV, ritz, rhos, i0: int, space: VectorSpace, cdt):
    """Restart from Ritz vector ``i0`` (the first unconverged one), only
    row 0 of the bases set (in place).  ``ritz`` is ``(Rv, Rav, Rbv,
    Rres)``.  Returns ``(vold, rho, w)``: the previous outer iterate, the
    new shift and the normalized residual still to orthonormalize."""
    Rv, Rav, Rbv, Rres = ritz
    nrm = space.norm(bs.get(Rv, i0))
    inv = (1 / torch.where(nrm > 0, nrm, torch.ones_like(nrm))).to(cdt)
    vold = tree_map(torch.clone, bs.get(V, 0))
    for B_, R_ in ((V, Rv), (AV, Rav), (BV, Rbv)):
        tree_map(torch.Tensor.zero_, B_)
        bs.set(B_, 0, scale(bs.get(R_, i0), inv))
    return vold, rhos[i0], scale(bs.get(Rres, i0), inv)


def geneigsolve_golubye(opA: LinearOperator, opB: Optional[LinearOperator], x0,
                        howmany: int, which, alg: GolubYe, space: VectorSpace = STANDARD):
    """Returns ``(vals, vecs, info)`` for ``A x = λ B x`` with Hermitian
    ``A`` and Hermitian positive definite ``B`` (``None``: the identity),
    on ``x0``'s device."""
    m = alg.krylovdim
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}")
    hm1 = howmany + 1
    mcap = m + hm1 + 2  # the Lanczos space, x_old and the deflation vectors

    op_a = opA.normal
    op_b = opB.normal if opB is not None else (lambda x: x)
    cdt = probe_dtype(opA, x0)
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)

    def inv_norm(x):
        nrm = space.norm(x)
        return (1 / torch.where(nrm > 0, nrm, torch.ones_like(nrm))).to(cdt)

    x0 = astype(x0, cdt)
    v0 = scale(x0, inv_norm(x0))
    av0 = op_a(v0)
    bv0 = op_b(v0)
    rho = torch.real(space.inner(v0, av0)) / torch.real(space.inner(v0, bv0))
    V, AV, BV = bs.alloc(v0, mcap), bs.alloc(av0, mcap), bs.alloc(bv0, mcap)
    for basis, vec in ((V, v0), (AV, av0), (BV, bv0)):
        bs.set(basis, 0, vec)
    # residual direction orthogonal to v0
    vres, beta, _ = on.orthonormalize(_shifted(av0, rho.to(cdt), bv0), V, 1, alg.orth, space)
    vold = v0
    cvecs = None
    k, nconv, numiter, numops = 1, 0, 1, 1

    while True:
        # one Lanczos cycle on A − ρB, ρ frozen for the cycle
        shift = rho.to(cdt)
        while k < m - nconv and float(beta) > tol:
            bs.set(V, k, vres)
            av = op_a(vres)
            bv = op_b(vres)
            bs.set(AV, k, av)
            bs.set(BV, k, bv)
            vres, beta, _ = on.orthonormalize(_shifted(av, shift, bv), V, k + 1, alg.orth, space)
            k += 1
            numops += 1

        # the LOCG correction (from the second cycle) and the converged vectors
        if numiter > 1:
            k, numops = _append(op_a, op_b, V, AV, BV, k, vold, alg.orth, space, numops)
        for i in range(nconv):
            k, numops = _append(op_a, op_b, V, AV, BV, k, bs.get(cvecs, i), alg.orth, space,
                                numops)

        # projected pencil and Ritz data: products of the bases, no applies
        nconv, rhos, betas, Rv, Rav, Rbv, Rres = _ritz(V, AV, BV, k, howmany, which, tol,
                                                      space, cdt)
        if nconv >= howmany or numiter >= alg.maxiter:
            break

        vold, rho, w = _restart(V, AV, BV, (Rv, Rav, Rbv, Rres), rhos, min(nconv, hm1 - 1),
                                space, cdt)
        vres, beta, _ = on.orthonormalize(w, V, 1, alg.orth, space)
        cvecs = bs.prefix(Rv, howmany)
        k = 1
        numiter += 1

    nconv_out = min(nconv, howmany)
    log_if(
        alg.verbosity, STARTSTOP,
        "GolubYe geneigsolve finished after {it} iterations: {nc} values "
        "converged, normres = {nr}",
        it=numiter, nc=nconv_out, nr=betas[:howmany],
    )
    warn_if(
        alg.verbosity, nconv_out < howmany,
        "GolubYe geneigsolve stopped without convergence: {nc} of "
        f"{howmany}" + " values converged",
        nc=nconv_out,
    )
    info = ConvergenceInfo(
        converged=nconv_out,
        residual=tree_map(torch.clone, bs.prefix(Rres, howmany)),
        normres=betas[:howmany],
        numiter=numiter,
        numops=numops,
    )
    return rhos[:howmany], tree_map(torch.clone, bs.prefix(Rv, howmany)), info


def geneigsolve(AB, x0=None, howmany: int = 1, which="SR", *,
                alg: Optional[GolubYe] = None, space: VectorSpace = STANDARD,
                tol: Optional[float] = None, krylovdim: Optional[int] = None,
                maxiter: Optional[int] = None, orth=None, verbosity: Optional[int] = None):
    """Extremal eigenvalues of the pencil ``(A, B)``: ``A x = λ B x``.

    ``AB`` is ``(A, B)`` (matrices, callables or operators; ``B=None`` is
    the identity) or a bare ``A``, the reference's ``genapply`` encoding
    (``src/apply.jl:22-23``).  ``A`` must be Hermitian, ``B`` Hermitian
    positive definite.  ``x0`` is a tensor or a pytree of them; the solve
    runs on its device, where numpy matrices are moved.  Reference:
    ``geneigsolve`` (``src/eigsolve/geneigsolve.jl``), driver GolubYe."""
    if x0 is None:
        A0 = AB[0] if isinstance(AB, tuple) else AB
        if isinstance(A0, (np.ndarray, torch.Tensor)) and A0.ndim == 2:
            x0 = concrete_start(A0)
        else:
            raise ValueError("x0 is required unless A is a concrete matrix")
    opA, opB = as_generalized_pair(AB, device=device_of(x0))
    refuse_grad("geneigsolve", opA, x0)
    refuse_grad("geneigsolve", opB, x0)
    w = which.upper() if isinstance(which, str) else which
    if isinstance(w, str) and w in ("LI", "SI"):
        raise ValueError("which=LI/SI invalid for Hermitian pencils (real spectrum)")
    if alg is None:
        kw = dict(tol=tol, krylovdim=krylovdim, maxiter=maxiter, orth=orth, verbosity=verbosity)
        alg = GolubYe(**{k: v for k, v in kw.items() if v is not None})
    elif tol is not None and alg.tol != tol:
        alg = dataclasses.replace(alg, tol=tol)
    return geneigsolve_golubye(opA, opB, x0, howmany, which, alg, space)
