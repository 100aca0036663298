"""Build the port's inputs from plain numpy arrays and tuples.

A Krylov solve has no weights: what two runs share is the operator's data,
the start vector and the algorithm settings.  These helpers take plain
numbers (e.g. a stencil's ``offsets``/``coeffs``, or
``dataclasses.asdict`` of an algorithm struct with ``orth`` given by name)
and return the port's objects on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .algorithms import (
    CG, GKL, GMRES, LSMR, MINRES, Arnoldi, BiArnoldi, BiCGStab, BlockLanczos, GolubYe, Lanczos,
)
from .factorizations.gkl import GKLState
from .factorizations.krylov import FusedScales, KrylovState, Lanczos3State
from .ops import orthonormal as on
from .ops.banded import BandedOperator
from .ops.block import Block
from .ops.operator import GridStencilOperator, MatrixOperator, StencilOperator, resolve_device
from .ops.sparse import ELLOperator

__all__ = [
    "stencil_from_arrays",
    "grid_stencil_from_arrays",
    "banded_from_arrays",
    "banded_batch_from_arrays",
    "ell_from_arrays",
    "matrix_from_numpy",
    "matrices_from_numpy",
    "vector_from_numpy",
    "tree_from_numpy",
    "block_from_numpy",
    "eig_problem_from_numpy",
    "lanczos_from_dict",
    "arnoldi_from_dict",
    "biarnoldi_from_dict",
    "cg_from_dict",
    "gmres_from_dict",
    "minres_from_dict",
    "bicgstab_from_dict",
    "gkl_from_dict",
    "lsmr_from_dict",
    "golubye_from_dict",
    "blocklanczos_from_dict",
    "krylov_state_from_numpy",
    "lanczos3_state_from_numpy",
    "gkl_state_from_numpy",
    "fused_scales_from_numpy",
]

_ORTH_BY_NAME = {
    **{name: getattr(on, name) for name in ("cgs", "mgs", "cgs2", "mgs2", "cgsir", "mgsir")},
    **{
        cls.__name__: cls()
        for cls in (
            on.ClassicalGramSchmidt, on.ModifiedGramSchmidt, on.ClassicalGramSchmidt2,
            on.ModifiedGramSchmidt2, on.ClassicalGramSchmidtIR, on.ModifiedGramSchmidtIR,
        )
    },
}


def stencil_from_arrays(offsets, coeffs, device="cuda") -> StencilOperator:
    """A :class:`StencilOperator` from its offsets and coefficients."""
    resolve_device(device)
    return StencilOperator(tuple(int(d) for d in offsets), tuple(coeffs))


def grid_stencil_from_arrays(grid, offsets2, coeffs, device="cuda") -> GridStencilOperator:
    """A :class:`GridStencilOperator` from its grid, ``(dy, dx)`` offsets and
    coefficients."""
    resolve_device(device)
    return GridStencilOperator(tuple(grid), tuple(tuple(o) for o in offsets2), tuple(coeffs))


def banded_from_arrays(offsets, diags, n, adj_offsets=None, adj_diags=None,
                       device="cuda") -> BandedOperator:
    """A :class:`BandedOperator` from a banded operator's offsets and
    ``(nδ, R, 128)`` diagonal planes (e.g. the numpy planes of the JAX
    package's ``BandedOperator``), with its adjoint when ``adj_offsets`` and
    ``adj_diags`` are given."""
    dev = resolve_device(device)
    adj = None
    if adj_offsets is not None:
        adj = BandedOperator(adj_offsets, torch.as_tensor(np.array(adj_diags), device=dev), n)
    return BandedOperator(offsets, torch.as_tensor(np.array(diags), device=dev), n, adj=adj)


def banded_batch_from_arrays(offsets, diags, n, device="cuda", adj_offsets=None,
                             adj_diags=None) -> list:
    """One :class:`BandedOperator` per plane set of the stack ``diags``
    (``(P, nδ, R, 128)``, e.g. the numpy planes of a JAX ``BandedOperator``
    batched under ``jax.vmap``), all with ``offsets``: the batched operator
    of ``solvers/batched_linsolve.py`` (``in_dims`` 0), whose equal offsets
    let it apply every problem's planes in one launch.  With ``adj_offsets``
    and the stack ``adj_diags`` (``(P, nδ', R, 128)``, the batched
    operator's ``adj.diags``) each operator has its adjoint, as the batched
    ``svdsolve``/``lssolve`` need it."""
    diags = np.asarray(diags)
    adjs = [None] * len(diags) if adj_offsets is None else np.asarray(adj_diags)
    if len(adjs) != len(diags):
        raise ValueError(f"{len(adjs)} adjoint plane sets for {len(diags)} operators")
    return [banded_from_arrays(offsets, d, n, adj_offsets, a, device=device)
            for d, a in zip(diags, adjs)]


def ell_from_arrays(cols, vals, n_cols, adj_cols=None, adj_vals=None,
                    device="cuda") -> ELLOperator:
    """An :class:`ELLOperator` from an ELL operator's ``(n_rows, width)``
    column-index and value planes (e.g. the numpy planes of the JAX
    package's ``ELLOperator``), with its adjoint when ``adj_cols`` and
    ``adj_vals`` are given."""
    dev = resolve_device(device)
    cols = torch.as_tensor(np.array(cols), device=dev)
    adj = None
    if adj_cols is not None:
        adj = ELLOperator(torch.as_tensor(np.array(adj_cols), device=dev),
                          torch.as_tensor(np.array(adj_vals), device=dev), cols.shape[0])
    return ELLOperator(cols, torch.as_tensor(np.array(vals), device=dev), n_cols, adj=adj)


def matrix_from_numpy(A, device="cuda") -> MatrixOperator:
    """A :class:`MatrixOperator` holding ``A`` on ``device``."""
    return MatrixOperator(torch.as_tensor(np.asarray(A), device=resolve_device(device)))


def matrices_from_numpy(As, device="cuda") -> list:
    """One :class:`MatrixOperator` per matrix of the stack ``As`` (``(P, n,
    n)``): the batched operator of ``solvers/batched.py`` (``in_dims`` 0)."""
    return [matrix_from_numpy(A, device) for A in np.asarray(As)]


def vector_from_numpy(x, device="cuda") -> torch.Tensor:
    """``x`` as a tensor on ``device``, same shape and dtype."""
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def tree_from_numpy(tree, device="cuda"):
    """A pytree vector (or a :class:`ParametricOperator`'s ``params``) on
    ``device``: every numpy array of the tuple, list or dict ``tree``
    (nested) becomes a tensor of the same shape and dtype.  A JAX pytree
    passes through ``jax.tree_util.tree_map(np.asarray, ...)`` first."""
    import numbers

    dev = resolve_device(device)

    def leaf(x):
        if isinstance(x, (np.ndarray, np.generic, numbers.Number)):
            return torch.as_tensor(np.asarray(x), device=dev)
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(leaf(v) for v in x)
        raise TypeError(f"cannot make a tensor of {type(x).__name__}")

    return leaf(tree)


def block_from_numpy(vectors, device="cuda") -> Block:
    """A :class:`Block` of the numpy vectors ``vectors`` on ``device``."""
    return Block([vector_from_numpy(v, device) for v in vectors])


def eig_problem_from_numpy(A, x0, device="cuda"):
    """``(operator, x0)`` of an eigenproblem on ``device``: ``A`` is a dense
    numpy matrix (a :class:`MatrixOperator`) or a stencil's
    ``(offsets, coeffs)`` pair (a :class:`StencilOperator`); ``x0`` keeps
    its shape and dtype."""
    if isinstance(A, tuple):
        op = stencil_from_arrays(*A, device=device)
    else:
        op = matrix_from_numpy(A, device)
    return op, vector_from_numpy(x0, device)


def _alg_from_dict(cls, fields: dict):
    """An algorithm struct from its fields; ``orth`` may be given by name."""
    fields = dict(fields)
    extra = set(fields) - {f.name for f in dataclasses.fields(cls)}
    if extra:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(extra)}")
    orth = fields.get("orth")
    if isinstance(orth, str):
        if orth not in _ORTH_BY_NAME:
            raise ValueError(f"unknown orthogonalizer {orth!r}")
        fields["orth"] = _ORTH_BY_NAME[orth]
    elif orth is not None and not isinstance(orth, on.Orthogonalizer):
        raise ValueError(
            "orth must be an orthogonalizer name such as 'cgs2' or an "
            f"Orthogonalizer, got {orth!r}"
        )
    return cls(**fields)


def lanczos_from_dict(fields: dict) -> Lanczos:
    """A :class:`Lanczos` from its fields.  ``orth`` is a name (``"cgs2"``,
    ``"ClassicalGramSchmidt2"``, ...; the IR variants with their default
    ``eta``/``maxiter``) or an orthogonalizer of this package."""
    return _alg_from_dict(Lanczos, fields)


def arnoldi_from_dict(fields: dict) -> Arnoldi:
    """An :class:`Arnoldi` from its fields; ``orth`` as in :func:`lanczos_from_dict`."""
    return _alg_from_dict(Arnoldi, fields)


def biarnoldi_from_dict(fields: dict) -> BiArnoldi:
    """A :class:`BiArnoldi` from its fields; ``orth`` as in :func:`lanczos_from_dict`."""
    return _alg_from_dict(BiArnoldi, fields)


def cg_from_dict(fields: dict) -> CG:
    """A :class:`CG` from its fields (``maxiter``, ``tol``, ``verbosity``)."""
    return _alg_from_dict(CG, fields)


def gmres_from_dict(fields: dict) -> GMRES:
    """A :class:`GMRES` from its fields; ``orth`` as in :func:`lanczos_from_dict`."""
    return _alg_from_dict(GMRES, fields)


def minres_from_dict(fields: dict) -> MINRES:
    """A :class:`MINRES` from its fields (``maxiter``, ``tol``, ``verbosity``)."""
    return _alg_from_dict(MINRES, fields)


def bicgstab_from_dict(fields: dict) -> BiCGStab:
    """A :class:`BiCGStab` from its fields (``maxiter``, ``tol``, ``verbosity``)."""
    return _alg_from_dict(BiCGStab, fields)


def gkl_from_dict(fields: dict) -> GKL:
    """A :class:`GKL` from its fields; ``orth`` as in :func:`lanczos_from_dict`."""
    return _alg_from_dict(GKL, fields)


def lsmr_from_dict(fields: dict) -> LSMR:
    """An :class:`LSMR` from its fields; ``orth`` as in :func:`lanczos_from_dict`."""
    return _alg_from_dict(LSMR, fields)


def golubye_from_dict(fields: dict) -> GolubYe:
    """A :class:`GolubYe` from its fields; ``orth`` as in :func:`lanczos_from_dict`."""
    return _alg_from_dict(GolubYe, fields)


def blocklanczos_from_dict(fields: dict) -> BlockLanczos:
    """A :class:`BlockLanczos` from its fields (``qr_tol`` among them);
    ``orth`` as in :func:`lanczos_from_dict`."""
    return _alg_from_dict(BlockLanczos, fields)


def krylov_state_from_numpy(V, H, k, beta, device="cuda") -> KrylovState:
    """A :class:`KrylovState` from the arrays of a factorization (e.g. the
    fields of the JAX package's state): basis ``V``, projected matrix ``H``,
    size ``k`` and residual norm ``beta``.  The arrays are copied, since the
    port's expansions write into them."""
    dev = resolve_device(device)
    return KrylovState(_copied(V, dev), _copied(H, dev), int(k), _copied(beta, dev))


def lanczos3_state_from_numpy(v_prev, v_cur, H, k, beta, device="cuda") -> Lanczos3State:
    """A 3-term :class:`Lanczos3State` from the arrays of a ``keepvecs=False``
    factorization: the rolling pair ``v_prev``/``v_cur``, projected matrix
    ``H``, size ``k`` and residual norm ``beta`` (copied, as in
    :func:`krylov_state_from_numpy`)."""
    dev = resolve_device(device)
    return Lanczos3State(_copied(v_prev, dev), _copied(v_cur, dev), _copied(H, dev), int(k),
                         _copied(beta, dev))


def gkl_state_from_numpy(U, V, B, k, beta, device="cuda") -> GKLState:
    """A :class:`GKLState` from the arrays of a factorization: codomain basis
    ``U``, domain basis ``V``, projected matrix ``B``, size ``k`` and
    residual norm ``beta`` (copied, as in :func:`krylov_state_from_numpy`)."""
    dev = resolve_device(device)
    return GKLState(_copied(U, dev), _copied(V, dev), _copied(B, dev), int(k), _copied(beta, dev))


def fused_scales_from_numpy(L, s, Hs, M, device="cuda") -> FusedScales:
    """The fused expansion's :class:`FusedScales` (float32) from its four
    arrays; the GKL solver carries one such bundle per basis."""
    dev = resolve_device(device)
    return FusedScales(*(_copied(a, dev).to(torch.float32) for a in (L, s, Hs, M)))


def _copied(a, dev) -> torch.Tensor:
    return torch.tensor(np.array(a), device=dev)
