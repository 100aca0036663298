"""ELLPACK sparse operators (counterpart of ``krylovkit_tpu/ops/sparse.py``).

Every row is padded to the same number of stored entries, held as
``(n_rows, width)`` column-index (int32) and value planes; a padding slot
points at column 0 with value 0.  The apply is one gather and one
multiply-reduce in plain PyTorch on every device: the JAX package has no
kernel for it (``jnp.take`` plus a sum).  Vectors are 1-D, of length
``n_cols``.  A banded-like square ELL operator converts to the banded
kernel's layout with ``ops.banded.ell_to_banded``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .operator import LinearOperator, resolve_device

__all__ = ["ELLOperator", "from_coo", "from_dense"]


@dataclasses.dataclass(frozen=True)
class ELLOperator(LinearOperator):
    """ELLPACK operator ``y[i] = Σ_s vals[i, s]·x[cols[i, s]]``; ``adj`` is
    ``Aᴴ`` as a second ELL operator, built at construction (or ``None``)."""

    cols: torch.Tensor = None
    vals: torch.Tensor = None
    n_cols: int = 0
    adj: Optional["ELLOperator"] = None

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, n_cols: int, adj=None):
        if cols.shape != vals.shape or cols.ndim != 2 or cols.device != vals.device:
            raise ValueError(f"cols {tuple(cols.shape)} and vals {tuple(vals.shape)} must be "
                             "(n_rows, width) planes on one device")
        object.__setattr__(self, "cols", cols)
        object.__setattr__(self, "vals", vals)
        object.__setattr__(self, "n_cols", int(n_cols))
        object.__setattr__(self, "adj", adj)
        object.__setattr__(self, "normal", self._matvec)
        object.__setattr__(self, "adjoint", adj._matvec if adj is not None else None)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.cols.shape[0], self.n_cols)

    def tensors(self) -> tuple:
        """The values, then the adjoint's values (the floating leaves of the
        JAX package's pytree registration)."""
        return (self.vals,) + ((self.adj.vals,) if self.adj is not None else ())

    def with_tensors(self, tensors, plain: bool = False) -> "ELLOperator":
        adj = None
        if self.adj is not None:
            adj = ELLOperator(self.adj.cols, tensors[1], self.adj.n_cols)
        return ELLOperator(self.cols, tensors[0], self.n_cols, adj=adj)

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "meta":
            # a dtype probe: no planes are read, wherever they lie
            dt = torch.promote_types(self.vals.dtype, x.dtype)
            return torch.empty(self.cols.shape[0], dtype=dt, device="meta")
        g = torch.index_select(x.reshape(-1), 0, self.cols.reshape(-1)).reshape(self.cols.shape)
        return torch.sum(self.vals * g, dim=1)


def _coo_to_ell(rows, cols, vals, n_rows, n_cols):
    """COO triplets → ``(cols, vals)`` ELL planes (int32 columns): the
    entries of a row in ascending column order (duplicates kept, in their
    input order), padding slots column 0 and value 0.  Vectorized: an
    entry's slot is its rank within its row after a stable sort."""
    rows = np.asarray(rows)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], np.asarray(cols)[order], np.asarray(vals)[order]
    counts = np.bincount(rows, minlength=n_rows)
    width = int(counts.max()) if len(counts) else 0
    ell_cols = np.zeros((n_rows, max(width, 1)), np.int32)
    ell_vals = np.zeros((n_rows, max(width, 1)), vals.dtype)
    starts = np.cumsum(counts) - counts
    slot = np.arange(rows.size) - starts[rows]
    ell_cols[rows, slot] = cols
    ell_vals[rows, slot] = vals
    return ell_cols, ell_vals


def from_coo(rows, cols, vals, shape: Tuple[int, int], with_adjoint: bool = True,
             device="cuda") -> ELLOperator:
    """An :class:`ELLOperator` on ``device`` from COO triplets (packed on
    the host); the values keep ``vals``' dtype."""
    dev = resolve_device(device)
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    n_rows, n_cols = shape
    ec, ev = _coo_to_ell(rows, cols, vals, n_rows, n_cols)
    adj = None
    if with_adjoint:
        ac, av = _coo_to_ell(cols, rows, np.conj(vals), n_cols, n_rows)
        adj = ELLOperator(torch.as_tensor(ac, device=dev), torch.as_tensor(av, device=dev), n_rows)
    return ELLOperator(torch.as_tensor(ec, device=dev), torch.as_tensor(ev, device=dev), n_cols,
                       adj=adj)


def from_dense(A, tol: float = 0.0, with_adjoint: bool = True, device="cuda") -> ELLOperator:
    """An :class:`ELLOperator` of the entries of the matrix ``A`` with
    ``|a| > tol``."""
    A = np.asarray(A)
    rows, cols = np.nonzero(np.abs(A) > tol)
    return from_coo(rows, cols, A[rows, cols], A.shape, with_adjoint, device=device)
