"""ConvergenceInfo and verbosity levels (counterpart of ``krylovkit_tpu/info.py``).

The JAX package prints from inside compiled programs; here the solver loop
runs on the host, so ``log_if``/``warn_if`` are plain host prints.  The
message texts are the JAX package's, word for word.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = [
    "ConvergenceInfo",
    "SILENT",
    "WARN",
    "STARTSTOP",
    "EACHITERATION",
    "log_if",
    "warn_if",
]

# Verbosity levels (reference src/KrylovKit.jl:158-162)
SILENT = 0
WARN = 1
STARTSTOP = 2
EACHITERATION = 3


def _host(v):
    """Tensors print as their numpy values, as ``jax.debug.print`` shows arrays."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.ndim == 0 else v.numpy()
    return v


def log_if(verbosity: int, level: int, fmt: str, **kw):
    """Print ``fmt`` when ``verbosity >= level`` (reference ``@info``)."""
    if verbosity >= level:
        print(fmt.format(**{k: _host(v) for k, v in kw.items()}))


def _per_problem(v) -> bool:
    return isinstance(v, (list, tuple)) or (isinstance(v, torch.Tensor) and v.ndim >= 1)


def warn_if(verbosity: int, cond, fmt: str, **kw):
    """Print ``fmt`` when ``cond`` holds and ``verbosity >= WARN``
    (reference ``@warn``).  ``cond`` is read on the host only when the
    verbosity asks for the message.

    A batched solve gives ``cond`` as a sequence (or 1-D tensor), one entry
    per problem: one line is printed per problem where it holds, in problem
    order, each with that problem's entry of every value given as a
    sequence, as the JAX package's ``warn_if`` prints under ``vmap``."""
    if verbosity < WARN:
        return
    if not _per_problem(cond):
        if bool(cond):
            print(fmt.format(**{k: _host(v) for k, v in kw.items()}))
        return
    for i, c in enumerate(cond):
        if bool(c):
            print(fmt.format(**{k: _host(v[i] if _per_problem(v) else v)
                                for k, v in kw.items()}))


class ConvergenceInfo(NamedTuple):
    """Result record of every solver (reference ``src/KrylovKit.jl:185-218``).

    Attributes:
      converged: number of converged solutions.
      residual: the residual vector(s), stacked along a leading axis.
      normres: norm(s) of the residual(s).
      numiter: number of (restart) iterations used.
      numops: number of operator applications.
    """

    converged: int
    residual: Any
    normres: torch.Tensor
    numiter: int
    numops: int

    def __repr__(self):
        # a batched solve's counts are (P,) tensors, printed as arrays
        return (
            f"ConvergenceInfo: {_host(self.converged)} converged value(s) after "
            f"{_host(self.numiter)} iteration(s) and {_host(self.numops)} "
            f"applications of the linear map; norms of residuals are "
            f"{_host(self.normres)!s}."
        )
