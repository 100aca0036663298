"""Gauge-sensitivity warnings of the pullbacks (counterpart of
``krylovkit_tpu/ad/gauge.py``).

The reference warns when eigenvector or singular-vector cotangents have
components along the gauge orbit (the phase freedom of each vector), which
the pullback formulas project out: a silent projection can hide a loss that
depends on the arbitrary phase (reference
``ext/KrylovKitChainRulesCoreExt/eigsolve.jl:150-156, 207-213, 334-341`` and
``svdsolve.jl:129-133, 185-190``).  The pullbacks run on the host, so the
check is a host comparison; the message is printed and also goes through
``warnings.warn``, so ``pytest.warns`` sees it.
"""

from __future__ import annotations

import warnings

from ..info import WARN

__all__ = ["warn_gauge_eager"]


def warn_gauge_eager(gauge, tol: float, verbosity: int, msg: str) -> None:
    """Warn when the gauge magnitude ``gauge`` (a 0-d tensor or a number)
    exceeds ``tol`` and ``verbosity >= WARN`` (the reference's
    ``alg_rrule.verbosity >= WARN``).  Reads ``gauge`` from the device only
    when the verbosity asks for the message."""
    if verbosity < WARN:
        return
    g = float(gauge)
    if g > float(tol):
        text = msg.format(gauge=g)
        print(text)
        warnings.warn(text, stacklevel=2)
