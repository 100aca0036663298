"""Batched CG, MINRES and BiCGStab: ``P`` linear systems ``(a0 + a1·A_p)
x_p = b_p`` in one host loop (the counterpart of ``jax.vmap`` over the JAX
package's ``linsolve_cg``, ``linsolve_minres`` and ``linsolve_bicgstab``).

Each driver runs the recurrence of its one-problem driver (``cg.py``,
``minres.py``, ``bicgstab.py``) on ``(P, ...)`` stacks of vectors, with
every scalar of the recurrence a ``(P,)`` tensor, as under ``vmap``:

* each problem gives the counts (``numops``, ``numiter``, ``converged``) and
  the bits of its own one-problem solve: the elementwise updates are the
  one-problem operations row by row, each inner product is the one-problem
  reduction of its row (``ops/vector.py:inner_batched``), and the batched
  operator applies give each row the one-problem apply's bits (a stack of
  matrices applies as one batched product, equal to float rounding);
* the problems that step are a host list; their rows are gathered, stepped
  and written back into new stacks, so a stopped problem is frozen, as a
  vmapped ``while_loop`` keeps its old carry;
* the operator applies only to the rows that need it, as one stack
  (``batched.py:_Operators``): one batched K3 launch for a shared banded
  operator or a sequence of banded operators with equal offsets, one
  batched K4 launch for ``laplacian_1d_pallas``.  A step applies it once
  (CG, MINRES) or twice (BiCGStab: ``A p``, then ``A s`` and the half
  step's true residual in one stack); a true-residual check of a subset is
  one more launch;
* the host reads one list of the active problems' scalars a step (CG
  ``‖r‖``, MINRES ``(|η|, β)``; BiCGStab ``[|ρ|, |σ|, thr, ‖s‖]`` and then
  ``‖r‖``, as its one-problem driver reads them), and once more in a step
  where some problem verifies its true residual.

``in_dims = (op_dim, b_dim, x0_dim)`` as in
:func:`~.batched.linsolve_gmres_batched`; ``a0`` and ``a1`` are shared.  On
a sharded space (``solvers/batched.py``) each rank runs its batch row's
problems on its block of rows, and a step's inner products are one
all-reduce of the ``(p,)`` partials each, its applies one stack apply of
the shared sharded operator.  Pytree vectors are stacks of trees
(``solvers/batched.py``): every stack operation runs leaf by leaf and each
row's inner products are the one-problem tree inner, also on a sharded
space.  Each driver is differentiable as ``linsolve`` is (``alg_rrule``;
``ad/batched.py``: the ``P`` adjoint systems in one batched solve of
``alg_rrule``'s family), on a sharded space too.
"""

from __future__ import annotations

import functools

import torch

from ..algorithms import CG, MINRES, BiCGStab
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops.operator import apply_shifted_batched, probe_dtype
from ..ops.vector import (STANDARD, VectorSpace, add, astype, device_of, inner_batched,
                          norm_batched, rounded, scalartype, scale, tree_leaves, tree_map,
                          tree_row, tree_rows)
from .batched import _batch_size, _count, _differentiated, _in_dims, _Operators, _read

__all__ = ["linsolve_cg_batched", "linsolve_minres_batched", "linsolve_bicgstab_batched"]


def _sel(T, pos):
    """Rows ``pos`` (sorted, distinct) of the stack ``T`` (leaf by leaf);
    ``T`` itself when they are all of its rows."""
    if len(pos) == tree_leaves(T)[0].shape[0]:
        return T
    return tree_map(
        lambda l: l.index_select(0, torch.tensor(pos, dtype=torch.int64, device=l.device)), T)


def _put(T, pos, V):
    """``T`` with rows ``pos`` replaced by ``V``, as a new stack (``V``
    itself when they are all of its rows)."""
    if len(pos) == tree_leaves(T)[0].shape[0]:
        return V
    return tree_map(
        lambda l, v: l.index_copy(0, torch.tensor(pos, dtype=torch.int64, device=l.device), v),
        T, V)


def _col(s: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """A ``(p,)`` scalar per row, shaped to broadcast over the stack ``X``."""
    return s.reshape((-1,) + (1,) * (X.ndim - 1))


def _axpy(Y, X, s: torch.Tensor):
    """``add(Y, X, a=s)`` of each row, ``s`` a ``(p,)`` scalar per row,
    leaf by leaf."""
    return tree_map(lambda ly, lx: add(ly, lx, a=_col(s, lx)), Y, X)


def _scaled(X, s: torch.Tensor):
    """``scale(X, s)`` of each row, leaf by leaf."""
    return tree_map(lambda l: scale(l, _col(s, l)), X)


def _where(mask: torch.Tensor, a, b):
    """Row by row ``a`` where the ``(p,)`` ``mask`` holds, else ``b``."""
    return tree_map(lambda la, lb: torch.where(_col(mask, la), la, lb), a, b)


def _pick(half, a, b):
    """Row by row ``a`` where ``half`` holds, else ``b`` (either may be
    ``None`` when no row takes it)."""
    if all(half):
        return a
    if not any(half):
        return b
    return _where(torch.tensor(half, device=tree_leaves(a)[0].device), a, b)


class _Active:
    """The problems still stepping (``ps``, in problem order) and their
    state as compact stacks (``s``, by name), row ``i`` problem ``ps[i]``:
    a step runs on whole stacks, with no gather.  :meth:`retire` writes the
    rows of the problems that stop into the ``(P, ...)`` results and drops
    them, so a stopped problem is frozen."""

    def __init__(self, ps, state: dict):
        self.ps = list(ps)
        self.s = {k: _sel(v, self.ps) for k, v in state.items()}

    def retire(self, done, out: dict):
        dev = device_of(next(iter(out.values())))
        probs = torch.tensor([self.ps[i] for i in done], dtype=torch.int64, device=dev)
        for k, O in out.items():
            for lO, lS in zip(tree_leaves(O), tree_leaves(_sel(self.s[k], done))):
                lO.index_copy_(0, probs, lS)
        keep = [i for i in range(len(self.ps)) if i not in set(done)]
        self.s = {k: _sel(v, keep) for k, v in self.s.items()}
        self.ps = [self.ps[i] for i in keep]


class _Problem:
    """What every batched linear solve starts from: the problems' operators
    (``ops``), right-hand sides ``B`` and starts ``X0`` as ``(P, ...)``
    stacks, and the shifted apply of a set of problems' rows."""

    def __init__(self, name, op, b, x0, a0, a1, space, in_dims):
        op_dim, b_dim, x_dim = _in_dims(in_dims, ("op", "b", "x0"))
        self.P = _batch_size(_count(op, op_dim, "op", vector=False), _count(b, b_dim, "b"),
                             _count(x0, x_dim, "x0"))
        self.ops = _Operators(op, self.P, op_dim == 0)
        self.args = (b, x0, a0, a1, space, (op_dim, b_dim, x_dim))
        self.grad = _differentiated(name, [b, x0], self.ops.distinct(), (a0, a1), rule=True)
        P = self.P

        def expand(l):
            return l.expand((P,) + tuple(l.shape))

        self.B = b if b_dim == 0 else tree_map(expand, b)
        self.X0 = x0 if x_dim == 0 else tree_map(expand, x0)
        self.a0, self.a1 = a0, a1
        self.dev = device_of(b)
        self.every = list(range(P))

    def vjp(self, driver, alg, alg_rrule):
        """``driver`` on these problems through ``ad/batched.py``: its
        backward solves the adjoint systems with ``alg_rrule``."""
        from ..ad.batched import linsolve_batched_vjp

        return linsolve_batched_vjp(driver, self.ops.ops, *self.args[:4], alg, alg_rrule,
                                    *self.args[4:])

    def cdt(self) -> torch.dtype:
        """The problems' scalar type, as :func:`probe_dtype` gives it."""
        return functools.reduce(torch.promote_types,
                                [probe_dtype(o, tree_row(self.B, 0))
                                 for o in self.ops.distinct()])

    def shifted(self, ps, X):
        """``a0·X + a1·A_p X`` for the rows of ``X``, the vectors of the
        problems ``ps``: one batched apply."""
        return apply_shifted_batched(lambda Z: self.ops.apply_stack(Z, ps), X, self.a0, self.a1)

    def true_residual(self, ps, X, B):
        """``b_p − (a0·x_p + a1·A_p x_p)`` for the rows of ``X`` and ``B``."""
        return add(B, self.shifted(ps, X), a=-1)

    def finish(self, alg, fmt: str, X, R, normr, nr_host, tol, numiter, numops):
        """Each problem's log line (``fmt``), and ``(conv, (x, info))`` with
        ``(P,)`` counts."""
        conv = [int(v <= tol) for v in nr_host]
        for p in range(self.P):
            log_if(alg.verbosity, STARTSTOP, fmt, it=numiter[p], c=conv[p], nr=normr[p],
                   no=numops[p])
        return conv, (X, ConvergenceInfo(
            converged=torch.tensor(conv, dtype=torch.int64, device=self.dev),
            residual=R, normres=normr,
            numiter=torch.tensor(numiter, dtype=torch.int64, device=self.dev),
            numops=torch.tensor(numops, dtype=torch.int64, device=self.dev),
        ))


def linsolve_cg_batched(op, b, x0, a0, a1, alg: CG, space: VectorSpace = STANDARD, *,
                        in_dims=(None, 0, 0), alg_rrule=None):
    """Conjugate-gradient solves of ``P`` systems, each as
    :func:`~.cg.linsolve_cg` solves it, in one host loop (module
    docstring).  Returns ``(x (P, ...), info)`` with ``(P,)`` counts; a
    problem's ``x`` takes the type of its start and residual together."""
    pr = _Problem("linsolve_cg_batched", op, b, x0, a0, a1, space, in_dims)
    if pr.grad:
        return pr.vjp(linsolve_cg_batched, alg, alg_rrule)
    P = pr.P
    tol = rounded(alg.tol, scalartype(pr.B).to_real())
    R = pr.true_residual(pr.every, pr.X0, pr.B)
    X = tree_map(lambda l, r: l.to(torch.promote_types(l.dtype, r.dtype)).clone(), pr.X0, R)
    rho = torch.real(inner_batched(tree_rows(R), tree_rows(R), space))
    normr = torch.sqrt(rho)
    nr_host = _read([normr])[0]
    numiter, numops = [0] * P, [1] * P
    act = _Active([p for p in range(P) if not nr_host[p] <= tol],
                  {"x": X, "r": R, "p": R, "rho": rho, "b": pr.B})
    out = {"x": X, "r": tree_map(torch.clone, R), "normr": normr.clone()}
    while act.ps:
        s = act.s
        x, r, p, rho = s["x"], s["r"], s["p"], s["rho"]
        Ap = pr.shifted(act.ps, p)
        pAp = torch.real(inner_batched(tree_rows(p), tree_rows(Ap), space))
        alpha = rho / torch.where(pAp != 0, pAp, 1)
        x = _axpy(x, p, alpha)
        r = _axpy(r, Ap, -alpha)
        rho_new = torch.real(inner_batched(tree_rows(r), tree_rows(r), space))
        beta = rho_new / torch.where(rho != 0, rho, 1)
        p = _axpy(r, p, beta)
        rho = rho_new
        normr = torch.sqrt(rho)
        nrs = _read([normr])[0]
        for q in act.ps:
            numiter[q] += 1
            numops[q] += 1
        verify = [i for i, v in enumerate(nrs) if v <= tol]
        if verify:
            # hard true-residual check on apparent convergence (cg.jl:69-75):
            # restart those recurrences from the true residual
            rt = pr.true_residual([act.ps[i] for i in verify], _sel(x, verify),
                                  _sel(s["b"], verify))
            rho_t = torch.real(inner_batched(tree_rows(rt), tree_rows(rt), space))
            r, p, rho = _put(r, verify, rt), _put(p, verify, rt), _put(rho, verify, rho_t)
            normr = torch.sqrt(rho)
            for i, v in zip(verify, _read([_sel(normr, verify)])[0]):
                nrs[i] = v
                numops[act.ps[i]] += 1
        act.s = {"x": x, "r": r, "p": p, "rho": rho, "normr": normr, "b": s["b"]}
        for q, v in zip(act.ps, nrs):
            nr_host[q] = v
        done = [i for i, q in enumerate(act.ps) if nr_host[q] <= tol or numiter[q] >= alg.maxiter]
        if done:
            act.retire(done, out)
    X, R, normr = out["x"], out["r"], out["normr"]
    conv, out = pr.finish(
        alg, "CG linsolve finished after {it} iterations: converged = {c}, "
        "normres = {nr}, numops = {no}", X, R, normr, nr_host, tol, numiter, numops)
    warn_if(
        alg.verbosity, [c == 0 for c in conv],
        "CG linsolve stopped without converging after {it} iterations: "
        "normres = {nr}", it=numiter, nr=normr,
    )
    return out


def linsolve_minres_batched(op, b, x0, a0, a1, alg: MINRES, space: VectorSpace = STANDARD, *,
                            in_dims=(None, 0, 0), alg_rrule=None):
    """MINRES solves of ``P`` Hermitian systems, each as
    :func:`~.minres.linsolve_minres` solves it, in one host loop (module
    docstring).  Returns ``(x (P, ...), info)`` with ``(P,)`` counts; the
    final true residuals are one more batched apply of every problem."""
    pr = _Problem("linsolve_minres_batched", op, b, x0, a0, a1, space, in_dims)
    if pr.grad:
        return pr.vjp(linsolve_minres_batched, alg, alg_rrule)
    P, dev = pr.P, pr.dev
    cdt = pr.cdt()
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    eps = torch.finfo(rdt).eps

    X = tree_map(torch.clone, astype(pr.X0, cdt))
    R0 = astype(pr.true_residual(pr.every, X, pr.B), cdt)
    beta1 = norm_batched(tree_rows(R0), space)
    beta1_h = _read([beta1])[0]
    V = _scaled(R0, (1 / torch.where(beta1 > 0, beta1, 1)).to(cdt))
    zeros = tree_map(torch.zeros_like, V)
    one = torch.ones(P, dtype=rdt, device=dev)
    zero = torch.zeros(P, dtype=rdt, device=dev)
    nr_host = list(beta1_h)
    numiter, numops = [0] * P, [1] * P
    # β entering the first step is 0 (no v_0 term); η starts at β₁
    act = _Active([p for p in range(P) if not beta1_h[p] <= tol], {
        "x": X, "v": V, "v_prev": zeros, "d": zeros, "d_prev": zeros, "b": pr.B,
        "beta": zero, "eta": beta1, "c1": one, "s1": zero, "c2": one, "s2": zero,
    })
    out = {"x": X, "normr": beta1.clone()}
    while act.ps:
        s = act.s
        v, beta, eta, c1, s1, c2, s2 = (s[k] for k in ("v", "beta", "eta", "c1", "s1", "c2", "s2"))
        w = pr.shifted(act.ps, v)
        w = _axpy(w, s["v_prev"], -beta.to(cdt))
        alpha = torch.real(inner_batched(tree_rows(v), tree_rows(w), space))  # Hermitian → real
        w = _axpy(w, v, -alpha.to(cdt))
        beta_next = norm_batched(tree_rows(w), space)
        v_next = _scaled(w, (1 / torch.where(beta_next > 0, beta_next, 1)).to(cdt))

        # QR update: rotate the new T column (β_k, α_k, β_{k+1}) by G_{k-2}, G_{k-1}
        eps_k = s2 * beta
        t = c2 * beta
        delta = c1 * t + s1 * alpha
        gamma_hat = -s1 * t + c1 * alpha
        gamma = torch.sqrt(gamma_hat ** 2 + beta_next ** 2)
        safe_g = torch.where(gamma > 0, gamma, 1)
        c_new = torch.where(gamma > 0, gamma_hat / safe_g, torch.ones_like(gamma))
        s_new = torch.where(gamma > 0, beta_next / safe_g, torch.zeros_like(gamma))
        tau = c_new * eta
        eta_next = -s_new * eta

        # direction: d_k = (v_k − δ d_{k-1} − ε d_{k-2}) / γ
        dk = _axpy(_axpy(v, s["d"], -delta.to(cdt)), s["d_prev"], -eps_k.to(cdt))
        dk = _scaled(dk, (1 / safe_g).to(cdt))
        x = _axpy(s["x"], dk, tau.to(cdt))
        normr = torch.abs(eta_next)
        for q in act.ps:
            numiter[q] += 1
            numops[q] += 1
        nrs, bns = _read([normr, beta_next])
        verify = [i for i, nr in enumerate(nrs) if nr <= tol]
        if verify:
            # true-residual verification on apparent convergence
            rt = pr.true_residual([act.ps[i] for i in verify], _sel(x, verify),
                                  _sel(s["b"], verify))
            normr = _put(normr, verify, norm_batched(tree_rows(rt), space))
            for i, nr in zip(verify, _read([_sel(normr, verify)])[0]):
                nrs[i] = nr
                numops[act.ps[i]] += 1
        act.s = {"x": x, "v": v_next, "v_prev": v, "d": dk, "d_prev": s["d"], "b": s["b"],
                 "beta": beta_next, "eta": eta_next, "c1": c_new, "s1": s_new, "c2": c1,
                 "s2": s1, "normr": normr}
        done = []
        for i, (q, nr, bn) in enumerate(zip(act.ps, nrs, bns)):
            nr_host[q] = nr
            lucky = bn <= eps * beta1_h[q]  # invariant subspace
            if nr <= tol or numiter[q] >= alg.maxiter or lucky:
                done.append(i)
        if done:
            act.retire(done, out)
    X, normr = out["x"], out["normr"]
    conv, (x, info) = pr.finish(
        alg, "MINRES linsolve finished after {it} iterations: converged = {c}, "
        "normres = {nr}", X, None, normr, nr_host, tol, numiter, numops)
    warn_if(
        alg.verbosity, [c == 0 for c in conv],
        "MINRES linsolve stopped without converging after {it} iterations: "
        "normres = {nr}", it=numiter, nr=normr,
    )
    r_final = pr.true_residual(pr.every, X, pr.B)
    return x, info._replace(residual=r_final, numops=info.numops + 1)


def linsolve_bicgstab_batched(op, b, x0, a0, a1, alg: BiCGStab, space: VectorSpace = STANDARD,
                              *, in_dims=(None, 0, 0), alg_rrule=None):
    """BiCGStab solves of ``P`` systems, each as
    :func:`~.bicgstab.linsolve_bicgstab` solves it, in one host loop (module
    docstring): the shadow residual, the half and full steps and their
    verifications, and the breakdown test against ``eps²·‖r₀‖²`` per
    problem.  Returns ``(x (P, ...), info)`` with ``(P,)`` counts."""
    pr = _Problem("linsolve_bicgstab_batched", op, b, x0, a0, a1, space, in_dims)
    if pr.grad:
        return pr.vjp(linsolve_bicgstab_batched, alg, alg_rrule)
    P, dev = pr.P, pr.dev
    cdt = pr.cdt()
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    eps_break = torch.finfo(rdt).eps ** 2

    X = tree_map(torch.clone, astype(pr.X0, cdt))
    R = astype(pr.true_residual(pr.every, X, pr.B), cdt)
    normr0 = norm_batched(tree_rows(R), space)
    # breakdown threshold, formed in the working type as the JAX package does
    thr = eps_break * normr0 * normr0
    one = torch.ones(P, dtype=cdt, device=dev)
    zeros = tree_map(torch.zeros_like, R)
    nr_host = _read([normr0])[0]
    numiter, numops = [0] * P, [1] * P
    breakdown = [False] * P
    # the shadow residual r̃ = r₀ stays fixed (bicgstab.jl:20)
    act = _Active([p for p in range(P) if not nr_host[p] <= tol], {
        "x": X, "r": R, "p": zeros, "v": zeros, "rs": R, "b": pr.B, "thr": thr,
        "rho": one, "alpha": one, "omega": one,
    })
    out = {"x": X, "r": tree_map(torch.clone, R), "normr": normr0.clone()}
    while act.ps:
        s = act.s
        r, rs, rho, omega = s["r"], s["rs"], s["rho"], s["omega"]
        rho_new = inner_batched(tree_rows(rs), tree_rows(r), space)
        denom_w = torch.where(torch.abs(rho * omega) > 0, rho * omega, 1)
        beta = rho_new * s["alpha"] / denom_w  # β = (ρ_new/ρ)(α/ω)
        # p = r + β (p − ω v)
        p = _axpy(r, _axpy(s["p"], s["v"], -omega), beta)
        v = pr.shifted(act.ps, p)
        sigma = inner_batched(tree_rows(rs), tree_rows(v), space)
        alpha = rho_new / torch.where(torch.abs(sigma) > 0, sigma, 1)
        # half step: s = r − α v, x_half = x + α p (bicgstab.jl:123-155)
        sv = _axpy(r, v, -alpha)
        norms = norm_batched(tree_rows(sv), space)
        arho, asig, th, ns = _read([torch.abs(rho_new), torch.abs(sigma), s["thr"], norms])
        half = [nv <= tol for nv in ns]
        xh = _axpy(s["x"], p, alpha)
        # the half step's true residual and the full step's t = A s: one apply
        sz = pr.shifted(act.ps, _pick(half, xh, sv))
        rh = nh = xf = rf = nf = omega_f = None
        if any(half):
            rh = add(s["b"], sz, a=-1)
            nh = norm_batched(tree_rows(rh), space)
        if not all(half):
            t = sz
            tt = torch.real(inner_batched(tree_rows(t), tree_rows(t), space))
            omega_f = inner_batched(tree_rows(t), tree_rows(sv), space) / torch.where(tt > 0, tt, 1)
            xf = _axpy(xh, sv, omega_f)
            rf = _axpy(sv, t, -omega_f)
            nf = norm_batched(tree_rows(rf), space)
        x, r, normr = _pick(half, xh, xf), _pick(half, rh, rf), _pick(half, nh, nf)
        omega = omega if omega_f is None else _pick(half, omega, omega_f)
        for i, q in enumerate(act.ps):
            numops[q] += 2
            numiter[q] += 1
            breakdown[q] = arho[i] <= th[i] or asig[i] <= th[i]
        nrs = _read([normr])[0]
        verify = [i for i, nr in enumerate(nrs) if nr <= tol and not half[i]]
        if verify:
            rt = pr.true_residual([act.ps[i] for i in verify], _sel(x, verify),
                                  _sel(s["b"], verify))
            r = _put(r, verify, rt)
            normr = _put(normr, verify, norm_batched(tree_rows(rt), space))
            for i, nr in zip(verify, _read([_sel(normr, verify)])[0]):
                nrs[i] = nr
                numops[act.ps[i]] += 1
        act.s = {"x": x, "r": r, "p": p, "v": v, "rs": rs, "b": s["b"], "thr": s["thr"],
                 "rho": rho_new, "alpha": alpha, "omega": omega, "normr": normr}
        done = []
        for i, (q, nr) in enumerate(zip(act.ps, nrs)):
            nr_host[q] = nr
            if nr <= tol or numiter[q] >= alg.maxiter or breakdown[q]:
                done.append(i)
        if done:
            act.retire(done, out)
    X, R, normr = out["x"], out["r"], out["normr"]
    conv, out = pr.finish(
        alg, "BiCGStab linsolve finished after {it} iterations: converged = {c}, "
        "normres = {nr}", X, R, normr, nr_host, tol, numiter, numops)
    warn_if(
        alg.verbosity, breakdown,
        "BiCGStab linsolve breakdown (rho or sigma ~ 0) after {it} iterations",
        it=numiter,
    )
    warn_if(
        alg.verbosity, [c == 0 and not bd for c, bd in zip(conv, breakdown)],
        "BiCGStab linsolve stopped without converging after {it} iterations: "
        "normres = {nr}", it=numiter, nr=normr,
    )
    return out
