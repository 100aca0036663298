"""Batched solves: ``P`` problems in one host loop (the counterpart of
``jax.vmap`` over the JAX package's ``eigsolve_lanczos`` and
``linsolve_gmres``).

The JAX drivers are single ``lax.while_loop`` nests, so ``jax.vmap`` batches
them: every problem runs its own solve, a problem that has stopped keeps its
carry (the vmapped loop selects the old one) while the others go on, and the
fused Lanczos step and the restart rotation run as one batched kernel
launch.  The port's one-problem drivers are host loops over ``int`` counts,
which ``torch.func.vmap`` cannot batch, so the loops here are written out
with a problem axis:

* each problem carries its own ``k``, counts, convergence state and
  :class:`~..factorizations.krylov.FusedScales`, and gives the counts and the
  values of its own one-problem solve (to float rounding);
* a stopped problem is frozen: its basis, projected matrix and counts never
  change again;
* the host reads one list of the active problems' loop scalars per step;
* the projected problems (``_process``, the Givens QR, the triangular
  solve) run per problem through the one-problem functions;
* on a fusable stencil operator with ``(R, 128)`` float32 vectors, each
  step is one batched K1 launch for the problems that step
  (``ops/fused_lanczos.py:fused_step_batched``; one per distinct live-row
  count among them, so each keeps its one-problem bits), and each Lanczos restart
  and the extraction one batched K2 launch
  (``ops/basis.py:transform_partial_inplace_batched``), a problem that is
  not restarting taking the identity;
* an unfused step applies the operator to the stack once and
  orthonormalizes through ``factorizations/krylov.py:expand_batched``: with
  ``ops/basis.py``'s projection flag on, a cgs-family sweep is one batched
  K5 and one batched K6 launch for every problem that steps.

Which arguments carry the problem axis is stated by ``in_dims`` (``0`` or
``None`` per argument, as ``vmap``'s ``in_dims``), never guessed from
shapes: an ``(R, 128)`` vector is 2-D itself.  A batched operator is a
sequence of ``P`` operators; ``P`` :class:`~..ops.operator.MatrixOperator`
of one shape apply as one ``torch.matmul`` over their ``(P, n, n)`` stack.

Every batched driver (the two here and those of ``batched_linsolve.py``,
``batched_arnoldi.py``, ``batched_expintegrator.py``, ``batched_gkl.py``,
``batched_golubye.py``, ``batched_biarnoldi.py`` and
``batched_blocklanczos.py``) takes a sharded space
(``VectorSpace(psum_axis=mesh.axis("vec"))`` on a ``(batch, vec)`` mesh of
``parallel/mesh.py``): each rank holds its batch row's problems, a ``(P_b,
...)`` stack of its block of rows (``shard_vector(..., batched=True)``),
and every collective runs over the ``vec`` axis only, so
batch rows never talk during a solve.  A lock-step then all-reduces once
for every stepping problem where the one-problem loop would once a
problem: the stack apply of a shared sharded operator and of its adjoint
(``LinearOperator.normal_stack``, ``adjoint_stack``), the ``(P,)`` inner
products and norms (``ops/vector.py:inner_batched``), a cgs sweep's ``(P,
k)`` coefficients, the projections of ``ops/basis.py:project_batched``,
the Block Lanczos Gram passes (``gram_batched``) and block-QR norms, and
the fused step's reductions and halos.  The dense work that runs once a
round per problem (Golub-Ye's Ritz data and restart, BiArnoldi's oblique
residual norms) keeps its one-problem collectives.  A fusable stencil whose
``(R, 128)`` blocks the fused step's halos cannot serve (fewer rows than
its reach, a grid row cut between ranks) raises
(``factorizations/krylov.py:check_sharded_blocks``); the gate's other rules
send a problem to the unfused lock-step, as on an unsharded space, never
to a loop over problems.

Vectors may be pytrees (tuples, lists, dicts, nested; a Block Lanczos start
of them): an argument with ``in_dims`` ``0`` is a tree whose every leaf
carries the problem axis first, and the outputs are trees of the input's
structure with leaves ``(P, ...)``, as ``jax.vmap`` returns them.  Problem
``p``'s vectors are views of row ``p`` of each leaf, and every operation
runs leaf by leaf as in the one-problem tree solve, which each problem
gives bit for bit on a shared operator.  A tree operator is a user
callable, applied problem by problem; the fused gates refuse a tree, so a
tree batch takes the unfused lock-step, and a restart rotates every leaf
the K2 kernel takes (a ``(kmax, R, 128)`` float32/bfloat16 leaf) in one
batched launch, any other leaf problem by problem.

Tree stacks run on a sharded space as tensors do: a row's local partial
of each reduction (``inner_batched``, ``project_batched``, a cgs sweep's
coefficients, ``gram_batched``) is the one-problem tree partial, summed
over the leaves, so a lock-step still all-reduces once of each kind for
every problem and leaf, and a tree operator makes its own collectives, one
problem at a time.

``eager=True`` is batched in every driver that takes it: each problem
processes after every step of its own, as its one-problem solve does, and
a lock-step expands only the problems whose rounds go on.  A restart
rotates only the problems that restart there (the eager one-problem solve
runs no identity rotation).  ``Lanczos(reorth="selective")`` is batched
in :func:`eigsolve_lanczos_batched` through
``factorizations/krylov.py:expand_hermitian_selective_batched``: each
problem keeps its own ω state, the sweep decisions of a lock-step are one
host read, and the problems that sweep sweep together.

The drivers whose one-problem front-end has a differentiation rule (the
two here, the CG, MINRES and BiCGStab drivers, the Arnoldi eigsolve and
the GKL svdsolve) differentiate by that rule, for the algorithm they are
given (``alg_rrule``; ``ad/batched.py``), on a sharded space as on an
unsharded one: each rank's cotangents are the one-problem sharded rule's,
problem by problem.  Refused, each with a ``ValueError`` that names it
(:func:`_differentiated`): selective with ``eager`` (as in the one-problem
driver) and differentiation through a driver with no rule, on any
space.
"""

from __future__ import annotations

import functools

import torch

from ..ad._common import SplitOperator, needs_grad, split_apply_batched
from ..algorithms import GMRES, Lanczos
from ..dense.triangular import solve_upper_active
from ..factorizations import krylov as kf
from ..info import EACHITERATION, STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import banded as bd
from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ops import stencil_1d as s1
from ..ops.banded import BandedOperator
from ..ops.operator import (LinearOperator, MatrixOperator, as_operator, probe_dtype,
                            require_adjoint)
from ..ops.stencil_1d import Laplacian1DOperator
from ..ops.vector import (STANDARD, VectorSpace, add, alloc_batched, astype, device_of, rounded,
                          scalartype, stack_size, tree_leaves, tree_map, tree_row, tree_rows,
                          tree_stack)
from .gmres import _qr_update
from .lanczos import _LoopState, _arrowhead, _process, _restart_rotation

__all__ = ["eigsolve_lanczos_batched", "linsolve_gmres_batched"]


def _in_dims(in_dims, names):
    dims = tuple(in_dims)
    if len(dims) != len(names) or any(d not in (0, None) for d in dims) or 0 not in dims:
        raise ValueError(
            f"in_dims must give 0 or None for each of {names}, at least one 0; got {in_dims}")
    return dims


def _differentiated(what: str, vectors, ops, scalars=(), rule: bool = False) -> bool:
    """Whether a batched call differentiates: gradients are on and a leaf of
    ``vectors``, a tensor of ``scalars`` or a tensor of one of ``ops``
    requires grad.  A driver whose one-problem front-end has a rule
    (``rule``) then goes through ``ad/batched.py``, on any ``space``; one
    whose front-end has none raises a ``ValueError`` that names it."""
    if not needs_grad(list(ops), *vectors, *scalars):
        return False
    if not rule:
        raise ValueError(f"{what}: differentiation has no rule here (nor has the JAX "
                         "package's: its lax.while_loop has no transpose); differentiate a "
                         "batched linsolve, eigsolve or svdsolve driver, or detach the inputs")
    return True


def _kernel_banded(o) -> bool:
    """A :class:`BandedOperator` whose apply is K3 (real planes, not the
    differentiable plain form)."""
    return type(o) is BandedOperator and not o.plain and not o.diags.is_complex()


def _banded_planes(ops, shared: bool):
    """The planes of kernel-backed banded operators as one launch takes
    them: the shared operator's, or the stack of a sequence with equal
    offsets, ``n``, plane shapes, types and devices; else ``None``."""
    o0 = ops[0]
    if shared:
        return o0.diags if _kernel_banded(o0) else None
    if all(_kernel_banded(o) for o in ops) and all(
            (o.offsets, o.n, o.diags.shape, o.diags.dtype, o.diags.device)
            == (o0.offsets, o0.n, o0.diags.shape, o0.diags.dtype, o0.diags.device)
            for o in ops):
        return torch.stack([o.diags for o in ops])
    return None


class _Operators:
    """The operator of each of ``P`` problems, applied to the vectors of a
    set of problems at once: one shared operator, or one per problem.

    A shared operator with a stack apply of its own
    (``LinearOperator.normal_stack``: the sharded operators of
    ``parallel/``, one collective for all rows) applies a stack through it.
    Three kinds apply a stack in one batched kernel launch, each row
    bit-identical to the one-problem apply: a shared kernel-backed
    :class:`BandedOperator` (its planes shared by the rows), a sequence of
    them with equal offsets, ``n``, plane shapes, types and devices (their
    planes stacked once, a row taking its problem's), and a shared
    :class:`Laplacian1DOperator`.  ``P`` matrices of one shape apply as one
    ``torch.matmul`` over their stack (a problem's rows the columns of its
    block); any other operator applies problem by problem.  The adjoint
    (:meth:`apply_adjoint_stack`) batches alike: a banded operator's adjoint
    planes (stacked on first use), the self-adjoint Laplacian, the
    conjugate-transposed matrix stack.

    A ``(f, fadjoint)`` tuple is one operator (``as_operator``), never two
    problems.  ``templates`` (each problem's vector of the codomain) gives
    every distinct operator its adjoint as the ``svdsolve``/``lssolve``
    front-ends do (``require_adjoint`` on its first problem's vector, a
    caller's pair checked in ``check_space``)."""

    def __init__(self, op, P: int, batched: bool, templates=None, check_space=None):
        if batched:
            if isinstance(op, tuple):
                raise ValueError("a (f, fadjoint) tuple is one shared operator, not a batch: "
                                 "give it with in_dims None, or a list of P operators")
            if isinstance(op, (LinearOperator, torch.Tensor)) or len(op) != P:
                raise ValueError(f"a batched operator is a sequence of {P} operators")
            self.ops = [as_operator(o) for o in op]
        else:
            self.ops = [as_operator(op)] * P
        if templates is not None:
            first = {}
            for p, o in enumerate(self.ops):
                if id(o) not in first:
                    first[id(o)] = require_adjoint(o, templates[p], check_space)
            self.ops = [first[id(o)] for o in self.ops]
        self.stack = None
        self.shared = not batched
        self.planes = _banded_planes(self.ops, self.shared)
        self.laplacian = not batched and isinstance(self.ops[0], Laplacian1DOperator)
        self.own_stack = not batched and self.ops[0].normal_stack is not None
        mats = batched and all(type(o) is MatrixOperator for o in self.ops)
        As = [o.A for o in self.ops] if mats else []
        if As and all(
                A.shape == As[0].shape and A.dtype == As[0].dtype and A.device == As[0].device
                for A in As):
            self.stack = torch.stack(As)

    @functools.cached_property
    def adj_planes(self):
        """The adjoints' planes as one launch takes them (or ``None``)."""
        if self.planes is None or any(o.adj is None for o in self.ops):
            return None
        return _banded_planes([o.adj for o in self.ops], self.shared)

    @functools.cached_property
    def adj_stack(self):
        """The conjugate-transposed matrix stack."""
        return self.stack.conj().transpose(1, 2)

    def distinct(self):
        return list({id(o): o for o in self.ops}.values())

    def _batches(self, x, adjoint: bool = False) -> bool:
        """Whether vectors like ``x`` (one problem's) apply as a stack (never
        a pytree vector: its operator is a callable, applied per problem)."""
        if not isinstance(x, torch.Tensor):
            return False
        planes = self.adj_planes if adjoint else self.planes
        if planes is not None:
            return not torch.promote_types(planes.dtype, x.dtype).is_complex
        if self.own_stack:
            return self._own(adjoint) is not None
        return self.laplacian or (self.stack is not None and x.ndim == 1)

    def _own(self, adjoint: bool):
        """The shared operator's own stack apply (or ``None``)."""
        o = self.ops[0]
        return o.adjoint_stack if adjoint else o.normal_stack

    def _apply(self, X, ps, adjoint: bool):
        if isinstance(X, torch.Tensor):  # a tree stack applies problem by problem
            if self.own_stack and self._own(adjoint) is not None:
                return self._own(adjoint)(X)
            planes = self.adj_planes if adjoint else self.planes
            if planes is not None and self._batches(X[0], adjoint):
                o0 = self.ops[0].adj if adjoint else self.ops[0]
                dt = torch.promote_types(planes.dtype, X.dtype)
                return bd.banded_spmv_batched(X.to(dt), planes.to(dt), o0.offsets, o0.n,
                                              planes=None if self.shared else list(ps))
            if self.laplacian:
                if X[0].numel() != self.ops[0].n:
                    raise ValueError(f"vector of {X[0].numel()} entries for an "
                                     f"n={self.ops[0].n} Laplacian")
                return s1.laplacian_1d_flat_batched(X)
            if self.stack is not None and X.ndim == 2:
                stack = self.adj_stack if adjoint else self.stack
                dt = torch.promote_types(stack.dtype, X.dtype)
                # row i is column slot[i] of its problem's (n, c) block
                slot, seen = [], {}
                for p in ps:
                    slot.append(seen.get(p, 0))
                    seen[p] = slot[-1] + 1
                full = torch.zeros((len(self.ops), X.shape[1], max(seen.values())), dtype=dt,
                                   device=X.device)
                full[list(ps), :, slot] = X.to(dt)
                return torch.matmul(stack.to(dt), full)[list(ps), :, slot]
        rows = tree_rows(X)
        if adjoint:
            return tree_stack([self.ops[p].apply_adjoint(x) for p, x in zip(ps, rows)])
        return tree_stack(self._normals(ps, rows))

    def _normals(self, ps, xs) -> list:
        """``A_p x`` for the vectors ``xs`` of the problems ``ps``, one by one;
        a pullback's :class:`~..ad._common.SplitOperator` maps on a sharded
        space sum every problem's partials in one all-reduce."""
        ops = [self.ops[p] for p in ps]
        if all(isinstance(o, SplitOperator) for o in ops) and ops[0].space.psum_axis is not None \
                and all(o.space.psum_axis is ops[0].space.psum_axis for o in ops):
            return split_apply_batched(ops, xs)
        return [o.normal(x) for o, x in zip(ops, xs)]

    def apply_stack(self, X, ps):
        """``A_p X[i]`` for row ``i`` of the stack ``X`` (a tensor, or a tree
        of stacks), the vector of problem ``ps[i]``, as a stack."""
        return self._apply(X, ps, False)

    def apply_adjoint_stack(self, X, ps):
        """``A_pᴴ X[i]`` for row ``i`` of the stack ``X``, the vector of
        problem ``ps[i]``, as a stack."""
        return self._apply(X, ps, True)

    def _map(self, xs: dict, adjoint: bool) -> dict:
        ps = list(xs)
        if not self._batches(xs[ps[0]], adjoint):
            if adjoint:
                return {p: self.ops[p].apply_adjoint(x) for p, x in xs.items()}
            return dict(zip(ps, self._normals(ps, list(xs.values()))))
        X = torch.stack([xs[p] for p in ps])
        Y = self.apply_adjoint_stack(X, ps) if adjoint else self.apply_stack(X, ps)
        return {p: Y[i] for i, p in enumerate(ps)}

    def __call__(self, xs: dict) -> dict:
        """``{p: A_p x_p}`` for the vectors ``xs = {p: x_p}``."""
        return self._map(xs, False)

    def adjoint(self, xs: dict) -> dict:
        """``{p: A_pᴴ x_p}`` for the vectors ``xs = {p: x_p}``."""
        return self._map(xs, True)


def _problems(x, dim, P, vector: bool = True):
    """Each problem's argument: row ``p`` of a vector stack (views of every
    leaf), entry ``p`` of a sequence (``vector=False``: operators, times),
    or ``x`` itself where it is shared (``dim`` ``None``)."""
    if dim is None:
        return [x] * P
    return [tree_row(x, p) if vector else x[p] for p in range(P)]


def _count(x, dim, name, vector: bool = True):
    """The problem count an argument gives (``None`` where it is shared): a
    vector's leaves' leading axis (a tuple is a pytree, never a list of
    problems), a sequence's length (``vector=False``: operators, times)."""
    if dim is None:
        return None
    if vector:
        return stack_size(x, name)
    if not isinstance(x, (torch.Tensor, list, tuple)) or len(x) == 0:
        raise ValueError(f"{name} has no leading problem axis")
    return len(x)


def _batch_size(*sizes):
    given = {s for s in sizes if s is not None}
    if len(given) != 1:
        raise ValueError(f"the batched arguments disagree on the problem count: {sorted(given)}")
    return given.pop()


def _rotate(Vb, Us: dict, m_out: int):
    """``V[p, :m_out] ← (V[p] @ U_p)[:m_out]`` for each ``p`` of ``Us``,
    leaf by leaf as the one-problem ``bs.transform_partial`` decides: one
    batched K2 launch for a leaf the kernel takes (a real ``U`` on a
    ``(kmax, R, 128)`` float32/bfloat16 leaf), ``bs.transform_partial`` per
    problem for any other.  No ``Us``, no launch."""
    if not Us:
        return
    ps = sorted(Us)
    U0 = Us[ps[0]]
    Ub = None
    for L in tree_leaves(Vb):
        if not torch.is_complex(U0) and bs._leaf_ok(L[0]):
            if Ub is None:
                none = torch.zeros_like(U0)
                Ub = torch.stack([Us.get(p, none) for p in range(L.shape[0])])
            bs.transform_partial_inplace_batched(L, Ub, m_out, ps)
            continue
        for p in ps:
            Lp = L[p]
            Lnew = bs.transform_partial(Lp, Us[p], m_out)
            if Lnew is not Lp:
                Lp.copy_(Lnew)


def _goes_on(alg, j: int, k: int, howmany: int) -> bool:
    """Whether a problem whose round has made ``j`` expansions, at size
    ``k``, takes another one (the one-problem loops' ``eager`` test): always
    without ``eager``; with it, the round's first, then only while ``k <
    howmany``."""
    return not alg.eager or j == 0 or k < max(howmany, 1)


def _read(values) -> list:
    """One host read of a list of device scalars."""
    return torch.stack(values).tolist() if values else []


def eigsolve_lanczos_batched(op, x0, howmany: int, which, alg: Lanczos,
                             space: VectorSpace = STANDARD, coeff_dtype=None, *,
                             in_dims=(None, 0), alg_rrule=None):
    """Hermitian eigsolves of ``P`` problems, each as
    :func:`~.lanczos.eigsolve_lanczos` solves it, in one host loop.

    ``in_dims = (op_dim, x0_dim)``: ``op_dim = 0`` takes ``op`` as a
    sequence of ``P`` operators (``None``: one shared operator);
    ``x0_dim = 0`` takes ``x0``'s leading axis as the problem axis
    (``None``: one shared start).  Returns ``(vals (P, howmany), vecs (P,
    howmany, ...), info)``; ``info``'s ``converged``, ``numiter`` and
    ``numops`` are ``(P,)`` int64 tensors and ``normres``/``residual`` carry
    the leading ``P``, as ``jax.vmap`` returns them.  At ``WARN`` each
    unconverged problem prints its one-problem line, in problem order.

    Differentiable in ``x0`` (zero gradient) and in the tensors of the
    operators, as ``eigsolve`` is (``ad/batched.py``): the backward takes
    the rule ``alg_rrule`` picks, all problems' inner solves in one batched
    call."""
    op_dim, x_dim = _in_dims(in_dims, ("op", "x0"))
    m = alg.krylovdim
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}; enlarge krylovdim")
    if isinstance(which, str) and which.upper() in ("LI", "SI"):
        raise ValueError(
            "which=:LI/:SI invalid for Hermitian eigsolve (real spectrum) — "
            "reference src/eigsolve/eigsolve.jl:209-236"
        )
    selective = getattr(alg, "reorth", "full") == "selective"
    if selective and alg.eager:
        raise ValueError(
            "eigsolve_lanczos_batched: reorth='selective' is incompatible with eager=True (the "
            "omega-recurrence state does not persist across eager processings)")
    P = _batch_size(_count(op, op_dim, "op", vector=False), _count(x0, x_dim, "x0"))
    ops = _Operators(op, P, op_dim == 0)
    if _differentiated("eigsolve_lanczos_batched", [x0], ops.distinct(), rule=True):
        from ..ad.batched import eigsolve_batched_vjp

        return eigsolve_batched_vjp(eigsolve_lanczos_batched, ops.ops, x0, howmany, which, alg,
                                    alg_rrule, space, (op_dim, x_dim), coeff_dtype=coeff_dtype)
    x0s = _problems(x0, x_dim, P)
    kf.check_sharded_blocks("eigsolve_lanczos_batched", ops.distinct(), x0s, space)
    cdt = coeff_dtype or functools.reduce(
        torch.promote_types, [probe_dtype(o, x0s[0]) for o in ops.distinct()])
    rdt = cdt.to_real()
    tol = alg.tol
    btol = float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)
    dev = device_of(x0s[0])
    promote = cdt.is_complex and not scalartype(x0s[0]).is_complex
    vdt = cdt if promote else scalartype(x0s[0])

    # one basis for all problems; each problem's factorization holds its row
    Vb = alloc_batched(x0s[0], P, m + 1, vdt)
    st = {}
    for p in range(P):
        f0 = kf.initialize(x0s[p], 0, cdt, space, vec_dtype=cdt if promote else None,
                           verbosity=alg.verbosity)
        bs.set(tree_row(Vb, p), 0, bs.get(f0.V, 0))
        fact = kf.KrylovState(tree_row(Vb, p),
                              torch.zeros((m + 1, m + 1), dtype=cdt, device=dev), 0,
                              f0.beta)
        st[p] = _LoopState(
            fact=fact, numiter=0, numops=0, nconv=0,
            vals=torch.zeros(m + 1, dtype=rdt, device=dev),
            U=torch.zeros((m + 1, m + 1), dtype=cdt, device=dev),
            resnorms=torch.full((m + 1,), float("inf"), dtype=rdt, device=dev),
            sc=kf.fused_scales_init(m + 1, device=dev),
        )

    dgks = type(alg.orth) is on.ClassicalGramSchmidt2 and 2 * (m + 1) + 2 <= 128
    fused = (
        op_dim is None
        and not alg.eager
        and not selective
        and (type(alg.orth) is on.ClassicalGramSchmidt or dgks)
        and cdt == torch.float32
        and kf.fused_available_batched(ops.ops[0], x0s, space, kmax=m + 1)
    )
    keep_max = min((3 * m + 2 * max(howmany - 1, 0)) // 5, m - 1)

    active = list(range(P))
    while active:
        facts = {p: st[p].fact for p in active}
        numops = {p: st[p].numops for p in active}
        scs = {p: st[p].sc for p in active}
        if fused:
            facts, scs, dops = kf.fused_expansions_batched(
                ops.ops[0], Vb, facts, scs, m, btol, dgks=dgks, space=space)
            for p in active:
                numops[p] += dops[p]
        else:
            # j: each problem's expansions in this round; selective: its ω
            # state, at the eps level after every restart
            j = dict.fromkeys(active, 0)
            if selective:
                om = {}
                for p in active:
                    om[p] = torch.full((m + 1,), torch.finfo(rdt).eps, dtype=rdt, device=dev)
                    om[p] = (om[p], om[p].clone())
            stepping = active
            while True:
                cand = [p for p in stepping if facts[p].k < m]
                betas = _read([facts[p].beta for p in cand])
                stepping = [p for p, b in zip(cand, betas)
                             if b > btol and _goes_on(alg, j[p], facts[p].k, howmany)]
                if not stepping:
                    break
                if selective:
                    # the first expansion after a restart sweeps
                    outs = kf.expand_hermitian_selective_batched(
                        ops, {p: facts[p] for p in stepping}, {p: om[p] for p in stepping},
                        {p: j[p] == 0 and st[p].numiter > 0 for p in stepping}, space)
                    for p in stepping:
                        facts[p], om_new, om_cur, _ = outs[p]
                        om[p] = (om_new, om_cur)
                else:
                    facts.update(kf.expand_batched(ops, {p: facts[p] for p in stepping},
                                                   alg.orth, space, alg.verbosity,
                                                   hermitian=True))
                for p in stepping:
                    numops[p] += 1
                    j[p] += 1

        rotations, finished = {}, []
        for p in active:
            fact = facts[p]
            nconv, vals, U, res = _process(fact.H, fact.k, fact.beta, which, tol, howmany)
            full = fact.k >= m
            numiter = st[p].numiter + int(full)
            stalled = not (float(fact.beta) > btol) and fact.k < m
            done = nconv >= howmany or (full and numiter >= alg.maxiter) or stalled
            keep = min(max((3 * m + 2 * nconv) // 5, 1), max(fact.k - 1, 1))
            restart_now = not done and fact.k >= m
            if alg.eager:
                # eager processes every step: rotate only when a restart is due
                if restart_now:
                    rotations[p] = _restart_rotation(fact.H, fact.k, U, keep)
            else:
                # every processing but the last restarts; the last one runs
                # the identity rotation (the JAX package's masked restart)
                rotations[p] = _restart_rotation(fact.H, fact.k, U, keep, gate=restart_now,
                                                 scales=scs[p].L if fused else None)
            sc = scs[p]
            if restart_now:
                fact = kf.KrylovState(fact.V, _arrowhead(fact.H, fact.k, vals, U, fact.beta, keep),
                                      keep, fact.beta)
                sc = kf.fused_scales_init(m + 1, H=fact.H if fused else None, device=dev)
            log_if(
                alg.verbosity, EACHITERATION,
                "Lanczos eigsolve in iteration {it}: {nc} values converged, "
                "normres = {nr}",
                it=numiter, nc=nconv, nr=res[:howmany],
            )
            st[p] = _LoopState(fact, numiter, numops[p], nconv, vals, U, res, sc)
            if done:
                finished.append(p)
        # rows < keep_max + 1 survive (kept Ritz vectors + relocated residual)
        _rotate(Vb, rotations, keep_max + 1)
        active = [p for p in active if p not in finished]

    # --- extract results ---
    m1 = m + 1
    rows = torch.arange(m1, device=dev)[:, None]
    cols = torch.arange(m1, device=dev)[None, :]
    extract, residuals = {}, []
    for p in range(P):
        s_, fact = st[p], st[p].fact
        k = fact.k
        Umask = torch.where((rows < k) & (cols < howmany), s_.U,
                            torch.zeros((), dtype=s_.U.dtype, device=dev))
        extract[p] = kf.fold_scales(s_.sc, Umask)
        # V[k] (the residual direction) before the in-place rotation
        vk = bs.unproject_bucketed(fact.V, s_.sc.L[:, k].to(cdt), k + 1)
        # residual vectors r_i = β·U[k-1,i]·V[k]
        s = fact.beta * s_.U[max(k - 1, 0)]
        residuals.append(tree_map(
            lambda l: s[:howmany].reshape((howmany,) + (1,) * l.ndim) * l[None], vk))
    _rotate(Vb, extract, howmany)
    vecs = tree_map(lambda l: l[:, :howmany].clone(), Vb)
    conv, iters = [], []
    for p in range(P):
        s_ = st[p]
        nconv_out = min(s_.nconv, howmany)
        numiter_out = max(s_.numiter, 1)
        conv.append(nconv_out)
        iters.append(numiter_out)
        log_if(
            alg.verbosity, STARTSTOP,
            "Lanczos eigsolve finished after {it} iterations: {nc} values "
            "converged, numops = {no}, normres = {nr}",
            it=numiter_out, nc=nconv_out, no=s_.numops, nr=s_.resnorms[:howmany],
        )
    warn_if(
        alg.verbosity, [c < howmany for c in conv],
        "Lanczos eigsolve stopped without convergence: {nc} of "
        f"{howmany} values converged " + "after {it} iterations",
        nc=conv, it=iters,
    )
    info = ConvergenceInfo(
        converged=torch.tensor(conv, dtype=torch.int64, device=dev),
        residual=tree_stack(residuals),
        normres=torch.stack([st[p].resnorms[:howmany] for p in range(P)]),
        numiter=torch.tensor(iters, dtype=torch.int64, device=dev),
        numops=torch.tensor([st[p].numops for p in range(P)], dtype=torch.int64, device=dev),
    )
    return torch.stack([st[p].vals[:howmany] for p in range(P)]), vecs, info


def linsolve_gmres_batched(op, b, x0, a0, a1, alg: GMRES, space: VectorSpace = STANDARD, *,
                           in_dims=(None, 0, 0), alg_rrule=None):
    """Restarted GMRES(m) solves of ``P`` systems ``(a0 + a1·A_p) x_p =
    b_p``, each as :func:`~.gmres.linsolve_gmres` solves it, in one host
    loop.  ``in_dims = (op_dim, b_dim, x0_dim)`` as in
    :func:`eigsolve_lanczos_batched`; ``a0`` and ``a1`` are shared.  Every
    problem starts a cycle at ``k = 0``, so the problems of a cycle step
    together, and a problem leaves the cycle's launches when its own cycle
    ends.  Returns ``(x (P, ...), info)`` with ``(P,)`` counts.

    Differentiable in ``b``, ``a0``, ``a1`` and the tensors of the
    operators, as ``linsolve`` is (``x0`` gets no gradient): the backward
    solves the ``P`` adjoint systems with ``alg_rrule`` (default ``alg``) in
    one batched call (``ad/batched.py``)."""
    op_dim, b_dim, x_dim = _in_dims(in_dims, ("op", "b", "x0"))
    m = alg.krylovdim
    P = _batch_size(_count(op, op_dim, "op", vector=False), _count(b, b_dim, "b"),
                    _count(x0, x_dim, "x0"))
    ops = _Operators(op, P, op_dim == 0)
    if _differentiated("linsolve_gmres_batched", [b, x0], ops.distinct(), (a0, a1), rule=True):
        from ..ad.batched import linsolve_batched_vjp

        return linsolve_batched_vjp(linsolve_gmres_batched, ops.ops, b, x0, a0, a1, alg,
                                    alg_rrule, space, (op_dim, b_dim, x_dim))
    bs_, xs = _problems(b, b_dim, P), _problems(x0, x_dim, P)
    kf.check_sharded_blocks("linsolve_gmres_batched", ops.distinct(), bs_, space)
    dev = device_of(bs_[0])
    cdt = functools.reduce(torch.promote_types, [probe_dtype(o, bs_[0]) for o in ops.distinct()])
    for a in (a0, a1):
        cdt = torch.result_type(torch.empty((), dtype=cdt), a)
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    a0c = torch.as_tensor(a0, dtype=cdt, device=dev)
    a1c = torch.as_tensor(a1, dtype=cdt, device=dev)

    def residuals(ps):
        """``b_p − (a0·x_p + a1·A_p x_p)`` for the problems ``ps``."""
        Ax = ops({p: x[p] for p in ps})
        return {p: astype(add(bs_[p], tree_map(lambda lx, la: a0c * lx + a1c * la, x[p], Ax[p]),
                              a=-1), cdt) for p in ps}

    def onehot(i: int):
        e = torch.zeros(m + 1, dtype=cdt, device=dev)
        e[i] = 1
        return e

    x = {p: astype(xs[p], cdt) for p in range(P)}
    r = residuals(range(P))
    normr = {p: space.norm(r[p]) for p in range(P)}

    dgks = type(alg.orth) is on.ClassicalGramSchmidt2 and 2 * (m + 1) + 2 <= 128
    fused = (
        op_dim is None
        and (type(alg.orth) is on.ClassicalGramSchmidt or dgks)
        and cdt == torch.float32
        and kf.fused_available_batched(ops.ops[0], bs_, space, kmax=m + 1)
    )
    numiter, numops = [0] * P, [1] * P

    def start(p, rows: int):
        """The cycle's basis of ``rows`` rows from ``r/‖r‖`` and its QR
        state, as the one-problem ``start``."""
        fact = kf.initialize(r[p], rows - 1, cdt, space, vec_dtype=cdt)
        G = torch.eye(m + 1, dtype=cdt, device=dev)
        R = torch.zeros((m + 1, m + 1), dtype=cdt, device=dev)
        return fact, G, R, normr[p].to(cdt) * onehot(0)

    def cycle_unfused(active):
        facts, G, R, y = {}, {}, {}, {}
        for p in active:
            facts[p], G[p], R[p], y[p] = start(p, m + 1)
        stepping = active
        while True:
            cand = [p for p in stepping if facts[p].k < m]
            res = _read([torch.abs(y[p][facts[p].k]) for p in cand])
            stepping = [p for p, v in zip(cand, res) if v > tol]
            if not stepping:
                break
            ks = {p: facts[p].k for p in stepping}  # the columns this step produces
            facts.update(kf.expand_batched(ops, {p: facts[p] for p in stepping}, alg.orth, space,
                                           alg.verbosity))
            for p in stepping:
                k = ks[p]
                col = a1c * facts[p].H[:, k] + a0c * onehot(k)
                G[p], R[p], y[p] = _qr_update(G[p], R[p], y[p], col, k)
                numops[p] += 1
        ident = kf.fused_scales_init(m + 1, device=dev)
        return {p: (facts[p].V, ident, G[p], R[p], y[p], facts[p].k) for p in active}

    Vb = None
    if fused:
        Vb = torch.zeros((P, m + 1) + tuple(bs_[0].shape), dtype=cdt, device=dev)
        prime, advance, tail = kf.make_fused_stepper_batched(ops.ops[0], m + 1, dgks, space)
        btol = float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)

    def cycle_fused(active):
        """The fused cycle of :func:`~.gmres.linsolve_gmres` for every active
        problem: one batched K1 launch per step for the problems whose
        cycle goes on."""
        kmax = m + 1
        G, R, yt = {}, {}, {}
        for p in active:
            f0, G[p], R[p], yt[p] = start(p, 1)
            Vb[p].zero_()
            Vb[p, 0] = f0.V[0]
        Y = torch.empty((P,) + tuple(Vb.shape[2:]), dtype=Vb.dtype, device=dev)
        carries = prime(Vb, Y, {p: 0 for p in active},
                        {p: kf.fused_scales_init(kmax, device=dev) for p in active}, active)
        go = {}
        for p in active:
            numops[p] += 1  # priming apply

        def shifted_col(h, beta_k, k):
            return a1c * (h.to(cdt) + beta_k.to(cdt) * onehot(k + 1)) + a0c * onehot(k)

        stepping = active
        while stepping:
            vals = _read([torch.stack([torch.abs(yt[p][carries[p].k]), torch.sqrt(carries[p].q)])
                          for p in stepping])
            nxt = []
            for p, (resk, qnorm) in zip(stepping, vals):
                live = resk > tol and qnorm > btol
                if carries[p].k < m - 1 and live:
                    nxt.append(p)
                else:
                    # tail column m-1: no (wasted) next apply
                    go[p] = carries[p].k == m - 1 and live
            if not nxt:
                break
            Y, outs = advance(Vb, Y, carries, nxt)
            for p in nxt:
                k = carries[p].k
                carries[p], _, beta_k, h = outs[p]
                G[p], R[p], yt[p] = _qr_update(G[p], R[p], yt[p], shifted_col(h, beta_k, k), k)
                numops[p] += 1
            stepping = nxt
        out, tails = {}, tail(carries, go)
        for p in active:
            k = carries[p].k
            V, sc, _, beta_m, h = tails[p]
            if go[p]:
                G[p], R[p], yt[p] = _qr_update(G[p], R[p], yt[p], shifted_col(h, beta_m, k), k)
                k += 1
            out[p] = (V, sc, G[p], R[p], yt[p], k)
        return out

    run_cycle = cycle_fused if fused else cycle_unfused
    nr = _read([normr[p] for p in range(P)])
    active = [p for p in range(P) if not nr[p] <= tol]
    while active:
        cycles = run_cycle(active)
        for p in active:
            V, sc, G, R, yv, k = cycles[p]
            # triangular solve on the active k×k block
            coeff = solve_upper_active(R[:m, :m], yv[:m], k)
            coeff = torch.cat([coeff, torch.zeros(1, dtype=cdt, device=dev)])
            x[p] = add(x[p], bs.unproject(V, kf.fold_scales(sc, coeff)))
            # residual reconstruction: r = V · (Gᴴ e_k · ỹ_k)
            yk = yv[k]
            rc = torch.conj(G.T) @ (yk * onehot(k))
            r[p] = bs.unproject(V, kf.fold_scales(sc, rc))
            normr[p] = torch.abs(yk)
            numiter[p] += 1
        nrs = dict(zip(active, _read([normr[p] for p in active])))
        verify = [p for p in active if nrs[p] <= tol]
        if verify:
            # true-residual verification on apparent convergence
            r.update(residuals(verify))
            for p in verify:
                normr[p] = space.norm(r[p])
                numops[p] += 1
            nrs.update(zip(verify, _read([normr[p] for p in verify])))
        active = [p for p in active if not (nrs[p] <= tol or numiter[p] >= alg.maxiter)]

    conv_tol = _read([normr[p] for p in range(P)])
    conv = [int(v <= tol) for v in conv_tol]
    for p in range(P):
        log_if(
            alg.verbosity, STARTSTOP,
            "GMRES linsolve finished after {it} restarts: converged = {c}, "
            "normres = {nr}, numops = {no}",
            it=numiter[p], c=conv[p], nr=normr[p], no=numops[p],
        )
    warn_if(
        alg.verbosity, [c == 0 for c in conv],
        "GMRES linsolve stopped without converging after {it} iterations: "
        "normres = {nr}", it=numiter, nr=[normr[p] for p in range(P)],
    )
    info = ConvergenceInfo(
        converged=torch.tensor(conv, dtype=torch.int64, device=dev),
        residual=tree_stack([r[p] for p in range(P)]),
        normres=torch.stack([normr[p] for p in range(P)]),
        numiter=torch.tensor(numiter, dtype=torch.int64, device=dev),
        numops=torch.tensor(numops, dtype=torch.int64, device=dev),
    )
    return tree_stack([x[p] for p in range(P)]), info
