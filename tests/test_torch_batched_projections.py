"""PyTorch port: the batched live-row projections (K5 and K6 for ``P``
problems, ``ops/projections.py:project_pallas_batched`` and
``unproject_pallas_batched``) and their routing through
``ops/basis.py:project_batched``/``unproject_batched`` and the batched CGS
sweep of ``ops/orthonormal.py``.

On the CPU the wrappers run their plain versions.  They are held against
``jax.vmap`` of the JAX package's Pallas kernels in interpret mode (``kb=4,
br=8``, a ``k`` per problem including 0 and ``kmax``) at ``(13, 16, 128)``
float32, atol 1e-4 as in the one-problem test, and bit for bit against the
looped one-problem plain versions.  The CUDA kernels are compared with
one-problem launches and the plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu.ops.pallas_basis import project_pallas as j_project_pallas
from krylovkit_tpu.ops.pallas_basis import unproject_pallas as j_unproject_pallas
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import orthonormal as ton
from krylovkit_tpu_torch.ops import projections as tpb

torch.set_num_threads(2)

KMAX, R = 13, 16
KS = [3, 0, 13, 7, 1]  # a k per problem: 0 and kmax among them


@pytest.fixture
def flag_on():
    old = tbs.use_pallas_projections
    tbs.use_pallas_projections = True
    try:
        yield
    finally:
        tbs.use_pallas_projections = old


def _stack(seed, P=len(KS)):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((P, KMAX, R, 128)).astype(np.float32)
    w = rng.standard_normal((P, R, 128)).astype(np.float32)
    c = rng.standard_normal((P, KMAX)).astype(np.float32)
    for p, k in enumerate(KS[:P]):
        c[p, k:] = 0  # the unproject contract: zero beyond k
    return V, w, c


def test_batched_project_matches_vmapped_jax_pallas():
    """Row ``p`` within 1e-4 of ``jax.vmap(project_pallas)``, zero from
    ``k_p`` on, and bit for bit the one-problem plain version."""
    V, w, _ = _stack(1)
    f = jax.vmap(lambda V, w, k: j_project_pallas(V, w, k, kb=4, br=8, interpret=True))
    want = np.asarray(f(jnp.asarray(V), jnp.asarray(w), jnp.asarray(KS, jnp.int32)))
    Vt, wt = torch.from_numpy(V), torch.from_numpy(w)
    got = tpb.project_pallas_batched(Vt, wt, KS)
    assert got.shape == (len(KS), KMAX) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    for p, k in enumerate(KS):
        assert torch.equal(got[p], tpb.project_reference(Vt[p], wt[p], k))
        assert not got[p, k:].any()
    assert torch.equal(tpb.project_batched_reference(Vt, wt, KS), got)


def test_batched_unproject_matches_vmapped_jax_pallas():
    """Row ``p`` within 1e-4 of ``jax.vmap(unproject_pallas)`` and bit for
    bit the one-problem plain version; a problem with ``k = 0`` gives
    zeros."""
    V, _, c = _stack(2)
    f = jax.vmap(lambda V, c, k: j_unproject_pallas(V, c, k, kb=4, br=8, interpret=True))
    want = np.asarray(f(jnp.asarray(V), jnp.asarray(c), jnp.asarray(KS, jnp.int32)))
    Vt, ct = torch.from_numpy(V), torch.from_numpy(c)
    got = tpb.unproject_pallas_batched(Vt, ct, KS)
    assert got.shape == (len(KS), R, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    for p, k in enumerate(KS):
        assert torch.equal(got[p], tpb.unproject_reference(Vt[p], ct[p], k))
    assert not got[KS.index(0)].any()
    assert torch.equal(tpb.unproject_batched_reference(Vt, ct, KS), got)


def test_batched_projections_take_separate_bases():
    """The bases are a list of tensors, not necessarily one stack: rows
    ``>= k`` of each may hold anything (NaN here) and are never read."""
    V, w, c = _stack(3, P=3)
    bases = [torch.from_numpy(V[p]).clone() for p in range(3)]
    for p, k in enumerate(KS[:3]):
        bases[p][k:] = float("nan")
    ws = [torch.from_numpy(w[p]) for p in range(3)]
    cs = [torch.from_numpy(c[p]) for p in range(3)]
    C = tpb.project_pallas_batched(bases, ws, KS[:3])
    Y = tpb.unproject_pallas_batched(bases, cs, KS[:3])
    assert bool(torch.isfinite(C).all()) and bool(torch.isfinite(Y).all())
    for p, k in enumerate(KS[:3]):
        assert torch.equal(C[p], tpb.project_reference(bases[p], ws[p], k))
        assert torch.equal(Y[p], tpb.unproject_reference(bases[p], cs[p], k))


@pytest.mark.parametrize("bad, word", [
    (lambda V, w, k: (V, w[:2], k), "operands"),
    (lambda V, w, k: (V, w, [14, 0, 1]), "k <= kmax"),
    (lambda V, w, k: ([V[0], V[1, :5], V[2]], w, k), "bases of shapes"),
    (lambda V, w, k: (V.double(), w, k), "float32"),
])
def test_batched_projections_refuse_bad_operands(bad, word):
    V, w, _ = _stack(4, P=3)
    args = bad(torch.from_numpy(V), torch.from_numpy(w), KS[:3])
    with pytest.raises(ValueError, match=word):
        tpb.project_pallas_batched(*args)


def test_basis_routes_batched_projections_by_the_flag(flag_on, monkeypatch):
    """``ops/basis.py``: with the flag on and eligible bases one batched
    call for all problems, bit for bit the one-problem ``project`` and
    ``unproject``; a float64 basis goes problem by problem."""
    calls = []
    for name in ("project_pallas_batched", "unproject_pallas_batched"):
        real = getattr(tpb, name)
        monkeypatch.setattr(tpb, name, lambda *a, real=real, name=name: (calls.append(name),
                                                                         real(*a))[1])
    V, w, c = _stack(5, P=3)
    Vs = list(torch.from_numpy(V))
    ws, cs = list(torch.from_numpy(w)), list(torch.from_numpy(c))
    ks = KS[:3]
    got = tbs.project_batched(Vs, ws, ks)
    gotu = tbs.unproject_batched(Vs, cs, ks)
    assert calls == ["project_pallas_batched", "unproject_pallas_batched"]
    for p in range(3):
        assert torch.equal(got[p], tbs.project(Vs[p], ws[p], ks[p]))
        assert torch.equal(gotu[p], tbs.unproject(Vs[p], cs[p], ks[p]))
    calls.clear()
    Vd = [v.double() for v in Vs]
    got = tbs.project_batched(Vd, [x.double() for x in ws], ks)
    assert calls == []
    for p in range(3):
        assert torch.equal(got[p], tbs.project(Vd[p], ws[p].double(), ks[p]))


@pytest.mark.parametrize("orth", ["cgs", "cgs2", "mgs2", "cgsir"])
@pytest.mark.parametrize("flag", [False, True])
def test_batched_orthonormalize_is_the_one_problem_one(orth, flag, flag_on):
    """Each problem of ``orthonormalize_batched`` bit for bit its
    one-problem ``orthonormalize``, flag off and on, for the batched cgs
    family and the per-problem others."""
    tbs.use_pallas_projections = flag
    V, w, _ = _stack(6, P=3)
    # orthonormal bases, as a Krylov basis is
    Vs = [torch.linalg.qr(torch.from_numpy(Vp).reshape(KMAX, -1).T)[0].T.reshape(KMAX, R, 128)
          .contiguous() for Vp in V]
    ws = list(torch.from_numpy(w))
    ks = [4, 13, 9]
    alg = getattr(kt, orth)
    outs = ton.orthonormalize_batched(ws, Vs, ks, alg)
    for p in range(3):
        v1, b1, c1 = ton.orthonormalize(ws[p], Vs[p], ks[p], alg)
        v, b, c = outs[p]
        assert torch.equal(v, v1) and torch.equal(b, b1) and torch.equal(c, c1)
