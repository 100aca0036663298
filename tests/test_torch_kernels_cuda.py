"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions on the card — the pytest form of ``chip_smoke.py``'s kernel phase.
Needs an NVIDIA GPU (marker ``cuda``; skipped elsewhere).  Imports no JAX.

    python -m pytest tests/test_torch_kernels_cuda.py -q     # on a machine with a card
"""

import pytest
import torch

from krylovkit_tpu_torch import _build
from krylovkit_tpu_torch.ops import basis as bs
from krylovkit_tpu_torch.ops import fused_lanczos as fl
from krylovkit_tpu_torch.ops.operator import GridStencilOperator, StencilOperator

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

POISSON_OFF = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
POISSON_CF = (4.0, -1.0, -1.0, -1.0, -1.0)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


# B > 32 reaches the kernel's wider register instantiations: KACC 64 with
# drift (B <= 63), KACC 64 and 128 without (B <= 126)
WIDE = [(64, 40, True), (64, 50, False), (127, 100, False)]


@pytest.mark.parametrize(
    "kind,B,with_drift,kmax",
    [(kind, B, drift, 31)
     for kind, B in [("chain", 1), ("chain", 4), ("chain", 29), ("chain_multirow", 8), ("grid", 16)]
     for drift in (False, True)]
    + [("chain", B, drift, kmax) for kmax, B, drift in WIDE],
)
def test_fused_step_kernel_matches_plain(kind, B, with_drift, kmax):
    if kind == "chain":
        op, R = StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0)), 1000  # ragged last block
    elif kind == "chain_multirow":
        op, R = StencilOperator((-300, -1, 0, 1, 300), (0.1, -1.0, 2.0, -1.0, 0.2)), 256
    else:
        op, R = GridStencilOperator((256, 1024), POISSON_OFF, POISSON_CF), 2048
    spec = fl.spec_for(op)
    kp1 = B
    gen = _gen(B)
    V = torch.randn((kmax, R, 128), generator=gen, device="cuda")
    y = torch.randn((R, 128), generator=gen, device="cuda")
    g = torch.randn(kmax + 1, generator=gen, device="cuda")
    Vk, Vr = V.clone(), V.clone()
    before = _build.launches["fused_step"]
    yk, rk = fl.fused_step(Vk, y, g, kp1, B, spec, with_drift)
    assert _build.launches["fused_step"] == before + 1
    yr, rr = fl.fused_step_reference(Vr, y, g, kp1, B, spec, with_drift)
    torch.cuda.synchronize()
    assert torch.equal(Vk[:kp1], V[:kp1]) and torch.equal(Vk[kp1 + 1:], V[kp1 + 1:])
    sc = float(yr.abs().max())
    assert float((Vk[kp1] - Vr[kp1]).abs().max()) <= 2e-4 * sc
    assert float((yk - yr).abs().max()) <= 2e-4 * sc
    torch.testing.assert_close(rk, rr, rtol=2e-4, atol=2e-3 * R ** 0.5)
    # deterministic: the same launch gives the same bits
    yk2, rk2 = fl.fused_step(Vk, y, g, kp1, B, spec, with_drift)
    assert torch.equal(yk, yk2) and torch.equal(rk, rk2)


@pytest.mark.parametrize("kmax,m_out", [(31, 20), (31, 4), (31, 31), (8, 3), (70, 40)])
def test_transform_kernel_matches_plain(kmax, m_out):
    gen = _gen(kmax + m_out)
    V = torch.randn((kmax, 64, 128), generator=gen, device="cuda")
    U = torch.randn((kmax, kmax), generator=gen, device="cuda") / kmax ** 0.5
    before = _build.launches["transform_partial"]
    Vk = bs.transform_partial_inplace(V.clone(), U, m_out)
    assert _build.launches["transform_partial"] == before + 1
    Vr = bs.transform_partial_inplace_reference(V.clone(), U, m_out)
    torch.cuda.synchronize()
    assert torch.equal(Vk[m_out:], V[m_out:])
    torch.testing.assert_close(Vk[:m_out], Vr[:m_out], rtol=1e-5, atol=1e-5)
    eye = torch.eye(kmax, device="cuda")
    assert torch.equal(bs.transform_partial_inplace(V.clone(), eye, m_out), V)


def test_wrappers_raise_instead_of_falling_back():
    V = torch.zeros((8, 16, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        bs.transform_partial_inplace(V, torch.eye(8, device="cuda"), 4)
    spec = fl.spec_for(StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0)))
    V = torch.zeros((8, 16, 128), device="cuda")
    y = torch.zeros((16, 128), device="cuda")
    g = torch.zeros(9, device="cuda")
    with pytest.raises(ValueError):
        fl.fused_step(V, y, g, 3, 5, spec)  # kp1 < B would read the row it writes
    with pytest.raises(ValueError):
        fl.fused_step(V.double(), y.double(), g.double(), 5, 5, spec)
