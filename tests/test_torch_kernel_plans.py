"""PyTorch port: the host-side plans of the two redesigned CUDA kernels, held
on the CPU.  ``plan_step`` sizes the fused-step kernel's shared-memory rings
and grid (``csrc/fused_lanczos.cu``); ``transform_rung`` names the register
tile of the basis rotation (``csrc/transform.cu``).  The kernels run only on
a card (``tests/test_torch_kernels_cuda.py``); what they are told to do is
checked here, with a Python model of the kernel's tile loop that fails when
a ring row is overwritten before its last reader.  Imports no JAX.
"""

import pytest
import torch

from krylovkit_tpu_torch.ops import basis as bs
from krylovkit_tpu_torch.ops import fused_lanczos as fl

torch.set_num_threads(2)

H100_SMEM = 232448  # dynamic shared memory one block may take, bytes
H100_SMEM_PER_SM = 233472
ROWS = (1, 7, 64, 8192, 8200, 16384)
HALOS = (1, 2, 8, 32)


def _live_rows(with_drift):
    # nslots = 2B + 2 (drift) or B + 2 must fit 128 lanes
    return range(1, 64 if with_drift else 127)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("with_drift", [False, True], ids=["nodrift", "drift"])
@pytest.mark.parametrize("h", HALOS)
@pytest.mark.parametrize("R", ROWS)
def test_plan_step_fits_the_card(R, h, with_drift, sms):
    for B in _live_rows(with_drift):
        plan = fl.plan_step(R, B, h, with_drift, sms)
        T, P, NSR, NR = plan.T, plan.P, plan.NSR, plan.NR
        assert T in (1, 2, 4, 8) and 1 <= P <= 8
        if T > 2:
            assert B <= 32  # tiles of 4 and 8 rows exist for the 32-slot kernels only
        # the ring of staged rows: P tiles in flight, the tile being read, and
        # the h rows the reductions lag (unless they re-read global memory)
        assert NSR >= (P + 1) * T + (0 if plan.reread else h)
        # the ring of w' rows: the tile being written and h rows either side
        # of the rows whose y' is formed
        assert NR >= T + 2 * h
        row_bytes = (B + 1) * 4 * fl.LANES
        assert row_bytes % 16 == 0 and (T * row_bytes) % 16 == 0
        assert plan.smem_bytes == fl._step_smem(B, NSR, NR)
        assert plan.smem_bytes % 16 == 0 and plan.smem_bytes <= H100_SMEM
        # runs cover [0, R) exactly once, none empty
        assert plan.run >= 1 and 1 <= plan.nblocks <= 2 * sms
        assert (plan.nblocks - 1) * plan.run < R <= plan.nblocks * plan.run
        if plan.nblocks > sms:  # two blocks share an SM: both must fit it
            assert 2 * (plan.smem_bytes + 1024) <= H100_SMEM_PER_SM and B <= 32
        if plan.nblocks > 1:
            assert plan.run >= max(8, 4 * h)


def _simulate_block(plan, R, h, block):
    """A model of one block of the kernel's tile loop, with the kernel's own
    index arithmetic.  A copy occupies its ring row from the moment it is
    issued (it may land at once) and is readable once waited for.  Returns
    the rows whose y' and reductions the block formed, in order."""
    T, P, NSR, NR = plan.T, plan.P, plan.NSR, plan.NR
    r0 = block * plan.run
    r1 = min(r0 + plan.run, R)
    s0, s1 = r0 - h, r1 + h
    ntiles = -(-(s1 - s0) // T)
    stage = [None] * NSR  # ("flying" | "landed", row)
    ring = [None] * NR
    groups = []

    def issue(base, slot0):
        group = []
        for i in range(T):
            row = base + i
            if row < 0 or row >= R or row >= s1:
                continue
            slot = slot0 + i
            if slot >= NSR:
                slot -= NSR
            assert 0 <= slot < NSR
            stage[slot] = ("flying", row)
            group.append((slot, row))
        groups.append(group)

    def wait(pending):
        while len(groups) > pending:
            for slot, row in groups.pop(0):
                if stage[slot] == ("flying", row):
                    stage[slot] = ("landed", row)

    def advance(x, step, size):
        x += step
        return x - size if x >= size else x

    for k in range(P):
        issue(s0 + k * T, k * T)
    ld_row, ld_slot = s0 + P * T, P * T
    a_row, a_slot, a_ring = s0, list(range(T)), list(range(T))
    b_row = s0 - h
    b_slot = [(ti - h) % NSR for ti in range(T)]
    b_ring = [(ti - h) % NR for ti in range(T)]
    done = []
    for _ in range(ntiles):
        wait(P - 1)
        issue(ld_row, ld_slot)
        ld_row, ld_slot = ld_row + T, advance(ld_slot, T, NSR)
        for ti in range(T):  # pass A
            row = a_row + ti
            if 0 <= row < R and row < s1:
                assert stage[a_slot[ti]] == ("landed", row), (row, stage[a_slot[ti]])
            if row < s1:
                ring[a_ring[ti]] = row
        a_row += T
        a_slot = [advance(x, T, NSR) for x in a_slot]
        a_ring = [advance(x, T, NR) for x in a_ring]
        for ti in range(T):  # pass B
            row = b_row + ti
            if r0 <= row < r1:
                for dq in range(-h, h + 1):
                    slot = b_ring[ti] + dq
                    slot = slot + NR if slot < 0 else slot - NR if slot >= NR else slot
                    assert ring[slot] == row + dq, (row, dq, ring[slot])
                if not plan.reread:
                    assert stage[b_slot[ti]] == ("landed", row), (row, stage[b_slot[ti]])
                done.append(row)
        b_row += T
        b_slot = [advance(x, T, NSR) for x in b_slot]
        b_ring = [advance(x, T, NR) for x in b_ring]
    return done


@pytest.mark.parametrize("with_drift", [False, True], ids=["nodrift", "drift"])
@pytest.mark.parametrize("h", HALOS)
@pytest.mark.parametrize("R", [1, 7, 64, 1000, 8200])
def test_plan_step_rings_hold_every_row_until_its_last_reader(R, h, with_drift):
    seen = set()
    for B in _live_rows(with_drift):
        plan = fl.plan_step(R, B, h, with_drift, 132)
        key = plan[:7]
        if key in seen:  # the loop depends on the plan, not on B
            continue
        seen.add(key)
        for block in {0, plan.nblocks // 2, plan.nblocks - 1}:
            r0 = block * plan.run
            assert _simulate_block(plan, R, h, block) == list(range(r0, min(r0 + plan.run, R)))
    assert seen


@pytest.mark.parametrize("T,P,reread", [(8, 1, False), (4, 2, False), (2, 8, False), (1, 3, False),
                                        (2, 2, True), (1, 1, True)])
@pytest.mark.parametrize("h", HALOS)
def test_tile_loop_model_at_the_least_ring_sizes(T, P, reread, h):
    # the sizes the kernel's entry point accepts at the least: a ring one row
    # shorter must fail the model
    R, run = 300, 75
    NSR, NR = (P + 1) * T + (0 if reread else h), T + 2 * h
    plan = fl.StepPlan(T, P, NSR, NR, reread, run, 4, 0)
    for block in range(4):
        assert _simulate_block(plan, R, h, block) == list(range(block * run, (block + 1) * run))
    with pytest.raises(AssertionError):
        _simulate_block(plan._replace(NR=NR - 1), R, h, 1)
    if NSR > T:
        with pytest.raises(AssertionError):
            _simulate_block(plan._replace(NSR=NSR - 1), R, h, 1)


def test_plan_step_pairs_blocks_where_two_fit_an_sm():
    # small B: two blocks of four-row tiles per SM; wide B: one block
    small, wide = fl.plan_step(16384, 4, 1, True, 132), fl.plan_step(16384, 30, 1, True, 132)
    assert small.nblocks > 132 and small.T == fl.PAIR_TILE_ROWS
    assert wide.nblocks <= 132 and not wide.reread
    # the config-2 grid (h = 8) at its mean B stays resident; B = 63 re-reads
    assert not fl.plan_step(8192, 16, 8, True, 132).reread
    assert fl.plan_step(8192, 63, 8, True, 132).reread
    with pytest.raises(ValueError):
        fl.plan_step(8192, 64, 1, True, 132)  # 2B + 2 slots do not fit 128
    with pytest.raises(ValueError):
        fl.plan_step(8192, 4, fl.MAX_HALO + 1, False, 132)


@pytest.mark.parametrize("B", range(0, 32))
def test_plan_step_fused_gkl_grid(B):
    """The fused GKL solve on the 1024×1024 grid (h = 8, drift on) launches
    with B = k over V (B = 0 at the first step of a solve: ``y`` alone is
    staged) and B = k + 1 over U, up to 31: every plan fits one
    block's shared memory without re-reading, the pair plan holds up to
    B = 11, and the tile loop visits every row."""
    R, h = 8192, 8
    plan = fl.plan_step(R, B, h, True, 132)
    assert plan.smem_bytes <= H100_SMEM and not plan.reread
    assert (plan.nblocks > 132) == (B <= 11)
    if B <= 11:
        assert plan.T == fl.PAIR_TILE_ROWS and 2 * (plan.smem_bytes + 1024) <= H100_SMEM_PER_SM
    assert fl._raw_len(B, True) <= fl.LANES
    for block in {0, plan.nblocks - 1}:
        r0 = block * plan.run
        assert _simulate_block(plan, R, h, block) == list(range(r0, min(r0 + plan.run, R)))


@pytest.mark.parametrize("with_drift", [False, True], ids=["nodrift", "drift"])
@pytest.mark.parametrize("h", HALOS)
def test_plan_step_without_a_live_row(h, with_drift):
    # B = 0 (the first domain half-step of a fused GKL solve): a staged row is
    # y alone, 512 bytes; two blocks share an SM and the loop visits every row
    for R in ROWS:
        plan = fl.plan_step(R, 0, h, with_drift, 132)
        assert plan.T == fl.PAIR_TILE_ROWS and not plan.reread
        assert plan.smem_bytes == fl._step_smem(0, plan.NSR, plan.NR)
        assert 2 * (plan.smem_bytes + 1024) <= H100_SMEM_PER_SM
        assert (plan.nblocks - 1) * plan.run < R <= plan.nblocks * plan.run
        for block in {0, plan.nblocks - 1}:
            r0 = block * plan.run
            assert _simulate_block(plan, R, h, block) == list(range(r0, min(r0 + plan.run, R)))
    with pytest.raises(ValueError):
        fl.plan_step(8192, -1, h, with_drift, 132)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kmax", [1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128])
def test_transform_rung(kmax, dtype):
    kreg, cols = bs.transform_rung(kmax, dtype)
    assert kreg in (16, 32, 64, 128) and kreg >= kmax and kreg % 4 == 0
    assert kreg == min(k for k in (16, 32, 64, 128) if k >= kmax)
    assert kreg * cols <= 128  # values a thread keeps in registers
    word = cols * torch.empty((), dtype=dtype).element_size()
    assert word in (2, 4, 8)  # one load per row and thread
    # every eligible basis (R % 8 == 0) splits into whole groups of `cols`
    # columns on 16-byte aligned rows, and U[:, :m_out] padded to kreg floats
    # fits shared memory for every m_out
    for R in (8, 64, 8192, 16384):
        assert (R * 128) % cols == 0 and (R * 128) % 4 == 0
    assert kmax * kreg * 4 <= 64 * 1024


def test_transform_rung_bounds():
    for bad in (0, 129):
        with pytest.raises(ValueError):
            bs.transform_rung(bad)
    assert bs.transform_rung(31) == (32, 1) and bs.transform_rung(31, torch.bfloat16) == (32, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_transform_partial_inplace_on_cpu_is_the_plain_version(dtype):
    gen = torch.Generator().manual_seed(3)
    V = torch.randn((9, 8, 128), generator=gen).to(dtype)
    U = torch.randn((9, 9), generator=gen) / 3
    big = torch.zeros((18, 18))
    big[::2, ::2] = U
    out = bs.transform_partial_inplace(V.clone(), big[::2, ::2], 5)  # a strided view of U
    want = bs.transform_partial_inplace_reference(V.clone(), U, 5)
    assert out.dtype == dtype and torch.equal(out, want) and torch.equal(out[5:], V[5:])
