#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``krylovkit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--parent DIR]
    python3 chip_smoke.py --kernel-times [--root DIR]

Phases, each printing one JSON line; any failure raises and exits non-zero
without the final ``ok`` line:

1. device  — torch and CUDA versions, the card's name and power limit
   (``nvidia-smi``), the TF32 flags (must be off);
2. build   — compiles every kernel of ``krylovkit_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel);
3. kernels — each of the six kernels against its plain PyTorch version on
   the card at the shapes of the paths below, with its tolerance or bit-identity
   contract, its time (CUDA events), the plain version's time, a yardstick
   PyTorch call where one computes the same function, and its bound on the
   card; K1 also at the edges of its plan (B = 1, 2, the wide-B
   instantiations, ragged and tiny R, kp1 > B, the re-reading plan) and
   twice (bit-equal), and with non-zero external halos (a rank's block:
   chain and grid, timed beside the launch without them), K2 on every rung of its ladder and in bfloat16; then
   `kernel_times`: K1 over the main path's schedule of B, each time beside
   the parent tree's where ``--parent`` is given;
4. small   — the port's eigsolve on a small Laplacian, on the card against
   the same solve on the CPU (plain versions);
5. main    — the port's Lanczos eigsolve at the bench configuration
   (``laplacian_1d(2**21)``, 4 eigenpairs "LM", krylovdim 30, maxiter 10,
   f32 ``(n/128, 128)`` vectors, default cgs2): launch counts of one solve,
   then 3 timed solves and the nnz/s metric of ``bench.py``;
6. small_linsolve — each linear solver on small banded Poisson systems in
   float64 (and fused GMRES in float32), on the card against the same solve
   on the CPU;
7. config2 — the linear solvers at the config-2 size (``poisson_2d(1024,
   1024)``, f32 ``(8192, 128)`` vectors; ``benchmarks/run_all.py``'s three
   solves, two of them again on the same matrix as a ``BandedOperator``, and
   BiCGStab on ``laplacian_1d_pallas(2**21)``): per solve, launch counts of
   one solve, then 3 timed solves, one JSON line each;
8. small_arnoldi — the Krylov-Schur Arnoldi solvers on a small
   non-symmetric stencil, on the card against the same solve on the CPU:
   ``schursolve`` fused, the same matrix as a ``BandedOperator`` with the
   projection kernels on, ``eigsolve`` on it, and a complex64 ``schursolve``
   on a dense matrix;
9. config4_arnoldi — ``benchmarks/run_all.py``'s config-4 Arnoldi solve at
   full size (transport-diffusion stencil, n = 2^20, f32 ``(8192, 128)``
   vectors, ``schursolve`` 4 "LM", krylovdim 30, maxiter 8, default cgs2):
   the stencil (fused), the same matrix as a ``BandedOperator`` with the
   projection kernels on, and with them off; per solve, launch counts of one
   solve, then timed solves, one JSON line each; then the time of each
   dense Schur processing round of one more fused solve;
10. small_svd_exp — ``svdsolve`` (fused on a chain and on a grid stencil,
   unfused on a dense float64 matrix), ``lssolve`` and ``exponentiate``
   (fused and unfused) at small sizes, on the card against the same solve
   on the CPU;
11. small_geneig_block — ``geneigsolve`` on the banded Q1 finite-element
   pencil (32×32 grid, float64, "SR" and "LR", the projection flag off and
   on; a 16×64 grid whose counts must match; float32 with the projection
   kernels) and on a callable dense pencil, Block Lanczos on the banded
   32×32 Poisson matrix (block of 4), each on the card against the same
   solve on the CPU; the ELL operator of the 1024×1024 Q1 stiffness (card
   against CPU, ``ell_to_banded`` against ``banded_from_coo``); complex64
   and complex128 ``BandedOperator`` applies (the plain version, no K3);
12. config3 — ``benchmarks/run_all.py``'s two GKL ``svdsolve`` solves at
   full size (8 triplets "LR", krylovdim 30, maxiter 12): the rectangular
   ``(A, Ah)`` map (rows 2^20, cols 2^19; unfused, K2 only; once more with
   the projection kernels on) and the 1024×1024 advection-diffusion grid
   stencil (fused: K1 with the normal spec over V and the adjoint spec over
   U, K2), held against an unfused solve of the same stencil; then the time
   of each projected-SVD round;
13. config4_expm — ``benchmarks/run_all.py``'s ``exponentiate`` step
   (−Laplacian stencil, n = 2^20, t = 0.1, krylovdim 30, tol 1e-4; fused:
   K1 in Lanczos mode), held against an unfused solve; then the time of
   each evaluation of the augmented exponential;
14. geneig — ``geneigsolve`` on the Q1 pencil of the 1024×1024 grid (n =
   2^20, nine offsets each, float32 ``(8192, 128)`` vectors, 4 "SR",
   krylovdim 30, maxiter 8): first K3 on both operators and K5/K6 on the
   solve's (37, 8192, 128) basis against their plain versions (line
   ``kernels_geneig``); then K3 twice per counted apply, with the
   projection kernels off and on (K5 and K6 once per cgs2 sweep); one
   metric line each, held against the analytic spectrum, the vectors'
   Rayleigh quotients and fresh residuals;
15. block_lanczos — Block Lanczos (block of 4, 4 "LR", krylovdim 30,
   maxiter 8) on config 2's Poisson matrix, banded (K3 per apply) and as
   the grid stencil; one metric line each;
16. small_ad — every AD route (``linsolve`` with a GMRES and a CG rule;
   ``eigsolve`` Lanczos and Arnoldi with a GMRES rule and with the
   Sylvester rule; ``svdsolve`` with both; a ``ParametricOperator``; bare
   callables in ``svdsolve``/``lssolve`` through ``with_adjoint_from``; the
   dict-vector eigsolve of the reference's ``test/issues.jl``) in float64
   and complex128 at the sizes of ``tests/test_ad.py``, on the card against
   the CPU: gradients within 1e-8 (relative), counts equal;
17. ad_impurity — the four bound states of config 2's banded Poisson matrix
   plus four wells (n = 2^20, float32 ``(8192, 128)`` vectors, 4 "SR",
   krylovdim 30, maxiter 10, tol 1e-5) as a ``ParametricOperator`` of the
   potential, and the gradient of their sum through the GMRES rule: forward
   and backward ms and launches (K3 = numops in the forward, K2 per
   round and extraction; no K1, K5, K6), Hellmann–Feynman and a central
   difference; again with the projection kernels on (K5/K6 in the forward's
   single-leaf sweeps, none in the backward's tuple sweeps), and K2 once on
   a ``((31, 8192, 128), (31, n))`` tuple basis;
18. ad_potential — ``linsolve`` of ``(0.5 + P + diag g) x = 1`` by CG at the
   same width and the gradient of ``⟨c, x⟩`` in ``b`` and ``g``: held
   against an independent solve for ``c``; K3 once per apply;
19. small_bieig_iter — ``bieigsolve`` on a dense 64 × 64 matrix and a
   banded 128-point non-symmetric tridiagonal in real and complex mode,
   every iterator (10 expansions) and ``Lanczos(reorth="selective")``
   against full reorthogonalization (200 × 200), float64 and complex128,
   on the card against the CPU: within 1e-10, counts and sweeps equal;
20. bieig — ``bieigsolve`` at config 4's width (the banded transport-
   diffusion tridiagonal, n = 2^20, float32, 4 "LM", krylovdim 30, maxiter
   :data:`BIEIG_ITERS` = 2, cut from 8 for the script's time budget), the projection kernels off and on: K3 = ``numops`` (half on the
   adjoint's planes), with the flag K5 = 3·numops + 4·numiter − 2 and K6 =
   2·numops; then the ms of each dense round (two Schur decompositions, two
   sorts);
21. lanczos_variants — config 2's Poisson plus the four wells of phase 17
   as a plain ``BandedOperator``: ``eigsolve`` with full and selective
   reorthogonalization, the flag off and on (4 values within 1e-4 of
   phase 17's; K3 = ``numops``, K2 = rounds + 1, with the flag K5 = K6 =
   the drift sweeps); ``LanczosIterator`` with the full basis and the
   3-term recurrence (peak memory of each), ``ArnoldiIterator``,
   ``BiArnoldiIterator`` and ``GKLIterator`` on config 4's banded matrix
   and ``BlockLanczosIterator`` on the Poisson matrix, 30 expansions each;
22. small_sharded — the distribution layer's scenarios (``SMALL_SHARDED``
   of ``sharded_cases``: the sharded ELL apply, Lanczos, LSMR, GKL, the
   fused Lanczos and GMRES on ``shard_local_stencil``, batched GMRES on a
   ``batch 2 × vec 1`` mesh, the sharded K5 projection) on two ranks of one
   gloo group with CUDA tensors, against the same on two CPU ranks run at
   the same time: float64 within 1e-12, counts equal, K1/K2/K5 launched on
   every card rank; then (line ``small_sharded_batched``, in the same rank
   processes) the batched drivers on a sharded space
   (``SMALL_SHARDED_BATCHED`` of ``sharded_batched_cases``, four problems on
   a ``batch 1 × vec 2`` mesh: fused Lanczos, ``schursolve``,
   ``exponentiate`` and GMRES, and ``eigsolve_arnoldi`` with the
   projection flag) on two card ranks against two CPU ranks: within
   1e-12 (float32 2e-4), counts equal, batched K1 (with every problem's
   halos) and batched K5/K6 on every card rank, no one-problem launch;
   and the batched GKL ``svdsolve``, LSMR, Golub-Ye, BiArnoldi and Block
   Lanczos (``SMALL_SHARDED_BATCHED_SOLVES``, float64, two problems,
   capped by ``SMALL_SHARDED_BATCHED_CAPS``), the eager and selective
   batches and the tree batches (CG, GMRES, Lanczos on ``(p, q)`` tuples,
   ``SHARDED_BATCHED_TREE``, capped alike), each problem bit-identical to
   its one-problem sharded solve on the card ranks too;
23. nccl_mesh1 — one rank over NCCL, ``make_mesh(1)``: the halo plan is
   communication-free and the sharded ELL apply equals ``sparse.from_coo``'s
   bit for bit;
24. config5 — BASELINE config 5 on two gloo ranks: the 1.07e8-nnz banded SPD
   matrix of ``tools/bench_planner.py`` (n = 2^21, float32, ``tile=128``)
   through Lanczos (4 "LM", krylovdim 30, maxiter 8, tol 1e-30) with the
   projection kernels off and on, and LSMR on ``rect_sparse_coo(2^21, 2^20,
   8)`` (40 iterations), each against the one-rank ``sparse.from_coo`` solve
   on the card: counts equal, values within 1e-4, K2 (and K5/K6) launches
   per rank equal to the one-rank solve's; planning seconds, the halo plan,
   collectives and their ms in the timed solve, the slowest rank's ms;
25. sharded_fused — config 1 on ``shard_local_stencil(laplacian_1d(2^21))``
   and config 2's ``gmres30_poisson_2d`` on the sharded 1024² grid, two gloo
   ranks: K1 per rank with the neighbours' edge rows as external halos
   (138 / K1 128 / K2 11 and 421 / K1 406 per rank, values within 1e-4 of
   phase main's, true residual within 1e-3 of phase config2's); config 1
   for phase 30's first 4 starts through ``eigsolve_lanczos_batched`` on the
   same ranks (every problem 138 / 10, 128 ``fused_step_batched`` with every
   problem's halos and 11 ``transform_partial_batched`` per rank, no
   one-problem K1, within 1e-4 of the one-rank batched solve, problem 0 of
   phase main's; its all-reduces beside four one-problem solves'), then the
   batched K1 with halos at a rank's width (P = 4, B = 4, 16, 29) against
   its plain version and one-problem launches with halos, ms and bound;
   then phase 36's config-1 tree batch on the same ranks (2 starts, each
   rank's block a tuple of two row leaves, maxiter
   :data:`SHARDED_TREE_ITERS` = 2, cut from phase 36's 8 for the phase's
   time) against each problem's one-problem sharded tree solve: the same
   bits and counts, the space's all-reduces kind by kind one problem's (and
   a norm a start), the tree map's halo rounds the problems' sum, batched
   K2 only;
26. small_front_ends — the front-ends of ``front_end_cases`` on a sharded
   space (MINRES, BiCGStab, ``exponentiate`` unfused and fused,
   ``expintegrator``, ``geneigsolve``, ``bieigsolve``, Block Lanczos,
   MINRES on a dict vector, the five iterators; float64 at n = 832, the
   fused ``exponentiate`` float32 at 2^15) on two card ranks against two
   CPU ranks run at the same time: within 1e-12 (float32 2e-4), counts
   equal, every rank the same bits, K1 launched per card rank;
27. sharded_front_ends — at full width on two ranks, each solve against the
   same solve on one rank, the projection kernels on in both: config 5's
   operator (planned once a rank) through Block Lanczos (4 "LM", b = 4,
   krylovdim 30, maxiter :data:`FE_BLOCK_ITERS` = 4, cut from 8 for the
   script's time budget), MINRES and BiCGStab (b = ones, tol 1e-6,
   maxiter 10 and 5), ``geneigsolve`` with a diagonal SPD ``B`` (4 "SR",
   krylovdim 30, maxiter 4, tol 1e-30) and 30 ``LanczosIterator``
   expansions; ``bieigsolve`` on config
   4's tridiagonal (n = 2^20, the parameters of phase 20, maxiter
   :data:`BIEIG_ITERS`; the adjoint plan); the fused ``exponentiate`` of config 4 on ``shard_local_stencil``
   (K1 per rank).  Counts, launches per rank and every rank's bits equal,
   values within 1e-4, the linear solves' true residuals within 1e-3; the
   slowest rank's ms, the collectives (by kind) and their ms, the one-rank
   ms.  Then the batched half, :data:`FE_BATCH_P` = 2 problems a solve on
   the same ranks (problem 0 the phase's own start), warmed up once at one
   iteration each and then timed at :data:`FE_BATCHED_ITERS`: Block
   Lanczos and Golub-Ye on config 5's operator, BiArnoldi, GKL ``svdsolve``
   and LSMR on config 4's tridiagonal; problem 0 bit for bit its
   one-problem sharded solve (the phase's own where it ran one), batched
   K2/K5/K6 only and as many as predicted, fewer all-reduces than P
   one-problem solves (by kind beside them);
28. pytree_drivers — small float64 tree solves (``svdsolve`` from a dict
   domain to a tuple codomain, ``lssolve`` with λ, ``geneigsolve``,
   ``expintegrator`` with three vectors, Block Lanczos on a ``Block`` of
   dicts) on the card against the CPU within 1e-12; then at full width,
   every vector cut into two leaves by rows: config 3's rectangular map
   through ``svdsolve`` (K2 per leaf) and config 4's ``exponentiate``
   against phases 12 and 13, the 1024² Q1 pencil through ``geneigsolve``
   and config 2's banded Poisson through Block Lanczos (float64, K3)
   against single-tensor solves: within 1e-4, counts equal where the
   solves run to ``maxiter``;
29. sharded_ad — gradients of sharded solves at config 2's width: the
   four bound states of the 1024² Poisson stencil plus the wells of phase
   17 (a ``ParametricOperator`` around ``shard_local_stencil(poisson_2d)``,
   the wells' block a rank's parameter) and the gradient of their sum by
   the GMRES rule, then with the projection kernels on by the Sylvester
   rule; fused GMRES(30) on ``(0.5 + P) x = 1`` for two cycles and the
   gradient of ``⟨c, x⟩`` in ``b`` and ``a0``; the adjoint derived across
   the ranks.  Two gloo ranks against one rank: Hellmann–Feynman per rank
   and the joined gradients within 1e-3, values and the linsolve's
   gradients within 1e-4 (``ā0`` summed over the ranks), counts equal,
   K1 per rank in the linsolve's forward and K5/K6 per rank in the flag-on
   forward equal to one rank's, none on the backward's tuple solves (K5 in
   the Sylvester operator's projection on the eigenvectors, as one rank
   launches it); forward and backward
   ms of the slowest rank, the collectives and their ms, the one-rank ms;
30. batched — ``P`` problems in one host loop: config 1 for 8 start
   vectors (phase 5's ``x0`` and 7 seeded) through
   ``eigsolve_lanczos_batched`` (every problem 138 / 10, values within
   2e-2 of 4, problems 0 and 1 within 1e-5 of their one-problem solves,
   exactly 128 ``fused_step_batched`` and 11 ``transform_partial_batched``
   launches, no one-problem K1/K2), config 2's shifted GMRES(30) for 4
   right-hand sides through ``linsolve_gmres_batched`` (converged, true
   residuals within tol, counts equal to one-problem solves), and the
   batched K1/K2 at these widths against their plain versions and
   bit-identical to one-problem launches, ms per launch beside the
   one-problem launches' and the bound;
31. batched_linear — ``P`` linear systems in one host loop per solve:
   CG and MINRES on config 2's banded Poisson (n = 2^20, float32, a0 = 0.5;
   fixed work, 40 steps) for 8 right-hand sides (ones and ``ones +
   0.05·normal``), BiCGStab on ``laplacian_1d_pallas(2^21)`` for 8 (tol
   1e-3: every problem converged with its true residual within tol), CG on
   4 banded Poissons with their planes scaled by ``1 + 0.1·p``; each
   problem's counts equal to its one-problem solve's and ``x`` within
   1e-5, each batched apply one
   ``banded_spmv_batched`` or ``laplacian_1d_batched`` launch, each
   problem's applies equal to its ``numops``, no one-problem K3/K4; then
   the batched K3 (shared and per-problem planes, float32 and float64,
   five and three offsets) and K4 against one-problem launches (bit for
   bit) and their plain versions, warm and cold ms, the bound, the plain
   version's and the library's ms (cuSPARSE SpMM / SpMV, cuDNN conv1d);
32. batched_arnoldi — config 4 for 4 starts (phase 30's) in one host loop
   per solve: ``schursolve_batched`` on the transport-diffusion stencil
   (fused: batched K1 and K2), ``eigsolve_arnoldi_batched`` on it as a
   ``BandedOperator`` with the projection kernels on (batched K3, K5, K6
   and K2), both fixed work (krylovdim 30, maxiter 3), and
   ``exponentiate_batched`` of the (1, −2, 1) chain (fused: batched K1,
   one launch per distinct live-row count; again unfused with mgs2): each
   problem's counts equal its one-problem solve's and its values within
   1e-5 (on the banded path problems 0 and 1 only, for the phase's
   budget), exactly the batched launches the one-problem solves' rounds
   give (the banded path: its own steps), no one-problem K1, K2, K3, K5 or
   K6;
   then the batched K5 and K6 at 8 bases (k = 18, 30, mixed) against
   one-problem launches (every row bit for bit) and their plain versions,
   warm and cold ms, the 8 one-problem launches, ``torch.bmm`` and the
   bound; untimed at 70 problems (two launches) and with every k = 0;
33. batched_gkl — config 3 for 4 starts in one host loop per solve:
   ``svdsolve_gkl_batched`` on the advection grid stencil (fused: batched
   K1 over both stacks, batched K2) and through the rectangular map with
   the projection kernels on (batched K5, K6 and K2), fixed work
   (krylovdim 30, maxiter 3); ``lssolve_lsmr_batched`` on config 2's
   banded Poisson for 8 right-hand sides (40 iterations; one batched K3
   launch per normal or adjoint apply); each compared problem's counts
   equal its one-problem solve's and its results bit-identical, exactly
   the batched launches the one-problem rounds give, no one-problem K1,
   K2, K3, K5 or K6; then the batched K1 on the adjoint grid spec (B = 0,
   18 and mixed) and the batched K3 on adjoint planes;
34. batched_geneig_bieig — (a) ``geneigsolve_golubye_batched`` on the
   1024² Q1 pencil of phase 14 (K and M two shared banded operators, nine
   offsets each) for 4 starts (phase 14's and ``default_rng(101–103)``),
   4 "SR", krylovdim 30, maxiter 8, tol 1e-30 (fixed work), the projection
   flag off, then on: every problem 240 / 8, 480 ``banded_spmv_batched``
   launches (two a batched apply of the pencil, each problem's batched
   pencil applies 240), with the flag 494 ``project_batched`` and
   ``unproject_batched`` (the one-problem solve's K5/K6), each Rayleigh
   quotient within 1e-4; (b) ``bieigsolve_batched`` on config 4's
   tridiagonal (n = 2^20, its adjoint planes) for 4 ``(v0, w0)`` pairs
   (phase 20's and ``default_rng(101–103)`` / ``(111–113)``), 4 "LM",
   krylovdim 30, tol 1e-30, the flag on, maxiter 2 (cut from the 8 phase
   20 then ran, for the phase's budget): ``numops`` even in 84..96, batched K3 = the
   largest ``numops``, batched K5/K6 as
   :func:`bieig_predicted_projections` on the batch's lock-steps, every
   ``|λ| <= 4 + ‖A v − λ v‖/‖v‖``; on both, problems 0 and 1 bit-identical
   to their one-problem solves and no one-problem K3, K5 or K6; then the
   batched K3 on the Q1 pencil's two nine-offset plane sets at ``P = 4``
   (warm and cold, 4 one-problem launches, the bound, the plain version,
   cuSPARSE SpMM), bit-identical to one-problem launches;
35. batched_block_lanczos — ``eigsolve_blocklanczos_batched`` on phase
   15's problem (config 2's banded Poisson, n = 2^20, float32, block of 4,
   4 "LR", krylovdim 30, maxiter 8, tol 1e-30: fixed work) for 4 start
   blocks (phase 15's and ``default_rng(101–103)``): the shared planes with
   the projection flag off and on, and a plane set per problem (scaled by
   ``1 + 0.1·p``); every problem 112 / 8 and bit-identical to its
   one-problem solve, exactly 28 ``banded_spmv_batched`` launches of 16
   rows (one a lock-step) and with the flag 232 ``project_batched`` (the
   block QRs' column passes), no one-problem K3 or K5; then the batched K3
   at those 16 rows (shared and per-problem planes, warm and cold, 16
   one-problem launches, the bound, the plain version, cuSPARSE);
36. batched_pytree — batched solves on pytree vectors, each vector cut
   into two leaves by rows and the operator a callable on the trees (the
   unfused lock-step): config 1 (n = 2^21, float32, two (8192, 128)
   leaves of a tuple, 4 "LM", krylovdim 30, maxiter 8, tol 1e-30) for
   phase 30's first 2 starts through ``eigsolve_lanczos_batched``, and
   config 3's rectangular map from a dict domain to a tuple codomain
   through ``svdsolve_gkl_batched`` (8 "LR", krylovdim 30, maxiter 3, 2
   starts): each problem's counts equal its one-problem tree solve's and
   its values, vectors and residuals bit-identical to it, config 1's
   values within 2e-2 of 4; exactly the one-problem tree solve's K2 count
   as ``transform_partial_batched`` (one launch per leaf per rotation), no
   one-problem kernel; then small float64 tree batches (2 problems)
   through every other batched driver, card within 1e-12 of the CPU,
   counts equal, each problem bit-identical to its one-problem tree solve
   on the card;
37. batched_eager_selective — the batched drivers with ``eager=True`` and
   ``Lanczos(reorth="selective")`` at full width, float32 ``(R, 128)``:
   selective Lanczos (krylovdim 30, maxiter 10, tol 1e-5, 4 "SR") on phase
   21's impurity operator for 4 starts, the projection flag off and on
   (each problem's counts, sweeps and bits its one-problem ``eigsolve``'s;
   one batched K3 a lock-step, one batched K2 a round and one for the
   extraction, with the flag one batched K5 and K6 a sweeping lock-step),
   eager Lanczos on it (batched K2 = restarting lock-steps + 1), eager
   ``schursolve`` (krylovdim 5, maxiter 2) and one round of eager
   BiArnoldi (krylovdim 4) on config 4's banded chain for 2 starts, eager
   GKL (krylovdim 10, maxiter 2) on config 3's rect map for 2 starts, and
   an eager ``exponentiate`` of config 4's chain for 4 starts against the
   fused batch (1e-4): counts and bits per problem, the batched launches
   predicted, no one-problem kernel and no K1; then small float64 eager and
   selective batches card against CPU (phase 22's rank group also runs the
   sharded eager and selective scenarios, ``SHARDED_BATCHED_EAGER``);
38. batched_ad — gradients through batched solves (``ad/batched.py``) at
   config 2's width (n = 2^20, float32 ``(8192, 128)``): the wells of
   phase 17 with their depths scaled by 1, 1.1, 1.2, 1.3, a banded
   operator a problem with ``g_p`` on its main plane (batched K3 with a
   plane set per problem in the forward), through
   ``eigsolve_lanczos_batched`` (4 "SR") and the gradient of the sum of
   the values by the GMRES rule (the 16 bordered systems in one batched
   GMRES, one-problem K3 a backward apply) and by the Sylvester rule (4
   eigensolves on ``(w, x)`` tuples in one batched Arnoldi): per problem
   phase 17's guards and within 1e-4 of its one-problem ``eigsolve``
   gradient; phase 18's system for 4 right-hand sides through
   ``linsolve_cg_batched`` (``b_p.grad`` and the shared ``g.grad`` against
   independent solves; one batched K3 a lock-step forward and backward);
   small float64 batches (the GMRES, MINRES and BiCGStab rules, the
   general Sylvester rule, both GKL rules) card against CPU within 1e-8,
   counts equal.  Phase 25 also runs phase 36's config-1 tree batch on the
   two ranks (``SHARDED_TREE_ITERS``) against each problem's one-problem
   sharded tree solve, and phase 22 the small sharded tree batches
   (``SHARDED_BATCHED_TREE``);
39. profile (only with ``--profile``) — one more config-1 solve and one
   more fused config-4 solve under ``torch.profiler``: device busy time and idle share, device ops, host
   reads of device scalars, device time by kernel name.

The ranks of phases 22-27 and 29 are spawned processes (``start_ranks``) joined
through a ``FileStore`` in a temporary directory, each collective bounded
by a 120 s timeout; a failed rank fails the script.  One card serves every
rank, so these phases measure correctness and the cost of the collectives,
not scaling.

``--parent DIR`` names an unpacked earlier tree of this repository: its K1
and K2 are then built and timed on the same card at the same shapes, in a
process of their own before and after this tree's kernels phase, and
printed as ``parent_ms`` beside ``ms`` (without it ``parent_ms`` is null).
``--kernel-times`` is that process: it times K1 and K2 of the package under
``--root`` (default: this tree) and prints one JSON line.

Each path (phases 5, 7, 9, 12, 13, 14, 15, 17, 18, 20, 21, 24, 25, 27,
28, 29, 30, 31, 32, 33, 34, 35, 36, 37 and 38, one solve or iterator at a time, the forward and the backward of
a differentiable solve apart; in 24, 25, 27 and 29 in every rank) is
driven with the launch counts set to 0 just before it and read just after.
Then the kernel summary line, the ``nvidia-smi`` name/power line, and as
the last line
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 and float64
# (non-tensor-core) rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
SLEEP_CYCLES = 20_000_000  # busy-wait queued ahead of timed launches


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_ms(torch, fn, reps=10, batches=3):
    """Median per-launch device time of ``fn`` over ``batches`` runs of
    ``reps`` launches.  A busy-wait kernel is queued first so the host
    enqueues the launches before the card reaches them: the events then
    time the kernels, not the host's launch overhead."""
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cold_device_ms(torch, fn, flush):
    """Per-launch device time of ``fn`` with the 50 MB L2 cache flushed
    before each launch (``flush`` is a 128 MB buffer written in between),
    less the flush's own time.  Back-to-back launches of a kernel whose
    working set fits L2 find their inputs there; this finds them in HBM."""
    return device_ms(torch, lambda: (flush.zero_(), fn())) - device_ms(torch, flush.zero_)


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_flops(n, B, ntaps, with_drift):
    # subtract (B FMAs + 2), stencil (ntaps FMAs), reductions (B or 2B FMAs + 2)
    return n * (2 * B + 2 + 2 * ntaps + (4 * B if with_drift else 2 * B) + 4)


def check_fused_step(torch, fl, op, R, kmax, B, kp1, with_drift, gen, timed=True, adjoint=False,
                     ext=False):
    """K1 against its plain version on the card, and against itself on a
    second launch (bit-equal); returns the case record, with times and the
    bound where ``timed``.  ``adjoint`` takes the spec of ``op``'s adjoint.
    ``ext`` gives both non-zero external halos (``Vext``, ``yext``: a shard
    of a split vector) and, timed, also times the launch without them on the
    same inputs (``ms_null``)."""
    dev = "cuda"
    spec = fl.adjoint_spec(op) if adjoint else fl.spec_for(op)
    V = torch.randn((kmax, R, 128), generator=gen, device=dev)
    y = torch.randn((R, 128), generator=gen, device=dev)
    g = torch.randn(kmax + 1, generator=gen, device=dev)
    halos = {}
    if ext:
        halos = {"Vext": torch.randn((kmax, 2, spec.h, 128), generator=gen, device=dev),
                 "yext": torch.randn((2, spec.h, 128), generator=gen, device=dev)}
    Vk = V.clone()
    yk, rawk = fl.fused_step(Vk, y, g, kp1, B, spec, with_drift, **halos)
    Vr = V.clone()
    yr, rawr = fl.fused_step_reference(Vr, y, g, kp1, B, spec, with_drift, **halos)
    torch.cuda.synchronize()
    others = torch.equal(Vk[:kp1], V[:kp1]) and torch.equal(Vk[kp1 + 1:], V[kp1 + 1:])
    require(others, f"fused_step B={B}: rows other than kp1 bit-identical")
    V2 = V.clone()
    y2, raw2 = fl.fused_step(V2, y, g, kp1, B, spec, with_drift, **halos)
    twice = torch.equal(y2, yk) and torch.equal(raw2, rawk) and torch.equal(V2[kp1], Vk[kp1])
    require(twice, f"fused_step B={B} R={R}: two launches bit-equal (y', raw, row kp1)")
    del V2, y2
    sc = float(torch.max(torch.abs(yr)))
    err_w = float(torch.max(torch.abs(Vk[kp1] - Vr[kp1])))
    err_y = float(torch.max(torch.abs(yk - yr)))
    # each reduction against the product of the norms it contracts
    nV = torch.linalg.vector_norm(V[:B].reshape(B, R * 128), dim=1)
    nw, ny = torch.linalg.vector_norm(Vr[kp1]), torch.linalg.vector_norm(yr)
    scales = [nV * ny] + ([nV * nw] if with_drift else []) + [(nw * ny)[None], (nw * nw)[None]]
    rel_raw = float(torch.max(torch.abs(rawk - rawr) / torch.cat(scales)))
    # one dropped layout row (128 products) moves a slot by ~sqrt(128)/n of its
    # norm product, 5e-6 at n = 2^21; float32 summation gives ~1e-7
    tol, tol_raw = 2e-4, 1e-6
    require(err_w <= tol * sc and err_y <= tol * sc, f"fused_step B={B}: w', y' within {tol}*scale")
    require(rel_raw <= tol_raw, f"fused_step B={B}: raw within {tol_raw} of the norm products")
    n = R * 128
    t_bound, by = bound((B + 3) * n * 4, k1_flops(n, B, len(spec.taps), with_drift))
    case = {
        "op": "grid" if spec.gc else "chain", "adjoint_spec": adjoint, "n": n, "R": R, "kmax": kmax,
        "B": B, "kp1": kp1, "h": spec.h, "with_drift": with_drift, "external_halos": ext,
        "max_abs_err": max(err_w, err_y), "scale": sc, "raw_rel_err": rel_raw,
        "tolerance": f"{tol}*scale (w', y'); {tol_raw}*norm products (raw)",
        "rows_other_than_kp1_bit_identical": others, "bit_equal_twice": twice,
    }
    if timed:
        case.update({
            "ms": device_ms(torch, lambda: fl.fused_step(Vk, y, g, kp1, B, spec, with_drift,
                                                         **halos)),
            "parent_ms": None,
            "plain_ms": device_ms(
                torch, lambda: fl.fused_step_reference(Vr, y, g, kp1, B, spec, with_drift,
                                                       **halos), reps=3
            ),
            "bound_ms": t_bound, "bound_by": by,
        })
        if ext:
            # the halo rows add 2h rows per basis row to the bytes moved
            t_bound, by = bound((B + 3) * n * 4 + (B + 1) * 2 * spec.h * 128 * 4,
                                k1_flops(n, B, len(spec.taps), with_drift))
            case.update({"bound_ms": t_bound, "bound_by": by, "ms_null": device_ms(
                torch, lambda: fl.fused_step(Vk, y, g, kp1, B, spec, with_drift))})
    return case


def check_transform(torch, bs, kmax, R, m_out, gen, dtype=None, timed=True):
    """K2 against its plain version on the card (float32, or bfloat16 with
    ``dtype``); returns the case record, with times and the bound where
    ``timed``."""
    dtype = dtype or torch.float32
    V = torch.randn((kmax, R, 128), generator=gen, device="cuda").to(dtype)
    U = torch.randn((kmax, kmax), generator=gen, device="cuda") / kmax ** 0.5
    Vk = bs.transform_partial_inplace(V.clone(), U, m_out)
    Vr = bs.transform_partial_inplace_reference(V.clone(), U, m_out)
    torch.cuda.synchronize()
    label = f"transform kmax={kmax} m_out={m_out} {dtype}"
    tail = torch.equal(Vk[m_out:], V[m_out:])
    require(tail, f"{label}: rows >= m_out bit-identical")
    ident = torch.equal(bs.transform_partial_inplace(V.clone(), torch.eye(kmax, device="cuda"), m_out), V)
    require(ident, f"{label}: identity rotation bit-identical")
    twice = torch.equal(bs.transform_partial_inplace(V.clone(), U, m_out), Vk)
    require(twice, f"{label}: two launches bit-equal")
    sc = float(torch.max(torch.abs(Vr[:m_out])))
    err = float(torch.max(torch.abs(Vk[:m_out].float() - Vr[:m_out].float())))
    if dtype == torch.float32:
        tol, tol_text = 1e-5, "1e-5*scale"
    else:
        # both round a float32 sum of the same bfloat16 products once
        tol, tol_text = 2 * 2.0 ** -7, "2 bfloat16 ulps (2^-7 each) of the scale"
    require(err <= tol * sc, f"{label}: rows < m_out within {tol_text}")
    n = R * 128
    case = {
        "kmax": kmax, "n": n, "m_out": m_out, "dtype": str(dtype), "max_abs_err": err, "scale": sc,
        "tolerance": tol_text, "tail_bit_identical": tail,
        "identity_bit_identical": ident, "bit_equal_twice": twice,
    }
    if timed:
        t_bound, by = bound((kmax + m_out) * n * V.element_size(), 2 * kmax * m_out * n)
        Vf = V.reshape(kmax, -1)
        Um = U[:, :m_out].T.to(dtype)
        case.update({
            "ms": device_ms(torch, lambda: bs.transform_partial_inplace(Vk, U, m_out)),
            "parent_ms": None,
            "plain_ms": device_ms(torch, lambda: bs.transform_partial_inplace_reference(Vr, U, m_out)),
            "library_ms": device_ms(torch, lambda: torch.matmul(Um, Vf)),
            "bound_ms": t_bound, "bound_by": by,
        })
    return case


# K1 and K2 shapes that are timed, here and on a parent tree: (operator, n, B,
# with_drift) at kmax 31, then (kmax, n, m_out)
K1_TIMED = [("chain", 1 << 21, 4, True), ("chain", 1 << 21, 16, True), ("chain", 1 << 21, 30, True),
            ("chain", 1 << 21, 16, False), ("grid", 1 << 20, 16, True), ("nonsym", 1 << 20, 18, True)]
K2_TIMED = [(31, 1 << 21, 20), (31, 1 << 21, 4), (31, 1 << 20, 21)]
K1_SCHEDULE_N = 1 << 21
KRYLOVDIM = 30


def k1_schedule():
    """B of each fused step of the main path: the first cycle appends rows
    1..29 (B = 1..29), the 9 restarted cycles rows 19..29 (B = 19..29)."""
    return list(range(1, KRYLOVDIM)) + 9 * list(range(19, KRYLOVDIM))


def stencil_op(kt, kind):
    if kind == "chain":
        return kt.laplacian_1d(1 << 21)
    if kind == "grid":
        return kt.poisson_2d(1024, 1024)
    return kt.StencilOperator((-1, 0, 1), (-1.3, 2.0, -0.7))


def k1_key(kind, n, B, with_drift):
    return f"{kind} n={n} B={B} drift={int(with_drift)}"


def k2_key(kmax, n, m_out):
    return f"kmax={kmax} n={n} m_out={m_out}"


def kernel_times(root):
    """Per-launch times of K1 and K2 of the package under ``root`` at
    ``K1_TIMED``, over the main path's schedule, and at ``K2_TIMED``: the
    ``--kernel-times`` mode.  Prints one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    import krylovkit_tpu_torch as kt
    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.ops import basis as bs
    from krylovkit_tpu_torch.ops import fused_lanczos as fl

    _build.build(("fused_lanczos", "transform"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kmax = KRYLOVDIM + 1
    out = {"k1": {}, "k1_schedule": {}, "k2": {}}
    bufs = {}
    for n in sorted({c[1] for c in K1_TIMED} | {K1_SCHEDULE_N}):
        bufs[n] = (torch.randn((kmax, n // 128, 128), generator=gen, device="cuda"),
                   torch.randn((n // 128, 128), generator=gen, device="cuda"),
                   torch.randn(kmax + 1, generator=gen, device="cuda"))
    for kind, n, B, drift in K1_TIMED:
        spec = fl.spec_for(stencil_op(kt, kind))
        V, y, g = bufs[n]
        out["k1"][k1_key(kind, n, B, drift)] = device_ms(
            torch, lambda: fl.fused_step(V, y, g, B, B, spec, drift))
    spec = fl.spec_for(stencil_op(kt, "chain"))
    V, y, g = bufs[K1_SCHEDULE_N]
    for B in sorted(set(k1_schedule())):
        out["k1_schedule"][B] = device_ms(torch, lambda: fl.fused_step(V, y, g, B, B, spec, True), reps=5)
    for kmax2, n, m_out in K2_TIMED:
        V = bufs[n][0][:kmax2]
        U = torch.randn((kmax2, kmax2), generator=gen, device="cuda") / kmax2 ** 0.5
        out["k2"][k2_key(kmax2, n, m_out)] = device_ms(
            torch, lambda: bs.transform_partial_inplace(V, U, m_out))
    sched = k1_schedule()
    emit({"kernel_times": out, "root": os.path.abspath(root),
          "k1_schedule_sum_ms": sum(out["k1_schedule"][B] for B in sched),
          "nvidia_smi": nvidia_smi_line(), "device": torch.cuda.get_device_name(0)})
    return 0


def parent_kernel_times(parent):
    """``--kernel-times`` of the tree under ``parent``, in a process of its
    own (the two trees' packages share a name)."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--kernel-times", "--root", parent],
        capture_output=True, text=True, timeout=600,
    )
    if out.returncode != 0:
        raise RuntimeError(f"--kernel-times on {parent} failed:\n{out.stdout}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def poisson_coo(np, nx, dtype):
    """COO triplets of the 5-point Poisson matrix on an ``nx × nx`` grid,
    offsets (-nx, -1, 0, 1, nx), no ±1 couplings across grid rows:
    ``nnz = 5n − 4·nx``."""
    i = np.arange(nx * nx)
    iy, ix = i // nx, i % nx
    rows, cols, vals = [i], [i], [np.full(i.size, 4.0, dtype)]
    for mask, d in ((iy > 0, -nx), (ix > 0, -1), (ix < nx - 1, 1), (iy < nx - 1, nx)):
        rows.append(i[mask])
        cols.append(i[mask] + d)
        vals.append(np.full(int(mask.sum()), -1.0, dtype))
    return tuple(np.concatenate(a) for a in (rows, cols, vals))


def q1_coo(np, ny, nx, dtype):
    """COO triplets of the Q1 finite-element pencil on an ``ny × nx`` grid,
    ``K = k⊗m + m⊗k`` and ``M = m⊗m`` with ``k = tridiag(−1, 2, −1)`` and
    ``m = tridiag(1, 4, 1)/6``: one entry per position (nine offsets)."""
    def tri(m, lo, d, up):
        i = np.arange(m)
        return (np.concatenate([i[1:], i, i[:-1]]), np.concatenate([i[1:] - 1, i, i[:-1] + 1]),
                np.concatenate([np.full(m - 1, lo), np.full(m, d), np.full(m - 1, up)]))

    def kron(a, b):  # the two factors share their pattern, so their entries align
        (r1, c1, v1), (r2, c2, v2) = a, b
        return ((r1[:, None] * nx + r2[None, :]).ravel(), (c1[:, None] * nx + c2[None, :]).ravel(),
                (v1[:, None] * v2[None, :]).ravel())

    ky, my = tri(ny, -1.0, 2.0, -1.0), tri(ny, 1 / 6, 4 / 6, 1 / 6)
    kx, mx = tri(nx, -1.0, 2.0, -1.0), tri(nx, 1 / 6, 4 / 6, 1 / 6)
    (rows, cols, kvm), (_, _, mvk), (_, _, mvm) = kron(ky, mx), kron(my, kx), kron(my, mx)
    return (rows, cols, (kvm + mvk).astype(dtype)), (rows, cols, mvm.astype(dtype))


def q1_bounds(np, N):
    """``(2μ₁, 2μ_N)``: the extreme eigenvalues of the Q1 pencil on an
    ``N × N`` grid, ``μ_i = 6(1 − cos θ_i)/(2 + cos θ_i)``, ``θ_i = iπ/(N+1)``."""
    th = np.array([1, N]) * np.pi / (N + 1)
    mu = 6 * (1 - np.cos(th)) / (2 + np.cos(th))
    return 2 * float(mu[0]), 2 * float(mu[1])


def poisson_top(np, N, k):
    """The ``k`` largest eigenvalues of the 5-point Poisson matrix on an
    ``N × N`` grid, ``4 − 2cos θ_i − 2cos θ_j``, with repeats."""
    c = np.cos(np.arange(1, N + 1) * np.pi / (N + 1))
    return np.sort((4 - 2 * c[:, None] - 2 * c[None, :]).ravel())[::-1][:k].copy()


def golubye_sweeps(numops, numiter):
    """cgs2 sweeps of a Golub-Ye solve of ``numiter`` cycles: one
    orthonormalization per counted apply pair (the start's residual, each
    Lanczos step, each append) and one per restart (``numiter − 1``; the
    last cycle ends the solve), two sweeps each."""
    return 2 * (numops + numiter - 1)


# the leading value of the full-width geneig solve with the projection
# kernels on and off, and of the banded and stencil Block Lanczos solves,
# agree to these (relative); the geneig routes measured 1.9e-5 apart on an
# H100 (float32 sweeps in two orders)
GENEIG_ROUTE_TOL = 1e-3
BLOCK_ROUTE_TOL = 1e-4


def card_vs_cpu(torch, _build, label, solve, tol, dev, counts_equal=True):
    """``solve(device)`` → ``(values, info)`` on ``dev`` with the launch
    counts set to 0 just before, then on the CPU: values within ``tol`` of
    each other (absolute), and with ``counts_equal`` equal ``numops``,
    ``numiter``, ``converged``.  Returns ``(record, launches, card info,
    card values)``."""
    _build.reset_launches()
    vc, ic = solve(dev)
    if dev != "cpu":
        torch.cuda.synchronize()
    counted = {k: v for k, v in _build.launches.items() if v}
    vh, ih = solve("cpu")
    err = float((vc.cpu() - vh).abs().max())
    rec = {"solve": label, "max_abs_err": err, "tolerance": tol, "vals": vc.cpu().tolist(),
           "vals_cpu": vh.tolist(), "numops": [ic.numops, ih.numops], "numiter": [ic.numiter, ih.numiter],
           "converged": [ic.converged, ih.converged], "launches": counted}
    require(err <= tol, f"small {label}: card vs CPU values within {tol}")
    if counts_equal:
        require((ic.numops, ic.numiter, ic.converged) == (ih.numops, ih.numiter, ih.converged),
                f"small {label}: counts equal ({rec['numops']}, {rec['numiter']}, {rec['converged']})")
    return rec, counted, ic, vc.cpu()


def small_geneig_block(torch, np, kt, _build, bs, q1_full, dev="cuda"):
    """Phase ``small_geneig_block``: ``geneigsolve`` on banded Q1 pencils and
    on a callable dense pencil, Block Lanczos on the banded 2-D Poisson,
    each on ``dev`` against the same solve on the CPU; the ELL operator of
    the full-width Q1 stiffness ``q1_full`` (card against CPU apply,
    ``ell_to_banded`` against ``banded_from_coo``); complex
    ``BandedOperator`` applies.  Returns the phase record."""
    t_phase = time.perf_counter()
    quiet = {"verbosity": kt.SILENT}
    solves = []

    def geneig(coo, nn, x, which, flag, **kw):
        def solve(d):
            bs.use_pallas_projections = flag
            try:
                ops = tuple(kt.banded_from_coo(*c, nn, device=d) for c in coo)
                vals, _, info = kt.geneigsolve(ops, x.to(d), 4, which, krylovdim=30, **kw, **quiet)
            finally:
                bs.use_pallas_projections = False
            return vals, info
        return solve

    # the square N = 32 pencil repeats eigenvalues (μ_i + μ_j = μ_j + μ_i):
    # which restart resolves the second copy follows the rounding, so its
    # counts are not compared (the JAX package and this port, both on one
    # CPU, take 1470/49 and 1350/45 for "LR"); the 16×64 pencil repeats none
    # and its counts must be equal
    N = 32
    lo, hi = q1_bounds(np, N)
    x32 = torch.from_numpy(np.random.default_rng(0).standard_normal((N * N // 128, 128)))
    for which, flag in (("SR", False), ("SR", True), ("LR", False), ("LR", True)):
        rec, counted, ic, vals = card_vs_cpu(
            torch, _build, f"geneigsolve Q1 32x32 {which} float64 projections={flag}",
            geneig((q1_coo(np, N, N, np.float64)), N * N, x32, which, flag, tol=1e-8, maxiter=300),
            1e-10, dev, counts_equal=False)
        want = lo if which == "SR" else hi
        rec["analytic_leading"] = want
        solves.append(rec)
        require(rec["converged"] == [4, 4], f"small {rec['solve']}: 4 of 4 converged on both")
        require(abs(float(vals[0]) - want) <= 1e-8, f"small {rec['solve']}: leading value "
                f"{float(vals[0])} within 1e-8 of the analytic {want}")
        require(counted == {"banded_spmv": 2 * ic.numops},
                f"small {rec['solve']}: K3 twice per counted apply, nothing else ({counted})")
    x16 = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 128)))
    for which in ("SR", "LR"):
        rec, counted, ic, _ = card_vs_cpu(
            torch, _build, f"geneigsolve Q1 16x64 {which} float64",
            geneig(q1_coo(np, 16, 64, np.float64), 1024, x16, which, False, tol=1e-8, maxiter=300),
            1e-10, dev)
        solves.append(rec)
        require(ic.converged == 4 and counted == {"banded_spmv": 2 * ic.numops},
                f"small {rec['solve']}: converged, K3 twice per counted apply ({counted})")
    # float32, two cycles: the sweeps run the projection kernels; the
    # unconverged trailing values of two float32 runs part by ~1e-4
    rec, counted, ic, vals = card_vs_cpu(
        torch, _build, "geneigsolve Q1 16x64 SR float32 projections=True",
        geneig(q1_coo(np, 16, 64, np.float32), 1024, x16.float(), "SR", True, tol=1e-30, maxiter=2),
        2e-4, dev)  # 1e-3 of the values (< 0.2)
    rec["leading_rel_err"] = abs(rec["vals"][0] - rec["vals_cpu"][0]) / abs(rec["vals_cpu"][0])
    solves.append(rec)
    require(rec["leading_rel_err"] <= 1e-5, f"small {rec['solve']}: leading value within 1e-5")
    sweeps = golubye_sweeps(ic.numops, ic.numiter)
    require(counted == {"banded_spmv": 2 * ic.numops, "project": sweeps, "unproject": sweeps},
            f"small {rec['solve']}: K3 twice per counted apply, K5 = K6 = 2(numops + numiter - 1) "
            f"= {sweeps} ({counted})")
    # a callable pencil of dense float64 matrices
    rng = np.random.default_rng(44)
    G = rng.standard_normal((200, 200)) / 200 ** 0.5
    C = rng.standard_normal((200, 200)) / 200 ** 0.5
    A, B, xg = (G + G.T) / 2, C @ C.T + 2 * np.eye(200), rng.standard_normal(200)

    def callable_pencil(d):
        At, Bt = torch.from_numpy(A).to(d), torch.from_numpy(B).to(d)
        vals, _, info = kt.geneigsolve((lambda v: At @ v, lambda v: Bt @ v), torch.from_numpy(xg).to(d),
                                       2, "SR", krylovdim=30, tol=1e-10, maxiter=100, **quiet)
        return vals, info

    rec, counted, ic, _ = card_vs_cpu(torch, _build, "geneigsolve callable dense pencil float64",
                                      callable_pencil, 1e-10, dev)
    solves.append(rec)
    require(ic.converged == 2 and counted == {}, "small callable pencil: converged, no kernel")
    # Block Lanczos on the banded Poisson, block of 4 from default_rng(5)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal((N * N // 128, 128))) for _ in range(4)]
    pcoo = poisson_coo(np, N, np.float64)

    def block(d):
        vals, _, info = kt.eigsolve(kt.banded_from_coo(*pcoo, N * N, device=d),
                                    kt.Block([x.to(d) for x in xs]), 4, "LR", krylovdim=30, tol=1e-8,
                                    maxiter=300, **quiet)
        return vals, info

    rec, counted, ic, vals = card_vs_cpu(torch, _build, "block lanczos poisson 32x32 LR float64",
                                         block, 1e-10, dev)
    want = poisson_top(np, N, 4)
    rec["analytic"] = want.tolist()
    solves.append(rec)
    require(ic.converged == 4 and counted == {"banded_spmv": ic.numops},
            f"small block lanczos: converged, K3 once per apply ({counted})")
    require(float((vals - torch.from_numpy(want)).abs().max()) <= 1e-8,
            f"small block lanczos: the top four {vals.tolist()} within 1e-8 of {want.tolist()} "
            "(the repeated pair resolved)")

    # the ELL operator of the Q1 stiffness at full width, card against CPU
    coo_k, n_q = q1_full
    ell = kt.sparse.from_coo(*coo_k, (n_q, n_q), device=dev)
    ell_h = kt.sparse.from_coo(*coo_k, (n_q, n_q), with_adjoint=False, device="cpu")
    xq = torch.from_numpy(np.random.default_rng(8).standard_normal(n_q).astype(np.float32))
    y, y_adj = ell.normal(xq.to(dev)), ell.apply_adjoint(xq.to(dev))
    yh = ell_h.normal(xq)
    scale = kt.sparse.ELLOperator(ell_h.cols, ell_h.vals.abs(), n_q).normal(xq.abs())
    rel = float(((y.cpu() - yh).abs() / scale.clamp_min(1e-30)).max())
    rel_adj = float(((y_adj.cpu() - yh).abs() / scale.clamp_min(1e-30)).max())
    kb = kt.banded_from_coo(*coo_k, n_q, device=dev)
    eb = kt.ell_to_banded(ell)
    ell_rec = {"n": n_q, "width": ell.cols.shape[1], "stored": int((ell.vals != 0).sum()),
               "max_rel_err": rel, "adjoint_max_rel_err": rel_adj, "tolerance": "1e-6*sum|a||x|",
               "ell_to_banded_offsets": list(eb.offsets)}
    require(rel <= 1e-6 and rel_adj <= 1e-6,
            f"ELL Q1 stiffness: card apply (and its adjoint, K symmetric) within 1e-6 of the CPU's")
    require(eb.offsets == kb.offsets and torch.equal(eb.diags, kb.diags),
            "ELL Q1 stiffness: ell_to_banded gives the offsets and planes of banded_from_coo")
    del ell, ell_h, kb, eb

    # complex planes: the plain version on the card too, no K3 launch
    cplx = []
    for dt, tol in ((np.complex64, 1e-6), (np.complex128, 1e-12)):
        rng = np.random.default_rng(9)
        n_c, offs = 1000, (-7, -1, 0, 2)
        rows = np.concatenate([np.arange(max(0, -d), min(n_c, n_c - d)) for d in offs])
        cols = np.concatenate([np.arange(max(0, -d), min(n_c, n_c - d)) + d for d in offs])
        vals = (rng.standard_normal(rows.size) + 1j * rng.standard_normal(rows.size)).astype(dt)
        xc = torch.from_numpy((rng.standard_normal(n_c) + 1j * rng.standard_normal(n_c)).astype(dt))
        opc, oph = (kt.banded_from_coo(rows, cols, vals, n_c, device=d) for d in (dev, "cpu"))
        absop = kt.banded_from_coo(rows, cols, np.abs(vals), n_c, device="cpu")
        pairs = [(opc.normal, oph.normal(xc), absop.normal(xc.abs())),
                 (opc.apply_adjoint, oph.apply_adjoint(xc), absop.apply_adjoint(xc.abs()))]
        _build.reset_launches()
        errs = [float(((fc(xc.to(dev)).cpu() - yh).abs() / sc).max()) for fc, yh, sc in pairs]
        k3 = _build.launches["banded_spmv"]
        cplx.append({"dtype": str(dt.__name__), "n": n_c, "max_rel_err": errs, "tolerance": tol,
                     "banded_spmv_launches": k3})
        require(max(errs) <= tol and k3 == 0,
                f"complex BandedOperator {dt.__name__}: card within {tol} of the CPU, no K3 launch")
    return {"phase": "small_geneig_block", "solves": solves, "ell": ell_rec, "complex_banded": cplx,
            "phase_seconds": time.perf_counter() - t_phase}


def geneig_kernel(cases):
    """The ``geneig`` shapes' fields of a kernel's entry in the ``kernels``
    line: the largest error over ``cases`` and the times of the timed ones,
    each case labelled by its operator or live length."""
    out = {"max_abs_err_geneig": max(c["max_abs_err"] for c in cases)}
    for c in cases:
        if "ms" in c:
            tag = c["case"].split()[1] if "case" in c else f"k{c['k']}"
            out.update({f"{key}_geneig_{tag}": c[key]
                        for key in ("ms", "plain_ms", "bound_ms", "library_ms")})
    return out


def sweep_times(torch, pb, V, w, c, ks):
    """Per-launch times of K5 and K6 at each live length in ``ks`` over the
    basis ``V``: ``{k: (project ms, unproject ms)}``."""
    return {k: (device_ms(torch, lambda: pb.project_pallas(V, w, k), reps=5),
                device_ms(torch, lambda: pb.unproject_pallas(V, c, k), reps=5)) for k in set(ks)}


def geneig_full(torch, np, kt, _build, bd, bs, fl, pb, q1_full, N, smi, dev="cuda"):
    """Phase ``geneig``: the Q1 pencil on the ``N × N`` grid in float32,
    ``geneigsolve((K, M), x0, 4, "SR", krylovdim=30, maxiter=8, tol=1e-30)``
    with the projection kernels off, then on; per route the launch counts of
    one solve, then a timed solve, one metric line each (printed before its
    checks).  Before the solves, K3 on both nine-offset operators and K5/K6
    on the solve's ``(37, R, 128)`` basis are held against their plain
    versions, K5/K6 at the live lengths the sweeps reach (1 to 30, mean
    15.9) and beyond, up to all 37 rows.  Returns the launches by route, the
    kernel records and the pencil's two operators."""
    (coo_k, coo_m), n = q1_full, N * N
    Kb, Mb = kt.banded_from_coo(*coo_k, n, device=dev), kt.banded_from_coo(*coo_m, n, device=dev)
    require(len(Kb.offsets) == len(Mb.offsets) == 9 and Kb.diags.dtype == torch.float32,
            f"Q1 pencil: nine offsets each, float32 ({Kb.offsets}, {Mb.offsets})")
    nnz = Kb.nnz + Mb.nnz
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal((n // 128, 128))
                          .astype(np.float32)).to(dev)
    lo, hi = q1_bounds(np, N)
    kw = dict(krylovdim=30, maxiter=8, tol=1e-30, verbosity=kt.SILENT)
    flush = torch.empty(32 << 20, device=dev)  # 128 MB, written to clear L2
    k3_cases = [check_banded(torch, bd, f"Q1 {name} f32, 9 offsets", x0, op.diags, op.offsets, n, flush)
                for name, op in (("K", Kb), ("M", Mb))]
    del flush
    k3_ms = [case["ms"] for case in k3_cases]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    mcap = 30 + 4 + 3
    k5_cases, k6_cases = check_projections(torch, pb, mcap, n // 128, (0, 1, 16, 30, 31, 33, 36, mcap),
                                           gen, timed=(16,))
    kernels = {"phase": "kernels_geneig", "banded_spmv": k3_cases, "project": k5_cases,
               "unproject": k6_cases}
    emit(kernels)
    V = torch.randn((mcap, n // 128, 128), generator=gen, device=dev)
    c = torch.randn(V.shape[0], generator=gen, device=dev)
    t_phase = time.perf_counter()
    launches_by, lead = {}, {}
    for metric, flag in (("geneigsolve_golubye_q1", False), ("geneigsolve_golubye_q1_proj", True)):
        bs.use_pallas_projections = flag
        try:
            (vals, vecs, info), launches, _, sweeps, first_ms, ms = drive_counted(
                torch, _build, fl, pb, lambda: kt.geneigsolve((Kb, Mb), x0, 4, "SR", **kw))
        finally:
            bs.use_pallas_projections = False
        ks = [k for _, k in sweeps]
        kernel_ms = {"banded_spmv": info.numops * sum(k3_ms)}
        if ks:
            per_k = sweep_times(torch, pb, V, x0, c, ks)
            kernel_ms["project"] = sum(per_k[k][0] for k in ks)
            kernel_ms["unproject"] = sum(per_k[k][1] for k in ks)
        # each returned pair against plain float64 applies of K and M on the card
        rq, fresh = [], []
        for i in range(4):
            v = vecs[i].double()
            kv = bd.banded_spmv_reference(v, Kb.diags.double(), Kb.offsets, n)
            mv = bd.banded_spmv_reference(v, Mb.diags.double(), Mb.offsets, n)
            rq.append(float(torch.sum(v * kv) / torch.sum(v * mv)))
            fresh.append((float(torch.linalg.vector_norm(kv - float(vals[i]) * mv)),
                          float(torch.linalg.vector_norm(kv))))
        vh = vals.cpu().double()
        nr = info.normres.cpu().tolist()
        rq_err = [abs(rq[i] - float(vh[i])) / abs(float(vh[i])) for i in range(4)]
        launches_by[metric] = launches
        lead[metric] = float(vh[0])
        emit({
            "metric": metric, "value": info.numops * nnz / ms / 1e6, "unit": "Gnnz/s",
            "formula": "numops * (nnz(K) + nnz(M)) / t", "nnz_K": Kb.nnz, "nnz_M": Mb.nnz,
            "projection_kernels": flag, "numops": info.numops, "numiter": info.numiter,
            "converged": info.converged, "ms_per_solve": ms, "first_solve_ms": first_ms,
            "vals": vh.tolist(), "analytic_range": [lo, hi], "normres": nr,
            "fresh_residual": [f for f, _ in fresh], "rayleigh_rel_err": rq_err,
            "launches_per_solve": launches, "projection_k_mean": sum(ks) / len(ks) if ks else None,
            "kernel_ms_per_solve": kernel_ms, "kernel_ms_per_launch": {"banded_spmv_K": k3_ms[0],
                                                                       "banded_spmv_M": k3_ms[1]},
            "outside_kernels_ms_per_solve": ms - sum(kernel_ms.values()),
            "device": torch.cuda.get_device_name(0) if dev != "cpu" else "cpu", "nvidia_smi": smi,
        })
        require(info.numiter == 8 and info.numops == 1 + 29 + 7 * 30,
                f"{metric}: 8 cycles, numops 1 + 29 + 7*30 = 240 (got {info.numiter}, {info.numops})")
        sw = golubye_sweeps(info.numops, info.numiter)
        want = {"banded_spmv": 2 * info.numops}
        if flag:
            want.update(project=sw, unproject=sw)
        require(launches == want, f"{metric}: launches {launches}, expected {want} (K3 twice per "
                "counted apply; with the flag K5 = K6 = 2(numops + numiter - 1))")
        require(bool(torch.isfinite(vecs).all()) and tuple(vecs.shape) == (4, n // 128, 128),
                f"{metric}: finite (4, R, 128) vectors")
        require(bool((vh[1:] >= vh[:-1]).all()) and lo * (1 - 1e-4) <= float(vh[0])
                and float(vh[-1]) <= hi * (1 + 1e-4),
                f"{metric}: values ascending within [2mu_1, 2mu_N] = [{lo}, {hi}]: {vh.tolist()}")
        require(max(rq_err) <= 1e-4, f"{metric}: each value within 1e-4 of its vector's Rayleigh "
                f"quotient <v, Kv>/<v, Mv> ({rq_err})")
        require(all(abs(fresh[i][0] - nr[i]) <= 1e-3 * fresh[i][1] for i in range(4)),
                f"{metric}: normres {nr} within 1e-3 |Kv| of |Kv - rho Mv| {fresh}")
    agree = abs(lead["geneigsolve_golubye_q1_proj"] - lead["geneigsolve_golubye_q1"]) / abs(
        lead["geneigsolve_golubye_q1"])
    emit({"phase": "geneig_agreement", "leading_rel_diff": agree, "tolerance": GENEIG_ROUTE_TOL,
          "phase_seconds": time.perf_counter() - t_phase})
    require(agree <= GENEIG_ROUTE_TOL, f"geneig: leading values of the two routes within "
            f"{GENEIG_ROUTE_TOL} ({agree})")
    return launches_by, kernels, (Kb, Mb)


def block_full(torch, np, kt, _build, bd, fl, pb, banded, grid, N, smi, dev="cuda"):
    """Phase ``block_lanczos``: Block Lanczos on the 5-point Poisson matrix
    of the ``N × N`` grid in float32, ``eigsolve(P, Block([x1..x4]), 4,
    "LR", krylovdim=30, maxiter=8, tol=1e-30)``, on the banded operator
    ``banded`` and on the grid stencil ``grid``; per route the launch
    counts of one solve, then a timed solve, one metric line each (printed
    before its checks).  Returns the launches of the banded route."""
    n = N * N
    rng = np.random.default_rng(5)
    X0 = kt.Block([torch.from_numpy(rng.standard_normal((n // 128, 128)).astype(np.float32)).to(dev)
                   for _ in range(4)])
    kw = dict(krylovdim=30, maxiter=8, tol=1e-30, verbosity=kt.SILENT)
    k3 = device_ms(torch, lambda: bd.banded_spmv(X0[0], banded.diags, banded.offsets, n))
    t_phase = time.perf_counter()
    out = {}
    Pd = banded.diags.double()
    for metric, op in (("block_lanczos_poisson_2d_banded", banded), ("block_lanczos_poisson_2d", grid)):
        (vals, vecs, info), launches, _, _, first_ms, ms = drive_counted(
            torch, _build, fl, pb, lambda: kt.eigsolve(op, X0, 4, "LR", **kw))
        kernel_ms = {"banded_spmv": launches.get("banded_spmv", 0) * k3}
        W = vecs.reshape(4, -1).double()
        ortho = float((W @ W.T - torch.eye(4, dtype=W.dtype, device=W.device)).abs().max())
        rq = [float(torch.sum(W[i] * bd.banded_spmv_reference(W[i], Pd, banded.offsets, n))
                    / torch.sum(W[i] * W[i])) for i in range(4)]
        vh = vals.cpu().double()
        rq_err = [abs(rq[i] - float(vh[i])) / abs(float(vh[i])) for i in range(4)]
        out[metric] = (info, launches, float(vh[0]))
        emit({
            "metric": metric, "value": info.numops * 5 * n / ms / 1e6, "unit": "Gnnz/s",
            "formula": "numops * 5n / t", "numops": info.numops, "numiter": info.numiter,
            "converged": info.converged, "ms_per_solve": ms, "first_solve_ms": first_ms,
            "vals": vh.tolist(), "normres": info.normres.cpu().tolist(), "orthonormality_err": ortho,
            "rayleigh_rel_err": rq_err, "launches_per_solve": launches,
            "kernel_ms_per_solve": kernel_ms, "kernel_ms_per_launch": {"banded_spmv": k3},
            "outside_kernels_ms_per_solve": ms - sum(kernel_ms.values()),
            "device": torch.cuda.get_device_name(0) if dev != "cpu" else "cpu", "nvidia_smi": smi,
        })
        require(info.numiter == 8, f"{metric}: 8 iterations (got {info.numiter})")
        require(bool(torch.isfinite(vecs).all()) and tuple(vecs.shape) == (4, n // 128, 128),
                f"{metric}: finite (4, R, 128) vectors")
        require(bool((vh[:-1] >= vh[1:]).all()) and 0 <= float(vh[-1]) and float(vh[0]) <= 8,
                f"{metric}: values descending within [0, 8]: {vh.tolist()}")
        require(ortho <= 1e-4, f"{metric}: vectors orthonormal to 1e-4 ({ortho})")
        require(max(rq_err) <= 1e-4, f"{metric}: each value within 1e-4 (relative) of its vector's "
                f"Rayleigh quotient ({rq_err})")
    (ib, lb, vb), (ig, lg, vg) = (out[k] for k in ("block_lanczos_poisson_2d_banded",
                                                   "block_lanczos_poisson_2d"))
    # 7 block steps fill the first cycle (k = 0..28), 3 refill each of the 7
    # restarted ones (keep 18 → 30), 4 applies a step
    require(ib.numops == ig.numops == 4 * (7 + 7 * 3),
            f"block lanczos: numops 4*(7 + 7*3) = 112 on both routes ({ib.numops}, {ig.numops})")
    require(lb == {"banded_spmv": ib.numops} and lg == {},
            f"block lanczos: K3 once per apply on the banded route, nothing on the stencil ({lb}, {lg})")
    agree = abs(vb - vg) / abs(vg)
    emit({"phase": "block_lanczos_agreement", "leading_rel_diff": agree, "tolerance": BLOCK_ROUTE_TOL,
          "numops": ib.numops, "phase_seconds": time.perf_counter() - t_phase})
    require(agree <= BLOCK_ROUTE_TOL, f"block lanczos: leading values of the two routes within "
            f"{BLOCK_ROUTE_TOL} ({agree})")
    return lb


# the AD phases: card-against-CPU gradients agree to this (relative to the
# largest entry, float64 and complex128)
AD_TOL = 1e-8


def _rel_err(torch, a, b):
    """``max|a − b| / max(1, max|b|)`` over two gradients (host)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def small_ad_routes(np, kt, torch):
    """``{label: run}`` of the AD routes of ``small_ad``: ``run(dev)`` builds
    its numpy-seeded inputs on ``dev``, differentiates one solve and returns
    ``(gradients, infos)``.  The sizes of ``tests/test_ad.py``."""
    n = 10
    routes = {}

    def rand(rng, shape, dtype):
        a = rng.standard_normal(shape)
        if np.dtype(dtype).kind == "c":
            a = a + 1j * rng.standard_normal(shape)
        return (a / np.sqrt(shape[0] if len(shape) > 1 else 1)).astype(dtype)

    def on(dev, x, grad=False):
        t = torch.as_tensor(np.asarray(x), device=dev)
        return t.requires_grad_(True) if grad else t

    for dt in (np.float64, np.complex128):
        rng = np.random.default_rng(71)
        A = rand(rng, (n, n), dt) + 2 * np.eye(n, dtype=dt)
        b, c = rand(rng, (n,), dt), rand(rng, (n,), dt)

        def lin(dev, A=A, b=b, c=c, dt=dt):
            At, bt = on(dev, A, True), on(dev, b, True)
            a0, a1 = on(dev, np.asarray(0.4, dt), True), on(dev, np.asarray(1.3, dt), True)
            x, info = kt.linsolve(At, bt, a0=a0, a1=a1, tol=1e-12, krylovdim=n)
            torch.real(torch.vdot(on(dev, c), x)).backward()
            return [At.grad, bt.grad, a0.grad, a1.grad], [info]

        routes[f"linsolve GMRES rule {np.dtype(dt).name}"] = lin

        rng = np.random.default_rng(73)
        H = rand(rng, (n, n), dt)
        H = (H + H.conj().T) / 2
        x0, cv = rand(rng, (n,), dt), rand(rng, (n,), dt)

        def lanczos(dev, H=H, x0=x0, cv=cv, rr=None):
            Ht = on(dev, H, True)
            vals, vecs, info = kt.eigsolve(Ht, on(dev, x0), 2, "SR", ishermitian=True, tol=1e-12,
                                           krylovdim=n, alg_rrule=rr)
            (vals[0] + 0.5 * vals[1] + torch.abs(torch.vdot(on(dev, cv), vecs[0])) ** 2).backward()
            return [Ht.grad], [info]

        routes[f"eigsolve Lanczos, GMRES rule {np.dtype(dt).name}"] = lanczos

        rng = np.random.default_rng(76)
        R = rand(rng, (2 * n, n), dt)
        u0, cu, dv = R @ rand(rng, (n,), dt), rand(rng, (2 * n,), dt), rand(rng, (n,), dt)

        def svd(dev, R=R, u0=u0, cu=cu, dv=dv, rr=None):
            Rt = on(dev, R, True)
            s, U, V, info = kt.svdsolve(Rt, on(dev, u0), 2, "LR", tol=1e-12, krylovdim=n,
                                        maxiter=100, alg_rrule=rr)
            pair = torch.vdot(on(dev, cu), U[0]) * torch.vdot(V[0], on(dev, dv))
            (s.sum() + torch.real(pair)).backward()
            return [Rt.grad], [info]

        routes[f"svdsolve GMRES rule {np.dtype(dt).name}"] = svd

        rng = np.random.default_rng(75)
        G = rand(rng, (n, n), dt) + np.diag(np.linspace(1, 2, n))
        xg, cg_ = rand(rng, (n,), dt), rand(rng, (n,), dt)

        def arnoldi(dev, G=G, xg=xg, cg_=cg_, rr=None):
            Gt = on(dev, G, True)
            vals, vecs, info = kt.eigsolve(Gt, on(dev, xg), 1, "LR", tol=1e-12, krylovdim=n,
                                           alg_rrule=rr)
            v0 = vecs[0]
            (torch.real(vals[0]) + 0.7 * torch.imag(vals[0])
             + torch.abs(torch.vdot(on(dev, cg_).to(v0.dtype), v0)) ** 2).backward()
            return [Gt.grad], [info]

        routes[f"eigsolve Arnoldi, GMRES rule {np.dtype(dt).name}"] = arnoldi
        # the Sylvester rules: an Arnoldi alg_rrule on the same problems
        rr = kt.Arnoldi(tol=1e-12, krylovdim=30, maxiter=100)
        name = np.dtype(dt).name
        routes[f"eigsolve Lanczos, Sylvester rule {name}"] = (
            lambda dev, f=lanczos, rr=rr: f(dev, rr=rr))
        routes[f"eigsolve Arnoldi, Sylvester rule {name}"] = (
            lambda dev, f=arnoldi, rr=rr: f(dev, rr=rr))
        routes[f"svdsolve Sylvester rule {name}"] = (
            lambda dev, f=svd: f(dev, rr=kt.Arnoldi(tol=1e-12, krylovdim=40, maxiter=200)))

    rng = np.random.default_rng(72)
    B = rng.standard_normal((n, n)) / np.sqrt(n)
    S, bs_, cs = B @ B.T + 2 * np.eye(n), rng.standard_normal(n), rng.standard_normal(n)

    def cg(dev):
        St, bt = on(dev, S, True), on(dev, bs_, True)
        x, info = kt.linsolve(St, bt, alg=kt.CG(tol=1e-12, maxiter=200))
        torch.vdot(on(dev, cs), x).backward()
        return [St.grad, bt.grad], [info]

    routes["linsolve CG rule float64"] = cg

    rng = np.random.default_rng(20)
    m = 24
    Sp = rng.standard_normal((m, m))
    Sp, Dp, xp = (Sp + Sp.T) / 2, rng.standard_normal(m), rng.standard_normal(m)

    def parametric(dev):
        St, Dt = on(dev, Sp), on(dev, Dp)
        g = on(dev, np.float64(0.3), True)
        op = kt.ParametricOperator(lambda g, x: St @ x + g * Dt * x, g)
        vals, _, info = kt.eigsolve(op, on(dev, xp), 1, "SR", ishermitian=True, krylovdim=24,
                                    maxiter=100, tol=1e-12)
        vals[0].backward()
        return [g.grad], [info]

    routes["ParametricOperator eigsolve float64"] = parametric

    rng = np.random.default_rng(300)
    Q = rng.standard_normal((20, 20))
    q0 = rng.standard_normal(20)

    def callables(dev):
        Qt = on(dev, Q)
        s, _, _, info_s = kt.svdsolve(lambda x: Qt @ x, on(dev, q0), 2, "LR", tol=1e-10)
        x, info_l = kt.lssolve(lambda x: Qt @ x, on(dev, q0), tol=1e-10)
        M = on(dev, Q, True)
        sp, _, _, info_p = kt.svdsolve(kt.ParametricOperator(lambda M, x: M @ x, M), on(dev, q0),
                                       2, "LR", tol=1e-12)
        sp.sum().backward()
        return [s, x, M.grad], [info_s, info_l, info_p]

    routes["bare callable svdsolve/lssolve (with_adjoint_from) float64"] = callables

    N = 32
    rng = np.random.default_rng(100)
    A100 = rng.standard_normal((N, N))
    A100 = A100 + A100.T
    h = N // 2
    va, vb = rng.standard_normal(h), rng.standard_normal(h)

    def dict_vector(dev):
        At = on(dev, A100)

        def f(v):
            y = At @ torch.cat([v["a"], v["b"]])
            return {"a": y[:h], "b": y[h:]}

        vals, vecs, info = kt.eigsolve(f, {"a": on(dev, va), "b": on(dev, vb)}, 4, "LM",
                                       ishermitian=True, krylovdim=12, maxiter=100, tol=1e-12)
        return [vals], [info]

    routes["dict-vector eigsolve (reference test/issues.jl) float64"] = dict_vector
    return routes


def small_ad(torch, np, kt, _build, dev="cuda"):
    """Phase ``small_ad``: every AD route (linsolve with a GMRES and a CG
    rule; eigsolve Lanczos and Arnoldi with a GMRES rule and with the
    Sylvester rule; svdsolve with both; a ParametricOperator; bare callables
    in svdsolve/lssolve; the dict-vector eigsolve of the reference's
    ``test/issues.jl``) in float64
    and complex128, each on ``dev`` against the same on the CPU: gradients
    within ``AD_TOL`` relative, ``numops``/``numiter``/``converged`` equal.
    Returns the launches of the ``dev`` runs."""
    t0 = time.perf_counter()
    cases, launches = [], {}
    for label, run in small_ad_routes(np, kt, torch).items():
        _build.reset_launches()
        gc, ic = run(dev)
        for k, v in _build.launches.items():
            launches[k] = launches.get(k, 0) + v
        gh, ih = run("cpu")
        err = max(_rel_err(torch, a, b) for a, b in zip(gc, gh))
        cc = [(i.numops, i.numiter, int(i.converged)) for i in ic]
        ch = [(i.numops, i.numiter, int(i.converged)) for i in ih]
        cases.append({"route": label, "max_rel_err": err, "counts": cc, "counts_cpu": ch})
        require(err <= AD_TOL, f"small_ad {label}: card vs CPU gradients within {AD_TOL} ({err})")
        require(cc == ch, f"small_ad {label}: counts equal ({cc}, {ch})")
    emit({"phase": "small_ad", "tolerance": AD_TOL, "routes": cases, "launches": launches,
          "phase_seconds": time.perf_counter() - t0})
    return launches


def _sync_ms(torch, _build, fn, dev):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after; returns ``(result, ms, launches)``, synchronised."""
    if dev != "cpu":
        torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    if dev != "cpu":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, {k: v for k, v in _build.launches.items() if v}


def _kernel_share(ms, launches, per_launch):
    """The share of ``ms`` outside the kernels: launches × per-launch time
    (``per_launch``, measured alone) subtracted."""
    inside = sum(launches.get(k, 0) * t for k, t in per_launch.items())
    return {"kernel_ms": inside, "outside_kernels_ms": ms - inside,
            "outside_kernels_share": (ms - inside) / ms if ms > 0 else None}


def _impurity_op(torch, np, kt, N, dev):
    """``(P, op, g, x0)`` of the impurity problem on an ``N × N`` grid:
    ``P`` the banded 5-point Poisson matrix, ``g`` zero but at four wells
    (depths −5, −6, −7, −8 at the grid's quarter points), ``op`` the
    ParametricOperator ``x ↦ P x + g ⊙ x`` with its adjoint, ``x0`` from
    ``default_rng(6)``; vectors ``(N²/128, 128)`` float32."""
    n = N * N
    P = kt.banded_from_coo(*poisson_coo(np, N, np.float32), n, device=dev)
    gn = np.zeros(n, np.float32)
    for site, depth in impurity_wells(N):
        gn[site] = depth
    g = torch.as_tensor(gn.reshape(n // 128, 128), device=dev).requires_grad_(True)
    x0 = torch.as_tensor(np.random.default_rng(6).standard_normal((n // 128, 128))
                         .astype(np.float32), device=dev)
    return P, g, x0


def ad_impurity(torch, np, kt, _build, bs, bd, N=1024, dev="cuda", smi=None):
    """Phase ``ad_impurity``: the bound states of ``P + diag(g)`` (``P``
    config 2's banded Poisson, four wells in ``g``) and the gradient of the
    sum of the four lowest with respect to ``g``, through the GMRES rule
    (bordered systems on ``(vector, scalar)`` tuples).  Guards: four
    converged values ascending, distinct and below the continuum's 0;
    ``g.grad`` within 1e-3 (relative ∞-norm) of ``Σᵢ vᵢ²``
    (Hellmann–Feynman), its sum within 1e-3 of 4, and within 1e-2 of a
    central difference in one well's depth (ε = 1e-2); no K1, K5 or K6
    launch.  Then the same with the projection kernels on: the forward's
    single-leaf sweeps launch K5/K6, the backward's tuple sweeps none; the
    Sylvester rule (an Arnoldi ``alg_rrule``: one eigensolve on ``(w, x)``
    pytrees) within 1e-3 of Hellmann–Feynman, K2 once per rotation of its
    tuple basis (the first leaf only); and K2 on a ``((31, R, 128), (31,
    n))`` float32 tuple basis once.  Returns the launch counts."""
    t_phase = time.perf_counter()
    n = N * N
    P, g, x0 = _impurity_op(torch, np, kt, N, dev)

    def apply(g, x):
        return P(x) + g * x

    kw = dict(ishermitian=True, krylovdim=30, maxiter=10, tol=1e-5)

    def forward(g, alg_rrule=None):
        return kt.eigsolve(kt.ParametricOperator(apply, g, adjoint_fn=apply), x0, 4, "SR",
                           alg_rrule=alg_rrule, **kw)

    (vals, vecs, info), fwd_ms, fwd_l = _sync_ms(torch, _build, lambda: forward(g), dev)
    _, bwd_ms, bwd_l = _sync_ms(torch, _build, lambda: vals.sum().backward(), dev)
    grad = g.grad.double()
    reps = []  # three more forward/backward pairs, timed alone
    for _ in range(3):
        g.grad = None
        (v_r, _, _), f_ms, _ = _sync_ms(torch, _build, lambda: forward(g), dev)
        reps.append((f_ms, _sync_ms(torch, _build, lambda: v_r.sum().backward(), dev)[1]))
    vh = vals.detach().cpu().double()
    hf = (vecs.detach().double() ** 2).sum(0)
    hf_err = float((grad - hf).abs().max() / hf.abs().max())
    gsum = float(grad.sum())
    site = (N // 4) * N + N // 4  # the first well, depth −5
    eps = 1e-2
    with torch.no_grad():
        fd = []
        for s in (1, -1):
            gp = g.detach().clone()
            gp.view(-1)[site] += s * eps
            fd.append(float(forward(gp)[0].double().sum()))
    fd = (fd[0] - fd[1]) / (2 * eps)
    g_site = float(grad.view(-1)[site])
    fd_err = abs(fd - g_site) / abs(g_site)
    # per-launch times of the two kernels at this shape, measured alone
    k3_ms = device_ms(torch, lambda: bd.banded_spmv(x0, P.diags, P.offsets, n)) if dev != "cpu" else 0
    V = torch.randn((31, n // 128, 128), device=dev)
    U = torch.eye(31, device=dev)
    k2_ms = (device_ms(torch, lambda: bs.transform_partial_inplace(V, U, 20))
             if dev != "cpu" else 0)
    per = {"banded_spmv": k3_ms, "transform_partial": k2_ms}
    rec = {
        "phase": "ad_impurity", "n": n, "vals": vh.tolist(), "converged": int(info.converged),
        "numops": info.numops, "numiter": info.numiter, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
        "forward_ms_reps": [r[0] for r in reps], "backward_ms_reps": [r[1] for r in reps],
        "launches_forward": fwd_l, "launches_backward": bwd_l,
        "forward": _kernel_share(fwd_ms, fwd_l, per), "backward": _kernel_share(bwd_ms, bwd_l, per),
        "kernel_ms_per_launch": per, "hellmann_feynman_rel_err": hf_err, "grad_sum": gsum,
        "fd": fd, "grad_at_well": g_site, "fd_rel_err": fd_err, "nvidia_smi": smi,
    }
    emit(rec)
    require(info.converged >= 4, f"ad_impurity: 4 values converged ({info.converged})")
    require(bool((vh[1:] > vh[:-1]).all()) and float(vh[-1]) < 0,
            f"ad_impurity: values ascending, distinct, below 0 ({vh.tolist()})")
    require(hf_err <= 1e-3, f"ad_impurity: g.grad within 1e-3 of sum v_i^2 ({hf_err})")
    require(abs(gsum - 4) <= 1e-3, f"ad_impurity: g.grad sums to 4 within 1e-3 ({gsum})")
    require(fd_err <= 1e-2, f"ad_impurity: central difference within 1e-2 ({fd}, {g_site})")
    for launches in (fwd_l, bwd_l):
        require(not {"fused_step", "project", "unproject"} & set(launches),
                f"ad_impurity: no K1, K5 or K6 launch ({launches})")
    card = dev != "cpu"  # the plain versions count no launch
    # K3 once per counted apply (the forward's dtype probe of the callable
    # runs on meta tensors); K2 once per processing round and once for the
    # extraction
    require(not card or fwd_l.get("banded_spmv", 0) == info.numops,
            f"ad_impurity: forward K3 = numops ({fwd_l}, {info.numops})")
    require(not card or (fwd_l.get("transform_partial", 0) >= 2
                         and bwd_l.get("banded_spmv", 0) >= 4),
            f"ad_impurity: K2 in the forward, K3 in the backward ({fwd_l}, {bwd_l})")
    require(bwd_l.get("transform_partial", 0) == 0, "ad_impurity: no K2 in the GMRES rule")

    # the projection kernels on: single-leaf forward sweeps take them, the
    # backward's (vector, scalar) tuple sweeps must not
    g.grad = None
    bs.use_pallas_projections = True
    try:
        (vals_p, _, info_p), _, fwd_lp = _sync_ms(torch, _build, lambda: forward(g), dev)
        _, _, bwd_lp = _sync_ms(torch, _build, lambda: vals_p.sum().backward(), dev)
    finally:
        bs.use_pallas_projections = False
    proj_err = float((g.grad.double() - grad).abs().max() / grad.abs().max())
    # the Sylvester rule: one Arnoldi eigensolve on (w, x) pytrees, whose
    # restart rotation takes K2 for the (31, R, 128) leaf only
    g.grad = None
    tuple_calls, transform_partial = [], bs.transform_partial

    def recording(V, U, m_out):
        tuple_calls.append(not isinstance(V, torch.Tensor))
        return transform_partial(V, U, m_out)

    vals_s, _, _ = forward(g, kt.Arnoldi(tol=1e-5, krylovdim=30, maxiter=10))
    bs.transform_partial = recording
    try:
        _, syl_ms, bwd_ls = _sync_ms(torch, _build, lambda: vals_s.sum().backward(), dev)
    finally:
        bs.transform_partial = transform_partial
    syl_err = float((g.grad.double() - hf).abs().max() / hf.abs().max())
    # K2 leaf by leaf on a tuple basis at this width
    Vt = (torch.randn((31, n // 128, 128), device=dev), torch.randn((31, n), device=dev))
    Ut = torch.randn((31, 31), device=dev) / 31 ** 0.5
    want = [bs.transform_partial_inplace_reference(v.clone(), Ut, 20) for v in Vt]
    _build.reset_launches()
    got = bs.transform_partial(Vt, Ut, 20)
    k2_tuple = {k: v for k, v in _build.launches.items() if v}
    k2_err = max(float((a[:20] - b[:20]).abs().max()) for a, b in zip(got, want))
    emit({"phase": "ad_impurity_gates", "launches_forward_proj": fwd_lp,
          "launches_backward_proj": bwd_lp, "grad_rel_diff_proj": proj_err,
          "sylvester_backward_ms": syl_ms, "launches_backward_sylvester": bwd_ls,
          "sylvester_tuple_rotations": sum(tuple_calls), "sylvester_rotations": len(tuple_calls),
          "sylvester_hellmann_feynman_rel_err": syl_err,
          "numops_proj": info_p.numops, "k2_tuple_basis_launches": k2_tuple,
          "k2_tuple_max_abs_err": k2_err, "phase_seconds": time.perf_counter() - t_phase})
    require(not card or (fwd_lp.get("project", 0) > 0 and fwd_lp.get("unproject", 0) > 0),
            f"ad_impurity: the forward's sweeps take K5/K6 with the flag on ({fwd_lp})")
    require(not {"fused_step", "project", "unproject"} & set(bwd_lp),
            f"ad_impurity: no K1/K5/K6 on the backward's tuple solves ({bwd_lp})")
    require(proj_err <= 1e-3, f"ad_impurity: gradients with the flag on within 1e-3 ({proj_err})")
    require(syl_err <= 1e-3, f"ad_impurity: the Sylvester rule within 1e-3 of sum v_i^2 ({syl_err})")
    require(sum(tuple_calls) >= 1 and not {"fused_step", "project", "unproject"} & set(bwd_ls)
            and (not card or bwd_ls.get("transform_partial", 0) == sum(tuple_calls)),
            f"ad_impurity: K2 once per rotation of the (w, x) basis, for its first leaf, no "
            f"K1/K5/K6 ({bwd_ls}, {tuple_calls})")
    require((not card or k2_tuple == {"transform_partial": 1}) and k2_err <= 1e-4,
            f"ad_impurity: K2 once on the tuple basis, first leaf only ({k2_tuple}, {k2_err})")
    return {"forward": fwd_l, "backward": bwd_l, "forward_proj": fwd_lp, "backward_proj": bwd_lp,
            "backward_sylvester": bwd_ls, "tuple_basis": k2_tuple}


def ad_potential(torch, np, kt, _build, bd, N=1024, dev="cuda", smi=None):
    """Phase ``ad_potential``: ``x`` solves ``(0.5 + P + diag g) x = b`` by
    CG (relative tolerance 5e-5), ``b = 1``, ``g = 0.5·uniform`` from
    ``default_rng(7)``; the gradient of ``⟨c, x⟩`` (``c`` from
    ``default_rng(8)``) with respect to ``b`` and ``g`` through the CG rule.
    Guards: both solves converge (the backward's by its residual); with
    ``w`` an independent solve of the same system for ``c``, ``b.grad``
    within 1e-3 of ``w`` and ``g.grad`` of ``−w ⊙ x`` (relative ∞-norm).
    Returns the launch counts."""
    t_phase = time.perf_counter()
    n = N * N
    R = n // 128
    P = kt.banded_from_coo(*poisson_coo(np, N, np.float32), n, device=dev)

    def apply(g, x):
        return P(x) + g * x

    g = torch.as_tensor(0.5 * np.random.default_rng(7).uniform(size=(R, 128)).astype(np.float32),
                        device=dev).requires_grad_(True)
    b = torch.ones((R, 128), device=dev).requires_grad_(True)
    c = torch.as_tensor(np.random.default_rng(8).standard_normal((R, 128)).astype(np.float32),
                        device=dev)
    kw = dict(a0=0.5, alg=kt.CG(maxiter=400), rtol=5e-5, atol=0.0)
    op = kt.ParametricOperator(apply, g, adjoint_fn=apply)
    (x, info), fwd_ms, fwd_l = _sync_ms(torch, _build, lambda: kt.linsolve(op, b, **kw), dev)
    _, bwd_ms, bwd_l = _sync_ms(torch, _build, lambda: torch.sum(c * x).backward(), dev)
    grads = (b.grad.clone(), g.grad.clone())
    reps = []  # three more forward/backward pairs, timed alone
    for _ in range(3):
        (x_r, _), f_ms, _ = _sync_ms(torch, _build, lambda: kt.linsolve(op, b, **kw), dev)
        reps.append((f_ms, _sync_ms(torch, _build, lambda: torch.sum(c * x_r).backward(), dev)[1]))
    b.grad, g.grad = grads
    with torch.no_grad():
        opd = kt.ParametricOperator(apply, g.detach(), adjoint_fn=apply)
        w, info_w = kt.linsolve(opd, c, **kw)
        xd = x.detach()
        tol_b = 5e-5 * float(torch.linalg.vector_norm(c))
        res_b = float(torch.linalg.vector_norm(0.5 * b.grad + apply(g.detach(), b.grad) - c))
        wmax = float(w.abs().max())
        err_b = float((b.grad - w).abs().max()) / wmax
        gw = -w * xd
        err_g = float((g.grad - gw).abs().max()) / float(gw.abs().max())
        # a float64 solve of the same system at rtol 1e-10: how far the float32
        # gradient is from the exact one (reported, not held)
        P64 = kt.BandedOperator(P.offsets, P.diags.double(), n)
        g64 = g.detach().double()
        w64, _ = kt.linsolve(lambda y: P64(y) + g64 * y, c.double(), a0=0.5,
                             alg=kt.CG(maxiter=2000), rtol=1e-10, atol=0.0)
        err_b64 = float((b.grad.double() - w64).abs().max() / w64.abs().max())
    per = {"banded_spmv": device_ms(torch, lambda: bd.banded_spmv(c, P.diags, P.offsets, n))
           if dev != "cpu" else 0}
    rec = {"phase": "ad_potential", "n": n, "numops": info.numops, "numiter": info.numiter,
           "converged": int(info.converged), "numops_independent": info_w.numops,
           "backward_residual": res_b, "backward_tol": tol_b, "forward_ms": fwd_ms,
           "backward_ms": bwd_ms, "forward_ms_reps": [r[0] for r in reps],
           "backward_ms_reps": [r[1] for r in reps], "launches_forward": fwd_l,
           "launches_backward": bwd_l, "forward": _kernel_share(fwd_ms, fwd_l, per),
           "backward": _kernel_share(bwd_ms, bwd_l, per), "kernel_ms_per_launch": per,
           "b_grad_rel_err": err_b, "g_grad_rel_err": err_g,
           "b_grad_vs_float64_rel_err": err_b64, "nvidia_smi": smi,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    require(info.converged == 1 and info_w.converged == 1, "ad_potential: CG solves converge")
    # the backward's CG stops on its recurrence's residual; its true one may
    # sit a float32 rounding above tol
    require(res_b <= 2 * tol_b, f"ad_potential: the backward solve converged ({res_b}, {tol_b})")
    require(err_b <= 1e-3, f"ad_potential: b.grad within 1e-3 of w ({err_b})")
    require(err_g <= 1e-3, f"ad_potential: g.grad within 1e-3 of -w*x ({err_g})")
    for launches in (fwd_l, bwd_l):
        require(set(launches) <= {"banded_spmv"}, f"ad_potential: K3 only ({launches})")
    card = dev != "cpu"  # the plain versions count no launch
    require(not card or fwd_l.get("banded_spmv", 0) == info.numops,
            f"ad_potential: forward K3 = numops ({fwd_l}, {info.numops})")
    require(not card or bwd_l.get("banded_spmv", 0) >= 2,
            f"ad_potential: K3 in the backward ({bwd_l})")
    return {"forward": fwd_l, "backward": bwd_l}, (fwd_ms, bwd_ms)


# the small card-against-CPU phase of the two-sided and iterator slice:
# float64 and complex128 values agree to this (relative to the largest)
SMALL_BIEIG_TOL = 1e-10
# the four bound states of config 2's Poisson plus the wells (phase ad_impurity)
IMPURITY_VALS = (-4.5073, -3.5821, -2.6830, -1.8266)


def impurity_wells(N):
    """``(site, depth)`` of the four wells on an ``N × N`` grid: depths −5,
    −6, −7, −8 at the grid's quarter points."""
    q = ((N // 4, N // 4), (N // 4, 3 * N // 4), (3 * N // 4, N // 4), (3 * N // 4, 3 * N // 4))
    return [(i * N + j, d) for (i, j), d in zip(q, (-5.0, -6.0, -7.0, -8.0))]


def counting_calls(module, name, keep=None):
    """Wrap ``module.name`` to record each call (``keep(result)``, or
    ``None``); returns ``(records, restore)``."""
    records, inner = [], getattr(module, name)

    def wrapped(*a, **kw):
        res = inner(*a, **kw)
        records.append(keep(res) if keep else None)
        return res

    setattr(module, name, wrapped)
    return records, lambda: setattr(module, name, inner)


def counting_sweeps(kf):
    """Wrap ``kf.expand_hermitian_selective`` to record each step's sweep
    decision; returns ``(flags, restore)``."""
    return counting_calls(kf, "expand_hermitian_selective", lambda out: out[3])


def counting_k3(bd, adj_diags):
    """Wrap ``bd.banded_spmv`` to count the launches on the planes
    ``adj_diags`` (an operator's adjoint); returns ``(counter, restore)``."""
    adj, inner = [0], bd.banded_spmv

    def wrapped(x, diags, offsets, n):
        adj[0] += int(diags.data_ptr() == adj_diags.data_ptr())
        return inner(x, diags, offsets, n)

    bd.banded_spmv = wrapped
    return adj, lambda: setattr(bd, "banded_spmv", inner)


def small_bieig_iter(torch, np, kt, _build, dev="cuda"):
    """Phase ``small_bieig_iter``: ``bieigsolve``, every iterator and the
    selective Lanczos solve on ``dev`` against the same calls on the CPU
    (plain versions), float64 and complex128.

    Operators: a dense 64 × 64 matrix ``A`` (real, and complex), its
    Hermitian part, and the banded 128-point tridiagonals with sub- and
    superdiagonal −0.3 and −0.2 and diagonal ``linspace(0, 2)``
    (non-symmetric; its adjoint the transposed planes) and ``(−1, 2,
    −1)``.  ``bieigsolve`` in real mode (real matrix and starts) and
    complex mode (complex matrix, or complex starts on the real banded
    planes, which run the plain version: no K3): 3 "LM" to 1e-10 on the
    dense matrix, 2 "LM" to 1e-12 on the banded one, krylovdim 24 (7, 6
    and 8 rounds on the CPU).  Each iterator 10
    expansions: Arnoldi, GKL, BiArnoldi on the non-symmetric operators,
    Lanczos (both modes) and Block Lanczos (a block of 3) on the symmetric
    ones.  ``Lanczos(reorth="selective")`` against full reorthogonalization
    on the 200 × 200 symmetric matrix of ``tests/test_modes.py``.

    Guards: values (projected matrices and residual norms for the
    iterators) within ``SMALL_BIEIG_TOL`` (relative to ``max(1, max|x|)``,
    as ``_rel_err``), equal ``numops``, ``numiter``,
    ``converged`` and sweep counts; on the card K3 once per banded real
    apply (half of it adjoint in ``bieigsolve``) and no other kernel.
    Returns the card's launches."""
    from krylovkit_tpu_torch.factorizations import krylov as kf
    from krylovkit_tpu_torch.ops import banded as bd

    t0 = time.perf_counter()
    card = dev != "cpu"
    quiet = dict(verbosity=kt.SILENT)
    rng = np.random.default_rng(70)
    An = rng.standard_normal((64, 64)) / 8 + np.diag(np.linspace(0, 2, 64))
    Ac = An + 1j * rng.standard_normal((64, 64)) / 8
    starts = {dt: [rng.standard_normal(s) + (1j * rng.standard_normal(s) if dt == "c" else 0)
                   for s in (64, 64, 128, 128, (3, 64), (3, 128))] for dt in ("r", "c")}
    # eigenvalue condition numbers of the leading pair 1.3 and 2.0: card and
    # CPU roundings stay apart by ~1e-15 (a Toeplitz (−1, 2, −0.8) matrix
    # puts them 7e-9 apart at tol 1e-9, its pairs being ill-conditioned)
    nonsym = tridiagonal_coo(np, 128, -0.3, np.linspace(0, 2, 128), -0.2, np.float64)
    sym = tridiagonal_coo(np, 128, -1.0, 2.0, -1.0, np.float64)

    def T(a, d):
        return torch.as_tensor(np.asarray(a), device=d)

    def ops(d):
        return {"dense_real": T(An, d), "dense_complex": T(Ac, d),
                "herm_real": T((An + An.T) / 2, d), "herm_complex": T((Ac + Ac.conj().T) / 2, d),
                "banded": kt.banded_from_coo(*nonsym, 128, device=d),
                "banded_sym": kt.banded_from_coo(*sym, 128, device=d)}

    all_launches, recs = {}, []

    def both(label, run, want_launches):
        """``run(device)`` → a list of tensors to compare, and a tuple of
        counts; on ``dev`` with the counts set to 0 just before, then on the
        CPU."""
        _build.reset_launches()
        out_c, counts_c = run(dev)
        if card:
            torch.cuda.synchronize()
        launched = {k: v for k, v in _build.launches.items() if v}
        out_h, counts_h = run("cpu")
        err = max(_rel_err(torch, a, b) for a, b in zip(out_c, out_h))
        recs.append({"call": label, "max_rel_err": err, "counts": [counts_c, counts_h],
                     "launches": launched})
        require(err <= SMALL_BIEIG_TOL, f"small {label}: card vs CPU within {SMALL_BIEIG_TOL} ({err})")
        require(counts_c == counts_h, f"small {label}: counts equal ({counts_c}, {counts_h})")
        require(not card or launched == want_launches(counts_c),
                f"small {label}: launches {launched}")
        for k, v in launched.items():
            all_launches[k] = all_launches.get(k, 0) + v

    def no_kernel(_):
        return {}

    # bieigsolve: dense real and complex; banded real (K3 both ways) and the
    # same planes with complex starts (complex mode: the plain version)
    for label, key, kind, vecs in (("bieigsolve dense real", "dense_real", "r", (0, 1)),
                                   ("bieigsolve dense complex", "dense_complex", "c", (0, 1)),
                                   ("bieigsolve banded real", "banded", "r", (2, 3)),
                                   ("bieigsolve banded complex mode", "banded", "c", (2, 3))):
        def bieig(d, key=key, kind=kind, vecs=vecs):
            v0, w0 = (T(starts[kind][i], d) for i in vecs)
            op = ops(d)[key]
            adj, restore = counting_k3(bd, op.adj.diags) if key == "banded" else ([0], lambda: None)
            hm, kw = (2, dict(krylovdim=24, tol=1e-12)) if key == "banded" else (
                3, dict(krylovdim=24, tol=1e-10))
            try:
                vals, (V, W), (iV, iW) = kt.bieigsolve(op, v0, w0, hm, "LM", maxiter=50, **kw,
                                                       **quiet)
            finally:
                restore()
            return [vals], (iV.numops, iV.numiter, iV.converged, adj[0])

        k3 = key == "banded" and kind == "r"
        both(label, bieig, lambda c, k3=k3: {"banded_spmv": c[0]} if k3 else {})
        if k3:
            require(recs[-1]["counts"][0][3] * 2 == recs[-1]["counts"][0][0],
                    f"small {label}: half the applies adjoint ({recs[-1]['counts'][0]})")

    # iterators, 10 expansions each
    def iterate(make, k=10):
        def run(d):
            it = make(ops(d), d)
            st = it.initialize()
            for _ in range(k):
                st = it.expand(st)
            sts = st if isinstance(st, tuple) else (st,)
            return ([kt.rayleighquotient(s) for s in sts] + [kt.normres(s).reshape(1) for s in sts],
                    tuple(s.k for s in sts))
        return run

    for kind in ("r", "c"):
        sfx = "real" if kind == "r" else "complex"
        S = starts[kind]
        cases = [
            (f"ArnoldiIterator dense {sfx}", lambda o, d: kt.ArnoldiIterator(o[f"dense_{sfx}"], T(S[0], d), krylovdim=12)),
            (f"GKLIterator dense {sfx}", lambda o, d: kt.GKLIterator(o[f"dense_{sfx}"], T(S[0], d), krylovdim=12)),
            (f"BiArnoldiIterator dense {sfx}", lambda o, d: kt.BiArnoldiIterator(
                o[f"dense_{sfx}"], T(S[0], d), T(S[1], d), krylovdim=12)),
            (f"LanczosIterator dense {sfx}", lambda o, d: kt.LanczosIterator(o[f"herm_{sfx}"], T(S[0], d), krylovdim=12)),
            (f"LanczosIterator 3-term dense {sfx}", lambda o, d: kt.LanczosIterator(
                o[f"herm_{sfx}"], T(S[0], d), krylovdim=12, orth=kt.cgs, keepvecs=False)),
            (f"BlockLanczosIterator dense {sfx}", lambda o, d: kt.BlockLanczosIterator(
                o[f"herm_{sfx}"], T(S[4], d), krylovdim=36)),
        ]
        for label, make in cases:
            both(label, iterate(make), no_kernel)
    S = starts["r"]
    for label, make, per in (
            ("ArnoldiIterator banded", lambda o, d: kt.ArnoldiIterator(o["banded"], T(S[2], d), krylovdim=12), 1),
            ("GKLIterator banded", lambda o, d: kt.GKLIterator(o["banded"], T(S[2], d), krylovdim=12), 2),
            ("BiArnoldiIterator banded", lambda o, d: kt.BiArnoldiIterator(
                o["banded"], T(S[2], d), T(S[3], d), krylovdim=12), 2),
            ("LanczosIterator banded", lambda o, d: kt.LanczosIterator(o["banded_sym"], T(S[2], d), krylovdim=12), 1),
            ("LanczosIterator 3-term banded", lambda o, d: kt.LanczosIterator(
                o["banded_sym"], T(S[2], d), krylovdim=12, orth=kt.cgs, keepvecs=False), 1),
            ("BlockLanczosIterator banded", lambda o, d: kt.BlockLanczosIterator(
                o["banded_sym"], T(S[5], d), krylovdim=36), 3)):
        both(label, iterate(make), lambda c, per=per: {"banded_spmv": 10 * per})

    # selective against full reorthogonalization (tests/test_modes.py's matrix)
    r116 = np.random.default_rng(116)
    M = r116.standard_normal((200, 200)) / np.sqrt(200)
    M = (M + M.T) / 2
    x0 = r116.standard_normal(200)
    vals_by = {}
    for reorth in ("full", "selective"):
        def lanczos(d, reorth=reorth):
            flags, restore = counting_sweeps(kf)
            try:
                vals, _, info = kt.eigsolve(T(M, d), T(x0, d), 4, "LR", ishermitian=True,
                                            alg=kt.Lanczos(krylovdim=30, tol=1e-10, maxiter=60,
                                                           reorth=reorth, **quiet))
            finally:
                restore()
            vals_by[(reorth, d)] = vals.cpu()
            return [vals], (info.numops, info.numiter, info.converged, sum(flags))

        both(f"eigsolve Lanczos reorth={reorth}", lanczos, no_kernel)
    agree = _rel_err(torch, vals_by[("selective", dev)], vals_by[("full", dev)])
    require(agree <= 1e-8, f"small selective: values within 1e-8 of full reorthogonalization ({agree})")
    emit({"phase": "small_bieig_iter", "calls": recs, "selective_vs_full_rel_diff": agree,
          "tolerance": SMALL_BIEIG_TOL, "phase_seconds": time.perf_counter() - t0})
    return all_launches


def timed_rounds(torch, module, names, solve, dev):
    """The wall time of each call of ``module.<name>`` for every name in
    ``names`` during one ``solve()``, synchronised before and after each
    call; returns ``{name: [ms, ...]}``."""
    times = {name: [] for name in names}
    inner = {name: getattr(module, name) for name in names}

    def timed(name):
        def call(*a, **kw):
            if dev != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner[name](*a, **kw)
            if dev != "cpu":
                torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    for name in names:
        setattr(module, name, timed(name))
    try:
        solve()
    finally:
        for name in names:
            setattr(module, name, inner[name])
    return times


def bieig_predicted_projections(numops, numiter):
    """K5 and K6 launches of a real-mode ``bieigsolve`` with the projection
    flag on (cgs2, a single-tensor basis): per expansion pair four cgs
    sweeps (K5 and K6 each) and the two ``_update_M`` projections (K5); per
    round the two projections of the oblique correction (K5); per restart
    (``numiter − 1``: the last round ends the solve) the two ``_update_M``
    projections of the residual slot (K5).  The unprojections of the
    correction and the restart have no live length: no K6."""
    pairs = numops // 2
    return 6 * pairs + 2 * numiter + 2 * (numiter - 1), 4 * pairs


# iterations of phase 20's bieigsolve and of phase 27's (cut from 8 for the
# script's time budget: a dense round costs ~0.3 s)
BIEIG_ITERS = 2  # cut from 8, then 4, for the script's time budget


def bieig_full(torch, np, kt, _build, bd, bs, fl, pb, n=1 << 20, dev="cuda", smi=None):
    """Phase ``bieig``: ``bieigsolve`` at config 4's width — the banded
    transport-diffusion tridiagonal ``(−1.3, 2.0, −0.7)``, n = 2^20, float32
    ``(n/128, 128)`` vectors, its adjoint the transposed planes (K3 both
    ways), ``v0 = default_rng(1)``, ``w0 = default_rng(10)``, 4 "LM",
    krylovdim 30, maxiter :data:`BIEIG_ITERS`, tol 1e-30 (nothing converges:
    fixed work) — with the projection kernels off and on.  Per route the
    launch counts of one solve (warm-up), then a timed solve; then the dense
    rounds (two Schur decompositions, two sorts) of one more solve.

    Guards: ``numiter`` :data:`BIEIG_ITERS` and ``numops`` equal on both
    routes; ``numops`` even and between 2·(30 + (BIEIG_ITERS − 1)·12)
    (``keep`` 12 at every restart: the 2×2-block adjustment lowers ``keep``
    from 18 to 12 at most) and 2·(30 + (BIEIG_ITERS − 1)·18) (``keep`` 18); K3 = ``numops``, half of it on the adjoint's planes; no K1, no
    K2; with the flag K5 and K6 as :func:`bieig_predicted_projections`
    counts; every ``|λ| <= 4 + ‖A v − λ v‖/‖v‖`` (‖A‖ <= 4 by Gershgorin;
    an unconverged two-sided Ritz value is no Rayleigh quotient and may lie
    outside the numerical range, but it is an eigenvalue of ``A − r
    vᴴ/‖v‖²``); the leading |λ| of the two routes within 1e-3; finite
    values and vectors; ``diag(WᴴV)`` nonzero.  Reported, not guarded: the
    off-diagonal of ``WᴴV`` relative to its diagonal.  Returns the launches
    of the two routes and the operator."""
    t_phase = time.perf_counter()
    R = n // 128
    m = 30
    card = dev != "cpu"
    op = kt.banded_from_coo(*tridiagonal_coo(np, n, -1.3, 2.0, -0.7, np.float32), n, device=dev)
    v0, w0 = (torch.from_numpy(np.random.default_rng(s).standard_normal((R, 128)).astype(np.float32))
              .to(dev) for s in (1, 10))
    kw = dict(krylovdim=m, maxiter=BIEIG_ITERS, tol=1e-30, verbosity=kt.SILENT)

    def solve():
        return kt.bieigsolve(op, v0, w0, 4, "LM", **kw)

    # per-launch times at this shape, measured alone: K3 on the normal and the
    # adjoint planes, K5/K6 on a (31, R, 128) basis at every live length
    per = {}
    if card:
        per["banded_spmv"] = device_ms(torch, lambda: bd.banded_spmv(v0, op.diags, op.offsets, n))
        per["banded_spmv_adjoint"] = device_ms(
            torch, lambda: bd.banded_spmv(v0, op.adj.diags, op.adj.offsets, n))
    out = {}
    for metric, flag in (("bieigsolve_nonsym_banded", False), ("bieigsolve_nonsym_banded_proj", True)):
        bs.use_pallas_projections = flag
        adj, restore = counting_k3(bd, op.adj.diags)
        ks_u, unproject = [], pb.unproject_pallas

        def rec_unproject(V, c, k):
            ks_u.append(int(k))
            return unproject(V, c, k)

        pb.unproject_pallas = rec_unproject
        try:
            (vals, (V, W), (iV, iW)), launches, _, sweeps, first_ms, ms = drive_counted(
                torch, _build, fl, pb, solve) if card else _cpu_counted(solve)
        finally:
            bs.use_pallas_projections = False
            pb.unproject_pallas = unproject
            restore()
        adj_launches = adj[0] // 2 if card else adj[0]  # the counted solve of two
        ks_p = [k for _, k in sweeps]
        ks_u = ks_u[: len(ks_u) // 2] if card else ks_u
        kernel_ms = {}
        if card:
            kernel_ms["banded_spmv"] = ((launches.get("banded_spmv", 0) - adj_launches) * per["banded_spmv"]
                                        + adj_launches * per["banded_spmv_adjoint"])
            if flag:
                Vb = torch.randn((m + 1, R, 128), device=dev)
                wb, cb = torch.randn((R, 128), device=dev), torch.randn(m + 1, device=dev)
                pk, uk = {}, {}
                for k in set(ks_p):
                    pk[k] = device_ms(torch, lambda: pb.project_pallas(Vb, wb, k), reps=5)
                for k in set(ks_u):
                    uk[k] = device_ms(torch, lambda: pb.unproject_pallas(Vb, cb, k), reps=5)
                kernel_ms["project"] = sum(pk[k] for k in ks_p)
                kernel_ms["unproject"] = sum(uk[k] for k in ks_u)
                del Vb, wb, cb
        lam = vals.detach().cpu()
        # each pair's own residual (applies made after the counts were read):
        # λ is an eigenvalue of A − r vᴴ/‖v‖², so |λ| <= ‖A‖ + ‖r‖/‖v‖ <= 4 + ‖r‖/‖v‖
        vn = torch.linalg.vector_norm(V.reshape(4, -1), dim=1)
        res = torch.stack([torch.linalg.vector_norm(op.normal(V[i].real) + 1j * op.normal(V[i].imag)
                                                    - vals[i] * V[i]) for i in range(4)])
        bound_l = (4.0 + res / vn).cpu()
        G = torch.einsum("ixy,jxy->ij", W.conj(), V).cpu().to(torch.complex128)
        dg = torch.diagonal(G).abs()
        off = float((G - torch.diag(torch.diagonal(G))).abs().max() / dg.max())
        out[metric] = {"info": iV, "launches": launches, "adjoint": adj_launches, "abs": lam.abs(),
                       "ks_p": ks_p, "ks_u": ks_u}
        emit({
            "metric": metric, "value": iV.numops * 3 * n / ms / 1e6, "unit": "Gnnz/s",
            "formula": "numops * 3n / t (both sides' applies counted)", "projection_kernels": flag,
            "numops": iV.numops, "numiter": iV.numiter, "converged": iV.converged,
            "ms_per_solve": ms, "first_solve_ms": first_ms,
            "abs_vals": lam.abs().tolist(), "vals_re": lam.real.tolist(), "vals_im": lam.imag.tolist(),
            "normres_right": iV.normres.cpu().tolist(), "normres_left": iW.normres.cpu().tolist(),
            "launches_per_solve": launches, "banded_spmv_adjoint_launches": adj_launches,
            "projection_k_mean": sum(ks_p) / len(ks_p) if ks_p else None,
            "WhV_diag_abs": dg.tolist(), "WhV_offdiag_rel": off,
            "true_residual_over_norm": (res / vn).cpu().tolist(),
            "kernel_ms_per_solve": kernel_ms, "kernel_ms_per_launch": per,
            "outside_kernels_ms_per_solve": ms - sum(kernel_ms.values()),
            "outside_kernels_share": (ms - sum(kernel_ms.values())) / ms,
            "device": torch.cuda.get_device_name(0) if card else "cpu", "nvidia_smi": smi,
        })
        lo, hi = (2 * (m + (BIEIG_ITERS - 1) * keep) for keep in (12, 18))
        require(iV.numiter == BIEIG_ITERS and iW.numiter == BIEIG_ITERS,
                f"{metric}: {BIEIG_ITERS} iterations ({iV.numiter})")
        require(iV.numops % 2 == 0 and lo <= iV.numops <= hi,
                f"{metric}: numops even, in {lo}..{hi} ({iV.numops})")
        require(bool(torch.isfinite(lam.abs()).all()) and bool((lam.abs() <= bound_l + 1e-3).all()),
                f"{metric}: |lambda| <= 4 + |A v - lambda v|/|v| (Gershgorin, widened by the pair's "
                f"residual): {lam.abs().tolist()} vs {bound_l.tolist()}")
        require(tuple(V.shape) == tuple(W.shape) == (4, R, 128) and bool(torch.isfinite(V).all())
                and bool(torch.isfinite(W).all()), f"{metric}: finite (4, R, 128) vectors")
        require(bool((dg > 0).all()), f"{metric}: diag(W^H V) nonzero ({dg.tolist()})")
        if card:
            want = {"banded_spmv": iV.numops}
            if flag:
                want["project"], want["unproject"] = bieig_predicted_projections(iV.numops, iV.numiter)
            require(launches == want, f"{metric}: launches {launches}, predicted {want}")
            require(2 * adj_launches == iV.numops, f"{metric}: half of K3 on the adjoint's planes "
                    f"({adj_launches} of {iV.numops})")
    off_r, on_r = (out[k] for k in ("bieigsolve_nonsym_banded", "bieigsolve_nonsym_banded_proj"))
    require(off_r["info"].numops == on_r["info"].numops,
            f"bieig: numops equal on both routes ({off_r['info'].numops}, {on_r['info'].numops})")
    agree = float((on_r["abs"][0] - off_r["abs"][0]).abs() / off_r["abs"][0])
    # the dense layer: each round's two Schur decompositions and two sorts
    rounds = timed_rounds(torch, kt.dense, ("real_schur_active", "sort_schur_real"), solve, dev)
    nr = len(rounds["real_schur_active"]) // 2
    per_round = [sum(rounds[k][2 * r] + rounds[k][2 * r + 1] for k in rounds) for r in range(nr)]
    emit({"phase": "bieig_agreement", "leading_abs_rel_diff": agree, "tolerance": 1e-3,
          "numops": off_r["info"].numops, "dense_rounds": nr, "dense_ms_per_round": per_round,
          "dense_ms_per_round_mean": sum(per_round) / nr,
          "dense_ms_by_call": {k: sum(v) for k, v in rounds.items()},
          "phase_seconds": time.perf_counter() - t_phase})
    require(agree <= 1e-3, f"bieig: leading |lambda| of the two routes within 1e-3 ({agree})")
    require(nr == BIEIG_ITERS, f"bieig: one dense round per iteration ({nr})")
    return {"bieig": off_r["launches"], "bieig_proj": on_r["launches"], "operator": op}


def _cpu_counted(solve):
    """CPU rehearsal of ``drive_counted``: one solve, no launches, no times."""
    return solve(), {}, [], [], 0.0, 1.0


def impurity_banded(np, kt, N, dev):
    """Config 2's 5-point Poisson matrix on the ``N × N`` grid with the four
    wells of :func:`impurity_wells` on its main plane, as a plain
    ``BandedOperator`` (float32; K3 per apply)."""
    rows, cols, vals = poisson_coo(np, N, np.float32)
    sites, depths = zip(*impurity_wells(N))
    return kt.banded_from_coo(np.concatenate([rows, sites]), np.concatenate([cols, sites]),
                              np.concatenate([vals, np.asarray(depths, np.float32)]), N * N,
                              device=dev)


def _ortho_err(torch, X):
    """``max|XᴴX − I|`` of the rows of ``X`` (float64)."""
    X = X.reshape(X.shape[0], -1).to(torch.float64)
    return float((X @ X.T - torch.eye(X.shape[0], dtype=X.dtype, device=X.device)).abs().max())


def _rel_norm(torch, a, b):
    """``‖a − b‖_F / ‖a‖_F`` in float64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a))


def lanczos_variants(torch, np, kt, _build, bd, bs, fl, pb, N=1024, dev="cuda", smi=None):
    """Phase ``lanczos_variants``: the Lanczos variants and the iterators at
    config 2's width (the ``N × N`` grid, float32 ``(N²/128, 128)``
    vectors).

    1. ``eigsolve(P + wells, x0, 4, "SR", ishermitian=True,
       alg=Lanczos(krylovdim=30, maxiter=10, tol=1e-5))``, ``x0 =
       default_rng(6)``, with full and with selective reorthogonalization,
       each with the projection kernels off and on: 4 converged values on
       every route within 1e-4 of each other and of ``IMPURITY_VALS``; K3 =
       ``numops``; K2 = processing rounds + 1 (each round's rotation, the
       last one the identity, and the extraction); with the flag K5 = K6 =
       ``numops`` (full: one drift sweep a step) or the number of sweeps
       (selective, at most ``numops``); no K1.
    2. ``LanczosIterator`` with ``keepvecs=True`` (cgs2) and
       ``keepvecs=False`` (cgs), 30 expansions each: K3 30 each, the basis
       orthonormal to 1e-4, the leading 8 × 8 of the two tridiagonals within
       1e-3 relative, the lowest Ritz value of the full one within 1e-4 of
       the eigsolve's; the peak memory each allocates.
    3. ``ArnoldiIterator``, ``BiArnoldiIterator`` and ``GKLIterator`` on
       config 4's banded tridiagonal (n = N², K3 both ways), and
       ``BlockLanczosIterator`` with a block of 4 from ``default_rng(5)`` on
       the Poisson matrix, 30 expansions each: K3 exact, each basis
       orthonormal to 1e-4, the factorization relation (as
       ``tests/test_factorize.py`` checks it) to 1e-4 relative.

    Returns the launches of the selective solves and of the iterators, and
    the impurity operator (``operator``)."""
    from krylovkit_tpu_torch.factorizations import krylov as kf

    t_phase = time.perf_counter()
    card = dev != "cpu"
    n = N * N
    R = n // 128
    op = impurity_banded(np, kt, N, dev)
    x0 = torch.from_numpy(np.random.default_rng(6).standard_normal((R, 128)).astype(np.float32)).to(dev)
    want = torch.tensor(IMPURITY_VALS, dtype=torch.float64)
    k3 = device_ms(torch, lambda: bd.banded_spmv(x0, op.diags, op.offsets, n)) if card else 0.0
    out, vals_by = {}, {}
    for reorth in ("full", "selective"):
        for flag in (False, True):
            metric = f"lanczos_{reorth}_impurity" + ("_proj" if flag else "")
            alg = kt.Lanczos(krylovdim=30, maxiter=10, tol=1e-5, reorth=reorth, verbosity=kt.SILENT)
            flags, restore = counting_sweeps(kf)
            bs.use_pallas_projections = flag
            try:
                (vals, vecs, info), launches, _, _, first_ms, ms = drive_counted(
                    torch, _build, fl, pb,
                    lambda: kt.eigsolve(op, x0, 4, "SR", ishermitian=True, alg=alg)
                ) if card else _cpu_counted(
                    lambda: kt.eigsolve(op, x0, 4, "SR", ishermitian=True, alg=alg))
            finally:
                bs.use_pallas_projections = False
                restore()
            sweeps = sum(flags[: info.numops])  # the counted solve's steps come first
            vh = vals.detach().cpu().double()
            vals_by[metric] = vh
            kernel_ms = {"banded_spmv": launches.get("banded_spmv", 0) * k3}
            out[metric] = {"info": info, "launches": launches, "sweeps": sweeps}
            emit({
                "metric": metric, "value": info.numops * 5 * n / ms / 1e6, "unit": "Gnnz/s",
                "formula": "numops * 5n / t", "reorth": reorth, "projection_kernels": flag,
                "numops": info.numops, "numiter": info.numiter, "converged": info.converged,
                "sweeps": sweeps if reorth == "selective" else info.numops,
                "ms_per_solve": ms, "first_solve_ms": first_ms, "vals": vh.tolist(),
                "normres": info.normres.cpu().tolist(), "launches_per_solve": launches,
                "kernel_ms_per_solve": kernel_ms,
                "outside_kernels_ms_per_solve": ms - sum(kernel_ms.values()),
                "device": torch.cuda.get_device_name(0) if card else "cpu", "nvidia_smi": smi,
            })
            require(info.converged >= 4, f"{metric}: 4 values converged ({info.converged})")
            if N == 1024:
                require(float((vh - want).abs().max()) <= 1e-4,
                        f"{metric}: values within 1e-4 of {IMPURITY_VALS} ({vh.tolist()})")
            require(reorth == "full" or sweeps <= info.numops,
                    f"{metric}: at most one sweep a step ({sweeps}, {info.numops})")
            if card:
                # one K2 per processing round (the last one the identity) and
                # one for the extraction; rounds = numiter when every round fills
                w = {"banded_spmv": info.numops, "transform_partial": info.numiter + 1}
                if flag:
                    w["project"] = w["unproject"] = info.numops if reorth == "full" else sweeps
                require(launches == w, f"{metric}: launches {launches}, predicted {w}")
    ref = vals_by["lanczos_full_impurity"]
    agree = max(float((v - ref).abs().max()) for v in vals_by.values())
    require(agree <= 1e-4, f"lanczos_variants: the four routes' values within 1e-4 ({agree})")

    # the Lanczos iterators: full basis (cgs2) and the 3-term recurrence
    its = {}
    for label, it in (("full", kt.LanczosIterator(op, x0, krylovdim=30)),
                      ("3term", kt.LanczosIterator(op, x0, krylovdim=30, orth=kt.cgs, keepvecs=False))):
        if card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        st = it.initialize()
        for _ in range(30):
            st = it.expand(st)
        if card:
            torch.cuda.synchronize()
        its[label] = {"state": st, "ms": (time.perf_counter() - t0) * 1e3,
                      "launches": {k: v for k, v in _build.launches.items() if v},
                      "peak_mib": ((torch.cuda.max_memory_allocated() - base) / 2 ** 20) if card
                      else "not measured"}
    Tf, T3 = (its[k]["state"].H.cpu().double() for k in ("full", "3term"))
    Tf, T3 = (torch.tril(T) + torch.tril(T, -1).T for T in (Tf, T3))
    tri_err = float((T3[:8, :8] - Tf[:8, :8]).abs().max() / Tf[:8, :8].abs().max())
    ritz = float(torch.linalg.eigvalsh(Tf[:30, :30])[0])
    ortho_l = _ortho_err(torch, its["full"]["state"].V[:31])
    recs = [{"iterator": f"LanczosIterator {k}", "expansions": 30, "ms": v["ms"],
             "launches": v["launches"], "peak_memory_mib": v["peak_mib"]} for k, v in its.items()]
    iter_launches = {}
    for v in its.values():
        for k, c in v["launches"].items():
            iter_launches[k] = iter_launches.get(k, 0) + c
    require(all(not card or v["launches"] == {"banded_spmv": 30} for v in its.values()),
            f"lanczos iterators: K3 30 each ({[v['launches'] for v in its.values()]})")
    require(ortho_l <= 1e-4, f"LanczosIterator: basis orthonormal to 1e-4 ({ortho_l})")
    require(tri_err <= 1e-3, f"LanczosIterator: 3-term and full tridiagonals within 1e-3 ({tri_err})")
    require(abs(ritz - float(vals_by["lanczos_full_impurity"][0])) <= 1e-4,
            f"LanczosIterator: lowest Ritz value within 1e-4 of the eigsolve's ({ritz})")
    del its

    # Arnoldi, BiArnoldi and GKL on config 4's banded tridiagonal; Block
    # Lanczos on the Poisson matrix
    A4 = kt.banded_from_coo(*tridiagonal_coo(np, n, -1.3, 2.0, -0.7, np.float32), n, device=dev)
    P = kt.banded_from_coo(*poisson_coo(np, N, np.float32), n, device=dev)
    v0, w0 = (torch.from_numpy(np.random.default_rng(s).standard_normal((R, 128)).astype(np.float32))
              .to(dev) for s in (1, 10))
    rng5 = np.random.default_rng(5)
    X0 = torch.stack([torch.from_numpy(rng5.standard_normal((R, 128)).astype(np.float32))
                      for _ in range(4)]).to(dev)
    for label, it, per in (("ArnoldiIterator", kt.ArnoldiIterator(A4, v0, krylovdim=30), 1),
                           ("BiArnoldiIterator", kt.BiArnoldiIterator(A4, v0, w0, krylovdim=30), 2),
                           ("GKLIterator", kt.GKLIterator(A4, v0, krylovdim=30), 2),
                           ("BlockLanczosIterator", kt.BlockLanczosIterator(P, X0, krylovdim=120), 4)):
        _build.reset_launches()
        t0 = time.perf_counter()
        st = it.initialize()
        for _ in range(30):
            st = it.expand(st)
        if card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in _build.launches.items() if v}
        for k, c in launches.items():
            iter_launches[k] = iter_launches.get(k, 0) + c
        # the invariants (their applies come after the counts were read)
        if label == "GKLIterator":
            k = st.k
            ortho = max(_ortho_err(torch, st.U[: k + 1]), _ortho_err(torch, st.V[:k]))
            AV = torch.stack([A4.normal(x) for x in st.V[:k]]).reshape(k, -1)
            AhU = torch.stack([A4.apply_adjoint(x) for x in st.U[:k]]).reshape(k, -1)
            B = st.B.to(torch.float64)
            rel = max(_rel_norm(torch, AV, B[: k + 1, :k].T @ st.U[: k + 1].reshape(k + 1, -1).double()),
                      _rel_norm(torch, AhU, B[:k, :k] @ st.V[:k].reshape(k, -1).double()))
        elif label == "BlockLanczosIterator":
            ortho, rel = _ortho_err(torch, st.V[: st.k]), None
        else:
            sides = st if isinstance(st, tuple) else (st,)
            ortho, rel = 0.0, 0.0
            for s, apply in zip(sides, (A4.normal, A4.apply_adjoint)):
                k = s.k
                ortho = max(ortho, _ortho_err(torch, s.V[: k + 1]))
                AV = torch.stack([apply(x) for x in s.V[:k]]).reshape(k, -1)
                VH = s.H[: k + 1, :k].double().T @ s.V[: k + 1].reshape(k + 1, -1).double()
                rel = max(rel, _rel_norm(torch, AV, VH))
        recs.append({"iterator": label, "expansions": 30, "ms": ms, "launches": launches,
                     "orthonormality_err": ortho, "factorization_rel_err": rel})
        require(not card or launches == {"banded_spmv": 30 * per},
                f"{label}: K3 {30 * per} ({launches})")
        require(ortho <= 1e-4, f"{label}: basis orthonormal to 1e-4 ({ortho})")
        require(rel is None or rel <= 1e-4, f"{label}: factorization relation to 1e-4 ({rel})")
        del st, it
    emit({"phase": "lanczos_variants_iterators", "iterators": recs,
          "tridiagonal_3term_vs_full_rel": tri_err, "lowest_ritz_full": ritz,
          "lanczos_basis_orthonormality_err": ortho_l, "values_agreement": agree,
          "device": torch.cuda.get_device_name(0) if card else "cpu", "nvidia_smi": smi,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"selective": out["lanczos_selective_impurity"]["launches"],
            "selective_proj": out["lanczos_selective_impurity_proj"]["launches"],
            "iterators": iter_launches, "operator": op}


def banded_csr(torch, D, offsets, n):
    """The banded matrix as a ``torch.sparse_csr_tensor`` of its nonzero
    entries: the cuSPARSE yardstick, never called by the port."""
    i = torch.arange(n, device=D.device)
    cols = i[:, None] + torch.tensor(offsets, device=D.device)[None, :]
    vals = D.reshape(len(offsets), -1)[:, :n].T
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=D.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return torch.sparse_csr_tensor(crow, cols[keep], vals[keep], (n, n))


def check_banded(torch, bd, label, x, D, offsets, n, flush):
    """K3 against its plain version on the card; returns the case record.
    The error is measured against ``Σ_p |d_p[i]|·|x[i+δ_p]|``: float32 FMAs
    against separate products and sums, both in offset order."""
    y = bd.banded_spmv(x, D, offsets, n)
    yr = bd.banded_spmv_reference(x, D, offsets, n)
    scale = bd.banded_spmv_reference(x.abs(), D.abs(), offsets, n).clamp_min(torch.finfo(x.dtype).tiny)
    torch.cuda.synchronize()
    rel = float(((y - yr).abs() / scale).max())
    tol = 1e-6 if x.dtype == torch.float32 else 1e-15
    require(rel <= tol, f"banded_spmv {label}: within {tol}*sum|d||x|")
    A = banded_csr(torch, D, offsets, n)
    xf = x.reshape(n)
    lib_rel = float(((torch.mv(A, xf).reshape(yr.shape) - yr).abs() / scale).max())
    require(lib_rel <= 10 * tol, f"banded_spmv {label}: the cuSPARSE yardstick computes the same product")
    nd, itemsize = len(offsets), x.element_size()
    rate = F32_FLOP_PER_S if x.dtype == torch.float32 else F64_FLOP_PER_S
    t_bound, by = bound((nd + 2) * n * itemsize, 2 * nd * n, rate)
    return {
        "case": label, "n": n, "offsets": len(offsets), "dtype": str(x.dtype),
        "max_abs_err": float((y - yr).abs().max()), "max_rel_err": rel,
        "tolerance": f"{tol}*sum_p|d_p||x|", "library_rel_err": lib_rel,
        "ms": device_ms(torch, lambda: bd.banded_spmv(x, D, offsets, n)),
        "cold_ms": cold_device_ms(torch, lambda: bd.banded_spmv(x, D, offsets, n), flush),
        "plain_ms": device_ms(torch, lambda: bd.banded_spmv_reference(x, D, offsets, n), reps=3),
        "library_ms": device_ms(torch, lambda: torch.mv(A, xf)),
        "library": "torch.mv(sparse_csr_tensor, x) (cuSPARSE)",
        "bound_ms": t_bound, "bound_by": by,
    }


def check_laplacian(torch, s1, n, dtype, gen, flush):
    """K4 against its plain version on the card (the same operations in the
    same order); returns the case record."""
    x = torch.randn((n // 128, 128), generator=gen, device="cuda", dtype=dtype)
    y = s1.laplacian_1d_flat(x)
    yr = s1.laplacian_1d_flat_reference(x)
    w = torch.tensor([-1.0, 2.0, -1.0], dtype=dtype, device="cuda").view(1, 1, 3)

    def conv():
        return torch.nn.functional.conv1d(x.view(1, 1, n), w, padding=1)

    torch.cuda.synchronize()
    require(tuple(y.shape) == (n,), "laplacian_1d: flat (n,) result")
    sc = float(yr.abs().max())
    err = float((y - yr).abs().max())
    tol = 1e-6 if dtype == torch.float32 else 1e-15
    require(err <= tol * sc, f"laplacian_1d {dtype}: within {tol}*scale")
    lib_err = float((conv().view(n) - yr).abs().max())
    require(lib_err <= 4 * tol * sc, f"laplacian_1d {dtype}: the conv1d yardstick computes the same map")
    rate = F32_FLOP_PER_S if dtype == torch.float32 else F64_FLOP_PER_S
    t_bound, by = bound(2 * n * x.element_size(), 3 * n, rate)
    return {
        "n": n, "dtype": str(dtype), "max_abs_err": err, "scale": sc,
        "tolerance": f"{tol}*scale", "bit_equal": bool(torch.equal(y, yr)),
        "ms": device_ms(torch, lambda: s1.laplacian_1d_flat(x)),
        "cold_ms": cold_device_ms(torch, lambda: s1.laplacian_1d_flat(x), flush),
        "plain_ms": device_ms(torch, lambda: s1.laplacian_1d_flat_reference(x), reps=3),
        "library_ms": device_ms(torch, conv), "library": "torch.nn.functional.conv1d (cuDNN, TF32 off)",
        "bound_ms": t_bound, "bound_by": by,
    }


def check_projections(torch, pb, kmax, R, ks, gen, timed=()):
    """K5 (project) and K6 (unproject) against their plain versions on the
    card for each live length in ``ks``, with ``k`` passed as a host int and
    as a device tensor, the rows ``>= k`` filled with NaN (they must never
    be read) and K5 run twice (bit-equal).  Returns ``(K5 cases, K6 cases)``;
    the lengths in ``timed`` also carry times, bounds and the cuBLAS
    yardsticks ``torch.mv(V[:k], w)`` and ``c[:k] @ V[:k]``."""
    n = R * 128
    V = torch.randn((kmax, R, 128), generator=gen, device="cuda")
    w = torch.randn((R, 128), generator=gen, device="cuda")
    c0 = torch.randn(kmax, generator=gen, device="cuda")
    nw = torch.linalg.vector_norm(w)
    tol = 1e-6
    p_cases, u_cases = [], []
    for k in ks:
        Vn = V.clone()
        Vn[k:] = float("nan")
        c = c0.clone()
        c[k:] = 0
        kdev = torch.tensor([k], dtype=torch.int32, device="cuda")
        want_c, want_y = pb.project_reference(Vn, w, k), pb.unproject_reference(Vn, c, k)
        Vk = V[:k].reshape(k, n)
        scale_c = torch.linalg.vector_norm(Vk, dim=1) * nw
        scale_y = (c[:k].abs()[:, None] * Vk.abs()).sum(0).reshape(R, 128)
        err_c = err_y = rel_c = rel_y = 0.0
        for kk in (k, kdev):
            got_c, again = pb.project_pallas(Vn, w, kk), pb.project_pallas(Vn, w, kk)
            got_y = pb.unproject_pallas(Vn, c, kk)
            torch.cuda.synchronize()
            label = f"kmax={kmax} R={R} k={k} ({'device' if kk is kdev else 'host'} k)"
            require(bool(torch.isfinite(got_c).all()) and bool(torch.isfinite(got_y).all()),
                    f"projections {label}: rows >= k never read (no NaN)")
            require(torch.equal(got_c, again), f"project {label}: two runs bit-equal")
            require(not bool(got_c[k:].any()), f"project {label}: zero beyond k")
            d_c, d_y = (got_c - want_c)[:k].abs(), (got_y - want_y).abs()
            require(bool((d_c <= tol * scale_c).all()),
                    f"project {label}: within {tol}*|V_j||w|")
            require(bool((d_y <= tol * scale_y).all()),
                    f"unproject {label}: within {tol}*sum_j|c_j||V_j|")
            if k:
                err_c, err_y = max(err_c, float(d_c.max())), max(err_y, float(d_y.max()))
                rel_c = max(rel_c, float((d_c / scale_c).max()))
                rel_y = max(rel_y, float((d_y / scale_y.clamp_min(1e-30)).max()))
            else:
                require(not bool(got_y.any()), f"unproject {label}: k = 0 gives zeros")
        pc = {"kmax": kmax, "n": n, "k": k, "max_abs_err": err_c, "max_rel_err": rel_c,
              "tolerance": f"{tol}*|V_j||w|", "bit_equal_twice": True, "rows_ge_k_nan": True}
        uc = {"kmax": kmax, "n": n, "k": k, "max_abs_err": err_y, "max_rel_err": rel_y,
              "tolerance": f"{tol}*sum_j|c_j||V_j|", "rows_ge_k_nan": True}
        if k in timed:
            pc.update(time_project(torch, pb, V, w, k, kdev))
            uc.update(time_unproject(torch, pb, V, c, k, kdev))
        p_cases.append(pc)
        u_cases.append(uc)
    return p_cases, u_cases


def time_project(torch, pb, V, w, k, kdev, plain_reps=3):
    """K5's time at live length ``k`` beside its bound (``V[:k]`` and ``w``
    read once, ``c`` written), its plain version and the cuBLAS gemv."""
    kmax, n = V.shape[0], V[0].numel()
    Vk, wf = V[:k].reshape(k, -1), w.reshape(-1)
    t_bound, by = bound((k + 1) * n * 4 + kmax * 4, 2 * k * n)
    return {
        "ms": device_ms(torch, lambda: pb.project_pallas(V, w, kdev)),
        "plain_ms": device_ms(torch, lambda: pb.project_reference(V, w, k), reps=plain_reps),
        "library_ms": device_ms(torch, lambda: torch.mv(Vk, wf)),
        "library": "torch.mv(V[:k].view(k, -1), w.view(-1)) (cuBLAS gemv)",
        "bound_ms": t_bound, "bound_by": by,
    }


def time_unproject(torch, pb, V, c, k, kdev, plain_reps=3):
    """K6's time at live length ``k`` beside its bound (``V[:k]`` and ``c``
    read once, ``y`` written), its plain version and the cuBLAS gemv."""
    kmax, n = V.shape[0], V[0].numel()
    Vk, ck = V[:k].reshape(k, -1), c[:k]
    t_bound, by = bound((k + 1) * n * 4 + kmax * 4, 2 * k * n)
    return {
        "ms": device_ms(torch, lambda: pb.unproject_pallas(V, c, kdev)),
        "plain_ms": device_ms(torch, lambda: pb.unproject_reference(V, c, k), reps=plain_reps),
        "library_ms": device_ms(torch, lambda: ck @ Vk),
        "library": "c[:k] @ V[:k].view(k, -1) (cuBLAS gemv)",
        "bound_ms": t_bound, "bound_by": by,
    }


def drive_counted(torch, _build, fl, pb, solve, reps=1):
    """One ``solve()`` with the launch counts set to 0 just before it and
    read just after (the ``(B, with_drift, spec)`` of each fused step and the
    ``(R, k)`` of each projection are recorded too), then ``reps`` timed
    ones (the counted solve is timed too: ``first_ms``).  Returns
    ``(result, launches, steps, sweeps, first_ms, ms_per_solve)``."""
    steps, sweeps = [], []
    fused_step, project = fl.fused_step, pb.project_pallas

    def recording(V, y, g, kp1, B, spec, with_drift=False, **halos):
        steps.append((B, with_drift, spec))
        return fused_step(V, y, g, kp1, B, spec, with_drift, **halos)

    def rec_project(V, w, k):
        sweeps.append((V.shape[1], int(k)))
        return project(V, w, k)

    fl.fused_step, pb.project_pallas = recording, rec_project
    try:
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in _build.launches.items() if v}
    finally:
        fl.fused_step, pb.project_pallas = fused_step, project
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solve()
    torch.cuda.synchronize()
    return out, launches, steps, sweeps, first_ms, (time.perf_counter() - t0) / reps * 1e3


def timed_calls(torch, module, name, solve):
    """The wall time of each call of ``module.name`` during one ``solve()``,
    synchronised before and after; returns the list in ms."""
    return timed_rounds(torch, module, (name,), solve, "cuda")[name]


def tridiagonal_coo(np, n, lower, diag, upper, dtype):
    """COO triplets of the Toeplitz tridiagonal matrix that the stencil
    ``((-1, 0, 1), (lower, diag, upper))`` applies."""
    i = np.arange(n)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[1:] - 1, i, i[:-1] + 1])
    vals = np.concatenate([np.full(n - 1, lower), np.full(n, diag), np.full(n - 1, upper)])
    return rows, cols, vals.astype(dtype)


def profile_solve(torch, label, solve):
    """One solve (``solve()``) under ``torch.profiler``, after the timed ones."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches, syncs = {}, 0, 0
    for evt in prof.events():
        dev_us = getattr(evt, "device_time", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time", 0.0)
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            launches += 1
            kernels[evt.name] = kernels.get(evt.name, 0.0) + dev_us / 1e3
        elif evt.name == "aten::_local_scalar_dense":
            syncs += 1
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "phase": "profile", "solve": label, "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if launches else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if launches else "not measured",
        "device_ops": launches, "host_scalar_reads": syncs,
        "device_ms_by_kernel": {name[:80]: ms for name, ms in top},
    }


# ---------------------------------------------------------------------------
# sharded runs: ranks of one torch.distributed group (the distribution layer)
# ---------------------------------------------------------------------------

SHARD_TIMEOUT_S = 120  # collective timeout of every rank group: a divergence fails


def _rank_entry(rank, world, store_path, backend, dev, threads, fn_name, kwargs, queue):
    """One rank: joins the group through a ``FileStore``, runs
    ``<fn_name>(torch, np, kt, dev=dev, **kwargs)`` of this module and puts
    ``(rank, result, error)`` on ``queue``."""
    import datetime
    import traceback

    try:
        import numpy as np
        import torch

        sys.path.insert(0, ROOT)
        import krylovkit_tpu_torch as kt

        torch.set_num_threads(threads)
        if dev == "cuda":
            torch.cuda.set_device(0)
        torch.distributed.init_process_group(
            backend, store=torch.distributed.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        try:
            out = globals()[fn_name](torch, np, kt, dev=dev, **kwargs)
        finally:
            torch.distributed.destroy_process_group()
        queue.put((rank, out, None))
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        queue.put((rank, None, traceback.format_exc()))


def start_ranks(world, fn_name, dev="cpu", backend="gloo", threads=1, timeout=600, **kwargs):
    """Start ``world`` spawned ranks of one group (``backend``, vectors on
    ``dev``) that run ``<fn_name>`` of this module; :func:`collect_ranks`
    waits for them.  The caller may work meanwhile."""
    import tempfile

    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    tmpdir = tempfile.TemporaryDirectory()
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, world, os.path.join(tmpdir.name, "store"), backend, dev,
                               threads, fn_name, kwargs, q))
             for r in range(world)]
    for p in procs:
        p.start()
    return {"procs": procs, "queue": q, "tmpdir": tmpdir, "fn": fn_name, "world": world,
            "deadline": time.time() + timeout, "timeout": timeout}


def collect_ranks(handle):
    """The results of :func:`start_ranks`' ranks, by rank.  Raises when a
    rank fails or the run outlasts its timeout; every rank process is ended
    before it returns."""
    import queue as queue_mod

    world, fn_name, results = handle["world"], handle["fn"], {}
    try:
        while len(results) < world:
            try:
                rank, out, err = handle["queue"].get(
                    timeout=max(1.0, handle["deadline"] - time.time()))
            except queue_mod.Empty:
                raise RuntimeError(f"{fn_name}: ranks {sorted(set(range(world)) - set(results))} "
                                   f"gave no result within {handle['timeout']} s") from None
            if err is not None:
                raise RuntimeError(f"{fn_name}: rank {rank} failed:\n{err}")
            results[rank] = out
    finally:
        for p in handle["procs"]:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        handle["tmpdir"].cleanup()
    return [results[r] for r in range(world)]


def run_ranks(world, fn_name, dev="cpu", backend="gloo", threads=1, timeout=600, **kwargs):
    """Run ``<fn_name>`` of this module on ``world`` spawned ranks of one
    group (``backend``, vectors on ``dev``) and return their results by
    rank (:func:`start_ranks`, then :func:`collect_ranks`)."""
    return collect_ranks(start_ranks(world, fn_name, dev, backend, threads, timeout, **kwargs))


def same_on_every_rank(np, results):
    """``results[0]`` after checking that every rank returned the same
    values, bit for bit (replicated scalars, gathered vectors, counts)."""
    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
        return a == b or (a != a and b != b)

    for r, res in enumerate(results[1:], 1):
        require(equal(results[0], res), f"rank {r} returned what rank 0 did")
    return results[0]


def gather(torch, ax, x, dim=0):
    """The blocks ``x`` of every rank of the mesh axis ``ax``, concatenated
    along ``dim`` on every rank (one all-reduce of a zero-filled buffer)."""
    slots = torch.zeros((ax.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    slots[ax.index] = x
    return torch.cat(list(ax.psum(slots)), dim=dim)


def _infos(info):
    return {"numops": int(info.numops), "numiter": int(info.numiter),
            "converged": int(info.converged)}


SHARDED_FUSED = {"chain_cgs": "cgs", "chain_cgs2": "cgs2", "grid": "cgs2"}


def sharded_cases(torch, np, kt, dev="cpu", names=None):
    """The sharded scenarios of the JAX package's tests at their sizes, on
    this rank (called on every rank of a group, ``run_ranks``): the ELL
    apply (banded, rectangular tiled, long-range couplings, a one-rank
    mesh), Lanczos on the sharded ELL operator and on ``sharded_laplacian_1d``,
    CG, LSMR, GKL ``svdsolve``, the real Arnoldi ``schursolve``, the fused
    Lanczos on ``shard_local_stencil`` (chain with cgs and cgs2, grid) and
    its apply, batched GMRES on a ``(2, world/2)`` mesh (``linsolve_gmres_batched``
    on this rank's batch row of right-hand sides), the sharded K5
    projection, a start vector that is zero on rank 0's block, the ELL
    operator's applies per ``numops``, the collective counters, and
    ``make_mesh``'s refusals.  Each
    returns global values (vectors gathered from every rank) and counts, or
    ``{"error": traceback}``; ``names`` picks some."""
    import traceback

    import torch.distributed as dist

    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.factorizations import krylov as kf
    from krylovkit_tpu_torch.ops import basis as bs
    from krylovkit_tpu_torch.ops.vector import VectorSpace
    from krylovkit_tpu_torch.parallel import sparse as psp

    P = kt.parallel
    mesh = P.make_mesh(device=dev)
    ax = mesh.axis(P.VECTOR_AXIS)
    space = VectorSpace(psum_axis=ax)
    f64 = torch.float64

    def sv(a, m=mesh):
        return P.shard_vector(torch.as_tensor(np.asarray(a)), m)

    def host(t, dim=0, a=ax):
        return gather(torch, a, t, dim).cpu().numpy()

    def spmv_dense():
        n = 264 * 8
        r, c, v = P.banded_coo(n, halfband=5, seed=1, spd=False)
        op = P.sharded_ell_from_coo(r, c, v, (n, n), mesh)
        x = sv(np.random.default_rng(2).standard_normal(n))
        return {"y": host(op.normal(x)), "z": host(op.adjoint(x)),
                "deltas": list(op.fwd_plan.deltas)}

    def spmv_rect_tiled():
        m, n = 128 * 8, 64 * 8
        r, c, v = P.rect_sparse_coo(m, n, nnz_per_row=7, seed=3)
        op = P.sharded_ell_from_coo(r, c, v, (m, n), mesh, tile=8)
        rng = np.random.default_rng(4)
        x = sv(rng.standard_normal((n // 8, 8)))
        u = sv(rng.standard_normal((m // 8, 8)))
        y, w = op.normal(x), op.adjoint(u)
        return {"y": host(y), "v": host(w), "y_local_shape": list(y.shape)}

    def spmv_long_range():
        n = 64 * 8
        i = np.arange(n)
        k = 3 * (n // 8)
        rows = np.concatenate([i, i[:-k], i[k:]])
        cols = np.concatenate([i, i[:-k] + k, i[k:] - k])
        vals = np.concatenate([np.full(n, 2.0), np.full(n - k, -1.0), np.full(n - k, -1.0)])
        op = P.sharded_ell_from_coo(rows, cols, vals, (n, n), mesh)
        x = sv(np.random.default_rng(5).standard_normal(n))
        return {"y": host(op.normal(x)), "deltas": list(op.fwd_plan.deltas)}

    def eigsolve_ell():
        n = 104 * 8
        r, c, v = P.banded_coo(n, halfband=4, seed=11, spd=True)
        op = P.sharded_ell_from_coo(r, c, v, (n, n), mesh)
        x0 = sv(np.random.default_rng(12).standard_normal(n))
        applies = []
        spmv = psp._spmv
        psp._spmv = lambda *a: applies.append(1) or spmv(*a)
        try:
            vals, vecs, info = kt.eigsolve(op, x0, 4, "LM", ishermitian=True, tol=1e-10,
                                           krylovdim=30, maxiter=200, space=space)
        finally:
            psp._spmv = spmv
        return {"vals": vals.cpu().numpy(), "applies": len(applies), **_infos(info)}

    def lssolve_lsmr():
        m, n = 96 * 8, 48 * 8
        r, c, v = P.rect_sparse_coo(m, n, nnz_per_row=6, seed=21)
        op = P.sharded_ell_from_coo(r, c, v, (m, n), mesh)
        b = sv(np.random.default_rng(22).standard_normal(m))
        x, info = kt.lssolve(op, b, tol=1e-12, maxiter=3 * n, space=space)
        return {"x": host(x), **_infos(info)}

    def svdsolve_gkl():
        m, n = 64 * 8, 40 * 8
        r, c, v = P.rect_sparse_coo(m, n, nnz_per_row=5, seed=31)
        op = P.sharded_ell_from_coo(r, c, v, (m, n), mesh)
        x0 = sv(np.random.default_rng(32).standard_normal(m))
        S, U, V, info = kt.svdsolve(op, x0, 3, "LR", tol=1e-10, krylovdim=30, maxiter=100,
                                    space=space)
        return {"vals": S.cpu().numpy(), **_infos(info)}

    def mesh1():
        m1 = P.make_mesh(devices=[dist.get_rank()], device=dev)
        n = 512
        r, c, v = P.banded_coo(n, halfband=3, seed=41)
        op = P.sharded_ell_from_coo(r, c, v, (n, n), m1)
        x = torch.as_tensor(np.random.default_rng(42).standard_normal(n), device=dev)
        return {"y": op.normal(x).cpu().numpy(), "deltas": list(op.fwd_plan.deltas)}

    def eigsolve_laplacian():
        n = 256
        op = P.sharded_laplacian_1d(n, mesh)
        x0 = sv(np.random.default_rng(105).standard_normal(n))
        vals, _, info = kt.eigsolve(op, x0, 2, "LM", ishermitian=True, tol=1e-8, krylovdim=30,
                                    maxiter=300, space=space)
        return {"vals": vals.cpu().numpy(), **_infos(info)}

    def cg_laplacian():
        n = 512
        op = P.sharded_laplacian_1d(n, mesh)
        b = sv(np.random.default_rng(104).standard_normal(n))
        x, info = kt.linsolve(op, b, alg=kt.CG(tol=1e-10, maxiter=3000), space=space)
        return {"x": host(x), **_infos(info)}

    def schursolve_real():
        n = 256
        d = np.linspace(1.0, 5.0, n)
        i = np.arange(n)
        rows = np.concatenate([i, i[:-1]])
        cols = np.concatenate([i, i[:-1] + 1])
        vals = np.concatenate([d, np.full(n - 1, 0.02)])
        op = P.sharded_ell_from_coo(rows, cols, vals, (n, n), mesh)
        x0 = sv(np.random.default_rng(106).standard_normal(n))
        T, vecs, (re, im), info = kt.schursolve(op, x0, 2, "LM", krylovdim=25, maxiter=150,
                                                tol=1e-9, space=space)
        return {"re": re.cpu().numpy(), "im": im.cpu().numpy(), **_infos(info)}

    def fused(kind):
        orth = SHARDED_FUSED[kind]
        if kind == "grid":
            gr, gc = 64, 256
            glob = kt.poisson_2d(gr, gc, device=dev)
            x = np.random.default_rng(62).standard_normal((gr * gc // 128, 128))
            alg = kt.Lanczos(krylovdim=16, maxiter=3, tol=1e-6)
        else:
            n = 1 << 15
            glob = kt.laplacian_1d(n, device=dev)
            x = np.random.default_rng(61).standard_normal((n // 128, 128))
            alg = kt.Lanczos(krylovdim=16, maxiter=4, tol=1e-6, orth=getattr(kt, orth))
        op = P.shard_local_stencil(glob, ax)
        x0 = sv(x.astype(np.float32))
        _build.reset_launches()
        eligible = kf.fused_available(op, x0, space, kmax=alg.krylovdim + 1)
        vals, vecs, info = kt.eigsolve_lanczos(op, x0, 4, "LM", alg, space=space)
        return {"vals": vals.cpu().numpy(), "vecs": host(vecs, dim=1), "fused": eligible,
                "launches": dict(_build.launches), **_infos(info)}

    def fused_gmres():
        gr, gc = 64, 256
        op = P.shard_local_stencil(kt.poisson_2d(gr, gc, device=dev), ax)
        b = sv(np.random.default_rng(63).standard_normal((gr * gc // 128, 128))
               .astype(np.float32))
        alg = kt.GMRES(krylovdim=16, maxiter=3, tol=1e-6, verbosity=kt.SILENT)
        _build.reset_launches()
        eligible = kf.fused_available(op, b, space, kmax=alg.krylovdim + 1)
        x, info = kt.linsolve(op, b, torch.zeros_like(b), 0.5, 1.0, alg=alg, space=space)
        return {"x": host(x), "fused": eligible, "launches": dict(_build.launches),
                **_infos(info)}

    def replicate_and_groups():
        # each rank holds other data; replicate gives every rank the root's
        mine = torch.full((3,), float(dist.get_rank() + 1), dtype=f64)
        rep = P.replicate({"a": mine, "b": (mine * 2,)}, mesh)
        # a space on the axis's process group reduces as one on the axis
        x = sv(np.arange(64 * ax.size, dtype=np.float64))
        by_group = VectorSpace(psum_axis=ax.group).inner(x, x)
        return {"a": rep["a"].cpu().numpy(), "b": rep["b"][0].cpu().numpy(),
                "inner_axis": float(space.inner(x, x)), "inner_group": float(by_group)}

    def stencil_apply():
        n = 1 << 14
        op = kt.StencilOperator((-200, 0, 200), (0.3, 1.0, -0.4))
        x = np.random.default_rng(71).standard_normal((n // 128, 128)).astype(np.float32)
        loc = P.shard_local_stencil(op, ax)
        return {"y": host(loc.normal(sv(x))), "z": host(loc.adjoint(sv(x)))}

    def gmres_batched():
        mb = P.make_mesh(batch=2, device=dev)
        axv = mb.axis(P.VECTOR_AXIS)
        n3 = 32 * axv.size
        op = P.sharded_laplacian_1d(n3, mb)
        B = P.shard_vector(torch.ones((4, n3), dtype=f64), mb, batched=True)
        alg = kt.GMRES(krylovdim=16, maxiter=50, tol=1e-9)
        sp = VectorSpace(psum_axis=axv)
        X, info = kt.linsolve_gmres_batched(op, B, torch.zeros_like(B), 1.0, 1.0, alg, sp)
        infos = [{k: int(getattr(info, k)[i]) for k in ("numops", "numiter", "converged")}
                 for i in range(B.shape[0])]
        X = gather(torch, mb.axis(P.BATCH_AXIS), gather(torch, axv, X, dim=1))
        return {"X": X.cpu().numpy(), "infos": infos}

    def project_k5():
        R, kmax, k = 32, 9, 6
        rng = np.random.default_rng(81)
        V = rng.standard_normal((kmax, R * ax.size, 128)).astype(np.float32)
        w = rng.standard_normal((R * ax.size, 128)).astype(np.float32)
        Vl = P.shard_vector(torch.as_tensor(V).transpose(0, 1).contiguous(), mesh)
        old = bs.use_pallas_projections
        bs.use_pallas_projections = True
        try:
            _build.reset_launches()
            c = bs.project(Vl.transpose(0, 1).contiguous(), sv(w), k, space)
        finally:
            bs.use_pallas_projections = old
        return {"c": c.cpu().numpy(), "launches": dict(_build.launches)}

    def zero_block_x0():
        n = 104 * 8
        r, c, v = P.banded_coo(n, halfband=4, seed=11, spd=True)
        op = P.sharded_ell_from_coo(r, c, v, (n, n), mesh)
        x = np.random.default_rng(13).standard_normal(n)
        x[: n // ax.size] = 0.0
        vals, _, info = kt.eigsolve(op, sv(x), 2, "LM", ishermitian=True, tol=1e-10,
                                    krylovdim=30, maxiter=200, space=space)
        return {"vals": vals.cpu().numpy(), **_infos(info)}

    def collective_stats():
        # an ELL apply starts one all-reduce (every halo round) and waits
        # for it after its interior rows; a norm is one more.  Both are
        # counted, and timed only with time_collectives on
        from krylovkit_tpu_torch.ops import collectives as pc

        n = 264 * 8
        r, c, v = P.banded_coo(n, halfband=5, seed=1, spd=False)
        op = P.sharded_ell_from_coo(r, c, v, (n, n), mesh)
        x = sv(np.random.default_rng(2).standard_normal(n))
        out = {"halo_elems": op.fwd_plan.halo_elems}
        for timed in (False, True):
            pc.reset_stats()
            pc.time_collectives = timed
            try:
                space.norm(op.normal(x))
            finally:
                pc.time_collectives = False
            out["timed" if timed else "untimed"] = {
                "collectives": pc.stats["collectives"], "bytes": pc.stats["bytes"],
                "seconds_positive": pc.stats["seconds"] > 0}
        pc.reset_stats()
        return out

    def mesh_refusals():
        out = {}
        if not torch.cuda.is_available():
            try:
                P.make_mesh()
                out["default_device"] = "no error"
            except RuntimeError as e:
                out["default_device"] = str(e)
        return out

    scenarios = {
        "spmv_dense": spmv_dense, "spmv_rect_tiled": spmv_rect_tiled,
        "spmv_long_range": spmv_long_range, "eigsolve_ell": eigsolve_ell,
        "lssolve_lsmr": lssolve_lsmr, "svdsolve_gkl": svdsolve_gkl, "mesh1": mesh1,
        "eigsolve_laplacian": eigsolve_laplacian, "cg_laplacian": cg_laplacian,
        "schursolve_real": schursolve_real, "fused_chain_cgs": lambda: fused("chain_cgs"),
        "fused_chain_cgs2": lambda: fused("chain_cgs2"), "fused_grid": lambda: fused("grid"),
        "stencil_apply": stencil_apply, "gmres_batched": gmres_batched,
        "fused_gmres": fused_gmres, "replicate_and_groups": replicate_and_groups,
        "project_k5": project_k5, "zero_block_x0": zero_block_x0,
        "collective_stats": collective_stats, "mesh_refusals": mesh_refusals,
    }
    out = {}
    for name, fn in scenarios.items():
        if names is not None and name not in names:
            continue
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 - the same on every rank; reported per scenario
            out[name] = {"error": traceback.format_exc()}
    return out


# the scenarios on the card: the ELL apply and the solves of the main
# sharded front-ends, and every one that launches a kernel (K1, K2, K5);
# the rest run in the CPU tests only
SMALL_SHARDED = ("spmv_rect_tiled", "eigsolve_ell", "lssolve_lsmr", "svdsolve_gkl",
                 "fused_chain_cgs2", "fused_grid", "gmres_batched", "fused_gmres", "project_k5")
SMALL_SHARDED_TOL = 1e-12  # float64: card ranks against CPU ranks, relative to the largest entry
SMALL_SHARDED_TOL32 = 2e-4  # float32 (the fused Lanczos and K5): kernel against plain version


def compare_sharded(np, card, cpu, phase="small_sharded", tol64=None):
    """Each scenario of ``sharded_cases`` (or ``front_end_cases``,
    ``sharded_ad_cases``) on the card's ranks against the CPU's: float64
    arrays within ``tol64`` (default :data:`SMALL_SHARDED_TOL`) of the
    largest entry, float32 ones within :data:`SMALL_SHARDED_TOL32`,
    everything else (counts, plans, flags) equal; fused eigenvectors by
    ``|<a, b>| ≈ 1``.  Returns one record per scenario."""
    tol64 = SMALL_SHARDED_TOL if tol64 is None else tol64
    records = []
    for name, want in cpu.items():
        got = card[name]
        require("error" not in got and "error" not in want,
                f"{phase} {name}: ran on both ({got.get('error') or want.get('error')})")
        worst = 0.0
        for key, w in want.items():
            g = got[key]
            if key == "launches":
                continue
            if key == "vecs":
                dots = [abs(float(np.dot(a.ravel(), b.ravel()))) for a, b in zip(g, w)]
                require(all(abs(d - 1) <= 1e-3 for d in dots), f"{phase} {name}: vectors")
                continue
            if isinstance(w, np.ndarray):
                tol = SMALL_SHARDED_TOL32 if w.dtype == np.float32 else tol64
                err = float(np.max(np.abs(g - w))) / max(float(np.max(np.abs(w))), 1e-300)
                require(g.shape == w.shape and err <= tol,
                        f"{phase} {name}.{key}: card within {tol} of CPU ({err})")
                worst = max(worst, err)
            else:
                require(g == w, f"{phase} {name}.{key}: card {g} == CPU {w}")
        records.append({"scenario": name, "max_rel_err": worst,
                        "launches_per_rank": got.get("launches", {}),
                        **{k: got[k] for k in ("numops", "numiter", "converged") if k in got}})
    return records


def small_sharded_rank(torch, np, kt, dev="cpu", names=None, batched_names=None):
    """Phase ``small_sharded`` on this rank, in one process: :func:`sharded_cases`
    of ``names``, then :func:`sharded_batched_cases` of ``batched_names``
    (one-problem loops for :data:`SMALL_SHARDED_BATCHED_SOLVES` only, cut
    to ``small``), each part's seconds beside it."""
    t0 = time.perf_counter()
    sharded = sharded_cases(torch, np, kt, dev, names)
    t1 = time.perf_counter()
    batched = sharded_batched_cases(torch, np, kt, dev, batched_names,
                                    one_problem=SMALL_SHARDED_BATCHED_SOLVES, small=True)
    return {"sharded": sharded, "batched": batched,
            "seconds": {"sharded": t1 - t0, "batched": time.perf_counter() - t1}}


def small_sharded(torch, np, world=2):
    """Phase ``small_sharded``: :func:`small_sharded_rank` on ``world`` ranks
    of one gloo group with CUDA tensors and, at the same time, on ``world``
    CPU ranks of another.  :func:`sharded_cases`: the card within 1e-12 of
    the CPU (float64), counts equal, and the kernels of the fused and K5
    scenarios launched on every card rank; then :func:`small_sharded_batched`."""
    t0 = time.perf_counter()
    kw = {"names": SMALL_SHARDED,
          "batched_names": SMALL_SHARDED_BATCHED + SMALL_SHARDED_BATCHED_SOLVES}
    on_card = start_ranks(world, "small_sharded_rank", dev="cuda", threads=2, timeout=600, **kw)
    on_cpu = start_ranks(world, "small_sharded_rank", dev="cpu", threads=2, timeout=600, **kw)
    try:
        card_all = collect_ranks(on_card)
    finally:
        cpu_all = collect_ranks(on_cpu)
    card = same_on_every_rank(np, [r["sharded"] for r in card_all])
    cpu = same_on_every_rank(np, [r["sharded"] for r in cpu_all])
    records = compare_sharded(np, card, cpu)
    for name, kernel in (("fused_chain_cgs2", "fused_step"), ("fused_grid", "fused_step"),
                         ("fused_gmres", "fused_step"),
                         ("fused_chain_cgs2", "transform_partial"), ("project_k5", "project")):
        require(card[name]["launches"].get(kernel, 0) > 0,
                f"small_sharded {name}: {kernel} launched on every card rank")
        require(card[name].get("fused", True),
                f"small_sharded {name}: the sharded space kept the fused path")
    launches = {}
    for name in card:
        for key, count in card[name].get("launches", {}).items():
            launches[key] = launches.get(key, 0) + count
    emit({"phase": "small_sharded", "ranks": world, "backend": "gloo", "scenarios": records,
          "tolerance": SMALL_SHARDED_TOL, "tolerance_float32": SMALL_SHARDED_TOL32,
          "launches_per_rank": launches, "seconds": time.perf_counter() - t0,
          "rank_seconds": {"card": card_all[0]["seconds"], "cpu": cpu_all[0]["seconds"]}})
    batched = small_sharded_batched(
        np, same_on_every_rank(np, [r["batched"] for r in card_all]),
        same_on_every_rank(np, [r["batched"] for r in cpu_all]), world,
        {"card": card_all[0]["seconds"]["batched"], "cpu": cpu_all[0]["seconds"]["batched"]})
    for key, count in batched.items():
        launches[key] = launches.get(key, 0) + count
    return launches


# the batched scenarios on the card: every one that launches a kernel
# (batched K1 with halos, K2, K5, K6); the unfused batched GMRES runs in
# sharded_cases' gmres_batched, and the rest in the CPU tests only
SMALL_SHARDED_BATCHED = ("lanczos_fused", "schursolve_fused", "exponentiate_fused",
                         "gmres_fused", "arnoldi_flag")
# and the GKL, LSMR and pencil drivers (float64, no kernel), each problem
# held against its one-problem sharded solve on the card too, with fewer
# problems and at caps that keep the phase short (gloo all-reduces of CUDA
# tensors take ms: at four problems the five added 6.2-7.4 s to the card
# ranks' time on an NVIDIA H100 80GB HBM3, 700.00 W)
# and (phase batched_eager_selective) the eager and selective batches: the
# same problems as lanczos_ell, bicgstab's tridiagonal, gkl, biarnoldi and
# exponentiate_fused (SHARDED_BATCHED_BASE), eager=True or
# reorth="selective"; no kernel (float64, or float32 unfused)
SHARDED_BATCHED_EAGER = ("lanczos_selective", "lanczos_eager", "schursolve_eager", "gkl_eager",
                         "biarnoldi_eager", "exponentiate_eager")
# and (phase batched_ad) pytree vectors on a sharded space: a (p, q) tuple a
# problem, the coupled map (p, q) -> (L p + q/2, L q + p/2) of
# sharded_laplacian_1d(n), whose applies make their own collectives one
# problem at a time (float64, no kernel)
SHARDED_BATCHED_TREE = ("tree_cg", "tree_gmres", "tree_lanczos")
SHARDED_BATCHED_TREE_N = 256
SHARDED_BATCHED_TREE_ALGS = {"tree_cg": {"tol": 1e-10, "maxiter": 400},
                             "tree_gmres": {"krylovdim": 16, "maxiter": 50, "tol": 1e-9},
                             "tree_lanczos": {"krylovdim": 20, "maxiter": 4, "tol": 1e-10}}
SMALL_SHARDED_BATCHED_SOLVES = ("gkl", "lsmr", "golubye", "biarnoldi",
                                "blocklanczos") + SHARDED_BATCHED_EAGER + SHARDED_BATCHED_TREE
SMALL_SHARDED_BATCHED_P = 2
SMALL_SHARDED_BATCHED_CAPS = {"gkl": {"maxiter": 1}, "lsmr": {"maxiter": 10},
                              "golubye": {"maxiter": 2}, "biarnoldi": {"maxiter": 1},
                              "blocklanczos": {"maxiter": 1},
                              "lanczos_selective": {"maxiter": 1, "krylovdim": 6},
                              "lanczos_eager": {"maxiter": 1, "krylovdim": 6},
                              "schursolve_eager": {"maxiter": 1, "krylovdim": 4},
                              "gkl_eager": {"maxiter": 1, "krylovdim": 6},
                              "biarnoldi_eager": {"maxiter": 1, "krylovdim": 4},
                              "exponentiate_eager": {"krylovdim": 6},
                              "tree_cg": {"maxiter": 12}, "tree_gmres": {"maxiter": 1},
                              "tree_lanczos": {"maxiter": 1, "krylovdim": 8}}


def small_sharded_batched(np, card, cpu, world=2, seconds=None):
    """The second half of phase ``small_sharded``: the batched drivers on a
    sharded space (a ``batch 1 × vec 2`` mesh at two ranks), card ranks
    against CPU ranks: within 1e-12 (float32 2e-4), counts equal, batched
    K1 and K5 launched on every card rank and no one-problem K1, K2, K5 or
    K6 (the one-problem sharded solves they are held against bit for bit
    run in the CPU tests, ``tests/test_torch_sharded_batched*.py``); the
    GKL, LSMR and pencil drivers each problem bit-identical to its
    one-problem sharded solve on the card ranks, with its counts.  Returns
    the launches per rank."""
    for name in SMALL_SHARDED_BATCHED_SOLVES:
        got = card[name]
        require("error" not in got, f"small_sharded_batched {name}: ran ({got.get('error')})")
        require(got["one_problem_bits"] and got["warn_lines_equal"],
                f"small_sharded_batched {name}: each problem its one-problem sharded solve, "
                "bit for bit, with its WARN lines")
        require(got["one_problem_counts"] == [list(c) for c in zip(
            got["numops"], got["numiter"], got["converged"])],
            f"small_sharded_batched {name}: the one-problem counts")
    for name in SMALL_SHARDED_BATCHED:
        got = card[name]
        kernels = {"arnoldi_flag": ("project_batched", "unproject_batched")}.get(
            name, ("fused_step_batched",))
        for kernel in kernels:
            require(min(got["launches"].get(kernel, [0])) > 0,
                    f"small_sharded_batched {name}: {kernel} launched on every card rank")
        one = {"fused_step", "transform_partial", "project", "unproject"} & set(got["launches"])
        require(not one, f"small_sharded_batched {name}: no one-problem launch ({one})")
    records = compare_sharded(np, card, cpu, phase="small_sharded_batched")
    launches = {}
    for name in card:
        for key, count in card[name].get("launches", {}).items():
            launches[key] = launches.get(key, 0) + max(count)
    emit({"phase": "small_sharded_batched", "ranks": world, "backend": "gloo",
          "mesh": {"batch": max(world // 2, 1), "vec": 2}, "problems": SHARDED_BATCHED_P,
          "scenarios": records, "collectives_per_solve": {
              name: card[name]["collectives"] for name in card},
          "one_problem_collectives": {name: card[name]["one_problem_collectives"]
                                      for name in SMALL_SHARDED_BATCHED_SOLVES},
          "caps": SMALL_SHARDED_BATCHED_CAPS, "problems_capped": SMALL_SHARDED_BATCHED_P,
          "tolerance": SMALL_SHARDED_TOL, "tolerance_float32": SMALL_SHARDED_TOL32,
          "launches_per_rank": launches, "rank_seconds": seconds})
    return launches


# ---------------------------------------------------------------------------
# the remaining front-ends on a sharded space
# ---------------------------------------------------------------------------

FRONT_END_N = 104 * 8  # whole blocks over 2 and 4 ranks
FRONT_END_TRI = (-1.3, 2.0, -0.7)  # config 4's transport-diffusion tridiagonal
FRONT_END_NEG_LAP = ((-1, 0, 1), (1.0, -2.0, 1.0))  # the operator config 4's exponentiate takes
FRONT_END_ITERATORS = ("lanczos_iterator", "arnoldi_iterator", "gkl_iterator",
                       "block_lanczos_iterator", "biarnoldi_iterator")
FRONT_END_STEPS = 10  # expansions of each iterator


def front_end_problem(np, P, name):
    """The global data of scenario ``name`` of :func:`front_end_cases`:
    COO triplets (``coo``, and ``coo_b`` for a pencil; shape ``shape``) and
    start vectors from numpy seeds.  ``P`` is a ``parallel`` module (this
    port's, or the JAX package's for the other side of a comparison: their
    ``banded_coo`` and ``rect_sparse_coo`` make the same triplets)."""
    n = FRONT_END_N
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "exponentiate_fused":
        n = 1 << 15
        return {"n": n, "x": rng.standard_normal((n // 128, 128)).astype(np.float32)}
    out = {"shape": (n, n)}
    if name in ("bicgstab", "arnoldi_iterator", "biarnoldi_iterator"):
        out["coo"] = tridiagonal_coo(np, n, *FRONT_END_TRI, np.float64)
    elif name == "bieigsolve":
        # random non-symmetric couplings on a graded diagonal: well separated,
        # well conditioned eigenvalues of largest modulus
        rows, cols, vals = tridiagonal_coo(np, n, *FRONT_END_TRI, np.float64)
        off = rows != cols
        vals[off] = 0.1 * rng.standard_normal(int(off.sum()))
        vals[~off] = 4 * np.linspace(0, 1, n) ** 8
        out["coo"] = (rows, cols, vals)
    elif name == "gkl_iterator":
        out["shape"] = (96 * 8, 48 * 8)
        out["coo"] = P.rect_sparse_coo(*out["shape"], nnz_per_row=6, seed=21)
    else:
        out["coo"] = P.banded_coo(n, halfband=4, seed=11, spd=True)
    if name == "geneigsolve":
        i = np.arange(n)
        out["coo_b"] = (i, i, 1.0 + rng.random(n))
    rows = out["shape"][0]
    out["x"], out["y"], out["z"] = rng.standard_normal((3, rows))
    out["block"] = rng.standard_normal((3, rows))
    return out


def front_end_cases(torch, np, kt, dev="cpu", names=None):
    """The scenarios of the tenth slice on this rank (called on every rank
    of a group, ``run_ranks``): MINRES, BiCGStab, ``exponentiate`` unfused
    (float64, the sharded ELL operator) and fused (float32,
    ``shard_local_stencil``: K1 per rank with external halos),
    ``expintegrator`` with three vectors, ``geneigsolve`` with a sharded
    diagonal ``B``, ``bieigsolve`` (the adjoint plan), Block Lanczos, MINRES
    on a dict vector whose leaves are sharded, and the five iterators
    (:data:`FRONT_END_STEPS` expansions: the projected matrix and ``β``).
    Each returns global values and counts, or ``{"error": traceback}``;
    ``names`` picks some."""
    import traceback

    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.factorizations import krylov as kf
    from krylovkit_tpu_torch.ops.vector import VectorSpace

    P = kt.parallel
    mesh = P.make_mesh(device=dev)
    ax = mesh.axis(P.VECTOR_AXIS)
    space = VectorSpace(psum_axis=ax)
    quiet = {"verbosity": kt.SILENT}

    def sv(a):
        return P.shard_vector(torch.as_tensor(np.asarray(a)), mesh)

    def host(t, dim=0):
        return gather(torch, ax, t, dim).cpu().numpy()

    def ell(prob, key="coo"):
        return P.sharded_ell_from_coo(*prob[key], prob["shape"], mesh)

    def minres():
        prob = front_end_problem(np, P, "minres")
        x, info = kt.linsolve(ell(prob), sv(prob["x"]), alg=kt.MINRES(tol=1e-10, maxiter=400, **quiet),
                              space=space)
        return {"x": host(x), **_infos(info)}

    def bicgstab():
        prob = front_end_problem(np, P, "bicgstab")
        x, info = kt.linsolve(ell(prob), sv(prob["x"]), None, 1.0, 1.0,
                              alg=kt.BiCGStab(tol=1e-10, maxiter=400, **quiet), space=space)
        return {"x": host(x), **_infos(info)}

    def exponentiate():
        prob = front_end_problem(np, P, "exponentiate")
        y, info = kt.exponentiate(ell(prob), -0.05, sv(prob["x"]), ishermitian=True, tol=1e-10,
                                  krylovdim=20, space=space, **quiet)
        return {"y": host(y), **_infos(info)}

    def exponentiate_fused():
        prob = front_end_problem(np, P, "exponentiate_fused")
        op = P.shard_local_stencil(kt.StencilOperator(*FRONT_END_NEG_LAP), ax)
        x0 = sv(prob["x"])
        alg = kt.Lanczos(krylovdim=30, tol=1e-4, **quiet)
        eligible = kf.fused_available(op, x0, space, kmax=alg.krylovdim + 1)
        _build.reset_launches()
        y, info = kt.exponentiate(op, 0.1, x0, alg=alg, space=space)
        return {"y": host(y), "fused": eligible, "launches": dict(_build.launches),
                **_infos(info)}

    def expintegrator():
        prob = front_end_problem(np, P, "expintegrator")
        u = [sv(prob[k]) for k in ("x", "y", "z")]
        y, info = kt.expintegrator(ell(prob), 0.1, *u, ishermitian=True, tol=1e-10, krylovdim=20,
                                   space=space, **quiet)
        return {"y": host(y), **_infos(info)}

    def geneigsolve():
        prob = front_end_problem(np, P, "geneigsolve")
        vals, vecs, info = kt.geneigsolve((ell(prob), ell(prob, "coo_b")), sv(prob["x"]), 2, "SR",
                                          krylovdim=25, tol=1e-8, maxiter=200, space=space,
                                          **quiet)
        X = host(vecs, dim=1)
        # each vector's sign fixed by its largest entry (devices may pick either)
        X *= np.sign(X[np.arange(len(X)), np.abs(X).argmax(1)])[:, None]
        return {"vals": vals.cpu().numpy(), "vectors": X, **_infos(info)}

    def bieigsolve():
        prob = front_end_problem(np, P, "bieigsolve")
        vals, (V, W), (iv, _) = kt.bieigsolve(ell(prob), sv(prob["x"]), sv(prob["y"]), 3, "LM",
                                              krylovdim=24, tol=1e-10, maxiter=100, space=space,
                                              **quiet)
        return {"vals": vals.cpu().numpy(), **_infos(iv)}

    def block_lanczos():
        prob = front_end_problem(np, P, "block_lanczos")
        X0 = kt.Block([sv(b) for b in prob["block"]])
        vals, vecs, info = kt.eigsolve(ell(prob), X0, 3, "LM", tol=1e-10, krylovdim=30,
                                       maxiter=100, space=space, **quiet)
        return {"vals": vals.cpu().numpy(), **_infos(info)}

    def minres_tree():
        # a dict vector, each leaf sharded on its rows; the map is the
        # operator on each leaf plus a coupling of the two
        prob = front_end_problem(np, P, "minres_tree")
        A = ell(prob)

        def apply(v):
            return {"p": A.normal(v["p"]) + 0.5 * v["q"], "q": A.normal(v["q"]) + 0.5 * v["p"]}

        b = {"p": sv(prob["x"]), "q": sv(prob["y"])}
        x, info = kt.linsolve(apply, b, alg=kt.MINRES(tol=1e-10, maxiter=400, **quiet),
                              space=space)
        return {"p": host(x["p"]), "q": host(x["q"]), **_infos(info)}

    def iterator(name):
        prob = front_end_problem(np, P, name)
        A = ell(prob)
        x0 = sv(prob["x"])
        its = {
            "lanczos_iterator": lambda: kt.LanczosIterator(A, x0, krylovdim=12, space=space),
            "arnoldi_iterator": lambda: kt.ArnoldiIterator(A, x0, krylovdim=12, space=space),
            "gkl_iterator": lambda: kt.GKLIterator(A, x0, krylovdim=12, space=space),
            "block_lanczos_iterator": lambda: kt.BlockLanczosIterator(
                A, kt.Block([sv(b) for b in prob["block"][:2]]).stacked, krylovdim=24,
                space=space),
            "biarnoldi_iterator": lambda: kt.BiArnoldiIterator(A, x0, sv(prob["y"]),
                                                               krylovdim=12, space=space),
        }
        it = its[name]()
        st = it.initialize()
        for _ in range(FRONT_END_STEPS):
            st = it.expand(st)
        if name == "biarnoldi_iterator":
            return {"H": st[0].H.cpu().numpy(), "K": st[1].H.cpu().numpy(),
                    "beta": st[0].beta.cpu().numpy(), "beta_left": st[1].beta.cpu().numpy(),
                    "k": st[0].k}
        return {"H": kt.rayleighquotient(st).cpu().numpy(), "beta": kt.normres(st).cpu().numpy(),
                "k": int(st.k)}

    scenarios = {"minres": minres, "bicgstab": bicgstab, "exponentiate": exponentiate,
                 "exponentiate_fused": exponentiate_fused, "expintegrator": expintegrator,
                 "geneigsolve": geneigsolve, "bieigsolve": bieigsolve,
                 "block_lanczos": block_lanczos, "minres_tree": minres_tree,
                 **{name: (lambda name=name: iterator(name)) for name in FRONT_END_ITERATORS}}
    out = {}
    for name, fn in scenarios.items():
        if names is not None and name not in names:
            continue
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 - the same on every rank; reported per scenario
            out[name] = {"error": traceback.format_exc()}
    return out


# ---------------------------------------------------------------------------
# batched solves on a sharded space (a (batch, vec) mesh)
# ---------------------------------------------------------------------------

SHARDED_BATCHED_P = 4  # problems of every scenario, split over the batch axis
SHARDED_TREE_ITERS = 2  # phase 25's config-1 tree batch: maxiter, for the phase's time
SHARDED_BATCHED_N32 = 1 << 13  # float32 chains: (64, 128) vectors, 32 rows a rank
SHARDED_BATCHED_ARNOLDI_N = 1 << 11  # the flag's K5 takes (8, 128) blocks a rank
SHARDED_BATCHED_GRID = (32, 256)  # fused GMRES: 64 layout rows, whole grid rows a rank
SHARDED_BATCHED_RECT = (128, 64)  # GKL and LSMR: a rectangular sharded ELL operator
SHARDED_BATCHED_PENCIL_N = 64  # Golub-Ye, BiArnoldi and Block Lanczos
SHARDED_BATCHED_BLOCK = 2  # Block Lanczos: the block size
SHARDED_BATCHED_ALGS = {  # the algorithms of the GKL, LSMR and pencil scenarios (float64)
    "gkl": dict(krylovdim=12, maxiter=20, tol=1e-10),
    "lsmr": dict(krylovdim=5, maxiter=60, tol=1e-9),
    "golubye": dict(krylovdim=8, maxiter=40, tol=1e-10),
    "biarnoldi": dict(krylovdim=12, maxiter=100, tol=1e-10),
    "blocklanczos": dict(krylovdim=12, maxiter=40, tol=1e-10),
    # the eager and selective ones at fixed work (each round a dense step)
    "lanczos_selective": dict(krylovdim=20, maxiter=3, tol=1e-10, reorth="selective"),
    "lanczos_eager": dict(krylovdim=20, maxiter=3, tol=1e-10, eager=True),
    "schursolve_eager": dict(krylovdim=12, maxiter=3, tol=1e-8, eager=True),
    "gkl_eager": dict(krylovdim=12, maxiter=3, tol=1e-10, eager=True),
    "biarnoldi_eager": dict(krylovdim=12, maxiter=1, tol=1e-10, eager=True),
    "exponentiate_eager": dict(krylovdim=20, tol=1e-5, eager=True),
}
# the eager and selective scenarios' problems: those of their base scenarios
SHARDED_BATCHED_BASE = {"lanczos_selective": "lanczos_ell", "lanczos_eager": "lanczos_ell",
                        "schursolve_eager": "bicgstab", "gkl_eager": "gkl",
                        "biarnoldi_eager": "biarnoldi", "exponentiate_eager": "exponentiate_fused"}
SHARDED_BATCHED_KERNELS = ("fused_step", "fused_step_batched", "transform_partial",
                           "transform_partial_batched", "project", "project_batched",
                           "unproject", "unproject_batched")


def sharded_batched_problem(np, name):
    """The global data of scenario ``name`` of :func:`sharded_batched_cases`
    (the same on every rank and on the JAX side of a comparison): the
    ``(P, ...)`` start vectors or right-hand sides ``X``, and for the ELL
    scenarios the COO triplets ``coo`` of an ``n × n`` matrix.  An eager or
    selective scenario takes its base scenario's (:data:`SHARDED_BATCHED_BASE`)."""
    name = SHARDED_BATCHED_BASE.get(name, name)
    rng = np.random.default_rng(sum(map(ord, name)))
    P = SHARDED_BATCHED_P
    if name in ("lanczos_fused", "schursolve_fused", "exponentiate_fused"):
        n = SHARDED_BATCHED_N32
        return {"n": n, "X": rng.standard_normal((P, n // 128, 128)).astype(np.float32)}
    if name == "gmres_fused":
        gr, gc = SHARDED_BATCHED_GRID
        return {"n": gr * gc,
                "X": rng.standard_normal((P, gr * gc // 128, 128)).astype(np.float32)}
    if name in ("gmres", "cg"):
        n = 64 if name == "gmres" else 256
        return {"n": n, "X": rng.standard_normal((P, n))}
    if name in SHARDED_BATCHED_TREE:
        n = SHARDED_BATCHED_TREE_N
        return {"n": n, "X": rng.standard_normal((P, n)), "Y": rng.standard_normal((P, n))}
    if name == "arnoldi_flag":
        n = SHARDED_BATCHED_ARNOLDI_N
        i = np.arange(n)
        d = 1.0 + 4.0 * np.linspace(0.0, 1.0, n) ** 8  # well separated largest values
        coo = (np.concatenate([i, i[:-1]]), np.concatenate([i, i[:-1] + 1]),
               np.concatenate([d, np.full(n - 1, 0.02)]).astype(np.float32))
        return {"n": n, "coo": coo,
                "X": rng.standard_normal((P, n // 128, 128)).astype(np.float32)}
    if name in ("gkl", "lsmr"):
        m, n = SHARDED_BATCHED_RECT
        return {"n": n, "shape": (m, n), "coo": ("rect", m, n, 4, 3),
                "X": rng.standard_normal((P, m))}
    if name in ("golubye", "biarnoldi", "blocklanczos"):
        n = SHARDED_BATCHED_PENCIL_N
        out = {"n": n, "shape": (n, n), "coo": ("banded", n, 4, 11, True)}
        if name == "golubye":
            i = np.arange(n)
            out["coo_b"] = (i, i, 1.0 + rng.random(n))  # a diagonal SPD B
        if name == "biarnoldi":
            # random non-symmetric couplings on a graded diagonal: well
            # separated eigenvalues of largest modulus
            rows, cols, vals = tridiagonal_coo(np, n, *FRONT_END_TRI, np.float64)
            off = rows != cols
            vals[off] = 0.1 * rng.standard_normal(int(off.sum()))
            vals[~off] = 4 * np.linspace(0, 1, n) ** 8
            out["coo"] = (rows, cols, vals)
            out["Y"] = rng.standard_normal((P, n))
        shape = (P, SHARDED_BATCHED_BLOCK, n) if name == "blocklanczos" else (P, n)
        return {**out, "X": rng.standard_normal(shape)}
    n = FRONT_END_N
    if name == "bicgstab":
        coo = tridiagonal_coo(np, n, *FRONT_END_TRI, np.float64)
    else:
        coo = None  # the banded SPD matrix of parallel.banded_coo(n, 4, seed=11)
    return {"n": n, "coo": coo, "X": rng.standard_normal((P, n))}


def sharded_batched_coo(par, prob, key="coo"):
    """The COO triplets of ``prob[key]`` (:func:`sharded_batched_problem`):
    given, or made by ``par`` (this port's ``parallel`` module or the JAX
    package's: both make the same triplets) from ``("banded", n, halfband,
    seed, spd)`` or ``("rect", m, n, nnz_per_row, seed)``."""
    spec = prob[key]
    if isinstance(spec[0], str):
        kind, *args = spec
        if kind == "banded":
            return par.banded_coo(args[0], halfband=args[1], seed=args[2], spd=args[3])
        return par.rect_sparse_coo(args[0], args[1], nnz_per_row=args[2], seed=args[3])
    return spec


def sharded_batched_cases(torch, np, kt, dev="cpu", names=None, one_problem=True, small=False):
    """The batched drivers on a sharded space, on this rank (called on every
    rank of a group, ``run_ranks``): a ``(world/2, 2)`` mesh of ``make_mesh(
    batch=world // 2)``, :data:`SHARDED_BATCHED_P` problems split over its
    ``batch`` axis (each rank its batch row's problems, its block of their
    rows), every collective of a solve over the ``vec`` axis.  The
    scenarios: batched GMRES on ``sharded_laplacian_1d`` (the problem of
    ``__graft_entry__.py``'s multichip dry run, one right-hand side a
    problem), Lanczos fused on ``shard_local_stencil(laplacian_1d)``
    (float32) and unfused on the sharded ELL operator (float64), CG on
    ``sharded_laplacian_1d``, MINRES on the sharded ELL SPD matrix,
    BiCGStab on the sharded tridiagonal, ``schursolve`` fused on a
    non-symmetric chain, ``eigsolve_arnoldi`` unfused with the projection
    flag on (float32, the sharded bidiagonal), ``exponentiate`` fused and
    GMRES fused on the sharded grid stencil, the batched GKL, LSMR and
    pencil drivers (below), and the stack applies of the sharded operators
    against their one-vector applies.  Each solve runs at
    ``WARN`` and, with ``one_problem`` (true, or the names of the scenarios
    that take it), after it each of this rank's problems through its
    one-problem sharded solve: whether the results are the same bits, the
    WARN lines the same lines, the one-problem counts and collectives.  The
    GKL, LSMR and pencil scenarios (``gkl``, ``lsmr``: the sharded
    rectangular ELL operator; ``golubye`` with a sharded diagonal ``B``,
    ``biarnoldi`` on a non-symmetric tridiagonal, ``blocklanczos`` with
    blocks of :data:`SHARDED_BATCHED_BLOCK`; float64) take the algorithms
    of :data:`SHARDED_BATCHED_ALGS`; with ``small``, their first
    :data:`SMALL_SHARDED_BATCHED_P` problems only, at the caps of
    :data:`SMALL_SHARDED_BATCHED_CAPS`.  The eager and selective scenarios
    (:data:`SHARDED_BATCHED_EAGER`) run selective and eager Lanczos on the
    ELL operator of ``lanczos_ell``, eager ``schursolve`` on the sharded
    tridiagonal of ``bicgstab``, eager GKL and BiArnoldi on the problems of
    ``gkl`` and ``biarnoldi``, and an eager ``exponentiate`` (float32,
    unfused) on the chain of ``exponentiate_fused``.  Each returns
    global values (gathered over both axes), per-problem counts, and per
    batch row the kernel launches and the collectives of the batched solve,
    or ``{"error": traceback}``; ``names`` picks some."""
    import contextlib
    import io
    import traceback

    import torch.distributed as dist

    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.factorizations import krylov as kf
    from krylovkit_tpu_torch.ops import basis as bs
    from krylovkit_tpu_torch.ops import collectives as pc
    from krylovkit_tpu_torch.ops.vector import VectorSpace

    Pm = kt.parallel
    mesh = Pm.make_mesh(batch=max(dist.get_world_size() // 2, 1), device=dev)
    axv, axb = mesh.axis(Pm.VECTOR_AXIS), mesh.axis(Pm.BATCH_AXIS)
    space = VectorSpace(psum_axis=axv)
    f64 = torch.float64

    def sv(a):
        return Pm.shard_vector(torch.as_tensor(np.asarray(a)), mesh, batched=True)

    def full(t, vec_dim=None):
        """This rank's ``(P_b, ...)`` results as the global ``(P, ...)``."""
        if vec_dim is not None:
            t = gather(torch, axv, t.contiguous(), dim=vec_dim)
        return gather(torch, axb, t.contiguous(), dim=0).cpu().numpy()

    def per_row(values):
        """``values`` (ints) of this rank, one list per batch row."""
        t = torch.tensor([values], dtype=torch.int64, device=mesh.device)
        return gather(torch, axb, t).cpu().tolist()

    def counts(info):
        return {k: full(torch.as_tensor(getattr(info, k), device=mesh.device)).tolist()
                for k in ("numops", "numiter", "converged")}

    def quiet(fn):
        """``fn()`` and the lines it printed."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        return out, buf.getvalue().splitlines()

    def run(batched, one, X, pick):
        """The batched solve with the launches and the collectives set to 0
        just before it and read just after (per batch row), then each
        problem of ``X`` through ``one``; ``pick`` maps a solve's result to
        ``(tensors, info)``, the batched one's tensors ``(P_b, ...)``."""
        _build.reset_launches()
        pc.reset_stats()
        res, lines = quiet(batched)
        rows = per_row([_build.launches[k] for k in SHARDED_BATCHED_KERNELS]
                       + [pc.stats["collectives"]])
        launches = {k: [r[i] for r in rows] for i, k in enumerate(SHARDED_BATCHED_KERNELS)}
        tensors, info = pick(res)
        out = {**counts(info), "launches": {k: v for k, v in launches.items() if any(v)},
               "collectives": [r[-1] for r in rows]}
        if not checked:
            return res, out
        pc.reset_stats()
        ones, one_lines = quiet(lambda: [pick(one(x)) for x in X])
        one_coll = pc.stats["collectives"]
        same = all(torch.equal(t[p], o[0][i]) for p, o in enumerate(ones)
                   for i, t in enumerate(tensors))
        diff = [max(float((t[p] - o[0][i]).abs().max()) for i, t in enumerate(tensors))
                for p, o in enumerate(ones)]
        one_rows = per_row([int(same), one_coll] + [
            int(getattr(o[1], k)) for o in ones for k in ("numops", "numiter", "converged")])
        flat = [c for row in one_rows for c in row[2:]]
        return res, {
            **out,
            "one_problem_collectives": [r[1] for r in one_rows],
            "one_problem_counts": [flat[i:i + 3] for i in range(0, len(flat), 3)],
            "one_problem_bits": all(r[0] for r in one_rows),
            "one_problem_max_abs_diff": full(torch.tensor(diff, dtype=f64,
                                                          device=mesh.device)).tolist(),
            "warn_lines": [r[0] for r in per_row([len(lines)])],
            "warn_lines_equal": lines == one_lines,
        }

    def ell(prob, tile=None):
        n = prob["n"]
        coo = prob["coo"] or Pm.banded_coo(n, halfband=4, seed=11, spd=True)
        return Pm.sharded_ell_from_coo(*coo, (n, n), mesh, tile=tile)

    def fused_gate(op, X, m):
        return bool(kf.fused_available_batched(op, list(X), space, kmax=m + 1))

    def linear(name, op, batched, one, alg, a0, fused=False):
        B = sv(sharded_batched_problem(np, name)["X"])
        Z = torch.zeros_like(B)
        (X, _), rec = run(lambda: batched(op, B, Z, a0, 1.0, alg, space),
                          lambda b: one(op, b, torch.zeros_like(b), a0, 1.0, alg, space), B,
                          lambda r: ((r[0],), r[1]))
        out = {"X": full(X, 1), **rec}
        if fused:
            out["fused"] = fused_gate(op, B, alg.krylovdim)
        return out

    def gmres():
        from krylovkit_tpu_torch.solvers.gmres import linsolve_gmres

        op = Pm.sharded_laplacian_1d(sharded_batched_problem(np, "gmres")["n"], mesh)
        return linear("gmres", op, kt.linsolve_gmres_batched, linsolve_gmres,
                      kt.GMRES(krylovdim=16, maxiter=50, tol=1e-9), 1.0)

    def gmres_fused():
        from krylovkit_tpu_torch.solvers.gmres import linsolve_gmres

        op = Pm.shard_local_stencil(kt.poisson_2d(*SHARDED_BATCHED_GRID, device=dev), axv)
        return linear("gmres_fused", op, kt.linsolve_gmres_batched, linsolve_gmres,
                      kt.GMRES(krylovdim=16, maxiter=3, tol=1e-6), 0.5, fused=True)

    def linear_krylov(name):
        from krylovkit_tpu_torch.solvers import bicgstab, cg, minres

        prob = sharded_batched_problem(np, name)
        if name == "cg":
            return linear(name, Pm.sharded_laplacian_1d(prob["n"], mesh),
                          kt.linsolve_cg_batched, cg.linsolve_cg,
                          kt.CG(tol=1e-10, maxiter=3000), 0.5)
        if name == "minres":
            return linear(name, ell(prob), kt.linsolve_minres_batched, minres.linsolve_minres,
                          kt.MINRES(tol=1e-10, maxiter=3000), 0.0)
        return linear(name, ell(prob), kt.linsolve_bicgstab_batched,
                      bicgstab.linsolve_bicgstab, kt.BiCGStab(tol=1e-10, maxiter=3000), 1.0)

    def lanczos(name):
        prob = sharded_batched_problem(np, name)
        X = sv(prob["X"])
        if name == "lanczos_ell":
            op = ell(prob)
            alg = kt.Lanczos(krylovdim=20, maxiter=50, tol=1e-10)
        else:
            op = Pm.shard_local_stencil(kt.laplacian_1d(prob["n"], device=dev), axv)
            alg = kt.Lanczos(krylovdim=16, maxiter=3, tol=1e-6)
        (vals, vecs, _), rec = run(
            lambda: kt.eigsolve_lanczos_batched(op, X, 2, "LM", alg, space),
            lambda x: kt.eigsolve_lanczos(op, x, 2, "LM", alg, space=space), X,
            lambda r: ((r[0], r[1]), r[2]))
        out = {"vals": full(vals), **rec}
        if name == "lanczos_fused":
            # each problem's first eigenvector (compared by |<a, b>|)
            out.update(vecs=full(vecs[:, 0], 1), fused=fused_gate(op, X, alg.krylovdim))
        return out

    def arnoldi(name):
        from krylovkit_tpu_torch.solvers import arnoldi as arn

        prob = sharded_batched_problem(np, name)
        X = sv(prob["X"])
        if name == "schursolve_fused":
            op = Pm.shard_local_stencil(kt.StencilOperator((-1, 0, 1), FRONT_END_TRI), axv)
            alg = kt.Arnoldi(krylovdim=16, maxiter=3, tol=1e-6)
            (_, _, (re, im), _), rec = run(
                lambda: kt.schursolve_batched(op, X, 2, "LM", alg, space),
                lambda x: arn.schursolve(op, x, 2, "LM", alg, space), X,
                lambda r: ((r[2][0], r[2][1]), r[3]))
            # (re, im) of each value together: an unconverged pair's imaginary
            # part is compared on the scale of the values, not its own
            return {"vals": full(torch.stack([re, im], dim=1)),
                    "fused": fused_gate(op, X, alg.krylovdim), **rec}
        op = ell(prob, tile=128)
        alg = kt.Arnoldi(krylovdim=16, maxiter=20, tol=1e-5)
        old = bs.use_pallas_projections
        bs.use_pallas_projections = True
        try:
            (vals, _, _), rec = run(
                lambda: kt.eigsolve_arnoldi_batched(op, X, 2, "LM", alg, space),
                lambda x: arn.eigsolve_arnoldi(op, x, 2, "LM", alg, space), X,
                lambda r: ((r[0],), r[2]))
        finally:
            bs.use_pallas_projections = old
        return {"vals": full(torch.stack([vals.real, vals.imag], dim=1)), **rec}

    def exponentiate_fused():
        from krylovkit_tpu_torch.solvers.expintegrator import _expintegrator_core

        X = sv(sharded_batched_problem(np, "exponentiate_fused")["X"])
        op = Pm.shard_local_stencil(kt.StencilOperator(*FRONT_END_NEG_LAP), axv)
        alg = kt.Lanczos(krylovdim=20, tol=1e-5)
        (y, _), rec = run(lambda: kt.exponentiate_batched(op, 0.1, X, alg, space),
                          lambda x: _expintegrator_core(op, 0.1, (x,), alg, space), X,
                          lambda r: ((r[0],), r[1]))
        return {"y": full(y, 1), "fused": fused_gate(op, X, alg.krylovdim), **rec}

    def sparse(prob, key="coo"):
        return Pm.sharded_ell_from_coo(*sharded_batched_coo(Pm, prob, key), prob["shape"], mesh)

    def alg_kw(name):
        cut = SMALL_SHARDED_BATCHED_CAPS[name] if small else {}
        return {**SHARDED_BATCHED_ALGS[name], **cut}

    def problem(name):
        prob = sharded_batched_problem(np, name)
        if small:
            prob.update({k: prob[k][:SMALL_SHARDED_BATCHED_P] for k in ("X", "Y") if k in prob})
        return prob

    def gkl(name):
        from krylovkit_tpu_torch.solvers import lssolve as lss, svdsolve as svs

        prob = problem(name)
        op, X = sparse(prob), sv(prob["X"])
        if name == "gkl":
            alg = kt.GKL(**alg_kw(name))
            (vals, _, _, _), rec = run(
                lambda: kt.svdsolve_gkl_batched(op, X, 2, "LR", alg, space),
                lambda x: svs.svdsolve_gkl(op, x, 2, "LR", alg, space), X,
                lambda r: ((r[0], r[1], r[2]), r[3]))
            return {"vals": full(vals), **rec}
        alg = kt.LSMR(**alg_kw(name))
        (x, _), rec = run(lambda: kt.lssolve_lsmr_batched(op, X, alg, 0.0, space),
                          lambda b: lss.lssolve_lsmr(op, b, alg, 0.0, space), X,
                          lambda r: ((r[0],), r[1]))
        return {"X": full(x, 1), **rec}

    def pencil(name):
        from krylovkit_tpu_torch.solvers import biarnoldi as ba, blocklanczos as bl, golubye as gy

        prob = problem(name)
        op = sparse(prob)
        if name == "golubye":
            X, opB = sv(prob["X"]), sparse(prob, "coo_b")
            alg = kt.GolubYe(**alg_kw(name))
            (vals, _, _), rec = run(
                lambda: kt.geneigsolve_golubye_batched(op, opB, X, 2, "SR", alg, space),
                lambda x: gy.geneigsolve_golubye(op, opB, x, 2, "SR", alg, space), X,
                lambda r: ((r[0], r[1]), r[2]))
            return {"vals": full(vals), **rec}
        if name == "biarnoldi":
            V0, W0 = sv(prob["X"]), sv(prob["Y"])
            alg = kt.BiArnoldi(**alg_kw(name))
            (vals, _, _), rec = run(
                lambda: kt.bieigsolve_batched(op, V0, W0, 2, "LM", alg, space),
                lambda vw: ba.bieigsolve_driver(op, vw[0], vw[1], 2, "LM", alg, space),
                list(zip(V0, W0)), lambda r: ((r[0], r[1][0], r[1][1]), r[2][0]))
            return {"vals": full(torch.stack([vals.real, vals.imag], dim=1)), **rec}
        # each problem's (b, n) start block: its rows split over the vec axis
        X = torch.stack([sv(prob["X"][:, j]) for j in range(SHARDED_BATCHED_BLOCK)], dim=1)
        alg = kt.BlockLanczos(**alg_kw(name))
        (vals, _, _), rec = run(
            lambda: kt.eigsolve_blocklanczos_batched(op, X, 2, "LM", alg, space),
            lambda x: bl.eigsolve_blocklanczos(op, x, 2, "LM", alg, space), X,
            lambda r: ((r[0], r[1]), r[2]))
        return {"vals": full(vals), **rec}

    def eager_selective(name):
        from krylovkit_tpu_torch.solvers import arnoldi as arn, biarnoldi as ba
        from krylovkit_tpu_torch.solvers import svdsolve as svs
        from krylovkit_tpu_torch.solvers.expintegrator import _expintegrator_core

        prob = problem(name)
        kw = alg_kw(name)
        X = sv(prob["X"])
        if name in ("lanczos_selective", "lanczos_eager"):
            op, alg = ell(prob), kt.Lanczos(**kw)
            (vals, _, _), rec = run(
                lambda: kt.eigsolve_lanczos_batched(op, X, 2, "LM", alg, space),
                lambda x: kt.eigsolve_lanczos(op, x, 2, "LM", alg, space=space), X,
                lambda r: ((r[0], r[1]), r[2]))
            return {"vals": full(vals), **rec}
        if name == "schursolve_eager":
            op, alg = ell(prob), kt.Arnoldi(**kw)
            (_, _, (re, im), _), rec = run(
                lambda: kt.schursolve_batched(op, X, 2, "LM", alg, space),
                lambda x: arn.schursolve(op, x, 2, "LM", alg, space), X,
                lambda r: ((r[0], r[1], r[2][0], r[2][1]), r[3]))
            return {"vals": full(torch.stack([re, im], dim=1)), **rec}
        if name == "gkl_eager":
            op, alg = sparse(prob), kt.GKL(**kw)
            (vals, _, _, _), rec = run(
                lambda: kt.svdsolve_gkl_batched(op, X, 2, "LR", alg, space),
                lambda x: svs.svdsolve_gkl(op, x, 2, "LR", alg, space), X,
                lambda r: ((r[0], r[1], r[2]), r[3]))
            return {"vals": full(vals), **rec}
        if name == "biarnoldi_eager":
            op, alg, W0 = sparse(prob), kt.BiArnoldi(**kw), sv(prob["Y"])
            (vals, _, _), rec = run(
                lambda: kt.bieigsolve_batched(op, X, W0, 2, "LM", alg, space),
                lambda vw: ba.bieigsolve_driver(op, vw[0], vw[1], 2, "LM", alg, space),
                list(zip(X, W0)), lambda r: ((r[0], r[1][0], r[1][1]), r[2][0]))
            return {"vals": full(torch.stack([vals.real, vals.imag], dim=1)), **rec}
        op = Pm.shard_local_stencil(kt.StencilOperator(*FRONT_END_NEG_LAP), axv)
        alg = kt.Lanczos(**kw)
        (y, _), rec = run(lambda: kt.exponentiate_batched(op, 0.1, X, alg, space),
                          lambda x: _expintegrator_core(op, 0.1, (x,), alg, space), X,
                          lambda r: ((r[0],), r[1]))
        return {"y": full(y, 1), **rec}

    def tree(name):
        # a (p, q) tuple a problem through the coupled tree map
        from krylovkit_tpu_torch.ops.vector import tree_rows
        from krylovkit_tpu_torch.solvers import cg, gmres as gm

        prob = problem(name)
        lap = Pm.sharded_laplacian_1d(prob["n"], mesh)
        op = kt.as_operator(lambda v: (lap.normal(v[0]) + 0.5 * v[1],
                                       lap.normal(v[1]) + 0.5 * v[0]))
        X = (sv(prob["X"]), sv(prob["Y"]))
        kw = {**SHARDED_BATCHED_TREE_ALGS[name],
              **(SMALL_SHARDED_BATCHED_CAPS[name] if small else {})}
        if name == "tree_lanczos":
            alg = kt.Lanczos(**kw)
            (vals, vecs, _), rec = run(
                lambda: kt.eigsolve_lanczos_batched(op, X, 2, "SR", alg, space),
                lambda x: kt.eigsolve_lanczos(op, x, 2, "SR", alg, space=space), tree_rows(X),
                lambda r: ((r[0], *r[1]), r[2]))
            return {"vals": full(vals), **rec}
        batched, one, alg = ((kt.linsolve_cg_batched, cg.linsolve_cg, kt.CG(**kw))
                             if name == "tree_cg" else
                             (kt.linsolve_gmres_batched, gm.linsolve_gmres, kt.GMRES(**kw)))
        Z = (torch.zeros_like(X[0]), torch.zeros_like(X[1]))
        (x, _), rec = run(lambda: batched(op, X, Z, 1.0, 1.0, alg, space),
                          lambda b: one(op, b, (torch.zeros_like(b[0]), torch.zeros_like(b[1])),
                                        1.0, 1.0, alg, space), tree_rows(X),
                          lambda r: (tuple(r[0]), r[1]))
        return {"X": full(x[0], 1), "Y": full(x[1], 1), **rec}

    def stack_apply():
        # each sharded operator's stack apply against its one-vector apply,
        # row by row and bit for bit, and its collectives: one for all rows
        prob = sharded_batched_problem(np, "lanczos_ell")
        chain = sharded_batched_problem(np, "lanczos_fused")
        grid = sharded_batched_problem(np, "gmres_fused")
        cases = {
            "laplacian": (Pm.sharded_laplacian_1d(prob["n"], mesh), sv(prob["X"])),
            "ell": (ell(prob), sv(prob["X"])),
            "chain": (Pm.shard_local_stencil(kt.StencilOperator((-200, 0, 200),
                                                                (0.3, 1.0, -0.4)), axv),
                      sv(chain["X"])),
            "grid": (Pm.shard_local_stencil(kt.poisson_2d(*SHARDED_BATCHED_GRID, device=dev),
                                            axv), sv(grid["X"])),
        }
        out = {}
        for key, (op, X) in cases.items():
            for side in ("normal", "adjoint"):
                pc.reset_stats()
                Y = getattr(op, side + "_stack")(X)
                stack_coll = pc.stats["collectives"]
                rows = torch.stack([getattr(op, side)(x) for x in X])
                out[f"{key}_{side}_equal"] = bool(torch.equal(Y, rows))
                out[f"{key}_{side}_collectives"] = stack_coll
                out[f"{key}_{side}"] = full(Y, 1)
        return out

    scenarios = {
        "gmres": gmres, "lanczos_ell": lambda: lanczos("lanczos_ell"),
        "cg": lambda: linear_krylov("cg"), "minres": lambda: linear_krylov("minres"),
        "bicgstab": lambda: linear_krylov("bicgstab"),
        "arnoldi_flag": lambda: arnoldi("arnoldi_flag"), "stack_apply": stack_apply,
        "lanczos_fused": lambda: lanczos("lanczos_fused"),
        "schursolve_fused": lambda: arnoldi("schursolve_fused"),
        "exponentiate_fused": exponentiate_fused, "gmres_fused": gmres_fused,
        "gkl": lambda: gkl("gkl"), "lsmr": lambda: gkl("lsmr"),
        "golubye": lambda: pencil("golubye"), "biarnoldi": lambda: pencil("biarnoldi"),
        "blocklanczos": lambda: pencil("blocklanczos"),
        **{name: (lambda name=name: eager_selective(name)) for name in SHARDED_BATCHED_EAGER},
        **{name: (lambda name=name: tree(name)) for name in SHARDED_BATCHED_TREE},
    }
    out = {}
    for name, fn in scenarios.items():
        if names is not None and name not in names:
            continue
        # read by run(): whether this scenario's problems meet their
        # one-problem solves
        checked = one_problem if isinstance(one_problem, bool) else name in one_problem
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 - the same on every rank; reported per scenario
            out[name] = {"error": traceback.format_exc()}
    return out


# ---------------------------------------------------------------------------
# gradients of sharded solves (eleventh slice)
# ---------------------------------------------------------------------------

SHARDED_AD_N = 1 << 10  # eigsolve and svdsolve: (8, 128) vectors
SHARDED_AD_N_LIN = 1 << 12  # linsolve: (32, 128)
SHARDED_AD_TOL = 1e-12
SHARDED_AD_CHAIN = ((-1, 0, 1), (-1.3, 2.0, -0.7))  # config 4's chain: A != Aᵀ
SHARDED_AD_GRID = ((16, 256), ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
                   (4.0, -1.2, -0.8, -1.1, -0.9))  # two vector rows a grid row: h = 2
SHARDED_AD_EIG = ("eigsolve_gmres", "eigsolve_sylvester", "eigsolve_sylvester_values",
                  "eigsolve_general")
SHARDED_AD_SVD = ("svdsolve_gmres", "svdsolve_sylvester", "svdsolve_sylvester_values",
                  "svdsolve_derived", "svdsolve_derived_scaled", "svdsolve_derived_rank1")
SHARDED_AD_DOT = ("chain", "grid", "ell", "psum")
# batched scenarios: P problems of a one-problem scenario's data, problem 0
# that scenario itself (each problem's g scaled, SHARDED_AD_SCALES)
SHARDED_AD_BATCHED = ("batched_linsolve", "batched_eigsolve_gmres", "batched_eigsolve_sylvester",
                      "batched_eigsolve_sylvester_values", "batched_svdsolve_gmres")
# every scale keeps the third eigenvalue (singular value) of each scenario
# at least 2e-3 from the wanted two; at 0.9 it came within 1.9e-4 in
# eigsolve_sylvester, where the gradient's conditioning (tol / gap) is 5e-9
SHARDED_AD_SCALES = (1.0, 1.1, 1.2)


def sharded_ad_problem(np, name):
    """The global data of scenario ``name`` of :func:`sharded_ad_cases`,
    from a numpy seed: a sharded parameter ``g``, a sharded ``mask`` that a
    replicated scalar ``s`` scales, a start ``x0``, a right-hand side ``b``
    and the cotangent directions ``c`` and ``d``.  Stencil scenarios take
    ``(n/128, 128)`` vectors; the ELL ones flat vectors of
    :data:`FRONT_END_N`, with the banded matrix ``coo``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("ell"):
        n, shape = FRONT_END_N, (FRONT_END_N,)
    else:
        n = SHARDED_AD_N_LIN if name.startswith("linsolve") else SHARDED_AD_N
        shape = (n // 128, 128)
    out = {"n": n, "s": 0.2, "a0": 0.5, "a1": 1.0}
    out["g"] = 0.3 * rng.standard_normal(shape)
    out["mask"] = (rng.random(shape) < 0.3).astype(np.float64)
    for key in ("x0", "b", "c", "d"):
        out[key] = rng.standard_normal(shape)
    return out


def sharded_ad_batch(np, name):
    """The global data of batched scenario ``name`` of
    :func:`sharded_ad_cases`: its one-problem scenario's
    (:func:`sharded_ad_problem`) and ``P = len(SHARDED_AD_SCALES)``
    problems stacked on a leading axis, problem 0 the one-problem scenario
    itself: ``G[p] = scale_p·g``, and for the linsolve ``B[p] = b + p/2·d``
    (right-hand sides) and ``C[p] = c + p/2·g`` (the cotangents of
    ``x``)."""
    out = sharded_ad_problem(np, name[len("batched_"):])
    scales = np.asarray(SHARDED_AD_SCALES)
    half = (np.arange(len(scales)) / 2)[:, None, None]
    out["G"] = scales[:, None, None] * out["g"][None]
    out["B"] = out["b"][None] + half * out["d"][None]
    out["C"] = out["c"][None] + half * out["g"][None]
    return out


def sharded_ad_map(name, A, inner):
    """``(apply, adjoint)`` of the ``ParametricOperator`` of an eigsolve or
    svdsolve scenario on the sharded stencil ``A``, with parameters ``p =
    (g, s, mask, d)``: ``x ↦ A x + g⊙x + s·mask⊙x``; for
    ``svdsolve_derived_scaled`` ``x ↦ (1 + g)⊙(A x) + s·mask⊙x`` (the
    halo term of the derived adjoint depends on ``g``) and for
    ``svdsolve_derived_rank1`` ``x ↦ A x + g⊙x + s·⟨mask, x⟩·d`` (a psum
    inside the map, ``inner`` the space's).  ``adjoint`` is ``None`` for the
    ``_derived`` scenarios: it is derived across the ranks."""
    if name == "svdsolve_derived_scaled":
        def apply(p, x):
            return (1 + p[0]) * A.normal(x) + p[1] * p[2] * x
    elif name == "svdsolve_derived_rank1":
        def apply(p, x):
            return A.normal(x) + p[0] * x + p[1] * inner(p[2], x) * p[3]
    else:
        def apply(p, x):
            return A.normal(x) + p[0] * x + p[1] * p[2] * x

    def adjoint(p, y):
        return A.apply_adjoint(y) + p[0] * y + p[1] * p[2] * y

    return apply, (None if "_derived" in name else adjoint)


def sharded_ad_algs(kt, name):
    """``(alg, alg_rrule)`` of an eigsolve or svdsolve scenario."""
    kw = dict(tol=SHARDED_AD_TOL, krylovdim=30, maxiter=100, verbosity=kt.SILENT)
    primal = (kt.Arnoldi(**kw) if name == "eigsolve_general" else
              kt.GKL(**kw) if name.startswith("svdsolve") else kt.Lanczos(**kw))
    rrule = kt.Arnoldi(**kw) if "sylvester" in name or name == "eigsolve_general" else None
    return primal, rrule


def sharded_ad_cases(torch, np, kt, dev="cpu", names=None):
    """Gradients of sharded solves on this rank (called on every rank of a
    group, ``run_ranks``), float64: ``linsolve`` (GMRES on
    ``shard_local_stencil(laplacian_1d(2**12))``, cotangents of ``b``,
    ``a0``, ``a1``), ``eigsolve`` through the GMRES, Sylvester and general
    Sylvester rules and ``svdsolve`` through the GMRES and Sylvester rules
    (a ``ParametricOperator`` ``x ↦ A x + g⊙x + s·mask⊙x`` on a sharded
    stencil: ``g`` sharded, ``s`` replicated; the ``_values`` cases take a
    cotangent on the values only), ``svdsolve`` with an adjoint derived
    across the ranks, ``linsolve`` and ``eigsolve`` around a
    ``ShardedELLOperator`` (the eigsolve's adjoint derived), the adjoint
    identity ``Σ_ranks ⟨y, A x⟩ = Σ_ranks ⟨Aᴴ y, x⟩`` of derived adjoints
    (``dot_*``: the chain and grid stencils, the ELL operator and a map with
    a psum), and the error of a map that calls ``torch.distributed``
    itself.  Each returns global values: sharded gradients gathered, and
    the partials of a replicated input by rank (``s``, ``a0``, ``a1``), with
    the forward's counts and the backward's adjoint applies; ``names``
    picks some.  The ``batched_`` scenarios (:data:`SHARDED_AD_BATCHED`,
    :func:`sharded_ad_batch`) differentiate the batched drivers on the
    space: ``linsolve_gmres_batched`` on the shared sharded stencil with
    shared ``a0``, ``a1``, and ``eigsolve_lanczos_batched`` or
    ``svdsolve_gkl_batched`` on one ``ParametricOperator`` a problem (its
    row of ``G``, a shared ``s``); each returns the stacks gathered, counts
    and the backward's applies per problem."""
    import traceback

    import torch.distributed as dist

    from krylovkit_tpu_torch.ops.vector import VectorSpace
    from krylovkit_tpu_torch.solvers import batched as bt

    P = kt.parallel
    mesh = P.make_mesh(device=dev)
    ax = mesh.axis(P.VECTOR_AXIS)
    space = VectorSpace(psum_axis=ax)
    f64 = torch.float64

    def sv(a):
        return P.shard_vector(torch.as_tensor(np.asarray(a, dtype=np.float64)), mesh)

    def host(t):
        return gather(torch, ax, t.detach()).cpu().numpy()

    def svb(a):
        return P.shard_vector(torch.as_tensor(np.asarray(a, dtype=np.float64)), mesh,
                              batched=True)

    def host_b(t):
        return gather(torch, ax, t.detach(), dim=1).cpu().numpy()

    def by_rank(t):
        return gather(torch, ax, t.detach().reshape(1)).cpu().numpy()

    def scalar(v):
        return torch.tensor(v, dtype=f64, device=mesh.device, requires_grad=True)

    def gsum(t):
        return ax.psum(t.detach())

    counts = {"adjoint": 0}

    def counted(fn, key="adjoint"):
        def apply(*a):
            if a[-1].device.type != "meta":
                counts[key] = counts.get(key, 0) + 1
            return fn(*a)

        return apply

    def stencil_param(name, prob, chain):
        """The operator of :func:`sharded_ad_map` on ``A`` the sharded
        stencil, its adjoint counted, and its two differentiated
        parameters ``(g, s)``."""
        if chain:
            A = P.shard_local_stencil(kt.StencilOperator(*SHARDED_AD_CHAIN), ax)
        else:
            A = P.shard_local_stencil(kt.laplacian_1d(prob["n"], device=dev), ax)
        g, s = sv(prob["g"]).requires_grad_(True), scalar(prob["s"])
        apply, adjoint = sharded_ad_map(name, A, space.inner)
        op = kt.ParametricOperator(apply, (g, s, sv(prob["mask"]), sv(prob["d"])),
                                   adjoint and counted(adjoint))
        return (g, s), op

    def eig_case(name):
        prob = sharded_ad_problem(np, name)
        (g, s), op = stencil_param(name, prob, chain=False)
        alg, rrule = sharded_ad_algs(kt, name)
        vals, vecs, info = kt.eigsolve(op, sv(prob["x0"]), 2, "SR", alg=alg, alg_rrule=rrule,
                                       space=space)
        c = sv(prob["c"])
        cv = gsum((c[None] * vecs).sum((1, 2)))
        gv = 2 * cv[:, None, None] * c[None]
        if name.endswith("_values"):
            gv = torch.zeros_like(gv)
        counts["adjoint"] = 0
        torch.autograd.backward([vals, vecs], [torch.ones_like(vals), gv])
        return {"vals": vals.detach().cpu().numpy(), "g": host(g.grad), "s": by_rank(s.grad),
                "adjoint_applies": counts["adjoint"], **_infos(info)}

    def svd_case(name):
        prob = sharded_ad_problem(np, name)
        (g, s), op = stencil_param(name, prob, chain=True)
        alg, rrule = sharded_ad_algs(kt, name)
        vals, U, V, info = kt.svdsolve(op, sv(prob["x0"]), 2, "LR", alg=alg, alg_rrule=rrule,
                                       space=space)
        c, d = sv(prob["c"]), sv(prob["d"])
        cu, dv = gsum((c[None] * U).sum((1, 2))), gsum((d[None] * V).sum((1, 2)))
        gU, gV = dv[:, None, None] * c[None], cu[:, None, None] * d[None]
        if name.endswith("_values"):
            gU, gV = torch.zeros_like(gU), torch.zeros_like(gV)
        counts["adjoint"] = 0
        torch.autograd.backward([vals, U, V], [torch.ones_like(vals), gU, gV])
        out = {"vals": vals.detach().cpu().numpy(), "g": host(g.grad), "s": by_rank(s.grad),
               **_infos(info)}
        if "_derived" not in name:
            out["adjoint_applies"] = counts["adjoint"]
        return out

    def batched_infos(info):
        return {k: getattr(info, k).tolist() for k in ("numops", "numiter", "converged")}

    def batched_spectral(name):
        """One ``ParametricOperator`` a problem (:func:`sharded_ad_map` with
        its row of ``G``), the cotangents of :func:`eig_case` /
        :func:`svd_case` problem by problem."""
        prob = sharded_ad_batch(np, name)
        one = name[len("batched_"):]
        svd = one.startswith("svdsolve")
        if svd:
            A = P.shard_local_stencil(kt.StencilOperator(*SHARDED_AD_CHAIN), ax)
        else:
            A = P.shard_local_stencil(kt.laplacian_1d(prob["n"], device=dev), ax)
        G, s = svb(prob["G"]).requires_grad_(True), scalar(prob["s"])
        apply, adjoint = sharded_ad_map(one, A, space.inner)
        fixed = (sv(prob["mask"]), sv(prob["d"]))
        Pb = G.shape[0]
        ops = [kt.ParametricOperator(apply, (G[p], s) + fixed, counted(adjoint, p))
               for p in range(Pb)]
        alg, rrule = sharded_ad_algs(kt, one)
        c, x0 = sv(prob["c"]), sv(prob["x0"])
        if svd:
            vals, U, V, info = kt.svdsolve_gkl_batched(ops, x0, 2, "LR", alg, space,
                                                       in_dims=(0, None), alg_rrule=rrule)
            d = fixed[1]
            cu, dv = gsum((c * U).sum((2, 3))), gsum((d * V).sum((2, 3)))
            outs = [vals, U, V]
            cots = [dv[..., None, None] * c, cu[..., None, None] * d]
        else:
            vals, vecs, info = kt.eigsolve_lanczos_batched(ops, x0, 2, "SR", alg, space,
                                                           in_dims=(0, None), alg_rrule=rrule)
            cv = gsum((c * vecs).sum((2, 3)))
            outs, cots = [vals, vecs], [2 * cv[..., None, None] * c]
        if name.endswith("_values"):
            cots = [torch.zeros_like(t) for t in cots]
        for p in range(Pb):
            counts[p] = 0
        torch.autograd.backward(outs, [torch.ones_like(vals)] + cots)
        return {"vals": vals.detach().cpu().numpy(), "g": host_b(G.grad), "s": by_rank(s.grad),
                "adjoint_applies": [counts[p] for p in range(Pb)], **batched_infos(info)}

    def batched_linsolve():
        """``linsolve_gmres_batched`` on the shared sharded stencil (its
        stack applies), ``b`` batched, ``a0`` and ``a1`` shared; the
        backward's applies are the adjoint solve's, per problem."""
        prob = sharded_ad_batch(np, "batched_linsolve")
        A = P.shard_local_stencil(kt.laplacian_1d(prob["n"], device=dev), ax)
        B = svb(prob["B"]).requires_grad_(True)
        a0, a1 = scalar(prob["a0"]), scalar(prob["a1"])
        alg = kt.GMRES(tol=SHARDED_AD_TOL, krylovdim=30, maxiter=200, verbosity=kt.SILENT)
        X, info = kt.linsolve_gmres_batched(A, B, torch.zeros_like(B), a0, a1, alg, space)
        with ApplyRecorder(bt) as rec:
            torch.autograd.backward(X, svb(prob["C"]))
        return {"x": host_b(X), "b": host_b(B.grad), "a0": by_rank(a0.grad),
                "a1": by_rank(a1.grad),
                "adjoint_applies": [rec.per_problem.get(p, 0) for p in range(B.shape[0])],
                **batched_infos(info)}

    def linsolve_case():
        prob = sharded_ad_problem(np, "linsolve")
        A = P.shard_local_stencil(kt.laplacian_1d(prob["n"], device=dev), ax)
        op = kt.LinearOperator(A.normal, counted(A.apply_adjoint))
        b = sv(prob["b"]).requires_grad_(True)
        a0, a1 = scalar(prob["a0"]), scalar(prob["a1"])
        alg = kt.GMRES(tol=SHARDED_AD_TOL, krylovdim=30, maxiter=200, verbosity=kt.SILENT)
        x, info = kt.linsolve(op, b, None, a0, a1, alg=alg, space=space)
        counts["adjoint"] = 0
        torch.autograd.backward(x, sv(prob["c"]))
        return {"x": host(x), "b": host(b.grad), "a0": by_rank(a0.grad), "a1": by_rank(a1.grad),
                "adjoint_applies": counts["adjoint"], **_infos(info)}

    def ell(prob):
        return P.sharded_ell_from_coo(*P.banded_coo(prob["n"], halfband=4, seed=11, spd=True),
                                      (prob["n"], prob["n"]), mesh)

    def ell_linsolve():
        prob = sharded_ad_problem(np, "ell_linsolve")
        E = ell(prob)
        g, b = sv(prob["g"]).requires_grad_(True), sv(prob["b"]).requires_grad_(True)
        op = kt.ParametricOperator(lambda p, x: E.normal(x) + p * x, g,
                                   counted(lambda p, y: E.apply_adjoint(y) + p * y))
        alg = kt.GMRES(tol=SHARDED_AD_TOL, krylovdim=30, maxiter=200, verbosity=kt.SILENT)
        x, info = kt.linsolve(op, b, alg=alg, space=space)
        counts["adjoint"] = 0
        torch.autograd.backward(x, sv(prob["c"]))
        return {"x": host(x), "g": host(g.grad), "b": host(b.grad),
                "adjoint_applies": counts["adjoint"], **_infos(info)}

    def ell_eigsolve_derived():
        prob = sharded_ad_problem(np, "ell_eigsolve_derived")
        E = ell(prob)
        g = sv(prob["g"]).requires_grad_(True)
        op = kt.ParametricOperator(lambda p, x: E.normal(x) + p * x, g)
        alg = kt.Lanczos(tol=SHARDED_AD_TOL, krylovdim=30, maxiter=100, verbosity=kt.SILENT)
        vals, vecs, info = kt.eigsolve(op, sv(prob["x0"]), 2, "SR", alg=alg, space=space)
        vals.sum().backward()
        return {"vals": vals.detach().cpu().numpy(), "g": host(g.grad), **_infos(info)}

    def dot_case(kind):
        """``(⟨y, A x⟩, ⟨Aᴴ y, x⟩)`` summed over the ranks for the adjoint
        derived by ``with_adjoint_from`` (and by ``torch.func.vjp``), and
        the largest gap to the explicit adjoint."""
        prob = sharded_ad_problem(np, "ell_dot" if kind == "ell" else "dot_" + kind)
        x, y = sv(prob["x0"]), sv(prob["b"])
        explicit = None
        if kind == "chain":
            A = P.shard_local_stencil(kt.StencilOperator(*SHARDED_AD_CHAIN), ax)
            f, explicit = A.normal, A.apply_adjoint
        elif kind == "grid":
            A = P.shard_local_stencil(kt.GridStencilOperator(*SHARDED_AD_GRID), ax)
            f, explicit = A.normal, A.apply_adjoint
        elif kind == "ell":
            E = ell(prob)
            f, explicit = E.normal, E.apply_adjoint
        else:
            # a rank-one global term: x ↦ g⊙x + ⟨c, x⟩·d, its psum transposed
            g, c, d = sv(prob["g"]), sv(prob["c"]), sv(prob["d"])

            def f(v):
                return g * v + space.inner(c, v) * d

            def explicit(w):
                return g * w + space.inner(d, w) * c

        derived = kt.ParametricOperator(lambda p, v: p * f(v), scalar(1.0).detach()
                                        ).with_adjoint_from(x)
        ady = derived.apply_adjoint(y)
        _, vjp = torch.func.vjp(f, torch.zeros_like(x))
        func_ady = vjp(y)[0]
        out = {"yAx": float(space.inner(y, f(x))), "Ayx": float(space.inner(ady, x)),
               "func_gap": float(gsum((func_ady - ady).abs().max()))}
        out["explicit_gap"] = float(gsum((explicit(y) - ady).abs().max()))
        return out

    def psum_loss():
        # a replicated loss reduced through the space: each rank's cotangent
        # of the psum's output is summed over the ranks, so b̄ = D·c
        prob = sharded_ad_problem(np, "psum_loss")
        b = sv(prob["b"]).requires_grad_(True)
        space.inner(sv(prob["c"]), b).backward()
        return {"b": host(b.grad)}

    def collective_error():
        # a map that sums over the ranks with torch.distributed itself: its
        # derived adjoint has no transpose for that sum and must raise
        def f(v):
            t = v.sum().reshape(1)
            dist.all_reduce(t, group=ax.group)
            return v + t

        x = sv(sharded_ad_problem(np, "collective_error")["x0"])
        op = kt.LinearOperator(f).with_adjoint_from(x)
        try:
            op.apply_adjoint(x)
        except RuntimeError as e:
            return {"raised": "collective that has none" in str(e)}
        return {"raised": False}

    scenarios = {"linsolve": linsolve_case, "ell_linsolve": ell_linsolve,
                 "ell_eigsolve_derived": ell_eigsolve_derived,
                 "collective_error": collective_error, "psum_loss": psum_loss,
                 **{name: (lambda name=name: eig_case(name)) for name in SHARDED_AD_EIG},
                 **{name: (lambda name=name: svd_case(name)) for name in SHARDED_AD_SVD},
                 "batched_linsolve": batched_linsolve,
                 **{name: (lambda name=name: batched_spectral(name))
                    for name in SHARDED_AD_BATCHED[1:]},
                 **{"dot_" + k: (lambda k=k: dot_case(k)) for k in SHARDED_AD_DOT}}
    out = {}
    for name, fn in scenarios.items():
        if names is not None and name not in names:
            continue
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 - the same on every rank; reported per scenario
            out[name] = {"error": traceback.format_exc()}
    return out


def nccl_mesh1(torch, np, kt, dev="cuda", n=1 << 16):
    """One rank over NCCL (``make_mesh(1)``): the halo plan is
    communication-free and the sharded ELL apply equals ``sparse.from_coo``'s
    bit for bit on the same row- and column-sorted COO (both then sum a
    row's entries in one order)."""
    P = kt.parallel
    mesh = P.make_mesh(1, device=dev)
    rows, cols, vals = P.banded_coo(n, halfband=25, dtype=np.float32, seed=7, spd=True)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    op = P.sharded_ell_from_coo(rows, cols, vals, (n, n), mesh, with_adjoint=False)
    ref = kt.sparse.from_coo(rows, cols, vals, (n, n), with_adjoint=False, device=dev)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(n).astype(np.float32), device=dev)
    y, y_ref = op.normal(P.shard_vector(x, mesh)), ref.normal(x)
    return {"deltas": list(op.fwd_plan.deltas), "bit_equal": bool(torch.equal(y, y_ref)),
            "max_abs_diff": float((y - y_ref).abs().max()), "backend": torch.distributed.get_backend(),
            "comm": op.comm_summary()}


# (file, function) of the once-a-round work that keeps one all-reduce per
# problem in a batched solve
ROUND_COLLECTIVES = (("golubye.py", "_ritz"), ("golubye.py", "_restart"),
                     ("biarnoldi.py", "_round"))
MAP_COLLECTIVES = (("eigsolve.py", "block_op"), ("svdsolve.py", "block_op"),
                   ("_common.py", "split_normal"), ("_common.py", "split_apply_batched"))
ROUTE_COLLECTIVES = tuple((f, fn) for f, fns in (
    ("eigsolve.py", ("_gmres_inner", "_sylvester_inner", "_sylvester_general_inner", "finish")),
    ("svdsolve.py", ("_gmres_inner", "_sylvester_inner", "finish"))) for fn in fns)
# kinds named by a function on the all-reduce's stack, the first that
# matches (its name, or its (file, name)); else "inner_norm"
COLLECTIVE_KINDS = (
    ("round_per_problem", ROUND_COLLECTIVES),
    ("apply", ("_spmv", "_swap")),
    # a pullback's per-problem maps (the bordered systems, the Sylvester
    # operators: their inner products and projections) and its route's own
    # reductions (the cotangents' inner products and Gram matrices)
    ("map_per_problem", MAP_COLLECTIVES),
    ("route_per_problem", ROUTE_COLLECTIVES),
    ("gram", ("gram_batched", "gram")),
    ("block_qr", ("block_qr_batched", "block_qr")),
    ("sweep", ("_cgs_sweep_batched", "_cgs_sweep", "_mgs_sweep")),
    ("projection", ("project_batched", "project")),
)


def _collective_kind(sys_mod):
    """The kind of the all-reduce being started (:data:`COLLECTIVE_KINDS`,
    read off the Python stack); an apply of an adjoint (an ``apply_adjoint``
    or ``_Operators._apply(adjoint=True)`` frame) is ``adjoint_apply``."""
    seen, adjoint = set(), False
    f = sys_mod._getframe(2)
    while f is not None:
        code = f.f_code
        seen.add(code.co_name)
        seen.add((os.path.basename(code.co_filename), code.co_name))
        if code.co_name == "apply_adjoint" or (code.co_name == "_apply"
                                               and f.f_locals.get("adjoint") is True):
            adjoint = True
        f = f.f_back
    for kind, names in COLLECTIVE_KINDS:
        if seen.intersection(names):
            return "adjoint_apply" if kind == "apply" and adjoint else kind
    return "inner_norm"


class _KindPending:
    """An all-reduce in flight whose timed seconds (``collectives.stats``,
    taken at its wait) go to its kind in ``seconds``."""

    def __init__(self, pending, kind, kinds):
        self.pending, self.kind, self.kinds = pending, kind, kinds

    def wait(self):
        stats = self.kinds.pc.stats
        before = stats["seconds"]
        out = self.pending.wait()
        secs = self.kinds.seconds
        secs[self.kind] = secs.get(self.kind, 0.0) + stats["seconds"] - before
        return out


class CollectiveKinds:
    """Inside, every all-reduce of ``ops/collectives.py`` is also counted by
    kind (:func:`_collective_kind`) in ``counts``, and its seconds (with
    ``time_collectives`` on) summed by kind in ``seconds``; a walk up the
    Python stack per all-reduce, microseconds against its milliseconds."""

    def __init__(self):
        from krylovkit_tpu_torch.ops import collectives as pc

        self.pc, self.counts, self.seconds = pc, {}, {}

    def __enter__(self):
        real = self.real = self.pc._all_reduce_start

        def counted(t, group):
            kind = _collective_kind(sys)
            self.counts[kind] = self.counts.get(kind, 0) + 1
            return _KindPending(real(t, group), kind, self)

        self.pc._all_reduce_start = counted
        return self

    def __exit__(self, *exc):
        self.pc._all_reduce_start = self.real


def rank_solve(torch, ax, solve, warm=True):
    """``solve()`` on this rank once to warm up (library loads, the first
    launch of each kernel; skipped without ``warm``), then once more,
    timed, with the launch counts and the collective counters set to 0 just
    before it and read just after (``time_collectives`` on: each all-reduce
    is timed from its start to its wait, less the work it overlaps; each
    counted by kind, :class:`CollectiveKinds`); each rank's times are
    gathered to every rank.  Returns ``(result, record)``."""
    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.ops import collectives as pc

    dev = torch.device(f"cuda:{torch.cuda.current_device()}") if torch.cuda.is_available() \
        else torch.device("cpu")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if warm:
        solve()
    sync()
    _build.reset_launches()
    pc.reset_stats()
    pc.time_collectives = True
    try:
        with CollectiveKinds() as kinds:
            t0 = time.perf_counter()
            out = solve()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        pc.time_collectives = False
    launches = {k: v for k, v in _build.launches.items() if v}
    coll = dict(pc.stats)
    per_rank = gather(torch, ax, torch.tensor([[ms, coll["seconds"] * 1e3]],
                                              dtype=torch.float64, device=dev)).cpu().tolist()
    return out, {"launches_per_rank": launches, "collectives_per_solve": coll["collectives"],
                 "collectives_by_kind": dict(sorted(kinds.counts.items())),
                 "collective_bytes_per_solve": coll["bytes"],
                 "ms_per_solve_by_rank": [r[0] for r in per_rank],
                 "collective_ms_by_rank": [r[1] for r in per_rank]}


def sharded_fused_rank(torch, np, kt, dev="cuda", n1=1 << 21, nx=1024, batched_p=4, tree_p=2,
                       tree_maxiter=SHARDED_TREE_ITERS):
    """Phase ``sharded_fused`` on this rank: config 1 (the main path's
    Lanczos eigsolve) on ``shard_local_stencil(laplacian_1d(n1))``, the same
    for ``batched_p`` starts through ``eigsolve_lanczos_batched`` (batched K1
    with every problem's halos), phase 36's config-1 tree batch (``tree_p``
    starts, each block cut into two row leaves of a tuple, the tree map
    applying the sharded stencil one problem at a time; ``tree_maxiter``)
    beside each problem's one-problem sharded tree solve, and config 2's
    ``gmres30_poisson_2d`` on the sharded grid stencil, float32 ``(R/D,
    128)`` blocks of ``VectorSpace(psum_axis=...)``: K1 per rank with the
    neighbours' edge rows as external halos."""
    from krylovkit_tpu_torch.ops.vector import VectorSpace, tree_leaves, tree_row

    P = kt.parallel
    mesh = P.make_mesh(device=dev)
    ax = mesh.axis(P.VECTOR_AXIS)
    space = VectorSpace(psum_axis=ax)
    out = {}
    op = P.shard_local_stencil(kt.laplacian_1d(n1, device=dev), ax)
    x0 = P.shard_vector(torch.ones((n1 // 128, 128), dtype=torch.float32), mesh)
    alg = kt.Lanczos(krylovdim=KRYLOVDIM, maxiter=10, tol=1e-30, verbosity=kt.SILENT)
    (vals, vecs, info), rec = rank_solve(
        torch, ax, lambda: kt.eigsolve_lanczos(op, x0, 4, "LM", alg, space=space))
    norms = torch.sqrt(space.inner(vecs[0], vecs[0]))
    out["config1"] = {"vals": vals.cpu().numpy(), "vec0_norm": float(norms), **_infos(info),
                      "comm_per_step": "1 all-reduce of (raw | 2 x 2 x h x 128) floats", **rec}
    # config 1 for phase 30's first P starts in one host loop: a (P, R/D, 128)
    # stack of this rank's blocks, one batched K1 launch with every problem's
    # halos and one all-reduce a lock-step
    X = P.shard_vector(batched_starts(torch, np, n1 // 128, batched_p, "cpu"), mesh,
                       batched=True)
    (bvals, bvecs, binfo), brec = rank_solve(
        torch, ax, lambda: kt.eigsolve_lanczos_batched(op, X, 4, "LM", alg, space))
    out["config1_batched"] = {
        "vals": bvals.cpu().numpy(), "numops": binfo.numops.tolist(),
        "numiter": binfo.numiter.tolist(),
        "vec0_norms": [float(space.norm(v)) for v in bvecs[:, 0]],
        "comm_per_step": f"1 all-reduce of (raw | 2 x 2 x h x 128) floats for each of the "
                         f"{batched_p} problems", **brec}
    del X, bvecs
    # the tree batch: the space's reductions shared, the map's halo rounds a
    # problem's (collectives by kind beside each one-problem solve's)
    Rl = x0.shape[0]
    cut = _tree_of(torch, "tuple", Rl // 2)
    top = _tree_map_of(torch, kt, op.normal, cut, cut, torch.float32)
    Xs = P.shard_vector(batched_starts(torch, np, n1 // 128, tree_p, "cpu"), mesh, batched=True)
    Xt = (Xs[:, :Rl // 2], Xs[:, Rl // 2:])
    talg = kt.Lanczos(krylovdim=KRYLOVDIM, maxiter=tree_maxiter, tol=1e-30, verbosity=kt.SILENT)
    (tvals, tvecs, tinfo), trec = rank_solve(
        torch, ax, lambda: kt.eigsolve_lanczos_batched(top, Xt, 4, "LM", talg, space), warm=False)
    ones, bits = [], []
    for p in range(tree_p):
        (v1, w1, i1), rec1 = rank_solve(torch, ax, lambda p=p: kt.eigsolve_lanczos(
            top, tree_row(Xt, p), 4, "LM", talg, space=space), warm=False)
        ones.append({"counts": [i1.numops, i1.numiter, i1.converged], **rec1})
        bits.append(bool(torch.equal(tvals[p], v1)) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(tree_row(tvecs, p)), tree_leaves(w1))))
    out["config1_tree_batched"] = {
        "vals": tvals.cpu().numpy(), "numops": tinfo.numops.tolist(),
        "numiter": tinfo.numiter.tolist(), "converged": tinfo.converged.tolist(),
        "leaves": [list(l.shape) for l in tvecs], "one_problem": ones,
        "bit_identical": bits, **trec}
    del Xs, Xt, tvecs
    grid = P.shard_local_stencil(kt.poisson_2d(nx, nx, device=dev), ax)
    b = P.shard_vector(torch.ones((nx * nx // 128, 128), dtype=torch.float32), mesh)
    alg2 = kt.GMRES(krylovdim=30, tol=1e-4, maxiter=14, verbosity=kt.SILENT)
    (x, info2), rec2 = rank_solve(
        torch, ax, lambda: kt.linsolve(grid, b, a0=0.0, alg=alg2, space=space))
    res = float(space.norm(b - grid.normal(x)))
    out["gmres30_poisson_2d"] = {"true_residual": res, "normres": float(info2.normres),
                                 **_infos(info2), **rec2}
    return out


def config5_rank(torch, np, kt, dev="cuda", n=1 << 21, halfband=25, ls_m=1 << 21, ls_n=1 << 20,
                 ls_nnz_row=8, ls_iters=40, go=None):
    """Phase ``config5`` on this rank (BASELINE config 5, row-partitioned
    over the group): the banded SPD matrix of ``tools/bench_planner.py``
    (n = 2^21, halfband 25, 1.07e8 nnz, float32, ``tile=128``) through a
    Lanczos eigsolve with the projection kernels off and on, and LSMR on
    ``rect_sparse_coo(ls_m, ls_n, ls_nnz_row)`` (both halo plans) with a
    fixed count; every rank plans the whole COO and keeps its block.  With
    ``go`` (an event of the spawning process) the solves wait for it after
    the planning, so no other work of that process shares their time."""
    from krylovkit_tpu_torch.ops import basis as bs
    from krylovkit_tpu_torch.ops.vector import VectorSpace

    P = kt.parallel
    mesh = P.make_mesh(device=dev)
    ax = mesh.axis(P.VECTOR_AXIS)
    space = VectorSpace(psum_axis=ax)
    out = {}
    t0 = time.perf_counter()
    rows, cols, vals = P.banded_coo(n, halfband, dtype=np.float32, seed=7, spd=True)
    gen_s = time.perf_counter() - t0
    nnz = len(rows)
    op = P.sharded_ell_from_coo(rows, cols, vals, (n, n), mesh, tile=128, with_adjoint=False)
    del rows, cols, vals
    x0 = P.shard_vector(np.random.default_rng(8).standard_normal(n).astype(np.float32)
                        .reshape(-1, 128), mesh)
    t0 = time.perf_counter()
    rows, cols, vals = P.rect_sparse_coo(ls_m, ls_n, ls_nnz_row, dtype=np.float32, seed=9)
    ls_gen_s = time.perf_counter() - t0
    ls_nnz = len(rows)
    op2 = P.sharded_ell_from_coo(rows, cols, vals, (ls_m, ls_n), mesh, tile=128)
    del rows, cols, vals
    b = P.shard_vector(np.random.default_rng(10).standard_normal(ls_m).astype(np.float32)
                       .reshape(-1, 128), mesh)
    if go is not None:
        require(go.wait(SHARD_TIMEOUT_S * 5), "config5: the spawning process gave the go")
    alg = kt.Lanczos(krylovdim=KRYLOVDIM, maxiter=8, tol=1e-30, verbosity=kt.SILENT)
    for flag in (False, True):
        old = bs.use_pallas_projections
        bs.use_pallas_projections = flag
        try:
            (ev, _, info), rec = rank_solve(
                torch, ax, lambda: kt.eigsolve(op, x0, 4, "LM", alg=alg, space=space))
        finally:
            bs.use_pallas_projections = old
        out["eigsolve_proj" if flag else "eigsolve"] = {
            "vals": ev.cpu().numpy(), **_infos(info), "nnz": nnz, "generate_s": gen_s,
            "plan_s": op.plan_seconds, "comm": op.comm_summary(), **rec}
    del op, x0
    lalg = kt.LSMR(tol=1e-30, maxiter=ls_iters, verbosity=kt.SILENT)
    (x, info), rec = rank_solve(torch, ax, lambda: kt.lssolve(op2, b, alg=lalg, space=space))
    out["lssolve"] = {"x": gather(torch, ax, x).cpu().numpy().reshape(-1), **_infos(info),
                      "nnz": ls_nnz, "generate_s": ls_gen_s, "plan_s": op2.plan_seconds,
                      "comm": op2.comm_summary(), **rec}
    return out


def config5_reference(torch, np, kt, dev="cuda", n=1 << 21, halfband=25, ls_m=1 << 21,
                      ls_n=1 << 20, ls_nnz_row=8):
    """The one-rank operators of phase ``config5``: ``sparse.from_coo`` of
    the same matrices on ``dev``, applied to ``(R, 128)`` vectors (the
    layout of the sharded solves, so the restart and projection kernels see
    the same bases).  Returns ``(eig_op, ls_op, seconds)``."""
    from krylovkit_tpu_torch.ops.operator import TypedOperator

    t0 = time.perf_counter()
    rows, cols, vals = kt.parallel.banded_coo(n, halfband, dtype=np.float32, seed=7, spd=True)
    ell = kt.sparse.from_coo(rows, cols, vals, (n, n), with_adjoint=False, device=dev)
    del rows, cols, vals
    eig = TypedOperator(lambda x: ell.normal(x).reshape(x.shape), dtype=torch.float32)
    rows, cols, vals = kt.parallel.rect_sparse_coo(ls_m, ls_n, ls_nnz_row, dtype=np.float32,
                                                   seed=9)
    rect = kt.sparse.from_coo(rows, cols, vals, (ls_m, ls_n), device=dev)
    ls = TypedOperator(lambda x: rect.normal(x).reshape(-1, 128),
                       lambda y: rect.adjoint(y).reshape(-1, 128), dtype=torch.float32)
    return eig, ls, time.perf_counter() - t0


def _rel(np, a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _agree_on_counts(results, key):
    """The record of ``key`` from rank 0 after checking that every rank
    counted the same launches and collectives (the times may differ)."""
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        for field in ("launches_per_rank", "collectives_per_solve", "numops", "numiter"):
            require(res[key].get(field) == first.get(field),
                    f"{key}: rank {r} counted {field} as rank 0 did")
    return first


def _solve_line(metric, rec, nnz_per_apply, extra):
    """One metric line of a sharded solve: ``numops · nnz / t`` with ``t``
    the slowest rank's ms per solve."""
    ms = max(rec["ms_per_solve_by_rank"])
    return {"metric": metric, "value": rec["numops"] * nnz_per_apply / ms / 1e6,
            "unit": "Gnnz/s", "formula": "numops * nnz / t, t the slowest rank",
            "ms_per_solve": ms, "collective_ms_per_solve": max(rec["collective_ms_by_rank"]),
            "collectives_per_solve": rec["collectives_per_solve"],
            "ms_per_collective": max(rec["collective_ms_by_rank"]) / max(rec["collectives_per_solve"], 1),
            **{k: v for k, v in rec.items() if k not in ("vals", "x")}, **extra}


def distribution_phases(torch, np, kt, _build, fl, pb, smi, config1_vals, config2, world=2):
    """Phases 22-25 (module docstring).  ``config1_vals`` are phase main's
    values; ``config2`` is ``(grid, b, x)`` of phase config2's
    ``gmres30_poisson_2d``.  Returns the launches per rank of each path for
    the kernels line."""
    card = torch.cuda.get_device_name(0)
    # 22. small scenarios: card ranks against CPU ranks
    small = small_sharded(torch, np, world)

    # 23. one rank over NCCL
    t0 = time.perf_counter()
    m1 = same_on_every_rank(np, run_ranks(1, "nccl_mesh1", dev="cuda", backend="nccl", threads=2,
                                          timeout=300))
    emit({"phase": "nccl_mesh1", **m1, "seconds": time.perf_counter() - t0})
    require(m1["backend"] == "nccl" and m1["deltas"] == [], "nccl_mesh1: communication-free plan")
    require(m1["bit_equal"], f"nccl_mesh1: sharded apply equals from_coo's to 0 ulp ({m1})")

    # 24. config 5: the ranks plan while this process builds the one-rank
    # operators; the ranks solve once it is done; then the one-rank solves
    import torch.multiprocessing as tmp

    t0 = time.perf_counter()
    go = tmp.get_context("spawn").Event()
    handle = start_ranks(world, "config5_rank", dev="cuda", threads=3, timeout=900, go=go)
    try:
        eig_op, ls_op, ref_s = config5_reference(torch, np, kt)
    finally:
        go.set()
    c5 = collect_ranks(handle)
    n = 1 << 21
    x0 = torch.as_tensor(np.random.default_rng(8).standard_normal(n).astype(np.float32)
                         .reshape(-1, 128), device="cuda")
    alg = kt.Lanczos(krylovdim=KRYLOVDIM, maxiter=8, tol=1e-30, verbosity=kt.SILENT)
    from krylovkit_tpu_torch.ops import basis as bs

    c5_launches = {}
    for key, flag in (("eigsolve", False), ("eigsolve_proj", True)):
        rec = _agree_on_counts(c5, key)
        old = bs.use_pallas_projections
        bs.use_pallas_projections = flag
        try:
            (vals1, _, info1), l1, _, _, _, ms1 = drive_counted(
                torch, _build, fl, pb, lambda: kt.eigsolve(eig_op, x0, 4, "LM", alg=alg), reps=1)
        finally:
            bs.use_pallas_projections = old
        err = _rel(np, rec["vals"], vals1.cpu().numpy())
        emit(_solve_line(f"config5_{key}", rec, rec["nnz"], {
            "ranks": world, "vals": rec["vals"].tolist(), "one_rank": {
                "vals": vals1.cpu().tolist(), "numops": info1.numops, "numiter": info1.numiter,
                "launches": l1, "ms_per_solve": ms1}, "vals_rel_err": err, "tolerance": 1e-4,
            "device": card, "nvidia_smi": smi}))
        require((rec["numops"], rec["numiter"]) == (info1.numops, info1.numiter),
                f"config5 {key}: counts equal to the one-rank solve's")
        require(err <= 1e-4, f"config5 {key}: values within 1e-4 of the one-rank solve's ({err})")
        kernels = ("transform_partial", "project", "unproject") if flag else ("transform_partial",)
        for kname in kernels:
            require(rec["launches_per_rank"].get(kname, 0) == l1.get(kname, 0) > 0,
                    f"config5 {key}: {kname} launches per rank equal to the one-rank solve's")
        c5_launches[key] = rec["launches_per_rank"]
    rec = _agree_on_counts(c5, "lssolve")
    b = torch.as_tensor(np.random.default_rng(10).standard_normal(1 << 21).astype(np.float32)
                        .reshape(-1, 128), device="cuda")
    lalg = kt.LSMR(tol=1e-30, maxiter=40, verbosity=kt.SILENT)
    (x1, info1), l1, _, _, _, ms1 = drive_counted(
        torch, _build, fl, pb, lambda: kt.lssolve(ls_op, b, alg=lalg), reps=1)
    err = _rel(np, c5[0]["lssolve"]["x"], x1.cpu().numpy())
    emit(_solve_line("config5_lssolve", rec, rec["nnz"], {
        "ranks": world, "cut": "rect_sparse_coo(2^21, 2^20, 8 per row): ~1.9e7 of config 5's 1e8 nnz",
        "one_rank": {"numops": info1.numops, "numiter": info1.numiter, "ms_per_solve": ms1},
        "x_rel_err": err, "tolerance": 1e-4, "device": card, "nvidia_smi": smi}))
    require(rec["numops"] == info1.numops, "config5 lssolve: numops equal to the one-rank solve's")
    require(err <= 1e-4, f"config5 lssolve: x within 1e-4 of the one-rank solve's ({err})")
    c5_launches["lssolve"] = rec["launches_per_rank"]
    emit({"phase": "config5", "seconds": time.perf_counter() - t0,
          "one_rank_build_s": ref_s, "note": "one card: ranks share it; no scaling measured"})
    del eig_op, ls_op, x0, b

    # 25. the fused paths sharded: config 1 and config 2's gmres30_poisson_2d
    t0 = time.perf_counter()
    sf = run_ranks(world, "sharded_fused_rank", dev="cuda", threads=2, timeout=600)
    rec = _agree_on_counts(sf, "config1")
    err = _rel(np, rec["vals"], config1_vals.numpy())
    emit(_solve_line("sharded_config1_eigsolve", rec, 3 * (1 << 21), {
        "ranks": world, "vals": rec["vals"].tolist(), "vals_rel_err_vs_main": err,
        "tolerance": 1e-4, "device": card, "nvidia_smi": smi}))
    require(rec["numops"] == 138, f"sharded config 1: numops 138 (got {rec['numops']})")
    require(rec["launches_per_rank"] == {"fused_step": 128, "transform_partial": 11},
            f"sharded config 1: K1 128 and K2 11 per rank ({rec['launches_per_rank']})")
    require(err <= 1e-4, f"sharded config 1: values within 1e-4 of phase main's ({err})")
    require(abs(rec["vec0_norm"] - 1) < 1e-3, "sharded config 1: unit eigenvector")
    batched1 = sharded_batched_config1(torch, np, kt, fl, sf, rec, config1_vals, card, smi)
    tree1 = sharded_tree_config1(np, sf, card, smi)
    grid, b2, x2 = config2
    res1 = float(torch.linalg.vector_norm(b2 - grid.normal(x2)))
    rec2 = _agree_on_counts(sf, "gmres30_poisson_2d")
    res_err = abs(rec2["true_residual"] - res1) / res1
    emit(_solve_line("sharded_gmres30_poisson_2d", rec2, 5 * (1 << 20), {
        "ranks": world, "true_residual_one_rank": res1, "true_residual_rel_err": res_err,
        "tolerance": 1e-3, "device": card, "nvidia_smi": smi}))
    require(rec2["numops"] == 421, f"sharded gmres30_poisson_2d: numops 421 (got {rec2['numops']})")
    require(rec2["launches_per_rank"].get("fused_step") == 406,
            f"sharded gmres30_poisson_2d: K1 406 per rank ({rec2['launches_per_rank']})")
    require(res_err <= 1e-3, f"sharded gmres30_poisson_2d: true residual within 1e-3 ({res_err})")
    emit({"phase": "sharded_fused", "seconds": time.perf_counter() - t0})
    return {"small": small, "config5": c5_launches,
            "fused_config1": rec["launches_per_rank"], "fused_gmres": rec2["launches_per_rank"],
            "batched_config1": batched1, "tree_config1": tree1}


def sharded_tree_config1(np, sf, card, smi, dev="cuda"):
    """Phase 25's tree batch (``sharded_fused_rank``'s
    ``config1_tree_batched``): config 1 for 2 starts, each rank's block a
    tuple of two row leaves, through ``eigsolve_lanczos_batched`` on two
    gloo ranks of ``vec 2``.  Guards: every rank the same values; each
    problem bit-identical to its one-problem sharded tree solve on the same
    ranks, with its counts; the space's all-reduces, kind by kind, those of
    one problem's solve (they do not grow with ``P``; but each start's
    norm, one a problem before the lock-steps), the tree map's own
    (``apply``: its halo rounds) the sum of the problems'; batched K2 only
    (``transform_partial_batched`` as many as one problem's
    ``transform_partial``, one a leaf a rotation), no one-problem K2 and
    no K1 (on the card; ``dev="cpu"`` rehearses the rest).  Returns the
    launches per rank."""
    t0 = time.perf_counter()
    recs = [r["config1_tree_batched"] for r in sf]
    rec = recs[0]
    P = len(rec["numops"])
    require(all(np.array_equal(r["vals"], rec["vals"]) for r in recs),
            "sharded tree config 1: every rank the same values")
    ones = rec["one_problem"]
    counts = [list(c) for c in zip(rec["numops"], rec["numiter"], rec["converged"])]
    kinds, kinds1 = rec["collectives_by_kind"], [o["collectives_by_kind"] for o in ones]
    space = {k: v for k, v in kinds.items() if k != "apply"}
    launches, launches1 = rec["launches_per_rank"], [o["launches_per_rank"] for o in ones]
    emit({"phase": "sharded_tree_config1", "ranks": 2, "P": P, "leaves": rec["leaves"],
          "vals": rec["vals"].tolist(), "counts": counts,
          "one_problem_counts": [o["counts"] for o in ones],
          "bit_identical": [all(r["bit_identical"][p] for r in recs) for p in range(P)],
          "collectives_by_kind": kinds, "one_problem_collectives_by_kind": kinds1,
          "collectives_per_solve": rec["collectives_per_solve"],
          "one_problem_collectives": [o["collectives_per_solve"] for o in ones],
          "launches_per_rank": launches, "one_problem_launches_per_rank": launches1,
          "ms_by_rank": rec["ms_per_solve_by_rank"],
          "one_problem_ms_by_rank": [o["ms_per_solve_by_rank"] for o in ones],
          "collective_ms_by_rank": rec["collective_ms_by_rank"], "device": card,
          "nvidia_smi": smi, "seconds": time.perf_counter() - t0})
    require(all(all(r["bit_identical"]) for r in recs),
            "sharded tree config 1: each problem bit-identical to its one-problem sharded "
            "tree solve on every rank")
    require(counts == [o["counts"] for o in ones],
            f"sharded tree config 1: the one-problem counts ({counts})")
    # each start's norm is one all-reduce a problem (kf.initialize), before
    # the lock-steps
    starts = {"inner_norm": P - 1}
    require(all({k: v + starts.get(k, 0) for k, v in k1.items() if k != "apply"} == space
                for k1 in kinds1),
            f"sharded tree config 1: the space's all-reduces, kind by kind, one problem's "
            f"(and a norm a start) ({kinds} vs {kinds1})")
    require(kinds.get("apply", 0) == sum(k1.get("apply", 0) for k1 in kinds1) > 0,
            f"sharded tree config 1: the tree map's halo rounds a problem's ({kinds} vs "
            f"{kinds1})")
    k2 = launches1[0].get("transform_partial", 0)
    require(dev == "cpu" or all(l1 == launches1[0] for l1 in launches1)
            and launches == {"transform_partial_batched": k2} and k2 > 0,
            f"sharded tree config 1: batched K2 only, as many as one problem's K2 "
            f"({launches} vs {launches1})")
    return {"launches_sharded_tree_config1_per_rank": launches.get("transform_partial_batched",
                                                                    0)}


def sharded_batched_config1(torch, np, kt, fl, sf, rec1, config1_vals, card, smi, P=4):
    """Phase 25's batched part: config 1 for ``P`` starts (phase 30's first)
    through ``eigsolve_lanczos_batched`` on two gloo ranks of ``vec 2``,
    against the same batched solve on one rank of this process: every
    problem 138 / 10 and within 1e-4, problem 0 within 1e-4 of phase main;
    exactly 128 ``fused_step_batched`` launches with halos and 11
    ``transform_partial_batched`` per rank, no one-problem K1; the
    all-reduces of the solve beside ``P`` times those of the one-problem
    sharded solve (``rec1``, problem 0's start: every problem's schedule is
    138 / 10).  Then the batched K1 with halos at the rank's width against
    its plain version and one-problem launches, ms and bound.  Returns the
    kernel line's entries."""
    t0 = time.perf_counter()
    rec = _agree_on_counts(sf, "config1_batched")
    n = 1 << 21
    R = n // 128
    op = kt.laplacian_1d(n)
    X = batched_starts(torch, np, R, P, "cuda")
    alg = kt.Lanczos(krylovdim=KRYLOVDIM, maxiter=10, tol=1e-30, verbosity=kt.SILENT)
    vals1, _, info1 = kt.eigsolve_lanczos_batched(op, X, 4, "LM", alg)
    del X
    vals1 = vals1.cpu().numpy()
    err = max(_rel(np, rec["vals"][p], vals1[p]) for p in range(P))
    err_main = _rel(np, rec["vals"][0], config1_vals.numpy())
    # the metric counts every problem's applies: numops summed over the batch
    emit(_solve_line("sharded_config1_eigsolve_batched", dict(rec, numops=sum(rec["numops"])),
                     3 * n, {
        "ranks": 2, "P": P, "vals": rec["vals"].tolist(), "vals_rel_err_vs_one_rank": err,
        "vals_rel_err_vs_main_problem0": err_main, "tolerance": 1e-4,
        "numops_per_problem": rec["numops"], "numiter_per_problem": rec["numiter"],
        "one_rank_numops": info1.numops.tolist(),
        "collectives_one_problem_loop": P * rec1["collectives_per_solve"],
        "collectives_one_problem_loop_note": f"{P} x the one-problem sharded solve's "
                                             "(problem 0's start; every problem 138 / 10)",
        "device": card, "nvidia_smi": smi}))
    require(rec["numops"] == [138] * P and rec["numiter"] == [10] * P,
            f"sharded batched config 1: every problem 138 / 10 ({rec['numops']}, "
            f"{rec['numiter']})")
    require(rec["launches_per_rank"] == {"fused_step_batched": 128,
                                         "transform_partial_batched": 11},
            f"sharded batched config 1: 128 batched K1 with halos and 11 batched K2 per rank, "
            f"no one-problem K1 ({rec['launches_per_rank']})")
    require(err <= 1e-4, f"sharded batched config 1: values within 1e-4 of one rank's ({err})")
    require(err_main <= 1e-4, f"sharded batched config 1: problem 0 within 1e-4 of phase "
                              f"main's ({err_main})")
    require(all(abs(v - 1) < 1e-3 for v in rec["vec0_norms"]),
            "sharded batched config 1: unit eigenvectors")
    # the batched K1 with every problem's halos at a rank's width (R/2 rows)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    chain = kt.laplacian_1d(n)
    k1 = [check_batched_step(torch, fl, chain, P, R // 2, KRYLOVDIM + 1, B, True, gen, ext=True)
          for B in (4, 16, 29)]
    emit({"phase": "sharded_batched_kernel", "fused_step_batched_external_halos": k1,
          "nvidia_smi": smi, "seconds": time.perf_counter() - t0})
    return {"launches_sharded_batched_config1_per_rank": rec["launches_per_rank"].get(
                "fused_step_batched", 0),
            "ms_batched_external_halos": mean([c["ms"] for c in k1]),
            "bound_ms_batched_external_halos": mean([c["bound_ms"] for c in k1]),
            "plain_ms_batched_external_halos": mean([c["plain_ms"] for c in k1]),
            "one_problem_launches_ms_batched_external_halos": mean(
                [c["one_problem_launches_ms"] for c in k1]),
            "max_abs_err_batched_external_halos": max(c["max_abs_err"] for c in k1),
            "shapes_batched_external_halos": f"P = {P}, (31, {R // 2}, 128) f32 a problem, "
                                             "B = 4, 16, 29, with drift, h = 1"}


def slice9(sharded, name):
    """The launches per rank of ``name`` on the sharded paths of phases
    22, 24 and 25."""
    return {"launches_sharded_config1_per_rank": sharded["fused_config1"].get(name, 0),
            "launches_config5_eigsolve_per_rank": sharded["config5"]["eigsolve"].get(name, 0),
            "launches_config5_eigsolve_proj_per_rank":
                sharded["config5"]["eigsolve_proj"].get(name, 0),
            "launches_small_sharded_per_rank": sharded["small"].get(name, 0)}


# ---------------------------------------------------------------------------
# phases 26-28: the remaining front-ends on a sharded space, pytree drivers
# ---------------------------------------------------------------------------

FE_TOL = 1e-4  # sharded against one rank, float32 at full width
FE_RESIDUAL_TOL = 1e-3
# tol 1e-6 is absolute, below the float32 floor of |b| = 1448 (b = ones at
# n = 2^21): both linear solves run these iterations, fixed work, and end
# with true residuals far above that floor, which two roundings agree on
FE_MINRES_ITERS = 10
FE_BICGSTAB_ITERS = 5
FE_ITERATOR_STEPS = 30
FE_GENEIG_ITERS = 4  # fixed work (tol 1e-30), as Block Lanczos and bieig
FE_BLOCK_ITERS = 4  # cut from 8 for the script's time budget


def small_front_ends(torch, np, world=2):
    """Phase ``small_front_ends``: :func:`front_end_cases` on ``world``
    ranks of one gloo group with CUDA tensors and, at the same time, on
    ``world`` CPU ranks: card within 1e-12 of the CPU (float64; the fused
    ``exponentiate`` in float32 within 2e-4), counts equal, every rank the
    same bits, K1 launched on every card rank by the fused ``exponentiate``.
    Returns the launches per card rank over the scenarios."""
    t0 = time.perf_counter()
    on_card = start_ranks(world, "front_end_cases", dev="cuda", threads=2, timeout=600)
    on_cpu = start_ranks(world, "front_end_cases", dev="cpu", threads=2, timeout=600)
    try:
        card = same_on_every_rank(np, collect_ranks(on_card))
    finally:
        cpu = same_on_every_rank(np, collect_ranks(on_cpu))
    records = compare_sharded(np, card, cpu, phase="small_front_ends")
    fused = card["exponentiate_fused"]
    require(fused["fused"] and fused["launches"].get("fused_step", 0) > 0,
            f"small_front_ends: the fused exponentiate launched K1 on every card rank "
            f"({fused['launches']})")
    launches = {}
    for name in card:
        for key, count in card[name].get("launches", {}).items():
            launches[key] = launches.get(key, 0) + count
    emit({"phase": "small_front_ends", "ranks": world, "backend": "gloo", "scenarios": records,
          "tolerance": SMALL_SHARDED_TOL, "tolerance_float32": SMALL_SHARDED_TOL32,
          "k1_launches_per_rank_exponentiate": fused["launches"].get("fused_step", 0),
          "launches_per_rank": launches, "seconds": time.perf_counter() - t0})
    return launches


SMALL_SHARDED_AD = ("linsolve", "ell_linsolve", "eigsolve_sylvester_values", "dot_chain",
                    "dot_grid", "dot_ell", "collective_error")


def small_sharded_ad(torch, np, world=2, names=SMALL_SHARDED_AD):
    """:func:`sharded_ad_cases` (``names``) on ``world`` gloo ranks with
    CUDA tensors and, at the same time, on ``world`` CPU ranks: gradients
    within :data:`AD_TOL` of the CPU's (float64, relative to the largest
    entry), counts and the backward's applies equal, every rank the same
    bits; the ``dot_*`` adjoint identities hold on the card's ranks to
    1e-12.  Returns one record per compared scenario."""
    on_card = start_ranks(world, "sharded_ad_cases", dev="cuda", threads=2, timeout=600,
                          names=names)
    on_cpu = start_ranks(world, "sharded_ad_cases", dev="cpu", threads=2, timeout=600,
                         names=names)
    try:
        card = same_on_every_rank(np, collect_ranks(on_card))
    finally:
        cpu = same_on_every_rank(np, collect_ranks(on_cpu))
    if "collective_error" in card:
        # the guard against a dropped term fires with CUDA tensors too
        got, want = card.pop("collective_error"), cpu.pop("collective_error")
        require(got.get("raised") is True and want.get("raised") is True,
                f"small_sharded_ad collective_error: raised on the card and the CPU ({got}, "
                f"{want})")
    for name in [k for k in card if k.startswith("dot_")]:
        # the adjoint identity on the card's ranks (its gaps are rounding)
        got, want = card.pop(name), cpu.pop(name)
        require("error" not in got, f"small_sharded_ad {name}: ran ({got.get('error')})")
        scale = abs(got["yAx"])
        require(abs(got["yAx"] - got["Ayx"]) <= 1e-12 * scale
                and max(got["explicit_gap"], got["func_gap"]) <= 1e-12 * scale
                and abs(got["yAx"] - want["yAx"]) <= AD_TOL * scale,
                f"small_sharded_ad {name}: sum <y, A x> = sum <A^H y, x> on the card ({got})")
    return compare_sharded(np, card, cpu, phase="small_sharded_ad", tol64=AD_TOL)


SHARDED_AD_CYCLES = 2  # GMRES(30) cycles of the full-width linsolve (tol 1e-30: fixed work)
SHARDED_AD_A0 = 0.5  # config 2's shifted system
SHARDED_AD_PASSES = ("eig_gmres", "eig_sylvester_proj", "linsolve")
# the batched passes: P problems of the passes above, problem 0 theirs (the
# wells scaled, a second right-hand side)
SHARDED_AD_BATCHED_PASSES = ("eig_gmres_batched", "eig_sylvester_proj_batched",
                             "linsolve_batched")
SHARDED_AD_BATCH_SCALES = (1.0, 1.1)


def sharded_ad_width(torch, np, kt, L, N, space, put, dev, put_b):
    """The passes of phase ``sharded_ad`` on the operator ``L`` (config 2's
    ``N × N`` Poisson stencil, sharded or not) in ``space``; ``put`` gives
    this rank's block of a global ``(N²/128, 128)`` array on ``dev``.  Each
    pass is a forward and a backward, each timed with its launches and its
    collectives (all-reduces, their seconds): ``eig_gmres`` the four lowest
    bound states of ``L + diag(g)`` (the wells of ``ad_impurity``) and the
    gradient of their sum by the GMRES rule; ``eig_sylvester_proj`` the same
    with the projection kernels on and an Arnoldi ``alg_rrule`` (the
    Sylvester rule); ``linsolve`` fused GMRES(30) on ``(0.5 + L) x = 1``
    (:data:`SHARDED_AD_CYCLES` cycles) and the gradient of ``⟨c, x⟩`` with
    respect to ``b`` and ``a0``.  Then their batched twins
    (:data:`SHARDED_AD_BATCHED_PASSES`, ``put_b`` giving this rank's
    block of each problem's rows of a ``(P, N²/128, 128)`` stack): the two
    eigenvalue passes through ``eigsolve_lanczos_batched`` on one
    ``ParametricOperator`` a problem (the wells scaled by
    :data:`SHARDED_AD_BATCH_SCALES`), the linsolve through
    ``linsolve_gmres_batched`` on the shared stencil (``b_0 = 1``, ``b_1``
    seeded, the shared ``a0``), ``Σ_p ⟨c, x_p⟩``; each with whether
    problem 0 is its one-problem pass bit for bit.  Then the adjoint
    derived across the ranks (no ``adjoint_fn``) against the explicit one.
    Returns ``(results, records)``: this rank's blocks and partials, and
    per pass its ms, launches and collectives (by kind,
    :class:`CollectiveKinds`)."""
    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.ops import basis as bs
    from krylovkit_tpu_torch.ops import collectives as pc

    n = N * N
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    gn = np.zeros(n, np.float32)
    for site, depth in impurity_wells(N):
        gn[site] = depth
    g = put(gn.reshape(n // 128, 128)).requires_grad_(True)
    rng = np.random.default_rng(6)
    x0 = put(rng.standard_normal((n // 128, 128)).astype(np.float32))
    c = put(rng.standard_normal((n // 128, 128)).astype(np.float32))

    def apply(p, x):
        return L.normal(x) + p * x

    def adjoint(p, y):
        return L.apply_adjoint(y) + p * y

    kw = dict(ishermitian=True, krylovdim=30, maxiter=10, tol=1e-5, verbosity=kt.SILENT)

    def timed(fn):
        sync()
        _build.reset_launches()
        pc.reset_stats()
        pc.time_collectives = True
        try:
            with CollectiveKinds() as kinds:
                t0 = time.perf_counter()
                out = fn()
                sync()
                ms = (time.perf_counter() - t0) * 1e3
        finally:
            pc.time_collectives = False
        return out, {"ms": ms, "launches": {k: v for k, v in _build.launches.items() if v},
                     "collectives": pc.stats["collectives"],
                     "collectives_by_kind": dict(sorted(kinds.counts.items())),
                     "collective_ms_by_kind": {k: v * 1e3 for k, v in sorted(kinds.seconds.items())},
                     "collective_ms": pc.stats["seconds"] * 1e3}

    res, recs = {}, {}

    def eig_pass(name, alg_rrule=None, proj=False):
        g.grad = None
        old = bs.use_pallas_projections
        bs.use_pallas_projections = proj
        try:
            op = kt.ParametricOperator(apply, g, adjoint)
            (vals, vecs, info), fwd = timed(
                lambda: kt.eigsolve(op, x0, 4, "SR", alg_rrule=alg_rrule, space=space, **kw))
            _, bwd = timed(lambda: vals.sum().backward())
        finally:
            bs.use_pallas_projections = old
        res[name] = {"vals": vals.detach().cpu().double().numpy(),
                     "grad": g.grad.detach().cpu().double().numpy(),
                     "hellmann_feynman": (vecs.detach().double() ** 2).sum(0).cpu().numpy(),
                     "numops": int(info.numops), "numiter": int(info.numiter),
                     "converged": int(info.converged)}
        recs[name] = {"forward": fwd, "backward": bwd}

    # both rules once more untimed: libraries load (the Sylvester rule's
    # dense eigensolvers take most of a second on their first call), first
    # launches
    arnoldi = kt.Arnoldi(tol=1e-5, krylovdim=30, maxiter=10, verbosity=kt.SILENT)
    for alg_rrule in (None, arnoldi):
        op0 = kt.ParametricOperator(apply, g, adjoint)
        kt.eigsolve(op0, x0, 4, "SR", alg_rrule=alg_rrule, space=space, **kw)[0].sum().backward()
    eig_pass("eig_gmres")
    eig_pass("eig_sylvester_proj", arnoldi, proj=True)

    b = put(np.ones((n // 128, 128), np.float32)).requires_grad_(True)
    a0 = torch.tensor(SHARDED_AD_A0, dtype=torch.float32, device=dev, requires_grad=True)
    alg = kt.GMRES(krylovdim=30, maxiter=SHARDED_AD_CYCLES, tol=1e-30, verbosity=kt.SILENT)
    (x, info), fwd = timed(lambda: kt.linsolve(L, b, None, a0, 1.0, alg=alg, space=space))
    _, bwd = timed(lambda: torch.autograd.backward(x, c))
    res["linsolve"] = {"b_grad": b.grad.detach().cpu().double().numpy(),
                       "a0_grad": float(a0.grad), "numops": int(info.numops),
                       "numiter": int(info.numiter)}
    recs["linsolve"] = {"forward": fwd, "backward": bwd}

    # the batched twins: problem 0 the pass above
    t_b = time.perf_counter()
    Pb = len(SHARDED_AD_BATCH_SCALES)
    G = put_b(np.stack([sc * gn for sc in SHARDED_AD_BATCH_SCALES]).reshape(
        Pb, n // 128, 128)).requires_grad_(True)
    lz = kt.Lanczos(krylovdim=30, maxiter=10, tol=1e-5, verbosity=kt.SILENT)

    def counts_of(info):
        return {k: getattr(info, k).tolist() for k in ("numops", "numiter", "converged")}

    def p0_bits(name, one):
        got = res[name]
        return {"vals": bool(np.array_equal(got["vals"][0], res[one]["vals"])),
                "grad": bool(np.array_equal(got["grad"][0], res[one]["grad"])),
                "counts": all(got[k][0] == res[one][k] for k in ("numops", "numiter",
                                                                   "converged"))}

    def eig_batched(name, one, alg_rrule=None, proj=False):
        G.grad = None
        old = bs.use_pallas_projections
        bs.use_pallas_projections = proj
        try:
            ops = [kt.ParametricOperator(apply, G[p], adjoint) for p in range(Pb)]
            (vals, vecs, info), fwd = timed(lambda: kt.eigsolve_lanczos_batched(
                ops, x0, 4, "SR", lz, space, in_dims=(0, None), alg_rrule=alg_rrule))
            _, bwd = timed(lambda: vals.sum().backward())
        finally:
            bs.use_pallas_projections = old
        res[name] = {"vals": vals.detach().cpu().double().numpy(),
                     "grad": G.grad.detach().cpu().double().numpy(),
                     "hellmann_feynman": (vecs.detach().double() ** 2).sum(1).cpu().numpy(),
                     **counts_of(info)}
        res[name]["p0_bit_equal"] = p0_bits(name, one)
        recs[name] = {"forward": fwd, "backward": bwd}

    eig_batched("eig_gmres_batched", "eig_gmres")
    eig_batched("eig_sylvester_proj_batched", "eig_sylvester_proj", arnoldi, proj=True)

    B = put_b(np.stack([np.ones((n // 128, 128), np.float32),
                        np.random.default_rng(13).standard_normal((n // 128, 128)).astype(
                            np.float32)])[:Pb]).requires_grad_(True)
    a0b = torch.tensor(SHARDED_AD_A0, dtype=torch.float32, device=dev, requires_grad=True)
    (X, info), fwd = timed(lambda: kt.linsolve_gmres_batched(L, B, torch.zeros_like(B), a0b, 1.0,
                                                             alg, space))
    _, bwd = timed(lambda: torch.autograd.backward(X, c.expand_as(X)))
    res["linsolve_batched"] = {"b_grad": B.grad.detach().cpu().double().numpy(),
                               "a0_grad": float(a0b.grad), **counts_of(info)}
    res["linsolve_batched"]["p0_bit_equal"] = {
        "b_grad": bool(np.array_equal(res["linsolve_batched"]["b_grad"][0],
                                      res["linsolve"]["b_grad"])),
        "counts": all(res["linsolve_batched"][k][0] == res["linsolve"][k]
                      for k in ("numops", "numiter"))}
    recs["linsolve_batched"] = {"forward": fwd, "backward": bwd}
    recs["batched_seconds"] = time.perf_counter() - t_b

    # the adjoint derived across the ranks against the explicit one
    y = put(np.random.default_rng(12).standard_normal((n // 128, 128)).astype(np.float32))
    gd = g.detach()
    derived = kt.ParametricOperator(apply, gd).with_adjoint_from(x0)
    want, ms_explicit = timed(lambda: adjoint(gd, y))
    got, ms_derived = timed(lambda: derived.apply_adjoint(y))
    top = space.psum_axis.psum(want.abs().max().reshape(1)) if space.psum_axis else want.abs().max()
    gap = (got - want).abs().max()
    if space.psum_axis is not None:
        gap = space.psum_axis.psum(gap.reshape(1))
    res["derived_adjoint"] = {"rel_gap": float(gap.max() / top.max())}
    recs["derived_adjoint"] = {"explicit": ms_explicit, "derived": ms_derived}
    return res, recs


def sharded_ad_rank(torch, np, kt, dev="cuda", N=1024):
    """Phase ``sharded_ad`` on this rank: :func:`sharded_ad_width` on
    ``shard_local_stencil(poisson_2d(N, N))`` over the group, each rank
    holding ``N/D`` grid rows of float32 ``(N²/128/D, 128)`` blocks."""
    from krylovkit_tpu_torch.ops.vector import VectorSpace

    P = kt.parallel
    mesh = P.make_mesh(device=dev)
    ax = mesh.axis(P.VECTOR_AXIS)
    L = P.shard_local_stencil(kt.poisson_2d(N, N, device=dev), ax)
    res, recs = sharded_ad_width(torch, np, kt, L, N, VectorSpace(psum_axis=ax),
                                 lambda a: P.shard_vector(torch.as_tensor(a), mesh), dev,
                                 lambda a: P.shard_vector(torch.as_tensor(a), mesh, batched=True))
    return {"results": res, "records": recs, "rank": ax.index}


def sharded_ad(torch, np, kt, _build, smi, world=2, N=1024, dev="cuda"):
    """Phase ``sharded_ad``: :func:`sharded_ad_width` on one rank (the
    plain ``poisson_2d(N, N)``, first, alone on the card), then on ``world``
    gloo ranks sharing it (:func:`sharded_ad_rank`).  Guards: each rank's
    ``g.grad`` within 1e-3 (relative ∞-norm) of its block of ``Σᵢ vᵢ²``
    (Hellmann–Feynman), the blocks joined within 1e-3 of the one-rank
    gradient and the values within 1e-4 of its values, for both rules; the
    linsolve's ``b̄`` joined within 1e-4 of the one-rank ``b̄`` and ``ā0``
    summed over the ranks within 1e-4 of the one-rank ``ā0``; counts equal
    on every rank and to the one-rank solve's; on the card K1 per rank in
    the linsolve's forward equal to the one-rank forward's, K5 and K6 in
    the forward with the projection kernels on, as many as one rank
    launches; in the backward no K5/K6 on the tuple solves (the Sylvester
    rule's operator projects its vector leaf on the eigenvectors: K5 as
    many as one rank launches, no K6), no K1 outside the linsolve's
    forward; the derived adjoint within 1e-5 of the explicit one.  Returns
    the launches per rank of each pass."""
    t0 = time.perf_counter()
    card = dev != "cpu"
    L1 = kt.poisson_2d(N, N, device=dev)
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    one, one_recs = sharded_ad_width(torch, np, kt, L1, N, kt.VectorSpace(), put, dev, put)
    t_one = time.perf_counter() - t0
    ranks = run_ranks(world, "sharded_ad_rank", dev=dev, threads=2, timeout=600, N=N)
    ranks = sorted(ranks, key=lambda r: r["rank"])
    res = [r["results"] for r in ranks]

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))

    def slowest(key, side):
        return max(r["records"][key][side]["ms"] for r in ranks)

    lines = {}
    for key in SHARDED_AD_PASSES:
        got = [r[key] for r in res]
        counts = {k: v for k, v in got[0].items() if k in ("numops", "numiter", "converged")}
        require(all({k: g[k] for k in counts} == counts for g in got),
                f"sharded_ad {key}: counts equal on every rank ({[g.get('numops') for g in got]})")
        want_counts = {k: one[key][k] for k in counts}
        recs = [r["records"][key] for r in ranks]
        line = {"phase": "sharded_ad", "pass": key, "ranks": world, "N": N, **counts,
                "one_rank_counts": want_counts,
                "forward_ms_slowest_rank": slowest(key, "forward"),
                "backward_ms_slowest_rank": slowest(key, "backward"),
                "one_rank_forward_ms": one_recs[key]["forward"]["ms"],
                "one_rank_backward_ms": one_recs[key]["backward"]["ms"],
                "collectives_per_pass": {side: recs[0][side]["collectives"]
                                         for side in ("forward", "backward")},
                "collective_ms_by_rank": {side: [rc[side]["collective_ms"] for rc in recs]
                                          for side in ("forward", "backward")},
                "launches_per_rank": {side: recs[0][side]["launches"]
                                      for side in ("forward", "backward")},
                "one_rank_launches": {side: one_recs[key][side]["launches"]
                                      for side in ("forward", "backward")},
                "device": torch.cuda.get_device_name(0) if card else "cpu", "nvidia_smi": smi}
        if key == "linsolve":
            joined = np.concatenate([g["b_grad"] for g in got])
            a0_sum = sum(g["a0_grad"] for g in got)
            line.update(b_grad_rel_err=rel(joined, one[key]["b_grad"]),
                        a0_grad_by_rank=[g["a0_grad"] for g in got], a0_grad_sum=a0_sum,
                        a0_grad_one_rank=one[key]["a0_grad"],
                        a0_grad_rel_err=abs(a0_sum - one[key]["a0_grad"])
                        / abs(one[key]["a0_grad"]))
        else:
            joined = np.concatenate([g["grad"] for g in got])
            line.update(hellmann_feynman_rel_err_by_rank=[rel(g["grad"], g["hellmann_feynman"])
                                                          for g in got],
                        grad_rel_err_vs_one_rank=rel(joined, one[key]["grad"]),
                        vals=got[0]["vals"].tolist(),
                        vals_rel_err_vs_one_rank=rel(got[0]["vals"], one[key]["vals"]))
        emit(line)
        lines[key] = line
        require(counts == want_counts,
                f"sharded_ad {key}: counts equal to the one-rank solve's ({counts}, {want_counts})")
        fl_, bl_ = line["launches_per_rank"]["forward"], line["launches_per_rank"]["backward"]
        one_fl, one_bl = (line["one_rank_launches"][side] for side in ("forward", "backward"))
        proj = {"project", "unproject"}
        if key == "eig_sylvester_proj":
            # the Sylvester operator projects its vector leaf on the primal
            # eigenvectors (one K5 an apply); the tuple solve itself none
            require(not card or (bl_.get("project", 0) == one_bl.get("project", 0) > 0
                                 and "unproject" not in bl_),
                    f"sharded_ad {key}: K5 per rank in the backward = one rank's, no K6 "
                    f"({bl_}, {one_bl})")
        else:
            require(not proj & set(bl_), f"sharded_ad {key}: no K5/K6 in the backward ({bl_})")
        if key == "linsolve":
            require(line["b_grad_rel_err"] <= 1e-4,
                    f"sharded_ad linsolve: b.grad joined within 1e-4 of one rank's "
                    f"({line['b_grad_rel_err']})")
            require(line["a0_grad_rel_err"] <= 1e-4,
                    f"sharded_ad linsolve: a0.grad summed within 1e-4 of one rank's "
                    f"({line['a0_grad_rel_err']})")
            k1_one = line["one_rank_launches"]["forward"].get("fused_step", 0)
            require(not card or fl_.get("fused_step", 0) == k1_one > 0,
                    f"sharded_ad linsolve: K1 per rank in the forward = one rank's "
                    f"({fl_}, {k1_one})")
            require("fused_step" not in bl_, f"sharded_ad linsolve: no K1 in the backward ({bl_})")
        else:
            hf = max(line["hellmann_feynman_rel_err_by_rank"])
            require(hf <= 1e-3, f"sharded_ad {key}: g.grad within 1e-3 of each rank's block of "
                                f"sum v_i^2 ({hf})")
            require(line["grad_rel_err_vs_one_rank"] <= 1e-3,
                    f"sharded_ad {key}: blocks joined within 1e-3 of the one-rank gradient "
                    f"({line['grad_rel_err_vs_one_rank']})")
            require(line["vals_rel_err_vs_one_rank"] <= 1e-4,
                    f"sharded_ad {key}: values within 1e-4 of one rank's "
                    f"({line['vals_rel_err_vs_one_rank']})")
            require("fused_step" not in fl_ and "fused_step" not in bl_,
                    f"sharded_ad {key}: no K1 (the operator is not a stencil) ({fl_}, {bl_})")
            if key == "eig_sylvester_proj":
                require(not card or all(fl_.get(k, 0) == one_fl.get(k, 0) > 0 for k in proj),
                        f"sharded_ad {key}: K5/K6 per rank in the forward = one rank's "
                        f"({fl_}, {one_fl})")
            else:
                require(not proj & set(fl_), f"sharded_ad {key}: flag off, no K5/K6 ({fl_})")
    batched = sharded_ad_batched_lines(np, one, one_recs, ranks, lines, world, N, card, smi,
                                       torch.cuda.get_device_name(0) if card else "cpu")
    gaps = [r["derived_adjoint"]["rel_gap"] for r in res]
    dms = [r["records"]["derived_adjoint"] for r in ranks]
    emit({"phase": "sharded_ad", "pass": "derived_adjoint", "rel_gap": max(gaps),
          "derived_ms_by_rank": [d["derived"]["ms"] for d in dms],
          "explicit_ms_by_rank": [d["explicit"]["ms"] for d in dms],
          "collectives_derived": dms[0]["derived"]["collectives"],
          "collectives_explicit": dms[0]["explicit"]["collectives"],
          "one_rank_rel_gap": one["derived_adjoint"]["rel_gap"], "nvidia_smi": smi})
    require(max(gaps) <= 1e-5,
            f"sharded_ad: the derived adjoint within 1e-5 of the explicit one ({gaps})")
    emit({"phase": "sharded_ad", "seconds": time.perf_counter() - t0, "one_rank_seconds": t_one,
          "batched_seconds_by_rank": [r["records"]["batched_seconds"] for r in ranks],
          "batched_seconds_one_rank": one_recs["batched_seconds"]})
    return {key: lines[key]["launches_per_rank"] for key in SHARDED_AD_PASSES} | batched


def sharded_ad_batched_lines(np, one, one_recs, ranks, lines, world, N, card, smi, device):
    """Phase ``sharded_ad``'s batched passes (:data:`SHARDED_AD_BATCHED_PASSES`):
    one line each, and the guards.  Hellmann–Feynman per rank and per
    problem within 1e-3, each problem's blocks joined within 1e-3 of the
    one-rank batch's gradient and its values within 1e-4; the linsolve's
    ``b̄`` joined within 1e-4 of one rank's, ``ā0`` summed over the ranks
    within 1e-4; counts per problem equal on every rank and to the one-rank
    batch's; on the card, per rank, ``fused_step_batched`` in the
    linsolve's forward and ``project_batched``/``unproject_batched`` in
    the flag-on forward as many as one rank launches, and no one-problem
    K1, K5 or K6 in a batched forward.  Whether problem 0 is the
    one-problem pass's bits on each rank is printed, not guarded.  Returns
    the launches per rank of each pass."""
    res = [r["results"] for r in ranks]

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))

    def slowest(key, side):
        return max(r["records"][key][side]["ms"] for r in ranks)

    out = {}
    for key in SHARDED_AD_BATCHED_PASSES:
        single = key[:-len("_batched")]
        got = [r[key] for r in res]
        counts = {k: got[0][k] for k in ("numops", "numiter", "converged") if k in got[0]}
        require(all({k: g[k] for k in counts} == counts for g in got),
                f"sharded_ad {key}: counts equal on every rank ({[g['numops'] for g in got]})")
        recs = [r["records"][key] for r in ranks]
        line = {"phase": "sharded_ad", "pass": key, "ranks": world, "N": N,
                "problems": len(SHARDED_AD_BATCH_SCALES), **counts,
                "one_rank_counts": {k: one[key][k] for k in counts},
                "forward_ms_slowest_rank": slowest(key, "forward"),
                "backward_ms_slowest_rank": slowest(key, "backward"),
                "one_rank_forward_ms": one_recs[key]["forward"]["ms"],
                "one_rank_backward_ms": one_recs[key]["backward"]["ms"],
                "one_problem_forward_ms_slowest_rank": lines[single]["forward_ms_slowest_rank"],
                "one_problem_backward_ms_slowest_rank": lines[single]["backward_ms_slowest_rank"],
                "collectives_per_pass": {side: recs[0][side]["collectives"]
                                         for side in ("forward", "backward")},
                "collectives_by_kind": {side: recs[0][side]["collectives_by_kind"]
                                        for side in ("forward", "backward")},
                "collective_ms_by_kind_by_rank": {
                    side: [rc[side]["collective_ms_by_kind"] for rc in recs]
                    for side in ("forward", "backward")},
                "collective_ms_by_rank": {side: [rc[side]["collective_ms"] for rc in recs]
                                          for side in ("forward", "backward")},
                "launches_per_rank": {side: recs[0][side]["launches"]
                                      for side in ("forward", "backward")},
                "one_rank_launches": {side: one_recs[key][side]["launches"]
                                      for side in ("forward", "backward")},
                "p0_bit_equal_to_one_problem_by_rank": [g["p0_bit_equal"] for g in got],
                "device": device, "nvidia_smi": smi}
        if key == "linsolve_batched":
            joined = np.concatenate([g["b_grad"] for g in got], axis=1)
            a0_sum = sum(g["a0_grad"] for g in got)
            line.update(b_grad_rel_err=rel(joined, one[key]["b_grad"]),
                        a0_grad_by_rank=[g["a0_grad"] for g in got], a0_grad_sum=a0_sum,
                        a0_grad_one_rank=one[key]["a0_grad"],
                        a0_grad_rel_err=abs(a0_sum - one[key]["a0_grad"])
                        / abs(one[key]["a0_grad"]))
        else:
            joined = np.concatenate([g["grad"] for g in got], axis=1)
            line.update(hellmann_feynman_rel_err_by_rank=[
                            [rel(g["grad"][p], g["hellmann_feynman"][p])
                             for p in range(len(g["grad"]))] for g in got],
                        grad_rel_err_vs_one_rank=[rel(joined[p], one[key]["grad"][p])
                                                  for p in range(len(joined))],
                        vals=got[0]["vals"].tolist(),
                        vals_rel_err_vs_one_rank=rel(got[0]["vals"], one[key]["vals"]))
        emit(line)
        require(counts == line["one_rank_counts"],
                f"sharded_ad {key}: counts equal to the one-rank batch's ({counts}, "
                f"{line['one_rank_counts']})")
        fl_, one_fl = line["launches_per_rank"]["forward"], line["one_rank_launches"]["forward"]
        require(not {"fused_step", "project", "unproject"} & set(fl_),
                f"sharded_ad {key}: no one-problem K1, K5 or K6 in the batched forward ({fl_})")
        if key == "linsolve_batched":
            require(line["b_grad_rel_err"] <= 1e-4,
                    f"sharded_ad {key}: b.grad joined within 1e-4 of one rank's "
                    f"({line['b_grad_rel_err']})")
            require(line["a0_grad_rel_err"] <= 1e-4,
                    f"sharded_ad {key}: a0.grad summed within 1e-4 of one rank's "
                    f"({line['a0_grad_rel_err']})")
            k1 = one_fl.get("fused_step_batched", 0)
            require(not card or fl_.get("fused_step_batched", 0) == k1 > 0,
                    f"sharded_ad {key}: fused_step_batched per rank in the forward = one "
                    f"rank's ({fl_}, {one_fl})")
        else:
            hf = max(max(h) for h in line["hellmann_feynman_rel_err_by_rank"])
            require(hf <= 1e-3, f"sharded_ad {key}: G.grad within 1e-3 of each rank's block of "
                                f"sum v_i^2, each problem ({hf})")
            require(max(line["grad_rel_err_vs_one_rank"]) <= 1e-3,
                    f"sharded_ad {key}: each problem's blocks joined within 1e-3 of the "
                    f"one-rank gradient ({line['grad_rel_err_vs_one_rank']})")
            require(line["vals_rel_err_vs_one_rank"] <= 1e-4,
                    f"sharded_ad {key}: values within 1e-4 of one rank's "
                    f"({line['vals_rel_err_vs_one_rank']})")
            proj = ("project_batched", "unproject_batched")
            if key == "eig_sylvester_proj_batched":
                require(not card or all(fl_.get(k, 0) == one_fl.get(k, 0) > 0 for k in proj),
                        f"sharded_ad {key}: batched K5/K6 per rank in the forward = one rank's "
                        f"({fl_}, {one_fl})")
            else:
                require(not set(proj) & set(fl_), f"sharded_ad {key}: flag off, no K5/K6 "
                                                  f"({fl_})")
        out[key] = line["launches_per_rank"]
    return out


def front_ends_data(np, n, n4):
    """The start data of phase ``sharded_front_ends``: the same on every
    rank and in the one-rank solves."""
    rng = np.random.default_rng(11)
    R, R4 = n // 128, n4 // 128
    return {
        "block": rng.standard_normal((4, R, 128)).astype(np.float32),
        "x0": np.random.default_rng(8).standard_normal((R, 128)).astype(np.float32),
        "b": np.ones((R, 128), np.float32),
        "v0": np.random.default_rng(1).standard_normal((R4, 128)).astype(np.float32),
        "w0": np.random.default_rng(10).standard_normal((R4, 128)).astype(np.float32),
    }


# the four smallest values of phase sharded_front_ends' pencil, about
FE_PENCIL_TARGETS = (1.0, 1.05, 1.1, 1.15)


def front_ends_pencil_b(np, rows, cols, vals, n):
    """The diagonal of phase ``sharded_front_ends``' ``B`` for config 5's
    ``A`` (its COO): ``(1 + U(0, 1)) / 128``, but ``A_ii / t_i`` on four rows
    spread over the ranks, ``t`` = :data:`FE_PENCIL_TARGETS`.  The pencil's
    four smallest values are then about ``t`` and every other lies above
    64 (``λ_min(A) >= 1`` by diagonal dominance); at the shift ``ρ ≈ 1``
    the four are the lowest eigenvalues of ``A − ρB`` (below 0.6, the rest
    above 0.98), so the Ritz values of a fixed count of Golub-Ye cycles
    settle on them, the same to ~1e-6 however a reduction rounds.  (With
    ``B`` random everywhere the smallest of 2^21 values crowd and the Ritz
    values beyond the first move with every rounding; where the solve may
    converge, float32 roundings converge cycles apart.)"""
    on = rows == cols
    dA = np.zeros(n)
    dA[rows[on]] = vals[on]
    dB = (1.0 + np.random.default_rng(12).random(n)) / 128
    heavy = np.arange(1, 8, 2) * (n // 8)
    dB[heavy] = dA[heavy] / np.asarray(FE_PENCIL_TARGETS)
    return dB.astype(np.float32)


def front_ends_solves(kt, A, B, tri, chain, vecs, space, host):
    """The solves of phase ``sharded_front_ends`` by name, each a function
    of no argument returning the values the ranks and the one-rank solve are
    compared on: Block Lanczos, MINRES, BiCGStab, ``geneigsolve`` and a
    ``LanczosIterator`` on config 5's operator ``A`` (``B`` diagonal SPD),
    ``bieigsolve`` on config 4's tridiagonal ``tri`` and the fused
    ``exponentiate`` of config 4's chain ``chain``.  ``vecs`` holds the
    start vectors (this rank's blocks on a sharded ``space``); ``host``
    brings a vector to one global numpy array."""
    from krylovkit_tpu_torch.ops.vector import add

    quiet = {"verbosity": kt.SILENT}

    def eig(vals, info):
        return {"vals": vals.cpu().numpy(), **_infos(info)}

    def block():
        vals, _, info = kt.eigsolve(A, kt.Block(vecs["block"]), 4, "LM", krylovdim=30,
                                    maxiter=FE_BLOCK_ITERS, tol=1e-30, space=space, **quiet)
        return eig(vals, info)

    def linear(alg):
        def solve():
            x, info = kt.linsolve(A, vecs["b"], alg=alg, space=space)
            res = float(space.norm(add(vecs["b"], A.normal(x), a=-1)))
            return {"x": host(x), "true_residual": res, "b_norm": float(space.norm(vecs["b"])),
                    "maxiter": alg.maxiter, **_infos(info)}
        return solve

    def geneig():
        vals, _, info = kt.geneigsolve((A, B), vecs["x0"], 4, "SR", krylovdim=30,
                                       maxiter=FE_GENEIG_ITERS, tol=1e-30, space=space, **quiet)
        return eig(vals, info)

    def iterator():
        it = kt.LanczosIterator(A, vecs["x0"], krylovdim=FE_ITERATOR_STEPS, space=space)
        st = it.initialize()
        for _ in range(FE_ITERATOR_STEPS):
            st = it.expand(st)
        return {"H": st.H.cpu().numpy(), "beta": st.beta.cpu().numpy(), "k": st.k,
                "numops": FE_ITERATOR_STEPS}

    def bieig():
        vals, _, (info, _) = kt.bieigsolve(tri, vecs["v0"], vecs["w0"], 4, "LM", krylovdim=30,
                                           maxiter=BIEIG_ITERS, tol=1e-30, space=space, **quiet)
        return eig(vals, info)

    def expo():
        y, info = kt.exponentiate(chain, 0.1, vecs["v0"], krylovdim=30, tol=1e-4,
                                  ishermitian=True, space=space, **quiet)
        return {"y": host(y), **_infos(info)}

    return {"block_lanczos": block,
            "minres": linear(kt.MINRES(tol=1e-6, maxiter=FE_MINRES_ITERS, **quiet)),
            "bicgstab": linear(kt.BiCGStab(tol=1e-6, maxiter=FE_BICGSTAB_ITERS, **quiet)),
            "geneigsolve": geneig, "lanczos_iterator": iterator, "bieigsolve": bieig,
            "exponentiate_fused": expo}


FE_BATCH_P = 2  # problems of each batched solve of phase sharded_front_ends
# the caps (iterations, tol 1e-30) of its batched solves: Block Lanczos at
# the phase's own (problem 0 is then the phase's solve); the others cut to
# keep the batched half near 10 s (at the phase's four rounds a batched
# Golub-Ye took 3.3 s and BiArnoldi 7.3 s on an NVIDIA H100 80GB HBM3,
# 700.00 W)
FE_BATCHED_ITERS = {"block_lanczos": FE_BLOCK_ITERS, "geneigsolve": 1, "bieigsolve": 1,
                    "svdsolve": 1, "lssolve": 20}


def front_ends_batched_solves(torch, np, kt, A, B, tri, vecs, sv, space, n, n4, warm=False):
    """The batched half of phase ``sharded_front_ends`` by name: ``(batched,
    one, pick)``, the batched solve of :data:`FE_BATCH_P` problems, the
    one-problem sharded solve of problem 0 (``one()``) and ``pick``, which
    maps either result to ``(tensors, info)``.  Problem 0 starts from the
    phase's own start (``vecs``), problem 1 from starts of other seeds
    (``sv`` shards a global array); the settings are the phase's (GKL and
    LSMR on config 4's tridiagonal ``tri``), every solve to its cap of
    :data:`FE_BATCHED_ITERS` (tol 1e-30); with ``warm``, every cap one
    iteration."""
    from krylovkit_tpu_torch.solvers import biarnoldi as ba, blocklanczos as bl
    from krylovkit_tpu_torch.solvers import golubye as gy, lssolve as lss, svdsolve as svs

    R, R4 = n // 128, n4 // 128
    other = {"block": np.random.default_rng(21).standard_normal((4, R, 128)).astype(np.float32),
             "x0": np.random.default_rng(18).standard_normal((R, 128)).astype(np.float32),
             "v0": np.random.default_rng(19).standard_normal((R4, 128)).astype(np.float32),
             "w0": np.random.default_rng(20).standard_normal((R4, 128)).astype(np.float32)}
    X = {"block": torch.stack([torch.stack(vecs["block"]),
                               torch.stack([sv(b) for b in other["block"]])])}
    for k in ("x0", "v0", "w0"):
        X[k] = torch.stack([vecs[k], sv(other[k])])

    def cap(name):
        return {"maxiter": 1 if warm else FE_BATCHED_ITERS[name], "tol": 1e-30,
                "verbosity": kt.SILENT}

    block = kt.BlockLanczos(krylovdim=30, **cap("block_lanczos"))
    gen = kt.GolubYe(krylovdim=30, **cap("geneigsolve"))
    bi = kt.BiArnoldi(krylovdim=30, **cap("bieigsolve"))
    gkl = kt.GKL(krylovdim=30, **cap("svdsolve"))
    lsmr = kt.LSMR(**cap("lssolve"))

    def eig(r):
        return (r[0], r[1]), r[2]

    return {
        "block_lanczos": (
            lambda: kt.eigsolve_blocklanczos_batched(A, X["block"], 4, "LM", block, space),
            lambda: bl.eigsolve_blocklanczos(A, X["block"][0], 4, "LM", block, space), eig),
        "geneigsolve": (
            lambda: kt.geneigsolve_golubye_batched(A, B, X["x0"], 4, "SR", gen, space),
            lambda: gy.geneigsolve_golubye(A, B, X["x0"][0], 4, "SR", gen, space), eig),
        "bieigsolve": (
            lambda: kt.bieigsolve_batched(tri, X["v0"], X["w0"], 4, "LM", bi, space),
            lambda: ba.bieigsolve_driver(tri, X["v0"][0], X["w0"][0], 4, "LM", bi, space),
            lambda r: ((r[0], r[1][0], r[1][1]), r[2][0])),
        "svdsolve": (
            lambda: kt.svdsolve_gkl_batched(tri, X["v0"], 4, "LR", gkl, space),
            lambda: svs.svdsolve_gkl(tri, X["v0"][0], 4, "LR", gkl, space),
            lambda r: ((r[0], r[1], r[2]), r[3])),
        "lssolve": (
            lambda: kt.lssolve_lsmr_batched(tri, X["w0"], lsmr, 0.0, space),
            lambda: lss.lssolve_lsmr(tri, X["w0"][0], lsmr, 0.0, space),
            lambda r: ((r[0],), r[1])),
    }


def front_ends_batched_rank(torch, np, kt, A, B, tri, vecs, mesh, space, n, n4, phase):
    """The batched half of phase ``sharded_front_ends`` on this rank, the
    projection kernels on: every solve of :func:`front_ends_batched_solves`
    once to warm up (one iteration each, to keep the phase short), then
    each timed (:func:`rank_solve`), then problem 0's one-problem sharded
    solve timed where the phase ran none at that cap (``phase[name]``, the
    phase's own solve of problem 0, is its record where the caps agree).
    Returns per name the batched record and counts, problem 0's
    one-problem record, and whether problem 0 is its one-problem solve bit
    for bit (the values and counts of the phase's own solve) on every rank;
    and the warm-up's seconds."""
    P = kt.parallel
    ax = mesh.axis(P.VECTOR_AXIS)
    args = (torch, np, kt, A, B, tri, vecs, lambda a: P.shard_vector(a, mesh), space, n, n4)
    t0 = time.perf_counter()
    for batched, _, _ in front_ends_batched_solves(*args, warm=True).values():
        batched()
    warm_s = time.perf_counter() - t0
    out = {}
    for name, (batched, one, pick) in front_ends_batched_solves(*args).items():
        res, rec = rank_solve(torch, ax, batched, warm=False)
        tensors, info = pick(res)
        counts = {k: torch.as_tensor(getattr(info, k)).tolist()
                  for k in ("numops", "numiter", "converged")}
        phase_caps = {"block_lanczos": FE_BLOCK_ITERS, "geneigsolve": FE_GENEIG_ITERS,
                      "bieigsolve": BIEIG_ITERS}
        if phase_caps.get(name) == FE_BATCHED_ITERS[name]:
            rec1 = {k: v for k, v in phase[name].items() if k != "vals"}
            same = np.array_equal(tensors[0][0].cpu().numpy(), phase[name]["vals"]) and all(
                counts[k][0] == phase[name][k] for k in counts)
        else:
            res1, rec1 = rank_solve(torch, ax, one, warm=False)
            t1, i1 = pick(res1)
            rec1.update({k: int(getattr(i1, k)) for k in counts})
            same = all(torch.equal(t[0], u) for t, u in zip(tensors, t1)) and all(
                counts[k][0] == rec1[k] for k in counts)
        every = gather(torch, ax, torch.tensor([[int(same)]], device=mesh.device))
        vals = tensors[0]
        if vals.is_complex():
            vals = torch.stack([vals.real, vals.imag], dim=1)
        out[name] = {**rec, **counts, "one_problem": rec1,
                     "problem0_bits": all(r[0] for r in every.tolist()),
                     "vals": vals.cpu().numpy() if name != "lssolve" else None}
    return out, warm_s


def sharded_front_ends_rank(torch, np, kt, dev="cuda", n=1 << 21, halfband=25, n4=1 << 20,
                            go=None):
    """Phase ``sharded_front_ends`` on this rank: config 5's operator
    generated and planned once (``tile=128``), with the diagonal ``B``,
    config 4's tridiagonal (both plans) and chain (``shard_local_stencil``);
    then every solve of :func:`front_ends_solves` once to warm up and once
    timed (``rank_solve``), the projection kernels on.  With ``go`` the
    solves wait for it after the planning."""
    from krylovkit_tpu_torch.ops import basis as bs
    from krylovkit_tpu_torch.ops.vector import VectorSpace

    P = kt.parallel
    mesh = P.make_mesh(device=dev)
    ax = mesh.axis(P.VECTOR_AXIS)
    space = VectorSpace(psum_axis=ax)
    t0 = time.perf_counter()
    rows, cols, vals = P.banded_coo(n, halfband, dtype=np.float32, seed=7, spd=True)
    gen_s = time.perf_counter() - t0
    nnz = len(rows)
    A = P.sharded_ell_from_coo(rows, cols, vals, (n, n), mesh, tile=128, with_adjoint=False)
    i = np.arange(n)
    B = P.sharded_ell_from_coo(i, i, front_ends_pencil_b(np, rows, cols, vals, n), (n, n), mesh,
                               tile=128, with_adjoint=False)
    del rows, cols, vals
    data = front_ends_data(np, n, n4)
    tri = P.sharded_ell_from_coo(*tridiagonal_coo(np, n4, *FRONT_END_TRI, np.float32), (n4, n4),
                                 mesh, tile=128)
    chain = P.shard_local_stencil(kt.StencilOperator(*FRONT_END_NEG_LAP), ax)
    vecs = {k: ([P.shard_vector(b, mesh) for b in v] if k == "block" else P.shard_vector(v, mesh))
            for k, v in data.items()}
    planned = gather(torch, ax, torch.tensor([[gen_s, A.plan_seconds["normal"],
                                               tri.plan_seconds["adjoint"]]],
                                             dtype=torch.float64, device=mesh.device))
    if go is not None:
        require(go.wait(SHARD_TIMEOUT_S * 5), "sharded_front_ends: the spawning process gave the go")
    solves = front_ends_solves(kt, A, B, tri, chain, vecs, space,
                               lambda t: gather(torch, ax, t).cpu().numpy())
    out = {}
    old = bs.use_pallas_projections
    bs.use_pallas_projections = True
    try:
        for name, solve in solves.items():
            res, rec = rank_solve(torch, ax, solve)
            out[name] = {**res, **rec}
        t0 = time.perf_counter()
        batched, warm_s = front_ends_batched_rank(torch, np, kt, A, B, tri, vecs, mesh, space, n,
                                                  n4, out)
        batched_s = time.perf_counter() - t0
    finally:
        bs.use_pallas_projections = old
    return {"solves": out, "batched": batched, "nnz": nnz, "comm": A.comm_summary(),
            "generate_plan_s_by_rank": planned.cpu().tolist(),
            "batched_seconds": {"warm_up": warm_s, "all": batched_s}}


def front_ends_reference(torch, np, kt, dev, n, halfband, n4):
    """The one-rank operators of phase ``sharded_front_ends`` on ``dev``:
    ``sparse.from_coo`` of the same matrices applied to ``(R, 128)``
    vectors, and config 4's chain as a ``StencilOperator`` (fused).
    Returns ``(A, B, tri, chain, seconds)``."""
    from krylovkit_tpu_torch.ops.operator import TypedOperator

    t0 = time.perf_counter()
    rows, cols, vals = kt.parallel.banded_coo(n, halfband, dtype=np.float32, seed=7, spd=True)
    ell = kt.sparse.from_coo(rows, cols, vals, (n, n), with_adjoint=False, device=dev)
    i = np.arange(n)
    diag = kt.sparse.from_coo(i, i, front_ends_pencil_b(np, rows, cols, vals, n), (n, n),
                              with_adjoint=False, device=dev)
    del rows, cols, vals
    tri = kt.sparse.from_coo(*tridiagonal_coo(np, n4, *FRONT_END_TRI, np.float32), (n4, n4),
                             device=dev)

    def tiled(op, adjoint=False):
        return lambda x: (op.adjoint if adjoint else op.normal)(x).reshape(x.shape)

    f32 = torch.float32
    return (TypedOperator(tiled(ell), dtype=f32), TypedOperator(tiled(diag), dtype=f32),
            TypedOperator(tiled(tri), tiled(tri, True), dtype=f32),
            kt.StencilOperator(*FRONT_END_NEG_LAP), time.perf_counter() - t0)


def _front_end_errors(np, name, got, want):
    """The relative errors of a sharded solve against the one-rank one,
    each beside its tolerance."""
    if name in ("minres", "bicgstab"):
        return {"x_rel_err": (_rel(np, got["x"], want["x"]), FE_TOL),
                "true_residual_rel_err": (abs(got["true_residual"] - want["true_residual"])
                                          / want["true_residual"], FE_RESIDUAL_TOL)}
    if name == "exponentiate_fused":
        return {"y_rel_err": (_rel(np, got["y"], want["y"]), FE_TOL)}
    if name == "lanczos_iterator":
        scale = float(np.abs(want["H"]).max())
        return {"H_rel_err": (float(np.abs(got["H"] - want["H"]).max()) / scale, FE_TOL),
                "beta_rel_err": (abs(float(got["beta"]) - float(want["beta"]))
                                 / float(want["beta"]), FE_TOL)}
    scale = float(np.abs(want["vals"]).max())
    return {"vals_rel_err": (float(np.abs(got["vals"] - want["vals"]).max()) / scale, FE_TOL)}


def _json_values(np, a):
    """A real array as a list, a complex one as ``{"re": [...], "im": [...]}``."""
    a = np.asarray(a)
    if np.iscomplexobj(a):
        return {"re": a.real.tolist(), "im": a.imag.tolist()}
    return a.tolist()


# nnz of one counted apply, by solve (config 5's operator, B diagonal, config
# 4's tridiagonal and chain)
def _front_end_nnz(name, nnz, n, n4):
    return {"geneigsolve": nnz + n, "bieigsolve": 3 * n4 - 2, "exponentiate_fused": 3 * n4}.get(
        name, nnz)


def sharded_front_ends(torch, np, kt, _build, smi, world=2, dev="cuda", n=1 << 21, halfband=25,
                       n4=1 << 20):
    """Phase ``sharded_front_ends``: the solves of :func:`front_ends_solves`
    on ``world`` gloo ranks (:func:`sharded_front_ends_rank`; the ranks plan
    while this process builds the one-rank operators) and on one rank, the
    projection kernels on in both; each solve once to warm up and once
    timed on either side.  Guards: every rank the same bits; counts
    equal to the one-rank solve's; values within 1e-4, the linear solves'
    true residuals within 1e-3; launches per rank equal to the one-rank
    solve's (K1 launched by the fused ``exponentiate``).  One metric line
    per solve: the slowest rank's ms, the collectives of that solve and
    their ms, the one-rank ms.  Returns the launches per rank by solve."""
    import torch.multiprocessing as tmp

    from krylovkit_tpu_torch.ops import basis as bs

    t0 = time.perf_counter()
    go = tmp.get_context("spawn").Event()
    handle = start_ranks(world, "sharded_front_ends_rank", dev=dev, threads=3, timeout=900, go=go,
                         n=n, halfband=halfband, n4=n4)
    try:
        A, B, tri, chain, ref_s = front_ends_reference(torch, np, kt, dev, n, halfband, n4)
        data = front_ends_data(np, n, n4)
        vecs = {k: ([torch.from_numpy(b).to(dev) for b in v] if k == "block"
                    else torch.from_numpy(v).to(dev)) for k, v in data.items()}
    finally:
        go.set()
    ranks = collect_ranks(handle)
    sharded = same_on_every_rank(np, [r["solves"] for r in ranks])
    from krylovkit_tpu_torch.ops.vector import STANDARD

    solves = front_ends_solves(kt, A, B, tri, chain, vecs, STANDARD, lambda t: t.cpu().numpy())
    card = torch.cuda.get_device_name(0) if dev != "cpu" else "cpu"
    launches = {}
    old = bs.use_pallas_projections
    bs.use_pallas_projections = True
    try:
        for name, solve in solves.items():
            solve()  # warm-up, as the ranks' (library loads, first launches)
            one, ms1, l1 = _sync_ms(torch, _build, solve, dev)
            rec = sharded[name]
            errs = _front_end_errors(np, name, rec, one)
            counts = {k: (rec[k], one[k]) for k in ("numops", "numiter", "converged", "k")
                      if k in one}
            ms = max(rec["ms_per_solve_by_rank"])
            cms = max(rec["collective_ms_by_rank"])
            emit({"metric": f"sharded_{name}",
                  "value": rec["numops"] * _front_end_nnz(name, ranks[0]["nnz"], n, n4) / ms / 1e6,
                  "unit": "Gnnz/s", "formula": "numops * nnz / t, t the slowest rank",
                  "ranks": world, "ms_per_solve": ms, "ms_per_solve_by_rank": rec["ms_per_solve_by_rank"],
                  "collectives_per_solve": rec["collectives_per_solve"],
                  "collective_bytes_per_solve": rec["collective_bytes_per_solve"],
                  "collective_ms_per_solve": cms,
                  "ms_per_collective": cms / max(rec["collectives_per_solve"], 1),
                  "launches_per_rank": rec["launches_per_rank"],
                  "counts_sharded_one_rank": counts,
                  **({"vals": _json_values(np, rec["vals"])} if "vals" in rec else {}),
                  **{k: rec[k] for k in ("maxiter", "true_residual", "b_norm") if k in rec},
                  "one_rank": {"ms_per_solve": ms1, "launches": l1},
                  **{k: v[0] for k, v in errs.items()},
                  "tolerances": {k: v[1] for k, v in errs.items()},
                  "device": card, "nvidia_smi": smi})
            for key, (a, b) in counts.items():
                require(a == b, f"sharded_front_ends {name}: {key} {a} equal to the one-rank "
                        f"solve's {b}")
            for key, (err, tol) in errs.items():
                require(err <= tol, f"sharded_front_ends {name}: {key} {err} within {tol}")
            require(rec["launches_per_rank"] == l1, f"sharded_front_ends {name}: launches per rank "
                    f"{rec['launches_per_rank']} equal to the one-rank solve's {l1}")
            launches[name] = rec["launches_per_rank"]
    finally:
        bs.use_pallas_projections = old
    if dev != "cpu":
        require(launches["exponentiate_fused"].get("fused_step", 0) > 0,
                "sharded_front_ends: the fused exponentiate launched K1 on every rank")
    batched = same_on_every_rank(np, [r["batched"] for r in ranks])
    for name, rec in batched.items():
        launches[f"{name}_batched"] = front_ends_batched_line(np, name, rec, world, dev, card, smi)
    emit({"phase": "sharded_front_ends", "seconds": time.perf_counter() - t0,
          "batched_seconds_by_rank": [r["batched_seconds"] for r in ranks],
          "one_rank_build_s": ref_s, "generate_plan_s_by_rank": [r["generate_plan_s_by_rank"]
                                                                   for r in ranks][0],
          "comm": ranks[0]["comm"], "note": "one card: ranks share it; no scaling measured"})
    return launches


def front_ends_batched_predicted(name, rec):
    """The batched K2/K5/K6 launches a rank makes in the batched solve
    ``name`` of phase ``sharded_front_ends`` (:data:`FE_BATCH_P` problems in
    lock-step, every solve to its cap), from its counts: ``{kernel:
    launches}``."""
    ops, it = rec["numops"][0], rec["numiter"][0]
    if name == "block_lanczos":  # 2 passes a column of b = 4: the start's QR and each step's
        return {"project_batched": 2 * (4 + ops)}
    if name == "geneigsolve":  # a cgs2 pair an apply and a restart (numops counts the start)
        return {"project_batched": 2 * (ops + it - 1), "unproject_batched": 2 * (ops + it - 1)}
    if name == "bieigsolve":  # each side's cgs2 pair a step, M's two and the oblique two a round
        # (a lock-step a step: after a restart the problems may keep
        # different counts and step apart, so one round, as the phase runs)
        steps = ops // 2
        return {"project_batched": 6 * steps + 2 * it + 2 * (it - 1),
                "unproject_batched": 4 * steps}
    if name == "svdsolve":  # one drift sweep each half-step, one rotation of each basis a round
        steps = ops // 2
        return {"project_batched": 2 * steps, "unproject_batched": 2 * steps,
                "transform_partial_batched": 2 * it}
    return {"project_batched": 2 * it, "unproject_batched": 2 * it}  # lssolve: a cgs2 ring sweep


def front_ends_batched_line(np, name, rec, world, dev, card, smi):
    """One metric line of the batched half of phase ``sharded_front_ends``
    and its guards: problem 0 bit-identical to its one-problem sharded
    solve (the phase's own, where it ran one), the problems' counts equal
    (fixed work: problem 1's one-problem solve would take problem 0's, so
    the two one-problem solves are ``P`` times problem 0's, measured),
    batched K2/K5/K6 only and as many as
    :func:`front_ends_batched_predicted` gives, fewer all-reduces than
    ``P`` one-problem solves.  Returns the launches per rank."""
    one = rec["one_problem"]
    ms, ms1 = max(rec["ms_per_solve_by_rank"]), max(one["ms_per_solve_by_rank"])
    got = rec["launches_per_rank"]
    want = front_ends_batched_predicted(name, rec) if dev != "cpu" else {}
    emit({"metric": f"sharded_{name}_batched", "value": ms / (FE_BATCH_P * ms1), "unit": "x",
          "formula": "t_batched / (P * t_one_problem(problem 0)), each the slowest rank",
          "ranks": world, "problems": FE_BATCH_P, "ms_per_solve": ms,
          "ms_per_solve_by_rank": rec["ms_per_solve_by_rank"], "one_problem_ms": ms1,
          "P_times_one_problem_ms": FE_BATCH_P * ms1,
          **{k: rec[k] for k in ("numops", "numiter", "converged")},
          "launches_per_rank": got, "predicted_launches_per_rank": want,
          "one_problem_launches_per_rank": one["launches_per_rank"],
          "collectives_per_solve": rec["collectives_per_solve"],
          "collectives_by_kind": rec["collectives_by_kind"],
          "one_problem_collectives": one["collectives_per_solve"],
          "one_problem_collectives_by_kind": one["collectives_by_kind"],
          "collective_ms_per_solve": max(rec["collective_ms_by_rank"]),
          "one_problem_collective_ms": max(one["collective_ms_by_rank"]),
          "problem0_bit_identical": rec["problem0_bits"],
          **({"vals": _json_values(np, rec["vals"])} if rec["vals"] is not None else {}),
          "device": card, "nvidia_smi": smi})
    require(rec["problem0_bits"], f"sharded_front_ends {name}_batched: problem 0 its "
            "one-problem sharded solve bit for bit")
    require(all(len(set(rec[k])) == 1 for k in ("numops", "numiter")),
            f"sharded_front_ends {name}_batched: every problem the same counts (fixed work)")
    require(got == want, f"sharded_front_ends {name}_batched: launches per rank {got} as "
            f"predicted {want}")
    require(rec["collectives_per_solve"] < FE_BATCH_P * one["collectives_per_solve"],
            f"sharded_front_ends {name}_batched: fewer all-reduces than {FE_BATCH_P} one-problem "
            "solves")
    return got


def _tree_of(torch, kind, cut):
    """``(split, join)`` of a vector cut into two leaves at row ``cut``: a
    dict ``{"a", "b"}`` or a tuple."""
    def split(v):
        return {"a": v[:cut], "b": v[cut:]} if kind == "dict" else (v[:cut], v[cut:])

    def join(t):
        return torch.cat([t["a"], t["b"]] if kind == "dict" else list(t))

    return split, join


def _tree_map_of(torch, kt, apply, dom, cod, dtype, adjoint=None):
    """``apply`` (a map on single tensors) as an operator from the tree
    ``dom`` to the tree ``cod`` (``(split, join)`` pairs) that states its
    type, so the solvers probe nothing."""
    from krylovkit_tpu_torch.ops.operator import TypedOperator

    def normal(t):
        return cod[0](apply(dom[1](t)))

    adj = None if adjoint is None else (lambda t: dom[0](adjoint(cod[1](t))))
    return TypedOperator(normal, adj, dtype=dtype)


def small_pytree_cases(torch, np, kt, dev):
    """The small float64 pytree solves of phase ``pytree_drivers`` on
    ``dev``, by name, each ``(values, info)``: ``svdsolve`` (a 40 × 30 map
    from a dict domain to a tuple codomain), ``lssolve`` with λ = 0.5,
    ``geneigsolve`` on dicts, ``expintegrator`` with three dict vectors,
    Block Lanczos on a ``Block`` of dicts."""
    quiet = {"verbosity": kt.SILENT}
    rng = np.random.default_rng(206)
    R = torch.from_numpy(rng.standard_normal((40, 30))).to(dev)
    C = torch.from_numpy(rng.standard_normal((20, 20))).to(dev)
    H = torch.from_numpy(rng.standard_normal((20, 20))).to(dev)
    H, Bm = (H + H.T) / 2, C @ C.T + 2 * torch.eye(20, dtype=torch.float64, device=dev)
    x40, x30, x20 = (torch.from_numpy(rng.standard_normal(k)).to(dev) for k in (40, 30, 20))
    u3 = [torch.from_numpy(rng.standard_normal(20)).to(dev) for _ in range(3)]
    cod, dom, sq = _tree_of(torch, "tuple", 17), _tree_of(torch, "dict", 12), _tree_of(
        torch, "dict", 9)
    f64 = torch.float64
    rect = _tree_map_of(torch, kt, lambda v: R @ v, dom, cod, f64, lambda v: R.T @ v)

    def svd():
        S, _, _, info = kt.svdsolve(rect, cod[0](R @ x30), 3, "LR", krylovdim=20, tol=1e-10,
                                    maxiter=200, **quiet)
        return S, info

    def ls():
        x, info = kt.lssolve(rect, cod[0](x40), 0.5, tol=1e-10, maxiter=400, **quiet)
        return dom[1](x), info

    def geneig():
        pencil = (_tree_map_of(torch, kt, lambda v: H @ v, sq, sq, f64),
                  _tree_map_of(torch, kt, lambda v: Bm @ v, sq, sq, f64))
        vals, _, info = kt.geneigsolve(pencil, sq[0](x20), 2, "SR", krylovdim=8, tol=1e-10,
                                       maxiter=50, **quiet)
        return vals, info

    def expint():
        op = _tree_map_of(torch, kt, lambda v: (H / 4) @ v, sq, sq, f64)
        y, info = kt.expintegrator(op, 0.5, *(sq[0](u) for u in u3), ishermitian=True,
                                   tol=1e-10, krylovdim=10, **quiet)
        return sq[1](y), info

    def block():
        op = _tree_map_of(torch, kt, lambda v: H @ v, sq, sq, f64)
        vals, _, info = kt.eigsolve(op, kt.Block([sq[0](u) for u in u3]), 3, "LR", tol=1e-10,
                                    krylovdim=12, maxiter=100, **quiet)
        return vals, info

    return {"svdsolve": svd, "lssolve": ls, "geneigsolve": geneig, "expintegrator": expint,
            "block_lanczos": block}


def pytree_drivers(torch, np, kt, _build, refs, smi, dev="cuda", N=1024):
    """Phase ``pytree_drivers``: the small pytree solves of
    :func:`small_pytree_cases` on the card against the CPU (within 1e-12,
    counts equal); then at full width, each vector cut into two leaves by
    rows, one solve each held against the single-tensor solve of the same
    problem: config 3's rectangular callables through ``svdsolve`` (a tuple
    codomain, a dict domain) and config 4's ``exponentiate`` against phases
    12 and 13 (``refs``), the ``N × N`` Q1 pencil through ``geneigsolve``
    and config 2's banded Poisson through Block Lanczos on a ``Block`` of
    dicts (float64) against single-tensor solves run here.  Values within
    1e-4, counts equal for the solves that run to ``maxiter``, the launches
    printed (and equal to the single-tensor solve's where it runs here).
    Returns the launches by solve."""
    t0 = time.perf_counter()
    small = []
    for name in small_pytree_cases(torch, np, kt, "cpu"):
        rec, _, _, _ = card_vs_cpu(torch, _build, f"pytree {name}",
                                   lambda d: small_pytree_cases(torch, np, kt, d)[name](),
                                   SMALL_SHARDED_TOL, dev)
        small.append(rec)
    emit({"phase": "pytree_drivers_small", "solves": small, "tolerance": SMALL_SHARDED_TOL})
    quiet = {"verbosity": kt.SILENT}
    f32 = torch.float32
    card = torch.cuda.get_device_name(0) if dev != "cpu" else "cpu"
    out = {}

    def line(metric, result, ref, info, ref_info, ms, launches, fixed, extra):
        err = _rel(np, result, ref)
        counts = {k: (getattr(info, k), getattr(ref_info, k)) for k in ("numops", "numiter",
                                                                        "converged")}
        emit({"metric": metric, "ms_per_solve": ms, "launches_per_solve": launches,
              "counts_tree_single": counts, "rel_err_vs_single": err, "tolerance": FE_TOL,
              "device": card, "nvidia_smi": smi, **extra})
        require(err <= FE_TOL, f"{metric}: within {FE_TOL} of the single-tensor solve ({err})")
        if fixed:
            require(all(a == b for a, b in counts.values()),
                    f"{metric}: counts equal to the single-tensor solve's ({counts})")
        out[metric] = launches

    # config 3's rectangular map: codomain (8192, 128) as a tuple, domain
    # (4096, 128) as a dict, each cut in half by rows
    rect, rect_adj, x0r = refs["rect"]
    cod, dom = _tree_of(torch, "tuple", x0r.shape[0] // 2), _tree_of(torch, "dict",
                                                                    x0r.shape[0] // 4)
    op3 = _tree_map_of(torch, kt, rect, dom, cod, f32, rect_adj)
    (S, U, V, info), ms, launches = _sync_ms(torch, _build, lambda: kt.svdsolve(
        op3, cod[0](x0r), 8, "LR", krylovdim=30, maxiter=12, tol=1e-30, **quiet), dev)
    S_ref, info_ref = refs["svdsolve"]
    line("pytree_svdsolve_rect", S.cpu().numpy(), S_ref.numpy(), info, info_ref, ms, launches, True,
         {"vals": S.cpu().tolist(), "leaves": {"codomain": [tuple(l.shape) for l in U],
                                               "domain": [tuple(V[k].shape) for k in V]}})
    # config 4's exponentiate on tuple vectors (unfused: a tree)
    chain, x04, (ye, ie) = refs["exponentiate"]
    te = _tree_of(torch, "tuple", x04.shape[0] // 2)
    ope = _tree_map_of(torch, kt, chain.normal, te, te, f32)
    (y, info), ms, launches = _sync_ms(torch, _build, lambda: kt.exponentiate(
        ope, 0.1, te[0](x04), krylovdim=30, tol=1e-4, ishermitian=True, **quiet), dev)
    line("pytree_exponentiate", te[1](y).cpu().numpy(), ye.cpu().numpy(), info, ie, ms, launches,
         False, {})
    # the Q1 pencil and config 2's banded Poisson in float64: both repeat
    # eigenvalues (λ(i, j) = λ(j, i)), and after a fixed count the Ritz values
    # beyond the first are unconverged and move with the order of a
    # reduction (3e-3 between a tree and a tensor in float32 at N = 64);
    # float64 keeps that motion far below the tolerance.  Each against its
    # single-tensor solve, run here
    nq = N * N
    f64 = torch.float64
    coo_k, coo_m = q1_coo(np, N, N, np.float64)
    Kb, Mb = (kt.banded_from_coo(*c, nq, device=dev) for c in (coo_k, coo_m))
    del coo_k, coo_m
    x0q = torch.from_numpy(np.random.default_rng(4).standard_normal((nq // 128, 128))).to(dev)
    sq = _tree_of(torch, "dict", x0q.shape[0] // 2)
    kwq = dict(krylovdim=30, maxiter=8, tol=1e-30, **quiet)
    (vq, _, iq), ms1, l1 = _sync_ms(torch, _build, lambda: kt.geneigsolve((Kb, Mb), x0q, 4, "SR",
                                                                          **kwq), dev)
    pencil = (_tree_map_of(torch, kt, Kb.normal, sq, sq, f64),
              _tree_map_of(torch, kt, Mb.normal, sq, sq, f64))
    (vals, _, info), ms, launches = _sync_ms(torch, _build, lambda: kt.geneigsolve(
        pencil, sq[0](x0q), 4, "SR", **kwq), dev)
    line("pytree_geneigsolve_q1", vals.cpu().numpy(), vq.cpu().numpy(), info, iq, ms, launches,
         True, {"vals": vals.cpu().tolist(), "dtype": "float64",
                "single": {"ms_per_solve": ms1, "launches": l1}})
    require(launches == l1, f"pytree_geneigsolve_q1: launches {launches} equal to the "
            f"single-tensor solve's {l1} (K3 twice per counted apply)")
    del Kb, Mb, pencil
    banded = kt.banded_from_coo(*poisson_coo(np, N, np.float64), nq, device=dev)
    rng = np.random.default_rng(5)
    X0 = [torch.from_numpy(rng.standard_normal((nq // 128, 128))).to(dev) for _ in range(4)]
    tb = _tree_of(torch, "dict", X0[0].shape[0] // 2)
    kwb = dict(krylovdim=30, maxiter=8, tol=1e-30, **quiet)
    (vb, _, ib), ms1, l1 = _sync_ms(torch, _build, lambda: kt.eigsolve(banded, kt.Block(X0), 4,
                                                                       "LR", **kwb), dev)
    opb = _tree_map_of(torch, kt, banded.normal, tb, tb, f64)
    (vals, _, info), ms, launches = _sync_ms(torch, _build, lambda: kt.eigsolve(
        opb, kt.Block([tb[0](x) for x in X0]), 4, "LR", **kwb), dev)
    line("pytree_block_lanczos_poisson", vals.cpu().numpy(), vb.cpu().numpy(), info, ib, ms,
         launches, True, {"vals": vals.cpu().tolist(), "dtype": "float64",
                          "single": {"ms_per_solve": ms1, "launches": l1}})
    require(launches == l1, f"pytree_block_lanczos_poisson: launches {launches} equal to the "
            f"single-tensor solve's {l1} (K3 once per apply)")
    emit({"phase": "pytree_drivers", "seconds": time.perf_counter() - t0})
    return out


def batched_starts(torch, np, R, P, dev, seed=100):
    """Phase ``batched``'s start vectors: phase ``main``'s ``x0`` (ones) and
    ``P - 1`` normal vectors from ``default_rng(seed + i)``, ``(P, R, 128)``
    float32."""
    X = torch.empty((P, R, 128), dtype=torch.float32, device=dev)
    X[0] = 1
    for i in range(1, P):
        X[i] = torch.from_numpy(np.random.default_rng(seed + i).standard_normal((R, 128))
                                .astype(np.float32))
    return X


def check_batched_step(torch, fl, op, P, R, kmax, B, with_drift, gen, timed=True,
                       adjoint=False, grouped=False, ext=False):
    """Batched K1 against its plain version (the one-problem tolerance of
    :func:`check_fused_step`) and, where every problem has the same ``B =
    kp1`` (``B`` an int), against ``P`` one-problem launches bit for bit;
    ``B`` a list gives each problem its own.  ``grouped`` launches a list
    ``B`` as the batched fused GKL does, one launch per distinct ``B``
    (``active`` its problems, one ``ynext`` buffer), and holds every problem
    against a one-problem launch bit for bit too.  ``adjoint``: the
    operator's adjoint spec (the codomain half-steps of the fused GKL).
    ``ext`` gives every problem non-zero external halos (``Vext (P, kmax,
    2, h, 128)``, ``yext (P, 2, h, 128)``: a rank's blocks of split
    vectors), held against the one-problem launch with the problem's
    halos.  Timed: ms per batched launch, the ``P`` one-problem launches'
    ms, the plain version's and the bound (``P`` times the one-problem
    bytes and operations, the halo rows included)."""
    spec = fl.adjoint_spec(op) if adjoint else fl.spec_for(op)
    V = torch.randn((P, kmax, R, 128), generator=gen, device="cuda")
    y = torch.randn((P, R, 128), generator=gen, device="cuda")
    g = torch.randn((P, kmax + 1), generator=gen, device="cuda")
    halos, one_halos = {}, lambda p: {}
    if ext:
        halos = {"Vext": torch.randn((P, kmax, 2, spec.h, 128), generator=gen, device="cuda"),
                 "yext": torch.randn((P, 2, spec.h, 128), generator=gen, device="cuda")}
        one_halos = lambda p: {k: v[p] for k, v in halos.items()}  # noqa: E731
    Bs = [B] * P if isinstance(B, int) else list(B)
    Vb = V.clone()
    if grouped:
        yb, raws = torch.empty_like(y), {}
        for b in sorted(set(Bs)):
            group = [p for p in range(P) if Bs[p] == b]
            _, raw = fl.fused_step_batched(Vb, y, g, Bs, Bs, spec, with_drift, active=group,
                                           ynext=yb, **halos)
            raws.update({p: raw[p] for p in group})
        rb = [raws[p] for p in range(P)]
    else:
        yb, rb = fl.fused_step_batched(Vb, y, g, Bs, Bs, spec, with_drift, **halos)
    Vr = V.clone()
    yr, rr = fl.fused_step_batched_reference(Vr, y, g, Bs, Bs, spec, with_drift, **halos)
    torch.cuda.synchronize()
    to_one = isinstance(B, int) or grouped
    err, rel_raw, same = 0.0, 0.0, True
    for p in range(P):
        k = Bs[p]
        sc = float(yr[p].abs().max())
        e = max(float((Vb[p, k] - Vr[p, k]).abs().max()), float((yb[p] - yr[p]).abs().max()))
        require(e <= 2e-4 * sc, f"fused_step_batched B={k}: w', y' within 2e-4*scale")
        require(torch.equal(Vb[p, :k], V[p, :k]) and torch.equal(Vb[p, k + 1:], V[p, k + 1:]),
                f"fused_step_batched B={k}: rows other than kp1 bit-identical")
        nV = torch.linalg.vector_norm(V[p, :k].reshape(k, R * 128), dim=1)
        nw, ny = torch.linalg.vector_norm(Vr[p, k]), torch.linalg.vector_norm(yr[p])
        scales = torch.cat([nV * ny] + ([nV * nw] if with_drift else [])
                           + [(nw * ny)[None], (nw * nw)[None]])
        n_slots = scales.numel()
        rel = float(torch.max(torch.abs(rb[p][:n_slots] - rr[p, :n_slots]) / scales))
        require(rel <= 1e-6, f"fused_step_batched B={k}: raw within 1e-6 of the norm products")
        err, rel_raw = max(err, e), max(rel_raw, rel)
        if to_one:
            V1 = V[p].clone()
            y1, r1 = fl.fused_step(V1, y[p], g[p], k, k, spec, with_drift, **one_halos(p))
            same = same and torch.equal(V1[k], Vb[p, k]) and torch.equal(y1, yb[p]) and \
                torch.equal(r1, rb[p][:r1.numel()])
    require(same, f"fused_step_batched B={B}: each problem bit-identical to a one-problem launch")
    n = R * 128
    case = {"op": "grid" if spec.gc else "chain", "adjoint": adjoint, "P": P, "n": n,
            "kmax": kmax, "B": B, "with_drift": with_drift, "external_halos": ext,
            "max_abs_err": err,
            "raw_rel_err": rel_raw,
            "tolerance": "2e-4*scale (w', y'); 1e-6*norm products (raw)",
            "launches": len(set(Bs)) if grouped else 1,
            "bit_identical_to_one_problem_launches": same if to_one else None}
    if timed:
        halo_bytes = (lambda k: (k + 1) * 2 * spec.h * 128 * 4) if ext else (lambda k: 0)
        t_bound, by = bound(sum((k + 3) * n * 4 + halo_bytes(k) for k in Bs),
                            sum(k1_flops(n, k, len(spec.taps), with_drift) for k in Bs))
        one = [device_ms(torch, lambda p=p: fl.fused_step(V[p], y[p], g[p], Bs[p], Bs[p], spec,
                                                           with_drift, **one_halos(p)), reps=5)
               for p in ([0] if isinstance(B, int) else range(P))]
        case.update({
            "ms": device_ms(torch, lambda: fl.fused_step_batched(Vb, y, g, Bs, Bs, spec,
                                                                 with_drift, **halos), reps=5),
            "one_problem_launches_ms": one[0] * P if isinstance(B, int) else sum(one),
            "plain_ms": device_ms(torch, lambda: fl.fused_step_batched_reference(
                Vr, y, g, Bs, Bs, spec, with_drift, **halos), reps=1, batches=1),
            "bound_ms": t_bound, "bound_by": by,
        })
    return case


def check_batched_transform(torch, bs, P, R, kmax, m_out, gen, dtype=None, timed=True):
    """Batched K2 against ``P`` one-problem launches bit for bit (one
    problem's ``U`` the identity: its basis bit-identical), rows ``>=
    m_out`` untouched, the plain version within the one-problem tolerance.
    Timed: ms per batched launch, ``P`` one-problem launches, the plain
    version, ``torch.bmm`` of the same product and the bound (``P`` times
    the one-problem bytes)."""
    dtype = dtype or torch.float32
    V = torch.randn((P, kmax, R, 128), generator=gen, device="cuda").to(dtype)
    U = torch.randn((P, kmax, kmax), generator=gen, device="cuda") / kmax ** 0.5
    U[P - 1] = torch.eye(kmax, device="cuda")
    Vb = bs.transform_partial_inplace_batched(V.clone(), U, m_out)
    Vr = bs.transform_partial_inplace_batched_reference(V.clone(), U, m_out)
    torch.cuda.synchronize()
    label = f"transform_partial_batched P={P} m_out={m_out} {dtype}"
    same = all(torch.equal(bs.transform_partial_inplace(V[p].clone(), U[p], m_out), Vb[p])
               for p in range(P))
    require(same, f"{label}: each problem bit-identical to a one-problem launch")
    require(torch.equal(Vb[P - 1], V[P - 1]), f"{label}: identity rotation bit-identical")
    require(torch.equal(Vb[:, m_out:], V[:, m_out:]), f"{label}: rows >= m_out bit-identical")
    sc = float(Vr[:, :m_out].float().abs().max())
    err = float((Vb[:, :m_out].float() - Vr[:, :m_out].float()).abs().max())
    tol = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -7
    require(err <= tol * sc, f"{label}: rows < m_out within {tol}*scale of the plain version")
    n = R * 128
    case = {"P": P, "kmax": kmax, "n": n, "m_out": m_out, "dtype": str(dtype), "max_abs_err": err,
            "scale": sc, "bit_identical_to_one_problem_launches": same}
    if timed:
        t_bound, by = bound(P * (kmax + m_out) * n * V.element_size(), P * 2 * kmax * m_out * n)
        Um = U[:, :, :m_out].transpose(1, 2).to(dtype)
        Vf = V.reshape(P, kmax, -1)
        case.update({
            "ms": device_ms(torch, lambda: bs.transform_partial_inplace_batched(Vb, U, m_out)),
            "one_problem_launches_ms": P * device_ms(
                torch, lambda: bs.transform_partial_inplace(Vb[0], U[0], m_out)),
            "plain_ms": device_ms(torch, lambda: bs.transform_partial_inplace_batched_reference(
                Vr, U, m_out), reps=2, batches=1),
            "library_ms": device_ms(torch, lambda: torch.bmm(Um, Vf)),
            "bound_ms": t_bound, "bound_by": by,
        })
    return case


def batched_phase(torch, np, kt, _build, fl, bs, smi, n=1 << 21, nx=1024, P=8, PG=4,
                  dev="cuda"):
    """Phase ``batched``: ``P`` problems in one host loop.

    (a) config 1 (``laplacian_1d(n)``, 4 "LM", krylovdim 30, maxiter 10,
    tol 1e-30) from :func:`batched_starts` through
    ``eigsolve_lanczos_batched``: every problem 138 / 10 with its values
    within 2e-2 of 4, problems 0 and 1 within 1e-5 (relative) of their
    one-problem solves, 128 ``fused_step_batched`` and 11
    ``transform_partial_batched`` launches and no one-problem K1/K2;
    (b) config 2's ``gmres30_poisson_2d_shifted_convergent`` (``a0 =
    0.5``, tol 5e-5, maxiter 20) for ``PG`` right-hand sides (ones and
    ``0.05·normal`` from ``default_rng(200 + i)``, small enough that the
    float32 rounding of their true residual ``b − A x`` stays under tol)
    through
    ``linsolve_gmres_batched``: every problem converged with its true
    residual within tol, counts equal to its one-problem solve; (c) the
    batched K1/K2 at these widths against their plain versions and
    one-problem launches (:func:`check_batched_step`,
    :func:`check_batched_transform`), ms per launch beside ``P``
    one-problem launches and the bound.  Each batched solve is driven with
    the counts set to 0 just before it and read just after, then timed once
    more beside the one-problem solves.  ``dev="cpu"`` with a small ``n``
    and ``nx`` rehearses (a) and (b) with the plain versions: no launch
    guard, no kernel checks."""
    t0 = time.perf_counter()
    card = dev != "cpu"
    R = n // 128
    op = kt.laplacian_1d(n, device=dev)
    X = batched_starts(torch, np, R, P, dev)
    alg = kt.Lanczos(krylovdim=KRYLOVDIM, maxiter=10, tol=1e-30, verbosity=kt.SILENT)
    (vals, vecs, info), first_ms, launches = _sync_ms(
        torch, _build, lambda: kt.eigsolve_lanczos_batched(op, X, 4, "LM", alg), dev)
    _, batched_ms, _ = _sync_ms(
        torch, _build, lambda: kt.eigsolve_lanczos_batched(op, X, 4, "LM", alg), dev)
    ones, one_ms = [], []
    for p in (0, 1):
        (v1, _, i1), ms1, _ = _sync_ms(torch, _build,
                                       lambda p=p: kt.eigsolve_lanczos(op, X[p], 4, "LM", alg), dev)
        ones.append((v1, i1))
        one_ms.append(ms1)
    rel_one = max(float(((vals[p] - v1).abs() / v1.abs()).max()) for p, (v1, _) in enumerate(ones))
    vals_h = vals.cpu()
    rec = {
        "phase": "batched", "path": "config1_lanczos", "P": P, "n": n,
        "numops": info.numops.tolist(), "numiter": info.numiter.tolist(),
        "converged": info.converged.tolist(), "vals": vals_h.tolist(),
        "launches": launches, "first_solve_ms": first_ms, "batched_ms": batched_ms,
        "one_problem_ms": one_ms, "P_times_one_problem_ms": P * sum(one_ms) / len(one_ms),
        "one_problem_max_rel_diff": rel_one, "tolerance": 1e-5, "nvidia_smi": smi,
    }
    emit(rec)
    require(info.numops.tolist() == [138] * P and info.numiter.tolist() == [10] * P,
            f"batched config 1: every problem 138 / 10 ({info.numops.tolist()}, "
            f"{info.numiter.tolist()})")
    if n == 1 << 21:
        require(bool((torch.abs(vals_h - 4.0) <= 2e-2).all()), f"batched config 1: vals ~ 4 "
                f"(atol 2e-2): {vals_h.tolist()}")
    require(tuple(vecs.shape) == (P, 4, R, 128) and bool(torch.isfinite(vecs).all()),
            "batched config 1: finite vecs")
    require(rel_one <= 1e-5, f"batched config 1: problems 0 and 1 within 1e-5 of their "
            f"one-problem solves ({rel_one})")
    require(all(i1.numops == 138 and i1.numiter == 10 for _, i1 in ones),
            "batched config 1: one-problem solves 138 / 10")
    if card:
        require(launches == {"fused_step_batched": 128, "transform_partial_batched": 11},
                f"batched config 1: 128 batched K1 and 11 batched K2 launches, no one-problem "
                f"K1/K2 ({launches})")
    del vecs

    grid = kt.poisson_2d(nx, nx, device=dev)
    Rg = nx * nx // 128
    Bg = torch.empty((PG, Rg, 128), dtype=torch.float32, device=dev)
    Bg[0] = 1
    for i in range(1, PG):
        Bg[i] = torch.from_numpy((0.05 * np.random.default_rng(200 + i).standard_normal((Rg, 128)))
                                 .astype(np.float32))
    galg = kt.GMRES(krylovdim=KRYLOVDIM, tol=5e-5, maxiter=20, verbosity=kt.SILENT)
    (x, ginfo), gfirst_ms, glaunches = _sync_ms(
        torch, _build, lambda: kt.linsolve_gmres_batched(grid, Bg, torch.zeros_like(Bg), 0.5,
                                                         1.0, galg), dev)
    _, gbatched_ms, _ = _sync_ms(
        torch, _build, lambda: kt.linsolve_gmres_batched(grid, Bg, torch.zeros_like(Bg), 0.5,
                                                         1.0, galg), dev)
    from krylovkit_tpu_torch.solvers.gmres import linsolve_gmres

    gone, gone_ms = [], []
    for p in range(PG):
        (x1, i1), ms1, l1 = _sync_ms(torch, _build, lambda p=p: linsolve_gmres(
            grid, Bg[p], torch.zeros_like(Bg[p]), 0.5, 1.0, galg), dev)
        gone.append((x1, i1, l1))
        gone_ms.append(ms1)
    true_res = [float(torch.linalg.vector_norm(Bg[p] - (0.5 * x[p] + grid.normal(x[p]))))
                for p in range(PG)]
    x_rel = max(float((x[p] - x1).abs().max() / x1.abs().max()) for p, (x1, _, _) in
                enumerate(gone))
    emit({"phase": "batched", "path": "config2_gmres30_shifted", "P": PG, "n": nx * nx,
          "numops": ginfo.numops.tolist(), "numiter": ginfo.numiter.tolist(),
          "converged": ginfo.converged.tolist(), "true_residual": true_res, "tol": galg.tol,
          "one_problem_numops": [i1.numops for _, i1, _ in gone],
          "one_problem_numiter": [i1.numiter for _, i1, _ in gone],
          "x_max_rel_diff_one_problem": x_rel, "launches": glaunches,
          "one_problem_launches": [l1 for _, _, l1 in gone], "first_solve_ms": gfirst_ms,
          "batched_ms": gbatched_ms, "one_problem_ms": gone_ms,
          "sum_one_problem_ms": sum(gone_ms), "nvidia_smi": smi})
    require(ginfo.converged.tolist() == [1] * PG and max(true_res) <= galg.tol,
            f"batched GMRES: every problem converged, true residual within {galg.tol} "
            f"({true_res})")
    require(ginfo.numops.tolist() == [i1.numops for _, i1, _ in gone]
            and ginfo.numiter.tolist() == [i1.numiter for _, i1, _ in gone],
            "batched GMRES: counts equal to the one-problem solves")
    require(x_rel <= 1e-5, f"batched GMRES: x within 1e-5 of the one-problem solves ({x_rel})")
    if card:
        # a step launches once for every problem whose cycle goes on: at
        # least the steps of the longest solve, at most those of all
        k1_one = [l1.get("fused_step", 0) for _, _, l1 in gone]
        require(set(glaunches) == {"fused_step_batched"}
                and max(k1_one) <= glaunches["fused_step_batched"] <= sum(k1_one),
                f"batched GMRES: batched K1 only, between the longest solve's steps and all "
                f"solves' steps ({glaunches}, {k1_one})")
    del x, Bg
    out = {"launches": launches, "gmres_launches": glaunches}
    if not card:
        return out

    # (c) the batched kernels at these widths
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    kmax = KRYLOVDIM + 1
    chain = kt.laplacian_1d(n)
    k1 = [check_batched_step(torch, fl, chain, P, R, kmax, B, True, gen) for B in (4, 16, 30)]
    k1.append(check_batched_step(torch, fl, chain, P, R, kmax, [30, 19, 25, 4, 16, 29, 1, 22][:P],
                                 True, gen))
    k1.append(check_batched_step(torch, fl, grid, PG, Rg, kmax, 16, True, gen))
    # the main path's schedule: every problem at the same B each step
    spec = fl.spec_for(chain)
    V = torch.randn((P, kmax, R, 128), generator=gen, device="cuda")
    y = torch.randn((P, R, 128), generator=gen, device="cuda")
    g = torch.randn((P, kmax + 1), generator=gen, device="cuda")
    per_B = {}
    for B in sorted(set(k1_schedule())):
        t_bound, _ = bound(P * (B + 3) * n * 4, P * k1_flops(n, B, 3, True))
        per_B[B] = {"ms": device_ms(torch, lambda: fl.fused_step_batched(V, y, g, B, B, spec, True),
                                    reps=3, batches=2), "bound_ms": t_bound}
    del V, y, g
    k2 = [check_batched_transform(torch, bs, P, R, kmax, m, gen) for m in (20, 4)]
    k2.append(check_batched_transform(torch, bs, P, R, kmax, 20, gen, dtype=torch.bfloat16))
    sched = k1_schedule()
    k2_sched = [20] * 10 + [4]
    t2 = {c["m_out"]: c for c in k2 if c["dtype"] == "torch.float32"}
    summary = {
        "fused_step": {
            "launches_batched": launches.get("fused_step_batched", 0),
            "launches_batched_gmres": glaunches.get("fused_step_batched", 0),
            "ms_batched": sum(per_B[B]["ms"] for B in sched) / len(sched),
            "bound_ms_batched": sum(per_B[B]["bound_ms"] for B in sched) / len(sched),
            "max_abs_err_batched": max(c["max_abs_err"] for c in k1),
        },
        "transform_partial": {
            "launches_batched": launches.get("transform_partial_batched", 0),
            "ms_batched": sum(t2[m]["ms"] for m in k2_sched) / len(k2_sched),
            "bound_ms_batched": sum(t2[m]["bound_ms"] for m in k2_sched) / len(k2_sched),
            "library_ms_batched": sum(t2[m]["library_ms"] for m in k2_sched) / len(k2_sched),
            "max_abs_err_batched": max(c["max_abs_err"] for c in k2 if "float32" in c["dtype"]),
            "max_abs_err_batched_bfloat16": k2[-1]["max_abs_err"],
        },
    }
    emit({"phase": "batched_kernels", "P": P, "fused_step_batched": k1,
          "fused_step_batched_schedule": per_B, "transform_partial_batched": k2,
          "summary": summary, "nvidia_smi": smi, "seconds": time.perf_counter() - t0})
    out["kernels"] = summary
    return out


def block_banded_csr(torch, D, offsets, n):
    """The block-diagonal matrix of ``P`` banded blocks (plane sets ``D (P,
    nδ, ...)``) as one ``torch.sparse_csr_tensor``: the cuSPARSE yardstick of
    the batched K3 with a plane set per problem, never called by the port."""
    P = D.shape[0]
    i = torch.arange(n, device=D.device)
    cols = i[:, None] + torch.tensor(offsets, device=D.device)[None, :]
    inside = (cols >= 0) & (cols < n)
    vals = D.reshape(P, len(offsets), -1)[:, :, :n].transpose(1, 2)  # (P, n, nδ)
    keep = inside[None] & (vals != 0)
    gcols = cols[None] + (torch.arange(P, device=D.device) * n)[:, None, None]
    crow = torch.zeros(P * n + 1, dtype=torch.int64, device=D.device)
    crow[1:] = torch.cumsum(keep.reshape(P * n, -1).sum(1), 0)
    return torch.sparse_csr_tensor(crow, gcols[keep], vals[keep], (P * n, P * n))


def check_banded_batched(torch, bd, label, X, D, offsets, n, planes, flush, timed=True):
    """Batched K3 (``planes`` None: ``D`` one plane set shared by the rows;
    else a set per row) against one-problem launches, bit for bit, and its
    plain version within the one-problem tolerance.  Timed: ms per batched
    launch warm and cold, the rows' one-problem launches warm and cold, the
    plain version, the cuSPARSE yardstick (shared: ``torch.sparse.mm`` of
    the CSR matrix with the ``(n, P)`` block, SpMM; per problem:
    ``torch.mv`` of the block-diagonal CSR matrix, SpMV) and the bound by
    bytes, each input read once (shared: (nδ + 2P)·n·itemsize; per
    problem: (S·nδ + 2P)·n·itemsize for the S distinct sets named)."""
    P = X.shape[0]

    def one(p):
        return bd.banded_spmv(X[p], D if planes is None else D[planes[p]], offsets, n)

    Y = bd.banded_spmv_batched(X, D, offsets, n, planes)
    Yr = bd.banded_spmv_batched_reference(X, D, offsets, n, planes)
    torch.cuda.synchronize()
    same = all(torch.equal(Y[p], one(p)) for p in range(P))
    require(same, f"banded_spmv_batched {label}: each row bit-identical to a one-problem launch")
    scale = bd.banded_spmv_batched_reference(X.abs(), D.abs(), offsets, n, planes).clamp_min(
        torch.finfo(X.dtype).tiny)
    rel = float(((Y - Yr).abs() / scale).max())
    tol = 1e-6 if X.dtype == torch.float32 else 1e-15
    require(rel <= tol, f"banded_spmv_batched {label}: within {tol}*sum|d||x| of the plain version")
    case = {"case": label, "P": P, "n": n, "offsets": len(offsets), "dtype": str(X.dtype),
            "planes": "shared" if planes is None else "per_problem",
            "max_abs_err": float((Y - Yr).abs().max()), "max_rel_err": rel,
            "tolerance": f"{tol}*sum_p|d_p||x|", "bit_identical_to_one_problem_launches": same}
    if not timed:
        return case
    nd, itemsize = len(offsets), X.element_size()
    rate = F32_FLOP_PER_S if X.dtype == torch.float32 else F64_FLOP_PER_S
    nbytes = ((nd + 2 * P) if planes is None else len(set(planes)) * nd + 2 * P) * n * itemsize
    t_bound, by = bound(nbytes, 2 * nd * n * P, rate)
    Xf = X.reshape(P, n)
    if planes is None:
        A = banded_csr(torch, D, offsets, n)
        Xt = Xf.T.contiguous()

        def lib():
            return torch.sparse.mm(A, Xt)

        lib_y = lib().T
    else:
        A = block_banded_csr(torch, D[planes], offsets, n)
        Xv = Xf.reshape(-1)

        def lib():
            return torch.mv(A, Xv)

        lib_y = lib().reshape(P, n)
    lib_rel = float(((lib_y - Yr.reshape(P, n)).abs() / scale.reshape(P, n)).max())
    require(lib_rel <= 10 * tol, f"banded_spmv_batched {label}: the cuSPARSE yardstick computes "
            f"the same product ({lib_rel})")
    case.update({
        "ms": device_ms(torch, lambda: bd.banded_spmv_batched(X, D, offsets, n, planes)),
        "cold_ms": cold_device_ms(torch, lambda: bd.banded_spmv_batched(X, D, offsets, n, planes),
                                  flush),
        "one_problem_launches_ms": device_ms(torch, lambda: [one(p) for p in range(P)]),
        "one_problem_launches_cold_ms": cold_device_ms(torch, lambda: [one(p) for p in range(P)],
                                                       flush),
        "plain_ms": device_ms(torch, lambda: bd.banded_spmv_batched_reference(
            X, D, offsets, n, planes), reps=2, batches=2),
        "library_ms": device_ms(torch, lib), "library_rel_err": lib_rel,
        "library": ("torch.sparse.mm(sparse_csr_tensor, (n, P) block) (cuSPARSE SpMM)"
                    if planes is None else
                    "torch.mv(block-diagonal sparse_csr_tensor, x) (cuSPARSE SpMV)"),
        "bound_ms": t_bound, "bound_by": by, "bytes": nbytes,
    })
    return case


def check_laplacian_batched(torch, s1, P, n, dtype, gen, flush, timed=True):
    """Batched K4 against ``P`` one-problem launches and its plain version,
    bit for bit.  Timed: ms per batched launch warm and cold, the ``P``
    one-problem launches, the plain version, ``conv1d`` with ``P`` as the
    batch (cuDNN, TF32 off) and the bound by bytes, 2·P·n·itemsize."""
    X = torch.randn((P, n), generator=gen, device="cuda", dtype=dtype)
    Y = s1.laplacian_1d_flat_batched(X)
    Yr = s1.laplacian_1d_flat_batched_reference(X)
    torch.cuda.synchronize()
    same = all(torch.equal(Y[p], s1.laplacian_1d_flat(X[p])) for p in range(P))
    label = f"laplacian_1d_batched P={P} n={n} {dtype}"
    require(same and torch.equal(Y, Yr), f"{label}: bit-identical to one-problem launches and to "
            f"the plain version")
    case = {"P": P, "n": n, "dtype": str(dtype), "max_abs_err": float((Y - Yr).abs().max()),
            "bit_identical_to_one_problem_launches": same, "bit_equal_plain": True}
    if not timed:
        return case
    w = torch.tensor([-1.0, 2.0, -1.0], dtype=dtype, device="cuda").view(1, 1, 3)
    Xc = X.view(P, 1, n)

    def conv():
        return torch.nn.functional.conv1d(Xc, w, padding=1)

    sc = float(Yr.abs().max())
    lib_err = float((conv().view(P, n) - Yr).abs().max())
    tol = 1e-6 if dtype == torch.float32 else 1e-15
    require(lib_err <= 4 * tol * sc, f"{label}: the conv1d yardstick computes the same map")
    rate = F32_FLOP_PER_S if dtype == torch.float32 else F64_FLOP_PER_S
    nbytes = 2 * P * n * X.element_size()
    t_bound, by = bound(nbytes, 3 * n * P, rate)
    case.update({
        "ms": device_ms(torch, lambda: s1.laplacian_1d_flat_batched(X)),
        "cold_ms": cold_device_ms(torch, lambda: s1.laplacian_1d_flat_batched(X), flush),
        "one_problem_launches_ms": device_ms(
            torch, lambda: [s1.laplacian_1d_flat(X[p]) for p in range(P)]),
        "plain_ms": device_ms(torch, lambda: s1.laplacian_1d_flat_batched_reference(X), reps=3),
        "library_ms": device_ms(torch, conv), "library_err": lib_err,
        "library": "torch.nn.functional.conv1d, batch P (cuDNN, TF32 off)",
        "bound_ms": t_bound, "bound_by": by, "bytes": nbytes,
    })
    return case


def batched_linear_rhs(torch, np, shape, P, dev, seed=100):
    """Phase ``batched_linear``'s right-hand sides: ``b_0 = ones`` and ``b_p =
    ones + 0.05·normal`` from ``default_rng(seed + p)``, float32."""
    B = torch.empty((P,) + tuple(shape), dtype=torch.float32, device=dev)
    B[0] = 1
    for p in range(1, P):
        B[p] = torch.from_numpy((1 + 0.05 * np.random.default_rng(seed + p).standard_normal(shape))
                                .astype(np.float32))
    return B


class ApplyRecorder:
    """Within the block, counts the batched applies of
    ``solvers/batched.py:_Operators.apply_stack`` and
    ``apply_adjoint_stack`` that carry each problem (``per_problem``) and
    the applies (``calls``)."""

    NAMES = ("apply_stack", "apply_adjoint_stack")

    def __init__(self, batched_mod):
        self.cls, self.calls, self.per_problem = batched_mod._Operators, 0, {}

    def __enter__(self):
        self.inner = {name: getattr(self.cls, name) for name in self.NAMES}

        def recording(inner):
            def apply(ops, X, ps):
                self.calls += 1
                for p in ps:
                    self.per_problem[p] = self.per_problem.get(p, 0) + 1
                return inner(ops, X, ps)
            return apply

        for name, inner in self.inner.items():
            setattr(self.cls, name, recording(inner))
        return self

    def __exit__(self, *exc):
        for name, inner in self.inner.items():
            setattr(self.cls, name, inner)


def batched_linear_phase(torch, np, kt, _build, bd, s1, smi, nx=1024, n1=1 << 21, P=8, PP=4,
                         dev="cuda"):
    """Phase ``batched_linear``: ``P`` linear systems in one host loop per
    solve, each batched operator apply one batched K3 or K4 launch.

    (a) CG on config 2's banded 1024² Poisson (planes shared by the
    problems) with ``a0 = 0.5``; (b) MINRES on the same operator and shift;
    (c) BiCGStab on ``laplacian_1d_pallas(n1)`` (K4) with ``a0 = 0.5``,
    ``BiCGStab(tol=1e-3, maxiter=100)``; (d) CG on ``PP`` banded Poissons
    whose planes are scaled by ``1 + 0.1·p`` (a plane set per problem).
    Right-hand sides from :func:`batched_linear_rhs`.  (a), (b) and (d) run
    fixed work (tol 1e-30, 40 steps): at tol 5e-5 the noisy right-hand
    sides stall at the float32 floor of their true residual.  Each batched
    solve is driven once with the launch counts set to 0 just before it and
    read just after, its applies recorded per problem, then timed once more
    beside the one-problem solves.  Guards: (c) every problem converged
    with its true residual (the one-problem apply and norm) within tol, the
    others 40 steps each; counts equal to its one-problem solve's, ``x``
    within 1e-5 relative; on the card only the batched kernel launched,
    once per batched apply, each problem's applies equal to its
    ``numops``.  Then (e) the batched K3 (shared and per problem,
    float32 and float64, config 2's five offsets and config 4's three, P =
    8) and K4 (n = 2^21, P = 8) against one-problem launches and their plain
    versions, timed.  ``dev="cpu"`` with small ``nx`` and ``n1`` rehearses
    (a)-(d) with the plain versions: no launch guard, no kernel checks."""
    from krylovkit_tpu_torch.ops.operator import apply_shifted
    from krylovkit_tpu_torch.ops.vector import STANDARD, add
    from krylovkit_tpu_torch.solvers import batched as batched_mod
    from krylovkit_tpu_torch.solvers.bicgstab import linsolve_bicgstab
    from krylovkit_tpu_torch.solvers.cg import linsolve_cg
    from krylovkit_tpu_torch.solvers.minres import linsolve_minres

    t0 = time.perf_counter()
    card = dev != "cpu"
    n2 = nx * nx
    banded = kt.banded_from_coo(*poisson_coo(np, nx, np.float32), n2, device=dev)
    scaled = [kt.BandedOperator(banded.offsets, banded.diags * (1 + 0.1 * p), n2, nnz=banded.nnz)
              for p in range(PP)]
    lap = kt.laplacian_1d_pallas(n1, device=dev)
    B2 = batched_linear_rhs(torch, np, (n2 // 128, 128), P, dev)
    B1 = batched_linear_rhs(torch, np, (n1,), P, dev)
    quiet = {"verbosity": kt.SILENT}
    # CG and MINRES at tol 5e-5 stall on the noisy right-hand sides at the
    # float32 floor of their true residual (2.6e-4 and 1.4e-3 after 400
    # iterations on an H100), so they run fixed work: tol 1e-30, 40 steps
    fixed = {"tol": 1e-30, "maxiter": 40, **quiet}
    paths = [
        # (path, batched driver, one-problem driver, operator(s), op axis, B,
        #  algorithm, kernel, applies a step)
        ("cg_banded", kt.linsolve_cg_batched, linsolve_cg, banded, None, B2, kt.CG(**fixed),
         "banded_spmv", 1),
        ("minres_banded", kt.linsolve_minres_batched, linsolve_minres, banded, None, B2,
         kt.MINRES(**fixed), "banded_spmv", 1),
        ("bicgstab_laplacian_1d_pallas", kt.linsolve_bicgstab_batched, linsolve_bicgstab, lap,
         None, B1, kt.BiCGStab(tol=1e-3, maxiter=100, **quiet), "laplacian_1d", 2),
        ("cg_banded_per_problem", kt.linsolve_cg_batched, linsolve_cg, scaled, 0, B2[:PP],
         kt.CG(**fixed), "banded_spmv", 1),
    ]
    out = {"launches": {}}
    for path, batched, one, op, op_dim, B, alg, kernel, per_step in paths:
        Pn = B.shape[0]
        with ApplyRecorder(batched_mod) as rec:
            (x, info), first_ms, launches = _sync_ms(
                torch, _build, lambda: batched(op, B, torch.zeros_like(B), 0.5, 1.0, alg,
                                               in_dims=(op_dim, 0, 0)), dev)
        _, batched_ms, _ = _sync_ms(
            torch, _build, lambda: batched(op, B, torch.zeros_like(B), 0.5, 1.0, alg,
                                           in_dims=(op_dim, 0, 0)), dev)
        ones, one_ms, one_launches = [], [], []
        for p in range(Pn):
            opp = op[p] if op_dim == 0 else op
            (x1, i1), ms1, l1 = _sync_ms(torch, _build, lambda: one(
                opp, B[p], torch.zeros_like(B[p]), 0.5, 1.0, alg), dev)
            ones.append((x1, i1))
            one_ms.append(ms1)
            one_launches.append(l1)
        true_res, x_rel, bit_equal = [], 0.0, True
        for p, (x1, i1) in enumerate(ones):
            opp = op[p] if op_dim == 0 else op
            r = add(B[p], apply_shifted(opp, x[p], 0.5, 1.0), a=-1)
            true_res.append(float(STANDARD.norm(r)))
            x_rel = max(x_rel, float((x[p] - x1).abs().max() / x1.abs().max()))
            bit_equal = bit_equal and bool(torch.equal(x[p], x1))
        numops, numiter = info.numops.tolist(), info.numiter.tolist()
        start = 2 if path.startswith("minres") else 1  # MINRES's final residual
        least = start + per_step * max(numiter)
        verifications = sum(numops) - start * Pn - per_step * sum(numiter)
        rec_line = {
            "phase": "batched_linear", "path": path, "P": Pn, "n": B[0].numel(),
            "numops": numops, "numiter": numiter, "converged": info.converged.tolist(),
            "one_problem_numops": [i1.numops for _, i1 in ones],
            "one_problem_numiter": [i1.numiter for _, i1 in ones],
            "true_residual": true_res, "tol": alg.tol, "x_max_rel_diff_one_problem": x_rel,
            "x_bit_equal_one_problem": bit_equal, "launches": launches,
            "batched_applies": rec.calls, "applies_per_problem": rec.per_problem,
            "least_applies": least, "verification_applies_at_most": verifications,
            "one_problem_launches": one_launches, "first_solve_ms": first_ms,
            "batched_ms": batched_ms, "one_problem_ms": one_ms, "sum_one_problem_ms": sum(one_ms),
            "nvidia_smi": smi,
        }
        emit(rec_line)
        if alg.tol == fixed["tol"]:
            require(numiter == [fixed["maxiter"]] * Pn and info.converged.tolist() == [0] * Pn,
                    f"batched_linear {path}: fixed work, {fixed['maxiter']} steps each")
        else:
            require(info.converged.tolist() == [1] * Pn and max(true_res) <= alg.tol,
                    f"batched_linear {path}: every problem converged, true residual within "
                    f"{alg.tol} ({true_res})")
        require(numops == [i1.numops for _, i1 in ones] and numiter == [i1.numiter for _, i1 in ones],
                f"batched_linear {path}: counts equal to the one-problem solves")
        require(x_rel <= 1e-5, f"batched_linear {path}: x within 1e-5 of the one-problem solves "
                f"({x_rel})")
        require(rec.per_problem == {p: numops[p] for p in range(Pn)}
                and least <= rec.calls <= least + verifications,
                f"batched_linear {path}: each problem's batched applies equal its numops, "
                f"{least} to {least + verifications} applies ({rec.calls})")
        if card:
            require(launches == {f"{kernel}_batched": rec.calls},
                    f"batched_linear {path}: one {kernel}_batched launch per batched apply, no "
                    f"one-problem launch ({launches})")
            require(all(l1 == {kernel: i1.numops} for l1, (_, i1) in zip(one_launches, ones)),
                    f"batched_linear {path}: the one-problem solves launch {kernel} once per "
                    f"apply")
        out["launches"][path] = launches
        del x, ones
    del B1, B2
    if not card:
        return out

    # (e) the batched kernels at the paths' shapes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    flush = torch.empty(32 << 20, device="cuda")  # 128 MB, written to clear L2
    R2 = n2 // 128
    X = torch.randn((P, R2, 128), generator=gen, device="cuda")
    Dsets = torch.randn((P,) + tuple(banded.diags.shape), generator=gen, device="cuda")
    every = list(range(P))
    tri = kt.banded_from_coo(*tridiagonal_coo(np, n2, -1.3, 2.0, -0.7, np.float32), n2)
    k3 = [
        check_banded_batched(torch, bd, "poisson_2d shared f32", X, banded.diags, banded.offsets,
                             n2, None, flush),
        check_banded_batched(torch, bd, "poisson_2d per problem f32", X, Dsets, banded.offsets,
                             n2, every, flush),
        check_banded_batched(torch, bd, "transport-diffusion shared f32", X, tri.diags,
                             tri.offsets, n2, None, flush),
        check_banded_batched(torch, bd, "transport-diffusion per problem f32", X,
                             torch.randn((P,) + tuple(tri.diags.shape), generator=gen,
                                         device="cuda"), tri.offsets, n2, every, flush,
                             timed=False),
        check_banded_batched(torch, bd, "poisson_2d shared f64", X.double(),
                             banded.diags.double(), banded.offsets, n2, None, flush, timed=False),
        check_banded_batched(torch, bd, "poisson_2d per problem f64", X.double(), Dsets.double(),
                             banded.offsets, n2, every, flush, timed=False),
        check_banded_batched(torch, bd, "transport-diffusion shared f64", X.double(),
                             tri.diags.double(), tri.offsets, n2, None, flush, timed=False),
        check_banded_batched(torch, bd, "transport-diffusion per problem f64", X.double(),
                             torch.randn((P,) + tuple(tri.diags.shape), generator=gen,
                                         device="cuda", dtype=torch.float64), tri.offsets, n2,
                             every, flush, timed=False),
    ]
    del X, Dsets
    k4 = [check_laplacian_batched(torch, s1, P, n1, torch.float32, gen, flush),
          check_laplacian_batched(torch, s1, P, n1, torch.float64, gen, flush, timed=False)]
    del flush
    main3, pp3 = k3[0], k3[1]
    L = out["launches"]
    summary = {
        "banded_spmv": {
            "launches_batched_cg": L["cg_banded"].get("banded_spmv_batched", 0),
            "launches_batched_minres": L["minres_banded"].get("banded_spmv_batched", 0),
            "launches_batched_cg_per_problem": L["cg_banded_per_problem"].get(
                "banded_spmv_batched", 0),
            "ms_batched": main3["ms"], "cold_ms_batched": main3["cold_ms"],
            "bound_ms_batched": main3["bound_ms"], "library_ms_batched": main3["library_ms"],
            "plain_ms_batched": main3["plain_ms"],
            "one_problem_launches_ms_batched": main3["one_problem_launches_ms"],
            "one_problem_launches_cold_ms_batched": main3["one_problem_launches_cold_ms"],
            "ms_batched_per_problem": pp3["ms"], "cold_ms_batched_per_problem": pp3["cold_ms"],
            "bound_ms_batched_per_problem": pp3["bound_ms"],
            "library_ms_batched_per_problem": pp3["library_ms"],
            "ms_batched_config4": k3[2]["ms"], "bound_ms_batched_config4": k3[2]["bound_ms"],
            "max_abs_err_batched": max(c["max_abs_err"] for c in k3),
            "shapes_batched": f"P = {P}, banded poisson_2d(1024, 1024) f32, n = 2^20, 5 offsets",
        },
        "laplacian_1d": {
            "launches_batched_bicgstab": L["bicgstab_laplacian_1d_pallas"].get(
                "laplacian_1d_batched", 0),
            "ms_batched": k4[0]["ms"], "cold_ms_batched": k4[0]["cold_ms"],
            "bound_ms_batched": k4[0]["bound_ms"], "library_ms_batched": k4[0]["library_ms"],
            "plain_ms_batched": k4[0]["plain_ms"],
            "one_problem_launches_ms_batched": k4[0]["one_problem_launches_ms"],
            "max_abs_err_batched": max(c["max_abs_err"] for c in k4),
            "shapes_batched": f"P = {P}, n = 2^21 f32",
        },
    }
    emit({"phase": "batched_linear_kernels", "banded_spmv_batched": k3,
          "laplacian_1d_batched": k4, "summary": summary, "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0})
    out["kernels"] = summary
    return out


def round_launches(arn, _build, solve):
    """``solve()`` (a one-problem Krylov-Schur solve) with the launch counts
    set to 0 just before it and the counts of each round's expansion read at
    each call of ``solvers/arnoldi.py:_round``.  Returns ``(result, [launches
    of round r])``."""
    marks, real = [], arn._round

    def counting(*a, **kw):
        marks.append(dict(_build.launches))
        return real(*a, **kw)

    arn._round = counting
    _build.reset_launches()
    try:
        out = solve()
    finally:
        arn._round = real
    rounds = [{k: v - prev.get(k, 0) for k, v in now.items() if v - prev.get(k, 0)}
              for prev, now in zip([{}] + marks[:-1], marks)]
    return out, rounds


def batched_rounds_expected(per_problem, pairs):
    """The batched launches of a batched Krylov-Schur solve from its
    problems' one-problem rounds.  Every problem starts a round's expansion
    together and expands to the same top row, so its ``j``-th step of round
    ``r`` is its ``c - j``-th from the end (``c`` its launches of that
    round).  A batched apply or sweep launches once for every problem that
    steps: round ``r`` launches ``max_p c_p`` times.  A fused step
    (``fused_step``) launches once per distinct live-row count among the
    problems that step, and two problems step at one count exactly when
    their ``c`` are equal.  ``pairs`` maps a one-problem kernel name to its
    batched launcher's."""
    out = {}
    nrounds = max(len(r) for r in per_problem)
    for one, batched in pairs.items():
        total = 0
        for i in range(nrounds):
            cs = [r[i].get(one, 0) for r in per_problem if i < len(r)]
            total += (sum(len({c for c in cs if c > j}) for j in range(max(cs)))
                      if one == "fused_step" else max(cs))
        if total:
            out[batched] = total
    return out


def check_batched_projections(torch, pb, ks, R, kmax, gen, flush=None, timed=True):
    """Batched K5 and K6 for ``len(ks)`` problems (each its own basis
    ``(kmax, R, 128)``, rows ``>= k_p`` NaN: never read) against one-problem
    launches (every row bit for bit) and the plain versions (within
    1e-5·|V_j||w| and 1e-5·Σ|c_j||V_j|).  Timed: warm and cold ms per
    batched launch, the ``P`` one-problem launches, the plain version,
    ``torch.bmm`` over the ``(P, kmax_live, n)`` view and the bound
    (``Σ_p (k_p + 1)·n·4`` bytes)."""
    P, n = len(ks), R * 128
    V = torch.randn((P, kmax, R, 128), generator=gen, device="cuda")
    W = torch.randn((P, R, 128), generator=gen, device="cuda")
    C = torch.randn((P, kmax), generator=gen, device="cuda")
    for p, k in enumerate(ks):
        C[p, k:] = 0
    Vn = V.clone()
    for p, k in enumerate(ks):
        Vn[p, k:] = float("nan")
    got_c = pb.project_pallas_batched(Vn, W, ks)
    got_y = pb.unproject_pallas_batched(Vn, C, ks)
    want_c = pb.project_batched_reference(Vn, W, ks)
    want_y = pb.unproject_batched_reference(Vn, C, ks)
    torch.cuda.synchronize()
    label = f"batched projections P={P} R={R} k={ks if len(set(ks)) > 1 else ks[0]}"
    require(bool(torch.isfinite(got_c).all()) and bool(torch.isfinite(got_y).all()),
            f"{label}: rows >= k never read (no NaN)")
    same = all(torch.equal(got_c[p], pb.project_pallas(Vn[p], W[p], k))
               and torch.equal(got_y[p], pb.unproject_pallas(Vn[p], C[p], k))
               for p, k in enumerate(ks))
    require(same, f"{label}: every row bit-identical to a one-problem launch")
    err_c = err_y = 0.0
    for p, k in enumerate(ks):
        require(not bool(got_c[p, k:].any()), f"{label}: project zero beyond k")
        if k == 0:
            require(not bool(got_y[p].any()), f"{label}: unproject k = 0 gives zeros")
            continue
        Vk = V[p, :k].reshape(k, n)
        sc_c = torch.linalg.vector_norm(Vk, dim=1) * torch.linalg.vector_norm(W[p])
        sc_y = (C[p, :k].abs()[:, None] * Vk.abs()).sum(0).reshape(R, 128)
        d_c, d_y = (got_c[p] - want_c[p])[:k].abs(), (got_y[p] - want_y[p]).abs()
        require(bool((d_c <= 1e-5 * sc_c).all()), f"{label}: project within 1e-5*|V_j||w|")
        require(bool((d_y <= 1e-5 * sc_y).all()), f"{label}: unproject within 1e-5*sum|c_j||V_j|")
        err_c, err_y = max(err_c, float(d_c.max())), max(err_y, float(d_y.max()))
    case = {"P": P, "kmax": kmax, "n": n, "k": ks, "max_abs_err_project": err_c,
            "max_abs_err_unproject": err_y, "tolerance": "1e-5*|V_j||w|, 1e-5*sum_j|c_j||V_j|",
            "bit_identical_to_one_problem_launches": same}
    if timed:
        kl = max(ks)
        Vv, Wv = V.reshape(P, kmax, n)[:, :kl], W.reshape(P, n, 1)
        Cv = C[:, None, :kl]
        t_bound, by = bound(sum((k + 1) * n * 4 for k in ks), sum(2 * k * n for k in ks))
        for name, fn, one, plain, lib in (
                ("project", lambda: pb.project_pallas_batched(V, W, ks),
                 lambda: [pb.project_pallas(V[p], W[p], k) for p, k in enumerate(ks)],
                 lambda: pb.project_batched_reference(V, W, ks), lambda: torch.bmm(Vv, Wv)),
                ("unproject", lambda: pb.unproject_pallas_batched(V, C, ks),
                 lambda: [pb.unproject_pallas(V[p], C[p], k) for p, k in enumerate(ks)],
                 lambda: pb.unproject_batched_reference(V, C, ks), lambda: torch.bmm(Cv, Vv))):
            case[name] = {
                "ms": device_ms(torch, fn, reps=5),
                "cold_ms": cold_device_ms(torch, fn, flush) if flush is not None else None,
                "one_problem_launches_ms": device_ms(torch, one, reps=3),
                "plain_ms": device_ms(torch, plain, reps=1, batches=2),
                "library_ms": device_ms(torch, lib, reps=5),
                "library": (f"torch.bmm over the (P, {kl}, n) view" if name == "project" else
                            f"torch.bmm((P, 1, {kl}), (P, {kl}, n))"),
                "bound_ms": t_bound, "bound_by": by,
            }
    return case


def batched_arnoldi_phase(torch, np, kt, _build, arn, expi, kf, bs, pb, smi, n=1 << 20, P=4,
                          PK=8, dev="cuda"):
    """Phase ``batched_arnoldi``: config 4 for ``P`` starts
    (:func:`batched_starts`) in one host loop per solve.

    (a) ``schursolve_batched`` on the transport-diffusion stencil (4 "LM",
    krylovdim 30, fixed work: maxiter 3, tol 1e-30): batched K1 and K2;
    (b) ``eigsolve_arnoldi_batched`` on the same matrix as a
    ``BandedOperator`` with the projection flag on: batched K3, K5, K6, K2;
    (c) ``exponentiate_batched`` of the (1, −2, 1) chain (t = 0.1, tol
    1e-4, krylovdim 30): fused, batched K1; once more unfused with mgs2.
    Each batched solve is driven with the counts set to 0 just before it
    and read just after, and timed so (no second run: the phase's budget).
    Each problem's counts equal its one-problem solve's and its values are
    within 1e-5 of them (bit-identity reported); on (b) problems 0 and 1
    only, for the phase's budget.  The batched launches are exactly what
    the one-problem solves' rounds give (:func:`batched_rounds_expected`;
    on (b) what the batched solve's own steps give), and no one-problem K1,
    K2, K3, K5 or K6 is launched.  (d) the batched K5 and K6 alone at ``PK`` problems,
    kmax 31, at this width (:func:`check_batched_projections`, equal ``k``
    18 and 30 and mixed ``k``), untimed at ``P = 70`` (two launches) and
    with every ``k = 0``.  ``dev="cpu"`` with a small ``n`` rehearses
    (a)-(c) with the plain versions: no launch guard, no kernel checks."""
    t0 = time.perf_counter()
    card = dev != "cpu"
    R = n // 128
    m = KRYLOVDIM
    X = batched_starts(torch, np, R, P, dev)
    quiet = {"verbosity": kt.SILENT}
    alg = kt.Arnoldi(krylovdim=m, maxiter=3, tol=1e-30, **quiet)
    stencil = kt.StencilOperator((-1, 0, 1), (-1.3, 2.0, -0.7))
    banded = kt.banded_from_coo(*tridiagonal_coo(np, n, -1.3, 2.0, -0.7, np.float32), n,
                                device=dev)
    one_problem = {"fused_step", "transform_partial", "banded_spmv", "project", "unproject",
                   "laplacian_1d"}
    pairs = {"fused_step": "fused_step_batched", "banded_spmv": "banded_spmv_batched",
             "project": "project_batched", "unproject": "unproject_batched"}
    def solve_pair(path, batched_solve, one_solve, values, flag, compared):
        """The batched solve (counted and timed) and the one-problem solves
        of the problems ``compared`` (their rounds' launches), with the
        guards.  Where every problem is compared the batched launches must
        be what the one-problem rounds give; else what the batched solve's
        own steps give (one batched K3, two K5 and two K6 a ``cgs2`` step;
        each problem in as many steps as its ``numops``)."""
        steps, real = [], kf.expand_batched

        def recording(apply, states, *a, **kw):
            steps.append(sorted(states))
            return real(apply, states, *a, **kw)

        bs.use_pallas_projections = flag
        kf.expand_batched = recording
        try:
            res, batched_ms, launches = _sync_ms(torch, _build, batched_solve, dev)
            kf.expand_batched = real
            ones, rounds, one_ms = [], [], []
            for p in compared:
                t1 = time.perf_counter()
                r1, lr = round_launches(arn, _build, lambda p=p: one_solve(p))
                if card:
                    torch.cuda.synchronize()
                one_ms.append((time.perf_counter() - t1) * 1e3)
                ones.append(r1)
                rounds.append(lr)
        finally:
            kf.expand_batched = real
            bs.use_pallas_projections = False
        info = res[-1] if path != "schursolve_stencil_fused" else res[3]
        infos1 = [o[-1] if path != "schursolve_stencil_fused" else o[3] for o in ones]
        vals, vals1 = values(res), [values(o) for o in ones]
        rel = max(float(((vals[p] - v1).abs() / v1.abs().clamp_min(1e-30)).max())
                  for p, v1 in zip(compared, vals1))
        bits = all(torch.equal(vals[p], v1) for p, v1 in zip(compared, vals1))
        counts = [info.numops.tolist(), info.numiter.tolist(), info.converged.tolist()]
        counts1 = [[i.numops for i in infos1], [i.numiter for i in infos1],
                   [i.converged for i in infos1]]
        if len(compared) == P:
            want = batched_rounds_expected(rounds, pairs)
            want["transform_partial_batched"] = max(len(r) for r in rounds)
        else:
            want = {"banded_spmv_batched": len(steps), "transform_partial_batched":
                    max(counts[1])}
            if flag:
                want.update(project_batched=2 * len(steps), unproject_batched=2 * len(steps))
            require([sum(p in st for st in steps) for p in range(P)] == counts[0],
                    f"batched {path}: each problem in as many batched steps as its numops")
        rec = {"phase": "batched_arnoldi", "path": path, "P": P, "n": n, "projection_kernels": flag,
               "numops": counts[0], "numiter": counts[1], "converged": counts[2],
               "compared_problems": list(compared), "one_problem_counts": counts1,
               "abs_vals": vals.abs().cpu().tolist(), "one_problem_max_rel_diff": rel,
               "tolerance": 1e-5, "bit_identical": bits, "launches": launches,
               "expected_launches": want, "one_problem_launches_per_round": rounds,
               "batched_ms": batched_ms, "one_problem_ms": one_ms,
               "batched_over_one_problem_mean_times_P": batched_ms / (P * mean(one_ms)),
               "nvidia_smi": smi}
        emit(rec)
        require([[c[p] for p in compared] for c in counts] == counts1,
                f"batched {path}: each compared problem's counts equal its one-problem solve's "
                f"({counts} vs {counts1})")
        require(rel <= 1e-5, f"batched {path}: values within 1e-5 of the one-problem solves "
                f"({rel})")
        require(bool(torch.isfinite(vals).all()), f"batched {path}: finite values")
        if card:
            require(launches == want, f"batched {path}: exactly the expected batched launches "
                    f"({launches} vs {want})")
            require(not one_problem & set(launches), f"batched {path}: no one-problem K1, K2, "
                    f"K3, K5 or K6 launch ({launches})")
        return res, launches

    def schur_vals(res):
        return torch.complex(*res[2])

    (_, _, (re_a, im_a), _), _ = solve_pair(
        "schursolve_stencil_fused",
        lambda: kt.schursolve_batched(stencil, X, 4, "LM", alg),
        lambda p: arn.schursolve(stencil, X[p], 4, "LM", alg), schur_vals, False, range(P))
    lam = torch.hypot(re_a, im_a).cpu()
    require(bool((lam <= 4.0 + 1e-3).all()), f"batched schursolve: |lambda| inside the "
            f"Gershgorin disc: {lam.tolist()}")
    (vals_b, vecs_b, info_b), launches_b = solve_pair(
        "eigsolve_banded_projection_kernels",
        lambda: kt.eigsolve_arnoldi_batched(banded, X, 4, "LM", alg),
        lambda p: arn.eigsolve_arnoldi(banded, X[p], 4, "LM", alg), lambda res: res[0], True,
        range(2))  # the phase's budget: problems 0 and 1 only
    require(tuple(vecs_b.shape) == (P, 4, R, 128) and bool(torch.isfinite(vecs_b).all()),
            "batched eigsolve: finite (P, 4, R, 128) vectors")
    # the stencil and the banded matrix are one operator: the two paths agree
    agree = float(((vals_b.abs().cpu() - lam).abs() / lam).max())
    require(agree <= 1e-3, f"batched config 4: banded |lambda| within 1e-3 of the stencil's "
            f"({agree})")
    del vecs_b

    # (c) exponentiate: fused (batched K1), then unfused with mgs2
    neg = kt.StencilOperator((-1, 0, 1), (1.0, -2.0, 1.0))
    lalg = kt.Lanczos(krylovdim=m, tol=1e-4, **quiet)
    (ye, ie), ms_e, launches_e = _sync_ms(
        torch, _build, lambda: kt.exponentiate_batched(neg, 0.1, X, lalg), dev)
    ones, k1_one, one_ms = [], [], []
    for p in range(P):
        (y1, i1), ms1, l1 = _sync_ms(torch, _build, lambda p=p: expi._expintegrator_core(
            neg, 0.1, (X[p],), lalg, kt.STANDARD), dev)
        ones.append((y1, i1))
        k1_one.append(l1.get("fused_step", 0))
        one_ms.append(ms1)
    ualg = kt.Lanczos(krylovdim=m, tol=1e-4, orth=kt.mgs2, **quiet)
    (yu, iu), ms_u, launches_u = _sync_ms(
        torch, _build, lambda: kt.exponentiate_batched(neg, 0.1, X, ualg), dev)
    rel_e = max(float(torch.linalg.vector_norm(ye[p] - y1) / torch.linalg.vector_norm(y1))
                for p, (y1, _) in enumerate(ones))
    bits_e = all(torch.equal(ye[p], y1) for p, (y1, _) in enumerate(ones))
    rel_u = float(torch.linalg.vector_norm(yu - ye) / torch.linalg.vector_norm(ye))
    counts_e = [ie.numops.tolist(), ie.numiter.tolist(), ie.converged.tolist()]
    counts_e1 = [[i.numops for _, i in ones], [i.numiter for _, i in ones],
                 [i.converged for _, i in ones]]
    want_e = {"fused_step_batched": max(k1_one)} if card else {}
    rec = {"phase": "batched_arnoldi", "path": "exponentiate_stencil_fused", "P": P, "n": n,
           "numops": counts_e[0], "numiter": counts_e[1], "converged": counts_e[2],
           "normres": ie.normres.cpu().tolist(), "one_problem_counts": counts_e1,
           "one_problem_max_rel_diff": rel_e, "tolerance": 1e-5, "bit_identical": bits_e,
           "launches": launches_e, "expected_launches": want_e,
           "one_problem_fused_step": k1_one, "batched_ms": ms_e, "one_problem_ms": one_ms,
           "batched_over_one_problem_mean_times_P": ms_e / sum(one_ms),
           "unfused_mgs2": {"numops": iu.numops.tolist(), "numiter": iu.numiter.tolist(),
                            "ms": ms_u, "launches": launches_u,
                            "rel_diff_vs_fused": rel_u},
           "nvidia_smi": smi}
    emit(rec)
    require(counts_e == counts_e1, f"batched exponentiate: counts equal to the one-problem "
            f"solves ({counts_e} vs {counts_e1})")
    require(ie.converged.tolist() == [1] * P and bool((ie.normres <= 0.1 * 1e-4).all()),
            "batched exponentiate: every problem converged within t*tol")
    require(rel_e <= 1e-5, f"batched exponentiate: within 1e-5 of the one-problem solves "
            f"({rel_e})")
    require(rel_u <= 1e-4, f"batched exponentiate: unfused mgs2 within 1e-4 of fused ({rel_u})")
    if card:
        # one cycle each (numiter 1): a step launches once for all problems
        require(counts_e[1] == [1] * P and launches_e == want_e,
                f"batched exponentiate: one cycle each, exactly {want_e} ({launches_e})")
        require(launches_u == {}, f"batched exponentiate, unfused mgs2: no kernel ({launches_u})")
    del ye, yu, ones
    if not card:
        return {}

    # (d) the batched K5 and K6 alone at this width
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    kmax = m + 1
    flush = torch.empty(32 << 20, device="cuda")
    cases = [check_batched_projections(torch, pb, [k] * PK, R, kmax, gen, flush) for k in (18, 30)]
    cases.append(check_batched_projections(torch, pb, [30, 19, 25, 4, 16, 29, 1, 22][:PK], R,
                                           kmax, gen, flush))
    del flush
    small = [check_batched_projections(torch, pb, [(7 * i) % 14 for i in range(70)], 16, 13, gen,
                                       timed=False),
             check_batched_projections(torch, pb, [0] * 5, 16, 13, gen, timed=False)]
    emit({"phase": "batched_arnoldi_kernels", "cases": cases, "untimed": small,
          "nvidia_smi": smi, "seconds": time.perf_counter() - t0})

    def summary(name):
        timed = [c[name] for c in cases]
        return {key: mean([t[key] for t in timed]) for key in
                ("ms", "cold_ms", "one_problem_launches_ms", "plain_ms", "library_ms", "bound_ms")}

    return {"kernels": {
        name: {**summary(name),
               "max_abs_err": max(c[f"max_abs_err_{name}"] for c in cases + small),
               "launches": launches_b.get(f"{name}_batched", 0)}
        for name in ("project", "unproject")}}


def check_banded_adjoint_batched(torch, label, ops, X, shared):
    """The batched adjoint apply of ``solvers/batched.py:_Operators`` on
    banded operators with their adjoints (one operator for every row, or
    one per row): one ``banded_spmv_batched`` launch on the adjoint planes,
    each row bit-identical to ``op.apply_adjoint``."""
    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.solvers.batched import _Operators

    P = X.shape[0]
    batch = _Operators(ops, P, not shared)
    _build.reset_launches()
    Y = batch.apply_adjoint_stack(X, list(range(P)))
    launches = {k: v for k, v in _build.launches.items() if v}
    one = [(ops if shared else ops[p]).apply_adjoint(X[p]) for p in range(P)]
    torch.cuda.synchronize()
    same = all(torch.equal(Y[p], one[p]) for p in range(P))
    require(same, f"adjoint stack {label}: each row bit-identical to op.apply_adjoint")
    require(launches == {"banded_spmv_batched": 1},
            f"adjoint stack {label}: one banded_spmv_batched launch ({launches})")
    return {"case": label, "P": P, "launches": launches,
            "bit_identical_to_apply_adjoint": same}


def batched_gkl_phase(torch, np, kt, _build, svds, lss, bd, bs, fl, smi, rect=None,
                      rect_adj=None, nx=1024, P=4, PL=8, PL1=2, dev="cuda"):
    """Phase ``batched_gkl``: batched GKL ``svdsolve`` and batched LSMR
    ``lssolve`` at the widths of configs 3 and 2, ``P`` (``PL``) problems in
    one host loop per solve.

    (a) ``svdsolve_gkl_batched`` on the ``nx × nx`` advection-diffusion grid
    stencil of config 3, fused: starts phase 12's ``x0q`` and
    ``default_rng(100 + i)`` normals, 8 "LR", krylovdim 30, fixed work
    (maxiter 3, tol 1e-30); batched K1 over both stacks, batched K2.
    (b) the same starts through config 3's rectangular ``(rect, rect_adj)``
    map (rows ``2·nx²``, columns ``nx²``), projection flag on: the applies
    per problem (a callable), batched K5 and K6 on both stacks, batched K2.
    (c) ``lssolve_lsmr_batched`` on config 2's banded Poisson (kernel-backed,
    with its adjoint) for phase 31's ``PL`` right-hand sides, 40 iterations
    (tol 1e-30): each batched apply, normal or adjoint, one
    ``banded_spmv_batched`` launch.

    Each batched solve is driven once with the launch counts set to 0 just
    before it and read just after, then timed once more; then the one-problem
    solves (all problems on (a) and (b), the first ``PL1`` on (c)), each
    with its rounds' launches.  Guards: each compared problem's counts equal
    its one-problem solve's, its values, singular vectors (solution and
    residual) bit-identical; exactly the batched launches the one-problem
    rounds give (:func:`batched_rounds_expected`; K2 twice a round) and no
    one-problem K1, K2, K3, K5 or K6; on (c) each problem's batched applies
    equal its ``numops``.  The true residuals ``‖A v_i − σ_i u_i‖`` are
    printed.  (d) the batched K1 on the stencil's adjoint spec at ``B = 0``
    and at mixed ``B`` (one launch per ``B``), and the batched K3 on the
    Poisson's adjoint planes (shared, and a set per problem).
    ``dev="cpu"`` with a small ``nx`` rehearses (a)-(c) with the plain
    versions: no launch guard, no kernel checks."""
    from krylovkit_tpu_torch.solvers import batched as batched_mod

    t0 = time.perf_counter()
    card = dev != "cpu"
    m = KRYLOVDIM
    quiet = {"verbosity": kt.SILENT}
    R = nx * nx // 128
    X = batched_starts(torch, np, R, P, dev)
    X[0] = torch.from_numpy(np.random.default_rng(2).standard_normal((R, 128))
                            .astype(np.float32))
    advect = kt.GridStencilOperator((nx, nx), ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
                                    (4.0, -1.5, -0.5, -1.2, -0.8))
    if rect is None:
        C = nx * nx // 2
        wr = torch.from_numpy(np.linspace(1.0, 3.0, C, dtype=np.float32)
                              .reshape(C // 128, 128)).to(dev)

        def rect(x):
            wx = wr * x
            return torch.cat([wx, 0.5 * torch.roll(wx, 1, dims=0)], dim=0)

        def rect_adj(y):
            return wr * y[: C // 128] + 0.5 * wr * torch.roll(y[C // 128:], -1, dims=0)

    alg = kt.GKL(krylovdim=m, maxiter=3, tol=1e-30, **quiet)
    one_problem = {"fused_step", "transform_partial", "banded_spmv", "project", "unproject"}
    pairs = {"fused_step": "fused_step_batched", "project": "project_batched",
             "unproject": "unproject_batched"}
    out = {"launches": {}}

    def svd_path(path, op, flag):
        bs.use_pallas_projections = flag
        try:
            (S, U, W, info), first_ms, launches = _sync_ms(
                torch, _build, lambda: kt.svdsolve_gkl_batched(op, X, 8, "LR", alg), dev)
            _, batched_ms, _ = _sync_ms(
                torch, _build, lambda: kt.svdsolve_gkl_batched(op, X, 8, "LR", alg), dev)
            one_op = kt.ops.operator.as_operator(op)
            ones, rounds, one_ms = [], [], []
            for p in range(P):
                t1 = time.perf_counter()
                r1, lr = round_launches(svds, _build, lambda p=p: svds.svdsolve_gkl(
                    one_op, X[p], 8, "LR", alg))
                if card:
                    torch.cuda.synchronize()
                one_ms.append((time.perf_counter() - t1) * 1e3)
                ones.append(r1)
                rounds.append(lr)
        finally:
            bs.use_pallas_projections = False
        counts = [info.numops.tolist(), info.numiter.tolist(), info.converged.tolist()]
        counts1 = [[o[3].numops for o in ones], [o[3].numiter for o in ones],
                   [o[3].converged for o in ones]]
        diff = max(max(float((a[p] - o[i]).abs().max()) for p, o in enumerate(ones))
                   for i, a in enumerate((S, U, W)))
        bits = all(torch.equal(S[p], o[0]) and torch.equal(U[p], o[1]) and torch.equal(W[p], o[2])
                   and torch.equal(info.residual[p], o[3].residual) for p, o in enumerate(ones))
        true_res = [[float(torch.linalg.vector_norm(one_op.normal(W[p, i]) - S[p, i] * U[p, i]))
                     for i in range(3)] for p in range(P)]
        want = batched_rounds_expected(rounds, pairs)
        want["transform_partial_batched"] = 2 * max(len(r) for r in rounds)
        rec = {"phase": "batched_gkl", "path": path, "P": P, "n": R * 128,
               "projection_kernels": flag, "numops": counts[0], "numiter": counts[1],
               "converged": counts[2], "one_problem_counts": counts1,
               "svals": S.cpu().tolist(), "normres_leading_3": info.normres[:, :3].cpu().tolist(),
               "true_residual_leading_3": true_res, "one_problem_max_abs_diff": diff,
               "bit_identical": bits, "launches": launches, "expected_launches": want,
               "one_problem_launches_per_round": rounds, "first_batched_ms": first_ms,
               "batched_ms": batched_ms, "one_problem_ms": one_ms, "batched_over_sum_of_one_problem": batched_ms / sum(one_ms),
               "nvidia_smi": smi}
        emit(rec)
        require(counts == counts1, f"batched_gkl {path}: each problem's counts equal its "
                f"one-problem solve's ({counts} vs {counts1})")
        require(counts[0] == [2 * (m + 2 * (m - 18))] * P and counts[1] == [3] * P,
                f"batched_gkl {path}: 3 rounds, 2*(30 + 12 + 12) applies each ({counts})")
        require(bits, f"batched_gkl {path}: values, singular vectors and residuals bit-identical "
                f"to the one-problem solves (max diff {diff})")
        S_h = S.cpu()
        require(bool(torch.isfinite(S_h).all()) and bool((S_h[:, :-1] >= S_h[:, 1:]).all())
                and tuple(U.shape) == (P, 8) + tuple(X.shape[1:]) and bool(torch.isfinite(U).all())
                and bool(torch.isfinite(W).all()),
                f"batched_gkl {path}: finite descending values, finite vectors of the expected shape")
        nr = info.normres.cpu()
        require(all(true_res[p][i] <= float(nr[p, i]) + 1e-3 * float(S_h[p, 0])
                    for p in range(P) for i in range(3)),
                f"batched_gkl {path}: |A v - sigma u| of the leading triplets within normres + "
                f"1e-3 sigma_0 ({true_res})")
        if card:
            require(launches == want, f"batched_gkl {path}: exactly the batched launches the "
                    f"one-problem rounds give ({launches} vs {want})")
            require(not one_problem & set(launches), f"batched_gkl {path}: no one-problem K1, K2, "
                    f"K3, K5 or K6 launch ({launches})")
        out["launches"][path] = launches
        return S_h

    S_a = svd_path("svdsolve_advect_fused", advect, False)
    S_b = svd_path("svdsolve_rect_projection_kernels", (rect, rect_adj), True)

    # (c) LSMR on the banded Poisson, normal and adjoint applies batched
    n2 = nx * nx
    banded = kt.banded_from_coo(*poisson_coo(np, nx, np.float32), n2, device=dev)
    Bl = batched_linear_rhs(torch, np, (R, 128), PL, dev)
    lalg = kt.LSMR(maxiter=40, tol=1e-30, **quiet)
    with ApplyRecorder(batched_mod) as rec_l:
        (xl, il), first_ms_l, launches_l = _sync_ms(
            torch, _build, lambda: kt.lssolve_lsmr_batched(banded, Bl, lalg), dev)
    _, ms_l, _ = _sync_ms(torch, _build, lambda: kt.lssolve_lsmr_batched(banded, Bl, lalg), dev)
    ones_l, one_ms_l, one_launches_l = [], [], []
    for p in range(PL1):
        (x1, i1), ms1, l1 = _sync_ms(torch, _build, lambda p=p: lss.lssolve_lsmr(banded, Bl[p],
                                                                                  lalg), dev)
        ones_l.append((x1, i1))
        one_ms_l.append(ms1)
        one_launches_l.append(l1)
    numops_l = il.numops.tolist()
    bits_l = all(torch.equal(xl[p], x1) and torch.equal(il.residual[p], i1.residual)
                 and torch.equal(il.normres[p], i1.normres) for p, (x1, i1) in enumerate(ones_l))
    diff_l = max(float((xl[p] - x1).abs().max()) for p, (x1, _) in enumerate(ones_l))
    true_res_l = [float(torch.linalg.vector_norm(
        banded.apply_adjoint(Bl[p] - banded.normal(xl[p])))) for p in range(PL)]
    want_l = {"banded_spmv_batched": 1 + 2 * lalg.maxiter}
    emit({"phase": "batched_gkl", "path": "lssolve_lsmr_banded", "P": PL, "n": n2,
          "numops": numops_l, "numiter": il.numiter.tolist(), "converged": il.converged.tolist(),
          "normres": il.normres.cpu().tolist(), "true_normal_equation_residual": true_res_l,
          "compared_problems": list(range(PL1)),
          "one_problem_counts": [[i1.numops for _, i1 in ones_l], [i1.numiter for _, i1 in ones_l]],
          "one_problem_max_abs_diff": diff_l, "bit_identical": bits_l, "launches": launches_l,
          "expected_launches": want_l, "applies": rec_l.calls,
          "applies_per_problem": rec_l.per_problem, "one_problem_launches": one_launches_l,
          "first_batched_ms": first_ms_l, "batched_ms": ms_l, "one_problem_ms": one_ms_l,
          "batched_over_one_problem_mean_times_P": ms_l / (PL * mean(one_ms_l)),
          "nvidia_smi": smi})
    require(numops_l == [1 + 2 * lalg.maxiter] * PL and il.numiter.tolist() == [lalg.maxiter] * PL,
            f"batched_gkl lssolve: 40 iterations, 81 applies each ({numops_l})")
    require([numops_l[p] for p in range(PL1)] == [i1.numops for _, i1 in ones_l]
            and [il.numiter[p].item() for p in range(PL1)] == [i1.numiter for _, i1 in ones_l],
            "batched_gkl lssolve: counts equal to the one-problem solves")
    require(bits_l, f"batched_gkl lssolve: x, residual and normres bit-identical to the "
            f"one-problem solves (max diff {diff_l})")
    require(rec_l.per_problem == {p: numops_l[p] for p in range(PL)}
            and rec_l.calls == 1 + 2 * lalg.maxiter,
            f"batched_gkl lssolve: each problem's batched applies equal its numops "
            f"({rec_l.per_problem}, {rec_l.calls} applies)")
    require(bool(torch.isfinite(xl).all()) and tuple(xl.shape) == (PL, R, 128),
            "batched_gkl lssolve: finite (P, R, 128) solutions")
    if card:
        require(launches_l == want_l, f"batched_gkl lssolve: one banded_spmv_batched launch per "
                f"batched apply, no one-problem launch ({launches_l})")
        require(all(l1 == {"banded_spmv": i1.numops} for l1, (_, i1) in zip(one_launches_l, ones_l)),
                "batched_gkl lssolve: the one-problem solves launch banded_spmv once per apply")
    out["launches"]["lssolve_lsmr_banded"] = launches_l
    del xl, ones_l
    if not card:
        return out

    # (d) the batched K1 on the adjoint spec at B = 0 and mixed B, and the
    # batched K3 on adjoint planes, at this width
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    kmax = m + 1
    k1 = [check_batched_step(torch, fl, advect, P, R, kmax, 0, True, gen, adjoint=True),
          check_batched_step(torch, fl, advect, P, R, kmax, 0, True, gen),
          check_batched_step(torch, fl, advect, P, R, kmax, 18, True, gen, adjoint=True),
          check_batched_step(torch, fl, advect, P, R, kmax, [0, 19, 12, 29][:P], True, gen,
                             timed=False, adjoint=True),
          check_batched_step(torch, fl, advect, P, R, kmax, [19, 12, 19, 0][:P], True, gen,
                             timed=False, adjoint=True, grouped=True)]
    Xk = torch.randn((P, R, 128), generator=gen, device="cuda")
    # config 4's non-symmetric tridiagonal, its lower band scaled per problem:
    # adjoint planes that differ from the normal ones
    tri = [kt.banded_from_coo(*tridiagonal_coo(np, n2, -1.3 * (1 + 0.1 * p), 2.0, -0.7,
                                               np.float32), n2) for p in range(P)]
    k3 = [check_banded_adjoint_batched(torch, "poisson_2d shared", banded, Xk, True),
          check_banded_adjoint_batched(torch, "transport-diffusion shared", tri[0], Xk, True),
          check_banded_adjoint_batched(torch, "transport-diffusion per problem", tri, Xk,
                                       False),
          check_banded_batched(torch, bd, "transport-diffusion adjoint planes shared f32", Xk,
                               tri[0].adj.diags, tri[0].adj.offsets, n2, None, None,
                               timed=False)]
    emit({"phase": "batched_gkl_kernels", "fused_step_batched": k1, "banded_spmv_batched": k3,
          "nvidia_smi": smi, "seconds": time.perf_counter() - t0})
    L = out["launches"]
    out["kernels"] = {
        "fused_step": {"launches_batched_gkl_svdsolve_advect":
                       L["svdsolve_advect_fused"].get("fused_step_batched", 0),
                       **{f"{key}_batched_gkl_adjoint_B{B}": case[key]
                          for B, case in ((0, k1[0]), (18, k1[2]))
                          for key in ("ms", "one_problem_launches_ms", "plain_ms", "bound_ms")}},
        "transform_partial": {f"launches_batched_gkl_{k}": L[k].get("transform_partial_batched", 0)
                              for k in ("svdsolve_advect_fused",
                                        "svdsolve_rect_projection_kernels")},
        "banded_spmv": {"launches_batched_gkl_lssolve":
                        L["lssolve_lsmr_banded"].get("banded_spmv_batched", 0)},
        "project": {"launches_batched_gkl_svdsolve_rect":
                    L["svdsolve_rect_projection_kernels"].get("project_batched", 0)},
        "unproject": {"launches_batched_gkl_svdsolve_rect":
                      L["svdsolve_rect_projection_kernels"].get("unproject_batched", 0)},
    }
    return out


def batched_geneig_bieig_phase(torch, np, kt, _build, bd, bs, smi, pencil=None, tri=None,
                               N=1024, n4=1 << 20, P=4, PB=4, dev="cuda"):
    """Phase ``batched_geneig_bieig``: batched Golub-Ye ``geneigsolve`` and
    batched BiArnoldi ``bieigsolve`` at the widths of phases 14 and 20, one
    host loop per solve.

    (a) ``geneigsolve_golubye_batched`` on the ``N × N`` Q1 pencil (K and M
    two shared float32 banded operators, nine offsets each) for ``P``
    starts (phase 14's ``default_rng(4)`` and ``default_rng(100 + p)``), 4
    "SR", krylovdim 30, maxiter 8, tol 1e-30 (fixed work), the projection
    flag off, then on.  (b) ``bieigsolve_batched`` on config 4's
    tridiagonal (n = ``n4``, its adjoint planes) for ``PB`` start pairs
    (phase 20's ``default_rng(1)``/``(10)`` and ``default_rng(100 + p)`` /
    ``(110 + p)``), 4 "LM", krylovdim 30, tol 1e-30, the flag on, maxiter 2
    (cut from phase 20's 8: a dense round costs ~0.3 s a problem).

    Each batched solve is driven once with the launch counts set to 0 just
    before it and read just after, and its applies recorded
    (:class:`ApplyRecorder`); then the one-problem solves (all ``P`` on
    (a), problems 0 and 1 on (b)), each with its launches.  Guards: (a)
    every problem 240 / 8, 480 batched K3 (two a batched pencil apply, each
    problem's batched pencil applies 240), with the flag K5 = K6 =
    :func:`golubye_sweeps` batched, each value within 1e-4 of its vector's
    Rayleigh quotient; (b) ``numiter`` 2, ``numops`` even in
    2·(30 + 12)..2·(30 + 18), batched K3 = the largest ``numops`` (each
    problem's batched applies its ``numops``), batched K5/K6 as
    :func:`bieig_predicted_projections` on the batch's lock-steps, every
    ``|λ| <= 4 + ‖A v − λ v‖/‖v‖``; on both, the compared problems' counts
    equal their one-problem solves', problems 0 and 1 bit-identical, and no
    one-problem K3, K5 or K6.  Then the batched K3 on the pencil's two
    plane sets at ``P`` (:func:`check_banded_batched`, timed).  ``pencil``
    (phase 14's ``(K, M)``) and ``tri`` (phase 20's operator) are built
    here when not given.  ``dev="cpu"`` with a small ``N`` and ``n4``
    rehearses (a) and (b) with the plain versions: no launch guard, no
    kernel check."""
    from krylovkit_tpu_torch.solvers import batched as batched_mod

    t0 = time.perf_counter()
    card = dev != "cpu"
    n = N * N
    R = n // 128
    if pencil is None:
        pencil = [kt.banded_from_coo(*c, n, device=dev) for c in q1_coo(np, N, N, np.float32)]
    Kb, Mb = pencil
    X = torch.empty((P, R, 128), dtype=torch.float32, device=dev)
    for p in range(P):
        X[p] = torch.from_numpy(np.random.default_rng(4 if p == 0 else 100 + p)
                                .standard_normal((R, 128)).astype(np.float32))
    alg = kt.GolubYe(krylovdim=30, maxiter=8, tol=1e-30, verbosity=kt.SILENT)
    one_problem = {"banded_spmv", "project", "unproject"}
    out = {"launches": {}}

    for path, flag in (("geneigsolve_golubye_q1", False), ("geneigsolve_golubye_q1_proj", True)):
        bs.use_pallas_projections = flag
        try:
            with ApplyRecorder(batched_mod) as rec:
                (vals, vecs, info), ms, launches = _sync_ms(
                    torch, _build, lambda: kt.geneigsolve_golubye_batched(Kb, Mb, X, 4, "SR", alg),
                    dev)
            ones, one_ms, one_launches = [], [], []
            for p in range(P):
                o, ms1, l1 = _sync_ms(torch, _build, lambda p=p: kt.geneigsolve(
                    (Kb, Mb), X[p], 4, "SR", alg=alg), dev)
                ones.append(o)
                one_ms.append(ms1)
                one_launches.append(l1)
        finally:
            bs.use_pallas_projections = False
        counts = [info.numops.tolist(), info.numiter.tolist(), info.converged.tolist()]
        counts1 = [[o[2].numops for o in ones], [o[2].numiter for o in ones],
                   [o[2].converged for o in ones]]
        bits = [torch.equal(vals[p], o[0]) and torch.equal(vecs[p], o[1])
                and torch.equal(info.normres[p], o[2].normres)
                and torch.equal(info.residual[p], o[2].residual) for p, o in enumerate(ones)]
        diff = [max(float((vals[p] - o[0]).abs().max()), float((vecs[p] - o[1]).abs().max()))
                for p, o in enumerate(ones)]
        rq_err = []
        for p in range(P):
            for i in range(4):
                v = vecs[p, i].double()
                kv = bd.banded_spmv_reference(v, Kb.diags.double(), Kb.offsets, n)
                mv = bd.banded_spmv_reference(v, Mb.diags.double(), Mb.offsets, n)
                rq = float(torch.sum(v * kv) / torch.sum(v * mv))
                rq_err.append(abs(rq - float(vals[p, i])) / abs(float(vals[p, i])))
        sw = golubye_sweeps(240, 8)
        want = {"banded_spmv_batched": 2 * 240}
        want1 = {"banded_spmv": 2 * 240}
        if flag:
            want.update(project_batched=sw, unproject_batched=sw)
            want1.update(project=sw, unproject=sw)
        emit({"phase": "batched_geneig_bieig", "path": path, "P": P, "n": n,
              "projection_kernels": flag, "numops": counts[0], "numiter": counts[1],
              "converged": counts[2], "one_problem_counts": counts1,
              "vals": vals.cpu().tolist(), "rayleigh_rel_err_max": max(rq_err),
              "bit_identical": bits, "one_problem_max_abs_diff": diff, "launches": launches,
              "expected_launches": want, "one_problem_launches": one_launches,
              "batched_applies": rec.calls, "pencil_applies_per_problem":
              {p: c // 2 for p, c in rec.per_problem.items()},
              "batched_ms": ms, "one_problem_ms": one_ms, "one_problem_ms_sum": sum(one_ms),
              "batched_over_sum_of_one_problem": ms / sum(one_ms), "nvidia_smi": smi})
        require(counts[0] == [240] * P and counts[1] == [8] * P,
                f"batched_geneig {path}: every problem 240 / 8 ({counts})")
        require(counts == counts1, f"batched_geneig {path}: each problem's counts equal its "
                f"one-problem solve's ({counts} vs {counts1})")
        require(all(bits[:2]), f"batched_geneig {path}: problems 0 and 1 bit-identical to their "
                f"one-problem solves ({bits}, max diff {diff})")
        require(max(rq_err) <= 1e-4, f"batched_geneig {path}: each value within 1e-4 of its "
                f"vector's Rayleigh quotient ({max(rq_err)})")
        require(bool(torch.isfinite(vecs).all()) and tuple(vecs.shape) == (P, 4, R, 128),
                f"batched_geneig {path}: finite (P, 4, R, 128) vectors")
        require(rec.calls == 2 * 240 and rec.per_problem == {p: 2 * 240 for p in range(P)},
                f"batched_geneig {path}: one batched apply of K and one of M per pencil apply, "
                f"240 a problem ({rec.calls}, {rec.per_problem})")
        if card:
            require(launches == want, f"batched_geneig {path}: launches {launches}, expected "
                    f"{want} (K3 twice a batched pencil apply; with the flag K5 = K6 = "
                    f"2(numops + numiter - 1))")
            require(not one_problem & set(launches), f"batched_geneig {path}: no one-problem K3, "
                    f"K5 or K6 ({launches})")
            require(all(l1 == want1 for l1 in one_launches), f"batched_geneig {path}: the "
                    f"one-problem solves launch {want1} ({one_launches})")
        out["launches"][path] = launches
        del vals, vecs, info, ones

    # (b) the two-sided solves, the projection flag on
    nb = n4
    Rb = nb // 128
    op = tri if tri is not None else kt.banded_from_coo(
        *tridiagonal_coo(np, nb, -1.3, 2.0, -0.7, np.float32), nb, device=dev)
    V0 = torch.empty((PB, Rb, 128), dtype=torch.float32, device=dev)
    W0 = torch.empty_like(V0)
    for p in range(PB):
        for Y, seed in ((V0, 1 if p == 0 else 100 + p), (W0, 10 if p == 0 else 110 + p)):
            Y[p] = torch.from_numpy(np.random.default_rng(seed).standard_normal((Rb, 128))
                                    .astype(np.float32))
    balg = kt.BiArnoldi(krylovdim=30, maxiter=2, tol=1e-30, verbosity=kt.SILENT)
    bs.use_pallas_projections = True
    try:
        with ApplyRecorder(batched_mod) as rec:
            (vals, (Vv, Ww), (iV, iW)), ms_b, launches_b = _sync_ms(
                torch, _build, lambda: kt.bieigsolve_batched(op, V0, W0, 4, "LM", balg), dev)
        ones, one_ms, one_launches = [], [], []
        for p in range(2):
            o, ms1, l1 = _sync_ms(torch, _build, lambda p=p: kt.bieigsolve(
                op, V0[p], W0[p], 4, "LM", alg=balg), dev)
            ones.append(o)
            one_ms.append(ms1)
            one_launches.append(l1)
    finally:
        bs.use_pallas_projections = False
    numops = iV.numops.tolist()
    bits = [torch.equal(vals[p], o[0]) and torch.equal(Vv[p], o[1][0])
            and torch.equal(Ww[p], o[1][1])
            and all(torch.equal(b.residual[p], i1.residual)
                    and torch.equal(b.normres[p], i1.normres) for b, i1 in zip((iV, iW), o[2]))
            for p, o in enumerate(ones)]
    diff = [float((vals[p] - o[0]).abs().max()) for p, o in enumerate(ones)]
    lam = vals.detach().cpu()
    vn = torch.linalg.vector_norm(Vv.reshape(PB, 4, -1), dim=2)
    res = torch.stack([torch.stack([torch.linalg.vector_norm(
        op.normal(Vv[p, i].real) + 1j * op.normal(Vv[p, i].imag) - vals[p, i] * Vv[p, i])
        for i in range(4)]) for p in range(PB)])
    bound_l = (4.0 + res / vn).cpu()
    k5, k6 = bieig_predicted_projections(max(numops), 2)
    want_b = {"banded_spmv_batched": max(numops), "project_batched": k5, "unproject_batched": k6}
    want1 = [dict(zip(("project", "unproject"), bieig_predicted_projections(numops[p], 2)),
                  banded_spmv=numops[p]) for p in range(2)]
    one_mean = mean(one_ms)
    emit({"phase": "batched_geneig_bieig", "path": "bieigsolve_nonsym_banded_proj", "P": PB,
          "n": nb, "projection_kernels": True, "maxiter": 2, "numops": numops,
          "numiter": iV.numiter.tolist(), "converged": iV.converged.tolist(),
          "one_problem_counts": [[o[2][0].numops for o in ones], [o[2][0].numiter for o in ones]],
          "abs_vals": lam.abs().tolist(), "true_residual_over_norm": (res / vn).cpu().tolist(),
          "bit_identical": bits, "one_problem_max_abs_diff": diff, "launches": launches_b,
          "expected_launches": want_b, "one_problem_launches": one_launches,
          "batched_applies": rec.calls, "applies_per_problem": rec.per_problem,
          "batched_ms": ms_b, "one_problem_ms": one_ms,
          "batched_over_one_problem_mean_times_P": ms_b / (PB * one_mean), "nvidia_smi": smi})
    require(iV.numiter.tolist() == [2] * PB and iW.numiter.tolist() == [2] * PB,
            f"batched_bieig: 2 iterations each ({iV.numiter.tolist()})")
    require(all(c % 2 == 0 and 84 <= c <= 96 for c in numops),
            f"batched_bieig: numops even, in 2*(30 + 12)..2*(30 + 18) ({numops})")
    require([numops[p] for p in range(2)] == [o[2][0].numops for o in ones],
            "batched_bieig: problems 0 and 1's counts equal their one-problem solves'")
    require(all(bits), f"batched_bieig: problems 0 and 1 bit-identical to their one-problem "
            f"solves ({bits}, max diff {diff})")
    require(bool(torch.isfinite(lam.abs()).all()) and bool((lam.abs() <= bound_l + 1e-3).all()),
            f"batched_bieig: |lambda| <= 4 + |A v - lambda v|/|v| ({lam.abs().tolist()} vs "
            f"{bound_l.tolist()})")
    require(tuple(Vv.shape) == tuple(Ww.shape) == (PB, 4, Rb, 128)
            and bool(torch.isfinite(Vv).all()) and bool(torch.isfinite(Ww).all()),
            "batched_bieig: finite (P, 4, R, 128) vectors")
    require(rec.per_problem == dict(enumerate(numops)) and rec.calls == max(numops),
            f"batched_bieig: each problem's batched applies equal its numops, one normal and one "
            f"adjoint batched apply a lock-step ({rec.per_problem}, {rec.calls})")
    if card:
        require(launches_b == want_b, f"batched_bieig: launches {launches_b}, predicted {want_b}")
        require(all(l1 == w1 for l1, w1 in zip(one_launches, want1)),
                f"batched_bieig: the one-problem solves launch {want1} ({one_launches})")
    out["launches"]["bieigsolve_nonsym_banded_proj"] = launches_b
    del vals, Vv, Ww, iV, iW, ones, op, V0, W0
    if not card:
        return out

    # the batched K3 on the pencil's two nine-offset plane sets at P
    flush = torch.empty(32 << 20, device=dev)  # 128 MB, written to clear L2
    k3 = [check_banded_batched(torch, bd, f"Q1 {name} f32, 9 offsets, shared, P={P}", X,
                               o.diags, o.offsets, n, None, flush)
          for name, o in (("K", Kb), ("M", Mb))]
    del flush
    seconds = time.perf_counter() - t0
    emit({"phase": "batched_geneig_bieig_kernels", "banded_spmv_batched": k3, "nvidia_smi": smi,
          "phase_seconds": seconds})
    L = out["launches"]
    out["kernels"] = {
        "banded_spmv": {
            "launches_batched_geneig_q1": L["geneigsolve_golubye_q1"]["banded_spmv_batched"],
            "launches_batched_geneig_q1_proj":
            L["geneigsolve_golubye_q1_proj"]["banded_spmv_batched"],
            "launches_batched_bieig": L["bieigsolve_nonsym_banded_proj"]["banded_spmv_batched"],
            **{f"{key}_batched_q1_{name}_P{P}": case[key]
               for name, case in zip("KM", k3)
               for key in ("ms", "cold_ms", "one_problem_launches_ms",
                           "one_problem_launches_cold_ms", "plain_ms", "library_ms",
                           "bound_ms")}},
        **{name: {"launches_batched_geneig_q1_proj":
                  L["geneigsolve_golubye_q1_proj"][f"{name}_batched"],
                  "launches_batched_bieig": L["bieigsolve_nonsym_banded_proj"][f"{name}_batched"]}
           for name in ("project", "unproject")},
    }
    return out


def batched_block_lanczos_phase(torch, np, kt, _build, bd, bs, smi, banded=None, N=1024, P=4,
                                dev="cuda"):
    """Phase ``batched_block_lanczos``: batched Block Lanczos
    (``eigsolve_blocklanczos_batched``) at phase 15's width, one host loop
    per solve: config 2's Poisson matrix of the ``N × N`` grid as a float32
    banded operator (five offsets), block of 4, 4 "LR", krylovdim 30,
    maxiter 8, tol 1e-30 (fixed work), for ``P`` start blocks (phase 15's
    ``default_rng(5)`` block and one from each ``default_rng(100 + p)``),
    three routes: (a) the shared planes, the projection flag off; (b) the
    same, the flag on; (c) one plane set per problem, the planes scaled by
    ``1 + 0.1·p`` (as phase 31), the flag off.

    Each batched solve is driven once with the launch counts set to 0 just
    before it and read just after, and its applies recorded
    (:class:`ApplyRecorder`); then the ``P`` one-problem solves
    (``eigsolve`` with a ``Block`` start on the problem's operator), each
    with its launches.  Guards: every problem 112 / 8 (7 block steps fill
    the first cycle, 3 refill each of the 7 restarted ones, 4 applies a
    step), equal to its one-problem solve's, and bit-identical to it
    (values, vectors, residuals, residual norms); 28 batched applies, each
    carrying 4 rows of every problem; on the card exactly 28
    ``banded_spmv_batched`` launches (16 rows each) and, with the flag, 232
    ``project_batched`` (29 block QRs × 2 passes × 4 columns, the
    one-problem solve's K5 count), no one-problem K3 or K5 and nothing
    else; each value within 1e-4 of its vector's Rayleigh quotient, the
    leading values of (b) and (c) within 1e-4 of (a)'s (scaled).  Then the
    batched K3 at the phase's 16 rows, shared planes and a set per problem
    (:func:`check_banded_batched`, timed).  ``banded`` (phase 15's
    operator) is built here when not given.  ``dev="cpu"`` with a small
    ``N`` rehearses the three routes with the plain versions: no launch
    guard, no kernel check."""
    from krylovkit_tpu_torch.solvers import batched as batched_mod

    t0 = time.perf_counter()
    card = dev != "cpu"
    n = N * N
    R = n // 128
    b = 4
    if banded is None:
        banded = kt.banded_from_coo(*poisson_coo(np, N, np.float32), n, device=dev)
    X = torch.empty((P, b, R, 128), dtype=torch.float32, device=dev)
    for p in range(P):
        rng = np.random.default_rng(5 if p == 0 else 100 + p)
        for j in range(b):
            X[p, j] = torch.from_numpy(rng.standard_normal((R, 128)).astype(np.float32))
    scaled = [kt.BandedOperator(banded.offsets, banded.diags * (1 + 0.1 * p), n, nnz=banded.nnz)
              for p in range(P)]
    alg = kt.BlockLanczos(krylovdim=30, maxiter=8, tol=1e-30, verbosity=kt.SILENT)
    steps = 7 + 7 * 3
    numops_want = b * steps
    qr_projections = (1 + steps) * 2 * b
    one_problem = {"banded_spmv", "project", "unproject"}
    out = {"launches": {}}
    leading = {}
    for path, op, flag, op_dim in (
            ("block_lanczos_poisson_2d_banded", banded, False, None),
            ("block_lanczos_poisson_2d_banded_proj", banded, True, None),
            ("block_lanczos_poisson_2d_banded_per_problem", scaled, False, 0)):
        ops = op if op_dim == 0 else [op] * P
        bs.use_pallas_projections = flag
        try:
            with ApplyRecorder(batched_mod) as rec:
                (vals, vecs, info), ms, launches = _sync_ms(
                    torch, _build, lambda: kt.eigsolve_blocklanczos_batched(
                        op, X, 4, "LR", alg, in_dims=(op_dim, 0)), dev)
            ones, one_ms, one_launches = [], [], []
            for p in range(P):
                o, ms1, l1 = _sync_ms(torch, _build, lambda p=p: kt.eigsolve(
                    ops[p], kt.Block(X[p], stacked=True), 4, "LR", alg=alg), dev)
                ones.append(o)
                one_ms.append(ms1)
                one_launches.append(l1)
        finally:
            bs.use_pallas_projections = False
        counts = [info.numops.tolist(), info.numiter.tolist(), info.converged.tolist()]
        counts1 = [[o[2].numops for o in ones], [o[2].numiter for o in ones],
                   [o[2].converged for o in ones]]
        bits = [torch.equal(vals[p], o[0]) and torch.equal(vecs[p], o[1])
                and torch.equal(info.normres[p], o[2].normres)
                and torch.equal(info.residual[p], o[2].residual) for p, o in enumerate(ones)]
        diff = [max(float((vals[p] - o[0]).abs().max()), float((vecs[p] - o[1]).abs().max()))
                for p, o in enumerate(ones)]
        rq_err = []
        for p in range(P):
            D64 = ops[p].diags.double()
            for i in range(4):
                v = vecs[p, i].double()
                rq = float(torch.sum(v * bd.banded_spmv_reference(v, D64, banded.offsets, n))
                           / torch.sum(v * v))
                rq_err.append(abs(rq - float(vals[p, i])) / abs(float(vals[p, i])))
        vh = vals.cpu().double()
        leading[path] = [float(vh[p, 0]) / (1 + 0.1 * p if op_dim == 0 else 1) for p in range(P)]
        want = {"banded_spmv_batched": steps}
        want1 = {"banded_spmv": numops_want}
        if flag:
            want["project_batched"] = qr_projections
            want1["project"] = qr_projections
        emit({"phase": "batched_block_lanczos", "path": path, "P": P, "block": b, "n": n,
              "projection_kernels": flag,
              "planes": "per_problem" if op_dim == 0 else "shared",
              "numops": counts[0], "numiter": counts[1], "converged": counts[2],
              "one_problem_counts": counts1, "vals": vh.tolist(),
              "rayleigh_rel_err_max": max(rq_err), "bit_identical": bits,
              "one_problem_max_abs_diff": diff, "launches": launches, "expected_launches": want,
              "one_problem_launches": one_launches, "batched_applies": rec.calls,
              "rows_per_problem": rec.per_problem, "batched_ms": ms, "one_problem_ms": one_ms,
              "one_problem_ms_sum": sum(one_ms),
              "batched_over_sum_of_one_problem": ms / sum(one_ms),
              "nvidia_smi": smi})
        require(counts[0] == [numops_want] * P and counts[1] == [8] * P,
                f"batched_block_lanczos {path}: every problem {numops_want} / 8 ({counts})")
        require(counts == counts1, f"batched_block_lanczos {path}: each problem's counts equal "
                f"its one-problem solve's ({counts} vs {counts1})")
        require(all(bits), f"batched_block_lanczos {path}: every problem bit-identical to its "
                f"one-problem solve ({bits}, max diff {diff})")
        require(max(rq_err) <= 1e-4, f"batched_block_lanczos {path}: each value within 1e-4 of "
                f"its vector's Rayleigh quotient ({max(rq_err)})")
        require(bool(torch.isfinite(vecs).all()) and tuple(vecs.shape) == (P, 4, R, 128),
                f"batched_block_lanczos {path}: finite (P, 4, R, 128) vectors")
        require(rec.calls == steps and rec.per_problem == {p: numops_want for p in range(P)},
                f"batched_block_lanczos {path}: one batched apply a lock-step carrying the {b} "
                f"rows of every problem ({rec.calls}, {rec.per_problem})")
        if card:
            require(launches == want, f"batched_block_lanczos {path}: launches {launches}, "
                    f"expected {want} (K3 once a lock-step; with the flag K5 once per column "
                    f"pass of each block QR)")
            require(not one_problem & set(launches), f"batched_block_lanczos {path}: no "
                    f"one-problem K3 or K5 ({launches})")
            require(all(l1 == want1 for l1 in one_launches), f"batched_block_lanczos {path}: "
                    f"the one-problem solves launch {want1} ({one_launches})")
        out["launches"][path] = launches
        del vals, vecs, info, ones
    base = leading["block_lanczos_poisson_2d_banded"]
    agree = max(abs(v - w) / abs(w) for path, vs in leading.items() for v, w in zip(vs, base))
    emit({"phase": "batched_block_lanczos_agreement", "leading_vals_unscaled": leading,
          "max_rel_diff": agree, "tolerance": BLOCK_ROUTE_TOL})
    require(agree <= BLOCK_ROUTE_TOL, f"batched_block_lanczos: each problem's leading value on "
            f"the three routes within {BLOCK_ROUTE_TOL} (scaled by 1 + 0.1 p on (c); {agree})")
    if not card:
        return out

    # the batched K3 at the phase's 16 rows: the shared planes, and a set per
    # problem named by each of its block's rows
    flush = torch.empty(32 << 20, device=dev)  # 128 MB, written to clear L2
    rows = X.reshape(P * b, R, 128)
    sets = torch.stack([o.diags for o in scaled])
    label = "poisson_2d banded f32, 5 offsets"
    k3 = [check_banded_batched(torch, bd, f"{label}, shared, {P * b} rows", rows, banded.diags,
                               banded.offsets, n, None, flush),
          check_banded_batched(torch, bd, f"{label}, {P} sets x {b} rows", rows, sets,
                               banded.offsets, n, [p for p in range(P) for _ in range(b)], flush)]
    del flush, sets
    emit({"phase": "batched_block_lanczos_kernels", "banded_spmv_batched": k3, "nvidia_smi": smi,
          "phase_seconds": time.perf_counter() - t0})
    L = out["launches"]
    out["kernels"] = {
        "banded_spmv": {
            "launches_batched_block_lanczos": L["block_lanczos_poisson_2d_banded"][
                "banded_spmv_batched"],
            "launches_batched_block_lanczos_proj": L["block_lanczos_poisson_2d_banded_proj"][
                "banded_spmv_batched"],
            "launches_batched_block_lanczos_per_problem":
            L["block_lanczos_poisson_2d_banded_per_problem"]["banded_spmv_batched"],
            **{f"{key}_batched_block_{name}_rows{P * b}": case[key]
               for name, case in zip(("shared", "per_problem"), k3)
               for key in ("ms", "cold_ms", "one_problem_launches_ms",
                           "one_problem_launches_cold_ms", "plain_ms", "library_ms",
                           "bound_ms")}},
        **{name: {"launches_batched_block_lanczos_proj":
                  L["block_lanczos_poisson_2d_banded_proj"].get(f"{name}_batched", 0)}
           for name in ("project", "unproject")},
    }
    return out


def small_batched_pytree_cases(torch, np, kt, dev, P=2, one_problem=True):
    """The small float64 batched tree solves of phase ``batched_pytree`` on
    ``dev``, by name, each a function giving ``(values, counts, bits)``:
    the batch's values (a flat float64 CPU tensor: solutions for the linear
    solves and the integrator, eigen- and singular values otherwise), its
    ``[numops, numiter, converged]`` lists, and whether every problem is
    bit-identical (``torch.equal`` leaf by leaf) to its one-problem tree
    solve on ``dev`` (``None`` with ``one_problem=False``: those solves are
    not run).  ``P`` problems each, the shapes of
    :func:`small_pytree_cases`: GMRES on dicts; CG, MINRES and BiCGStab on
    tuples; ``schursolve``, ``eigsolve_arnoldi`` and ``realeigsolve_arnoldi``
    on tuples; ``expintegrator`` with three dict vectors; LSMR from a tuple
    domain to a dict codomain; Golub-Ye on dicts; BiArnoldi on a ``(v0,
    w0)`` pair of tuples; Block Lanczos on ``(P, b, ...)`` dict leaves."""
    from krylovkit_tpu_torch.ops.operator import as_operator
    from krylovkit_tpu_torch.ops.vector import tree_leaves, tree_map, tree_row
    from krylovkit_tpu_torch.solvers import arnoldi as arn
    from krylovkit_tpu_torch.solvers import biarnoldi as ba
    from krylovkit_tpu_torch.solvers import bicgstab, cg, gmres, minres
    from krylovkit_tpu_torch.solvers import blocklanczos as bl
    from krylovkit_tpu_torch.solvers import expintegrator as ei
    from krylovkit_tpu_torch.solvers import golubye as gy
    from krylovkit_tpu_torch.solvers import lssolve as ls

    quiet = {"verbosity": kt.SILENT}
    f64 = torch.float64
    rng = np.random.default_rng(207)

    def mat(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev)

    R, C, H, G = mat(40, 30), mat(20, 20), mat(20, 20), mat(20, 20)
    H, Bm = (H + H.T) / 2, C @ C.T + 2 * torch.eye(20, dtype=f64, device=dev)
    S = H @ H / 20 + torch.eye(20, dtype=f64, device=dev)  # symmetric positive definite
    G = G / 20 ** 0.5 + 2 * torch.eye(20, dtype=f64, device=dev)  # nonsymmetric
    X20, X40 = mat(P, 20), mat(P, 40)
    U3 = [mat(P, 20) for _ in range(3)]
    XB = mat(P, 3, 20)
    tup, dic = _tree_of(torch, "tuple", 9), _tree_of(torch, "dict", 9)
    cod, dom = _tree_of(torch, "dict", 17), _tree_of(torch, "tuple", 12)

    def stacked(split, X):
        """A ``(P, ...)`` stack cut into two leaves on its last axis."""
        t = split(X.transpose(0, -1))
        return tree_map(lambda l: l.transpose(0, -1), t)

    def op_of(M, tree, adjoint=False):
        return _tree_map_of(torch, kt, lambda v: M @ v, tree, tree, f64,
                            (lambda v: M.T @ v) if adjoint else None)

    ps = range(P) if one_problem else ()

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))

    def counts(info):
        return [info.numops.tolist(), info.numiter.tolist(), info.converged.tolist()]

    def flat(*ts):
        out = []
        for t in ts:
            for l in tree_leaves(t):
                l = l.detach().cpu()
                out.append((torch.view_as_real(l) if l.is_complex() else l).reshape(-1).double())
        return torch.cat(out)

    def linear(M, tree, one, batched, alg, a0=0.5):
        op = op_of(M, tree)
        B = stacked(tree[0], X20)
        Z = tree_map(torch.zeros_like, B)
        x, info = batched(op, B, Z, a0, 1.0, alg)
        bits = all(same(tree_row(x, p), one(op, tree_row(B, p), tree_row(Z, p), a0, 1.0,
                                            alg)[0]) for p in ps)
        return flat(x), counts(info), bits if one_problem else None

    def schur(name):
        op = op_of(G, tup)
        X = stacked(tup[0], X20)
        alg = kt.Arnoldi(krylovdim=20, tol=1e-10, maxiter=50, **quiet)
        if name == "schursolve":
            T, V, (re, im), info = kt.schursolve_batched(op, X, 3, "LM", alg)
            ones = [arn.schursolve(op, tree_row(X, p), 3, "LM", alg) for p in ps]
            bits = all(torch.equal(T[p], o[0]) and same(tree_row(V, p), o[1])
                       and torch.equal(re[p], o[2][0]) for p, o in enumerate(ones))
            return flat(re, im), counts(info), bits if one_problem else None
        batched, one = ((kt.eigsolve_arnoldi_batched, arn.eigsolve_arnoldi)
                        if name == "eigsolve_arnoldi"
                        else (kt.realeigsolve_arnoldi_batched, arn.realeigsolve_arnoldi))
        out = batched(op, X, 3, "LR", alg)
        ones = [one(op, tree_row(X, p), 3, "LR", alg) for p in ps]
        bits = all(torch.equal(out[0][p], o[0]) and same(tree_row(out[1], p), o[1])
                   for p, o in enumerate(ones))
        return flat(out[0]), counts(out[2]), bits if one_problem else None

    def expint():
        op = op_of(H / 4, dic)
        us = tuple(stacked(dic[0], U) for U in U3)
        alg = kt.Lanczos(krylovdim=10, tol=1e-10, **quiet)
        y, info = kt.expintegrator_batched(op, 0.5, us, alg)
        bits = all(same(tree_row(y, p), ei._expintegrator_core(
            op, 0.5, tuple(tree_row(u, p) for u in us), alg, kt.STANDARD)[0]) for p in ps)
        return flat(y), counts(info), bits if one_problem else None

    def lsmr():
        op = _tree_map_of(torch, kt, lambda v: R @ v, dom, cod, f64, lambda v: R.T @ v)
        B = stacked(cod[0], X40)
        alg = kt.LSMR(tol=1e-10, maxiter=400, **quiet)
        x, info = kt.lssolve_lsmr_batched(op, B, alg, 0.5)
        bits = all(same(tree_row(x, p), ls.lssolve_lsmr(op, tree_row(B, p), alg, 0.5)[0])
                   for p in ps)
        return flat(x), counts(info), bits if one_problem else None

    def golub():
        opA, opB = op_of(H, dic), op_of(Bm, dic)
        X = stacked(dic[0], X20)
        alg = kt.GolubYe(krylovdim=19, tol=1e-10, maxiter=50, **quiet)
        vals, vecs, info = kt.geneigsolve_golubye_batched(opA, opB, X, 2, "SR", alg)
        ones = [gy.geneigsolve_golubye(opA, opB, tree_row(X, p), 2, "SR", alg) for p in ps]
        bits = all(torch.equal(vals[p], o[0]) and same(tree_row(vecs, p), o[1])
                   for p, o in enumerate(ones))
        return flat(vals), counts(info), bits if one_problem else None

    def biarn():
        op = op_of(G, tup, adjoint=True)
        V0, W0 = stacked(tup[0], X20), stacked(tup[0], U3[0])
        alg = kt.BiArnoldi(krylovdim=20, tol=1e-10, maxiter=50, **quiet)
        vals, (V, W), (iV, _) = kt.bieigsolve_batched(op, V0, W0, 2, "LM", alg)
        ones = [ba.bieigsolve_driver(as_operator(op), tree_row(V0, p), tree_row(W0, p), 2, "LM",
                                     alg) for p in ps]
        bits = all(torch.equal(vals[p], o[0]) and same(tree_row(V, p), o[1][0])
                   and same(tree_row(W, p), o[1][1]) for p, o in enumerate(ones))
        return flat(vals), counts(iV), bits if one_problem else None

    def block():
        op = op_of(H, dic)
        X = stacked(dic[0], XB)
        alg = kt.BlockLanczos(krylovdim=18, tol=1e-10, maxiter=100, **quiet)
        vals, vecs, info = kt.eigsolve_blocklanczos_batched(op, X, 3, "LR", alg)
        ones = [bl.eigsolve_blocklanczos(op, tree_row(X, p), 3, "LR", alg) for p in ps]
        bits = all(torch.equal(vals[p], o[0]) and same(tree_row(vecs, p), o[1])
                   for p, o in enumerate(ones))
        return flat(vals), counts(info), bits if one_problem else None

    def gm():
        alg = kt.GMRES(krylovdim=8, tol=1e-10, maxiter=50, **quiet)
        return linear(G, dic, gmres.linsolve_gmres, kt.linsolve_gmres_batched, alg)

    return {
        "gmres_dict": gm,
        "cg_tuple": lambda: linear(S, tup, cg.linsolve_cg, kt.linsolve_cg_batched,
                                   kt.CG(tol=1e-10, maxiter=200, **quiet)),
        "minres_tuple": lambda: linear(H, tup, minres.linsolve_minres,
                                       kt.linsolve_minres_batched,
                                       kt.MINRES(tol=1e-10, maxiter=200, **quiet), a0=3.0),
        "bicgstab_tuple": lambda: linear(G, tup, bicgstab.linsolve_bicgstab,
                                         kt.linsolve_bicgstab_batched,
                                         kt.BiCGStab(tol=1e-10, maxiter=200, **quiet)),
        "schursolve_tuple": lambda: schur("schursolve"),
        "eigsolve_arnoldi_tuple": lambda: schur("eigsolve_arnoldi"),
        "realeigsolve_arnoldi_tuple": lambda: schur("realeigsolve_arnoldi"),
        "expintegrator_three_dicts": expint,
        "lssolve_lsmr_dict_tuple": lsmr,
        "geneigsolve_golubye_dict": golub,
        "bieigsolve_tuple_pair": biarn,
        "eigsolve_blocklanczos_dict": block,
    }


def small_batched_eager_cases(torch, np, kt, dev, P=2, one_problem=True):
    """The small float64 batches of phase ``batched_eager_selective`` on
    ``dev``, by name, each a function giving ``(values, counts, bits)`` as
    :func:`small_batched_pytree_cases` does: the batch's values (a flat
    float64 CPU tensor), its ``[numops, numiter, converged]`` lists, and
    whether every problem is bit-identical to its one-problem solve on
    ``dev`` (``None`` with ``one_problem=False``).  ``P`` problems each on
    one shared operator: the seven entry points that take ``eager=True``
    (``eigsolve_lanczos_batched``, the three Arnoldi drivers,
    ``svdsolve_gkl_batched``, ``bieigsolve_batched``,
    ``expintegrator_batched`` with two vectors, ``exponentiate_batched``),
    and ``Lanczos(reorth="selective")`` on a 20 × 20 symmetric matrix and on
    dict vectors of it."""
    from krylovkit_tpu_torch.ops.vector import tree_leaves, tree_map, tree_row
    from krylovkit_tpu_torch.solvers import arnoldi as arn
    from krylovkit_tpu_torch.solvers import biarnoldi as ba
    from krylovkit_tpu_torch.solvers import expintegrator as ei
    from krylovkit_tpu_torch.solvers import lanczos as lz
    from krylovkit_tpu_torch.solvers import svdsolve as sv

    quiet = {"verbosity": kt.SILENT}
    f64 = torch.float64
    rng = np.random.default_rng(211)

    def mat(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev)

    H, G, R = mat(20, 20), mat(20, 20), mat(30, 20)
    H = (H + H.T) / 2
    # a real leading spectrum with a gap (3, then [0, 1]) and a small random
    # part: the eager rounds (a dense Schur each step) end within a few steps
    d = torch.linspace(0.0, 1.0, 20, dtype=f64, device=dev)
    d[-2:] = torch.tensor([2.0, 3.0], dtype=f64)
    G = G / 80 + torch.diag(d)
    X20, X30, U20 = mat(P, 20), mat(P, 30), mat(P, 20)
    dic = _tree_of(torch, "dict", 9)
    ps = range(P) if one_problem else ()

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))

    def counts(info):
        return [info.numops.tolist(), info.numiter.tolist(), info.converged.tolist()]

    def flat(*ts):
        out = []
        for t in ts:
            for l in tree_leaves(t):
                l = l.detach().cpu()
                out.append((torch.view_as_real(l) if l.is_complex() else l).reshape(-1).double())
        return torch.cat(out)

    def done(vals, info, outs, ones):
        """``(values, counts, bits)``: ``outs`` the batch's outputs, ``ones``
        each problem's one-problem outputs in the same order."""
        bits = all(same(tree_row(o, p), o1) for p, one in zip(ps, ones)
                   for o, o1 in zip(outs, one))
        return flat(vals), counts(info), bits if one_problem else None

    def lanczos(alg, tree=False):
        op = kt.as_operator(_tree_map_of(torch, kt, lambda v: H @ v, dic, dic, f64) if tree
                            else H)
        # a dict stack: each (P, 20) row cut into two leaves
        X = tree_map(lambda l: l.T, dic[0](X20.T)) if tree else X20
        vals, vecs, info = kt.eigsolve_lanczos_batched(op, X, 2, "LR", alg)
        ones = [lz.eigsolve_lanczos(op, tree_row(X, p), 2, "LR", alg) for p in ps]
        return done(vals, info, (vals, vecs, info.residual),
                    [(v, w, i.residual) for v, w, i in ones])

    def arnoldi(name):
        op = kt.as_operator(G)
        alg = kt.Arnoldi(krylovdim=6, tol=1e-8, maxiter=100, eager=True, **quiet)
        if name == "schursolve":
            T, V, (re, im), info = kt.schursolve_batched(op, X20, 1, "LR", alg)
            ones = [arn.schursolve(op, X20[p], 1, "LR", alg) for p in ps]
            return done((re, im), info, (T, V, re, im, info.residual),
                        [(o[0], o[1], o[2][0], o[2][1], o[3].residual) for o in ones])
        one = arn.eigsolve_arnoldi if name == "eigsolve_arnoldi" else arn.realeigsolve_arnoldi
        out = getattr(kt, f"{name}_batched")(op, X20, 1, "LR", alg)
        ones = [one(op, X20[p], 1, "LR", alg) for p in ps]
        return done(out[0], out[2], (out[0], out[1], out[2].residual),
                    [(o[0], o[1], o[2].residual) for o in ones])

    def gkl():
        op = kt.as_operator(R)
        alg = kt.GKL(krylovdim=8, tol=1e-10, maxiter=100, eager=True, **quiet)
        S, U, V, info = kt.svdsolve_gkl_batched(op, X30, 2, "LR", alg)
        ones = [sv.svdsolve_gkl(op, X30[p], 2, "LR", alg) for p in ps]
        return done(S, info, (S, U, V, info.residual), [(o[0], o[1], o[2], o[3].residual)
                                                         for o in ones])

    def biarn():
        op = kt.as_operator(G)
        alg = kt.BiArnoldi(krylovdim=6, tol=1e-8, maxiter=100, eager=True, **quiet)
        vals, (V, W), (iV, _) = kt.bieigsolve_batched(op, X20, U20, 1, "LR", alg)
        ones = [ba.bieigsolve_driver(op, X20[p], U20[p], 1, "LR", alg) for p in ps]
        return done(vals, iV, (vals, V, W), [(o[0], o[1][0], o[1][1]) for o in ones])

    def expint(two):
        op = kt.as_operator(H / 4)
        alg = kt.Lanczos(krylovdim=8, tol=1e-10, eager=True, **quiet)
        us = (X20, U20) if two else (X20,)
        y, info = kt.expintegrator_batched(op, 0.5, us, alg)
        ones = [ei._expintegrator_core(op, 0.5, tuple(u[p] for u in us), alg, kt.STANDARD)
                for p in ps]
        return done(y, info, (y, info.normres), [(o[0], o[1].normres) for o in ones])

    eager = kt.Lanczos(krylovdim=8, tol=1e-10, maxiter=100, eager=True, **quiet)
    sel = kt.Lanczos(krylovdim=10, tol=1e-10, maxiter=100, reorth="selective", **quiet)
    return {
        "lanczos_eager": lambda: lanczos(eager),
        "lanczos_selective": lambda: lanczos(sel),
        "lanczos_selective_dict": lambda: lanczos(sel, tree=True),
        "schursolve_eager": lambda: arnoldi("schursolve"),
        "eigsolve_arnoldi_eager": lambda: arnoldi("eigsolve_arnoldi"),
        "realeigsolve_arnoldi_eager": lambda: arnoldi("realeigsolve_arnoldi"),
        "svdsolve_gkl_eager": gkl,
        "bieigsolve_eager": biarn,
        "expintegrator_eager": lambda: expint(True),
        "exponentiate_eager": lambda: expint(False),
    }


def batched_pytree_phase(torch, np, kt, _build, svds, smi, rect=None, rect_adj=None, n=1 << 21,
                         nx=1024, P=2, maxiter=8, dev="cuda"):
    """Phase ``batched_pytree``: batched solves on pytree vectors, each
    vector cut into two leaves by rows (phase 28's :func:`_tree_of`), the
    operator a callable on the trees (:func:`_tree_map_of`), so every solve
    takes the unfused lock-step and rotates each ``(kmax, R, 128)`` float32
    leaf with one batched K2 launch.

    (a) config 1 on a tuple: ``laplacian_1d(n)`` as two ``(R/2, 128)``
    leaves, ``eigsolve_lanczos_batched`` with 4 "LM", krylovdim 30,
    ``maxiter`` (8: phase ``main``'s 10 cut for the phase's 10 s), tol
    1e-30, cgs2, for phase 30's first ``P`` starts.
    (b) config 3's rectangular map (``rect``, ``rect_adj``; rows ``2·nx²``,
    columns ``nx²``) from a dict domain to a tuple codomain (phase 28's
    cuts), ``svdsolve_gkl_batched`` with 8 "LR", krylovdim 30, maxiter 3,
    tol 1e-30 (phase 33's fixed work), phase 33's first ``P`` starts.
    Each batched solve is driven once with the launch counts set to 0 just
    before it and read just after; then each problem's one-problem tree
    solve (``solvers/lanczos.py:eigsolve_lanczos``,
    ``solvers/svdsolve.py:svdsolve_gkl``) with its launches.  Guards: each
    problem's counts equal its one-problem tree solve's, its values, vectors
    and residuals bit-identical to it; (a) values within 2e-2 of 4 at full
    ``n``; on the card exactly the one-problem tree solve's K2 count as
    ``transform_partial_batched`` (one launch per leaf per rotation) and no
    one-problem kernel.  (c) the small float64 tree batches of
    :func:`small_batched_pytree_cases` on the card against the CPU: values
    within 1e-12 of the largest entry, counts equal, and on the card each
    problem bit-identical to its one-problem tree solve.  Prints the
    ms of each batch beside its one-problem solves, the launches and the
    counts.  ``dev="cpu"`` with a small ``n`` and ``nx`` rehearses (a) and
    (b) with the plain versions: no launch guard, no (c)."""
    from krylovkit_tpu_torch.ops.vector import tree_leaves, tree_row
    from krylovkit_tpu_torch.solvers import lanczos as lz

    t0 = time.perf_counter()
    card = dev != "cpu"
    quiet = {"verbosity": kt.SILENT}
    f32 = torch.float32
    out = {"launches": {}}
    one_problem = {"fused_step", "transform_partial", "banded_spmv", "laplacian_1d", "project",
                   "unproject"}

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))

    def counts(info):
        return [info.numops.tolist(), info.numiter.tolist(), info.converged.tolist()]

    def check(path, batch, ones, counts_b, bits, launches, ones_launches, ms, one_ms, extra):
        counts1 = [[o.numops for o in ones], [o.numiter for o in ones],
                   [o.converged for o in ones]]
        want = {"transform_partial_batched": ones_launches[0].get("transform_partial", 0)}
        emit({"phase": "batched_pytree", "path": path, "P": P, **batch,
              "numops": counts_b[0], "numiter": counts_b[1], "converged": counts_b[2],
              "one_problem_counts": counts1, "bit_identical": bits, "launches": launches,
              "expected_launches": want, "one_problem_launches": ones_launches,
              "batched_ms": ms, "one_problem_ms": one_ms,
              "batched_over_sum_of_one_problem": ms / sum(one_ms), "nvidia_smi": smi, **extra})
        require(counts_b == counts1, f"batched_pytree {path}: each problem's counts equal its "
                f"one-problem tree solve's ({counts_b} vs {counts1})")
        require(all(bits), f"batched_pytree {path}: every problem bit-identical to its "
                f"one-problem tree solve ({bits})")
        if card:
            require(all(l1 == ones_launches[0] for l1 in ones_launches),
                    f"batched_pytree {path}: the one-problem tree solves launch alike "
                    f"({ones_launches})")
            require(launches == want and want["transform_partial_batched"] > 0,
                    f"batched_pytree {path}: one batched K2 launch per leaf per rotation, as "
                    f"many as the one-problem tree solve's K2 ({launches} vs {want})")
            require(not one_problem & set(launches), f"batched_pytree {path}: no one-problem "
                    f"launch ({launches})")
        out["launches"][path] = launches

    # (a) config 1 on a tuple of two (R/2, 128) leaves
    R = n // 128
    lap = kt.laplacian_1d(n, device=dev)
    t1 = _tree_of(torch, "tuple", R // 2)
    op1 = _tree_map_of(torch, kt, lap.normal, t1, t1, f32)
    X = batched_starts(torch, np, R, P, dev)
    Xt = (X[:, :R // 2], X[:, R // 2:])
    alg = kt.Lanczos(krylovdim=KRYLOVDIM, maxiter=maxiter, tol=1e-30, **quiet)
    (vals, vecs, info), ms, launches = _sync_ms(
        torch, _build, lambda: kt.eigsolve_lanczos_batched(op1, Xt, 4, "LM", alg), dev)
    ones, one_ms, one_l = [], [], []
    for p in range(P):
        o, ms1, l1 = _sync_ms(torch, _build, lambda p=p: lz.eigsolve_lanczos(
            op1, tree_row(Xt, p), 4, "LM", alg), dev)
        ones.append(o)
        one_ms.append(ms1)
        one_l.append(l1)
    bits = [torch.equal(vals[p], o[0]) and same(tree_row(vecs, p), o[1])
            and same(tree_row(info.residual, p), o[2].residual)
            and torch.equal(info.normres[p], o[2].normres) for p, o in enumerate(ones)]
    vh = vals.cpu()
    check("config1_lanczos_tuple", {"n": n, "leaves": [tuple(l.shape) for l in vecs]},
          [o[2] for o in ones], counts(info), bits, launches, one_l, ms, one_ms,
          {"vals": vh.tolist(), "maxiter": maxiter})
    require(all(tuple(l.shape) == (P, 4, R // 2, 128) and bool(torch.isfinite(l).all())
                for l in vecs), "batched_pytree config 1: finite (P, 4, R/2, 128) leaves")
    if n == 1 << 21:
        require(bool((torch.abs(vh - 4.0) <= 2e-2).all()), f"batched_pytree config 1: vals ~ 4 "
                f"(atol 2e-2): {vh.tolist()}")
    del vals, vecs, info, ones

    # (b) config 3's rectangular map, dict domain, tuple codomain
    Rr = nx * nx // 128
    if rect is None:
        Cr = nx * nx // 2
        wr = torch.from_numpy(np.linspace(1.0, 3.0, Cr, dtype=np.float32)
                              .reshape(Cr // 128, 128)).to(dev)

        def rect(x):
            wx = wr * x
            return torch.cat([wx, 0.5 * torch.roll(wx, 1, dims=0)], dim=0)

        def rect_adj(y):
            return wr * y[: Cr // 128] + 0.5 * wr * torch.roll(y[Cr // 128:], -1, dims=0)

    cod, dom = _tree_of(torch, "tuple", Rr // 2), _tree_of(torch, "dict", Rr // 4)
    op3 = _tree_map_of(torch, kt, rect, dom, cod, f32, rect_adj)
    X3 = batched_starts(torch, np, Rr, P, dev)
    X3[0] = torch.from_numpy(np.random.default_rng(2).standard_normal((Rr, 128))
                             .astype(np.float32))
    X3t = (X3[:, :Rr // 2], X3[:, Rr // 2:])
    galg = kt.GKL(krylovdim=KRYLOVDIM, maxiter=3, tol=1e-30, **quiet)
    (S, U, W, info), ms, launches = _sync_ms(
        torch, _build, lambda: kt.svdsolve_gkl_batched(op3, X3t, 8, "LR", galg), dev)
    ones, one_ms, one_l = [], [], []
    for p in range(P):
        o, ms1, l1 = _sync_ms(torch, _build, lambda p=p: svds.svdsolve_gkl(
            op3, tree_row(X3t, p), 8, "LR", galg), dev)
        ones.append(o)
        one_ms.append(ms1)
        one_l.append(l1)
    bits = [torch.equal(S[p], o[0]) and same(tree_row(U, p), o[1]) and same(tree_row(W, p), o[2])
            and same(tree_row(info.residual, p), o[3].residual) for p, o in enumerate(ones)]
    Sh = S.cpu()
    check("config3_svdsolve_rect_dict_tuple", {
        "rows": 2 * Rr * 64, "cols": Rr * 64,
        "leaves": {"codomain": [tuple(l.shape) for l in U], "domain":
                   {k: tuple(W[k].shape) for k in W}}},
        [o[3] for o in ones], counts(info), bits, launches, one_l, ms, one_ms,
        {"svals": Sh.tolist()})
    require(bool(torch.isfinite(Sh).all()) and bool((Sh[:, :-1] >= Sh[:, 1:]).all()),
            "batched_pytree config 3: finite descending singular values")
    del S, U, W, info, ones
    if not card:
        return out

    # (c) the small float64 tree batches, card against CPU
    small = []
    for name in small_batched_pytree_cases(torch, np, kt, "cpu", P):
        _build.reset_launches()
        t1s = time.perf_counter()
        vc, cc, bc = small_batched_pytree_cases(torch, np, kt, dev, P)[name]()
        torch.cuda.synchronize()
        ms_c = (time.perf_counter() - t1s) * 1e3
        counted = {k: v for k, v in _build.launches.items() if v}
        vh, ch, _ = small_batched_pytree_cases(torch, np, kt, "cpu", P, False)[name]()
        err = float((vc - vh).abs().max()) / max(float(vh.abs().max()), 1.0)
        small.append({"solve": name, "rel_err": err, "counts": cc, "counts_cpu": ch,
                      "bit_identical_card": bc, "launches": counted,
                      "ms_card_with_one_problem_solves": ms_c})
        require(err <= SMALL_SHARDED_TOL, f"batched_pytree small {name}: card within "
                f"{SMALL_SHARDED_TOL} of the CPU ({err})")
        require(cc == ch, f"batched_pytree small {name}: counts equal ({cc} vs {ch})")
        require(bc, f"batched_pytree small {name}: each problem bit-identical to its "
                "one-problem tree solve on the card")
    emit({"phase": "batched_pytree_small", "solves": small, "tolerance": SMALL_SHARDED_TOL,
          "nvidia_smi": smi, "phase_seconds": time.perf_counter() - t0})
    return out


def counting_rotations(modules):
    """Wrap ``_rotate`` (``solvers/batched.py``) where each of ``modules``
    calls it, to record the problems of every call that rotates some (one
    batched K2 launch a leaf); returns ``(calls, restore)``."""
    calls, inner = [], modules[0]._rotate

    def wrapped(Vb, Us, m_out):
        if Us:
            calls.append(sorted(Us))
        return inner(Vb, Us, m_out)

    for m in modules:
        m._rotate = wrapped
    return calls, lambda: [setattr(m, "_rotate", inner) for m in modules]


# the small batches phase 37 runs on the card: an eager Arnoldi or BiArnoldi
# round at k <= 8 took 65-115 ms there (dense Schur steps on an NVIDIA H100
# 80GB HBM3, 700.00 W), so those two run in the card tests and at full width
BATCHED_EAGER_SMALL = ("lanczos_eager", "lanczos_selective_dict", "svdsolve_gkl_eager",
                       "expintegrator_eager")


def batched_eager_selective_phase(torch, np, kt, _build, bs, smi, impurity=None, tri=None,
                                  rect=None, rect_adj=None, N=1024, n4=1 << 20, P=4, PA=2,
                                  arnoldi_dims=(5, 2), gkl_dims=(10, 2), biarnoldi_dim=4,
                                  dev="cuda"):
    """Phase ``batched_eager_selective``: the batched drivers with
    ``eager=True`` and ``Lanczos(reorth="selective")`` at full width, each
    batch driven once with the launch counts set to 0 just before it and
    read just after, then each problem's one-problem solve with its
    launches; float32 ``(R, 128)`` vectors.

    (a) ``eigsolve_lanczos_batched`` with ``Lanczos(krylovdim=30,
    maxiter=10, tol=1e-5, reorth="selective")``, 4 "SR", on phase
    ``lanczos_variants``' impurity operator (``impurity``: config 2's banded
    Poisson plus the wells, ``N × N``, shared) for ``P`` starts
    ``default_rng(6 + p)`` (problem 0 is phase 21's
    ``lanczos_selective_impurity``), the projection flag off, then on:
    each problem's counts, sweeps and bits its one-problem ``eigsolve``'s,
    problem 0 within 1e-4 of ``IMPURITY_VALS``; one batched K3 launch a
    lock-step, one batched K2 a round and one for the extraction, with the
    flag one batched K5 and K6 in each lock-step where a problem sweeps.
    (b) the same with ``Lanczos(krylovdim=30, maxiter=10, tol=1e-5,
    eager=True)``: batched K2 = the lock-steps that restart + 1, as many
    problem rotations as the one-problem solves' restarts; no K1.
    (c) ``schursolve_batched`` with ``Arnoldi(eager=True)``, 4 "LM", tol
    1e-30, on config 4's banded chain (``tri``, ``n4``) for ``PA`` starts
    (phase 30's); ``krylovdim, maxiter = arnoldi_dims`` (5, 2: cut from
    30, 8, each eager step being a dense Schur round of 65-115 ms on the
    card).  (d)
    ``svdsolve_gkl_batched`` with ``GKL(eager=True)``, 8 "LR", tol 1e-30,
    on config 3's rect callables (``rect``, ``rect_adj``) for ``PA``
    starts, ``gkl_dims`` (10, 2: cut from 30, 12).  (e)
    ``bieigsolve_batched`` with ``BiArnoldi(eager=True)``, 4 "LM", one
    round of ``krylovdim`` ``biarnoldi_dim`` (4), on ``tri`` (its adjoint
    planes) for ``PA`` start pairs.  (f) ``exponentiate_batched`` of the
    (1, −2, 1) chain, t = 0.1, tol 1e-4, ``Lanczos(krylovdim=30,
    eager=True)``, ``P`` starts, against the same batch without ``eager``
    (fused) within 1e-4.  (c)-(f): counts and bits per problem, (c)-(e)
    batched K3 (both planes in (e)) a lock-step and batched K2 a rotating
    lock-step (both stacks in (d)); no one-problem kernel and no K1 in any
    eager or selective batch.  (g) the small float64 batches
    :data:`BATCHED_EAGER_SMALL` of :func:`small_batched_eager_cases` on the
    card against the CPU.  ``dev="cpu"`` with a small ``N`` and ``n4``
    rehearses (a)-(f) with the plain versions: no launch guard, no (g)."""
    from krylovkit_tpu_torch.factorizations import gkl as gf
    from krylovkit_tpu_torch.factorizations import krylov as kf
    from krylovkit_tpu_torch.ops.operator import TypedOperator
    from krylovkit_tpu_torch.ops.vector import tree_leaves
    from krylovkit_tpu_torch.solvers import arnoldi as arn
    from krylovkit_tpu_torch.solvers import batched as bt
    from krylovkit_tpu_torch.solvers import batched_arnoldi as bta
    from krylovkit_tpu_torch.solvers import batched_gkl as btg
    from krylovkit_tpu_torch.solvers import biarnoldi as ba
    from krylovkit_tpu_torch.solvers import svdsolve as svs
    from krylovkit_tpu_torch.solvers.expintegrator import _expintegrator_core

    t0 = time.perf_counter()
    card = dev != "cpu"
    quiet = {"verbosity": kt.SILENT}
    f32 = torch.float32
    out = {"launches": {}}
    one_problem = {"fused_step", "transform_partial", "banded_spmv", "laplacian_1d", "project",
                   "unproject"}

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))

    def counts(info):
        return [info.numops.tolist(), info.numiter.tolist(), info.converged.tolist()]

    def ones_of(solve, n):
        """Each problem's one-problem solve: ``[(result, ms, launches)]``."""
        return [_sync_ms(torch, _build, lambda p=p: solve(p), dev) for p in range(n)]

    def check(path, n, batch, ms, launches, ones, infos, bits, want, extra):
        counts1 = [[i.numops for i in infos], [i.numiter for i in infos],
                   [i.converged for i in infos]]
        emit({"phase": "batched_eager_selective", "path": path, "P": n,
              "numops": batch[0], "numiter": batch[1], "converged": batch[2],
              "one_problem_counts": counts1, "bit_identical": bits, "launches": launches,
              "expected_launches": want, "one_problem_launches": [o[2] for o in ones],
              "batched_ms": ms, "one_problem_ms": [o[1] for o in ones],
              "batched_over_sum_of_one_problem": ms / sum(o[1] for o in ones),
              "part_seconds": time.perf_counter() - t_part, "nvidia_smi": smi, **extra})
        require(batch == counts1, f"batched_eager_selective {path}: each problem's counts equal "
                f"its one-problem solve's ({batch} vs {counts1})")
        require(all(bits), f"batched_eager_selective {path}: every problem bit-identical to its "
                f"one-problem solve ({bits})")
        if card:
            require(launches == want, f"batched_eager_selective {path}: launches {launches}, "
                    f"predicted {want}")
            require(not (one_problem | {"fused_step_batched"}) & set(launches),
                    f"batched_eager_selective {path}: no one-problem launch and no K1 "
                    f"({launches})")
        out["launches"][path] = launches

    R = N * N // 128
    op = impurity if impurity is not None else impurity_banded(np, kt, N, dev)
    X = torch.stack([torch.from_numpy(np.random.default_rng(6 + p).standard_normal((R, 128))
                                      .astype(np.float32)) for p in range(P)]).to(dev)
    want_vals = torch.tensor(IMPURITY_VALS, dtype=torch.float64)

    # (a) selective Lanczos, the projection flag off and on
    for flag in (False, True):
        t_part = time.perf_counter()
        path = "lanczos_selective_impurity" + ("_proj" if flag else "")
        alg = kt.Lanczos(krylovdim=30, maxiter=10, tol=1e-5, reorth="selective", **quiet)
        bs.use_pallas_projections = flag
        try:
            steps, restore = counting_calls(kf, "expand_hermitian_selective_batched",
                                            lambda res: {p: o[3] for p, o in res.items()})
            try:
                (vals, vecs, info), ms, launches = _sync_ms(
                    torch, _build, lambda: kt.eigsolve_lanczos_batched(op, X, 4, "SR", alg), dev)
            finally:
                restore()
            ones, sweeps1 = [], []
            for p in range(P):
                flags, restore = counting_sweeps(kf)
                try:
                    ones += ones_of(lambda q: kt.eigsolve(op, X[p], 4, "SR", ishermitian=True,
                                                           alg=alg), 1)
                finally:
                    restore()
                sweeps1.append(flags)
        finally:
            bs.use_pallas_projections = False
        sweeps = [[s[p] for s in steps if p in s] for p in range(P)]
        bits = [torch.equal(vals[p], o[0][0]) and torch.equal(vecs[p], o[0][1])
                and torch.equal(info.residual[p], o[0][2].residual)
                and torch.equal(info.normres[p], o[0][2].normres) for p, o in enumerate(ones)]
        want = {"banded_spmv_batched": len(steps),
                "transform_partial_batched": max(info.numiter.tolist()) + 1}
        if flag:
            want["project_batched"] = want["unproject_batched"] = sum(any(s.values())
                                                                      for s in steps)
        vh = vals.cpu().double()
        check(path, P, counts(info), ms, launches, ones, [o[0][2] for o in ones], bits, want,
              {"sweeps": [sum(f) for f in sweeps], "one_problem_sweeps": [sum(f) for f in sweeps1],
               "lock_steps": len(steps), "vals": vh.tolist()})
        require(sweeps == sweeps1, f"batched_eager_selective {path}: each problem sweeps at "
                "its one-problem solve's steps")
        if N == 1024:
            require(float((vh[0] - want_vals).abs().max()) <= 1e-4,
                    f"batched_eager_selective {path}: problem 0 within 1e-4 of {IMPURITY_VALS}")
        del vals, vecs, info, ones

    # (b) eager Lanczos
    t_part = time.perf_counter()
    alg = kt.Lanczos(krylovdim=30, maxiter=10, tol=1e-5, eager=True, **quiet)
    steps, restore_s = counting_calls(kf, "expand_batched")
    rots, restore_r = counting_rotations([bt])
    try:
        (vals, vecs, info), ms, launches = _sync_ms(
            torch, _build, lambda: kt.eigsolve_lanczos_batched(op, X, 4, "SR", alg), dev)
    finally:
        restore_s()
        restore_r()
    ones = ones_of(lambda p: kt.eigsolve(op, X[p], 4, "SR", ishermitian=True, alg=alg), P)
    bits = [torch.equal(vals[p], o[0][0]) and torch.equal(vecs[p], o[0][1])
            and torch.equal(info.residual[p], o[0][2].residual) for p, o in enumerate(ones)]
    want = {"banded_spmv_batched": len(steps), "transform_partial_batched": len(rots)}
    vh = vals.cpu().double()
    check("lanczos_eager_impurity", P, counts(info), ms, launches, ones,
          [o[0][2] for o in ones], bits, want,
          {"lock_steps": len(steps), "restart_lock_steps": len(rots) - 1,
           "problems_rotated": [len(r) for r in rots], "vals": vh.tolist()})
    require(rots[-1] == list(range(P)), "batched_eager_selective lanczos_eager: the extraction "
            "rotates every problem")
    if card:
        restarts1 = sum(o[2].get("transform_partial", 0) - 1 for o in ones)
        require(sum(len(r) for r in rots[:-1]) == restarts1,
                f"batched_eager_selective lanczos_eager: a problem rotates at its one-problem "
                f"solve's restarts only ({[len(r) for r in rots]}, {restarts1})")
    if N == 1024:
        require(float((vh[0] - want_vals).abs().max()) <= 1e-4,
                f"batched_eager_selective lanczos_eager: problem 0 within 1e-4 of {IMPURITY_VALS}")
    del vals, vecs, info, ones

    # (c) eager schursolve on config 4's banded chain
    t_part = time.perf_counter()
    R4 = n4 // 128
    A4 = tri if tri is not None else kt.banded_from_coo(
        *tridiagonal_coo(np, n4, -1.3, 2.0, -0.7, np.float32), n4, device=dev)
    X4 = batched_starts(torch, np, R4, PA, dev)
    kd, mi = arnoldi_dims
    alg = kt.Arnoldi(krylovdim=kd, maxiter=mi, tol=1e-30, eager=True, **quiet)
    steps, restore_s = counting_calls(kf, "expand_batched")
    rots, restore_r = counting_rotations([bta])
    try:
        (T, V, (re, im), info), ms, launches = _sync_ms(
            torch, _build, lambda: kt.schursolve_batched(A4, X4, 4, "LM", alg), dev)
    finally:
        restore_s()
        restore_r()
    ones = ones_of(lambda p: arn.schursolve(A4, X4[p], 4, "LM", alg), PA)
    bits = [torch.equal(T[p], o[0][0]) and torch.equal(V[p], o[0][1])
            and torch.equal(re[p], o[0][2][0]) and torch.equal(im[p], o[0][2][1])
            and torch.equal(info.residual[p], o[0][3].residual) for p, o in enumerate(ones)]
    want = {"banded_spmv_batched": len(steps), "transform_partial_batched": len(rots)}
    check("schursolve_eager_config4", PA, counts(info), ms, launches, ones,
          [o[0][3] for o in ones], bits, want,
          {"n": n4, "krylovdim": kd, "maxiter": mi, "lock_steps": len(steps),
           "problems_rotated": [len(r) for r in rots], "re": re.cpu().tolist()})
    if card:
        require(sum(map(len, rots)) == sum(o[2].get("transform_partial", 0) for o in ones) > 0,
                "batched_eager_selective schursolve_eager: the one-problem restarts' rotations")
    del T, V, info, ones

    # (d) eager GKL on config 3's rect callables
    t_part = time.perf_counter()
    Rr = n4 // 128
    if rect is None:
        Cr = n4 // 2
        wr = torch.from_numpy(np.linspace(1.0, 3.0, Cr, dtype=np.float32)
                              .reshape(Cr // 128, 128)).to(dev)

        def rect(x):
            wx = wr * x
            return torch.cat([wx, 0.5 * torch.roll(wx, 1, dims=0)], dim=0)

        def rect_adj(y):
            return wr * y[: Cr // 128] + 0.5 * wr * torch.roll(y[Cr // 128:], -1, dims=0)

    pair = TypedOperator(rect, rect_adj, dtype=f32)
    X3 = batched_starts(torch, np, Rr, PA, dev)
    kd, mi = gkl_dims
    alg = kt.GKL(krylovdim=kd, maxiter=mi, tol=1e-30, eager=True, **quiet)
    steps, restore_s = counting_calls(gf, "expand_batched")
    rots, restore_r = counting_rotations([btg])
    try:
        (S, U, W, info), ms, launches = _sync_ms(
            torch, _build, lambda: kt.svdsolve_gkl_batched(pair, X3, 8, "LR", alg), dev)
    finally:
        restore_s()
        restore_r()
    ones = ones_of(lambda p: svs.svdsolve_gkl(pair, X3[p], 8, "LR", alg), PA)
    bits = [torch.equal(S[p], o[0][0]) and torch.equal(U[p], o[0][1])
            and torch.equal(W[p], o[0][2]) and torch.equal(info.residual[p], o[0][3].residual)
            for p, o in enumerate(ones)]
    want = {"transform_partial_batched": len(rots)}
    check("svdsolve_gkl_eager_config3_rect", PA, counts(info), ms, launches, ones,
          [o[0][3] for o in ones], bits, {k: v for k, v in want.items() if v},
          {"rows": n4, "cols": n4 // 2, "krylovdim": kd, "maxiter": mi,
           "lock_steps": len(steps), "problems_rotated": [len(r) for r in rots],
           "svals": S.cpu().tolist()})
    if card:
        require(sum(map(len, rots)) == sum(o[2].get("transform_partial", 0) for o in ones) > 0,
                "batched_eager_selective svdsolve_gkl_eager: the one-problem restarts' rotations")
    del S, U, W, info, ones

    # (e) eager BiArnoldi on config 4's tridiagonal, one round
    t_part = time.perf_counter()
    V0 = batched_starts(torch, np, R4, PA, dev)
    W0 = batched_starts(torch, np, R4, PA, dev, seed=110)
    alg = kt.BiArnoldi(krylovdim=biarnoldi_dim, maxiter=1, tol=1e-30, eager=True, **quiet)
    steps, restore_s = counting_calls(kf, "expand_batched")
    try:
        (vals, (V, W), (iV, _)), ms, launches = _sync_ms(
            torch, _build, lambda: kt.bieigsolve_batched(A4, V0, W0, 4, "LM", alg), dev)
    finally:
        restore_s()
    ones = ones_of(lambda p: ba.bieigsolve_driver(A4, V0[p], W0[p], 4, "LM", alg), PA)
    bits = [torch.equal(vals[p], o[0][0]) and torch.equal(V[p], o[0][1][0])
            and torch.equal(W[p], o[0][1][1]) for p, o in enumerate(ones)]
    # a lock-step: one expand_batched a side, one batched K3 each
    check("bieigsolve_eager_config4", PA, counts(iV), ms, launches, ones,
          [o[0][2][0] for o in ones], bits, {"banded_spmv_batched": len(steps)},
          {"n": n4, "krylovdim": biarnoldi_dim, "lock_steps": len(steps) // 2,
           "vals": torch.view_as_real(vals).cpu().tolist()})
    del vals, V, W, iV, ones

    # (f) eager exponentiate of the (1, -2, 1) chain, against the fused batch
    t_part = time.perf_counter()
    neg = kt.StencilOperator(*FRONT_END_NEG_LAP)
    XE = batched_starts(torch, np, R4, P, dev)
    alg = kt.Lanczos(krylovdim=30, tol=1e-4, eager=True, **quiet)
    (y, info), ms, launches = _sync_ms(
        torch, _build, lambda: kt.exponentiate_batched(neg, 0.1, XE, alg), dev)
    ones = ones_of(lambda p: _expintegrator_core(neg, 0.1, (XE[p],), alg, kt.STANDARD), P)
    bits = [torch.equal(y[p], o[0][0]) for p, o in enumerate(ones)]
    yf, _ = kt.exponentiate_batched(neg, 0.1, XE, kt.Lanczos(krylovdim=30, tol=1e-4, **quiet))
    diff = float((y - yf).abs().max() / yf.abs().max())
    check("exponentiate_eager_config4", P, counts(info), ms, launches, ones,
          [o[0][1] for o in ones], bits, {}, {"n": n4, "rel_diff_to_fused_batch": diff})
    require(diff <= 1e-4, f"batched_eager_selective exponentiate_eager: within 1e-4 of the "
            f"fused batch ({diff})")
    del y, yf, ones
    if not card:
        return out

    # (g) small float64 batches, card against CPU
    small = []
    for name in BATCHED_EAGER_SMALL:
        _build.reset_launches()
        t1s = time.perf_counter()
        vc, cc, bc = small_batched_eager_cases(torch, np, kt, dev)[name]()
        torch.cuda.synchronize()
        ms_c = (time.perf_counter() - t1s) * 1e3
        counted = {k: v for k, v in _build.launches.items() if v}
        vh, ch, _ = small_batched_eager_cases(torch, np, kt, "cpu", one_problem=False)[name]()
        err = float((vc - vh).abs().max()) / max(float(vh.abs().max()), 1.0)
        small.append({"solve": name, "rel_err": err, "counts": cc, "counts_cpu": ch,
                      "bit_identical_card": bc, "launches": counted,
                      "ms_card_with_one_problem_solves": ms_c})
        require(err <= SMALL_SHARDED_TOL, f"batched_eager_selective small {name}: card within "
                f"{SMALL_SHARDED_TOL} of the CPU ({err})")
        require(cc == ch, f"batched_eager_selective small {name}: counts equal ({cc} vs {ch})")
        require(bc, f"batched_eager_selective small {name}: each problem bit-identical to its "
                "one-problem solve on the card")
    emit({"phase": "batched_eager_selective_small", "solves": small,
          "tolerance": SMALL_SHARDED_TOL, "nvidia_smi": smi,
          "phase_seconds": time.perf_counter() - t0})
    return out

# ---------------------------------------------------------------------------
# gradients through batched solves (twenty-second slice)
# ---------------------------------------------------------------------------

BATCHED_AD_SCALES = (1.0, 1.1, 1.2, 1.3)  # phase 38's well depths, a problem each
BATCHED_AD_TOL_ONE = 1e-4  # float32: a batched gradient against its one-problem one


def banded_with_main(torch, kt, base, g):
    """``base`` (a kernel-backed ``BandedOperator`` with its adjoint) plus
    ``diag(g)``: the main plane of the operator and of its adjoint carry
    ``g`` (``(R, 128)``), so the planes require grad where ``g`` does."""
    def planes(op):
        main = op.offsets.index(0)
        return torch.stack([op.diags[i] + g if i == main else op.diags[i]
                            for i in range(len(op.offsets))])

    adj = kt.BandedOperator(base.adj.offsets, planes(base.adj), base.n, nnz=base.adj.nnz)
    return kt.BandedOperator(base.offsets, planes(base), base.n, adj=adj, nnz=base.nnz)


def small_batched_ad_routes(np, kt, torch, n=12, P=2):
    """``{label: run}`` of phase 38's small float64 batches: ``run(dev)``
    differentiates one batched solve of ``P`` problems built from numpy
    seeds on ``dev`` and returns ``(gradients, infos)``: the GMRES, MINRES
    and BiCGStab rules of ``linsolve`` (``P`` matrices, a shared one, a
    shared matrix with a tuple ``b``), the general Sylvester rule of the
    Arnoldi eigsolve and both GKL rules of ``svdsolve``."""
    routes = {}

    def on(dev, a, grad=False):
        t = torch.as_tensor(np.asarray(a), device=dev)
        return t.requires_grad_(True) if grad else t

    def linear(driver, alg, shared, tree, seed):
        def run(dev):
            rng = np.random.default_rng(seed)
            As = np.stack([(lambda B: B @ B.T / n + np.eye(n))(rng.standard_normal((n, n)))
                           for _ in range(P)])
            B, C = rng.standard_normal((P, n)), rng.standard_normal((P, n))
            S, Bt = on(dev, As[0] if shared else As, True), on(dev, B, True)
            a0, a1 = on(dev, np.float64(0.4), True), on(dev, np.float64(1.3), True)
            if tree:
                op = kt.ParametricOperator(lambda m, v: (m @ v[0], m @ v[1]), S)
                b = (Bt, 0.5 * Bt)
            else:
                op = S if shared else [kt.MatrixOperator(S[p]) for p in range(P)]
                b = Bt
            x0 = tuple(torch.zeros_like(l) for l in b) if tree else torch.zeros_like(Bt)
            X, info = driver(op, b, x0, a0, a1, alg, in_dims=(None if shared else 0, 0, 0))
            Xs = X[0] + X[1] if tree else X
            torch.sum(Xs * on(dev, C)).backward()
            return [S.grad, Bt.grad, a0.grad, a1.grad], [info]

        return run

    quiet = {"verbosity": kt.SILENT}
    routes["linsolve GMRES rule, P matrices"] = linear(
        kt.linsolve_gmres_batched, kt.GMRES(tol=1e-12, krylovdim=n, **quiet), False, False, 90)
    routes["linsolve MINRES rule, shared matrix"] = linear(
        kt.linsolve_minres_batched, kt.MINRES(tol=1e-12, maxiter=100, **quiet), True, False, 91)
    routes["linsolve BiCGStab rule, shared matrix, tuple b"] = linear(
        kt.linsolve_bicgstab_batched, kt.BiCGStab(tol=1e-12, maxiter=100, **quiet), True,
        True, 92)

    def spectral(kind, rr, seed):
        def run(dev):
            rng = np.random.default_rng(seed)
            if kind == "arnoldi":
                As = np.stack([rng.standard_normal((n, n)) / 4 + np.diag(np.linspace(1, 2, n))
                               for _ in range(P)])
                X0 = rng.standard_normal((P, n))
            else:
                As = np.stack([rng.standard_normal((2 * n, n)) for _ in range(P)])
                X0 = rng.standard_normal((P, 2 * n))
            S = on(dev, As, True)
            ops = [kt.MatrixOperator(S[p]) for p in range(P)]
            if kind == "arnoldi":
                vals, vecs, info = kt.eigsolve_arnoldi_batched(
                    ops, on(dev, X0), 1, "LR", kt.Arnoldi(tol=1e-12, krylovdim=n, **quiet),
                    in_dims=(0, 0), alg_rrule=rr)
                loss = (torch.real(vals[:, 0]) + 0.7 * torch.imag(vals[:, 0])
                        + torch.abs(vecs[:, 0, 0]) ** 2).sum()
            else:
                s, U, V, info = kt.svdsolve_gkl_batched(
                    ops, on(dev, X0), 2, "LR", kt.GKL(tol=1e-12, krylovdim=n, maxiter=100,
                                                      **quiet), in_dims=(0, 0), alg_rrule=rr)
                loss = s.sum() + (U[:, 0, 0] * V[:, 0, 1]).sum()
            loss.backward()
            return [S.grad], [info]

        return run

    routes["eigsolve Arnoldi, general Sylvester rule"] = spectral(
        "arnoldi", kt.Arnoldi(tol=1e-12, krylovdim=30, maxiter=100, **quiet), 93)
    routes["svdsolve GKL, GMRES rule"] = spectral("gkl", None, 94)
    routes["svdsolve GKL, Sylvester rule"] = spectral(
        "gkl", kt.Arnoldi(tol=1e-12, krylovdim=40, maxiter=200, **quiet), 95)
    return routes


def _batch_counts(info):
    return [info.numops.tolist(), info.numiter.tolist(), info.converged.tolist()]


def batched_ad_phase(torch, np, kt, _build, smi=None, N=1024, P=4, dev="cuda", small=True):
    """Phase ``batched_ad``: gradients through batched solves
    (``ad/batched.py``) at config 2's width, ``N × N`` grid, float32 ``(N²/128,
    128)`` vectors; each forward and each backward driven with the launch
    counts set to 0 just before it and read just after.

    (a) the wells of phase ``ad_impurity`` (:func:`_impurity_op`), their
    depths scaled by :data:`BATCHED_AD_SCALES` a problem: ``P`` banded
    operators, config 2's Poisson planes with ``g_p`` on the main plane
    (:func:`banded_with_main`), so the forward's lock-steps are batched K3
    launches with a plane set per problem; ``eigsolve_lanczos_batched``
    (krylovdim 30, maxiter 10, tol 1e-5, 4 "SR", the shared start of phase
    ``ad_impurity``) and the gradient of the sum over the problems of the
    four lowest values through the GMRES rule (the ``P × 4`` bordered
    systems in one ``linsolve_gmres_batched``, each a per-problem callable
    whose adjoint apply is a one-problem K3 launch).  Guards per problem,
    phase ``ad_impurity``'s: four converged values ascending, distinct,
    below 0; ``g_p.grad`` within 1e-3 of Hellmann–Feynman ``Σᵢ v_{p,i}²``,
    its sum within 1e-3 of 4; and within :data:`BATCHED_AD_TOL_ONE` of its
    one-problem ``eigsolve`` gradient (the bits reported).  Launches: the
    forward batched K3 and K2 only, the backward one-problem K3 as many as
    its inner solves' applies.
    (b) the same batch through the Sylvester rule (an ``Arnoldi``
    ``alg_rrule``: ``P`` eigensolves on ``(w, x)`` tuples in one
    ``eigsolve_arnoldi_batched``), under the same guards.
    (c) phase ``ad_potential``'s system ``(0.5 + P + diag g) x_p = b_p`` for
    ``P`` right-hand sides ``default_rng(7 + p)`` and the shared ``g``
    through ``linsolve_cg_batched`` (tol 5e-5·‖b₀‖) and the gradient of
    ``Σ_p ⟨c_p, x_p⟩`` (``c_p`` from ``default_rng(20 + p)``): ``b_p.grad``
    within 1e-3 of ``w_p``, an independent one-problem solve for ``c_p``,
    the shared ``g.grad`` within 1e-3 of ``−Σ_p w_p ⊙ x_p``; the adjoint
    solves one batched K3 launch a lock-step on the adjoint planes.
    (d) the small float64 batches of :func:`small_batched_ad_routes` on the
    card against the CPU: gradients within :data:`AD_TOL`, counts equal.
    Prints per part the forward's and the backward's launches, ms, and the
    sum of the ``P`` one-problem gradients' ms.  ``dev="cpu"`` with a small
    ``N`` rehearses (a)–(c) (no launch guard); ``small`` runs (d)."""
    from krylovkit_tpu_torch.solvers import batched as sb
    from krylovkit_tpu_torch.solvers import batched_arnoldi as sba
    from krylovkit_tpu_torch.solvers import batched_linsolve as sbl

    t0 = time.perf_counter()
    card = dev != "cpu"
    n = N * N
    R = n // 128
    base = kt.banded_from_coo(*poisson_coo(np, N, np.float32), n, device=dev)
    wells = np.zeros(n, np.float32)
    for site, depth in impurity_wells(N):
        wells[site] = depth
    wells = wells.reshape(R, 128)
    x0 = torch.as_tensor(np.random.default_rng(6).standard_normal((R, 128)).astype(np.float32),
                         device=dev)
    scales = BATCHED_AD_SCALES[:P]
    alg = kt.Lanczos(krylovdim=30, maxiter=10, tol=1e-5)
    out = {"launches": {}}
    one_problem = {"banded_spmv", "transform_partial"}

    def wells_batch(rr):
        gs = [torch.as_tensor(wells * sc, device=dev).requires_grad_(True) for sc in scales]
        ops = [banded_with_main(torch, kt, base, g) for g in gs]
        (vals, vecs, info), fwd_ms, fwd_l = _sync_ms(
            torch, _build, lambda: kt.eigsolve_lanczos_batched(
                ops, x0, 4, "SR", alg, in_dims=(0, None), alg_rrule=rr), dev)
        # the infos of the rule's batched inner solves
        records, restore = (counting_calls(sba, "eigsolve_arnoldi_batched", lambda r: r[-1])
                            if rr is not None else
                            counting_calls(sb, "linsolve_gmres_batched", lambda r: r[-1]))
        try:
            _, bwd_ms, bwd_l = _sync_ms(torch, _build, lambda: vals.sum().backward(), dev)
        finally:
            restore()
        inner = records[-1]
        one_ms, bits, rel = [], [], []
        for p, g in enumerate(gs):
            g1 = g.detach().clone().requires_grad_(True)
            op1 = banded_with_main(torch, kt, base, g1)

            def one():
                v1, _, _ = kt.eigsolve(op1, x0, 4, "SR", ishermitian=True, krylovdim=30,
                                       maxiter=10, tol=1e-5, alg_rrule=rr)
                v1.sum().backward()
                return v1

            v1, ms1, _ = _sync_ms(torch, _build, one, dev)
            one_ms.append(ms1)
            bits.append(bool(torch.equal(g.grad, g1.grad)) and bool(torch.equal(vals[p], v1)))
            rel.append(float((g.grad - g1.grad).abs().max() / g1.grad.abs().max()))
        vh = vals.detach().cpu().double()
        hf = [(vecs[p].detach().double() ** 2).sum(0) for p in range(P)]
        hf_err = [float((g.grad.double() - h).abs().max() / h.abs().max())
                  for g, h in zip(gs, hf)]
        sums = [float(g.grad.double().sum()) for g in gs]
        k3_back = int(inner.numops.sum())
        rec = {"phase": "batched_ad", "part": "wells_gmres" if rr is None else "wells_sylvester",
               "n": n, "P": P, "scales": list(scales), "vals": vh.tolist(),
               "counts": _batch_counts(info), "inner_counts": _batch_counts(inner),
               "forward_ms": fwd_ms, "backward_ms": bwd_ms,
               "one_problem_forward_backward_ms": one_ms,
               "sum_one_problem_ms": sum(one_ms), "launches_forward": fwd_l,
               "launches_backward": bwd_l, "predicted_backward_banded_spmv": k3_back,
               "hellmann_feynman_rel_err": hf_err, "grad_sums": sums,
               "one_problem_rel_diff": rel, "one_problem_bit_identical": bits,
               "tolerance_one_problem": BATCHED_AD_TOL_ONE, "nvidia_smi": smi}
        emit(rec)
        tag = f"batched_ad {rec['part']}"
        for p in range(P):
            require(int(info.converged[p]) >= 4, f"{tag}: problem {p} 4 values converged")
            require(bool((vh[p, 1:] > vh[p, :-1]).all()) and float(vh[p, -1]) < 0,
                    f"{tag}: problem {p} values ascending, distinct, below 0 ({vh[p].tolist()})")
            require(hf_err[p] <= 1e-3, f"{tag}: problem {p} g.grad within 1e-3 of sum v_i^2 "
                    f"({hf_err[p]})")
            require(abs(sums[p] - 4) <= 1e-3, f"{tag}: problem {p} g.grad sums to 4 ({sums[p]})")
            require(rel[p] <= BATCHED_AD_TOL_ONE, f"{tag}: problem {p} within "
                    f"{BATCHED_AD_TOL_ONE} of its one-problem gradient ({rel[p]})")
        for launches in (fwd_l, bwd_l):
            require(not {"fused_step", "project", "unproject", "fused_step_batched",
                         "project_batched", "unproject_batched"} & set(launches),
                    f"{tag}: no K1, K5 or K6 launch ({launches})")
        if card:
            require(fwd_l.get("banded_spmv_batched", 0) > 0
                    and fwd_l.get("transform_partial_batched", 0) > 0
                    and not one_problem & set(fwd_l),
                    f"{tag}: the forward batched K3 and K2 only ({fwd_l})")
            require(bwd_l.get("banded_spmv", 0) == k3_back,
                    f"{tag}: one one-problem K3 a backward apply ({bwd_l}, {k3_back})")
        out["launches"][rec["part"]] = {"forward": fwd_l, "backward": bwd_l}

    # (a) the GMRES rule, (b) the Sylvester rule
    wells_batch(None)
    wells_batch(kt.Arnoldi(tol=1e-5, krylovdim=30, maxiter=10))

    # (c) the CG rule: P right-hand sides, the shared potential
    g = torch.as_tensor(0.5 * np.random.default_rng(7).uniform(size=(R, 128)).astype(np.float32),
                        device=dev).requires_grad_(True)
    B = torch.as_tensor(np.stack([np.random.default_rng(7 + p).standard_normal((R, 128))
                                  for p in range(P)]).astype(np.float32),
                        device=dev).requires_grad_(True)
    C = torch.as_tensor(np.stack([np.random.default_rng(20 + p).standard_normal((R, 128))
                                  for p in range(P)]).astype(np.float32), device=dev)
    tol = 5e-5 * float(torch.linalg.vector_norm(B[0].detach()))
    cg = kt.CG(maxiter=400, tol=tol)
    op = banded_with_main(torch, kt, base, g)
    (X, info), fwd_ms, fwd_l = _sync_ms(
        torch, _build, lambda: kt.linsolve_cg_batched(op, B, torch.zeros_like(B), 0.5, 1.0, cg),
        dev)
    records, restore = counting_calls(sbl, "linsolve_cg_batched", lambda r: r[-1])
    try:
        _, bwd_ms, bwd_l = _sync_ms(torch, _build, lambda: torch.sum(C * X).backward(), dev)
    finally:
        restore()
    back = records[-1]
    with torch.no_grad():
        opd = banded_with_main(torch, kt, base, g.detach())
        one_ms, ws, errs_b = [], [], []
        for p in range(P):
            (w, _), ms1, _ = _sync_ms(torch, _build, lambda p=p: kt.linsolve(
                opd, C[p], a0=0.5, alg=cg), dev)
            one_ms.append(ms1)
            ws.append(w)
            errs_b.append(float((B.grad[p] - w).abs().max()) / float(w.abs().max()))
        gw = -sum(w * x for w, x in zip(ws, X.detach()))
        err_g = float((g.grad - gw).abs().max()) / float(gw.abs().max())
    rec = {"phase": "batched_ad", "part": "potential_cg", "n": n, "P": P, "tol": tol,
           "counts": _batch_counts(info), "inner_counts": _batch_counts(back),
           "forward_ms": fwd_ms, "backward_ms": bwd_ms,
           "independent_solves_ms": one_ms, "sum_one_problem_ms": sum(one_ms),
           "launches_forward": fwd_l, "launches_backward": bwd_l,
           "b_grad_rel_err": errs_b, "g_grad_rel_err": err_g, "nvidia_smi": smi}
    emit(rec)
    require(all(int(c) == 1 for c in info.converged) and all(int(c) == 1 for c in back.converged),
            "batched_ad potential_cg: the forward and adjoint solves converge")
    require(max(errs_b) <= 1e-3, f"batched_ad potential_cg: b_p.grad within 1e-3 of w_p ({errs_b})")
    require(err_g <= 1e-3, f"batched_ad potential_cg: g.grad within 1e-3 of -sum w_p*x_p ({err_g})")
    if card:
        for side, launches, info_ in (("forward", fwd_l, info), ("backward", bwd_l, back)):
            require(set(launches) == {"banded_spmv_batched"}
                    and launches["banded_spmv_batched"] == int(info_.numops.max()),
                    f"batched_ad potential_cg: the {side} one batched K3 a lock-step "
                    f"({launches}, {info_.numops.tolist()})")
    out["launches"]["potential_cg"] = {"forward": fwd_l, "backward": bwd_l}

    # (d) the small float64 batches, card against CPU
    if small:
        cases = []
        for label, run in small_batched_ad_routes(np, kt, torch).items():
            gc, ic = run(dev)
            gh, ih = run("cpu")
            err = max(_rel_err(torch, a, b) for a, b in zip(gc, gh))
            cc, ch = [_batch_counts(i) for i in ic], [_batch_counts(i) for i in ih]
            cases.append({"route": label, "max_rel_err": err, "counts": cc})
            require(err <= AD_TOL, f"batched_ad small {label}: card vs CPU within {AD_TOL} "
                    f"({err})")
            require(cc == ch, f"batched_ad small {label}: counts equal ({cc}, {ch})")
        emit({"phase": "batched_ad_small", "tolerance": AD_TOL, "routes": cases})
    emit({"phase": "batched_ad_seconds", "seconds": time.perf_counter() - t0})
    return out


def mean(xs):
    return sum(xs) / len(xs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one config-1 and one config-4 solve (phase 39)")
    ap.add_argument("--parent", metavar="DIR",
                    help="an unpacked earlier tree: time its K1 and K2 on this card as parent_ms")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only time K1 and K2 of the package under --root; one JSON line")
    ap.add_argument("--root", default=ROOT, help="tree whose package --kernel-times loads")
    args = ap.parse_args()
    if args.kernel_times:
        return kernel_times(args.root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import krylovkit_tpu_torch as kt
    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.ops import banded as bd
    from krylovkit_tpu_torch.ops import basis as bs
    from krylovkit_tpu_torch.ops import fused_lanczos as fl
    from krylovkit_tpu_torch.ops import projections as pb
    from krylovkit_tpu_torch.ops import stencil_1d as s1
    from krylovkit_tpu_torch.factorizations import krylov as kf
    from krylovkit_tpu_torch.solvers import arnoldi as arn
    from krylovkit_tpu_torch.solvers import expintegrator as expi
    from krylovkit_tpu_torch.solvers import lssolve as lss
    from krylovkit_tpu_torch.solvers import svdsolve as svds

    t_start = t_lap = time.perf_counter()

    def phase_done(name):
        """One line: the seconds of the phase that ends here, and since the
        script began."""
        nonlocal t_lap
        now = time.perf_counter()
        emit({"phase_done": name, "seconds": now - t_lap, "total_seconds": now - t_start})
        t_lap = now

    # 1. device
    smi = nvidia_smi_line()
    print(smi, flush=True)
    tf32 = {
        "matmul": torch.backends.cuda.matmul.allow_tf32,
        "cudnn": torch.backends.cudnn.allow_tf32,
    }
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi, "tf32": tf32})
    require(not any(tf32.values()), "TF32 is off")
    phase_done("device")

    # 2. build
    secs = _build.build()
    report = {}
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        lines = log.read_text().splitlines() if log.exists() else []
        report[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "ptxas": report})
    phase_done("build")

    # 3. kernels at the shapes of the paths below (the parent tree's K1 and
    # K2, where one is given, before and after)
    parent_runs = [parent_kernel_times(args.parent)] if args.parent else []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n, kmax = 1 << 21, 31
    R = n // 128
    chain = kt.laplacian_1d(n)
    k1_cases = [check_fused_step(torch, fl, chain, R, kmax, B, B, True, gen) for B in (4, 16, 30)]
    k1_cases.append(check_fused_step(torch, fl, chain, R, kmax, 16, 16, False, gen))
    grid = kt.poisson_2d(1024, 1024)
    k1_cases.append(check_fused_step(torch, fl, grid, (1024 * 1024) // 128, kmax, 16, 16, True, gen))
    # K1 beyond the paths' shapes, untimed: the smallest B, the wide-B
    # instantiations, a run that ends inside a tile, R below one tile, kp1 > B,
    # and on the grid a B whose staged rows do not fit with the halo lag
    for op_x, R_x, kmax_x, B_x, kp1_x, drift_x in (
            (chain, R, kmax, 1, 1, True), (chain, R, kmax, 2, 2, True),
            (chain, 2048, 64, 40, 40, True), (chain, 2048, 127, 100, 100, False),
            (chain, 8200, kmax, 16, 16, True), (chain, 3, kmax, 4, 4, True),
            (chain, R, kmax, 5, 9, True), (grid, 8192, 64, 63, 63, True)):
        k1_cases.append(check_fused_step(torch, fl, op_x, R_x, kmax_x, B_x, kp1_x, drift_x, gen,
                                         timed=False))
    # config 3's fused GKL solve: the adjoint spec of its non-symmetric grid
    # stencil (the codomain half-steps), drift on, kp1 = B.  With krylovdim 30
    # the solve launches B <= 29 over U; B = 31 needs a 32-row basis (untimed)
    advect = kt.GridStencilOperator((1024, 1024), ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
                                    (4.0, -1.5, -0.5, -1.2, -0.8))
    for B_x in (1, 12, 23, 29):
        k1_cases.append(check_fused_step(torch, fl, advect, 8192, kmax, B_x, B_x, True, gen,
                                         adjoint=True))
    k1_cases.append(check_fused_step(torch, fl, advect, 8192, 32, 31, 31, True, gen, timed=False,
                                     adjoint=True))
    k1_cases.append(check_fused_step(torch, fl, advect, 8192, kmax, 28, 28, True, gen))
    # the first domain half-step of that solve: no live row, kp1 = 0
    k1_cases.append(check_fused_step(torch, fl, advect, 8192, kmax, 0, 0, True, gen))
    k1_cases.append(check_fused_step(torch, fl, chain, 3, kmax, 0, 2, False, gen, timed=False))
    # K1 with non-zero external halos (a rank's block of a split vector): the
    # chain and grid specs at config 1's and config 2's shapes, timed beside
    # the launch without them on the same inputs (ms_null), and at the block
    # shapes of phase sharded_fused (two ranks: R/2 rows each)
    k1_ext = [check_fused_step(torch, fl, chain, R, kmax, B, B, True, gen, ext=True)
              for B in (1, 12, 30)]
    k1_ext += [check_fused_step(torch, fl, grid, (1024 * 1024) // 128, kmax, B, B, True, gen,
                                ext=True) for B in (16, 30)]
    k1_ext += [check_fused_step(torch, fl, chain, R // 2, kmax, 16, 16, True, gen, ext=True),
               check_fused_step(torch, fl, grid, (1024 * 1024) // 256, kmax, 16, 16, True, gen,
                                ext=True)]
    k1_ext += [check_fused_step(torch, fl, op_x, R_x, kmax_x, B_x, kp1_x, drift_x, gen,
                                timed=False, ext=True)
               for op_x, R_x, kmax_x, B_x, kp1_x, drift_x in (
                   (chain, R, kmax, 0, 1, False), (chain, 16, kmax, 12, 12, False),
                   (chain, 2048, 64, 40, 40, True), (grid, 8192, 64, 63, 63, True),
                   (kt.StencilOperator((-200, 0, 200), (0.3, 1.0, -0.4)), 64, kmax, 5, 9, True))]
    k2_cases = [check_transform(torch, bs, kmax, R, m, gen) for m in (20, 4)]
    # the two rotations of a GKL restart in config 3's rectangular solve:
    # (31, 8192, 128) over U (timed below as config 4's shape) and (31, 4096,
    # 128) over V, m_out = keep_max + 1 = 21
    k2_cases.append(check_transform(torch, bs, kmax, 4096, 21, gen))
    # K2 on every rung of its ladder (kmax <= 16, 32, 64, 128) and in bfloat16
    for kmax_x, m_x in ((16, 9), (33, 20), (64, 40), (128, 70)):
        k2_cases.append(check_transform(torch, bs, kmax_x, 64, m_x, gen, timed=False))
    k2_bf16 = check_transform(torch, bs, kmax, R, 20, gen, dtype=torch.bfloat16)
    # K3: the config-2 matrix as a banded operator (built from numpy COO),
    # halfband 8 at n = 2^21, float64, and a ragged n
    nx = 1024
    n2 = nx * nx
    coo = poisson_coo(np, nx, np.float32)
    banded = kt.banded_from_coo(*coo, n2)
    require(banded.offsets == (-nx, -1, 0, 1, nx) and banded.nnz == 5 * n2 - 4 * nx,
            f"banded Poisson: offsets {banded.offsets}, nnz {banded.nnz}")
    half8 = tuple(range(-8, 9))
    xb = torch.randn((n2 // 128, 128), generator=gen, device="cuda")
    xh8 = torch.randn(n, generator=gen, device="cuda")
    D8 = torch.randn((len(half8), R, 128), generator=gen, device="cuda")
    D300 = torch.randn((3, 3, 128), generator=gen, device="cuda")
    x300 = torch.randn(300, generator=gen, device="cuda")
    flush = torch.empty(32 << 20, device="cuda")  # 128 MB, written to clear L2
    k3_cases = [
        check_banded(torch, bd, "poisson_2d banded f32", xb, banded.diags, banded.offsets, n2, flush),
        check_banded(torch, bd, "halfband 8 f32", xh8, D8, half8, n, flush),
        check_banded(torch, bd, "poisson_2d banded f64", xb.double(), banded.diags.double(),
                     banded.offsets, n2, flush),
        check_banded(torch, bd, "ragged n=300 f32", x300, D300, (-2, 0, 5), 300, flush),
    ]
    del xh8, D8
    k4_cases = [check_laplacian(torch, s1, n, dt, gen, flush) for dt in (torch.float32, torch.float64)]
    # config 4's matrix (n = 2^20) as a stencil and as a banded operator; K1
    # on its chain spec, K2 at the Krylov-Schur restart's m_out = keep_max + 1
    # = 21, K3 on its three offsets, K5/K6 at its (31, 8192, 128) basis
    n4 = 1 << 20
    R4 = n4 // 128
    nonsym = kt.StencilOperator((-1, 0, 1), (-1.3, 2.0, -0.7))
    k1_cases.append(check_fused_step(torch, fl, nonsym, R4, kmax, 18, 18, True, gen))
    k2_cases.append(check_transform(torch, bs, kmax, R4, 21, gen))
    banded4 = kt.banded_from_coo(*tridiagonal_coo(np, n4, -1.3, 2.0, -0.7, np.float32), n4)
    require(banded4.offsets == (-1, 0, 1) and banded4.nnz == 3 * n4 - 2,
            f"banded transport-diffusion: offsets {banded4.offsets}, nnz {banded4.nnz}")
    x4 = torch.randn((R4, 128), generator=gen, device="cuda")
    k3_cases.append(check_banded(torch, bd, "transport-diffusion banded f32", x4, banded4.diags,
                                 banded4.offsets, n4, flush))
    k5_cases, k6_cases = check_projections(torch, pb, kmax, R4, (0, 1, 18, 30, 31), gen,
                                           timed=(18, 30))
    k5_small, k6_small = check_projections(torch, pb, 13, 16, (0, 5, 13), gen)
    k5_cases += k5_small
    k6_cases += k6_small
    del flush, x4
    k2_cases.append(k2_bf16)
    emit({"phase": "kernels", "fused_step": k1_cases, "fused_step_external_halos": k1_ext,
          "transform_partial": k2_cases,
          "banded_spmv": k3_cases, "laplacian_1d": k4_cases,
          "project": k5_cases, "unproject": k6_cases,
          "fused_step_library": "none: no single PyTorch call computes the fused step"})

    # per-launch times over the main path's schedule; the plain version at
    # three B only
    m = KRYLOVDIM
    schedule = k1_schedule()
    spec = fl.spec_for(chain)
    V = torch.randn((kmax, R, 128), generator=gen, device="cuda")
    y = torch.randn((R, 128), generator=gen, device="cuda")
    g = torch.randn(kmax + 1, generator=gen, device="cuda")
    per_B = {}
    for B in sorted(set(schedule)):
        t_bound, _ = bound((B + 3) * n * 4, k1_flops(n, B, 3, True))
        per_B[B] = {
            "ms": device_ms(torch, lambda: fl.fused_step(V, y, g, B, B, spec, True), reps=5),
            "bound_ms": t_bound,
        }
    plain_B = {B: device_ms(torch, lambda: fl.fused_step_reference(V, y, g, B, B, spec, True),
                            reps=2, batches=1) for B in (4, 16, 29)}
    del V, y, g
    if args.parent:
        parent_runs.append(parent_kernel_times(args.parent))

    def parent_mean(table, key):
        """Mean of the parent tree's time at ``key``; null without a parent
        or where it did not time that shape."""
        times = [run["kernel_times"][table].get(key) for run in parent_runs]
        return mean(times) if times and None not in times else None

    for case in k1_cases:
        if "ms" in case and not case["adjoint_spec"]:
            kind = "grid" if case["op"] == "grid" else ("chain" if case["n"] == n else "nonsym")
            case["parent_ms"] = parent_mean("k1", k1_key(kind, case["n"], case["B"], case["with_drift"]))
    for case in k2_cases:
        if "ms" in case and case["dtype"] == "torch.float32":
            case["parent_ms"] = parent_mean("k2", k2_key(case["kmax"], case["n"], case["m_out"]))
    for B in per_B:
        per_B[B]["parent_ms"] = parent_mean("k1_schedule", str(B))
    k1_sum = sum(per_B[B]["ms"] for B in schedule)
    emit({"phase": "kernel_times", "nvidia_smi": smi,
          "fused_step": [{k: c[k] for k in ("op", "adjoint_spec", "n", "B", "with_drift", "ms",
                                            "parent_ms", "bound_ms", "plain_ms")}
                         for c in k1_cases if "ms" in c],
          "fused_step_schedule": {"per_B": per_B, "sum_ms": k1_sum,
                                  "mean_ms": k1_sum / len(schedule),
                                  "bound_mean_ms": mean([per_B[B]["bound_ms"] for B in schedule]),
                                  "parent_sum_ms": (sum(per_B[B]["parent_ms"] for B in schedule)
                                                    if parent_runs else None),
                                  "plain_ms": plain_B},
          "transform_partial": [{k: c[k] for k in ("kmax", "n", "m_out", "dtype", "ms", "parent_ms",
                                                   "bound_ms", "plain_ms", "library_ms")}
                                for c in k2_cases if "ms" in c],
          "parent": os.path.abspath(args.parent) if args.parent else None})
    t2 = {c["m_out"]: c for c in k2_cases if c["n"] == n and c["dtype"] == "torch.float32" and "ms" in c}
    k2_schedule = [20] * 10 + [4]

    phase_done("kernels")

    # 4. small solve: card vs CPU (plain versions)
    xs = torch.randn((32, 128), generator=torch.Generator().manual_seed(1))
    alg_s = kt.Lanczos(krylovdim=30, maxiter=6, verbosity=kt.SILENT)
    vc, _, ic = kt.eigsolve_lanczos(kt.laplacian_1d(4096), xs.cuda(), 4, "LM", alg_s)
    vh, _, ih = kt.eigsolve_lanczos(kt.laplacian_1d(4096, device="cpu"), xs, 4, "LM", alg_s)
    small_err = float(torch.max(torch.abs(vc.cpu() - vh) / torch.abs(vh)))
    emit({"phase": "small", "n": 4096, "vals_cuda": vc.tolist(), "vals_cpu": vh.tolist(),
          "max_rel_err": small_err, "tolerance": 2e-4,
          "numops": [ic.numops, ih.numops], "numiter": [ic.numiter, ih.numiter]})
    require(small_err <= 2e-4, "small solve: card vs CPU values rtol 2e-4")
    require(ic.numops == ih.numops and ic.numiter == ih.numiter, "small solve: counts equal")

    phase_done("small")

    # 5. main path at the bench configuration
    op = kt.laplacian_1d(n)
    x0 = torch.ones((R, 128), dtype=torch.float32, device="cuda")
    alg = kt.Lanczos(krylovdim=m, maxiter=10, tol=1e-30, verbosity=kt.SILENT)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, vecs, info = kt.eigsolve_lanczos(op, x0, 4, "LM", alg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    require(launches.get("fused_step", 0) > 0, "main path launched fused_step")
    require(launches.get("transform_partial", 0) > 0, "main path launched transform_partial")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        vals, vecs, info = kt.eigsolve_lanczos(op, x0, 4, "LM", alg)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    vals_h = vals.cpu()
    require(bool(torch.all(torch.abs(vals_h - 4.0) <= 2e-2)), f"vals ~ 4 (atol 2e-2): {vals_h.tolist()}")
    require(tuple(vecs.shape) == (4, R, 128) and bool(torch.isfinite(vecs).all()), "finite vecs")
    vnorm = torch.linalg.vector_norm(vecs.reshape(4, -1), dim=1).cpu()
    require(bool(torch.all(torch.abs(vnorm - 1) < 1e-3)), f"unit eigenvectors: {vnorm.tolist()}")
    require(info.numops == 138, f"numops 138 (got {info.numops})")
    require(launches == {"fused_step": len(schedule), "transform_partial": len(k2_schedule)},
            f"launches {launches}")
    k1_ms = sum(per_B[B]["ms"] for B in schedule)
    k2_ms = sum(t2[mo]["ms"] for mo in k2_schedule)
    value = info.numops * 3 * n / dt
    emit({
        "metric": "lanczos_eigsolve_spmv_orthog_throughput", "value": value, "unit": "nnz/s",
        "numops": info.numops, "numiter": info.numiter, "ms_per_solve": dt * 1e3,
        "first_solve_ms": first_s * 1e3, "vals": vals_h.tolist(),
        "normres": info.normres.cpu().tolist(), "launches_per_solve": launches,
        "kernel_ms_per_solve": {"fused_step": k1_ms, "transform_partial": k2_ms},
        "outside_kernels_ms_per_solve": dt * 1e3 - k1_ms - k2_ms,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
    })

    phase_done("main")

    # 6. small linear solves: card vs CPU (plain versions).  MINRES runs on
    # the 32x32 grid, where a0 = -0.1 lies inside the Laplacian's spectrum
    # [0.018, 7.98]; on larger indefinite grids its Lanczos vectors lose
    # orthogonality over ~300 iterations and differently rounded runs end a
    # few iterations apart.  The CPU run converges in 74 applies.
    quiet = {"verbosity": kt.SILENT}
    small_ls = []
    for name, gx, a0, alg_ls in [
        ("cg", 64, 0.5, kt.CG(tol=1e-8, maxiter=300, **quiet)),
        ("gmres30", 64, 0.5, kt.GMRES(krylovdim=30, tol=1e-8, maxiter=50, **quiet)),
        ("bicgstab", 64, 0.5, kt.BiCGStab(tol=1e-8, maxiter=300, **quiet)),
        ("minres", 32, -0.1, kt.MINRES(tol=1e-8, maxiter=300, **quiet)),
    ]:
        coo_s = poisson_coo(np, gx, np.float64)
        bh = torch.ones((gx * gx // 128, 128), dtype=torch.float64)
        _build.reset_launches()
        xc, ic = kt.linsolve(kt.banded_from_coo(*coo_s, gx * gx), bh.cuda(), a0=a0, alg=alg_ls)
        spmv = _build.launches["banded_spmv"]
        xh, ih = kt.linsolve(kt.banded_from_coo(*coo_s, gx * gx, device="cpu"), bh, a0=a0,
                             alg=alg_ls)
        rel = float((xc.cpu() - xh).abs().max() / xh.abs().max())
        small_ls.append({"solver": name, "grid": f"{gx}x{gx}", "a0": a0, "dtype": "float64",
                         "numops": [ic.numops, ih.numops], "numiter": [ic.numiter, ih.numiter],
                         "converged": [ic.converged, ih.converged], "x_max_rel_err": rel,
                         "tolerance": 1e-8, "banded_spmv_launches": spmv})
        require(ic.converged == ih.converged == 1, f"small {name}: converged on card and CPU")
        require((ic.numops, ic.numiter) == (ih.numops, ih.numiter), f"small {name}: counts equal")
        require(rel <= 1e-8, f"small {name}: x card vs CPU within rtol 1e-8")
        require(spmv == ic.numops, f"small {name}: one banded_spmv launch per operator apply")
    # fused GMRES in float32 on a grid of 128 columns (the fused path's
    # condition); tol 1e-3 is 1.1e-5 of |b|, and float32 noise of such a
    # solve is ~1e-6 of max|x|
    bf = torch.ones((64, 128))
    alg_f = kt.GMRES(krylovdim=30, tol=1e-3, maxiter=20, **quiet)
    _build.reset_launches()
    xc, ic = kt.linsolve(kt.poisson_2d(64, 128), bf.cuda(), a0=0.5, alg=alg_f)
    k1_small = _build.launches["fused_step"]
    xh, ih = kt.linsolve(kt.poisson_2d(64, 128, device="cpu"), bf, a0=0.5, alg=alg_f)
    rel = float((xc.cpu() - xh).abs().max() / xh.abs().max())
    small_ls.append({"solver": "gmres30 fused", "grid": "64x128", "a0": 0.5, "dtype": "float32",
                     "numops": [ic.numops, ih.numops], "numiter": [ic.numiter, ih.numiter],
                     "converged": [ic.converged, ih.converged], "x_max_rel_err": rel,
                     "tolerance": 2e-5, "fused_step_launches": k1_small})
    emit({"phase": "small_linsolve", "solves": small_ls})
    require(ic.converged == ih.converged == 1 and ic.numiter == ih.numiter,
            "small fused GMRES: converged on both, numiter equal")
    require(rel <= 2e-5 and k1_small > 0, "small fused GMRES: x within 2e-5, fused_step launched")

    phase_done("small_linsolve")

    # 7. config 2 at full size
    grid_spec = fl.spec_for(grid)
    n1 = 1 << 21
    b2 = torch.ones((n2 // 128, 128), device="cuda")
    b1 = torch.ones(n1, device="cuda")
    lap = kt.laplacian_1d_pallas(n1)
    k3_main, k4_main = k3_cases[0], k4_cases[0]
    solves = [
        # (metric, operator, b, a0, algorithm, linsolve keywords, nnz per apply, must converge)
        ("cg_poisson_2d", grid, b2, 0.5, kt.CG(tol=5e-5, maxiter=400, **quiet),
         {"ishermitian": True, "isposdef": True}, 5 * n2, True),
        ("gmres30_poisson_2d", grid, b2, 0.0,
         kt.GMRES(krylovdim=30, tol=1e-4, maxiter=14, **quiet), {}, 5 * n2, False),
        ("gmres30_poisson_2d_shifted_convergent", grid, b2, 0.5,
         kt.GMRES(krylovdim=30, tol=5e-5, maxiter=20, **quiet), {}, 5 * n2, True),
        ("cg_poisson_2d_banded", banded, b2, 0.5, kt.CG(tol=5e-5, maxiter=400, **quiet),
         {"ishermitian": True, "isposdef": True}, 5 * n2, True),
        ("gmres30_poisson_2d_banded_shifted_convergent", banded, b2, 0.5,
         kt.GMRES(krylovdim=30, tol=5e-5, maxiter=20, **quiet), {}, 5 * n2, True),
        # tol 1e-3 = 6.9e-7 of |b|: the same solve on the CPU (plain versions)
        # converges in 9 iterations to a true residual of 4.2e-4
        ("bicgstab_laplacian_1d_pallas", lap, b1, 0.5, kt.BiCGStab(tol=1e-3, maxiter=100, **quiet),
         {}, 3 * n1, True),
    ]
    Vg = torch.randn((kmax, n2 // 128, 128), generator=gen, device="cuda")
    yg = torch.randn((n2 // 128, 128), generator=gen, device="cuda")
    gg = torch.randn(kmax + 1, generator=gen, device="cuda")
    grid_ms = {}
    config2_launches = {}
    xs_by_metric = {}
    for metric, op2, b, a0, alg2, kw, nnz, must_converge in solves:
        (x, info2), launches2, steps2, _, first_ms, ms = drive_counted(
            torch, _build, fl, pb, lambda: kt.linsolve(op2, b, a0=a0, alg=alg2, **kw), reps=3)
        Bs = [(B, drift) for B, drift, _ in steps2]
        for key, count in launches2.items():
            config2_launches[key] = config2_launches.get(key, 0) + count
        xs_by_metric[metric] = x
        true_res = float(torch.linalg.vector_norm(b - (a0 * x + op2.normal(x))))
        kernel_ms = {}
        if Bs:
            for key in set(Bs):
                if key not in grid_ms:
                    grid_ms[key] = device_ms(
                        torch, lambda: fl.fused_step(Vg, yg, gg, key[0], key[0], grid_spec, key[1]),
                        reps=5,
                    )
            kernel_ms["fused_step"] = sum(grid_ms[key] for key in Bs)
        if launches2.get("banded_spmv"):
            kernel_ms["banded_spmv"] = launches2["banded_spmv"] * k3_main["ms"]
        if launches2.get("laplacian_1d"):
            kernel_ms["laplacian_1d"] = launches2["laplacian_1d"] * k4_main["ms"]
        emit({
            "metric": metric, "value": info2.numops * nnz / ms / 1e6, "unit": "Gnnz/s",
            "formula": f"numops * {nnz // b.numel()}n / t (benchmarks/run_all.py)",
            "converged": info2.converged, "numops": info2.numops, "numiter": info2.numiter,
            "ms_per_solve": ms, "first_solve_ms": first_ms, "tol": alg2.tol,
            "normres": float(info2.normres), "true_residual": true_res,
            "launches_per_solve": launches2, "fused_step_B_mean": (sum(B for B, _ in Bs) / len(Bs)
                                                                  if Bs else None),
            "kernel_ms_per_solve": kernel_ms,
            "outside_kernels_ms_per_solve": ms - sum(kernel_ms.values()),
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        })
        require(launches2.get("fused_step", 0) == len(Bs), f"{metric}: fused steps recorded")
        if must_converge:
            require(info2.converged == 1 and true_res <= alg2.tol,
                    f"{metric}: converged, true residual {true_res} within tol {alg2.tol}")
        if op2 is banded:
            require(launches2.get("banded_spmv", 0) == info2.numops,
                    f"{metric}: banded_spmv launches == numops")
    require(config2_launches.get("fused_step", 0) > 0, "gmres30_poisson_2d launched fused_step")
    require(config2_launches.get("laplacian_1d", 0) > 0, "bicgstab launched laplacian_1d")
    for banded_metric, stencil_metric in (
        ("cg_poisson_2d_banded", "cg_poisson_2d"),
        ("gmres30_poisson_2d_banded_shifted_convergent", "gmres30_poisson_2d_shifted_convergent"),
    ):
        xa, xs_ = xs_by_metric[banded_metric], xs_by_metric[stencil_metric]
        rel = float((xa - xs_).abs().max() / xs_.abs().max())
        emit({"phase": "config2_agreement", "banded": banded_metric, "stencil": stencil_metric,
              "x_max_rel_err": rel, "tolerance": 1e-4})
        require(rel <= 1e-4, f"{banded_metric}: x agrees with {stencil_metric} to 1e-4")
    del Vg, yg, gg

    phase_done("config2")

    # 8. small Arnoldi solves: card vs CPU (plain versions)
    ns = 4096
    coeffs = (-1.3, 2.0, -0.7)
    xa = torch.randn((ns // 128, 128), generator=torch.Generator().manual_seed(2))
    alg_a = kt.Arnoldi(krylovdim=18, maxiter=5, tol=1e-5, **quiet)
    coo_a = tridiagonal_coo(np, ns, *coeffs, np.float32)

    def small_pair(label, make_op, flag, solve):
        """``solve(op, x0)`` → ``(values, info)`` on the card and on the CPU
        with the projection flag set to ``flag``; values to 2e-4 of the
        largest, counts equal."""
        bs.use_pallas_projections = flag
        try:
            _build.reset_launches()
            vc, ic = solve(make_op("cuda"), xa.cuda())
            counted = dict(_build.launches)
            vh, ih = solve(make_op("cpu"), xa)
        finally:
            bs.use_pallas_projections = False
        err = float((vc.cpu() - vh).abs().max() / vh.abs().max())
        rec = {"solve": label, "n": ns, "max_rel_err": err, "tolerance": 2e-4,
               "numops": [ic.numops, ih.numops], "numiter": [ic.numiter, ih.numiter],
               "launches": counted}
        require(err <= 2e-4, f"small {label}: card vs CPU values within 2e-4")
        require((ic.numops, ic.numiter) == (ih.numops, ih.numiter), f"small {label}: counts equal")
        return rec, counted, ic

    def schur_abs(op, x):
        _, _, (re, im), info = kt.schursolve(op, x, 4, "LM", alg_a)
        return torch.hypot(re, im), info

    def eig_abs(op, x):
        vals, vecs, info = kt.eigsolve(op, x, 4, "LM", alg=alg_a)
        require(vals.dtype == torch.complex64 and tuple(vecs.shape) == (4,) + tuple(x.shape),
                "small eigsolve: complex64 values, (4, R, 128) vectors")
        return vals.abs(), info

    small_a = []
    rec, counted, ic = small_pair(
        "schursolve stencil fused", lambda d: kt.StencilOperator((-1, 0, 1), coeffs), False,
        schur_abs)
    require(counted.get("fused_step", 0) == ic.numops - ic.numiter
            and counted.get("transform_partial", 0) == ic.numiter,
            f"small fused schursolve: K1 per in-stream apply, K2 per round ({counted})")
    small_a.append(rec)
    for label, solve in (("schursolve banded, projection kernels", schur_abs),
                         ("eigsolve banded, projection kernels", eig_abs)):
        rec, counted, ic = small_pair(
            label, lambda d: kt.banded_from_coo(*coo_a, ns, device=d), True, solve)
        require(counted.get("banded_spmv", 0) == ic.numops
                and counted.get("project", 0) == counted.get("unproject", 0) == 2 * ic.numops
                and counted.get("fused_step", 0) == 0,
                f"small {label}: K3 per apply, K5 and K6 twice per expansion ({counted})")
        small_a.append(rec)
    # complex64 schursolve on a small dense operator
    rng_c = np.random.default_rng(3)
    Ac = ((rng_c.standard_normal((96, 96)) + 1j * rng_c.standard_normal((96, 96))) / 96 ** 0.5
          ).astype(np.complex64)
    xc0 = torch.from_numpy((rng_c.standard_normal(96) + 1j * rng_c.standard_normal(96))
                           .astype(np.complex64))
    alg_c = kt.Arnoldi(krylovdim=20, maxiter=40, tol=2e-5, **quiet)
    outs = []
    for dev in ("cuda", "cpu"):
        Tc, Vc, valsc, infc = kt.schursolve(torch.from_numpy(Ac).to(dev), xc0.to(dev), 3, "LM", alg_c)
        Vm = Vc.cpu().numpy().T
        outs.append((valsc.cpu(), infc, float(np.linalg.norm(Ac @ Vm - Vm @ Tc.cpu().numpy()))))
    (vc, ic, res_c), (vh, ih, _) = outs
    err = float((vc - vh).abs().max() / vh.abs().max())
    small_a.append({"solve": "schursolve dense complex64", "n": 96, "max_rel_err": err,
                    "tolerance": 2e-4, "converged": [ic.converged, ih.converged],
                    "numiter": [ic.numiter, ih.numiter], "schur_residual": res_c})
    emit({"phase": "small_arnoldi", "solves": small_a})
    require(vc.dtype == torch.complex64 and err <= 2e-4 and ic.converged == ih.converged == 3,
            "small complex schursolve: 3 converged, card vs CPU values within 2e-4")
    require(res_c <= 1e-3, f"small complex schursolve: |A V - V T| = {res_c} within 1e-3")

    phase_done("small_arnoldi")

    # 9. config 4's Arnoldi solve at full size, three ways
    x04 = torch.from_numpy(np.random.default_rng(1).standard_normal((R4, 128)).astype(np.float32)).cuda()
    alg4 = kt.Arnoldi(krylovdim=m, maxiter=8, tol=1e-30, **quiet)
    k3_c4 = next(c for c in k3_cases if c["case"] == "transport-diffusion banded f32")
    k2_c4 = next(c for c in k2_cases if c["n"] == n4 and "ms" in c)
    spec4 = fl.spec_for(nonsym)
    V4 = torch.randn((kmax, R4, 128), generator=gen, device="cuda")
    y4 = torch.randn((R4, 128), generator=gen, device="cuda")
    g4 = torch.randn(kmax + 1, generator=gen, device="cuda")
    k1_ms4, proj_ms4 = {}, {}
    c4 = {}
    for metric, op4, flag in (("arnoldi_realschur_nonsym", nonsym, False),
                              ("arnoldi_realschur_nonsym_banded_proj", banded4, True),
                              ("arnoldi_realschur_nonsym_banded", banded4, False)):
        bs.use_pallas_projections = flag
        try:
            (_, _, (re4, im4), info4), launches4, steps4, sweeps4, first_ms, ms = drive_counted(
                torch, _build, fl, pb, lambda: kt.schursolve(op4, x04, 4, "LM", alg4))
        finally:
            bs.use_pallas_projections = False
        Bs, ks = [(B, drift) for B, drift, _ in steps4], [k for _, k in sweeps4]
        lam = torch.hypot(re4, im4).cpu()
        kernel_ms = {}
        if Bs:
            for key in set(Bs):
                if key not in k1_ms4:
                    k1_ms4[key] = device_ms(
                        torch, lambda: fl.fused_step(V4, y4, g4, key[0], key[0], spec4, key[1]), reps=5)
            kernel_ms["fused_step"] = sum(k1_ms4[key] for key in Bs)
        if ks:
            for k in set(ks):
                if k not in proj_ms4:
                    kdev = torch.tensor([k], dtype=torch.int32, device="cuda")
                    proj_ms4[k] = (time_project(torch, pb, V4, y4, k, kdev, plain_reps=2),
                                   time_unproject(torch, pb, V4, g4[:kmax], k, kdev, plain_reps=2))
            kernel_ms["project"] = sum(proj_ms4[k][0]["ms"] for k in ks)
            kernel_ms["unproject"] = sum(proj_ms4[k][1]["ms"] for k in ks)
        if launches4.get("banded_spmv"):
            kernel_ms["banded_spmv"] = launches4["banded_spmv"] * k3_c4["ms"]
        kernel_ms["transform_partial"] = launches4.get("transform_partial", 0) * k2_c4["ms"]
        c4[metric] = {"lam": lam, "info": info4, "launches": launches4, "ks": ks, "Bs": Bs}
        emit({
            "metric": metric, "value": info4.numops * 3 * n4 / ms / 1e6, "unit": "Gnnz/s",
            "formula": "numops * 3n / t (benchmarks/run_all.py)", "projection_kernels": flag,
            "numops": info4.numops, "numiter": info4.numiter, "converged": info4.converged,
            "ms_per_solve": ms, "first_solve_ms": first_ms, "abs_vals": lam.tolist(),
            "im": im4.cpu().tolist(), "normres": info4.normres.cpu().tolist(),
            "launches_per_solve": launches4,
            "projection_k_mean": sum(ks) / len(ks) if ks else None,
            "fused_step_B_mean": sum(B for B, _ in Bs) / len(Bs) if Bs else None,
            "kernel_ms_per_solve": kernel_ms,
            "outside_kernels_ms_per_solve": ms - sum(kernel_ms.values()),
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        })
        require(bool(torch.isfinite(lam).all()) and bool((lam <= 4.0 + 1e-3).all()),
                f"{metric}: |lambda| inside the Gershgorin disc (<= 1.3 + 2.0 + 0.7): {lam.tolist()}")
        require(info4.numiter == 8 and 100 <= info4.numops <= 114,
                f"{metric}: 8 iterations, numops in 100..114 (got {info4.numiter}, {info4.numops})")
    fused4, proj4, plain4 = (c4[key] for key in ("arnoldi_realschur_nonsym",
                                                 "arnoldi_realschur_nonsym_banded_proj",
                                                 "arnoldi_realschur_nonsym_banded"))
    nops4, nit4 = fused4["info"].numops, fused4["info"].numiter
    require(fused4["launches"] == {"fused_step": nops4 - nit4, "transform_partial": nit4},
            f"config-4 fused solve: K1 per in-stream apply, K2 per round ({fused4['launches']})")
    require(proj4["launches"] == {"banded_spmv": nops4, "project": 2 * nops4,
                                  "unproject": 2 * nops4, "transform_partial": nit4},
            f"config-4 banded solve, projection kernels: K3 per apply, K5 and K6 twice per "
            f"expansion, K2 per round, no K1 ({proj4['launches']})")
    require(plain4["launches"] == {"banded_spmv": nops4, "transform_partial": nit4},
            f"config-4 banded solve, kernels off: K3 and K2 only ({plain4['launches']})")
    require(proj4["info"].numops == plain4["info"].numops == nops4, "config-4: numops equal across the three")
    agree = max(float(((c["lam"] - fused4["lam"]).abs() / fused4["lam"]).max()) for c in (proj4, plain4))
    emit({"phase": "config4_agreement", "abs_vals_max_rel_diff": agree, "tolerance": 1e-3,
          "numops": nops4})
    require(agree <= 1e-3, "config-4: the four leading |lambda| of the three solves agree to 1e-3")
    # the dense Schur layer: each processing round of one more fused solve
    rounds = timed_calls(torch, arn, "_process_real", lambda: kt.schursolve(nonsym, x04, 4, "LM", alg4))
    emit({"phase": "config4_process_real", "m": m, "rounds": len(rounds),
          "ms_per_round": rounds, "ms_per_round_mean": mean(rounds), "ms_per_solve": sum(rounds)})
    require(len(rounds) == nit4, "config-4: one _process_real per round")
    ks4 = proj4["ks"]
    del V4, y4, g4

    phase_done("config4_arnoldi")

    # 10. small svdsolve / lssolve / exponentiate: card vs CPU (plain versions)
    small_se = []

    def pair(label, solve, tol, counts_equal=True):
        """``solve(dev)`` → ``(values, info)`` on the card and on the CPU."""
        _build.reset_launches()
        vc, ic = solve("cuda")
        torch.cuda.synchronize()
        counted = {k: v for k, v in _build.launches.items() if v}
        vh, ih = solve("cpu")
        err = float((vc.cpu() - vh).abs().max() / vh.abs().max())
        small_se.append({"solve": label, "max_rel_err": err, "tolerance": tol,
                         "numops": [ic.numops, ih.numops], "numiter": [ic.numiter, ih.numiter],
                         "converged": [ic.converged, ih.converged], "launches": counted})
        require(err <= tol, f"small {label}: card vs CPU within {tol}")
        if counts_equal:
            require((ic.numops, ic.numiter, ic.converged) == (ih.numops, ih.numiter, ih.converged),
                    f"small {label}: counts equal")
        return counted, ic

    advect_off = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    advect_cf = (4.0, -1.5, -0.5, -1.2, -0.8)
    xg = torch.from_numpy(np.random.default_rng(51).standard_normal((32, 128)).astype(np.float32))
    for label, op_s in (("svdsolve chain stencil fused", kt.StencilOperator((-2, 0, 1), (0.4, 1.0, -0.8))),
                        ("svdsolve grid stencil fused",
                         kt.GridStencilOperator((32, 128), advect_off, advect_cf))):
        def svd_small(dev, op_s=op_s, **kw):
            vals, _, _, info = kt.svdsolve(op_s, xg.to(dev), 4, "LR", krylovdim=18, maxiter=5,
                                           tol=1e-6, verbosity=kt.SILENT, **kw)
            return vals, info

        counted, ic = pair(label, svd_small, 2e-4)
        # one launch per half-step but each tail's two
        require(counted == {"fused_step": ic.numops - 2 * ic.numiter,
                            "transform_partial": 2 * ic.numiter},
                f"small {label}: K1 per in-stream half-step, K2 twice per round ({counted})")
        vu, iu = svd_small("cuda", orth=kt.mgs2)
        require((iu.numops, iu.numiter) == (ic.numops, ic.numiter)
                and float((vu - svd_small("cuda")[0]).abs().max() / vu.abs().max()) <= 1e-3,
                f"small {label}: agrees with the unfused solve (mgs2) to 1e-3, counts equal")
    rng_s = np.random.default_rng(13)
    As = rng_s.standard_normal((200, 100)) / 200 ** 0.5
    xs0, bs0 = rng_s.standard_normal(200), rng_s.standard_normal(200)

    def svd_dense(dev):
        vals, _, _, info = kt.svdsolve(torch.from_numpy(As).to(dev), torch.from_numpy(xs0).to(dev), 4,
                                       "LR", krylovdim=25, tol=1e-10, maxiter=100, **quiet)
        return vals, info

    def ls_dense(dev):
        return kt.lssolve(torch.from_numpy(As).to(dev), torch.from_numpy(bs0).to(dev), tol=1e-10,
                          maxiter=400, **quiet)

    pair("svdsolve dense float64", svd_dense, 1e-8)
    # LSMR without reorthogonalization beyond its ring: the iteration at
    # which |zeta| passes tol may differ by one between two roundings
    _, il = pair("lssolve dense float64", ls_dense, 1e-7, counts_equal=False)
    require(il.converged == 1, "small lssolve: converged on the card")
    neg_lap = kt.StencilOperator((-1, 0, 1), (1.0, -2.0, 1.0))
    xe = torch.from_numpy(np.random.default_rng(7).standard_normal((32, 128)).astype(np.float32))
    for label, orth_e in (("exponentiate fused", kt.cgs2), ("exponentiate unfused (mgs2)", kt.mgs2)):
        counted, ic = pair(label, lambda dev: kt.exponentiate(
            neg_lap, 0.1, xe.to(dev), krylovdim=30, tol=1e-4, ishermitian=True, orth=orth_e,
            **quiet), 2e-4)
        require(("fused_step" in counted) == (orth_e is kt.cgs2) and ic.converged == 1,
                f"small {label}: converged; K1 launched by the fused solve only ({counted})")
    emit({"phase": "small_svd_exp", "solves": small_se})

    phase_done("small_svd_exp")

    # 11. small generalized and block eigensolves, ELL and complex banded:
    # card vs CPU (plain versions)
    nq = 1024
    q1_full = q1_coo(np, nq, nq, np.float32)
    emit(small_geneig_block(torch, np, kt, _build, bs, (q1_full[0], nq * nq)))

    phase_done("small_geneig_block")

    # 12. config 3 at full size: the rectangular map and the square stencil
    C3, R3 = 1 << 19, 1 << 20
    wr = torch.from_numpy(np.linspace(1.0, 3.0, C3, dtype=np.float32).reshape(C3 // 128, 128)).cuda()

    def rect(x):  # (C/128, 128) -> (R/128, 128): upsample with banded mixing
        wx = wr * x
        return torch.cat([wx, 0.5 * torch.roll(wx, 1, dims=0)], dim=0)

    def rect_adj(y):
        y0, y1 = y[: C3 // 128], y[C3 // 128:]
        return wr * y0 + 0.5 * wr * torch.roll(y1, -1, dims=0)

    x0r = torch.from_numpy(np.random.default_rng(0).standard_normal((R3 // 128, 128))
                           .astype(np.float32)).cuda()
    x0q = torch.from_numpy(np.random.default_rng(2).standard_normal((8192, 128))
                           .astype(np.float32)).cuda()
    kw3 = dict(krylovdim=m, maxiter=12, tol=1e-30, **quiet)
    k2_by_R = {c["n"] // 128: c for c in k2_cases if c["m_out"] == 21 and "ms" in c}
    Vq = torch.randn((kmax, 8192, 128), generator=gen, device="cuda")
    yq = torch.randn((8192, 128), generator=gen, device="cuda")
    gq = torch.randn(kmax + 1, generator=gen, device="cuda")
    step_ms = {}

    def steps_ms(steps):
        """Summed per-launch time of the recorded fused steps at their (B, spec)."""
        for key in set(steps):
            if key not in step_ms:
                step_ms[key] = device_ms(
                    torch, lambda: fl.fused_step(Vq, yq, gq, key[0], key[0], key[2], key[1]), reps=5)
        return sum(step_ms[key] for key in steps)

    sweep_ms = {}

    def sweeps_ms(sweeps):
        """Summed per-launch times of K5 and K6 over the recorded ``(R, k)``."""
        for R_s, k_s in set(sweeps):
            if (R_s, k_s) not in sweep_ms:
                Vs, ws, cs = Vq[:, :R_s], yq[:R_s], gq[:kmax]
                Vs = Vs.contiguous() if R_s != Vq.shape[1] else Vs
                sweep_ms[(R_s, k_s)] = (
                    device_ms(torch, lambda: pb.project_pallas(Vs, ws, k_s), reps=5),
                    device_ms(torch, lambda: pb.unproject_pallas(Vs, cs, k_s), reps=5))
        return (sum(sweep_ms[key][0] for key in sweeps), sum(sweep_ms[key][1] for key in sweeps))

    c3 = {}
    for metric, A3, x03, nnz, flag, kw in (
            ("gkl_svdsolve_rect", (rect, rect_adj), x0r, 3 * C3, False, {}),
            ("gkl_svdsolve_rect_proj", (rect, rect_adj), x0r, 3 * C3, True, {}),
            ("gkl_svdsolve_square_stencil_fused", advect, x0q, 5 * n2, False, {}),
            ("gkl_svdsolve_square_stencil_unfused", advect, x0q, 5 * n2, False, {"orth": kt.mgs2})):
        bs.use_pallas_projections = flag
        try:
            (S3, U3, W3, info3), launches3, steps3, sweeps3, first_ms, ms = drive_counted(
                torch, _build, fl, pb, lambda: kt.svdsolve(A3, x03, 8, "LR", **kw3, **kw))
        finally:
            bs.use_pallas_projections = False
        op3 = kt.as_operator(A3)
        true_res = [float(torch.linalg.vector_norm(op3.normal(W3[i]) - S3[i] * U3[i])) for i in range(3)]
        kernel_ms = {}
        if steps3:
            kernel_ms["fused_step"] = steps_ms(steps3)
        if sweeps3:
            kernel_ms["project"], kernel_ms["unproject"] = sweeps_ms(sweeps3)
        if launches3.get("transform_partial"):
            rows = (U3.shape[1], W3.shape[1])
            kernel_ms["transform_partial"] = launches3["transform_partial"] / 2 * sum(
                k2_by_R[r]["ms"] for r in rows)
        S3h = S3.cpu()
        c3[metric] = {"S": S3h, "info": info3, "launches": launches3, "steps": steps3}
        emit({
            "metric": metric, "value": info3.numops * nnz / ms / 1e6, "unit": "Gnnz/s",
            "formula": f"numops * {nnz} / t (benchmarks/run_all.py)", "projection_kernels": flag,
            "numops": info3.numops, "numiter": info3.numiter, "converged": info3.converged,
            "ms_per_solve": ms, "first_solve_ms": first_ms, "svals": S3h.tolist(),
            "normres": info3.normres.cpu().tolist(), "true_residual_leading_3": true_res,
            "launches_per_solve": launches3,
            "fused_step_B_max": max((B for B, _, _ in steps3), default=None),
            "kernel_ms_per_solve": kernel_ms,
            "outside_kernels_ms_per_solve": ms - sum(kernel_ms.values()),
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        })
        # |A| <= 3 * 1.5 (rectangular: weights <= 3, two bands 1 and 0.5),
        # <= the sum of |coefficients| = 8 (stencil); float32 slack 1e-5
        smax = (3 * 1.5 if nnz == 3 * C3 else 8.0) * (1 + 1e-5)
        require(bool(torch.isfinite(S3h).all()) and bool((S3h[:-1] >= S3h[1:]).all())
                and 0 < float(S3h[0]) <= smax,
                f"{metric}: singular values finite, descending, sigma_0 <= |A| bound {smax}: {S3h.tolist()}")
        require(tuple(U3.shape) == (8,) + tuple(x03.shape) and bool(torch.isfinite(U3).all())
                and bool(torch.isfinite(W3).all()), f"{metric}: finite triplet vectors of the expected shape")
        nr = info3.normres.cpu()
        require(all(true_res[i] <= float(nr[i]) + 1e-3 * float(S3h[0]) for i in range(3)),
                f"{metric}: |A v - sigma u| of the leading triplets within normres + 1e-3 sigma_0 "
                f"({true_res} vs {nr[:3].tolist()})")
        require(info3.numiter == 12 and info3.numops == 2 * (m + 11 * (m - 18)),
                f"{metric}: 12 rounds, numops 2*(30 + 11*12) (got {info3.numiter}, {info3.numops})")
    rect3, proj3, fused3, unfused3 = (c3[k] for k in (
        "gkl_svdsolve_rect", "gkl_svdsolve_rect_proj", "gkl_svdsolve_square_stencil_fused",
        "gkl_svdsolve_square_stencil_unfused"))
    nops3, nit3 = fused3["info"].numops, fused3["info"].numiter
    # K2: both bases at every processing round (the last round's rotations are
    # the identity).  K1: every half-step (the first of the solve with no
    # live row) but the two of each round's tail
    require(rect3["launches"] == {"transform_partial": 2 * nit3},
            f"config-3 rectangular solve: K2 twice per round, no other kernel ({rect3['launches']})")
    require(proj3["launches"] == {"transform_partial": 2 * nit3, "project": nops3, "unproject": nops3},
            f"config-3 rectangular solve, projection kernels: K5 and K6 once per half-step "
            f"({proj3['launches']})")
    require(fused3["launches"] == {"fused_step": nops3 - 2 * nit3, "transform_partial": 2 * nit3},
            f"config-3 fused solve: K1 = numops - 2*numiter, K2 = 2*numiter ({fused3['launches']})")
    require(min(B for B, _, _ in fused3["steps"]) == 0,
            "config-3 fused solve: the first domain half-step launched K1 with no live row")
    specs3 = {spec for _, _, spec in fused3["steps"]}
    require(specs3 == {fl.spec_for(advect), fl.adjoint_spec(advect)},
            "config-3 fused solve: K1 ran the normal and the adjoint spec")
    require(unfused3["launches"] == {"transform_partial": 2 * nit3},
            f"config-3 unfused stencil solve: K2 only ({unfused3['launches']})")
    k1_mean3 = steps_ms(fused3["steps"]) / len(fused3["steps"])
    agree3 = float(((fused3["S"] - unfused3["S"]).abs() / unfused3["S"]).max())
    agree3p = float(((proj3["S"] - rect3["S"]).abs() / rect3["S"]).max())
    emit({"phase": "config3_agreement", "fused_vs_unfused_max_rel_diff": agree3,
          "rect_proj_vs_plain_max_rel_diff": agree3p, "tolerance": 1e-3, "numops": nops3})
    require(agree3 <= 1e-3 and unfused3["info"].numops == nops3,
            "config-3: fused and unfused square solves agree to 1e-3 with equal numops")
    require(agree3p <= 1e-3, "config-3: rectangular solve with and without projection kernels agree to 1e-3")
    svd_rounds = timed_calls(torch, svds, "_process",
                             lambda: kt.svdsolve(advect, x0q, 8, "LR", **kw3))
    emit({"phase": "config3_process", "m": m, "rounds": len(svd_rounds), "ms_per_round": svd_rounds,
          "ms_per_round_mean": mean(svd_rounds)})
    require(len(svd_rounds) == nit3, "config-3: one projected SVD per round")

    phase_done("config3")

    # 13. config 4's exponentiate step at full size
    x0e = x04
    kwe = dict(krylovdim=m, tol=1e-4, ishermitian=True, **quiet)
    calls = []
    fused_expansions = kf.fused_expansions

    def counting(*a, **kw):
        calls.append(1)
        return fused_expansions(*a, **kw)

    kf.fused_expansions = counting
    try:
        (ye, infoe), launchese, stepse, _, first_ms, ms = drive_counted(
            torch, _build, fl, pb, lambda: kt.exponentiate(neg_lap, 0.1, x0e, **kwe))
    finally:
        kf.fused_expansions = fused_expansions
    ncalls = len(calls) // 2  # the counted solve and the timed one
    (yu, infou), launchesu, _, _, _, ms_u = drive_counted(
        torch, _build, fl, pb, lambda: kt.exponentiate(neg_lap, 0.1, x0e, orth=kt.mgs2, **kwe))
    k1_ms_e = steps_ms(stepse)
    rel_e = float(torch.linalg.vector_norm(ye - yu) / torch.linalg.vector_norm(yu))
    # exp(tA) x0 by its Taylor series in float64 with a plain three-point
    # apply: |tA| <= 0.4, so 20 terms leave ~1e-27.  Shares no code with the
    # solver
    term = x0e.reshape(-1).double()
    taylor = term.clone()
    for j in range(1, 21):
        lap = -2.0 * term
        lap[1:] += term[:-1]
        lap[:-1] += term[1:]
        term = (0.1 / j) * lap
        taylor += term
    rel_taylor = float(torch.linalg.vector_norm(ye.reshape(-1).double() - taylor)
                       / torch.linalg.vector_norm(taylor))
    rel_taylor_u = float(torch.linalg.vector_norm(yu.reshape(-1).double() - taylor)
                         / torch.linalg.vector_norm(taylor))
    del term, taylor, lap
    ny, nx0 = float(torch.linalg.vector_norm(ye)), float(torch.linalg.vector_norm(x0e))
    emit({
        "metric": "exponentiate_step", "value": infoe.numops * 3 * n4 / ms / 1e6, "unit": "Gnnz/s",
        "formula": "numops * 3n / t (benchmarks/run_all.py)",
        "numops": infoe.numops, "numiter": infoe.numiter, "converged": infoe.converged,
        "normres": float(infoe.normres), "ms_per_solve": ms, "first_solve_ms": first_ms,
        "launches_per_solve": launchese, "fused_expansions_calls": ncalls,
        "fused_step_B_max": max(B for B, _, _ in stepse),
        "kernel_ms_per_solve": {"fused_step": k1_ms_e},
        "outside_kernels_ms_per_solve": ms - k1_ms_e,
        "unfused": {"orth": "mgs2", "numops": infou.numops, "numiter": infou.numiter,
                    "ms_per_solve": ms_u, "launches_per_solve": launchesu},
        "rel_diff_fused_vs_unfused": rel_e, "norm_y_over_norm_x0": ny / nx0,
        "rel_diff_vs_taylor_float64": {"fused": rel_taylor, "unfused": rel_taylor_u},
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
    })
    require(infoe.converged == 1 and float(infoe.normres) <= 0.1 * 1e-4,
            f"exponentiate_step: converged, total error {float(infoe.normres)} within t*tol")
    require(bool(torch.isfinite(ye).all()) and ny <= (1 + 1e-4) * nx0,
            f"exponentiate_step: |y| <= (1 + 1e-4)|x0| (negative semidefinite operator): {ny / nx0}")
    require(rel_e <= 1e-4 and launchesu == {},
            f"exponentiate_step: agrees with the unfused solve to 1e-4 ({rel_e}), which launches nothing")
    require(rel_taylor <= 1e-4 and rel_taylor_u <= 1e-4,
            f"exponentiate_step: within 1e-4 of the float64 Taylor series of exp(tA) x0 "
            f"(fused {rel_taylor}, unfused {rel_taylor_u})")
    # numops = one build apply per cycle + per fused call one priming apply and
    # one in-kernel apply per launch
    require(launchese == {"fused_step": infoe.numops - infoe.numiter - ncalls},
            f"exponentiate_step: K1 = numops - numiter - fused calls ({launchese}, {ncalls} calls)")
    phi_ms = timed_calls(torch, expi, "_phi_step", lambda: kt.exponentiate(neg_lap, 0.1, x0e, **kwe))
    emit({"phase": "config4_phi_step", "calls": len(phi_ms), "ms_per_call": phi_ms,
          "ms_per_call_mean": mean(phi_ms)})
    del Vq, yq, gq

    phase_done("config4_expm")

    # 14. the Q1 pencil at full width through geneigsolve, the projection
    # kernels off and on
    geneig_launches, kg, q1_pencil = geneig_full(torch, np, kt, _build, bd, bs, fl, pb, q1_full,
                                                 nq, smi)
    del q1_full

    phase_done("geneig")

    # 15. Block Lanczos on the config-2 Poisson matrix, banded and stencil
    block_launches = block_full(torch, np, kt, _build, bd, fl, pb, banded, grid, nx, smi)
    geneig_off, geneig_on = (geneig_launches[k] for k in ("geneigsolve_golubye_q1",
                                                          "geneigsolve_golubye_q1_proj"))

    phase_done("block_lanczos")

    # 16-18. differentiable solves: every AD route card vs CPU, then the
    # eigenvalue and linear-solve gradients at config 2's width
    ad_small_launches = small_ad(torch, np, kt, _build)
    phase_done("small_ad")
    ad_imp = ad_impurity(torch, np, kt, _build, bs, bd, N=nx, smi=smi)
    phase_done("ad_impurity")
    ad_pot, _ = ad_potential(torch, np, kt, _build, bd, N=nx, smi=smi)
    phase_done("ad_potential")

    # 19-21. two-sided eigenproblems, the iterators and the Lanczos variants:
    # card vs CPU, then bieigsolve at config 4's width and the variants at
    # config 2's
    small_bieig_iter(torch, np, kt, _build)
    phase_done("small_bieig_iter")
    bieig_l = bieig_full(torch, np, kt, _build, bd, bs, fl, pb, n=n4, smi=smi)
    phase_done("bieig")
    lanczos_l = lanczos_variants(torch, np, kt, _build, bd, bs, fl, pb, N=nx, smi=smi)
    impurity = lanczos_l.pop("operator")

    phase_done("lanczos_variants")

    # 22-25. the distribution layer: ranks of one torch.distributed group on
    # this card (gloo with CUDA tensors; NCCL takes one rank per card)
    sharded = distribution_phases(torch, np, kt, _build, fl, pb, smi, vals_h,
                                  (grid, b2, xs_by_metric["gmres30_poisson_2d"]))

    phase_done("sharded_22_25")

    # 26-28. the remaining front-ends on a sharded space (small scenarios,
    # card ranks against CPU ranks; then at full width against one rank) and
    # pytree vectors in the drivers that took single tensors before
    t_slice10 = time.perf_counter()
    small_fe = small_front_ends(torch, np)
    phase_done("small_front_ends")
    sharded_fe = sharded_front_ends(torch, np, kt, _build, smi)
    phase_done("sharded_front_ends")
    rect3 = c3["gkl_svdsolve_rect"]
    tree_l = pytree_drivers(torch, np, kt, _build, {
        "rect": (rect, rect_adj, x0r), "svdsolve": (rect3["S"], rect3["info"]),
        "exponentiate": (neg_lap, x0e, (ye, infoe))}, smi)
    emit({"phase": "slice10", "seconds": time.perf_counter() - t_slice10})

    phase_done("pytree_drivers")

    # 29. gradients of sharded solves at config 2's width: two gloo ranks
    # against one rank
    ad_sharded = sharded_ad(torch, np, kt, _build, smi, N=nx)

    phase_done("sharded_ad")

    # 30. batched solves: config 1 for 8 starts and config 2's shifted
    # GMRES for 4 right-hand sides, each in one host loop
    batched = batched_phase(torch, np, kt, _build, fl, bs, smi)

    phase_done("batched")

    # 31. batched linear solves: CG and MINRES on config 2's banded Poisson
    # for 8 right-hand sides (batched K3), BiCGStab on the 1-D Laplacian
    # (batched K4), CG on 4 banded operators (a plane set per problem)
    batched_lin = batched_linear_phase(torch, np, kt, _build, bd, s1, smi)

    phase_done("batched_linear")

    # 32. batched Arnoldi and exponential integrator: config 4 for 4 starts
    # (fused schursolve, banded eigsolve with the projection kernels,
    # exponentiate), then the batched K5 and K6 alone
    batched_arn = batched_arnoldi_phase(torch, np, kt, _build, arn, expi, kf, bs, pb, smi)

    phase_done("batched_arnoldi")

    # 33. batched GKL svdsolve and LSMR lssolve: config 3 for 4 starts (the
    # fused grid stencil; the rectangular map with the projection kernels),
    # config 2's banded Poisson for 8 right-hand sides
    batched_svd = batched_gkl_phase(torch, np, kt, _build, svds, lss, bd, bs, fl, smi, rect,
                                    rect_adj)

    phase_done("batched_gkl")

    # 34. batched Golub-Ye geneigsolve on the Q1 pencil for 4 starts (two
    # batched K3 launches an apply) and batched BiArnoldi bieigsolve on
    # config 4's tridiagonal for 4 start pairs (batched K3 on the normal and
    # the adjoint planes), the projection kernels batched
    tri4 = bieig_l.pop("operator")
    batched_gb = batched_geneig_bieig_phase(torch, np, kt, _build, bd, bs, smi, q1_pencil, tri4)

    phase_done("batched_geneig_bieig")

    # 35. batched Block Lanczos on config 2's banded Poisson for 4 start
    # blocks (one batched K3 launch a lock-step over every problem's block;
    # the block QR's projections batched with the flag), shared planes and a
    # plane set per problem
    batched_bl = batched_block_lanczos_phase(torch, np, kt, _build, bd, bs, smi, banded)

    phase_done("batched_block_lanczos")

    # 36. batched solves on pytree vectors: config 1 on a tuple of two
    # leaves and config 3's rectangular map from a dict domain to a tuple
    # codomain (batched K2 leaf by leaf), then small float64 tree batches
    # through every other batched driver, card against CPU
    batched_tree = batched_pytree_phase(torch, np, kt, _build, svds, smi, rect, rect_adj)

    phase_done("batched_pytree")

    # 37. batched eager and selective solves: selective and eager Lanczos on
    # phase 21's impurity operator for 4 starts, eager schursolve, GKL,
    # BiArnoldi and exponentiate on configs 4 and 3 (depth cut), then small
    # float64 batches card against CPU
    batched_es = batched_eager_selective_phase(torch, np, kt, _build, bs, smi, impurity, tri4,
                                               rect, rect_adj)
    del impurity, tri4

    phase_done("batched_eager_selective")

    # 38. gradients through batched solves: the wells of phase 17 for 4
    # depths by both eigsolve rules, phase 18's system for 4 right-hand
    # sides by the CG rule, then small float64 batches card against CPU
    batched_ad = batched_ad_phase(torch, np, kt, _build, smi, N=nx)

    phase_done("batched_ad")

    def slice11(name):
        """The launches per rank of ``name`` in phase 29's passes."""
        return {"launches_sharded_ad_per_rank": {
            f"{key}_{side}": n for key, sides in ad_sharded.items()
            for side, counts in sides.items() if (n := counts.get(name, 0))}}

    def slice10(name):
        """The launches of ``name`` on the paths of phases 26-28."""
        return {"launches_small_front_ends_per_rank": small_fe.get(name, 0),
                "launches_sharded_front_ends_per_rank": {
                    k: v[name] for k, v in sharded_fe.items() if v.get(name)},
                "launches_sharded_front_ends_batched_per_rank": {
                    k: v[f"{name}_batched"] for k, v in sharded_fe.items()
                    if v.get(f"{name}_batched")},
                "launches_pytree_drivers": {k: v[name] for k, v in tree_l.items() if v.get(name)}}

    def slice8(name):
        """The launches of ``name`` on the paths of phases 20 and 21."""
        return {"launches_bieig": bieig_l["bieig"].get(name, 0),
                "launches_bieig_proj": bieig_l["bieig_proj"].get(name, 0),
                "launches_lanczos_selective": lanczos_l["selective"].get(name, 0),
                "launches_lanczos_selective_proj": lanczos_l["selective_proj"].get(name, 0),
                "launches_iterators": lanczos_l["iterators"].get(name, 0)}

    def slice21(name):
        """The launches of ``name`` on the paths of phase 37."""
        return {f"launches_batched_eager_selective_{path}": L[name]
                for path, L in batched_es["launches"].items() if L.get(name)}

    def slice22(*names):
        """The launches of ``names`` on the forward and backward paths of
        phase 38."""
        return {f"launches_batched_ad_{part}_{side}_{name}": L[name]
                for part, sides in batched_ad["launches"].items()
                for side, L in sides.items() for name in names if L.get(name)}

    if args.profile:
        emit(profile_solve(torch, "config 1 Lanczos eigsolve",
                           lambda: kt.eigsolve_lanczos(op, x0, 4, "LM", alg)))
        emit(profile_solve(torch, "config 4 Arnoldi schursolve, fused",
                           lambda: kt.schursolve(nonsym, x04, 4, "LM", alg4)))
        phase_done("profile")

    emit({"kernels": [
        {
            "name": "fused_step", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/fused_lanczos.cu",
            "replaces": "krylovkit_tpu/ops/pallas_fused_lanczos.py:253",
            "launches": launches["fused_step"],
            "max_abs_err": max(c["max_abs_err"] for c in k1_cases + k1_ext),
            "ms": mean([per_B[B]["ms"] for B in schedule]),
            "parent_ms": (mean([per_B[B]["parent_ms"] for B in schedule]) if parent_runs else None),
            "plain_ms": mean(list(plain_B.values())),
            "bound_ms": mean([per_B[B]["bound_ms"] for B in schedule]),
            "bound_by": "bytes", "library_ms": None,
            "shapes": "mean per launch over the main path's 128 steps, B = 1..29; plain_ms: "
                      "mean of B = 4, 16, 29",
            "launches_config2": config2_launches.get("fused_step", 0),
            "launches_config4_arnoldi": fused4["launches"]["fused_step"],
            "launches_config3_square_fused": fused3["launches"]["fused_step"],
            "ms_config3_square_fused": k1_mean3,
            "launches_config4_exponentiate": launchese["fused_step"],
            "launches_ad": sum(ad_imp[k].get("fused_step", 0) for k in ad_imp)
            + ad_pot["forward"].get("fused_step", 0) + ad_pot["backward"].get("fused_step", 0),
            "ms_config4_exponentiate": k1_ms_e / len(stepse),
            "ms_external_halos": mean([c["ms"] for c in k1_ext if "ms" in c]),
            "ms_null_same_inputs": mean([c["ms_null"] for c in k1_ext if "ms_null" in c]),
            "max_abs_err_external_halos": max(c["max_abs_err"] for c in k1_ext),
            "launches_sharded_config1_per_rank": sharded["fused_config1"].get("fused_step", 0),
            "launches_sharded_gmres30_poisson_2d_per_rank": sharded["fused_gmres"].get("fused_step", 0),
            "launches_small_sharded_per_rank": sharded["small"].get("fused_step", 0),
            "launches_small_sharded_batched_per_rank":
                sharded["small"].get("fused_step_batched", 0),
            **sharded["batched_config1"],
            **slice10("fused_step"),
            **slice11("fused_step"),
            **batched["kernels"]["fused_step"],
            **batched_svd["kernels"]["fused_step"],
        },
        {
            "name": "transform_partial", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/transform.cu",
            "replaces": "krylovkit_tpu/ops/basis.py:289",
            "launches": launches["transform_partial"],
            "max_abs_err": max(c["max_abs_err"] for c in k2_cases if c["dtype"] == "torch.float32"),
            "max_abs_err_bfloat16": k2_bf16["max_abs_err"], "ms_bfloat16": k2_bf16["ms"],
            "ms": mean([t2[mo]["ms"] for mo in k2_schedule]),
            "parent_ms": (mean([t2[mo]["parent_ms"] for mo in k2_schedule]) if parent_runs else None),
            "plain_ms": mean([t2[mo]["plain_ms"] for mo in k2_schedule]),
            "bound_ms": mean([t2[mo]["bound_ms"] for mo in k2_schedule]),
            "bound_by": t2[20]["bound_by"],
            "library_ms": mean([t2[mo]["library_ms"] for mo in k2_schedule]),
            "shapes": "mean per launch over the main path's 11 calls: m_out 20 x10, 4 x1",
            "launches_config4_arnoldi": fused4["launches"]["transform_partial"],
            "ms_config4_arnoldi": k2_c4["ms"],
            "launches_config3_rect": rect3["launches"]["transform_partial"],
            "launches_config3_square_fused": fused3["launches"]["transform_partial"],
            "ms_config3_R4096": k2_by_R[4096]["ms"],
            "launches_ad_impurity_forward": ad_imp["forward"].get("transform_partial", 0),
            "launches_ad_impurity_backward": ad_imp["backward"].get("transform_partial", 0),
            "launches_ad_tuple_basis": ad_imp["tuple_basis"].get("transform_partial", 0),
            "launches_ad_small": ad_small_launches.get("transform_partial", 0),
            **slice8("transform_partial"),
            **slice9(sharded, "transform_partial"),
            **slice10("transform_partial"),
            **slice11("transform_partial"),
            **batched["kernels"]["transform_partial"],
            **batched_svd["kernels"]["transform_partial"],
            **{f"launches_batched_pytree_{path}": L.get("transform_partial_batched", 0)
               for path, L in batched_tree["launches"].items()},
            **slice21("transform_partial_batched"),
            **sharded["tree_config1"],
            **slice22("transform_partial_batched", "transform_partial"),
        },
        {
            "name": "banded_spmv", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/banded_spmv.cu",
            "replaces": "krylovkit_tpu/ops/pallas_spmv.py:44",
            "launches": config2_launches.get("banded_spmv", 0),
            "max_abs_err": max(c["max_abs_err"] for c in k3_cases + kg["banded_spmv"]),
            "ms": k3_main["ms"], "cold_ms": k3_main["cold_ms"], "plain_ms": k3_main["plain_ms"],
            "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
            "library_ms": k3_main["library_ms"],
            "shapes": "banded poisson_2d(1024, 1024) f32, n = 2^20, 5 offsets; launches "
                      "over the two banded config-2 solves",
            "launches_config4_arnoldi": proj4["launches"]["banded_spmv"],
            "ms_config4_arnoldi": k3_c4["ms"],
            "launches_geneig": geneig_off["banded_spmv"],
            "launches_geneig_proj": geneig_on["banded_spmv"],
            "launches_block": block_launches["banded_spmv"],
            "launches_ad_impurity_forward": ad_imp["forward"].get("banded_spmv", 0),
            "launches_ad_impurity_backward": ad_imp["backward"].get("banded_spmv", 0),
            "launches_ad_potential_forward": ad_pot["forward"].get("banded_spmv", 0),
            "launches_ad_potential_backward": ad_pot["backward"].get("banded_spmv", 0),
            **geneig_kernel(kg["banded_spmv"]),
            **slice8("banded_spmv"),
            **slice10("banded_spmv"),
            **slice11("banded_spmv"),
            **batched_lin["kernels"]["banded_spmv"],
            **batched_svd["kernels"]["banded_spmv"],
            **batched_gb["kernels"]["banded_spmv"],
            **batched_bl["kernels"]["banded_spmv"],
            **slice21("banded_spmv_batched"),
            **slice22("banded_spmv_batched", "banded_spmv"),
        },
        {
            "name": "laplacian_1d", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/laplacian_1d.cu",
            "replaces": "krylovkit_tpu/ops/pallas_stencil.py:31",
            "launches": config2_launches.get("laplacian_1d", 0),
            "max_abs_err": max(c["max_abs_err"] for c in k4_cases),
            "ms": k4_main["ms"], "cold_ms": k4_main["cold_ms"], "plain_ms": k4_main["plain_ms"],
            "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
            "library_ms": k4_main["library_ms"],
            "shapes": "n = 2^21 f32; launches over the config-2 BiCGStab solve",
            **slice10("laplacian_1d"),
            **slice11("laplacian_1d"),
            **batched_lin["kernels"]["laplacian_1d"],
        },
        {
            "name": "project", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/projections.cu",
            "replaces": "krylovkit_tpu/ops/pallas_basis.py:59",
            "launches": proj4["launches"]["project"],
            "max_abs_err": max(c["max_abs_err"] for c in k5_cases + kg["project"]),
            "ms": mean([proj_ms4[k][0]["ms"] for k in ks4]),
            "plain_ms": mean([proj_ms4[k][0]["plain_ms"] for k in ks4]),
            "bound_ms": mean([proj_ms4[k][0]["bound_ms"] for k in ks4]),
            "bound_by": "bytes",
            "library_ms": mean([proj_ms4[k][0]["library_ms"] for k in ks4]),
            "shapes": "mean per launch over the config-4 banded Arnoldi solve's sweeps, "
                      "(31, 8192, 128) f32 basis, k = 1..30",
            "launches_config3_rect_proj": proj3["launches"]["project"],
            "launches_geneig": geneig_off.get("project", 0),
            "launches_geneig_proj": geneig_on["project"],
            "launches_block": block_launches.get("project", 0),
            "launches_ad_impurity_forward_proj": ad_imp["forward_proj"].get("project", 0),
            "launches_ad_impurity_backward_proj": ad_imp["backward_proj"].get("project", 0),
            **geneig_kernel(kg["project"]),
            **slice8("project"),
            **slice9(sharded, "project"),
            **slice10("project"),
            **slice11("project"),
        },
        {
            "name": "unproject", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/projections.cu",
            "replaces": "krylovkit_tpu/ops/pallas_basis.py:118",
            "launches": proj4["launches"]["unproject"],
            "max_abs_err": max(c["max_abs_err"] for c in k6_cases + kg["unproject"]),
            "ms": mean([proj_ms4[k][1]["ms"] for k in ks4]),
            "plain_ms": mean([proj_ms4[k][1]["plain_ms"] for k in ks4]),
            "bound_ms": mean([proj_ms4[k][1]["bound_ms"] for k in ks4]),
            "bound_by": "bytes",
            "library_ms": mean([proj_ms4[k][1]["library_ms"] for k in ks4]),
            "shapes": "mean per launch over the config-4 banded Arnoldi solve's sweeps, "
                      "(31, 8192, 128) f32 basis, k = 1..30",
            "launches_config3_rect_proj": proj3["launches"]["unproject"],
            "launches_geneig": geneig_off.get("unproject", 0),
            "launches_geneig_proj": geneig_on["unproject"],
            "launches_block": block_launches.get("unproject", 0),
            "launches_ad_impurity_forward_proj": ad_imp["forward_proj"].get("unproject", 0),
            "launches_ad_impurity_backward_proj": ad_imp["backward_proj"].get("unproject", 0),
            **geneig_kernel(kg["unproject"]),
            **slice8("unproject"),
            **slice9(sharded, "unproject"),
            **slice10("unproject"),
            **slice11("unproject"),
        },
        *[{
            "name": f"{name}_batched", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/projections.cu",
            "replaces": replaces + " (under jax.vmap)",
            **batched_arn["kernels"][name],
            **batched_svd["kernels"][name],
            **batched_gb["kernels"][name],
            **batched_bl["kernels"][name],
            "launches_small_sharded_batched_per_rank":
                sharded["small"].get(f"{name}_batched", 0),
            **slice21(f"{name}_batched"),
            "bound_by": "bytes",
            "shapes": "mean per launch over P = 8 bases (31, 8192, 128) f32 at k = 18, 30 and "
                      "mixed k; launches: the config-4 banded eigsolve_arnoldi_batched, P = 4, "
                      "projection flag on",
        } for name, replaces in (("project", "krylovkit_tpu/ops/pallas_basis.py:59"),
                                 ("unproject", "krylovkit_tpu/ops/pallas_basis.py:118"))],
    ]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
