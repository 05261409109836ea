"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py

Phases (any failure raises, and the script then prints no result):

1. card and build: the card's name and power limit; nvcc builds
   dflo_tpu_torch/csrc/*.cu (one process per source, timed); the tile
   kernel of the residual and the candidate (csrc/residual.cuh), and the
   tile kernels of the post and the modal positivity (csrc/fused_post.cu,
   csrc/fused_modal_pos.cu): each instantiation's registers, stack and
   spill from ptxas, and the tile and dynamic shared memory per block of
   the main forms (the post's and the modal positivity's equal to
   ops/kernels.post_smem at every degree, the per-cell kernels' thread
   block equal to ops/kernels.BLOCK); the Pk post's and the check's tile
   kernels (csrc/fused_pk_post.cu, csrc/fused_mood_check.cu): no stack and
   no spill in any tile instantiation, each tile's shared memory equal to
   ops/kernels.pk_post_smem and check_smem.
2. RK/TVB kernels against their plain PyTorch versions on the card, on the
   1152 x 288 Q2 double-Mach-reflection (DMR) state after the initial
   post_stage and after 10 plain steps, in float32 and float64: both forms of
   the residual, the post with and without its diagnostics, the diag; CUDA
   event times (median of 20); the f64 free stream through the residual
   kernel; one NaN cell must trip the fatal flag.
3. the RK main path: entry._build(1152, 288, float32, cuda) and
   Solver._multi_step(50); every kernel of the path launched, no plain
   version called, no fatal flag, finite state; DoF-updates/s.
4. the entry() analog at 128 x 24: one f64 step with the kernels against the
   plain step, on the card and on the CPU.
5. MOOD kernels against their plain versions, on the 1152 x 288 P2 DMR
   state after 3 MOOD steps through the plain versions (on the card), in
   float32 and float64: the dense modal residual (R and u + dt*R), the sparse
   candidate on a realistic cell set (pass 1's changed cells, their
   neighbors and the cells the positivity chain moves) and on every cell,
   the modal positivity in all four forms, the Pk post with and without its
   diag, the check (bitwise), the diag on Pk; CUDA event times.
6. the MOOD main path: entry._build(1152, 288, float32, cuda, "mood"),
   post_stage, Solver._multi_step(20) after a warm-up; every kernel of the
   path launched (the Pk post in both forms), no plain version called, no
   fatal flag, finite state; bench.py's headline metric
   dmr_q2_pk_mood_dof_updates_per_sec with ms/step, MoodStats, cascade
   passes, host syncs and strips per step.
7. sparse against dense, f64, 128 x 32, 3 MOOD steps: the default stage
   against make_mood(..., sparse_mode="off") (which launches
   fused_modal_pos with truncation), and the kernels against the plain
   versions on the same card: state within 1e-10, equal degree and
   limiter maps, equal MoodStats.
8. the device's busy share: each main path's chunk (RK 5 steps, MOOD 3,
   forward step 3, sharded RK 3, the vortex 10, rayleigh_taylor 10,
   iso_xing_shu 10, the forward step on P2 under MOOD 3, the DMR on P4
   under MOOD 3, the vortex on P4 5, the curvilinear annulus 10) under
   torch.profiler; busy time is the union of the
   device events' intervals; idle shares of the traced wall and of the
   untraced ms/step of phases 3, 6 and 10.
9. forward-step kernels against their plain versions, on the Mach-3
   forward step of examples/forward_step_tpu.prm at its full 1920 x 640
   (Q1, LxF, the solid-cell mask, the `limiter` indicator), on its IC after
   post_stage and after 10 plain steps, in float32 and float64: the masked
   LxF residual (R and stage forms), the masked post with and without its
   diag, the masked diag and volume_residual; CUDA event times (median of
   20).
10. the forward-step main path through the port's CLI,
   cli.run([examples/forward_step_tpu.prm, --max-steps 50, --chunk 10,
   --output-dir <tmp>]) in float32: every kernel of the path launched, no
   plain version called, finite state, both VTU snapshots written; then
   Solver._multi_step(10) on the CLI's solver, timed apart from output:
   fwdstep_q1_rk_tvb_dof_updates_per_sec and ms/step.
11. the volume_kernel="pallas" path at 1920 x 640: the residual with its
   volume term through volume_residual against the plain residual, f64 and
   f32; then 5 steps of Solver(volume_kernel="pallas", post_kernel="fused")
   in f32 with volume_residual launched, no fatal flag, finite state.
12. the block kernels of the sharded RK path against their plain versions,
   on phase 2's two DMR states split over a (2, 2) virtual mesh (four
   blocks of 144 x 576 on the one card), in float32 and float64: the post's
   block form with and without diag against its plain block form; the
   sharded post against the single-device post kernel on the whole state
   (bitwise, else its error and flipped cells within TOL and
   MAX_FLIP_FRACTION); the sharded diag against the single-device diag
   (equal); the sharded residual and stage against the single-device
   kernel (TOL); CUDA event times (median of 20) per block launch and for
   the whole sharded post and diag; the sharded rows' `ms` is the four
   blocks' kernel time alone (a torch.profiler trace of 20 calls), their
   `sharded_call_ms` the whole call with its halo copies and reduce.
13. the sharded main path: entry._build(1152, 288, float32, cuda,
   device_mesh=(2, 2) on the card), post_stage, Solver._multi_step(50):
   the residual, the post's block form and the sharded diag launched, no
   plain version called, no fatal flag, finite state;
   dmr_q2_rk_tvb_sharded_dof_updates_per_sec and ms/step.  Then 10 f64
   steps of the sharded solver against the single-device solver on the
   same card: each dt within 1e-14 relative, the state within 1e-10.  With
   two or more cards both runs repeat over distinct cards; with one, a line
   says so.
14. the modal LxF forms and the periodic Q1 post against their plain
   versions, f32 and f64: the LxF residual on the modal P2 basis in its R,
   u + dt*R and SSP-stage forms on the IC of examples/isentropic_vortex.prm
   at 2048 x 2048 (K = 6), with the Pk diag there; the LxF MOOD candidate
   on the 1152 x 288 P2 DMR state run with flux="lxf" after 3 plain MOOD
   steps, on a realistic cell set and on every cell (bitwise); the Q1 post
   periodic on both axes, with and without its diag, on
   examples/vortex_system_pbc.prm at 2048 x 2048 on its IC after
   post_stage and after 10 plain steps; CUDA event times (median of 20).
15. the vortex main path: cli.build_solver on isentropic_vortex.prm at
   2048 x 2048 (P2, LxF, limiter none, periodic on all sides), f32,
   Solver._multi_step(10) five times after a warm-up: the modal LxF stage
   form and the Pk diag launched, no plain version called, no fatal flag,
   finite state; isenvort_p2_lxf_rk_dof_updates_per_sec, ms/step and the
   density l2_error against the IC (the vortex is stationary: information,
   not a gate); its chunk is traced in phase 8.
16. the seven Cartesian configs (sod_shock_tube, sod_mood,
   isentropic_vortex, vortex_system, vortex_system_pbc, rayleigh_taylor,
   iso_xing_shu) through cli.run at their shipped sizes, --max-steps 20
   --chunk 10, f32: finite, no plain version called, the forms each carries
   launched, a snapshot written.
17. the residual's source arms against their plain versions, f32 and f64,
   in the R, u + dt*R and SSP-stage forms: gravity on Q1 (the constant
   g of examples/rayleigh_taylor.prm), the same on P2 and the force planes
   of an external force on Q1, on rayleigh_taylor's 1:3 box at
   1024 x 3072 and its IC after post_stage; the isothermal well-balanced
   arm on GLL1-3 with hllc and lxf on examples/iso_xing_shu.prm's unit box
   at 2048 x 2048, its hydrostatic IC with a seeded 1 % perturbation, and
   the diag on GLL2 there; whether each is bitwise; CUDA event times
   (median of 20) of the stage forms beside the plain versions' and the
   same launch without the source arm (what the arm costs).  Then the
   well-balance oracle through the fused path: GLL2, 512 x 512, outflow
   sides, the hydrostatic IC, 25 f64 steps with lxf and with hllc: drift
   max|u - u0| below 5e-13 (tests/test_gravity.py's bound).
18. the two main paths through cli.run, f32, 20 steps in chunks of 10:
   rayleigh_taylor.prm at 1024 x 3072 (Q1, hllc, gravity, characteristic
   TVB) and iso_xing_shu.prm at 2048 x 2048 (GLL2, hllc, isothermal
   well-balancing, limiter none): finite, no fatal flag, no plain version
   called, the source form launched; then Solver._multi_step(10) five
   times on the CLI's solver after a warm-up, timed apart from output:
   rt_q1_rk_tvb_gravity_dof_updates_per_sec and
   isohydro_gll2_wb_rk_dof_updates_per_sec with ms/step (their chunks are
   traced in phase 8).  The P2 gravity and the force-plane forms run 10
   steps each on rayleigh_taylor's solver with basis = Pk, degree = 2, and
   with the gravity replaced by the external force, at 1024 x 3072.

19. the Roe, Steger-Warming, KFVS and KEP forms of the residual against
   their plain versions, f32 and f64, in the R, u + dt*R and SSP-stage
   forms, at 1024 x 1024 on Q1, Q2, Q3, GLL2 and P2 (the Gaussian bump of
   tests/test_implicit.py:83-110 on the unit square, farfield W/E, slip
   S/N, perturbed by a seeded 2 %) and masked Q1 (the forward step's
   geometry and BCs on its inflow state): roe and sw bitwise, kfvs and kep
   bitwise where the card's exp/log round as torch's, else within TOL;
   CUDA-event times of each flux's stage and R forms on Q1 and of roe's
   stage on P2 at 2048 x 2048; ptxas registers and spills per flux, dtype
   and degree; the diag on the implicit vortex's Q1 state.  Each flux's
   RK path: the periodic vortex on Q1 at 1024 x 1024, 4 steps, its stage
   form launched, no plain version called.
20. the implicit vortex: Q1, roe, limiter none, the periodic isentropic
   vortex at 1024 x 1024 (512 x 512 if one step takes over 10 s), theta
   1, cfl 5, two Newton iterations to 1e-4, block-Jacobi, f32: a warm-up
   step, 2 steps in one chunk, one traced step;
   isenvort_q1_roe_implicit_dof_updates_per_sec, ms/step, Newton
   iterations, GMRES restarts, tangents and host reads per step, the roe
   R-form launches (> 0), plain calls (0), busy/idle share and the
   kernel's ms against the rest; not diverged, finite.
21. the steady bump through cli.run: Q1, roe, `method = gmres`,
   `stationary = true`, local dt, cfl 2, linear residual 1e-4 at 256 x 256
   (the 128 x 128 companion first), --max-steps 3 per level (at cfl 2
   the bump's disturbance crosses these grids in hundreds of PTC steps:
   60 steps moved ||R|| from 66.8 to 45.4 on 128 x 128 and not at all on
   256 x 256, see PERF.md; cut from 20, 10 and then 5 per level to keep
   the script within its time limit), f32: the PTC steps and first and last ||R||
   of each level (both histories to chiprun_out/steady_history.json), the
   CLI timer, roe R-form launches (> 0), plain calls (0), every linear
   solve run, the histories finite.
22. f64 kernel primal against plain primal: the implicit vortex at 64 x 64
   (cfl 2, linear residual 1e-6, block-Jacobi), 2 steps with
   volume_kernel="fused" and "xla" from the same state: within 1e-10
   relative, equal Newton counts, every linear solve converged.
23. the masked modal residual against its plain version, f32 and f64, in
   its R, u + dt*R and SSP-stage forms with all six fluxes at P1, P2 and
   P3, on examples/forward_step_tpu.prm on the modal basis at its full 1920
   x 640 (IC perturbed on every mode by a seeded generator, solid cells
   pinned, plain positivity), a solid cell's R exactly 0; and the MOOD
   candidate with roe, sw, kfvs and kep on the 1152 x 288 P2 DMR run with
   each flux (kep from a contact, phase 24) after 3 plain MOOD steps, on a
   realistic cell set and on every cell; whether each case is bitwise;
   CUDA-event times of the P2 forms (kernel median of 20, plain of 5) and
   of each candidate; ptxas registers and spills of the modal residual and
   the candidate per flux.  Then the other kernels of phase 24's paths at
   their sizes, f32 and f64: on the forward step's P2 MOOD solver at 1920
   x 640 the masked Pk diag and the modal positivity with and without
   truncation (degree map from the pass-1 candidate's masked check) and
   in its diag form; on rayleigh_taylor's P2 MOOD solver at 1024 x 3072
   after 2 plain steps the check (pass 1 and the dense route's pass 2,
   bitwise), the Pk post with and without diag (0 flipped cells in f64)
   and the modal positivity; CUDA-event times of each.
24.the new paths, f32, no plain version called, finite, on the card:
   forward_step_tpu.prm on P2 (`basis = Pk`, `degree = 2`) under MOOD
   through cli.run at 1920 x 640, 10 steps in one chunk (the masked
   modal u + dt*R form, the modal positivity kernel and the masked diag
   launched), then timed apart from output over 10 steps:
   fwdstep_p2_mood_dof_updates_per_sec with ms/step, MoodStats, host
   syncs and launches per step (its chunk traced in phase 8); the same
   under rk3, 10 steps (fwdstep_p2_rk_tvb_dof_updates_per_sec, the masked
   modal stage form); rayleigh_taylor.prm on P2 under MOOD with
   positivity at 1024 x 3072, 5 steps (rt_p2_mood_gravity_dof_updates_
   per_sec: the gravity arm's u + dt*R form, the check kernel, the Pk
   post); the DMR MOOD path with each of roe, sw, kfvs and kep at 1152 x
   288, 5 steps (dmr_p2_mood_<flux>_dof_updates_per_sec, the flux's
   candidate launched; kep from a contact discontinuity in the DMR box:
   from the Mach-10 shock the reference's KEP cascade, and the port's,
   give NaN in the first step).

25. the fused residual's single-card envelope against the plain versions,
   f32 and f64: at 384 x 128 (the phase-19 bump, 2 % noise) every flux at
   p 4 and p 6 on Qk, GLL and Pk (R), all three forms for one flux per
   basis, masked for one flux per basis, p 5 with lxf, nq = p + 2 on Qk,
   GLL and Pk; the source arms with roe, sw, kfvs and kep (gravity on Q1
   and P2, the force planes on Q1, isothermal on GLL2) on
   rayleigh_taylor's and iso_xing_shu's configs, and each arm on the
   general dims (Q4, P4, GLL4, Q2 on 4 x 4 points); the post on Q4-Q6 masked
   and not, with and without diag; the diag on every new basis kind,
   masked and not; volume_residual at K = 25, 36, 49; whether each case is
   bitwise; ptxas registers, spills and stack of the general-dims
   instantiations.  Then the table's new rows at their paths' shapes,
   timed (kernel median of 20, plain of 5): the P4 and P6 lxf stages and
   diags on the vortex at 2048 x 2048 and 1024 x 1024, the over-integrated
   Q2 stage and diag on the vortex at 2048 x 2048, the Q4 hllc stage, post
   (with diag, flipped cells bounded) and diag on the DMR at 1152 x 288,
   volume_residual on the Q4 DMR, the roe gravity stage on rayleigh_taylor
   at 1024 x 3072 and the roe isothermal stage on iso_xing_shu at
   2048 x 2048.  Phase 17's well-balance oracle also runs roe.
26. the envelope's paths, f32, 10 steps in chunks of 5 after a warm-up,
   no plain version called, finite, no fatal flag, each with ms/step and
   DoF-updates/s: isentropic_vortex.prm at degree 4 (2048 x 2048) and
   degree 6 (1024 x 1024) through prm_solver (the P4/P6 lxf stage and the
   diag; the density l2_error against the IC), the DMR box of
   entry._build on Q4 (the Q4 hllc stage, the post with diag, the diag)
   and with volume_kernel="pallas" (volume_residual at K = 25, 5 steps),
   the vortex on the over-integrated Q2 through Solver (its non-collocated
   stage, the diag), rayleigh_taylor.prm with flux = roe at 1024 x 3072 and
   iso_xing_shu.prm with flux = roe at 2048 x 2048 through cli.run (the roe
   gravity and isothermal stages).
27. the MOOD kernels over their degree range against their plain
   versions, f32 and f64, bitwise: at 160 x 96 on the DMR box (its IC with
   2 % noise, positivity-limited; seeded degree map, cell set, limiter
   marks and shock plane) the candidate with all six fluxes at p 4, with
   hllc and lxf at p 5, 6 and 1 and on the over-integrated P2 (4 x 4
   points), on a cell set and on every cell; the modal positivity in its
   four forms, the Pk post with and without diag at p 4, 5, 6 and 1, the
   check (periodic and not) at p 4, 5 and 6; the masked forward step's
   modal positivity at p 4 (cut to 240 x 80); ptxas registers, spills and
   stack of the general MOOD kernels.  Then the table's P4 rows on the P4
   DMR MOOD state at 1152 x 288 after a plain step (pass 1's degree map
   and cell set): bitwise, timed (kernel median of 20, plain of 5).
28. the MOOD paths over the degree range, f32, no plain version called,
   finite, no fatal flag: the DMR MOOD path on P4 (entry._build(1152, 288,
   "mood", degree=4)), 10 steps, the candidate, the modal positivity, the
   Pk post and the check launched, dmr_p4_mood_dof_updates_per_sec with
   ms/step, MoodStats, passes and host syncs per step; the same on P1, 5
   steps: the forward-Euler residual and the Pk post launched, its check
   the plain stab/mood.check_update (counted per step); no degree can drop
   on P1, so its cascade ends after pass 1, as the reference's, and the
   candidate, the modal positivity and the check kernel are never
   launched there (phase 27 holds the P1 candidate and modal positivity);
   examples/sod_mood.prm at degree 1 and 4 as shipped, 20 steps through
   cli.run (launches counted) and through `python -m dflo_tpu_torch` in a
   subprocess.
29. the tile post (row 4), its block form (row 5) and the tile modal
   positivity (row 8) against their plain versions, f32 and f64, bitwise,
   with and without diag: the post at Q1-Q6 on grids cut against every
   tile and smaller than one (1 x 1, 3 x 2, 2 x 37, 40 x 1, 37 x 11,
   96 x 40, one cell past the degree's tile), periodic in x, y and both,
   the density, energy and `limiter` indicators, char_lim on and off,
   pos_lim off, masked with solid cells on tile and domain edges; a NaN
   cell reaching lam_max and the fatal flag; the block form on a (2, 2)
   virtual mesh of ragged blocks with each halo line present and absent,
   against its plain block form and the sharded post against the
   single-device post; the modal positivity at P1-P6 on the same grids
   with and without a degree map holding every degree 0..p.
30. the tile Pk post (row 9) and the wide-tile MOOD check (row 10) against
   their plain versions, f32 and f64, bitwise (NaN where the plain version
   has NaN): the Pk post at P1-P6, with and without diag, on phase 29's
   grids and the grid one cell past the degree's tile, periodic on
   neither, one or both axes (char_lim on and off, a TVB M on one), the
   marked cells on tile and domain edges and half the others; a NaN cell
   reaching lam_max; the check at p 2-6 on the same grids, 256 x 20 and
   260 x 35 (rows a 16-byte vector of every plane, of the float planes
   alone) and one cell past its tile, periodic on neither, one or both
   axes, degree-1 marked cells on tile and domain edges, so that spreads
   cross tile borders and wrap.
31. the diag (row 6, one launch a call: the Pk mode-0 mean, the nodal full
   row), its sharded form (row 7) and the volume residual (row 1: the
   per-cell kernel up to ops/kernels.VOLUME_CELL_MAX_P, the tile kernel
   above) against their plain versions, f32 and f64,
   bitwise, on grids whose rows a 16-byte vector covers and does not, odd
   row counts, grids smaller than one run or tile, masked and not, and a
   state 4 bytes past a 16-byte boundary.

32. the DMR from a mesh file (path A): a .geo of two transfinite blocks
   (1152 x 288, the bottom split at x = 1/6 with Physical Lines 0 and 1)
   and its .prm (entry.dmr_geo_text, entry.dmr_geo_prm: the boundary
   conditions of tests/test_masked_domain.py:66-110, Q2, hllc, TVB beta 1
   with the `limiter` indicator, positivity, cfl 0.4) through cli.run, f32,
   20 steps in chunks of 10: rows 2, 4 and 6 launched, no plain version
   called, no fatal flag, finite; dmr_geo_q2_rk_tvb_dof_updates_per_sec
   and ms/step timed apart from output; the domain through write_msh and
   the native load_msh gives identical arrays; one full-width SSP stage
   with the segmented strips bitwise against its plain version, f32 and
   f64, timed (the kernel table's row fused_residual_geo).
33. the curvilinear block that fills the card (path B): the annulus of
   scripts/naca_bench.py:130-146 (320 x 1536 cells, r 1 to 3), Q2, hllc,
   periodic W/E, slip S, farfield N at the naca0012 free stream, cfl 0.4,
   f32, limiter none with positivity on (minmax on a q1 block waits for
   slice E), 20 steps in chunks of 10 after a warm-up: plain torch, as the
   reference's curvilinear path is XLA (no kernel launched, no plain
   version called); annulus_q2_curvi_rk_dof_updates_per_sec and ms/step
   (its chunk traced in phase 8); the f64 free stream on a 1024 x 1024
   wavy block of the unit square, max |R| * h below 1e-12 (h = 1/1024:
   the round-off of one cell's fluxes is divided by its size).
34. the naca0012 steady workflow (path C) through cli.run with
   examples/naca0012.prm's settings on a NACA 0012 O-mesh of naca.struct's
   size (160 x 40, mesh.curvilinear.naca0012_omesh) written as a .struct,
   f32, 2 PTC steps on each level of the grid sequence: Newton and Krylov
   counts and each level's ||R|| history (chiprun_out/
   naca_steady_history.json); no Newton divergence, finite.
35. the limiters and indicators of the physics envelope, f32 at full
   width: the 1152 x 288 DMR (entry._build) on Q2 with the minmax limiter
   (characteristic, density indicator, positivity) and on P2 under RK3
   with TVB and the u2 indicator, 10 steps each, and on Q2 with TVB and
   the residual indicator, 5 steps: the residual kernel (the SSP stage;
   the R form inside the residual indicator) and the diag launched, the
   fused post not, no plain version called, finite, no fatal flag
   (dmr_q2_rk_minmax_, dmr_p2_rk_tvb_u2_, dmr_q2_rk_tvb_residual_
   dof_updates_per_sec); examples/vortex_system.prm at 2048 x 2048 with
   `conserve angular momentum = true` through cli.run, 10 steps, its
   angular-momentum monitor line every step, its solver timed apart
   (vortex_system_p1_angmom_dof_updates_per_sec).
36. pressure sides and the full mass matrix: examples/forward_step_tpu.prm
   at its 1920 x 640 through cli.run with its outlet a pressure side at
   the free stream's pressure, 20 steps in chunks of 10: rows 2, 4 and 6
   launched, no plain version called
   (fwdstep_q1_pressure_outlet_dof_updates_per_sec); one full-width masked
   Q1 stage with the pressure strips bitwise against its plain version, f32
   and f64, timed (the kernel table's row fused_residual_pressure);
   examples/iso_xing_shu.prm at 2048 x 2048 with `mass matrix = full` and
   cfl 0.5 (the consistent mass is unstable at the shipped 0.9, in the
   reference too), 10 steps: the plain residual and the diag
   (isohydro_gll2_fullmass_dof_updates_per_sec); its f64 well-balance
   drift at 512 x 512 after 5 steps.
37. MOOD off the fused route, and output: the P2 DMR MOOD with
   volume_kernel="xla", 5 steps, f32: rows 3, 8, 9 and 10 and the residual
   kernel not launched, row 6 launched (dmr_p2_mood_xla_dof_updates_per
   _sec); one f64 stage each on that state: dmp_bounds="collapsed" reduces
   a superset of the neighborhood's cells, deg_in = full(p) equals the
   cold stage bitwise outside the cells the full-degree chain moves (and
   their neighbors), a warm start from the settled map accepts the same
   state in no more passes; mu_shock of phase 35's final minmax state,
   timed, finite and nonnegative; examples/sod_shock_tube.prm as shipped
   through cli.run, 20 steps, with `format = tecplot` (.plt snapshots) and
   with `diffusion coefficient = 1` (VTUs with the mu_shock field).

Rows 1, 6 and 7 are bitwise in every phase that compares them (record,
BITWISE_ROWS).  Phase 1 also holds the diag's and the volume residual's
instantiations to no stack and no spill and the volume tile's shared
memory to ops/kernels.volume_smem; phase 8 traces 20 diag calls and
finds 20 device events, each the diag kernel.

The last lines are the kernel table, the card line and the card as JSON.  The
machine with the card has no JAX: this script imports neither jax nor
dflo_tpu.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

#: tolerances, relative to the plain version's largest magnitude per
#: component.  f64: round-off of a different summation order and FMA
#: contraction.  f32: the same, at f32 epsilon; the post may flip a
#: threshold decision (KXRCF > 1, change > 1e-10) in a few cells, which are
#: counted and bounded separately.
TOL = {torch.float64: {"fused_residual": 1e-11, "fused_post": 1e-11,
                       "fused_diag": 1e-11, "fused_mood_candidate": 1e-11,
                       "fused_modal_pos": 1e-11, "fused_pk_post": 1e-11,
                       "volume_residual": 1e-11},
       torch.float32: {"fused_residual": 1e-5, "fused_post": 1e-4,
                       "fused_diag": 1e-5, "fused_mood_candidate": 1e-5,
                       "fused_modal_pos": 1e-5, "fused_pk_post": 1e-4,
                       "volume_residual": 1e-5}}
MAX_FLIP_FRACTION = 1e-4          # 0.01 % of the cells
NX, NY = 1152, 288
MAIN_STEPS = 50
MOOD_STEPS = 20
MOOD_PLAIN_STEPS = 3              # steps that make the MOOD kernels' input
SD_NX, SD_NY, SD_STEPS = 128, 32, 3
SD_TOL = 1e-10
#: the forward step (examples/forward_step_tpu.prm, read as it ships)
FS_PRM = "examples/forward_step_tpu.prm"
FS_NX, FS_NY = 1920, 640
FS_PLAIN_STEPS = 10
FS_STEPS, FS_CHUNK = 50, 10
PALLAS_STEPS = 5
#: the sharded path: the DMR split over a (2, 2) mesh of blocks
SHARD = (2, 2)
SHARD_STEPS = 50
SHARD_F64_STEPS = 10
#: the modal LxF path: the periodic isentropic vortex (and the periodic Q1
#: post of the vortex system), at 2048 x 2048
VORTEX_PRM = "examples/isentropic_vortex.prm"
PBC_PRM = "examples/vortex_system_pbc.prm"
VX_N = 2048
VX_STEPS, VX_CHUNK = 50, 10
#: the five Cartesian configs without a body force, through cli.run
#: (phase 16), and the kernel forms each must launch
CONFIG_STEPS, CONFIG_CHUNK = 20, 10
CONFIG_FORMS = {
    "rayleigh_taylor": ("fused_residual[qk_hllc_grav_stage]", "fused_post",
                        "fused_diag"),
    "iso_xing_shu": ("fused_residual[gll_hllc_wbiso_stage]", "fused_diag"),
    "sod_shock_tube": ("fused_residual[pk_hllc_stage]", "fused_diag"),
    "sod_mood": ("fused_residual[pk_lxf_step]", "fused_mood_candidate[lxf]",
                 "fused_modal_pos", "fused_pk_post", "fused_mood_check",
                 "fused_diag"),
    "isentropic_vortex": ("fused_residual[pk_lxf_stage]", "fused_diag"),
    "vortex_system": ("fused_residual[pk_lxf_stage]", "fused_diag"),
    "vortex_system_pbc": ("fused_residual[qk_lxf_stage]", "fused_post",
                          "fused_diag"),
}
#: the body-force and gravity paths: rayleigh_taylor's 1:3 box and
#: iso_xing_shu's unit box (phases 17-18), the well-balance oracle's grid
RT_PRM = "examples/rayleigh_taylor.prm"
ISO_PRM = "examples/iso_xing_shu.prm"
RT_NX, RT_NY = 1024, 3072
ISO_N = 2048
SRC_STEPS, SRC_CHUNK = 20, 10
VARIANT_STEPS = 10
WB_N, WB_STEPS, WB_DRIFT = 512, 25, 5e-13
#: the Roe, Steger-Warming, KFVS and KEP forms of the residual (phase 19)
#: on these bases and masked Q1 at FLUX_N x FLUX_N, and each flux's RK
#: path (FLUX_STEPS steps); the bump's free stream
FLUX_NEW = ("roe", "sw", "kfvs", "kep")
FLUX_N = 1024
FLUX_CASES = (("Qk", 1), ("Qk", 2), ("Qk", 3), ("Qk_gll", 2), ("Pk", 2))
FLUX_STEPS = 4
BUMP_FAR = (0.5, 0.0, 1.0, 2.6)
#: the implicit paths: the vortex (phase 20; IMPL_FALLBACK_N if one step
#: takes over 10 s), the steady bump through the CLI (phase 21), the f64
#: kernel primal against the plain one (phase 22); each tangent of the
#: Krylov solves costs 64-83 ms on the card (launch-bound), so the steady
#: and primal depths were cut from 5 to make room for phase 34's 10 PTC
#: steps within the script's limit
IMPL_N, IMPL_FALLBACK_N, IMPL_STEPS = 1024, 512, 2
STEADY_N, STEADY_STEPS = 256, 3
PRIMAL_N, PRIMAL_STEPS = 64, 2
#: masked modal Pk and MOOD with every flux and a body force (phases
#: 23-24): the residual's fluxes; the forward step on P2 under MOOD
#: (FWD_MOOD_STEPS in chunks of FWD_MOOD_CHUNK) and RK; rayleigh_taylor on
#: P2 MOOD at RT_NX x RT_NY; the DMR MOOD path with each new flux
ALL_FLUXES = ("hllc", "lxf") + FLUX_NEW
FWD_MOOD_STEPS, FWD_MOOD_CHUNK = 10, 10
FWD_RK_STEPS = 10
RT_MOOD_STEPS = 5
RT_PLAIN_STEPS = 2                # steps that make phase 23's rt input
DMR_FLUX_STEPS = 5
#: the envelope (phases 25-26): the coverage grid of the new forms; the
#: vortex on P4 and P6, the over-integrated vortex (Q2 on 4 x 4 points);
#: each new path's steps and chunk
ENV_GRID = (384, 128)
P4_N, P6_N, Q2OI_N = 2048, 1024, 2048
ENV_STEPS, ENV_CHUNK = 10, 5
#: the MOOD cascade over its degree range (phases 27-28): the coverage grid
#: (the DMR box), its cases (degree, the candidate's fluxes, nq or None),
#: the masked forward step's cut grid, the plain steps that make the P4
#: rows' state, the P4 and P1 DMR paths' steps; sod_mood.prm as shipped
MD_GRID = (160, 96)
MD_CASES = ((4, ALL_FLUXES, None), (5, ("hllc", "lxf"), None),
            (6, ("hllc", "lxf"), None), (1, ("hllc", "lxf"), None),
            (2, ("hllc",), 4))
MD_FWD_GRID = (240, 80)
MD_PLAIN_STEPS = 1
MD_P4_STEPS, MD_P1_STEPS = 10, 5
SOD_MOOD_PRM = "examples/sod_mood.prm"
SOD_GRID = (100, 4)
#: slice D, part 2 (phases 32-34): the DMR read from a .geo file at
#: NX x NY (two transfinite blocks, GEO_NL cells across before the split of
#: its bottom at x = 1/6), GEO_STEPS steps in chunks of GEO_CHUNK; the
#: annulus of scripts/naca_bench.py:130-146 (r_in, r_out, n_r, n_theta) on
#: Q2 at the naca0012 free stream, ANN_STEPS in chunks of ANN_CHUNK; the
#: f64 free stream on a wavy unit square of WAVY_N x WAVY_N, max |R| * h
#: below WAVY_FS_TOL; the naca0012 O-mesh of naca.struct's size (cells
#: around, out), NACA_STEPS PTC steps a level
GEO_NL, GEO_STEPS, GEO_CHUNK = 48, 20, 10
ANN = (1.0, 3.0, 320, 1536)
ANN_STEPS, ANN_CHUNK = 20, 10
WAVY_N, WAVY_FS_TOL = 1024, 1e-12
NACA_PRM = "examples/naca0012.prm"
#: each PTC step here is one Newton iteration of up to 10 GMRES restarts of
#: 30 tangents (naca0012.prm's settings; at cfl 2 they stop unconverged),
#: 15 to 22 s on the card: 5 steps a level took 156 to 221 s (PERF.md), so
#: the phase takes 2 a level to keep the script inside its limit
NACA, NACA_STEPS = (160, 40), 2
#: the rest of the physics envelope (phases 35-37): the DMR paths' steps
#: (minmax, u2, MOOD off the fused route) and chunk; the residual
#: indicator's; the vortex system at VS_N x VS_N and its steps; the forward
#: step with a pressure outlet, its steps; iso_xing_shu with the full mass
#: matrix at ISO_N x ISO_N, its steps, and its f64 drift at WB_N x WB_N; the
#: Sod tube as shipped (SOD_N) and its steps
ENV_STEPS, ENV_CHUNK, RESID_STEPS = 10, 10, 5
VS_PRM, VS_N, VS_STEPS = "examples/vortex_system.prm", 2048, 10
PRES_STEPS, PRES_CHUNK = 20, 10
FULLMASS_STEPS, WB_N, WB_STEPS = 10, 512, 5
MOOD_XLA_STEPS = 5
SOD_PRM, SOD_N, SOD_STEPS = "examples/sod_shock_tube.prm", (100, 10), 20
#: the naca0012 free stream, M 0.63 at 2 degrees (examples/naca0012.prm)
NACA_FS = (0.6296158, 0.0219908, 1.0, 1.9841269)
#: the external force of the force-plane form (f_0, f_1 expressions)
FORCE_EXPR = ("0.01*sin(2*pi*x)*cos(t)", "-1.0")
#: the card's peaks for the bound (NVIDIA H100 SXM data sheet, dense,
#: outside the tensor cores): HBM bytes/s and FLOP/s per dtype
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

#: table rows: name -> (CUDA source, TPU kernel it replaces (file:line),
#: TPU function, wrapper, main path it runs on)
PK = "dflo_tpu/ops/pallas_kernels.py"
SOURCES = {
    "fused_residual": ("dflo_tpu_torch/csrc/fused_residual.cu", f"{PK}:617",
                       f"{PK}:make_fused_residual", "fused_residual", "rk"),
    "fused_post": ("dflo_tpu_torch/csrc/fused_post.cu", f"{PK}:1075",
                   f"{PK}:make_fused_post", "fused_post", "rk"),
    "fused_diag": ("dflo_tpu_torch/csrc/fused_diag.cu", f"{PK}:1663",
                   f"{PK}:make_fused_diag", "fused_diag", "rk"),
    "fused_residual_pk": ("dflo_tpu_torch/csrc/fused_residual.cu",
                          f"{PK}:617", f"{PK}:make_fused_residual (modal Pk)",
                          "fused_residual", "mood"),
    "fused_mood_candidate": ("dflo_tpu_torch/csrc/fused_mood_candidate.cu",
                             f"{PK}:955",
                             f"{PK}:make_fused_residual(...).sparse",
                             "fused_mood_candidate", "mood"),
    "fused_modal_pos": ("dflo_tpu_torch/csrc/fused_modal_pos.cu",
                        f"{PK}:1805", f"{PK}:make_fused_modal_pos",
                        "fused_modal_pos", "mood"),
    "fused_pk_post": ("dflo_tpu_torch/csrc/fused_pk_post.cu", f"{PK}:1997",
                      f"{PK}:make_fused_pk_post", "fused_pk_post", "mood"),
    "fused_mood_check": ("dflo_tpu_torch/csrc/fused_mood_check.cu",
                         f"{PK}:2222", f"{PK}:make_fused_mood_check",
                         "fused_mood_check", "mood"),
    "fused_diag_pk": ("dflo_tpu_torch/csrc/fused_diag.cu", f"{PK}:1663",
                      f"{PK}:make_fused_diag (Pk)", "fused_diag", "mood"),
    "fused_residual_fwd": ("dflo_tpu_torch/csrc/fused_residual_lxf.cu",
                           f"{PK}:617",
                           f"{PK}:make_fused_residual (masked, lxf)",
                           "fused_residual", "fwd"),
    "fused_post_fwd": ("dflo_tpu_torch/csrc/fused_post.cu", f"{PK}:1075",
                       f"{PK}:make_fused_post (masked, limiter)",
                       "fused_post", "fwd"),
    "fused_diag_fwd": ("dflo_tpu_torch/csrc/fused_diag.cu", f"{PK}:1663",
                       f"{PK}:make_fused_diag (masked)", "fused_diag", "fwd"),
    "volume_residual": ("dflo_tpu_torch/csrc/volume_residual.cu",
                        f"{PK}:166", f"{PK}:volume_residual",
                        "volume_residual", "pallas"),
    "fused_post_block": ("dflo_tpu_torch/csrc/fused_post.cu", f"{PK}:1536",
                         f"{PK}:make_fused_post_sharded",
                         "fused_post_block", "shard"),
    "fused_diag_sharded": ("dflo_tpu_torch/csrc/fused_diag.cu", f"{PK}:1758",
                           f"{PK}:make_fused_diag_sharded",
                           "fused_diag_sharded", "shard"),
    "fused_residual_pk_lxf": ("dflo_tpu_torch/csrc/fused_residual_lxf.cu",
                              f"{PK}:617",
                              f"{PK}:make_fused_residual (modal Pk, lxf)",
                              "fused_residual[pk_lxf_stage]", "vortex"),
    "fused_diag_pk_vortex": ("dflo_tpu_torch/csrc/fused_diag.cu",
                             f"{PK}:1663", f"{PK}:make_fused_diag (Pk)",
                             "fused_diag", "vortex"),
    "fused_mood_candidate_lxf": ("dflo_tpu_torch/csrc/"
                                 "fused_mood_candidate_lxf.cu", f"{PK}:955",
                                 f"{PK}:make_fused_residual(...).sparse (lxf)",
                                 "fused_mood_candidate[lxf]", "sod_mood"),
    "fused_post_pbc": ("dflo_tpu_torch/csrc/fused_post.cu", f"{PK}:1075",
                       f"{PK}:make_fused_post (periodic x and y, limiter)",
                       "fused_post", "pbc"),
    "fused_residual_grav": ("dflo_tpu_torch/csrc/fused_residual_src.cu",
                            f"{PK}:617",
                            f"{PK}:make_fused_residual (source, :573)",
                            "fused_residual[qk_hllc_grav_stage]", "rt"),
    "fused_residual_pk_grav": ("dflo_tpu_torch/csrc/fused_residual_src.cu",
                               f"{PK}:617",
                               f"{PK}:make_fused_residual (modal Pk, "
                               f"source, :573)",
                               "fused_residual[pk_hllc_grav_stage]", "rt_pk"),
    "fused_residual_force": ("dflo_tpu_torch/csrc/fused_residual_planes.cu",
                             f"{PK}:617",
                             f"{PK}:make_fused_residual (source, :573)",
                             "fused_residual[qk_hllc_force_stage]",
                             "rt_force"),
    "fused_residual_wbiso": ("dflo_tpu_torch/csrc/fused_residual_wb.cu",
                             f"{PK}:617",
                             f"{PK}:make_fused_residual (wb_iso, :578)",
                             "fused_residual[gll_hllc_wbiso_stage]", "iso"),
    "fused_diag_gll": ("dflo_tpu_torch/csrc/fused_diag.cu", f"{PK}:1663",
                       f"{PK}:make_fused_diag (GLL)", "fused_diag", "iso"),
    "fused_residual_roe": ("dflo_tpu_torch/csrc/fused_residual_roe.cu",
                           f"{PK}:617", f"{PK}:make_fused_residual (roe)",
                           "fused_residual[qk_roe_R]", "impl"),
    "fused_residual_sw": ("dflo_tpu_torch/csrc/fused_residual_sw.cu",
                          f"{PK}:617", f"{PK}:make_fused_residual (sw)",
                          "fused_residual[qk_sw_stage]", "flux_sw"),
    "fused_residual_kfvs": ("dflo_tpu_torch/csrc/fused_residual_kfvs.cu",
                            f"{PK}:617", f"{PK}:make_fused_residual (kfvs)",
                            "fused_residual[qk_kfvs_stage]", "flux_kfvs"),
    "fused_residual_kep": ("dflo_tpu_torch/csrc/fused_residual_kep.cu",
                           f"{PK}:617", f"{PK}:make_fused_residual (kep)",
                           "fused_residual[qk_kep_stage]", "flux_kep"),
    "fused_diag_impl": ("dflo_tpu_torch/csrc/fused_diag.cu", f"{PK}:1663",
                        f"{PK}:make_fused_diag (implicit)", "fused_diag",
                        "impl"),
    "fused_residual_pk_masked": ("dflo_tpu_torch/csrc/fused_residual_lxf.cu",
                                 f"{PK}:617",
                                 f"{PK}:make_fused_residual (modal Pk, "
                                 f"masked, lxf; u + dt*R)",
                                 "fused_residual[pk_lxf_masked_step]",
                                 "fwd_mood"),
    "fused_residual_pk_masked_rk": ("dflo_tpu_torch/csrc/"
                                    "fused_residual_lxf.cu", f"{PK}:617",
                                    f"{PK}:make_fused_residual (modal Pk, "
                                    f"masked, lxf; SSP stage)",
                                    "fused_residual[pk_lxf_masked_stage]",
                                    "fwd_rk"),
    **{f"fused_mood_candidate_{f}": (
        f"dflo_tpu_torch/csrc/fused_mood_candidate_{f}.cu", f"{PK}:955",
        f"{PK}:make_fused_residual(...).sparse ({f})",
        f"fused_mood_candidate[{f}]", f"dmr_{f}") for f in FLUX_NEW},
    "fused_diag_pk_masked": ("dflo_tpu_torch/csrc/fused_diag.cu",
                             f"{PK}:1663", f"{PK}:make_fused_diag (masked Pk)",
                             "fused_diag", "fwd_mood"),
    "fused_modal_pos_fwd": ("dflo_tpu_torch/csrc/fused_modal_pos.cu",
                            f"{PK}:1805", f"{PK}:make_fused_modal_pos "
                            f"(masked Pk, truncation)", "fused_modal_pos",
                            "fwd_mood"),
    "fused_mood_check_rt": ("dflo_tpu_torch/csrc/fused_mood_check.cu",
                            f"{PK}:2222", f"{PK}:make_fused_mood_check "
                            f"(gravity)", "fused_mood_check", "rt_mood"),
    "fused_pk_post_rt": ("dflo_tpu_torch/csrc/fused_pk_post.cu",
                         f"{PK}:1997", f"{PK}:make_fused_pk_post (gravity)",
                         "fused_pk_post", "rt_mood"),
    "fused_modal_pos_rt": ("dflo_tpu_torch/csrc/fused_modal_pos.cu",
                           f"{PK}:1805", f"{PK}:make_fused_modal_pos "
                           f"(gravity, truncation)", "fused_modal_pos",
                           "rt_mood"),
    **{f"fused_residual_pk{p}_lxf": (
        "dflo_tpu_torch/csrc/fused_residual_lxf.cu", f"{PK}:617",
        f"{PK}:make_fused_residual (modal P{p}, lxf; general dims)",
        "fused_residual[pk_lxf_stage]", f"vortex_p{p}") for p in (4, 6)},
    **{f"fused_diag_pk{p}": (
        "dflo_tpu_torch/csrc/fused_diag.cu", f"{PK}:1663",
        f"{PK}:make_fused_diag (P{p})", "fused_diag", f"vortex_p{p}")
       for p in (4, 6)},
    "fused_residual_q4_hllc": ("dflo_tpu_torch/csrc/fused_residual.cu",
                               f"{PK}:617", f"{PK}:make_fused_residual "
                               f"(Q4, hllc; general dims)",
                               "fused_residual[qk_hllc_stage]", "dmr_q4"),
    "fused_post_q4": ("dflo_tpu_torch/csrc/fused_post.cu", f"{PK}:1075",
                      f"{PK}:make_fused_post (Q4; general dims)",
                      "fused_post", "dmr_q4"),
    "fused_diag_q4": ("dflo_tpu_torch/csrc/fused_diag.cu", f"{PK}:1663",
                      f"{PK}:make_fused_diag (Q4)", "fused_diag", "dmr_q4"),
    "volume_residual_q4": ("dflo_tpu_torch/csrc/volume_residual.cu",
                           f"{PK}:166", f"{PK}:volume_residual (Q4; the tile "
                           f"kernel)", "volume_residual", "pallas_q4"),
    "fused_residual_q2oi_lxf": ("dflo_tpu_torch/csrc/fused_residual_lxf.cu",
                                f"{PK}:617", f"{PK}:make_fused_residual "
                                f"(over-integrated Q2 on 4 x 4 points, lxf; "
                                f"the V contraction, :450-459)",
                                "fused_residual[qk_lxf_stage]", "q2oi"),
    "fused_diag_q2oi": ("dflo_tpu_torch/csrc/fused_diag.cu", f"{PK}:1663",
                        f"{PK}:make_fused_diag (over-integrated Q2)",
                        "fused_diag", "q2oi"),
    "fused_residual_roe_grav": ("dflo_tpu_torch/csrc/"
                                "fused_residual_src_roe.cu", f"{PK}:617",
                                f"{PK}:make_fused_residual (source, :573; "
                                f"roe)", "fused_residual[qk_roe_grav_stage]",
                                "rt_roe"),
    "fused_residual_roe_wbiso": ("dflo_tpu_torch/csrc/"
                                 "fused_residual_wb_roe.cu", f"{PK}:617",
                                 f"{PK}:make_fused_residual (wb_iso, :578; "
                                 f"roe)",
                                 "fused_residual[gll_roe_wbiso_stage]",
                                 "iso_roe"),
    "fused_mood_candidate_p4": ("dflo_tpu_torch/csrc/fused_mood_candidate.cu",
                                f"{PK}:955",
                                f"{PK}:make_fused_residual(...).sparse (P4; "
                                f"general dims)",
                                "fused_mood_candidate[hllc]", "dmr_p4_mood"),
    "fused_modal_pos_p4": ("dflo_tpu_torch/csrc/fused_modal_pos.cu",
                           f"{PK}:1805", f"{PK}:make_fused_modal_pos (P4; "
                           f"general dims)", "fused_modal_pos",
                           "dmr_p4_mood"),
    "fused_pk_post_p4": ("dflo_tpu_torch/csrc/fused_pk_post.cu", f"{PK}:1997",
                         f"{PK}:make_fused_pk_post (P4; general dims)",
                         "fused_pk_post", "dmr_p4_mood"),
    "fused_mood_check_p4": ("dflo_tpu_torch/csrc/fused_mood_check.cu",
                            f"{PK}:2222", f"{PK}:make_fused_mood_check (P4)",
                            "fused_mood_check", "dmr_p4_mood"),
    "fused_residual_geo": ("dflo_tpu_torch/csrc/fused_residual.cu",
                           f"{PK}:617", f"{PK}:make_fused_residual (the .geo "
                           f"DMR: segmented S strips, SSP stage)",
                           "fused_residual[qk_hllc_stage]", "dmr_geo"),
    "fused_residual_pressure": ("dflo_tpu_torch/csrc/fused_residual_lxf.cu",
                                f"{PK}:617",
                                f"{PK}:make_fused_residual (masked, lxf, "
                                f"a pressure outlet's E strips, SSP stage)",
                                "fused_residual[qk_lxf_masked_stage]",
                                "fwd_pressure"),
}
#: the grid each row is measured and bounded at, by path: the DMR's, the
#: forward step's, the vortex's; the LxF candidate's launches come from
#: sod_mood (phase 16) and its times from the DMR run with LxF, the
#: periodic post's launches from vortex_system_pbc as shipped and its times
#: at 2048 x 2048
GRIDS = {"rk": (NX, NY), "mood": (NX, NY), "fwd": (FS_NX, FS_NY),
         "pallas": (FS_NX, FS_NY), "shard": (NX, NY), "vortex": (VX_N, VX_N),
         "sod_mood": (NX, NY), "pbc": (VX_N, VX_N), "rt": (RT_NX, RT_NY),
         "rt_pk": (RT_NX, RT_NY), "rt_force": (RT_NX, RT_NY),
         "iso": (ISO_N, ISO_N), "impl": (IMPL_N, IMPL_N),
         "flux_sw": (FLUX_N, FLUX_N), "flux_kfvs": (FLUX_N, FLUX_N),
         "flux_kep": (FLUX_N, FLUX_N), "fwd_mood": (FS_NX, FS_NY),
         "fwd_rk": (FS_NX, FS_NY), "rt_mood": (RT_NX, RT_NY),
         **{f"dmr_{f}": (NX, NY) for f in FLUX_NEW},
         "vortex_p4": (P4_N, P4_N), "vortex_p6": (P6_N, P6_N),
         "dmr_q4": (NX, NY), "pallas_q4": (NX, NY),
         "q2oi": (Q2OI_N, Q2OI_N), "rt_roe": (RT_NX, RT_NY),
         "iso_roe": (ISO_N, ISO_N), "dmr_p4_mood": (NX, NY),
         "dmr_geo": (NX, NY), "fwd_pressure": (FS_NX, FS_NY)}
#: the steps of each path whose rows carry launches per step
PATH_STEPS = {"dmr_p4_mood": MD_P4_STEPS, "dmr_geo": GEO_STEPS,
              "fwd_pressure": PRES_STEPS}
#: the kernel wrappers of dflo_tpu_torch.ops.kernels (each has a *_plain)
WRAPPERS = ("fused_residual", "fused_mood_candidate", "fused_post",
            "fused_diag", "fused_modal_pos", "fused_pk_post",
            "fused_mood_check", "volume_residual", "fused_post_sharded",
            "fused_diag_sharded")



def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def kernel_ms(fn, pattern: str, launches: int,
              reps: int = 20) -> float | None:
    """Device time per fn() call of the kernels whose names hold pattern:
    their events' durations summed over reps calls under torch.profiler
    (after a warm-up) over reps, so host gaps between launches are left
    out.  None unless the trace holds exactly `launches` such events per
    call (a trace that drops events would under-count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and pattern in e.name]
    return 1e-3 * sum(us) / reps if len(us) == launches * reps else None


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of fn() in ms, each call ending in a
    synchronize (host work and device work together)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def rel_err(k: torch.Tensor, p: torch.Tensor) -> float:
    """max over components of max|k - p| / max|p| (component = leading axis
    for states, the whole tensor for scalars)."""
    k, p = k.double(), p.double()
    if k.dim() == 0:
        return float((k - p).abs() / p.abs().clamp(min=1e-300))
    num = (k - p).abs().flatten(1).amax(1)
    den = p.abs().flatten(1).amax(1).clamp(min=1e-300)
    return float((num / den).max())


def abs_err(k: torch.Tensor, p: torch.Tensor) -> float:
    return float((k.double() - p.double()).abs().max())


#: the rows whose kernels equal their plain versions bitwise in every
#: comparison (NaN where the plain version has NaN, -0 equal to +0): the
#: diag (rows 6 and 7: max and min are exact) and the volume residual (row
#: 1: the plain version's products and sums in its order)
BITWISE_ROWS = ("fused_diag", "volume_residual")


def record(results, name, tag, pairs):
    """Fold the (kernel, plain) pairs' errors into results[name]; returns the
    largest relative error.  A row of BITWISE_ROWS must be bitwise."""
    r = results[name]
    if name.startswith(BITWISE_ROWS):
        eq = all(same(k, p) for k, p in pairs)
        r[f"bitwise_{tag}"] = r.get(f"bitwise_{tag}", True) and eq
        assert eq, f"{name} {tag} is not bitwise equal to its plain version"
    e = max(rel_err(k, p) for k, p in pairs)
    r[f"max_rel_err_{tag}"] = max(r.get(f"max_rel_err_{tag}", 0.0), e)
    r[f"max_abs_err_{tag}"] = max(r.get(f"max_abs_err_{tag}", 0.0),
                                  max(abs_err(k, p) for k, p in pairs))
    return e


@contextlib.contextmanager
def plain_versions(kernels):
    """Every kernel wrapper replaced by its plain version: the same control
    flow on the same card, for comparisons."""
    saved = {n: getattr(kernels, n) for n in WRAPPERS}
    for n in WRAPPERS:
        setattr(kernels, n, getattr(kernels, n + "_plain"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(kernels, n, f)


def work(name: str, basis, dtype, n: int, marked: int = 0, cells: int = 0,
         halo: int = 0, fluid: int = 0, flux: str = "lxf"):
    """(bytes, operations) that the kernel's function needs on n cells of
    `basis`: each input read once and each output written once.  Operations
    count a multiply-add as 2 and a division, square root or comparison as
    1: the linear maps by their operators' nonzero entries (V, Gx, Gy,
    faceV, the cell average, the positivity points' evaluation); each
    face's two traces and its flux once (two faces per cell); the Euler
    flux 20 per point, HLLC 100 per face point, LxF 70 (its two wave
    speeds from the cell averages), the positivity's point arithmetic 45
    per point, KXRCF 80 per face point.  The sharded post and diag do
    their single-device forms' work on the whole state (the halo lines are
    intermediates, not inputs).  Bytes of the diag:
    only the modes its cell average reads.  Data-dependent work
    is counted on this run's data: the characteristic TVB (300 per cell plus
    the rebuild) on the `marked` cells only; the candidate's residual on its
    `cells` and its {truncation -> positivity} chain once on each of the
    `halo` cells (the set with its face neighbors); the forward step's
    `limiter` indicator sends every `fluid` cell to the TVB (its kernel
    computes the slopes of every cell), the periodic post's every cell
    (`marked`).  LxF costs 70 per face point and the two cells' averages.  A mask costs one byte per cell,
    the post's flag plane five.  The source arms: a body force 6 per
    quadrature point and its lift by the nonzero entries of src =
    minv (wq2 V)^T (the force planes add their 2Q values per cell); the
    isothermal arm reads phi (K per cell) and costs RT 10, exp and the
    division 3 per node, the nodal derivatives by Gxn's and Gyn's nonzero
    entries and 14 per node for S and its adds.  The fluxes per face
    point: HLLC 100, LxF 70, Roe 150, Steger-Warming 110, KFVS 130 (exp
    counted as one operation), KEP 250 (logs likewise) and KEP's averages
    as LxF's; the roe row is its R form (u read, R written), the others
    and "_stage" names the SSP-stage form.  The candidates with the new
    fluxes count as the hllc candidate with their flux's cost; the masked
    modal rows as the modal residual with `flux` (LxF unless named) plus a
    mask byte per cell, in the u + dt*R form (MOOD's pass 1) and the
    SSP-stage form (RK).  The rows of phase 24's masked and gravity paths
    count as their DMR or forward-step rows, the positivity with
    truncation (the cascade's form) reading the degree map besides."""
    from dflo_tpu_torch.stab.positivity import _pos_points
    name = {"fused_diag_pk_masked": "fused_diag_fwd",
            "fused_pk_post_rt": "fused_pk_post",
            "fused_mood_check_rt": "fused_mood_check",
            "fused_residual_q4_hllc": "fused_residual",
            "fused_residual_pk4_lxf": "fused_residual_pk_lxf",
            "fused_residual_pk6_lxf": "fused_residual_pk_lxf",
            "fused_residual_q2oi_lxf": "fused_residual_pk_lxf",
            "fused_post_q4": "fused_post", "fused_diag_q4": "fused_diag",
            "fused_diag_pk4": "fused_diag", "fused_diag_pk6": "fused_diag",
            "fused_diag_q2oi": "fused_diag",
            "volume_residual_q4": "volume_residual",
            "fused_mood_candidate_p4": "fused_mood_candidate",
            "fused_modal_pos_p4": "fused_modal_pos",
            "fused_pk_post_p4": "fused_pk_post",
            "fused_mood_check_p4": "fused_mood_check",
            "fused_residual_geo": "fused_residual",
            "fused_residual_pressure": "fused_residual_fwd"}.get(name, name)

    def nnz(a):
        """nonzero entries; an entry within 1e-12 of the largest is a zero
        integral's quadrature round-off (the Pk average's modes 1..K-1)"""
        a = torch.as_tensor(a).abs()
        return int((a > 1e-12 * a.max()).sum())

    S = 4 if dtype == torch.float32 else 8
    K = basis.K
    nq = basis.faceV.shape[1]
    # the DoFs go through V to the points: modal Pk, and a nodal basis off
    # its nodes (over-integrated)
    contract = not basis.is_nodal_collocated
    state = 4 * K * S
    avg = basis.wq2 @ basis.V
    FLUX_OPS = {"roe": 150, "sw": 110, "kfvs": 130, "kep": 250}
    res = (8 * nnz(basis.V) * contract                  # point values
           + 20 * basis.V.shape[0]                      # Euler fluxes
           + 8 * (nnz(basis.Gx) + nnz(basis.Gy))        # volume lift
           + 8 * nnz(basis.faceV)                       # face traces
           + 2 * nq * 100                               # HLLC
           + 8 * nnz(basis.faceV))                      # face lifts
    vp = basis.eval_at(_pos_points(basis.degree))
    pos = 8 * nnz(vp) + 45 * vp.shape[0] + 16 * K + 20
    tvb = 300 + 32 * K
    if name == "fused_residual":             # SSP-stage form, main path
        return 3 * state * n, (res + 20 * K) * n
    Q = basis.V.shape[0]
    src = ((1.0 / basis.mass)[:, None] * basis.wq2[None, :] * basis.V.T)
    force = 6 * Q + 8 * nnz(src)            # S(W) and its lift
    wbiso = 10 + 17 * K + 2 * (nnz(basis.Gx) + nnz(basis.Gy))
    roe = res - 2 * nq * 100 + 2 * nq * FLUX_OPS["roe"]
    if name == "fused_residual_roe_grav":    # the arms with roe, stage form
        return 3 * state * n, (roe + 20 * K + force) * n
    if name == "fused_residual_roe_wbiso":
        return 3 * state * n + K * S * n, (roe + 20 * K + wbiso) * n
    nflux = name[len("fused_residual_"):].split("_")[0]
    if name.startswith("fused_residual_") and nflux in FLUX_OPS:
        ops = res - 2 * nq * 100 + 2 * nq * FLUX_OPS[nflux]
        if nflux == "kep":
            ops += 8 * nnz(avg)
        if nflux == "roe" and not name.endswith("_stage"):
            return 2 * state * n, ops * n
        return 3 * state * n, (ops + 20 * K) * n
    if name in ("fused_residual_grav", "fused_residual_pk_grav"):
        return 3 * state * n, (res + 20 * K + force) * n
    if name == "fused_residual_force":       # + the planes fx, fy
        return 3 * state * n + 2 * Q * S * n, (res + 20 * K + force) * n
    if name == "fused_residual_wbiso":       # + phi; RT, exp, grad E, S
        return 3 * state * n + K * S * n, (res + 20 * K + wbiso) * n
    lxf = res - 2 * nq * 100 + 2 * nq * 70 + 8 * nnz(avg)
    if name == "fused_residual_fwd":         # masked LxF, SSP-stage form
        return 3 * state * n + n, (lxf + 20 * K) * n
    if name == "fused_residual_pk_lxf":      # modal LxF, SSP-stage form
        return 3 * state * n, (lxf + 20 * K) * n
    if name == "fused_mood_candidate_lxf":
        return (halo * (state + 4) + cells * state + n,
                (lxf + 8 * K) * cells + pos * halo)
    cflux = name[len("fused_mood_candidate_"):]
    if name.startswith("fused_mood_candidate_") and cflux in FLUX_OPS:
        ops = res - 2 * nq * 100 + 2 * nq * FLUX_OPS[cflux]
        if cflux == "kep":
            ops += 8 * nnz(avg)
        return (halo * (state + 4) + cells * state + n,
                (ops + 8 * K) * cells + pos * halo)
    if name.startswith("fused_residual_pk_masked"):
        ops = (res - 2 * nq * 100
               + 2 * nq * {"hllc": 100, "lxf": 70, **FLUX_OPS}[flux]
               + (8 * nnz(avg) if flux in ("lxf", "kep") else 0))
        if name.endswith("_rk"):                # SSP stage
            return 3 * state * n + n, (ops + 20 * K) * n
        return 2 * state * n + n, (ops + 8 * K) * n    # u + dt*R
    if name == "fused_post_pbc":             # mark-all, no positivity, diag
        return 2 * state * n, (8 * K + 40) * n + tvb * marked
    if name == "volume_residual":
        return (2 * state * n,
                (20 * K + 8 * (nnz(basis.Gx) + nnz(basis.Gy))) * n)
    if name == "fused_post_fwd":             # masked, mark-all, with diag
        return (2 * state * n + 5 * n,
                (8 * K + pos + 40) * n + tvb * fluid)
    if name == "fused_diag_fwd":
        return 4 * nnz(avg) * S * n + n, (8 * nnz(avg) + 20) * n
    if name == "fused_residual_pk":          # u + dt*R, MOOD pass 1
        return 2 * state * n, (res + 8 * K) * n
    if name == "fused_mood_candidate":
        return (halo * (state + 4) + cells * state + n,
                (res + 8 * K) * cells + pos * halo)
    if name == "fused_modal_pos":            # main-path form: no truncation
        return 2 * state * n, pos * n
    if name in ("fused_modal_pos_fwd", "fused_modal_pos_rt"):
        return 2 * state * n + 4 * n, pos * n
    if name == "fused_pk_post":              # with diag
        return (2 * state + S) * n, (4 + pos + 40) * n + tvb * marked
    if name in ("fused_post", "fused_post_block"):     # with diag
        return (2 * state * n,
                (8 * K + 2 * nnz(basis.faceV) + 80 * nq + pos + 40) * n
                + tvb * marked)
    if name == "fused_mood_check":
        return (5 * S + 4 + 1 + 6) * n, 60 * n
    # fused_diag(_pk): the modes the cell average reads, then the wave speed
    return 4 * nnz(avg) * S * n, (8 * nnz(avg) + 20) * n


def bound(name, basis, dtype, n, **data):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the dtype's peak."""
    b, f = work(name, basis, dtype, n, **data)
    tb, tf = b / HBM_BPS, f / PEAK_FLOPS[dtype]
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def post_err(k: torch.Tensor, p: torch.Tensor, tol: float):
    """(relative error outside flipped cells, number of flipped cells): a
    cell is flipped when its own error exceeds tol (a threshold decision of
    the limiter went the other way)."""
    k, p = k.double(), p.double()
    scale = p.abs().flatten(1).amax(1).clamp(min=1e-300)       # [4]
    cell = ((k - p).abs() / scale[:, None, None, None]).amax((0, 1))
    flipped = cell > tol
    return float(torch.where(flipped, 0.0, cell).max()), int(flipped.sum())


class PlainStage:
    """The fused residual's SSP stage through its plain version."""

    def __init__(self, solver):
        self.s = solver

    def stage(self, u, u_old, t, a, dt):
        from dflo_tpu_torch.ops import kernels
        sc = torch.stack([torch.full_like(dt, a), dt])
        return kernels.fused_residual_plain(u, *self.s.rhs.strips(u, t),
                                            self.s.rhs.ops, u_old=u_old, sc=sc)


def plain_step(s, u, t, t_end):
    """Solver._make_step()'s step with every kernel replaced by its plain
    version (the same control flow, for comparisons on one device)."""
    from dflo_tpu_torch.ops import kernels
    from dflo_tpu_torch.solver import rk as rk_mod
    from dflo_tpu_torch.stab.positivity import EPS
    t, t_end = s._scalar(t), s._scalar(t_end)
    lam, _ = kernels.fused_diag_plain(u, s._diag_ops)
    dt = torch.minimum(s.cfl / lam / (2.0 * s.basis.degree + 1.0), t_end - t)
    u, _lam, minq = rk_mod.ssp_rk_step(
        PlainStage(s), u, t, dt, s.ark, s.stage_times,
        post_stage=lambda v, tc: kernels.fused_post_plain(s.apply_mask(v),
                                                          s._post_ops, True),
        post_diag=True)
    return u, dt, ~(minq >= EPS)


def phase_kernels(entry, kernels, euler, results):
    """Phase 2 for both dtypes; fills results[name][...] and returns
    {tag: (solver, state after post_stage, state after 10 plain steps, t)}
    for phase 12."""
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.solver.spatial import BoundarySide
    states = {}
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        tol = TOL[dt]
        s, u0 = entry._build(NX, NY, dtype=dt, device="cuda")
        u_a = s.post_stage(u0)
        u_b, t = u_a, 0.0
        for _ in range(10):
            u_b, dtt, bad = plain_step(s, u_b, t, 1.0)
            t += float(dtt)
            assert not bool(bad), f"{tag}: plain steps tripped the fatal flag"
        ubar = s.cell_averages(u_b)
        shock, _ = s._post_ops.indicator(u_b, ubar)
        n_marked = int((shock > 1.0).sum())
        print(f"[{tag}] state after 10 plain steps: t={t!r}, "
              f"{n_marked} cells marked by KXRCF")
        assert n_marked > 0, "the indicator marks no cell"
        results["fused_post"][f"data_{tag}"] = {"marked": n_marked}
        results["fused_post_block"][f"data_{tag}"] = {"marked": n_marked}
        states[tag] = (s, u_a, u_b, t)

        tt = torch.full((), t, dtype=dt, device="cuda")
        dtt = torch.full((), 1e-4, dtype=dt, device="cuda")
        sc = torch.stack([torch.full_like(dtt, 0.75), dtt])
        for label, u in (("post_stage", u_a), ("10 steps", u_b)):
            strips = s.rhs.strips(u, tt)
            ops = s.rhs.ops
            checks = {
                "fused_residual": [
                    (kernels.fused_residual(u, *strips, ops),
                     kernels.fused_residual_plain(u, *strips, ops)),
                    (kernels.fused_residual(u, *strips, ops, u_old=u_a, sc=sc),
                     kernels.fused_residual_plain(u, *strips, ops, u_old=u_a,
                                                  sc=sc))],
                "fused_diag": list(zip(kernels.fused_diag(u, s._diag_ops),
                                       kernels.fused_diag_plain(u,
                                                                s._diag_ops))),
            }
            pk = kernels.fused_post(u, s._post_ops, with_diag=True)
            pp = kernels.fused_post_plain(u, s._post_ops, with_diag=True)
            pk0 = kernels.fused_post(u, s._post_ops)
            torch.cuda.synchronize()
            for name, pairs in checks.items():
                e = record(results, name, tag, pairs)
                print(f"[{tag}] {label}: {name} rel err {e:.3e} "
                      f"(tol {tol[name]:.0e})")
                assert e <= tol[name], f"{name} {tag} disagrees: {e}"
            e_in, n_flip = post_err(pk[0], pp[0], tol["fused_post"])
            e0_in, n_flip0 = post_err(pk0, pp[0], tol["fused_post"])
            e_diag = max(rel_err(pk[1], pp[1]), rel_err(pk[2], pp[2]))
            e = max(e_in, e0_in, e_diag)
            nflip = max(n_flip, n_flip0)
            r = results["fused_post"]
            r[f"max_rel_err_{tag}"] = max(r.get(f"max_rel_err_{tag}", 0), e)
            r[f"max_abs_err_{tag}"] = max(r.get(f"max_abs_err_{tag}", 0),
                                          abs_err(pk[0], pp[0]))
            r[f"flipped_cells_{tag}"] = max(r.get(f"flipped_cells_{tag}", 0),
                                            nflip)
            print(f"[{tag}] {label}: fused_post rel err {e:.3e} outside "
                  f"{nflip} flipped cells (tol {tol['fused_post']:.0e}); "
                  f"diag rel err {e_diag:.3e}")
            assert e <= tol["fused_post"], f"fused_post {tag} disagrees: {e}"
            if dt == torch.float64:
                assert nflip == 0, "f64 post flipped a limiter decision"
            else:
                assert nflip <= MAX_FLIP_FRACTION * NX * NY, \
                    f"too many flipped cells: {nflip}"

        # ---- times on the 10-step state (main-path forms) ----------------
        strips = s.rhs.strips(u_b, tt)
        ops = s.rhs.ops
        timings = {
            "fused_residual": (
                lambda: kernels.fused_residual(u_b, *strips, ops, u_old=u_a,
                                               sc=sc),
                lambda: kernels.fused_residual_plain(u_b, *strips, ops,
                                                     u_old=u_a, sc=sc)),
            "fused_post": (
                lambda: kernels.fused_post(u_b, s._post_ops, with_diag=True),
                lambda: kernels.fused_post_plain(u_b, s._post_ops,
                                                 with_diag=True)),
            "fused_diag": (
                lambda: kernels.fused_diag(u_b, s._diag_ops),
                lambda: kernels.fused_diag_plain(u_b, s._diag_ops)),
        }
        for name, (fk, fp) in timings.items():
            ms_k = time_ms(fk)
            ms_p = time_ms(fp)
            results[name][f"ms_{tag}"] = ms_k
            results[name][f"plain_ms_{tag}"] = ms_p
            print(f"[{tag}] {name}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms "
                  f"at {NX}x{NY}")

        # ---- NaN must reach the fatal flag -------------------------------
        u_nan = u_b.clone()
        u_nan[:, :, NY // 2, NX // 3] = float("nan")
        _lam, minq = kernels.fused_diag(u_nan, s._diag_ops)
        _u, _lam2, minq2 = kernels.fused_post(u_nan, s._post_ops,
                                              with_diag=True)
        _u, _dt, bad, _st = s._make_step()(u_nan, 0.0, 1.0)
        from dflo_tpu_torch.stab.positivity import EPS
        flags = [bool(~(minq >= EPS)), bool(~(minq2 >= EPS)), bool(bad)]
        print(f"[{tag}] one NaN cell -> fatal flag (diag, post, step): {flags}")
        assert all(flags), "a NaN cell did not reach the fatal flag"

    # ---- f64 free stream through the residual kernel ---------------------
    # round-off in du/dt scales like |F|/dx: 1e-12 is held at 128 x 32 (the
    # CPU tests' bound), the full width to the same bound times nx / 128
    per = BoundarySide(euler.BC_PERIODIC)
    lim = LimiterConfig(type="TVB", shock_indicator="density", beta=2.0,
                        char_lim=True, pos_lim=True)
    basis = make_basis("Qk", 2)
    rho, vx, vy, p = 1.4, 0.7, -0.3, 1.0
    state = torch.tensor([rho * vx, rho * vy, rho,
                          p / (euler.GAMMA - 1.0)
                          + 0.5 * rho * (vx * vx + vy * vy)],
                         dtype=torch.float64, device="cuda")
    for nx, ny in ((128, 32), (NX, NY)):
        fs = Solver(basis, CartesianMesh(nx, ny, 0.0, 4.0, 0.0, 1.0),
                    dict(W=per, E=per, S=per, N=per), flux="hllc",
                    limiter=lim, cfl=0.5, dtype=torch.float64, device="cuda")
        u_fs = state[:, None, None, None].expand(4, basis.K, ny, nx)
        R = fs.rhs(u_fs.contiguous(), 0.0)
        torch.cuda.synchronize()
        fs_max = float(R.abs().max())
        bound = 1e-12 * (nx / 128)
        print(f"[f64] free stream {nx}x{ny}: max|du/dt| through "
              f"fused_residual {fs_max:.3e} (bound {bound:.1e})")
        assert fs_max < bound, "free stream not preserved"
        results[f"free_stream_f64_{nx}x{ny}"] = fs_max
    return states


def cascade_pass1(kernels, s, u, tt, h) -> dict:
    """Pass 1 of a MOOD stage of solver s on u through the plain versions:
    the DMP bounds, the initial planes, the strips, the forward-Euler
    candidate u_c and its check (deg1, lim1, chg1), and the cell set the
    next pass recomputes (aff: the changed cells, their neighbors and the
    cells the full-degree positivity chain moves, with their neighbors),
    with the data the candidate's bound counts."""
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.stab import mood as mood_mod
    stage = s._mood_stage
    mops = stage.mops
    ny, nx = u.shape[-2:]
    rho0 = mops.avg0 * u[euler.RHO, 0]
    out = {"bmin": mood_mod.neighborhood_min(rho0, stage.valid),
           "bmax": mood_mod.neighborhood_max(rho0, stage.valid),
           "deg0": torch.full((ny, nx), s.basis.degree, dtype=torch.int32,
                              device=u.device),
           "lim0": torch.zeros((ny, nx), dtype=torch.bool, device=u.device),
           "strips": s.rhs.strips(u, tt)}
    out["u_c"] = kernels.fused_residual_plain(u, *out["strips"], s.rhs.ops,
                                              dt=h)
    with plain_versions(kernels):       # on a masked domain the plain check
        out["deg1"], out["lim1"], out["chg1"] = stage._check(
            out["u_c"], out["bmin"], out["bmax"], out["deg0"], out["lim0"])
    moved = (kernels.fused_modal_pos_plain(u, mops) != u).flatten(0, 1).any(0)
    aff = (out["chg1"] | mood_mod.dilate4(out["chg1"])
           | mood_mod.dilate4(moved))
    out["aff"] = aff
    out["data"] = {"cells": int(aff.sum()),
                   "halo": int(mood_mod.dilate4(aff).sum())}
    return out


def phase_mood_kernels(entry, kernels, results):
    """Phase 5 for both dtypes; fills results[name][...], with the data the
    bounds count (marked cells, the candidate's cell set and halo)."""
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.stab import mood as mood_mod
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        tol = TOL[dt]
        s, u0 = entry._build(NX, NY, dtype=dt, device="cuda", method="mood")
        u, t = s.post_stage(u0), 0.0
        with plain_versions(kernels):
            for _ in range(MOOD_PLAIN_STEPS):
                u, dtt, bad, st = s._step(u, t, 1.0)
                t += float(dtt)
                assert not bool(bad), f"{tag}: plain MOOD steps tripped bad"
            # one stage through the plain versions: its marks feed the post
            _, marked, st_plain, _ = s._mood_stage(u, s._scalar(t), dtt)
        stage, rops = s._mood_stage, s.rhs.ops
        mops, cops, pops = stage.mops, stage.cops, s._pk_post_ops
        tt, h = s._scalar(t), dtt
        print(f"[{tag}] MOOD state after {MOOD_PLAIN_STEPS} plain steps: "
              f"t={t!r}; a plain stage: n_reduce={int(st_plain.n_reduce)}, "
              f"n_marked={int(st_plain.n_marked)}, passes={st_plain.iters}")
        assert int(st_plain.n_reduce) > 0, "the cascade does not fire"

        # pass 1 and its check give a realistic degree map and cell set
        c1 = cascade_pass1(kernels, s, u, tt, h)
        bmin, bmax, deg0, lim0 = c1["bmin"], c1["bmax"], c1["deg0"], c1["lim0"]
        strips, u_c, deg1, lim1, chg1, aff = (
            c1["strips"], c1["u_c"], c1["deg1"], c1["lim1"], c1["chg1"],
            c1["aff"])
        n_set = int(aff.sum())
        results["fused_mood_candidate"][f"data_{tag}"] = c1["data"]
        results["fused_pk_post"][f"data_{tag}"] = {
            "marked": int(marked.sum())}
        every = torch.ones_like(aff)
        tp_strips = s.rhs.strips(u, tt, deg1)
        shock = marked.to(dt) * 2.0

        def cand(fn, cells):
            return fn(u, u_c.clone(), deg1, cells, *tp_strips, rops, mops, h)

        checks = {
            "fused_residual_pk": [
                (kernels.fused_residual(u, *strips, rops),
                 kernels.fused_residual_plain(u, *strips, rops)),
                (kernels.fused_residual(u, *strips, rops, dt=h), u_c)],
            "fused_mood_candidate": [
                (cand(kernels.fused_mood_candidate, c),
                 cand(kernels.fused_mood_candidate_plain, c))
                for c in (aff, every)],
            "fused_modal_pos": [
                pair for deg in (None, deg1)
                for pair in [(kernels.fused_modal_pos(u, mops, deg),
                              kernels.fused_modal_pos_plain(u, mops, deg)),
                             *zip(kernels.fused_modal_pos(u, mops, deg,
                                                          with_diag=True),
                                  kernels.fused_modal_pos_plain(
                                      u, mops, deg, with_diag=True))]],
            "fused_diag_pk": list(zip(kernels.fused_diag(u, s._diag_ops),
                                      kernels.fused_diag_plain(u,
                                                               s._diag_ops))),
        }
        torch.cuda.synchronize()
        for name, pairs in checks.items():
            e = record(results, name, tag, pairs)
            print(f"[{tag}] {name} rel err {e:.3e} (tol "
                  f"{tol.get(name, tol['fused_diag']):.0e})")
            assert e <= tol.get(name, tol["fused_diag"]), \
                f"{name} {tag} disagrees: {e}"
        # cells off the set keep u_prev bitwise
        kc = cand(kernels.fused_mood_candidate, aff)
        assert torch.equal(kc[..., ~aff], u_c[..., ~aff])

        pk = kernels.fused_pk_post(u, shock, pops, with_diag=True)
        pp = kernels.fused_pk_post_plain(u, shock, pops, with_diag=True)
        pk0 = kernels.fused_pk_post(u, shock, pops)
        torch.cuda.synchronize()
        e_in, nflip = post_err(pk[0], pp[0], tol["fused_pk_post"])
        e0_in, nflip0 = post_err(pk0, pp[0], tol["fused_pk_post"])
        e_diag = max(rel_err(pk[1], pp[1]), rel_err(pk[2], pp[2]))
        r = results["fused_pk_post"]
        e = max(e_in, e0_in, e_diag)
        r[f"max_rel_err_{tag}"] = e
        r[f"max_abs_err_{tag}"] = abs_err(pk[0], pp[0])
        r[f"flipped_cells_{tag}"] = max(nflip, nflip0)
        r[f"bitwise_{tag}"] = bool(torch.equal(pk[0], pp[0]))
        print(f"[{tag}] fused_pk_post rel err {e:.3e} outside "
              f"{max(nflip, nflip0)} flipped cells of {int(marked.sum())} "
              f"marked (tol {tol['fused_pk_post']:.0e}); bitwise "
              f"{r[f'bitwise_{tag}']}; diag rel err {e_diag:.3e}")
        assert e <= tol["fused_pk_post"], f"fused_pk_post {tag}: {e}"
        assert (nflip == nflip0 == 0 if dt == torch.float64
                else max(nflip, nflip0) <= MAX_FLIP_FRACTION * NX * NY)

        # the check, bitwise: on pass 1 and on a later pass
        candk = cand(kernels.fused_mood_candidate, aff)
        for (uc, dg, lm) in ((u_c, deg0, lim0), (candk, deg1, lim1)):
            outk = kernels.fused_mood_check(uc, bmin, bmax, dg, lm, cops)
            outp = kernels.fused_mood_check_plain(uc, bmin, bmax, dg, lm,
                                                  cops)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(outk, outp)), \
                f"fused_mood_check {tag} is not bitwise"
        results["fused_mood_check"][f"max_abs_err_{tag}"] = 0.0
        results["fused_mood_check"][f"max_rel_err_{tag}"] = 0.0
        print(f"[{tag}] fused_mood_check bitwise equal (pass 1: "
              f"{int(chg1.sum())} cells reduced); candidate cell set "
              f"{n_set} of {NX * NY}")

        # ---- times, main-path forms ---------------------------------------
        u_prev = u_c.clone()
        timings = {
            "fused_residual_pk": (
                lambda: kernels.fused_residual(u, *strips, rops, dt=h),
                lambda: kernels.fused_residual_plain(u, *strips, rops, dt=h)),
            "fused_mood_candidate": (
                lambda: kernels.fused_mood_candidate(
                    u, u_prev, deg1, aff, *tp_strips, rops, mops, h),
                lambda: kernels.fused_mood_candidate_plain(
                    u, u_prev, deg1, aff, *tp_strips, rops, mops, h)),
            "fused_modal_pos": (
                lambda: kernels.fused_modal_pos(u, mops),
                lambda: kernels.fused_modal_pos_plain(u, mops)),
            "fused_pk_post": (
                lambda: kernels.fused_pk_post(u, shock, pops, with_diag=True),
                lambda: kernels.fused_pk_post_plain(u, shock, pops,
                                                    with_diag=True)),
            "fused_mood_check": (
                lambda: kernels.fused_mood_check(u_c, bmin, bmax, deg0, lim0,
                                                 cops),
                lambda: kernels.fused_mood_check_plain(u_c, bmin, bmax, deg0,
                                                       lim0, cops)),
            "fused_diag_pk": (
                lambda: kernels.fused_diag(u, s._diag_ops),
                lambda: kernels.fused_diag_plain(u, s._diag_ops)),
        }
        for name, (fk, fp) in timings.items():
            ms_k, ms_p = time_ms(fk), time_ms(fp)
            results[name][f"ms_{tag}"] = ms_k
            results[name][f"plain_ms_{tag}"] = ms_p
            print(f"[{tag}] {name}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms "
                  f"at {NX}x{NY}")
        if dt == torch.float32:
            # host clock, ending in a synchronize: the strips (plain torch,
            # O(boundary)) and one whole cascade stage through the kernels
            host = {"strips_ms": host_ms(lambda: s.rhs.strips(u, tt)),
                    "strips_tp_ms": host_ms(lambda: s.rhs.strips(u, tt,
                                                                 deg1)),
                    "mood_stage_ms": host_ms(lambda: stage(u, tt, h))}
            results["mood_host_f32"] = host
            print(f"[{tag}] host ms (median of 5): {host}")

        # ---- NaN must reach the fatal flag through the Pk post diag -------
        u_nan = u.clone()
        u_nan[:, :, NY // 2, NX // 3] = float("nan")
        from dflo_tpu_torch.stab.positivity import EPS
        _u, _lam, minq = kernels.fused_pk_post(u_nan, shock, pops,
                                               with_diag=True)
        assert bool(~(minq >= EPS)), "a NaN cell did not reach the flag"


def plain_rhs(s):
    """The plain ("xla") residual of solver s's configuration."""
    from dflo_tpu_torch.solver.spatial import make_rhs
    return make_rhs(s.basis, s.mesh, s.bcs, flux=s.flux, dtype=s.dtype,
                    device=s.device, volume_kernel="xla", mask=s.mask)


def prm_solver(prm, dtype, n: int | None = None, grid=None, edit=None,
               **solver_kw):
    """(params, solver, IC) of a .prm config on the card, through the
    port's config layer and CLI builders; n: an n x n grid, grid: an
    (nx, ny) grid in place of the shipped one; edit(params): other changes
    to the parameters."""
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.config.params import AllParameters
    params = AllParameters.from_prm_file(prm)
    if n is not None:
        grid = (n, n)
    if grid is not None:
        params.cartesian_mesh.nx, params.cartesian_mesh.ny = grid
    if edit is not None:
        edit(params)
    s, _ = cli.build_solver(params, dtype=dtype, device="cuda", **solver_kw)
    return params, s, cli.set_ic(params, s)


def fs_solver(dtype, **solver_kw):
    """(params, solver, IC) of examples/forward_step_tpu.prm on the card."""
    params, s, u0 = prm_solver(FS_PRM, dtype, **solver_kw)
    assert (s.mesh.nx, s.mesh.ny) == (FS_NX, FS_NY)
    return params, s, u0


def check_post(results, name, tag, tol, pk, pk0, pp):
    """Fold a post's (kernel with diag, kernel without, plain with diag)
    into results[name]: error outside flipped cells, flipped cells, diag."""
    e_in, n_flip = post_err(pk[0], pp[0], tol)
    e0_in, n_flip0 = post_err(pk0, pp[0], tol)
    e_diag = max(rel_err(pk[1], pp[1]), rel_err(pk[2], pp[2]))
    e, nflip = max(e_in, e0_in, e_diag), max(n_flip, n_flip0)
    r = results[name]
    r[f"max_rel_err_{tag}"] = max(r.get(f"max_rel_err_{tag}", 0), e)
    r[f"max_abs_err_{tag}"] = max(r.get(f"max_abs_err_{tag}", 0),
                                  abs_err(pk[0], pp[0]))
    r[f"flipped_cells_{tag}"] = max(r.get(f"flipped_cells_{tag}", 0), nflip)
    r[f"bitwise_{tag}"] = (r.get(f"bitwise_{tag}", True)
                           and bool(torch.equal(pk[0], pp[0])))
    return e, nflip, e_diag


def phase_fwd_kernels(kernels, results):
    """Phase 9 for both dtypes: the forward-step kernels against their
    plain versions at 1920 x 640; returns the f64 10-step state for phase
    11."""
    out = {}
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        tol = TOL[dt]
        params, s, u0 = fs_solver(dt)
        mask = s._post_ops.mask
        u_a = s.post_stage(u0)
        u_b, t = u_a, 0.0
        for _ in range(FS_PLAIN_STEPS):
            u_b, dtt, bad = plain_step(s, u_b, t, params.final_time)
            t += float(dtt)
            assert not bool(bad), f"{tag}: plain steps tripped the fatal flag"
        n_fluid = int(mask.sum())
        print(f"[{tag}] forward step after {FS_PLAIN_STEPS} plain steps: "
              f"t={t!r}, {n_fluid} fluid cells of {FS_NX * FS_NY}")
        results["fused_post_fwd"][f"data_{tag}"] = {"fluid": n_fluid}
        out[tag] = (s, u_b, t)

        ops = s.rhs.ops
        lift = plain_rhs(s).lift_stack          # [K, 2K] volume lift
        tt = torch.full((), t, dtype=dt, device="cuda")
        dtt = torch.full((), 1e-4, dtype=dt, device="cuda")
        sc = torch.stack([torch.full_like(dtt, 0.75), dtt])
        for label, u in (("post_stage", u_a), (f"{FS_PLAIN_STEPS} steps",
                                               u_b)):
            strips = s.rhs.strips(u, tt)
            checks = {
                "fused_residual_fwd": [
                    (kernels.fused_residual(u, *strips, ops),
                     kernels.fused_residual_plain(u, *strips, ops)),
                    (kernels.fused_residual(u, *strips, ops, u_old=u_a, sc=sc),
                     kernels.fused_residual_plain(u, *strips, ops, u_old=u_a,
                                                  sc=sc))],
                "fused_diag_fwd": list(zip(
                    kernels.fused_diag(u, s._diag_ops),
                    kernels.fused_diag_plain(u, s._diag_ops))),
                "volume_residual": [(kernels.volume_residual(lift, u),
                                     kernels.volume_residual_plain(lift, u))],
            }
            pk = kernels.fused_post(u, s._post_ops, with_diag=True)
            pp = kernels.fused_post_plain(u, s._post_ops, with_diag=True)
            pk0 = kernels.fused_post(u, s._post_ops)
            torch.cuda.synchronize()
            for name, pairs in checks.items():
                e = record(results, name, tag, pairs)
                tname = name.replace("_fwd", "")
                print(f"[{tag}] forward step, {label}: {name} rel err "
                      f"{e:.3e} (tol {tol[tname]:.0e})")
                assert e <= tol[tname], f"{name} {tag} disagrees: {e}"
            e, nflip, e_diag = check_post(results, "fused_post_fwd", tag,
                                          tol["fused_post"], pk, pk0, pp)
            print(f"[{tag}] forward step, {label}: fused_post_fwd rel err "
                  f"{e:.3e} outside {nflip} flipped cells (tol "
                  f"{tol['fused_post']:.0e}); bitwise "
                  f"{results['fused_post_fwd'][f'bitwise_{tag}']}; diag rel "
                  f"err {e_diag:.3e}")
            assert e <= tol["fused_post"], f"fused_post_fwd {tag}: {e}"
            if dt == torch.float64:
                assert nflip == 0, "f64 post flipped a limiter decision"
            else:
                assert nflip <= MAX_FLIP_FRACTION * FS_NX * FS_NY, \
                    f"too many flipped cells: {nflip}"

        # ---- times on the 10-step state (main-path forms) ----------------
        strips = s.rhs.strips(u_b, tt)
        timings = {
            "fused_residual_fwd": (
                lambda: kernels.fused_residual(u_b, *strips, ops, u_old=u_a,
                                               sc=sc),
                lambda: kernels.fused_residual_plain(u_b, *strips, ops,
                                                     u_old=u_a, sc=sc)),
            "fused_post_fwd": (
                lambda: kernels.fused_post(u_b, s._post_ops, with_diag=True),
                lambda: kernels.fused_post_plain(u_b, s._post_ops,
                                                 with_diag=True)),
            "fused_diag_fwd": (
                lambda: kernels.fused_diag(u_b, s._diag_ops),
                lambda: kernels.fused_diag_plain(u_b, s._diag_ops)),
            "volume_residual": (
                lambda: kernels.volume_residual(lift, u_b),
                lambda: kernels.volume_residual_plain(lift, u_b)),
        }
        for name, (fk, fp) in timings.items():
            ms_k = time_ms(fk)
            ms_p = time_ms(fp)
            results[name][f"ms_{tag}"] = ms_k
            results[name][f"plain_ms_{tag}"] = ms_p
            print(f"[{tag}] {name}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms "
                  f"at {FS_NX}x{FS_NY}")
    return out


def phase_main_fwd(kernels, plain_calls):
    """Phase 10: the forward step through the port's CLI; returns its launch
    counts, ms/step and (solver, state) for the trace."""
    from dflo_tpu_torch import cli
    with tempfile.TemporaryDirectory() as out:
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        t0 = time.perf_counter()
        res = cli.run([FS_PRM, "--max-steps", str(FS_STEPS), "--chunk",
                       str(FS_CHUNK), "--output-dir", out])
        torch.cuda.synchronize()
        wall_cli = time.perf_counter() - t0
        counts = kernels.launch_counts()
        snaps = sorted(f for f in os.listdir(out) if f.endswith(".vtu"))
        sizes = [os.path.getsize(os.path.join(out, f)) for f in snaps]
    finite = bool(torch.isfinite(res.u).all())
    print(f"forward-step CLI: {res.it} steps to t={res.t!r} in {wall_cli:.2f} "
          f"s with set-up and output, finite={finite}, launches={counts}, "
          f"plain calls={plain_calls['n']}, snapshots {snaps} ({sizes} B)")
    assert res.it == FS_STEPS and finite
    assert res.u.dtype == torch.float32 and res.u.is_cuda
    assert all(counts[k] > 0 for k in ("fused_residual", "fused_post",
                                       "fused_diag")), counts
    assert plain_calls["n"] == 0, "the forward step called a plain version"
    assert snaps == ["solution-000.vtu", "solution-001.vtu"]

    # ---- the CLI's solver timed apart from output ------------------------
    s = res.solver
    multi = s._multi_step(FS_CHUNK)
    multi(res.u, res.t, 4.0)                       # warm-up
    torch.cuda.synchronize()
    u, t, n, bad = res.u, res.t, 0, False
    t0 = time.perf_counter()
    for _ in range(FS_STEPS // FS_CHUNK):
        u, t, nd, bad_c, _ = multi(u, t, 4.0)
        n, bad = n + nd, bad | bad_c
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, bad = int(n), bool(bad)
    assert n == FS_STEPS and not bad and bool(torch.isfinite(u).all())
    rate = 4 * s.basis.K * FS_NX * FS_NY * FS_STEPS / wall
    print(json.dumps({"fwdstep_q1_rk_tvb_dof_updates_per_sec": rate,
                      "unit": "DoF-updates/s", "dtype": "float32",
                      "grid": [FS_NX, FS_NY], "steps": FS_STEPS,
                      "chunk": FS_CHUNK, "ms_per_step": 1e3 * wall / FS_STEPS,
                      "cli_wall_s": wall_cli,
                      "launches_per_step": {k: v / FS_STEPS
                                            for k, v in counts.items()},
                      "card": card_line()}))
    return counts, 1e3 * wall / FS_STEPS, (s, u)


def phase_pallas(kernels, plain_calls, fwd_states):
    """Phase 11: the volume_kernel="pallas" path; returns its launch
    counts."""
    solvers = {}
    for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
        _, u, t = fwd_states[tag]
        _, s, _ = fs_solver(dt, volume_kernel="pallas", post_kernel="fused")
        solvers[tag] = s
        tt = s._scalar(t)
        e = rel_err(s.rhs(u, tt), plain_rhs(s)(u, tt))
        torch.cuda.synchronize()
        print(f"[{tag}] volume_kernel='pallas' residual against the plain "
              f"residual at {FS_NX}x{FS_NY}: rel err {e:.3e} "
              f"(tol {TOL[dt]['fused_residual']:.0e})")
        assert e <= TOL[dt]["fused_residual"]
    s = solvers["f32"]
    _, u, t = fwd_states["f32"]
    multi = s._multi_step(PALLAS_STEPS)
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    t0 = time.perf_counter()
    u1, t1, n, bad, _ = multi(u, t, 4.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n, bad = int(n), bool(bad)
    finite = bool(torch.isfinite(u1).all())
    print(f"volume_kernel='pallas' path (f32): {n} steps in {wall:.3f} s, "
          f"bad={bad}, finite={finite}, launches={counts}, plain calls="
          f"{plain_calls['n']}")
    assert n == PALLAS_STEPS and not bad and finite
    assert counts["volume_residual"] > 0 and counts["fused_post"] > 0
    assert counts["fused_residual"] == 0 and plain_calls["n"] == 0
    return counts


def phase_main_rk(entry, kernels, plain_calls):
    """Phase 3: the RK main path; returns its launch counts and ms/step."""
    solver, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda")
    u = solver.post_stage(u0)
    multi = solver._multi_step(MAIN_STEPS)
    solver._multi_step(2)(u, 0.0, 1.0e3)            # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    t0 = time.perf_counter()
    u1, t1, n_done, bad, _ = multi(u, 0.0, 1.0e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_done, bad = int(n_done), bool(bad)
    finite = bool(torch.isfinite(u1).all())
    print(f"RK main path: {n_done} steps to t={float(t1)!r} in {wall:.4f} s, "
          f"bad={bad}, finite={finite}, launches={counts}, "
          f"plain calls={plain_calls['n']}")
    assert n_done == MAIN_STEPS and not bad and finite
    assert all(counts[k] > 0 for k in ("fused_residual", "fused_post",
                                       "fused_diag")), counts
    assert plain_calls["n"] == 0, "the main path called a plain version"
    rate = 4 * solver.basis.K * NX * NY * MAIN_STEPS / wall
    print(json.dumps({"dmr_q2_rk_tvb_dof_updates_per_sec": rate,
                      "unit": "DoF-updates/s", "dtype": "float32",
                      "grid": [NX, NY], "steps": MAIN_STEPS,
                      "ms_per_step": 1e3 * wall / MAIN_STEPS,
                      "card": card_line()}))
    return counts, 1e3 * wall / MAIN_STEPS


def phase_main_mood(entry, kernels, plain_calls):
    """Phase 6: the MOOD main path; returns its launch counts and
    ms/step."""
    solver, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda",
                              method="mood")
    u = solver.post_stage(u0)
    multi = solver._multi_step(MOOD_STEPS)
    solver._multi_step(2)(u, 0.0, 1.0e3)            # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    syncs0 = solver.host_syncs
    t0 = time.perf_counter()
    u1, t1, n_done, bad, stats = multi(u, 0.0, 1.0e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    syncs = solver.host_syncs - syncs0
    n_done, bad = int(n_done), bool(bad)
    finite = bool(torch.isfinite(u1).all())
    print(f"MOOD main path: {n_done} steps to t={float(t1)!r} in {wall:.4f} "
          f"s, bad={bad}, finite={finite}, launches={counts}, "
          f"plain calls={plain_calls['n']}, cascade reads={syncs}")
    assert n_done == MOOD_STEPS and not bad and finite
    need = ("fused_residual", "fused_mood_candidate", "fused_modal_pos",
            "fused_pk_post", "fused_pk_post_with_diag", "fused_mood_check",
            "fused_diag")
    assert all(counts[k] > 0 for k in need), counts
    assert counts["fused_pk_post"] > counts["fused_pk_post_with_diag"]
    assert plain_calls["n"] == 0, "the MOOD path called a plain version"
    n_stages = MOOD_STEPS * len(solver.ark)
    per_step = {k: v / MOOD_STEPS for k, v in counts.items()}
    print(json.dumps({
        "dmr_q2_pk_mood_dof_updates_per_sec":
            4 * solver.basis.K * NX * NY * MOOD_STEPS / wall,
        "unit": "DoF-updates/s", "dtype": "float32", "grid": [NX, NY],
        "steps": MOOD_STEPS, "ms_per_step": 1e3 * wall / MOOD_STEPS,
        "mood_stats_per_step": {
            "n_reduce": int(stats.n_reduce) / MOOD_STEPS,
            "n_marked": int(stats.n_marked) / MOOD_STEPS,
            "passes": stats.iters / MOOD_STEPS},
        "cascade_passes_per_stage": stats.iters / n_stages,
        "host_syncs_per_step": syncs / MOOD_STEPS,
        "strips_per_step": (counts["fused_residual"]
                            + counts["fused_mood_candidate"]) / MOOD_STEPS,
        "launches_per_step": per_step, "card": card_line()}))
    return counts, 1e3 * wall / MOOD_STEPS


def device_busy(fn) -> dict | None:
    """fn() under torch.profiler (CUDA activity only): the host-clock wall,
    the device's busy time (the union of its kernels' and copies'
    intervals), the device events and the port's kernels among them, and
    the device time by kernel name.  None if the trace holds no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return None
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in evs):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict[str, float] = {}
    for e in evs:
        key = e.name.split("(")[0][:90]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    port = [e for e in evs if "dflo::" in e.name]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": 1e3 * wall, "busy_ms": 1e-3 * busy,
            "device_events": len(evs), "port_kernel_events": len(port),
            "diag_kernel_events": sum("fused_diag_kernel" in e.name
                                      for e in evs),
            "port_kernel_ms": 1e-3 * sum(e.time_range.elapsed_us()
                                         for e in port),
            "top_ms": {k: 1e-3 * v for k, v in top}}


def phase_trace(entry, ms_per_step, built):
    """Phase 8: each main path's chunk under torch.profiler (RK 5 steps and
    MOOD 3 steps at 1152 x 288, the forward step 3 steps on the CLI's
    solver at 1920 x 640, the sharded RK path 3 steps on the (2, 2) virtual
    mesh, the vortex 10 steps at 2048 x 2048, rayleigh_taylor 10 steps at
    1024 x 3072 and iso_xing_shu 10 steps at 2048 x 2048 on their CLI's
    solvers, the forward step on P2 under MOOD 3 steps on its CLI's solver,
    the DMR on P4 under MOOD 3 steps (phase 28's solver), the vortex on P4
    ENV_CHUNK steps at P4_N x P4_N (phase 26's solver), the curvilinear
    annulus ANN_CHUNK steps (phase 33's solver);
    built[method] = (solver, state) for all but the first two;
    f32, after a warm-up):
    device busy time, and the idle share of the traced wall and of the
    untraced ms/step of the main-path phase (ms_per_step[method]; tracing
    slows the host), device events and the port's kernels per step.  A
    measurement only: a trace without device events is reported as not
    measured."""
    out = {}
    for method, steps in (("rk", 5), ("mood", 3), ("fwd", 3), ("shard", 3),
                          ("vortex", VX_CHUNK), ("rt", SRC_CHUNK),
                          ("iso", SRC_CHUNK), ("fwd_mood", 3),
                          ("dmr_p4_mood", 3), ("vortex_p4", ENV_CHUNK),
                          ("annulus", ANN_CHUNK)):
        if method in built:
            s, u = built[method]
        else:
            s, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda",
                                 method=method)
            u = s.post_stage(u0)
        multi = s._multi_step(steps)
        multi(u, 0.0, 1.0e3)                       # warm-up
        r = device_busy(lambda: multi(u, 0.0, 1.0e3))
        if r is not None:
            r = {**r, "steps": steps,
                 "idle_share_traced": 1.0 - r["busy_ms"] / r["wall_ms"],
                 "idle_share": 1.0 - r["busy_ms"] / steps
                               / ms_per_step[method],
                 "wall_ms_per_step": r["wall_ms"] / steps,
                 "untraced_ms_per_step": ms_per_step[method],
                 "busy_ms_per_step": r["busy_ms"] / steps,
                 "port_kernel_ms_per_step": r["port_kernel_ms"] / steps,
                 "device_events_per_step": r["device_events"] / steps,
                 "port_kernel_events_per_step":
                     r["port_kernel_events"] / steps,
                 "diag_kernel_events_per_step":
                     r["diag_kernel_events"] / steps}
        print(f"{method} trace ({steps} steps): "
              f"{json.dumps(r) if r else 'no device events: not measured'}")
        out[method] = r
    # a diag call is one kernel and nothing after it: 20 calls on the P4
    # vortex (the mode-0 mean) and on iso_xing_shu (GLL2, the full row)
    # (a trace that drops an event is taken again, up to three times)
    from dflo_tpu_torch.ops import kernels
    for method in ("vortex_p4", "iso"):
        s, u = built[method]
        for _ in range(3):
            r = device_busy(lambda: [kernels.fused_diag(u, s._diag_ops)
                                     for _ in range(20)])
            if r is None or r["device_events"] == 20:
                break
        print(f"{method} diag, 20 calls: "
              f"{json.dumps(r) if r else 'no device events: not measured'}")
        if r is not None:
            assert r["device_events"] == r["diag_kernel_events"] == 20, r
        out[f"diag_calls_{method}"] = r
    return out


def phase_sparse_dense(entry, kernels, results):
    """Phase 7: the sparse cascade against the dense one and the kernels
    against the plain versions, f64, on the card."""
    from dflo_tpu_torch.stab.mood import make_mood
    runs = {}
    for label in ("sparse", "dense", "sparse_plain"):
        s, u0 = entry._build(SD_NX, SD_NY, dtype=torch.float64,
                             device="cuda", method="mood")
        if label == "dense":
            s._mood_stage = make_mood(s.basis, s.mesh, s.rhs,
                                      sparse_mode="off")
        u, t, out = s.post_stage(u0), 0.0, []
        kernels.reset_launch_counts()
        ctx = (plain_versions(kernels) if label == "sparse_plain"
               else contextlib.nullcontext())
        with ctx:
            for _ in range(SD_STEPS):
                u, dt, bad, st = s._step(u, t, 1.0)
                t += float(dt)
                assert not bool(bad)
                out.append((u, s.last_deg, s.last_lim,
                            (int(st.n_reduce), int(st.n_marked), st.iters)))
        torch.cuda.synchronize()
        runs[label] = (out, kernels.launch_counts())
    ref = runs["sparse"][0]
    worst, failures = 0.0, []
    for label in ("dense", "sparse_plain"):
        for k, (a, b) in enumerate(zip(ref, runs[label][0])):
            e = rel_err(b[0], a[0])
            worst = max(worst, e)
            cell = (b[0] - a[0]).abs().flatten(0, 1).amax(0)
            bad_cells = torch.nonzero(cell > SD_TOL * a[0].abs().max())
            maps = torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
            print(f"[f64 {SD_NX}x{SD_NY}] step {k}: sparse vs {label}: "
                  f"rel {e:.3e}, equal maps {maps}, stats {a[3]} / {b[3]}, "
                  f"cells over tol {bad_cells.tolist()[:8]}")
            if e > SD_TOL or not maps or a[3] != b[3]:
                failures.append((label, k, e))
    assert not failures, f"sparse against dense / plain: {failures}"
    fired = sum(r[3][0] for r in ref)
    dense_counts = runs["dense"][1]
    print(f"sparse vs dense: {fired} degree reductions in {SD_STEPS} steps; "
          f"the dense run launched fused_modal_pos "
          f"{dense_counts['fused_modal_pos']} times")
    assert fired > 0 and dense_counts["fused_modal_pos"] > 0
    results["sparse_vs_dense_f64"] = {"max_rel_err": worst,
                                      "degree_reductions": fired,
                                      "dense_modal_pos_launches":
                                          dense_counts["fused_modal_pos"]}


def virtual_mesh():
    """The (2, 2) mesh of four blocks on the one card."""
    from dflo_tpu_torch.parallel import device_mesh
    return device_mesh(SHARD, [torch.device("cuda")] * (SHARD[0] * SHARD[1]))


def phase_shard_kernels(entry, kernels, results, states):
    """Phase 12 for both dtypes, on phase 2's states; fills
    results["fused_post_block"] and results["fused_diag_sharded"]."""
    from dflo_tpu_torch.parallel import exchange_halos, reduce_max, reduce_min
    dm = virtual_mesh()
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        tol = TOL[dt]
        s, u_a, u_b, t = states[tag]
        sN, _ = entry._build(NX, NY, dtype=dt, device="cuda", device_mesh=dm)
        pops, dops = sN._blk_post_ops, sN._blk_diag_ops
        tt = torch.full((), t, dtype=dt, device="cuda")
        dtt = torch.full((), 1e-4, dtype=dt, device="cuda")
        sc = torch.stack([torch.full_like(dtt, 0.75), dtt])
        rb = results["fused_post_block"]
        rd = results["fused_diag_sharded"]
        for label, u in (("post_stage", u_a), ("10 steps", u_b)):
            blocks = sN.shard(u)
            halos = exchange_halos(blocks, dm, s._post_ops.per_x,
                                   s._post_ops.per_y)
            # the block form against its plain block form, launched block
            # by block, compared on the assembled state (its magnitudes
            # scale the errors: a block may hold a zero component)
            pk, pk0, pp = [], [], []
            for b, o, h in zip(blocks, pops, halos):
                pk.append(kernels.fused_post(b, o, True, halos=h))
                pk0.append(kernels.fused_post(b, o, halos=h))
                pp.append(kernels.fused_post_plain(b, o, True, halos=h))

            def whole(outs):
                return (sN.gather([x[0] for x in outs]),
                        reduce_max([x[1] for x in outs]),
                        reduce_min([x[2] for x in outs]))
            torch.cuda.synchronize()
            e, nflip, e_diag = check_post(results, "fused_post_block", tag,
                                          tol["fused_post"], whole(pk),
                                          sN.gather(pk0), whole(pp))
            assert e <= tol["fused_post"], f"block post {tag}: {e}"
            assert (nflip == 0 if dt == torch.float64
                    else nflip <= MAX_FLIP_FRACTION * NX * NY)
            print(f"[{tag}] {label}: block post vs its plain block form: "
                  f"rel err {rb[f'max_rel_err_{tag}']:.3e}, flipped "
                  f"{rb[f'flipped_cells_{tag}']}, bitwise "
                  f"{rb[f'bitwise_{tag}']}")
            # the sharded post against the single-device post kernel
            outs, lam, mq = kernels.fused_post_sharded(blocks, pops, dm, True)
            p1 = kernels.fused_post(u, s._post_ops, with_diag=True)
            g = sN.gather(outs)
            torch.cuda.synchronize()
            same = (torch.equal(g, p1[0]) and torch.equal(lam, p1[1])
                    and torch.equal(mq, p1[2]))
            e_in, nflip = post_err(g, p1[0], tol["fused_post"])
            e_diag = max(rel_err(lam, p1[1]), rel_err(mq, p1[2]))
            rb[f"sharded_vs_single_bitwise_{tag}"] = (
                rb.get(f"sharded_vs_single_bitwise_{tag}", True) and same)
            rb[f"sharded_vs_single_rel_err_{tag}"] = max(
                rb.get(f"sharded_vs_single_rel_err_{tag}", 0.0), e_in,
                e_diag)
            rb[f"sharded_vs_single_flipped_{tag}"] = max(
                rb.get(f"sharded_vs_single_flipped_{tag}", 0), nflip)
            print(f"[{tag}] {label}: sharded post vs single-device post: "
                  f"bitwise {same}; rel err {max(e_in, e_diag):.3e} outside "
                  f"{nflip} flipped cells")
            assert max(e_in, e_diag) <= tol["fused_post"]
            assert nflip <= MAX_FLIP_FRACTION * NX * NY
            # the sharded diag: equal to the single-device diag
            dk = kernels.fused_diag_sharded(blocks, dops, dm)
            dp = kernels.fused_diag_sharded_plain(blocks, dops, dm)
            d1 = kernels.fused_diag(u, s._diag_ops)
            torch.cuda.synchronize()
            record(results, "fused_diag_sharded", tag, list(zip(dk, dp)))
            assert all(torch.equal(a, b) for a, b in zip(dk, d1)), \
                f"sharded diag {tag} differs from the single-device diag"
            assert rd[f"max_rel_err_{tag}"] <= tol["fused_diag"]
            # the sharded residual and stage against the single-device
            # kernel on the whole state
            e_r = rel_err(sN.gather(sN.rhs(blocks, tt)), s.rhs(u, tt))
            e_s = rel_err(
                sN.gather(sN.rhs.stage(blocks, sN.shard(u_a), tt, 0.75, dtt)),
                kernels.fused_residual(u, *s.rhs.strips(u, tt), s.rhs.ops,
                                       u_old=u_a, sc=sc))
            torch.cuda.synchronize()
            rb[f"sharded_residual_rel_err_{tag}"] = max(
                rb.get(f"sharded_residual_rel_err_{tag}", 0.0), e_r, e_s)
            print(f"[{tag}] {label}: sharded diag equal to single-device; "
                  f"sharded residual rel err {e_r:.3e}, stage {e_s:.3e} "
                  f"(tol {tol['fused_residual']:.0e})")
            assert max(e_r, e_s) <= tol["fused_residual"]

        # ---- times on the 10-step state ----------------------------------
        blocks = sN.shard(u_b)
        halos = exchange_halos(blocks, dm, s._post_ops.per_x,
                               s._post_ops.per_y)
        block_ms = [time_ms(lambda b=b, o=o, h=h: kernels.fused_post(
            b, o, True, halos=h)) for b, o, h in zip(blocks, pops, halos)]
        rb[f"block_ms_{tag}"] = block_ms
        rd[f"block_ms_{tag}"] = [time_ms(lambda b=b, o=o: kernels.fused_diag(
            b, o)) for b, o in zip(blocks, dops)]
        # ms: the four blocks' kernel time alone (the trace, else the sum
        # of the per-block event times); sharded_call_ms: the whole
        # function (halo exchange, launches, reduce, host gaps)
        for r, fn, kname in (
                (rb, lambda: kernels.fused_post_sharded(blocks, pops, dm,
                                                        True),
                 "post_kernel"),
                (rd, lambda: kernels.fused_diag_sharded(blocks, dops, dm),
                 "fused_diag_kernel")):
            r[f"sharded_call_ms_{tag}"] = time_ms(fn)
            k = kernel_ms(fn, kname, len(blocks))
            r[f"ms_{tag}"] = sum(r[f"block_ms_{tag}"]) if k is None else k
            r[f"ms_source_{tag}"] = ("block_events" if k is None
                                     else "trace")
        rb[f"plain_ms_{tag}"] = time_ms(
            lambda: kernels.fused_post_sharded_plain(blocks, pops, dm, True))
        rd[f"plain_ms_{tag}"] = time_ms(
            lambda: kernels.fused_diag_sharded_plain(blocks, dops, dm))
        rb[f"stage_ms_{tag}"] = time_ms(lambda: sN.rhs.stage(
            blocks, blocks, tt, 0.75, dtt))
        print(f"[{tag}] block post per block launch {block_ms} ms; sharded "
              f"post kernels {rb[f'ms_{tag}']:.4f} ms "
              f"({rb[f'ms_source_{tag}']}), whole call "
              f"{rb[f'sharded_call_ms_{tag}']:.4f} ms (plain "
              f"{rb[f'plain_ms_{tag}']:.4f}); sharded diag kernels "
              f"{rd[f'ms_{tag}']:.4f} ms ({rd[f'ms_source_{tag}']}), whole "
              f"call {rd[f'sharded_call_ms_{tag}']:.4f} ms (plain "
              f"{rd[f'plain_ms_{tag}']:.4f}); sharded stage (strips + 4 "
              f"residual launches) {rb[f'stage_ms_{tag}']:.4f} ms, at "
              f"{NX}x{NY} on {SHARD}")


def shard_vs_single(entry, dm, label):
    """SHARD_F64_STEPS f64 steps of the sharded solver on dm against the
    single-device solver on the card: (worst dt rel err, worst state rel
    err)."""
    s1, u0 = entry._build(NX, NY, dtype=torch.float64, device="cuda")
    sN, _ = entry._build(NX, NY, dtype=torch.float64, device="cuda",
                         device_mesh=dm)
    u = s1.post_stage(u0)
    b = sN.post_stage(sN.shard(u0))
    assert torch.equal(sN.gather(b).to(u.device), u)
    t, e_dt, e_u = 0.0, 0.0, 0.0
    for _ in range(SHARD_F64_STEPS):
        u, dt1, bad1, _ = s1._step(u, t, 1.0)
        b, dtN, badN, _ = sN._step(b, t, 1.0)
        t += float(dt1)
        assert not bool(bad1) and not bool(badN)
        e_dt = max(e_dt, abs(float(dtN) - float(dt1)) / float(dt1))
        e_u = max(e_u, rel_err(sN.gather(b).to(u.device), u))
    print(f"[f64] {label}: {SHARD_F64_STEPS} sharded steps vs one device: dt "
          f"rel err {e_dt:.3e} (tol 1e-14), state rel err {e_u:.3e} "
          f"(tol 1e-10)")
    assert e_dt <= 1e-14 and e_u <= 1e-10
    return e_dt, e_u


def phase_main_shard(entry, kernels, plain_calls, results):
    """Phase 13: the sharded RK main path on the (2, 2) virtual mesh, then
    the f64 1-vs-N check (and both over distinct cards when there are two or
    more); returns the launch counts, ms/step and (solver, blocks) for the
    trace."""
    from dflo_tpu_torch.parallel import compatible_shape, device_mesh

    def main_path(dm, label):
        solver, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda",
                                  device_mesh=dm)
        u = solver.post_stage(solver.shard(u0))
        multi = solver._multi_step(SHARD_STEPS)
        solver._multi_step(2)(u, 0.0, 1.0e3)            # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        t0 = time.perf_counter()
        u1, t1, n_done, bad, _ = multi(u, 0.0, 1.0e3)
        for d in {b.device for b in u1}:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        n_done, bad = int(n_done), bool(bad)
        finite = all(bool(torch.isfinite(b).all()) for b in u1)
        print(f"sharded main path ({label}): {n_done} steps to "
              f"t={float(t1)!r} in {wall:.4f} s, bad={bad}, finite={finite}, "
              f"launches={counts}, plain calls={plain_calls['n']}")
        assert n_done == SHARD_STEPS and not bad and finite
        assert all(counts[k] > 0 for k in ("fused_residual", "fused_post",
                                           "fused_post_block",
                                           "fused_diag_sharded")), counts
        assert counts["fused_post"] == counts["fused_post_block"]
        assert counts["fused_diag"] == 0
        assert plain_calls["n"] == 0, "the sharded path called a plain version"
        rate = 4 * solver.basis.K * NX * NY * SHARD_STEPS / wall
        print(json.dumps({"dmr_q2_rk_tvb_sharded_dof_updates_per_sec": rate,
                          "unit": "DoF-updates/s", "dtype": "float32",
                          "grid": [NX, NY], "mesh": list(dm.shape),
                          "devices": [str(d) for d in dm.flat],
                          "steps": SHARD_STEPS,
                          "ms_per_step": 1e3 * wall / SHARD_STEPS,
                          "launches_per_step": {k: v / SHARD_STEPS
                                                for k, v in counts.items()},
                          "card": card_line()}))
        return counts, 1e3 * wall / SHARD_STEPS, (solver, u)

    dm = virtual_mesh()
    counts, ms, traced = main_path(dm, f"{SHARD} virtual mesh on one card")
    results["shard_f64_vs_single"] = {
        "virtual": shard_vs_single(entry, dm, "virtual mesh")}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        n = 4 if n_cards >= 4 else 2
        dm_n = device_mesh(compatible_shape(n, NY, NX),
                           [torch.device("cuda", i) for i in range(n)])
        main_path(dm_n, f"{dm_n.shape} over {n} distinct cards")
        results["shard_f64_vs_single"]["distinct_cards"] = shard_vs_single(
            entry, dm_n, f"{n} distinct cards")
    else:
        print(f"distinct cards: not run ({n_cards} CUDA device visible; the "
              f"sharded path ran on the {SHARD} virtual mesh of one card)")
    return counts, ms, traced


def fold(results, name, tag, pairs, tol, bitwise: bool = False):
    """Record the (kernel, plain) pairs under results[name], print and
    check them (bitwise=True: each pair equal); returns the error."""
    e = record(results, name, tag, pairs)
    eq = all(torch.equal(k, q) for k, q in pairs)
    r = results[name]
    r[f"bitwise_{tag}"] = r.get(f"bitwise_{tag}", True) and eq
    print(f"[{tag}] {name} rel err {e:.3e} (tol {tol:.0e}); bitwise {eq}")
    assert e <= tol, f"{name} {tag} disagrees: {e}"
    assert eq or not bitwise, f"{name} {tag} is not bitwise"
    return e


def time_pair(results, name, tag, fk, fp, grid):
    """CUDA-event times of a kernel call (median of 20) and its plain
    version (median of 5: it repeats the kernel's arithmetic in many
    small torch kernels and is no yardstick of speed)."""
    ms_k, ms_p = time_ms(fk), time_ms(fp, reps=5, warm=1)
    results[name][f"ms_{tag}"] = ms_k
    results[name][f"plain_ms_{tag}"] = ms_p
    print(f"[{tag}] {name}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms at "
          f"{grid[0]}x{grid[1]}")


def phase_lxf_kernels(entry, kernels, results):
    """Phase 14 for both dtypes: the modal LxF residual's three forms and
    the Pk diag on the vortex at 2048 x 2048, the LxF candidate on the
    DMR, the periodic Q1 post at 2048 x 2048."""
    from dflo_tpu_torch.driver import Solver
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        tol = TOL[dt]
        # ---- the modal LxF residual and the Pk diag on the vortex's IC --
        _, s, u = prm_solver(VORTEX_PRM, dt, VX_N)
        assert (s.basis.family, s.flux, s.rhs.ops.flux) == ("Pk", "lxf", "lxf")
        assert s.limiter_cfg.type == "none" and s.post_kernel == "xla"
        ops, strips = s.rhs.ops, s.rhs.strips(u, s._scalar(0.0))
        h = torch.full((), 1e-4, dtype=dt, device="cuda")
        sc = torch.stack([torch.full_like(h, 0.75), h])
        u_old = torch.roll(u, 1, -1).contiguous()
        forms = ({}, {"dt": h}, {"u_old": u_old, "sc": sc})
        fold(results, "fused_residual_pk_lxf", tag,
             [(kernels.fused_residual(u, *strips, ops, **kw),
               kernels.fused_residual_plain(u, *strips, ops, **kw))
              for kw in forms], tol["fused_residual"])
        fold(results, "fused_diag_pk_vortex", tag,
             list(zip(kernels.fused_diag(u, s._diag_ops),
                      kernels.fused_diag_plain(u, s._diag_ops))),
             tol["fused_diag"])
        time_pair(results, "fused_residual_pk_lxf", tag,
                  lambda: kernels.fused_residual(u, *strips, ops, **forms[2]),
                  lambda: kernels.fused_residual_plain(u, *strips, ops,
                                                       **forms[2]),
                  (VX_N, VX_N))
        time_pair(results, "fused_diag_pk_vortex", tag,
                  lambda: kernels.fused_diag(u, s._diag_ops),
                  lambda: kernels.fused_diag_plain(u, s._diag_ops),
                  (VX_N, VX_N))
        del s, u, u_old, strips
        torch.cuda.empty_cache()

        # ---- the LxF candidate on the DMR run with LxF ------------------
        s0, u = entry._build(NX, NY, dtype=dt, device="cuda", method="mood")
        s = Solver(s0.basis, s0.mesh, s0.bcs, flux="lxf",
                   limiter=s0.limiter_cfg, cfl=s0.cfl, dtype=dt,
                   device="cuda", method="mood")
        u, t = s.post_stage(u), 0.0
        with plain_versions(kernels):
            for _ in range(MOOD_PLAIN_STEPS):
                u, dtt, bad, _ = s._step(u, t, 1.0)
                t += float(dtt)
                assert not bool(bad), f"{tag}: plain LxF MOOD steps: bad"
        tt = s._scalar(t)
        c1 = cascade_pass1(kernels, s, u, tt, dtt)
        results["fused_mood_candidate_lxf"][f"data_{tag}"] = c1["data"]
        print(f"[{tag}] LxF MOOD state after {MOOD_PLAIN_STEPS} plain steps: "
              f"t={t!r}; pass 1 reduces {int(c1['chg1'].sum())} cells, "
              f"candidate set {c1['data']}")
        assert int(c1["chg1"].sum()) > 0, "the LxF cascade does not fire"
        tp_strips = s.rhs.strips(u, tt, c1["deg1"])
        rops, mops = s.rhs.ops, s.rhs.modal_ops

        def cand(fn, cells):
            return fn(u, c1["u_c"].clone(), c1["deg1"], cells, *tp_strips,
                      rops, mops, dtt)

        fold(results, "fused_mood_candidate_lxf", tag,
             [(cand(kernels.fused_mood_candidate, c),
               cand(kernels.fused_mood_candidate_plain, c))
              for c in (c1["aff"], torch.ones_like(c1["aff"]))],
             tol["fused_mood_candidate"], bitwise=True)
        u_prev = c1["u_c"].clone()
        time_pair(results, "fused_mood_candidate_lxf", tag,
                  lambda: kernels.fused_mood_candidate(
                      u, u_prev, c1["deg1"], c1["aff"], *tp_strips, rops,
                      mops, dtt),
                  lambda: kernels.fused_mood_candidate_plain(
                      u, u_prev, c1["deg1"], c1["aff"], *tp_strips, rops,
                      mops, dtt), (NX, NY))
        del s, s0, u, c1, u_prev

        # ---- the Q1 post periodic on both axes --------------------------
        params, s, u0 = prm_solver(PBC_PRM, dt, VX_N)
        po = s._post_ops
        assert po.per_x and po.per_y and po.mark_all and not po.pos_lim
        u_a = s.post_stage(u0)
        u_b, t = u_a, 0.0
        for _ in range(10):
            u_b, dtt, bad = plain_step(s, u_b, t, params.final_time)
            t += float(dtt)
            assert not bool(bad), f"{tag}: plain pbc steps tripped bad"
        results["fused_post_pbc"][f"data_{tag}"] = {"marked": VX_N * VX_N}
        for label, v in (("post_stage", u_a), ("10 steps", u_b)):
            pk = kernels.fused_post(v, po, with_diag=True)
            pp = kernels.fused_post_plain(v, po, with_diag=True)
            pk0 = kernels.fused_post(v, po)
            torch.cuda.synchronize()
            e, nflip, e_diag = check_post(results, "fused_post_pbc", tag,
                                          tol["fused_post"], pk, pk0, pp)
            print(f"[{tag}] vortex_system_pbc {VX_N}x{VX_N}, {label}: "
                  f"fused_post_pbc rel err {e:.3e} outside {nflip} flipped "
                  f"cells (tol {tol['fused_post']:.0e}); bitwise "
                  f"{results['fused_post_pbc'][f'bitwise_{tag}']}; diag rel "
                  f"err {e_diag:.3e}")
            assert e <= tol["fused_post"], f"fused_post_pbc {tag}: {e}"
            assert nflip <= (0 if dt == torch.float64
                             else MAX_FLIP_FRACTION * VX_N * VX_N), nflip
        time_pair(results, "fused_post_pbc", tag,
                  lambda: kernels.fused_post(u_b, po, with_diag=True),
                  lambda: kernels.fused_post_plain(u_b, po, with_diag=True),
                  (VX_N, VX_N))
        del s, u0, u_a, u_b
        torch.cuda.empty_cache()


def phase_main_vortex(kernels, plain_calls):
    """Phase 15: the vortex main path at 2048 x 2048; returns its launch
    counts, ms/step and (solver, state) for the trace."""
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.physics import euler
    params, s, u0 = prm_solver(VORTEX_PRM, torch.float32, VX_N)
    u = s.post_stage(u0)
    assert torch.equal(u, u0), "limiter none without positivity: no post"
    t_end = params.final_time
    multi = s._multi_step(VX_CHUNK)
    multi(u, 0.0, t_end)                            # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    n, bad, t = 0, False, 0.0
    t0 = time.perf_counter()
    for _ in range(VX_STEPS // VX_CHUNK):
        u, t, nd, bad_c, _ = multi(u, t, t_end)
        n, bad = n + nd, bad | bad_c
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n, bad = int(n), bool(bad)
    finite = bool(torch.isfinite(u).all())
    err = ic.l2_error(s.basis, s.mesh, u, ic.IC_FUNCTIONS["isenvort"](),
                      float(t))
    print(f"vortex main path: {n} steps to t={float(t)!r} in {wall:.4f} s, "
          f"bad={bad}, finite={finite}, launches={counts}, plain calls="
          f"{plain_calls['n']}")
    assert n == VX_STEPS and not bad and finite
    assert counts["fused_residual[pk_lxf_stage]"] == 3 * VX_STEPS, counts
    assert counts["fused_diag"] > 0, counts
    assert plain_calls["n"] == 0, "the vortex path called a plain version"
    ms = 1e3 * wall / VX_STEPS
    print(json.dumps({
        "isenvort_p2_lxf_rk_dof_updates_per_sec":
            4 * s.basis.K * VX_N * VX_N * VX_STEPS / wall,
        "unit": "DoF-updates/s", "dtype": "float32", "grid": [VX_N, VX_N],
        "steps": VX_STEPS, "chunk": VX_CHUNK, "ms_per_step": ms,
        "t": float(t), "rho_l2_error_vs_ic": float(err[euler.RHO]),
        "launches_per_step": {k: v / VX_STEPS for k, v in counts.items()
                              if v}, "card": card_line()}))
    return counts, ms, (s, u)


def phase_configs(kernels, plain_calls):
    """Phase 16: the seven configs through cli.run at their shipped sizes;
    returns {config: launch counts}."""
    from dflo_tpu_torch import cli
    out = {}
    for name in CONFIG_FORMS:
        with tempfile.TemporaryDirectory() as d:
            kernels.reset_launch_counts()
            plain_calls["n"] = 0
            t0 = time.perf_counter()
            res = cli.run([f"examples/{name}.prm", "--max-steps",
                           str(CONFIG_STEPS), "--chunk", str(CONFIG_CHUNK),
                           "--output-dir", d])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            snaps = sorted(f for f in os.listdir(d) if f.endswith(".vtu"))
        finite = bool(torch.isfinite(res.u).all())
        used = {k: v for k, v in counts.items() if v}
        print(f"config {name}: {res.it} steps to t={res.t!r} in {wall:.2f} s "
              f"(with set-up and output), {res.solver.basis.family}"
              f"{res.solver.basis.degree} {res.solver.flux} "
              f"{res.solver.method}, finite={finite}, launches={used}, plain "
              f"calls={plain_calls['n']}, snapshots={snaps}")
        assert res.it == CONFIG_STEPS and finite
        assert res.u.dtype == torch.float32 and res.u.is_cuda
        assert plain_calls["n"] == 0, f"{name} called a plain version"
        assert all(counts[k] > 0 for k in CONFIG_FORMS[name]), (name, counts)
        assert snaps and snaps[0] == "solution-000.vtu", snaps
        out[name] = counts
    return out


def rt_pk(params):
    """rayleigh_taylor on the modal P2 basis (the P2 gravity form)."""
    params.basis, params.degree = "Pk", 2


def rt_force(params):
    """rayleigh_taylor with its gravity replaced by the external force of
    FORCE_EXPR (the force-plane form)."""
    from dflo_tpu_torch.config.expressions import compile_expression
    fx, fy = (compile_expression(e) for e in FORCE_EXPR)
    params.gravity = 0.0
    params.external_force = lambda x, y, t: (fx(x, y, t), fy(x, y, t))


def iso_variant(p: int, flux: str):
    def edit(params):
        params.degree, params.flux.flux = p, flux
    return edit


def check_forms(kernels, results, name, tag, tol, s, u, t, bitwise=False):
    """The fused residual of solver s on u at time t in its R, u + dt*R and
    SSP-stage forms against the plain version; returns (stage call, plain
    stage call, error)."""
    ops = s.rhs.ops
    strips, force = s.rhs.strips(u, t), s.rhs.force(t)
    h = torch.full((), 1e-4, dtype=u.dtype, device="cuda")
    sc = torch.stack([torch.full_like(h, 0.75), h])
    u_old = torch.roll(u, 1, -1).contiguous()
    forms = ({}, {"dt": h}, {"u_old": u_old, "sc": sc})
    e = fold(results, name, tag,
             [(kernels.fused_residual(u, *strips, ops, force=force, **kw),
               kernels.fused_residual_plain(u, *strips, ops, force=force,
                                            **kw))
              for kw in forms], tol, bitwise)
    return (lambda: kernels.fused_residual(u, *strips, ops, force=force,
                                           **forms[2]),
            lambda: kernels.fused_residual_plain(u, *strips, ops,
                                                 force=force, **forms[2]),
            e)


def time_without_source(kernels, results, name, tag, s, u, t):
    """The same SSP-stage launch with the operators of no source arm (the
    residual the arm is added to), timed into results[name]: what the arm
    costs."""
    base = kernels.residual_operators(s.basis, s.mesh, flux=s.flux,
                                      dtype=u.dtype, device="cuda")
    strips = s.rhs.strips(u, t)
    h = torch.full((), 1e-4, dtype=u.dtype, device="cuda")
    sc = torch.stack([torch.full_like(h, 0.75), h])
    u_old = torch.roll(u, 1, -1).contiguous()
    ms = time_ms(lambda: kernels.fused_residual(u, *strips, base,
                                                u_old=u_old, sc=sc))
    results[name][f"no_source_ms_{tag}"] = ms
    print(f"[{tag}] {name}: the same stage without the source arm {ms:.4f} "
          f"ms")


def phase_source_kernels(kernels, results):
    """Phase 17 for both dtypes, then the f64 well-balance oracle."""
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        tol = TOL[dt]["fused_residual"]
        # ---- the body force on rayleigh_taylor's box ---------------------
        for name, edit, arm in (("fused_residual_grav", None, "grav"),
                                ("fused_residual_pk_grav", rt_pk, "grav"),
                                ("fused_residual_force", rt_force, "force")):
            _, s, u0 = prm_solver(RT_PRM, dt, grid=(RT_NX, RT_NY), edit=edit)
            assert s.rhs.ops.source == arm and s.flux == "hllc", name
            u = s.post_stage(u0)
            tt = torch.full((), 0.37, dtype=dt, device="cuda")
            fk, fp, _ = check_forms(kernels, results, name, tag, tol, s, u,
                                    tt)
            time_pair(results, name, tag, fk, fp, (RT_NX, RT_NY))
            time_without_source(kernels, results, name, tag, s, u, tt)
            if name == "fused_residual_pk_grav":
                ops, strips = s.rhs.ops, s.rhs.strips(u, tt)
                r = results[name]
                r[f"ms_R_{tag}"] = time_ms(
                    lambda: kernels.fused_residual(u, *strips, ops))
                r[f"plain_ms_R_{tag}"] = time_ms(
                    lambda: kernels.fused_residual_plain(u, *strips, ops))
                print(f"[{tag}] {name} R form: kernel {r[f'ms_R_{tag}']:.4f}"
                      f" ms, plain {r[f'plain_ms_R_{tag}']:.4f} ms")
            del s, u, u0, fk, fp
            torch.cuda.empty_cache()
        # ---- isothermal well-balancing on GLL1-3, iso_xing_shu's box -----
        gen = torch.Generator(device="cuda").manual_seed(7)
        for p in (1, 2, 3):
            for flux in ("hllc", "lxf"):
                _, s, u0 = prm_solver(ISO_PRM, dt, ISO_N,
                                      edit=iso_variant(p, flux))
                assert s.rhs.ops.source == "wbiso" and s.flux == flux
                noise = torch.rand(u0.shape, generator=gen, device="cuda",
                                   dtype=dt)
                u = (u0 * (1.0 + 0.01 * (2.0 * noise - 1.0))).contiguous()
                del noise, u0
                tt = torch.full((), 0.0, dtype=dt, device="cuda")
                main = (p, flux) == (2, "hllc")
                name = "fused_residual_wbiso"
                if main:
                    fk, fp, _ = check_forms(kernels, results, name, tag, tol,
                                            s, u, tt)
                    time_pair(results, name, tag, fk, fp, (ISO_N, ISO_N))
                    time_without_source(kernels, results, name, tag, s, u, tt)
                    fold(results, "fused_diag_gll", tag,
                         list(zip(kernels.fused_diag(u, s._diag_ops),
                                  kernels.fused_diag_plain(u, s._diag_ops))),
                         TOL[dt]["fused_diag"])
                    time_pair(results, "fused_diag_gll", tag,
                              lambda: kernels.fused_diag(u, s._diag_ops),
                              lambda: kernels.fused_diag_plain(u,
                                                               s._diag_ops),
                              (ISO_N, ISO_N))
                else:
                    # the other degrees and the other flux: checked into the
                    # row's error and bitwise flag, timed under variants
                    fk, fp, e = check_forms(kernels, results, name, tag, tol,
                                            s, u, tt)
                    v = results[name].setdefault(f"variants_{tag}", {})
                    v[f"gll{p}_{flux}"] = {"ms": time_ms(fk),
                                           "plain_ms": time_ms(fp, reps=5,
                                                               warm=1),
                                           "max_rel_err": e}
                    print(f"[{tag}] {name} GLL{p} {flux}: kernel "
                          f"{v[f'gll{p}_{flux}']['ms']:.4f} ms, plain "
                          f"{v[f'gll{p}_{flux}']['plain_ms']:.4f} ms")
                del s, u, fk, fp
                torch.cuda.empty_cache()

    # ---- the well-balance oracle through the fused path, f64 ------------
    for flux in ("lxf", "hllc", "roe"):
        _, s, u0 = prm_solver(ISO_PRM, torch.float64, WB_N,
                              edit=iso_variant(2, flux))
        kernels.reset_launch_counts()
        u, t, n, bad, _ = s._multi_step(WB_STEPS)(s.post_stage(u0), 0.0, 1e9)
        counts = kernels.launch_counts()
        drift = float((u - u0).abs().max())
        print(f"well-balance oracle GLL2 {flux} {WB_N}x{WB_N} f64: "
              f"{int(n)} steps to t={float(t)!r}, drift {drift:.3e} (bound "
              f"{WB_DRIFT:.0e}), launches "
              f"{counts[f'fused_residual[gll_{flux}_wbiso_stage]']}")
        assert int(n) == WB_STEPS and not bool(bad)
        assert counts[f"fused_residual[gll_{flux}_wbiso_stage]"] \
            == len(s.ark) * WB_STEPS, counts
        assert drift < WB_DRIFT, drift
        results["well_balance_drift"][flux] = drift
        del s, u, u0
        torch.cuda.empty_cache()


def cut_prm(src: str, out: str, nx: int, ny: int) -> str:
    """A copy of the config src with nx, ny replaced, written to out."""
    import re
    text = open(src).read()
    text = re.sub(r"set nx = \d+", f"set nx = {nx}", text)
    text = re.sub(r"set ny = \d+", f"set ny = {ny}", text)
    with open(out, "w") as f:
        f.write(text)
    return out


def phase_main_source(kernels, plain_calls, name, metric, prm, grid, form):
    """Phase 18: a body-force main path through cli.run at full size, then
    its solver timed apart from output; returns launch counts, ms/step and
    (solver, state) for the trace."""
    from dflo_tpu_torch import cli
    nx, ny = grid
    with tempfile.TemporaryDirectory() as out:
        cut = cut_prm(prm, os.path.join(out, f"{name}.prm"), nx, ny)
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        t0 = time.perf_counter()
        res = cli.run([cut, "--max-steps", str(SRC_STEPS), "--chunk",
                       str(SRC_CHUNK), "--output-dir", out])
        torch.cuda.synchronize()
        wall_cli = time.perf_counter() - t0
        counts = kernels.launch_counts()
        snaps = sorted(f for f in os.listdir(out) if f.endswith(".vtu"))
        sizes = [os.path.getsize(os.path.join(out, f)) for f in snaps]
    finite = bool(torch.isfinite(res.u).all())
    used = {k: v for k, v in counts.items() if v}
    print(f"{name} CLI {nx}x{ny}: {res.it} steps to t={res.t!r} in "
          f"{wall_cli:.2f} s with set-up and output, finite={finite}, "
          f"launches={used}, plain calls={plain_calls['n']}, snapshots "
          f"{snaps} ({sizes} B)")
    assert res.it == SRC_STEPS and finite
    assert res.u.dtype == torch.float32 and res.u.is_cuda
    assert counts[form] == len(res.solver.ark) * SRC_STEPS, counts
    assert counts["fused_diag"] > 0, counts
    assert plain_calls["n"] == 0, f"{name} called a plain version"
    assert snaps and snaps[0] == "solution-000.vtu", snaps

    s = res.solver
    multi = s._multi_step(SRC_CHUNK)
    multi(res.u, res.t, 1e3)                       # warm-up
    torch.cuda.synchronize()
    u, t, n, bad = res.u, res.t, 0, False
    t0 = time.perf_counter()
    for _ in range(SRC_STEPS // SRC_CHUNK):
        u, t, nd, bad_c, _ = multi(u, t, 1e3)
        n, bad = n + nd, bad | bad_c
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, bad = int(n), bool(bad)
    assert n == SRC_STEPS and not bad and bool(torch.isfinite(u).all())
    ms = 1e3 * wall / SRC_STEPS
    print(json.dumps({metric: 4 * s.basis.K * nx * ny * SRC_STEPS / wall,
                      "unit": "DoF-updates/s", "dtype": "float32",
                      "grid": [nx, ny], "steps": SRC_STEPS,
                      "chunk": SRC_CHUNK, "ms_per_step": ms,
                      "cli_wall_s": wall_cli, "t": float(t),
                      "launches_per_step": {k: v / SRC_STEPS
                                            for k, v in used.items()},
                      "card": card_line()}))
    return counts, ms, (s, u)


def phase_variant_path(kernels, plain_calls, name, edit, form):
    """Phase 18's P2-gravity and force-plane runs: rayleigh_taylor's solver
    with edit at 1024 x 3072, VARIANT_STEPS steps of the chunked loop;
    returns the launch counts."""
    _, s, u0 = prm_solver(RT_PRM, torch.float32, grid=(RT_NX, RT_NY),
                          edit=edit)
    u = s.post_stage(u0)
    multi = s._multi_step(VARIANT_STEPS)
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    u, t, n, bad, _ = multi(u, 0.0, 1e3)
    counts = kernels.launch_counts()
    n, bad, finite = int(n), bool(bad), bool(torch.isfinite(u).all())
    print(f"{name} path {RT_NX}x{RT_NY}: {n} steps to t={float(t)!r}, "
          f"bad={bad}, finite={finite}, launches="
          f"{ {k: v for k, v in counts.items() if v} }, plain calls="
          f"{plain_calls['n']}")
    assert n == VARIANT_STEPS and not bad and finite
    assert counts[form] == len(s.ark) * VARIANT_STEPS, counts
    assert plain_calls["n"] == 0, f"{name} called a plain version"
    return counts


# ---------------------------------------------------------------------------
# phases 19-22: the Roe, Steger-Warming, KFVS and KEP forms of the residual
# and the implicit path
# ---------------------------------------------------------------------------

def bump_fn(x, y, t=0.0):
    """Free stream (0.5, 0, 1, 2.6) with a Gaussian bump
    (tests/test_implicit.py:83-110)."""
    b = 0.05 * torch.exp(-50.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
    return torch.stack([0.5 + b, b, 1.0 + b, torch.full_like(x, 2.6)])


def bump_bcs():
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.solver.spatial import BoundarySide

    def far(x, y, t):
        return torch.stack([torch.full_like(x, v) for v in BUMP_FAR])
    return dict(W=BoundarySide(euler.BC_FARFIELD, far),
                E=BoundarySide(euler.BC_FARFIELD, far),
                S=BoundarySide(euler.BC_SLIP), N=BoundarySide(euler.BC_SLIP))


def perturbed(u, seed: int):
    """u times (1 + 0.02 U(-1, 1)), the noise from a seeded generator on
    the card: every face carries a jump."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.rand(u.shape, generator=g, dtype=u.dtype, device="cuda")
    return (u * (1.0 + 0.02 * (2.0 * noise - 1.0))).contiguous()


class RhsOnly:
    """A solver-like holder of a fused rhs, for check_forms."""

    def __init__(self, rhs):
        self.rhs = rhs


def flux_case(family, p, flux, dtype, masked, seed):
    """(holder of the fused rhs, state) of one new-flux case at FLUX_N x
    FLUX_N: the bump on the unit square, or the forward step's masked
    geometry (examples/forward_step_tpu.prm's mask and BCs) on its inflow
    state, each perturbed by 2 %."""
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.solver.spatial import make_rhs
    if masked:
        _, s, u0 = prm_solver(FS_PRM, dtype, grid=(FLUX_N, FLUX_N),
                              edit=lambda q: setattr(q.flux, "flux", flux))
        return s, s.apply_mask(perturbed(u0, seed))
    basis = make_basis(family, p)
    mesh = CartesianMesh(FLUX_N, FLUX_N, 0.0, 1.0, 0.0, 1.0)
    u = ic.set_initial_condition(basis, mesh, bump_fn, dtype=dtype,
                                 device="cuda")
    rhs = make_rhs(basis, mesh, bump_bcs(), flux=flux, dtype=dtype,
                   device="cuda", volume_kernel="fused")
    return RhsOnly(rhs), perturbed(u, seed)


def ptxas_table(log: str, sources=None,
                kernel: str = "fused_residual_kernel") -> dict:
    """{source: [(dtype, basis, p, registers, spill bytes)]} of one kernel
    template's instantiations (the residual kernel's, or the candidate
    kernel's, always modal) in `sources` (default: the new flux sources),
    from the build's ptxas lines."""
    import re
    if sources is None:
        sources = {f"fused_residual_{f}.cu" for f in FLUX_NEW}
    # the tile kernel (csrc/residual.cuh) on the fixed dims, no source arm:
    # the residual (TP false) or the candidate (TP true, modal)
    tp = "0" if kernel == "fused_residual_kernel" else "1"
    pat = (r"tile_residual_kernel(?:_wide)?I([fd])NS_5BDimsILi(\d)ELb([01])EEELi\d+"
           r"ELi0ELb" + tp + "E")
    out, src, fn, spill = {}, None, "", 0
    for line in log.splitlines():
        if line.startswith("== "):
            src = line.split()[1]
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        k = re.search(pat, fn)
        if m and k and src in sources:
            out.setdefault(src, []).append(
                ("f32" if k.group(1) == "f" else "f64",
                 "Qk" if k.group(3) == "0" else "Pk", int(k.group(2)),
                 int(m.group(1)), spill))
    return out


def ptxas_tiles(log: str) -> list:
    """[(source, dtype, dims, flux, source arm, candidate, registers, stack
    bytes, spill bytes)] of every instantiation of the residual's and the
    candidate's tile kernel (csrc/residual.cuh tile_residual_kernel, in
    float64 tile_residual_kernel_wide), from
    the build's ptxas lines; dims "P<p>" / "Q<p>" for the fixed dims (modal
    / collocated), "G-contract" / "G-collocated" for the general ones."""
    import re
    out, src, fn, stack, spill = [], None, "", 0, 0
    pat = (r"tile_residual_kernel(?:_wide)?I([fd])NS_5(?:BDimsILi(\d)ELb([01])|"
           r"GDimsILb([01]))EEELi(\d)ELi(n?\d)ELb([01])E")
    for line in log.splitlines():
        if line.startswith("== "):
            src = line.split()[1]
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        k = re.search(pat, fn)
        if m and k:
            dims = (f"{'P' if k.group(3) == '1' else 'Q'}{k.group(2)}"
                    if k.group(2) else
                    f"G-{'contract' if k.group(4) == '1' else 'collocated'}")
            out.append((src, "f32" if k.group(1) == "f" else "f64", dims,
                        ALL_FLUXES[int(k.group(5))],
                        int(k.group(6).replace("n", "-")), k.group(7) == "1",
                        int(m.group(1)), stack, spill))
    return out


def ptxas_post_tiles(log: str) -> list:
    """[(kernel, dtype, dims, registers, stack bytes, spill bytes)] of every
    instantiation of the post's and the modal positivity's tile kernels
    (csrc/fused_post.cu tile_post_kernel, csrc/fused_modal_pos.cu
    tile_modal_pos_kernel; in float64 their _wide entries) and of the
    post's per-cell kernel (cell_post_kernel, "fused_post_cell"), from the
    build's ptxas lines; dims "Q<p>" / "P<p>" for the fixed dims, "G" for
    the general ones."""
    import re
    out, fn, stack, spill = [], "", 0, 0
    pat = (r"(tile_post|tile_modal_pos|cell_post)_kernel(?:_wide)?I([fd])"
           r"NS_5(?:BDimsILi(\d)ELb[01]|GDimsILb[01])E")
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        k = re.search(pat, fn)
        if m and k:
            kind = {"tile_post": "fused_post", "cell_post": "fused_post_cell",
                    "tile_modal_pos": "fused_modal_pos"}[k.group(1)]
            dims = ("G" if k.group(3) is None else
                    f"{'P' if kind == 'fused_modal_pos' else 'Q'}{k.group(3)}")
            out.append((kind, "f32" if k.group(2) == "f" else "f64", dims,
                        int(m.group(1)), stack, spill))
    return out


def post_tile_report(kernels, log) -> dict:
    """Phase 1, the post's and the modal positivity's tile kernels: each
    instantiation's registers, stack and spill (ptxas), and each degree's
    tile and dynamic shared memory per block (csrc dflo_post_smem,
    dflo_modal_pos_smem), which must equal ops/kernels.post_smem; the
    per-cell kernels' block (dflo_block_dims), which must equal
    ops/kernels.BLOCK."""
    from dflo_tpu_torch.stab.positivity import _pos_points
    rows = ptxas_post_tiles(log)
    assert rows, "no post tile kernel in the build's ptxas lines"
    print("ptxas tile_post_kernel / cell_post_kernel / tile_modal_pos_kernel"
          "(_wide): " + ", ".join(
        f"{k[len('fused_'):]} {d} {dims} {r} regs {st} B stack {sp} B spill"
        for k, d, dims, r, st, sp in rows))
    lib = kernels._load()
    # the per-cell kernels' thread block, whose diag partials Python sizes
    block = (lib.dflo_block_dims(0), lib.dflo_block_dims(1))
    assert block == kernels.BLOCK, (block, kernels.BLOCK)
    smem = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        code = int(dtype == torch.float64)
        for p in range(1, 7):
            for modal in (False, True):
                tile = kernels.post_tile(p, modal, dtype)
                if modal:
                    K = (p + 1) * (p + 2) // 2
                    qp = len(_pos_points(p))
                    forms = {"": lib.dflo_modal_pos_smem(code, K, qp, *tile)}
                    want = {"": kernels.post_smem(p, True, dtype, tile)}
                else:
                    forms = {f"{'m' if m else ''}{'' if z else 'n'}":
                             lib.dflo_post_smem(code, p, m, z, *tile)
                             for m in (0, 1) for z in (0, 1)}
                    want = {f"{'m' if m else ''}{'' if z else 'n'}":
                            kernels.post_smem(p, False, dtype, tile, bool(m),
                                              bool(z))
                            for m in (0, 1) for z in (0, 1)}
                assert forms == want, (tag, p, modal, forms, want)
                smem[f"{'P' if modal else 'Q'}{p} {tag}"] = {
                    "tile": list(tile), "smem_bytes": forms[""] if modal
                    else forms["m"]}
    print("post / modal positivity tile shared memory per block (masked "
          "post): " + "; ".join(
              f"{k} {v['tile'][0]}x{v['tile'][1]} {v['smem_bytes']} B"
              for k, v in smem.items()))
    big = [r for r in rows if r[4] > 16 or (r[1] == "f64" and r[4] > 0)]
    print(f"post and modal positivity kernels: {len(rows)} instantiations, "
          f"{min(r[3] for r in rows)}-{max(r[3] for r in rows)} registers, "
          f"stack above 16 B (or any in f64): {big or 'none'}")
    return {"instantiations": [list(r) for r in rows],
            "smem_per_block": smem, "stack_over_bound": [list(r) for r in big]}


#: the tile kernel's main forms whose shared memory per block phase 1
#: prints: (label, family, p, nq, flux, source arm code, masked, candidate)
TILE_FORMS = (("Q2 hllc stage (DMR)", "Qk", 2, None, "hllc", 0, 0, 0),
              ("P2 hllc u+dt*R / candidate (MOOD)", "Pk", 2, None, "hllc",
               0, 0, 1),
              ("P2 lxf stage (vortex)", "Pk", 2, None, "lxf", 0, 0, 0),
              ("P4 lxf stage (vortex)", "Pk", 4, None, "lxf", 0, 0, 0),
              ("P4 hllc candidate (MOOD)", "Pk", 4, None, "hllc", 0, 0, 1),
              ("P6 lxf stage (vortex)", "Pk", 6, None, "lxf", 0, 0, 0),
              ("Q4 hllc stage (DMR)", "Qk", 4, None, "hllc", 0, 0, 0),
              ("Q2 on 4x4 lxf stage", "Qk", 2, 4, "lxf", 0, 0, 0),
              ("GLL2 roe isothermal", "Qk_gll", 2, None, "roe", 3, 0, 0),
              ("Q1 lxf masked (fwd)", "Qk", 1, None, "lxf", 0, 1, 0),
              ("Q6 kep", "Qk", 6, None, "kep", 0, 0, 0))


def phase_tile_report(kernels, log, results):
    """Phase 1, the tile kernels: each instantiation's registers, stack and
    spill (ptxas), and the dynamic shared memory per block and the tile of
    the main forms (csrc/fused_residual.cu dflo_tile_smem)."""
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.stab.positivity import _pos_points
    rows = ptxas_tiles(log)
    assert rows, "no tile kernel in the build's ptxas lines"
    local = [r for r in rows if r[7] or r[8]]
    regs = [r[6] for r in rows]
    print(f"ptxas tile_residual_kernel(_wide): {len(rows)} instantiations, "
          f"{min(regs)}-{max(regs)} registers, {len(local)} with a stack "
          f"frame or spills")
    for src in sorted({r[0] for r in rows}):
        print(f"  {src}: " + ", ".join(
            f"{d} {dims} {fl}{'' if a == 0 else f' src{a}'}"
            f"{' TP' if tp else ''} {rg} regs {st} B stack {sp} B spill"
            for _, d, dims, fl, a, tp, rg, st, sp in
            (r for r in rows if r[0] == src)))
    lib = kernels._load()
    smem = {}
    for label, fam, p, nq, flux, arm, masked, tp in TILE_FORMS:
        b = make_basis(fam, p, nq)
        qp = len(_pos_points(p)) if fam == "Pk" else 0
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            tile = kernels.residual_tile(b.K, dtype)
            n = lib.dflo_tile_smem(int(dtype == torch.float64),
                                   int(not b.is_nodal_collocated), b.K, b.nq,
                                   qp, ALL_FLUXES.index(flux), arm, masked,
                                   tp, *tile)
            assert n > 0, (label, tag)
            smem[f"{label} {tag}"] = {"tile": list(tile), "smem_bytes": n}
    print("tile shared memory per block: " + "; ".join(
        f"{k} {v['tile'][0]}x{v['tile'][1]} {v['smem_bytes']} B"
        for k, v in smem.items()))
    results["tile_kernels"] = {
        "instantiations": len(rows), "registers": [min(regs), max(regs)],
        "with_stack_or_spill": [list(r) for r in local],
        "smem_per_block": smem,
        "post_and_modal_pos": post_tile_report(kernels, log),
        "pk_post_and_check": pk_check_report(kernels, log),
        "diag_and_volume": diag_volume_report(kernels, log)}


def pk_check_report(kernels, log) -> dict:
    """Phase 1, the Pk post's and the check's kernels (rows 9 and 10): each
    instantiation's registers, stack and spill (ptxas; no tile kernel's
    may have a stack frame or spill), and the tile and dynamic shared memory per block
    of the Pk post at every degree and of the check in each dtype (csrc
    dflo_pk_post_smem, dflo_mood_check_smem), which must equal
    ops/kernels.pk_post_smem and check_smem."""
    import re
    from dflo_tpu_torch.stab.positivity import _pos_points
    rows, fn, stack, spill = [], "", 0, 0
    pat = (r"(tile_pk_post|cell_pk_post|tile_check|cell_check)_kernel"
           r"(?:_wide)?I([fd])"
           r"(?:NS_5(?:BDimsILi(\d)ELb1|GDimsILb1)E)?")
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        k = re.search(pat, fn)
        if m and k:
            kind = {"tile_pk_post": "pk_post", "cell_pk_post": "pk_post_cell",
                    "tile_check": "mood_check",
                    "cell_check": "mood_check_cell"}[k.group(1)]
            dims = ("" if kind.startswith("mood_check") else
                    "G" if k.group(3) is None else f"P{k.group(3)}")
            rows.append((kind, "f32" if k.group(2) == "f" else "f64", dims,
                         int(m.group(1)), stack, spill))
    assert {r[0] for r in rows} >= {"pk_post", "mood_check"}, rows
    print("ptxas tile_pk_post_kernel(_wide) / cell_pk_post_kernel / "
          "tile_check_kernel / cell_check_kernel: " + ", ".join(
              f"{k} {d} {dims} {r} regs {st} B stack {sp} B spill"
              for k, d, dims, r, st, sp in rows))
    # the tile kernels hold no cell's arrays; the per-cell Pk post at
    # float32 P3 and float64 P2 keeps PR 13's stack frame (faster there)
    local = [r for r in rows if (r[4] or r[5]) and not r[0].endswith("_cell")]
    assert not local, f"rows 9 and 10 with a stack frame or spills: {local}"
    lib = kernels._load()
    smem = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        code = int(dtype == torch.float64)
        for p in range(1, 7):
            tile = kernels.pk_post_tile(p, dtype)
            n = lib.dflo_pk_post_smem(code, p, (p + 1) * (p + 2) // 2,
                                      len(_pos_points(p)), *tile)
            assert n == kernels.pk_post_smem(p, dtype, tile), (tag, p, n)
            smem[f"pk_post P{p} {tag}"] = {"tile": list(tile),
                                           "smem_bytes": n}
        n = lib.dflo_mood_check_smem(code)
        assert n == kernels.check_smem(dtype), (tag, n)
        smem[f"check {tag}"] = {"tile": list(kernels.check_tile(dtype)),
                                "smem_bytes": n}
    print("Pk post / check tile shared memory per block (0: the per-cell "
          "kernel): " + "; ".join(
              f"{k} {v['tile'][0]}x{v['tile'][1]} {v['smem_bytes']} B"
              for k, v in smem.items()))
    return {"instantiations": [list(r) for r in rows],
            "smem_per_block": smem}


def diag_volume_report(kernels, log) -> dict:
    """Phase 1, the diag's and the volume residual's kernels (rows 6 and 1):
    each instantiation's registers, stack and spill (ptxas; none may have
    a stack frame or spill), and the volume residual's tile and dynamic
    shared memory per block at every degree and dtype (csrc
    dflo_volume_smem, 0 for the per-cell kernel), which must equal
    ops/kernels.volume_smem."""
    import re
    rows, fn, stack, spill = [], "", 0, 0
    pat = (r"(fused_diag|cell_volume|tile_volume)_kernelI([fd])Li(\d+)"
           r"E(?:L[ib](\d+)E)?")
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        k = re.search(pat, fn)
        if m and k:
            kind, n, w = k.group(1), int(k.group(3)), k.group(4)
            form = {"fused_diag": f"{'mode0' if n == 0 else f'K{n}'}"
                                  f"{' vec' if w == '1' else ''}",
                    "cell_volume": f"K{n}",
                    "tile_volume": f"Q{n} x{w}"}[kind]
            rows.append((kind, "f32" if k.group(2) == "f" else "f64", form,
                         int(m.group(1)), stack, spill))
    assert {r[0] for r in rows} >= {"fused_diag", "tile_volume"}, rows
    print("ptxas fused_diag_kernel / cell_volume_kernel / "
          "tile_volume_kernel: " + ", ".join(
              f"{k} {d} {f} {r} regs {st} B stack {sp} B spill"
              for k, d, f, r, st, sp in rows))
    local = [r for r in rows if r[4] or r[5]]
    assert not local, f"rows 1 and 6 with a stack frame or spills: {local}"
    lib = kernels._load()
    smem = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        code = int(dtype == torch.float64)
        for p in range(1, 7):
            K = (p + 1) ** 2
            n = lib.dflo_volume_smem(code, K)
            assert n == kernels.volume_smem(p, dtype), (tag, p, n)
            assert n <= kernels.MAX_SMEM, (tag, p, n)
            smem[f"volume Q{p} {tag}"] = {
                "tile_x": kernels.volume_tile(K, dtype), "smem_bytes": n}
    print("volume residual tile (cells along x, 0: the per-cell kernel) and "
          "shared memory per block: " + "; ".join(
              f"{k} {v['tile_x']} {v['smem_bytes']} B"
              for k, v in smem.items()))
    return {"instantiations": [list(r) for r in rows],
            "volume_smem_per_block": smem}


def phase_flux_kernels(kernels, results, log):
    """Phase 19: each new flux's residual forms against their plain
    versions at 1024 x 1024, f32 and f64, and its times."""
    regs = ptxas_table(log)
    for src, rows in sorted(regs.items()):
        print(f"ptxas {src}: " + ", ".join(
            f"{d} {b}{p} {r} regs {sp} B spilled" for d, b, p, r, sp in rows))
    results["flux_registers"] = regs
    cases = [(f, p, False) for f, p in FLUX_CASES] + [("Qk", 1, True)]
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        for flux in FLUX_NEW:
            name = f"fused_residual_{flux}"
            for ci, (family, p, masked) in enumerate(cases):
                s, u = flux_case(family, p, flux, dtype, masked, seed=ci)
                label = f"{family}{p}{' masked' if masked else ''}"
                fk, fp, e = check_forms(kernels, results, name, tag,
                                        TOL[dtype]["fused_residual"], s, u,
                                        0.25, bitwise=flux in ("roe", "sw"))
                r = results[name]
                r.setdefault(f"cases_{tag}", {})[label] = e
                if (family, p, masked) == ("Qk", 1, False):
                    # the stage form (RK) and the R form (the implicit
                    # primal) on the main paths' basis
                    time_pair(results, name, tag, fk, fp, (FLUX_N, FLUX_N))
                    strips = s.rhs.strips(u, 0.25)
                    ops = s.rhs.ops
                    r[f"stage_ms_{tag}"] = r[f"ms_{tag}"]
                    r[f"plain_stage_ms_{tag}"] = r[f"plain_ms_{tag}"]
                    r[f"ms_R_{tag}"] = time_ms(
                        lambda: kernels.fused_residual(u, *strips, ops))
                    r[f"plain_ms_R_{tag}"] = time_ms(
                        lambda: kernels.fused_residual_plain(u, *strips,
                                                             ops))
                    print(f"[{tag}] {name} R form: kernel "
                          f"{r[f'ms_R_{tag}']:.4f} ms, plain "
                          f"{r[f'plain_ms_R_{tag}']:.4f} ms")
                    if flux == "roe":
                        # the roe row is the implicit primal: its R form
                        r[f"ms_{tag}"] = r[f"ms_R_{tag}"]
                        r[f"plain_ms_{tag}"] = r[f"plain_ms_R_{tag}"]
                del s, u
            torch.cuda.empty_cache()
    # roe's stage form on P2 at 2048 x 2048 (the vortex's size)
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.solver.spatial import make_rhs
    basis = make_basis("Pk", 2)
    mesh = CartesianMesh(VX_N, VX_N, 0.0, 1.0, 0.0, 1.0)
    u = perturbed(ic.set_initial_condition(basis, mesh, bump_fn,
                                           dtype=torch.float32,
                                           device="cuda"), 7)
    rhs = make_rhs(basis, mesh, bump_bcs(), flux="roe", dtype=torch.float32,
                   device="cuda", volume_kernel="fused")
    strips = rhs.strips(u, 0.25)
    h = torch.full((), 1e-4, dtype=torch.float32, device="cuda")
    sc = torch.stack([torch.full_like(h, 0.75), h])
    u_old = torch.roll(u, 1, -1).contiguous()
    ms = time_ms(lambda: kernels.fused_residual(u, *strips, rhs.ops,
                                                u_old=u_old, sc=sc))
    b_ms, b_by = bound("fused_residual_roe_stage", basis, torch.float32,
                       VX_N * VX_N)
    results["fused_residual_roe"]["stage_ms_p2_2048"] = ms
    results["fused_residual_roe"]["stage_bound_ms_p2_2048"] = b_ms
    print(f"[f32] fused_residual_roe stage P2 {VX_N}x{VX_N}: {ms:.4f} ms "
          f"(bound {b_ms:.4f} ms by {b_by})")
    # the diag on the implicit vortex's Q1 state (its dt, its `bad`)
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        s, u = impl_solver(FLUX_N, dtype)
        fold(results, "fused_diag_impl", tag,
             list(zip(kernels.fused_diag(u, s._diag_ops),
                      kernels.fused_diag_plain(u, s._diag_ops))),
             TOL[dtype]["fused_diag"])
        time_pair(results, "fused_diag_impl", tag,
                  lambda: kernels.fused_diag(u, s._diag_ops),
                  lambda: kernels.fused_diag_plain(u, s._diag_ops),
                  (FLUX_N, FLUX_N))
        del s, u
    for flux in FLUX_NEW:
        r = results[f"fused_residual_{flux}"]
        print(f"{flux}: bitwise f32 {r['bitwise_f32']}, f64 "
              f"{r['bitwise_f64']}; max rel err f32 "
              f"{r['max_rel_err_f32']:.3e}, f64 {r['max_rel_err_f64']:.3e}")


def phase_flux_paths(kernels, plain_calls):
    """The RK path of each new flux: the periodic isentropic vortex on Q1
    at FLUX_N x FLUX_N (the reference's 10 x 10 box), limiter none, rk2,
    FLUX_STEPS steps of the chunked loop in f32; returns {flux: launch
    counts}."""
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.driver import Solver
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.solver.spatial import BoundarySide
    per = BoundarySide(euler.BC_PERIODIC)
    basis = make_basis("Qk", 1)
    mesh = CartesianMesh(FLUX_N, FLUX_N, -5.0, 5.0, -5.0, 5.0)
    out = {}
    for flux in FLUX_NEW:
        s = Solver(basis, mesh, dict(W=per, E=per, S=per, N=per), flux=flux,
                   cfl=0.5, dtype=torch.float32, device="cuda")
        u = ic.set_initial_condition(basis, mesh, ic.isentropic_vortex(),
                                     dtype=torch.float32, device="cuda")
        multi = s._multi_step(FLUX_STEPS)
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        u, t, n, bad, _ = multi(u, 0.0, 1e3)
        counts = kernels.launch_counts()
        n, bad, finite = int(n), bool(bad), bool(torch.isfinite(u).all())
        print(f"{flux} RK path Q1 {FLUX_N}x{FLUX_N}: {n} steps to "
              f"t={float(t)!r}, bad={bad}, finite={finite}, launches="
              f"{ {k: v for k, v in counts.items() if v} }, plain calls="
              f"{plain_calls['n']}")
        assert n == FLUX_STEPS and not bad and finite
        assert counts.get(f"fused_residual[qk_{flux}_stage]", 0) == 2 * FLUX_STEPS
        assert plain_calls["n"] == 0, f"the {flux} path called a plain version"
        out[flux] = counts
    return out


def impl_solver(n, dtype, **kw):
    """The implicit vortex: Q1, roe, limiter none, the periodic isentropic
    vortex on the reference's 10 x 10 box at n x n, theta 1, cfl 5, two
    Newton iterations to 1e-4, block-Jacobi (tests/test_implicit.py:30)."""
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.driver import Solver
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.solver.spatial import BoundarySide
    per = BoundarySide(euler.BC_PERIODIC)
    basis = make_basis("Qk", 1)
    mesh = CartesianMesh(n, n, -5.0, 5.0, -5.0, 5.0)
    args = dict(flux="roe", cfl=5.0, method="implicit", theta=1.0,
                max_nonlin_iter=2, linear_residual=1e-4,
                precondition="block_jacobi")
    args.update(kw)
    s = Solver(basis, mesh, dict(W=per, E=per, S=per, N=per), dtype=dtype,
               device="cuda", **args)
    return s, ic.set_initial_condition(basis, mesh, ic.isentropic_vortex(),
                                       dtype=dtype, device="cuda")


def phase_main_implicit(kernels, plain_calls):
    """Phase 20: the implicit vortex at IMPL_N x IMPL_N (IMPL_FALLBACK_N if
    one step takes over 10 s), f32: a warm-up step, IMPL_STEPS steps in one
    chunk, then one step under torch.profiler (the device's busy share,
    the kernel's time against the rest: the tangents and GMRES); returns
    (launch counts, ms/step, the summary dict)."""
    n = IMPL_N
    s, u = impl_solver(n, torch.float32)
    t0 = time.perf_counter()
    u1, _, bad, _, _ = s._step(u, 0.0, 1e3, pred=u)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if first_s > 10.0:
        print(f"implicit vortex {n}x{n}: the first step took {first_s:.1f} s"
              f" (> 10 s); the phase runs at {IMPL_FALLBACK_N} x "
              f"{IMPL_FALLBACK_N}")
        n = IMPL_FALLBACK_N
        del s, u, u1
        torch.cuda.empty_cache()
        s, u = impl_solver(n, torch.float32)
        s._step(u, 0.0, 1e3, pred=u)
    multi = s._multi_step(IMPL_STEPS)
    counts_k = s.krylov_counts
    counts_k.reset()
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, t, nd, bad, info = multi(u, 0.0, 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    kc = counts_k.as_dict()
    nd, bad = int(nd), bool(bad)
    finite = bool(torch.isfinite(u).all())
    plain = plain_calls["n"]
    ms = 1e3 * wall / IMPL_STEPS
    one = s._multi_step(1)
    trace = device_busy(lambda: one(u, t, 1e3))
    per = {k: v / IMPL_STEPS for k, v in kc.items()}
    out = {"isenvort_q1_roe_implicit_dof_updates_per_sec":
               4 * s.basis.K * n * n * IMPL_STEPS / wall,
           "unit": "DoF-updates/s", "dtype": "float32", "grid": [n, n],
           "first_step_s": first_s, "steps": IMPL_STEPS,
           "ms_per_step": ms, "t": float(t), "diverged": bool(info.diverged),
           "lin_res_last": float(info.lin_res),
           "newton_per_step": per["newton"],
           "gmres_restarts_per_step": per["restarts"],
           "tangents_per_step": per["tangents"],
           "primals_per_step": per["primals"],
           "host_reads_per_step": per["host_reads"],
           "roe_R_launches_per_step":
               counts.get("fused_residual[qk_roe_R]", 0) / IMPL_STEPS,
           "diag_launches_per_step": counts["fused_diag"] / IMPL_STEPS,
           "plain_twin_calls": plain, "card": card_line()}
    if trace is not None:
        busy = trace["busy_ms"]
        out.update({"traced_step_wall_ms": trace["wall_ms"],
                    "traced_busy_ms": busy,
                    "traced_idle_share": 1.0 - busy / trace["wall_ms"],
                    "idle_share_untraced": 1.0 - busy / ms,
                    "kernel_ms_in_step": trace["port_kernel_ms"],
                    "other_device_ms_in_step": busy - trace["port_kernel_ms"],
                    "device_events": trace["device_events"],
                    "top_ms": trace["top_ms"]})
    else:
        out["trace"] = "no device events: not measured"
    print(json.dumps(out))
    assert nd == IMPL_STEPS and not bad and finite, (nd, bad, finite)
    assert not bool(info.diverged)
    assert math.isfinite(out["lin_res_last"]) and kc["restarts"] > 0
    assert counts.get("fused_residual[qk_roe_R]", 0) > 0, counts
    assert counts["fused_diag"] > 0, counts
    assert plain == 0, "the implicit path called a plain version"
    return counts, ms, out


STEADY_PRM = """# the bump relaxed to its free stream by pseudo-transient continuation
# (geometry, BCs and IC of tests/test_implicit.py:83-110, solver settings of
# examples/naca0012.prm)
subsection cartesian mesh
   set nx = {n}
   set ny = {n}
   set x0 = 0.0
   set x1 = 1.0
   set y0 = 0.0
   set y1 = 1.0
end
set degree = 1
subsection boundary_1
   set type = slip
end
subsection boundary_3
   set type = slip
end
subsection boundary_2
   set type = farfield
   set w_0 value = 0.5
   set w_1 value = 0.0
   set w_2 value = 1.0
   set w_3 value = 2.6
end
subsection boundary_4
   set type = farfield
   set w_0 value = 0.5
   set w_1 value = 0.0
   set w_2 value = 1.0
   set w_3 value = 2.6
end
subsection initial condition
   set w_0 value = 0.5 + 0.05*exp(-50*((x-0.5)^2 + (y-0.5)^2))
   set w_1 value = 0.05*exp(-50*((x-0.5)^2 + (y-0.5)^2))
   set w_2 value = 1.0 + 0.05*exp(-50*((x-0.5)^2 + (y-0.5)^2))
   set w_3 value = 2.6
end
subsection time stepping
   set time step type = local
   set cfl = 2.0
   set stationary = true
   set nonlinear iterations = 1
   set min residual = 1.0e-10
end
subsection linear solver
   set method = gmres
   set residual = 1.0e-4
end
subsection refinement
   set refinement = false
end
subsection flux
   set flux = roe
end
subsection limiter
   set type = none
end
"""


def phase_main_steady(kernels, plain_calls):
    """Phase 21: the steady bump through cli.run at STEADY_N x STEADY_N
    (the STEADY_N / 2 companion first), f32, --max-steps STEADY_STEPS;
    returns (launch counts, summary)."""
    import contextlib
    import io
    import re
    from dflo_tpu_torch import cli
    with tempfile.TemporaryDirectory() as out:
        prm = os.path.join(out, "steady.prm")
        with open(prm, "w") as f:
            f.write(STEADY_PRM.format(n=STEADY_N))
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            res = cli.run([prm, "--max-steps", str(STEADY_STEPS),
                           "--output-dir", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    text = log.getvalue()
    timer = {k: float(v) for k, v in re.findall(
        r"^(Setup|Time loop|Output)\s+\d+\s+([0-9.]+)", text, re.M)}
    coarse, fine = res.steady_levels
    kc = res.solver.krylov_counts.as_dict()
    kcc = res.solver.steady_coarse.krylov_counts.as_dict()
    finite = bool(torch.isfinite(res.u).all())
    out = {"grid": [STEADY_N, STEADY_N], "dtype": "float32",
           "ptc_steps": [len(coarse), len(fine)],
           "coarse_res_first_last": [coarse[0], coarse[-1]],
           "fine_res_first_last": [fine[0], fine[-1]],
           "cli_timer_s": timer, "cli_wall_s": wall,
           "roe_R_launches": counts.get("fused_residual[qk_roe_R]", 0),
           "plain_twin_calls": plain_calls["n"],
           "krylov_fine": kc, "krylov_coarse": kcc,
           "warnings": text.count("WARNING"), "card": card_line()}
    print(json.dumps(out))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "steady_history.json"), "w") as f:
        json.dump({"coarse": coarse, "fine": fine, **out}, f)
    assert finite and len(coarse) == len(fine) == STEADY_STEPS
    assert all(math.isfinite(r) for r in coarse + fine)
    assert counts.get("fused_residual[qk_roe_R]", 0) > 0, counts
    assert plain_calls["n"] == 0, "the steady path called a plain version"
    assert kc["restarts"] > 0 and kcc["restarts"] > 0
    return counts, out


def phase_primal_f64(kernels):
    """Phase 22: PRIMAL_STEPS f64 implicit steps at PRIMAL_N x PRIMAL_N
    with the kernel primal (volume_kernel="fused") and the plain one
    ("xla") from the same state: the states within 1e-10 relative, the
    Newton iterations equal (the card's tests/test_implicit.py:287)."""
    out = {}
    for vk in ("fused", "xla"):
        s, u0 = impl_solver(PRIMAL_N, torch.float64, cfl=2.0,
                            linear_residual=1e-6, volume_kernel=vk)
        iters = []
        kernels.reset_launch_counts()
        lin = []

        def note(*_):
            iters.append(int(s.last_stats.iters))
            lin.append(float(s.last_stats.lin_res))
        u, t, it = s.run(u0, 1e3, max_steps=PRIMAL_STEPS, callback=note)
        torch.cuda.synchronize()
        out[vk] = (u, iters, kernels.launch_counts())
        # every linear solve converged and the vortex moved
        assert max(lin) <= 1.001e-6, lin
        assert rel_err(u, u0) > 1e-6
    e = rel_err(out["fused"][0], out["xla"][0])
    print(json.dumps({"implicit_f64_kernel_vs_plain_primal": {
        "grid": [PRIMAL_N, PRIMAL_N], "steps": PRIMAL_STEPS, "rel_err": e,
        "newton_iters_fused": out["fused"][1],
        "newton_iters_plain": out["xla"][1],
        "roe_R_launches": out["fused"][2].get("fused_residual[qk_roe_R]", 0)},
        "card": card_line()}))
    assert e <= 1e-10, e
    assert out["fused"][1] == out["xla"][1]
    assert out["fused"][2].get("fused_residual[qk_roe_R]", 0) > 0
    assert out["xla"][2]["fused_residual"] == 0
    return e


# ---------------------------------------------------------------------------
# phases 23-24: masked modal Pk, MOOD with a body force and with every flux
# ---------------------------------------------------------------------------

def edit_prm(src: str, out: str, nx: int, ny: int, *edits) -> str:
    """cut_prm(src, out, nx, ny) with each (old, new) text edit made."""
    cut_prm(src, out, nx, ny)
    text = open(out).read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    with open(out, "w") as f:
        f.write(text)
    return out


def pk_edits(p: int, method: str):
    """The forward step's edits to the modal P_p basis and `method`."""
    return (("set degree = 1", f"set degree = {p}\nset basis = Pk"),
            ("set method = rk3", f"set method = {method}"))


#: rayleigh_taylor's edits to P2 MOOD with positivity
RT_MOOD_EDITS = (("set degree = 1", "set degree = 2"),
                 ("set basis = Qk", "set basis = Pk"),
                 ("set method = rk3", "set method = mood"),
                 ("set positivity limiter = false",
                  "set positivity limiter = true"))


def dmr_mood(entry, flux: str, dtype):
    """(solver, IC) of the 1152 x 288 DMR MOOD configuration with `flux`.
    With kep the IC is entry.contact_ic: from the Mach-10 shock the
    cascade with KEP gives NaN in its first step, in the reference as in
    the port (dflo_tpu's Solver at 32 x 8 and 64 x 16 on the CPU; KEP's
    logarithmic means of a state the shock drives non-positive)."""
    from dflo_tpu_torch import ic
    s, u0 = entry._build(NX, NY, dtype=dtype, device="cuda", method="mood",
                         flux=flux)
    if flux == "kep":
        u0 = ic.set_initial_condition(s.basis, s.mesh, entry.contact_ic,
                                      dtype=dtype, device="cuda")
    return s, u0


def fwd_pk_solver(kernels, p: int, dtype, method: str = "rk3",
                  grid=(FS_NX, FS_NY)):
    """(solver, state) of the forward step on P_p (`method`) at its full
    1920 x 640 (or at `grid`): the IC with 2 % noise on every DoF and 0.3 %
    of the mean on the higher modes (a seeded generator on the card), solid
    cells pinned in every mode (Solver.apply_mask), then the plain modal
    positivity, as every state the paths hand the residual has had."""
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.config.params import AllParameters
    with tempfile.TemporaryDirectory() as out:
        prm = edit_prm(FS_PRM, os.path.join(out, "fs_pk.prm"), *grid,
                       *pk_edits(p, method))
        params = AllParameters.from_prm_file(prm)
    s, _ = cli.build_solver(params, dtype=dtype, device="cuda")
    u = perturbed(cli.set_ic(params, s), 100 + p)
    g = torch.Generator(device="cuda").manual_seed(200 + p)
    noise = torch.rand(u[:, 1:].shape, generator=g, dtype=dtype,
                       device="cuda")
    u[:, 1:] += 0.003 * u[:, :1] * (2.0 * noise - 1.0)
    return s, kernels.fused_modal_pos_plain(s.apply_mask(u),
                                            s.rhs.modal_ops)


def phase_masked_pk_kernels(entry, kernels, results, log):
    """Phase 23: the masked modal residual (R, u + dt*R and SSP stage, all
    six fluxes, P1-P3) on the forward step at 1920 x 640, and the candidate
    with roe, sw, kfvs and kep on the DMR run with each (a realistic cell
    set and every cell), against their plain versions, f32 and f64, with
    whether each is bitwise; a solid cell's R exactly 0; CUDA-event times
    (kernel: median of 20, plain: of 5) of the P2 forms beside each
    form's bound; ptxas registers and spills of the Pk residual and of the
    candidate per flux."""
    from dflo_tpu_torch.solver.spatial import make_rhs
    res_src = {"fused_residual.cu"} | {f"fused_residual_{f}.cu"
                                       for f in ALL_FLUXES[1:]}
    cand_src = {"fused_mood_candidate.cu"} | {
        f"fused_mood_candidate_{f}.cu" for f in ALL_FLUXES[1:]}
    regs = {src: [r for r in rows if r[1] == "Pk"]
            for src, rows in ptxas_table(log, res_src).items()}
    regs.update(ptxas_table(log, cand_src, "fused_mood_candidate_kernel"))
    for src, rows in sorted(regs.items()):
        print(f"ptxas {src} (Pk): " + ", ".join(
            f"{d} P{p} {r} regs {sp} B spilled" for d, _, p, r, sp in rows))
    results["masked_pk_registers"] = regs
    name, rk = "fused_residual_pk_masked", "fused_residual_pk_masked_rk"
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        tol = TOL[dtype]
        cases, times = {}, {}
        for p in (1, 2, 3):
            s, u = fwd_pk_solver(kernels, p, dtype)
            t = s._scalar(0.25)
            h = torch.full((), 1e-4, dtype=dtype, device="cuda")
            sc = torch.stack([torch.full_like(h, 0.75), h])
            u_old = torch.roll(u, 1, -1).contiguous()
            for flux in ALL_FLUXES:
                rhs = make_rhs(s.basis, s.mesh, s.bcs, flux=flux, dtype=dtype,
                               device="cuda", volume_kernel="fused",
                               mask=s.mask)
                assert not hasattr(rhs, "sparse_candidate")
                strips = rhs.strips(u, t)
                forms = ({}, {"dt": h}, {"u_old": u_old, "sc": sc})
                pairs = [(kernels.fused_residual(u, *strips, rhs.ops, **kw),
                          kernels.fused_residual_plain(u, *strips, rhs.ops,
                                                       **kw)) for kw in forms]
                torch.cuda.synchronize()
                e = fold(results, name, tag, pairs, tol["fused_residual"])
                assert float(pairs[0][0][..., ~rhs.ops.mask].abs().max()) \
                    == 0.0, f"{flux} P{p} {tag}: a solid cell's R is not 0"
                cases[f"{flux} P{p}"] = {
                    "rel_err": e,
                    "bitwise": all(torch.equal(k, q) for k, q in pairs)}
                del pairs
                if p == 2:
                    # the three forms; the plain step (MOOD's pass 1) and
                    # stage (RK) beside them
                    tm = {"R": time_ms(lambda: kernels.fused_residual(
                              u, *strips, rhs.ops)),
                          "step": time_ms(lambda: kernels.fused_residual(
                              u, *strips, rhs.ops, dt=h)),
                          "stage": time_ms(lambda: kernels.fused_residual(
                              u, *strips, rhs.ops, **forms[2])),
                          "plain_step": time_ms(
                              lambda: kernels.fused_residual_plain(
                                  u, *strips, rhs.ops, dt=h), reps=5, warm=1),
                          "plain_stage": time_ms(
                              lambda: kernels.fused_residual_plain(
                                  u, *strips, rhs.ops, **forms[2]), reps=5,
                              warm=1)}
                    n = FS_NX * FS_NY
                    for form, row in (("step", name), ("stage", rk)):
                        tm[f"bound_{form}"] = bound(row, s.basis, dtype, n,
                                                    flux=flux)[0]
                    times[flux] = tm
                    print(f"[{tag}] masked P2 {flux} {FS_NX}x{FS_NY}: "
                          + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in tm.items()))
                del rhs, strips
            del s, u, u_old
            torch.cuda.empty_cache()
        r = results[name]
        r[f"cases_{tag}"] = cases
        r[f"forms_ms_{tag}"] = times
        r[f"ms_{tag}"] = times["lxf"]["step"]
        r[f"plain_ms_{tag}"] = times["lxf"]["plain_step"]
        for k in ("max_rel_err", "max_abs_err", "bitwise"):
            results[rk][f"{k}_{tag}"] = r[f"{k}_{tag}"]
        results[rk][f"ms_{tag}"] = times["lxf"]["stage"]
        results[rk][f"plain_ms_{tag}"] = times["lxf"]["plain_stage"]
        print(f"[{tag}] masked modal residual not bitwise in: "
              f"{sorted(k for k, v in cases.items() if not v['bitwise'])}")

        # ---- the candidate with each new flux on the DMR run with it -----
        for flux in FLUX_NEW:
            cname = f"fused_mood_candidate_{flux}"
            s, u = dmr_mood(entry, flux, dtype)
            u, t = s.post_stage(u), 0.0
            with plain_versions(kernels):
                for _ in range(MOOD_PLAIN_STEPS):
                    u, dtt, bad, _ = s._step(u, t, 1.0)
                    t += float(dtt)
                    assert not bool(bad), f"{tag}: plain {flux} MOOD: bad"
            tt = s._scalar(t)
            c1 = cascade_pass1(kernels, s, u, tt, dtt)
            results[cname][f"data_{tag}"] = c1["data"]
            assert int(c1["chg1"].sum()) > 0, f"the {flux} cascade is idle"
            tp_strips = s.rhs.strips(u, tt, c1["deg1"])
            rops, mops = s.rhs.ops, s.rhs.modal_ops

            def cand(fn, cells):
                return fn(u, c1["u_c"].clone(), c1["deg1"], cells,
                          *tp_strips, rops, mops, dtt)

            e = fold(results, cname, tag,
                     [(cand(kernels.fused_mood_candidate, c),
                       cand(kernels.fused_mood_candidate_plain, c))
                      for c in (c1["aff"], torch.ones_like(c1["aff"]))],
                     tol["fused_mood_candidate"])
            u_prev = c1["u_c"].clone()
            time_pair(results, cname, tag,
                      lambda: kernels.fused_mood_candidate(
                          u, u_prev, c1["deg1"], c1["aff"], *tp_strips, rops,
                          mops, dtt),
                      lambda: kernels.fused_mood_candidate_plain(
                          u, u_prev, c1["deg1"], c1["aff"], *tp_strips, rops,
                          mops, dtt), (NX, NY))
            print(f"[{tag}] {cname}: after {MOOD_PLAIN_STEPS} plain steps, "
                  f"pass 1 reduces {int(c1['chg1'].sum())} cells, set "
                  f"{c1['data']}, rel err {e:.3e}")
            del s, u, c1, u_prev
            torch.cuda.empty_cache()


def modal_pos_pairs(kernels, s, u, deg, states):
    """(kernel, plain) pairs of fused_modal_pos on each of `states` without
    and with the degree map `deg`, each also in its diag form."""
    mops = s.rhs.modal_ops
    return [pair for v in states for d in (None, deg)
            for pair in [(kernels.fused_modal_pos(v, mops, d),
                          kernels.fused_modal_pos_plain(v, mops, d)),
                         *zip(kernels.fused_modal_pos(v, mops, d,
                                                      with_diag=True),
                              kernels.fused_modal_pos_plain(
                                  v, mops, d, with_diag=True))]]


def phase_pk_path_kernels(kernels, results):
    """Phase 23, the other kernels of phase 24's masked and gravity MOOD
    paths at their sizes, f32 and f64, against their plain versions: on
    the forward step's P2 MOOD solver at 1920 x 640 (fwd_pk_solver's
    state, the degree map of its pass-1 candidate's masked check) the
    masked Pk diag and the modal positivity with and without truncation
    (and their diag forms), on that state and on the candidate pinned; on
    rayleigh_taylor's P2 MOOD solver at 1024 x 3072 after RT_PLAIN_STEPS
    plain steps the check (pass 1 and the dense route's pass 2, bitwise),
    the Pk post (with and without diag, on the marks of a plain stage) and
    the modal positivity; CUDA-event times of each main-path form."""
    from dflo_tpu_torch.physics import euler
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        tol = TOL[dtype]
        # ---- the masked forward step on P2 --------------------------------
        s, u = fwd_pk_solver(kernels, 2, dtype, "mood")
        assert s.mask is not None and s._mood_stage.mask is not None
        lam, _ = kernels.fused_diag_plain(u, s._diag_ops)
        h = s.cfl / lam / (2.0 * s.basis.degree + 1.0)
        c1 = cascade_pass1(kernels, s, u, s._scalar(0.0), h)
        deg1 = c1["deg1"]
        assert int(c1["chg1"].sum()) > 0, "the masked check reduces nothing"
        pinned = s.apply_mask(c1["u_c"])
        fold(results, "fused_diag_pk_masked", tag,
             [pair for v in (u, pinned)
              for pair in zip(kernels.fused_diag(v, s._diag_ops),
                              kernels.fused_diag_plain(v, s._diag_ops))],
             tol["fused_diag"])
        fold(results, "fused_modal_pos_fwd", tag,
             modal_pos_pairs(kernels, s, u, deg1, (u, pinned)),
             tol["fused_modal_pos"])
        mops = s.rhs.modal_ops
        grid = (FS_NX, FS_NY)
        time_pair(results, "fused_diag_pk_masked", tag,
                  lambda: kernels.fused_diag(u, s._diag_ops),
                  lambda: kernels.fused_diag_plain(u, s._diag_ops), grid)
        time_pair(results, "fused_modal_pos_fwd", tag,
                  lambda: kernels.fused_modal_pos(u, mops, deg1),
                  lambda: kernels.fused_modal_pos_plain(u, mops, deg1), grid)
        print(f"[{tag}] masked P2 {FS_NX}x{FS_NY}: pass 1 reduces "
              f"{int(c1['chg1'].sum())} cells")
        del s, u, c1, pinned, deg1
        torch.cuda.empty_cache()

        # ---- rayleigh_taylor on P2 under MOOD ------------------------------
        with tempfile.TemporaryDirectory() as out:
            prm = edit_prm(RT_PRM, os.path.join(out, "rt_mood.prm"), RT_NX,
                           RT_NY, *RT_MOOD_EDITS)
            _, s, u0 = prm_solver(prm, dtype)
        assert s.method == "mood" and s.mask is None
        u, t = s.post_stage(u0), 0.0
        del u0
        with plain_versions(kernels):
            for _ in range(RT_PLAIN_STEPS):
                u, dtt, bad, _ = s._step(u, t, 1.0)
                t += float(dtt)
                assert not bool(bad), f"{tag}: plain rt MOOD steps: bad"
            _, marked, _, _ = s._mood_stage(u, s._scalar(t), dtt)
        tt = s._scalar(t)
        c1 = cascade_pass1(kernels, s, u, tt, dtt)
        deg1, lim1 = c1["deg1"], c1["lim1"]
        assert int(c1["chg1"].sum()) > 0, "the rt cascade is idle"
        mops, cops, pops = s.rhs.modal_ops, s._mood_stage.cops, \
            s._pk_post_ops
        # the dense route's pass 2: truncated predictor, forward Euler
        u_t = kernels.fused_modal_pos_plain(u, mops, deg1)
        u_c2 = kernels.fused_residual_plain(u_t, *s.rhs.strips(u_t, tt),
                                            s.rhs.ops, dt=dtt)
        del u_t
        fold(results, "fused_mood_check_rt", tag,
             [pair for uc, dg, lm in ((c1["u_c"], c1["deg0"], c1["lim0"]),
                                      (u_c2, deg1, lim1))
              for pair in zip(
                  kernels.fused_mood_check(uc, c1["bmin"], c1["bmax"], dg,
                                           lm, cops),
                  kernels.fused_mood_check_plain(uc, c1["bmin"],
                                                 c1["bmax"], dg, lm, cops))],
             0.0, bitwise=True)
        shock = marked.to(dtype) * 2.0
        results["fused_pk_post_rt"][f"data_{tag}"] = {
            "marked": int(marked.sum())}
        for v in (u, c1["u_c"]):
            e, nflip, e_diag = check_post(
                results, "fused_pk_post_rt", tag, tol["fused_pk_post"],
                kernels.fused_pk_post(v, shock, pops, with_diag=True),
                kernels.fused_pk_post(v, shock, pops),
                kernels.fused_pk_post_plain(v, shock, pops, with_diag=True))
            print(f"[{tag}] fused_pk_post_rt rel err {e:.3e} outside "
                  f"{nflip} flipped cells of {int(marked.sum())} marked; "
                  f"diag rel err {e_diag:.3e}")
            assert e <= tol["fused_pk_post"], f"fused_pk_post_rt {tag}: {e}"
            assert (nflip == 0 if dtype == torch.float64
                    else nflip <= MAX_FLIP_FRACTION * RT_NX * RT_NY)
        fold(results, "fused_modal_pos_rt", tag,
             modal_pos_pairs(kernels, s, u, deg1, (u, c1["u_c"])),
             tol["fused_modal_pos"])
        grid = (RT_NX, RT_NY)
        u_c, bmin, bmax = c1["u_c"], c1["bmin"], c1["bmax"]
        deg0, lim0 = c1["deg0"], c1["lim0"]
        time_pair(results, "fused_mood_check_rt", tag,
                  lambda: kernels.fused_mood_check(u_c, bmin, bmax, deg0,
                                                   lim0, cops),
                  lambda: kernels.fused_mood_check_plain(u_c, bmin, bmax,
                                                         deg0, lim0, cops),
                  grid)
        time_pair(results, "fused_pk_post_rt", tag,
                  lambda: kernels.fused_pk_post(u, shock, pops,
                                                with_diag=True),
                  lambda: kernels.fused_pk_post_plain(u, shock, pops,
                                                      with_diag=True), grid)
        time_pair(results, "fused_modal_pos_rt", tag,
                  lambda: kernels.fused_modal_pos(u, mops, deg1),
                  lambda: kernels.fused_modal_pos_plain(u, mops, deg1), grid)
        print(f"[{tag}] rt P2 MOOD {RT_NX}x{RT_NY} after {RT_PLAIN_STEPS} "
              f"plain steps: pass 1 reduces {int(c1['chg1'].sum())} cells, "
              f"{int(marked.sum())} marked; rho min "
              f"{float(u[euler.RHO, 0].min())!r}")
        del s, u, c1, u_c2, shock, marked, u_c
        torch.cuda.empty_cache()


def mood_summary(s, counts, stats, syncs, steps):
    """The per-step MOOD numbers of a path's run."""
    n_st = steps * len(s.ark)
    return {"mood_stats_per_step": {"n_reduce": int(stats.n_reduce) / steps,
                                    "n_marked": int(stats.n_marked) / steps,
                                    "passes": stats.iters / steps},
            "cascade_passes_per_stage": stats.iters / n_st,
            "host_syncs_per_step": syncs / steps,
            "strips_per_step": (counts["fused_residual"]
                                + counts["fused_mood_candidate"]) / steps}


def phase_main_pk(kernels, plain_calls, name, metric, prm, grid, edits,
                  steps, chunk, forms, extra=None):
    """Phase 24 (and 26): one new path through cli.run (the prm edited and
    cut to grid), `steps` steps in chunks of `chunk`, f32: finite, no fatal
    flag, on the card, no plain version called, each of `forms` launched;
    then the CLI's solver timed apart from output over as many steps, still
    with no plain version called; extra(solver, u, t) adds entries to the
    metric's line; returns launch counts, ms/step and (solver, state) for
    the trace."""
    from dflo_tpu_torch import cli
    nx, ny = grid
    with tempfile.TemporaryDirectory() as out:
        cut = edit_prm(prm, os.path.join(out, f"{name}.prm"), nx, ny, *edits)
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        t0 = time.perf_counter()
        res = cli.run([cut, "--max-steps", str(steps), "--chunk", str(chunk),
                       "--output-dir", out])
        torch.cuda.synchronize()
        wall_cli = time.perf_counter() - t0
        counts = kernels.launch_counts()
    s = res.solver
    finite = bool(torch.isfinite(res.u).all())
    used = {k: v for k, v in counts.items() if v}
    print(f"{name} CLI {nx}x{ny}: {res.it} steps to t={res.t!r} in "
          f"{wall_cli:.2f} s with set-up and output, finite={finite}, "
          f"launches={used}, plain calls={plain_calls['n']}")
    assert res.it == steps and finite
    assert res.u.dtype == torch.float32 and res.u.is_cuda
    assert all(counts.get(f, 0) > 0 for f in forms), (forms, used)
    assert plain_calls["n"] == 0, f"{name} called a plain version"

    multi = s._multi_step(chunk)
    multi(res.u, res.t, 1e3)                       # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    syncs0 = s.host_syncs
    u, t, n, bad, stats = res.u, res.t, 0, False, None
    t0 = time.perf_counter()
    for _ in range(steps // chunk):
        u, t, nd, bad_c, st = multi(u, t, 1e3)
        n, bad = n + nd, bad | bad_c
        stats = st if not stats else type(st)(*(a + b
                                                for a, b in zip(stats, st)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = kernels.launch_counts()
    n, bad = int(n), bool(bad)
    assert n == steps and not bad and bool(torch.isfinite(u).all())
    assert all(timed.get(f, 0) > 0 for f in forms), (forms, timed)
    assert plain_calls["n"] == 0, f"{name} called a plain version"
    ms = 1e3 * wall / steps
    line = {metric: 4 * s.basis.K * nx * ny * steps / wall,
            "unit": "DoF-updates/s", "dtype": "float32", "grid": [nx, ny],
            "steps": steps, "chunk": chunk, "ms_per_step": ms,
            "cli_wall_s": wall_cli, "t": float(t),
            "launches_per_step": {k: v / steps for k, v in timed.items()
                                  if v},
            "card": card_line()}
    if s.method == "mood":
        line.update(mood_summary(s, timed, stats, s.host_syncs - syncs0,
                                 steps))
    if extra is not None:
        line.update(extra(s, u, t))
    print(json.dumps(line))
    return counts, ms, (s, u)


def phase_dmr_flux_mood(entry, kernels, plain_calls):
    """Phase 24: the DMR MOOD path with roe, sw, kfvs and kep (dmr_mood:
    entry._build(1152, 288, float32, cuda, "mood", flux=...); kep from the
    contact), post_stage,
    a 2-step warm-up, DMR_FLUX_STEPS steps in one chunk: finite, no fatal
    flag, no plain version called, the flux's candidate launched;
    dmr_p2_mood_<flux>_dof_updates_per_sec; returns {flux: launch
    counts}."""
    out = {}
    for flux in FLUX_NEW:
        s, u0 = dmr_mood(entry, flux, torch.float32)
        u = s.post_stage(u0)
        s._multi_step(2)(u, 0.0, 1.0e3)            # warm-up
        multi = s._multi_step(DMR_FLUX_STEPS)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        syncs0 = s.host_syncs
        t0 = time.perf_counter()
        u1, t1, n, bad, stats = multi(u, 0.0, 1.0e3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        n, bad = int(n), bool(bad)
        finite = bool(torch.isfinite(u1).all())
        print(f"DMR MOOD {flux}: {n} steps to t={float(t1)!r}, bad={bad}, "
              f"finite={finite}, plain calls={plain_calls['n']}")
        assert n == DMR_FLUX_STEPS and not bad and finite and u1.is_cuda
        assert counts.get(f"fused_mood_candidate[{flux}]", 0) > 0, counts
        assert plain_calls["n"] == 0, f"the {flux} MOOD path: plain calls"
        print(json.dumps({
            f"dmr_p2_mood_{flux}_dof_updates_per_sec":
                4 * s.basis.K * NX * NY * DMR_FLUX_STEPS / wall,
            "unit": "DoF-updates/s", "dtype": "float32", "grid": [NX, NY],
            "steps": DMR_FLUX_STEPS, "ic": "contact" if flux == "kep"
            else "dmr", "ms_per_step": 1e3 * wall / DMR_FLUX_STEPS,
            **mood_summary(s, counts, stats, s.host_syncs - syncs0,
                           DMR_FLUX_STEPS),
            "launches_per_step": {k: v / DMR_FLUX_STEPS
                                  for k, v in counts.items() if v},
            "card": card_line()}))
        out[flux] = counts
        del s, u, u1
    return out


# ---------------------------------------------------------------------------
# phases 25-26: the fused residual's single-card envelope (degrees 4-6,
# over-integrated quadrature, the source arms with every flux)
# ---------------------------------------------------------------------------

def ptxas_general(log: str) -> dict:
    """{source: [(kernel, dtype, dims, registers, spill bytes, stack
    bytes)]} of the general-dims instantiations (csrc/euler.cuh GDims) of
    the residual, the post and the MOOD kernels (the candidate, the modal
    positivity, the Pk post), from the build's ptxas lines."""
    import re
    out, src, fn, spill, stack = {}, None, "", 0, 0
    for line in log.splitlines():
        if line.startswith("== "):
            src = line.split()[1]
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        k = re.search(r"(tile_post|tile_modal_pos|tile_pk_post)_kernel"
                      r"(?:_wide)?I([fd])NS_5GDimsILb([01])E", fn)
        # the tile kernel of the residual (TP false) and the candidate
        t = re.search(r"tile_residual_kernel(?:_wide)?I([fd])NS_5GDimsILb([01])EEE"
                      r"Li\d+ELin?\d+ELb([01])E", fn)
        if m and t:
            k = ("fused_mood_candidate" if t.group(3) == "1"
                 else "fused_residual", t.group(1), t.group(2))
        elif m and k:
            k = (k.group(1).replace("tile_", "fused_"), *k.groups()[1:])
        if m and k:
            out.setdefault(src, []).append(
                (k[0], "f32" if k[1] == "f" else "f64",
                 "contract" if k[2] == "1" else "collocated",
                 int(m.group(1)), spill, stack))
    return out


def env_state(basis, grid, dtype, seed: int, mask=None):
    """The bump of phase 19 on the unit square at grid = (nx, ny), 2 %
    noise on every DoF (perturbed)."""
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.mesh import CartesianMesh
    mesh = CartesianMesh(grid[0], grid[1], 0.0, 1.0, 0.0, 1.0)
    u = ic.set_initial_condition(basis, mesh, bump_fn, dtype=dtype,
                                 device="cuda")
    return mesh, perturbed(u, seed)


def pairs_err(pairs):
    """(largest relative error, all bitwise) of (kernel, plain) pairs."""
    torch.cuda.synchronize()
    return (max(rel_err(k, p) for k, p in pairs),
            all(torch.equal(k, p) for k, p in pairs))


def residual_pairs(kernels, rhs, u, t, forms=("R",)):
    """(kernel, plain) pairs of the fused rhs on u in `forms` (R, step,
    stage)."""
    strips, force = rhs.strips(u, t), rhs.force(t)
    h = torch.full((), 1e-4, dtype=u.dtype, device="cuda")
    kw = {"R": {}, "step": {"dt": h},
          "stage": {"u_old": torch.roll(u, 1, -1).contiguous(),
                    "sc": torch.stack([torch.full_like(h, 0.75), h])}}
    return [(kernels.fused_residual(u, *strips, rhs.ops, force=force,
                                    **kw[f]),
             kernels.fused_residual_plain(u, *strips, rhs.ops, force=force,
                                          **kw[f])) for f in forms]


#: the coverage cases of phase 25 at ENV_GRID: (family, p, nq or None,
#: flux, forms, masked)
ENV_CASES = tuple(
    [(fam, p, None, f, ("R",), False) for fam in ("Qk", "Qk_gll", "Pk")
     for p in (4, 6) for f in ("hllc", "lxf", "roe", "sw", "kfvs", "kep")]
    + [("Qk", 4, None, "hllc", ("R", "step", "stage"), False),
       ("Qk_gll", 5, None, "roe", ("R", "step", "stage"), False),
       ("Pk", 4, None, "kep", ("R", "step", "stage"), False),
       ("Qk", 4, None, "lxf", ("R", "stage"), True),
       ("Qk_gll", 6, None, "kep", ("R", "stage"), True),
       ("Pk", 5, None, "roe", ("R", "step"), True),
       ("Qk", 5, None, "lxf", ("R",), False),
       ("Qk_gll", 5, None, "lxf", ("R",), False),
       ("Pk", 5, None, "lxf", ("R",), False),
       ("Qk", 2, 4, "lxf", ("R", "step", "stage"), False),
       ("Qk_gll", 2, 4, "hllc", ("R", "step", "stage"), False),
       ("Pk", 2, 4, "roe", ("R", "step", "stage"), False),
       ("Qk", 4, 6, "kep", ("R", "stage"), True),
       ("Pk", 6, 8, "sw", ("R",), False)])


def phase_envelope_kernels(entry, kernels, results, log):
    """Phase 25 for both dtypes: the new forms against their plain versions.
    Coverage at ENV_GRID (ENV_CASES; the twelve flux x arm pairs on
    rayleigh_taylor's and iso_xing_shu's configs; the post on Q4-Q6 masked
    and not, with and without diag; the diag on every new basis kind;
    volume_residual at K = 25, 36, 49), then each row of the kernel table
    at its path's shapes, timed (kernel median of 20, plain of 5)."""
    import numpy as np
    from dflo_tpu_torch.driver import Solver
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.ops.contract import basis_reduce
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.solver.spatial import make_rhs
    regs = ptxas_general(log)
    for src, rows in sorted(regs.items()):
        print(f"ptxas {src} (general dims): " + ", ".join(
            f"{k[len('fused_'):]} {d} {dims} {r} regs {sp} B spilled "
            f"{st} B stack" for k, d, dims, r, sp, st in rows))
    results["envelope_registers"] = regs
    gx, gy = ENV_GRID
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        tol = TOL[dtype]
        cases = {}

        def note(key, pairs, tol_key="fused_residual"):
            e, eq = pairs_err(pairs)
            cases[key] = {"rel_err": e, "bitwise": eq}
            assert e <= tol[tol_key], f"{key} {tag}: {e}"
            assert eq or tol_key not in BITWISE_ROWS, f"{key} {tag}: not bitwise"

        # ---- the residual: degrees 4-6, over-integrated, masked ----------
        for fam, p, nq, flux, forms, masked in ENV_CASES:
            basis = make_basis(fam, p, nq)
            mesh, u = env_state(basis, ENV_GRID, dtype, 300 + p)
            mask = None
            if masked:
                mask = np.ones((gy, gx), bool)
                mask[gy // 4:gy // 2, gx // 3:gx // 2] = False
            rhs = make_rhs(basis, mesh, bump_bcs(), flux=flux, dtype=dtype,
                           device="cuda", volume_kernel="fused", mask=mask)
            note(f"{fam}{p} nq{basis.nq} {flux}"
                 + (" masked" if masked else "") + " " + "/".join(forms),
                 residual_pairs(kernels, rhs, u, rhs_time(dtype), forms))
            del rhs, u
        # ---- the twelve flux x arm pairs at p 1-2 -------------------------
        for flux in FLUX_NEW:
            for arm, prm, edit in (("grav", RT_PRM, None),
                                   ("grav", RT_PRM, rt_pk),
                                   ("force", RT_PRM, rt_force),
                                   ("wbiso", ISO_PRM, iso_variant(2, flux))):
                def with_flux(params, _e=edit, _f=flux):
                    if _e is not None:
                        _e(params)
                    params.flux.flux = _f
                _, s, u0 = prm_solver(prm, dtype, grid=ENV_GRID,
                                      edit=with_flux)
                assert (s.rhs.ops.flux, s.rhs.ops.source) == (flux, arm)
                u = perturbed(s.post_stage(u0), 400)
                note(f"{arm} {s.basis.family}{s.basis.degree} {flux} "
                     "R/step/stage",
                     residual_pairs(kernels, s.rhs, u, rhs_time(dtype),
                                    ("R", "step", "stage")))
                del s, u, u0
        # ---- the arms on the general dims (the arm read at run time) ----
        for fam, p, nq, flux, kw in (
                ("Qk", 4, None, "hllc",
                 dict(source=euler.GravitySource(0.0, -1.0))),
                ("Pk", 4, None, "roe", dict(source=euler.ExternalForce(
                    lambda x, y, t: (0.01 * x * torch.cos(t),
                                     -1.0 + 0.0 * y)))),
                ("Qk_gll", 4, None, "kep",
                 dict(well_balanced="isothermal",
                      potential=lambda x, y: x + y)),
                ("Qk", 2, 4, "sw", dict(source=euler.GravitySource(0.0,
                                                                   -1.0)))):
            basis = make_basis(fam, p, nq)
            mesh, u = env_state(basis, ENV_GRID, dtype, 450 + p)
            rhs = make_rhs(basis, mesh, bump_bcs(), flux=flux, dtype=dtype,
                           device="cuda", volume_kernel="fused", **kw)
            note(f"{rhs.ops.source} {fam}{p} nq{basis.nq} {flux} "
                 "R/step/stage",
                 residual_pairs(kernels, rhs, u, rhs_time(dtype),
                                ("R", "step", "stage")))
            del rhs, u
        # ---- the post Q4-Q6 (masked and not), the diag, volume_residual --
        for p in (4, 5, 6):
            basis = make_basis("Qk", p)
            mesh, u = env_state(basis, ENV_GRID, dtype, 500 + p)
            for masked in (False, True):
                mask = None
                if masked:
                    mask = np.ones((gy, gx), bool)
                    mask[gy // 4:gy // 2, gx // 3:gx // 2] = False
                po = kernels.post_operators(
                    basis, mesh, indicator="density", beta=2.0,
                    char_lim=True, pos_lim=True, mask=mask, dtype=dtype,
                    device="cuda")
                pk = kernels.fused_post(u, po, with_diag=True)
                pp = kernels.fused_post_plain(u, po, with_diag=True)
                pk0 = kernels.fused_post(u, po)
                torch.cuda.synchronize()
                e_in, nflip = post_err(pk[0], pp[0], tol["fused_post"])
                e0, nflip0 = post_err(pk0, pp[0], tol["fused_post"])
                e_d = max(rel_err(pk[1], pp[1]), rel_err(pk[2], pp[2]))
                cases[f"post Q{p}" + (" masked" if masked else "")] = {
                    "rel_err": max(e_in, e0, e_d),
                    "flipped_cells": max(nflip, nflip0),
                    "bitwise": bool(torch.equal(pk[0], pp[0])
                                    and torch.equal(pk0, pp[0])
                                    and torch.equal(pk[1], pp[1])
                                    and torch.equal(pk[2], pp[2]))}
                assert max(e_in, e0, e_d) <= tol["fused_post"], p
                assert max(nflip, nflip0) <= (
                    0 if dtype == torch.float64
                    else MAX_FLIP_FRACTION * gx * gy), (p, nflip)
            vrhs = make_rhs(basis, mesh, bump_bcs(), dtype=dtype,
                            device="cuda", volume_kernel="pallas")
            note(f"volume_residual K={basis.K}",
                 [(kernels.volume_residual(vrhs.lift_stack, u),
                   kernels.volume_residual_plain(vrhs.lift_stack, u))],
                 "volume_residual")
            del u, vrhs
        for fam, p, nq in (("Qk", 4, None), ("Qk", 6, 8), ("Qk_gll", 5, 7),
                           ("Pk", 4, None), ("Pk", 6, 8), ("Qk", 2, 4),
                           ("Pk", 5, None)):
            basis = make_basis(fam, p, nq)
            mesh, u = env_state(basis, ENV_GRID, dtype, 600 + p)
            mask = np.ones((gy, gx), bool)
            mask[gy // 4:gy // 2, gx // 3:gx // 2] = False
            for m in (None, mask):
                d = kernels.diag_operators(basis, mesh, mask=m, dtype=dtype,
                                           device="cuda")
                note(f"diag {fam}{p} nq{basis.nq}"
                     + (" masked" if m is not None else ""),
                     list(zip(kernels.fused_diag(u, d),
                              kernels.fused_diag_plain(u, d))), "fused_diag")
            del u
        results["envelope_cases"][tag] = cases
        nb = sorted(k for k, v in cases.items() if not v["bitwise"])
        print(f"[{tag}] envelope coverage at {gx}x{gy}: {len(cases)} cases, "
              f"largest rel err {max(v['rel_err'] for v in cases.values()):.3e}"
              f"; not bitwise: {nb}")
        torch.cuda.empty_cache()

        # ---- the table's rows at their paths' shapes -----------------------
        def row(name, fk, fp, grid, pairs, tol_key="fused_residual"):
            fold(results, name, tag, pairs, tol[tol_key])
            time_pair(results, name, tag, fk, fp, grid)

        def stage_row(name, s, u, grid):
            pairs = residual_pairs(kernels, s.rhs, u, s._scalar(0.25),
                                   ("R", "step", "stage"))
            strips = s.rhs.strips(u, s._scalar(0.25))
            force = s.rhs.force(s._scalar(0.25))
            h = torch.full((), 1e-4, dtype=dtype, device="cuda")
            kw = {"u_old": torch.roll(u, 1, -1).contiguous(),
                  "sc": torch.stack([torch.full_like(h, 0.75), h]),
                  "force": force}
            row(name, lambda: kernels.fused_residual(u, *strips, s.rhs.ops,
                                                     **kw),
                lambda: kernels.fused_residual_plain(u, *strips, s.rhs.ops,
                                                     **kw), grid, pairs)

        def diag_row(name, s, u, grid):
            row(name, lambda: kernels.fused_diag(u, s._diag_ops),
                lambda: kernels.fused_diag_plain(u, s._diag_ops), grid,
                list(zip(kernels.fused_diag(u, s._diag_ops),
                         kernels.fused_diag_plain(u, s._diag_ops))),
                "fused_diag")

        for p, n, rname, dname in ((4, P4_N, "fused_residual_pk4_lxf",
                                    "fused_diag_pk4"),
                                   (6, P6_N, "fused_residual_pk6_lxf",
                                    "fused_diag_pk6")):
            _, s, u0 = prm_solver(VORTEX_PRM, dtype, n,
                                  edit=lambda q, _p=p: setattr(q, "degree",
                                                               _p))
            assert (s.basis.degree, s.rhs.ops.flux) == (p, "lxf")
            u = perturbed(u0, 700 + p)
            del u0
            stage_row(rname, s, u, (n, n))
            diag_row(dname, s, u, (n, n))
            del s, u
            torch.cuda.empty_cache()
        # the over-integrated vortex: Q2 on 4 x 4 Gauss points
        params, s, u0 = oi_vortex(dtype)
        u = perturbed(u0, 710)
        del u0
        stage_row("fused_residual_q2oi_lxf", s, u, (Q2OI_N, Q2OI_N))
        diag_row("fused_diag_q2oi", s, u, (Q2OI_N, Q2OI_N))
        del s, u
        torch.cuda.empty_cache()
        # the DMR on Q4: after post_stage and after 2 plain steps
        s, u0 = entry._build(NX, NY, dtype=dtype, device="cuda", degree=4)
        u_a = s.post_stage(u0)
        u_b, t = u_a, 0.0
        for _ in range(2):
            u_b, dtt, bad = plain_step(s, u_b, t, 1.0)
            t += float(dtt)
            assert not bool(bad), f"{tag}: plain Q4 DMR steps tripped bad"
        stage_row("fused_residual_q4_hllc", s, u_b, (NX, NY))
        diag_row("fused_diag_q4", s, u_b, (NX, NY))
        po = s._post_ops
        for label, v in (("the IC", u0), ("2 steps", u_b)):
            pk = kernels.fused_post(v, po, with_diag=True)
            pp = kernels.fused_post_plain(v, po, with_diag=True)
            pk0 = kernels.fused_post(v, po)
            torch.cuda.synchronize()
            e, nflip, e_diag = check_post(results, "fused_post_q4", tag,
                                          tol["fused_post"], pk, pk0, pp)
            print(f"[{tag}] DMR Q4 {label}: fused_post_q4 rel err {e:.3e} "
                  f"outside {nflip} flipped cells; diag rel err "
                  f"{e_diag:.3e}")
            assert e <= tol["fused_post"], e
            assert nflip <= (0 if dtype == torch.float64
                             else MAX_FLIP_FRACTION * NX * NY), nflip
        # the cells the TVB limiter sees (the bound's data)
        shock, _ = po.indicator(u_b, basis_reduce(po.avg, u_b))
        results["fused_post_q4"][f"data_{tag}"] = {
            "marked": int((shock > 1.0).sum())}
        time_pair(results, "fused_post_q4", tag,
                  lambda: kernels.fused_post(u_b, po, with_diag=True),
                  lambda: kernels.fused_post_plain(u_b, po, with_diag=True),
                  (NX, NY))
        sv = Solver(s.basis, s.mesh, s.bcs, flux=s.flux,
                    limiter=s.limiter_cfg, cfl=s.cfl, dtype=dtype,
                    device="cuda", volume_kernel="pallas",
                    post_kernel="fused")
        L = sv.rhs.lift_stack
        row("volume_residual_q4", lambda: kernels.volume_residual(L, u_b),
            lambda: kernels.volume_residual_plain(L, u_b), (NX, NY),
            [(kernels.volume_residual(L, u_b),
              kernels.volume_residual_plain(L, u_b))], "volume_residual")
        del s, sv, u0, u_a, u_b
        torch.cuda.empty_cache()
        # the source arms with roe on their paths' configs
        _, s, u0 = prm_solver(RT_PRM, dtype, grid=(RT_NX, RT_NY),
                              edit=lambda q: setattr(q.flux, "flux", "roe"))
        assert (s.rhs.ops.flux, s.rhs.ops.source) == ("roe", "grav")
        stage_row("fused_residual_roe_grav", s, s.post_stage(u0),
                  (RT_NX, RT_NY))
        del s, u0
        _, s, u0 = prm_solver(ISO_PRM, dtype, ISO_N,
                              edit=iso_variant(2, "roe"))
        assert (s.rhs.ops.flux, s.rhs.ops.source) == ("roe", "wbiso")
        u = perturbed(u0, 720)
        del u0
        stage_row("fused_residual_roe_wbiso", s, u, (ISO_N, ISO_N))
        del s, u
        torch.cuda.empty_cache()


def rhs_time(dtype):
    return torch.full((), 0.25, dtype=dtype, device="cuda")


def oi_vortex(dtype):
    """(params, solver, IC) of examples/isentropic_vortex.prm at Q2OI_N x
    Q2OI_N on the over-integrated Q2 basis (4 x 4 Gauss points), built
    through Solver: the prm has no quadrature setting."""
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.driver import Solver
    from dflo_tpu_torch.ops.basis import make_basis
    params, s0, _ = prm_solver(VORTEX_PRM, dtype, Q2OI_N)
    s = Solver(make_basis("Qk", 2, 4), s0.mesh, s0.bcs, flux=s0.flux,
               limiter=s0.limiter_cfg, cfl=s0.cfl, dtype=dtype,
               device="cuda")
    assert s.volume_kernel == "fused" and s.rhs.ops.V is not None
    return params, s, cli.set_ic(params, s)


def vortex_error(s, u, t) -> dict:
    """The density l2_error of the vortex against its IC (stationary:
    information, not a gate)."""
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.physics import euler
    err = ic.l2_error(s.basis, s.mesh, u, ic.IC_FUNCTIONS["isenvort"](),
                      float(t))
    return {"t": float(t), "rho_l2_error_vs_ic": float(err[euler.RHO])}


def phase_solver_path(kernels, plain_calls, name, metric, s, u, steps,
                      chunk, forms, grid, extra=None):
    """Phase 26: a path driven through Solver._multi_step (after post_stage
    and a warm-up chunk), `steps` steps in chunks of `chunk`, f32: finite,
    no fatal flag, no plain version called, each of `forms` launched;
    returns launch counts and ms/step."""
    u = s.post_stage(u)
    multi = s._multi_step(chunk)
    multi(u, 0.0, 1e3)                              # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    n, bad, t = 0, False, 0.0
    t0 = time.perf_counter()
    for _ in range(steps // chunk):
        u, t, nd, bad_c, _ = multi(u, t, 1e3)
        n, bad = n + nd, bad | bad_c
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n, bad, finite = int(n), bool(bad), bool(torch.isfinite(u).all())
    used = {k: v for k, v in counts.items() if v}
    print(f"{name} {grid[0]}x{grid[1]}: {n} steps to t={float(t)!r}, "
          f"bad={bad}, finite={finite}, launches={used}, plain calls="
          f"{plain_calls['n']}")
    assert n == steps and not bad and finite and u.is_cuda
    assert all(counts.get(f, 0) > 0 for f in forms), (forms, used)
    assert plain_calls["n"] == 0, f"{name} called a plain version"
    ms = 1e3 * wall / steps
    line = {metric: 4 * s.basis.K * grid[0] * grid[1] * steps / wall,
            "unit": "DoF-updates/s", "dtype": "float32",
            "grid": list(grid), "steps": steps, "chunk": chunk,
            "ms_per_step": ms,
            "launches_per_step": {k: v / steps for k, v in used.items()},
            "card": card_line()}
    if extra is not None:
        line.update(extra(s, u, t))
    print(json.dumps(line))
    return counts, ms


def phase_envelope_paths(entry, kernels, plain_calls):
    """Phase 26: the six new paths, f32, ENV_STEPS steps each; returns
    ({path: launch counts}, the P4 vortex's ms/step, its (solver, state)
    for phase 8)."""
    from dflo_tpu_torch.driver import Solver
    out = {}
    for p, n in ((4, P4_N), (6, P6_N)):
        _, s, u0 = prm_solver(VORTEX_PRM, torch.float32, n,
                              edit=lambda q, _p=p: setattr(q, "degree", _p))
        assert s.basis.degree == p and s.limiter_cfg.type == "none"
        out[f"vortex_p{p}"], ms = phase_solver_path(
            kernels, plain_calls, f"isenvort_p{p}",
            f"isenvort_p{p}_lxf_rk_dof_updates_per_sec", s, u0, ENV_STEPS,
            ENV_CHUNK, ("fused_residual[pk_lxf_stage]", "fused_diag"),
            (n, n), extra=vortex_error)
        if p == 4:
            vortex_p4 = (ms, (s, s.post_stage(u0)))
        del s, u0
        torch.cuda.empty_cache()
    s, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda",
                         degree=4)
    assert s.basis.degree == 4 and s.post_kernel == "fused"
    out["dmr_q4"], _ = phase_solver_path(
        kernels, plain_calls, "dmr_q4", "dmr_q4_rk_tvb_dof_updates_per_sec",
        s, u0, ENV_STEPS, ENV_CHUNK,
        ("fused_residual[qk_hllc_stage]", "fused_post", "fused_diag"),
        (NX, NY))
    # one post per stage, the last stage's in its diag form
    assert out["dmr_q4"]["fused_post"] == len(s.ark) * ENV_STEPS
    sv = Solver(s.basis, s.mesh, s.bcs, flux=s.flux, limiter=s.limiter_cfg,
                cfl=s.cfl, dtype=torch.float32, device="cuda",
                volume_kernel="pallas", post_kernel="fused")
    out["pallas_q4"], _ = phase_solver_path(
        kernels, plain_calls, "dmr_q4_pallas",
        "dmr_q4_pallas_rk_tvb_dof_updates_per_sec", sv, u0, PALLAS_STEPS,
        PALLAS_STEPS, ("volume_residual", "fused_post"), (NX, NY))
    del s, sv, u0
    _, s, u0 = oi_vortex(torch.float32)
    out["q2oi"], _ = phase_solver_path(
        kernels, plain_calls, "isenvort_q2oi",
        "isenvort_q2oi_lxf_rk_dof_updates_per_sec", s, u0, ENV_STEPS,
        ENV_CHUNK, ("fused_residual[qk_lxf_stage]", "fused_diag"),
        (Q2OI_N, Q2OI_N), extra=vortex_error)
    del s, u0
    out["rt_roe"], _, _ = phase_main_pk(
        kernels, plain_calls, "rt_q1_roe",
        "rt_q1_roe_rk_tvb_gravity_dof_updates_per_sec", RT_PRM,
        (RT_NX, RT_NY), (("set flux = hllc", "set flux = roe"),),
        ENV_STEPS, ENV_CHUNK, ("fused_residual[qk_roe_grav_stage]",
                               "fused_post", "fused_diag"))
    out["iso_roe"], _, _ = phase_main_pk(
        kernels, plain_calls, "iso_gll2_roe",
        "isohydro_gll2_wb_roe_rk_dof_updates_per_sec", ISO_PRM,
        (ISO_N, ISO_N), (("set flux = hllc", "set flux = roe"),),
        ENV_STEPS, ENV_CHUNK, ("fused_residual[gll_roe_wbiso_stage]",
                               "fused_diag"))
    torch.cuda.empty_cache()
    return out, *vortex_p4


# ---------------------------------------------------------------------------
# phases 27-28: the MOOD cascade over its whole degree range (the candidate,
# the modal positivity, the Pk post and the check at p 4-6; P1's plain
# check)
# ---------------------------------------------------------------------------

def same(k: torch.Tensor, q: torch.Tensor) -> bool:
    """Bitwise equal, NaN where the other is NaN (KEP's cascade on the
    perturbed DMR can leave NaN in both versions alike)."""
    return (torch.equal(k.isnan(), q.isnan())
            and torch.equal(k.nan_to_num(), q.nan_to_num()))


def md_case(p: int, dtype, seed: int, flux: str = "hllc", nq=None):
    """(solver-like holder, state, planes) of one coverage case of phase
    27 on the DMR box at MD_GRID, P_p on nq x nq points: the DMR IC with 2 %
    noise on every mode (perturbed), positivity-limited; a degree map, a
    cell set (30 %), limiter marks (20 %) and a shock plane (50 % marked)
    from a seeded generator on the card."""
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.ops import kernels
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.solver.spatial import make_rhs
    from dflo_tpu_torch.entry import _build, dmr_ic
    nx, ny = MD_GRID
    basis = make_basis("Pk", p, nq)
    mesh = CartesianMesh(nx, ny, 0.0, 4.0, 0.0, 1.0)
    bcs = _build(8, 8, dtype=dtype, device="cuda", method="mood")[0].bcs
    rhs = make_rhs(basis, mesh, bcs, flux=flux, dtype=dtype, device="cuda",
                   volume_kernel="fused")
    u = perturbed(ic.set_initial_condition(basis, mesh, dmr_ic, dtype=dtype,
                                           device="cuda"), seed)
    u = kernels.fused_modal_pos_plain(u, rhs.modal_ops)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd():
        return torch.rand((ny, nx), generator=g, device="cuda")
    planes = {"deg": 1 + (rnd() * p).to(torch.int32).clamp(max=p - 1),
              "cells": rnd() < 0.3, "lim": rnd() < 0.2,
              "shock": (rnd() < 0.5).to(dtype) * 2.0}
    return basis, mesh, rhs, u, planes


def candidate_cases(kernels, rhs, u, pl):
    """(kernel, plain) pairs of the candidate on the case's cell set and
    on every cell (in place into a reversed copy of u); cells off the set
    keep it."""
    h = torch.full((), 1e-4, dtype=u.dtype, device="cuda")
    strips = rhs.strips(u, 0.0, pl["deg"])
    prev = u.flip(-1).contiguous()
    pairs = []
    for cells in (pl["cells"], torch.ones_like(pl["cells"])):
        k = kernels.fused_mood_candidate(u, prev.clone(), pl["deg"], cells,
                                         *strips, rhs.ops, rhs.modal_ops, h)
        q = kernels.fused_mood_candidate_plain(u, prev.clone(), pl["deg"],
                                               cells, *strips, rhs.ops,
                                               rhs.modal_ops, h)
        assert torch.equal(k[..., ~cells], prev[..., ~cells])
        pairs.append((k, q))
    return pairs


def mood_check_pairs(kernels, basis, mesh, u, pl):
    """(kernel, plain) output triples of the check on a candidate near u
    (1e-6 noise, so DMP goes both ways), non-periodic and periodic."""
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.stab import mood as mood_mod
    g = torch.Generator(device="cuda").manual_seed(basis.degree)
    cand = (u * (1.0 + 1e-6 * (2.0 * torch.rand(
        u.shape, generator=g, dtype=u.dtype, device="cuda") - 1.0)))
    cand = cand.contiguous()
    out = []
    for per in (False, True):
        ops = kernels.mood_check_operators(basis, mesh, per_x=per,
                                           per_y=per, device="cuda")
        rho0 = ops.avg0 * u[euler.RHO, 0]
        bmin = mood_mod.neighborhood_min(rho0, ops.valid)
        bmax = mood_mod.neighborhood_max(rho0, ops.valid)
        k = kernels.fused_mood_check(cand, bmin, bmax, pl["deg"], pl["lim"],
                                     ops)
        q = kernels.fused_mood_check_plain(cand, bmin, bmax, pl["deg"],
                                           pl["lim"], ops)
        out += list(zip(k, q))
    return out


def phase_mood_degree_kernels(entry, kernels, results, log):
    """Phase 27 for both dtypes: rows 3, 8, 9 and 10 over the degree range
    against their plain versions, bitwise.  Coverage at MD_GRID (MD_CASES:
    the candidate with all six fluxes at p 4, with hllc and lxf at p 5, 6
    and 1, and on the over-integrated P2 (4 x 4 points), on a cell set and
    on every cell; the modal positivity in its four forms and the Pk post
    with and without diag at p 4, 5, 6 and 1, the check, periodic and not,
    at p 4, 5 and 6; the
    masked forward step's modal positivity at p 4, cut to MD_FWD_GRID).
    Then the P4 rows at the P4 DMR MOOD path's state (1152 x 288 after
    MD_PLAIN_STEPS plain MOOD steps; pass 1's degree map and cell set),
    timed: kernel median of 20, plain of 5."""
    regs = {src: [r for r in rows if r[0] in (
        "fused_mood_candidate", "fused_modal_pos", "fused_pk_post")]
        for src, rows in ptxas_general(log).items()}
    regs = {k: v for k, v in regs.items() if v}
    for src, rows in sorted(regs.items()):
        print(f"ptxas {src} (general modal dims): " + ", ".join(
            f"{k[len('fused_'):]} {d} {r} regs {sp} B spilled {st} B stack"
            for k, d, _, r, sp, st in rows))
    results["mood_degree_registers"] = regs
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        cases = {}

        def note(key, pairs):
            torch.cuda.synchronize()
            eq = all(same(k, q) for k, q in pairs)
            cases[key] = eq
            assert eq, f"{key} {tag} is not bitwise"

        for p, fluxes, nq in MD_CASES:
            for flux in fluxes:
                basis, mesh, rhs, u, pl = md_case(p, dtype, 800 + p, flux, nq)
                note(f"candidate P{p} nq{basis.nq} {flux}",
                     candidate_cases(kernels, rhs, u, pl))
            if nq is not None:
                continue
            mops = rhs.modal_ops
            note(f"modal_pos P{p}", [
                pair for d in (None, pl["deg"])
                for pair in [(kernels.fused_modal_pos(u, mops, d),
                              kernels.fused_modal_pos_plain(u, mops, d)),
                             *zip(kernels.fused_modal_pos(
                                 u, mops, d, with_diag=True),
                                 kernels.fused_modal_pos_plain(
                                     u, mops, d, with_diag=True))]])
            pops = kernels.pk_post_operators(basis, mesh, beta=2.0,
                                             char_lim=True, dtype=dtype,
                                             device="cuda")
            note(f"pk_post P{p}", [
                (kernels.fused_pk_post(u, pl["shock"], pops),
                 kernels.fused_pk_post_plain(u, pl["shock"], pops)),
                *zip(kernels.fused_pk_post(u, pl["shock"], pops,
                                           with_diag=True),
                     kernels.fused_pk_post_plain(u, pl["shock"], pops,
                                                 with_diag=True))])
            if p >= 2:
                note(f"check P{p}", mood_check_pairs(kernels, basis, mesh, u,
                                                     pl))
            del rhs, u
        # the masked forward step's modal positivity at p 4
        s, u = fwd_pk_solver(kernels, 4, dtype, "mood", grid=MD_FWD_GRID)
        assert s.mask is not None and s._mood_stage.mask is not None
        g = torch.Generator(device="cuda").manual_seed(4)
        deg = 1 + (torch.rand(u.shape[-2:], generator=g, device="cuda")
                   * 4).to(torch.int32).clamp(max=3)
        note("modal_pos P4 masked fwd",
             modal_pos_pairs(kernels, s, u, deg, (u, s.apply_mask(u))))
        del s, u
        results["mood_degree_cases"][tag] = cases
        print(f"[{tag}] MOOD kernels over the degree range at "
              f"{MD_GRID[0]}x{MD_GRID[1]}: {len(cases)} cases, all bitwise")
        torch.cuda.empty_cache()

        # ---- the P4 rows at the P4 DMR path's state ------------------------
        s, u0 = entry._build(NX, NY, dtype=dtype, device="cuda",
                             method="mood", degree=4)
        u, t = s.post_stage(u0), 0.0
        del u0
        with plain_versions(kernels):
            for _ in range(MD_PLAIN_STEPS):
                u, dtt, bad, _ = s._step(u, t, 1.0)
                t += float(dtt)
                assert not bool(bad), f"{tag}: plain P4 MOOD steps: bad"
            _, marked, st_plain, _ = s._mood_stage(u, s._scalar(t), dtt)
        tt, h = s._scalar(t), dtt
        c1 = cascade_pass1(kernels, s, u, tt, h)
        aff, deg1, u_c = c1["aff"], c1["deg1"], c1["u_c"]
        assert int(c1["chg1"].sum()) > 0, "the P4 cascade is idle"
        rops, mops = s.rhs.ops, s._mood_stage.mops
        cops, pops = s._mood_stage.cops, s._pk_post_ops
        tp_strips = s.rhs.strips(u, tt, deg1)
        shock = marked.to(dtype) * 2.0
        results["fused_mood_candidate_p4"][f"data_{tag}"] = c1["data"]
        results["fused_pk_post_p4"][f"data_{tag}"] = {
            "marked": int(marked.sum())}

        def cand(fn):
            return fn(u, u_c.clone(), deg1, aff, *tp_strips, rops, mops, h)
        fold(results, "fused_mood_candidate_p4", tag,
             [(cand(kernels.fused_mood_candidate),
               cand(kernels.fused_mood_candidate_plain))], 0.0,
             bitwise=True)
        fold(results, "fused_modal_pos_p4", tag,
             modal_pos_pairs(kernels, s, u, deg1, (u,)), 0.0, bitwise=True)
        fold(results, "fused_pk_post_p4", tag,
             [(kernels.fused_pk_post(u, shock, pops),
               kernels.fused_pk_post_plain(u, shock, pops)),
              *zip(kernels.fused_pk_post(u, shock, pops, with_diag=True),
                   kernels.fused_pk_post_plain(u, shock, pops,
                                               with_diag=True))],
             0.0, bitwise=True)
        candk = cand(kernels.fused_mood_candidate)
        fold(results, "fused_mood_check_p4", tag,
             [pair for uc, dg, lm in ((u_c, c1["deg0"], c1["lim0"]),
                                      (candk, deg1, c1["lim1"]))
              for pair in zip(
                  kernels.fused_mood_check(uc, c1["bmin"], c1["bmax"], dg,
                                           lm, cops),
                  kernels.fused_mood_check_plain(uc, c1["bmin"],
                                                 c1["bmax"], dg, lm, cops))],
             0.0, bitwise=True)
        print(f"[{tag}] P4 DMR MOOD state after {MD_PLAIN_STEPS} plain "
              f"steps: t={t!r}; a plain stage: n_reduce="
              f"{int(st_plain.n_reduce)}, n_marked={int(st_plain.n_marked)}"
              f", passes={st_plain.iters}; pass 1 reduces "
              f"{int(c1['chg1'].sum())} cells, the candidate's set "
              f"{c1['data']['cells']} cells")
        u_prev = u_c.clone()
        bmin, bmax, deg0, lim0 = (c1["bmin"], c1["bmax"], c1["deg0"],
                                  c1["lim0"])
        timings = {
            "fused_mood_candidate_p4": (
                lambda: kernels.fused_mood_candidate(
                    u, u_prev, deg1, aff, *tp_strips, rops, mops, h),
                lambda: kernels.fused_mood_candidate_plain(
                    u, u_prev, deg1, aff, *tp_strips, rops, mops, h)),
            "fused_modal_pos_p4": (
                lambda: kernels.fused_modal_pos(u, mops),
                lambda: kernels.fused_modal_pos_plain(u, mops)),
            "fused_pk_post_p4": (
                lambda: kernels.fused_pk_post(u, shock, pops,
                                              with_diag=True),
                lambda: kernels.fused_pk_post_plain(u, shock, pops,
                                                    with_diag=True)),
            "fused_mood_check_p4": (
                lambda: kernels.fused_mood_check(u_c, bmin, bmax, deg0, lim0,
                                                 cops),
                lambda: kernels.fused_mood_check_plain(u_c, bmin, bmax, deg0,
                                                       lim0, cops)),
        }
        for name, (fk, fp) in timings.items():
            time_pair(results, name, tag, fk, fp, (NX, NY))
        # the path's other kernel: pass 1's forward Euler u + dt*R of the
        # P4 hllc residual on the general dims (row 2, ported in PR 10)
        strips = c1["strips"]
        results[f"mood_p4_step_ms_{tag}"] = time_ms(
            lambda: kernels.fused_residual(u, *strips, rops, dt=h))
        results[f"mood_p4_step_bound_ms_{tag}"], by = bound(
            "fused_residual_pk", s.basis, dtype, NX * NY)
        print(f"[{tag}] fused_residual[pk_hllc_step] P4: kernel "
              f"{results[f'mood_p4_step_ms_{tag}']:.4f} ms at {NX}x{NY}, "
              f"bound {results[f'mood_p4_step_bound_ms_{tag}']:.4f} ms "
              f"({by})")
        del s, u, c1, u_c, u_prev, candk, tp_strips, strips
        torch.cuda.empty_cache()


def phase_mood_path(kernels, plain_calls, name, metric, s, u, steps, forms,
                    checks=None):
    """Phase 28: a MOOD path through Solver._multi_step(steps) after
    post_stage and a 2-step warm-up, f32, on the card: finite, no fatal
    flag, no plain version called, each of `forms` launched;
    checks: a counter of stab/mood.check_update calls (the plain check,
    P1's), printed per step; returns launch counts, ms/step and (solver,
    state) for the trace."""
    u = s.post_stage(u)
    s._multi_step(2)(u, 0.0, 1.0e3)                # warm-up
    multi = s._multi_step(steps)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    n_check = checks["n"] if checks is not None else 0
    syncs0 = s.host_syncs
    t0 = time.perf_counter()
    u1, t1, n, bad, stats = multi(u, 0.0, 1.0e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n, bad, finite = int(n), bool(bad), bool(torch.isfinite(u1).all())
    used = {k: v for k, v in counts.items() if v}
    print(f"{name} {NX}x{NY}: {n} steps to t={float(t1)!r}, bad={bad}, "
          f"finite={finite}, launches={used}, plain calls="
          f"{plain_calls['n']}")
    assert n == steps and not bad and finite and u1.is_cuda
    assert all(counts.get(f, 0) > 0 for f in forms), (forms, used)
    assert plain_calls["n"] == 0, f"{name} called a plain version"
    ms = 1e3 * wall / steps
    line = {metric: 4 * s.basis.K * NX * NY * steps / wall,
            "unit": "DoF-updates/s", "dtype": "float32", "grid": [NX, NY],
            "steps": steps, "ms_per_step": ms, "t": float(t1),
            **mood_summary(s, counts, stats, s.host_syncs - syncs0, steps),
            "launches_per_step": {k: v / steps for k, v in used.items()},
            "plain_calls": plain_calls["n"], "card": card_line()}
    if checks is not None:
        line["plain_checks_per_step"] = (checks["n"] - n_check) / steps
    print(json.dumps(line))
    return counts, ms, (s, u1)


def phase_mood_degree_paths(entry, kernels, plain_calls):
    """Phase 28: the P4 DMR MOOD path (entry._build(1152, 288, float32,
    cuda, "mood", degree=4), MD_P4_STEPS steps: rows 3, 8, 9 and 10
    launched, no plain call), the P1 one (MD_P1_STEPS steps: rows 3, 8 and
    9 launched, the check the plain stab/mood.check_update with the u2 test
    off and no other plain call), and examples/sod_mood.prm at degree 1 and
    4 as shipped, CONFIG_STEPS steps through cli.run (launches, no plain
    call) and through `python -m dflo_tpu_torch` in a subprocess; returns
    {path: launch counts}, the P4 path's ms/step and (solver, state) for
    the trace."""
    from dflo_tpu_torch.stab import mood as mood_mod
    out = {}
    rows = ("fused_residual[pk_hllc_step]", "fused_pk_post",
            "fused_mood_candidate[hllc]", "fused_modal_pos",
            "fused_mood_check")
    s, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda",
                         method="mood", degree=4)
    assert s._mood_stage.sparse and s._mood_stage.cops is not None
    out["dmr_p4_mood"], ms_p4, p4 = phase_mood_path(
        kernels, plain_calls, "dmr_p4_mood",
        "dmr_p4_mood_dof_updates_per_sec", s, u0, MD_P4_STEPS, rows)
    del s, u0
    s, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda",
                         method="mood", degree=1)
    assert s._mood_stage.cops is None
    checks = {"n": 0}
    plain_check = mood_mod.check_update

    def counted(*a, **k):
        checks["n"] += 1
        return plain_check(*a, **k)
    mood_mod.check_update = counted
    try:
        out["dmr_p1_mood"], _, _ = phase_mood_path(
            kernels, plain_calls, "dmr_p1_mood",
            "dmr_p1_mood_dof_updates_per_sec", s, u0, MD_P1_STEPS, rows[:2],
            checks)
    finally:
        mood_mod.check_update = plain_check
    # on P1 no degree can drop: every cascade ends after pass 1, as the
    # reference's (dflo_tpu/stab/mood.py:357-361), so neither the
    # candidate nor the modal positivity runs, and the check is the plain
    # one
    c1 = out["dmr_p1_mood"]
    assert c1["fused_mood_check"] == c1["fused_mood_candidate"] == \
        c1["fused_modal_pos"] == 0 and checks["n"] > 0
    del s, u0
    for p in (1, 4):
        edits = (("set degree = 2", f"set degree = {p}"),)
        out[f"sod_mood_p{p}"], _, _ = phase_main_pk(
            kernels, plain_calls, f"sod_mood_p{p}",
            f"sod_p{p}_mood_dof_updates_per_sec", SOD_MOOD_PRM, SOD_GRID,
            edits, CONFIG_STEPS, CONFIG_CHUNK,
            ("fused_residual[pk_lxf_step]", "fused_pk_post", "fused_diag")
            + (("fused_mood_candidate[lxf]", "fused_modal_pos",
                "fused_mood_check") if p > 1 else ()))
        with tempfile.TemporaryDirectory() as tmp:
            prm = edit_prm(SOD_MOOD_PRM, os.path.join(tmp, "sod.prm"),
                           *SOD_GRID, *edits)
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "dflo_tpu_torch", prm, "--max-steps",
                 str(CONFIG_STEPS), "--chunk", str(CONFIG_CHUNK),
                 "--output-dir", tmp], capture_output=True, text=True,
                timeout=600)
            written = sorted(f for f in os.listdir(tmp) if f.endswith(".vtu"))
        print(f"python -m dflo_tpu_torch sod_mood.prm (degree = {p}): rc "
              f"{r.returncode} in {time.perf_counter() - t0:.1f} s, "
              f"{len(written)} snapshots; last line: "
              f"{(r.stdout.strip().splitlines() or [''])[-1][:200]}")
        assert r.returncode == 0 and written, r.stderr[-2000:]
    torch.cuda.empty_cache()
    return out, ms_p4, p4


#: the tile post's and the modal positivity's coverage grids (phase 29):
#: (nx, ny), cut against every tile and smaller than one; each degree also
#: runs the grid one cell past its own tile on both axes
TP_GRIDS = ((1, 1), (3, 2), (2, 37), (40, 1), (37, 11), (96, 40))
#: the post's forms there: (per_x, per_y, indicator, char_lim, pos_lim,
#: masked)
TP_FORMS = ((False, False, "density", True, True, False),
            (True, False, "energy", False, True, False),
            (False, True, "limiter", True, True, False),
            (True, True, "density", False, False, False),
            (True, True, "limiter", True, True, False),
            (False, False, "density", True, True, True),
            (True, True, "energy", True, True, True))


def tile_edge_mask(nx: int, ny: int):
    """Fluid flags with solid cells on the domain's four edges and on the
    tiles' edges (columns 7, 8, 15, 16 and rows 3, 4, 7, 8, 15, 16)."""
    import numpy as np
    m = np.ones((ny, nx), bool)
    m[::3, 0] = m[1::4, -1] = False
    m[0, 1::5] = m[-1, ::4] = False
    for x in (7, 8, 15, 16):
        if x < nx:
            m[1::2, x] = False
    for y in (3, 4, 7, 8, 15, 16):
        if y < ny:
            m[y, 2::3] = False
    return m


def tp_state(family: str, p: int, nx: int, ny: int, dtype, seed: int,
             scale: float = 0.3):
    """(mesh, state) of a phase-29 case: the DMR IC on the 4 x 1 box with
    `scale` relative noise on every DoF (numpy seed), so the limiter marks
    cells and positivity moves some."""
    import numpy as np
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.entry import dmr_ic
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.ops.basis import make_basis
    mesh = CartesianMesh(nx, ny, 0.0, 4.0, 0.0, 1.0)
    u = ic.set_initial_condition(make_basis(family, p), mesh, dmr_ic,
                                 dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(seed)
    u = u * torch.from_numpy(1.0 + scale * rng.uniform(-1.0, 1.0, u.shape))
    return mesh, u.to(dtype=dtype, device="cuda").contiguous()


def phase_tile_post_kernels(kernels, results):
    """Phase 29 for both dtypes: the tile post (row 4), its block form (row
    5) and the tile modal positivity (row 8) against their plain versions,
    bitwise (NaN where the plain version has NaN), with and without diag.
    The post at Q1-Q6 on TP_GRIDS and the grid one cell past its tile, in
    TP_FORMS (periodic x, y and both; the three indicators; char_lim on and
    off; pos_lim off; masked with solid cells on tile and domain edges), a
    NaN cell reaching lam_max and the fatal flag; the block form on a (2, 2)
    virtual mesh of ragged blocks, periodic on neither, one and both axes
    (each halo line present and absent), equal to its plain block form and
    the sharded post equal to the single-device post; the modal positivity
    at P1-P6 on the same grids with and without a degree map holding every
    degree 0..p."""
    import numpy as np
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.parallel import (exchange_halos, gather_state,
                                         shard_state)
    from dflo_tpu_torch.stab.positivity import EPS
    dm = virtual_mesh()
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        n_cases = 0

        def note(key, pairs):
            nonlocal n_cases
            torch.cuda.synchronize()
            assert all(same(k, q) for k, q in pairs), \
                f"{key} {tag} is not bitwise"
            n_cases += 1

        for p in range(1, 7):
            basis = make_basis("Qk", p)
            ty, tx = kernels.post_tile(p, False, dtype)
            for gi, (nx, ny) in enumerate(TP_GRIDS + ((tx + 1, ty + 1),)):
                mesh, u = tp_state("Qk", p, nx, ny, dtype, 10 * p + gi)
                for per_x, per_y, ind, char, pos, masked in TP_FORMS:
                    po = kernels.post_operators(
                        basis, mesh, indicator=ind, beta=2.0, char_lim=char,
                        pos_lim=pos, per_x=per_x, per_y=per_y,
                        mask=tile_edge_mask(nx, ny) if masked else None,
                        dtype=dtype, device="cuda")
                    note(f"post Q{p} {nx}x{ny} {per_x}{per_y} {ind} {char} "
                         f"{pos} {masked}",
                         [(kernels.fused_post(u, po),
                           kernels.fused_post_plain(u, po)),
                          *zip(kernels.fused_post(u, po, with_diag=True),
                               kernels.fused_post_plain(u, po,
                                                        with_diag=True))])
            # a NaN cell reaches lam_max and the fatal flag, alike
            mesh, u = tp_state("Qk", p, 37, 11, dtype, 90 + p)
            u[:, :, 5, 17] = float("nan")
            po = kernels.post_operators(basis, mesh, indicator="density",
                                        beta=2.0, char_lim=True, dtype=dtype,
                                        device="cuda")
            k = kernels.fused_post(u, po, with_diag=True)
            note(f"post Q{p} NaN cell",
                 zip(k, kernels.fused_post_plain(u, po, with_diag=True)))
            assert bool(k[1].isnan()) and bool(~(k[2] >= EPS))
            # the block form: four ragged blocks, periodic on neither, one
            # and both axes (each halo line present and absent)
            for nx, ny in ((34, 18), (6, 4), (2, 2)):
                mesh, u = tp_state("Qk", p, nx, ny, dtype, 70 + p)
                for per_x, per_y in ((False, False), (True, False),
                                     (False, True), (True, True)):
                    po = kernels.post_operators(
                        basis, mesh, indicator="density", beta=2.0,
                        char_lim=True, per_x=per_x, per_y=per_y, dtype=dtype,
                        device="cuda")
                    blocks = shard_state(u, dm)
                    halos = exchange_halos(blocks, dm, per_x, per_y)
                    note(f"block post Q{p} {nx}x{ny} {per_x}{per_y}", [
                        pair for b, h in zip(blocks, halos)
                        for pair in zip(
                            kernels.fused_post(b, po, True, halos=h),
                            kernels.fused_post_plain(b, po, True,
                                                     halos=h))])
                    ks, lam, mq = kernels.fused_post_sharded(
                        blocks, [po] * 4, dm, True)
                    note(f"sharded post Q{p} {nx}x{ny} {per_x}{per_y}",
                         zip((gather_state(ks, dm), lam, mq),
                             kernels.fused_post(u, po, with_diag=True)))
        for p in range(1, 7):
            basis = make_basis("Pk", p)
            ty, tx = kernels.post_tile(p, True, dtype)
            for gi, (nx, ny) in enumerate(TP_GRIDS + ((tx + 1, ty + 1),)):
                mesh, u = tp_state("Pk", p, nx, ny, dtype, 100 + 10 * p + gi)
                mops = kernels.modal_operators(basis, mesh, dtype=dtype,
                                               device="cuda")
                rng = np.random.default_rng(p + gi)
                deg = rng.integers(0, p + 1, (ny, nx), dtype=np.int32)
                deg.flat[:min(p + 1, deg.size)] = np.arange(p + 1)[:deg.size]
                deg = torch.from_numpy(deg).to("cuda")
                note(f"modal_pos P{p} {nx}x{ny}", [
                    pair for d in (None, deg)
                    for pair in [(kernels.fused_modal_pos(u, mops, d),
                                  kernels.fused_modal_pos_plain(u, mops, d)),
                                 *zip(kernels.fused_modal_pos(
                                     u, mops, d, with_diag=True),
                                     kernels.fused_modal_pos_plain(
                                         u, mops, d, with_diag=True))]])
        out[tag] = n_cases
        print(f"[{tag}] tile post and modal positivity: {n_cases} cases "
              f"bitwise (rows 4, 5 and 8; every form, Q1-Q6 / P1-P6)")
    results["tile_post_cases"] = out


#: the check's coverage grids (phase 30): phase 29's, and rows a 16-byte
#: vector of every plane (256) and of the float planes alone (260); each
#: dtype also runs the grid one cell past its tile on both axes
CK_GRIDS = TP_GRIDS + ((256, 20), (260, 35))
PER_AXES = ((False, False), (True, False), (False, True), (True, True))


def edge_marks(nx: int, ny: int, seed: int, density: float = 0.5):
    """A random bool plane (numpy seed) set on the domain's four edges and
    on the tiles' edges (columns 7, 8, 15, 16, 127, 128 and rows 3, 4, 7,
    8, 15, 16)."""
    import numpy as np
    m = np.random.default_rng(seed).uniform(size=(ny, nx)) < density
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = True
    m[:, [x for x in (7, 8, 15, 16, 127, 128) if x < nx]] = True
    m[[y for y in (3, 4, 7, 8, 15, 16) if y < ny], :] = True
    return m


def check_inputs(u, p: int, nx: int, ny: int, seed: int):
    """(candidate, deg, lim) of a phase-30 check case: the candidate with
    1e-4 relative noise on the means (DMP fails at most local extrema) and
    its higher modes 1 % of the mean in random signs (the u2 test fails in
    most cells), degree 1 and 70 % marked on the edge_marks cells."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cand = u * torch.from_numpy(1.0 + 1e-4 * rng.uniform(-1.0, 1.0, u.shape)
                                ).to(u)
    cand[:, 1:] += 0.01 * cand[:, :1] * torch.from_numpy(
        rng.uniform(-1.0, 1.0, cand[:, 1:].shape)).to(u)
    edges = edge_marks(nx, ny, seed + 1, density=0.3)
    deg = np.where(edges, 1, rng.integers(1, p + 1, (ny, nx))).astype(np.int32)
    lim = edges & (rng.uniform(size=(ny, nx)) < 0.7)
    return (cand.contiguous(), torch.from_numpy(deg).to("cuda"),
            torch.from_numpy(lim).to("cuda"))


def phase_tile_pk_check_kernels(kernels, results):
    """Phase 30 for both dtypes: the tile Pk post (row 9) and the wide-tile
    check (row 10) against their plain versions, bitwise (NaN where the
    plain version has NaN).  The Pk post at P1-P6 with and without diag on
    TP_GRIDS and the grid one cell past its tile, periodic on neither, one
    or both axes (char_lim off where only x is, a TVB M where only y is),
    the marked cells on tile and domain edges and half the others; a NaN
    cell reaching lam_max.  The check at p 2-6 on CK_GRIDS and one cell
    past its tile, periodic on neither, one or both axes, degree-1 marked
    cells on tile and domain edges (spreads across tile borders and wrap);
    some cells change."""
    import numpy as np
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.stab import mood as mood_mod
    from dflo_tpu_torch.stab.positivity import EPS
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        n_cases, changed = 0, 0

        def note(key, pairs):
            nonlocal n_cases
            torch.cuda.synchronize()
            assert all(same(k, q) for k, q in pairs), \
                f"{key} {tag} is not bitwise"
            n_cases += 1

        for p in range(1, 7):
            basis = make_basis("Pk", p)
            ty, tx = kernels.pk_post_tile(p, dtype)
            for gi, (nx, ny) in enumerate(TP_GRIDS + ((tx + 1, ty + 1),)):
                mesh, u = tp_state("Pk", p, nx, ny, dtype, 200 + 10 * p + gi)
                shock = torch.from_numpy(np.where(
                    edge_marks(nx, ny, p + gi), 2.0, 0.0)).to(
                        dtype=dtype, device="cuda")
                for per in PER_AXES:
                    po = kernels.pk_post_operators(
                        basis, mesh, M=10.0 if per == (False, True) else 0.0,
                        beta=2.0, char_lim=per != (True, False),
                        per_x=per[0], per_y=per[1], dtype=dtype,
                        device="cuda")
                    note(f"pk_post P{p} {nx}x{ny} {per}", [
                        (kernels.fused_pk_post(u, shock, po),
                         kernels.fused_pk_post_plain(u, shock, po)),
                        *zip(kernels.fused_pk_post(u, shock, po,
                                                   with_diag=True),
                             kernels.fused_pk_post_plain(u, shock, po,
                                                         with_diag=True))])
            # a NaN cell reaches lam_max and the fatal flag, alike
            mesh, u = tp_state("Pk", p, 37, 11, dtype, 290 + p)
            u[:, :, 5, 17] = float("nan")
            po = kernels.pk_post_operators(basis, mesh, beta=2.0,
                                           char_lim=True, dtype=dtype,
                                           device="cuda")
            shock = torch.full((11, 37), 2.0, dtype=dtype, device="cuda")
            k = kernels.fused_pk_post(u, shock, po, with_diag=True)
            note(f"pk_post P{p} NaN cell", zip(k, kernels.fused_pk_post_plain(
                u, shock, po, with_diag=True)))
            assert bool(k[1].isnan()) and bool(~(k[2] >= EPS))
        for p in range(2, 7):
            basis = make_basis("Pk", p)
            ty, tx = kernels.check_tile(dtype)
            for gi, (nx, ny) in enumerate(CK_GRIDS + ((tx + 1, ty + 1),)):
                mesh, u = tp_state("Pk", p, nx, ny, dtype, 400 + 10 * p + gi)
                cand, deg, lim = check_inputs(u, p, nx, ny, 7 * p + gi)
                for per in PER_AXES:
                    ops = kernels.mood_check_operators(
                        basis, mesh, per_x=per[0], per_y=per[1],
                        device="cuda")
                    rho0 = ops.avg0 * u[euler.RHO, 0]
                    bmin = mood_mod.neighborhood_min(rho0, ops.valid)
                    bmax = mood_mod.neighborhood_max(rho0, ops.valid)
                    k = kernels.fused_mood_check(cand, bmin, bmax, deg, lim,
                                                 ops)
                    note(f"check P{p} {nx}x{ny} {per}", zip(
                        k, kernels.fused_mood_check_plain(cand, bmin, bmax,
                                                          deg, lim, ops)))
                    changed += int(k[2].sum())
        assert changed > 0, f"{tag}: no check case changed a degree"
        out[tag] = n_cases
        print(f"[{tag}] tile Pk post and check: {n_cases} cases bitwise "
              f"(rows 9 and 10; P1-P6 / p 2-6), {changed} degrees dropped")
    results["tile_pk_check_cases"] = out


#: the diag's and the volume residual's coverage grids (phase 31): rows a
#: 16-byte vector of cells covers (nx % 4 == 0) and rows it does not, odd
#: row counts, grids smaller than one run or tile, and one of 64 tiles
DV_GRIDS = ((96, 20), (33, 17), (130, 9), (5, 3), (1, 1), (256, 64))
#: the diag's bases there: (family, degree, nq or None)
DV_DIAG_BASES = (*(("Pk", p, None) for p in range(1, 7)),
                 *(("Qk", p, None) for p in range(1, 7)),
                 *(("Qk_gll", p, None) for p in range(1, 7)),
                 ("Pk", 2, 4), ("Pk", 6, 8), ("Qk", 2, 4), ("Qk_gll", 5, 7))


def phase_diag_volume_kernels(kernels, results):
    """Phase 31 for both dtypes: the diag (row 6) over DV_DIAG_BASES (the
    Pk mode-0 mean, the nodal full row, over-integrated bases) on
    DV_GRIDS, masked (a quarter of the cells solid) and not, and on a state
    4 bytes past a 16-byte boundary (the element loads); the sharded diag
    (row 7) on a (2, 2) virtual mesh at P2, Q2 and Q4; the volume residual
    (row 1) at Q1-Q6 and GLL1-GLL6 on DV_GRIDS; the diag also on a workspace
    of 3 blocks (the grid-stride loop's later rounds); all bitwise (NaN
    where the plain version has NaN), one launch a call."""
    import dataclasses

    import numpy as np
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.parallel import shard_state
    from dflo_tpu_torch.solver.spatial import make_rhs
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        n_cases = 0

        def note(key, pairs):
            nonlocal n_cases
            pairs = list(pairs)
            torch.cuda.synchronize()
            assert all(same(k, q) for k, q in pairs), f"{key} {tag}"
            n_cases += 1

        for fam, p, nq in DV_DIAG_BASES:
            basis = make_basis(fam, p, nq)
            for gi, (nx, ny) in enumerate(DV_GRIDS):
                mesh, u = tp_state(fam, p, nx, ny, dtype, 800 + 10 * p + gi)
                rng = np.random.default_rng(p + gi)
                for mask in (None, rng.uniform(size=(ny, nx)) > 0.25):
                    ops = kernels.diag_operators(basis, mesh, mask=mask,
                                                 dtype=dtype, device="cuda")
                    # and on a workspace of 3 blocks: the grid-stride
                    # loop's later rounds
                    narrow = dataclasses.replace(
                        ops, part=ops.part[:6].clone(),
                        ticket=torch.zeros_like(ops.ticket))
                    for o in (ops, narrow):
                        n0 = kernels.fused_diag.launches
                        note(f"diag {fam}{p} nq{basis.nq} {nx}x{ny}",
                             zip(kernels.fused_diag(u, o),
                                 kernels.fused_diag_plain(u, o)))
                        assert kernels.fused_diag.launches == n0 + 1
                        assert int(o.ticket) == 0
                buf = torch.empty(u.numel() + 1, dtype=dtype, device="cuda")
                off = buf[1:].view(u.shape)
                off.copy_(u)
                note(f"diag {fam}{p} {nx}x{ny} unaligned",
                     zip(kernels.fused_diag(off, ops),
                         kernels.fused_diag_plain(u, ops)))
                del u, buf, off
        dm = virtual_mesh()
        for fam, p in (("Pk", 2), ("Qk", 2), ("Qk", 4)):
            basis = make_basis(fam, p)
            mesh, u = tp_state(fam, p, 256, 64, dtype, 880 + p)
            blocks = shard_state(u, dm)
            bops = [kernels.diag_operators(basis, mesh, dtype=dtype,
                                           device="cuda") for _ in blocks]
            got = kernels.fused_diag_sharded(blocks, bops, dm)
            note(f"sharded diag {fam}{p}", zip(got, kernels.fused_diag(
                u, kernels.diag_operators(basis, mesh, dtype=dtype,
                                          device="cuda"))))
            note(f"sharded diag {fam}{p} plain", zip(
                got, kernels.fused_diag_sharded_plain(blocks, bops, dm)))
            del u, blocks
        for fam in ("Qk", "Qk_gll"):
            for p in range(1, 7):
                basis = make_basis(fam, p)
                for gi, (nx, ny) in enumerate(DV_GRIDS):
                    mesh, u = tp_state(fam, p, nx, ny, dtype,
                                       900 + 10 * p + gi, scale=0.05)
                    L = make_rhs(basis, mesh, bump_bcs(), dtype=dtype,
                                 device="cuda",
                                 volume_kernel="pallas").lift_stack
                    n0 = kernels.volume_residual.launches
                    note(f"volume {fam}{p} {nx}x{ny}",
                         [(kernels.volume_residual(L, u),
                           kernels.volume_residual_plain(L, u))])
                    assert kernels.volume_residual.launches == n0 + 1
                    del u
        torch.cuda.empty_cache()
        out[tag] = n_cases
        print(f"[{tag}] diag and volume residual: {n_cases} cases bitwise "
              f"(rows 6, 7 and 1)")
    results["diag_volume_cases"] = out


def geo_dmr_files(out: str) -> str:
    """The DMR as its own input describes it, written to out: a .geo of two
    transfinite blocks, NX x NY cells with the bottom split at x = 1/6
    (entry.dmr_geo_text), and its .prm (entry.dmr_geo_prm: the boundary
    conditions of tests/test_masked_domain.py:66-110 as expressions,
    mapping cartesian, Q2, hllc, TVB beta 1 with the `limiter` indicator,
    positivity, cfl 0.4); returns the .prm's path."""
    from dflo_tpu_torch import entry
    with open(os.path.join(out, "dmr.geo"), "w") as f:
        f.write(entry.dmr_geo_text(GEO_NL, NX - GEO_NL, NY))
    prm = os.path.join(out, "dmr_geo.prm")
    with open(prm, "w") as f:
        f.write(entry.dmr_geo_prm("dmr.geo"))
    return prm


def phase_geo_dmr(kernels, plain_calls, results):
    """Phase 32 (path A): the DMR from a .geo file through cli.run at
    NX x NY in f32, GEO_STEPS steps in chunks of GEO_CHUNK: the residual
    (with the segmented bottom's strips), the post and the diag launched,
    no plain version called, no fatal flag, finite; then the CLI's solver
    timed apart from output (dmr_geo_q2_rk_tvb_dof_updates_per_sec).  The
    same domain through write_msh and the native load_msh gives the same
    arrays.  One full-width SSP stage with the segmented strips against
    its plain version, f32 and f64, bitwise, timed.  Returns (launch
    counts, ms/step, summary)."""
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.config.params import AllParameters
    from dflo_tpu_torch.mesh import geo, msh
    from dflo_tpu_torch.solver.spatial import SegmentedSide, make_rhs
    with tempfile.TemporaryDirectory() as out:
        prm = geo_dmr_files(out)
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        t0 = time.perf_counter()
        res = cli.run([prm, "--max-steps", str(GEO_STEPS), "--chunk",
                       str(GEO_CHUNK), "--output-dir", out])
        torch.cuda.synchronize()
        wall_cli = time.perf_counter() - t0
        counts = kernels.launch_counts()
        plain = plain_calls["n"]
        s = res.solver
        finite = bool(torch.isfinite(res.u).all())
        used = {k: v for k, v in counts.items() if v}
        print(f"dmr .geo CLI {NX}x{NY}: {res.it} steps to t={res.t!r} in "
              f"{wall_cli:.2f} s with set-up and output, finite={finite}, "
              f"launches={used}, plain calls={plain}")
        assert res.it == GEO_STEPS and finite
        assert res.u.dtype == torch.float32 and res.u.is_cuda
        assert (s.mesh.nx, s.mesh.ny, s.mask) == (NX, NY, None)
        assert isinstance(s.bcs["S"], SegmentedSide)
        assert all(counts[k] > 0 for k in ("fused_residual", "fused_post",
                                           "fused_diag")), counts
        assert counts["fused_residual[qk_hllc_stage]"] == 3 * GEO_STEPS
        assert plain == 0, "the .geo DMR called a plain version"

        # the same domain as a .msh, read back by the native reader
        dom = geo.load_geo(os.path.join(out, "dmr.geo"))
        path = os.path.join(out, "dmr.msh")
        t0 = time.perf_counter()
        msh.write_msh(path, dom.mesh, dom.side_bids, dom.mask)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = msh.load_msh(path)
        t_read = time.perf_counter() - t0
        same_msh = (back.mesh == dom.mesh and back.mask is None
                    and dom.mask is None
                    and all(bool((back.side_bids[k] == dom.side_bids[k])
                                 .all()) for k in "WESN"))
        print(f"dmr .msh round trip: write_msh {t_write:.2f} s, native "
              f"load_msh {t_read:.2f} s ({os.path.getsize(path)} B), "
              f"identical arrays {same_msh}")
        assert same_msh

        # the CLI's solver timed apart from output
        multi = s._multi_step(GEO_CHUNK)
        multi(res.u, res.t, 1e3)                   # warm-up
        torch.cuda.synchronize()
        u, t, n, bad = res.u, res.t, 0, False
        t0 = time.perf_counter()
        for _ in range(GEO_STEPS // GEO_CHUNK):
            u, t, nd, bad_c, _ = multi(u, t, 1e3)
            n, bad = n + nd, bad | bad_c
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, bad = int(n), bool(bad)
        assert n == GEO_STEPS and not bad and bool(torch.isfinite(u).all())
        ms = 1e3 * wall / GEO_STEPS
        rows = {"fused_residual": "row 2", "fused_post": "row 4",
                "fused_diag": "row 6"}
        summary = {"dmr_geo_q2_rk_tvb_dof_updates_per_sec":
                   4 * s.basis.K * NX * NY * GEO_STEPS / wall,
                   "unit": "DoF-updates/s", "dtype": "float32",
                   "grid": [NX, NY], "steps": GEO_STEPS, "chunk": GEO_CHUNK,
                   "ms_per_step": ms, "cli_wall_s": wall_cli,
                   "launches_per_step": {f"{k} ({r})": counts[k] / GEO_STEPS
                                         for k, r in rows.items()},
                   "plain_calls": plain,
                   "msh_round_trip_s": [t_write, t_read],
                   "card": card_line()}
        print(json.dumps(summary))

        # one full-width stage with the segmented strips, bitwise
        params = AllParameters.from_prm_file(prm)
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            sd, _ = cli.build_solver(params, out, dtype=dtype, device="cuda")
            ud = sd.post_stage(u.to(dtype))
            u_old = sd.post_stage(cli.set_ic(params, sd))
            tt = torch.full((), float(t), dtype=dtype, device="cuda")
            strips = sd.rhs.strips(ud, tt)
            whole = dict(sd.bcs, S=sd.bcs["S"].segments[1])
            slip = make_rhs(sd.basis, sd.mesh, whole, flux="hllc",
                            dtype=dtype, device="cuda",
                            volume_kernel="fused").strips(ud, tt)
            assert not torch.equal(strips[2], slip[2])
            lam, _ = sd._diag(ud)
            sc = torch.stack([torch.full((), 0.75, dtype=dtype,
                                         device="cuda"),
                              0.4 / lam / 5.0])

            def fk(ud=ud, strips=strips, sd=sd, u_old=u_old, sc=sc):
                return kernels.fused_residual(ud, *strips, sd.rhs.ops,
                                              u_old=u_old, sc=sc)

            def fp(ud=ud, strips=strips, sd=sd, u_old=u_old, sc=sc):
                return kernels.fused_residual_plain(ud, *strips, sd.rhs.ops,
                                                    u_old=u_old, sc=sc)

            fold(results, "fused_residual_geo", tag, [(fk(), fp())],
                 TOL[dtype]["fused_residual"], bitwise=True)
            time_pair(results, "fused_residual_geo", tag, fk, fp, (NX, NY))
            del sd, ud, u_old, strips
        torch.cuda.empty_cache()
    return counts, ms, summary


def phase_annulus(kernels, plain_calls):
    """Phase 33 (path B): the curvilinear block that fills the card, the
    annulus of scripts/naca_bench.py:130-146 (r 1 to 3, 320 x 1536 cells),
    Q2, hllc, periodic W/E, slip S, farfield N, the naca0012 free stream
    (M 0.63 at 2 degrees), cfl 0.4, f32, ANN_STEPS steps in chunks of
    ANN_CHUNK through Solver._multi_step after a warm-up: limiter none with
    positivity on (minmax on a q1 block waits for slice E); the path is
    plain torch, as the reference's is XLA, so no kernel is launched and no
    plain version called; annulus_q2_curvi_rk_dof_updates_per_sec and
    ms/step.  Then the f64 free stream on a wavy unit square of WAVY_N x
    WAVY_N cells (Q2, hllc, farfield sides): max |R| * h below WAVY_FS_TOL,
    h = 1/WAVY_N.  Returns (ms/step, (solver, state) for the trace,
    summary)."""
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    from dflo_tpu_torch.mesh.curvilinear import annulus_mesh, wavy_mesh
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.solver.spatial import BoundarySide
    from dflo_tpu_torch.solver.spatial_curvi import make_rhs_curvilinear

    def freestream(x, y, t=0.0):
        return torch.stack([torch.full_like(x, v) for v in NACA_FS])

    r_in, r_out, n_r, n_th = ANN
    mesh = annulus_mesh(r_in, r_out, n_r, n_th)
    basis = make_basis("Qk", 2)
    per = BoundarySide(euler.BC_PERIODIC)
    far = BoundarySide(euler.BC_FARFIELD, freestream)
    bcs = dict(W=per, E=per, S=BoundarySide(euler.BC_SLIP), N=far)
    t0 = time.perf_counter()
    s = Solver(basis, mesh, bcs, flux="hllc", limiter=LimiterConfig(
        pos_lim=True), cfl=0.4, dtype=torch.float32, device="cuda")
    u = s.post_stage(ic.set_initial_condition(
        basis, mesh, freestream, dtype=torch.float32, device="cuda"))
    setup_s = time.perf_counter() - t0
    multi = s._multi_step(ANN_CHUNK)
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    u, t, _, _, _ = multi(u, 0.0, 1e3)             # warm-up
    torch.cuda.synchronize()
    n, bad = 0, False
    t0 = time.perf_counter()
    for _ in range(ANN_STEPS // ANN_CHUNK):
        u, t, nd, bad_c, _ = multi(u, t, 1e3)
        n, bad = n + nd, bad | bad_c
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n, bad = int(n), bool(bad)
    finite = bool(torch.isfinite(u).all())
    print(f"annulus {n_th}x{n_r} Q2: {n} steps to t={float(t)!r}, "
          f"finite={finite}, fatal flag {bad}, launches="
          f"{ {k: v for k, v in counts.items() if v} }, plain calls="
          f"{plain_calls['n']}")
    assert n == ANN_STEPS and not bad and finite
    assert s.curvilinear and not any(counts.values()), counts
    assert plain_calls["n"] == 0
    ms = 1e3 * wall / ANN_STEPS

    # the f64 free stream on a wavy block (the discrete metric identities):
    # du/dt is the round-off of a cell's face fluxes over its size h, so
    # max |R| * h is what the reference's 1e-12 bounds at its cells of 0.2 x
    # 0.125 (tests/test_curvilinear.py:32-43)
    h = 1.0 / WAVY_N
    wmesh = wavy_mesh(WAVY_N, WAVY_N, 0.0, 1.0, 0.0, 1.0, amp=0.05)
    rhs = make_rhs_curvilinear(basis, wmesh, dict(W=far, E=far, S=far, N=far),
                               flux="hllc", dtype=torch.float64,
                               device="cuda")
    uw = ic.set_initial_condition(basis, wmesh, freestream,
                                  dtype=torch.float64, device="cuda")
    fs = float(rhs(uw, 0.0).abs().max())
    del rhs, uw
    torch.cuda.empty_cache()
    summary = {"annulus_q2_curvi_rk_dof_updates_per_sec":
               4 * basis.K * n_r * n_th * ANN_STEPS / wall,
               "unit": "DoF-updates/s", "dtype": "float32",
               "grid": [n_th, n_r], "steps": ANN_STEPS, "chunk": ANN_CHUNK,
               "ms_per_step": ms, "setup_s": setup_s,
               "limiter": "none, positivity on (minmax on a q1 block waits "
                          "for slice E)",
               "wavy_f64_free_stream_max_abs_R": fs,
               "wavy_f64_free_stream_max_abs_R_times_h": fs * h,
               "wavy_grid": [WAVY_N, WAVY_N], "card": card_line()}
    print(json.dumps(summary))
    assert fs * h < WAVY_FS_TOL, f"wavy free stream max|R| {fs!r}, h {h!r}"
    return ms, (s, u), summary


def phase_naca_steady(kernels, plain_calls):
    """Phase 34 (path C): the naca0012 steady workflow through cli.run with
    examples/naca0012.prm's settings (Q1, roe, local dt, cfl 2, gmres,
    limiter none, grid-sequenced) on a NACA 0012 O-mesh of naca.struct's
    size (mesh.curvilinear.naca0012_omesh: 160 cells around, 40 out, the
    farfield at 20 chords) written as a .struct, f32, NACA_STEPS PTC steps
    on each level: the Newton and Krylov counts and the ||R|| history of
    each level (to chiprun_out/naca_steady_history.json); gates: no Newton
    divergence (cli.run raises on one) and a finite state; a drop in ||R||
    is not a gate.  Returns the summary."""
    import io
    import re
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.mesh.curvilinear import naca0012_omesh, write_struct
    with tempfile.TemporaryDirectory() as out:
        write_struct(os.path.join(out, "naca.struct"), naca0012_omesh(*NACA))
        text = "\n".join("set mesh file = naca.struct"
                         if ln.startswith("set mesh file") else ln
                         for ln in open(NACA_PRM).read().splitlines())
        prm = os.path.join(out, "naca.prm")
        with open(prm, "w") as f:
            f.write(text + "\n")
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            res = cli.run([prm, "--max-steps", str(NACA_STEPS),
                           "--output-dir", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    text = log.getvalue()
    timer = {k: float(v) for k, v in re.findall(
        r"^(Setup|Time loop|Output)\s+\d+\s+([0-9.]+)", text, re.M)}
    coarse, fine = res.steady_levels
    s = res.solver
    finite = bool(torch.isfinite(res.u).all())
    out = {"grid": [s.mesh.nx, s.mesh.ny],
           "coarse_grid": [s.steady_coarse.mesh.nx, s.steady_coarse.mesh.ny],
           "dtype": "float32", "ptc_steps": [len(coarse), len(fine)],
           "res_coarse": coarse, "res_fine": fine,
           "krylov_coarse": s.steady_coarse.krylov_counts.as_dict(),
           "krylov_fine": s.krylov_counts.as_dict(),
           "linear_warnings": text.count("WARNING"), "diverged": False,
           "finite": finite, "cli_timer_s": timer, "cli_wall_s": wall,
           "plain_calls": plain_calls["n"], "card": card_line()}
    print(json.dumps(out))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "naca_steady_history.json"),
              "w") as f:
        json.dump(out, f)
    assert finite and s.curvilinear
    assert len(coarse) == len(fine) == NACA_STEPS
    assert all(math.isfinite(r) for r in coarse + fine)
    assert not any(counts.values()) and plain_calls["n"] == 0
    return out


def envelope_limiter(kind: str):
    """The DMR's limiter configuration of phase 35's paths: minmax
    (characteristic, density indicator, positivity), or characteristic
    TVB beta 2 with positivity and the `u2` or `residual` indicator."""
    from dflo_tpu_torch.driver import LimiterConfig
    if kind == "minmax":
        return LimiterConfig(type="minmax", shock_indicator="density",
                             char_lim=True, pos_lim=True)
    return LimiterConfig(type="TVB", shock_indicator=kind, beta=2.0,
                         char_lim=True, pos_lim=True)


def phase_envelope_limiters(entry, kernels, plain_calls):
    """Phase 35, the limiters and indicators of the physics envelope, f32
    at full width, each through the normal entry points: the NX x NY DMR
    (entry._build) on Q2 with the minmax limiter (characteristic, the
    density indicator, positivity), on P2 under RK3 with TVB and the u2
    indicator, ENV_STEPS steps each, and on Q2 with TVB and the residual
    indicator, RESID_STEPS steps: the residual kernel (row 2: the SSP stage,
    and the R form inside the residual indicator) and the diag (row 6)
    launched, the fused post not (the reference's post_ok excludes them),
    no plain version called, finite, no fatal flag; then
    examples/vortex_system.prm at VS_N x VS_N with `conserve angular
    momentum = true` through cli.run, VS_STEPS steps with its angular-
    momentum monitor line every step, and its solver timed apart from
    output.  Returns (launch counts by path, ms/step by path, summaries,
    the minmax DMR's solver and final state for phase 37)."""
    import io
    import re
    from dflo_tpu_torch import cli
    counts, ms, summary = {}, {}, {}
    last = {}

    def keep(s, u, t):
        last["s"], last["u"] = s, u
        return {}

    paths = (("dmr_q2_minmax", "dmr_q2_rk_minmax_dof_updates_per_sec",
              dict(limiter=envelope_limiter("minmax")), ENV_STEPS,
              ("fused_residual[qk_hllc_stage]", "fused_diag")),
             ("dmr_p2_rk_u2", "dmr_p2_rk_tvb_u2_dof_updates_per_sec",
              dict(limiter=envelope_limiter("u2"), family="Pk"), ENV_STEPS,
              ("fused_residual[pk_hllc_stage]", "fused_diag")),
             ("dmr_q2_residual", "dmr_q2_rk_tvb_residual_dof_updates_per_sec",
              dict(limiter=envelope_limiter("residual")), RESID_STEPS,
              ("fused_residual[qk_hllc_stage]", "fused_residual[qk_hllc_R]",
               "fused_diag")))
    for name, metric, kw, steps, forms in paths:
        s, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda",
                             **kw)
        assert s.volume_kernel == "fused" and not s._fused_chain
        c, m = phase_solver_path(
            kernels, plain_calls, name, metric, s, u0, steps, steps, forms,
            (NX, NY), extra=keep if name == "dmr_q2_minmax" else None)
        assert c["fused_post"] == 0, c
        n_st = len(s.ark)
        assert c["fused_residual"] == n_st * steps * (
            2 if name == "dmr_q2_residual" else 1), c
        counts[name], ms[name] = c, m
        if name == "dmr_q2_minmax":
            dmr_minmax = (last["s"], last["u"])
        del s, u0
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as out:
        prm = edit_prm(VS_PRM, os.path.join(out, "vs.prm"), VS_N, VS_N, (
            "set beta = 2",
            "set beta = 2\n   set conserve angular momentum = true"))
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            res = cli.run([prm, "--max-steps", str(VS_STEPS),
                           "--output-dir", out])
        torch.cuda.synchronize()
        wall_cli = time.perf_counter() - t0
        c = kernels.launch_counts()
    am = re.findall(r"^Total angular momentum:.*$", log.getvalue(), re.M)
    for line in am:
        print("vortex_system " + line)
    s = res.solver
    finite = bool(torch.isfinite(res.u).all())
    used = {k: v for k, v in c.items() if v}
    print(f"vortex_system CLI {VS_N}x{VS_N} (conserve angular momentum): "
          f"{res.it} steps to t={res.t!r} in {wall_cli:.2f} s with set-up "
          f"and output, finite={finite}, launches={used}, plain calls="
          f"{plain_calls['n']}")
    assert res.it == VS_STEPS and finite and res.u.is_cuda
    assert s.limiter_cfg.conserve_angular_momentum and len(am) == VS_STEPS
    assert c["fused_residual[pk_lxf_stage]"] == len(s.ark) * VS_STEPS, c
    assert c["fused_diag"] > 0 and plain_calls["n"] == 0
    am_vals = [float(ln.split()[-1]) for ln in am]
    c2, m2 = phase_solver_path(
        kernels, plain_calls, "vortex_system_angmom",
        "vortex_system_p1_angmom_dof_updates_per_sec", s, res.u, VS_STEPS,
        VS_STEPS, ("fused_residual[pk_lxf_stage]", "fused_diag"),
        (VS_N, VS_N), extra=lambda s_, u_, t_: {
            "cli_wall_s": wall_cli, "angular_momentum": am_vals})
    counts["vortex_system_angmom"], ms["vortex_system_angmom"] = c, m2
    summary["angular_momentum"] = am_vals
    del res, s
    torch.cuda.empty_cache()
    return counts, ms, summary, dmr_minmax


def phase_pressure_fullmass(kernels, plain_calls, results):
    """Phase 36, pressure sides and the full mass matrix, f32 unless said:
    examples/forward_step_tpu.prm at its 1920 x 640 (Q1, LxF, the mask)
    through cli.run with its outlet a pressure side at the free stream's
    pressure (energy slot 1.0), PRES_STEPS steps in chunks of PRES_CHUNK:
    rows 2 (the masked stage, the pressure strips on E), 4 and 6 launched,
    no plain version called; its solver timed apart from output
    (fwdstep_q1_pressure_outlet_dof_updates_per_sec); one full-width
    masked Q1 stage with the pressure strips bitwise against its plain
    version in f32 and f64, timed (the kernel table's row
    fused_residual_pressure); then examples/iso_xing_shu.prm at ISO_N x
    ISO_N with `mass matrix = full` and cfl 0.5 (the shipped 0.9 is
    unstable with the consistent mass, in the reference too) through cli's
    solver (the plain residual and the diag, row 6), FULLMASS_STEPS steps
    (isohydro_gll2_fullmass_dof_updates_per_sec), and its f64 well-balance
    drift at WB_N x WB_N after WB_STEPS steps.  Returns (launch counts by
    path, ms/step by path, summaries)."""
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.config.params import AllParameters
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.solver.spatial import BoundarySide, make_rhs
    counts, ms, summary = {}, {}, {}
    pressure = (("subsection boundary_2\n   set type = outflow",
                 "subsection boundary_2\n   set type = pressure\n"
                 "   set w_3 value = 1.0"),)
    with tempfile.TemporaryDirectory() as out:
        prm = edit_prm(FS_PRM, os.path.join(out, "fwd_p.prm"), FS_NX, FS_NY,
                       *pressure)
        kernels.reset_launch_counts()
        plain_calls["n"] = 0
        t0 = time.perf_counter()
        res = cli.run([prm, "--max-steps", str(PRES_STEPS), "--chunk",
                       str(PRES_CHUNK), "--output-dir", out])
        torch.cuda.synchronize()
        wall_cli = time.perf_counter() - t0
        c = kernels.launch_counts()
        s = res.solver
        finite = bool(torch.isfinite(res.u).all())
        used = {k: v for k, v in c.items() if v}
        print(f"forward step CLI, pressure outlet: {res.it} steps to "
              f"t={res.t!r} in {wall_cli:.2f} s with set-up and output, "
              f"finite={finite}, launches={used}, plain calls="
              f"{plain_calls['n']}")
        assert res.it == PRES_STEPS and finite and res.u.is_cuda
        assert s.bcs["E"].kind == euler.BC_PRESSURE and s.mask is not None
        form = "fused_residual[qk_lxf_masked_stage]"
        assert c[form] == len(s.ark) * PRES_STEPS, c
        assert all(c[k] > 0 for k in ("fused_post", "fused_diag")), c
        assert plain_calls["n"] == 0, "the pressure outlet called a plain"
        counts["fwd_pressure"] = c
        c2, ms["fwd_pressure"] = phase_solver_path(
            kernels, plain_calls, "fwd_pressure",
            "fwdstep_q1_pressure_outlet_dof_updates_per_sec", s, res.u,
            PRES_STEPS, PRES_CHUNK, (form, "fused_post", "fused_diag"),
            (FS_NX, FS_NY), extra=lambda s_, u_, t_: {"cli_wall_s": wall_cli})
        u_end = res.u

        # one full-width masked stage with the pressure strips, bitwise
        params = AllParameters.from_prm_file(prm)
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            sd, _ = cli.build_solver(params, out, dtype=dtype, device="cuda")
            ud = sd.post_stage(u_end.to(dtype))
            u_old = sd.post_stage(cli.set_ic(params, sd))
            tt = torch.full((), 0.01, dtype=dtype, device="cuda")
            strips = sd.rhs.strips(ud, tt)
            outflow = make_rhs(sd.basis, sd.mesh, dict(
                sd.bcs, E=BoundarySide(euler.BC_OUTFLOW)), flux="lxf",
                dtype=dtype, device="cuda", volume_kernel="fused",
                mask=sd.mask).strips(ud, tt)
            assert not torch.equal(strips[1], outflow[1])
            lam, _ = sd._diag(ud)
            sc = torch.stack([torch.full((), 0.5, dtype=dtype,
                                         device="cuda"),
                              0.5 / lam / 3.0])

            def fk(ud=ud, strips=strips, sd=sd, u_old=u_old, sc=sc):
                return kernels.fused_residual(ud, *strips, sd.rhs.ops,
                                              u_old=u_old, sc=sc)

            def fp(ud=ud, strips=strips, sd=sd, u_old=u_old, sc=sc):
                return kernels.fused_residual_plain(ud, *strips, sd.rhs.ops,
                                                    u_old=u_old, sc=sc)

            fold(results, "fused_residual_pressure", tag, [(fk(), fp())],
                 TOL[dtype]["fused_residual"], bitwise=True)
            time_pair(results, "fused_residual_pressure", tag, fk, fp,
                      (FS_NX, FS_NY))
            del sd, ud, u_old, strips, outflow
        del res, s, u_end
    torch.cuda.empty_cache()

    # the consistent mass shrinks the stable CFL number: at the shipped 0.9
    # the round-off of the rest state grows ten-fold a step in both
    # packages (f32 fails in 9 steps), at 0.5 it stays bounded
    full = (("set potential = x + y",
             "set potential = x + y\nset mass matrix = full"),
            ("set cfl = 0.9", "set cfl = 0.5"))
    with tempfile.TemporaryDirectory() as out:
        prm = edit_prm(ISO_PRM, os.path.join(out, "iso_full.prm"), ISO_N,
                       ISO_N, *full)
        params = AllParameters.from_prm_file(prm)
        s, _ = cli.build_solver(params, out, dtype=torch.float32,
                                device="cuda")
        assert s.volume_kernel == "xla" and params.mass_matrix == "full"
        c, ms["iso_fullmass"] = phase_solver_path(
            kernels, plain_calls, "iso_fullmass",
            "isohydro_gll2_fullmass_dof_updates_per_sec", s,
            cli.set_ic(params, s), FULLMASS_STEPS, FULLMASS_STEPS,
            ("fused_diag",), (ISO_N, ISO_N))
        assert c["fused_residual"] == 0, c
        counts["iso_fullmass"] = c
        del s
        torch.cuda.empty_cache()
        # the f64 well-balance drift with the full mass matrix
        prm = edit_prm(ISO_PRM, os.path.join(out, "iso_wb.prm"), WB_N, WB_N,
                       *full)
        params = AllParameters.from_prm_file(prm)
        s, _ = cli.build_solver(params, out, dtype=torch.float64,
                                device="cuda")
        u0 = s.post_stage(cli.set_ic(params, s))
        u, t, n, bad, _ = s._multi_step(WB_STEPS)(u0, 0.0, 1e3)
        drift = float((u - u0).abs().max())
        mom = float(u[:2].abs().max())
        print(f"iso_xing_shu full mass f64 {WB_N}x{WB_N}: {int(n)} steps to "
              f"t={float(t)!r}, max |u - u0| {drift:.3e}, max |m| {mom:.3e}")
        assert int(n) == WB_STEPS and not bool(bad)
        assert math.isfinite(drift)
        summary["iso_fullmass_f64_drift"] = {
            "grid": [WB_N, WB_N], "steps": WB_STEPS, "max_abs_du": drift,
            "max_abs_momentum": mom, "t": float(t)}
        del s, u, u0
    torch.cuda.empty_cache()
    return counts, ms, summary


def phase_mood_off_route(entry, kernels, plain_calls, dmr_minmax):
    """Phase 37, MOOD off the fused route, and output: the NX x NY P2 DMR
    MOOD with volume_kernel="xla" (the plain residual, MoodStage's plain
    arm, the plain post), MOOD_XLA_STEPS steps, f32: the diag (row 6)
    launched and the candidate, the modal positivity, the Pk post and the
    check (rows 3, 8, 9 and 10) not, nor the residual kernel, as the
    reference routes it (dflo_tpu_torch/driver.py, dflo_tpu/driver.py:
    283-330) (dmr_p2_mood_xla_dof_updates_per_sec); then one f64 stage each
    on that DMR state through the fused route: dmp_bounds="collapsed"
    reduces a superset of the neighborhood's cells; deg_in = full(p) equals
    the cold stage bitwise outside the cells (and their neighbors) where
    the full-degree {truncation -> positivity} chain moves the predictor;
    a warm start from the cold stage's settled map accepts the same state
    (1e-12) in no more passes.  mu_shock (stab/mushock) of phase 35's final
    minmax DMR state, f32, timed: finite, at least -1e-12 times its max.
    examples/sod_shock_tube.prm as shipped through cli.run, SOD_STEPS steps,
    with `format = tecplot` (the .plt snapshots written) and with
    `diffusion coefficient = 1` (each VTU carries the mu_shock field).
    Returns (launch counts, ms/step, summary)."""
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.stab import mood as mood_mod
    from dflo_tpu_torch.stab.mushock import make_mu_shock
    summary = {}
    s, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda",
                         method="mood", volume_kernel="xla")
    assert s.volume_kernel == "xla" and not s._mood_stage.fused
    assert s._pk_post_ops is None
    state = {}

    def keep(s_, u_, t_):
        state["u"], state["t"] = u_, t_
        st = s_.last_stats
        return {"mood_stats_last_step": [int(st.n_reduce), int(st.n_marked),
                                         st.iters]}

    counts, ms = phase_solver_path(
        kernels, plain_calls, "dmr_p2_mood_xla",
        "dmr_p2_mood_xla_dof_updates_per_sec", s, u0, MOOD_XLA_STEPS,
        MOOD_XLA_STEPS, ("fused_diag",), (NX, NY), extra=keep)
    off = ("fused_mood_candidate", "fused_modal_pos", "fused_pk_post",
           "fused_mood_check", "fused_residual")
    assert all(counts[k] == 0 for k in off), counts
    assert counts["fused_diag"] > 0, counts
    summary["dmr_p2_mood_xla_rows_3_8_9_10"] = [counts[k] for k in off[:4]]

    # one f64 stage each through the fused route on the DMR state
    sf, _ = entry._build(NX, NY, dtype=torch.float64, device="cuda",
                         method="mood")
    u = sf.post_stage(state["u"].double())
    stage = sf._mood_stage
    t64 = torch.zeros((), dtype=torch.float64, device="cuda")
    dt = sf.cfl / sf._diag(u)[0] / 5.0
    cold = stage(u, t64, dt)
    coll = mood_mod.make_mood(sf.basis, sf.mesh, sf.rhs,
                              dmp_bounds="collapsed")(u, t64, dt)
    p = sf.basis.degree
    red_n, red_c = cold[3] < p, coll[3] < p
    superset = bool((red_c | ~red_n).all())
    full = stage(u, t64, dt, deg_in=torch.full_like(cold[3], p))
    moved = mood_mod.dilate4((kernels.fused_modal_pos(u, stage.mops) != u)
                             .flatten(0, 1).any(0))
    same_out = bool(torch.equal(full[0][..., ~moved], cold[0][..., ~moved])
                    and torch.equal(full[3][~moved], cold[3][~moved]))
    bitwise_all = bool(torch.equal(full[0], cold[0]))
    warm = stage(u, t64, dt, deg_in=cold[3])
    warm_err = rel_err(warm[0], cold[0])
    line = {"cells": NX * NY, "dtype": "float64",
            "neighborhood_reduced_cells": int(red_n.sum()),
            "collapsed_reduced_cells": int(red_c.sum()),
            "collapsed_superset": superset,
            "moved_cells_with_neighbors": int(moved.sum()),
            "full_p_bitwise_outside_moved": same_out,
            "full_p_bitwise_everywhere": bitwise_all,
            "cold_passes": cold[2].iters, "warm_passes": warm[2].iters,
            "warm_rel_err": warm_err,
            "warm_same_degree_map": bool(torch.equal(warm[3], cold[3]))}
    print("MOOD stage options on the DMR state: " + json.dumps(line))
    assert superset and same_out, line
    assert warm_err <= 1e-12 and warm[2].iters <= cold[2].iters, line
    summary["mood_stage_options"] = line
    del sf, u, stage, cold, coll, full, warm, s, state
    torch.cuda.empty_cache()

    # mu_shock of the final minmax DMR state
    sm, um = dmr_minmax
    mu_fn = make_mu_shock(sm.basis, sm.mesh, 1.0, dtype=torch.float32,
                          device="cuda", bcs=sm.bcs)
    ubar = sm.cell_averages(um)
    mu = mu_fn(um, ubar)
    torch.cuda.synchronize()
    mu_ms = host_ms(lambda: mu_fn(um, ubar))
    mu_max, mu_min = float(mu.max()), float(mu.min())
    finite = bool(torch.isfinite(mu).all())
    summary["mu_shock"] = {"grid": [NX, NY], "max": mu_max, "min": mu_min,
                           "ms": mu_ms, "finite": finite}
    print(f"mu_shock of the minmax DMR state {NX}x{NY} f32: max {mu_max:.4e}"
          f", min {mu_min:.4e}, finite {finite}, {mu_ms:.2f} ms a call")
    assert finite and mu_min >= -1e-12 * mu_max and mu_max > 0.0

    # sod as shipped: Tecplot snapshots, and VTUs with mu_shock
    with tempfile.TemporaryDirectory() as out:
        tec = edit_prm(SOD_PRM, os.path.join(out, "sod_tec.prm"), *SOD_N, (
            "set schlieren plot = true",
            "set schlieren plot = true\n   set format = tecplot"))
        mu_prm = edit_prm(SOD_PRM, os.path.join(out, "sod_mu.prm"), *SOD_N, (
            "set mapping = cartesian",
            "set mapping = cartesian\nset diffusion coefficient = 1.0"))
        files = {}
        for tag, prm, ext in (("tecplot", tec, ".plt"),
                              ("mu_shock", mu_prm, ".vtu")):
            d = os.path.join(out, tag)
            t0 = time.perf_counter()
            res = cli.run([prm, "--max-steps", str(SOD_STEPS),
                           "--output-dir", d])
            wall = time.perf_counter() - t0
            names = sorted(f for f in os.listdir(d) if f.endswith(ext))
            assert res.it == SOD_STEPS and res.u.is_cuda and len(names) == 2
            assert bool(torch.isfinite(res.u).all())
            head = open(os.path.join(d, names[-1]), "rb").read(4096)
            if ext == ".vtu":
                assert b'Name="mu_shock"' in head, head[:400]
                assert not [f for f in os.listdir(d) if f.endswith(".plt")]
            else:
                assert head.startswith(b'TITLE = "dflo_tpu solution"')
            files[tag] = {"files": names, "cli_wall_s": wall,
                          "bytes": os.path.getsize(os.path.join(d,
                                                                names[-1]))}
        print("sod_shock_tube as shipped, " + json.dumps(files))
        summary["sod_output"] = files
    return counts, ms, summary


def clock(t_start: float, what: str) -> None:
    """The script's elapsed time before the phases `what`."""
    print(f"chip_smoke: at {time.perf_counter() - t_start:.1f} s, next: "
          f"{what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    from dflo_tpu_torch import entry
    from dflo_tpu_torch.ops import kernels
    from dflo_tpu_torch.physics import euler
    assert "jax" not in sys.modules and "dflo_tpu" not in sys.modules
    t_start = time.perf_counter()

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | python {sys.version.split()[0]}")

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    so, log = kernels.build(ptxas_info=True)
    build_s = time.perf_counter() - t0
    times = {ln.split()[1]: float(ln.split("(")[1].split()[0])
             for ln in log.splitlines() if ln.startswith("== ")}
    pole = max(times, key=times.get)
    print(f"build: {so.name} in {build_s:.1f} s, {len(times)} sources, "
          f"long pole {pole} ({times[pole]:.1f} s)")
    for line in log.splitlines():
        if line.startswith("=="):
            print("  " + line.strip())
    results = {name: {} for name in SOURCES}
    phase_tile_report(kernels, log, results)

    clock(t_start, "phases 2, 5 and 9")
    # ---- phases 2, 5 and 9: kernels against plain versions ------------------
    results["flux_registers"] = {}
    results["masked_pk_registers"] = {}
    dmr_states = phase_kernels(entry, kernels, euler, results)
    phase_mood_kernels(entry, kernels, results)
    fwd_states = phase_fwd_kernels(kernels, results)

    clock(t_start, "phase 12")
    # ---- phase 12: the sharded path's block kernels -------------------------
    phase_shard_kernels(entry, kernels, results, dmr_states)
    del dmr_states

    clock(t_start, "phase 14")
    # ---- phase 14: the modal LxF forms and the periodic post ---------------
    phase_lxf_kernels(entry, kernels, results)

    clock(t_start, "phase 17")
    # ---- phase 17: the source arms and the well-balance oracle --------------
    results["well_balance_drift"] = {}
    phase_source_kernels(kernels, results)

    clock(t_start, "phase 19")
    # ---- phase 19: the Roe, Steger-Warming, KFVS and KEP forms --------------
    phase_flux_kernels(kernels, results, log)

    clock(t_start, "phase 23")
    # ---- phase 23: the masked modal residual, the candidate's four fluxes --
    phase_masked_pk_kernels(entry, kernels, results, log)
    phase_pk_path_kernels(kernels, results)

    clock(t_start, "phase 25")
    # ---- phase 25: the envelope's new forms against their plain versions ---
    results["envelope_cases"] = {}
    phase_envelope_kernels(entry, kernels, results, log)

    clock(t_start, "phase 27")
    # ---- phase 27: the MOOD kernels over their degree range -----------------
    results["mood_degree_cases"] = {}
    phase_mood_degree_kernels(entry, kernels, results, log)

    clock(t_start, "phase 29")
    # ---- phase 29: the tile post and modal positivity over their forms --
    phase_tile_post_kernels(kernels, results)

    clock(t_start, "phase 30")
    # ---- phase 30: the tile Pk post and check over their forms ------------
    phase_tile_pk_check_kernels(kernels, results)

    clock(t_start, "phase 31")
    # ---- phase 31: the diag and the volume residual over their forms -----
    phase_diag_volume_kernels(kernels, results)

    clock(t_start, "phases 3 and 6")
    # ---- phases 3 and 6: the main paths, with the plain versions counted -----
    plain_calls = {"n": 0}
    for name in WRAPPERS:
        fn = getattr(kernels, name + "_plain")

        def counted(*a, _fn=fn, **k):
            plain_calls["n"] += 1
            return _fn(*a, **k)
        setattr(kernels, name + "_plain", counted)
    counts, ms_step = {}, {}
    counts["rk"], ms_step["rk"] = phase_main_rk(entry, kernels, plain_calls)
    counts["mood"], ms_step["mood"] = phase_main_mood(entry, kernels,
                                                      plain_calls)

    clock(t_start, "phases 10 and 11")
    # ---- phases 10 and 11: the forward step, through the CLI and with the
    # volume_kernel="pallas" path --------------------------------------------
    counts["fwd"], ms_step["fwd"], fwd = phase_main_fwd(kernels, plain_calls)
    counts["pallas"] = phase_pallas(kernels, plain_calls, fwd_states)
    del fwd_states

    clock(t_start, "phase 13")
    # ---- phase 13: the sharded main path and the 1-vs-N check --------------
    counts["shard"], ms_step["shard"], shard = phase_main_shard(
        entry, kernels, plain_calls, results)

    clock(t_start, "phases 15 and 16")
    # ---- phases 15 and 16: the vortex main path, the seven configs ---------
    counts["vortex"], ms_step["vortex"], vortex = phase_main_vortex(
        kernels, plain_calls)
    by_config = phase_configs(kernels, plain_calls)
    counts["sod_mood"] = by_config["sod_mood"]
    counts["pbc"] = by_config["vortex_system_pbc"]

    clock(t_start, "phase 18")
    # ---- phase 18: the body-force main paths --------------------------------
    counts["rt"], ms_step["rt"], rt = phase_main_source(
        kernels, plain_calls, "rayleigh_taylor",
        "rt_q1_rk_tvb_gravity_dof_updates_per_sec", RT_PRM, (RT_NX, RT_NY),
        "fused_residual[qk_hllc_grav_stage]")
    counts["iso"], ms_step["iso"], iso = phase_main_source(
        kernels, plain_calls, "iso_xing_shu",
        "isohydro_gll2_wb_rk_dof_updates_per_sec", ISO_PRM, (ISO_N, ISO_N),
        "fused_residual[gll_hllc_wbiso_stage]")
    counts["rt_pk"] = phase_variant_path(kernels, plain_calls, "rt_pk", rt_pk,
                                         "fused_residual[pk_hllc_grav_stage]")
    counts["rt_force"] = phase_variant_path(
        kernels, plain_calls, "rt_force", rt_force,
        "fused_residual[qk_hllc_force_stage]")

    clock(t_start, "phases 19-22")
    # ---- phases 19-22: the new fluxes' RK paths, the implicit paths ---------
    by_flux = phase_flux_paths(kernels, plain_calls)
    for flux in ("sw", "kfvs", "kep"):
        counts[f"flux_{flux}"] = by_flux[flux]
    counts["impl"], ms_step["impl"], impl = phase_main_implicit(kernels,
                                                                plain_calls)
    GRIDS["impl"] = tuple(impl["grid"])
    counts["steady"], steady = phase_main_steady(kernels, plain_calls)
    primal_err = phase_primal_f64(kernels)

    clock(t_start, "phase 24")
    # ---- phase 24: masked P2 (MOOD and RK), MOOD with gravity, the DMR
    # MOOD path with each new flux ------------------------------------------
    counts["fwd_mood"], ms_step["fwd_mood"], fwd_mood = phase_main_pk(
        kernels, plain_calls, "fwd_p2_mood",
        "fwdstep_p2_mood_dof_updates_per_sec", FS_PRM, (FS_NX, FS_NY),
        pk_edits(2, "mood"), FWD_MOOD_STEPS, FWD_MOOD_CHUNK,
        ("fused_residual[pk_lxf_masked_step]", "fused_modal_pos",
         "fused_diag"))
    counts["fwd_rk"], _, _ = phase_main_pk(
        kernels, plain_calls, "fwd_p2_rk",
        "fwdstep_p2_rk_tvb_dof_updates_per_sec", FS_PRM, (FS_NX, FS_NY),
        pk_edits(2, "rk3"), FWD_RK_STEPS, FWD_RK_STEPS,
        ("fused_residual[pk_lxf_masked_stage]", "fused_diag"))
    counts["rt_mood"], _, _ = phase_main_pk(
        kernels, plain_calls, "rt_p2_mood",
        "rt_p2_mood_gravity_dof_updates_per_sec", RT_PRM, (RT_NX, RT_NY),
        RT_MOOD_EDITS, RT_MOOD_STEPS, RT_MOOD_STEPS,
        ("fused_residual[pk_hllc_grav_step]", "fused_mood_check",
         "fused_pk_post", "fused_modal_pos"))
    for flux, c in phase_dmr_flux_mood(entry, kernels, plain_calls).items():
        counts[f"dmr_{flux}"] = c

    clock(t_start, "phase 26")
    # ---- phase 26: the envelope's paths ------------------------------------
    counts_env, ms_step["vortex_p4"], vortex_p4 = phase_envelope_paths(
        entry, kernels, plain_calls)
    counts.update(counts_env)

    clock(t_start, "phase 28")
    # ---- phase 28: the P4 and P1 MOOD paths, sod_mood at degree 1 and 4 ----
    counts_md, ms_step["dmr_p4_mood"], p4_mood = phase_mood_degree_paths(
        entry, kernels, plain_calls)
    counts.update(counts_md)

    clock(t_start, "phases 32-34")
    # ---- phases 32-34: the DMR from a .geo file, the curvilinear annulus,
    # the naca0012 steady workflow --------------------------------------------
    counts["dmr_geo"], ms_step["dmr_geo"], geo_dmr = phase_geo_dmr(
        kernels, plain_calls, results)
    ms_step["annulus"], annulus, annulus_summary = phase_annulus(
        kernels, plain_calls)
    naca = phase_naca_steady(kernels, plain_calls)

    clock(t_start, "phases 35-37")
    # ---- phases 35-37: the rest of the physics envelope --------------------
    t_env = time.perf_counter()
    c35, ms35, env_lim, dmr_minmax = phase_envelope_limiters(
        entry, kernels, plain_calls)
    c36, ms36, env_pres = phase_pressure_fullmass(kernels, plain_calls,
                                                  results)
    counts.update(c35)
    counts.update(c36)
    ms_step.update(ms35)
    ms_step.update(ms36)
    counts["dmr_p2_mood_xla"], ms_step["dmr_p2_mood_xla"], env_mood = \
        phase_mood_off_route(entry, kernels, plain_calls, dmr_minmax)
    del dmr_minmax
    envelope = {"phases_35_37_s": time.perf_counter() - t_env,
                "launches_per_step": {
                    k: {f: v / steps for f, v in counts[k].items() if v}
                    for k, steps in (
                        ("dmr_q2_minmax", ENV_STEPS),
                        ("dmr_p2_rk_u2", ENV_STEPS),
                        ("dmr_q2_residual", RESID_STEPS),
                        ("vortex_system_angmom", VS_STEPS),
                        ("fwd_pressure", PRES_STEPS),
                        ("iso_fullmass", FULLMASS_STEPS),
                        ("dmr_p2_mood_xla", MOOD_XLA_STEPS))},
                "ms_per_step": {k: ms_step[k] for k in (
                    "dmr_q2_minmax", "dmr_p2_rk_u2", "dmr_q2_residual",
                    "vortex_system_angmom", "fwd_pressure", "iso_fullmass",
                    "dmr_p2_mood_xla")},
                **env_lim, **env_pres, **env_mood, "card": card_line()}
    print("physics envelope: " + json.dumps(envelope))

    clock(t_start, "phase 8")
    # ---- phase 8: the device's busy share under torch.profiler --------------
    busy = phase_trace(entry, ms_step, {"fwd": fwd, "shard": shard,
                                        "vortex": vortex, "rt": rt,
                                        "iso": iso, "fwd_mood": fwd_mood,
                                        "dmr_p4_mood": p4_mood,
                                        "vortex_p4": vortex_p4,
                                        "annulus": annulus})
    del vortex, rt, iso, fwd_mood, p4_mood, vortex_p4, annulus

    clock(t_start, "phase 7")
    # ---- phase 7: sparse against dense ---------------------------------------
    phase_sparse_dense(entry, kernels, results)

    clock(t_start, "phase 4")
    # ---- phase 4: entry() analog, one f64 step ------------------------------
    fn, (ue, te, tend) = entry.entry(dtype=torch.float64, device="cuda")
    uk = fn(ue, te, tend)
    s_cpu, _ = entry._build(128, 24, dtype=torch.float64, device="cpu")
    s_gpu, _ = entry._build(128, 24, dtype=torch.float64, device="cuda")
    up_gpu, _, _ = plain_step(s_gpu, ue, te, tend)
    up_cpu, _, _ = plain_step(s_cpu, ue.cpu(), te.cpu(), tend.cpu())
    torch.cuda.synchronize()
    e_gpu, e_cpu = rel_err(uk, up_gpu), rel_err(uk.cpu(), up_cpu)
    print(f"entry() step 128x24 f64: kernels vs plain on the card {e_gpu:.3e},"
          f" vs plain on the CPU {e_cpu:.3e} (tol 1e-10)")
    assert e_gpu <= 1e-10 and e_cpu <= 1e-10

    # ---- result lines -----------------------------------------------------
    from dflo_tpu_torch.ops.basis import make_basis
    bases = {"rk": make_basis("Qk", 2), "mood": make_basis("Pk", 2),
             "fwd": make_basis("Qk", 1), "pallas": make_basis("Qk", 1),
             "shard": make_basis("Qk", 2), "vortex": make_basis("Pk", 2),
             "sod_mood": make_basis("Pk", 2), "pbc": make_basis("Qk", 1),
             "rt": make_basis("Qk", 1), "rt_pk": make_basis("Pk", 2),
             "rt_force": make_basis("Qk", 1),
             "iso": make_basis("Qk_gll", 2), "impl": make_basis("Qk", 1),
             "flux_sw": make_basis("Qk", 1), "flux_kfvs": make_basis("Qk", 1),
             "flux_kep": make_basis("Qk", 1),
             **{k: make_basis("Pk", 2) for k in
                ("fwd_mood", "fwd_rk", "rt_mood",
                 *(f"dmr_{f}" for f in FLUX_NEW))},
             "vortex_p4": make_basis("Pk", 4),
             "vortex_p6": make_basis("Pk", 6),
             "dmr_q4": make_basis("Qk", 4), "pallas_q4": make_basis("Qk", 4),
             "q2oi": make_basis("Qk", 2, 4), "rt_roe": make_basis("Qk", 1),
             "iso_roe": make_basis("Qk_gll", 2),
             "dmr_p4_mood": make_basis("Pk", 4),
             "dmr_geo": make_basis("Qk", 2),
             "fwd_pressure": make_basis("Qk", 1)}
    table = []
    for name, (src, line, tpu, wrapper, path) in SOURCES.items():
        r = results[name]
        n_cells = GRIDS[path][0] * GRIDS[path][1]
        data = r.get("data_f32", {})
        b_ms, b_by = bound(name, bases[path], torch.float32, n_cells, **data)
        n_bytes, n_ops = work(name, bases[path], torch.float32, n_cells,
                              **data)
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "tpu_kernel": tpu, "path": path,
            "launches": counts[path][wrapper],
            **({"launches_per_step": counts[path][wrapper]
                / PATH_STEPS[path]} if path in PATH_STEPS else {}),
            "max_abs_err": r["max_abs_err_f32"],
            "ms": r["ms_f32"], "plain_ms": r["plain_ms_f32"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bytes": n_bytes, "operations": n_ops,
            "max_abs_err_f64": r["max_abs_err_f64"],
            "max_rel_err_f32": r["max_rel_err_f32"],
            "max_rel_err_f64": r["max_rel_err_f64"],
            "ms_f64": r["ms_f64"], "plain_ms_f64": r["plain_ms_f64"],
            "bound_ms_f64": bound(name, bases[path], torch.float64, n_cells,
                                  **r.get("data_f64", {}))[0],
            **({"bound_data_f32": data} if data else {}),
            **({"flipped_cells_f32": r["flipped_cells_f32"],
                "flipped_cells_f64": r["flipped_cells_f64"]}
               if "flipped_cells_f32" in r else {}),
            **({"bitwise_f32": r["bitwise_f32"],
                "bitwise_f64": r["bitwise_f64"]}
               if "bitwise_f32" in r else {}),
            **{k: v for k, v in r.items()
               if k.startswith(("block_ms", "sharded_", "stage_ms",
                                "ms_source", "variants_", "ms_R_",
                                "plain_ms_R_", "no_source_ms_", "cases_",
                                "plain_stage_ms", "stage_bound",
                                "forms_ms_"))}})
    assert all(math.isfinite(v) for row in table for v in row.values()
               if isinstance(v, float))
    total_s = time.perf_counter() - t_start
    print(f"chip_smoke: every phase passed in {total_s:.1f} s (build "
          f"{build_s:.1f} s)")
    print(json.dumps({"build_s": build_s, "build_long_pole": [pole,
                                                              times[pole]],
                      "card": card, "total_s": total_s,
                      "tile_kernels": results["tile_kernels"],
                      "device_busy": busy,
                      "fused_pk_post_with_diag_launches":
                          counts["mood"]["fused_pk_post_with_diag"],
                      "implicit_vortex": impl, "steady": steady,
                      "implicit_f64_primal_rel_err": primal_err,
                      "flux_registers": results["flux_registers"],
                      "masked_pk_registers": results["masked_pk_registers"],
                      "envelope_registers": results["envelope_registers"],
                      "envelope_cases": results["envelope_cases"],
                      "mood_degree_registers":
                          results["mood_degree_registers"],
                      "mood_degree_cases": results["mood_degree_cases"],
                      "tile_post_cases": results["tile_post_cases"],
                      "tile_pk_check_cases": results["tile_pk_check_cases"],
                      "diag_volume_cases": results["diag_volume_cases"],
                      "dmr_geo": geo_dmr, "annulus": annulus_summary,
                      "naca_steady": naca, "physics_envelope": envelope,
                      **{k: v for k, v in results.items()
                         if k.startswith(("free_stream", "sparse_vs",
                                          "mood_host", "mood_p4",
                                          "shard_f64",
                                          "well_balance"))}}))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
