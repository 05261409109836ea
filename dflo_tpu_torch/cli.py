"""Command-line driver: ``python -m dflo_tpu_torch input.prm``.

The torch counterpart of dflo_tpu/cli.py (after src/main.cc:13-81 and
src/claw.cc:953-1130): parse the .prm config, build the mesh (the Cartesian
mesh and its solid-cell mask from the `cartesian mesh` subsection, or the
`mesh file`: a .geo rasterized to a Cartesian mesh with a mask and
segmented sides, or chained into a curvilinear block; a raster .msh; a
.struct O-mesh as a curvilinear block wrapped in xi), wire the boundary ids
to the four sides (a side with several ids becomes a SegmentedSide), set
the IC, march in
time with the configured flux, limiter chain and body force
(``method = rk3`` on Qk, GLL or Pk, ``mood`` on Pk, ``gmres``, ``direct``
or ``umfpack`` for implicit Newton-Krylov; a global, local or fixed time
step; ``gravity``, the ``f_0``/``f_1`` force or a ``potential`` for
well-balanced gravity; the lumped or the full mass matrix), or with
``stationary = true`` and an implicit method solve to steady state by
pseudo-transient continuation (grid-sequenced through a 2x-coarsened
companion where the grid halves, a curvilinear block's every other node),
write VTU snapshots (with the mu_shock field of a nonzero `diffusion
coefficient` on a Cartesian mesh, src/output.cc:95-105) or, with `format =
tecplot`, ASCII Tecplot snapshots, and checkpoints on their cadence, and
report the wall time of each phase.

The run is on the card; ``--platform cpu`` runs it on the CPU, where every
kernel wrapper takes its plain version.  Without a CUDA device and without
``--platform cpu`` the run stops with an error: it never falls back to the
CPU by itself.  ``--devices N`` splits the domain over N devices (the
most-square mesh that divides the grid, parallel/sharding): N distinct
cards, or with ``--platform cpu`` N CPU blocks; snapshots and checkpoints
gather the blocks first.  The reference's other branches (unstructured
meshes: a circle-bounded .geo and a .msh that is not a raster; AMR;
``--slices``) raise NotImplementedError naming the slice that brings them.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from dflo_tpu_torch import ic as ic_mod
from dflo_tpu_torch.config.params import AllParameters
from dflo_tpu_torch.diagnostics import angular_momentum
from dflo_tpu_torch.driver import LimiterConfig, Solver
from dflo_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from dflo_tpu_torch.io.vtk import write_tecplot, write_vtu
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.mesh.curvilinear import CurvilinearMesh, load_struct
from dflo_tpu_torch.mesh.geo import load_geo
from dflo_tpu_torch.mesh.msh import load_msh
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.parallel.sharding import compatible_shape, device_mesh
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver.implicit import run_steady, run_steady_sequenced
from dflo_tpu_torch.solver.spatial import BoundarySide, SegmentedSide
from dflo_tpu_torch.stab.mushock import make_mu_shock
from dflo_tpu_torch.utils.profiling import Timer, device_trace

#: where the branches this CLI does not carry yet come from (ROADMAP)
_LATER = {
    "amr": "slice F, AMR (ROADMAP)",
    "devices": "slice G, the rest of multi-GPU (ROADMAP)",
}


def _later(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with "
                               f"{_LATER[key]}")


def build_domain(params: AllParameters, prm_dir: str = "."):
    """(mesh, mask, side boundary ids) of the configuration
    (dflo_tpu/cli.py:31-80): the `cartesian mesh` subsection (the mask True
    on fluid cells, False where the `solid` expression of the cell centre is
    nonzero), or the `mesh file`.  A missing file falls back to the .geo or
    .struct of its stem, then to any .geo or .struct beside the config (the
    reference ships generators, not .msh files).  A .struct is a curvilinear
    O-mesh wrapped in xi (W/E id -2, the airfoil S = 0, the farfield
    N = 1); a .geo a rasterized Cartesian domain or a curvilinear chain; any
    other file a .msh raster."""
    cm = params.cartesian_mesh
    if params.mesh_type == "cartesian" or cm.nx > 0:
        mesh = CartesianMesh(cm.nx, cm.ny, cm.x0, cm.x1, cm.y0, cm.y1)
        # native meshes use the Gmsh-free convention S=1, E=2, N=3, W=4
        side_bids = {"W": np.full(cm.ny, 4), "E": np.full(cm.ny, 2),
                     "S": np.full(cm.nx, 1), "N": np.full(cm.nx, 3)}
        mask = None
        if cm.solid is not None:
            xc, yc = mesh.cell_centers()
            solid = cm.solid(torch.as_tensor(xc), torch.as_tensor(yc))
            mask = ~np.asarray(solid.numpy(), bool)
        return mesh, mask, side_bids
    path = os.path.join(prm_dir, params.mesh_filename)
    if not os.path.exists(path):
        stem = os.path.splitext(path)[0]
        candidates = [path, stem + ".geo", stem + ".struct"] + [
            os.path.join(prm_dir, f) for f in sorted(os.listdir(prm_dir))
            if f.endswith((".geo", ".struct"))]
        path = next((c for c in candidates if os.path.exists(c)), None)
        if path is None:
            raise FileNotFoundError(
                f"mesh file {params.mesh_filename!r} not found "
                f"(src/claw.cc:961 fatal)")
    if path.endswith(".struct"):
        # the O-mesh (naca.struct): wrap-periodic in xi, the airfoil at
        # eta = 0 (boundary id 0), the farfield at eta = max (id 1)
        cmesh = load_struct(path)
        side_bids = {"W": np.full(cmesh.ny, -2), "E": np.full(cmesh.ny, -2),
                     "S": np.full(cmesh.nx, 0), "N": np.full(cmesh.nx, 1)}
        return cmesh, None, side_bids
    dom = load_geo(path) if path.endswith(".geo") else load_msh(path)
    return dom.mesh, dom.mask, dom.side_bids


def build_bcs(params: AllParameters, side_bids: dict):
    """Map the boundary_N config table onto the four domain sides
    (dflo_tpu/cli.py:83-106): id -2 is the O-mesh's periodic wrap, a
    negative id (a bounding-box edge behind a solid region) or an id
    without a boundary_N entry a slip wall; a side with several ids is a
    SegmentedSide."""
    wall = BoundarySide(euler.BC_SLIP)
    sides = {}
    for name, bids in side_bids.items():
        uniq = sorted(set(int(b) for b in bids))
        segs, seg_of = [], {}
        for b in uniq:
            spec = params.boundary_conditions.get(b)
            if b == -2:
                segs.append(BoundarySide(euler.BC_PERIODIC))
            elif b < 0 or spec is None:
                segs.append(wall)
            else:
                segs.append(BoundarySide(spec.kind, spec.values))
            seg_of[b] = len(segs) - 1
        seg_id = np.array([seg_of[int(b)] for b in bids], np.int32)
        sides[name] = (segs[0] if len(segs) == 1
                       else SegmentedSide(seg_id, tuple(segs)))
    return sides


def build_ic(params: AllParameters):
    if params.ic_function in ic_mod.IC_FUNCTIONS:
        return ic_mod.IC_FUNCTIONS[params.ic_function](params)
    return params.initial_conditions


def set_ic(params: AllParameters, solver):
    """The initial state, solid cells pinned: the setters that branch on
    the cell centre (IC_CELLWISE) through
    set_initial_condition_cellcentered, every other IC set on the basis
    (dflo_tpu/cli.py:108-125)."""
    kw = dict(dtype=solver.dtype, device=solver.device)
    if params.ic_function in ic_mod.IC_CELLWISE:
        fn = ic_mod.IC_CELLWISE[params.ic_function](params)
        u = ic_mod.set_initial_condition_cellcentered(solver.basis,
                                                      solver.mesh, fn, **kw)
    else:
        u = ic_mod.set_initial_condition(solver.basis, solver.mesh,
                                         build_ic(params), **kw)
    return solver.apply_mask(u)


def build_source(params: AllParameters):
    """The body force of the configuration (dflo_tpu/cli.py:130-147):
    `gravity` g as the constant force (0, -g), else the `f_0`/`f_1`
    expressions as an external force, else None."""
    if params.gravity != 0.0:
        return euler.GravitySource(0.0, -params.gravity)
    if params.external_force is not None:
        return euler.ExternalForce(params.external_force)
    return None


def build_solver(params: AllParameters, prm_dir: str = ".", domain=None, *,
                 dtype: torch.dtype, device, **solver_kw):
    """(solver, mask) of the configuration; solver_kw go to Solver (e.g.
    volume_kernel, post_kernel).  A steady implicit solve on an unmasked
    single-device grid that halves gets its 2x-coarsened companion as
    ``solver.steady_coarse`` (dflo_tpu/cli.py:298-320): the Cartesian mesh
    at half the cells, or a curvilinear block's every other node."""
    mesh, mask, side_bids = (domain if domain is not None
                             else build_domain(params, prm_dir))
    if params.refinement.do_refine:
        raise _later("refinement = true", "amr")
    basis = make_basis({"Qk": "Qk", "Pk": "Pk", "GLL": "Qk_gll"}[params.basis],
                       params.degree)
    well_balanced = None
    if (params.potential is not None and params.gravity == 0.0
            and params.external_force is None):
        # the potential is the force description (src_gll/parameters.cc:
        # 358); beside a `gravity` constant it is documentation only, as
        # the reference trees never apply both (dflo_tpu/cli.py:231-238)
        well_balanced = params.well_balanced
    lim = LimiterConfig(
        type=params.limiter.type,
        shock_indicator=params.limiter.shock_indicator,
        M=params.limiter.M, beta=params.limiter.beta,
        char_lim=params.limiter.char_lim, pos_lim=params.limiter.pos_lim,
        conserve_angular_momentum=params.limiter.conserve_angular_momentum)
    if params.solver.method == "mood":
        method = "mood"
    elif params.solver.implicit:
        method = "implicit"
    else:
        method = "rk"
    # `time step = ...` with cfl <= 0 (src/claw.cc:455-459)
    fixed_dt = (params.time_step if (params.cfl <= 0 and params.time_step > 0
                                     and not params.is_stationary) else None)
    bcs = build_bcs(params, side_bids)
    source = build_source(params)
    common = dict(flux=params.flux.flux, limiter=lim, cfl=params.cfl,
                  dtype=dtype, device=device, method=method, source=source,
                  well_balanced=well_balanced, potential=params.potential,
                  theta=params.theta, max_nonlin_iter=params.max_nonlin_iter,
                  linear_residual=params.solver.linear_residual,
                  time_step_type=params.time_step_type,
                  mass_matrix=params.mass_matrix)
    solver = Solver(basis, mesh, bcs, mask=mask, fixed_time_step=fixed_dt,
                    **common, **solver_kw)
    if (params.is_stationary and method == "implicit" and mask is None
            and solver_kw.get("device_mesh") is None
            and mesh.ny % 2 == 0 and mesh.nx % 2 == 0):
        # the coarse companion of grid-sequenced steady solves
        # (run_steady_sequenced)
        if isinstance(mesh, CurvilinearMesh):
            cmesh = CurvilinearMesh(mesh.X[::2, ::2].copy(),
                                    mesh.Y[::2, ::2].copy())
        else:
            cmesh = CartesianMesh(mesh.nx // 2, mesh.ny // 2, mesh.x0,
                                  mesh.x1, mesh.y0, mesh.y1)
        kw = {k: v for k, v in solver_kw.items() if k != "device_mesh"}
        solver.steady_coarse = Solver(basis, cmesh, bcs, **common, **kw)
    return solver, mask


def mesh_of(n: int, device: torch.device, mesh):
    """The device mesh of --devices n: n distinct cards (raises if fewer
    are visible; never a virtual mesh), or n blocks on the CPU, in the
    most-square shape that divides the grid."""
    shape = compatible_shape(n, mesh.ny, mesh.nx)
    if shape is None:
        raise ValueError(f"--devices {n}: no mesh of {n} divides the "
                         f"{mesh.nx} x {mesh.ny} grid")
    if device.type == "cpu":
        return device_mesh(shape, [device] * n)
    visible = torch.cuda.device_count()
    if visible < n:
        raise RuntimeError(f"--devices {n} needs {n} cards, {visible} are "
                           f"visible")
    return device_mesh(shape, [torch.device("cuda", i) for i in range(n)])


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="dflo_tpu_torch",
        description="DG Euler solver on one NVIDIA GPU (PyTorch + CUDA)")
    ap.add_argument("prm", help="deal.II-style .prm configuration file")
    ap.add_argument("--output-dir", default="output")
    ap.add_argument("--final-time", type=float, default=None,
                    help="override the config's final time")
    ap.add_argument("--max-steps", type=int, default=10**7,
                    help="stop after N time steps")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a checkpoint every N outputs")
    ap.add_argument("--platform", default=None, choices=("cuda", "cpu"),
                    help="the device (default: the CUDA card; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--x64", action="store_true",
                    help="run in float64 (default float32)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="steps per host round trip (cadences are then "
                         "chunk-granular)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the domain over N devices: N cards, or N "
                         "CPU blocks with --platform cpu")
    ap.add_argument("--slices", type=int, default=0,
                    help="with --devices: S slices (not ported)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the time loop to "
                         "DIR/trace.json")
    return ap.parse_args(argv)


class CliRun(NamedTuple):
    """What a CLI run leaves: the solver, the final state (gathered onto the
    first device under a mesh), time and steps."""
    solver: Solver
    u: torch.Tensor
    t: float
    it: int
    #: a steady solve's ||R|| histories, one per level (coarse, fine), or
    #: None for a time-marching run
    steady_levels: list | None = None


def run(argv=None) -> CliRun:
    """The CLI's run (see the module docstring); returns its CliRun."""
    args = parse_args(argv)
    if args.slices:
        raise _later("--slices", "devices")
    if args.platform == "cpu":
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass --platform cpu to run on the CPU")
    dtype = torch.float64 if args.x64 else torch.float32

    t_wall = time.time()
    timer = Timer()
    params = AllParameters.from_prm_file(args.prm)
    prm_dir = os.path.dirname(os.path.abspath(args.prm))
    with timer("Setup"):
        domain = build_domain(params, prm_dir)
        dm = (mesh_of(args.devices, device, domain[0]) if args.devices
              else None)
        solver, mask = build_solver(params, prm_dir, domain, dtype=dtype,
                                    device=device, device_mesh=dm)
    basis, mesh = solver.basis, solver.mesh
    print(f"dflo_tpu_torch: {basis.family}{basis.degree}, mesh "
          f"{mesh.nx}x{mesh.ny}, flux={params.flux.flux}, "
          f"limiter={params.limiter.type}, {dtype}, {device}")

    u = set_ic(params, solver)
    t0 = 0.0
    if args.resume:
        u_np, t0, _, _ = load_checkpoint(args.resume, basis=basis, mesh=mesh)
        u = torch.as_tensor(u_np).to(dtype=dtype, device=device).contiguous()
    if dm is not None:
        u = solver.shard(u)

    def whole(u):
        """The whole state (the blocks gathered under a mesh)."""
        return u if isinstance(u, torch.Tensor) else solver.gather(u)

    t_end = (args.final_time if args.final_time is not None
             else params.final_time)
    out_iter = params.output.output_iter_step
    out_tstep = params.output.output_time_step
    next_out_t = [out_tstep]          # src/claw.cc:1093-1099 time cadence
    ang_iter = params.output.ang_mom_step
    snap = [0]
    tecplot = params.output.format == "tecplot"
    # the mu_shock diagnostic field (src/mu_shock.cc:288-374), written with
    # each VTU on one device's Cartesian mesh (dflo_tpu/cli.py:487-497)
    mu_fn = None
    if (params.diffusion_coef != 0.0 and not tecplot and dm is None
            and not solver.curvilinear):
        per_x = solver.bcs["W"].kind == euler.BC_PERIODIC
        per_y = solver.bcs["S"].kind == euler.BC_PERIODIC
        mu_fn = make_mu_shock(basis, mesh, params.diffusion_coef, per_x,
                              per_y, dtype=dtype, device=device,
                              bcs=solver.bcs)

    def write_snapshot(u, t):
        with timer("Output"):
            uw = whole(u)
            u_np = uw.detach().cpu().numpy()
            if tecplot:
                write_tecplot(os.path.join(args.output_dir,
                                           f"solution-{snap[0]:03d}.plt"),
                              basis, mesh, u_np, t=t, mask=mask)
            else:
                extra = None
                if mu_fn is not None:
                    extra = {"mu_shock": mu_fn(
                        uw, solver.cell_averages(uw), t).cpu().numpy()}
                write_vtu(os.path.join(args.output_dir,
                                       f"solution-{snap[0]:03d}.vtu"),
                          basis, mesh, u_np, t=t,
                          schlieren=params.output.schlieren_plot, mask=mask,
                          extra_cell_fields=extra)
            if args.checkpoint_every and snap[0] % args.checkpoint_every == 0:
                save_checkpoint(os.path.join(args.output_dir,
                                             f"checkpoint-{snap[0]:03d}.npz"),
                                u_np, t, snap[0], basis=basis, mesh=mesh)
        snap[0] += 1

    write_snapshot(u, t0)
    verbose = params.solver.output == "verbose"

    def callback(u, t, it):
        if it % 50 == 0 or t >= t_end - 1e-12 or verbose:
            line = f"  it={it:6d}  t={t:.6f}"
            stats = solver.last_stats
            if solver.method == "mood" and stats is not None:
                # cascade counters (src/claw.cc:851 printout)
                line += (f"  mood: reduce={int(stats.n_reduce)}"
                         f" limit={int(stats.n_marked)}"
                         f" passes={int(stats.iters)}")
            elif solver.method == "implicit" and stats is not None:
                # Newton residual and the linear solve's residual
                # (src/claw.cc:913-914, 1090)
                lin_res = float(stats.lin_res)
                line += (f"  newton: res={float(stats.res):.3e}"
                         f" iters={int(stats.iters)} lin_res={lin_res:.1e}")
                if lin_res > solver.linear_residual * 1.001:
                    # tolerated non-convergence (src/claw.cc:677-687)
                    line += "  WARNING: linear solver did not converge"
            elif verbose:
                # explicit per-step rhs norm (src/claw.cc:749,768-769)
                R = solver.rhs(u, t)
                sq = (float(torch.sum(R ** 2)) if isinstance(R, torch.Tensor)
                      else sum(float(torch.sum(r ** 2)) for r in R))
                res = sq ** 0.5
                line += f"  res={res:.3e}"
            print(line)
        if out_iter and it % out_iter == 0:
            write_snapshot(u, t)
        elif t + 1e-12 >= next_out_t[0]:
            write_snapshot(u, t)
            next_out_t[0] += out_tstep
        if ang_iter and it % ang_iter == 0:
            am = float(angular_momentum(basis, mesh, whole(u), mask))
            print(f"Total angular momentum: {t:18.8e} {am:24.14e}")

    trace = (device_trace(args.profile) if args.profile
             else contextlib.nullcontext())
    levels = None
    with timer("Time loop"), trace:
        if params.is_stationary and solver.method == "implicit":
            # pseudo-transient steady solve, grid-sequenced when a coarse
            # companion exists (dflo_tpu/cli.py:579-596)
            steady = dict(cfl0=params.cfl,
                          min_residual=params.min_residual or 1e-10,
                          max_steps=min(100000, args.max_steps), verbose=True)
            coarse = getattr(solver, "steady_coarse", None)
            if coarse is not None:
                levels = []
                u, hist = run_steady_sequenced(solver, coarse, u,
                                               levels=levels, **steady)
            else:
                u, hist = run_steady(solver, u, **steady)
                levels = [hist]
            t, it = t0, len(hist)
        else:
            u, t, it = solver.run(u, t_end, t0=t0, callback=callback,
                                  chunk=max(args.chunk, 1),
                                  max_steps=args.max_steps)
        u = whole(u)
        if u.is_cuda:
            torch.cuda.synchronize()
    write_snapshot(u, t)
    print(timer.summary())
    print(f"steps={it}  final t={t:.6f}  wall={time.time() - t_wall:.1f}s")
    return CliRun(solver, u, t, it, levels)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
