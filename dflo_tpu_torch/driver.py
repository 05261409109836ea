"""Solver driver: RK on the nodal Qk and GLL and the modal Pk bases, with
body forces and well-balanced gravity, the MOOD cascade on modal Pk, and
implicit (Newton-Krylov) stepping, time-accurate or pseudo-transient.

The torch counterpart of dflo_tpu/driver.py's ``Solver``:

- ``method="rk"``: each SSP stage is one fused residual pass (residual +
  blend) followed by the stage's post.  On collocated Qk with the TVB
  limiter the post is one fused pass (averages -> shock indicator ->
  characteristic TVB -> positivity), and the final stage's post also
  yields the next step's CFL wave speed and the fatal-negativity minimum.
  Everywhere else (the modal Pk and GLL bases, a Qk basis off its nodes,
  or limiter type "none") the post is
  the plain stab chain {indicator -> TVB -> positivity}, each step present
  only where configured, and the diag kernel reads the wave speed and
  the negativity minimum off the step's result.  A solid-cell mask (the
  forward step's obstacle) pins solid cells to a benign state before
  every post and freezes their residual; the kernels mirror the fluid
  state at fluid|solid faces.
- A source term (``source``: a body force; ``well_balanced`` with a
  ``potential``: the src_gll gravity forms) goes to make_rhs; the fused
  residual carries ``euler.GravitySource``, ``euler.ExternalForce`` and
  isothermal well-balancing in its kernel, and any other source callable
  and polytropic well-balancing resolve "auto" to the plain residual, as
  the reference's vol_ok does (dflo_tpu/driver.py:104-122).
- ``method="implicit"``: the theta-scheme through Newton-Krylov
  (solver/implicit.py): each Newton residual through the residual
  kernel's R form, each GMRES tangent a Jacobian-vector product of the
  plain residual (implicit.FusedPrimalRhs, the reference's fused_primal_rhs,
  dflo_tpu/driver.py:179-192), the post after every Newton update (the
  fused post on Gauss Qk with TVB, without its diag), dt from the diag
  kernel, and the predictor 2u - u_old carried from step to step on a
  global dt (src/claw.cc:1063-1065, 1101-1108).
- ``time_step_type="local"`` gives each cell its own dt (rk.local_dt; for
  RK each stage is then R and a torch blend), ``fixed_time_step`` a
  constant dt (`cfl <= 0` with a `time step`); the step's scalar dt (the
  global CFL value, or the fixed one) advances t.
- ``method="mood"``: each SSP stage runs the MOOD cascade (stab/mood.py)
  from the stage predictor, blends, pins solid cells, and runs the fused Pk
  post (modal TVB on the cells the cascade marked, then positivity); the
  final stage's Pk post yields the wave speed and the negativity minimum.
  Where the reference builds no fused Pk post (dflo_tpu/driver.py:
  322-326: a masked domain, limiter none, the angular-momentum option, or
  off the fused route) the stage's post is the plain limiter on the marked
  cells, if any, then the modal positivity kernel on the fused route with
  positivity on or else the plain positivity, if on
  (dflo_tpu/driver.py:457-466), and the diag kernel reads the wave speed
  and the negativity minimum off the step's result.  A body force
  (``euler.GravitySource`` or ``euler.ExternalForce``) rides the residual's
  source arm; such a cascade and a masked one take the dense route
  (stab/mood.MoodStage).  Off the fused route (``volume_kernel="xla"``, a
  source callable the kernel does not carry) or with positivity off the
  cascade takes MoodStage's plain arm, as the reference's make_mood does
  without its {truncation -> positivity} kernel.  The state before the
  first step goes through the plain stab chain (indicator -> modal TVB ->
  modal positivity), as the JAX package's post_stage does for Pk.  MOOD
  needs the Pk basis and a global dt (dflo_tpu/driver.py:64-66), and runs
  at every degree 1-6 the residual takes (on P1 its check is the plain
  one, as the reference's).

``volume_kernel`` and ``post_kernel`` select the forms as the reference's
Solver does (dflo_tpu/driver.py:104-138): "auto" takes the fused kernels
wherever the configuration is inside their envelope, as the reference does
on a TPU; "xla" runs the plain PyTorch residual or post chain,
``volume_kernel="pallas"`` the plain residual with its volume term through
``kernels.volume_residual``.  The full mass matrix (``mass_matrix="full"``)
runs on the plain residual (vol_ok, dflo_tpu/driver.py:117).  The fused
post exists for the collocated Qk TVB chain with the limiter, density or
energy indicator and without the angular-momentum option (the reference's
post_ok, dflo_tpu/driver.py:124-134); everywhere else (the minmax limiter,
the u2 and residual indicators, the Pk RK post) the post is the plain
chain on every device, in the reference too, which has no fused kernel
for it.  The residual indicator evaluates the solver's residual (the
kernel's R form on the fused route).  Each wrapper is chosen by the device of the state: on a
CUDA tensor it launches its kernel, on a CPU tensor it runs its plain
version, so the control flow is the same on both.

With ``device_mesh`` (parallel/sharding: a grid of devices, which may
repeat) the RK/TVB step on collocated Qk runs on the state split into
blocks, ``u`` a row-major list of ``[4, K, ly, lx]`` blocks (``shard`` and
``gather`` convert): per stage the sharded residual (the residual kernel on
each block, delta strips from the exchanged halo lines), the sharded post
(the post's block form on each block) and, with the diag, the max / min of
the blocks' (lam, minq) on the first block's device, where the step's
scalars (t, dt, bad) live.  The same chunked loop runs, with one host sync
per chunk.  The port's kernels take any block shape: a mesh needs only
``ny % DY == nx % DX == 0`` (the JAX package's sharded kernels also want
8 x 128-aligned blocks).

On a curvilinear block (a mesh with per-cell metric terms, ``mapping =
q1``: mesh/curvilinear.py) the residual is solver/spatial_curvi.py's plain
one on every device, as the reference keeps that path off its kernels
(dflo_tpu/driver.py:105, :145): "auto" resolves to the plain forms and an
explicit kernel form raises; the cell averages are metric-weighted, dt is
the curvilinear CFL dt every step (no carried wave speed, no per-cell dt)
and the fatal flag comes from those averages; the limiter is "none"
(positivity may be on), TVB, masks and well-balancing raise as in the
reference (dflo_tpu/driver.py:157-166).  Any side may be a SegmentedSide.

Configurations outside the ported slices raise NotImplementedError on
every device: a basis beyond the kernels' bounds (degree above 6 or more
than kernels.NQ_MAX quadrature points per direction: the bounds of the
general dims, ROADMAP), minmax on a q1 block (slice E); under a device
mesh, MOOD, implicit and local stepping, masks, source terms, curvilinear
blocks, the plain and volume_residual forms and the plain post chain
(slice G, the rest of multi-GPU).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.contract import basis_reduce
from dflo_tpu_torch.parallel.sharding import (block_shape, gather_state,
                                              shard_state)
from dflo_tpu_torch.solver import implicit as implicit_mod
from dflo_tpu_torch.solver import rk as rk_mod
from dflo_tpu_torch.solver.spatial import BoundarySide, _check_bcs, make_rhs
from dflo_tpu_torch.solver.spatial_curvi import (compute_dt_curvilinear,
                                                 make_rhs_curvilinear)
from dflo_tpu_torch.stab.indicator import make_shock_indicator
from dflo_tpu_torch.stab.limiter import make_minmax_limiter, make_tvb_limiter
from dflo_tpu_torch.stab.mood import MoodStats, make_mood
from dflo_tpu_torch.stab.positivity import (EPS, make_positivity_limiter,
                                            negative_average_flag)


@dataclasses.dataclass(frozen=True)
class LimiterConfig:
    """Mirrors Parameters::Limiter (src/parameters.h:241-256)."""
    type: str = "none"               # none | TVB | minmax
    shock_indicator: str = "limiter"  # limiter | density | energy | u2 |
                                      # residual
    M: float = 0.0
    beta: float = 1.0
    char_lim: bool = False
    pos_lim: bool = False
    conserve_angular_momentum: bool = False


def _where(cond, new, old):
    """torch.where over a state or, under a mesh, each block (cond, a 0-dim
    bool on the first block's device, goes to each block's device)."""
    if isinstance(new, torch.Tensor):
        return torch.where(cond, new, old)
    return [torch.where(cond.to(n.device, non_blocking=True), n, o)
            for n, o in zip(new, old)]


def _fused_post_takes(basis, limiter: LimiterConfig) -> bool:
    """The configurations the fused post carries (the reference's post_ok,
    dflo_tpu/driver.py:124-134): collocated Gauss Qk with the TVB limiter,
    the limiter, density or energy indicator and no angular-momentum
    option."""
    return (basis.family == "Qk" and basis.is_nodal_collocated
            and limiter.type == "TVB"
            and not limiter.conserve_angular_momentum
            and limiter.shock_indicator in ("limiter", "density", "energy"))


def _kernel_forms(basis, flux: str, method: str, limiter: LimiterConfig,
                  volume_kernel: str, post_kernel: str, source=None,
                  well_balanced: str | None = None,
                  mass_matrix: str = "diagonal") -> tuple[str, str]:
    """Resolve "auto" as the reference does (dflo_tpu/driver.py:104-138):
    the fused residual wherever the configuration is inside its envelope
    (any Qk, GLL or Pk basis of degree 1-6 on any quadrature, any of the
    six fluxes, no source term or one of the kernel's source arms: a
    GravitySource, an ExternalForce or isothermal well-balancing; the
    diagonal mass matrix), the fused post on collocated Gauss Qk with the
    TVB limiter, without the angular-momentum option, and the limiter,
    density or energy indicator (the reference's post_ok), else the plain
    forms.  A basis beyond the kernels' bounds
    raises where the Solver builds its operators (kernels.beyond_caps), on
    every device: the reference runs its kernels there, and no device runs
    it on the plain path instead."""
    vol_ok = (flux in kernels.FLUXES
              and kernels.carries_source(source, well_balanced)
              and mass_matrix == "diagonal")
    post_ok = vol_ok and _fused_post_takes(basis, limiter)
    if volume_kernel == "auto":
        volume_kernel = "fused" if vol_ok else "xla"
    if post_kernel == "auto":
        post_kernel = "fused" if post_ok else "xla"
    if volume_kernel not in ("fused", "pallas", "xla"):
        raise ValueError(f"unknown volume kernel {volume_kernel!r}")
    if post_kernel not in ("fused", "xla"):
        raise ValueError(f"unknown post kernel {post_kernel!r}")
    if method in ("rk", "implicit") and post_kernel == "fused" and not post_ok:
        raise ValueError("post_kernel='fused' covers the collocated Qk TVB "
                         "chain only, on Gauss nodes, with the limiter, "
                         "density or energy indicator and no angular-"
                         "momentum option (dflo_tpu/driver.py:124-140)")
    return volume_kernel, post_kernel


def _mesh_later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} under a device mesh is not ported yet; it comes with "
        f"slice G, the rest of multi-GPU (ROADMAP)")


def _check_curvilinear(cfg: LimiterConfig, mask, well_balanced, device_mesh,
                       volume_kernel: str, post_kernel: str) -> None:
    """What a curvilinear block (mapping = q1) refuses, as the reference
    does (dflo_tpu/driver.py:157-166, :105, :145): the TVB limiter, masks,
    well-balancing, the kernels' forms (their residual, post and diag are
    Cartesian; "auto" resolves to the plain forms there), and here also the
    minmax limiter (the reference's runs through its unstructured view) and
    a device mesh."""
    if cfg.type == "TVB":
        raise ValueError(
            "the TVB limiter requires the cartesian mapping "
            "(src/parameters.cc:545-546); q1 meshes use the mapping-general "
            "minmax limiter (src_mpi/limiter.cc:397-555)")
    if mask is not None or well_balanced is not None:
        raise ValueError("masks / well-balanced gravity are Cartesian-path "
                         "features")
    if cfg.type == "minmax":
        raise NotImplementedError(
            "the minmax limiter on a q1 block is not ported yet; it runs on "
            "the unstructured view of the block and comes with slice E, "
            "unstructured meshes (ROADMAP)")
    if volume_kernel not in ("auto", "xla") or post_kernel not in ("auto",
                                                                   "xla"):
        raise ValueError(
            f"volume_kernel={volume_kernel!r} / post_kernel={post_kernel!r}:"
            f" a curvilinear block has no kernel form; its residual, post "
            f"and dt are plain PyTorch, as the reference's are XLA "
            f"(dflo_tpu/driver.py:105, :145)")
    if device_mesh is not None:
        raise _mesh_later("a curvilinear block")


class Solver:
    """DG solver on a Cartesian mesh or a curvilinear block, on one device
    or (RK/TVB on collocated Qk, device_mesh) on a mesh of blocks: RK on
    nodal Qk or GLL
    or modal Pk (method="rk"), the MOOD cascade on modal Pk
    (method="mood") or the implicit theta-scheme (method="implicit":
    theta, max_nonlin_iter, linear_residual, gmres_restart,
    gmres_maxiter, precondition None or "block_jacobi", as
    dflo_tpu/driver.py:43-67); fixed_time_step and time_step_type
    ("global" or "local") for every method but MOOD's global dt; source,
    well_balanced, potential and polytropic_nu as make_rhs takes them."""

    def __init__(self, basis: basis_mod.Basis, mesh,
                 bcs: dict[str, BoundarySide], flux: str = "lxf",
                 limiter: LimiterConfig | None = None, cfl: float = 0.9, *,
                 dtype: torch.dtype, device, scheme: str | None = None,
                 method: str = "rk", mask=None,
                 solid_state=(0.0, 0.0, 1.0, 2.5),
                 volume_kernel: str = "auto", post_kernel: str = "auto",
                 source=None, well_balanced: str | None = None,
                 potential=None, polytropic_nu: float = 1.2,
                 device_mesh=None, theta: float = 1.0,
                 max_nonlin_iter: int = 1, linear_residual: float = 1e-4,
                 gmres_restart: int = 30, gmres_maxiter: int = 10,
                 precondition: str | None = None,
                 fixed_time_step: float | None = None,
                 time_step_type: str = "global",
                 mass_matrix: str = "diagonal"):
        if method not in ("rk", "mood", "implicit"):
            raise ValueError(f"unknown solver method {method!r}")
        if time_step_type not in ("global", "local"):
            raise ValueError(f"unknown time step type {time_step_type!r}")
        if time_step_type == "local" and method == "mood":
            raise ValueError("MOOD requires global time stepping "
                             "(src/parameters.cc:536-544)")
        if precondition not in (None, "block_jacobi"):
            raise ValueError(f"unknown preconditioner {precondition!r}")
        modal = basis.family == "Pk"
        if method == "mood" and not modal:
            raise ValueError("MOOD requires the Pk basis "
                             "(src/parameters.cc:541-544)")
        if device_mesh is not None:
            if method == "mood":
                raise _mesh_later("the MOOD cascade")
            if mask is not None:
                raise _mesh_later("a solid-cell mask")
            if source is not None or well_balanced is not None:
                raise _mesh_later("a body force or well-balanced gravity")
            if method == "implicit":
                raise _mesh_later("implicit stepping")
            if time_step_type == "local":
                raise _mesh_later("local time stepping")
            if torch.device(device).type != device_mesh.flat[0].type:
                raise ValueError(f"device {device} is not of the mesh's "
                                 f"type ({device_mesh.flat[0].type})")
            block_shape(device_mesh, mesh.ny, mesh.nx)
        cfg = limiter or LimiterConfig()
        # curvilinear blocks (mapping = q1) carry per-cell metric terms
        curvilinear = hasattr(mesh, "metric")
        if curvilinear:
            _check_curvilinear(cfg, mask, well_balanced, device_mesh,
                               volume_kernel, post_kernel)
            volume_kernel = post_kernel = "xla"
        if cfg.type not in ("none", "TVB", "minmax"):
            raise ValueError(f"unknown limiter type {cfg.type!r}")
        volume_kernel, post_kernel = _kernel_forms(
            basis, flux, method, cfg, volume_kernel, post_kernel, source,
            well_balanced, mass_matrix)
        if device_mesh is not None and (volume_kernel, post_kernel) != (
                "fused", "fused"):
            raise _mesh_later(f"volume_kernel={volume_kernel!r} / "
                              f"post_kernel={post_kernel!r}")
        self.basis = basis
        self.mesh = mesh
        self.bcs = bcs
        self.flux = flux
        self.cfl = cfl
        self.fixed_time_step = fixed_time_step
        self.time_step_type = time_step_type
        self.dtype = dtype
        self.device_mesh = device_mesh
        # under a mesh the step's scalars live on the first block's device
        self.device = (torch.device(device) if device_mesh is None
                       else device_mesh.flat[0])
        self.method = method
        self.limiter_cfg = cfg
        self.curvilinear = curvilinear
        self.volume_kernel, self.post_kernel = volume_kernel, post_kernel
        per_x, per_y = _check_bcs(bcs)
        self.mask = None if mask is None else np.asarray(mask, bool)
        if self.mask is not None:
            self._fmask = torch.as_tensor(self.mask, device=self.device)
            self._u_solid = torch.tensor(solid_state, dtype=dtype,
                                         device=self.device)[:, None, None,
                                                             None]

        if curvilinear:
            # the plain curvilinear residual on every device, as the
            # reference's XLA one (dflo_tpu/driver.py:157-169)
            self.rhs = make_rhs_curvilinear(basis, mesh, bcs, flux=flux,
                                            source=source, dtype=dtype,
                                            device=self.device)
        else:
            self.rhs = make_rhs(basis, mesh, bcs, flux=flux, dtype=dtype,
                                device=self.device,
                                volume_kernel=volume_kernel, mask=self.mask,
                                source=source, well_balanced=well_balanced,
                                potential=potential,
                                polytropic_nu=polytropic_nu,
                                mass_matrix=mass_matrix,
                                device_mesh=device_mesh)
        if method == "implicit" and volume_kernel == "fused":
            # Newton-Krylov on the kernel: its R form for the primal, the
            # plain residual's Jacobian-vector products for the tangent
            # (dflo_tpu/driver.py:179-192)
            self.rhs = implicit_mod.FusedPrimalRhs(self.rhs, make_rhs(
                basis, mesh, bcs, flux=flux, dtype=dtype, device=self.device,
                volume_kernel="xla", mask=self.mask, source=source,
                well_balanced=well_balanced, potential=potential,
                polytropic_nu=polytropic_nu))

        def diag_ops(dev):
            return kernels.diag_operators(basis, mesh, mask=self.mask,
                                          dtype=dtype, device=dev)

        def post_ops(dev):
            return kernels.post_operators(
                basis, mesh, indicator=cfg.shock_indicator, M=cfg.M,
                beta=cfg.beta, char_lim=cfg.char_lim, pos_lim=cfg.pos_lim,
                per_x=per_x, per_y=per_y, mask=self.mask, dtype=dtype,
                device=dev)

        # the RK and implicit post on collocated Gauss Qk with TVB, the
        # limiter, density or energy indicator and no angular-momentum
        # option: the fused post (or its plain version; RK takes its diag
        # form); every other post is the plain chain
        self._fused_chain = (method in ("rk", "implicit")
                             and _fused_post_takes(basis, cfg))
        if curvilinear:
            # no fused diag off Cartesian meshes (dflo_tpu/driver.py:145):
            # dt and the fatal flag come from the metric-weighted averages
            self._diag_ops = None
        elif device_mesh is None:
            self._diag_ops = diag_ops(self.device)
            if self._fused_chain:
                self._post_ops = post_ops(self.device)
        else:
            # one post operator set per distinct device, listed per block;
            # a diag set per block (each holds its kernel's workspace)
            by_dev = {d: post_ops(d) for d in dict.fromkeys(device_mesh.flat)}
            self._blk_diag_ops = [diag_ops(d) for d in device_mesh.flat]
            self._blk_post_ops = [by_dev[d] for d in device_mesh.flat]
        if modal:
            self._avg0 = kernels.mode0_mean(basis)
        # the plain stab chain {indicator -> TVB -> positivity}, each step
        # only where configured (dflo_tpu/driver.py:223-233, :389-408)
        dev = self.device
        self._indicator = self._limit = self._positivity = None
        if not self._fused_chain and cfg.type != "none":
            # the residual indicator evaluates the solver's residual
            # (dflo_tpu/driver.py:200-202)
            self._indicator = make_shock_indicator(
                basis, mesh, cfg.shock_indicator, per_x, per_y, self.mask,
                dtype=dtype, device=dev, rhs=self.rhs)
        if not self._fused_chain and cfg.type == "TVB":
            self._limit = make_tvb_limiter(
                basis, mesh, M=cfg.M, beta=cfg.beta, char_lim=cfg.char_lim,
                conserve_angular_momentum=cfg.conserve_angular_momentum,
                per_x=per_x, per_y=per_y, mask=self.mask, dtype=dtype,
                device=dev)
        elif cfg.type == "minmax":
            # dflo_tpu/driver.py:227-231 (Qk only: Pk raises ValueError)
            self._limit = make_minmax_limiter(
                basis, mesh, M=cfg.M, char_lim=cfg.char_lim, per_x=per_x,
                per_y=per_y, mask=self.mask, dtype=dtype, device=dev)
        if not self._fused_chain and cfg.pos_lim:
            self._positivity = make_positivity_limiter(basis, dtype=dtype,
                                                       device=dev)
        if method == "mood":
            self._mood_stage = make_mood(basis, mesh, self.rhs, per_x, per_y,
                                         mask=self.mask,
                                         positivity=cfg.pos_lim)
            # beside the reference's {truncation -> positivity} kernel (the
            # stage's fused route, dflo_tpu/driver.py:283-285), its fused Pk
            # post (:322-326: unmasked, TVB without angular momentum)
            self._pk_post_ops = None
            if (self._mood_stage.fused and self.mask is None
                    and cfg.type == "TVB"
                    and not cfg.conserve_angular_momentum):
                self._pk_post_ops = kernels.pk_post_operators(
                    basis, mesh, M=cfg.M, beta=cfg.beta,
                    char_lim=cfg.char_lim, per_x=per_x, per_y=per_y,
                    dtype=dtype, device=dev)
        self.ark, self.stage_times = rk_mod.rk_coeffs(
            scheme or rk_mod.default_scheme(basis.degree))
        self.precondition = precondition
        self.linear_residual = linear_residual
        if method == "implicit":
            # the stabilization chain after EVERY Newton update, where the
            # reference limits (src/claw.cc:905-911)
            self._implicit_step = implicit_mod.make_implicit_step(
                self.rhs, theta=theta, max_newton=max_nonlin_iter,
                lin_tol=linear_residual, gmres_restart=gmres_restart,
                gmres_maxiter=gmres_maxiter, precondition=precondition,
                post_update=self.post_stage)
        # global-dt implicit stepping seeds Newton with the predictor
        # 2u - u_old carried across steps (src/claw.cc:1063-1065,
        # 1101-1108); local (pseudo-transient) stepping does not
        self._carry_pred = (method == "implicit"
                            and time_step_type == "global")
        self._step = self._make_step()
        self._multi_cache: dict[int, Callable] = {}
        # the most recent step's summed MoodStats and its final stage's
        # limiter marks and degree map (MOOD only)
        self.last_stats = None
        self.last_lim = None
        self.last_deg = None

    # ------------------------------------------------------------------
    def _scalar(self, x) -> torch.Tensor:
        """A 0-dim tensor of the solver dtype on its device.  Python floats
        go through a fill, never a host-to-device copy."""
        if isinstance(x, torch.Tensor):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.full((), float(x), dtype=self.dtype, device=self.device)

    def shard(self, u):
        """A whole state -> the row-major block list of the device mesh."""
        return shard_state(u, self.device_mesh)

    def gather(self, blocks):
        """The block list -> the whole state on the first block's
        device."""
        return gather_state(blocks, self.device_mesh)

    def _diag(self, u):
        """(lam_max, minq) of the state (a block list under a mesh)."""
        if self.device_mesh is None:
            return kernels.fused_diag(u, self._diag_ops)
        return kernels.fused_diag_sharded(u, self._blk_diag_ops,
                                          self.device_mesh)

    def cell_averages(self, u):
        if self.curvilinear:
            # metric-weighted means (dflo_tpu/driver.py:372-373)
            return self.rhs.cell_averages(u)
        if self.basis.family == "Pk":
            # modal Legendre: mode 0 is the mean (dflo_tpu/driver.py:371)
            return self._avg0 * u[:, 0]
        return basis_reduce(self._diag_ops.avg, u)

    def apply_mask(self, u):
        """Freeze solid-masked cells at the benign reference state
        (dflo_tpu/driver.py:381-385)."""
        if self.mask is None:
            return u
        return torch.where(self._fmask, u, self._u_solid)

    def post_stage(self, u, t=0.0):
        """Stabilization chain after each RK stage (src/claw.cc:762-766),
        solid cells pinned first: the fused post (collocated Qk, TVB) or
        the plain chain {indicator -> TVB -> positivity} with the steps the
        limiter configuration has (dflo_tpu/driver.py:389-408); for MOOD
        the chain before the first step."""
        if self._fused_chain:
            return self._post()(self.apply_mask(u))
        u = self.apply_mask(u)
        if self._limit is None and self._positivity is None:
            return u
        ubar = self.cell_averages(u)
        if self._limit is not None:
            shock, _ = self._indicator(u, ubar, t)
            u = self._limit(u, ubar, shock)
        if self._positivity is not None:
            u = self._positivity(u, ubar)
        return u

    def _post_diag(self, u, t=0.0):
        """post_stage plus (lam_max, minq) of the stage's (fluid) cell
        averages."""
        return self._post()(self.apply_mask(u), with_diag=True)

    def _post(self):
        """The fused RK post chain (collocated Qk, TVB) as post(u,
        with_diag=False): the kernel, or (post_kernel="xla") its plain
        version on every device; under a mesh the sharded post over the
        block list."""
        if self.device_mesh is not None:
            return lambda u, with_diag=False: kernels.fused_post_sharded(
                u, self._blk_post_ops, self.device_mesh, with_diag)
        post = (kernels.fused_post if self.post_kernel == "fused"
                else kernels.fused_post_plain)
        return lambda u, with_diag=False: post(u, self._post_ops, with_diag)

    @property
    def host_syncs(self) -> int:
        """Host reads of device values inside steps so far: the MOOD
        cascade's one ``bool(chg.any())`` per pass (0 for RK; the implicit
        path counts its own in krylov_counts)."""
        return self._mood_stage.host_syncs if self.method == "mood" else 0

    @property
    def krylov_counts(self):
        """The implicit path's KrylovCounts (Newton iterations, restarts,
        tangents, primals, host reads), or None."""
        if self.method != "implicit":
            return None
        return self._implicit_step.counts

    def _bad(self, u):
        """The fatal flag of a state (0-dim bool, NaN-safe): a (fluid) cell
        average with density or pressure below EPS, from the diag, or on a
        curvilinear block from its metric-weighted averages
        (dflo_tpu/driver.py:554-559)."""
        if self.curvilinear:
            return negative_average_flag(self.cell_averages(u))
        return ~(self._diag(u)[1] >= EPS)

    def _local_dt(self, u):
        """The per-cell dt of `time step type = local` (rk.local_dt at the
        solver's CFL), zero on solid cells (dflo_tpu/driver.py:523-530)."""
        dt = rk_mod.local_dt(self.cell_averages(u), self.mesh,
                             self.basis.degree, self.cfl)
        if self.mask is not None:
            dt = torch.where(self._fmask, dt, torch.zeros_like(dt))
        return dt

    def _mood_rk_step(self, u, t, dt, live=None):
        """SSP stages with the MOOD cascade replacing plain forward-Euler
        updates (iterate_mood, src/claw.cc:777-871): each stage re-cascades
        from degree p, blends, pins solid cells, then runs the Pk post with
        the TVB limiter only on the cells the cascade marked
        (src/mood.cc:335-340) and positivity (src/claw.cc:866-869); where
        the reference builds no Pk post that post is the plain limiter on
        the marked cells, if any, then the modal positivity kernel on the
        fused route with positivity on, else the plain positivity, if on
        (dflo_tpu/driver.py:443-466).  Returns (u, summed MoodStats, (lam,
        minq) of the step's result: from the final stage's Pk post, else
        from the diag)."""
        u_old = u
        n_red = n_mark = None
        iters = 0
        n_st = len(self.ark)
        for si, (a, c) in enumerate(zip(self.ark, self.stage_times)):
            u_cand, marked, st, deg = self._mood_stage(u, t + c * dt, dt,
                                                       live=live)
            n_red = st.n_reduce if n_red is None else n_red + st.n_reduce
            n_mark = st.n_marked if n_mark is None else n_mark + st.n_marked
            iters += st.iters
            u = self.apply_mask(a * u_old + (1.0 - a) * u_cand)
            shock = marked.to(u.dtype) * 2.0
            last = si == n_st - 1
            if self._pk_post_ops is None:
                ubar = self.cell_averages(u)
                if self._limit is not None:
                    u = self._limit(u, ubar, shock)
                if self._mood_stage.fused:
                    u = kernels.fused_modal_pos(u, self.rhs.modal_ops)
                elif self._positivity is not None:
                    u = self._positivity(u, ubar)
                if last:
                    lam, minq = self._diag(u)
            elif last:
                u, lam, minq = kernels.fused_pk_post(u, shock,
                                                     self._pk_post_ops,
                                                     with_diag=True)
            else:
                u = kernels.fused_pk_post(u, shock, self._pk_post_ops)
            if last:
                self.last_lim, self.last_deg = marked, deg
        return u, MoodStats(n_red, n_mark, iters), (lam, minq)

    def _make_step(self, carry_lam: bool = False):
        """step(u, t, t_end) -> (u, dt, bad, stats); carry_lam=True builds
        step(u, t, t_end, lam_prev) -> (..., lam_next) for the chunked loop:
        the wave speed comes from the previous step's final-stage post (the
        fused post for RK, the Pk post for MOOD: both preserve cell means)
        or, after the plain chain, from the diag of the step's result,
        instead of a whole-state diag pass at the start of every step
        (dflo_tpu/driver.py:469-489).
        Nothing in it waits for the device, except the MOOD cascade's one
        read per pass and the implicit path's reads (per GMRES restart and
        Newton iteration); live (a 0-dim bool tensor) stops the cascade of a
        step the chunked loop discards.  dt is the fixed time step, or the
        global CFL dt; with a local time step each cell takes its own
        (rk.local_dt) and the global one advances t.  Implicit:
        step(u, t, t_end, pred=None) -> (u, dt, bad, NewtonInfo) with the
        Newton seed pred, and with a global dt also the next step's seed
        2u - u_old as a fifth value."""
        denom = 2.0 * self.basis.degree + 1.0

        def step(u, t, t_end, lam_prev=None, live=None, pred=None):
            u_in = u
            t = self._scalar(t)
            t_end = self._scalar(t_end)
            if self.fixed_time_step is not None:
                # `time step = ...` with cfl <= 0 (src/claw.cc:455-459)
                dt = self._scalar(self.fixed_time_step)
            elif self.curvilinear:
                dt = compute_dt_curvilinear(self.cell_averages(u), self.mesh,
                                            self.basis.degree, self.cfl)
            else:
                lam = lam_prev if carry_lam else self._diag(u)[0]
                dt = self.cfl / lam / denom
            dt = torch.minimum(dt, t_end - t)
            # no per-cell dt on a curvilinear block (dflo_tpu/driver.py:524)
            dt_field = (self._local_dt(u) if self.time_step_type == "local"
                        and not self.curvilinear else None)
            stats = ()
            if self.method == "implicit":
                u, info = self._implicit_step(
                    u, t, dt if dt_field is None else dt_field,
                    u_guess=pred if self._carry_pred else None)
                # Newton divergence aborts the run like the reference's
                # AssertThrow (src/claw.cc:919-923)
                bad = self._bad(u) | info.diverged
                out = (u, dt, bad, info)
                if self._carry_pred:
                    # the next step's Newton seed (src/claw.cc:1104-1108)
                    out = out + (2.0 * u - u_in,)
                return out
            if self.method == "mood":
                u, stats, (lam_new, minq) = self._mood_rk_step(u, t, dt, live)
                self.last_stats = stats
            elif self._fused_chain:
                u, lam_new, minq = rk_mod.ssp_rk_step(
                    self.rhs, u, t, dt, self.ark, self.stage_times,
                    post_stage=self._post_diag, post_diag=True,
                    dt_field=dt_field)
            else:
                # the plain chain preserves cell means too: one diag of the
                # step's result gives the next wave speed and the flag
                u = rk_mod.ssp_rk_step(self.rhs, u, t, dt, self.ark,
                                       self.stage_times,
                                       post_stage=self.post_stage,
                                       dt_field=dt_field)
                # a curvilinear block has no diag: its flag comes from its
                # averages, and so does its next dt (no wave speed carried,
                # dflo_tpu/driver.py:481-482)
                lam_new, minq = ((None, None) if self.curvilinear
                                 else self._diag(u))
            bad = (self._bad(u) if self.curvilinear
                   else ~(minq >= EPS))     # NaN-safe
            if carry_lam:
                return u, dt, bad, stats, lam_new
            return u, dt, bad, stats
        return step

    def _multi_step(self, chunk: int):
        """A loop of `chunk` steps with no host sync inside
        (dflo_tpu/driver.py:573): t, the Kahan compensator, the step count
        and `bad` stay 0-dim device tensors, and a step takes effect only
        while t < t_end - 1e-12 and `bad` is unset.  Returns
        multi(u, t, t_end) -> (u, t, n_done, bad, stats).  stats (MOOD):
        MoodStats summed over the chunk, the counts over the steps that took
        effect and the passes over every step dispatched (the JAX loop
        returns the last step's); () for RK.  Implicit: the steps' own host
        reads make a device-only loop moot, so the loop reads `live` before
        each step and stops there; stats is the last step's NewtonInfo,
        and the predictor starts from the chunk's first state
        (dflo_tpu/driver.py:595-599)."""
        if chunk not in self._multi_cache and self.method == "implicit":
            self._multi_cache[chunk] = self._multi_implicit(chunk)
        if chunk not in self._multi_cache:
            step = self._make_step(carry_lam=True)

            def multi(u, t, t_end):
                t = self._scalar(t)
                t_end = self._scalar(t_end)
                comp = torch.zeros_like(t)
                it = torch.zeros((), dtype=torch.int64, device=self.device)
                bad = torch.zeros((), dtype=torch.bool, device=self.device)
                # seed once per chunk; thereafter the wave speed comes free
                # from the final stage's fused post diagnostics
                lam = None if self.curvilinear else self._diag(u)[0]
                stats = ()
                for _ in range(chunk):
                    live = (t < t_end - 1e-12) & ~bad
                    un, dt, bad_n, st, lam_n = step(u, t, t_end, lam, live)
                    if st:
                        st = MoodStats(st.n_reduce * live, st.n_marked * live,
                                       st.iters)
                        stats = st if not stats else MoodStats(
                            *(a + b for a, b in zip(stats, st)))
                    u = _where(live, un, u)
                    y = dt - comp
                    t2 = t + y
                    comp = torch.where(live, (t2 - t) - y, comp)
                    t = torch.where(live, t2, t)
                    it = it + live.to(it.dtype)
                    bad = bad | (live & bad_n)
                    if not self.curvilinear:
                        lam = torch.where(live, lam_n, lam)
                return u, t, it, bad, stats

            self._multi_cache[chunk] = multi
        return self._multi_cache[chunk]

    def _multi_implicit(self, chunk: int):
        """_multi_step's implicit loop (see there)."""
        step = self._step

        def multi(u, t, t_end):
            t = self._scalar(t)
            t_end = self._scalar(t_end)
            comp = torch.zeros_like(t)
            it = torch.zeros((), dtype=torch.int64, device=self.device)
            bad = torch.zeros((), dtype=torch.bool, device=self.device)
            pred = u
            stats = ()
            for _ in range(chunk):
                self._implicit_step.counts.host_reads += 1
                if not bool((t < t_end - 1e-12) & ~bad):
                    break
                if self._carry_pred:
                    u, dt, bad, stats, pred = step(u, t, t_end, pred=pred)
                else:
                    u, dt, bad, stats = step(u, t, t_end)
                y = dt - comp
                t2 = t + y
                comp = (t2 - t) - y
                t = t2
                it = it + 1
            return u, t, it, bad, stats

        return multi

    # ------------------------------------------------------------------
    def run(self, u, t_end: float, t0: float = 0.0,
            callback: Callable | None = None, max_steps: int = 10**7,
            chunk: int = 1):
        """Advance u from t0 to t_end; callback(u, t, it) after every chunk.
        chunk > 1 runs that many steps per host round trip (one sync per
        chunk); failure flags and callbacks are then checked per chunk."""
        t, it = t0, 0
        # the reference limits the freshly-set IC before the first step
        # (src/claw.cc:997-1001)
        u = self.post_stage(u, t0)
        if chunk > 1:
            multi = self._multi_step(chunk)
            tdev = self._scalar(t)
            while t < t_end - 1e-12 and it < max_steps:
                u, tdev, n, bad, stats = multi(u, tdev, t_end)
                self.last_stats = stats or None
                if bool(bad):
                    raise FloatingPointError(
                        f"negative density/pressure cell average (or Newton "
                        f"divergence) near t={float(tdev)!r} "
                        f"(src/positivity.cc:26-39 fatal condition)")
                t = float(tdev)
                it += int(n)
                if callback is not None:
                    callback(u, t, it)
                if int(n) == 0:
                    # the device loop (solver-dtype comparison) considers the
                    # run finished while host-double t is still below
                    # t_end - 1e-12: stop instead of re-dispatching
                    # zero-step chunks forever
                    break
            return u, t, it
        pred = u if self._carry_pred else None
        while t < t_end - 1e-12 and it < max_steps:
            if self._carry_pred:
                u, dt, bad, stats, pred = self._step(u, t, t_end, pred=pred)
            else:
                u, dt, bad, stats = self._step(u, t, t_end)
            if self.method == "implicit":
                self.last_stats = stats
            if bool(bad):
                raise FloatingPointError(
                    f"negative density/pressure cell average (or Newton "
                    f"divergence) at t={t!r} (src/positivity.cc:26-39 "
                    f"fatal condition)")
            t += float(dt)
            it += 1
            if callback is not None:
                callback(u, t, it)
            if float(dt) <= 0.0:
                # the solver-dtype clamp dt = min(dt, t_end - t) returned 0
                # (f32 half-ulp window below t_end): final time reached at
                # solver precision, and t += 0 would spin forever
                break
        return u, t, it

