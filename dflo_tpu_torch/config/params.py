"""Structured runtime configuration mirroring Parameters::AllParameters.

A copy of dflo_tpu/config/params.py over the port's own expression
compiler (expressions compile to torch functions) and boundary kinds
(physics/euler's BC_* codes).  Re-implements the reference's config layer (src/parameters.h:112-414,
src/parameters.cc:10-551) as plain dataclasses parsed from a .prm dict:
per-subsystem groups (Solver/Refinement/Flux/Limiter/Output), up to 10
boundary-condition entries with expression values, expression ICs, and the
reference's cross-field validation rules (src/parameters.cc:536-550).
Also folds in the MPI tree's periodic boundaries
(src_mpi/parameters.cc:397-410, 524-558) and the GLL tree's gravity
potential + mass matrix options (src_gll/parameters.cc:335-358, 342).

Unknown keys raise, mimicking ParameterHandler's strict schema.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from dflo_tpu_torch.config.expressions import (compile_expression,
                                               compile_vector_expression)
from dflo_tpu_torch.config.prm import parse_prm_file
from dflo_tpu_torch.physics import euler

MAX_N_BOUNDARIES = 10  # src/parameters.h:375

N_COMP = 4


def _bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes")


@dataclasses.dataclass
class SolverParams:
    """subsection 'linear solver' (src/parameters.cc:10-92)."""
    output: str = "quiet"
    method: str = "rk3"          # direct|gmres|umfpack|rk3|mood
    linear_residual: float = 1e-10
    max_iterations: int = 300
    ilut_fill: float = 2.0
    ilut_atol: float = 1e-9
    ilut_rtol: float = 1.1
    ilut_drop: float = 1e-10

    @property
    def implicit(self) -> bool:
        return self.method in ("direct", "gmres", "umfpack")


@dataclasses.dataclass
class RefinementParams:
    """subsection 'refinement' (src/parameters.cc:96-142)."""
    do_refine: bool = True
    time_step: float = 1.0e20
    iter_step: int = 100000000
    refine_fraction: float = 0.1
    unrefine_fraction: float = 0.1
    max_elements: int = 1000000
    shock_value: float = 4.0
    shock_levels: int = 3
    #: extension: refinement tile edge (cells).  0 = auto (prefers 2);
    #: 1 = per-cell flags, exact parity with src/refine.cc:48-60; larger
    #: tiles trade refined-cell overshoot for pool capacity (the per-event
    #: accounting prints the overhead either way)
    tile: int = 0


@dataclasses.dataclass
class FluxParams:
    """subsection 'flux' (src/parameters.cc:145-192 + kep
    src_mpi/parameters.cc:180)."""
    flux: str = "lxf"            # lxf|sw|roe|hllc|kfvs|kep
    stab_kind: str = "mesh"      # mesh|constant
    stab_value: float = 1.0


@dataclasses.dataclass
class LimiterParams:
    """subsection 'limiter' (src/parameters.cc:195-257 + minmax
    src_mpi/parameters.h:235, residual src_gll/parameters.cc:200)."""
    shock_indicator: str = "limiter"  # limiter|density|energy|u2|residual
    type: str = "none"                # none|TVB|minmax
    char_lim: bool = False
    pos_lim: bool = False
    M: float = 0.0
    beta: float = 1.0
    conserve_angular_momentum: bool = False


@dataclasses.dataclass
class OutputParams:
    """subsection 'output' (src/parameters.cc:260-313)."""
    schlieren_plot: bool = False
    output_time_step: float = 1e20
    output_iter_step: int = 1000000
    format: str = "vtk"               # vtk|tecplot
    ang_mom_step: int = 10000000


@dataclasses.dataclass
class BoundaryConditionSpec:
    """One boundary_N subsection (src/parameters.cc:380-398 + periodic
    src_mpi/parameters.cc:397-410)."""
    kind: int = euler.BC_OUTFLOW
    values: Callable | None = None     # (x, y, t) -> [4, ...]
    periodic_pair: int | None = None
    periodic_direction: str | None = None


_BC_KINDS = {
    "slip": euler.BC_SLIP,
    "inflow": euler.BC_INFLOW,
    "outflow": euler.BC_OUTFLOW,
    "pressure": euler.BC_PRESSURE,
    "farfield": euler.BC_FARFIELD,
    "periodic": euler.BC_PERIODIC,
}


@dataclasses.dataclass
class CartesianMeshParams:
    """Our native mesh spec (extension subsection 'cartesian mesh'):
    reference runs always go through Gmsh files; the TPU build can also
    construct the block mesh directly.  `solid` is an optional x,y expression
    marking obstacle cells (rasterized forward_step-style domains without a
    mesh file)."""
    nx: int = 0
    ny: int = 0
    x0: float = 0.0
    x1: float = 1.0
    y0: float = 0.0
    y1: float = 1.0
    solid: Callable | None = None


@dataclasses.dataclass
class AllParameters:
    """Top-level config (src/parameters.h:363-411)."""
    mesh_type: str = "gmsh"
    mesh_filename: str = "grid.msh"
    degree: int = 1
    basis: str = "Qk"                # Qk|Pk|GLL (GLL = the src_gll variant)
    mapping: str = "q1"              # q1|q2|cartesian
    diffusion_power: float = 2.0
    diffusion_coef: float = 0.0
    gravity: float = 0.0
    potential: Callable | None = None      # src_gll/parameters.cc:358
    external_force: Callable | None = None  # f(x,y,t) -> (fx, fy)
                                            # (src_mpi/parameters.cc:488-497)
    mass_matrix: str = "diagonal"          # src_gll/parameters.cc:342
    well_balanced: str = "isothermal"      # which src_gll gravity form is
                                           # active when a potential is set
                                           # (polytropic is the manually
                                           #  swapped variant,
                                           #  src_gll/assemble_explicit.cc:579)
    # time stepping
    is_stationary: bool = False
    cfl: float = 0.0
    time_step_type: str = "global"         # global|local
    time_step: float = -1.0
    final_time: float = 1.0e20
    theta: float = 1.0
    max_nonlin_iter: int = 1
    min_residual: float = 0.0   # steady-state stop criterion
                                # (examples/naca0012/m063.prm 'min residual')
    # ICs
    ic_function: str = "none"
    initial_conditions: Callable | None = None
    # groups
    solver: SolverParams = dataclasses.field(default_factory=SolverParams)
    refinement: RefinementParams = dataclasses.field(default_factory=RefinementParams)
    flux: FluxParams = dataclasses.field(default_factory=FluxParams)
    limiter: LimiterParams = dataclasses.field(default_factory=LimiterParams)
    output: OutputParams = dataclasses.field(default_factory=OutputParams)
    boundary_conditions: dict[int, BoundaryConditionSpec] = \
        dataclasses.field(default_factory=dict)
    cartesian_mesh: CartesianMeshParams = \
        dataclasses.field(default_factory=CartesianMeshParams)

    # ------------------------------------------------------------------
    @classmethod
    def from_prm_file(cls, path: str) -> "AllParameters":
        return cls.from_dict(parse_prm_file(path))

    @classmethod
    def from_dict(cls, d: dict) -> "AllParameters":
        d = dict(d)  # shallow copy; we pop as we consume
        p = cls()

        def take(sec: dict, key: str, default=None):
            return sec.pop(key) if key in sec else default

        p.mesh_type = take(d, "mesh type", p.mesh_type)
        p.mesh_filename = take(d, "mesh file", p.mesh_filename)
        p.degree = int(take(d, "degree", p.degree))
        p.basis = take(d, "basis", p.basis)
        p.mapping = take(d, "mapping", p.mapping)
        p.diffusion_power = float(take(d, "diffusion power", p.diffusion_power))
        p.diffusion_coef = float(take(d, "diffusion coefficient", p.diffusion_coef))
        p.gravity = float(take(d, "gravity", p.gravity))
        pot = take(d, "potential")
        if pot is not None:
            p.potential = compile_expression(pot, ("x", "y"))
        f0 = take(d, "f_0 value")
        f1 = take(d, "f_1 value")
        if f0 is not None or f1 is not None:
            fx = compile_expression(f0 or "0.0")
            fy = compile_expression(f1 or "0.0")
            p.external_force = lambda x, y, t: (fx(x, y, t), fy(x, y, t))
        p.mass_matrix = take(d, "mass matrix", p.mass_matrix)
        p.well_balanced = take(d, "well balanced", p.well_balanced)

        ts = take(d, "time stepping", {})
        p.is_stationary = _bool(take(ts, "stationary", "false"))
        p.cfl = float(take(ts, "cfl", "0.0"))
        p.time_step_type = take(ts, "time step type", "global")
        p.time_step = float(take(ts, "time step", "-1.0"))
        p.final_time = float(take(ts, "final time", "1.0e20"))
        p.theta = float(take(ts, "theta scheme value", "1.0"))
        p.max_nonlin_iter = int(take(ts, "nonlinear iterations", "1"))
        p.min_residual = float(take(ts, "min residual", "0.0"))
        if ts:
            raise ValueError(f"unknown 'time stepping' keys: {sorted(ts)}")
        if p.is_stationary:
            p.time_step = 1.0
            p.final_time = 1.0e20
        elif not (p.cfl > 0 or p.time_step > 0):
            raise ValueError("cfl and time_step zero "
                             "(src/parameters.cc:512 check)")

        for bid in range(MAX_N_BOUNDARIES):
            sec = take(d, f"boundary_{bid}")
            if sec is None:
                continue
            kind_name = take(sec, "type", "outflow")
            if kind_name not in _BC_KINDS:
                raise ValueError(f"unknown boundary type {kind_name!r}")
            spec = BoundaryConditionSpec(kind=_BC_KINDS[kind_name])
            exprs = [take(sec, f"w_{c} value", "0.0") for c in range(N_COMP)]
            spec.values = compile_vector_expression(exprs)
            if kind_name == "periodic":
                pair = take(sec, "pair")
                spec.periodic_pair = int(pair) if pair is not None else None
                spec.periodic_direction = take(sec, "direction")
            if sec:
                raise ValueError(f"unknown boundary_{bid} keys: {sorted(sec)}")
            p.boundary_conditions[bid] = spec

        icsec = take(d, "initial condition", {})
        p.ic_function = take(icsec, "function", "none")
        exprs = [take(icsec, f"w_{c} value", "0.0") for c in range(N_COMP)]
        p.initial_conditions = compile_vector_expression(exprs)
        if icsec:
            raise ValueError(f"unknown 'initial condition' keys: {sorted(icsec)}")

        ls = take(d, "linear solver", {})
        p.solver = SolverParams(
            output=take(ls, "output", "quiet"),
            method=take(ls, "method", "rk3"),
            linear_residual=float(take(ls, "residual", "1e-10")),
            max_iterations=int(take(ls, "max iters", "300")),
            ilut_fill=float(take(ls, "ilut fill", "2")),
            ilut_atol=float(take(ls, "ilut absolute tolerance", "1e-9")),
            ilut_rtol=float(take(ls, "ilut relative tolerance", "1.1")),
            ilut_drop=float(take(ls, "ilut drop tolerance", "1e-10")))
        if ls:
            raise ValueError(f"unknown 'linear solver' keys: {sorted(ls)}")

        rf = take(d, "refinement", {})
        p.refinement = RefinementParams(
            do_refine=_bool(take(rf, "refinement", "true")),
            time_step=float(take(rf, "time step", "1.0e20")),
            iter_step=int(take(rf, "iter step", "100000000")),
            refine_fraction=float(take(rf, "refinement fraction", "0.1")),
            unrefine_fraction=float(take(rf, "unrefinement fraction", "0.1")),
            max_elements=int(take(rf, "max elements", "1000000")),
            shock_value=float(take(rf, "shock value", "4.0")),
            shock_levels=int(float(take(rf, "shock levels", "3.0"))),
            tile=int(float(take(rf, "tile", "0"))))
        if rf:
            raise ValueError(f"unknown 'refinement' keys: {sorted(rf)}")

        fl = take(d, "flux", {})
        p.flux = FluxParams(flux=take(fl, "flux", "lxf"),
                            stab_kind=take(fl, "stab", "mesh"),
                            stab_value=float(take(fl, "stab value", "1")))
        if fl:
            raise ValueError(f"unknown 'flux' keys: {sorted(fl)}")
        if p.flux.flux not in ("lxf", "sw", "roe", "hllc", "kfvs", "kep"):
            raise ValueError(f"unknown flux {p.flux.flux!r}")

        lm = take(d, "limiter", {})
        lim_type = take(lm, "type", "none")
        if lim_type == "grad":
            # examples/backward_step/input.prm ships `type = grad`, the name
            # of the deprecated face-difference Qk limiter
            # (src/limiter.cc:72-218) that NO reference tree's parser still
            # accepts (src/parameters.cc:203 allows only none|TVB) — the
            # shipped prm aborts in the reference as-is.  Map it to its
            # successor, the TVB gradient limiter, and say so.
            import warnings
            warnings.warn("limiter `type = grad` is the reference's "
                          "deprecated pre-TVB limiter and is rejected by "
                          "every reference parser; running TVB instead",
                          stacklevel=2)
            lim_type = "TVB"
        p.limiter = LimiterParams(
            shock_indicator=take(lm, "shock indicator", "limiter"),
            type=lim_type,
            char_lim=_bool(take(lm, "characteristic limiter", "false")),
            pos_lim=_bool(take(lm, "positivity limiter", "false")),
            M=float(take(lm, "M", "0")),
            beta=float(take(lm, "beta", "1.0")),
            conserve_angular_momentum=_bool(
                take(lm, "conserve angular momentum", "false")))
        if lm:
            raise ValueError(f"unknown 'limiter' keys: {sorted(lm)}")

        out = take(d, "output", {})
        p.output = OutputParams(
            schlieren_plot=_bool(take(out, "schlieren plot", "false")),
            output_time_step=float(take(out, "time step", "1e20")),
            output_iter_step=int(take(out, "iter step", "1000000")),
            format=take(out, "format", "vtk"),
            ang_mom_step=int(take(out, "compute angular momentum", "10000000")))
        if out:
            raise ValueError(f"unknown 'output' keys: {sorted(out)}")

        cm = take(d, "cartesian mesh", None)
        if cm is not None:
            solid = take(cm, "solid")
            p.cartesian_mesh = CartesianMeshParams(
                nx=int(take(cm, "nx", "0")), ny=int(take(cm, "ny", "0")),
                x0=float(take(cm, "x0", "0")), x1=float(take(cm, "x1", "1")),
                y0=float(take(cm, "y0", "0")), y1=float(take(cm, "y1", "1")),
                solid=(compile_expression(solid, ("x", "y"))
                       if solid is not None else None))
            if cm:
                raise ValueError(f"unknown 'cartesian mesh' keys: {sorted(cm)}")

        if d:
            raise ValueError(f"unknown top-level config keys: {sorted(d)}")
        p.validate()
        return p

    # ------------------------------------------------------------------
    def validate(self):
        """Cross-field constraints (src/parameters.cc:536-550)."""
        if self.solver.method == "mood":
            if self.time_step_type != "global":
                raise ValueError("MOOD requires global time step")
            if self.basis != "Pk":
                raise ValueError("MOOD is implemented only for Pk")
        if self.limiter.type == "TVB" and self.mapping != "cartesian":
            raise ValueError("TVB limiter works on cartesian grids only")
        if self.basis == "Pk":
            if self.mapping != "cartesian":
                raise ValueError("Pk basis can only be used with Cartesian grids")
            if self.refinement.do_refine:
                raise ValueError("Refinement does not work for Pk basis")
