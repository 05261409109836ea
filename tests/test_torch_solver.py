"""The port's Solver against the JAX package's on the DMR configuration at
32 x 8, in float64 on the CPU, plus the driver's loop contracts.

Three steps of dflo_tpu_torch's Solver must equal three dflo_tpu
Solver._step calls to 1e-10 relative (same u, same dt, same fatal flag):
the chains agree to round-off per stage, and three SSP-RK3 steps through
limiter decisions keep that well inside 1e-10.
"""

import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu.solver import rk as jrk
from dflo_tpu_torch import entry, interop
from dflo_tpu_torch.driver import LimiterConfig, Solver
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.parallel import device_mesh
from dflo_tpu_torch.solver import rk as trk

NX, NY = 32, 8
F64 = torch.float64
T_END = 1.0
TOL = 1e-10
ROOT = pathlib.Path(__file__).resolve().parent.parent


def rel(a, b) -> float:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.fixture(scope="module")
def jax_solver():
    return graft._build(NX, NY)


@pytest.fixture(scope="module")
def jax_run(jax_solver):
    """Three JAX steps from the post-staged DMR state:
    (u0, start, [(u, dt, bad)])."""
    js, u0 = jax_solver
    u = jax.jit(js.post_stage)(u0)
    start = np.asarray(u)
    t, out = 0.0, []
    for _ in range(3):
        u, dt, bad, _ = js._step(u, t, T_END)
        t += float(dt)
        out.append((np.asarray(u), float(dt), bool(bad)))
    return np.asarray(u0), start, out


@pytest.fixture(scope="module")
def port():
    return entry._build(NX, NY, dtype=F64, device="cpu")


def test_rk_schemes_match_jax():
    for scheme in ("rk1", "rk2", "rk3"):
        assert trk.rk_coeffs(scheme) == jrk.rk_coeffs(scheme)
    for p in range(4):
        assert trk.default_scheme(p) == jrk.default_scheme(p)


def test_three_steps_match_jax(jax_run, port):
    u0_np, start_np, ref = jax_run
    s, u0 = port
    assert rel(u0_np, u0) <= 1e-15
    u = s.post_stage(u0)
    assert rel(start_np, u) <= 1e-12
    t = 0.0
    for k, (u_ref, dt_ref, bad_ref) in enumerate(ref):
        u, dt, bad, _ = s._step(u, t, T_END)
        t += float(dt)
        assert rel(dt_ref, dt) <= TOL, k
        assert rel(u_ref, u) <= TOL, k
        assert bool(bad) == bad_ref is False


@pytest.mark.parametrize("chunk", (1, 3))
def test_multi_step_matches_jax(jax_run, port, chunk):
    """The chunked loop (carry-lambda, Kahan time) lands on the same state."""
    _, start_np, ref = jax_run
    s, _ = port
    u = interop.state_from_numpy(start_np, F64, "cpu")
    t = 0.0
    for _ in range(3 // chunk):
        u, t, n, bad, _ = s._multi_step(chunk)(u, t, T_END)
        assert int(n) == chunk and not bool(bad)
    assert rel(ref[-1][0], u) <= TOL
    assert rel(sum(r[1] for r in ref), t) <= 1e-13


def test_run_matches_jax_steps(jax_run, port):
    """run(u0, t_end) post-stages the IC, then steps to t_end: with t_end the
    time after three JAX steps it takes three steps and lands on their
    state, per step and chunked."""
    _, _, ref = jax_run
    s, tu0 = port
    t_end = sum(r[1] for r in ref)
    ut, tt, itt = s.run(tu0, t_end)
    assert itt == 3 and rel(t_end, tt) <= 1e-13 and rel(ref[-1][0], ut) <= TOL
    uc, tc, itc = s.run(tu0, t_end, chunk=4)
    assert itc == 3 and rel(ut, uc) <= 1e-12 and abs(tc - tt) <= 1e-15


def test_multi_step_stops_at_t_end(port):
    s, u0 = port
    u = s.post_stage(u0)
    t_end = 1.0e-4
    u1, t1, n, bad, _ = s._multi_step(8)(u, 0.0, t_end)
    assert 0 < int(n) < 8 and not bool(bad)
    assert abs(float(t1) - t_end) <= 1e-15
    # steps after t_end take no effect
    u2, t2, n2, _, _ = s._multi_step(3)(u1, t1, t_end)
    assert int(n2) == 0 and torch.equal(u2, u1) and float(t2) == float(t1)


def test_run_breaks_on_zero_dt_f32():
    """f32: once host-double t sits in the half-ulp window below t_end the
    clamp dt = min(dt, t_end - t) is exactly 0; run must stop instead of
    spinning (per-step loop), and the chunked loop must stop on a chunk
    that made no progress."""
    s, u0 = entry._build(16, 4, dtype=torch.float32, device="cpu")
    t_end = 0.2
    t0 = 0.2 - 1e-9
    assert t0 < t_end - 1e-12 and np.float32(t0) == np.float32(t_end)
    _, dt, _, _ = s._step(u0, t0, t_end)
    assert float(dt) == 0.0
    _, t1, it1 = s.run(u0, t_end, t0=t0, max_steps=500)
    assert it1 == 1 and np.float32(t1) == np.float32(t_end)
    t_end = 0.7
    t0 = float(np.float32(t_end))
    assert t0 < t_end - 1e-12
    _, _, it2 = s.run(u0, t_end, t0=t0, chunk=10, max_steps=500)
    assert it2 == 0


@pytest.mark.parametrize("chunk", (1, 4))
def test_nan_state_trips_the_fatal_flag(port, chunk):
    s, u0 = port
    u = s.post_stage(u0).clone()
    u[:, :, NY // 2, NX // 3] = float("nan")
    _, _, bad, _ = s._step(u, 0.0, T_END)
    assert bool(bad)
    _, _, n, bad, _ = s._multi_step(2)(u, 0.0, T_END)
    assert bool(bad) and int(n) == 1
    # run post-stages first, so feed NaN through the state it limits
    with pytest.raises(FloatingPointError):
        s.run(u, T_END, chunk=chunk, max_steps=4)


def test_entry_step_is_the_solver_step():
    fn, (u, t, t_end) = entry.entry(device="cpu")
    assert tuple(u.shape) == (4, 9, 24, 128) and u.dtype == F64
    s, u0 = entry._build(128, 24, dtype=F64, device="cpu")
    u0 = s.post_stage(u0)
    assert torch.equal(u, u0)
    ref, _, bad, _ = s._make_step()(u0, t, t_end)
    out = fn(u, t, t_end)
    assert torch.equal(out, ref) and not bool(bad)
    assert bool(torch.isfinite(out).all())


def test_out_of_slice_configurations_raise():
    s, _ = entry._build(16, 4, dtype=F64, device="cpu")
    lim = LimiterConfig(type="TVB", shock_indicator="density", beta=2.0,
                        char_lim=True, pos_lim=True)
    args = (s.basis, s.mesh, s.bcs)
    # implicit stepping is ported on one device; under a mesh it waits
    with pytest.raises(NotImplementedError, match="implicit"):
        Solver(*args, limiter=lim, dtype=F64, device="cpu", method="implicit",
               device_mesh=device_mesh((1, 2), ["cpu"] * 2))
    # masked MOOD runs (tests/test_torch_masked_pk.py); MOOD with a source
    # callable the residual kernel's source arm does not carry runs on the
    # plain residual, as the reference's (tests/test_torch_mood_routes.py)
    sm = Solver(make_basis("Pk", 2), s.mesh, s.bcs, limiter=lim, dtype=F64,
                device="cpu", method="mood", mask=np.ones((4, 16), bool),
                source=lambda x, y, t, W: 0.0 * W)
    assert sm.volume_kernel == "xla" and not sm._mood_stage.fused
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        Solver(*args, limiter=lim, dtype=F64, device="cpu",
               device_mesh=device_mesh((1, 2), ["cpu"] * 2),
               post_kernel="xla")
    # minmax runs on the plain post (tests/test_torch_envelope_limiters.py);
    # on the modal basis it raises, as the reference's
    smm = Solver(*args, limiter=LimiterConfig(type="minmax"), dtype=F64,
                 device="cpu")
    assert (smm.volume_kernel, smm.post_kernel) == ("fused", "xla")
    with pytest.raises(ValueError, match="Qk"):
        Solver(make_basis("Pk", 2), s.mesh, s.bcs, dtype=F64, device="cpu",
               limiter=LimiterConfig(type="minmax"))
    # degrees 1-6 on any quadrature up to NQ_MAX run through the kernels
    # (tests/test_torch_envelope.py); beyond those bounds nothing does
    for basis in (make_basis("Qk", 2, kernels.NQ_MAX + 1),
                  make_basis("Pk", 7)):
        with pytest.raises(NotImplementedError,
                           match="the bounds of the general dims"):
            kernels.residual_operators(basis, s.mesh, dtype=F64,
                                       device="cpu")


def test_port_never_imports_jax():
    src = ROOT / "dflo_tpu_torch"
    pat = re.compile(r"^\s*(import|from)\s+(jax|dflo_tpu)\b", re.M)
    for f in list(src.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not pat.search(f.read_text()), f
    code = ("import sys, dflo_tpu_torch, dflo_tpu_torch.entry, "
            "dflo_tpu_torch.interop, dflo_tpu_torch.stab.mood, "
            "dflo_tpu_torch.ops.kernels, dflo_tpu_torch.cli; "
            "assert 'jax' not in sys.modules and 'dflo_tpu' not in "
            "sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# ---------------------------------------------------------------------------
# the reference's defaults: the flux left unset, limiter type "none"
# ---------------------------------------------------------------------------

def test_default_flux_is_the_reference_default():
    """A Solver and a make_rhs built with the flux left unset run lxf, the
    reference's default (ROADMAP queue 3, fault 3): their residuals equal
    dflo_tpu's, also built with the flux unset, on a perturbed DMR state
    (f64, 1e-12)."""
    from dflo_tpu.driver import Solver as JSolver
    from dflo_tpu.ops.basis import make_basis as jax_make_basis
    from dflo_tpu.solver import spatial as jspatial
    from dflo_tpu_torch.solver.spatial import make_rhs
    js, u0 = graft._build(NX, NY)
    ts, _ = entry._build(NX, NY, dtype=F64, device="cpu")
    rng = np.random.default_rng(41)
    u_np = np.asarray(jax.jit(js.post_stage)(u0))
    u_np = u_np * (1.0 + 0.01 * rng.uniform(-1.0, 1.0, u_np.shape))
    u = torch.from_numpy(u_np)
    jb = jax_make_basis("Qk", 2)
    R_jax = np.asarray(jax.jit(jspatial.make_rhs(jb, js.mesh, js.bcs))(
        u_np, 0.01))
    R_solver = np.asarray(jax.jit(JSolver(jb, js.mesh, js.bcs).rhs)(
        u_np, 0.01))
    assert rel(R_jax, R_solver) <= 1e-14
    rhs = make_rhs(ts.basis, ts.mesh, ts.bcs, dtype=F64, device="cpu")
    s = Solver(ts.basis, ts.mesh, ts.bcs, dtype=F64, device="cpu")
    assert s.flux == "lxf" and s.rhs.ops.flux == "lxf"
    assert rel(R_jax, rhs(u, 0.01)) <= 1e-12
    assert rel(R_jax, s.rhs(u, 0.01)) <= 1e-12
    assert kernels.residual_operators(ts.basis, ts.mesh, dtype=F64,
                                      device="cpu").flux == "lxf"


@pytest.mark.parametrize("family, p, pos_lim", [("Qk", 1, True),
                                                ("Qk", 2, False),
                                                ("Pk", 2, False)])
def test_none_limiter_matches_jax(family, p, pos_lim):
    """Limiter type "none", the default in both packages (ROADMAP queue 3,
    fault 2): no limit step, positivity where pos_lim asks for it; "auto"
    resolves the post to the plain chain, as the reference's post_ok does.
    The periodic isentropic vortex at 16 x 16 (LxF), three steps of the
    port's Solver against dflo_tpu's (dt, flag, state to 1e-10)."""
    from dflo_tpu import ic as jic
    from dflo_tpu.driver import LimiterConfig as JLim
    from dflo_tpu.driver import Solver as JSolver
    from dflo_tpu.ops.basis import make_basis as jax_make_basis
    from dflo_tpu.physics import euler as jeuler
    from dflo_tpu.solver.spatial import BoundarySide as JSide
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.physics import euler
    from dflo_tpu_torch.solver.spatial import BoundarySide
    mesh = CartesianMesh(16, 16, -5.0, 5.0, -5.0, 5.0)
    jper, tper = JSide(jeuler.BC_PERIODIC), BoundarySide(euler.BC_PERIODIC)
    js = JSolver(jax_make_basis(family, p), mesh,
                 dict(W=jper, E=jper, S=jper, N=jper),
                 limiter=JLim(type="none", pos_lim=pos_lim),
                 dtype=jax.numpy.float64)
    ts = Solver(make_basis(family, p), mesh,
                dict(W=tper, E=tper, S=tper, N=tper),
                limiter=LimiterConfig(type="none", pos_lim=pos_lim),
                dtype=F64, device="cpu")
    assert (ts.volume_kernel, ts.post_kernel) == ("fused", "xla")
    u0 = ic.set_initial_condition(ts.basis, mesh, ic.isentropic_vortex(),
                                  dtype=F64, device="cpu").numpy()
    assert rel(jic.set_initial_condition(js.basis, mesh,
                                         jic.isentropic_vortex()), u0) \
        <= 1e-14
    uj = jax.jit(js.post_stage)(jax.numpy.asarray(u0))
    ut = ts.post_stage(torch.from_numpy(u0))
    if not pos_lim:
        assert np.array_equal(ut.numpy(), u0)      # no limit step at all
    assert rel(uj, ut) <= 1e-14
    tj = tt = 0.0
    for _ in range(3):
        uj, dtj, badj, _ = js._step(uj, tj, 20.0)
        ut, dtt, badt, _ = ts._step(ut, tt, 20.0)
        assert float(dtt) == pytest.approx(float(dtj), rel=1e-12)
        assert bool(badt) == bool(badj) is False
        tj += float(dtj)
        tt += float(dtt)
        assert rel(uj, ut) <= 1e-10
    with pytest.raises(ValueError, match="collocated Qk TVB"):
        Solver(ts.basis, mesh, ts.bcs, limiter=LimiterConfig(type="none"),
               dtype=F64, device="cpu", post_kernel="fused")
