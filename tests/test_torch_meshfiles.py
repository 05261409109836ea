"""The port's mesh files and segmented sides against the JAX package's, in
float64 on the CPU.

- The .geo interpreter: parse_geo, rasterize and to_curvilinear (through
  load_geo) give the reference's model and arrays on three texts written
  here: the double Mach reflection (DMR) box split at x = 1/6 into two
  transfinite blocks with Physical Lines 0 and 1 on the bottom, an L-shaped
  forward step of three blocks, and a rectangle chained with a ramp (a
  curvilinear block).  A circle-bounded .geo and a .msh that is not a
  raster raise NotImplementedError naming slice E.
- .msh: write_msh of the DMR and L-step domains reads back, through the
  native reader and through parse_msh, as the reference's load_msh reads
  it.
- Segmented sides: the DMR with its bottom split at x = 1/6 (post-shock
  farfield before, slip after; tests/test_masked_domain.py:66-110) at
  48 x 12, against dflo_tpu's plain residual with the same segments: the
  fused residual's R, SSP-stage and u + dt*R forms (their plain versions
  and strips here) on Q2; the MOOD candidate's strips on P2 (the sparse
  candidate on every cell against positivity(truncation(u)) + dt*R); the
  block form on a (2, 2) mesh of CPU blocks; all within 1e-12.  Then 3
  steps of the .geo DMR through the port's cli.run against dflo_tpu's CLI
  on the same files: the checkpoints within 1e-10.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu import cli as jcli
from dflo_tpu.config.params import AllParameters as JParams
from dflo_tpu.mesh import geo as jgeo
from dflo_tpu.mesh import msh as jmsh
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu.stab import positivity as jpos
from dflo_tpu_torch import cli, interop
from dflo_tpu_torch.config.params import AllParameters
from dflo_tpu_torch.entry import POST_CONSERVED as POST
from dflo_tpu_torch.entry import dmr_geo_prm, dmr_geo_text
from dflo_tpu_torch.mesh import geo, msh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.parallel import device_mesh, gather_state, shard_state
from dflo_tpu_torch.solver.spatial import SegmentedSide, make_rhs

F64 = torch.float64


def rel(a, b) -> float:
    """max over components of max|a - b| / max|a|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a).reshape(a.shape[0], -1).max(1), 1e-300)
    return float((np.abs(a - b).reshape(a.shape[0], -1).max(1)
                  / scale).max())


L_STEP = """// the forward step as an L of three blocks, h = 0.1
h = 0.1;
Point(1) = {0, 0, 0}; Point(2) = {0.6, 0, 0}; Point(3) = {0.6, 0.2, 0};
Point(4) = {3, 0.2, 0}; Point(5) = {3, 1, 0}; Point(6) = {0.6, 1, 0};
Point(7) = {0, 1, 0}; Point(8) = {0, 0.2, 0};
Line(1) = {1, 2}; Line(2) = {2, 3}; Line(3) = {3, 8}; Line(4) = {8, 1};
Line(5) = {3, 6}; Line(6) = {6, 7}; Line(7) = {7, 8};
Line(8) = {3, 4}; Line(9) = {4, 5}; Line(10) = {5, 6};
Line Loop(1) = {1, 2, 3, 4}; Plane Surface(1) = {1};
Line Loop(2) = {-3, 5, 6, 7}; Plane Surface(2) = {2};
Line Loop(3) = {8, 9, 10, -5}; Plane Surface(3) = {3};
Transfinite Line{1, 3, 6} = 0.6/h + 1;
Transfinite Line{2, 4} = 0.2/h + 1;
Transfinite Line{5, 7, 9} = 0.8/h + 1;
Transfinite Line{8, 10} = 2.4/h + 1;
Physical Line(1) = {4, 7};
Physical Line(2) = {9};
Physical Line(3) = {1, 2, 8, 6, 10};
Mesh.RecombineAll = 1;
"""

RAMP_CHAIN = """/* a rectangle chained with a 14 degree ramp */
Point(1) = {0, 0, 0}; Point(2) = {1, 0, 0}; Point(3) = {1, 1, 0};
Point(4) = {0, 1, 0}; Point(5) = {2, 0.25, 0}; Point(6) = {2, 1.25, 0};
Line(1) = {1, 2}; Line(2) = {2, 3}; Line(3) = {3, 4}; Line(4) = {4, 1};
Line(5) = {2, 5}; Line(6) = {5, 6}; Line(7) = {6, 3};
Line Loop(1) = {1, 2, 3, 4}; Plane Surface(1) = {1};
Line Loop(2) = {5, 6, 7, -2}; Plane Surface(2) = {2};
Transfinite Line{1, 3, 5, 7} = 9; Transfinite Line{2, 4, 6} = 7;
Physical Line(1) = {4}; Physical Line(2) = {1, 5};
Physical Line(3) = {6}; Physical Line(4) = {3, 7};
"""

CIRCLE = """lc = 0.1;
Point(1) = {0, 0, 0, lc}; Point(2) = {1, 0, 0, lc}; Point(3) = {0, 1, 0, lc};
Point(4) = {-1, 0, 0, lc}; Point(5) = {0, -1, 0, lc};
Circle(1) = {2, 1, 3}; Circle(2) = {3, 1, 4};
Circle(3) = {4, 1, 5}; Circle(4) = {5, 1, 2};
Line Loop(1) = {1, 2, 3, 4}; Plane Surface(1) = {1};
Physical Line(0) = {1, 2, 3, 4};
"""

GEO_TEXTS = {"dmr_split": dmr_geo_text(2, 46, 12), "l_step": L_STEP,
             "ramp_chain": RAMP_CHAIN}


def same_domain(j, t) -> None:
    """A reference RasterizedDomain and the port's hold equal arrays."""
    assert type(j.mesh).__name__ == type(t.mesh).__name__
    if hasattr(j.mesh, "metric"):
        assert np.array_equal(j.mesh.X, t.mesh.X)
        assert np.array_equal(j.mesh.Y, t.mesh.Y)
    else:
        assert (j.mesh.nx, j.mesh.ny, j.mesh.x0, j.mesh.x1, j.mesh.y0,
                j.mesh.y1) == (t.mesh.nx, t.mesh.ny, t.mesh.x0, t.mesh.x1,
                               t.mesh.y0, t.mesh.y1)
    assert (j.mask is None) == (t.mask is None)
    if j.mask is not None:
        assert np.array_equal(j.mask, t.mask)
    assert j.side_bids.keys() == t.side_bids.keys()
    for k in j.side_bids:
        assert np.array_equal(j.side_bids[k], t.side_bids[k]), k
    assert (j.periodic_x, j.periodic_y) == (t.periodic_x, t.periodic_y)


@pytest.mark.parametrize("name", tuple(GEO_TEXTS))
def test_geo_texts_match_jax(tmp_path, name):
    text = GEO_TEXTS[name]
    jm, tm = jgeo.parse_geo(text), geo.parse_geo(text)
    assert vars(jm) == vars(tm)
    path = tmp_path / f"{name}.geo"
    path.write_text(text)
    jd, td = jgeo.load_geo(str(path)), geo.load_geo(str(path))
    same_domain(jd, td)
    # the reference's domain carried across as arrays
    same_domain(jd, interop.domain_from_numpy(jd))
    if name == "ramp_chain":
        mesh, bids = geo.to_curvilinear(tm)
        assert mesh.nx == 16 and mesh.ny == 6
        assert float(np.min(mesh.metric(np.array([[0.5, 0.5]]))[4])) > 0
        assert sorted(set(bids["S"])) == [2] and sorted(set(bids["N"])) == [4]
    else:
        for a, b in zip(jgeo.rasterize(jm).side_bids.values(),
                        geo.rasterize(tm).side_bids.values()):
            assert np.array_equal(a, b)
    if name == "dmr_split":
        assert (td.mesh.nx, td.mesh.ny) == (48, 12) and td.mask is None
        assert list(td.side_bids["S"][:3]) == [0, 0, 1]
    if name == "l_step":
        assert td.mask is not None and int((~td.mask).sum()) == 48


@pytest.mark.parametrize("name", ("dmr_split", "l_step"))
def test_msh_round_trip_matches_jax(tmp_path, name):
    path = tmp_path / f"{name}.geo"
    path.write_text(GEO_TEXTS[name])
    dom = geo.load_geo(str(path))
    out = str(tmp_path / f"{name}.msh")
    msh.write_msh(out, dom.mesh, dom.side_bids, dom.mask)
    ref = jmsh.load_msh(out)
    for parser in ("native", "python"):
        same_domain(ref, msh.load_msh(out, parser=parser))
    # the native parse gives parse_msh's structures
    from dflo_tpu_torch import native
    with open(out) as f:
        assert native.msh_parse(out) == msh.parse_msh(f.read())
    # the written domain reads back as itself (ids of bbox edges behind
    # the solid region are written as given)
    back = msh.load_msh(out)
    assert back.mesh == dom.mesh
    assert np.array_equal(back.side_bids["S"], dom.side_bids["S"])


NON_RASTER_MSH = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
6
1 0 0 0
2 1 0 0
3 3 0 0
4 0 1 0
5 1 1 0
6 3 1 0
$EndNodes
$Elements
2
1 3 2 100 0 1 2 5 4
2 3 2 100 0 2 3 6 5
$EndElements
"""


def test_slice_e_meshes_raise(tmp_path):
    circle = tmp_path / "disk.geo"
    circle.write_text(CIRCLE)
    with pytest.raises(NotImplementedError, match="slice E"):
        geo.load_geo(str(circle))
    with pytest.raises(NotImplementedError, match="slice E"):
        geo.UnstructuredDomain(None)
    bad = tmp_path / "ragged.msh"
    bad.write_text(NON_RASTER_MSH)
    for parser in ("native", "python"):
        with pytest.raises(NotImplementedError, match="slice E"):
            msh.load_msh(str(bad), parser=parser)
    # the reference sends both to its unstructured mesh
    assert isinstance(jgeo.load_geo(str(circle)), jgeo.UnstructuredDomain)
    with pytest.raises(ValueError, match="non-uniform"):
        jmsh.rasterize_msh(*jmsh.parse_msh(NON_RASTER_MSH))
    with pytest.raises(ValueError, match="non-uniform"):
        msh.rasterize_msh(*msh.parse_msh(NON_RASTER_MSH))
    # a mesh file that is not there (dflo_tpu/cli.py:57-59)
    empty = tmp_path / "empty"
    empty.mkdir()
    params = AllParameters.from_prm_file(str(_write_prm(empty,
                                                        "missing.msh")))
    with pytest.raises(FileNotFoundError, match="missing.msh"):
        cli.build_domain(params, str(empty))


# ---------------------------------------------------------------------------
# segmented sides
# ---------------------------------------------------------------------------

def _write_prm(d, mesh_file: str, **kw):
    p = d / f"dmr_{mesh_file.replace('.', '_')}.prm"
    p.write_text(dmr_geo_prm(mesh_file, **kw))
    return p


@pytest.fixture(scope="module")
def dmr_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dmr")
    (d / "dmr.geo").write_text(dmr_geo_text(2, 46, 12))
    return d


def both_bcs(d, family: str):
    """(reference bcs, port bcs, reference params, port params) of the .geo
    DMR, each built by its own package's CLI from the same files."""
    prm = str(_write_prm(d, "dmr.geo", basis=family))
    jp, tp = JParams.from_prm_file(prm), AllParameters.from_prm_file(prm)
    jdom, tdom = jcli.build_domain(jp, str(d)), cli.build_domain(tp, str(d))
    jb, tb = jcli.build_bcs(jp, jdom[2]), cli.build_bcs(tp, tdom[2])
    assert isinstance(tb["S"], SegmentedSide)
    assert np.array_equal(jb["S"].seg_id, tb["S"].seg_id)
    # the reference's mesh and split side carried across (its boundary
    # values are JAX callables: the port's sides stand in for them)
    assert interop.mesh_from_numpy(jdom[0]) == tdom[0]
    carried = interop.segmented_from_numpy(jb["S"].seg_id,
                                           tb["S"].segments)
    assert np.array_equal(carried.seg_id, tb["S"].seg_id)
    assert [g.kind for g in carried.segments] == [g.kind for g in
                                                  jb["S"].segments]
    solver, _ = cli.build_solver(tp, str(d), dtype=F64, device="cpu")
    return jb, tb, jdom[0], solver


def dmr_state(solver, seed: int):
    """The oblique-shock IC at the nodes (or its projection), perturbed by
    a seeded 2 % and limited by the solver's post (JAX's jit and eager
    differ by 6e-11 on unlimited DMR states, ROADMAP "Faults found")."""
    basis, mesh = solver.basis, solver.mesh
    from dflo_tpu_torch import ic

    def oblique(x, y, t=0.0):
        post = x < 1.0 / 6.0 + y / np.sqrt(3.0)
        out = [torch.where(post, torch.full_like(x, a), torch.full_like(x, b))
               for a, b in zip(POST, (0.0, 0.0, 1.4, 2.5))]
        return torch.stack(out)

    u = ic.set_initial_condition(basis, mesh, oblique, dtype=F64,
                                 device="cpu")
    rng = np.random.default_rng(seed)
    u = u * torch.from_numpy(1.0 + 0.02 * rng.uniform(-1, 1, u.shape))
    return solver.post_stage(u, 0.0)


def test_segmented_strips_match_jax(dmr_dir):
    """R, stage and u + dt*R with the split bottom (Q2, hllc) at t = 0.05,
    where the moving shock has entered the top edge."""
    jb, tb, jmesh, solver = both_bcs(dmr_dir, "Qk")
    jbasis = jax_make_basis("Qk", 2)
    basis, tmesh = solver.basis, solver.mesh
    u, u_old = dmr_state(solver, 1), dmr_state(solver, 2)
    t, dt, a = 0.05, 2e-4, 0.75
    jrhs = jax.jit(jspatial.make_rhs(jbasis, jmesh, jb, flux="hllc",
                                     dtype=jnp.float64, volume_kernel="xla"))
    R = np.asarray(jrhs(jnp.asarray(u.numpy()), t))
    rhs = make_rhs(basis, tmesh, tb, flux="hllc", dtype=F64, device="cpu",
                   volume_kernel="fused")
    tt, dtt = torch.tensor(t, dtype=F64), torch.tensor(dt, dtype=F64)
    assert rel(R, rhs(u, tt)) <= 1e-12
    assert rel(a * u_old.numpy() + (1 - a) * (u.numpy() + dt * R),
               rhs.stage(u, u_old, tt, a, dtt)) <= 1e-12
    assert rel(u.numpy() + dt * R, rhs.step(u, tt, dtt)) <= 1e-12
    # the plain residual takes the same segments
    plain = make_rhs(basis, tmesh, tb, flux="hllc", dtype=F64, device="cpu")
    assert rel(R, plain(u, tt)) <= 1e-12
    # the split shows: a whole-side slip bottom gives another residual
    slip = dict(tb, S=tb["S"].segments[1])
    assert rel(R, make_rhs(basis, tmesh, slip, flux="hllc", dtype=F64,
                           device="cpu")(u, tt)) > 1e-6

    # the block form on a (2, 2) mesh of CPU blocks: the segment ids and
    # face points sliced at each block's offset
    dm = device_mesh((2, 2), [torch.device("cpu")] * 4)
    rN = make_rhs(basis, tmesh, tb, flux="hllc", dtype=F64, device="cpu",
                  volume_kernel="fused", device_mesh=dm)
    blocks, old = shard_state(u, dm), shard_state(u_old, dm)
    assert rel(R, gather_state(rN(blocks, tt), dm)) <= 1e-12
    assert rel(a * u_old.numpy() + (1 - a) * (u.numpy() + dt * R),
               gather_state(rN.stage(blocks, old, tt, a, dtt), dm)) <= 1e-12


def test_segmented_candidate_strips_match_jax(dmr_dir):
    """The MOOD candidate with the split bottom on P2: the sparse candidate
    on every cell is positivity(truncation(u)) + dt*R(.) of dflo_tpu's
    plain residual; with a cell set the others keep u_prev."""
    jb, tb, jmesh, solver = both_bcs(dmr_dir, "Pk")
    jbasis = jax_make_basis("Pk", 2)
    basis, tmesh = solver.basis, solver.mesh
    rhs = make_rhs(basis, tmesh, tb, flux="hllc", dtype=F64, device="cpu",
                   volume_kernel="fused")
    u = kernels.modal_tp_plain(dmr_state(solver, 3), None, rhs.modal_ops)
    rng = np.random.default_rng(4)
    deg = rng.integers(1, 3, (tmesh.ny, tmesh.nx)).astype(np.int32)
    deg[0, :4] = (1, 2, 2, 1)          # both segments' cells, each degree
    t, dt = 0.05, 2e-4
    trunc = np.stack([(jbasis.mode_degree <= k) for k in range(3)])
    u_np = u.numpy()
    mean = jnp.asarray(float((jbasis.wq2 @ jbasis.V)[0]) * u_np[:, 0])
    ut = jax.jit(jpos.make_positivity_limiter(jbasis, jmesh, jnp.float64))(
        jnp.asarray(u_np * np.moveaxis(trunc[deg], -1, 0)[None]), mean)
    jrhs = jax.jit(jspatial.make_rhs(jbasis, jmesh, jb, flux="hllc",
                                     dtype=jnp.float64, volume_kernel="xla"))
    ref = np.asarray(ut + dt * jrhs(ut, t))
    degt = torch.from_numpy(deg)
    h = torch.tensor(dt, dtype=F64)
    cand = rhs.sparse_candidate(u, torch.zeros_like(u), degt, t, h,
                                torch.ones((tmesh.ny, tmesh.nx),
                                           dtype=torch.bool))
    assert rel(ref, cand) <= 1e-12
    cells = torch.from_numpy(rng.uniform(size=deg.shape) < 0.3)
    prev = torch.from_numpy(rng.standard_normal(u.shape))
    part = rhs.sparse_candidate(u, prev.clone(), degt, t, h, cells)
    assert torch.equal(part[..., ~cells], prev[..., ~cells])
    assert torch.equal(part[..., cells], cand[..., cells])


def test_geo_dmr_cli_matches_jax(dmr_dir, tmp_path):
    """3 steps of the .geo DMR through both CLIs, checkpoints within
    1e-10."""
    prm = str(_write_prm(dmr_dir, "dmr.geo", out_iter=1))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    args = ["--max-steps", "3", "--checkpoint-every", "1", "--x64",
            "--platform", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main([prm, "--output-dir", jout, *args]) == 0
        res = cli.run([prm, "--output-dir", tout, *args])
    assert res.it == 3 and isinstance(res.solver.bcs["S"], SegmentedSide)
    names = sorted(f for f in os.listdir(jout) if f.startswith("checkpoint"))
    assert names == sorted(f for f in os.listdir(tout)
                           if f.startswith("checkpoint")) and len(names) == 5
    for n in names:
        with np.load(os.path.join(jout, n)) as a, \
                np.load(os.path.join(tout, n)) as b:
            assert int(a["it"]) == int(b["it"])
            assert abs(float(a["t"]) - float(b["t"])) <= 1e-14
            assert rel(a["u"], b["u"]) <= 1e-10
    assert os.path.exists(os.path.join(tout, "solution-004.vtu"))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build of the native library raises with the compiler's
    message (the reference falls back to Python; the port takes the plain
    reader only when asked, load_msh(parser="python"))."""
    from dflo_tpu_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", "g++ --no-such-flag")
    with pytest.raises(RuntimeError):
        native.build()
    bad = tmp_path / "broken.cc"
    bad.write_text("int f( {")
    monkeypatch.setenv("CXX", "g++")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="broken.cc"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.so"))
