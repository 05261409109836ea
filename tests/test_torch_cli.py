"""The port's CLI against the JAX package's CLI, on the CPU in float64.

Both run examples/forward_step_tpu.prm cut to 60 x 20 cells with a snapshot
and a checkpoint after every step (`iter step = 1`), 5 steps: `python -m
dflo_tpu ... --platform cpu --x64` (the JAX package's XLA path) and the
port's `cli.run([... , "--platform", "cpu", "--x64"])` (every kernel
wrapper's plain version).  Every checkpoint must agree to 1e-10 relative
(per component; the two packages differ by summation orders, and five
limited steps keep that near 1e-15), with equal times to 1e-14 and equal
step and snapshot counts.  A checkpoint written by the JAX package resumes
in the port's CLI and carries the state on: from the JAX run's snapshot 3,
two more steps land on its snapshot 5 to the same tolerance.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

from dflo_tpu import cli as jcli
from dflo_tpu_torch import cli

TOL = 1e-10
STEPS = 5


def rel(a, b) -> float:
    """max over components of max|a - b| / max|a| (a zero component must
    agree exactly)."""
    scale = np.maximum(np.abs(a).reshape(4, -1).max(1), 1e-300)
    return float((np.abs(a - b).reshape(4, -1).max(1) / scale).max())


def ckpt(d, i):
    with np.load(os.path.join(d, f"checkpoint-{i:03d}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(prm path, JAX output dir and stdout, port output dir and CliRun)."""
    root = tmp_path_factory.mktemp("cli")
    src = open("examples/forward_step_tpu.prm").read()
    prm = root / "fs.prm"
    prm.write_text(src.replace("nx = 1920", "nx = 60")
                   .replace("ny = 640", "ny = 20")
                   .replace("iter step = 0", "iter step = 1"))
    common = [str(prm), "--platform", "cpu", "--x64", "--max-steps",
              str(STEPS), "--checkpoint-every", "1"]
    jout, tout = root / "jax", root / "port"
    jlog = io.StringIO()
    with contextlib.redirect_stdout(jlog):
        assert jcli.main(common + ["--output-dir", str(jout)]) == 0
        res = cli.run(common + ["--output-dir", str(tout)])
    return prm, str(jout), jlog.getvalue(), str(tout), res


def test_cli_matches_jax(runs):
    _, jout, jlog, tout, res = runs
    assert re.search(rf"steps={STEPS}\s", jlog) and res.it == STEPS
    names = sorted(f for f in os.listdir(jout) if f.startswith("checkpoint"))
    assert names == sorted(f for f in os.listdir(tout)
                           if f.startswith("checkpoint"))
    assert len(names) == STEPS + 2          # IC, one per step, final
    for i in range(len(names)):
        a, b = ckpt(jout, i), ckpt(tout, i)
        assert int(a["it"]) == int(b["it"]) == i
        assert abs(float(a["t"]) - float(b["t"])) <= 1e-14 * max(
            float(a["t"]), 1e-300)
        assert rel(a["u"], b["u"]) <= TOL
        assert str(b["family"]) == "Qk" and int(b["nx"]) == 60
    assert res.t == pytest.approx(float(ckpt(jout, STEPS)["t"]), rel=1e-14)


def test_resume_from_jax_checkpoint(runs, tmp_path):
    prm, jout, _, _, _ = runs
    with contextlib.redirect_stdout(io.StringIO()):
        res = cli.run([str(prm), "--platform", "cpu", "--x64", "--max-steps",
                       "2", "--checkpoint-every", "1", "--output-dir",
                       str(tmp_path), "--resume",
                       os.path.join(jout, "checkpoint-003.npz")])
    ref = ckpt(jout, STEPS)
    assert res.it == 2
    assert res.t == pytest.approx(float(ref["t"]), rel=1e-14)
    assert rel(ref["u"], res.u.numpy()) <= TOL
    # the resumed run's first snapshot is the JAX checkpoint's state
    assert np.array_equal(ckpt(tmp_path, 0)["u"],
                          ckpt(jout, 3)["u"])


def test_vtu_snapshots_and_chunked_loop(runs, tmp_path):
    """The VTU files hold the fluid cells' patches (appended raw binary,
    its blocks adding up to the file), and a chunked run (--chunk 5, one
    host sync per chunk) ends where the step-by-step run did."""
    prm, _, _, tout, res = runs
    mask = res.solver.mask
    path = os.path.join(tout, "solution-006.vtu")
    data = open(path, "rb").read()
    mark = b'<AppendedData encoding="raw">\n_'
    head = data[:data.index(mark) + len(mark)].decode()
    cells = int(re.search(r'NumberOfCells="(\d+)"', head).group(1))
    points = int(re.search(r'NumberOfPoints="(\d+)"', head).group(1))
    assert cells == int(mask.sum()) and points == 4 * cells     # Q1 patches
    body, n = data[len(head):], 0
    for _ in re.findall(r'offset="(\d+)"', head):
        n += 8 + int(np.frombuffer(body[n:n + 8], np.uint64)[0])
    assert body[n:] == b"\n</AppendedData>\n</VTKFile>\n"
    with contextlib.redirect_stdout(io.StringIO()):
        chunked = cli.run([str(prm), "--platform", "cpu", "--x64",
                           "--max-steps", str(STEPS), "--chunk", "5",
                           "--output-dir", str(tmp_path)])
    assert chunked.it == STEPS and chunked.t == pytest.approx(res.t,
                                                              rel=1e-14)
    assert rel(res.u.numpy(), chunked.u.numpy()) <= 1e-12
