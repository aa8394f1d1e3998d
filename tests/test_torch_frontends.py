"""The port's frontends (CLI, MFS oracle, plots, GUI) on the CPU.

`python -m biem_helmholtz_sphere_tpu_torch --help` runs in a subprocess,
as does the check that the frontends import no JAX; the subcommands run
through the same entry (`cli.main`) in this process, with --device cpu.
Their accuracy and jascome rows are held to the JAX package's CLI rows
(complex128, CPU) within 1e-10, its header and heatmap file names equal,
read from tests/golden/test_torch_frontends.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests test_torch_frontends`: the JAX CLI
compiles each shape); the MFS oracle,
numpy-only in both packages, is held to the JAX package's copy within
1e-12 on the spot.  The GUI tests mirror the JAX package's
(tests/test_frontends.py) on the port.
"""

import csv
import os
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import _jax_golden
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCURACY = ["--branching-types", "a,ba", "--k-max-log2", "1", "--n-end-max-log2", "2"]
PORT_MODULES = ("parallel", "cli", "validation", "plot", "gui")


def _cli(*args):
    from biem_helmholtz_sphere_tpu_torch.cli import main

    main(list(args))


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def jax_golden():
    """The JAX package's CLI rows: `accuracy` in mode k (the ACCURACY
    sweep) and `jascome` for 'ba' at n_end 1..3, complex128 on the CPU."""
    import tempfile

    from biem_helmholtz_sphere_tpu.cli._accuracy import _HEADER, plot_accuracy, run_accuracy
    from biem_helmholtz_sphere_tpu.cli._jascome import run_jascome

    out = {"accuracy header": np.array(_HEADER)}
    with tempfile.TemporaryDirectory() as tmp:
        rows = _rows(run_accuracy(tmp, branching_types=["a", "ba"], mode="k",
                                  k_max_log2=1.0, n_end_max_log2=2.0))
        out["heatmaps"] = np.array(sorted(os.path.basename(p) for p in plot_accuracy(tmp)))
        out["accuracy keys"] = np.array([f"{r['branching_types']} {float(r['k'])!r} "
                                         f"{r['n_end']}" for r in rows])
        out["accuracy uscat"] = np.array([complex(float(r["uscat_real"]),
                                                  float(r["uscat_imag"])) for r in rows])
        rows = _rows(run_jascome(tmp, n_end_max=3, btypes=["ba"]))
        out["jascome uscat"] = np.array([complex(r["uscat"].strip("()")) for r in rows])
    return out


@pytest.fixture(scope="module")
def golden():
    return _jax_golden.load("test_torch_frontends")


def test_cli_help():
    out = subprocess.run([sys.executable, "-m", "biem_helmholtz_sphere_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=REPO, check=True)
    assert "biem-helmholtz-sphere-tpu-torch" in out.stdout
    for cmd in ("serve", "jascome", "jascome-bempp", "jascome-clean", "accuracy",
                "plot-accuracy", "bench"):
        assert cmd in out.stdout


def test_frontends_import_no_jax():
    """A fresh interpreter importing parallel, cli, validation, plot and gui
    of the port has no "jax" in sys.modules."""
    mods = "; ".join(f"import biem_helmholtz_sphere_tpu_torch.{m}" for m in PORT_MODULES)
    subprocess.run([sys.executable, "-c", f"import sys; {mods}; "
                    "assert 'jax' not in sys.modules, 'jax imported'"], check=True, cwd=REPO)


def test_accuracy_rows_match_the_jax_cli(tmp_path, golden):
    """`accuracy --mode k` on 'a' and 'ba' (n_end 1..4, k 1..2): the JAX
    CLI's header, and each row's uscat(0) within 1e-10 of its row; then
    `plot-accuracy` writes the JAX CLI's file names."""
    _cli("accuracy", "--device", "cpu", "--dtype", "float64", *ACCURACY, "--out-dir",
         str(tmp_path))
    path = tmp_path / "accuracy.csv"
    with open(path) as fh:
        assert fh.readline().strip() == ",".join(golden["accuracy header"])
    rows = _rows(path)
    keys = [f"{r['branching_types']} {float(r['k'])!r} {r['n_end']}" for r in rows]
    assert keys == list(golden["accuracy keys"])
    got = np.array([complex(float(r["uscat_real"]), float(r["uscat_imag"])) for r in rows])
    np.testing.assert_allclose(got, golden["accuracy uscat"], rtol=0, atol=1e-10)
    assert {(r["device"], r["dtype"], r["density_dtype"], r["uscat_device"]) for r in rows} \
        == {("cpu", "float64", "complex128", "cpu")}
    assert {r["solve_relres"] for r in rows} == {"exact"}  # 2 spheres: LU

    _cli("plot-accuracy", "--out-dir", str(tmp_path))
    names = sorted(p.name for p in tmp_path.glob("accuracy_heatmap_*"))
    assert names == list(golden["heatmaps"])
    assert all((tmp_path / n).stat().st_size > 1000 for n in names)


def test_accuracy_k_block_matches_scalar(tmp_path):
    """k_block > 1 solves k-points in one batched call; its rows match the
    one-k calls to solver precision (as the JAX CLI's test)."""
    from biem_helmholtz_sphere_tpu_torch.cli._accuracy import run_accuracy

    kw = dict(branching_types=["a"], mode="k", k_max_log2=1.0, n_end_max_log2=1.0,
              device="cpu")
    one = _rows(run_accuracy(str(tmp_path / "scalar"), **kw))
    blk = _rows(run_accuracy(str(tmp_path / "blocked"), k_block=2, **kw))
    assert [(r["k"], r["n_end"]) for r in one] == [(r["k"], r["n_end"]) for r in blk]
    for key in ("uscat_real", "uscat_imag"):
        np.testing.assert_allclose([float(r[key]) for r in blk], [float(r[key]) for r in one],
                                   rtol=0, atol=1e-8)


def test_jascome_and_clean(tmp_path, golden):
    _cli("jascome", "--device", "cpu", "--n-end-max", "3", "--btypes", "ba", "--out-dir",
         str(tmp_path))
    rows = _rows(tmp_path / "jascome_output.csv")
    assert [int(r["n_end"]) for r in rows] == [1, 2, 3]
    got = np.array([complex(r["uscat"].strip("()")) for r in rows])
    np.testing.assert_allclose(got, golden["jascome uscat"], rtol=0, atol=1e-10)
    assert (tmp_path / "ba.svg").stat().st_size > 1000
    _cli("jascome-clean", "--out-dir", str(tmp_path))
    with open(tmp_path / "jascome_output_3d.csv") as fh:
        table = list(csv.reader(fh))
    assert table[0] == ["n", "ba"] and len(table) == 4


def test_jascome_bempp_matches_the_jax_oracle(tmp_path):
    """`jascome-bempp` runs the port's copy of the MFS oracle; both copies
    agree within 1e-12, and the ladder nears the README golden."""
    from biem_helmholtz_sphere_tpu.validation import mfs_uscat as j_mfs_uscat
    from biem_helmholtz_sphere_tpu_torch.validation import mfs_uscat

    _cli("jascome-bempp", "--out-dir", str(tmp_path), "--n-src-max", "100")
    rows = _rows(tmp_path / "jascome_mfs_output.csv")
    assert [int(r["n_src"]) for r in rows] == [50, 100]
    last = complex(rows[-1]["uscat"].strip("()"))
    assert abs(last - (-0.74133 - 0.66966j)) < 2e-5
    kw = dict(centers=np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]]), radii=np.ones(2), k=1.0,
              direction=np.array([1.0, 0.0, 0.0]), n_src=100, src_depth=0.45)
    x = np.array([[0.0, 0.0, 0.0], [3.0, 1.0, 0.5]])
    got, ref = mfs_uscat(**kw), j_mfs_uscat(**kw)
    np.testing.assert_allclose(got.uscat(x), ref.uscat(x), rtol=0, atol=1e-12)
    assert abs(got.bc_residual - ref.bc_residual) <= 1e-12


def test_bench_on_the_cpu_with_a_profile(tmp_path, capsys):
    _cli("bench", "--device", "cpu", "--n-end", "6", "--profile", str(tmp_path))
    out = capsys.readouterr().out
    assert "device=cpu" in out and "per k-point" in out
    assert (tmp_path / "bench_trace.json").stat().st_size > 1000


def _pair_calc(n_end=4):
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    f64 = dict(dtype=torch.float64)
    k = torch.tensor(1.0, **f64)
    uin, _ = plane_wave(k=k, direction=torch.tensor([1.0, 0.0, 0.0], **f64))
    return biem(create_from_branching_types("ba"),
                centers=torch.tensor([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], **f64),
                radii=torch.ones(2, **f64), k=k, n_end=n_end, uin=uin)


def test_plots(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from biem_helmholtz_sphere_tpu_torch.plot import animate_biem, plot_biem, plot_biem_far

    calc = _pair_calc()
    ax = plot_biem(calc, n_points=24)
    ax.figure.savefig(tmp_path / "near.png")
    ax2 = plot_biem_far(calc, n_points=36)
    ax2.figure.savefig(tmp_path / "far.png")
    animate_biem(calc, str(tmp_path / "anim.gif"), n_frames=3, n_points=16)
    for name in ("near.png", "far.png", "anim.gif"):
        assert (tmp_path / name).stat().st_size > 1000, name


def test_gui_solver_handler():
    from biem_helmholtz_sphere_tpu_torch.gui import _solve_and_plot

    status, images = _solve_and_plot({
        "ctype": "custom", "btype": "ba", "dim": "3", "device": "cpu", "dtype": "float64",
        "k": "1", "eta": "1", "n_end": "6", "kind": "outer",
        "spheres": "1+0j, 0+0j, 1.0, 0 2 0\n1+0j, 0+0j, 1.0, 0 -2 0",
        "axes": "0 1", "lim": "6", "fmt": "png",
    })
    assert "uscat(0) = -0.741333-0.669657j" in status  # the README golden
    assert "device: cpu" in status and "complex128" in status
    assert "base64" in images


def test_gui_http_roundtrip():
    from biem_helmholtz_sphere_tpu_torch.gui import _Handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30).read()
        for needle in (b"biem-helmholtz-sphere-tpu-torch", b'name="device"', b'name="dtype"',
                       b'name="force_matrix"', b'name="sphere"', b"addRow",
                       b'name="animate"', b'id="progress"',
                       b'id="reactive" name="reactive" checked', b"fetch('/compute'",
                       b"<option >cpu</option>"):
            assert needle in page, needle
        data = urllib.parse.urlencode([
            ("ctype", "custom"), ("btype", "ba"), ("dim", "3"), ("device", "cpu"),
            ("dtype", "float32"), ("k", "1"), ("eta", "1"), ("n_end", "2"),
            ("kind", "outer"), ("sphere", "1+0j, 0+0j, 1.0, 0 2 0"),
            ("sphere", "1+0j, 0+0j, 1.0, 0 -2 0"), ("sphere", "1+0j, 1+0j, 0.5, 3 0 0"),
            ("axes", "0 1"), ("lim", "4"), ("t", "0.25"), ("fmt", "png"),
        ]).encode()
        resp = urllib.request.urlopen(
            urllib.request.Request(f"http://127.0.0.1:{port}/", data=data), timeout=300).read()
        assert b"uscat(0)" in resp and b"device: cpu" in resp and b"base64" in resp
        assert resp.count(b'name="sphere"') == 3 + 1  # the rows and addRow's template
        frag = urllib.request.urlopen(
            urllib.request.Request(f"http://127.0.0.1:{port}/compute", data=data),
            timeout=300).read()
        assert b"uscat(0)" in frag and b"<form" not in frag
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_gui_compute_serialized(monkeypatch):
    """Concurrent /compute POSTs are serialized through the module lock and
    stale queued requests are dropped (answered 204) without a solve."""
    from biem_helmholtz_sphere_tpu_torch import gui

    calls = {"active": 0, "max_active": 0, "n": 0, "seqs": []}
    guard = threading.Lock()

    def fake_solve(form):
        with guard:
            calls["active"] += 1
            calls["max_active"] = max(calls["max_active"], calls["active"])
            calls["n"] += 1
            calls["seqs"].append(form.get("__seq"))
        time.sleep(0.3)
        with guard:
            calls["active"] -= 1
        return "<p>uscat(0) = fake</p>", ""

    monkeypatch.setattr(gui, "_solve_and_plot", fake_solve)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), gui._Handler)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        statuses = {}

        def post(seq):
            data = urllib.parse.urlencode(
                {"__seq": str(seq), "__cid": "torchcid", "n_end": "2"}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/compute", data=data)
            with urllib.request.urlopen(req, timeout=30) as resp:
                statuses[seq] = resp.status

        threads = []
        for seq in (1, 2, 3):
            t = threading.Thread(target=post, args=(seq,))
            t.start()
            threads.append(t)
            time.sleep(0.08)  # 1 starts solving; 2 and 3 queue behind the lock
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert calls["max_active"] == 1
        assert calls["n"] < 3
        assert statuses[3] == 200 and 204 in statuses.values()
        assert "3" in calls["seqs"]
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_gmres_tolerance_overrides(monkeypatch, dtype):
    """BHS_GMRES_TOL (float64) and BHS_GMRES_TOL_F32 (float32) replace the
    default tolerance when tol is None, as in the JAX package; an explicit
    tol wins, and the other precision's variable is not read."""
    from biem_helmholtz_sphere_tpu_torch.ops.gmres import gmres_solve_op

    rng = np.random.default_rng(5)
    n = 40
    a = torch.as_tensor(np.eye(n) * 4 + rng.standard_normal((n, n)) * 0.5, dtype=dtype)
    b = torch.as_tensor(rng.standard_normal((1, n)), dtype=dtype)

    def steps(tol=None):
        _, relres, iters = gmres_solve_op(lambda x: x @ a.T, a.diagonal()[None], b, tol=tol)
        return float(relres[0]), int(iters[0])

    mine, other = (("BHS_GMRES_TOL_F32", "BHS_GMRES_TOL") if dtype == torch.complex64
                   else ("BHS_GMRES_TOL", "BHS_GMRES_TOL_F32"))
    monkeypatch.delenv(mine, raising=False)
    monkeypatch.setenv(other, "0.5")
    default = steps()
    monkeypatch.setenv(mine, "1e-2")
    loose = steps()
    assert loose[0] <= 1e-2 and loose[1] < default[1]
    assert steps(tol=1e-5)[1] > loose[1]
