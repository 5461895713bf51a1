"""The port's CLI (``cgx_torch.cli.main``) against cgx's
(``cgx.cli.main``) with the same arguments, on the CPU: both grammars,
every ``--format``, the ``[STEP k]`` line, the CSV rows, ``std::stoi``
parity, the usage message, the preconditioners, and the flags whose
paths are not ported.

Tolerances are set above the fp64 floor (1e-6 absolute, against
``||b||`` near 1e5), where the two packages' iteration counts agree
exactly; the full-size run keeps cgx's default 1e-10."""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
import cgx.solver.operators as cgx_ops
from cgx.cli import main as climod
from cgx.mats.generators import lap2d_fd_coo_lower
from cgx_torch.cli import main as ctcli
from cgx_torch.ops import matvec

STEP = re.compile(r"\[STEP (\d+)\] residual = ([0-9.e+-]+), \|\|x\|\| = ([0-9.e+-]+), "
                  r"\|\|Ax - b\|\|/\|\|b\|\| = ([0-9.e+-]+|nan)")


def _step(out: str):
    m = STEP.search(out)
    assert m, out
    return int(m.group(1)), float(m.group(2)), float(m.group(3)), float(m.group(4))


def _both(argv, tmp_path, capsys):
    """Run cgx's CLI and the port's (on the CPU) with ``argv``, where
    ``OUT`` stands for each one's own CSV file; return both
    ``(stdout, csv fields)``."""
    res = {}
    for name, call in (("cgx", climod.main),
                       ("port", lambda a: ctcli.main(a + ["--device", "cpu"]))):
        out = tmp_path / f"{name}.txt"
        rc = call([str(out) if a == "OUT" else a for a in argv])
        assert rc == 0, name
        res[name] = (capsys.readouterr().out, out.read_text().strip().split(","))
    return res["cgx"], res["port"]


def _assert_same_solve(want, got):
    (w_out, w_row), (g_out, g_row) = want, got
    wk, wres, wx, wrel = _step(w_out)
    gk, gres, gx, grel = _step(g_out)
    assert gk == wk
    assert gres == pytest.approx(wres, rel=1e-6)
    assert gx == pytest.approx(wx, rel=1e-9)
    assert grel < 1e-9 and wrel < 1e-9
    assert len(g_row) == len(w_row) == 3 and g_row[:2] == w_row[:2] and float(g_row[2]) > 0
    assert "Time for CG" in g_out


@pytest.mark.parametrize("extra", [["--format", "dense"], ["--format", "dia"],
                                   ["--format", "ell"], ["--format", "csr"], ["--pallas"]],
                         ids=["dense", "dia", "ell", "csr", "pallas"])
def test_mpi_grammar_matches_cgx(extra, tmp_path, capsys):
    want, got = _both(["256", "OUT", "--tol", "1e-6"] + extra, tmp_path, capsys)
    _assert_same_solve(want, got)
    assert got[1][:2] == ["256", "1"]


@pytest.mark.parametrize("method", ["pipelined", "sstep", "gvpipe", "chebyshev"])
def test_methods_match_cgx(method, tmp_path, capsys):
    """--method pipelined, sstep, gvpipe and chebyshev (cgx
    cli/main.py:341-377) on lap2d_fd(24) through the CUDA grammar, fp64
    at 1e-6: the [STEP k] line (k equal, but within s = 4 for s-step,
    whose Gram sums in another order) and the CSV row."""
    path = tmp_path / "lap24.mtx"
    lap2d_fd_coo_lower(24).write(path)
    (w_out, w_row), (g_out, g_row) = _both(
        [str(path), "1024", "16", "false", "OUT", "--format", "dia", "--tol", "1e-6",
         "--method", method], tmp_path, capsys)
    wk, wres, wx, wrel = _step(w_out)
    gk, gres, gx, grel = _step(g_out)
    assert gk == wk if method != "sstep" else abs(gk - wk) <= 4
    assert gx == pytest.approx(wx, rel=1e-9)
    assert grel < 1e-8 and wrel < 1e-8
    assert g_row[:2] == w_row[:2] == ["1024", "16"] and float(g_row[2]) > 0


@pytest.fixture
def mtx12(tmp_path):
    path = tmp_path / "lap12.mtx"
    lap2d_fd_coo_lower(12).write(path)
    return str(path)


@pytest.mark.parametrize("fused,fmt", [("true", "dense"), ("false", "dense"), ("true", "dia"),
                                       ("true", "ell"), ("true", "csr")])
def test_cuda_grammar_matches_cgx(mtx12, fused, fmt, tmp_path, capsys):
    want, got = _both([mtx12, "1024", "16", fused, "OUT", "--format", fmt, "--tol", "1e-6"],
                      tmp_path, capsys)
    _assert_same_solve(want, got)
    assert got[1][:2] == ["1024", "16"]


def test_cuda_grammar_true_runs_the_dense_kernel_with_clamped_tiles(mtx12, tmp_path):
    before = matvec.dense_matvec.launches
    run = ctcli.run([mtx12, "1000,", "200", "true", str(tmp_path / "o.txt"), "--device", "cpu"])
    assert run.rc == 0 and type(run.op).__name__ == "PallasDenseOperator"
    assert (run.op.block_rows, run.op.block_cols) == (1000, 128)  # cli/main.py:271-272
    assert matvec.dense_matvec.launches - before >= int(run.result.iterations) + 1
    assert run.csv_row.startswith("1000,200,")
    default = ctcli.run(["64", str(tmp_path / "o.txt"), "--pallas", "--device", "cpu"])
    assert (default.op.block_rows, default.op.block_cols) == (256, 512)
    assert type(ctcli.run(["64", str(tmp_path / "o.txt"), "--device", "cpu"]).op).__name__ == (
        "DenseOperator")


def test_maxiter_positional_matches_cgx(tmp_path, capsys):
    want, got = _both(["256", "OUT", "50", "--format", "dia", "--tol", "0.0"], tmp_path, capsys)
    assert "[STEP 50]" in want[0] and "[STEP 50]" in got[0]


@pytest.mark.parametrize("grammar", ["mpi", "cuda"])
def test_usage_message_and_rc_1(mtx12, grammar, capsys):
    argv = ["256"] if grammar == "mpi" else [mtx12, "8"]
    assert climod.main(argv) == 1
    want = capsys.readouterr().err
    assert ctcli.main(argv + ["--device", "cpu"]) == 1
    got = capsys.readouterr().err
    assert "usage" in want and "usage" in got


@pytest.mark.parametrize("token", ["1024,", "-3x", "+7", "16", "0012", "x3", "", "-"])
def test_stoi_and_is_int_parity(token):
    try:
        want = climod._stoi(token)
    except ValueError:
        with pytest.raises(ValueError):
            ctcli._stoi(token)
    else:
        assert ctcli._stoi(token) == want
    assert ctcli._is_int(token) == climod._is_int(token)


@pytest.mark.parametrize("fmt", ["dia", "ell", "csr"])
def test_host_conversions_match_cgx(fmt):
    dia_c, dia_p = cgx.lap2d_reference(64), ctcli.lap2d_reference(64)
    conv = {"dia": lambda m, d: d, "ell": lambda m, d: m._dia_to_ell(d),
            "csr": lambda m, d: m._dia_to_csr(d)}[fmt]
    want, got = conv(climod, dia_c), conv(ctcli, dia_p)
    for field in ("indices", "indptr", "values", "bands"):
        if hasattr(want, field):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(ctcli._as_dense_np(got), climod._as_dense_np(want))


@pytest.mark.parametrize(
    "extra,error,match",
    # --devices, --precond and their A14 pairs run now (test_torch_cli_sharded.py, below);
    # --precision bf16 runs since ROADMAP A6's first part (tests/test_torch_bf16.py), but
    # not into the s-step loop, which carries no bfloat16 vectors in cgx either
    [(["--precision", "bf16"], TypeError, "bfloat16")],
    ids=["bf16"],
)
def test_unported_flags_raise_naming_their_item(extra, error, match, tmp_path):
    assert ctcli.main(["64", str(tmp_path / "ok.txt"), "--device", "cpu", "--tol", "1e3"]
                      + extra) == 0
    assert (tmp_path / "ok.txt").read_text().startswith("64,1,")
    with pytest.raises(error, match=match):
        ctcli.main(["64", str(tmp_path / "o.txt"), "--device", "cpu", "--method", "sstep"]
                   + extra)
    assert not (tmp_path / "o.txt").exists()


@pytest.mark.parametrize(
    "extra",
    [["--precond", "block_jacobi"], ["--precond", "mg"], ["--precond", "chebyshev"],
     ["--precond", "block_jacobi", "--precond-block-size", "24"],
     ["--precond", "mg", "--mg-smoother", "gs"], ["--precond", "mg", "--mg-cycle", "fp32"]],
    ids=["precond", "mg", "chebyshev", "block_size", "mg_gs", "mg_fp32_cycle"],
)
def test_precond_flags_match_cgx(extra, tmp_path, capsys):
    """--precond block_jacobi|chebyshev|mg with their options (cgx
    cli/main.py:285-340) on lap2d_fd(24) through the CUDA grammar, DIA,
    fp64 at 1e-6: the [STEP k] line (k equal; within 1 for the fp32
    cycle) and the CSV row."""
    path = tmp_path / "lap24.mtx"
    lap2d_fd_coo_lower(24).write(path)
    (w_out, w_row), (g_out, g_row) = _both(
        [str(path), "1024", "16", "false", "OUT", "--format", "dia", "--tol", "1e-6"] + extra,
        tmp_path, capsys)
    wk, wres, wx, wrel = _step(w_out)
    gk, gres, gx, grel = _step(g_out)
    assert abs(gk - wk) <= (1 if "fp32" in extra else 0)
    assert gx == pytest.approx(wx, rel=1e-9)
    assert grel < 1e-8 and wrel < 1e-8
    assert g_row[:2] == w_row[:2] == ["1024", "16"] and float(g_row[2]) > 0


def test_precond_mg_needs_a_banded_operator(tmp_path, capsys):
    """--precond mg on the default dense format: cgx's error, exit code 1
    and no CSV row, from both CLIs."""
    for name, call in (("cgx", climod.main),
                       ("port", lambda a: ctcli.main(a + ["--device", "cpu"]))):
        out = tmp_path / f"{name}.txt"
        assert call(["64", str(out), "--precond", "mg"]) == 1, name
        assert "needs a banded grid operator" in capsys.readouterr().err
        assert not out.exists()


def test_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctcli.main(["64", str(tmp_path / "o.txt")])


@pytest.mark.parametrize("grammar", ["mpi-dense", "mpi-dia", "cuda-true"])
def test_fp32_run_matches_cgx_with_fp32_dots(mtx12, grammar, tmp_path):
    """An fp32 CLI run has fp32 dots, as cgx's has from a shell. This
    conftest turns x64 on, under which cgx's CLI would take fp64 dots
    (cli/main.py:132-135), so the port is held against cgx's cg_solve
    with dot_precision=float32 on the same operator."""
    if grammar == "cuda-true":
        n = 144
        argv = [mtx12, "1024", "16", "true"]
        want_op = cgx_ops.PallasDenseOperator(  # "1024 16" -> 1024 x 128 tiles
            jnp.asarray(cgx.COOMatrix.read(mtx12).to_dense(), jnp.float32), 1024, 128)
    else:
        n = 256
        argv = ["256"]
        dia = cgx.lap2d_reference(n)
        want_op = (cgx_ops.DenseOperator.from_host(dia.to_dense(), dtype=jnp.float32)
                   if grammar == "mpi-dense" else
                   cgx_ops.DiaOperator.from_host(dia, dtype=jnp.float32))
    b = cgx.source_term(n)
    tol = 1e-5 * float(np.linalg.norm(b))
    want = cgx.cg_solve(want_op, jnp.asarray(b, jnp.float32), tol=tol, dot_precision=jnp.float32)
    fmt = ["--format", "dia"] if grammar == "mpi-dia" else []
    run = ctcli.run(argv + [str(tmp_path / "o.txt"), "--precision", "fp32", "--tol", str(tol),
                            "--device", "cpu"] + fmt)
    assert run.result.x.dtype == torch.float32 and run.result.rsold.dtype == torch.float32
    assert int(run.result.iterations) == int(want.iterations)
    want_x = np.asarray(want.x, np.float64)
    assert np.max(np.abs(run.result.x.numpy() - want_x)) <= 1e-4 * np.max(np.abs(want_x))


@pytest.fixture(scope="module")
def fullsize_mtx(tmp_path_factory):
    """lap2D_5pt_n100.mtx regenerated at full size, as
    tests/test_mtx_fullsize.py:24-31 does."""
    path = tmp_path_factory.mktemp("mtx") / "lap2D_5pt_n100.mtx"
    lap2d_fd_coo_lower(100).write(path, comment=" 2D 5-point Laplacian, 100x100 grid")
    return str(path)


def test_fullsize_cuda_grammar_reaches_cgx_k(fullsize_mtx, tmp_path, capsys):
    """tests/test_mtx_fullsize.py:89-110 on both CLIs, fp64 at the
    default tol 1e-10: the port reaches cgx's k (the golden 488)."""
    want, got = _both([fullsize_mtx, "1024", "16", "true", "OUT", "--format", "dia",
                       "--history", "8"], tmp_path, capsys)
    wk, _, wx, wrel = _step(want[0])
    gk, _, gx, grel = _step(got[0])
    assert gk == wk == 488
    assert gx == pytest.approx(wx, rel=1e-9)
    assert grel < 1e-10 and wrel < 1e-10
    assert got[1][:2] == ["1024", "16"] and float(got[1][2]) > 0


def test_module_entry_point_runs_without_jax(tmp_path):
    """``python -m cgx_torch.cli.main`` on the CPU, in a fresh process
    that never imports JAX."""
    out = tmp_path / "o.txt"
    code = ("import sys, runpy; sys.argv = ['cgx-torch', '64', %r, '--format', 'dia', "
            "'--device', 'cpu']; "
            "rc = 0\n"
            "try:\n    runpy.run_module('cgx_torch.cli.main', run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "sys.exit(rc)") % str(out)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(pathlib.Path(__file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stderr
    assert "[STEP" in proc.stdout and out.read_text().startswith("64,1,")


@pytest.mark.parametrize("extra", [["--method", "gvpipe", "--gv-replace-every", "10"],
                                   ["--method", "gvpipe", "--precond", "jacobi"],
                                   ["--method", "chebyshev", "--pallas"],
                                   ["--method", "chebyshev", "--precond", "jacobi"]],
                         ids=["gvpipe_cadence", "gvpipe_jacobi", "chebyshev_pallas",
                              "chebyshev_ignores_precond"])
def test_gvpipe_and_chebyshev_mpi_grammar_match_cgx(extra, tmp_path, capsys):
    """The MPI grammar with the two methods (they raised naming A11 until
    it landed): gvpipe with a cadence and a preconditioner, chebyshev
    through the dense kernel's operator and with a preconditioner it
    ignores, as cgx warns and ignores it."""
    want, got = _both(["256", "OUT", "--tol", "1e-6"] + extra, tmp_path, capsys)
    _assert_same_solve(want, got)
    assert got[1][:2] == ["256", "1"]
