"""The port's CLI with ``--precond`` and with ``--devices`` against cgx's
(cgx/cli/main.py:197-240, :285-340, :398-406), on the CPU.

``--devices 2`` runs on a gloo world of two spawned ranks (the harness
of test_torch_sharded.py), as ``torchrun --nproc-per-node 2`` would start
it: rank 0 prints the ``[STEP k]`` line and appends the CSV row, whose
``psize`` is 2. No jax or cgx import at the top: the ranks import this
module.
"""

import contextlib
import functools
import io
import os
import re
import tempfile

import pytest
import torch.distributed as dist

from cgx_torch.cli import main as ctcli
from cgx_torch.parallel import initialize_from_env
from test_torch_sharded import run_world

STEP = re.compile(r"\[STEP (\d+)\] residual = ([0-9.e+-]+), \|\|x\|\| = ([0-9.e+-]+), "
                  r"\|\|Ax - b\|\|/\|\|b\|\| = ([0-9.e+-]+|nan)")
# name: the CLI's options after "256 OUT", on two ranks
SHARDED_RUNS = {
    "dia_halo": ["--format", "dia", "--tol", "1e-6"],
    "dense_reducescatter": ["--tol", "1e-6", "--strategy", "reducescatter"],
    "dia_pipelined_neumann": ["--format", "dia", "--tol", "1e-6", "--method", "pipelined",
                              "--precond", "neumann"],
    "csr_jacobi": ["--format", "csr", "--tol", "1e-6", "--precond", "jacobi"],
    "dia_block_jacobi": ["--format", "dia", "--tol", "1e-6", "--precond", "block_jacobi",
                         "--precond-block-size", "16"],
    "dense_chebyshev": ["--tol", "1e-6", "--precond", "chebyshev"],
}


def _step(out: str):
    m = STEP.search(out)
    assert m, out
    return int(m.group(1)), float(m.group(2)), float(m.group(3)), float(m.group(4))


def _cli(argv):
    """(stdout, the CSV file's text) of one port CLI run on this rank."""
    out_dir = tempfile.mkdtemp()
    path = os.path.join(out_dir, "o.txt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ctcli.main(["256", path] + argv + ["--device", "cpu"])
    assert rc == 0
    text = open(path).read() if os.path.exists(path) else ""
    return buf.getvalue(), text


def case_cli_runs():
    return {name: _cli(opts + ["--devices", "2"]) for name, opts in SHARDED_RUNS.items()}


def case_cli_wrong_devices():
    try:
        _cli(["--devices", "4"])
    except ValueError as e:
        return str(e)
    return None


def case_initialize():
    """The group this rank runs in: the CLI takes the one it finds."""
    return {"world": dist.get_world_size(), "rank": dist.get_rank(),
            "backend": dist.get_backend()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_world(str(tmp_path_factory.mktemp("cli2")), 2, __name__,
                     ["case_cli_runs", "case_cli_wrong_devices", "case_initialize"])


@functools.lru_cache(maxsize=None)
def cgx_cli(argv: tuple):
    """(stdout, CSV text) of cgx's CLI in this process."""
    from cgx.cli import main as climod

    out_dir = tempfile.mkdtemp()
    path = os.path.join(out_dir, "o.txt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert climod.main(["256", path] + list(argv)) == 0
    return buf.getvalue(), open(path).read()


@pytest.mark.parametrize("name", list(SHARDED_RUNS))
def test_two_rank_run_matches_cgx(two_ranks, name):
    """Rank 0 reports; rank 1 prints and writes nothing. The [STEP k]
    line matches cgx's --devices 2 run, and the row names psize 2."""
    out, csv = two_ranks[0]["case_cli_runs"][name]
    out1, csv1 = two_ranks[1]["case_cli_runs"][name]
    assert "[STEP" not in out1 and csv1 == ""
    w_out, w_csv = cgx_cli(tuple(SHARDED_RUNS[name] + ["--devices", "2"]))
    gk, gres, gx, grel = _step(out)
    wk, wres, wx, wrel = _step(w_out)
    assert gk == wk
    assert gres == pytest.approx(wres, rel=1e-6)
    assert gx == pytest.approx(wx, rel=1e-9)
    assert grel < 1e-9
    row = csv.strip().split(",")
    assert row[:2] == w_csv.strip().split(",")[:2] == ["256", "2"] and float(row[2]) > 0


def test_devices_must_equal_the_world(two_ranks):
    for rank in two_ranks:
        assert "--devices 4 but the process group has 2 ranks" in rank["case_cli_wrong_devices"]


def test_the_harness_group_is_gloo(two_ranks):
    assert [r["case_initialize"] for r in two_ranks] == [
        {"world": 2, "rank": 0, "backend": "gloo"}, {"world": 2, "rank": 1, "backend": "gloo"}]


def test_devices_without_torchrun_raises(tmp_path, monkeypatch):
    for var in ("WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        ctcli.main(["64", str(tmp_path / "o.txt"), "--devices", "2", "--device", "cpu"])


def test_initialize_from_env_needs_a_rank(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun or SLURM"):
        initialize_from_env()


@pytest.mark.parametrize("precond", ["jacobi", "neumann"])
@pytest.mark.parametrize("fmt", ["dense", "dia", "csr"])
@pytest.mark.parametrize("method", ["reference", "pipelined"])
def test_precond_single_device_matches_cgx(precond, fmt, method):
    """--precond jacobi|neumann on one device (neumann on a non-banded
    operator falls back to jacobi, as in cgx); the [STEP k] line shows
    the residual norm under a preconditioner, as cgx's does."""
    opts = ["--format", fmt, "--tol", "1e-6", "--precond", precond, "--method", method]
    out, csv = _cli(opts)
    w_out, w_csv = cgx_cli(tuple(opts))
    gk, gres, gx, grel = _step(out)
    wk, wres, wx, wrel = _step(w_out)
    assert gk == wk
    assert gres == pytest.approx(wres, rel=1e-6)
    assert gx == pytest.approx(wx, rel=1e-9)
    assert grel < 1e-9 and wrel < 1e-9
    assert csv.strip().split(",")[:2] == ["256", "1"]
