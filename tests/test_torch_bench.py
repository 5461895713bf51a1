"""The port's bench tooling (cgx_torch.bench) against cgx's (cgx/bench):
cgx's cases of tests/test_slope.py, test_autotune.py, test_tenancy.py and
test_bench_analysis.py run on both packages, where the same fake
callables and virtual clocks give the same outputs; the measurements'
structure on the CPU (no slope is asserted from CPU wall time); the
bandwidth table's refusal; the autotuner's feasibility from dense_plan
and its cache; the CLI's tuned tiles; the sweeps on the CPU and on a
two-rank gloo world.

No jax or cgx import at the top: the spawned ranks import this module.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from cgx_torch.bench import analysis, autotune, slope, sweeps, tenancy
from cgx_torch.bench import report as port_report
from cgx_torch.mats.generators import lap2d_fd
from test_torch_sharded import run_world

PACKAGES = ["cgx", "port"]


def _bench(package: str, module: str):
    if package == "cgx":
        return importlib.import_module(f"cgx.bench.{module}")
    return importlib.import_module(f"cgx_torch.bench.{module}")


def _slope_kw(package: str) -> dict:
    return {} if package == "cgx" else {"device": "cpu"}


# ---------------------------------------------------------------------------
# The slope method (tests/test_slope.py)
# ---------------------------------------------------------------------------


def _fixed_cost_run(vclock, spikes=(), drift=0.0):
    def run(b, k):
        vclock["calls"] += 1
        spike = 0.080 if vclock["calls"] in spikes else 0.0
        vclock["t"] += 0.005 + 1e-4 * k + spike + drift * vclock["calls"]
        return np.zeros(1)
    return run


SLOPE_CASES = {
    "fixed_overhead": dict(reps=3, spikes=(), drift=0.0),
    "outlier_spikes": dict(reps=5, spikes=(3, 11), drift=0.0),
    "linear_drift": dict(reps=4, spikes=(), drift=2e-3),
}


def _slope_out(package: str, case: str) -> dict:
    c = SLOPE_CASES[case]
    vclock = {"t": 0.0, "calls": 0}
    return _bench(package, "slope").slope_seconds_per_iter(
        _fixed_cost_run(vclock, c["spikes"], c["drift"]), lambda rep: np.zeros(4),
        ks=(10, 40, 70), reps=c["reps"], clock=lambda: vclock["t"], **_slope_kw(package))


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", list(SLOPE_CASES))
def test_slope_mathematics(package, case):
    """5 ms fixed + 0.1 ms an iteration: 0.1 ms/iter exactly and a 5 ms
    floor; two spiked samples of 15 leave Theil-Sen exact and flag the
    least-squares fit; the snake order cancels a linear drift."""
    out = _slope_out(package, case)
    if case == "linear_drift":
        assert abs(out["s_per_iter"] - 1e-4) / 1e-4 < 0.05
        return
    assert abs(out["s_per_iter"] - 1e-4) / 1e-4 < 1e-6
    if case == "fixed_overhead":
        assert abs(out["floor"] - 0.005) < 1e-9
        assert out["fit_rel_err"] < 1e-6
    else:
        assert out["fit_rel_err"] > 0.5


@pytest.mark.parametrize("case", list(SLOPE_CASES))
def test_slope_outputs_equal_cgx(case):
    assert _slope_out("port", case) == _slope_out("cgx", case)


@pytest.mark.parametrize("package", PACKAGES)
def test_bytes_and_utilization(package):
    m = _bench(package, "slope")
    assert m.dia_cg_bytes_per_iter(1000, 5, 8) == 18 * 1000 * 8
    assert m.dia_cg_bytes_per_iter(1000, 5, 8, precond_factor=1.0) == (18 + 7) * 1000 * 8
    rep = m.utilization_report(1e-3, 3350e6, peak_gbps=3350.0)
    assert abs(rep["achieved_gbps"] - 3350.0) < 1e-9
    assert abs(rep["fraction_of_peak"] - 1.0) < 1e-12
    assert m.dense_cg_flops_per_iter(100) == 2e4


ROWS = [((283.0, 0.034, 90.4), {}, True), ((940.6, 0.164, 79.8), {}, True),
        ((34.3, 27.316, 854.9), {}, False), ((-45.3, 0.1, 50.0), {}, False),
        ((100.0, 0.05, 150.0), {}, False), ((283.0, 0.21, 90.4), {}, False),
        ((283.0, 0.21, 90.4), {"spread_gate": 0.25}, True)]


@pytest.mark.parametrize("package", PACKAGES)
def test_row_trusted_gates(package):
    for args, kw, want in ROWS:
        assert _bench(package, "slope").row_trusted(*args, **kw) is want, (args, kw)


def test_chip_hbm_gbps_table_and_refusal(monkeypatch):
    """The port's table holds the H100's data-sheet rate, keyed by the
    CUDA device name; any other device raises, naming it, unless a
    default (or, in the measurements, peak_gbps) is given. No TPU entry
    and no TPU default."""
    assert slope.HBM_GBPS == {"NVIDIA H100 80GB HBM3": 3350.0}
    with pytest.raises(ValueError, match="'cpu'"):
        slope.chip_hbm_gbps(device="cpu")
    with pytest.raises(ValueError, match="'cpu'"):
        slope.utilization_report(1e-3, 1e6, device="cpu")
    monkeypatch.setattr(slope, "resolve_device", lambda d: torch.device("cuda", 0))
    for name, want in (("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        if want is None:
            with pytest.raises(ValueError, match="A100-SXM4-80GB"):
                slope.chip_hbm_gbps()
            assert slope.chip_hbm_gbps(1000.0) == 1000.0
        else:
            assert slope.chip_hbm_gbps() == want
            assert slope.utilization_report(1.0, 3350e9)["fraction_of_peak"] == 1.0


def test_measure_dia_cg_structure():
    """The measurement's fields on lap2d_fd(32), with peak_gbps given;
    a positive slope is not asserted from CPU wall times (cgx's
    test_measure_dia_cg_end_to_end is the known timing-dependent test)."""
    out = slope.measure_dia_cg(lap2d_fd(32), ks=(20, 40), reps=2, device="cpu",
                               peak_gbps=100.0)
    assert out["bytes_per_iter"] == 18 * 1024 * 8 and out["n"] == 1024
    assert out["dtype"] == "float64" and out["peak_gbps"] == 100.0 and out["ks"] == (20, 40)
    assert len(out["s_per_iter_all"]) == 2 and np.isfinite(out["s_per_iter"])
    assert out["fraction_of_peak"] == pytest.approx(out["achieved_gbps"] / 100.0)


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_measure_dense_cg_structure(kernel):
    """kernel="pallas" runs the dense kernel's wrapper (B3), "xla" torch.matmul."""
    from cgx_torch.ops import matvec

    before = matvec.dense_matvec.launches
    out = slope.measure_dense_cg(lap2d_fd(8).to_dense(), ks=(5, 10), reps=2, device="cpu",
                                 peak_gbps=100.0, block_rows=16, block_cols=32, kernel=kernel)
    ran = matvec.dense_matvec.launches - before
    assert (ran > 0) == (kernel == "pallas")
    assert out["kernel"] == kernel and out["bytes_per_iter"] == 64 * 64 * 4
    assert (out["block_rows"], out["block_cols"], out["n"]) == (16, 32, 64)
    assert np.isfinite(out["gflops"])
    with pytest.raises(ValueError, match="unknown kernel"):
        slope.measure_dense_cg(np.eye(4), kernel="triton", device="cpu", peak_gbps=1.0)


# ---------------------------------------------------------------------------
# The autotuner (tests/test_autotune.py) and the CLI's tiles
# ---------------------------------------------------------------------------


def test_autotune_picks_persists_and_reloads(tmp_path):
    cache = tmp_path / "autotune.json"
    n = 256
    tiles = autotune.autotune_dense_tiles(n, np.float32, candidates=((128, 128), (128, 256)),
                                          repeats=2, cache_path=str(cache), device="cpu")
    assert tiles in ((128, 128), (128, 256))
    data = json.loads(cache.read_text())
    assert list(data) == [f"cpu|{n}|float32"]
    (rec,) = data.values()
    assert rec["block_rows"] == tiles[0] and rec["block_cols"] == tiles[1]
    assert rec["candidates_tried"] == 2
    assert autotune.tuned_tiles(n, np.float32, cache_path=str(cache), device="cpu") == tiles
    assert autotune.tuned_tiles(n, torch.float32, cache_path=str(cache), device="cpu") == tiles
    again = autotune.autotune_dense_tiles(n, np.float32, candidates=((512, 512),),
                                          cache_path=str(cache), device="cpu")
    assert again == tiles  # a cache hit: the candidates are not measured
    forced = autotune.autotune_dense_tiles(n, np.float32, candidates=((128, 256),), repeats=1,
                                           force=True, cache_path=str(cache), device="cpu")
    assert forced == (128, 256)


def test_tuned_tiles_defaults_and_caches_apart(tmp_path, monkeypatch):
    """Untuned: the static defaults, the CLI's DEFAULT_TILES. The port's
    cache is its own file: a winner in cgx's cache is not read."""
    from cgx_torch.cli import main as cli

    assert autotune.tuned_tiles(10_000, np.float32, cache_path=str(tmp_path / "none.json"),
                                device="cpu") == (256, 512) == cli.DEFAULT_TILES
    cgx_cache = tmp_path / "cgx.json"
    cgx_cache.write_text(json.dumps({"cpu|512|float32": {"block_rows": 8, "block_cols": 128}}))
    monkeypatch.setenv("CGX_AUTOTUNE_CACHE", str(cgx_cache))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("CGX_TORCH_AUTOTUNE_CACHE", raising=False)
    assert autotune._cache_path() == str(tmp_path / ".cache" / "cgx_torch" / "autotune.json")
    assert autotune.tuned_tiles(512, np.float32, device="cpu") == (256, 512)
    monkeypatch.setenv("CGX_TORCH_AUTOTUNE_CACHE", str(cgx_cache))
    assert autotune.tuned_tiles(512, np.float32, device="cpu") == (8, 128)


def test_autotune_clamps_oversized_tiles(tmp_path):
    tiles = autotune.autotune_dense_tiles(256, np.float32, candidates=((100_000, 100_000),),
                                          repeats=1, cache_path=str(tmp_path / "c.json"),
                                          device="cpu")
    assert tiles == (256, 256)


def test_default_candidates_sane():
    """cgx's candidates, each one that dense_plan takes at the reference's
    N on the card in float32 and float64 (cgx's TPU VMEM bound does not
    carry over)."""
    from cgx.bench.autotune import DEFAULT_CANDIDATES as cgx_candidates

    assert autotune.DEFAULT_CANDIDATES == cgx_candidates
    for br, bc in autotune.DEFAULT_CANDIDATES:
        assert br % 8 == 0 and bc % 128 == 0
        for dtype in (torch.float32, torch.float64):
            assert autotune.feasible(10_000, bc, dtype, torch.device("cpu"))


def test_autotune_skips_exactly_what_dense_plan_refuses(tmp_path, monkeypatch):
    from cgx_torch.ops import matvec

    real = matvec.dense_plan
    asked = []

    def plan(n_rows, n_cols, block_cols, dtype, sms, **kw):
        asked.append(block_cols)
        if block_cols == 256:
            raise ValueError("rows do not fit")
        return real(n_rows, n_cols, block_cols, dtype, sms, **kw)

    monkeypatch.setattr(matvec, "dense_plan", plan)
    cache = tmp_path / "c.json"
    tiles = autotune.autotune_dense_tiles(
        256, np.float32, candidates=((128, 256), (128, 128), (64, 256)), repeats=1,
        cache_path=str(cache), device="cpu")
    assert tiles == (128, 128) and asked == [256, 128, 256]
    assert json.loads(cache.read_text())["cpu|256|float32"]["candidates_tried"] == 1
    assert sweeps.kernel_sweep(256, threads=(64,), block_widths=(128, 256), repeats=1,
                               device="cpu")[0].startswith("64,128,")
    assert len(sweeps.kernel_sweep(256, threads=(64,), block_widths=(128, 256), repeats=1,
                                   device="cpu")) == 1

    def broken(*args, **kw):
        raise RuntimeError("a failed build")

    monkeypatch.setattr(matvec, "dense_plan", broken)
    with pytest.raises(RuntimeError, match="failed build"):
        autotune.autotune_dense_tiles(256, np.float32, candidates=((128, 128),), force=True,
                                      cache_path=str(cache), device="cpu")
    monkeypatch.setattr(matvec, "dense_plan", real)
    monkeypatch.setattr(matvec, "dense_matvec", lambda *a, **k: broken())
    with pytest.raises(RuntimeError, match="failed build"):
        autotune.autotune_dense_tiles(256, np.float32, candidates=((128, 128),), force=True,
                                      cache_path=str(cache), device="cpu")


@pytest.mark.parametrize("cached", [None, (16, 200)])
def test_cli_pallas_without_tiles_takes_the_cached_pair(tmp_path, monkeypatch, cached):
    """--pallas without tiles builds its operator with the cache's pair for
    this device, N and dtype (clamped as cgx clamps it), else DEFAULT_TILES;
    explicit tiles (the CUDA grammar's) win over the cache."""
    from cgx_torch.cli import main as cli

    cache = tmp_path / "tiles.json"
    data = {} if cached is None else {
        "cpu|64|float64": {"block_rows": cached[0], "block_cols": cached[1]}}
    cache.write_text(json.dumps(data))
    monkeypatch.setenv("CGX_TORCH_AUTOTUNE_CACHE", str(cache))
    with contextlib.redirect_stdout(io.StringIO()):
        run = cli.run(["64", str(tmp_path / "out.txt"), "--pallas", "--device", "cpu"])
    assert run.rc == 0 and type(run.op).__name__ == "PallasDenseOperator"
    want = cli.DEFAULT_TILES if cached is None else (16, 128)
    assert (run.op.block_rows, run.op.block_cols) == want
    assert bool(run.result.converged)


# ---------------------------------------------------------------------------
# Per-row control gating (tests/test_tenancy.py)
# ---------------------------------------------------------------------------


class Script:
    """A control kernel whose value follows a scripted sequence."""

    def __init__(self, values):
        self.values = list(values)
        self.calls = 0

    def __call__(self):
        v = self.values[min(self.calls, len(self.values) - 1)]
        self.calls += 1
        return v


def no_sleep(_s):
    pass


def _tenancy_cases(m):
    """cgx's cases on module ``m``: each returns what its asserts read."""
    out = {}
    c = Script([100.0, 101.0, 99.5])
    out["calm"] = m.calibrate_control(c, sleep=no_sleep)
    c = Script([100.0, 150.0, 80.0, 100.0, 100.5, 99.9])
    out["recovers"] = (m.calibrate_control(c, sleep=no_sleep), c.calls)
    out["gives_up"] = m.calibrate_control(Script([100.0, 150.0] * 40), runs=2, max_rounds=3,
                                          sleep=no_sleep)
    out["clean"] = m.measure_with_control(lambda: {"us": 42.0}, Script([100.0, 100.0]), 100.0,
                                          sleep=no_sleep)
    seen = []
    out["burst"] = m.measure_with_control(lambda: (seen.append(1), {"us": 42.0})[1],
                                          Script([100.0, 160.0, 100.0, 100.0]), 100.0,
                                          sleep=no_sleep)
    out["burst_measures"] = len(seen)
    out["permanent"] = m.measure_with_control(lambda: {"us": 42.0}, Script([160.0] * 40), 100.0,
                                              retries=3, sleep=no_sleep)
    out["sweep"] = m.gated_sweep(["a", "b", "c"], lambda item: {"item": item},
                                 Script([100.0] * 7 + [102.0] * 5), recalibrate_every=2,
                                 sleep=no_sleep)
    out["uncalibratable"] = m.gated_sweep(["a"], lambda item: {"item": item},
                                          Script([100.0, 150.0] * 40), retries=1, sleep=no_sleep)
    with pytest.raises(ValueError):
        m.measure_with_control(lambda: {}, lambda: 1.0, 0.0)
    return out


@pytest.mark.parametrize("package", PACKAGES)
def test_tenancy_cases(package):
    out = _tenancy_cases(_bench(package, "tenancy"))
    assert out["calm"] == pytest.approx(100.0)
    assert out["recovers"][0] == pytest.approx(100.0) and out["recovers"][1] == 6
    assert out["gives_up"] is None
    row = out["clean"]
    assert row["row_trusted"] and row["us"] == 42.0 and row["attempts"] == 1
    assert row["control_dev"] == 0.0
    assert out["burst"]["row_trusted"] and out["burst"]["attempts"] == 2
    assert out["burst_measures"] == 2
    row = out["permanent"]
    assert not row["row_trusted"] and row["attempts"] == 3
    assert row["control_dev"] == pytest.approx(0.6)
    rows = out["sweep"]
    assert [r["item"] for r in rows] == ["a", "b", "c"] and all(r["row_trusted"] for r in rows)
    assert rows[0]["expected_control"] == pytest.approx(100.0)
    assert rows[2]["expected_control"] == pytest.approx(102.0)
    assert out["uncalibratable"][0]["calibration_failed"]
    assert not out["uncalibratable"][0]["row_trusted"]


def test_tenancy_outputs_equal_cgx():
    assert _tenancy_cases(tenancy) == _tenancy_cases(_bench("cgx", "tenancy"))


# ---------------------------------------------------------------------------
# The analysis and the report (tests/test_bench_analysis.py)
# ---------------------------------------------------------------------------


def _analysis_values(m):
    """cgx's analysis cases on module ``m``, as numbers."""
    t = m.ScalingTable.parse(["1024,1,1.0", "1024,2,0.6", "1024,4,0.35", "2048,1,4.0",
                              "# a comment", "2048,4,1.25"])
    p = np.array([1, 2, 4, 8, 16])
    out = {"speedup": t.speedup(1024), "efficiency": t.efficiency(2048),
           "amdahl0": m.amdahl_bound(0.0, p).tolist(), "amdahl1": m.amdahl_bound(1.0, p).tolist(),
           "gustafson": m.gustafson_bound(0.0, p).tolist(),
           "alphas": [m.REFERENCE_ALPHAS[n] for n in sorted(m.REFERENCE_ALPHAS)],
           "weak": m.weak_efficiency([(1, 1.0), (4, 1.25), (16, 2.0)]),
           "ladders": m.group_ladders({1024: [(1, 1.0)], 2048: [(4, 1.3)]})}
    pp = np.array([2, 4, 8, 16, 32])
    out["fit_alpha"] = m.fit_alpha(list(zip(pp.tolist(), m.amdahl_bound(0.05, pp).tolist())))
    model = m.reference_comm_model()
    by_n, iters = {}, {}
    for n in (4096, 16384, 65536):
        by_n[n] = [(q, float(model.iter_time(q, n, t1=1e-10 * n * n, alpha=2e-5, beta=3e-10))
                    * 200) for q in (1, 2, 4, 8, 16, 32)]
        iters[n] = 200
    fit = m.fit_comm_model_joint(by_n, iters, model)
    out["joint_fit"] = fit
    out["single_fit"] = m.fit_comm_model(by_n[16384], 16384, 200, model)
    out["predict"] = m.predict_scaling(model, 16384, [8], {"t1": fit["t1:16384"],
                                                           "alpha": fit["alpha"],
                                                           "beta": fit["beta"]}, iters=200)
    out["crossover"] = m.strategy_crossover(n=1_000_000, bandwidth=1000,
                                            params={"t1": 1e-3, "alpha": 1e-6, "beta": 1e-11})
    w, s, n = 1000, 8, 1_000_000
    for name, kw in (("hi_lat", dict(t1=1e-3, alpha=5e-6, beta=1e-10)),
                     ("no_lat", dict(t1=1e-3, alpha=0.0, beta=1e-8))):
        out[name] = [float(mod.iter_time(64, n=n, **kw)) for mod in (
            m.sstep_comm_model(w, s), m.sstep_deephalo_comm_model(w, s),
            m.pipelined_comm_model(w), m.gvpipe_comm_model(w), m.halo_comm_model(w))]
    return out


def test_analysis_cases():
    out = _analysis_values(analysis)
    sp = dict(out["speedup"])
    assert sp[1] == 1.0 and abs(sp[4] - 1.0 / 0.35) < 1e-12
    assert abs(dict(out["efficiency"])[4] - (4.0 / 1.25) / 4) < 1e-12
    np.testing.assert_allclose(out["amdahl0"], [1, 2, 4, 8, 16])
    np.testing.assert_allclose(out["amdahl1"], np.ones(5))
    np.testing.assert_allclose(out["gustafson"], np.ones(5))
    alphas = out["alphas"]
    assert all(a2 <= a1 + 1e-12 for a1, a2 in zip(alphas, alphas[1:]))
    assert abs(out["fit_alpha"] - 0.05) < 1e-9
    assert dict(out["weak"]) == {1: 1.0, 4: 0.8, 16: 0.5}
    fit = out["joint_fit"]
    assert abs(fit["alpha"] - 2e-5) / 2e-5 < 1e-6 and abs(fit["beta"] - 3e-10) / 3e-10 < 1e-6
    for n in (4096, 16384, 65536):
        assert abs(fit[f"t1:{n}"] - 1e-10 * n * n) / (1e-10 * n * n) < 1e-6
    cross = out["crossover"]
    assert {"sstep", "sstep_deephalo"} <= set(cross)
    ag, halo, pipe = (dict(cross[k]) for k in ("allgather", "halo", "pipelined"))
    for p in (8, 32, 64):
        assert halo[p] < ag[p] and pipe[p] <= halo[p] + 1e-15
    t_ss, t_dh, t_pp = out["hi_lat"][:3]
    assert t_dh < t_ss and t_dh < t_pp
    assert out["no_lat"][1] > out["no_lat"][0]


def test_analysis_outputs_equal_cgx():
    assert _analysis_values(analysis) == _analysis_values(_bench("cgx", "analysis"))


def _report(main, strong, weak, out_dir) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([str(strong), str(weak), str(out_dir)]) == 0
    return buf.getvalue()


def test_report_equals_cgx(tmp_path):
    """python -m cgx_torch.bench.report strong.txt weak.txt out/ prints
    cgx's tables; the figures come where matplotlib is (here), and
    make_plots returns [] where it is not (the card's machine)."""
    from cgx.bench import report as cgx_report

    strong = tmp_path / "strong.txt"
    strong.write_text("1024,1,1.0\n1024,2,0.6\n1024,4,0.4\n2048,1,4.0\n2048,2,2.1\n")
    weak = tmp_path / "weak.txt"
    weak.write_text("1024,1,1.0\n2048,4,1.3\n4096,16,1.9\n")
    ours = _report(port_report.main, strong, weak, tmp_path / "ours")
    theirs = _report(cgx_report.main, strong, weak, tmp_path / "theirs")
    assert ours.replace(str(tmp_path / "ours"), "OUT") == \
        theirs.replace(str(tmp_path / "theirs"), "OUT")
    assert "alpha=" in ours and "N0=  1024" in ours
    written = sorted(os.listdir(tmp_path / "ours"))
    if importlib.util.find_spec("matplotlib") is not None:
        assert written == ["strong_scaling.png", "weak_scaling.png"]
    else:
        assert written == []
    assert port_report.main([]) == 1


def test_make_plots_without_matplotlib(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert analysis.make_plots(tmp_path / "s", tmp_path / "w", tmp_path / "o") == []


# ---------------------------------------------------------------------------
# The sweeps, on the CPU and on a two-rank gloo world
# ---------------------------------------------------------------------------


def test_sweeps_on_one_rank(tmp_path):
    out = tmp_path / "strong.txt"
    rows = sweeps.strong_scaling(sizes=(128,), out_file=out, fmt="dia", tol=1e-4, device="cpu")
    assert len(rows) == 1 and out.read_text().splitlines() == rows
    n, p, t = rows[0].split(",")
    assert n == "128" and p == "1" and float(t) > 0
    weak = sweeps.weak_scaling(base_sizes=(128,), device_counts=(1,), fmt="dia", maxiter=20,
                               device="cpu")
    assert len(weak) == 1 and weak[0].startswith("128,1,")
    tiles = tmp_path / "tiles.txt"
    rows = sweeps.kernel_sweep(n=256, threads=(64,), block_widths=(128,), out_file=tiles,
                               repeats=1, device="cpu")
    assert len(rows) == 1 and rows[0].startswith("64,128,") and float(rows[0].split(",")[2]) > 0
    with pytest.raises(ValueError, match="only 1 available"):
        sweeps.strong_scaling(sizes=(128,), device_counts=(2,), fmt="dia", device="cpu")


def case_sweeps():
    """Run on every rank of the world: the scaling sweeps over every mesh
    size up to the world's, and their rows."""
    d = os.environ["CGX_TORCH_TEST_SWEEP_DIR"]
    strong = sweeps.strong_scaling(sizes=(128,), out_file=os.path.join(d, "strong.txt"),
                                   fmt="dia", tol=1e-4, device="cpu")
    weak = sweeps.weak_scaling(base_sizes=(128,), out_file=os.path.join(d, "weak.txt"),
                               fmt="dia", maxiter=20, device="cpu")
    return {"strong": strong, "weak": weak}


def test_sweeps_on_a_two_rank_world(tmp_path, monkeypatch):
    """make_mesh(p) subgroups for p = 1, 2: rank 0 times both and alone
    writes the file; rank 1 only the mesh of 2. N(2) = 128 sqrt(2) = 181."""
    monkeypatch.setenv("CGX_TORCH_TEST_SWEEP_DIR", str(tmp_path))
    ranks = run_world(str(tmp_path / "world"), 2, __name__, ["case_sweeps"])
    r0, r1 = ranks[0]["case_sweeps"], ranks[1]["case_sweeps"]
    assert [row.rsplit(",", 1)[0] for row in r0["strong"]] == ["128,1", "128,2"]
    assert [row.rsplit(",", 1)[0] for row in r1["strong"]] == ["128,2"]
    assert [row.rsplit(",", 1)[0] for row in r0["weak"]] == ["128,1", "181,2"]
    assert all(float(row.split(",")[2]) > 0 for row in r0["strong"] + r0["weak"])
    assert (tmp_path / "strong.txt").read_text().splitlines() == r0["strong"]
    assert (tmp_path / "weak.txt").read_text().splitlines() == r0["weak"]
    table = analysis.ScalingTable.read(tmp_path / "strong.txt")
    assert [p for p, _ in table.speedup(128)] == [1, 2]


def test_bench_exports_equal_cgx():
    import cgx.bench as cgx_bench

    import cgx_torch.bench as port_bench

    names = {n for n in dir(cgx_bench) if not n.startswith("_")}
    assert names <= set(dir(port_bench)), names - set(dir(port_bench))
