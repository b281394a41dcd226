"""The port's 2008 sweeps (``experiments/fuel2008_sweep.py``) and head-to-head
(``experiments/fuel_headtohead.py``) against the JAX system's repo-root
scripts ``run_fuel2008_sweep.py``, ``_sweep2.py``, ``_sweep3.py``,
``run_fuel2008_finish.py`` and ``run_fuel_headtohead.py``.

CPU, f64.  The sweeps' logic is held with ``fuel_reconstruction`` stubbed on
both sides by the same table of ``rel_norm``s (a function of the
configuration): the rows, their order, names and configurations, the best
rows and the reports must come out equal, the JAX scripts run by their own
``main`` in a temporary directory (``monkeypatch.chdir``), never in
``results/``.  One row runs unstubbed at a tiny protocol on the same rays.
The north star's numbers come from the JAX record's report, read at run
time, and equal the literals the JAX scripts write.
"""

import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adjointnonlinearraytracing_tpu.tracer as JT
from adjointnonlinearraytracing_tpu.experiments import voxel_scenes as JV
from adjointnonlinearraytracing_tpu.fields import grid as JG
from adjointnonlinearraytracing_tpu.pathmatrix import fuel2008 as JF
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch.experiments import fuel2008_sweep as TW
from adjointnonlinearraytracing_tpu_torch.experiments import fuel_headtohead as TH
from adjointnonlinearraytracing_tpu_torch.pathmatrix import fuel2008 as TF

ROOT = Path(__file__).resolve().parent.parent
NS_RECORD = str(ROOT / "results" / "fuel_northstar" / "report.json")
RECORD_ROWS = ROOT / "results" / "fuel2008_sweep" / "sweep.jsonl"
TINY = dict(nviews=4, nbins=8, spp=2, int_res=64, recon_res=8, seed=0)
# the table both sides' stub reads: a rel_norm a configuration, no two equal
GRID = {16: 0.8643, 32: 1.4834, 48: 1.7140}
SPLINE = {"hermite": -0.0065, "true": 0.1941}
DAMP = {0.0: 0.0, 1e-7: 2e-4, 1e-6: 1e-4, 1e-5: 3e-4, 1e-4: -1e-3, 1e-3: 4e-4, 1e-2: 0.6256,
        1e-1: 0.9, 1.0: 1.2}


def fake_rel_norm(cfg):
    return (GRID.get(cfg.get("recon_res"), 3.9036) + SPLINE.get(cfg.get("spline"), 0.0)
            + DAMP[cfg.get("damp", 0.0)] + 0.05 * (cfg.get("angle_span") == 180)
            + {1e-5: 2e-3, 1e-3: -5e-4}.get(cfg.get("damp_int"), 0.0)
            + 0.01 * (cfg.get("int_res") == 175) - 3e-3 * (cfg["spp"] == 16))


def fake_reconstruction(gt, cfg, **kwargs):
    rel = fake_rel_norm(cfg)
    n = cfg["nviews"] * cfg["nbins"] ** 2 * cfg["spp"]
    return np.zeros((2, 2, 2)), dict(
        rel_err_norm=rel, max_err=rel / 1e4, l1_err=rel / 1e5, num_rays=n, solve_time=1.25,
        trace_time=0.5, phi_time=0.25, integration_time=0.125, total_time=2.0, phi_nnz=7 * n,
        process_peak_rss_mb=1.0, rss_mb=1.0)


def _timeless(rows):
    return [{k: v for k, v in r.items() if k != "total_s"} for r in rows]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture
def scripts(monkeypatch, tmp_path):
    """The four JAX sweep scripts, importable, run in ``tmp_path/jax`` with the
    stub; the port's stub too."""
    monkeypatch.syspath_prepend(str(ROOT))
    for name in ("run_fuel2008_sweep", "run_fuel2008_sweep2", "run_fuel2008_sweep3",
                 "run_fuel2008_finish"):
        sys.modules.pop(name, None)
    import run_fuel2008_finish
    import run_fuel2008_sweep
    import run_fuel2008_sweep2
    import run_fuel2008_sweep3
    monkeypatch.setattr(JF, "fuel_reconstruction", fake_reconstruction)
    monkeypatch.setattr(TF, "fuel_reconstruction", fake_reconstruction)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    yield dict(sweep=run_fuel2008_sweep, sweep2=run_fuel2008_sweep2,
               sweep3=run_fuel2008_sweep3, finish=run_fuel2008_finish)
    for name in ("run_fuel2008_sweep", "run_fuel2008_sweep2", "run_fuel2008_sweep3",
                 "run_fuel2008_finish"):
        sys.modules.pop(name, None)


def test_the_four_sweeps_match_the_jax_scripts(scripts, tmp_path):
    """Each sweep in turn, as the scripts chain them: the rows, the best rows,
    the reports and the appended ``sweep.jsonl`` equal the scripts'; the north
    star's ``rel_norm`` read from the JAX record equals their literals."""
    out = str(tmp_path / "port")
    gt = torch.zeros((3, 3, 3), dtype=torch.float64)
    jdir = Path("results/fuel2008_sweep")
    for name in ("sweep", "sweep2", "sweep3", "finish"):
        scripts[name].main()
        kw = {} if name == "sweep2" else dict(northstar_report=NS_RECORD)
        got = getattr(TW, name)(gt, out_dir=out, device="cpu", **kw)
        want = json.load(open(jdir / ("report2.json" if name == "sweep2" else "report.json")))
        assert _timeless(got["rows"]) == _timeless(want["rows"]), name
        for key in ("best_screening", "best_full_protocol"):
            assert _timeless([got[key]]) == _timeless([want[key]]), (name, key)
        for key in set(want) - {"rows", "best_screening", "best_full_protocol",
                                "adjoint_rel_norm_for_reference", "purpose", "truncated"}:
            assert got[key] == want[key], (name, key)
        if "adjoint_rel_norm_for_reference" in want:
            ref = got["adjoint_rel_norm_for_reference"]
            for key, value in want["adjoint_rel_norm_for_reference"].items():
                assert ref[key] == (NS_RECORD if key == "source" else value), key
        assert got["device"] == "cpu" and got["card"] is None
        assert _timeless(_jsonl(Path(out) / "sweep.jsonl")) == _timeless(
            _jsonl(jdir / "sweep.jsonl")), name
    # the chain took the combinations and the winner the scripts take
    names = [r["name"] for r in _jsonl(Path(out) / "sweep.jsonl")]
    assert "recon16_damp1e-2" in names and "combo_recon16_hermite" in names
    assert names.count("BEST_full_protocol") == 3 and "BEST2_full_protocol" in names
    assert got["best_full_protocol"]["cfg"] == dict(TW.SCREEN, recon_res=16, spline="hermite",
                                                    spp=16)
    assert got["truncated"] == []  # sweep3 ran every lever before finish


def test_a_failed_row_is_written_and_fails_the_sweep(scripts, tmp_path, monkeypatch):
    """A configuration the pipeline refuses is a row with ``error`` on both
    sides; the JAX script sweeps on, the port too, then raises once its report
    is written.  An error of another kind (a CUDA fault) is raised at once."""
    def refusing(gt, cfg, **kwargs):
        if cfg.get("damp") == 1e-6:
            raise ValueError("LSQR refused the system")
        return fake_reconstruction(gt, cfg)

    monkeypatch.setattr(JF, "fuel_reconstruction", refusing)
    monkeypatch.setattr(TF, "fuel_reconstruction", refusing)
    scripts["sweep"].main()
    want = json.load(open("results/fuel2008_sweep/report.json"))
    out = tmp_path / "port"
    gt = torch.zeros((3, 3, 3), dtype=torch.float64)
    with pytest.raises(TW.SweepError, match="damp_1e-06"):
        TW.sweep(gt, out_dir=str(out), northstar_report=NS_RECORD, device="cpu")
    got = json.load(open(out / "report.json"))
    assert _timeless(got["rows"]) == _timeless(want["rows"])
    assert [r for r in got["rows"] if "error" in r][0]["error"] == \
        "ValueError('LSQR refused the system')"

    def faulting(gt, cfg, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(TF, "fuel_reconstruction", faulting)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        TW.sweep(gt, out_dir=str(out), northstar_report=NS_RECORD, device="cpu")
    assert len(_jsonl(out / "sweep.jsonl")) == 0  # raised at the first row


def test_sweeps_raise_where_a_report_is_missing(tmp_path):
    gt = torch.zeros((3, 3, 3), dtype=torch.float64)
    missing = str(tmp_path / "nowhere" / "report.json")
    for fn in (TW.sweep, TW.sweep3, TW.finish):
        with pytest.raises(FileNotFoundError, match="nowhere/report.json"):
            fn(gt, out_dir=str(tmp_path / "out"), northstar_report=missing, device="cpu")
    with pytest.raises(FileNotFoundError, match="run sweep first"):  # the script polls
        TW.sweep2(gt, out_dir=str(tmp_path / "out"), device="cpu")
    with pytest.raises(FileNotFoundError, match="sweep.jsonl is missing"):
        TW.finish(gt, out_dir=str(tmp_path / "empty"), northstar_report=NS_RECORD,
                  device="cpu")
    if not torch.cuda.is_available():  # the entry points need a GPU unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TW.sweep(gt, out_dir=str(tmp_path / "out"), northstar_report=NS_RECORD)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TH.run(gt, northstar_report=NS_RECORD, out_dir=None)


def test_defaults_and_row_keys_are_the_scripts(scripts):
    assert TW.SCREEN == dict(nviews=32, nbins=64, spp=4, int_res=256, seed=0)
    assert TW.protocol_text(TW.SCREEN) == "32 views x 64^2 x 4 spp (524k rays)"
    record = _jsonl(RECORD_ROWS)
    assert {tuple(r) for r in record} == {("name", "cfg", "rel_norm", "max_err", "l1_err",
                                            "rays", "solve_s", "total_s")}
    rows = []
    TW.run_cfg(torch.zeros((3, 3, 3)), "recon16", dict(TW.SCREEN, recon_res=16), rows, ".",
               device="cpu")
    assert list(rows[0]) == list(record[0])
    assert TW.OUT_DIR.endswith("_torch")
    assert TH.OUT_DIR.endswith("_torch") and TH.PROTOCOL == dict(nviews=32, nbins=64, spp=16,
                                                                 int_res=175, seed=0)


def test_one_row_unstubbed_matches_the_jax_script(monkeypatch, tmp_path):
    """``run_cfg`` with the real pipeline at a tiny protocol on a 17^3 volume,
    both sides on the port's draw (256 rays): the row's numbers within 1e-6 relative (the
    reconstruction itself is held at 1e-8 in test_torch_pathmatrix.py).  The
    whole row is the JAX script's; its one nonlinear trace and its error's
    field evaluation run jitted (op by op JAX compiles its stepper for 8-16 s
    here)."""
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("run_fuel2008_sweep", None)
    import run_fuel2008_sweep as JW
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(JW, "OUT_DIR", str(tmp_path))
    gt = JV.gaussian_bump(17, 1.0, amp=0.0005).astype(jnp.float64)
    rays = TF.gen_rays(TINY, device="cpu")
    monkeypatch.setattr(JS, "rand_rays_in_sphere", lambda *a, **k: (
        JS.Rays(*(jnp.asarray(t.numpy()) for t in rays)), None))
    monkeypatch.setattr(TF, "gen_rays", lambda p, dtype, device: rays)
    monkeypatch.setattr(JG, "eval_grad", jax.jit(JG.eval_grad))  # one program, not op by op
    monkeypatch.setattr(JF, "tracer",
                        SimpleNamespace(trace=jax.jit(JT.trace, static_argnums=(3, 4))))
    want, got = [], []
    JW.run_cfg(gt, "tiny", TINY, want)
    (tmp_path / "port").mkdir()
    TW.run_cfg(torch.from_numpy(np.asarray(gt)), "tiny", TINY, got, str(tmp_path / "port"),
               device="cpu")
    sys.modules.pop("run_fuel2008_sweep", None)
    (w,), (g,) = want, got
    assert "error" not in w and "error" not in g and g["rays"] == w["rays"] > 0
    for key in ("rel_norm", "max_err", "l1_err"):
        assert abs(g[key] - w[key]) <= 1e-6 * abs(w[key]), key


def _northstar_report(tmp_path, per_stage, final):
    path = tmp_path / "ns" / "report.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(dict(grid=f"{final}^3", reconstruction=dict(
        rel_norm=per_stage[final]), reconstruction_per_stage={str(k): v for k, v in
                                                              per_stage.items()})))
    return str(path)


def test_headtohead_matches_the_jax_script(monkeypatch, tmp_path):
    """``run_fuel_headtohead.main`` and the port's ``run`` with the stub on the
    JAX record's north-star report: the 2008 half equal, the north-star half
    read from the report, every ratio the script's (which rounds to 3
    places) under a name that gives both grids."""
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("run_fuel_headtohead", None)
    import run_fuel_headtohead as JH
    monkeypatch.setattr(JF, "fuel_reconstruction", fake_reconstruction)
    monkeypatch.setattr(TF, "fuel_reconstruction", fake_reconstruction)
    (tmp_path / "jax" / "results" / "fuel_northstar").mkdir(parents=True)
    (tmp_path / "jax" / "results" / "fuel_northstar" / "report.json").write_text(
        Path(NS_RECORD).read_text())
    monkeypatch.chdir(tmp_path / "jax")
    JH.main()
    sys.modules.pop("run_fuel_headtohead", None)
    want = json.load(open("results/fuel_headtohead/report.json"))
    gt = torch.zeros((65, 65, 65), dtype=torch.float64)
    recon, got = TH.run(gt, northstar_report=NS_RECORD, out_dir=str(tmp_path / "port"),
                        device="cpu")
    assert json.load(open(tmp_path / "port" / "report.json")) == got
    assert np.load(tmp_path / "port" / "recon_2008.npy").shape == recon.shape
    for key in ("rays", "rel_norm", "max_err", "l1_err", "phi_nnz", "trace_time_s", "phi_time_s",
                "solve_time_s", "integration_time_s", "total_time_s"):
        assert got["linear_2008"][key] == want["linear_2008"][key], key
    assert got["linear_2008"]["recon_res"] == 64
    adj = got["nonlinear_adjoint"]
    assert adj["rel_norm_129"] == want["nonlinear_adjoint"]["rel_norm_129"]
    assert adj["rel_norm_65"] == want["nonlinear_adjoint"]["rel_norm_65"]
    assert adj["source"] == NS_RECORD and adj["grid"] == 129
    adv = got["advantage"]
    assert set(adv) == {"adjoint_65_vs_2008_recon64", "adjoint_129_vs_2008_recon64"}
    assert round(adv["adjoint_65_vs_2008_recon64"], 3) == \
        want["advantage"]["adjoint_vs_2008_at_matched_res_65"]
    assert round(adv["adjoint_129_vs_2008_recon64"], 3) == \
        want["advantage"]["adjoint_vs_2008_at_129"]
    assert got["gt_volume"] == want["gt_volume"] and got["metric"] == want["metric"]


def test_headtohead_ratios_come_from_the_reports_given(monkeypatch, tmp_path):
    """The tuned baseline (a sweep's report) beside the untuned, each against
    the north star's last stage and its stage nearest the reconstruction's
    grid, with numbers of a report made here; a missing report raises."""
    monkeypatch.setattr(TF, "fuel_reconstruction", fake_reconstruction)
    ns = _northstar_report(tmp_path, {9: 3.0, 17: 0.5, 33: 0.4, 65: 0.25, 129: 0.2}, 129)
    sweep = tmp_path / "sweep.json"
    best = dict(name="BEST_full_protocol", cfg=dict(TW.SCREEN, recon_res=16, spp=16),
                rel_norm=0.75)
    sweep.write_text(json.dumps(dict(best_full_protocol=best, rows=[
        dict(name="recon16", cfg={}, rel_norm=0.8), dict(name="bad", cfg={}, error="x"), best])))
    gt = torch.zeros((65, 65, 65), dtype=torch.float64)
    _, got = TH.run(gt, protocol=dict(TH.PROTOCOL, recon_res=32), northstar_report=ns,
                    sweep_report=str(sweep), out_dir=None, device="cpu")
    lin = fake_rel_norm(dict(TH.PROTOCOL, recon_res=32))
    assert got["linear_2008"]["recon_res"] == 32
    assert got["linear_2008_tuned"]["lever_summary"] == {"recon16": 0.8,
                                                         "BEST_full_protocol": 0.75}
    assert got["advantage"] == {"adjoint_33_vs_2008_recon32": lin / 0.4,
                                "adjoint_129_vs_2008_recon32": lin / 0.2,
                                "adjoint_17_vs_2008_tuned_recon16": 0.75 / 0.5,
                                "adjoint_129_vs_2008_tuned_recon16": 0.75 / 0.2}
    assert not any("matched" in key for key in got["advantage"])
    with pytest.raises(FileNotFoundError, match="no north-star report at .*missing.json"):
        TH.run(gt, northstar_report=str(tmp_path / "missing.json"), out_dir=None, device="cpu")
    with pytest.raises(FileNotFoundError, match="no sweep report"):
        TH.run(gt, northstar_report=ns, sweep_report=str(tmp_path / "none.json"), out_dir=None,
               device="cpu")
    assert math.isfinite(got["advantage"]["adjoint_33_vs_2008_recon32"])
