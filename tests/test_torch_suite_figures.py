"""The port's figure/table benchmarks (``repro_torch.suite.figures``)
against the reference's (``benchmarks/figures.py``).

Fig. 4, Fig. 5, Fig. 7 and Table 3 are analytic: every row equals the
reference's, ``AGREEMENT n/13`` included.  Fig. 3 and Fig. 6 also time
the apps; with both packages' ``measure`` stubbed they equal the
reference's in every column but the time, which the port names after its
device (``wall_s_cpu`` here).  One test times one cheap app for real.  The
sweep's classes, VB, AI and R_ins equal the reference's on the reference's
two chip models, over a registry holding only the built-in providers.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import benchmarks.apps as ref_apps  # noqa: E402
import benchmarks.figures as ref_figures  # noqa: E402
from repro_torch.suite import apps, figures  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

ANALYTIC = ("fig4_thread_scaling", "fig5_qc_sensitivity", "fig7_roofline",
            "table3_decision_tree")


@pytest.fixture(scope="module", autouse=True)
def suites():
    return ref_apps.suite(), apps.suite()


@pytest.mark.parametrize("name", ANALYTIC)
def test_analytic_figures_equal_the_reference(name):
    got = figures.ALL[name]()
    want = ref_figures.ALL[name]()
    assert got == want
    if name == "table3_decision_tree":
        assert got[-1]["app"] == "AGREEMENT 13/13"


def test_benchmark_names_are_the_reference_but_the_dry_run():
    assert list(figures.ALL) == [n for n in ref_figures.ALL
                                 if n != "dryrun_roofline"]
    assert set(figures.TIMED) == {"fig3_vectorization",
                                  "fig6_synthetic_spmv"}


def test_fig3_equals_the_reference_but_the_time(monkeypatch):
    monkeypatch.setattr(ref_apps, "measure", lambda app, **kw: 0.0)
    monkeypatch.setattr(apps, "measure", lambda app, **kw: 0.0)
    got = figures.fig3_vectorization(device="cpu")
    want = ref_figures.fig3_vectorization()
    assert [list(r) for r in got] == [list(r) for r in want]  # wall_s_cpu
    assert got == want


def test_fig6_equals_the_reference_but_the_time():
    got = figures.fig6_synthetic_spmv(device="cpu")
    want = ref_figures.fig6_synthetic_spmv()
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r for r in got if "wall_s_cpu" in r] == \
        [r for r in got if r["dtype"] == "fp32"]
    for g, w in zip(got, want):
        assert float(g.pop("wall_s_cpu", 1.0)) > 0.0
        w.pop("wall_s_cpu", None)
        assert g == w


def test_measure_times_an_app_for_real():
    app = apps.suite()["FFT1D"]
    t = apps.measure(app, repeats=5, min_time_s=0.0, device="cpu")
    assert 0.0 < t < 1.0


@pytest.fixture()
def builtin_registries(monkeypatch):
    """Both registries emptied for the test, so discovery fills them with
    the kernels and the apps alone (other tests register their own)."""
    for name in ("repro.analysis.workload", "repro_torch.analysis.workload"):
        # the module, not the ``workload`` decorator its package exports
        mod = importlib.import_module(name)
        monkeypatch.setattr(mod, "_REGISTRY", {})
        monkeypatch.setattr(mod, "_LAZY", {})
        monkeypatch.setattr(mod, "_discovered", False)


def test_sweep_classes_equal_the_reference(builtin_registries):
    got = figures.sve_analysis_sweep()
    want = ref_figures.sve_analysis_sweep()
    assert {r["chip"] for r in got} == {"grace-core", "tpu-v5e", "h100"}
    keys = ("workload", "chip", "dtype", "vb", "r_ins", "ai", "knee",
            "bound", "class")
    mine = [{k: r[k] for k in keys} for r in got if r["chip"] != "h100"]
    assert mine == [{k: r[k] for k in keys} for r in want]
    assert len(got) == 3 * 20  # 7 kernels + 13 apps, on three chips
