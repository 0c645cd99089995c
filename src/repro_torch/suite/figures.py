"""One benchmark per paper table/figure, the counterpart of the
reference's ``benchmarks/figures.py``.  Each function returns a list of
CSV rows (dicts) and is invoked by :mod:`repro_torch.suite.run`.

fig3  — R_ins_reduction + speedup across the suite (paper Fig. 3a/3b)
fig4  — 1-thread vs 72-thread (socket) scaling of both metrics (Fig. 4)
fig5  — QC-simulator speedup vs thread count (Fig. 5)
fig6  — synthetic SpMV: speedup vs arithmetic intensity x ELEN (Fig. 6)
fig7  — adapted-roofline placement of every app (Fig. 7)
table3 — decision-tree classification of 26 cases vs the paper (Table 3)
sweep — every registered workload through the one-call pipeline

The timed benchmarks (:data:`TIMED`: Fig. 3's best-of per app, Fig. 6's
fp32 SpMV) take ``device`` and name their time column after it
(``wall_s_cpu`` or ``wall_s_cuda``).  The reference's ``dryrun_roofline``
reads the TPU dry-run's artifacts, which the port does not have yet
(ROADMAP 1.19); ``ALL`` leaves it out.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

from repro_torch.core import hw, metrics
from repro_torch.core.decision_tree import classify
from repro_torch.core.device import resolve_device
from repro_torch.core.profiler import block_until_ready
from repro_torch.core.roofline import adapted_roofline
from repro_torch.suite import apps as apps_mod


def _bw_at_threads(t: int) -> float:
    """Grace STREAM bandwidth saturation: 30 GB/s @1T -> 250 GB/s plateau
    (paper Sec. 3; Fig. 5 shows saturation around 8 threads)."""
    return min(30e9 * t, 250e9)


def _chip_at_threads(t: int) -> hw.ChipSpec:
    return dataclasses.replace(
        hw.GRACE_CORE,
        name=f"grace-{t}t",
        peak_flops={k: v * t for k, v in hw.GRACE_CORE.peak_flops.items()},
        hbm_bw=_bw_at_threads(t),
    )


def _wall_key(device: Any) -> str:
    return f"wall_s_{resolve_device(device).type}"


# ---------------------------------------------------------------------------


def fig3_vectorization(device: Any = "cuda") -> List[Dict]:
    """R_ins (issue model) + predicted & measured speedup per app, each app
    timed on ``device``."""
    rows = []
    key = _wall_key(device)
    for app in apps_mod.suite().values():
        rep = app.report(hw.GRACE_CORE)
        rl = adapted_roofline(hw.GRACE_CORE, app.dtype)
        wall = apps_mod.measure(app, device=device)
        rows.append({
            "app": app.name,
            "dtype": app.dtype,
            "problem": app.problem,
            "vb": rl.vb,
            "r_ins": round(rep.r_ins, 3),
            "ai": f"{rep.ai:.4g}",
            "speedup_predicted": round(rl.predicted_speedup(rep.ai), 3),
            key: f"{wall:.5f}",
            "vectorizable_fraction": app.vectorizable_fraction,
        })
    return rows


def fig4_thread_scaling() -> List[Dict]:
    """1-thread vs 72-thread: R_ins collapse for runtime-heavy apps, and the
    memory-bound flip for QC/STREAM (paper Fig. 4)."""
    # apps whose 72T instruction stream is dominated by threading runtime
    runtime_heavy = {"YOLOv3": 0.45, "AlexNet": 0.45,
                     "LLM-training": 0.5, "LLM-inference": 0.5}
    rows = []
    for app in apps_mod.suite().values():
        for threads in (1, 72):
            chip = _chip_at_threads(threads)
            vf = app.vectorizable_fraction
            if threads == 72 and app.name in runtime_heavy:
                vf = runtime_heavy[app.name]  # OpenMP runtime instructions
            vb = metrics.vectorization_bound(chip, app.dtype)
            r_ins = metrics.amdahl_r_ins(vb, vf)
            rl = adapted_roofline(chip, app.dtype)
            rows.append({
                "app": app.name, "threads": threads,
                "r_ins": round(r_ins, 3),
                "speedup_predicted": round(rl.predicted_speedup(app.ai), 3),
                "region": rl.region(app.ai),
            })
    return rows


def fig5_qc_sensitivity() -> List[Dict]:
    """QC speedup vs thread count: collapses as bandwidth saturates ~8T."""
    app = apps_mod.suite()["QC-simulator"]
    rows = []
    for threads in (1, 2, 4, 8, 16, 32, 72):
        rl = adapted_roofline(_chip_at_threads(threads), app.dtype)
        rows.append({
            "threads": threads,
            "ai": f"{app.ai:.4g}",
            "speedup_predicted": round(rl.predicted_speedup(app.ai), 3),
            "bw_gbs": _bw_at_threads(threads) / 1e9,
            "region": rl.region(app.ai),
        })
    return rows


def fig6_synthetic_spmv(device: Any = "cuda") -> List[Dict]:
    """The synthetic benchmark: speedup vs repeat-K intensity, per ELEN.
    Reproduces: saturation at VB (2x fp64 / 4x fp32), and ~no speedup at
    K=1 (memory-bound).  Wall time measured on ``device`` for the fp32
    variant (the mean of 3 calls after a warm one)."""
    from repro_torch.kernels.spmv import ops as spmv_ops, ref as spmv_ref

    dev = resolve_device(device)
    key = _wall_key(dev)
    vals, cols, nnz, x = (t.to(dev) for t in apps_mod.spmv_problem(1024))
    nnz_np = nnz.cpu().numpy()
    rows = []
    for dtype, dbytes in (("fp64", 8), ("fp32", 4), ("fp16", 2)):
        rl = adapted_roofline(hw.GRACE_CORE, dtype)
        for repeat in (1, 2, 5, 10, 20, 40):
            fb = spmv_ops.flops_bytes(nnz_np, repeat=repeat, dtype_bytes=dbytes)
            row = {
                "dtype": dtype, "repeat": repeat, "ai": f"{fb['ai']:.4g}",
                "vb": rl.vb,
                "speedup_predicted": round(rl.predicted_speedup(fb["ai"]), 3),
            }
            if dtype == "fp32":
                def fn(r=repeat):
                    return spmv_ref.spmv_ref(vals, cols, nnz, x, repeat=r)

                block_until_ready(fn())
                t0 = time.perf_counter()
                for _ in range(3):
                    block_until_ready(fn())
                row[key] = f"{(time.perf_counter() - t0) / 3:.5f}"
            rows.append(row)
    return rows


def fig7_roofline() -> List[Dict]:
    """Adapted-roofline placement (paper Fig. 7): each app's AI vs the
    scalar/vector knees; flags the compute->memory flip (red triangles)."""
    rows = []
    for app in apps_mod.suite().values():
        rl = adapted_roofline(hw.GRACE_CORE, app.dtype)
        scalar_region = rl.region(app.ai, vectorized=False)
        vector_region = rl.region(app.ai, vectorized=True)
        rows.append({
            "app": app.name, "dtype": app.dtype, "ai": f"{app.ai:.4g}",
            "ai_irr": f"{rl.ai_irr:.4g}", "ai_irv": f"{rl.ai_irv:.4g}",
            "scalar_region": scalar_region,
            "vector_region": vector_region,
            "flips_to_memory_bound": scalar_region == "compute-bound"
            and vector_region == "memory-bound",
        })
    return rows


# paper Table 3 ground truth (SN, app) -> (class@1T, class@72T)
_TABLE3_PAPER = {
    "YOLOv3": (4, 4), "LLM-training": (4, 4), "LLM-inference": (4, 4),
    "QC-simulator": (4, 2), "FFT1D": (1, 1), "FFT2D": (1, 1),
    "STREAM": (2, 2), "DGEMM": (4, 4), "SGEMM": (4, 4), "SpMV": (3, 3),
    "Jacobi2D": (2, 1), "AlexNet": (4, 4), "AutoDock": (4, 4),
}

_RUNTIME_HEAVY_72T = {"Jacobi2D": 0.15, "YOLOv3": 0.45, "AlexNet": 0.45,
                      "LLM-training": 0.5, "LLM-inference": 0.5}


def table3_decision_tree() -> List[Dict]:
    rows = []
    agree = 0
    for app in apps_mod.suite().values():
        expected = _TABLE3_PAPER.get(app.name)
        got = []
        for threads in (1, 72):
            chip = _chip_at_threads(threads)
            rep = app.report(chip)
            if threads == 72 and app.name in _RUNTIME_HEAVY_72T:
                vb = metrics.vectorization_bound(chip, app.dtype)
                r = metrics.amdahl_r_ins(vb, _RUNTIME_HEAVY_72T[app.name])
                rep = dataclasses.replace(
                    rep, ins_vec=rep.ins_scalar / r,
                    vectorizable_fraction=_RUNTIME_HEAVY_72T[app.name],
                )
            got.append(int(classify(rep, chip).perf_class))
        match = expected is not None and tuple(got) == expected
        agree += int(match)
        rows.append({
            "app": app.name,
            "class_1t": got[0], "class_72t": got[1],
            "paper_1t": expected[0] if expected else "",
            "paper_72t": expected[1] if expected else "",
            "match": match,
        })
    rows.append({"app": f"AGREEMENT {agree}/{len(_TABLE3_PAPER)}",
                 "class_1t": "", "class_72t": "", "paper_1t": "",
                 "paper_72t": "", "match": ""})
    return rows


def sve_analysis_sweep() -> List[Dict]:
    """Every registered workload (7 kernels + 13 apps) through the one-call
    pipeline on the Grace core, TPU and H100 models — the unified-API view
    of Table 3/Fig. 7."""
    from repro_torch.analysis import analyze_sweep

    return [r.row() for r in analyze_sweep(
        chips=(hw.GRACE_CORE, hw.TPU_V5E, hw.H100))]


ALL = {
    "fig3_vectorization": fig3_vectorization,
    "fig4_thread_scaling": fig4_thread_scaling,
    "fig5_qc_sensitivity": fig5_qc_sensitivity,
    "fig6_synthetic_spmv": fig6_synthetic_spmv,
    "fig7_roofline": fig7_roofline,
    "table3_decision_tree": table3_decision_tree,
    "sve_analysis_sweep": sve_analysis_sweep,
}

#: the benchmarks that time on a device (they take ``device=``)
TIMED = ("fig3_vectorization", "fig6_synthetic_spmv")
