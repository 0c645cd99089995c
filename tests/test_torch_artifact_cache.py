"""The port's artifact cache and the ``Events`` half of its store
(``analysis/store.py``, ``analysis/pipeline.py::ArtifactCache``) and the
analysis service over them, mirroring ``tests/test_artifact_store.py``,
``tests/test_analysis_api.py:110-192`` and
``tests/test_analysis_service.py:55-70``.

Fingerprints are stable for identical workloads, in a second process too,
and change with each input that changes a recording; corrupt store files
are dropped and recorded again; ``analyze_sweep(jobs>1)`` records once per
unique workload and matches the serial sweep; a second process over the
same store records nothing.  Each package's store reads the ``Events``
payloads the other's wrote, while their fingerprints never coincide.
"""

import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import ArtifactStore as RefStore  # noqa: E402
from repro.analysis import Workload as RefWorkload  # noqa: E402
from repro.analysis import workload_fingerprint as ref_fingerprint  # noqa: E402
from repro.core.counters import Events as RefEvents  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    ArtifactCache, ArtifactStore, Workload, analyze, analyze_sweep,
    workload_fingerprint,
)
from repro_torch.analysis.store import fn_token  # noqa: E402
from repro_torch.core import hw  # noqa: E402
from repro_torch.core.counters import Events, events_from_analytic  # noqa: E402
from repro_torch.core.decision_tree import PerfClass  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.serve.analysis_service import AnalysisService, main  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mm_workload(shape=(64, 64), dtype=torch.float32, name="store-mm"):
    a = torch.ones(shape, dtype=dtype)
    return Workload(name=name, fn=lambda x: x @ x, args=(a,), dtype="fp32")


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def test_fingerprint_stable_for_identical_workloads():
    assert workload_fingerprint(_mm_workload()) == \
        workload_fingerprint(_mm_workload())


def test_fingerprint_changes_with_shape_dtype_body_and_defaults():
    base = workload_fingerprint(_mm_workload())
    assert workload_fingerprint(_mm_workload(shape=(32, 64))) != base
    assert workload_fingerprint(_mm_workload(dtype=torch.bfloat16)) != base
    a = torch.ones((64, 64))
    assert workload_fingerprint(
        Workload(name="store-mm", fn=lambda x: x + x, args=(a,))) != base
    d1 = Workload(name="store-mm", fn=lambda x, k=1.0: x * k, args=(a,))
    d2 = Workload(name="store-mm", fn=lambda x, k=2.0: x * k, args=(a,))
    assert workload_fingerprint(d1) != workload_fingerprint(d2)


def test_fingerprint_sees_captured_tensor_shape_and_dtype():
    a = torch.ones(16)

    def make(w):
        return Workload(name="cap", fn=lambda x: x + w.sum(), args=(a,))

    base = workload_fingerprint(make(torch.zeros(2000)))
    assert workload_fingerprint(make(torch.zeros(4000))) != base
    assert workload_fingerprint(make(torch.zeros(2000, dtype=torch.bfloat16))) != base
    assert workload_fingerprint(make(torch.zeros(2000))) == base


def test_fingerprint_of_partial_bound_callables_and_tensors():
    a = torch.ones(16)

    def step(op, x):
        return op(x)

    def double(x):
        return x * 2

    def triple(x):
        return x * 3

    def fp(fn):
        return workload_fingerprint(Workload(name="part", fn=fn, args=(a,)))

    assert fp(functools.partial(step, double)) != \
        fp(functools.partial(step, triple))
    assert fp(functools.partial(step, double)) == \
        fp(functools.partial(step, double))

    def scale(w, x):
        return x * w.sum()

    assert fp(functools.partial(scale, torch.zeros(2000))) != \
        fp(functools.partial(scale, torch.zeros(4000)))


def test_fn_token_sees_through_kernel_ops():
    """``KernelOps`` carries its wrapper as ``__wrapped__``
    (``functools.update_wrapper``): the token is the wrapper's bytecode."""
    assert fn_token(registry.GEMM) == fn_token(registry.GEMM.raw)
    assert fn_token(registry.GEMM) != fn_token(registry.STREAM_TRIAD)


def test_fingerprint_differs_from_the_reference_for_the_same_workload():
    a = np.ones((64, 64), np.float32)
    port = Workload(name="store-mm", fn=lambda x: x @ x,
                    args=(torch.from_numpy(a),))
    ref = RefWorkload(name="store-mm", fn=lambda x: x @ x,
                      args=(jnp.asarray(a),))
    assert workload_fingerprint(port) != ref_fingerprint(ref)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def test_events_json_round_trip():
    ev = events_from_analytic(flops=1e9, hbm_bytes=1e6, gather_bytes=3e4,
                              collective_bytes=2e5, n_devices=4)
    ev.nonvec_flops = 1e8
    ev.census = {"dot": 3}
    ev.unknown_trip_counts = 1
    back = Events.from_dict(json.loads(json.dumps(ev.to_dict())))
    assert back.to_dict() == ev.to_dict()
    assert back.vectorizable_fraction == ev.vectorizable_fraction


def test_store_put_get_and_stats(tmp_path):
    store = ArtifactStore(str(tmp_path))
    ev = events_from_analytic(flops=2.0, hbm_bytes=4.0)
    assert store.get("feedface") is None and store.misses == 1
    path = store.put("feedface", ev, workload="w")
    assert os.path.exists(path)
    got = store.get("feedface")
    assert got is not None and got.flops == 2.0
    assert store.hits == 1 and store.puts == 1
    assert store.entries() == {"feedface": "w"}
    assert store.clear() == 1


@pytest.mark.parametrize("garbage", ["{not json", '{"version": 99}', "",
                                     '{"version": 1, "events": 3}'])
def test_corrupt_store_file_is_dropped_and_recorded_again(tmp_path, garbage):
    store = ArtifactStore(str(tmp_path))
    wl = _mm_workload()
    with open(store.path_for(workload_fingerprint(wl)), "w") as f:
        f.write(garbage)
    cache = ArtifactCache(store=store)
    result = analyze(wl, hw.GRACE_CORE, cache=cache)
    assert result.events.flops >= 2 * 64**3
    assert cache.compiles == 1 and store.dropped_corrupt == 1
    fresh = ArtifactCache(store=ArtifactStore(str(tmp_path)))
    analyze(_mm_workload(), hw.GRACE_CORE, cache=fresh)
    assert fresh.compiles == 0 and fresh.store_hits == 1


def test_cache_accepts_a_directory_string_as_store(tmp_path):
    first = ArtifactCache(store=str(tmp_path))
    analyze(_mm_workload(), hw.GRACE_CORE, cache=first)
    assert first.compiles == 1 and len(first.store.entries()) == 1
    again = ArtifactCache(store=str(tmp_path))
    analyze(_mm_workload(), hw.GRACE_CORE, cache=again)
    assert again.compiles == 0 and again.store_hits == 1
    assert analyze(_mm_workload(), store=str(tmp_path)).source == "compiled"


def test_store_hit_returns_the_recorded_events(tmp_path):
    store = ArtifactStore(str(tmp_path))
    first = ArtifactCache(store=store)
    r1 = analyze(_mm_workload(), hw.GRACE_CORE, cache=first)
    second = ArtifactCache(store=store)
    r2 = analyze(_mm_workload(), hw.GRACE_CORE, cache=second)
    assert second.compiles == 0 and second.store_hits == 1
    assert r2.to_dict() == r1.to_dict()
    assert first.record_s > 0.0 and second.record_s == 0.0


def test_each_store_reads_the_others_events(tmp_path):
    """Same layout and stamps: the reference's ``Events`` payloads list and
    load in the port's store, and the port's in the reference's."""
    ref_ev = RefEvents(flops=3e9, bytes_accessed=2e6, mxu_flops=2e9,
                       census={"dot": 2}, while_trip_counts=[8])
    RefStore(str(tmp_path)).put("ab" * 16, ref_ev, workload="ref")
    port = ArtifactStore(str(tmp_path))
    ((fp, payload),) = list(port.iter_json())
    assert fp == "ab" * 16 and payload["workload"] == "ref"
    assert Events.from_dict(payload["events"]).to_dict() == ref_ev.to_dict()
    assert port.get("ab" * 16).to_dict() == ref_ev.to_dict()
    rec = analyze(_mm_workload(), cache=ArtifactCache(store=port)).events
    (key,) = set(port.entries()) - {"ab" * 16}
    assert RefStore(str(tmp_path)).get(key).to_dict() == rec.to_dict()


# ---------------------------------------------------------------------------
# the cache and sweeps
# ---------------------------------------------------------------------------


def test_cache_keyed_by_content_not_object_identity():
    cache = ArtifactCache()
    analyze(_mm_workload(), hw.GRACE_CORE, cache=cache)
    analyze(_mm_workload(), hw.GRACE_CORE, cache=cache)
    assert cache.compiles == 1 and cache.hits == 1


def test_cache_distinguishes_same_named_workloads():
    a = torch.ones((32, 32))
    small = Workload(name="same-name", fn=lambda x: x + x, args=(a,))
    big = Workload(name="same-name", fn=lambda x: x @ x, args=(a,))
    cache = ArtifactCache()
    ev_small = analyze(small, cache=cache).events
    ev_big = analyze(big, cache=cache).events
    assert cache.compiles == 2
    assert ev_big.flops > ev_small.flops


def test_sweep_records_each_workload_once_and_analytic_never():
    a = torch.ones((64, 64))
    wls = [Workload(name="sweep-mm", fn=lambda x: x @ x, args=(a,)),
           Workload(name="sweep-add", fn=lambda x: x + x, args=(a,))]
    cache = ArtifactCache()
    results = analyze_sweep(wls, chips=(hw.GRACE_CORE, hw.GRACE_SOCKET,
                                        hw.TPU_V5E), cache=cache)
    assert len(results) == 6 and cache.compiles == 2 and cache.hits == 4
    analytic = ArtifactCache()
    results = analyze_sweep(["kernel/gemm", "kernel/stream-triad"],
                            chips=(hw.GRACE_CORE, hw.H100), cache=analytic)
    assert analytic.compiles == 0
    assert all(r.source == "analytic" for r in results)


def _parallel_workloads(n=3):
    a = torch.ones((48, 48))
    return [Workload(name=f"par-{i}", fn=lambda x, k=float(i): x @ x + k,
                     args=(a,)) for i in range(n)]


@pytest.mark.parametrize("with_store", [False, True])
def test_parallel_sweep_records_once_per_workload(tmp_path, with_store):
    """jobs=4 over 3 workloads x 2 chips: single-flight keeps recordings at
    3, with and without a store, and the results equal the serial sweep's."""
    wls = _parallel_workloads()
    chips = (hw.GRACE_CORE, hw.H100)
    cache = ArtifactCache(store=str(tmp_path) if with_store else None)
    parallel = analyze_sweep(wls, chips, source="compiled", cache=cache,
                             jobs=4)
    assert cache.compiles == len(wls)
    assert cache.compiles + cache.hits == 6
    if with_store:
        assert len(cache.store.entries()) == len(wls)
    serial = analyze_sweep(wls, chips, source="compiled",
                           cache=ArtifactCache())
    assert [r.to_dict() for r in parallel] == [r.to_dict() for r in serial]


def test_single_flight_under_thread_stress():
    """More threads than cores, a short switch interval: every unique
    workload is recorded exactly once, every other cell is a hit, and the
    results equal the serial sweep's (a lost update would break the
    counts)."""
    wls = _parallel_workloads(4)
    chips = (hw.GRACE_CORE, hw.GRACE_SOCKET, hw.TPU_V5E, hw.TPU_V5P, hw.H100)
    dtypes = ("fp32", "bf16")
    cache = ArtifactCache()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = analyze_sweep(wls, chips, dtypes=dtypes, source="compiled",
                                cache=cache, jobs=4 * (os.cpu_count() or 4))
    finally:
        sys.setswitchinterval(interval)
    assert cache.compiles == len(wls)
    assert cache.compiles + cache.hits == len(results) == 40
    serial = analyze_sweep(wls, chips, dtypes=dtypes, source="compiled",
                           cache=ArtifactCache())
    assert [r.to_dict() for r in results] == [r.to_dict() for r in serial]


_SECOND_PROCESS = """
import json, sys
import torch
from repro_torch.analysis import (ArtifactCache, Workload, analyze_sweep,
                                  workload_fingerprint)
from repro_torch.core import hw
a = torch.ones((64, 64), dtype=torch.float32)
wl = Workload(name="store-mm", fn=lambda x: x @ x, args=(a,), dtype="fp32")
cache = ArtifactCache(store=sys.argv[1])
results = analyze_sweep(["kernel/gemm", "kernel/stream-triad"],
                        chips=(hw.GRACE_CORE, hw.H100), source="compiled",
                        cache=cache)
print(json.dumps({"fingerprint": workload_fingerprint(wl),
                  "compiles": cache.compiles, "store_hits": cache.store_hits,
                  "results": [r.to_dict() for r in results]}))
"""


def test_second_process_records_nothing_and_fingerprints_agree(tmp_path):
    """The headline acceptance: a fresh process over the kernel workloads
    gets every event from the store, with the same fingerprints and
    results."""
    cache = ArtifactCache(store=str(tmp_path))
    first = analyze_sweep(["kernel/gemm", "kernel/stream-triad"],
                          chips=(hw.GRACE_CORE, hw.H100), source="compiled",
                          cache=cache)
    assert cache.compiles == 2 and cache.store_hits == 0
    proc = subprocess.run(
        [sys.executable, "-c", _SECOND_PROCESS, str(tmp_path)],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO_ROOT, "src")})
    assert proc.returncode == 0, proc.stderr
    second = json.loads(proc.stdout.strip().splitlines()[-1])
    assert second["fingerprint"] == workload_fingerprint(_mm_workload())
    assert second["compiles"] == 0 and second["store_hits"] == 2
    assert second["results"] == [json.loads(r.to_json()) for r in first]


# ---------------------------------------------------------------------------
# the service and its CLI
# ---------------------------------------------------------------------------


def test_recording_failure_is_captured_not_fatal():
    """A workload that raises while it is recorded fails ITS request only."""

    def boom(x):
        raise RuntimeError("trace failure")

    svc = AnalysisService(cache=ArtifactCache(), device="cpu")
    bad = svc.submit(Workload(name="svc-bad", fn=boom,
                              args=(torch.ones((8, 8)),)), source="compiled")
    ok = svc.submit("kernel/gemm")
    svc.run_until_drained()
    assert bad.done and "trace failure" in bad.error and bad.results == []
    assert ok.error is None and ok.results[0].perf_class == PerfClass.SPEEDUP
    report = svc.report()["service"]
    assert report["errors"] == 1 and report["compiles"] == 1


def test_same_workload_across_requests_records_once():
    wl = Workload(name="svc-shared", fn=lambda x: x @ x,
                  args=(torch.ones((48, 48)),))
    cache = ArtifactCache()
    svc = AnalysisService(max_batch=8, jobs=4, cache=cache, device="cpu")
    for chips in (("grace-core",), ("tpu-v5e",), ("h100",)):
        svc.submit(wl, chips=chips, source="compiled")
    svc.run_until_drained()
    assert cache.compiles == 1
    assert all(len(r.results) == 1 for r in svc.completed.values())
    assert svc.report()["service"]["cache_hits"] == 2


def test_cli_store_dir_twice_records_nothing_the_second_time(
        tmp_path, capsys):
    store = str(tmp_path / "store")
    names = ["kernel/gemm", "kernel/spmv", "kernel/qc-gate"]
    reports = []
    for _ in range(2):
        out = tmp_path / "r.json"
        assert main(["--device", "cpu", "--source", "compiled",
                     "--store-dir", store, "--workloads", *names,
                     "--chips", "grace-core", "h100",
                     "--out", str(out)]) == 0
        reports.append(json.loads(out.read_text()))
    first, second = (r["service"] for r in reports)
    assert (first["compiles"], first["store_hits"]) == (3, 0)
    assert (second["compiles"], second["store_hits"]) == (0, 3)
    assert first["cells"] == second["cells"] == 6
    assert "0 compiles, 3 store hits" in capsys.readouterr().err
    strip = [[{k: v for k, v in res.items() if k != "wall_s"}
              for req in r["requests"] for res in req["results"]]
             for r in reports]
    assert strip[0] == strip[1]
    assert len(ArtifactStore(store).entries()) == 3


def test_cli_no_store_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path / "art"))
    out = tmp_path / "r.json"
    assert main(["--device", "cpu", "--source", "compiled", "--no-store",
                 "--workloads", "kernel/jacobi2d", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["service"]["compiles"] == 1
    assert report["requests"][0]["results"][0]["source"] == "compiled"
    assert not (tmp_path / "art").exists()
