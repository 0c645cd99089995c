"""The scenario matrix's later axes in the port's runner: prefix sharing,
speculation and the mesh, against the JAX runner and their twins.

Mirrors the sharing cells of ``tests/test_scenarios.py``, the speculate
cells of ``tests/test_speculative.py`` (without their perf-ledger lines,
which wait for ROADMAP item 1.15), and its mesh cells: a ``1x1`` cell and
a ``1x1`` device-loss cell, each equal to the JAX runner's and to its
unsharded twin, and a ``1x2`` cell over gloo equal to its unsharded twin.
A meshed cell runs inside spawned ranks (``launch/mesh.spawn``, at most
``runner.MESH_TIMEOUT_S`` = 120 s a spawn).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.scenarios import (  # noqa: E402
    ArrivalSpec,
    EosSpec,
    PromptSpec,
    runner,
)
import torch_threads  # noqa: E402
from torch_scenario_checks import (  # noqa: E402
    assert_like_jax,
    carry_jax_params,
    one_cell as _cell,
    run,
    tiny_matrix as _tiny_matrix,
)

torch_threads.use_threads(2)
carry_jax_params()


# ---------------------------------------------------------------------------
# prefix sharing (tests/test_scenarios.py)
# ---------------------------------------------------------------------------


def _shared(fault="none"):
    cell, = _tiny_matrix(faults=[fault], prompt_sharing=["shared"],
                         prompts=[PromptSpec(kind="uniform", lo=8,
                                             hi=14)]).cells()
    return cell


def test_shared_cell_matches_sharing_off_twin_with_fewer_blocks():
    """A shared-prefix cell runs against its sharing-off twin: identical
    streams (golden), strictly fewer physical blocks, dedup > 1, all as
    the JAX runner counts them."""
    r = assert_like_jax(_shared())
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["share_prefixes"] is True
    assert r.stats["shared_block_hits"] > 0
    assert r.stats["block_dedup_ratio"] > 1.0
    assert r.stats["physical_blocks"] < r.stats["logical_blocks"]
    assert r.report()["prompt_sharing"] == "shared"


def test_shared_preempt_cell_matches_both_twins():
    """Sharing + mid-flight preemption: the preempted COW cell must match
    its fault-free golden twin AND its sharing-off twin."""
    r = assert_like_jax(_shared("preempt"))
    assert r.stats["preemptions"] >= 1
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["block_dedup_ratio"] > 1.0


# ---------------------------------------------------------------------------
# the speculate axis (tests/test_speculative.py)
# ---------------------------------------------------------------------------


def _spec_cell(fault="none"):
    cell, = _tiny_matrix(faults=[fault], speculate=[4], max_len=64).cells()
    return cell


def test_spec_cell_matches_spec_off_twin():
    r = assert_like_jax(_spec_cell())
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["spec_k"] == 4
    assert r.stats["drafted_tokens"] > 0
    # the runner's self-draft: every proposal lands on the CPU (the
    # card's bf16 rounding may flip a near tie, so there it is below 1)
    assert r.stats["acceptance_rate"] == 1.0
    assert r.report()["spec_k"] == 4


def test_spec_cell_survives_preemption():
    """Preempting mid-speculation must rewind AND replay cleanly: the
    faulted spec cell still matches its fault-free golden twin and its
    spec-off twin."""
    r = assert_like_jax(_spec_cell("preempt"))
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["preemptions"] >= 1
    assert r.stats["drafted_tokens"] > 0


# ---------------------------------------------------------------------------
# the mesh axis: cells served by spawned ranks over gloo
# ---------------------------------------------------------------------------


def test_mesh_cell_matches_unsharded_twin():
    r = assert_like_jax(_cell(meshes=["1x1"]))
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["mesh"] == "1x1"
    assert r.stats["mesh_devices"] == 1
    assert r.stats["device_lane_utilization"] > 0
    assert r.report()["mesh"] == "1x1"


def test_mesh_device_loss_cell_restarts_resharded():
    """Device loss on a meshed cell: every rank runs the resilient loop
    over its own checkpoints, crashes at the same step and restores; the
    streams still match the fault-free unsharded twin."""
    r = assert_like_jax(_cell("device-loss", meshes=["1x1"]))
    assert r.restarts >= 1, "the simulated device loss must actually fire"
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["mesh"] == "1x1"
    assert r.stats["device_lane_utilization"] > 0


def test_two_rank_mesh_cell_matches_unsharded_twin():
    """1x2 over gloo: heads split over two ranks, the streams and exact
    stats those of the unsharded cell."""
    cell = _cell(meshes=["1x2"], arrivals=[ArrivalSpec(kind="bursty",
                                                       burst=2, gap=3)],
                 eos=[EosSpec(p_early=0.0)])
    r = run(cell)
    assert r.error == ""
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["mesh"] == "1x2" and r.stats["mesh_devices"] == 2
    twin = run(cell.mesh_twin())
    assert r.tokens == twin.tokens and len(r.tokens) == cell.requests
    for key in ("fused_steps", "busy_slot_steps", "ttft_p95_steps",
                "logical_blocks", "physical_blocks"):
        assert r.stats[key] == twin.stats[key], key


def test_mesh_spawns_have_their_own_timeout():
    assert 0 < runner.MESH_TIMEOUT_S <= 120
