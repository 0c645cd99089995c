"""Shared checks of the port's scenario runner against
``repro.scenarios.runner``: the port's parameter cache carries the JAX
runner's own parameters, and a cell's result is held to the JAX runner's
on the same cell.
"""

import dataclasses

import jax
import numpy as np

import repro.scenarios as ref
import repro.scenarios.runner as ref_runner
import repro_torch.configs as port_configs
from repro_torch.models import transformer
from repro_torch.scenarios import (ArrivalSpec, EosSpec, MatrixSpec,
                                   PromptSpec)
from repro_torch.scenarios import runner

#: the stats that are exact (no wall clock): the port must count them as
#: the JAX runner does
EXACT = ("requests", "new_tokens", "fused_steps", "busy_slot_steps",
         "slot_steps", "preemptions", "restarts", "rejected",
         "ttft_p50_steps", "ttft_p95_steps", "logical_blocks",
         "physical_blocks", "shared_block_hits", "cow_copies",
         "kv_bytes_served", "kv_bytes_stored", "drafted_tokens",
         "accepted_tokens", "rejected_tokens", "draft_steps",
         "target_steps", "scheduler", "prefill_chunk", "share_prefixes",
         "spec_k", "mesh", "mesh_devices", "slot_utilization",
         "device_lane_utilization", "acceptance_rate", "block_dedup_ratio")


def carry_jax_params(archs=("gpt2-124m", "qwen3-1.7b")):
    """Fill the port runner's CPU cache with the JAX runner's parameters
    (``init_model(PRNGKey(0))`` of each smoke config)."""
    for arch in archs:
        _, rp = ref_runner._params_for(arch)
        cfg = port_configs.get_smoke_config(arch)
        runner._PARAMS[(arch, "cpu")] = (cfg, transformer.params_from_numpy(
            jax.tree.map(np.asarray, rp), cfg, "cpu"))


def tiny_matrix(**over) -> MatrixSpec:
    """``tests/test_scenarios.py``'s smallest matrix that still exercises
    queueing and slot refill."""
    kw = dict(
        arrivals=[ArrivalSpec(kind="poisson", rate=0.5)],
        prompts=[PromptSpec(kind="uniform", lo=4, hi=10)],
        eos=[EosSpec(p_early=0.1)],
        schedulers=["continuous"],
        archs=["gpt2-124m"],
        faults=["none"],
        requests=4,
        max_new=4,
        max_batch=2,
        max_len=32,
        block_size=8,
    )
    kw.update(over)
    return MatrixSpec(**kw)


def one_cell(fault="none", **over):
    cells = tiny_matrix(faults=[fault], **over).cells()
    assert len(cells) == 1
    return cells[0]


_RUNS = {}


def run(cell):
    """The port's result for ``cell`` on the CPU, memoized."""
    if cell not in _RUNS:
        _RUNS[cell] = runner.run_cell(cell, device="cpu")
    return _RUNS[cell]


def ref_cell(cell):
    """The reference's Scenario of the same axes and seed."""
    d = dataclasses.asdict(cell)
    return ref.Scenario(arrival=ref.ArrivalSpec(**d.pop("arrival")),
                        prompt=ref.PromptSpec(**d.pop("prompt")),
                        eos=ref.EosSpec(**d.pop("eos")),
                        slo=ref.SLOSpec(**d.pop("slo")), **d)


def assert_like_jax(cell, exact=EXACT):
    """The port's result for ``cell`` against the JAX runner's: streams,
    rejections (uids and reasons), restarts, the ``exact`` stats and the
    report's fields but its stats; every twin equal.  Returns the port's
    result."""
    mine = run(cell)
    theirs = ref_runner.run_cell(ref_cell(cell))
    assert mine.error == theirs.error == ""
    assert mine.tokens == theirs.tokens
    assert mine.rejected == theirs.rejected
    assert mine.restarts == theirs.restarts
    assert {k: mine.stats[k] for k in exact} == {
        k: theirs.stats[k] for k in exact}
    assert mine.golden_checked == theirs.golden_checked
    assert mine.golden_diffs == [] and mine.slo_failures == []
    assert mine.ok
    assert {k: v for k, v in mine.report().items() if k != "stats"} == {
        k: v for k, v in theirs.report().items() if k != "stats"}
    return mine
