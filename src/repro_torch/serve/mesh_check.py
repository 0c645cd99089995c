"""Cross-mesh golden check of the port: serve the same traffic on every
mesh shape and demand identical token streams.

Port of ``repro/serve/mesh_check.py``.  The contract of tensor-parallel
serving is that the mesh never shows in the tokens: :func:`run_check`
serves one seeded workload per architecture unsharded (the baseline) and
on each requested ``DxM`` mesh of ranks (:func:`repro_torch.launch.mesh.
spawn`), and diffs every stream against the baseline, uid for uid, token
for token.  One set of ranks a shape serves every workload.

With int8 pools it also holds each rank's pools against the baseline's
head slice.  Every rank must hold the same scale pools, bit for bit, as
the rules replicate them.  Codes must be within one step and scales
within ``INT8_SCALE_RTOL`` of the baseline's: data-sharded matmuls and
row-parallel sums move K/V by a few ulps before they are quantized, so
bit-equality holds only where nothing moved them, and a code that such
ulps flip feeds one quantization step into every later row.

    PYTHONPATH=src python -m repro_torch.serve.mesh_check --device cpu \\
        --meshes none,1x1,2x1,1x2,2x2

The JSON verdict on stdout carries per-(workload, mesh) stream digests, the
diff list (empty = contract holds), per-device utilization, each rank's
backend, collectives' counters, head-sharded decode launches and
commit-kernel launches, and the baseline's streams.  A workload that needs
an architecture or a feature the port lacks is listed under ``refused``
with the ROADMAP item that ports it, and fails the check; the default
``--workloads`` are the reference's nine.  The speculative workloads draw
the draft's weights as the target's (``--weights`` or the seeded init):
with ``draft`` the served arch, self-speculation.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

#: (name, arch, engine-kwargs overrides): the reference's nine workloads,
#: then the port's chunked one (the reference serves no chunked mesh)
DEFAULT_WORKLOADS = (
    ("gpt2", "gpt2-124m", {}),
    ("qwen3", "qwen3-1.7b", {}),
    ("mamba2", "mamba2-370m", {}),
    ("mla", "deepseek-v2-lite-16b", {}),
    ("moe", "deepseek-moe-16b", {}),
    ("jamba", "jamba-1.5-large-398b", {}),
    ("gpt2-int8-shared", "gpt2-124m",
     {"kv_dtype": "int8", "share_prefixes": True, "shared_prefix_len": 6}),
    ("gpt2-spec", "gpt2-124m", {"spec_k": 2, "draft": "gpt2-124m"}),
    ("gpt2-spec-adapt", "gpt2-124m",
     {"spec_k": 2, "draft": "gpt2-124m", "spec_adaptive": True}),
    ("qwen3-int8-shared-chunked", "qwen3-1.7b",
     {"kv_dtype": "int8", "share_prefixes": True, "shared_prefix_len": 6,
      "prefill_chunk": 4}),
)
#: the workloads ``--workloads`` runs by default
SERVED = ("gpt2", "qwen3", "mamba2", "mla", "moe", "jamba",
          "gpt2-int8-shared", "gpt2-spec", "gpt2-spec-adapt")
#: int8 pools against the baseline's: codes within one step, scales
#: within this relative difference.  A flipped code moves later rows by
#: up to a quantization step (1/127 of a row's amax); on an H100 the
#: scales moved by up to 1.2e-3.  A rank that scaled its rows by the
#: amax of its own heads only would be off by 5-50%.
INT8_SCALE_RTOL = 1e-2


def _load_weights(weights: Optional[str], arch: str):
    """The reference parameter tree of ``arch`` from ``weights/<arch>.npz``
    (keys "/"-joined), or None."""
    if weights is None:
        return None
    tree: Dict[str, Any] = {}
    with np.load(Path(weights) / f"{arch}.npz") as z:
        for key in z.files:
            node = tree
            *head, last = key.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = z[key]
    return tree


def full_params(arch: str, cfg, seed: int, device, weights=None):
    """The unsharded parameters of a workload: the reference's tree from
    ``weights`` (see :func:`_load_weights`), else the port's seeded
    init."""
    from repro_torch.models import transformer

    tree = _load_weights(weights, arch)
    if tree is None:
        return transformer.init_lm(cfg, seed=seed, device=device)
    return transformer.params_from_numpy(tree, cfg, device)


def serve_workload(arch: str, mesh, *, requests: int = 4, max_new: int = 8,
                   max_batch: int = 2, max_len: int = 64,
                   block_size: int = 8, seed: int = 0,
                   kv_dtype: str = "f32", share_prefixes: bool = False,
                   shared_prefix_len: int = 0, spec_k: int = 0,
                   draft: Optional[str] = None, spec_adaptive: bool = False,
                   prefill_chunk: int = 1, device="cuda",
                   weights: Optional[str] = None, config=None,
                   params=None) -> Dict[str, Any]:
    """Serve one seeded workload; returns streams, engine stats and, for
    int8 pools, the final pools as numpy arrays.

    Traffic depends only on (arch, seed, sizing), never on the mesh, so
    the same call with another ``mesh`` is a golden twin.  ``config``
    replaces the smoke config of ``arch``; ``params`` are the full
    parameters (:func:`full_params`), built here when not given; under a
    mesh this rank serves its shards of them.  With ``spec_k`` a
    ``draft`` of another arch has its smoke config and the parameters of
    :func:`full_params` with the same seed, cut by the same rules; a draft
    of ``arch`` (the default) is the target itself, ``config`` and
    parameters (self-speculation).
    """
    import repro_torch.configs as configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = config or configs.get_smoke_config(arch)
    if params is None:
        params = full_params(arch, cfg, seed, device, weights)
    draft_cfg = draft_params = None
    own_draft = spec_k and (draft or arch) != arch
    if own_draft:
        draft_cfg = configs.get_smoke_config(draft)
        draft_params = full_params(draft, draft_cfg, seed, device, weights)
    if mesh is not None:
        params = transformer.shard_params(params, mesh, mesh.device)
        if own_draft:
            draft_params = transformer.shard_params(draft_params, mesh,
                                                    mesh.device)
    if spec_k and not own_draft:  # self-speculation: the target's weights
        draft_cfg, draft_params = cfg, params
    engine = ServeEngine(
        cfg, params, max_batch=max_batch, max_len=max_len,
        scheduler="continuous", block_size=block_size, kv_dtype=kv_dtype,
        share_prefixes=share_prefixes, spec_k=spec_k, draft_cfg=draft_cfg,
        draft_params=draft_params, spec_adaptive=spec_adaptive,
        prefill_chunk=prefill_chunk, mesh=mesh, device=device,
    )
    last: Dict[str, Any] = {}
    engine.add_step_hook(
        lambda e, busy: bool(last.update(cache=e._live["cache"])))
    rng = np.random.default_rng(seed)
    prefix = (rng.integers(0, cfg.vocab, size=shared_prefix_len)
              .astype(np.int32) if shared_prefix_len > 0 else None)
    for uid in range(requests):
        plen = int(rng.integers(3, 10))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        if prefix is not None:
            prompt = np.concatenate([prefix, prompt])
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=max_new))
    done = engine.run_until_drained()
    stats = engine.stats()
    return {
        "streams": {int(u): [int(t) for t in r.generated]
                    for u, r in done.items()},
        "mesh": engine.mesh_shape,
        "device_lane_utilization": stats["device_lane_utilization"],
        "mesh_devices": stats["mesh_devices"],
        "fused_steps": stats["fused_steps"],
        "drafted_tokens": stats["drafted_tokens"],
        "accepted_tokens": stats["accepted_tokens"],
        "draft_steps": stats["draft_steps"],
        "physical_blocks": stats.get("physical_blocks", 0),
        "logical_blocks": stats.get("logical_blocks", 0),
        "pools": ({k: v.cpu().numpy() for k, v in last["cache"].items()}
                  if kv_dtype == "int8" else None),
    }


def _digest(streams: Dict[int, List[int]]) -> str:
    blob = json.dumps({str(k): streams[k] for k in sorted(streams)},
                      sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def compare_pools(local: Dict[str, np.ndarray], base: Dict[str, np.ndarray],
                  model_index: int, model: int) -> Dict[str, Any]:
    """One rank's int8 pools against the baseline's head slice: the
    largest code difference, how many codes differ, the largest relative
    scale difference, and a digest of the rank's scale pools."""
    kv = base["k"].shape[-2]
    per = kv // model if kv % model == 0 else kv
    first = model_index * per if kv % model == 0 else 0
    codes = [local[k].astype(np.int32)
             - base[k][..., first:first + per, :].astype(np.int32)
             for k in ("k", "v")]
    scales = [np.abs(local[k] - base[k]) / np.maximum(np.abs(base[k]),
                                                      1e-30)
              for k in ("k_scale", "v_scale")]
    blob = b"".join(np.ascontiguousarray(local[k]).tobytes()
                    for k in ("k_scale", "v_scale"))
    return {"codes_max_diff": int(max(np.abs(c).max() for c in codes)),
            "codes_differ": int(sum((c != 0).sum() for c in codes)),
            "scales_max_rel_diff": float(max(s.max() for s in scales)),
            "scales_digest": hashlib.sha256(blob).hexdigest()[:16]}


def _rank_counts(mesh) -> Dict[str, Any]:
    from repro_torch.kernels.flash_decode import kernel

    return {"rank": mesh.rank, "backend": mesh.backend,
            "comm": mesh.comm.counters(),
            "decode_sharded_launches":
                kernel.flash_decode_paged_sharded.launches,
            "commit_launches": kernel.commit_paged.launches}


def _serve_on_mesh(mesh, workloads, kw, base_pools, params
                   ) -> Dict[str, Any]:
    """One rank's part of :func:`run_check` on one shape: serve every
    workload on its shards of ``params[name]``, hold int8 pools against
    the baseline's, and gather every rank's pool comparison and counters
    to each rank."""
    out = {}
    for name, arch, overrides in workloads:
        before = _rank_counts(mesh)
        res = serve_workload(arch, mesh, **kw, **overrides,
                             params=params[name])
        pools = res.pop("pools")
        mine = {"counts": _rank_counts(mesh), "before": before}
        if pools is not None:
            mine["pools"] = compare_pools(pools, base_pools[name],
                                          mesh.model_index, mesh.model)
        res["ranks"] = mesh.gather_objects(mine)
        out[name] = res
    return out


def _serve_on_meshes(world, shapes, workloads, kw, base_pools, params
                     ) -> Dict[str, Any]:
    """One rank's part of :func:`run_check` on every shape: each shape a
    mesh of the spawn's first ranks (:func:`_serve_on_mesh` on those in
    it); {shape: its results} on rank 0."""
    import torch

    from repro_torch.launch.mesh import make_train_mesh, parse_mesh

    out = {}
    for shape in shapes:
        d, m = parse_mesh(shape)
        mesh = make_train_mesh(d, m, device=world.device,
                               ranks=range(d * m))
        if mesh is not None:
            out[shape] = _serve_on_mesh(mesh, workloads, kw, base_pools,
                                        params)
        if world.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _per_rank(ranks) -> List[Dict[str, Any]]:
    """Each rank's counters for one workload: what it added while serving
    it."""
    rows = []
    for r in ranks:
        now, then = r["counts"], r["before"]
        rows.append({"rank": now["rank"], "backend": now["backend"],
                     **{k: now["comm"][k] - then["comm"][k]
                        for k in now["comm"]},
                     **{key: now[key] - then[key]
                        for key in ("decode_sharded_launches",
                                    "commit_launches")}})
    return rows


def _pool_verdict(ranks) -> Dict[str, Any]:
    pools = [r["pools"] for r in ranks]
    return {"codes_max_diff": max(p["codes_max_diff"] for p in pools),
            "codes_differ": sum(p["codes_differ"] for p in pools),
            "scales_max_rel_diff": max(p["scales_max_rel_diff"]
                                       for p in pools),
            "scales_replicated": len({p["scales_digest"]
                                      for p in pools}) == 1}


def run_check(meshes: Sequence[Optional[str]],
              workloads=tuple(w for w in DEFAULT_WORKLOADS
                              if w[0] in SERVED), *,
              requests: int = 4, max_new: int = 8, seed: int = 0,
              device="cuda", weights: Optional[str] = None,
              timeout: float = 600.0) -> Dict[str, Any]:
    """Serve every workload on every mesh shape; diff against unsharded.

    The ``None`` baseline is always run (prepended when absent) in this
    process; the ``DxM`` shapes run in one spawn of ranks, as large as the
    largest data and model axes, whose first ``D*M`` ranks serve each
    shape as a mesh of their own (:func:`~repro_torch.launch.mesh.
    make_train_mesh`), all workloads at a time.  Each workload's
    parameters are built once, here, and reach the ranks shared (through
    CUDA IPC on the card), which cut their shards.
    """
    import repro_torch.configs as configs
    from repro_torch.launch.mesh import parse_mesh, spawn

    shapes = list(meshes)
    if None not in shapes:
        shapes.insert(0, None)
    results: Dict[str, Any] = {
        "workloads": {}, "diffs": [], "refused": {}, "device": str(device),
        "shapes": [s or "none" for s in shapes]}
    kw = dict(requests=requests, max_new=max_new, seed=seed, device=device,
              weights=weights)
    base, base_pools, params = {}, {}, {}
    for name, arch, overrides in workloads:
        try:
            cfg = (overrides.get("config")
                   or configs.get_smoke_config(arch))
            params[name] = full_params(arch, cfg, seed, device, weights)
            out = serve_workload(arch, None, **kw, **overrides,
                                 params=params[name])
        except (KeyError, ValueError) as e:
            if "ROADMAP item" not in str(e):
                raise
            results["refused"][name] = e.args[0]
            continue
        base_pools[name] = out.pop("pools")
        base[name] = out
    live = [w for w in workloads if w[0] in base]
    results["streams"] = {name: out["streams"] for name, out in base.items()}
    meshed = [s for s in shapes if s is not None]
    by_shape = {None: base}
    if meshed:
        dims = [parse_mesh(s) for s in meshed]
        by_shape.update(spawn(
            _serve_on_meshes, max(d for d, _ in dims),
            max(m for _, m in dims), meshed, live, kw, base_pools, params,
            device=device, timeout=timeout * len(meshed)))
    for shape in shapes:
        by_name = by_shape[shape]
        for name, _, _ in live:
            out = by_name[name]
            row = {
                "digest": _digest(out["streams"]),
                "device_lane_utilization": out["device_lane_utilization"],
                "mesh_devices": out["mesh_devices"],
                "fused_steps": out["fused_steps"],
                "drafted_tokens": out["drafted_tokens"],
                "accepted_tokens": out["accepted_tokens"],
                "draft_steps": out["draft_steps"],
            }
            if shape is not None:
                row["ranks"] = _per_rank(out["ranks"])
                if base_pools[name] is not None:
                    row["pools"] = pools = _pool_verdict(out["ranks"])
                    if not (pools["scales_replicated"]
                            and pools["codes_max_diff"] <= 1
                            and pools["scales_max_rel_diff"]
                            <= INT8_SCALE_RTOL):
                        results["diffs"].append(
                            f"{name}@{shape}: int8 pools {pools}")
                for uid in sorted(base[name]["streams"]):
                    got = out["streams"].get(uid)
                    want = base[name]["streams"][uid]
                    if got != want:
                        results["diffs"].append(
                            f"{name}@{shape}: uid {uid} diverged "
                            f"({got} != {want})")
            results["workloads"].setdefault(name, {})[shape or "none"] = row
    results["ok"] = not results["diffs"] and not results["refused"]
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="none,1x1,2x1,1x2,2x2",
                    help="comma list of DxM shapes ('none' = unsharded "
                         "baseline; always included)")
    ap.add_argument("--workloads", default=",".join(SERVED),
                    help="comma list of workload names to run (default: "
                         "the ones the port serves)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--weights", default=None,
                    help="directory of <arch>.npz reference parameter "
                         "trees ('/'-joined keys); default: the port's "
                         "seeded init")
    ap.add_argument("--out", default=None, help="write the verdict here "
                    "instead of stdout")
    args = ap.parse_args(argv)
    shapes = [None if s in ("none", "") else s
              for s in args.meshes.split(",")]
    want = set(args.workloads.split(","))
    unknown = want - {w[0] for w in DEFAULT_WORKLOADS}
    if unknown:
        ap.error(f"unknown workloads: {sorted(unknown)}")
    workloads = tuple(w for w in DEFAULT_WORKLOADS if w[0] in want)
    verdict = run_check(shapes, workloads, requests=args.requests,
                        max_new=args.max_new, seed=args.seed,
                        device=args.device, weights=args.weights)
    blob = json.dumps(verdict, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob)
        print(f"mesh check {'OK' if verdict['ok'] else 'FAILED'} "
              f"-> {args.out}")
    else:
        print(blob)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
