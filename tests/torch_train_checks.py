"""Checks shared by the port's train-stack tests
(``tests/test_torch_train_*.py``): the port's ``steps.model_forward``,
``loss_fn``, ``loss_and_grads`` and train step held against
``repro.train.steps`` on the reference's weights and batches, for each
arch's smoke config (whisper's encoder-decoder included).

The weights come from ``repro.train.steps.init_model(PRNGKey(0), cfg)``
through ``steps.params_from_numpy`` (the family's layout map); the
reference's gradients and optimizer states carry across through the same
map (``params_from_numpy(..., dtype=)``, ``adamw.opt_state_from_numpy``).  The
port's pipeline is held equal to ``repro.data.pipeline.global_batch`` in
one process; the parity checks run on :func:`fixed_batch`'s batches, the
same in every process.  The reference's steps are jitted.

Tolerances: logits rtol 1e-4 and atol 1e-5; the loss rtol 1e-5; every
gradient leaf rtol 1e-4 and atol 1e-5; params, m, v and master after
three train steps rtol 1e-4 and atol 1e-5 (the reference's microbatch
bound, ``tests/test_optim_train.py``), and 2e-4 for the SSM and hybrid
archs (the bound of the two SSD orders, ``tests/torch_stateful_checks.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
from repro.configs.base import ShapeConfig as RefShape
from repro.data import pipeline as ref_pipeline
from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps
import repro_torch.configs as port_configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import steps

#: the reference's ``tests/conftest.py`` smoke shape: 2 rows of 32
SEQ, BATCH = 32, 2
LOGITS = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=0)
GRADS = dict(rtol=1e-4, atol=1e-5)
#: the SSD bound for the archs with mamba mixers
SSD = dict(rtol=2e-4, atol=2e-4)
STEPS = 3


def state_tol(arch) -> dict:
    return SSD if port_configs.get_smoke_config(arch).ssm is not None \
        else GRADS


@dataclasses.dataclass
class Arch:
    name: str
    rcfg: object
    cfg: object
    rparams: dict
    tree: dict  # the reference's params as numpy

    def params(self) -> dict:
        return steps.params_from_numpy(self.tree, self.cfg, "cpu")


@functools.lru_cache(maxsize=None)
def arch(name: str) -> Arch:
    rcfg = ref_configs.get_smoke_config(name)
    rp = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
    return Arch(name, rcfg, port_configs.get_smoke_config(name), rp,
                jax.tree.map(np.asarray, rp))


def ref_batch(a: Arch, step: int, seq=SEQ, batch=BATCH, seed=0) -> dict:
    return ref_pipeline.global_batch(
        a.rcfg, RefShape("smoke", seq, batch, "train"),
        ref_pipeline.DataConfig(seed=seed), step)


def fixed_batch(a: Arch, step: int, seq=SEQ, batch=BATCH, seed=0) -> dict:
    """A batch laid out as the pipeline's (Zipf tokens and next-token
    labels, the VLM's unit-Gaussian image embeddings before the text, the
    encoder-decoder's unit-Gaussian frames, max(seq // 4, 8) of them),
    drawn from numpy seeded by (seed, step) alone.  The pipeline's own
    seeds hash a string, which Python randomizes per process, so each test
    process would hold the two packages to other batches; a fixed one
    makes a router's near tie, where a top-k choice may part by an ulp,
    either show in every run or in none."""
    rng = np.random.default_rng([seed, step])
    n_img = a.cfg.n_img_tokens if a.cfg.family == "vlm" else 0
    z = rng.zipf(1.2, size=(batch, seq - n_img + 1)).astype(np.int64)
    tokens = ((z - 1) % a.cfg.vocab).astype(np.int32)
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if n_img:
        out["img_embeds"] = rng.standard_normal(
            (batch, n_img, a.cfg.d_model), dtype=np.float32)
    if a.cfg.is_encoder_decoder:
        out["enc_frames"] = rng.standard_normal(
            (batch, max(seq // 4, 8), a.cfg.d_model), dtype=np.float32)
    return out


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def as_port_tree(a: Arch, tree, dtype=torch.float32) -> dict:
    """A reference tree of the parameters' shape as the port's."""
    return steps.params_from_numpy(jax.tree.map(np.asarray, tree), a.cfg,
                                   "cpu", dtype=dtype)


def assert_trees_close(got, want, what, **tol) -> None:
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   w.float().numpy(), err_msg=f"{what} {i}",
                                   **tol)


# -- the checks ---------------------------------------------------------------


def check_batch_equals_the_reference(name: str) -> None:
    a = arch(name)
    shape = ShapeConfig("smoke", SEQ, BATCH, "train")
    for step in (0, 5):
        got = pipeline.global_batch(a.cfg, shape, pipeline.DataConfig(),
                                    step)
        want = ref_batch(a, step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


def check_forward(name: str) -> None:
    a = arch(name)
    batch = fixed_batch(a, 0)
    fwd = jax.jit(lambda p, b: ref_steps.model_forward(p, a.rcfg, b,
                                                       remat="none"))
    rlogits, raux, _ = fwd(a.rparams, to_jax(batch))
    logits, aux, labels = steps.model_forward(a.params(), a.cfg,
                                              to_torch(batch), remat="none")
    assert tuple(logits.shape) == rlogits.shape
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(rlogits),
                               **LOGITS)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(labels.numpy(), batch["labels"])


def check_loss_and_grads(name: str) -> None:
    a = arch(name)
    batch = fixed_batch(a, 0)
    run = ref_steps.RunConfig(remat="none", zero=False)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_steps.loss_fn(p, a.rcfg, b, run), has_aux=True))
    (rtotal, rmetrics), rgrads = vg(a.rparams, to_jax(batch))
    prun = steps.RunConfig(remat="none")
    params = a.params()
    total, _ = steps.loss_fn(params, a.cfg, to_torch(batch), prun)
    grads, metrics = steps.loss_and_grads(params, a.cfg, to_torch(batch),
                                          prun)
    np.testing.assert_allclose(float(total), float(rtotal), **LOSS)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), **LOSS)
    assert_trees_close(grads, as_port_tree(a, rgrads), "grad", **GRADS)
    # the caller's params carry no autograd state
    assert all(not p.requires_grad for p in tree_leaves(params))


def check_train_steps(name: str) -> None:
    """Three train steps on the pipeline's batches 0..2: params and every
    leaf of the optimizer state."""
    a = arch(name)
    run = ref_steps.RunConfig(remat="none", zero=False)
    ts = jax.jit(ref_steps.make_train_step(a.rcfg, run))
    rp, ro = a.rparams, ref_adamw.init_opt_state(a.rparams, run.opt)
    prun = steps.RunConfig(remat="none")
    step_fn = steps.make_train_step(a.cfg, prun)
    params = a.params()
    opt = adamw.init_opt_state(params, prun.opt)
    for step in range(STEPS):
        batch = fixed_batch(a, step)
        rp, ro, rm = ts(rp, ro, to_jax(batch))
        params, opt, metrics = step_fn(params, opt, to_torch(batch))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(rm["loss"]), **LOSS)
        assert float(metrics["lr"]) == float(rm["lr"])  # bit-equal
    tol = state_tol(name)
    assert_trees_close(params, as_port_tree(a, rp), "params", **tol)
    want = adamw.opt_state_from_numpy(jax.tree.map(np.asarray, ro), a.cfg,
                                      prun.opt, "cpu")
    assert int(opt["step"]) == int(want["step"]) == STEPS
    for key in ("m", "v", "master"):
        assert_trees_close(opt[key], want[key], key, **tol)


def check_remat_policies_agree(name: str) -> None:
    """none, full and dots give the same loss and gradients."""
    a = arch(name)
    batch = to_torch(fixed_batch(a, 0))
    params = a.params()
    out = {policy: steps.loss_and_grads(
        params, a.cfg, batch, steps.RunConfig(remat=policy))
        for policy in transformer.REMAT_POLICIES}
    grads, metrics = out["none"]
    for policy in ("full", "dots"):
        g, m = out[policy]
        np.testing.assert_allclose(float(m["loss"]), float(metrics["loss"]),
                                   **LOSS)
        assert_trees_close(g, grads, f"{policy} grad", rtol=1e-6, atol=1e-7)


def check_param_count(name: str) -> None:
    a = arch(name)
    assert a.cfg.param_count() == a.rcfg.param_count()
    n_port = sum(p.numel() for p in tree_leaves(a.params()))
    n_ref = sum(x.size for x in jax.tree.leaves(a.tree))
    assert n_port == n_ref


#: the per-arch checks, run by each ``tests/test_torch_train_*.py`` file on
#: its archs
CHECKS = [check_batch_equals_the_reference, check_forward,
          check_loss_and_grads, check_train_steps,
          check_remat_policies_agree, check_param_count]


def check_id(check) -> str:
    return check.__name__[len("check_"):]


def check_prefill_with_image(name: str) -> None:
    """``prefill`` with image embeddings before the text: last-token logits
    and every cache row against the reference's."""
    from repro.models import transformer as ref_tf

    a = arch(name)
    batch = fixed_batch(a, 0)
    img, tok = batch["img_embeds"], batch["tokens"]
    rlogits, rcache = jax.jit(lambda p, t, i: ref_tf.prefill(
        p, a.rcfg, t, img_embeds=i))(a.rparams, jnp.asarray(tok),
                                     jnp.asarray(img))
    logits, cache = steps.make_prefill_step(a.cfg)(
        a.params(), tokens=torch.from_numpy(tok),
        img_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **LOGITS)
    assert cache["pos"] == int(rcache["pos"]) == img.shape[1] + tok.shape[1]
    for key in ("k", "v"):
        want = np.asarray(rcache["blocks"]["slot0"][key])  # (layers, ...)
        np.testing.assert_allclose(cache[key].numpy(), want, **LOGITS)
