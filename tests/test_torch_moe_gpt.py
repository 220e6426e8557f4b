"""The Mixture-of-Experts GPT of the port (models/gpt.py with
``moe_num_experts``, its ``layers/moe`` subtree in place of ``mlp``)
against the JAX reference's on the same fp32 weights (carried by
models/convert.py, leaf for leaf):

* the loss (cross-entropy plus the layers' summed ``moe_loss``) within
  AUX_RTOL and every param's grad within GRAD_RTOL/GRAD_ATOL of
  ``jax.grad``, dense dispatch under remat "full" and dropless without;
  ``make_gpt``'s specs (the expert leaves on the ``expert`` axis), the init
  shapes and the weights' conversion both ways;
* serving and speculative verify over a MoE target: greedy tokens equal
  to the reference engine's on the same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.serving import ServingConfig as JaxServingConfig
from deeperspeed_tpu.serving import ServingEngine as JaxServingEngine
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.serving import ServingConfig, ServingEngine

torch.set_num_threads(1)

# the frameworks sum fp32 in other orders (tests/test_torch_moe.py)
AUX_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-6

KW = dict(vocab_size=61, n_layer=2, n_head=2, d_model=32, max_seq=64,
          moe_num_experts=4, attn_impl="xla")


def _pair(seed=0, **kw):
    kw = dict(KW, **kw)
    jcfg = jax_gpt.GPTConfig(**kw, dtype=jnp.float32)
    jinit, _, jloss, jspecs = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(seed))
    tcfg = gpt.GPTConfig(**kw, dtype=torch.float32)
    numpy_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, jloss, tcfg, convert.from_jax_params(
        numpy_params, tcfg, "cpu")


@pytest.mark.parametrize("impl,remat", [("dense", True),
                                        ("dropless", False)])
def test_moe_gpt_loss_and_grads_match_reference(impl, remat):
    _, jparams, jloss, tcfg, tparams = _pair(
        moe_dispatch_impl=impl, remat=remat)
    toks = np.random.RandomState(7).randint(0, 61, (2, 17))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams, jnp.asarray(toks))
    _, _, tloss, specs = gpt.make_gpt(tcfg)
    leaves = {k: v.requires_grad_(True) for k, v in
              convert._flatten(tparams).items()}
    tl = tloss(tparams, torch.tensor(toks))
    names = sorted(leaves)
    grads = torch.autograd.grad(tl, [leaves[n] for n in names])
    np.testing.assert_allclose(float(tl), float(jl), rtol=AUX_RTOL)
    flat_j = convert._flatten(jax.tree.map(np.asarray, jg))
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), flat_j[n], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)
    assert "mlp" not in tparams["layers"]
    assert specs["layers"]["moe"]["experts"]["wo"] == (None, "expert",
                                                       None, None)
    # the tensor-parallel specs are the reference's (the qkv leaves also
    # carry their q/k/v sections)
    assert specs["layers"]["attn"]["wqkv"] == (None, None, "model")
    dense = gpt.make_gpt(gpt.GPTConfig(**dict(KW, moe_num_experts=0)))[3]
    assert dense["layers"]["mlp"]["wi"] == (None, None, "model")
    back = convert.to_numpy_params(tparams)
    for n, a in convert._flatten(back).items():
        np.testing.assert_array_equal(a, convert._flatten(
            jax.tree.map(np.asarray, jparams))[n])
    shapes = convert._flatten(gpt.param_shapes(tcfg))
    init = convert._flatten(gpt.init_params(0, tcfg, device="cpu"))
    assert {n: tuple(t.shape) for n, t in init.items()} == shapes


def _scfg(spec=None):
    d = dict(num_slots=2, block_size=4, num_blocks=64, max_seq_len=64,
             prefill_buckets=(4, 8, 16, 32, 64))
    if spec is not None:
        d["speculative"] = dict(spec)
    return d


def _serve(eng, prompts, new):
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("spec", [None, {"draft_k": 3,
                                         "drafter": {"n_layer": 1}}])
def test_moe_serving_tokens_equal_reference(spec):
    jcfg, jparams, _, tcfg, tparams = _pair(2, remat=False)
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 61, (n,)).tolist() for n in (5, 11, 19)]
    eng = ServingEngine(tcfg, tparams, ServingConfig(**_scfg(spec)),
                        device="cpu")
    got = _serve(eng, prompts, 12)
    want = _serve(JaxServingEngine(jcfg, jparams,
                                   JaxServingConfig(**_scfg(spec))),
                  prompts, 12)
    assert got == want
    if spec is not None:
        assert eng.metrics.spec_rounds > 0


def test_moe_stats_account_for_the_aux_term():
    """``moe_stats``' per-layer aux and z losses are the MoE part of the
    loss: the loss less its value with both coefficients 0 equals
    sum(aux_coef * aux + z_coef * z) over the layers."""
    _, _, _, tcfg, tparams = _pair(3, remat=False)
    toks = torch.tensor(np.random.RandomState(8).randint(0, 61, (2, 17)))
    stats = gpt.moe_stats(tcfg, tparams, toks[:, :-1])
    assert len(stats) == tcfg.n_layer
    assert all(0.0 <= s["dropped_frac"] < 1.0 for s in stats)
    with torch.no_grad():
        full = float(gpt.make_gpt(tcfg)[2](tparams, toks))
        bare = float(gpt.make_gpt(dataclasses.replace(
            tcfg, moe_aux_coef=0.0, moe_z_coef=0.0))[2](tparams, toks))
    want = sum(tcfg.moe_aux_coef * s["aux_loss"]
               + tcfg.moe_z_coef * s["z_loss"] for s in stats)
    np.testing.assert_allclose(full - bare, want, rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError, match="Mixture-of-Experts"):
        gpt.moe_stats(dataclasses.replace(tcfg, moe_num_experts=0),
                      tparams, toks)


def test_moe_8e_ep_config_trains():
    """configs/moe_8e_ep.json's blocks as written (bf16 with an fp32
    master, ZeRO 1, Adam 3e-4 betas 0.9/0.95, clip 1.0, micro-batch 8),
    train_batch_size cut to 8 for one rank, on a tiny 8-expert top-2 MoE
    GPT: the engine builds and the loss falls over a fixed batch."""
    import json
    from pathlib import Path

    import deeperspeed_tpu_torch

    root = Path(__file__).resolve().parent.parent
    config = json.loads((root / "configs" / "moe_8e_ep.json").read_text())
    config["train_batch_size"] = 8
    cfg = gpt.GPTConfig(**dict(KW, moe_num_experts=8), moe_top_k=2,
                        dtype=torch.bfloat16)
    init, _, loss, specs = gpt.make_gpt(cfg)
    eng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=loss, model_parameters=init(0, device="cpu"), config=config,
        device="cpu", param_specs=specs)
    assert (eng.zero_stage, eng.gradient_accumulation_steps()) == (1, 1)
    assert eng.master is not None
    batch = np.random.RandomState(5).randint(0, 61, (8, 33))
    losses = [float(eng.train_batch(batch)) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]

