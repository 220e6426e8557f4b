"""The PyTorch port's training engine: the imperative forward/backward/
step loop against train_batch, the fp16 overflow-skipped step, masterless
bf16 state, and a masterless bf16 loss curve against the JAX reference's
engine (plain paths on both sides: kernels off, attn_impl "xla").

Inputs come from numpy with a seed and are handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.ops import kernel_config as kc

torch.set_num_threads(1)

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
            rotary=True, parallel_residual=True)
S = 64
BASE = {
    "train_batch_size": 4,
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Adam",
                  "params": {"lr": 3e-3, "betas": [0.9, 0.95]}},
    "scheduler": {"type": "WarmupDecayLR",
                  "params": {"warmup_max_lr": 3e-3, "warmup_num_steps": 3,
                             "total_num_steps": 50}},
    "gradient_clipping": 0.5,
}
MASTERLESS = dict(BASE, bf16={"enabled": True, "master_weights": False})
# both engines store params, grads and moments in bf16 and compute the
# update in fp32; they round the forward at other places (XLA fuses), so
# the losses agree to a few bf16 ulps of the loss, not to fp32 rounding
BF16_LOSS_RTOL = 4e-3


def _models(dtype_j, dtype_t, seed=0):
    jcfg = jax_gpt.GPTConfig(**NEOX, dtype=dtype_j, attn_impl="xla",
                             remat=False, ce_chunk=0)
    jinit, _, jloss, _ = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(seed))
    tcfg = gpt.GPTConfig(**NEOX, dtype=dtype_t, attn_impl="xla",
                         remat=False, ce_chunk=0)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jparams, jloss, tparams, gpt.make_gpt(tcfg)[2]


def _batches(n, rows, seed=11):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 97, (rows, S + 1)).astype(np.int32)
            for _ in range(n)]


def test_masterless_bf16_loss_curve_matches_reference():
    jparams, jloss, tparams, tloss = _models(jnp.bfloat16, torch.bfloat16)
    batches = _batches(2, 4) * 3
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jeng, _, _, _ = deeperspeed_tpu.initialize(
        model=jloss, model_parameters=jparams, config=MASTERLESS, mesh=mesh)
    jl = [float(jeng.train_batch(b)) for b in batches]
    with kc.override():
        teng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=tloss, model_parameters=tparams, config=MASTERLESS,
            device="cpu")
        tl = [float(teng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_RTOL)
    assert tl[-1] < tl[0]
    assert teng.master is None and jeng.state.master is None
    assert teng.params["layers"]["attn"]["wqkv"].dtype == torch.bfloat16
    assert teng.opt_state.exp_avg_sq["layers"]["mlp"]["wi"].dtype == \
        torch.bfloat16
    assert (str(jeng.state.opt_state.exp_avg_sq["layers"]["mlp"]["wi"].dtype)
            == "bfloat16")


def test_fp16_overflow_skips_the_step_and_halves_the_scale():
    """fp16 with the dynamic scaler: a non-finite gradient skips the
    update (params and moments untouched), counts a skipped step, halves
    the scale once hysteresis is spent, and leaves the LR schedule."""
    conf = {"train_batch_size": 2, "fp16": {"enabled": True,
                                            "initial_scale_power": 8,
                                            "hysteresis": 1},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_max_lr": 1e-2,
                                     "warmup_num_steps": 5}}}

    def loss_fn(p, batch):
        return (p["w"].float() * batch.float()).sum()

    eng, _, _, sched = deeperspeed_tpu_torch.initialize(
        model=loss_fn, model_parameters={"w": torch.ones(2, 3)}, config=conf,
        device="cpu")
    assert eng.loss_scale() == 256.0
    eng.train_batch(np.ones((2, 3), np.float32))
    assert eng.skipped_steps == 0 and sched.last_batch_iteration == 0
    w = eng.params["w"].detach().clone()
    eng.train_batch(np.full((2, 3), np.inf, np.float32))
    assert eng.skipped_steps == 1 and eng.loss_scale() == 128.0
    assert not np.isfinite(eng.get_global_grad_norm())
    torch.testing.assert_close(eng.params["w"].detach(), w)
    assert sched.last_batch_iteration == 0 and eng.global_steps == 2
    eng.train_batch(np.ones((2, 3), np.float32))
    assert eng.skipped_steps == 1 and sched.last_batch_iteration == 1


def test_imperative_loop_matches_train_batch():
    """forward/backward/step over the micro-batches gives the same update
    as train_batch on their concatenation."""
    _, _, tparams, tloss = _models(jnp.float32, torch.float32)
    batches = _batches(2, 4)
    with kc.override():
        a, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=tloss, model_parameters=tparams, config=BASE, device="cpu")
        b, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=tloss, model_parameters=tparams, config=BASE, device="cpu")
        for batch in batches:
            a.train_batch(batch)
            for i in range(2):
                b.forward(batch[2 * i:2 * i + 2])
                b.backward()
                assert b.is_gradient_accumulation_boundary() == (i == 1)
                b.step()
    assert a.global_steps == b.global_steps == 2
    for k, v in convert._flatten(a.params).items():
        torch.testing.assert_close(v, convert._flatten(b.params)[k],
                                   atol=1e-6, rtol=1e-6)
    with pytest.raises(RuntimeError, match="prior forward"):
        b.backward()


def test_loss_that_takes_an_rng_gets_a_fresh_generator_per_call():
    """A loss_fn(params, batch, rng) gets a torch.Generator seeded from
    (initialize's rng, call count): the same engine seed replays the same
    draws, successive calls draw anew."""
    seen = []

    def loss_fn(p, batch, rng):
        seen.append(torch.rand(2, generator=rng))
        return (p["w"] * batch.float()).sum()

    draws = []
    for _ in range(2):
        seen.clear()
        eng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=loss_fn, model_parameters={"w": torch.ones(3)},
            config={"train_batch_size": 2}, device="cpu", rng=5)
        eng.train_batch(np.ones((2, 3), np.float32))
        eng.train_batch(np.ones((2, 3), np.float32))
        draws.append(torch.stack(seen))
    torch.testing.assert_close(draws[0], draws[1])
    assert not torch.equal(draws[0][0], draws[0][1])


def test_grads_autograd_shares_or_expands_are_banked_safely():
    """autograd hands back an expanded view for the grad of a sum, and one
    tensor for both inputs of an add; the engine banks copies, so two
    micro-batches accumulate to exactly 2 per element and the in-place
    unscale/clip cannot touch a grad twice."""
    def loss_fn(p, batch):
        return (p["a"] + p["b"]).sum() + p["w"].sum() * batch.float().sum()

    params = {"a": torch.zeros(3, 4), "b": torch.zeros(3, 4),
              "w": torch.zeros(5)}
    conf = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 2, "gradient_clipping": 0.5}
    eng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=loss_fn, model_parameters=params, config=conf, device="cpu")
    for _ in range(2):
        eng.forward(np.ones((1, 1), np.float32))
        eng.backward()
    acc = dict(zip("abw", eng._grad_acc))
    for k in "abw":
        torch.testing.assert_close(acc[k], torch.full_like(acc[k], 2.0))
    eng.step()
    eng.step()
    assert eng.global_steps == 1
    # the norm is of the summed grads over gas: sqrt(12 + 12 + 5) * 2 / 2
    np.testing.assert_allclose(eng.get_global_grad_norm(), 29 ** 0.5,
                               rtol=1e-6)
    eng.train_batch(np.ones((2, 1), np.float32))
    assert eng.global_steps == 2
