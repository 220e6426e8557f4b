"""BERT MLM pretraining through both engines: a tiny BERT (2 layers,
d_model 64) trained 10 steps by the JAX reference's
``deeperspeed_tpu.initialize`` and the port's, from the same numpy
weights and batches, with LAMB, WarmupLR, gradient clipping and the
"kernels" block at mode ``fused`` (the reference's Pallas kernels in
interpret mode, the port's kernel wrappers' plain versions). fp32, and
bf16 with an fp32 master.

Also: a "Lamb" config builds the port's FusedLamb, routes no Adam kernel
(so it needs no ``"fused_adam": false``), and a BERT batch of 2 or 3
arrays splits into micro-batches unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.models import bert as jax_bert
from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu_torch.models import bert, convert
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.ops.lamb import FusedLamb
from deeperspeed_tpu_torch.runtime.engine import _micro_batch

torch.set_num_threads(1)

KW = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
          ce_chunk=32)
S = 64
BASE = {
    "train_batch_size": 4,
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Lamb",
                  "params": {"lr": 1e-2, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_max_lr": 1e-2, "warmup_num_steps": 3}},
    "gradient_clipping": 1.0,
    "kernels": {"mode": "fused"},
}
# fp32: the two frameworks sum in other orders; LAMB normalizes the update
# per leaf, so ulp-level gradient differences stay at that level
FP32_LOSS_RTOL = 1e-4
# bf16 with an fp32 master: the forward rounds at other places in the two
# frameworks (PR 2's limit for the GPT engines)
BF16_LOSS_RTOL = 4e-3


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _batches(n, rows, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, 97, (rows, S)).astype(np.int32)
        labels = np.where(rs.rand(rows, S) < 0.15, ids, -100)
        ids = np.where(labels != -100, 3, ids).astype(np.int32)  # [MASK]
        out.append((ids, labels.astype(np.int32)))
    return out


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_bert_engine_loss_curve_matches_reference(precision):
    config = dict(BASE)
    if precision == "bf16":
        config["bf16"] = {"enabled": True}
    dt_j, dt_t = ((jnp.bfloat16, torch.bfloat16) if precision == "bf16"
                  else (jnp.float32, torch.float32))
    jcfg = jax_bert.BertConfig(**KW, dtype=dt_j)
    tcfg = bert.BertConfig(**KW, dtype=dt_t)
    jinit, _, jloss, _ = jax_bert.make_bert(jcfg)
    jparams = jinit(jax.random.PRNGKey(0))
    tparams = convert.from_jax_bert_params(jax.tree.map(np.asarray, jparams),
                                           tcfg, "cpu")
    batches = _batches(2, 4) * 5
    with jax_kc.override():
        jeng, _, _, _ = deeperspeed_tpu.initialize(
            model=jloss, model_parameters=jparams, config=config,
            mesh=_one_device_mesh())
        jl = [float(jeng.train_batch(b)) for b in batches]
    with kc.override():
        teng, opt, _, _ = deeperspeed_tpu_torch.initialize(
            model=bert.make_bert(tcfg)[2], model_parameters=tparams,
            config=config, device="cpu")
        assert isinstance(opt, FusedLamb)
        tl = [float(teng.train_batch(b)) for b in batches]
    rtol = BF16_LOSS_RTOL if precision == "bf16" else FP32_LOSS_RTOL
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[-1] < tl[0]
    assert teng.get_lr() == jeng.get_lr()
    assert teng.global_steps == jeng.global_steps == 10
    assert teng.skipped_steps == jeng.skipped_steps == 0


def test_lamb_config_routes_no_adam_kernel_and_bert_batches_split():
    """Under kernels ``fused`` (which routes fused_adam to its unported
    kernel on a CUDA device) a Lamb config needs no ``fused_adam: false``:
    no Adam is built. A 3-array batch (ids, labels, mask) splits per
    micro-batch as the 2-array one does."""
    tcfg = bert.BertConfig(**KW, dtype=torch.float32)
    params = bert.init_params(0, tcfg, device="cpu")
    config = dict(BASE, optimizer={"type": "Lamb", "params": {
        "lr": 1e-3, "max_coeff": 5.0, "min_coeff": 0.1}})
    with kc.override():
        eng, opt, _, _ = deeperspeed_tpu_torch.initialize(
            model=bert.make_bert(tcfg)[2], model_parameters=params,
            config=config, device="cpu")
        assert isinstance(opt, FusedLamb)
        assert (opt.max_coeff, opt.min_coeff) == (5.0, 0.1)
        assert kc.get().mode == "fused" and kc.get().fused_adam
        ids, labels = _batches(1, 4)[0]
        mask = np.ones_like(ids)
        mask[:, 60:] = 0
        batch = eng._place_batch((ids, labels, mask))
        parts = [_micro_batch(batch, i, 2) for i in range(2)]
        assert [tuple(t.shape) for t in parts[1]] == [(2, S)] * 3
        assert torch.equal(parts[1][2], batch[2][2:])
        loss = eng.train_batch((ids, labels, mask))
    assert np.isfinite(float(loss)) and eng.global_steps == 1
