"""The sparse-attention slice as a whole: a user's loss that stacks
BertSparseSelfAttention layers pre-LN with a residual (h = h +
attn_i(layer_norm_i(h)), a final layer_norm, the mean square against a
fixed target), with its sparsity config read from a "sparse_attention"
block by get_sparse_attention, trained 10 steps through both engines'
initialize -> train_batch (Adam at a constant LR, clipping 1.0, micro-batch
1 x 2 accumulation steps). It is chip_smoke.py's phase 12 at a small size:
2 layers, hidden 64, 4 heads, S 128, block 16.

The reference's layers run their Pallas kernels in interpret mode (its
``SparseSelfAttention.impl`` set to "pallas_interpret": its
BertSparseSelfAttention takes no impl, and its "auto" is the dense XLA
route off a TPU). The port's layers keep impl "auto", which on the CPU is
the kernel pair's plain versions through the custom ops and their
autograd, and its engine runs under
"kernels": {"mode": "fused"}, so layer_norm goes through its kernel
wrappers' autograd Functions as well. Inputs, target and weights come
from seeded numpy and are handed to both. Losses agree within 1e-4 in
fp32 and within 4e-3 in masterless bf16 (the two engines round the bf16
forward at other places), the limits of the earlier slices' curves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.ops import sparse_attention as ref
from deeperspeed_tpu.ops.pallas.fused_blocks import layer_norm as ref_ln
from deeperspeed_tpu.runtime.config import TrainingConfig as RefConfig
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.ops import sparse_attention as port
from deeperspeed_tpu_torch.ops.fused_blocks import layer_norm
from deeperspeed_tpu_torch.ops.sparse_attention import block_sparse
from deeperspeed_tpu_torch.runtime.config import TrainingConfig

torch.set_num_threads(1)

LAYERS, D, HEADS, S, BLOCK = 2, 64, 4, 128, 16
EPS = 1e-5
STEPS = 10
SPARSE = {"mode": "fixed", "block": BLOCK, "different_layout_per_head": True,
          "num_local_blocks": 4, "num_global_blocks": 1,
          "attention": "bidirectional", "horizontal_global_attention": False,
          "num_different_global_patterns": 4}
BASE = {
    "train_batch_size": 2,
    "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
    "gradient_clipping": 1.0,
    "sparse_attention": SPARSE,
}
CONFIGS = {
    "fp32": (BASE, 1e-4),
    "bf16": (dict(BASE, bf16={"enabled": True, "master_weights": False}),
             4e-3),
}


def _weights(seed=0):
    """The params tree as numpy: per layer a LayerNorm and the q/k/v
    projections (w ~ N(0, 1/D), small random biases), then a final
    LayerNorm with a randomized affine."""
    rs = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rs.standard_normal(s) * scale).astype(
        np.float32)
    tree = {}
    for i in range(LAYERS):
        tree[f"layer{i:02d}"] = {
            "ln": {"w": 1.0 + f(D, scale=0.1), "b": f(D, scale=0.1)},
            "attn": {n: {"w": f(D, D, scale=D ** -0.5), "b": f(D, scale=0.1)}
                     for n in ("query", "key", "value")},
        }
    tree["ln_f"] = {"w": 1.0 + f(D, scale=0.1), "b": f(D, scale=0.1)}
    return tree


def _batch(seed=1):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((2, S, D)).astype(np.float32),
            rs.standard_normal((2, S, D)).astype(np.float32))


def _port_loss(attn):
    def loss_fn(params, batch):
        x, target = batch
        h = x.to(params["ln_f"]["w"].dtype)
        for i in range(LAYERS):
            lp = params[f"layer{i:02d}"]
            h = h + attn.apply(lp["attn"], layer_norm(h, lp["ln"]["w"],
                                                      lp["ln"]["b"], EPS))
        y = layer_norm(h, params["ln_f"]["w"], params["ln_f"]["b"], EPS)
        return (y.float() - target).square().mean()

    return loss_fn


def _ref_loss(attn):
    def loss_fn(params, batch):
        x, target = batch
        h = x.astype(params["ln_f"]["w"].dtype)
        for i in range(LAYERS):
            lp = params[f"layer{i:02d}"]
            h = h + attn.apply(lp["attn"], ref_ln(h, lp["ln"]["w"],
                                                  lp["ln"]["b"], EPS))
        y = ref_ln(h, params["ln_f"]["w"], params["ln_f"]["b"], EPS)
        return jnp.mean(jnp.square(y.astype(jnp.float32) - target))

    return loss_fn


@pytest.mark.parametrize("precision", list(CONFIGS))
def test_sparse_training_curve_matches_reference(precision):
    config, rtol = CONFIGS[precision]
    rsparsity = RefConfig(config).get_sparse_attention(HEADS)
    psparsity = TrainingConfig(config).get_sparse_attention(HEADS)
    assert np.array_equal(rsparsity.make_layout(S), psparsity.make_layout(S))
    rattn = ref.BertSparseSelfAttention(D, HEADS, rsparsity, max_seq_length=S)
    rattn.attn.impl = "pallas_interpret"
    pattn = port.BertSparseSelfAttention(D, HEADS, psparsity,
                                         max_seq_length=S)
    assert pattn.attn.impl == "auto"
    tree = _weights()
    batch = _batch()

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jeng, _, _, _ = deeperspeed_tpu.initialize(
        model=_ref_loss(rattn),
        model_parameters=jax.tree.map(jnp.asarray, tree), config=config,
        mesh=mesh)
    jl = [float(jeng.train_batch(batch)) for _ in range(STEPS)]

    tconfig = dict(config, kernels={"mode": "fused"})
    with kc.override():
        teng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=_port_loss(pattn),
            model_parameters=jax.tree.map(torch.tensor, tree),
            config=tconfig, device="cpu")
        fwd0, bwd0 = block_sparse.sparse_fwd.launches, \
            block_sparse.sparse_bwd.launches
        tl = [float(teng.train_batch(batch)) for _ in range(STEPS)]
        norms = [teng.get_global_grad_norm()]
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[-1] < tl[0]
    assert teng.skipped_steps == 0 and all(np.isfinite(norms))
    # the CPU takes the plain versions: the wrappers count no launch
    assert block_sparse.sparse_fwd.launches == fwd0
    assert block_sparse.sparse_bwd.launches == bwd0
    if precision == "bf16":
        assert teng.master is None
        assert teng.params["layer00"]["attn"]["query"]["w"].dtype == \
            torch.bfloat16
