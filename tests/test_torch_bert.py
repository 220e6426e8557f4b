"""The PyTorch port's BERT (models/bert.py) against the JAX reference's,
in fp32, from one set of weights carried across with
``convert.from_jax_bert_params``: the encoder's sequence and pooled
outputs, the MLM loss (chunked streaming cross-entropy, the scored-row
gather, every remat policy) and its gradients, and the SQuAD span loss.

Both run the "kernels" block at mode ``fused``: the reference its Pallas
kernels in interpret mode, the port its kernel wrappers' plain
versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import bert as jax_bert
from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu.utils import hooks as jax_hooks
from deeperspeed_tpu_torch.models import bert, convert
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.utils import hooks

torch.set_num_threads(1)

KW = dict(vocab_size=97, n_layer=2, n_head=4, d_model=32, max_seq=64)
B, S = 2, 64
TOL = 1e-4  # fp32 on both sides


def _models(qa=False, **kw):
    args = dict(KW, **kw)
    jcfg = jax_bert.BertConfig(**args, dtype=jnp.float32)
    tcfg = bert.BertConfig(**args, dtype=torch.float32)
    make_j = jax_bert.make_bert_qa if qa else jax_bert.make_bert
    make_t = bert.make_bert_qa if qa else bert.make_bert
    jinit, japply, jloss, _ = make_j(jcfg)
    _, tapply, tloss, _ = make_t(tcfg)
    jparams = jinit(jax.random.PRNGKey(0))
    # nonzero biases and LN affine, so every parameter's gradient is tested
    rs = np.random.RandomState(9)
    jparams = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rs.randn(*a.shape).astype(
            np.float32), jparams)
    tparams = convert.from_jax_bert_params(jparams, tcfg, "cpu")
    return jparams, japply, jloss, tcfg, tparams, tapply, tloss


def _batch(seed=0, masked=False):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 97, (B, S)).astype(np.int32)
    labels = np.where(rs.rand(B, S) < 0.15, ids, -100).astype(np.int32)
    batch = [ids, labels]
    if masked:
        m = np.ones((B, S), np.int32)
        m[0, 50:] = 0
        batch.append(m)
    return batch


def _leaves(tree):
    out = []
    for v in tree.values():
        out += _leaves(v) if isinstance(v, dict) else [v]
    return out


def _grad_pair(jloss, jparams, tloss, tparams, batch):
    """(reference loss, port loss, [(port grad, reference grad)])."""
    with jax_kc.override(mode="fused"):
        jl, jg = jax.value_and_grad(jloss)(
            jparams, tuple(jnp.asarray(b) for b in batch))
    leaves = _leaves(tparams)
    for t in leaves:
        t.requires_grad_()
    with kc.override(mode="fused"):
        tl = tloss(tparams, tuple(torch.from_numpy(b) for b in batch))
        tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    pairs = [(torch.zeros_like(p) if g is None else g, np.asarray(r))
             for p, g, r in zip(leaves, tg, _leaves(jg))]
    return float(jl), float(tl.detach()), pairs


def test_bert_apply_matches_reference():
    """Sequence and pooled outputs with token types, no mask (the
    super-tile path; the masked, dense path is held through the MLM loss
    below)."""
    jparams, japply, _, _, tparams, tapply, _ = _models()
    ids, _ = _batch(1)
    tt = np.random.RandomState(2).randint(0, 2, (B, S)).astype(np.int32)
    with jax_kc.override(mode="fused"):
        jseq, jpool = japply(jparams, jnp.asarray(ids), jnp.asarray(tt))
    with kc.override(mode="fused"):
        tseq, tpool = tapply(tparams, torch.from_numpy(ids),
                             torch.from_numpy(tt))
    np.testing.assert_allclose(tseq.detach().numpy(), np.asarray(jseq),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tpool.detach().numpy(), np.asarray(jpool),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("variant", [
    dict(remat_policy="full", ce_chunk=16, masked=True),
    dict(remat_policy="matmuls", ce_chunk=0),
    dict(remat_policy="dots_all", ce_chunk=32, pre_layer_norm=True),
    dict(remat=False, ce_chunk=16, mlm_gather_frac=0.5),
])
def test_bert_mlm_loss_and_grads_match_reference(variant):
    variant = dict(variant)
    masked = variant.pop("masked", False)
    jparams, _, jloss, _, tparams, _, tloss = _models(**variant)
    jl, tl, pairs = _grad_pair(jloss, jparams, tloss, tparams,
                               _batch(3, masked))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    for i, (g, r) in enumerate(pairs):
        np.testing.assert_allclose(g.numpy(), r, atol=TOL, rtol=TOL,
                                   err_msg=f"leaf {i}")


def test_bert_mlm_gather_reports_dropped_positions():
    """With a cut below the scored count, the loss is the reference's and
    the "mlm_dropped" tap reports how many positions went unscored."""
    jparams, _, jloss, _, tparams, _, tloss = _models(mlm_gather_frac=0.05)
    # 4 x 64 rows, 3 in 4 scored: the head keeps the first 128 of 192
    ids = np.random.RandomState(4).randint(0, 97, (4, S)).astype(np.int32)
    labels = np.where(np.arange(4 * S).reshape(4, S) % 4 != 0, ids,
                      -100).astype(np.int32)
    jc = jax_hooks.LayerOutputCollector()
    jax_hooks.set_active(jc)
    try:
        with jax_kc.override(mode="fused"):
            jl = float(jloss(jparams, (jnp.asarray(ids),
                                       jnp.asarray(labels))))
    finally:
        jax_hooks.set_active(None)
    tc = hooks.LayerOutputCollector(layer_name_pattern="mlm")
    hooks.set_active(tc)
    try:
        with kc.override(mode="fused"):
            tl = float(tloss(tparams, (torch.from_numpy(ids),
                                       torch.from_numpy(labels))))
    finally:
        hooks.set_active(None)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    n_scored = int((labels != -100).sum())
    assert tc.layer_outputs["mlm_dropped"][0] == n_scored - 128
    assert int(jc.layer_outputs["mlm_dropped"][0]) == n_scored - 128
    assert "bertlayer" not in tc.layer_outputs


def test_layer_output_tap_collects_each_layer():
    _, _, _, tcfg, tparams, tapply, _ = _models()
    ids, _ = _batch(5)
    assert not hooks.capture_active()
    c = hooks.LayerOutputCollector()
    hooks.set_active(c)
    try:
        seq, _ = tapply(tparams, torch.from_numpy(ids))
    finally:
        hooks.set_active(None)
    outs = c.layer_outputs["bertlayer"]
    assert len(outs) == tcfg.n_layer
    np.testing.assert_array_equal(outs[-1], seq.detach().numpy())


def test_bert_qa_loss_and_grads_match_reference():
    jparams, _, jloss, tcfg, tparams, _, tloss = _models(qa=True)
    assert set(tparams["qa"]) == {"w", "b"}
    ids, _, mask = _batch(6, masked=True)
    rs = np.random.RandomState(7)
    start = rs.randint(0, 40, (B,)).astype(np.int32)
    end = rs.randint(0, 40, (B,)).astype(np.int32)
    jl, tl, pairs = _grad_pair(jloss, jparams, tloss, tparams,
                               [ids, start, end, mask])
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    for i, (g, r) in enumerate(pairs):
        np.testing.assert_allclose(g.numpy(), r, atol=TOL, rtol=TOL,
                                   err_msg=f"leaf {i}")
    init_fn = bert.make_bert_qa(tcfg)[0]
    fresh = init_fn(0, device="cpu")
    assert fresh["qa"]["w"].shape == (KW["d_model"], 2)


def test_bert_config_and_init_match_reference():
    for bad in (dict(remat_policy="flash"), dict(mlm_gather_frac=1.5)):
        with pytest.raises(ValueError):
            jax_bert.BertConfig(**bad)
        with pytest.raises(ValueError):
            bert.BertConfig(**bad)
    cfg = bert.BertConfig(**KW, dtype=torch.float32)
    jcfg = jax_bert.BertConfig(**KW, dtype=jnp.float32)
    ours = bert.init_params(0, cfg, device="cpu")
    ref = jax_bert.init_params(jax.random.PRNGKey(0), jcfg)
    flat_o = convert._flatten(ours)
    flat_r = convert._flatten(jax.tree.map(np.asarray, ref))
    assert set(flat_o) == set(flat_r)
    for k in flat_r:
        assert tuple(flat_o[k].shape) == flat_r[k].shape, k
        # the same init scales: the draws differ, the spreads agree
        np.testing.assert_allclose(float(flat_o[k].std()),
                                   float(flat_r[k].std()), rtol=0.2,
                                   atol=1e-6, err_msg=k)
    specs = bert.param_specs(cfg)
    assert specs["layers"]["attn_qkvw"] == (None, None, "model")
    assert set(convert._flatten(specs)) == set(flat_r)


def test_bert_entry_points_default_to_cuda_and_import_no_jax():
    """init_fn, the transformer layer's init and initialize take CUDA
    unless the caller names the CPU; the new modules load no JAX."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would take it")
    from deeperspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)

    cfg = bert.BertConfig(**KW, dtype=torch.float32)
    with pytest.raises(RuntimeError):
        bert.make_bert(cfg)[0](0)
    layer = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
        hidden_size=32, heads=4))
    with pytest.raises(RuntimeError):
        layer.init(0)
    assert layer.init(0, device="cpu")["attn_qkvw"].device.type == "cpu"
    code = ("import json, sys\n"
            "import deeperspeed_tpu_torch.models.bert, deeperspeed_tpu_torch"
            ".ops.lamb, deeperspeed_tpu_torch.ops.flash_static, "
            "deeperspeed_tpu_torch.utils.hooks, deeperspeed_tpu_torch.ops."
            "transformer\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deeperspeed_tpu_torch.models.bert" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib")
                or m == "deeperspeed_tpu" or m.startswith("deeperspeed_tpu.")]
