"""The port's streamed offload engine against the reference's and against
the port's monolithic path.

Profile of the cross-package runs: wire_bits 32, resident_bits 16, fp32
host state in RAM (the deterministic wire: no stochastic rounding), the
same params and batches, three steps. Tolerances: losses within rtol
1e-5, the fp32 masters (``master_params_f32``) within relative L2 1e-5
(the two frameworks sum the same products in different orders, and the
native Adam contracts into FMAs where numpy rounds twice). The bf16 wire
(wire_bits 16) rounds each grad to bf16 on the card, where one rounding
difference moves a whole bf16 ulp: losses within rtol 1e-4, masters
within relative L2 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models.gpt import make_gpt as jax_make_gpt
from deeperspeed_tpu_torch.models import convert
from deeperspeed_tpu_torch.models.gpt import make_gpt
from torch_streaming_common import (batch, jax_cfg, jax_engine, params_np,
                                    port_engine, rel_l2, scfg, streaming,
                                    tiny_cfg)

TOL = {32: (1e-5, 1e-5), 16: (1e-4, 1e-4)}


def _run_both(wire_bits, native, steps=3, **kw):
    sc = scfg(wire_bits=wire_bits, warmup_steps=0, lr=1e-3,
              use_native_host=native)
    params = params_np(**kw)
    ours = port_engine(tiny_cfg(**kw), sc, params)
    ref = jax_engine(jax_cfg(**kw), sc, params)
    toks = batch(seed=4, n=steps)
    return ours, ref, [ours.train_batch(t) for t in toks], \
        [ref.train_batch(t) for t in toks]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("wire_bits", [32, 16])
def test_engine_matches_reference(wire_bits, native):
    loss_rtol, master_rel = TOL[wire_bits]
    ours, ref, lo, lr_ = _run_both(wire_bits, native)
    np.testing.assert_allclose(lo, lr_, rtol=loss_rtol)
    om, rm = ours.master_params_f32(), ref.master_params_f32()
    for c in ref.chunk_names:
        assert rel_l2(om[c], rm[c]) <= master_rel, c
    # the wide wires run the numpy codec in both packages; the Adam is the
    # native library's (ds_adam_step) unless use_native_host is off
    assert set(ours.host_routes.values()) == {"numpy"}
    assert ours.opt.has_native == native


def test_engine_matches_reference_untied_learned_positions():
    ours, ref, lo, lr_ = _run_both(32, False, rotary=False,
                                   tie_embeddings=False,
                                   parallel_residual=False)
    np.testing.assert_allclose(lo, lr_, rtol=1e-5)
    om, rm = ours.master_params_f32(), ref.master_params_f32()
    for c in ref.chunk_names:
        assert rel_l2(om[c], rm[c]) <= 1e-5, c


@pytest.mark.parametrize("kw", [dict(), dict(rotary=False,
                                             tie_embeddings=False,
                                             parallel_residual=False)])
def test_streamed_grads_match_monolithic(kw):
    """The grads the wire carries equal the port's make_gpt autograd grads
    at the same bf16-rounded point (the reference's
    test_streamed_grads_match_monolithic, its tolerances)."""
    cfg = tiny_cfg(**kw)
    sc = scfg(wire_bits=32, warmup_steps=0, lr=0.0)
    params = params_np(**kw)
    eng = port_engine(cfg, sc, params)
    eng.capture_grads = True
    tokens = batch()[0]
    loss = eng.train_batch(tokens)
    tparams = convert.from_jax_params(params, cfg, "cpu")
    tparams = streaming.tree_map(
        lambda t: t.to(torch.bfloat16).float().requires_grad_(True), tparams)
    _, _, loss_fn, _ = make_gpt(cfg)
    ref_loss = loss_fn(tparams, torch.from_numpy(tokens).long())
    ref_loss.backward()
    assert abs(loss - float(ref_loss.detach())) < 1e-4
    _, ref_chunks = eng._chunk(streaming.tree_map(lambda t: t.grad,
                                                  tparams))
    for cname, ref in ref_chunks.items():
        # one bf16 ulp at the grads' output; the tied wte grad sums a
        # bf16 head part with the fp32 embedding scatter
        atol = 5e-4 if cname == "globals" else 2e-5
        np.testing.assert_allclose(eng.last_grads[cname], ref, rtol=1e-2,
                                   atol=atol, err_msg=cname)


def test_streamed_loss_matches_reference_monolithic():
    """The first step's loss is the reference's monolithic loss at the
    bf16-rounded params (both packages hold bf16 params on the card)."""
    cfg = jax_cfg()
    params = params_np()
    eng = port_engine(tiny_cfg(), scfg(wire_bits=32, lr=0.0), params)
    tokens = batch(seed=2)[0]
    loss = eng.train_batch(tokens)
    params_bf = jax.tree.map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32),
        params)
    _, _, loss_fn, _ = jax_make_gpt(cfg)
    assert abs(loss - float(loss_fn(params_bf, jnp.asarray(tokens)))) < 1e-5


def test_lr_zero_leaves_params_untouched():
    eng = port_engine(tiny_cfg(), scfg(group_layers=1, wire_bits=32,
                                       warmup_steps=0, lr=0.0), params_np())
    before = {c: eng._shadow[c].copy() for c in eng.chunk_names}
    eng.train_batch(batch()[0])
    for c in eng.chunk_names:
        np.testing.assert_array_equal(eng._shadow[c], before[c])
    assert all(eng.shadow_matches_device().values())


def test_timings_and_batch_shape():
    eng = port_engine(tiny_cfg(), scfg(wire_bits=8), params_np())
    eng.train_batch(batch()[0])
    for k in ("compute_s", "d2h_s", "h2d_s", "host_opt_s",
              "initial_upload_s"):
        assert eng.timings[k] >= 0.0
    with pytest.raises(ValueError, match="seq\\+1"):
        eng.train_batch(np.zeros((2, 5), np.int32))
    assert eng.step_count == 1


def test_eval_batch_is_the_step_loss_without_the_step():
    eng = port_engine(tiny_cfg(), scfg(wire_bits=8, warmup_steps=0,
                                       lr=1e-2), params_np())
    tok = batch(seed=8)[0]
    before = {c: eng._shadow[c].copy() for c in eng.chunk_names}
    loss = eng.eval_batch(tok)
    assert eng.step_count == 0
    for c in eng.chunk_names:
        np.testing.assert_array_equal(eng._shadow[c], before[c])
    assert eng.train_batch(tok) == loss
    assert eng.eval_batch(tok) != loss   # the step moved the params
