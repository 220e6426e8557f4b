"""Speculative decoding in the PyTorch port's serving engine
(serving/spec/) against the JAX reference's on the same fp32 weights:
``paged_attend_multi`` within 1e-5 of the reference's on the same pools,
tables and write targets; the truncated drafter a view of the target's
tensors; greedy spec output equal to the port's plain decode and to the
reference's spec engine, cold, over a prefix-cache hit and under chunked
prefill; sampled spec output equal to the port's plain sampled output; EOS
mid-draft, single-token requests, drafter-pool backpressure and drafter
swaps; exactly three decode-path signatures; and the spec/* instants,
strict-valid and counted exactly by the request ledger."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.serving import ServingConfig as JaxServingConfig
from deeperspeed_tpu.serving import ServingEngine as JaxServingEngine
from deeperspeed_tpu.serving import kv_cache as jax_kv
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.monitor import shutdown_monitor
from deeperspeed_tpu_torch.monitor.reqledger import (build_index,
                                                     build_ledger,
                                                     request_cost)
from deeperspeed_tpu_torch.monitor.validate import (validate_events,
                                                    validate_file)
from deeperspeed_tpu_torch.serving import ServingConfig, ServingEngine
from deeperspeed_tpu_torch.serving.config import SpeculativeConfig
from deeperspeed_tpu_torch.serving.kv_cache import paged_attend_multi
from deeperspeed_tpu_torch.serving.spec.runtime import truncated_drafter

torch.set_num_threads(1)

KW = dict(vocab_size=97, n_layer=2, n_head=2, d_model=32, max_seq=128,
          remat=False, attn_impl="xla")


def _pair(seed):
    jcfg = jax_gpt.GPTConfig(**KW, dtype=jnp.float32)
    jparams = jax_gpt.make_gpt(jcfg)[0](jax.random.PRNGKey(seed))
    tcfg = gpt.GPTConfig(**KW, dtype=torch.float32)
    numpy_params = jax.tree.map(np.asarray, jparams)
    return (jcfg, jparams, tcfg,
            convert.from_jax_params(numpy_params, tcfg, "cpu"), numpy_params)


@pytest.fixture(scope="module")
def model():
    return _pair(0)


_SPEC = {"draft_k": 3, "drafter": {"n_layer": 1}}


def _scfg(spec=_SPEC, **kw):
    d = dict(num_slots=2, block_size=4, num_blocks=64, max_seq_len=128,
             prefill_buckets=(4, 8, 16, 32, 64, 128))
    d.update(kw)
    if spec is not None:
        d["speculative"] = dict(spec)
    return d


def _engine(model, spec=_SPEC, **kw):
    _, _, tcfg, tparams, _ = model
    return ServingEngine(tcfg, tparams, ServingConfig(**_scfg(spec, **kw)),
                         device="cpu")


def _jax_engine(model, spec=_SPEC, **kw):
    jcfg, jparams, _, _, _ = model
    return JaxServingEngine(jcfg, jparams,
                            JaxServingConfig(**_scfg(spec, **kw)))


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, 97, (n,)).tolist()


def _serve(eng, prompts, new, **kw):
    rids = [eng.submit(p, max_new_tokens=new, **kw) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


# ------------------------------------------------------------------ #
# the verify step's attention core
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_paged_attend_multi_matches_reference(hq, hkv):
    """Same pools, tables, lengths and write targets (an idle lane on
    the null block, a slot over two non-contiguous blocks): the same
    context and the same pools after the writes."""
    rs = np.random.RandomState(hq + hkv)
    nb, bs, dh, T = 12, 4, 8, 3
    k_pool = rs.randn(nb, bs, hkv, dh).astype(np.float32)
    v_pool = rs.randn(nb, bs, hkv, dh).astype(np.float32)
    q = rs.randn(3, T, hq, dh).astype(np.float32)
    k_new = rs.randn(3, T, hkv, dh).astype(np.float32)
    v_new = rs.randn(3, T, hkv, dh).astype(np.float32)
    tables = np.array([[5, 2, 9, 0], [7, 3, 0, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([6, 2, 0], np.int32)
    pos = lengths[:, None] + np.arange(T)[None]
    wblk = np.take_along_axis(tables, pos // bs, axis=1)
    woff = (pos % bs).astype(np.int32)
    ctx_j, kj, vj = jax_kv.paged_attend_multi(
        jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(q),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(wblk), jnp.asarray(woff))
    kt, vt = torch.tensor(k_pool), torch.tensor(v_pool)
    ctx_t = paged_attend_multi(
        kt, vt, torch.tensor(q), torch.tensor(k_new), torch.tensor(v_new),
        torch.tensor(tables).long(), torch.tensor(lengths).long(),
        torch.tensor(wblk).long(), torch.tensor(woff).long())
    # lanes 0 and 1 hold real context; lane 2 is idle (its output is
    # ignored by the engine, and its null-block writes race)
    np.testing.assert_allclose(ctx_t.numpy()[:2], np.asarray(ctx_j)[:2],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(kt.numpy()[1:], np.asarray(kj)[1:])
    np.testing.assert_array_equal(vt.numpy()[1:], np.asarray(vj)[1:])


# ------------------------------------------------------------------ #
# config plumbing and the drafter
# ------------------------------------------------------------------ #


def test_speculative_config_block():
    scfg = ServingConfig.from_dict(
        {"speculative": {"draft_k": 2, "drafter": {"n_layer": 1}}})
    assert isinstance(scfg.speculative, SpeculativeConfig)
    assert scfg.speculative.draft_k == 2
    assert ServingConfig.from_dict({}).speculative is None
    with pytest.raises(ValueError, match="unknown speculative"):
        ServingConfig.from_dict({"speculative": {"k_draft": 2}})
    with pytest.raises(ValueError, match="draft_k"):
        SpeculativeConfig(draft_k=0)


def test_truncated_drafter_views_target_params(model):
    _, _, tcfg, tparams, _ = model
    dcfg, dparams = truncated_drafter(tcfg, tparams, 1)
    assert dcfg.n_layer == 1
    # a view, not a copy: the drafter rides the target's storage
    for key in ("ln1_scale", "ln2_bias"):
        d, t = dparams["layers"][key], tparams["layers"][key]
        assert d.shape[0] == 1 and d.data_ptr() == t.data_ptr()
    d, t = dparams["layers"]["mlp"]["wi"], tparams["layers"]["mlp"]["wi"]
    assert d.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
    assert dparams["embed"]["wte"] is tparams["embed"]["wte"]
    assert dparams["final_ln"] is tparams["final_ln"]
    with pytest.raises(ValueError, match="n_layer"):
        truncated_drafter(tcfg, tparams, 5)
    eng = _engine(model)
    assert (eng._spec.dparams["layers"]["attn"]["wqkv"].data_ptr()
            == eng.params["layers"]["attn"]["wqkv"].data_ptr())


def test_plain_engine_without_spec_block_is_untouched(model):
    eng = _engine(model, spec=None)
    assert eng._spec is None
    assert eng.draft_compile_count == -1
    assert eng.verify_compile_count == -1
    with pytest.raises(RuntimeError, match="not enabled"):
        eng.set_drafter_params({})


# ------------------------------------------------------------------ #
# greedy spec == plain greedy == the reference's spec engine
# ------------------------------------------------------------------ #


def test_greedy_spec_identical_to_plain_and_reference_cold(model):
    prompts = [_prompt(9, 1), _prompt(17, 2), _prompt(30, 3)]
    plain = _serve(_engine(model, spec=None), prompts, 20)
    eng = _engine(model)
    out = _serve(eng, prompts, 20)
    assert out == plain
    assert out == _serve(_jax_engine(model), prompts, 20)
    assert eng.metrics.spec_rounds > 0 and eng.metrics.spec_drafted > 0


@pytest.mark.parametrize("draft_k,n_layer", [(3, 1), (2, 2)])
def test_greedy_acceptance_counts_match_the_reference(model, draft_k,
                                                      n_layer):
    """Acceptance held against the reference: on the same fp32 weights,
    with a truncated drafter, both packages' engines report the same
    rounds, drafted and accepted counts, not only the same tokens."""
    spec = {"draft_k": draft_k, "drafter": {"n_layer": n_layer}}
    prompts = [_prompt(9, 21), _prompt(17, 22)]
    counts = []
    for eng in (_engine(model, spec=spec), _jax_engine(model, spec=spec)):
        out = _serve(eng, prompts, 16)
        m = eng.metrics
        counts.append((out, m.spec_rounds, m.spec_drafted, m.spec_accepted))
    assert counts[0] == counts[1]
    assert counts[0][2] > 0
    if n_layer == 2:  # the drafter is the whole target: all accepted
        assert counts[0][3] == counts[0][2]


def test_greedy_spec_cache_hit_identical_to_miss(model):
    """A spec request admitted over shared radix blocks (drafter synced
    from its own prefix index) emits the cold plain greedy stream."""
    sys_p = _prompt(14, 7)
    p1, p2 = sys_p + _prompt(5, 8), sys_p + _prompt(9, 9)
    ref = _serve(_engine(model, spec=None), [p1, p2], 12)
    outs = {}
    for name, eng in (("port", _engine(model, prefix_caching=True)),
                      ("jax", _jax_engine(model, prefix_caching=True))):
        h1 = eng.submit(p1, max_new_tokens=12)
        eng.run()                                   # indexes p1
        h2 = eng.submit(p2, max_new_tokens=12)      # hits the prefix
        out = eng.run()
        assert eng.metrics.reuse_hits == 1
        outs[name] = [eng.get(h1).output, out[h2]]
    assert outs["port"] == ref == outs["jax"]
    assert eng.metrics.spec_rounds > 0


def test_greedy_spec_chunked_prefill_identical_to_unchunked(model):
    prompts = [_prompt(37, 2), _prompt(18, 3), _prompt(61, 4)]
    ref = _serve(_engine(model, spec=None), prompts, 10)
    eng = _engine(model, prefill_chunk=16, prefill_token_budget=32)
    assert _serve(eng, prompts, 10) == ref
    assert eng.metrics.prefill_chunks > 0
    assert eng.metrics.spec_rounds > 0
    assert _serve(_jax_engine(model, prefill_chunk=16,
                              prefill_token_budget=32), prompts, 10) == ref


def test_sampled_spec_identical_to_plain(model):
    """The matched-key contract end to end: drafter and target draw with
    the same (seed, output index) keys, so the sampled stream is the one
    plain decode emits, for any drafter."""
    prompts = [_prompt(8, 11), _prompt(21, 12), _prompt(13, 13)]
    temps = [0.7, 1.0, 0.9]
    outs = []
    for spec in (None, _SPEC):
        eng = _engine(model, spec=spec)
        for i, (p, t) in enumerate(zip(prompts, temps)):
            eng.submit(p, max_new_tokens=18, temperature=t,
                       request_id=f"s{i}")
        out = eng.run()
        outs.append([out[f"s{i}"] for i in range(3)])
    assert outs[0] == outs[1]
    assert eng.metrics.spec_rounds > 0
    # drafter layer 0 is the target's own first layer: some draws agree
    assert eng.metrics.spec_accepted > 0


def test_spec_respects_eos_mid_draft(model):
    """An EOS inside the accepted window truncates the emission exactly
    where plain decode stops."""
    prompt = _prompt(10, 21)
    plain = _engine(model, spec=None, eos_token_id=3)
    r = plain.submit(prompt, max_new_tokens=40)
    ref = plain.run()[r]
    eng = _engine(model, eos_token_id=3)
    h = eng.submit(prompt, max_new_tokens=40)
    assert eng.run()[h] == ref
    assert eng.get(h).finish_reason == plain.get(r).finish_reason


# ------------------------------------------------------------------ #
# three signatures, fallback eligibility, backpressure, drafter swaps
# ------------------------------------------------------------------ #


def test_exactly_three_decode_path_signatures(model):
    """Mixed traffic (greedy and sampled, short and long, early-finishing
    lanes) keeps the decode path at one signature per step."""
    eng = _engine(model, num_slots=4)
    eng.submit(_prompt(6, 30), max_new_tokens=24)
    eng.submit(_prompt(40, 31), max_new_tokens=6)
    eng.submit(_prompt(12, 32), max_new_tokens=16, temperature=0.8)
    eng.submit(_prompt(25, 33), max_new_tokens=1)    # never speculates
    eng.run()
    assert eng.decode_compile_count == 1      # the fallback step
    assert eng.draft_compile_count == 1
    assert eng.verify_compile_count == 1
    assert eng.metrics.spec_fallback_lanes >= 1


def test_single_token_requests_never_speculate(model):
    prompt = _prompt(11, 40)
    ref = _serve(_engine(model, spec=None), [prompt], 1)
    eng = _engine(model)
    assert _serve(eng, [prompt], 1) == ref
    assert eng.metrics.spec_drafted == 0      # every lane fell back


def test_drafter_pool_backpressure_falls_back_not_fails(model):
    """A drafter pool too small to mirror the context: the slot decodes
    on the plain step every round, the same tokens, and the drafter pool
    never leaks."""
    prompt = _prompt(30, 41)                   # needs 8 drafter blocks
    ref = _serve(_engine(model, spec=None), [prompt], 16)
    eng = _engine(model, spec=dict(_SPEC, num_blocks=3))   # 8 rows
    assert _serve(eng, [prompt], 16) == ref
    assert eng.metrics.spec_drafted == 0
    assert eng.metrics.spec_fallback_lanes > 0
    assert eng._spec.kv.allocator.num_allocated == 0


def test_drafter_swap_mid_stream_resyncs_and_stays_identical(model):
    """set_drafter_params mid-decode: slot mirrors drop, resync lazily,
    and the greedy stream is untouched. The new drafter comes in the
    reference's numpy layout (explicit drafter params through
    models/convert)."""
    prompts = [_prompt(9, 50), _prompt(22, 51)]
    ref = _serve(_engine(model, spec=None), prompts, 24)
    eng = _engine(model)
    rids = [eng.submit(p, max_new_tokens=24) for p in prompts]
    for _ in range(4):
        if eng.has_work():
            eng.step()
    before = eng.metrics.spec_drafter_prefills
    alt = _pair(9)[4]
    alt["layers"] = jax.tree.map(lambda a: a[:1], alt["layers"])
    eng.set_drafter_params(alt)
    assert isinstance(eng._spec.dparams["layers"]["mlp"]["wi"], torch.Tensor)
    out = eng.run()
    assert [out[r] for r in rids] == ref
    # the swap dropped every slot mirror: at least one resync prefill
    assert eng.metrics.spec_drafter_prefills > before


def test_explicit_drafter_params_need_a_drafter_config(model):
    _, _, tcfg, tparams, numpy_params = model
    with pytest.raises(ValueError, match="drafter"):
        ServingEngine(tcfg, tparams,
                      ServingConfig(**_scfg({"draft_k": 2})),
                      device="cpu", drafter_params=numpy_params)
    bad = dict(_SPEC, drafter={"n_layer": 1, "vocab_size": 64})
    with pytest.raises(ValueError, match="n_layer"):
        _engine(model, spec=bad)


# ------------------------------------------------------------------ #
# observability: strict schemas and ledger token exactness
# ------------------------------------------------------------------ #


def _inst(name, ts, **args):
    return {"name": name, "ph": "i", "ts": float(ts), "pid": 1, "tid": 0,
            "s": "p", "args": args}


def _span(name, ts, dur, **args):
    return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
            "pid": 1, "tid": 0, "args": args}


def test_spec_instants_strict_schemas():
    good = [
        _inst("spec/draft", 10, n_active=2, k=3, dur_us=120.0),
        _inst("spec/verify", 20, n_active=2, k=3, dur_us=340.0),
        _inst("spec/accept", 30, rid="A", accepted=2, k=3, emitted=3),
    ]
    assert validate_events(good, strict=True) == []
    errors = validate_events(
        [_inst("spec/accept", 30, rid="A", accepted=2, k=3)])
    assert len(errors) == 1 and "emitted" in errors[0]


def test_ledger_counts_spec_emission_exactly():
    """One decode span emits ``emitted`` tokens, not 1: request_cost must
    match the finish event's token count exactly."""
    events = [
        _inst("req/submit", 0, rid="A", prompt_len=8),
        _inst("serving/admit", 1000, rid="A", slot=0, ctx_len=8,
              admissions=1),
        _span("serving/prefill", 1000, 2000, rid="A", ctx_len=8),
        _span("serving/decode", 3000, 900, rids="A", n_active=1),
        _inst("spec/draft", 3100, n_active=1, k=3, dur_us=300.0),
        _inst("spec/verify", 3500, n_active=1, k=3, dur_us=400.0),
        _inst("spec/accept", 3900, rid="A", accepted=2, k=3, emitted=3),
        _inst("serving/finish", 4000, rid="A", reason="length", tokens=4,
              kv_block_s=0.01, admissions=1),
    ]
    idx = build_index(events)
    cost = request_cost(idx, idx.timelines["A"])
    assert cost["tokens_final"] == 4 == cost["finish_tokens_reported"]
    assert cost["spec_rounds"] == 1
    assert cost["spec_accept_rate"] == pytest.approx(2 / 3)
    sp = build_ledger(events)["speculative"]
    assert sp["rounds"] == 1 and sp["drafted"] == 3 and sp["accepted"] == 2
    assert sp["draft_ms"] == pytest.approx(0.3)
    assert sp["verify_ms"] == pytest.approx(0.4)


def test_engine_trace_events_validate_strict(model, tmp_path):
    """A spec engine under the monitor with a strict watchdog: every
    event, the spec/* instants included, passes the strict validator, the
    ledger counts every emitted token, and no step met a second
    signature."""
    _, _, tcfg, tparams, _ = model
    trace = str(tmp_path / "spec_trace.json")
    eng = ServingEngine(tcfg, tparams, ServingConfig(**_scfg()),
                        device="cpu",
                        monitor_config={"trace_path": trace,
                                        "watchdog": "strict"})
    try:
        rids = [eng.submit(_prompt(10, 60), max_new_tokens=12),
                eng.submit(_prompt(18, 61), max_new_tokens=12,
                           temperature=0.7)]
        eng.run()
        assert eng.telemetry.watchdog.fired == []
    finally:
        shutdown_monitor(save=True)
    assert validate_file(trace, strict=True) == []
    ledger = build_ledger(trace)
    assert ledger["speculative"]["rounds"] > 0
    assert sorted(ledger["requests"]) == sorted(rids)
    for rid in rids:
        cost = ledger["requests"][rid]["cost"]
        assert cost["tokens_final"] == 12 == cost["finish_tokens_reported"]
