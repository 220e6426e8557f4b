"""The PyTorch port's continuous-batching ServingEngine against the JAX
reference's ServingEngine on the same fp32 weights: greedy outputs
token-identical under staggered arrivals, preemption, EOS/length/timeout
eviction and prefix caching with chunked prefill; the same config errors
and the same allocator / radix-cache state; and sampled tokens that are a
pure function of (seed, token index) inside the port."""

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
from deeperspeed_tpu_torch.serving import (
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_TIMEOUT,
    BlockAllocator,
    PrefixCache,
    ServingConfig,
    ServingEngine,
    request_sample_key,
)
from deeperspeed_tpu_torch.serving.kv_cache import OutOfBlocks

torch.set_num_threads(1)

KW = dict(vocab_size=97, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
          max_seq=128, rotary=True, parallel_residual=True)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_gpt.GPTConfig(**KW, remat=False, dtype=jnp.float32,
                             attn_impl="xla")
    jparams = jax_gpt.make_gpt(jcfg)[0](jax.random.PRNGKey(0))
    tcfg = gpt.GPTConfig(**KW, remat=False, dtype=torch.float32,
                         attn_impl="xla")
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engines(models, clock=None, **scfg):
    jcfg, jparams, tcfg, tparams = models
    kw = {} if clock is None else {"clock": clock}
    return (JaxServingEngine(jcfg, jparams, JaxServingConfig(**scfg), **kw),
            ServingEngine(tcfg, tparams, ServingConfig(**scfg),
                          device="cpu", **kw))


def _prompts(lens, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 97, (n,)).tolist() for n in lens]


def _drive(eng, prompts, news, schedule):
    """Submit prompts in the waves ``schedule`` gives (counts per wave),
    stepping once between waves, then run to completion."""
    rids, i = [], 0
    for wave in schedule:
        for _ in range(wave):
            rids.append(eng.submit(prompts[i], max_new_tokens=news[i]))
            i += 1
        eng.step()
    outs = eng.run()
    return rids, outs


def _same_outcome(jeng, teng, jr, jo, tr, to):
    for a, b in zip(jr, tr):
        assert to[b] == jo[a], b
        assert teng.get(b).finish_reason == jeng.get(a).finish_reason
        assert teng.get(b).admissions == jeng.get(a).admissions
    js, ts = jeng.metrics.summary(), teng.metrics.summary()
    for key in ("requests_finished", "tokens_generated", "decode_steps",
                "prefills", "preemptions", "finish_reasons"):
        assert ts[key] == js[key], key


def test_staggered_arrivals_token_identical(models):
    prompts = _prompts([3, 5, 7, 9, 6], 0)
    news = [6, 9, 4, 7, 5]
    jeng, teng = _engines(models, num_slots=3, block_size=4, num_blocks=64,
                          max_seq_len=48)
    jr, jo = _drive(jeng, prompts, news, [2, 0, 2, 1])
    tr, to = _drive(teng, prompts, news, [2, 0, 2, 1])
    _same_outcome(jeng, teng, jr, jo, tr, to)
    assert all(teng.get(r).finish_reason == FINISH_LENGTH for r in tr)


def test_preemption_under_small_pool_token_identical(models):
    prompts = _prompts([7, 6, 5, 4], 2)
    news = [10, 9, 11, 8]
    jeng, teng = _engines(models, num_slots=4, block_size=4, num_blocks=8,
                          max_seq_len=20)
    jr, jo = _drive(jeng, prompts, news, [4])
    tr, to = _drive(teng, prompts, news, [4])
    assert teng.metrics.preemptions > 0
    _same_outcome(jeng, teng, jr, jo, tr, to)
    assert teng.kv.allocator.num_allocated == 0


def test_eos_eviction_token_identical(models):
    prompt = _prompts([6], 4)
    _, probe = _engines(models, num_slots=2, block_size=4, num_blocks=32,
                        max_seq_len=32)
    rid = probe.submit(prompt[0], max_new_tokens=12)
    eos = probe.run()[rid][4]
    jeng, teng = _engines(models, num_slots=2, block_size=4, num_blocks=32,
                          max_seq_len=32, eos_token_id=eos)
    jr, jo = _drive(jeng, prompt, [12], [1])
    tr, to = _drive(teng, prompt, [12], [1])
    _same_outcome(jeng, teng, jr, jo, tr, to)
    assert teng.get(tr[0]).finish_reason == FINISH_EOS
    assert to[tr[0]][-1] == eos and len(to[tr[0]]) <= 5


def test_timeout_evicts_queued_and_active(models):
    clk = FakeClock()
    _, eng = _engines(models, clock=clk, num_slots=1, block_size=4,
                      num_blocks=32, max_seq_len=32, request_timeout_s=5.0)
    p = _prompts([4, 4], 5)
    active = eng.submit(p[0], max_new_tokens=20)
    queued = eng.submit(p[1], max_new_tokens=20)
    eng.step()
    assert eng.get(active).state == "active"
    clk.t = 6.0
    done = eng.step()
    assert {r.rid for r in done} == {active, queued}
    assert eng.get(active).finish_reason == FINISH_TIMEOUT
    assert eng.get(queued).finish_reason == FINISH_TIMEOUT
    assert len(eng.get(active).output) >= 1
    assert eng.get(queued).output == []
    assert not eng.has_work() and eng.kv.allocator.num_allocated == 0


def test_prefix_caching_with_chunked_prefill_token_identical(models):
    shared = _prompts([37], 6)[0]
    tails = _prompts([3, 9, 20, 5], 7)
    prompts = [shared + t for t in tails] + _prompts([50], 8)
    news = [5, 6, 4, 7, 6]
    scfg = dict(num_slots=2, block_size=8, num_blocks=64, max_seq_len=96,
                prefix_caching=True, prefill_chunk=16,
                prefill_token_budget=32)
    jeng, teng = _engines(models, **scfg)
    jr, jo = _drive(jeng, prompts, news, [1, 2, 2])
    tr, to = _drive(teng, prompts, news, [1, 2, 2])
    _same_outcome(jeng, teng, jr, jo, tr, to)
    jp = jeng.metrics.summary()["prefix_reuse"]
    tp = teng.metrics.summary()["prefix_reuse"]
    assert tp["reuse_hits"] > 0 and tp["prefill_chunks"] > 0
    for key in ("admissions", "reuse_hits", "tokens_saved", "cow_splits",
                "prefill_chunks", "chunk_tokens", "prefill_tokens"):
        assert tp[key] == jp[key], key
    assert (teng.sched.prefix_cache.stats()
            == jeng.sched.prefix_cache.stats())


def test_drain_and_cancel(models):
    _, eng = _engines(models, num_slots=1, block_size=4, num_blocks=32,
                      max_seq_len=32)
    p = _prompts([4, 4, 4], 9)
    a = eng.submit(p[0], max_new_tokens=3)
    b = eng.submit(p[1], max_new_tokens=3)
    c = eng.submit(p[2], max_new_tokens=3)
    assert eng.cancel(c) and not eng.cancel(c) and not eng.cancel("nope")
    eng.step()                      # a holds the one slot, b waits
    assert eng.drain() == [b]
    assert eng.get(a).finish_reason == FINISH_LENGTH
    from deeperspeed_tpu_torch.serving import EngineDrainingError
    with pytest.raises(EngineDrainingError):
        eng.submit(p[0])


@pytest.mark.parametrize("bad", [
    {"num_slot": 2},
    {"num_slots": 0},
    {"num_blocks": 1},
    {"block_size": 4, "prefill_buckets": [6]},
    {"max_seq_len": 64, "prefill_buckets": [16, 32]},
    {"top_k": 0},
    {"prefill_chunk": 0},
    {"slo": {"ttft_p99_ms": -1}},
    {"fleet": {"retry_max": -1}},
    {"fleet": {"nope": 1}},
    {"speculative": {"draft_k": 0}},
])
def test_serving_config_errors_match_reference(bad):
    with pytest.raises(ValueError) as jerr:
        JaxServingConfig.from_dict(bad)
    with pytest.raises(ValueError) as terr:
        ServingConfig.from_dict(bad)
    assert str(terr.value) == str(jerr.value)


def test_serving_config_round_trip_matches_reference():
    d = {"enabled": True, "num_slots": 4, "block_size": 8, "num_blocks": 99,
         "max_seq_len": 100, "eos_token_id": 3, "top_k": 5,
         "prefill_chunk": 16, "prefix_caching": True,
         "slo": {"ttft_p99_ms": 50.0}, "fleet": {"num_replicas": 3}}
    j, t = JaxServingConfig.from_dict(d), ServingConfig.from_dict(d)
    assert t.prefill_buckets == j.prefill_buckets
    assert t.blocks_per_slot == j.blocks_per_slot
    assert t.prefill_plan(70, 20) == j.prefill_plan(70, 20)
    assert t.kv_pool_bytes(24, 16, 128) == j.kv_pool_bytes(24, 16, 128)


def test_engine_rejects_unported_paths(models):
    _, _, tcfg, tparams = models
    # the "speculative" block is served now (tests/test_torch_serving_spec.py
    # holds it to the reference): it builds a drafter instead of raising
    eng = ServingEngine(tcfg, tparams, {"speculative": {"draft_k": 2}},
                        device="cpu")
    assert eng._spec is not None and eng._spec.K == 2
    # tensor-parallel serving is ported (tests/test_torch_tp_serving.py);
    # splitting the slots over data ranks is not
    from deeperspeed_tpu_torch.parallel import build_mesh

    with pytest.raises(NotImplementedError, match="mesh"):
        ServingEngine(tcfg, tparams, None, device="cpu",
                      mesh=build_mesh({"data": 2}, world=2))


def _alloc_ops(alloc_cls, cache_cls, errors):
    a = alloc_cls(10)
    log = []
    x = a.alloc(3)
    y = a.alloc(2)
    a.ref(x[0])
    a.free(x)
    log.append(a.alloc(20))
    cache = cache_cls(a, 4)
    toks = list(range(11))
    log.append(cache.insert(toks, y + [a.alloc(1)[0]]))
    log.append(cache.match(toks[:9] + [99, 98]))
    log.append(cache.match(toks + [5]))
    log.append(cache.match([7, 7, 7]))
    log.append(a.alloc(7))          # reclaim evicts cache-only leaves
    with pytest.raises(errors):
        a.free([x[1]])
    log.append(cache.stats())
    return log, sorted(a._free), dict(a._refs), a.num_free


def test_allocator_and_prefix_cache_state_match_reference():
    assert (_alloc_ops(BlockAllocator, PrefixCache, OutOfBlocks)
            == _alloc_ops(jax_kv.BlockAllocator, jax_kv.PrefixCache,
                          jax_kv.OutOfBlocks))


def test_sampled_tokens_are_a_function_of_seed_and_index(models):
    g1 = request_sample_key(123, 4)
    g2 = request_sample_key(123, 4)
    assert torch.equal(torch.rand(8, generator=g1), torch.rand(8, generator=g2))
    assert not torch.equal(torch.rand(8, generator=request_sample_key(123, 5)),
                           torch.rand(8, generator=request_sample_key(123, 4)))
    p = _prompts([5, 7, 4], 10)
    scfg = dict(num_slots=3, block_size=4, num_blocks=64, max_seq_len=48,
                top_k=20)

    def run(prompts, waves, temps):
        _, eng = _engines(models, **scfg)
        rids, i = [], 0
        for wave in waves:
            for _ in range(wave):
                rids.append(eng.submit(prompts[i], max_new_tokens=8,
                                       temperature=temps[i], seed=11 + i))
                i += 1
            eng.step()
        outs = eng.run()
        return [outs[r] for r in rids]

    batched = run(p, [3], [0.9, 0.0, 1.3])
    # alone, or arriving later beside other traffic: the same tokens
    assert run(p[:1], [1], [0.9]) == batched[:1]
    assert run(p, [1, 1, 1], [0.9, 0.0, 1.3]) == batched
    # a greedy lane beside sampled ones is still the reference's
    jeng, _ = _engines(models, **scfg)
    rid = jeng.submit(p[1], max_new_tokens=8)
    assert jeng.run()[rid] == batched[1]


def test_config_file_blocks_load_like_the_reference(tmp_path):
    from deeperspeed_tpu.runtime.config_utils import load_config as jax_load
    from deeperspeed_tpu_torch.ops import kernel_config as kc
    from deeperspeed_tpu_torch.runtime.config_utils import load_config

    path = tmp_path / "ds.json"
    path.write_text('{"kernels": {"mode": "auto"}, "serving": '
                    '{"num_slots": 8, "block_size": 16, "num_blocks": 1024, '
                    '"max_seq_len": 1024}}')
    cfg = load_config(str(path))
    assert cfg == jax_load(str(path))
    assert load_config(path.read_text()) == cfg          # inline JSON too
    assert kc.validate(cfg["kernels"]) == {"mode": "auto"}
    scfg = ServingConfig.from_dict(cfg["serving"])
    assert (scfg.num_slots, scfg.num_blocks, scfg.blocks_per_slot) == \
        (8, 1024, 64)
    path.write_text('{"serving": {"num_slots": 2, "num_slots": 3}}')
    with pytest.raises(ValueError, match="Duplicate keys"):
        load_config(str(path))


def test_engine_emits_the_reference_trace_events(models):
    """With a tracer installed, both engines record the same serving
    span, instant and counter names, in the same order, for one workload
    (events outside the engine's namespaces, such as the reference's
    compile instants, are not compared)."""
    from deeperspeed_tpu.monitor import tracer as jax_tracer
    from deeperspeed_tpu_torch.monitor import tracer

    prompts = _prompts([3, 6, 5], 11)
    jeng, teng = _engines(models, num_slots=2, block_size=4, num_blocks=64,
                          max_seq_len=32)
    names = []
    for mod, eng in ((jax_tracer, jeng), (tracer, teng)):
        t = mod.Tracer()
        prev = mod.set_tracer(t)
        try:
            _drive(eng, prompts, [4, 3, 5], [2, 1])
        finally:
            mod.set_tracer(prev)
        names.append([(e["name"], e["ph"]) for e in t.events()
                      if e["name"].startswith(("serving/", "req/", "kv/"))])
    assert names[1] == names[0]
    assert ("serving/decode", "X") in names[1]
    assert ("serving/finish", "i") in names[1]
