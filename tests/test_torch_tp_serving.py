"""Tensor-parallel serving: the port's ``ServingEngine(..., mesh=)`` over
2 gloo ranks (tests/torch_gloo_worker.py) from the same whole fp32
weights, against the meshless engines of both packages:

* every rank keeps its heads (its KV pools hold ``Hkv / tp`` heads, its
  fused qkv ``(H + 2 Hkv) Dh / tp`` columns), every rank emits the same
  greedy tokens, and they equal the port's meshless engine's and the JAX
  reference's, request for request; with GQA (2 K/V heads over 2 ranks)
  too;
* the refusals, each naming its reason: a data axis above 1 (one
  scheduler shared by processes is not ported), K/V heads fewer than the
  tp ranks, and a ``"speculative"`` block on a tp mesh.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.serving import ServingEngine as JaxServingEngine
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.parallel import build_mesh
from deeperspeed_tpu_torch.serving import ServingEngine
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

NEW = 8
SCFG = {"num_slots": 4, "block_size": 8, "num_blocks": 64,
        "max_seq_len": 64}
MODELS = {
    "mha": dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, max_seq=64,
                attn_impl="xla"),
    "gqa": dict(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2,
                d_model=32, max_seq=64, attn_impl="xla",
                tie_embeddings=True, rotary=False, parallel_residual=False),
}
_RUN = {}


def _requests():
    rs = np.random.RandomState(11)
    return [{"rid": f"r{i}", "prompt": rs.randint(0, 64, n).tolist()}
            for i, n in enumerate((3, 9, 17, 5, 30, 12))]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        for name, kw in MODELS.items():
            d = tmp_path_factory.mktemp(f"tp_serving_{name}")
            jcfg = jax_gpt.GPTConfig(**kw, dtype=jnp.float32)
            jparams = jax_gpt.init_params(jax.random.PRNGKey(9), jcfg)
            tcfg = gpt.GPTConfig(**kw, dtype=torch.float32)
            tparams = convert.from_jax_params(
                jax.tree.map(np.asarray, jparams), tcfg, "cpu")
            torch.save(tparams, d / "tp_params.pt")
            worker.spawn("tp_serving_run", 2, d, {"model": 2}, kw,
                         _requests(), NEW)
            ranks = []
            for r in range(2):
                with open(os.path.join(d, f"tp_serving_rank{r}.json")) as f:
                    ranks.append(json.load(f))
            _RUN[name] = {"jcfg": jcfg, "jparams": jparams, "tcfg": tcfg,
                          "tparams": tparams, "ranks": ranks}
    return _RUN


def _serve(engine):
    for r in _requests():
        engine.submit(r["prompt"], max_new_tokens=NEW, request_id=r["rid"])
    return {k: [int(t) for t in v] for k, v in engine.run().items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_every_rank_emits_the_meshless_engines_tokens(run, name):
    got = run[name]
    ranks = got["ranks"]
    assert ranks[0]["outs"] == ranks[1]["outs"]
    mine = _serve(ServingEngine(got["tcfg"], got["tparams"], SCFG,
                                device="cpu"))
    ref = _serve(JaxServingEngine(got["jcfg"], got["jparams"], SCFG))
    assert ranks[0]["outs"] == mine == ref
    assert all(len(v) == NEW for v in mine.values())


@pytest.mark.parametrize("name", list(MODELS))
def test_each_rank_holds_its_heads(run, name):
    cfg = run[name]["tcfg"]
    for rank in run[name]["ranks"]:
        assert rank["kv_heads"] == cfg.kv_heads // 2
        assert rank["wqkv"] == [cfg.n_layer, cfg.d_model, cfg.qkv_dim // 2]


def test_refusals(run):
    got = run["mha"]
    with pytest.raises(NotImplementedError, match="scheduler shared"):
        ServingEngine(got["tcfg"], got["tparams"], SCFG, device="cpu",
                      mesh=build_mesh({"data": 2, "model": 2}, world=4))
    mqa = gpt.GPTConfig(vocab_size=64, n_layer=1, n_head=4, n_kv_head=1,
                        d_model=32, dtype=torch.float32)
    with pytest.raises(ValueError, match="K/V heads"):
        ServingEngine(mqa, gpt.init_params(0, mqa, device="cpu"), SCFG,
                      device="cpu", mesh=build_mesh({"model": 2}, world=2))
    with pytest.raises(NotImplementedError, match="speculative"):
        ServingEngine(got["tcfg"], got["tparams"],
                      dict(SCFG, speculative={"draft_k": 2}), device="cpu",
                      mesh=build_mesh({"model": 2}, world=2))
