"""The port's ``PipelineServingBridge`` (serving/engine.py) over its
2-stage ``PipelineEngine`` (two gloo ranks, tests/torch_gloo_worker.py),
against the reference's bridge over the reference's engine on a CPU mesh
of the same shape, from the same weights: greedy tokens equal, request
for request, on every rank (the last stage's logits reach every rank
through ``inference_batch``'s broadcast). Mirrors
tests/test_serving_engine.py's bridge parity test."""

import pickle

import numpy as np
import torch

from deeperspeed_tpu.serving import PipelineServingBridge, ServingConfig
from tests import test_torch_pipe_engine as eng_test
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

CASE = dict(name="serve", kind="bert", dims={"pipe": 2},
            config=eng_test._config(micro=1, gas=1))
NEWS = [6, 4, 7]


def test_bridge_greedy_tokens_match_reference(tmp_path):
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, worker.PIPE_V, (n,)).tolist()
               for n in (4, 7, 5)]
    ref_eng = eng_test.reference_engine(CASE)
    with open(tmp_path / "serve_init.pkl", "wb") as f:
        pickle.dump(eng_test.reference_params(ref_eng), f)
    bridge = PipelineServingBridge.from_pipeline_engine(
        ref_eng, ServingConfig(num_slots=2, block_size=8, num_blocks=16,
                               max_seq_len=32))
    rids = [bridge.submit(p, max_new_tokens=m) for p, m in zip(prompts, NEWS)]
    outs = bridge.run()
    want = [list(outs[r]) for r in rids]
    assert [len(w) for w in want] == NEWS

    worker.spawn("pipe_serving_run", 2, tmp_path, CASE, prompts, NEWS)
    for r in range(2):
        with open(tmp_path / f"serve_rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got["outs"] == want, (r, got["outs"], want)
        assert got["finished"] == len(prompts)
