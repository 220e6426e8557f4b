"""The pipeline engine on the card, and its refusal to fall back to the
CPU without one. The card test runs with

    python -m pytest tests/test_torch_pipe_cuda.py -m cuda -q

and skips, with its reason, where ``torch.cuda.is_available()`` is false.
No JAX here: the card test holds the engine to its own launch counts."""

import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch as pt
from deeperspeed_tpu_torch.ops import fused_blocks as fb
from deeperspeed_tpu_torch.ops import kernel_config
from deeperspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                   DeepSpeedTransformerLayer)
from deeperspeed_tpu_torch.runtime.pipe import (Embedding, LayerSpec,
                                                PipelineModule, TiedLayerSpec)

torch.set_num_threads(1)

V, D, S, B, M = 64, 64, 32, 2, 2
CONFIG = {"train_batch_size": B * M, "train_micro_batch_size_per_gpu": B,
          "gradient_accumulation_steps": M, "bf16": {"enabled": True},
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "kernels": {"mode": "fused"}}


def _module():
    conf = DeepSpeedTransformerConfig(
        batch_size=B, hidden_size=D, heads=2, intermediate_size=4 * D,
        attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
        num_hidden_layers=2, fp16=True, pre_layer_norm=False)

    def xent(logits, labels):
        return torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, V), labels.long().reshape(-1))

    layers = ([TiedLayerSpec("embed", Embedding, V, D)]
              + [LayerSpec(DeepSpeedTransformerLayer, conf)
                 for _ in range(2)]
              + [TiedLayerSpec("embed", Embedding, V, D,
                               forward_fn=lambda p, x: x @ p["w"].T)])
    return PipelineModule(layers, num_stages=1, loss_fn=xent)


def test_engine_refuses_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.initialize(model=_module(), config=CONFIG)


@pytest.mark.cuda
def test_one_stage_engine_launches_the_kernels_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    mbs = [tuple(rng.integers(0, V, (B, S)) for _ in range(2))
           for _ in range(M)]
    with kernel_config.override():
        eng = pt.initialize(model=_module(), config=CONFIG, rng=0)[0]
        fb.add_ln_fwd.launches = 0
        losses = [float(eng.train_batch(iter(mbs))) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    # post-LN: two add-LN forwards a layer, each micro-batch's forward
    # run twice (the backward replays it)
    assert fb.add_ln_fwd.launches == 3 * 2 * 2 * 2 * M
