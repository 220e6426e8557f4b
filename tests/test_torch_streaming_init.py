"""``initialize`` with a model config builds the streamed engine, as the
reference routes it; the config keys, the derived StreamConfig and every
refusal (with its message) are the reference's; what is not ported
raises naming its ROADMAP.md item."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.runtime.config import TrainingConfig as JaxConfig
from deeperspeed_tpu_torch.models.bert import BertConfig
from deeperspeed_tpu_torch.models.gpt import get_preset
from deeperspeed_tpu_torch.ops import kernel_config
from deeperspeed_tpu_torch.runtime.config import TrainingConfig
from torch_streaming_common import (B, S, batch, jax_cfg, jax_streaming,
                                    model_kw, params_np, scfg, streaming,
                                    tiny_cfg)

from tests import torch_gloo_worker as worker

ROOT = Path(__file__).resolve().parent.parent
INFINITY = ROOT / "configs" / "neox_20b_infinity.json"


def _ds_config(**stream):
    return {
        "train_batch_size": B,
        "train_micro_batch_size_per_gpu": B,
        "bf16": {"enabled": True},
        "zero_optimization": {"stage": 3,
                              "offload_param": {"device": "cpu"}},
        "optimizer": {"type": "Adam",
                      "params": {"lr": 2e-3, "betas": [0.9, 0.95],
                                 "eps": 1e-8}},
        "streaming": {"seq": S, "group_layers": 2, "wire_bits": 4,
                      "warmup_steps": 0, **stream},
    }


def test_initialize_routes_to_streamed_engine(monkeypatch):
    monkeypatch.setattr(streaming, "MIN_QUANT_SIZE", 0)
    engine, opt, loader, sched = deeperspeed_tpu_torch.initialize(
        model=tiny_cfg("bf16"), config=_ds_config(), device="cpu")
    assert isinstance(engine, streaming.StreamedOffloadEngine)
    assert opt is engine.opt and loader is None and sched is None
    assert engine.scfg.wire_bits == 4
    assert engine.scfg.lr == 2e-3
    assert engine.scfg.betas == (0.9, 0.95)
    assert opt.has_native
    losses = [engine.train_batch(t) for t in batch(n=6)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < losses[0], losses


def test_initialize_takes_params_and_applies_kernels_block():
    conf = _ds_config(wire_bits=32)
    conf["kernels"] = {"mode": "fused"}
    params = params_np()
    with kernel_config.override(mode="off"):
        engine, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=tiny_cfg(), config=conf, device="cpu",
            model_parameters=params)
        assert kernel_config.get().mode == "fused"
        loss = engine.train_batch(batch()[0])
    _, chunks = engine._chunk(params)
    assert engine.n_params == sum(c.size for c in chunks.values())
    assert np.isfinite(loss)


def _raises_both(config, model_kw=None, match=None):
    """Both packages refuse ``config`` with the same message."""
    msgs = []
    for pkg, cfg in ((deeperspeed_tpu, jax_cfg(**(model_kw or {}))),
                     (deeperspeed_tpu_torch, tiny_cfg(**(model_kw or {})))):
        kw = {} if pkg is deeperspeed_tpu else {"device": "cpu"}
        with pytest.raises(ValueError, match=match) as err:
            pkg.initialize(model=cfg, config=copy.deepcopy(config), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _with(**patch):
    conf = _ds_config()
    for k, v in patch.items():
        conf[k] = v
    return conf


@pytest.mark.parametrize("name,config,match", [
    ("not enabled", {"train_batch_size": B,
                     "train_micro_batch_size_per_gpu": B,
                     "bf16": {"enabled": True}}, "streaming"),
    ("unknown key", "wire_bitz", "wire_bitz"),
    ("optimizer", _with(optimizer={"type": "OneBitLamb",
                                   "params": {"lr": 1e-4}}), "OneBitLamb"),
    ("warmup_max_lr", _with(scheduler={
        "type": "WarmupLR", "params": {"warmup_num_steps": 5,
                                       "warmup_max_lr": 9e-4}}),
     "warmup_max_lr"),
    ("warmup_min_lr", _with(scheduler={
        "type": "WarmupLR", "params": {"warmup_min_lr": 1e-5}}),
     "warmup_min_lr"),
    ("scheduler", _with(scheduler={"type": "WarmupDecayLR",
                                   "params": {"total_num_steps": 9}}),
     "WarmupDecayLR"),
    ("clipping", _with(gradient_clipping=1.0), "gradient_clipping"),
    ("gas", _with(train_batch_size=2 * B,
                  gradient_accumulation_steps=2),
     "gradient_accumulation_steps"),
])
def test_initialize_streaming_config_validation(name, config, match):
    if config == "wire_bitz":
        config = _ds_config()
        config["streaming"]["wire_bitz"] = 4
    _raises_both(config, match=match)


def test_warmup_max_lr_alone_is_the_peak_lr():
    ok = _ds_config()
    del ok["optimizer"]["params"]["lr"]
    ok["scheduler"] = {"type": "WarmupLR",
                       "params": {"warmup_num_steps": 5,
                                  "warmup_max_lr": 9e-4}}
    got = streaming.stream_config_from_ds_config(TrainingConfig(ok),
                                                 tiny_cfg())
    want = jax_streaming.stream_config_from_ds_config(
        JaxConfig(ok, world_size=1), jax_cfg())
    assert got.lr == want.lr == 9e-4
    assert vars(got) == vars(want)


@pytest.mark.parametrize("field,value,match", [
    ("ckpt_moment_bits", 6, "ckpt_moment_bits"),
    ("ckpt_master_residual_bits", 2, "ckpt_master_residual_bits"),
    ("wire_bits", 2, "wire_bits"),
    ("wire_block", 7, "wire_block"),
    ("resident_bits", 2, "resident_bits"),
    ("host_state", "fp16", "host_state"),
    ("swap_states", "m", "swap_states"),
    ("group_layers", 3, "group_layers"),
])
def test_stream_config_values_refused_like_the_reference(field, value,
                                                         match):
    msgs = []
    for mod, cfg, kw in ((jax_streaming, jax_cfg(), {}),
                         (streaming, tiny_cfg(), {"device": "cpu"})):
        with pytest.raises(ValueError, match=match) as err:
            mod.StreamedOffloadEngine(cfg, mod.StreamConfig(
                micro_batch=B, seq=S, **{field: value}), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_infinity_config_parses_as_in_the_reference():
    raw = json.loads(INFINITY.read_text())
    ours, ref = TrainingConfig(raw), JaxConfig(raw, world_size=1)
    assert ours.streaming_enabled and ref.streaming_enabled
    assert ours.zero_optimization_stage == 3
    assert ours.streaming_params == ref.streaming_params
    assert vars(ours.aio_config) == vars(ref.aio_config)
    assert ours.aio_config.queue_depth == 16
    got = streaming.stream_config_from_ds_config(
        ours, get_preset("neox-20b", n_layer=4))
    from deeperspeed_tpu.models.gpt import get_preset as jax_preset

    want = jax_streaming.stream_config_from_ds_config(
        ref, jax_preset("neox-20b", n_layer=4))
    assert vars(got) == vars(want)
    assert (got.wire_bits, got.resident_bits, got.host_state,
            got.swap_states, got.state_device) == (4, 4, "bf16",
                                                   "exp_avg_sq", "nvme")


def test_streaming_enabled_rules():
    base = {"train_batch_size": 1}
    assert not TrainingConfig(base).streaming_enabled
    assert TrainingConfig({**base, "streaming": {}}).streaming_enabled
    assert not TrainingConfig(
        {**base, "streaming": {"enabled": False}}).streaming_enabled
    z3 = {**base, "zero_optimization": {"stage": 3,
                                        "offload_param": {"device": "nvme"}}}
    assert TrainingConfig(z3).streaming_enabled
    assert not TrainingConfig(
        {**base, "zero_optimization": {"stage": 3}}).streaming_enabled
    with pytest.raises(Exception, match="streaming"):
        TrainingConfig({**base, "streaming": 4})


def test_unported_parts_raise_naming_their_item(tmp_path):
    item = "item 10 'Offload and ZeRO-Infinity'"
    with pytest.raises(NotImplementedError, match="BERT streaming") as e:
        deeperspeed_tpu_torch.initialize(
            model=BertConfig(vocab_size=64, n_layer=2, n_head=2, d_model=32,
                             max_seq=32), config=_ds_config(), device="cpu")
    assert item in str(e.value)
    for mesh in ({"dp": 2}, {"dp": 1, "fsdp": 2}):
        with pytest.raises(NotImplementedError,
                           match="data-parallel mesh") as e:
            deeperspeed_tpu_torch.initialize(
                model=tiny_cfg(), config={**_ds_config(), "mesh": mesh},
                device="cpu")
        assert item in str(e.value)
    with pytest.raises(NotImplementedError, match="Compact") as e:
        streaming.StreamedOffloadEngine(
            tiny_cfg(), scfg(ckpt_compact=True), device="cpu")
    assert item in str(e.value)
    loss = lambda p, b: p["w"].sum()  # noqa: E731
    params = {"w": torch.ones(2)}
    for zero, part in (
            ({"stage": 2, "offload_optimizer": {"device": "cpu"}},
             "HostOffloadOptimizer"),
            ({"stage": 1, "cpu_offload": True}, "HostOffloadOptimizer"),
            ({"stage": 3}, "stage-3 helpers"),
            ({"stage": 2, "offload_param": {"device": "nvme"}},
             "stage-3 helpers")):
        with pytest.raises(NotImplementedError, match=part) as e:
            deeperspeed_tpu_torch.initialize(
                model=loss, model_parameters=params, device="cpu",
                config={"train_batch_size": 1, "zero_optimization": zero})
        assert item in str(e.value)


def test_initialize_refuses_a_data_parallel_world(tmp_path):
    """Two gloo ranks, each with the whole batch triple's world: both
    refuse, naming the item, before any engine (or swap file) is made."""
    conf = _ds_config()
    conf["train_batch_size"] = 2 * B
    worker.spawn("streaming_refusal", 2, tmp_path, model_kw(), conf)
    for r in range(2):
        text = (tmp_path / f"refusal{r}.txt").read_text()
        assert "data-parallel mesh" in text
        assert "item 10 'Offload and ZeRO-Infinity'" in text


@pytest.mark.cuda
def test_streamed_engine_on_the_card_keeps_shadow_and_routes_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with kernel_config.override(mode="auto"):
        eng = streaming.StreamedOffloadEngine(
            tiny_cfg("bf16", attn_impl="auto", n_head=1, d_model=64),
            scfg(wire_bits=4, resident_bits=4, host_state="bf16",
                 warmup_steps=0, lr=1e-3),
            params_np(dtype="bf16", n_head=1, d_model=64))
        assert eng.device.type == "cuda"
        losses = [eng.train_batch(t) for t in batch(n=3)]
        assert np.isfinite(losses).all()
        assert all(eng.shadow_matches_device().values())
