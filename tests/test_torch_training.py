"""The PyTorch port's training slice against the JAX reference: the config
(same fields, same errors), the LR schedules, Adam, the loss scaler, and a
10-step loss curve of both engines on tiny NeoX and GPT-2 models from the
same weights and batches (the GPT loss itself: tests/test_torch_gpt.py).

Inputs come from numpy with a seed and are handed to both packages. JAX
runs on the CPU with its Pallas kernels in interpret mode
(``"kernels": {"mode": "fused"}``, ``attn_impl="pallas_interpret"``); the
port runs the same "kernels" block, under which its kernel wrappers take
their plain versions on a CPU tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.ops import adam as jax_adam
from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu.runtime import config as jax_config
from deeperspeed_tpu.runtime import dataloader as jax_dataloader
from deeperspeed_tpu.runtime import lr_schedules as jax_lr
from deeperspeed_tpu.runtime.fp16 import loss_scaler as jax_scaler
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.ops import adam
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.runtime import config as pt_config
from deeperspeed_tpu_torch.runtime import dataloader as pt_dataloader
from deeperspeed_tpu_torch.runtime import lr_schedules as pt_lr
from deeperspeed_tpu_torch.runtime.fp16 import loss_scaler as pt_scaler

torch.set_num_threads(1)

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
            rotary=True, parallel_residual=True)
GPT2 = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
            rotary=False, parallel_residual=False)
S = 64
BASE = {
    "train_batch_size": 4,
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Adam",
                  "params": {"lr": 3e-3, "betas": [0.9, 0.95]}},
    "scheduler": {"type": "WarmupDecayLR",
                  "params": {"warmup_max_lr": 3e-3, "warmup_num_steps": 3,
                             "total_num_steps": 50}},
    "gradient_clipping": 0.5,
    "kernels": {"mode": "fused"},
}
# fp32 on both sides. Adam's update m / (sqrt(v) + eps) normalizes the
# gradient, so an ulp-level difference in a small gradient entry (the two
# frameworks sum in other orders) moves the weights by a visible fraction
# of lr; over 10 steps that stays below 1e-4 of the loss.
LOSS_RTOL = 1e-4


def _one_device_mesh():
    """The reference engine on one device, so both engines see the same
    batch triple (world size 1)."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


# ------------------------------------------------------------------ #
# config
# ------------------------------------------------------------------ #

def _raised(cls, cfg):
    try:
        cls(cfg)
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("bad", [
    {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 3,
     "gradient_accumulation_steps": 2},
    {"train_batch_size": 0},
    {"steps_per_print": 10},
    {"train_batch_size": 4, "fp16": {"enabled": True},
     "bf16": {"master_weights": False}},
    {"train_batch_size": 4, "bf16": {"enabled": True,
                                     "grad_accum_dtype": "fp8"}},
    {"train_batch_size": 4, "checkpoint": {"tag_validation": "Sometimes"}},
    {"train_batch_size": 4, "kernels": {"mode": "turbo"}},
    {"train_batch_size": 4, "fp16": {"enabled": True, "loss_scale": -1}},
])
def test_config_errors_match_reference(bad):
    want = _raised(jax_config.TrainingConfig, bad)
    assert want is not None
    assert _raised(pt_config.TrainingConfig, bad) == want


def test_config_duplicate_keys_raise_as_in_reference(tmp_path):
    path = tmp_path / "ds.json"
    path.write_text('{"train_batch_size": 4, "train_batch_size": 8}')
    for cls in (jax_config.TrainingConfig, pt_config.TrainingConfig):
        with pytest.raises(ValueError, match="Duplicate keys"):
            cls(str(path))


@pytest.mark.parametrize("cfg", [
    BASE,
    {"train_batch_size": 8, "gradient_accumulation_steps": 4,
     "bf16": {"enabled": True, "master_weights": False,
              "grad_accum_dtype": "fp32"}},
    {"train_micro_batch_size_per_gpu": 3, "fp16": {"enabled": True},
     "steps_per_print": 7, "wall_clock_breakdown": True},
    {"train_batch_size": 6, "fp16": {"enabled": True, "type": "bfloat16",
                                     "loss_scale": 128}},
])
def test_config_fields_match_reference(cfg):
    j = jax_config.TrainingConfig(cfg)
    t = pt_config.TrainingConfig(cfg)
    for f in ("train_batch_size", "train_micro_batch_size_per_gpu",
              "gradient_accumulation_steps", "precision", "master_weights",
              "grad_accum_dtype", "loss_scale", "dynamic_loss_scale",
              "dynamic_loss_scale_args", "optimizer_name",
              "optimizer_params", "scheduler_name", "scheduler_params",
              "gradient_clipping", "steps_per_print", "wall_clock_breakdown",
              "kernels_params", "kernels_mode", "bfloat16_enabled",
              "fp16_enabled", "checkpoint_tag_validation_mode"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("block,item", [
    ({"zero_optimization": {"stage": 3}}, "Offload and ZeRO-Infinity"),
    # the mesh block's tp and sp run now (tests/test_torch_tp_engine.py),
    # and so does the pipeline (tests/test_torch_pipe_engine.py): its
    # block is stored as the reference stores it
    ({"pipeline": {"stages": 4, "partition_method": "uniform"}},
     "MoE, TP and pipeline"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
     "Offload and ZeRO-Infinity"),
    ({"streaming": {}}, "Offload and ZeRO-Infinity"),
    ({"pipeline": {"stages": 2, "activation_checkpoint_interval": 1}},
     "MoE, TP and pipeline"),
    ({"optimizer": {"type": "CPUAdam", "params": {}}},
     "Offload and ZeRO-Infinity"),
    ({"checkpoint": {"sharded_io": True}}, "Sharded checkpoints"),
    ({"pipeline": {"stages": 2}}, "MoE, TP and pipeline"),
    ({"autotune": {}}, "Tooling"),
    ({"autotune": {"enabled": True}}, "Tooling"),
    ({"progressive_layer_drop": {"enabled": True}}, "Tooling"),
    ({"flops_profiler": {"enabled": True}}, "Tooling"),
])
def test_unported_blocks_raise_naming_their_roadmap_item(block, item):
    cfg = dict({"train_batch_size": 4}, **block)
    if item == "MoE, TP and pipeline":
        # ported: the "pipeline" block is accepted and stored as the
        # reference's TrainingConfig stores it
        want = deeperspeed_tpu.runtime.config.TrainingConfig(cfg).pipeline
        assert pt_config.TrainingConfig(cfg).pipeline == want
        assert want == block["pipeline"]
        return
    if "optimizer" in block or item == "Offload and ZeRO-Infinity":
        # an optimizer the port does not have is refused when initialize
        # builds it; so are ZeRO 3, offload and streaming for a loss
        # callable (only the streamed engine, built for a model config,
        # runs them)
        with pytest.raises(NotImplementedError, match="ROADMAP") as e:
            deeperspeed_tpu_torch.initialize(
                model=lambda p, b: p["w"].sum(),
                model_parameters={"w": torch.ones(2)}, config=cfg,
                device="cpu")
    else:
        with pytest.raises(pt_config.ConfigError, match="ROADMAP") as e:
            pt_config.TrainingConfig(cfg)
    assert item in str(e.value)
    # a block switched off explicitly is not an error
    key = next(iter(block))
    if isinstance(block[key], dict) and key not in (
            "zero_optimization", "pipeline", "progressive_layer_drop",
            "batch_scheduler", "optimizer"):
        pt_config.TrainingConfig({"train_batch_size": 4,
                                  key: {"enabled": False}})


def test_unknown_optimizer_raises_as_in_reference():
    cfg = dict(BASE, optimizer={"type": "Adagrad", "params": {}})
    cfg.pop("kernels")
    params = {"w": np.ones((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unknown optimizer 'adagrad'"):
        deeperspeed_tpu.initialize(model=lambda p, b: jnp.sum(p["w"]),
                                   model_parameters=params, config=cfg,
                                   mesh=_one_device_mesh())
    with pytest.raises(ValueError, match="unknown optimizer 'adagrad'"):
        deeperspeed_tpu_torch.initialize(
            model=lambda p, b: p["w"].sum(),
            model_parameters={"w": torch.ones(2, 2)}, config=cfg,
            device="cpu")
    # an optimizer the reference has and the port does not yet
    cfg["optimizer"] = {"type": "CPUAdam", "params": {}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deeperspeed_tpu_torch.initialize(
            model=lambda p, b: p["w"].sum(),
            model_parameters={"w": torch.ones(2, 2)}, config=cfg,
            device="cpu")


# ------------------------------------------------------------------ #
# LR schedules, Adam, loss scaling, data loader
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 10, "cycle_second_step_size": 15,
                  "decay_step_size": 5, "decay_lr_rate": 0.1}),
    ("WarmupLR", {"warmup_min_lr": 0.0, "warmup_max_lr": 2e-4,
                  "warmup_num_steps": 20}),
    ("WarmupDecayLR", {"warmup_max_lr": 2e-4, "warmup_num_steps": 10,
                       "total_num_steps": 40}),
])
def test_lr_schedules_match_reference(name, params):
    j = jax_lr.get_scheduler(name, params)
    t = pt_lr.get_scheduler(name, params)
    for _ in range(50):
        assert t.get_lr() == j.get_lr()
        if name == "OneCycle":
            assert t.get_mom() == j.get_mom()
        j.step()
        t.step()
    assert t.state_dict() == j.state_dict()
    assert pt_lr.VALID_LR_SCHEDULES == jax_lr.VALID_LR_SCHEDULES
    with pytest.raises(ValueError, match="unknown lr schedule"):
        pt_lr.get_scheduler("Cosine", {})


def _adam_tree(rs, shapes):
    return {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("storage", ["fp32", "bf16_masterless"])
@pytest.mark.parametrize("adam_w_mode,wd,bias_correction", [
    (True, 0.0, True), (True, 0.1, True), (False, 0.05, False)])
def test_fused_adam_matches_reference(storage, adam_w_mode, wd,
                                      bias_correction):
    """Three steps from the same params and moments, with the reference's
    update in fp32 arithmetic over the storage dtypes. Masterless bf16
    stores params and moments in bf16 (beta2 = 0.95 keeps exp_avg_sq in
    bf16 too); those agree within one bf16 ulp."""
    rs = np.random.RandomState(7)
    shapes = {"a": (5, 7), "b": (11,)}
    p0, m0 = _adam_tree(rs, shapes), _adam_tree(rs, shapes)
    v0 = {k: np.abs(x) for k, x in _adam_tree(rs, shapes).items()}
    grads = [_adam_tree(rs, shapes) for _ in range(3)]
    bf16 = storage == "bf16_masterless"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                            torch.float32)
    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=wd,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    jopt = jax_adam.FusedAdam(**kw, state_dtype=jdt, use_pallas=False)
    topt = adam.FusedAdam(**kw, state_dtype=tdt)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p0)
    jst = jax_adam.AdamState(
        jnp.zeros((), jnp.int32), jax.tree.map(lambda x: jnp.asarray(x, jdt),
                                               m0),
        jax.tree.map(lambda x: jnp.asarray(x, jdt), v0))
    tp = {k: torch.from_numpy(x).to(tdt) for k, x in p0.items()}
    tst = convert.from_jax_adam_state(jst, "cpu")
    assert tst.step == 0 and tst.exp_avg["a"].dtype == tdt
    for g in grads:
        jp, jst = jopt.update(jax.tree.map(lambda x: jnp.asarray(x, jdt), g),
                              jst, jp, jnp.float32(1e-2))
        tp, tst = topt.update({k: torch.from_numpy(x).to(tdt)
                               for k, x in g.items()}, tst, tp, 1e-2)
    tol = dict(atol=1e-2, rtol=1e-2) if bf16 else dict(atol=1e-6, rtol=1e-6)
    back = convert.to_numpy_adam_state(tst)
    assert back.step == int(jst.step) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32), **tol)
        np.testing.assert_allclose(back.exp_avg[k],
                                   np.asarray(jst.exp_avg[k], np.float32),
                                   **tol)
        np.testing.assert_allclose(back.exp_avg_sq[k],
                                   np.asarray(jst.exp_avg_sq[k], np.float32),
                                   **tol)


def test_fused_adam_second_moment_dtype_rule_matches_reference():
    for b2 in (0.999, 0.95, 0.992):
        j = jax_adam.FusedAdam(betas=(0.9, b2), state_dtype=jnp.bfloat16)
        t = adam.FusedAdam(betas=(0.9, b2), state_dtype=torch.bfloat16)
        assert str(jnp.dtype(j.state_dtype_sq)) == str(t.state_dtype_sq
                                                       ).split(".")[-1]


def test_dynamic_loss_scaler_matches_reference():
    flags = [False, True, True, False, False, False, True, False, True,
             True, True, False] + [False] * 9
    for args in ({"init_scale": 2.0 ** 16, "scale_window": 4,
                  "delayed_shift": 2, "min_scale": 1.0},
                 {"init_scale": 8.0, "scale_window": 3, "delayed_shift": 1,
                  "min_scale": 2.0}):
        j = jax_scaler.create_loss_scaler("fp16", 0, args)
        t = pt_scaler.create_loss_scaler("fp16", 0, args)
        js, ts = j.init(), t.init()
        for overflow in flags:
            js, ts = j.update(js, jnp.asarray(overflow)), t.update(ts,
                                                                  overflow)
            assert (ts.loss_scale, ts.good_steps, ts.hysteresis) == (
                float(js.loss_scale), int(js.good_steps),
                int(js.hysteresis))
    st = pt_scaler.create_loss_scaler("bfloat16", 1.0)
    assert not st.dynamic and st.update(st.init(), True).loss_scale == 1.0


def test_dataloader_matches_reference():
    data = [(np.arange(3) + i, np.array([i])) for i in range(10)]
    for shuffle in (False, True):
        j = jax_dataloader.DeepSpeedDataLoader(data, 3, shuffle=shuffle)
        t = pt_dataloader.DeepSpeedDataLoader(data, 3, shuffle=shuffle)
        assert len(t) == len(j) == 3
        for a, b in zip(t, j):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    rep = pt_dataloader.RepeatingLoader(t)
    assert len([next(rep) for _ in range(7)]) == 7 and rep.epoch == 2


# ------------------------------------------------------------------ #
# the GPT loss and the engines
# ------------------------------------------------------------------ #

def _jax_and_port(kw, seed=0, **cfg_kw):
    jcfg = jax_gpt.GPTConfig(**kw, dtype=jnp.float32,
                             attn_impl="pallas_interpret", **cfg_kw)
    jinit, _, jloss, _ = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(seed))
    tcfg = gpt.GPTConfig(**kw, dtype=torch.float32,
                         attn_impl="pallas_interpret", **cfg_kw)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jparams, jloss, tcfg, tparams


def _batches(n, rows, seed=11):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 97, (rows, S + 1)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("variant", ["neox", "gpt2"])
def test_engine_loss_curve_matches_reference(variant):
    """10 train_batch steps of both engines, gas 2, clipping and a warmup
    schedule, from the same weights and batches (LOSS_RTOL). The JAX side
    runs its Pallas LN/bias+GeLU and attention kernels in interpret mode;
    the port's wrappers take their plain versions."""
    kw = NEOX if variant == "neox" else GPT2
    jparams, jloss, tcfg, tparams = _jax_and_port(kw, ce_chunk=0)
    batches = _batches(2, 4) * 5  # two batches in turn: the loss can fall
    with jax_kc.override():
        jeng, _, _, _ = deeperspeed_tpu.initialize(
            model=jloss, model_parameters=jparams, config=BASE,
            mesh=_one_device_mesh())
        jl = [float(jeng.train_batch(b)) for b in batches]
        jnorm = jeng.get_global_grad_norm()
    with kc.override():
        _, _, tloss, _ = gpt.make_gpt(tcfg)
        teng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=tloss, model_parameters=tparams, config=BASE, device="cpu")
        tl = [float(teng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(teng.get_global_grad_norm(), jnorm, rtol=1e-3)
    assert teng.get_lr() == jeng.get_lr()
    assert teng.global_steps == jeng.global_steps == 10
    assert teng.skipped_steps == jeng.skipped_steps == 0


def test_remat_policies_give_the_same_grads():
    """remat off and every policy ("full", "flash", "matmuls", "dots",
    "dots_all") differ only in what the backward replays; their grads
    agree to fp32 rounding. The kernel wrappers' launch counters (all
    plain on the CPU) stay at zero."""
    _, _, tcfg, tparams = _jax_and_port(GPT2, remat=False, ce_chunk=0)
    batch = torch.from_numpy(_batches(1, 2)[0])
    ref = None
    with kc.override(mode="fused"):
        for policy in (None, "full", "flash", "matmuls", "dots",
                       "dots_all"):
            cfg = (tcfg if policy is None else
                   gpt.GPTConfig(**GPT2, dtype=torch.float32,
                                 attn_impl="pallas_interpret", remat=True,
                                 remat_policy=policy))
            leaves = list(convert._flatten(tparams).values())
            for t in leaves:
                t.requires_grad_()
            grads = torch.autograd.grad(gpt.make_gpt(cfg)[2](tparams, batch),
                                        leaves)
            if ref is None:
                ref = grads
            for a, b in zip(grads, ref):
                torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
