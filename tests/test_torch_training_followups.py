"""The training follow-ups of the PyTorch port against the JAX reference:
``ops/sgd.py``, the GPT remat policies "flash", "dots" and "dots_all",
``store_gradients`` and the layer-output capture, the ``FP16_Optimizer``
wrappers, ``runtime/utils.py``, ``runtime/bs_schedules.py`` and the
``"batch_scheduler"`` block.

Inputs come from a numpy seed and go through both packages, fp32. The
reference runs its Pallas kernels in interpret mode where its path has
them; the port's wrappers take their plain versions on the CPU."""

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
from deeperspeed_tpu.ops import sgd as jax_sgd
from deeperspeed_tpu.runtime import bs_schedules as jax_bs
from deeperspeed_tpu.runtime import config as jax_config
from deeperspeed_tpu.runtime import utils as jax_utils
from deeperspeed_tpu.runtime.fp16 import fused_optimizer as jax_fp16
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.ops import adam, flash_attention, sgd
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.runtime import bs_schedules, utils
from deeperspeed_tpu_torch.runtime import config as pt_config
from deeperspeed_tpu_torch.runtime.fp16 import (FP16_Optimizer,
                                                FP16_UnfusedOptimizer)

torch.set_num_threads(1)

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
            rotary=True, parallel_residual=True)
S = 64
BASE = {
    "train_batch_size": 4,
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Adam",
                  "params": {"lr": 3e-3, "betas": [0.9, 0.95]}},
    "gradient_clipping": 0.5,
    "kernels": {"mode": "fused"},
}
# one forward+backward, fp32 (tests/test_torch_gpt.py's limits)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# a few engine steps, fp32 (tests/test_torch_training.py's LOSS_RTOL)
CURVE_RTOL = 1e-4


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _tree(seed, shapes=((3, 5), (7,), (2, 2, 4))):
    rs = np.random.RandomState(seed)
    return {f"w{i}": rs.randn(*s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _models(**cfg_kw):
    kw = dict(NEOX, attn_impl="pallas_interpret", ce_chunk=0, **cfg_kw)
    jcfg = jax_gpt.GPTConfig(**kw, dtype=jnp.float32)
    jinit, _, jloss, _ = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(0))
    tcfg = gpt.GPTConfig(**kw, dtype=torch.float32)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jparams, jloss, tparams, gpt.make_gpt(tcfg)[2]


def _batches(n, rows=4, seed=11):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 97, (rows, S + 1)).astype(np.int32)
            for _ in range(n)]


def _engines(config, **cfg_kw):
    jparams, jloss, tparams, tloss = _models(**cfg_kw)
    jeng, _, _, _ = deeperspeed_tpu.initialize(
        model=jloss, model_parameters=jparams, config=config,
        mesh=_one_device_mesh())
    teng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=tloss, model_parameters=tparams, config=config, device="cpu")
    return jeng, teng


def _close(tree_t, tree_j, atol, rtol):
    jflat = convert._flatten(jax.tree.map(np.asarray, tree_j))
    tflat = convert._flatten(tree_t)
    assert sorted(tflat) == sorted(jflat)
    for k, v in tflat.items():
        got = v.detach().float().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v, np.float32)
        np.testing.assert_allclose(got, jflat[k], atol=atol, rtol=rtol,
                                   err_msg=k)


# ------------------------------------------------------------------ #
# SGD
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("momentum,nesterov,wd", [
    (0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 0.0),
    (0.9, True, 1e-2), (0.5, False, 1e-2)])
def test_sgd_matches_reference_per_leaf(momentum, nesterov, wd):
    """5 steps, an LR that changes every step: params and momentum
    buffers of every leaf within fp32 rounding of the reference's."""
    params = _tree(0)
    jopt = jax_sgd.SGD(lr=0.1, momentum=momentum, weight_decay=wd,
                       nesterov=nesterov)
    topt = sgd.SGD(lr=0.1, momentum=momentum, weight_decay=wd,
                   nesterov=nesterov)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _torch_tree(params)
    ts = topt.init(tp)
    for step in range(5):
        g = _tree(step + 1)
        lr = 0.1 / (step + 1)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             lr=jnp.float32(lr))
        tp, ts = topt.update(_torch_tree(g), ts, tp, lr=lr)
    assert ts.step == int(js.step) == 5
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.momentum_buf[k].numpy(),
                                   np.asarray(js.momentum_buf[k]),
                                   rtol=1e-6, atol=1e-7)


def test_engine_sgd_type_trains_and_checkpoints_like_reference(tmp_path):
    """The engines' "SGD" type (momentum, Nesterov, weight decay): the loss
    curves of 3 steps agree, and the reference loads the port's checkpoint
    (params and momentum buffers) and takes the same next step."""
    config = dict(BASE, optimizer={"type": "SGD", "params": {
        "lr": 0.05, "momentum": 0.9, "nesterov": True,
        "weight_decay": 1e-3}})
    batches = _batches(4)
    with jax_kc.override(), kc.override():
        jeng, teng = _engines(config)
        assert isinstance(teng.optimizer, sgd.SGD)
        jl = [float(jeng.train_batch(b)) for b in batches[:3]]
        tl = [float(teng.train_batch(b)) for b in batches[:3]]
        np.testing.assert_allclose(tl, jl, rtol=CURVE_RTOL)
        teng.save_checkpoint(str(tmp_path))
        jeng2, _ = _engines(config)
        jeng2.load_checkpoint(str(tmp_path))
        _close(teng.opt_state.momentum_buf,
               jeng2.state.opt_state.momentum_buf, 0, 0)
        np.testing.assert_allclose(float(jeng2.train_batch(batches[3])),
                                   float(teng.train_batch(batches[3])),
                                   rtol=CURVE_RTOL)


# ------------------------------------------------------------------ #
# remat policies
# ------------------------------------------------------------------ #

POLICIES = ("full", "flash", "matmuls", "dots", "dots_all")


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_loss_and_grads_match_reference(policy):
    """One forward+backward under ``policy`` in both packages (kernels
    fused: the reference's Pallas kernels in interpret mode), and in the
    port against its "full": the loss within LOSS_RTOL, every grad within
    GRAD_ATOL + GRAD_RTOL."""
    batch = _batches(1, rows=2)[0]
    jparams, jloss, tparams, tloss = _models(remat=True,
                                             remat_policy=policy)
    _, _, _, tfull = _models(remat=True, remat_policy="full")
    with jax_kc.override(mode="fused"), kc.override(mode="fused"):
        jl, jg = jax.value_and_grad(jloss)(jparams, jnp.asarray(batch))
        leaves = {k: v.requires_grad_() for k, v in
                  convert._flatten(tparams).items()}
        tl = tloss(tparams, torch.from_numpy(batch))
        tg = torch.autograd.grad(tl, list(leaves.values()))
        fl = tfull(tparams, torch.from_numpy(batch))
        fg = torch.autograd.grad(fl, list(leaves.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl.item(), fl.item(), rtol=LOSS_RTOL)
    jflat = convert._flatten(jax.tree.map(np.asarray, jg))
    for (k, _), g, f in zip(leaves.items(), tg, fg):
        np.testing.assert_allclose(g.numpy(), jflat[k], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)
        np.testing.assert_allclose(g.numpy(), f.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("policy,fwd_per_layer", [
    ("full", 2), ("flash", 1), ("matmuls", 1), ("dots", 2),
    ("dots_all", 2)])
def test_flash_forward_calls_per_policy(policy, fwd_per_layer,
                                        monkeypatch):
    """The flash op's forward runs once a layer where the policy keeps its
    o and lse ("flash", "matmuls") and twice where the backward replays it
    ("full", and "dots"/"dots_all", whose JAX policies never match a
    pallas_call); the backward once a layer. Counted through the plain
    versions the wrappers take on a CPU tensor."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash_attention.flash_fwd_plain, flash_attention.flash_bwd_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(flash_attention, "flash_fwd_plain",
                        count("fwd", fwd))
    monkeypatch.setattr(flash_attention, "flash_bwd_plain",
                        count("bwd", bwd))
    _, _, tparams, tloss = _models(remat=True, remat_policy=policy)
    batch = torch.from_numpy(_batches(1, rows=2)[0])
    with kc.override(mode="off"):
        leaves = [v.requires_grad_() for v in
                  convert._flatten(tparams).values()]
        torch.autograd.grad(tloss(tparams, batch), leaves)
    L = NEOX["n_layer"]
    assert calls == {"fwd": fwd_per_layer * L, "bwd": L}
    assert set(gpt.REMAT_SAVED) == set(POLICIES) - {"full"}


# ------------------------------------------------------------------ #
# store_gradients and layer outputs
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("on_cpu", [False, True])
def test_store_gradients_match_reference(on_cpu):
    """``store_gradients`` (and ``store_gradients_cpu``): the summed
    gradients of the step, before unscaling and clipping, as the
    reference's, and equal to the port's own unfused backward."""
    batch = _batches(1)[0]
    with jax_kc.override(), kc.override():
        jeng, teng = _engines(BASE)
        for eng in (jeng, teng):
            eng.store_gradients = True
            eng.store_gradients_cpu = on_cpu
        # the port's unfused backward from the same params
        _, _, tparams, tloss = _models()
        leaves = list(convert._flatten(tparams).values())
        for t in leaves:
            t.requires_grad_()
        want = None
        for i in range(2):
            g = torch.autograd.grad(
                tloss(tparams, torch.from_numpy(batch[2 * i:2 * i + 2])),
                leaves)
            want = g if want is None else [a + b for a, b in zip(want, g)]
        jeng.train_batch(batch)
        teng.train_batch(batch)
    stored = teng.stored_gradients
    first = next(iter(convert._flatten(stored).values()))
    assert isinstance(first, np.ndarray if on_cpu else torch.Tensor)
    _close(stored, jeng.stored_gradients, GRAD_ATOL, GRAD_RTOL)
    for g, w in zip(convert._flatten(stored).values(), want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_layer_outputs_match_reference():
    """``register_forward_hook``: after a step, one output per layer of a
    forward of the step's batch under the updated params, as the
    reference's; ``remove_forward_hooks`` empties it."""
    batch = _batches(1)[0]
    with jax_kc.override(), kc.override():
        jeng, teng = _engines(BASE)
        for eng in (jeng, teng):
            eng.register_forward_hook(layer_name_pattern="transformer")
            eng.train_batch(batch)
    jout = jeng.layer_outputs["transformerlayer"]
    tout = teng.layer_outputs["transformerlayer"]
    assert len(tout) == len(jout) == NEOX["n_layer"]
    for a, b in zip(tout, jout):
        assert a.shape == (4, S, NEOX["d_model"])
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-4)
    teng.remove_forward_hooks()
    jeng.remove_forward_hooks()
    assert teng.layer_outputs == {}


# ------------------------------------------------------------------ #
# FP16_Optimizer wrappers
# ------------------------------------------------------------------ #

def _wrapper_pair(cls_t, cls_j, clip, dynamic=True):
    params = _tree(20, shapes=((16, 8), (8,), (4, 4)))
    args = {"init_scale": 2.0 ** 10, "scale_window": 2,
            "delayed_shift": 1}
    j = cls_j(jax_adam.FusedAdam(lr=1e-2), jax.tree.map(jnp.asarray,
                                                        params),
              dynamic_loss_scale=dynamic, dynamic_loss_args=args,
              static_loss_scale=4.0, clip_grad=clip, verbose=False)
    t = cls_t(adam.FusedAdam(lr=1e-2), _torch_tree(params),
              dynamic_loss_scale=dynamic, dynamic_loss_args=args,
              static_loss_scale=4.0, clip_grad=clip, verbose=False)
    return j, t


@pytest.mark.parametrize("unfused,clip,dynamic", [
    (False, 0.0, True), (False, 0.5, True), (True, 0.5, True),
    (True, 0.0, False)])
def test_fp16_optimizer_matches_reference(unfused, clip, dynamic):
    """6 steps of scaled gradients, one of them holding an inf: the same
    skips, loss scales (halved on the overflow, doubled every 2 clean
    steps), clipped norms and fp32 params as the reference; the bf16
    compute copies follow the master."""
    cls_t, cls_j = ((FP16_UnfusedOptimizer, jax_fp16.FP16_UnfusedOptimizer)
                    if unfused else (FP16_Optimizer, jax_fp16.FP16_Optimizer))
    j, t = _wrapper_pair(cls_t, cls_j, clip, dynamic)
    assert t.per_tensor_clip == j.per_tensor_clip == unfused
    assert t.compute_dtype == torch.bfloat16
    for step in range(6):
        g = _tree(30 + step, shapes=((16, 8), (8,), (4, 4)))
        if step == 2:
            g["w1"][3] = np.inf
        assert t.cur_scale == j.cur_scale
        scaled = {k: v * t.cur_scale for k, v in g.items()}
        skipped_t = t.step(_torch_tree(scaled))
        skipped_j = j.step(jax.tree.map(jnp.asarray, scaled))
        # the inf is an overflow under a static scale too
        assert skipped_t == skipped_j == (step == 2)
        assert t.cur_scale == j.cur_scale
        assert t.overflow == j.overflow
        if not skipped_t:
            np.testing.assert_allclose(float(t._last_norm),
                                       float(j._last_norm), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(t.fp32_params[k].numpy(),
                                       np.asarray(j.fp32_params[k]),
                                       rtol=1e-6, atol=1e-7)
            assert t.params[k].dtype == torch.bfloat16
            assert torch.equal(t.params[k],
                               t.fp32_params[k].to(torch.bfloat16))
    if dynamic:
        # scale 2^10, x2 after steps 2 (clean) ... halved at the overflow
        assert t.cur_scale == j.cur_scale != 2.0 ** 10
    if unfused and clip:
        # per-tensor: each clipped tensor has norm <= clip, not the total
        big = {k: v * 100 * t.cur_scale for k, v in _tree(99).items()}
        clipped, norm = t._clip({k: torch.from_numpy(v / t.cur_scale)
                                 for k, v in big.items()})
        for v in clipped.values():
            assert float(torch.linalg.vector_norm(v)) <= clip * (1 + 1e-5)
        assert float(utils.global_norm(clipped)) > clip


def test_fp16_optimizer_state_dict_round_trip():
    """A wrapper loaded from another's state_dict (a snapshot) takes the
    same steps, bit for bit."""
    _, a = _wrapper_pair(FP16_Optimizer, jax_fp16.FP16_Optimizer, 0.5)
    for step in range(3):
        a.step(_torch_tree(_tree(40 + step, shapes=((16, 8), (8,), (4, 4)))))
    sd = a.state_dict()
    _, b = _wrapper_pair(FP16_Optimizer, jax_fp16.FP16_Optimizer, 0.5)
    b.load_state_dict(sd)
    for step in range(3):
        g = _tree(50 + step, shapes=((16, 8), (8,), (4, 4)))
        a.step(_torch_tree(g))
        b.step(_torch_tree(g))
    for k in a.fp32_params:
        assert torch.equal(a.fp32_params[k], b.fp32_params[k])
        assert torch.equal(a.params[k], b.params[k])
    assert a.scaler_state == b.scaler_state
    assert a.opt_state.step == b.opt_state.step == 6
    # the snapshot did not move with the steps after it
    assert sd["opt_state"].step == 3


# ------------------------------------------------------------------ #
# runtime/utils
# ------------------------------------------------------------------ #

def test_runtime_utils_match_reference():
    rs = np.random.RandomState(4)
    for n, p in ((10, 3), (7, 7), (3, 5), (100, 8)):
        assert utils.partition_uniform(n, p) == \
            jax_utils.partition_uniform(n, p)
    for _ in range(20):
        w = list(rs.randint(1, 50, rs.randint(0, 30)))
        p = int(rs.randint(1, 9))
        assert utils.partition_balanced(w, p) == \
            jax_utils.partition_balanced(w, p)
    assert utils.call_to_str("F", 1, "a", x=2) == \
        jax_utils.call_to_str("F", 1, "a", x=2)
    tree = _tree(5)
    jt, tt = jax.tree.map(jnp.asarray, tree), _torch_tree(tree)
    np.testing.assert_allclose(float(utils.global_norm(tt)),
                               float(jax_utils.global_norm(jt)), rtol=1e-6)
    np.testing.assert_allclose(float(utils.global_sqnorm(tt)),
                               float(jax_utils.global_sqnorm(jt)),
                               rtol=1e-6)
    assert float(utils.global_sqnorm({})) == 0.0
    for max_norm in (0.5, 1e3):
        tc, tn = utils.clip_by_global_norm(tt, max_norm)
        jc, jn = jax_utils.clip_by_global_norm(jt, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-7)
    bad = dict(tree, w1=np.array([1.0, np.nan], np.float32))
    for g, want in ((tree, False), (bad, True)):
        assert bool(utils.CheckOverflow.has_overflow_serial(
            _torch_tree(g))) == want == bool(
            jax_utils.CheckOverflow.has_overflow_serial(
                jax.tree.map(jnp.asarray, g)))
        assert utils.CheckOverflow().has_overflow(_torch_tree(g)) == want
        assert bool(utils.CheckOverflow().check(_torch_tree(g))) == want


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_torch(norm_type):
    tree = _tree(6)
    mine = [torch.from_numpy(v.copy()) for v in tree.values()]
    ref = [torch.from_numpy(v.copy()).requires_grad_() for v in
           tree.values()]
    for r, v in zip(ref, tree.values()):
        r.grad = torch.from_numpy(v.copy())
    n1 = utils.clip_grad_norm_(mine, 0.3, norm_type)
    n2 = torch.nn.utils.clip_grad_norm_(ref, 0.3, norm_type)
    np.testing.assert_allclose(float(n1), float(n2), rtol=1e-6)
    for a, r in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), r.grad.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_memory_readers_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: its counters are not 0")
    assert utils.memory_status() == jax_utils.memory_status() == {
        "bytes_in_use": 0, "peak_bytes_in_use": 0}
    utils.see_memory_usage("quiet")
    utils.see_memory_usage("loud", force=True)
    assert utils.mem_status("x", reset_max=True) == utils.memory_status()


# ------------------------------------------------------------------ #
# BatchSizeScheduler and the "batch_scheduler" block
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("args", [
    (512, 0.01, 1000, 4), (64, 0.25, 6, 3), (10, 0.5, 3, 1),
    (100, 1.0, 10, 5)])
def test_batch_size_scheduler_matches_reference(args):
    j = jax_bs.BatchSizeScheduler(*args)
    t = bs_schedules.BatchSizeScheduler(*args)
    assert t.schedule == j.schedule
    for _ in range(args[2] + 3):
        j.step()
        t.step()
        assert t.current_batch_size == j.current_batch_size
    t2 = bs_schedules.BatchSizeScheduler(*args)
    t2.load_state_dict(t.state_dict())
    assert t2.state_dict() == j.state_dict()
    assert t2.current_batch_size == j.current_batch_size


def test_batch_scheduler_block_matches_reference():
    """The block parses to the reference's fields; the engines build the
    same scheduler, refuse the same unknown key, and report the same
    current_batch_size step after step."""
    block = {"enabled": True, "min_batch_size_multiplier": 0.25,
             "warmup_num_steps": 4, "num_intervals": 3}
    cfg = dict(BASE, batch_scheduler=block)
    tc, jc = pt_config.TrainingConfig(cfg), jax_config.TrainingConfig(cfg)
    assert (tc.batch_scheduler_enabled, tc.batch_scheduler_params) == (
        jc.batch_scheduler_enabled, jc.batch_scheduler_params)
    params = {"w": np.ones((2, 2), np.float32)}
    batch = np.ones((4, 2), np.float32)
    with jax_kc.override(), kc.override():
        jeng, _, _, _ = deeperspeed_tpu.initialize(
            model=lambda p, b: jnp.sum(p["w"] * jnp.mean(b)),
            model_parameters=params, config=cfg, mesh=_one_device_mesh())
        teng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=lambda p, b: (p["w"] * b.mean()).sum(),
            model_parameters={"w": torch.ones(2, 2)}, config=cfg,
            device="cpu")
        assert (teng.batch_size_scheduler.schedule
                == jeng.batch_size_scheduler.schedule)
        for _ in range(6):
            assert teng.current_batch_size() == jeng.current_batch_size()
            jeng.train_batch(batch)
            teng.train_batch(batch)
        bad = dict(cfg, batch_scheduler=dict(block, ramp=3))
        msgs = []
        for init, kw in ((deeperspeed_tpu.initialize,
                          dict(model_parameters=params,
                               mesh=_one_device_mesh(),
                               model=lambda p, b: jnp.sum(p["w"]))),
                         (deeperspeed_tpu_torch.initialize,
                          dict(model_parameters={"w": torch.ones(2, 2)},
                               device="cpu",
                               model=lambda p, b: p["w"].sum()))):
            with pytest.raises(ValueError, match="unknown keys") as e:
                init(config=bad, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------------------------------ #
# on the card
# ------------------------------------------------------------------ #

@pytest.mark.cuda
def test_sgd_and_fp16_optimizer_on_the_card():
    """SGD (momentum, Nesterov) on CUDA leaves against its CPU run, and
    FP16_Optimizer over the fused Adam kernel skipping an inf step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = _tree(0)
    opt = sgd.SGD(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-2)
    cp, gp = _torch_tree(params), {k: torch.from_numpy(v).cuda()
                                   for k, v in params.items()}
    cs, gs = opt.init(cp), opt.init(gp)
    for step in range(3):
        g = _tree(step + 1)
        cp, cs = opt.update(_torch_tree(g), cs, cp)
        gp, gs = opt.update({k: torch.from_numpy(v).cuda()
                             for k, v in g.items()}, gs, gp)
    for k in params:
        torch.testing.assert_close(gp[k].cpu(), cp[k], rtol=1e-6,
                                   atol=1e-7)
    with kc.override(mode="auto"):
        w = FP16_Optimizer(adam.FusedAdam(lr=1e-3),
                           {k: torch.from_numpy(v).cuda()
                            for k, v in params.items()},
                           dynamic_loss_scale=True,
                           dynamic_loss_args={"init_scale": 2.0 ** 8},
                           verbose=False)
        g = {k: torch.full_like(v, float("inf")) for k, v in
             w.fp32_params.items()}
        assert w.step(g) and w.cur_scale == 2.0 ** 7
