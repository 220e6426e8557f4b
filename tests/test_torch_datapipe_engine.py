"""The datapipe in the engine: ``initialize`` -> ``train_batch()`` with no
batch passed, in both packages, from one corpus file.

A 2-layer, width-64 GPT-NeoX trains 4 steps through each package's engine
under a config whose ``"datapipe"`` block has the seq-len curriculum and
prefetching with device staging (the port stages onto the CPU here). The
global batches the two engines consume are equal, and the losses agree
within LOSS_RTOL (fp32 on both sides; the JAX side runs its Pallas kernels
in interpret mode, the port's wrappers their plain versions). Each package
resumes the other's checkpoint mid-stream and continues the same token
stream; a checkpoint saved without datapipe state warns and seeds the
pipe's step; and at 2 gloo ranks each rank's rows are its block of the
reference's global batch."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.datapipe import DataPipeConfig, build_datapipe
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.runtime import engine as pt_engine
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
            rotary=True, parallel_residual=True)
S = 64
# 4 steps, fp32 both sides (tests/test_torch_training.py's LOSS_RTOL)
LOSS_RTOL = 1e-4


def _corpus_file(tmp_path):
    path = tmp_path / "corpus.npy"
    np.save(path, np.random.RandomState(9).randint(0, 97, 40_000)
            .astype(np.uint16))
    return str(path)


def _config(source, world=1, **block):
    dp = dict(source=source, seq_len=S, seed=42, prefetch=True,
              prefetch_depth=2, stage_to_device=True,
              curriculum={"start_seq_len": 16, "warmup_steps": 3,
                          "num_intervals": 4})
    dp.update(block)
    return {
        "train_batch_size": 4 * world,
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "Adam",
                      "params": {"lr": 3e-3, "betas": [0.9, 0.95]}},
        "scheduler": {"type": "WarmupDecayLR",
                      "params": {"warmup_max_lr": 3e-3,
                                 "warmup_num_steps": 3,
                                 "total_num_steps": 50}},
        "gradient_clipping": 0.5,
        "kernels": {"mode": "fused"},
        "datapipe": dp,
    }


def _models():
    jcfg = jax_gpt.GPTConfig(**NEOX, dtype=jnp.float32,
                             attn_impl="pallas_interpret", ce_chunk=0)
    jinit, _, jloss, _ = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(0))
    tcfg = gpt.GPTConfig(**NEOX, dtype=torch.float32,
                         attn_impl="pallas_interpret", ce_chunk=0)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jparams, jloss, tparams, gpt.make_gpt(tcfg)[2]


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _record(engine):
    """Wrap the engine's pipe so every global batch it hands over is kept
    (as numpy)."""
    seen = []
    pull = engine.datapipe.next_global_batch

    def recording():
        batch, placed = pull()
        seen.append(np.asarray(batch))
        return batch, placed

    engine.datapipe.next_global_batch = recording
    return seen


def _jax_engine(jparams, jloss, config):
    eng, _, _, _ = deeperspeed_tpu.initialize(
        model=jloss, model_parameters=jparams, config=config,
        mesh=_one_device_mesh())
    return eng


def _torch_engine(tparams, tloss, config):
    eng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=tloss, model_parameters=tparams, config=config, device="cpu")
    return eng


def test_engines_train_the_same_stream_from_the_datapipe(tmp_path):
    config = _config(_corpus_file(tmp_path))
    jparams, jloss, tparams, tloss = _models()
    with jax_kc.override():
        jeng = _jax_engine(jparams, jloss, config)
        jseen = _record(jeng)
        jl = [float(jeng.train_batch()) for _ in range(4)]
        jstate = jeng.datapipe.state_dict()
        jeng.datapipe.close()
    with kc.override():
        teng = _torch_engine(tparams, tloss, config)
        assert teng.training_dataloader is None
        tseen = _record(teng)
        tl = [float(teng.train_batch()) for _ in range(4)]
        teng.datapipe.close()
    assert len(tseen) == len(jseen) == 4
    for a, b in zip(tseen, jseen):
        assert a.shape == (4, S + 1) and np.array_equal(a, b)
    # the curriculum masked the columns past 16, 32, 48 and 64 tokens
    assert [int((b != 0).any(0).nonzero()[0].max()) for b in tseen] == [
        16, 32, 48, 64]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert teng.datapipe.state_dict() == jstate
    assert teng.global_steps == 4


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_each_package_resumes_the_others_checkpoint(direction, tmp_path):
    """2 steps in one package, save (with batches staged in its queue),
    then the other package loads and trains steps 3-4: the same batches
    as the first package's uninterrupted steps 3-4, the same losses."""
    config = _config(_corpus_file(tmp_path))
    jparams, jloss, tparams, tloss = _models()
    ckpt = str(tmp_path / "ckpt")
    with jax_kc.override(), kc.override():
        make = {"jax": lambda: _jax_engine(jparams, jloss, config),
                "torch": lambda: _torch_engine(tparams, tloss, config)}
        first, second = direction.split("_to_")
        a = make[first]()
        seen_a = _record(a)
        for _ in range(2):
            a.train_batch()
        a.save_checkpoint(ckpt)
        want = [float(a.train_batch()) for _ in range(2)]
        a.datapipe.close()
        b = make[second]()
        seen_b = _record(b)
        b.load_checkpoint(ckpt)
        assert b.global_steps == 2
        assert b.datapipe.state_dict()["step"] == 2
        got = [float(b.train_batch()) for _ in range(2)]
        b.datapipe.close()
    for x, y in zip(seen_b, seen_a[2:]):
        assert np.array_equal(x, y)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_checkpoint_without_datapipe_state_warns_and_seeds_the_step(
        tmp_path, monkeypatch):
    source = _corpus_file(tmp_path)
    config = _config(source)
    plain = {k: v for k, v in config.items() if k != "datapipe"}
    _, _, tparams, tloss = _models()
    ckpt = str(tmp_path / "ckpt")
    said = []
    monkeypatch.setattr(pt_engine.logger, "warning",
                        lambda msg, *a: said.append(msg % a))
    with kc.override():
        old = _torch_engine(tparams, tloss, plain)
        batches = np.random.RandomState(1).randint(0, 97, (3, 4, S + 1))
        for b in batches:
            old.train_batch(b)
        old.save_checkpoint(ckpt)
        new = _torch_engine(tparams, tloss, config)
        new.load_checkpoint(ckpt)
        new.datapipe.close()
    assert any("carries no datapipe state" in m for m in said)
    st = new.datapipe.state_dict()
    assert (st["step"], st["epoch"], st["cursor"]) == (3, 0, 0)


def test_two_ranks_take_their_rows_of_the_reference_global_batch(tmp_path):
    """2 gloo ranks, micro 2 x gas 2 each: every rank pulls the same
    global batch of 8 rows from the pipe and trains on its block of 4;
    the blocks concatenate to the reference's global batch, and one
    DataState (the same on both ranks) names the stream."""
    source = _corpus_file(tmp_path)
    config = _config(source, world=2)
    _, _, tparams, _ = _models()
    torch.save(tparams, tmp_path / "params.pt")
    steps = 3
    worker.spawn("datapipe_rows", 2, tmp_path, NEOX, config, steps)
    rows = [np.load(tmp_path / f"rows{r}.npy") for r in range(2)]
    runs = [json.loads((tmp_path / f"datapipe_rank{r}.json").read_text())
            for r in range(2)]
    ref = build_datapipe(DataPipeConfig.from_dict(
        dict(config["datapipe"], prefetch=False, stage_to_device=False)),
        global_rows=8)
    for i in range(steps):
        want = ref.next_global_batch()[0]
        assert rows[0][i].shape == (4, S + 1)
        assert np.array_equal(np.concatenate([rows[0][i], rows[1][i]]),
                              want)
    assert runs[0]["state"] == runs[1]["state"] == ref.state_dict()
    assert runs[0]["losses"] == runs[1]["losses"]


def test_shipped_datapipe_config_parses_as_in_reference():
    """configs/gpt_125m_datapipe.json as written: both packages' configs
    accept it and build the same DataPipeConfig."""
    from deeperspeed_tpu.runtime import config as jax_config
    from deeperspeed_tpu_torch.runtime import config as pt_config

    path = str(Path(__file__).resolve().parent.parent / "configs"
               / "gpt_125m_datapipe.json")
    t = pt_config.TrainingConfig(path)
    j = jax_config.TrainingConfig(path)
    assert t.datapipe_enabled and j.datapipe_enabled
    assert (t.datapipe_config().__dict__ == j.datapipe_config().__dict__)
    assert t.batch_scheduler_enabled == j.batch_scheduler_enabled
