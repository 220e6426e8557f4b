"""Checkpoints of the streamed engine, in the reference's full format:
resume within the port is bit for bit (losses, the card's params, the host
state), on the RAM tier and on the NVMe tier; each package resumes the
other's files; the geometry guard refuses a mismatched engine; named tags
are kept and generated ones pruned."""

import jax
import numpy as np
import pytest

from torch_streaming_common import (batch, jax_cfg, jax_engine, jax_streaming,
                                    params_np, port_engine, rel_l2, scfg,
                                    streaming, tiny_cfg)


@pytest.fixture(autouse=True)
def _quantize_every_leaf(monkeypatch):
    # the tiny model's leaves are all below MIN_QUANT_SIZE
    monkeypatch.setattr(streaming, "MIN_QUANT_SIZE", 0)
    monkeypatch.setattr(jax_streaming, "MIN_QUANT_SIZE", 0)


@pytest.mark.parametrize("profile", [
    dict(wire_bits=4),
    dict(wire_bits=4, resident_bits=4, host_state="bf16"),
])
def test_checkpoint_resume_bitwise(tmp_path, profile):
    sc = scfg(group_layers=1, warmup_steps=0, lr=2e-3, **profile)
    data = batch(seed=3, n=5)
    eng = port_engine(tiny_cfg("bf16"), sc, params_np(dtype="bf16"))
    for i in range(2):
        eng.train_batch(data[i])
    eng.save_checkpoint(str(tmp_path), tag="t")
    cont = [eng.train_batch(data[i]) for i in range(2, 5)]

    eng2 = port_engine(tiny_cfg("bf16"), sc, params_np(seed=1,
                                                       dtype="bf16"))
    assert eng2.load_checkpoint(str(tmp_path), tag="t").endswith("t")
    assert eng2.step_count == 2
    resumed = [eng2.train_batch(data[i]) for i in range(2, 5)]
    np.testing.assert_array_equal(cont, resumed)
    for c in eng.chunk_names:
        for k, v in eng.storage_bytes(c).items():
            np.testing.assert_array_equal(v, eng2.storage_bytes(c)[k])
        np.testing.assert_array_equal(eng.master_params_f32()[c],
                                      eng2.master_params_f32()[c])


def test_checkpoint_resume_nvme_tier(tmp_path):
    """The 20B profile's tiers: v round-trips through the swap files."""
    def mk(folder):
        return scfg(group_layers=1, wire_bits=4, warmup_steps=0, lr=2e-2,
                    resident_bits=4, host_state="bf16", state_device="nvme",
                    swap_states="exp_avg_sq", swap_folder=str(folder),
                    pipeline_swap=False)

    data = batch(seed=9, n=4)
    eng = port_engine(tiny_cfg("bf16"), mk(tmp_path / "s1"),
                      params_np(dtype="bf16"))
    eng.train_batch(data[0])
    eng.save_checkpoint(str(tmp_path / "ck"))
    cont = [eng.train_batch(data[i]) for i in (1, 2, 3)]
    eng2 = port_engine(tiny_cfg("bf16"), mk(tmp_path / "s2"),
                       params_np(dtype="bf16"))
    eng2.load_checkpoint(str(tmp_path / "ck"))
    resumed = [eng2.train_batch(data[i]) for i in (1, 2, 3)]
    np.testing.assert_array_equal(cont, resumed)
    assert all(eng2.shadow_matches_device().values())


@pytest.mark.parametrize("pipeline_swap", [False, True])
def test_checkpoint_reloads_into_the_engine_that_ran_on(tmp_path,
                                                        pipeline_swap):
    """The 20B profile's tiers: a tag of step 2 loaded back into the
    engine after its step 3 (state the load missed would keep step 3's
    values) gives step 3's loss and card bytes again, bit for bit."""
    sc = scfg(group_layers=1, wire_bits=4, warmup_steps=0, lr=2e-2,
              resident_bits=4, host_state="bf16", state_device="nvme",
              swap_states="exp_avg_sq", swap_folder=str(tmp_path / "s"),
              pipeline_swap=pipeline_swap)
    data = batch(seed=9, n=3)
    eng = port_engine(tiny_cfg("bf16"), sc, params_np(dtype="bf16"))
    eng.train_batch(data[0])
    eng.train_batch(data[1])
    eng.save_checkpoint(str(tmp_path / "ck"))
    loss3 = eng.train_batch(data[2])
    card3 = {c: eng.storage_bytes(c) for c in eng.chunk_names}
    eng.load_checkpoint(str(tmp_path / "ck"))
    assert eng.step_count == 2
    assert eng.train_batch(data[2]) == loss3
    for c in eng.chunk_names:
        for k, v in eng.storage_bytes(c).items():
            np.testing.assert_array_equal(v, card3[c][k])
    assert all(eng.shadow_matches_device().values())


def test_checkpoint_resume_all_states_swapped(tmp_path):
    sc = scfg(wire_bits=8, warmup_steps=0, state_device="nvme",
              swap_folder=str(tmp_path / "swap"), pipeline_swap=False)
    data = batch(seed=5, n=3)
    eng = port_engine(tiny_cfg(), sc, params_np())
    eng.train_batch(data[0])
    eng.save_checkpoint(str(tmp_path / "ck"))
    cont = [eng.train_batch(data[i]) for i in (1, 2)]
    sc2 = scfg(wire_bits=8, warmup_steps=0, state_device="nvme",
               swap_folder=str(tmp_path / "swap2"), pipeline_swap=True)
    eng2 = port_engine(tiny_cfg(), sc2, params_np())
    eng2.load_checkpoint(str(tmp_path / "ck"))
    np.testing.assert_array_equal(
        cont, [eng2.train_batch(data[i]) for i in (1, 2)])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """Each package resumes the other's files: the loaded host state is
    the writer's, bit for bit, and both continue alike (the fp32 wire;
    the engines' tolerances of test_torch_streaming_engine.py)."""
    sc = scfg(wire_bits=32, warmup_steps=0, lr=1e-3)
    params = params_np()
    data = batch(seed=6, n=4)
    mk = {"port": lambda: port_engine(tiny_cfg(), sc, params),
          "jax": lambda: jax_engine(jax_cfg(), sc, params)}
    src = mk[writer]()
    for i in range(2):
        src.train_batch(data[i])
    src.save_checkpoint(str(tmp_path))
    dst = mk["port" if writer == "jax" else "jax"]()
    dst.load_checkpoint(str(tmp_path))
    assert dst.step_count == 2
    sm, dm = src.master_params_f32(), dst.master_params_f32()
    for c in src.chunk_names:
        np.testing.assert_array_equal(sm[c], dm[c])
        np.testing.assert_array_equal(src._shadow[c], dst._shadow[c])
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(src._ram[c][k], dst._ram[c][k])
    assert src._rng.bit_generator.state == dst._rng.bit_generator.state
    a = [src.train_batch(data[i]) for i in (2, 3)]
    b = [dst.train_batch(data[i]) for i in (2, 3)]
    np.testing.assert_allclose(a, b, rtol=1e-5)
    sm, dm = src.master_params_f32(), dst.master_params_f32()
    for c in src.chunk_names:
        assert rel_l2(dm[c], sm[c]) <= 1e-5, c


def test_checkpoint_quant_resident_files_cross_packages(tmp_path):
    """The quant-resident shadow file (per-leaf codes, scales and bf16
    leaves in one npz) written by the port loads in the reference."""
    sc = scfg(wire_bits=8, resident_bits=4, host_state="bf16",
              warmup_steps=0, lr=1e-3)
    params = params_np(dtype="bf16")
    eng = port_engine(tiny_cfg("bf16"), sc, params)
    eng.train_batch(batch(seed=2)[0])
    eng.save_checkpoint(str(tmp_path), tag="q")
    ref = jax_engine(jax_cfg("bf16"), sc, params)
    ref.load_checkpoint(str(tmp_path), tag="q")
    for c in eng.chunk_names:
        np.testing.assert_array_equal(ref._shadow_f32(c),
                                      eng._shadow_f32(c))
        storage = (ref._dev_globals if c == "globals"
                   else ref._dev_groups[int(c[1:])])
        dev = np.concatenate([
            np.asarray(x, np.float32).reshape(-1)
            for x in jax.tree.leaves(ref._fetch_device_tree(storage, c))])
        np.testing.assert_array_equal(dev, eng._shadow_f32(c))


def test_checkpoint_latest_and_geometry_guard(tmp_path):
    sc = scfg(group_layers=1, wire_bits=8, warmup_steps=0)
    eng = port_engine(tiny_cfg(), sc, params_np())
    eng.train_batch(batch(seed=1)[0])
    eng.save_checkpoint(str(tmp_path))  # default tag = global_step1
    assert (tmp_path / "latest").read_text() == "global_step1"
    eng2 = port_engine(tiny_cfg(), scfg(group_layers=2, wire_bits=8,
                                        warmup_steps=0), params_np())
    with pytest.raises(ValueError, match="geometry mismatch"):
        eng2.load_checkpoint(str(tmp_path))
    eng3 = port_engine(tiny_cfg(), scfg(group_layers=1, wire_bits=8,
                                        resident_bits=4, warmup_steps=0),
                       params_np())
    with pytest.raises(ValueError, match="geometry mismatch"):
        eng3.load_checkpoint(str(tmp_path))
    eng4 = port_engine(tiny_cfg(), sc, params_np())
    assert eng4.load_checkpoint(str(tmp_path / "empty")) is None
    assert eng4.step_count == 0


def test_checkpoint_retention_user_tags_kept(tmp_path):
    sc = scfg(group_layers=1, wire_bits=8, warmup_steps=0)
    eng = port_engine(tiny_cfg(), sc, params_np())
    data = batch(seed=7, n=4)
    eng.train_batch(data[0])
    eng.save_checkpoint(str(tmp_path), tag="milestone1")
    eng.train_batch(data[1])
    eng.save_checkpoint(str(tmp_path), tag="milestone2")
    assert (tmp_path / "milestone1").is_dir()
    assert (tmp_path / "latest").read_text() == "milestone2"
    eng.train_batch(data[2])
    eng.save_checkpoint(str(tmp_path))          # global_step3
    eng.train_batch(data[3])
    eng.save_checkpoint(str(tmp_path))          # global_step4
    assert not (tmp_path / "global_step3").is_dir()
    assert (tmp_path / "global_step4").is_dir()
    assert (tmp_path / "milestone1").is_dir()
    assert (tmp_path / "milestone2").is_dir()
    # saving a tag again replaces it in place
    eng.save_checkpoint(str(tmp_path), tag="milestone1")
    assert (tmp_path / "latest").read_text() == "milestone1"
    assert not list(tmp_path.glob("*.tmp*")) + list(tmp_path.glob("*.old*"))

    eng2 = port_engine(tiny_cfg(), scfg(group_layers=1, wire_bits=8,
                                        warmup_steps=0,
                                        ckpt_prune_auto_tags=False),
                       params_np())
    eng2.train_batch(data[0])
    eng2.save_checkpoint(str(tmp_path / "k2"))
    eng2.train_batch(data[1])
    eng2.save_checkpoint(str(tmp_path / "k2"))
    assert (tmp_path / "k2" / "global_step1").is_dir()
    assert (tmp_path / "k2" / "global_step2").is_dir()
