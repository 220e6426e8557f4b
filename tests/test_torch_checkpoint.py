"""The port's checkpoints against the JAX reference's.

- The port's msgpack codec writes the bytes ``flax.serialization.to_bytes``
  writes, and reads what flax writes.
- Each package's ``save_tree`` files are read by the other's ``load_tree``;
  at step 0 both engines write byte-identical checkpoint files.
- A tiny GPT saved by one engine after 3 steps resumes in the other and
  continues 3 steps within the curve tolerances of tests/test_torch_
  training.py and tests/test_torch_engine.py (1e-4 fp32, 4e-3 masterless
  bf16) of the resuming engine's own uninterrupted run.
- The port resumed from its own checkpoint, in a fresh engine from other
  weights, is bit-identical to its uninterrupted run.
- Client state, LR-scheduler state, ``load_module_only``, a missing tag,
  ``save_latest=False``, the fallback from a corrupt committed tag, and
  the ``zero_to_fp32`` tool.

Inputs come from numpy with a seed and are handed to both packages."""

import os
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.checkpoint import serialization as jax_ser
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu_torch.checkpoint import msgpack, serialization, zero_to_fp32
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.resilience import manifest
from deeperspeed_tpu_torch.runtime import config as pt_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NEOX = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
            rotary=True, parallel_residual=True)
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
}
PRECISIONS = {
    "fp32": ({}, jnp.float32, torch.float32, 1e-4),
    "bf16_masterless": ({"bf16": {"enabled": True, "master_weights": False}},
                        jnp.bfloat16, torch.bfloat16, 4e-3),
    "bf16_master": ({"bf16": {"enabled": True}}, jnp.bfloat16,
                    torch.bfloat16, 4e-3),
}


class _Pair(NamedTuple):
    step: object
    moments: object


# ------------------------------------------------------------------ #
# the codec
# ------------------------------------------------------------------ #

def _codec_trees():
    rs = np.random.RandomState(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 63, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
            -2 ** 31 - 1, -2 ** 63]
    return {
        "scalars": {"ints": ints, "floats": [0.0, -1.5, 1e300, 3e-3],
                    "flags": (True, False, None)},
        "strings": {"fix": "x" * 31, "str8": "y" * 32, "str16": "z" * 300,
                    "utf8": "é中", "bin": b"\x00\x01",
                    "bin16": bytes(300), "bin32": bytes(70000)},
        "maps": {"small": {str(i): i for i in range(15)},
                 "map16": {str(i): i for i in range(16)}, "empty": {}},
        "arrays": {
            "f32": rs.randn(3, 5).astype(np.float32),
            "f64": rs.randn(4).astype(np.float64),
            "f16": rs.randn(2, 2).astype(np.float16),
            "i32": np.arange(7, dtype=np.int32),
            "i64": np.arange(-3, 3, dtype=np.int64),
            "u8": np.arange(5, dtype=np.uint8), "bool": np.array([True, False]),
            "zero_d": np.asarray(2.5, np.float32),
            "empty": np.zeros((0, 3), np.float32),
            "fixext": np.zeros((), np.int8),
            "ext16": rs.randn(300).astype(np.float32),
            "ext32": rs.randn(20000).astype(np.float32),
            "f_order": np.asfortranarray(rs.randn(3, 4).astype(np.float32)),
        },
        "npscalars": [np.float32(1.25), np.int64(-4), np.bool_(True)],
        "namedtuple": _Pair(np.asarray(3, np.int32), {"m": np.ones(2)}),
    }


def test_codec_writes_the_bytes_flax_writes():
    tree = _codec_trees()
    assert msgpack.to_bytes(tree) == flax_ser.to_bytes(tree)


def test_codec_reads_what_flax_writes():
    tree = _codec_trees()
    back = msgpack.restore(flax_ser.to_bytes(tree))
    want = flax_ser.msgpack_restore(flax_ser.to_bytes(tree))

    def same(a, b):
        if isinstance(b, dict):
            assert list(a) == list(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b

    same(back, want)
    assert isinstance(back["npscalars"]["0"], np.float32)


def test_codec_bf16_and_chunked_arrays_match_flax(monkeypatch):
    """bf16 travels as a torch tensor under the dtype name "bfloat16";
    arrays over MAX_CHUNK_SIZE bytes (made small here, in both packages)
    take flax's chunked form, and both read each other's."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(1)
    x = rs.randn(7, 5).astype(np.float32)
    jtree = {"bf": np.asarray(jnp.asarray(x, jnp.bfloat16)), "f": x,
             "small": x[:2, :2], "nested": {"bf": np.asarray(
                 jnp.asarray(x[0], jnp.bfloat16))}}
    ttree = {"bf": torch.from_numpy(x).bfloat16(), "f": x,
             "small": x[:2, :2], "nested": {"bf": torch.from_numpy(
                 x[0]).bfloat16()}}
    data = flax_ser.to_bytes(jtree)
    assert msgpack.to_bytes(ttree) == data
    back = msgpack.restore(data)
    assert back["bf"].dtype == torch.bfloat16
    assert torch.equal(back["bf"], ttree["bf"])
    np.testing.assert_array_equal(back["f"], x)
    raw = msgpack.restore(data, unchunk=False)
    parts = msgpack.chunked_parts(raw["f"])
    assert len(parts) == 3 and msgpack.leaf_shape(raw["f"]) == (7, 5)
    np.testing.assert_array_equal(np.concatenate(parts).reshape(7, 5), x)
    flax_back = flax_ser.msgpack_restore(msgpack.to_bytes(ttree))
    np.testing.assert_array_equal(np.asarray(flax_back["bf"], np.float32),
                                  ttree["bf"].float().numpy())


def test_codec_restores_structures_and_rejects_what_flax_rejects():
    tree = {"pair": _Pair(np.asarray(1, np.int32), [np.zeros(2), 3])}
    back = msgpack.from_bytes(tree, flax_ser.to_bytes(tree))
    assert isinstance(back["pair"], _Pair)
    assert isinstance(back["pair"].moments, list)
    assert back["pair"].moments[1] == 3
    with pytest.raises(TypeError, match="set"):
        msgpack.to_bytes({"bad": {1, 2}})
    with pytest.raises(ValueError, match="ends early"):
        msgpack.restore(flax_ser.to_bytes(tree)[:-3])


# ------------------------------------------------------------------ #
# files
# ------------------------------------------------------------------ #

def test_save_tree_files_cross_between_packages(tmp_path):
    """Each package's save_tree file loads in the other, and for the same
    tree (unsorted keys included) the two files are byte-identical."""
    rs = np.random.RandomState(2)
    x = rs.randn(6, 3).astype(np.float32)
    jtree = {"z": {"b": x, "a": np.asarray(jnp.asarray(x, jnp.bfloat16))},
             "step": 4, "tag": "global_step4", "none": None,
             "scale": np.float32(2.0)}
    ttree = {"z": {"b": torch.from_numpy(x), "a": torch.from_numpy(
        x).bfloat16()}, "step": 4, "tag": "global_step4", "none": None,
        "scale": np.float32(2.0)}
    jax_ser.save_tree(str(tmp_path / "j.msgpack"), jtree)
    serialization.save_tree(str(tmp_path / "t.msgpack"), ttree)
    host = serialization.to_host(ttree)
    assert list(host) == sorted(ttree) and list(host["z"]) == ["a", "b"]
    assert isinstance(host["z"]["b"], np.ndarray)
    assert host["z"]["a"].dtype == torch.bfloat16
    assert host["scale"].shape == () and host["step"] == 4
    assert msgpack.to_bytes(host) == flax_ser.to_bytes(jax_ser.to_host(
        jtree))
    assert (tmp_path / "j.msgpack").read_bytes() == (
        tmp_path / "t.msgpack").read_bytes()
    assert not list(tmp_path.glob("*.tmp"))
    from_port = jax_ser.load_tree(str(tmp_path / "t.msgpack"))
    np.testing.assert_array_equal(from_port["z"]["b"], x)
    assert str(from_port["z"]["a"].dtype) == "bfloat16"
    assert from_port["step"] == 4 and from_port["none"] is None
    from_jax = serialization.load_tree(str(tmp_path / "j.msgpack"))
    np.testing.assert_array_equal(from_jax["z"]["b"], x)
    assert torch.equal(from_jax["z"]["a"], ttree["z"]["a"])
    assert from_jax["scale"].shape == () and from_jax["tag"] == "global_step4"
    assert list(from_jax) == sorted(ttree)


# ------------------------------------------------------------------ #
# the engines
# ------------------------------------------------------------------ #

def _jax_params(dtype, seed=0):
    cfg = jax_gpt.GPTConfig(**NEOX, dtype=dtype, attn_impl="xla",
                            remat=False, ce_chunk=0)
    init, _, loss, _ = jax_gpt.make_gpt(cfg)
    return init(jax.random.PRNGKey(seed)), loss


def _port_model(jparams, dtype):
    cfg = gpt.GPTConfig(**NEOX, dtype=dtype, attn_impl="xla", remat=False,
                        ce_chunk=0)
    params = convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    return params, gpt.make_gpt(cfg)[2]


def _batches(n=6, rows=4, seed=11):
    rs = np.random.RandomState(seed)
    two = [rs.randint(0, 97, (rows, S + 1)).astype(np.int32)
           for _ in range(2)]
    return [two[i % 2] for i in range(n)]


def _jax_engine(precision, seed=0):
    block, jdt, _, _ = PRECISIONS[precision]
    jparams, jloss = _jax_params(jdt, seed)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    with jax_kc.override():
        eng, *_ = deeperspeed_tpu.initialize(
            model=jloss, model_parameters=jparams, config=dict(BASE, **block),
            mesh=mesh)
    return eng


def _port_engine(precision, seed=0, kernels="off", config=None):
    block, jdt, tdt, _ = PRECISIONS[precision]
    jparams, _ = _jax_params(jdt, seed)
    params, loss = _port_model(jparams, tdt)
    conf = dict(config or BASE, **block)
    conf["kernels"] = {"mode": kernels}
    with kc.override():
        eng, *_ = deeperspeed_tpu_torch.initialize(
            model=loss, model_parameters=params, config=conf, device="cpu")
    return eng


def _train(eng, batches, port):
    with kc.override(**({"mode": "off"} if not port else
                        eng._config.kernels_params or {})):
        return [float(eng.train_batch(b)) for b in batches]


def test_both_engines_write_the_same_files_at_step_zero(tmp_path):
    for precision in PRECISIONS:
        _jax_engine(precision).save_checkpoint(str(tmp_path / "j" / precision),
                                               client_state={"epoch": 1})
        _port_engine(precision).save_checkpoint(
            str(tmp_path / "t" / precision), client_state={"epoch": 1})
        for name in (serialization.model_state_filename(),
                     serialization.optim_state_filename()):
            a = (tmp_path / "j" / precision / "global_step0" / name)
            b = (tmp_path / "t" / precision / "global_step0" / name)
            assert a.read_bytes() == b.read_bytes(), (precision, name)


@pytest.mark.parametrize("precision", ["fp32", "bf16_masterless"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_resumes_in_the_other_engine(tmp_path, precision, writer):
    """3 steps in the writer, save, load in a fresh engine of the other
    package (built from other weights), 3 more steps: the losses equal
    the reader's own uninterrupted run's within the curve tolerance."""
    tol = PRECISIONS[precision][3]
    batches = _batches()
    make = {"port": lambda seed: _port_engine(precision, seed),
            "jax": lambda seed: _jax_engine(precision, seed)}
    reader = "jax" if writer == "port" else "port"
    uninterrupted = _train(make[reader](0), batches, reader == "port")
    first = make[writer](0)
    _train(first, batches[:3], writer == "port")
    first.save_checkpoint(str(tmp_path), client_state={"by": writer})
    second = make[reader](1)
    path, client = second.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step3")
    assert client == {"by": writer}
    assert second.global_steps == 3 and second.get_lr() == first.get_lr()
    resumed = _train(second, batches[3:], reader == "port")
    np.testing.assert_allclose(resumed, uninterrupted[3:], rtol=tol)


def _port_state(eng):
    trees = [eng.params, eng.opt_state.exp_avg, eng.opt_state.exp_avg_sq]
    if eng.master is not None:
        trees.append(eng.master)
    return [t.detach().clone() for tree in trees
            for t in convert._flatten(tree).values()]


@pytest.mark.parametrize("precision", ["bf16_masterless", "bf16_master"])
def test_port_resume_is_bit_identical(tmp_path, precision):
    """Under kernels mode fused (the Adam update through the kernel
    wrapper, plain on the CPU): 6 uninterrupted steps against 3, a save,
    a fresh engine from other weights, a load and 3 more steps."""
    batches = _batches()
    whole = _port_engine(precision, kernels="fused")
    losses = _train(whole, batches, True)
    norm = whole.get_global_grad_norm()
    half = _port_engine(precision, kernels="fused")
    _train(half, batches[:3], True)
    half.save_checkpoint(str(tmp_path))
    fresh = _port_engine(precision, seed=1, kernels="fused")
    fresh.load_checkpoint(str(tmp_path))
    assert fresh.opt_state.step == fresh.optimizer_steps == 3
    assert fresh.lr_scheduler.state_dict() == half.lr_scheduler.state_dict()
    assert _train(fresh, batches[3:], True) == losses[3:]
    assert fresh.get_global_grad_norm() == norm
    for a, b in zip(_port_state(fresh), _port_state(whole)):
        assert torch.equal(a, b)


def test_load_options_tags_and_latest(tmp_path):
    eng = _port_engine("bf16_master")
    batches = _batches()
    _train(eng, batches[:2], True)
    eng.save_checkpoint(str(tmp_path), client_state={"epoch": 7})
    _train(eng, batches[2:3], True)
    eng.save_checkpoint(str(tmp_path), tag="late", save_latest=False)
    assert serialization.read_latest(str(tmp_path)) == "global_step2"
    stub = tmp_path / "late" / zero_to_fp32.RECOVERY_SCRIPT
    assert "deeperspeed_tpu_torch" in stub.read_text()

    # module only: params, counters and schedule restored; the optimizer
    # state stays the fresh engine's, and the master follows the params
    mod = _port_engine("bf16_master", seed=1)
    path, client = mod.load_checkpoint(str(tmp_path), load_module_only=True)
    assert path.endswith("global_step2") and client == {"epoch": 7}
    saved = serialization.load_tree(str(tmp_path / "global_step2" /
                                         serialization.model_state_filename()))
    assert torch.equal(mod.params["lm_head"], saved["module"]["lm_head"])
    assert mod.global_steps == 2 and mod.opt_state.step == 0
    assert float(mod.opt_state.exp_avg["lm_head"].abs().sum()) == 0.0
    assert torch.equal(mod.master["lm_head"],
                       mod.params["lm_head"].float())
    assert mod.lr_scheduler.state_dict() == {"last_batch_iteration": 1}

    # an explicit tag, without the LR-scheduler state
    late = _port_engine("bf16_master", seed=1)
    late.load_checkpoint(str(tmp_path), tag="late",
                         load_lr_scheduler_states=False)
    assert late.global_steps == 3 and late.opt_state.step == 3
    assert late.lr_scheduler.state_dict() == {"last_batch_iteration": -1}
    for a, b in zip(_port_state(late), _port_state(eng)):
        assert torch.equal(a, b)

    # nothing to load
    empty = tmp_path / "empty"
    empty.mkdir()
    assert late.load_checkpoint(str(empty)) == (None, {})
    assert late.load_checkpoint(str(empty), tag="global_step9") == (None, {})


def test_corrupt_committed_tag_falls_back_to_the_newest_valid_one(tmp_path):
    eng = _port_engine("fp32")
    batches = _batches()
    _train(eng, batches[:1], True)
    eng.save_checkpoint(str(tmp_path))
    _train(eng, batches[1:2], True)
    eng.save_checkpoint(str(tmp_path))
    newest = tmp_path / "global_step2"
    manifest.write_manifest(str(newest))
    (newest / manifest.COMMITTED_MARKER).write_text("ok\n")
    assert manifest.tag_status(str(newest)) == "committed"
    model = newest / serialization.model_state_filename()
    data = bytearray(model.read_bytes())
    data[-1] ^= 0xFF
    model.write_bytes(bytes(data))
    assert manifest.tag_status(str(newest)) == "corrupt"
    fresh = _port_engine("fp32", seed=1)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step1") and fresh.global_steps == 1


def test_zero_to_fp32_cli_and_stub(tmp_path):
    """The tool consolidates the fp32 master (bf16 with a master) or the
    module (fp32 training), through its main() and through the stub the
    save drops into the tag directory; the reference reads its output."""
    eng = _port_engine("bf16_master")
    _train(eng, _batches()[:1], True)
    eng.save_checkpoint(str(tmp_path / "ck"))
    out = tmp_path / "fp32.msgpack"
    zero_to_fp32.main([str(tmp_path / "ck"), str(out)])
    got = jax_ser.load_tree(str(out))
    for k, t in convert._flatten(eng.master).items():
        node = got
        for part in k.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node, t.numpy())
    stub_out = tmp_path / "stub.msgpack"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, zero_to_fp32.RECOVERY_SCRIPT, ".", str(stub_out)],
        cwd=tmp_path / "ck" / "global_step1", env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "fp32 elements" in res.stdout
    assert stub_out.read_bytes() == out.read_bytes()
    fp32 = _port_engine("fp32")
    fp32.save_checkpoint(str(tmp_path / "f"))
    state = serialization.consolidate_fp32_state(str(tmp_path / "f" /
                                                     "global_step0"))
    np.testing.assert_array_equal(state["lm_head"],
                                  fp32.params["lm_head"].detach().numpy())


def test_unported_layouts_raise_naming_their_roadmap_item(tmp_path):
    with pytest.raises(pt_config.ConfigError, match="Sharded checkpoints"):
        pt_config.TrainingConfig(dict(BASE, checkpoint={"sharded_io": True}))
    pt_config.TrainingConfig(dict(BASE, checkpoint={"sharded_io": False}))
    (tmp_path / "t" / serialization.SHARDED_STATE_DIR).mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="Sharded checkpoints"):
        serialization.consolidate_fp32_state(str(tmp_path / "t"))
    (tmp_path / "latest").write_text("t")
    with pytest.raises(NotImplementedError, match="Sharded checkpoints"):
        _port_engine("fp32").load_checkpoint(str(tmp_path))
    assert serialization.validate_tag_across_processes("t", True)
