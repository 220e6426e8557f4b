"""The PyTorch port stands alone: importing ``deeperspeed_tpu_torch``
loads neither ``jax``, ``flax``, ``msgpack`` nor any module of
``deeperspeed_tpu`` (names are compared exactly, since the port's own
name starts with ``deeperspeed_tpu``), the monitor's and the datapipe's
modules included, no source file of the port, chip_smoke.py or
scripts/torch_first_step_probe.py imports them, and the serving, replica
worker, training and streamed-offload entry points refuse to fall back to
the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deeperspeed_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "deeperspeed_tpu"}


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_forbidden_name_matching_is_exact():
    assert _forbidden("deeperspeed_tpu.serving")
    assert _forbidden("jax.numpy")
    assert _forbidden("msgpack")
    assert not _forbidden("deeperspeed_tpu_torch.checkpoint.msgpack")
    assert not _forbidden("deeperspeed_tpu_torch.serving")
    assert not _forbidden("jaxtyping_like")


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import json, sys\n"
        "import deeperspeed_tpu_torch\n"
        "import deeperspeed_tpu_torch.serving, deeperspeed_tpu_torch.models."
        "convert, deeperspeed_tpu_torch.runtime.config_utils\n"
        "import deeperspeed_tpu_torch.runtime.engine, deeperspeed_tpu_torch."
        "runtime.config, deeperspeed_tpu_torch.runtime.lr_schedules\n"
        "import deeperspeed_tpu_torch.runtime.dataloader, deeperspeed_tpu_"
        "torch.runtime.fp16.loss_scaler, deeperspeed_tpu_torch.ops.adam\n"
        "import deeperspeed_tpu_torch.ops.flash_attention, deeperspeed_tpu_"
        "torch.ops.fused_adam\n"
        "import deeperspeed_tpu_torch.checkpoint.msgpack, deeperspeed_tpu_"
        "torch.checkpoint.serialization\n"
        "import deeperspeed_tpu_torch.checkpoint.zero_to_fp32, deeperspeed_"
        "tpu_torch.resilience.manifest\n"
        "import deeperspeed_tpu_torch.ops.sparse_attention, deeperspeed_tpu_"
        "torch.ops.sparse_attention.block_sparse\n"
        "import deeperspeed_tpu_torch.ops.sparse_attention.kernels, "
        "deeperspeed_tpu_torch.ops.sparse_attention.sparsity_config\n"
        "import deeperspeed_tpu_torch.ops.sparse_attention.sparse_self_"
        "attention, deeperspeed_tpu_torch.ops.sparse_attention.sparse_"
        "attention_utils\n"
        "import deeperspeed_tpu_torch.sharding, deeperspeed_tpu_torch.runtime."
        "zero, deeperspeed_tpu_torch.runtime.comm\n"
        "import deeperspeed_tpu_torch.distributed, deeperspeed_tpu_torch.ops."
        "fused_quant\n"
        "import deeperspeed_tpu_torch.monitor.aggregate, deeperspeed_tpu_"
        "torch.monitor.goodput, deeperspeed_tpu_torch.monitor.reqledger\n"
        "import deeperspeed_tpu_torch.monitor.slo, deeperspeed_tpu_torch."
        "utils.tensorboard, deeperspeed_tpu_torch.serving.metrics\n"
        "import deeperspeed_tpu_torch.runtime.offload.streaming, deeperspeed_"
        "tpu_torch.runtime.offload.swapper, deeperspeed_tpu_torch.ops.aio\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deeperspeed_tpu_torch.serving.engine" in mods
    assert "deeperspeed_tpu_torch.runtime.engine" in mods
    assert "deeperspeed_tpu_torch.ops.flash_attention" in mods
    assert "deeperspeed_tpu_torch.checkpoint.msgpack" in mods
    assert "deeperspeed_tpu_torch.resilience.manifest" in mods
    for name in ("sharding.mesh", "sharding.rules", "sharding.config",
                 "runtime.zero.partition", "runtime.zero.config",
                 "runtime.comm.reducer", "runtime.comm.bucketing",
                 "runtime.comm.collectives", "runtime.comm.compressed",
                 "distributed.topology", "ops.fused_quant"):
        assert f"deeperspeed_tpu_torch.{name}" in mods
    for name in ("monitor", "monitor.tracer", "monitor.runctx",
                 "monitor.flight", "monitor.metrics", "monitor.validate",
                 "monitor.watchdog", "monitor.memwatch", "monitor.perf",
                 "monitor.config", "monitor.aggregate", "monitor.goodput",
                 "monitor.reqledger", "monitor.slo", "utils.tensorboard",
                 "serving.metrics"):
        assert f"deeperspeed_tpu_torch.{name}" in mods
    for name in ("runtime.offload", "runtime.offload.streaming",
                 "runtime.offload.swapper", "runtime.offload.aio_config",
                 "ops.aio", "ops.op_builder"):
        assert f"deeperspeed_tpu_torch.{name}" in mods
    for name in ("block_sparse", "kernels", "sparsity_config",
                 "sparse_self_attention", "sparse_attention_utils"):
        assert f"deeperspeed_tpu_torch.ops.sparse_attention.{name}" in mods
    assert [m for m in mods if _forbidden(m)] == []


def test_input_pipeline_and_follow_ups_load_no_jax():
    """The datapipe, the batch-size scheduler, SGD, the FP16_Optimizer
    wrappers, runtime/utils and resilience/reshard import torch and numpy
    only."""
    code = (
        "import json, sys\n"
        "import deeperspeed_tpu_torch.datapipe, deeperspeed_tpu_torch."
        "datapipe.pipeline, deeperspeed_tpu_torch.datapipe.prefetcher\n"
        "import deeperspeed_tpu_torch.runtime.bs_schedules, deeperspeed_tpu_"
        "torch.ops.sgd, deeperspeed_tpu_torch.runtime.utils\n"
        "import deeperspeed_tpu_torch.runtime.fp16.fused_optimizer, "
        "deeperspeed_tpu_torch.resilience.reshard\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("datapipe", "datapipe.collator", "datapipe.config",
                 "datapipe.curriculum", "datapipe.dataset",
                 "datapipe.pipeline", "datapipe.prefetcher",
                 "datapipe.state", "runtime.bs_schedules", "ops.sgd",
                 "runtime.utils", "runtime.fp16.fused_optimizer",
                 "resilience.reshard"):
        assert f"deeperspeed_tpu_torch.{name}" in mods
    assert [m for m in mods if _forbidden(m)] == []


def test_speculative_decoding_and_fleet_load_no_jax():
    """Speculative decoding, the fleet (router, replicas, the worker) and
    the resilience copies (faults, compute_backoff) import no JAX and
    nothing of the reference."""
    code = (
        "import json, sys\n"
        "import deeperspeed_tpu_torch.models.speculative, deeperspeed_tpu_"
        "torch.serving.spec\n"
        "import deeperspeed_tpu_torch.serving.spec.runtime, deeperspeed_tpu_"
        "torch.serving.spec.steps\n"
        "import deeperspeed_tpu_torch.serving.router, deeperspeed_tpu_torch."
        "serving.fleet, deeperspeed_tpu_torch.serving.replica_worker\n"
        "import deeperspeed_tpu_torch.resilience.faults, deeperspeed_tpu_"
        "torch.resilience.supervisor\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("models.speculative", "serving.spec",
                 "serving.spec.runtime", "serving.spec.steps",
                 "serving.router", "serving.fleet", "serving.replica_worker",
                 "resilience.faults", "resilience.supervisor"):
        assert f"deeperspeed_tpu_torch.{name}" in mods
    assert [m for m in mods if _forbidden(m)] == []


_RUNTIME_MODULES = (
    "resilience.config", "resilience.writer", "resilience.preemption",
    "resilience.manager", "resilience.supervisor", "resilience.reshard",
    "elasticity", "elasticity.constants", "elasticity.elasticity",
    "distributed.config", "distributed.bootstrap",
    "distributed.rendezvous", "distributed.fleet", "utils.distributed",
    "launcher", "launcher.constants", "launcher.runner", "launcher.launch",
    "launcher.multinode_runner")


@pytest.fixture(scope="module")
def runtime_imports():
    """One fresh interpreter imports the slice's modules one by one and
    records, after each, whether it loaded and which forbidden modules
    sys.modules then holds."""
    code = (
        "import importlib, json, sys\n"
        f"names = {list(_RUNTIME_MODULES)!r}\n"
        "out = {}\n"
        "for n in names:\n"
        "    importlib.import_module('deeperspeed_tpu_torch.' + n)\n"
        "    out[n] = sorted(sys.modules)\n"
        "print(json.dumps(out))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", _RUNTIME_MODULES)
def test_resilience_and_multiprocess_runtime_load_no_jax(runtime_imports,
                                                         name):
    """Each module of the resilience and multi-process runtime slice
    imports with neither jax nor any module of the reference in
    sys.modules."""
    mods = runtime_imports[name]
    assert f"deeperspeed_tpu_torch.{name}" in mods
    assert [m for m in mods if _forbidden(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_sources_import_no_jax_and_no_reference_module():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_first_step_probe.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): m for f in files for m in _imports(f)
           if _forbidden(m)}
    assert bad == {}


def test_serving_engine_without_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine would take it")
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.serving import ServingEngine

    cfg = gpt.GPTConfig(vocab_size=17, n_layer=1, n_head=2, d_model=8,
                        dtype=torch.float32)
    params = gpt.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, {"num_slots": 1, "num_blocks": 8,
                                    "max_seq_len": 16})
    with pytest.raises(RuntimeError):
        gpt.init_params(0, cfg)      # the entry points default to CUDA
    eng = ServingEngine(cfg, params, {"num_slots": 1, "num_blocks": 8,
                                      "max_seq_len": 16}, device="cpu")
    assert eng.device.type == "cpu" and eng.kv.k.device.type == "cpu"


def test_replica_worker_without_device_refuses_the_cpu():
    """A replica spec without "device" builds on CUDA: with no card it
    raises, and the worker process would exit non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the worker would take it")
    from deeperspeed_tpu_torch.serving.replica_worker import build_engine

    spec = {"gpt": {"vocab_size": 17, "n_layer": 1, "n_head": 2,
                    "d_model": 8, "max_seq": 16},
            "serving": {"num_slots": 1, "num_blocks": 8, "max_seq_len": 16}}
    with pytest.raises(RuntimeError):
        build_engine(spec)
    eng = build_engine(dict(spec, device="cpu"))
    assert eng.device.type == "cpu"


def test_training_engine_without_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine would take it")
    import deeperspeed_tpu_torch as ds

    cfg = {"train_batch_size": 1}
    params = {"w": torch.ones(2)}
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.initialize(model=lambda p, b: p["w"].sum(),
                      model_parameters=params, config=cfg)
    eng, _, _, _ = ds.initialize(model=lambda p, b: p["w"].sum(),
                                 model_parameters=params, config=cfg,
                                 device="cpu")
    assert eng.params["w"].device.type == "cpu"


def test_streamed_engine_without_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine would take it")
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt

    cfg = gpt.GPTConfig(vocab_size=17, n_layer=1, n_head=2, d_model=8,
                        max_seq=8, dtype=torch.float32, attn_impl="xla")
    conf = {"train_batch_size": 1,
            "streaming": {"wire_bits": 32, "use_native_host": False}}
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.initialize(model=cfg, config=conf)
    eng, _, _, _ = ds.initialize(model=cfg, config=conf, device="cpu")
    assert eng.device.type == "cpu"
    assert eng._dev_globals.device.type == "cpu"


def test_chip_smoke_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
