"""The autotuner's ``"provenance"`` block in the port
(deeperspeed_tpu_torch/autotune/provenance.py, runtime/config.py):

* ``knob_fingerprint``, ``make_provenance`` and ``verify_provenance``
  give the reference's values on the shipped configs and on a tampered
  copy;
* the config checks the block's keys as the reference's does: a block
  that is not a dict, or lacks required keys, raises, naming them;
* every shipped config gets the reference's verdict at worlds 1, 2 and 8
  (accepted, or the same error: a batch triple derived for another
  world, an elasticity bound): no block is refused as unported;
* ``configs/gpt_125m_autotuned.json`` trains 2 steps on 2 gloo ranks
  (tests/torch_gloo_worker.py), its ``fsdp: 8`` cut to ``fsdp: 2`` (8
  processes on a test host would be over the test rules) and with it its
  ``train_batch_size`` 8 -> 2 (micro-batch 1, no accumulation, as
  written) and its comm ``bucket_mb`` 25 -> 0.05 (several buckets on the
  tiny model), on a tiny GPT: ZeRO 2 shards over fsdp, the int8 comm block
  runs, both ranks agree.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from deeperspeed_tpu.autotune import provenance as ref_prov
from deeperspeed_tpu.runtime.config import DeepSpeedConfig
from deeperspeed_tpu_torch.autotune import provenance as prov
from deeperspeed_tpu_torch.runtime.config import ConfigError, TrainingConfig
from tests import torch_gloo_worker as worker
from tests.test_torch_zero_training import TINY, _batches, _params

torch.set_num_threads(1)

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs")
                 .glob("*.json"))
AUTOTUNED = Path(__file__).resolve().parents[1] / "configs" / \
    "gpt_125m_autotuned.json"
STEPS = 2


def _load(path):
    return json.loads(Path(path).read_text())


def test_keys_and_tool_are_the_reference_ones():
    assert prov.TUNED_KEYS == ref_prov.TUNED_KEYS
    assert prov.PROVENANCE_REQUIRED_KEYS == ref_prov.PROVENANCE_REQUIRED_KEYS
    assert prov.TOOL_NAME == ref_prov.TOOL_NAME


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_fingerprint_and_verify_equal_the_reference(path):
    cfg = _load(path)
    assert prov.knob_fingerprint(cfg) == ref_prov.knob_fingerprint(cfg)
    assert prov.verify_provenance(cfg) == ref_prov.verify_provenance(cfg)
    if "provenance" in cfg:
        assert prov.verify_provenance(cfg) == (True, "knob_hash verified")
        tampered = dict(cfg, zero_optimization={"stage": 1})
        got = prov.verify_provenance(tampered)
        assert got == ref_prov.verify_provenance(tampered)
        assert not got[0] and "knob_hash mismatch" in got[1]


def test_make_provenance_equals_the_reference():
    cfg = _load(AUTOTUNED)
    kw = dict(space_hash="cea56750c66a2030", platform="cpu", devices=8,
              predicted_step_s=1.639815139, measured_step_ms=14.1,
              rank_correlation=1.0, rev="585e7c2")
    rec = prov.make_provenance(cfg, **kw)
    assert rec == ref_prov.make_provenance(cfg, **kw)
    assert rec["knob_hash"] == cfg["provenance"]["knob_hash"]


@pytest.mark.parametrize("block,match", [
    (["not", "a", "dict"], "must be the record"),
    ({"tool": "deeperspeed_tpu.autotune"},
     r"missing keys \['space_hash', 'knob_hash', 'platform', 'devices'\]"),
    ({"tool": "t", "space_hash": "s", "knob_hash": "k", "platform": "cpu"},
     r"missing keys \['devices'\]"),
])
def test_bad_block_raises(block, match):
    cfg = dict(_load(AUTOTUNED), provenance=block)
    with pytest.raises(ConfigError, match=match):
        TrainingConfig(cfg, world_size=8)
    with pytest.raises(Exception, match=match):
        DeepSpeedConfig(cfg, world_size=8)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_shipped_configs_get_the_reference_verdict(path):
    def verdict(cls):
        try:
            cls(str(path), world_size=world)
            return None
        except Exception as e:  # the verdict is the error itself
            return type(e).__name__, str(e)

    for world in (1, 2, 8):
        got, want = verdict(TrainingConfig), verdict(DeepSpeedConfig)
        assert got == want, (world, got, want)
        assert got is None or "not ported" not in got[1]


def test_autotuned_config_trains_at_a_cut_world(tmp_path):
    cfg = _load(AUTOTUNED)
    assert cfg["mesh"] == {"fsdp": 8}
    cfg["mesh"] = {"fsdp": 2}
    cfg["train_batch_size"] = 2
    cfg["comm"] = dict(cfg["comm"], bucket_mb=0.05)
    _, _, tparams = _params()
    torch.save(tparams, tmp_path / "params.pt")
    np.save(tmp_path / "batches.npy", np.stack(_batches())[:, :2])
    worker.spawn("config_run", 2, tmp_path, TINY, cfg, STEPS)
    ranks = [json.loads((tmp_path / f"config_rank{r}.json").read_text())
             for r in range(2)]
    for r in ranks:
        assert np.isfinite(r["losses"]).all() and len(r["losses"]) == STEPS
        assert r["losses"] == ranks[0]["losses"]
        assert r["mesh"]["fsdp"] == 2 and r["zero_axis"] == "fsdp"
        assert r["zero_sharded"] > 0
        assert r["comm_mode"] == "int8"
    assert ranks[0]["losses"][1] != ranks[0]["losses"][0]
