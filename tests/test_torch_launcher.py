"""The port's launcher/ against the reference's.

Hostfile parsing, the include/exclude resource filters, the world-info
encoding and the per-node process plan give the reference's results
(errors included); the pdsh, ssh and OpenMPI runners build the
reference's commands for the same arguments, but for the per-node module
they launch (``deeperspeed_tpu_torch.launcher.launch``); the per-node
launcher spawns its processes with the rendezvous env and
CUDA_VISIBLE_DEVICES (the reference's TPU_VISIBLE_CHIPS) and propagates a
failing child's exit code; ``--launcher gcloud`` raises."""

import json
import subprocess
import sys

import pytest

from deeperspeed_tpu import launcher as jl
from deeperspeed_tpu.launcher import multinode_runner as jmr
from deeperspeed_tpu_torch import launcher as pl
from deeperspeed_tpu_torch.launcher import multinode_runner as pmr


def _outcome(fn, *args, **kw):
    try:
        return ("ok", json.loads(json.dumps(fn(*args, **kw))))
    except Exception as e:  # noqa: BLE001 - compare the error, too
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("text", [
    "worker-0 slots=4\nworker-1 slots=4\n",
    "\n# comment\nworker-0 slots=2\n\nworker-1 slots=8\n",
    "worker-0 slots=4 extra\n",
    "worker-0 gpus=4\n",
    "worker-0 slots=4\nworker-0 slots=2\n",
])
def test_hostfile_parsing_matches_the_reference(tmp_path, text):
    p = tmp_path / "hostfile"
    p.write_text(text)
    assert _outcome(pl.fetch_hostfile, str(p)) == \
        _outcome(jl.fetch_hostfile, str(p))
    assert pl.fetch_hostfile(str(tmp_path / "missing")) is None


POOL = {"worker-0": 4, "worker-1": 4, "worker-2": 2}


@pytest.mark.parametrize("inc,exc", [
    ("", ""), ("worker-1", ""), ("worker-0:0,2@worker-2", ""),
    ("", "worker-1:1"), ("", "worker-0@worker-2:0"),
    ("worker-0", "worker-1"), ("nope", ""), ("worker-0:9", ""),
    ("worker-2@worker-0", ""),
])
def test_resource_filters_match_the_reference(inc, exc):
    assert _outcome(pl.parse_inclusion_exclusion, POOL, inc, exc) == \
        _outcome(jl.parse_inclusion_exclusion, POOL, inc, exc)


def test_world_info_encoding_matches_the_reference():
    info = {"w0": [0, 1], "w1": [0, 1, 2, 3]}
    assert pl.encode_world_info(info) == jl.encode_world_info(info)


@pytest.mark.parametrize("world,node_rank,procs", [
    ({"w0": [0, 1, 2, 3], "w1": [0, 1, 2, 3]}, 1, 1),
    ({"w0": [0, 1, 2, 3], "w1": [0, 1, 2, 3]}, 1, 4),
    ({"w0": [0, 1, 2], "w1": [0]}, 0, 2),
    ({"w0": [0, 1, 2, 3], "w1": [0, 1, 2, 3]}, 5, 1),
])
def test_process_planning_matches_the_reference(world, node_rank, procs):
    assert _outcome(pl.plan_node_processes, world, node_rank, procs) == \
        _outcome(jl.plan_node_processes, world, node_rank, procs)


def _norm(cmd):
    """A command with the per-node module's package name unified."""
    return [c.replace("deeperspeed_tpu_torch.launcher",
                      "deeperspeed_tpu.launcher") for c in cmd]


RESOURCES = {"w0": [0, 1], "w1": [0, 1]}
ARGV = ["--master_addr", "10.0.0.1", "--procs_per_node", "2", "train.py",
        "--lr", "0.1", "--name", "a b"]


@pytest.mark.parametrize("kind", ["pdsh", "ssh", "openmpi"])
def test_runner_commands_match_the_reference(kind):
    cmds, envs = [], []
    for mod, launcher in ((pmr, pl), (jmr, jl)):
        args = launcher.parse_args(ARGV)
        runner = {"pdsh": lambda: mod.PDSHRunner(args, "B64"),
                  "ssh": lambda: mod.SSHRunner(args, "B64"),
                  "openmpi": lambda: mod.OpenMPIRunner(
                      args, "B64", {"w0": 2, "w1": 2})}[kind]()
        runner.add_export("NCCL_DEBUG", "INFO")
        runner.add_export("SPACED", "--a --b")
        env = {}
        cmds.append(_norm(runner.get_cmd(env, RESOURCES)))
        envs.append(env)
    assert cmds[0] == cmds[1]
    assert envs[0] == envs[1]
    joined = " ".join(cmds[0])
    if kind == "openmpi":
        assert cmds[0][cmds[0].index("-n") + 1] == "4"
    else:
        assert "--world_info=B64" in joined


def test_openmpi_refuses_filters_as_the_reference():
    for mod, launcher in ((pmr, pl), (jmr, jl)):
        args = launcher.parse_args(["--include", "w0"] + ARGV)
        with pytest.raises(ValueError, match="include/exclusion"):
            mod.OpenMPIRunner(args, "B64", {"w0": 2}).get_cmd({}, RESOURCES)


def test_gcloud_launcher_raises():
    with pytest.raises(NotImplementedError, match="no GPU counterpart"):
        pl.main(["--launcher", "gcloud", "train.py"])
    assert not hasattr(pmr, "GCloudRunner")


def test_single_node_launch_spawns_script(tmp_path):
    script = tmp_path / "probe.py"
    script.write_text(
        "import os, json\n"
        "keys = ['RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'LOCAL_WORLD_SIZE',\n"
        "        'DS_PROCESS_ID', 'DS_NUM_PROCESSES',\n"
        "        'DS_COORDINATOR_ADDRESS', 'CUDA_VISIBLE_DEVICES']\n"
        "out = {k: os.environ.get(k) for k in keys}\n"
        "path = os.path.join(os.path.dirname(__file__),\n"
        "                    f\"out_{os.environ['RANK']}.json\")\n"
        "json.dump(out, open(path, 'w'))\n")
    world = pl.encode_world_info({"localhost": [0, 1]})
    proc = subprocess.run(
        [sys.executable, "-m", "deeperspeed_tpu_torch.launcher.launch",
         f"--world_info={world}", "--master_addr=127.0.0.1",
         "--master_port=29999", "--procs_per_node=2", "--node_rank=0",
         str(script)], capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    outs = [json.loads((tmp_path / f"out_{r}.json").read_text())
            for r in (0, 1)]
    assert [o["RANK"] for o in outs] == ["0", "1"]
    assert all(o["WORLD_SIZE"] == "2" and o["LOCAL_WORLD_SIZE"] == "2"
               and o["DS_NUM_PROCESSES"] == "2" for o in outs)
    assert all(o["DS_COORDINATOR_ADDRESS"] == "127.0.0.1:29999"
               for o in outs)
    assert [o["CUDA_VISIBLE_DEVICES"] for o in outs] == ["0", "1"]


def test_failing_child_propagates(tmp_path):
    script = tmp_path / "boom.py"
    script.write_text("import sys; sys.exit(3)\n")
    world = pl.encode_world_info({"localhost": [0]})
    proc = subprocess.run(
        [sys.executable, "-m", "deeperspeed_tpu_torch.launcher.launch",
         f"--world_info={world}", "--node_rank=0", str(script)],
        capture_output=True, timeout=120)
    assert proc.returncode == 3
