"""The port's launcher and elasticity against the JAX package's, on the CPU.

* hostfile parsing, ``--include`` / ``--exclude`` and the world-info
  encoding give JAX's results (or JAX's exception);
* the multinode commands (ssh, pdsh, openmpi, mpich, impi, mvapich,
  slurm) equal JAX's up to the launch module's name, the ``EXPORT_ENVS``
  names and the rendezvous (``MASTER_ADDR`` / ``MASTER_PORT`` where JAX
  exports ``COORDINATOR_ADDRESS``);
* a local launch runs a script that sees the env contract, a child's
  failure propagates, ``wait_all`` tears siblings down, escalates to
  SIGKILL and forwards signals, and the ``--elastic_training`` restart
  loop restarts, gives up, stops on an operator's signal and keeps a
  sliding budget;
* ``compute_elastic_config`` gives JAX's result or JAX's exception over a
  ``hypothesis`` grid of v0.1 / v0.2 configs and world sizes;
* the port's ``DeepSpeedConfig`` gives JAX's batch trio for an
  ``elasticity`` block.

Every subprocess runs under a hard timeout.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepspeed_tpu.elasticity import compute_elastic_config as jcompute
from deepspeed_tpu.launcher import constants as jconst
from deepspeed_tpu.launcher import multinode_runner as jmn
from deepspeed_tpu.launcher import runner as jrunner
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.elasticity import compute_elastic_config as tcompute
from deepspeed_tpu_torch.launcher import constants as tconst
from deepspeed_tpu_torch.launcher import multinode_runner as tmn
from deepspeed_tpu_torch.launcher import runner as trunner
from deepspeed_tpu_torch.resilience import ResilienceMetrics
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from torch_port_common import single_process_env  # noqa: F401 (autouse)

TIMEOUT = 120


@pytest.fixture(autouse=True)
def _no_node_range(monkeypatch):
    monkeypatch.delenv("DS_ELASTIC_NODE_RANGE", raising=False)
    monkeypatch.delenv("DEEPSPEED_ELASTICITY_CONFIG", raising=False)


def _outcome(fn, *args, **kwargs):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(*args, **kwargs), None
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return None, (type(e).__name__, str(e))


# --------------------------------------------------------------------- #
# Host pool
# --------------------------------------------------------------------- #
HOSTFILES = {
    "mixed": "# comment\nworker-0 slots=4\nworker-1 slots=2\nworker-2\n",
    "blank_lines": "\n\na slots=1  # trailing\n\nb slots=8\n",
    "duplicate": "h slots=2\nh slots=4\n",
    "malformed": "h slots=2 extra\n",
    "bad_slots": "h slots=x\n",
}


@pytest.mark.parametrize("name", list(HOSTFILES))
def test_fetch_hostfile_matches_jax(tmp_path, name):
    path = tmp_path / "hostfile"
    path.write_text(HOSTFILES[name])
    got = _outcome(trunner.fetch_hostfile, str(path))
    assert got == _outcome(jrunner.fetch_hostfile, str(path))
    assert trunner.fetch_hostfile(str(tmp_path / "missing")) is None


FILTERS = [("w0:0,2@w1", ""), ("", "w0:1,3@w1"), ("w0", "w0"),
           ("w2", ""), ("w0:7", ""), ("w1:1", ""), ("", "w0@w1"),
           ("", "w1:0,1"), ("", "")]


@pytest.mark.parametrize("inc,exc", FILTERS)
def test_inclusion_exclusion_matches_jax(inc, exc):
    pool = {"w0": 4, "w1": 2}
    got = _outcome(trunner.parse_inclusion_exclusion, pool, inc, exc)
    assert got == _outcome(jrunner.parse_inclusion_exclusion, pool, inc, exc)


@pytest.mark.parametrize("info", [{"a": [0, 1], "b": [0]},
                                  {"localhost": [0]},
                                  {"n-0": [0, 2, 3], "n-1": [1]}])
def test_world_info_round_trip_matches_jax(info):
    enc = trunner.encode_world_info(info)
    assert enc == jrunner.encode_world_info(info)
    assert trunner.decode_world_info(enc) == info


# --------------------------------------------------------------------- #
# Multinode commands
# --------------------------------------------------------------------- #
#: the JAX package's exported variables and the port's in their place
RENAMED = {"XLA_FLAGS": "CUDA_VISIBLE_DEVICES", "JAX_PLATFORMS": "CUDA_HOME"}


def _to_port(tokens):
    """JAX's command in the port's names: the launch module, the exported
    variables, and ``COORDINATOR_ADDRESS=host:port`` as ``MASTER_ADDR`` /
    ``MASTER_PORT`` in the same form."""
    out, i = [], 0
    while i < len(tokens):
        tok = tokens[i].replace("deepspeed_tpu.launcher.launch",
                                "deepspeed_tpu_torch.launcher.launch")
        tok = RENAMED.get(tok, tok)                  # -genv NAME VALUE
        for a, b in RENAMED.items():                 # NAME=VALUE
            tok = tok.replace(f"{a}=", f"{b}=")
        if tok == "COORDINATOR_ADDRESS":            # -genv NAME VALUE
            addr, port = tokens[i + 1].split(":")
            out += ["MASTER_ADDR", addr, tokens[i - 1], "MASTER_PORT", port]
            i += 2
            continue
        if tok.startswith("COORDINATOR_ADDRESS="):  # -x / env NAME=VALUE
            addr, port = tok.split("=", 1)[1].split(":")
            extra = [out[-1]] if out and out[-1] == "-x" else []
            out += [f"MASTER_ADDR={addr}", *extra, f"MASTER_PORT={port}"]
            i += 1
            continue
        out.append(tok)
        i += 1
    return out


@pytest.fixture
def exported_env(monkeypatch):
    """Every exported variable of either package set, the renamed ones to
    one value under both names; ``TPU_CHIPS_PER_HOST`` (JAX only, no
    counterpart) unset."""
    assert set(jconst.EXPORT_ENVS) - set(RENAMED) - set(tconst.EXPORT_ENVS) \
        == {"TPU_CHIPS_PER_HOST"}
    assert set(tconst.EXPORT_ENVS) - set(jconst.EXPORT_ENVS) == \
        set(RENAMED.values())
    for name in set(jconst.EXPORT_ENVS) | set(tconst.EXPORT_ENVS):
        monkeypatch.setenv(name, "0,1")
    monkeypatch.delenv("TPU_CHIPS_PER_HOST")


@pytest.mark.parametrize("launcher", ["ssh", "pdsh"])
def test_ssh_and_pdsh_commands_match_jax(exported_env, launcher):
    argv = ["--master_port", "12345", "--launcher", launcher,
            "--launcher_args", "-p 22", "train.py", "--foo", "a b"]
    info = {"w0": [0, 1], "w1": [0, 1]}
    got = trunner.build_multinode_cmds(trunner.parse_args(argv), info, "w0")
    want = jrunner.build_multinode_cmds(jrunner.parse_args(argv), info, "w0")
    assert got == [_to_port(c) for c in want]
    assert all("deepspeed_tpu_torch.launcher.launch" in c[-1] for c in got)


@pytest.mark.parametrize("name", ["openmpi", "mpich", "impi", "mvapich",
                                  "slurm"])
def test_scheduler_commands_match_jax(exported_env, tmp_path, name):
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("worker-0 slots=4\nworker-1 slots=4\n")
    argv = [f"--hostfile={hostfile}", f"--launcher={name}",
            "--launcher_args=--foo", "train.py", "--lr", "0.1"]
    pool = {"worker-0": [0, 1, 2, 3], "worker-1": [0, 1, 2, 3]}
    cmds = []
    for mn, runner in ((tmn, trunner), (jmn, jrunner)):
        cmd = mn.RUNNERS[name](runner.parse_args(argv), pool, "worker-0",
                               29500).get_cmd()
        if "-hostfile" in cmd:          # a temp file of its own each
            i = cmd.index("-hostfile") + 1
            with open(cmd[i]) as f:
                cmd[i] = f.read()
        cmds.append(cmd)
    got, want = cmds
    assert got == _to_port(want)
    assert "MASTER_ADDR" in " ".join(got) and \
        "COORDINATOR_ADDRESS" not in " ".join(got)


def test_uneven_slots_raise_as_jax(tmp_path):
    pool = {"a": [0, 1], "b": [0]}
    out = [_outcome(lambda: mn.MPICHRunner(
        runner.parse_args(["--launcher=mpich", "x.py"]), pool, "a",
        29500).get_cmd()) for mn, runner in ((tmn, trunner),
                                             (jmn, jrunner))]
    assert out[0] == out[1] and out[0][1][0] == "ValueError"


# --------------------------------------------------------------------- #
# Local launch and its teardown
# --------------------------------------------------------------------- #
CONTRACT = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "NNODES", "NODE_RANK", "COORDINATOR_ADDRESS")


def _launch(info, script, timeout=TIMEOUT):
    return subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         f"--world_info={trunner.encode_world_info(info)}",
         "--node_rank=0", "--master_addr=localhost",
         "--master_port=23456", "--", str(script)],
        capture_output=True, text=True, timeout=timeout)


def test_local_launch_sets_the_env_contract(tmp_path):
    out = tmp_path / "out"
    script = tmp_path / "child.py"
    script.write_text(
        "import json, os\n"
        f"keys = {CONTRACT!r}\n"
        f"open(r'{out}' + os.environ['RANK'], 'w').write(json.dumps(\n"
        "    {k: os.environ.get(k) for k in keys}))\n")
    proc = _launch({"localhost": [0, 1]}, script)
    assert proc.returncode == 0, proc.stderr
    for rank in (0, 1):
        env = json.loads((tmp_path / f"out{rank}").read_text())
        assert env == {"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                       "MASTER_PORT": "23456", "NNODES": "1",
                       "NODE_RANK": "0", "COORDINATOR_ADDRESS": None}


def test_launch_propagates_child_failure(tmp_path):
    script = tmp_path / "boom.py"
    script.write_text("import sys; sys.exit(3)\n")
    assert _launch({"localhost": [0]}, script).returncode == 3


def _sleeper(seconds=60.0):
    return subprocess.Popen(
        [sys.executable, "-c", f"import time; time.sleep({seconds})"],
        start_new_session=True)


def test_wait_all_terminates_siblings_on_first_failure():
    bad = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"],
                           start_new_session=True)
    hung = _sleeper()
    t0 = time.monotonic()
    assert trunner.wait_all([bad, hung], poll_s=0.02, term_grace_s=1.0) == 3
    assert time.monotonic() - t0 < 10.0
    assert hung.poll() is not None


def test_wait_all_escalates_sigkill():
    stubborn = subprocess.Popen(
        [sys.executable, "-c",
         "import signal, sys, time; signal.signal(signal.SIGTERM, "
         "signal.SIG_IGN); print('ready', flush=True); time.sleep(60)"],
        start_new_session=True, stdout=subprocess.PIPE, text=True)
    assert stubborn.stdout.readline().strip() == "ready"
    bad = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(2)"],
                           start_new_session=True)
    assert trunner.wait_all([bad, stubborn], poll_s=0.02,
                            term_grace_s=0.3) == 2
    assert stubborn.wait(timeout=10) == -signal.SIGKILL


def test_wait_all_spawn_failure_tears_down_started_launchers():
    """A fork / exec failure mid-spawn must not orphan the launchers that
    already started (each lives in a session of its own)."""
    sleeper = [sys.executable, "-c", "import time; time.sleep(61.7329)"]
    rc = trunner.wait_all(spawn=[sleeper, ["/nonexistent-binary-xyz"]],
                          poll_s=0.02, term_grace_s=1.0)
    assert rc != 0
    time.sleep(0.2)
    assert not subprocess.run(
        ["pgrep", "-f", "time.sleep[(]61.7329[)]"], capture_output=True,
        timeout=TIMEOUT).stdout.strip()


def test_wait_all_forwards_signals_to_child_groups():
    child = _sleeper()
    threading.Timer(0.2, lambda: os.kill(os.getpid(),
                                         signal.SIGTERM)).start()
    rc = trunner.wait_all([child], poll_s=0.02, term_grace_s=1.0)
    assert rc == 128 + signal.SIGTERM
    assert child.wait(timeout=10) is not None


# --------------------------------------------------------------------- #
# The elastic restart loop
# --------------------------------------------------------------------- #
def _flaky(tmp_path, succeed_at, fail_code=1, sleep_s=0.0):
    marker = tmp_path / "attempts"
    script = tmp_path / "flaky.py"
    script.write_text(
        "import pathlib, sys, time\n"
        f"p = pathlib.Path(r'{marker}')\n"
        "n = int(p.read_text()) if p.exists() else 0\n"
        "p.write_text(str(n + 1))\n"
        f"time.sleep({sleep_s})\n"
        f"sys.exit(0 if n >= {succeed_at} else {fail_code})\n")
    return marker, script


def _elastic(script, *extra, metrics=None):
    return trunner.main([
        "--hostfile", "/nonexistent", "--num_gpus", "1",
        "--elastic_training", "--restart_backoff_s", "0.01", *extra,
        str(script)], metrics=metrics)


def test_elastic_restart_loop_relaunches(tmp_path):
    """A failed worker group is relaunched, with one ``crash`` restart
    recorded at world 1 -> 1."""
    marker, script = _flaky(tmp_path, succeed_at=1)
    metrics = ResilienceMetrics()
    assert _elastic(script, "--max_restarts", "2", metrics=metrics) == 0
    assert marker.read_text() == "2"
    snap = metrics.snapshot()
    assert (snap["restart_total"], snap["restart_crash"],
            snap["world_size"]) == (1.0, 1.0, 1.0)
    assert metrics.last_restart_backoff_s > 0


def test_elastic_restart_gives_up(tmp_path):
    script = tmp_path / "alwaysfail.py"
    script.write_text("import sys; sys.exit(5)\n")
    assert _elastic(script, "--max_restarts", "1") == 5


def test_elastic_stops_on_operator_signal(tmp_path):
    script = tmp_path / "sleeper.py"
    script.write_text("import time; time.sleep(60)\n")
    metrics = ResilienceMetrics()
    threading.Timer(1.0, lambda: os.kill(os.getpid(),
                                         signal.SIGTERM)).start()
    rc = _elastic(script, "--max_restarts", "3", metrics=metrics)
    assert rc == 128 + signal.SIGTERM
    assert metrics.restarts == 0


def test_elastic_budget_is_sliding_window(tmp_path):
    """--max_restarts 1 within a 0.2 s window: two failures of 0.3 s each
    still finish, the window sliding past each restart.  They exit 143: a
    worker group whose code only looks like a signal is a crash to
    restart, not an operator's stop."""
    marker, script = _flaky(tmp_path, succeed_at=2, fail_code=143,
                            sleep_s=0.3)
    assert _elastic(script, "--max_restarts", "1",
                    "--restart_window_s", "0.2") == 0
    assert marker.read_text() == "3"


# --------------------------------------------------------------------- #
# Elasticity
# --------------------------------------------------------------------- #
_elastic_block = st.fixed_dictionaries({
    "enabled": st.just(True),
    "max_train_batch_size": st.integers(1, 3000),
    "micro_batch_sizes": st.lists(st.integers(1, 24), min_size=1,
                                  max_size=4),
    "version": st.sampled_from([0.1, 0.2]),
}, optional={
    "min_gpus": st.integers(0, 16), "max_gpus": st.integers(1, 512),
    "num_gpus_per_node": st.sampled_from([1, 2, 4, 8]),
    "model_parallel_size": st.sampled_from([1, 2, 3, 4]),
    "prefer_larger_batch": st.booleans(),
})


@settings(max_examples=150, deadline=None, database=None)
@given(block=_elastic_block, world_size=st.integers(0, 64),
       micro=st.booleans())
def test_compute_elastic_config_matches_jax(block, world_size, micro):
    cfg = {"elasticity": block}
    got = _outcome(tcompute, cfg, "0.1.0", world_size=world_size,
                   return_microbatch=micro)
    want = _outcome(jcompute, cfg, "0.1.0", world_size=world_size,
                    return_microbatch=micro)
    assert got == want


@pytest.mark.parametrize("cfg,version", [
    ({"elasticity": {"enabled": False}}, "0.1.0"),
    ({"elasticity": {"enabled": True}}, "0.1.0"),
    ({"elasticity": {"enabled": True, "max_train_batch_size": 100,
                     "micro_batch_sizes": [2], "version": 0.1}}, "0.0.1"),
    ({"elasticity": {"enabled": True, "max_train_batch_size": 100,
                     "micro_batch_sizes": [2], "version": 0.3}}, "0.1.0"),
    ({"train_batch_size": 8}, "0.1.0"),
])
def test_elastic_config_errors_match_jax(cfg, version):
    got = _outcome(tcompute, cfg, version)
    assert got == _outcome(jcompute, cfg, version) and got[1] is not None


ELASTIC_BLOCKS = [
    {"enabled": True, "max_train_batch_size": 1024,
     "micro_batch_sizes": [2, 4], "min_gpus": 1, "max_gpus": 64,
     "version": 0.2, "num_gpus_per_node": 1},
    {"enabled": True, "max_train_batch_size": 2048,
     "micro_batch_sizes": [2, 4, 8], "num_gpus_per_node": 8,
     "model_parallel_size": 2, "version": 0.2},
    {"enabled": True, "max_train_batch_size": 16,
     "micro_batch_sizes": [4], "version": 0.1},
    {"enabled": True, "max_train_batch_size": 100,
     "micro_batch_sizes": [3, 5], "version": 0.1},
]


def _trio(cls, block, world_size, extra=None):
    def run():
        cfg = cls({"optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                   "elasticity": block, **(extra or {})})
        cfg.resolve_batch_size(1, world_size=world_size)
        return (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
                cfg.gradient_accumulation_steps)
    return _outcome(run)


@pytest.mark.parametrize("world_size", [0, 1, 8, 16])
@pytest.mark.parametrize("block", range(len(ELASTIC_BLOCKS)))
def test_engine_config_elastic_trio_matches_jax(block, world_size):
    got = _trio(TConfig, ELASTIC_BLOCKS[block], world_size)
    assert got == _trio(JConfig, ELASTIC_BLOCKS[block], world_size)
    assert got[1] is None or "A7" not in got[1][1]


def test_engine_config_elastic_refusals_match_jax(monkeypatch):
    block = ELASTIC_BLOCKS[0]
    both = {"train_micro_batch_size_per_gpu": 2}
    got = _trio(TConfig, block, 1, both)
    assert got == _trio(JConfig, block, 1, both)
    assert got[1][0] == "ValueError"
    ok = dict(block, ignore_non_elastic_batch_info=True)
    assert _trio(TConfig, ok, 1, both) == _trio(JConfig, ok, 1, both)
    # a scheduler fixed another block at submission time
    monkeypatch.setenv("DEEPSPEED_ELASTICITY_CONFIG",
                       '{"enabled": true, "max_train_batch_size": 512, '
                       '"micro_batch_sizes": [2, 4], "version": 0.2}')
    got = _trio(TConfig, block, 1)
    assert got == _trio(JConfig, block, 1)
    assert got[1][0] == "ElasticityConfigError"
    # the engine's one-device rule still holds
    cfg = TConfig({"elasticity": block})
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        cfg.resolve_batch_size(8)
