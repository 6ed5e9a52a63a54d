"""The port's JobSupervisor and its policy pieces against the JAX package's,
on the CPU.

* The scripted worker of ``tests/unit/test_supervisor.py`` (stdlib only: it
  imports neither package) runs under both supervisors, side by side, for
  a crash, a death before the first beat, a startup stall, a hang with a
  stack dump, a SIGTERM-proof hang (SIGKILL escalation), an exhausted
  restart budget and a host blacklisted into an elastic downsize: equal
  sequences of ``(event, reason, attempt, hosts)`` and equal counters.
* ``BackoffPolicy`` (jitter off), ``RestartBudget`` and ``HostBlacklist``
  give JAX's answers over ``hypothesis`` sequences.
* A supervised launcher: SIGUSR1 (the dump request) kills the launcher,
  whose worker lives in a session of its own and survives the teardown,
  in both packages alike.
* The port's ``supervisor_smoke`` (crash and hang variants over workers
  training the port's engine) passes on the CPU.

Every subprocess runs under a hard timeout.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepspeed_tpu import resilience as jres
from deepspeed_tpu.launcher import runner as jrunner
from deepspeed_tpu_torch import resilience as tres
from deepspeed_tpu_torch.launcher import runner as trunner
from torch_port_common import single_process_env  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jres, "port": tres}
TIMED = ("save_latency_s", "mean_save_latency_s")

_WORKER = r"""
import json, os, signal, sys, time

HB = os.environ["DS_HEARTBEAT_FILE"]

def beat(step):
    tmp = HB + ".t"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "step": step, "time": time.time()}, f)
    os.replace(tmp, HB)

mode = sys.argv[1]
if mode == "ok":                     # beat briefly, exit clean
    for i in range(5):
        beat(i); time.sleep(0.02)
    sys.exit(0)
elif mode == "slow":                 # keep beating until terminated
    i = 0
    while True:
        beat(i); time.sleep(0.02); i += 1
elif mode.startswith("crash"):       # beat, then die nonzero
    for i in range(3):
        beat(i); time.sleep(0.02)
    sys.exit(int(mode.split("_")[1]))
elif mode == "die_unbeaten":         # die before the FIRST beat
    sys.exit(11)
elif mode == "never_beat":           # alive but never beats
    time.sleep(60)
elif mode == "stubborn":             # stalls and ignores SIGTERM / SIGUSR1
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGUSR1, signal.SIG_IGN)
    for i in range(3):
        beat(i); time.sleep(0.02)
    time.sleep(60)
elif mode == "dump":                 # stall with a faulthandler installed
    import faulthandler
    faulthandler.register(signal.SIGUSR1,
                          file=open(os.environ["DS_STACKDUMP_FILE"], "w"),
                          all_threads=True)
    for i in range(3):
        beat(i); time.sleep(0.02)
    time.sleep(60)
else:
    sys.exit(99)
"""

#: supervisors stopped at teardown even when an assertion fails
_LIVE = []


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.delenv("DS_ELASTIC_NODE_RANGE", raising=False)
    yield
    for sup in _LIVE:
        try:
            sup.stop()
        except Exception:
            pass
    _LIVE.clear()


@pytest.fixture
def worker_script(tmp_path):
    path = tmp_path / "worker.py"
    path.write_text(_WORKER)
    return str(path)


def _supervisor(pkg, worker_script, run_dir, modes_by_attempt, hosts,
                **kwargs):
    def spec_fn(current_hosts, attempt):
        key = attempt if attempt in modes_by_attempt \
            else max(k for k in modes_by_attempt if k <= attempt)
        modes = modes_by_attempt[key]
        return [pkg.WorkerSpec(host=h, cmd=[sys.executable, worker_script,
                                            modes.get(h, "ok")])
                for h in current_hosts]

    defaults = dict(run_dir=run_dir, heartbeat_interval_s=0.2,
                    hang_timeout_s=1.0, poll_s=0.02, term_grace_s=1.0,
                    dump_grace_s=0.5,
                    backoff=pkg.BackoffPolicy(base_s=0.02, jitter=0.0),
                    max_restarts=3, blacklist_after=3)
    defaults.update(kwargs)
    sup = pkg.JobSupervisor(spec_fn, list(hosts), **defaults)
    _LIVE.append(sup)
    return sup


def _trace(sup):
    out = []
    for e in sup.events:
        hosts = e.get("hosts", e.get("host"))
        out.append((e["event"], e.get("reason"), e.get("attempt"),
                    tuple(hosts) if isinstance(hosts, list) else hosts))
    return out


ELASTIC = {"elasticity": {"enabled": True, "max_train_batch_size": 12,
                          "micro_batch_sizes": [1], "version": 0.1}}
#: name: (modes by attempt, hosts, supervisor kwargs)
CASES = {
    "crash": ({0: {"h0": "crash_7", "h1": "slow"}, 1: {}}, ("h0", "h1"),
              {}),
    "startup_death": ({0: {"h0": "die_unbeaten", "h1": "slow"}, 1: {}},
                      ("h0", "h1"), {}),
    "startup_stall": ({0: {"h0": "never_beat", "h1": "slow"}, 1: {}},
                      ("h0", "h1"), {"startup_timeout_s": 0.5}),
    "hang_with_dump": ({0: {"h0": "dump", "h1": "slow"}, 1: {}},
                       ("h0", "h1"), {"hang_timeout_s": 0.4}),
    "stubborn_escalation": ({0: {"h0": "stubborn"}}, ("h0",),
                            {"hang_timeout_s": 0.3, "term_grace_s": 0.3,
                             "max_restarts": 0}),
    "budget_exhausted": ({0: {"h0": "crash_5"}}, ("h0",),
                         {"max_restarts": 2}),
    "blacklist_elastic_downsize": (
        {0: {"h0": "slow", "h1": "slow", "h2": "crash_3"}, 1: {}},
        ("h0", "h1", "h2"), {"blacklist_after": 1,
                             "elastic_config": ELASTIC}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_supervisor_decides_as_jax(worker_script, tmp_path, case):
    modes, hosts, kwargs = CASES[case]
    sups = {}
    for name, pkg in PACKAGES.items():
        sups[name] = _supervisor(pkg, worker_script,
                                 str(tmp_path / name / "run"), modes,
                                 hosts, **kwargs)
    for sup in sups.values():       # both jobs run side by side
        sup.start()
    rcs = {name: sup.wait(timeout=30) for name, sup in sups.items()}
    assert rcs["port"] == rcs["jax"] and rcs["port"] is not None
    got, want = sups["port"], sups["jax"]
    assert _trace(got) == _trace(want)
    counters = [{k: v for k, v in s.metrics.snapshot().items()
                 if k not in TIMED} for s in (got, want)]
    assert counters[0] == counters[1]
    assert (got.attempt, got.hosts, sorted(got.blacklist.hosts)) == \
        (want.attempt, want.hosts, sorted(want.blacklist.hosts))
    events = [e[0] for e in _trace(got)]
    if case == "hang_with_dump":
        assert "dump_captured" in events and "File" in got.dumps["h0"][0]
    if case == "stubborn_escalation":
        assert "escalate_kill" in events
        assert all(h.proc.poll() is not None for h in got.handles)
    if case == "budget_exhausted":
        assert rcs["port"] == 5 and "budget exhausted" in got.error
        assert [e["backoff_s"] for e in got.events
                if e["event"] == "restart"] == [0.02, 0.04]
    if case == "blacklist_elastic_downsize":
        assert got.hosts == ["h0", "h1"] and got.metrics.world_size == 2


# --------------------------------------------------------------------- #
# Policy pieces under hypothesis sequences
# --------------------------------------------------------------------- #
@settings(max_examples=60, deadline=None, database=None)
@given(base=st.floats(0.0, 10.0), factor=st.floats(1.0, 4.0),
       extra=st.floats(0.0, 100.0),
       attempts=st.lists(st.integers(-2, 30), max_size=12))
def test_backoff_policy_matches_jax(base, factor, extra, attempts):
    policies = [pkg.BackoffPolicy(base_s=base, factor=factor,
                                  max_s=base + extra, jitter=0.0)
                for pkg in (jres, tres)]
    assert [policies[1].delay(a) for a in attempts] == \
        [policies[0].delay(a) for a in attempts]


@settings(max_examples=30, deadline=None, database=None)
@given(base=st.floats(-1.0, 2.0), factor=st.floats(0.0, 2.0),
       max_s=st.floats(-1.0, 3.0), jitter=st.floats(-0.5, 0.5))
def test_backoff_policy_rejects_as_jax(base, factor, max_s, jitter):
    out = []
    for pkg in (jres, tres):
        try:
            pkg.BackoffPolicy(base_s=base, factor=factor, max_s=max_s,
                              jitter=jitter)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    assert out[1] == out[0]


_budget_ops = st.lists(st.tuples(
    st.sampled_from(("record", "exhausted", "in_window")),
    st.floats(0.0, 5.0)), max_size=25)


@settings(max_examples=60, deadline=None, database=None)
@given(max_restarts=st.integers(0, 5), window=st.floats(0.1, 10.0),
       ops=_budget_ops)
def test_restart_budget_matches_jax(max_restarts, window, ops):
    budgets = [pkg.RestartBudget(max_restarts, window)
               for pkg in (jres, tres)]
    now = 0.0
    for op, dt in ops:
        now += dt                       # the monotonic clock never falls
        got, want = (getattr(b, op)(now) for b in (budgets[1], budgets[0]))
        assert got == want, (op, now)


@settings(max_examples=60, deadline=None, database=None)
@given(threshold=st.integers(1, 4), ops=st.lists(st.tuples(
    st.sampled_from(("record_failure", "record_success", "is_blacklisted")),
    st.sampled_from(("a", "b", "c"))), max_size=30))
def test_host_blacklist_matches_jax(threshold, ops):
    lists = [pkg.HostBlacklist(threshold) for pkg in (jres, tres)]
    for op, host in ops:
        got, want = (getattr(b, op)(host) for b in (lists[1], lists[0]))
        assert got == want, (op, host)
    assert lists[1].hosts == lists[0].hosts


# --------------------------------------------------------------------- #
# A supervised launcher
# --------------------------------------------------------------------- #
_CHILD = r"""
import json, os, sys, time
HB = os.environ["DS_HEARTBEAT_FILE"]
with open(os.environ["PIDFILE"], "w") as f:
    f.write(str(os.getpid()))
for i in range(3):
    with open(HB, "w") as f:
        json.dump({"step": i}, f)
    time.sleep(0.05)
time.sleep(60)                        # the hang
"""


def test_supervised_launcher_orphans_its_hung_worker_as_jax(tmp_path):
    """A JobSupervisor whose worker is a launcher signals the launcher's
    process group only.  On a hang, its SIGUSR1 (the stack-dump request)
    kills the launcher, which has no handler for it, so no dump comes and
    the worker, in a session of its own, outlives the teardown.  Both
    packages behave so (recorded in ROADMAP C; the port keeps it)."""
    out = {}
    for name, pkg, runner in (("jax", jres, jrunner),
                              ("port", tres, trunner)):
        d = tmp_path / name
        d.mkdir()
        child = d / "child.py"
        child.write_text(_CHILD)
        pidfile = d / "pid"
        info = runner.encode_world_info({"localhost": [0]})
        module = runner.__name__.replace(".runner", ".launch")

        def spec_fn(hosts, attempt, module=module, info=info, child=child,
                    pidfile=pidfile, pkg=pkg):
            return [pkg.WorkerSpec(
                host="h0", env={"PIDFILE": str(pidfile),
                                "JAX_PLATFORMS": "cpu"},
                cmd=[sys.executable, "-m", module, f"--world_info={info}",
                     "--node_rank=0", "--master_addr=localhost",
                     "--master_port=29531", "--", str(child)])]

        sup = pkg.JobSupervisor(
            spec_fn, ["h0"], run_dir=str(d / "run"),
            heartbeat_interval_s=0.5, hang_timeout_s=1.0,
            startup_timeout_s=60.0, poll_s=0.02, term_grace_s=1.0,
            dump_grace_s=0.5, max_restarts=0)
        _LIVE.append(sup)
        rc = sup.run(timeout=60)
        worker = int(pidfile.read_text())
        try:
            os.kill(worker, 0)
            alive = True
            os.kill(worker, signal.SIGKILL)
        except ProcessLookupError:
            alive = False
        out[name] = (rc, [e[0] for e in _trace(sup)],
                     sup.handles[0].proc.returncode, alive)
    assert out["port"] == out["jax"]
    rc, events, launcher_rc, orphan = out["port"]
    assert events == ["launch", "hang_detected", "dump_missing", "give_up"]
    assert launcher_rc == -signal.SIGUSR1 and orphan


# --------------------------------------------------------------------- #
# The port's supervisor smoke
# --------------------------------------------------------------------- #
def test_supervisor_smoke_on_the_cpu(tmp_path):
    tool = ROOT / "deepspeed_tpu_torch" / "tools" / "supervisor_smoke.py"
    proc = subprocess.run(
        [sys.executable, str(tool), "--device", "cpu"],
        env={**os.environ, "TMPDIR": str(tmp_path)}, cwd=tmp_path,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, \
        f"stdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}"
    snap = json.loads(proc.stdout.strip().splitlines()[-1])
    assert snap["supervisor_smoke"] == "ok"
    assert snap["crash"]["restarts"] == 1 and snap["hang"]["restarts"] == 1
    assert snap["crash"]["resume_step"] >= 4
    assert snap["hang"]["hang_detect_age_s"] <= 2.0
