"""The port's multi-process Section-6 run against the JAX package's.

The JAX package's ``run_section6`` runs on 8 forced host devices (one
process a run, as tests/test_distributed.py runs it), with ``allgather``
and with ``ppermute`` in two subprocesses side by side, at tests/test_distributed.py's small
settings (m = 8, n = 24 an agent, 4 steps recorded every 2, 20 inner
metric steps); its instance ``(x0, y0, data)`` is handed to the port's
``run_section6`` through ``setup=`` (the port's ``default_setup`` draws
other numbers).  The port runs in two layouts of real gloo groups on the
CPU, one subprocess a rank, each with a timeout: ``allgather`` with 2
processes x 4 agents (the group of 2 that runs the other algorithms
makes it last) and ``ppermute`` with 8 processes x 1 agent.

Held: measured, broadcast-priced and per-link-priced bytes exactly the
JAX package's; the eq.-11 traces within ``TRACE_RTOL`` = steps x 2e-6
relative (the one-step bound of tests/test_torch_interact.py over 4
steps; the largest gap is printed beside it); each layout against the
port's own single-process ``dense`` run of the same instance within the
same bound; the digest of the final x the same on every rank.  The other
three algorithms construct and step on both backends, held to the port's
``dense`` run.  The launcher (``python -m repro_torch.launch.
launch_local --device cpu --wire gloo``) writes the JAX package's result
keys, and refuses what it cannot run.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_section6_worker as S  # noqa: E402
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 tree_from_numpy)
from repro_torch.core import MLPMetaProblem, convergence_metric  # noqa: E402
from repro_torch.launch import launch_local  # noqa: E402
from repro_torch.solvers import SolverConfig, make_solver  # noqa: E402
from repro_torch.solvers.api import _chunks  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
STEPS = S.SETTINGS["num_steps"]
TRACE_RTOL = STEPS * 2e-6
TIMEOUT = 300
LAYOUTS = {"allgather": 2, "ppermute": 8}     # backend: processes
# the JAX package's run_section6 keys (src/repro/launch/distributed.py)
JAX_KEYS = ("backend", "num_agents", "num_processes", "num_devices",
            "mesh_shape", "num_steps", "compression", "final_metric",
            "trace", "digest", "measured_wire_bytes", "priced_wire_bytes",
            "per_link_priced_bytes", "round_latency_us", "ledger")
OTHER_ALGOS = ("svr-interact", "gt-dsgd", "d-sgd")

_JAX = textwrap.dedent("""
    import json, os, pickle, sys
    import jax, numpy as np
    sys.path.insert(0, TESTS)
    import _torch_section6_worker as S
    from repro.launch.distributed import run_section6
    from repro.solvers.api import default_setup
    cfg = S.SETTINGS
    _, x0, y0, data = default_setup(
        cfg["seed"], num_agents=cfg["num_agents"],
        n_per_agent=cfg["n_per_agent"], d_in=8, hidden=8, classes=3)
    if BACKEND == "allgather":
        host = jax.tree_util.tree_map(np.asarray, (x0, y0, data))
        with open(OUT + "/setup.pkl.tmp", "wb") as f:
            pickle.dump(host, f)
        os.replace(OUT + "/setup.pkl.tmp", OUT + "/setup.pkl")
    with open(OUT + f"/jax_{BACKEND}.json", "w") as f:
        json.dump(run_section6(backend=BACKEND, **cfg), f)
    print("JAX_SECTION6_OK")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_all(procs):
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errors.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, errors[0]


def _group(world: int, runs: list[dict], out: Path):
    """The ranks of one gloo group making ``runs`` (see the worker)."""
    out.mkdir(exist_ok=True)
    spec = out / f"runs{world}.json"
    spec.write_text(json.dumps(runs))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return [subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_section6_worker.py"),
         str(world), str(rank), str(port), str(spec), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]


def _results(out: Path, name: str, world: int) -> list[dict]:
    return [json.loads((out / f"{name}.rank{r}.json").read_text())
            for r in range(world)]


def _dense_trace(setup: Path | None, algo: str = "interact",
                 num_agents: int = S.SETTINGS["num_agents"]):
    """The port's single-process ``dense`` run of the instance (the
    pickled one, or the port's ``default_setup``), recorded as
    ``run_section6`` records."""
    cfg = dict(S.SETTINGS, num_agents=num_agents)
    if setup is None:
        from repro_torch.solvers.api import default_setup
        problem, x0, y0, data = default_setup(
            cfg["seed"], num_agents=num_agents,
            n_per_agent=cfg["n_per_agent"], d_in=8, hidden=8, classes=3,
            device="cpu")
    else:
        with open(setup, "rb") as f:
            x0, y0, data = pickle.load(f)
        data = agent_data_from_numpy(data, "cpu")
        problem = MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0)
        x0, y0 = tree_from_numpy(x0, "cpu"), tree_from_numpy(y0, "cpu")
    solver = make_solver(SolverConfig(
        algo=algo, alpha=cfg["alpha"], beta=cfg["beta"],
        num_agents=num_agents, backend="dense", seed=cfg["seed"]))
    state = solver.init(problem, None, x0, y0, data)
    metric = lambda st: float(convergence_metric(
        problem, solver._hg_cfg, st.x, st.y, cfg["metric_inner_steps"], 0.5,
        data).total)
    trace = []
    for length in _chunks(STEPS, cfg["record_every"]):
        trace.append(metric(state))
        state = solver.run(state, data, length)
    trace.append(metric(state))
    return trace


# the other algorithms' groups, on the port's default_setup at m = 4:
# backend -> processes
OTHER_LAYOUTS = {"allgather": 2, "ppermute": 4}


def _await_file(path: Path, proc) -> None:
    """Wait until ``proc`` has written ``path`` (at most ``TIMEOUT`` s);
    fail if it exits first."""
    deadline = time.monotonic() + TIMEOUT
    while not path.exists():
        assert proc.poll() is None or path.exists(), (
            f"{path} was not written: {proc.stderr.read()[-3000:]}")
        assert time.monotonic() < deadline, f"{path}: no file in {TIMEOUT} s"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's two runs, the port's two layouts (every rank's
    result) and the other algorithms' groups, and the port's dense
    traces, each made once.  The port's layouts start once the JAX
    process has written its instance, beside its runs; the dense traces
    are made here while the groups run."""
    root = tmp_path_factory.mktemp("section6")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    # one process a backend; the allgather one writes the instance first
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"TESTS = {str(TESTS)!r}\nOUT = {str(root)!r}\n"
         f"BACKEND = {backend!r}\n" + _JAX],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for backend in sorted(LAYOUTS)]
    others = root / "others"
    setup = root / "setup.pkl"
    main = {backend: dict(name=backend, backend=backend, algo="interact",
                          setup=str(setup),
                          num_agents=S.SETTINGS["num_agents"])
            for backend in LAYOUTS}
    # a group of the same size makes its layout's run after the other
    # algorithms' (its ranks wait for the JAX package's instance)
    shared = {b for b in LAYOUTS if LAYOUTS[b] == OTHER_LAYOUTS[b]}
    procs = [p for backend, world in OTHER_LAYOUTS.items()
             for p in _group(world, [dict(name=f"{backend}-{algo}",
                                          backend=backend, algo=algo,
                                          setup=None, num_agents=4)
                                     for algo in OTHER_ALGOS]
                             + [main[backend]] * (backend in shared),
                             others)]
    try:
        _await_file(setup, jax_procs[0])
        procs += [p for backend, world in LAYOUTS.items()
                  if backend not in shared
                  for p in _group(world, [main[backend]], root / backend)]
        dense = _dense_trace(setup)
        dense_others = {a: _dense_trace(None, a, 4) for a in OTHER_ALGOS}
    finally:
        _wait_all(jax_procs + procs)
    return dict(
        jax={b: json.loads((root / f"jax_{b}.json").read_text())
             for b in LAYOUTS},
        port={b: _results(others if b in shared else root / b, b, w)
              for b, w in LAYOUTS.items()},
        others={(b, a): _results(others, f"{b}-{a}", w)[0]
                for b, w in OTHER_LAYOUTS.items() for a in OTHER_ALGOS},
        dense=dense, dense_others=dense_others)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_layout_runs_as_laid_out(runs, backend):
    res = runs["port"][backend][0]
    world = LAYOUTS[backend]
    assert res["num_processes"] == world == res["num_devices"]
    assert res["agents_per_process"] == S.SETTINGS["num_agents"] // world
    assert res["wire"] == "gloo" and res["device"] == "cpu"
    assert set(JAX_KEYS) <= set(res)
    assert len(res["trace"]) == STEPS // S.SETTINGS["record_every"] + 1


@pytest.mark.parametrize("key", ["measured_wire_bytes", "priced_wire_bytes",
                                 "per_link_priced_bytes"])
@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_wire_bytes_equal_the_jax_packages(runs, backend, key):
    assert runs["port"][backend][0][key] == runs["jax"][backend][key]


@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_measured_bytes_match_the_backends_price(runs, backend):
    res = runs["port"][backend][0]
    price = ("priced_wire_bytes" if backend == "allgather"
             else "per_link_priced_bytes")
    assert res["measured_wire_bytes"] == res[price]


@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_trace_matches_the_jax_package(runs, backend):
    got = runs["port"][backend][0]["trace"]
    want = runs["jax"][backend]["trace"]
    gap = _rel(got, want)
    print(f"{backend}: trace against the JAX package, largest relative gap "
          f"{gap:.3e} (bound {TRACE_RTOL:.1e})")
    assert gap <= TRACE_RTOL
    assert runs["port"][backend][0]["final_metric"] == got[-1]


@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_trace_matches_the_ports_dense_run(runs, backend):
    gap = _rel(runs["port"][backend][0]["trace"], runs["dense"])
    print(f"{backend}: trace against the port's dense run, largest "
          f"relative gap {gap:.3e} (bound {TRACE_RTOL:.1e})")
    assert gap <= TRACE_RTOL


@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_every_rank_returns_one_result(runs, backend):
    ranks = runs["port"][backend]
    assert len({r["digest"] for r in ranks}) == 1
    assert all(r["rank_digests"] == [ranks[0]["digest"]] * len(ranks)
               for r in ranks)
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in ("round_latency_us", "ledger")}
    assert all(strip(r) == strip(ranks[0]) for r in ranks)


@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_no_kernel_launches_on_the_cpu(runs, backend):
    for launches in runs["port"][backend][0]["kernel_launches"]:
        assert set(launches.values()) == {0}


@pytest.mark.parametrize("algo", OTHER_ALGOS)
@pytest.mark.parametrize("backend", sorted(OTHER_LAYOUTS))
def test_other_algorithms_step_on_both_backends(runs, backend, algo):
    """SVR-INTERACT, GT-DSGD and D-SGD on 2 processes (``allgather``, 2
    agents each) or 4 (``ppermute``), held to the port's dense run of the
    same config: every rank's sampler draws the whole block and keeps
    its rows."""
    got = runs["others"][backend, algo]
    assert got["algo"] == algo
    assert got["num_processes"] == OTHER_LAYOUTS[backend]
    gap = _rel(got["trace"], runs["dense_others"][algo])
    print(f"{algo} on {backend}: trace against the port's dense run, "
          f"largest relative gap {gap:.3e} (bound {TRACE_RTOL:.1e})")
    assert gap <= TRACE_RTOL
    assert got["measured_wire_bytes"] == got[
        "priced_wire_bytes" if backend == "allgather"
        else "per_link_priced_bytes"]


def test_launcher_writes_the_jax_packages_keys(tmp_path):
    out = tmp_path / "result.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.launch_local", "--device",
         "cpu", "--wire", "gloo", "--processes", "2", "--agents", "4",
         "--backend", "allgather", "--steps", "4", "--record-every", "4",
         "--n-per-agent", "24", "--metric-inner-steps", "20", "--out",
         str(out)], env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(out.read_text())
    assert set(JAX_KEYS) <= set(res) and res["skip_init"] is False
    assert res["num_processes"] == 2 and res["num_agents"] == 4
    assert np.isfinite(res["final_metric"])
    assert res["measured_wire_bytes"] == res["priced_wire_bytes"]
    assert res["round_latency_us"] > 0 and len(res["digest"]) == 64
    assert json.loads(proc.stdout) == res


@pytest.mark.parametrize("argv,match", [
    (["--device", "cpu", "--wire", "nccl"], "CUDA tensors only"),
    (["--device", "cpu", "--wire", "gloo", "--processes", "3", "--agents",
      "4"], "does not divide"),
    (["--device", "cpu", "--wire", "gloo", "--devices-per-process", "4"],
     "one device"),
    (["--device", "cpu", "--wire", "gloo", "--skip-init"], "--processes 1"),
], ids=["nccl-on-cpu", "indivisible", "devices-per-process", "skip-init"])
def test_launcher_refuses_before_spawning(argv, match):
    with pytest.raises((SystemExit, ValueError), match=match):
        launch_local.main(argv)


def test_a_failed_worker_stops_the_others(tmp_path):
    """Rank 0 of a 2-process group waits for rank 1, which dies: the
    launcher's wait kills rank 0 and reports the failure at once, well
    inside the group's timeout; a worker past the deadline is killed
    too."""
    import time
    run = [dict(name="r", backend="allgather", algo="interact", setup=None,
                num_agents=4)]
    waiting = _group(2, run, tmp_path / "out")[:1]
    dying = subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])
    t0 = time.monotonic()
    failed = launch_local._wait(waiting + [dying], 60.0)
    assert failed == [(1, 3)]
    assert time.monotonic() - t0 < 30
    assert waiting[0].poll() is not None       # killed, not left waiting
    waiting = _group(2, run, tmp_path / "again")[:1]
    assert launch_local._wait(waiting, 2.0) == [(0, "timeout")]
    assert waiting[0].poll() is not None
