"""The port's LM training path against the JAX package's.

The JAX package's ``make_train_step`` does not run on this CPU stack
(its ``shard_map`` body fails with ``ShardingTypeError``, ROADMAP Queue
C), so the port's train steps are held against the reference that
tests/test_distributed.py builds: per-agent ``local_grads`` plus dense
ring mixing with ``mix_pytree``, at that test's settings (reduced
smollm-360m, vocab 128, 2 layers, float32, ``BilevelHyper(mu_g=0.5,
neumann_k=2, lipschitz_g=4.0, ce_chunk=16, remat=False)``, 4 agents,
tokens (4, 4, 32), alpha 0.05, beta 0.3).  The JAX ``init_train_state``
draws the state; each rank of a real gloo group of 4 processes
(tests/_torch_train_worker.py, one agent a process) takes its row.

Held, relative to each leaf's max-abs scale in the reference:
- 2 INTERACT steps (``make_train_step``): x and y within ``XY_TOL`` =
  1e-5, u and v within ``UV_TOL`` = 1e-4; the metrics (group means)
  within 1e-5 relative of the reference's.
- 3 SVR-INTERACT steps with q = 3 (a refresh, then two recursive
  steps) against the same reference with ``local_grads`` at both
  iterates, under the same bounds.  They start from the reference's
  INTERACT state after 2 steps, the previous iterate its state after 1:
  from ``init_svr_train_state``'s state (previous iterate = iterate,
  u = v = 0) the first recursive differences are rounding noise, and
  the norm scales (zero at init) would hold nothing else.
- The eval step at the initial state, both attention impls (``cuda``
  runs the flash kernel's plain version on CPU tensors), against the
  mean of the JAX ``outer_loss`` within 1e-5 relative.
The largest gaps are printed beside their bounds.  Also here: the
config's fields and defaults and its ``SolverConfig`` round trip, every
option the port refuses (each names its ROADMAP item, or, for
``batch_shard``, the pods layout it needs), and the driver:
8 steps checkpointed every 4, rerun to 12, bit for bit the uninterrupted
12-step run.
"""
import dataclasses
import functools
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_train_worker as W  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import mix_pytree, ring_mixing  # noqa: E402
from repro.train.bilevel_lm import BilevelHyper as JBilevelHyper  # noqa: E402
from repro.train.bilevel_lm import local_grads as j_local_grads  # noqa: E402
from repro.train.bilevel_lm import outer_loss as j_outer_loss  # noqa: E402
from repro.train.step import InteractConfig as JInteractConfig  # noqa: E402
from repro.train.step import init_train_state as j_init_train_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.launch import train as driver  # noqa: E402
from repro_torch.sharding.collectives import AgentMesh  # noqa: E402
from repro_torch.solvers import SolverConfig  # noqa: E402
from repro_torch.train.bilevel_lm import BilevelHyper, local_grads  # noqa: E402
from repro_torch.train.step import (InteractConfig,  # noqa: E402
                                    init_train_state, make_eval_step,
                                    make_train_step)
from repro_torch.train.svr_step import make_svr_train_step  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TIMEOUT = 300
XY_TOL, UV_TOL = 1e-5, 1e-4
S = W.SETTINGS
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _configs():
    kw = dict(vocab_size=S["vocab_size"], num_layers=S["num_layers"],
              dtype="float32")
    return (j_get_config(S["arch"]).reduced(**kw),
            get_config(S["arch"]).reduced(**kw))


def _reference(jcfg, state, tokens, steps, q=None, prev=None):
    """tests/test_distributed.py's composed reference of Algorithm 1
    (``q=None``) or, with ``q``, Algorithm 2 with ``local_grads`` at both
    iterates (the previous iterate ``prev = (x, y)``, else the state's);
    returns each step's state and each step's mean outer CE and
    tracked-gradient norm."""
    m = S["m"]
    lg = _jitted(jcfg)[0]
    mat = jnp.asarray(ring_mixing(m, self_weight=1.0 / 3.0).matrix,
                      jnp.float32)
    row = lambda tree, i: jax.tree_util.tree_map(lambda l: l[i], tree)
    stack = lambda rows: jax.tree_util.tree_map(lambda *ls: jnp.stack(ls),
                                                *rows)
    x_prev, y_prev = prev if prev is not None else (state.x, state.y)
    r, states, metrics = state, [], []
    for _ in range(steps):
        t = int(r.t)
        x_mixed = mix_pytree(mat, r.x)
        u_mixed = mix_pytree(mat, r.u)
        x_new = jax.tree_util.tree_map(lambda mx, u: mx - S["alpha"] * u,
                                       x_mixed, r.u)
        y_new = r.y - S["beta"] * r.v
        refresh = q is None or (t + 1) % q == 0
        ps, vs, ces = [], [], []
        for i in range(m):
            inner, outer = tokens[i, :2], tokens[i, 2:]
            p, v, ce = lg(row(x_new, i), y_new[i], inner, outer)
            if not refresh:
                p_old, v_old, _ = lg(row(x_prev, i), y_prev[i], inner, outer)
                p = jax.tree_util.tree_map(lambda pp, a, b: pp + a - b,
                                           row(r.p_prev, i), p, p_old)
                v = r.v[i] + v - v_old
            ps.append(p)
            vs.append(v)
            ces.append(float(ce))
        p_new, v_new = stack(ps), jnp.stack(vs)
        u_new = jax.tree_util.tree_map(lambda mu, pn, pp: mu + pn - pp,
                                       u_mixed, p_new, r.p_prev)
        gsq = sum(float(jnp.sum(jnp.square(l)))
                  for l in jax.tree_util.tree_leaves(u_new))
        metrics.append({"outer_ce": float(np.mean(ces)),
                        "grad_norm": float(np.sqrt(gsq / m))})
        x_prev, y_prev = r.x, r.y
        r = r._replace(x=x_new, y=y_new, u=u_new, v=v_new, p_prev=p_new,
                       t=r.t + 1)
        states.append(r)
    return states, metrics


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    """The JAX ``local_grads`` and ``outer_loss`` at the settings, jitted
    once."""
    hyper = JBilevelHyper(**W.hyper_kwargs())
    return (jax.jit(lambda x, y, a, b: j_local_grads(jcfg, hyper, x, y, a,
                                                     b)),
            jax.jit(lambda x, y, t: j_outer_loss(jcfg, hyper, x, y, t)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, cfg = _configs()
    m = S["m"]
    state = jax.jit(lambda key: j_init_train_state(jcfg, key, m))(
        jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1),
                                (m, S["batch"], S["seq"]), 0,
                                jcfg.vocab_size)
    out = tmp_path_factory.mktemp("train")
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({"state": np_tree(state._asdict()),
                     "tokens": np.asarray(tokens, np.int64)}, f)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_train_worker.py"), str(m),
         str(rank), str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(m)]
    try:
        # the references run while the workers do; the workers' SVR steps
        # start from the INTERACT reference's state
        interact = _reference(jcfg, state, tokens, S["interact_steps"])
        mid, before = interact[0][-1], interact[0][-2]
        tmp = out / "svr_inputs.pkl.tmp"
        tmp.write_bytes(pickle.dumps(np_tree(dict(
            mid._asdict(), x_prev=before.x, y_prev=before.y))))
        tmp.rename(out / "svr_inputs.pkl")
        svr = _reference(jcfg, mid, tokens, S["svr_steps"], q=S["q"],
                         prev=(before.x, before.y))
        evals = [float(_jitted(jcfg)[1](
            jax.tree_util.tree_map(lambda l: l[i], state.x), state.y[i],
            tokens[i])) for i in range(m)]
        errors = []
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
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
             for r in range(m)]
    return dict(cfg=cfg, ranks=ranks, interact=interact, svr=svr,
                eval=float(np.mean(evals)))


def _field_gaps(run, name: str, ref_state) -> dict:
    """Per field, the largest gap over agents and leaves, relative to
    each reference leaf's max-abs scale."""
    ref = np_tree(ref_state)
    gaps = {}
    for rank, got in enumerate(run["ranks"]):
        want = train_state_from_numpy(ref, run["cfg"], "cpu", rank)
        for field in ("x", "y", "u", "v", "p_prev"):
            g = torch.utils._pytree.tree_leaves(got[name][field])
            w = torch.utils._pytree.tree_leaves(getattr(want, field))
            assert [a.shape for a in g] == [tuple(b.shape) for b in w]
            gap = max(float(np.max(np.abs(a - b.numpy())))
                      / max(float(b.abs().max()), 1e-30)
                      for a, b in zip(g, w))
            gaps[field] = max(gaps.get(field, 0.0), gap)
    return gaps


@pytest.mark.parametrize("name", ["interact", "svr"])
def test_trajectory_matches_composed_reference(run, name):
    ref_states, ref_metrics = run[name]
    gaps = _field_gaps(run, name, ref_states[-1])
    print(f"{name}: largest gaps {gaps} (x, y bound {XY_TOL}; u, v bound "
          f"{UV_TOL})")
    assert gaps["x"] < XY_TOL and gaps["y"] < XY_TOL, gaps
    assert gaps["u"] < UV_TOL and gaps["v"] < UV_TOL, gaps
    for rank in run["ranks"]:
        assert rank["metrics"][name] == run["ranks"][0]["metrics"][name]
        assert rank[name]["t"] == int(ref_states[-1].t)
    for got, want in zip(run["ranks"][0]["metrics"][name], ref_metrics):
        for key in got.keys() & want.keys():   # SVR reports no grad_norm
            assert got[key] == pytest.approx(want[key], rel=1e-5), (key, got)


def test_svr_refreshes_on_its_period(run):
    # from t = 2 with q = 3: a refresh at (t + 1) % q == 0, then two
    # recursive steps
    assert [m["refresh"] for m in run["ranks"][0]["metrics"]["svr"]] == [
        1.0, 0.0, 0.0]


@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_eval_step_matches_jax(run, impl):
    got = [rank["eval"][impl] for rank in run["ranks"]]
    assert len(set(got)) == 1
    print(f"eval {impl}: {got[0]} against {run['eval']}")
    assert got[0] == pytest.approx(run["eval"], rel=1e-5)


def test_config_fields_and_defaults_match_jax():
    assert dataclasses.asdict(InteractConfig()) == dataclasses.asdict(
        JInteractConfig())
    assert dataclasses.asdict(BilevelHyper()) == dataclasses.asdict(
        JBilevelHyper())


def test_solver_config_round_trip():
    icfg = InteractConfig(alpha=0.05, beta=0.3, topology="erdos-renyi",
                          p_connect=0.7, topology_seed=3,
                          consensus_compress="int8", dp_sigma=0.01, q=5,
                          hyper=BilevelHyper(neumann_k=6, lipschitz_g=3.0))
    scfg = icfg.solver_config()
    jscfg = JInteractConfig(
        alpha=0.05, beta=0.3, topology="erdos-renyi", p_connect=0.7,
        topology_seed=3, consensus_compress="int8", dp_sigma=0.01, q=5,
        hyper=JBilevelHyper(neumann_k=6, lipschitz_g=3.0)).solver_config()
    for field in ("algo", "alpha", "beta", "q", "backend"):
        assert getattr(scfg, field) == getattr(jscfg, field)
    assert dict(scfg.backend_opts) == dict(jscfg.backend_opts)
    assert dataclasses.asdict(scfg.topology) == dataclasses.asdict(
        jscfg.topology)
    for field in ("method", "backend", "neumann_k", "lipschitz_g"):
        assert getattr(scfg.hypergrad, field) == getattr(jscfg.hypergrad,
                                                         field)
    assert scfg.hypergrad.resolve_backend() == "neumann-linearized"
    back = InteractConfig.from_solver_config(scfg)
    assert back == dataclasses.replace(icfg, hyper=BilevelHyper(
        neumann_k=6, lipschitz_g=3.0))
    assert InteractConfig.coerce(scfg) == back
    assert InteractConfig.coerce(icfg) is icfg
    with pytest.raises(ValueError, match="explicit MixingSpec"):
        InteractConfig.from_solver_config(
            SolverConfig(mixing=icfg.mixing_spec(4)))


def _mesh():
    # the rows of a 4-process group, as rank 0 sees them; nothing here
    # reaches a collective
    return AgentMesh(4, 4, 0, torch.device("cpu"), "gloo")


def _lg_call(hyper):
    _, cfg = _configs()
    state = init_train_state(cfg, 0, device="cpu")
    x = torch.utils._pytree.tree_map(lambda l: l[0], state.x)
    toks = torch.zeros((4, 8), dtype=torch.int64)
    return lambda: local_grads(cfg, hyper, x, state.y[0], toks[:2], toks[2:])


# each refused option, the error it raises and the words it names (the
# pods layout is tests/test_torch_pods.py's; batch_shard belongs to it)
REFUSED = {
    "seq_shard": (lambda cfg: make_train_step(cfg, _mesh(), InteractConfig(
        hyper=BilevelHyper(seq_shard=True))), NotImplementedError,
        "item 10"),
    "batch_shard": (lambda cfg: make_eval_step(cfg, _mesh(), InteractConfig(
        hyper=BilevelHyper(batch_shard=True))), ValueError,
        "agent_mode='pods'"),
    "attn_cuda_train_step": (lambda cfg: make_train_step(
        cfg, _mesh(), InteractConfig(hyper=BilevelHyper(attn_impl="cuda"))),
        NotImplementedError, "no backward kernel"),
    "attn_cuda_local_grads": (lambda cfg: _lg_call(
        BilevelHyper(attn_impl="cuda"))(), NotImplementedError,
        "no backward kernel"),
    "production_mesh": (lambda cfg: driver.main(
        ["--reduced", "--device", "cpu", "--wire", "gloo",
         "--production-mesh"]), NotImplementedError, "item 10"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_options_name_their_roadmap_item(name):
    _, cfg = _configs()
    entry, error, words = REFUSED[name]
    with pytest.raises(error, match=words):
        entry(cfg)


def test_backend_rule_and_missing_q():
    _, cfg = _configs()
    with pytest.raises(ValueError, match="requires 'ppermute'"):
        make_train_step(cfg, _mesh(),
                        InteractConfig(consensus_backend="dense"))
    with pytest.raises(ValueError, match="refresh period q"):
        make_svr_train_step(cfg, _mesh(), InteractConfig())


def _drive(ckpt: Path, steps: int, out: Path,
           dtype: str = "float32") -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--device", "cpu", "--wire", "gloo", "--agents", "2",
           "--per-agent-batch", "2", "--seq-len", "16", "--log-every", "4",
           "--ckpt-every", "4", "--steps", str(steps), "--ckpt-dir",
           str(ckpt), "--out", str(out), "--timeout", str(TIMEOUT),
           "--dtype", dtype]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(SRC)))


def _result(proc: subprocess.Popen, out: Path) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT + 30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stderr[-3000:]
    return dict(json.loads(out.read_text()), stdout=stdout)


def test_driver_resumes_bit_for_bit(tmp_path):
    # the uninterrupted run goes on beside the interrupted one
    whole_proc = _drive(tmp_path / "b", 12, tmp_path / "b12.json")
    first = _result(_drive(tmp_path / "a", 8, tmp_path / "a8.json"),
                    tmp_path / "a8.json")
    resumed = _result(_drive(tmp_path / "a", 12, tmp_path / "a12.json"),
                      tmp_path / "a12.json")
    whole = _result(whole_proc, tmp_path / "b12.json")
    assert "checkpointed step 8" in first["stdout"]
    assert "restoring step 8" in resumed["stdout"]
    assert "done." in resumed["stdout"]
    assert (first["start"], resumed["start"], whole["start"]) == (0, 8, 0)
    lines = [l for l in whole["stdout"].splitlines() if l.startswith("step")]
    assert len(lines) == 3 and "tracked_grad_norm" in lines[0]
    assert resumed["log"][-1]["outer_ce"] == whole["log"][-1]["outer_ce"]
    assert resumed["rank_digests"] == whole["rank_digests"]
    assert len(set(whole["rank_digests"])) == 2   # distinct agents


def test_driver_resumes_bfloat16_bit_for_bit(tmp_path):
    # bfloat16 leaves go to the store as their int16 bits and come back
    # as bfloat16: the resumed run is the uninterrupted one, bit for bit
    whole_proc = _drive(tmp_path / "b", 12, tmp_path / "b12.json",
                        "bfloat16")
    first = _result(_drive(tmp_path / "a", 8, tmp_path / "a8.json",
                           "bfloat16"), tmp_path / "a8.json")
    resumed = _result(_drive(tmp_path / "a", 12, tmp_path / "a12.json",
                             "bfloat16"), tmp_path / "a12.json")
    whole = _result(whole_proc, tmp_path / "b12.json")
    assert {first["dtype"], resumed["dtype"], whole["dtype"]} == {"bfloat16"}
    assert "checkpointed step 8" in first["stdout"]
    assert "restoring step 8" in resumed["stdout"]
    assert (first["start"], resumed["start"], whole["start"]) == (0, 8, 0)
    assert resumed["log"][-1]["outer_ce"] == whole["log"][-1]["outer_ce"]
    assert resumed["rank_digests"] == whole["rank_digests"]
    assert first["rank_digests"] != whole["rank_digests"]
