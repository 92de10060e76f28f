"""The INTERACT and SVR-INTERACT train steps of the MoE, hybrid, dense
and RWKV models against the JAX package.

Reduced mixtral-8x7b (the moe ffn's capacity route and its aux in the
outer loss), jamba-1.5-large (an attention layer with a dense ffn, then
a mamba layer with a moe ffn), gemma2-2b (local and global attention
layers, the attention and final softcaps) and rwkv6-3b (the WKV6
recurrence as a token loop under autograd), as ``ArchConfig.reduced``
makes them
at chip_smoke.py's ``LM_REDUCED`` (vocab 128, 2 layers, float32), with
tests/test_torch_train.py's settings (``BilevelHyper(mu_g=0.5,
neumann_k=2, lipschitz_g=4.0, ce_chunk=16)``, alpha 0.05, beta 0.3, 4 x
32 tokens an agent).  The port's one-agent steps run with ``remat`` on,
as the card's runs have it, so each layer, its capacity route and its
scan or token loop are recomputed in the backward pass; the reference's
``local_grads`` runs without it (one compile an arch serves every case;
on and off give the same gradients within rounding,
tests/test_torch_substrate.py).  The JAX ``init_train_state`` draws the
state and ``train_state_from_numpy`` carries it over; the tokens come
from a numpy seed.  The JAX ``make_train_step`` does not run on this CPU
stack (ROADMAP Queue C), so the steps are held against the composed
reference of tests/test_torch_train.py: the JAX ``local_grads`` and the
mixing matrix, here in numpy.

Held, relative to each leaf's max-abs scale in the reference (x and y
within ``XY_TOL`` = 1e-5, u and v within ``UV_TOL`` = 1e-4, rwkv6-3b's u
and v within ``RWKV_UV_TOL`` = 5e-4; the metrics within 1e-5 relative):
- one agent in this process (``AgentMesh.local(1)``): 2 INTERACT steps
  from the initial state, then 2 SVR-INTERACT steps with q = 3 (a
  refresh, then a recursive step) from the reference's state after 2
  steps, its previous iterate the state after 1;
- reduced mixtral on 2 gloo processes (tests/_torch_train_worker.py, at
  its settings: ``remat`` off), ``ring_mixing(2)``: 2 INTERACT steps and
  its 3 SVR-INTERACT steps;
- ``make_eval_step`` at the initial state with ``attn_impl``
  ``"reference"`` and ``"cuda"`` (the flash and WKV6 kernels' plain
  versions on CPU tensors) against the JAX ``outer_loss``, within 1e-5
  relative.
Also: chip_smoke.py's phase-4k cuts keep the published widths, and its
phase-4l runs train the published configs with nothing cut.
The largest gaps are printed beside their bounds.
"""
import collections
import dataclasses
import functools
import importlib.util
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

import _torch_train_worker as W  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import ring_mixing  # noqa: E402
from repro.train.bilevel_lm import BilevelHyper as JBilevelHyper  # noqa: E402
from repro.train.bilevel_lm import local_grads as j_local_grads  # noqa: E402
from repro.train.bilevel_lm import outer_loss as j_outer_loss  # noqa: E402
from repro.train.step import init_train_state as j_init_train_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.sharding.collectives import AgentMesh  # noqa: E402
from repro_torch.train.bilevel_lm import BilevelHyper  # noqa: E402
from repro_torch.train.step import (InteractConfig,  # noqa: E402
                                    make_eval_step, make_train_step)
from repro_torch.train.svr_step import make_svr_train_step  # noqa: E402

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
ARCHS = ["mixtral-8x7b", "jamba-1.5-large-398b", "gemma2-2b", "rwkv6-3b"]
# chip_smoke.py's cut runs (phase 4k) and its runs at full size (4l)
CUT_ARCHS = ["mixtral-8x7b", "jamba-1.5-large-398b"]
FULL_ARCHS = ["gemma2-2b", "rwkv6-3b", "paligemma-3b"]
S = W.SETTINGS
REDUCED = dict(vocab_size=S["vocab_size"], num_layers=S["num_layers"],
               dtype="float32")
HYPER = dict(W.hyper_kwargs(), remat=True)
INTERACT_STEPS, SVR_STEPS, Q = 2, 2, 3
XY_TOL, UV_TOL, CE_RTOL = 1e-5, 1e-4, 1e-5
# Reduced rwkv6-3b's hypergradient is ill-conditioned in exact arithmetic:
# in float64 a relative 1e-6 change of x moves layer 1's bonus-u entry of
# p by 4.2e-4 of its scale, and at one point the JAX package's float32 p
# is 2.3e-5 from float64 there, the port's 5.7e-5; after two INTERACT
# steps, whose x agree within 8.3e-6, u and p_prev differ by 1.7e-4
RWKV_UV_TOL = 5e-4
TIMEOUT = 240
FIELDS = ("x", "y", "u", "v", "p_prev")
tmap = jax.tree_util.tree_map
np_tree = lambda t: tmap(np.asarray, t)


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    """The JAX ``local_grads`` and ``outer_loss`` at the worker's
    settings, jitted once a config."""
    hyper = JBilevelHyper(**W.hyper_kwargs())
    return (jax.jit(lambda x, y, a, b: j_local_grads(jcfg, hyper, x, y, a,
                                                     b)),
            jax.jit(lambda x, y, t: j_outer_loss(jcfg, hyper, x, y, t)))


@functools.lru_cache(maxsize=None)
def _init(arch: str):
    """The reduced configs and the JAX initial state of one agent."""
    jcfg = j_get_config(arch).reduced(**REDUCED)
    state = jax.jit(lambda key: j_init_train_state(jcfg, key, 1))(
        jax.random.PRNGKey(0))
    return jcfg, get_config(arch).reduced(**REDUCED), np_tree(
        state._asdict())


def _setup(arch: str, m: int):
    """The reduced configs, the JAX initial state of m agents as numpy
    (every agent starts from the same (x0, y0), as the JAX
    ``init_train_state`` broadcasts it) and the tokens (m, 4, 32) from a
    numpy seed."""
    jcfg, cfg, one = _init(arch)
    state = {k: v if k == "t" else tmap(
        lambda l: np.repeat(l, m, axis=0), v) for k, v in one.items()}
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (m, S["batch"], S["seq"]))
    return jcfg, cfg, state, tokens


def _reference(jcfg, r, tokens, steps, q=None, prev=None):
    """From the state ``r`` (a dict of numpy leaves), the composed
    reference of Algorithm 1 (``q=None``) or, with ``q``,
    Algorithm 2 with ``local_grads`` at both iterates (the previous
    iterate ``prev = (x, y)``, else the state's), under ``ring_mixing(m)``
    (self weight 1/3), in numpy on the JAX ``local_grads``' values;
    returns each step's state and its mean outer CE."""
    lg = _jitted(jcfg)[0]
    m = tokens.shape[0]
    mat = ring_mixing(m, self_weight=1.0 / 3.0).matrix.astype(np.float32)
    mix = lambda tree: tmap(lambda l: np.tensordot(mat, l, axes=1)
                            .astype(np.float32), tree)
    row = lambda tree, i: tmap(lambda l: l[i], tree)
    x_prev, y_prev = prev if prev is not None else (r["x"], r["y"])
    states, ces = [], []
    for _ in range(steps):
        t = int(r["t"])
        x_new = tmap(lambda mx, u: mx - np.float32(S["alpha"]) * u,
                     mix(r["x"]), r["u"])
        y_new = r["y"] - np.float32(S["beta"]) * r["v"]
        refresh = q is None or (t + 1) % q == 0
        ps, vs, ce = [], [], []
        for i in range(m):
            inner, outer = tokens[i, :2], tokens[i, 2:]
            p, v, c = np_tree(lg(row(x_new, i), y_new[i], inner, outer))
            if not refresh:
                p_old, v_old, _ = np_tree(lg(row(x_prev, i), y_prev[i],
                                             inner, outer))
                p = tmap(lambda pp, a, b: pp + a - b, row(r["p_prev"], i),
                         p, p_old)
                v = r["v"][i] + v - v_old
            ps.append(p)
            vs.append(v)
            ce.append(float(c))
        p_new = tmap(lambda *ls: np.stack(ls), *ps)
        u_new = tmap(lambda mu, pn, pp: mu + pn - pp, mix(r["u"]), p_new,
                     r["p_prev"])
        x_prev, y_prev = r["x"], r["y"]
        r = dict(r, x=x_new, y=y_new, u=u_new, v=np.stack(vs),
                 p_prev=p_new, t=t + 1)
        states.append(r)
        ces.append(float(np.mean(ce)))
    return states, ces


def _svr_fields(mid: dict, before: dict) -> dict:
    return dict(mid, x_prev=before["x"], y_prev=before["y"])


def _to_port(fields: dict, cfg, agent: int):
    return train_state_from_numpy(
        collections.namedtuple("JState", list(fields))(**fields), cfg, "cpu",
        agent)


def _gaps(got: dict, want: dict, cfg, agent: int) -> dict:
    """Per field, the largest gap over the leaves of this agent's row,
    relative to each reference leaf's max-abs scale."""
    ref = _to_port(want, cfg, agent)
    gaps = {}
    for field in FIELDS:
        g = torch.utils._pytree.tree_leaves(got[field])
        w = torch.utils._pytree.tree_leaves(getattr(ref, field))
        assert [tuple(a.shape) for a in g] == [tuple(b.shape) for b in w]
        gaps[field] = max(float(np.max(np.abs(np.asarray(a) - b.numpy())))
                          / max(float(b.abs().max()), 1e-30)
                          for a, b in zip(g, w))
    return gaps


def _assert_within(gaps: dict, what: str, uv_tol: float = UV_TOL) -> None:
    print(f"{what}: largest gaps {gaps} (x, y bound {XY_TOL}; u, v bound "
          f"{uv_tol})")
    assert gaps["x"] < XY_TOL and gaps["y"] < XY_TOL, gaps
    assert gaps["u"] < uv_tol and gaps["v"] < uv_tol, gaps


def _one_agent(arch: str) -> dict:
    """The port's steps on ``AgentMesh.local(1)`` and the reference's."""
    jcfg, cfg, state, tokens = _setup(arch, 1)
    interact = _reference(jcfg, state, tokens, INTERACT_STEPS)
    before, mid = interact[0][-2], interact[0][-1]
    svr = _reference(jcfg, mid, tokens, SVR_STEPS, q=Q,
                     prev=(before["x"], before["y"]))
    mesh = AgentMesh.local(1, "cpu")
    icfg = InteractConfig(alpha=S["alpha"], beta=S["beta"],
                          hyper=BilevelHyper(**HYPER))
    toks = torch.as_tensor(tokens)
    got = {}
    for name, make, start, steps in (
            ("interact", lambda: make_train_step(cfg, mesh, icfg),
             state, INTERACT_STEPS),
            ("svr", lambda: make_svr_train_step(cfg, mesh, icfg, q=Q),
             _svr_fields(mid, before), SVR_STEPS)):
        step, st, metrics = make(), _to_port(start, cfg, 0), []
        for _ in range(steps):
            st, met = step(st, toks)
            metrics.append({k: float(v) for k, v in met.items()})
        got[name] = dict(state=st._asdict(), metrics=metrics)
    return dict(cfg=cfg, got=got, ref=dict(interact=interact, svr=svr))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Reduced mixtral on a gloo group of 2 processes (the worker's
    settings, ``remat`` off) against the composed reference under
    ``ring_mixing(2)``; while the group runs, each arch's steps on one
    agent here (``_one_agent``)."""
    arch, m = "mixtral-8x7b", 2
    jcfg, cfg, state, tokens = _setup(arch, m)
    out = tmp_path_factory.mktemp("train_moe")
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({"state": state,
                     "tokens": np.asarray(tokens, np.int64)}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_train_worker.py"), str(m),
         str(rank), str(port), str(out), arch], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(m)]
    try:
        # the workers' SVR steps start from the INTERACT reference's state
        interact = _reference(jcfg, state, tokens, S["interact_steps"])
        before, mid = interact[0][-2], interact[0][-1]
        tmp = out / "svr_inputs.pkl.tmp"
        tmp.write_bytes(pickle.dumps(_svr_fields(mid, before)))
        tmp.rename(out / "svr_inputs.pkl")
        one = {a: _one_agent(a) for a in ARCHS}
        svr = _reference(jcfg, mid, tokens, S["svr_steps"], q=S["q"],
                         prev=(before["x"], before["y"]))
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
    return dict(one=one, two=dict(cfg=cfg, ranks=ranks,
                                  ref=dict(interact=interact, svr=svr)))


@pytest.mark.parametrize("name", ["interact", "svr"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_agent_steps_match_composed_reference(runs, arch, name):
    run = runs["one"][arch]
    ref_states, ref_ces = run["ref"][name]
    got = run["got"][name]
    _assert_within(_gaps(got["state"], ref_states[-1], run["cfg"], 0),
                   f"{arch} {name}, one agent",
                   RWKV_UV_TOL if arch == "rwkv6-3b" else UV_TOL)
    assert got["state"]["t"] == ref_states[-1]["t"]
    assert [m["outer_ce"] for m in got["metrics"]] == pytest.approx(
        ref_ces, rel=CE_RTOL)
    if name == "svr":   # from t = 2 with q = 3: a refresh, then a recursion
        assert [m["refresh"] for m in got["metrics"]] == [1.0, 0.0]


@pytest.mark.parametrize("name", ["interact", "svr"])
def test_two_processes_match_composed_reference(runs, name):
    run = runs["two"]
    ref_states, ref_ces = run["ref"][name]
    gaps = {}
    for rank, got in enumerate(run["ranks"]):
        for field, gap in _gaps(got[name], ref_states[-1], run["cfg"],
                                rank).items():
            gaps[field] = max(gaps.get(field, 0.0), gap)
        assert got["metrics"][name] == run["ranks"][0]["metrics"][name]
        assert got[name]["t"] == ref_states[-1]["t"]
    _assert_within(gaps, f"mixtral-8x7b {name}, 2 processes")
    assert [m["outer_ce"] for m in run["ranks"][0]["metrics"][name]] == (
        pytest.approx(ref_ces, rel=CE_RTOL))


@pytest.mark.parametrize("impl", ["reference", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_jax(arch, impl):
    jcfg, cfg, state, tokens = _setup(arch, 1)
    want = float(_jitted(jcfg)[1](
        tmap(lambda l: l[0], state["x"]), state["y"][0], tokens[0]))
    icfg = InteractConfig(hyper=BilevelHyper(**HYPER, attn_impl=impl))
    got = float(make_eval_step(cfg, AgentMesh.local(1, "cpu"), icfg)(
        _to_port(state, cfg, 0), torch.as_tensor(tokens)))
    print(f"{arch} eval {impl}: {got} against {want}")
    assert got == pytest.approx(want, rel=CE_RTOL)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


WIDTHS = ("d_model", "d_ff", "num_heads", "num_kv_heads", "head_dim",
          "vocab_size", "mamba_d_state", "mamba_d_conv", "mamba_expand",
          "experts_per_token", "sliding_window", "dtype")


@pytest.mark.parametrize("arch", CUT_ARCHS)
def test_phase_4k_cuts_keep_published_widths(arch):
    run = _chip_smoke().LM_RUNS[arch]
    published = j_get_config(arch)
    cut = dataclasses.replace(get_config(arch), **run["cut"])
    assert set(run["cut"]) <= {"num_layers", "attn_every", "num_experts"}
    for field in WIDTHS:
        assert getattr(cut, field) == getattr(published, field), field
    assert cut.num_layers < published.num_layers
    mixers = {(s.mixer, s.ffn) for s in cut.layer_pattern()}
    if arch.startswith("jamba"):
        assert mixers == {("attn", "dense"), ("mamba", "moe")}
        assert 1 < cut.num_experts < published.num_experts
    else:
        assert mixers == {("attn", "moe")}
        assert cut.num_experts == published.num_experts


# each run's cuda eval call: the bf16 flash kernel once an attention
# layer, WKV6 once an rwkv layer: the published depths
FULL_EVAL_LAUNCHES = {"gemma2-2b": ("attn", 26), "rwkv6-3b": ("rwkv", 32),
                      "paligemma-3b": ("attn", 18)}


@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_phase_4l_runs_keep_published_configs(arch):
    smoke = _chip_smoke()
    run = smoke.LM_RUNS[arch]
    assert arch in smoke.LM_PHASE_RUNS["lm_dense_ssm_vlm"]
    assert run["cut"] == {}
    cfg = dataclasses.replace(get_config(arch), **run["cut"])
    published = j_get_config(arch)
    for field in dataclasses.fields(published):
        assert getattr(cfg, field.name) == getattr(published, field.name), (
            field.name)
    mixer, layers = FULL_EVAL_LAUNCHES[arch]
    assert sum(s.mixer == mixer for s in cfg.layer_pattern()
               * (cfg.num_layers // len(cfg.layer_pattern()))) == layers
    assert run["agents"] == 1 and run["interact_steps"] >= 2
    # neither package's SVR step takes a prefix
    assert bool(run["svr_steps"]) == (cfg.num_prefix_tokens == 0)
