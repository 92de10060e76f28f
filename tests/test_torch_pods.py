"""The pods layout (``agent_mode="pods"``) against the JAX package.

An agent is a pod of k processes holding its INTERACT state sharded by
``repro_torch.sharding.partition`` (the JAX package's ``leaf_spec`` at
model size 1 with the pod's ``("data", k)``), its backbone math split
over the pod's share of the batch.  A pods step must compute what the
rows layout computes for the same m agents on the same tokens, up to
the order of the reductions, so the reference is tests/test_torch_train.py's
composed one: per-agent JAX ``local_grads`` and the ring's mixing matrix
(``ring_mixing(2)``), here in numpy, at that file's settings (vocab
128, 2 layers, float32, ``BilevelHyper(mu_g=0.5, neumann_k=2,
lipschitz_g=4.0, ce_chunk=16, remat=False)``, alpha 0.05, beta 0.3, 4 x
32 tokens an agent).

One launch of a gloo group of 4 processes (tests/_torch_pods_worker.py:
2 agents x pods of 2, a (2, 2, 1) process mesh) runs every
multi-process case; the reference runs here meanwhile.  Held, relative
to each reference leaf's max-abs scale, on the whole leaves put back
together from the ranks' shards (a leaf kept whole must be the same on
both ranks of a pod):
- reduced smollm-360m, 2 INTERACT steps and 3 SVR-INTERACT steps (q =
  3, from the reference's state after 2 steps, the previous iterate its
  state after 1); reduced mixtral-8x7b and dbrx-132b at capacity factor
  1.0, where slots drop; reduced paligemma-3b with its prefix: x and y
  within ``XY_TOL`` = 1e-5, u and v within ``UV_TOL`` = 1e-4, the
  metrics within 1e-5 relative;
- every capacity route of the moe cases: the kept (token, slot, expert,
  position) set of the pod's batch equals the JAX ``moe_ffn``'s on the
  same tokens and router (its dispatch tensor), and slots drop;
- the int8 wire and local-DP noise, one step each: the pods layout
  against the port's rows layout on the same draws, within ``WIRE_TOL``
  = 1e-6 of scale;
- the moe ffn alone, the 4 ranks as one pod each with its share of a
  batch, routed whole, in token chunks within a share and in chunks over
  2 shares: the ranks' outputs are the JAX ``moe_ffn``'s on the whole
  batch, the ranks' mean aux its aux;
- ``init_train_state(..., mesh=)``'s shards bit for bit the whole
  state's slices, and their bytes as the rule gives.
Single-process: the split dim against ``repro.sharding.partition.
leaf_spec`` for every leaf of all 11 configs at published shapes (a
shape-only init) at k = 2, 4 and 16, and on random shapes; smollm-360m's
sizes; ``launch/mesh.py``'s checks against ``make_production_mesh``'s.
The largest gaps are printed beside their bounds.
"""
import collections
import functools
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - offline fallback
    from _hypothesis_compat import given, settings, strategies as st

import _torch_pods_worker as PW  # noqa: E402
import _torch_train_worker as W  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import ring_mixing  # noqa: E402
from repro.launch.mesh import make_production_mesh as j_mesh  # noqa: E402
from repro.models import moe as JMoe  # noqa: E402
from repro.sharding.partition import leaf_spec as j_leaf_spec  # noqa: E402
from repro.train.bilevel_lm import BilevelHyper as JBilevelHyper  # noqa: E402
from repro.train.bilevel_lm import local_grads as j_local_grads  # noqa: E402
from repro.train.step import init_train_state as j_init_train_state  # noqa: E402
from repro_torch.configs import _MODULES, get_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.sharding import partition as P  # noqa: E402
from repro_torch.sharding.collectives import AgentMesh, PodsMesh  # noqa: E402
from repro_torch.train.bilevel_lm import BilevelHyper  # noqa: E402
from repro_torch.train.step import (InteractConfig,  # noqa: E402
                                    make_eval_step, make_train_step)
from repro_torch.train.svr_step import make_svr_train_step  # noqa: E402

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
M, K = PW.SHAPE[0], PW.SHAPE[1]
S = W.SETTINGS
XY_TOL, UV_TOL, CE_RTOL, WIRE_TOL = 1e-5, 1e-4, 1e-5, 1e-6
TIMEOUT = 240
FIELDS = ("x", "y", "u", "v", "p_prev")
MOE_CASES = ("mixtral", "dbrx")
tmap = jax.tree_util.tree_map
np_tree = lambda t: tmap(np.asarray, t)
PREFIX_SCALE = 0.1


def _jcfg(case: str):
    arch, extra = PW.CASES[case]
    return j_get_config(arch).reduced(vocab_size=S["vocab_size"],
                                      num_layers=S["num_layers"],
                                      dtype="float32", **extra)


@functools.lru_cache(maxsize=None)
def _jitted(case: str):
    jcfg = _jcfg(case)
    hyper = JBilevelHyper(**W.hyper_kwargs())
    return jax.jit(lambda x, y, a, b, pa, pb: j_local_grads(
        jcfg, hyper, x, y, a, b, prefix_inner=pa, prefix_outer=pb))


@functools.lru_cache(maxsize=None)
def _setup(case: str):
    """The JAX initial state of M agents as numpy, the tokens (M, 4, 32)
    and, for a frontend, the prefix (M, 4, prefix, frontend_dim), all
    from numpy seeds."""
    jcfg = _jcfg(case)
    state = np_tree(jax.jit(lambda key: j_init_train_state(jcfg, key, M))(
        jax.random.PRNGKey(0))._asdict())
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (M, S["batch"], S["seq"]))
    prefix = None
    if jcfg.num_prefix_tokens:
        prefix = (PREFIX_SCALE * rng.standard_normal(
            (M, S["batch"], jcfg.num_prefix_tokens, jcfg.frontend_dim))
        ).astype(np.float32)
    return state, tokens, prefix


def _reference(case, r, steps, q=None, prev=None):
    """From the state ``r`` (numpy), the composed reference of Algorithm 1
    (``q=None``) or Algorithm 2 (``q``; the previous iterate ``prev``),
    under ``ring_mixing(M)``; each step's state and metrics."""
    _, tokens, prefix = _setup(case)
    lg = _jitted(case)
    mat = ring_mixing(M, self_weight=1.0 / 3.0).matrix.astype(np.float32)
    mix = lambda tree: tmap(lambda l: np.tensordot(mat, l, axes=1)
                            .astype(np.float32), tree)
    row = lambda tree, i: tmap(lambda l: l[i], tree)
    x_prev, y_prev = prev if prev is not None else (r["x"], r["y"])
    half = S["batch"] // 2
    states, metrics = [], []
    for _ in range(steps):
        t = int(r["t"])
        x_new = tmap(lambda mx, u: mx - np.float32(S["alpha"]) * u,
                     mix(r["x"]), r["u"])
        y_new = r["y"] - np.float32(S["beta"]) * r["v"]
        refresh = q is None or (t + 1) % q == 0
        ps, vs, ces = [], [], []
        for i in range(M):
            args = (tokens[i, :half], tokens[i, half:],
                    None if prefix is None else prefix[i, :half],
                    None if prefix is None else prefix[i, half:])
            p, v, c = np_tree(lg(row(x_new, i), y_new[i], *args))
            if not refresh:
                p_old, v_old, _ = np_tree(lg(row(x_prev, i), y_prev[i],
                                             *args))
                p = tmap(lambda pp, a, b: pp + a - b, row(r["p_prev"], i),
                         p, p_old)
                v = r["v"][i] + v - v_old
            ps.append(p)
            vs.append(v)
            ces.append(float(c))
        p_new = tmap(lambda *ls: np.stack(ls), *ps)
        u_new = tmap(lambda mu, pn, pp: mu + pn - pp, mix(r["u"]), p_new,
                     r["p_prev"])
        x_prev, y_prev = r["x"], r["y"]
        r = dict(r, x=x_new, y=y_new, u=u_new, v=np.stack(vs),
                 p_prev=p_new, t=t + 1)
        gsq = sum(float(np.sum(np.square(l.astype(np.float64))))
                  for l in jax.tree_util.tree_leaves(u_new))
        states.append(r)
        metrics.append({"outer_ce": float(np.mean(ces)),
                        "grad_norm": float(np.sqrt(gsq / M))})
    return states, metrics


def _chunk_inputs() -> dict:
    """A moe ffn (d_model 16, 4 experts of d_ff 8, top 2) and one batch of
    (8, 8, 16) tokens for the token-chunk case, from a numpy seed."""
    rng = np.random.default_rng(5)
    e, d, f = 4, 16, 8
    params = {"router": rng.standard_normal((d, e)) / 4,
              "w_gate": rng.standard_normal((e, d, f)) / 4,
              "w_up": rng.standard_normal((e, d, f)) / 4,
              "w_down": rng.standard_normal((e, f, d)) / 3}
    return dict(params={k: v.astype(np.float32) for k, v in params.items()},
                x=rng.standard_normal((8, 8, d)).astype(np.float32),
                num_experts=e, top_k=2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """The 4-process group's records, each case's reference beside them."""
    cases = {}
    for case in PW.CASES:
        state, tokens, prefix = _setup(case)
        cases[case] = dict(state=state, tokens=np.asarray(tokens, np.int64),
                           prefix=prefix)
    out = tmp_path_factory.mktemp("pods")
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": cases, "chunks": _chunk_inputs()}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_pods_worker.py"), str(rank),
         str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(M * K)]
    try:
        refs = {case: _reference(case, cases[case]["state"], PW.INTERACT_STEPS)
                for case in PW.CASES}
        before, mid = refs["smollm"][0][-2], refs["smollm"][0][-1]
        svr_start = dict(mid, x_prev=before["x"], y_prev=before["y"])
        tmp = out / "svr_inputs.pkl.tmp"
        tmp.write_bytes(pickle.dumps(svr_start))
        tmp.rename(out / "svr_inputs.pkl")
        refs["svr"] = _reference("smollm", mid, PW.SVR_STEPS, q=PW.Q,
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
             for r in range(M * K)]
    print(f"pods group: {time.perf_counter() - t0:.1f} s; rank 0's "
          f"seconds {ranks[0]['seconds']}")
    return dict(ranks=ranks, refs=refs)


def _whole(ranks, field: str, cfg, agent: int, like):
    """The agent's whole ``field`` put back together from its ranks'
    shards, in ``like``'s (the whole reference's) leaf order."""
    mine = sorted((r for r in ranks if r["agent"] == agent),
                  key=lambda r: r["data"])
    dims = (P.x_shard_dims(like, K) if isinstance(like, dict)
            else (P.head_shard_dim(like, K),))
    parts = [torch.utils._pytree.tree_leaves(r["state"][field])
             for r in mine]
    out = []
    for i, dim in enumerate(dims):
        chunks = [p[i] for p in parts]
        if dim is None:
            assert all(np.array_equal(c, chunks[0]) for c in chunks), (
                f"{field} leaf {i} is kept whole but its ranks differ")
            out.append(chunks[0])
        else:
            out.append(np.concatenate(chunks, axis=dim))
    return out


def _gaps(ranks, want: dict, cfg) -> dict:
    """Per field, the largest gap over agents and leaves, relative to each
    whole reference leaf's max-abs scale."""
    gaps = {}
    for agent in range(M):
        ref = train_state_from_numpy(
            collections.namedtuple("JState", list(want))(**want), cfg,
            "cpu", agent)
        for field in FIELDS:
            like = getattr(ref, field)
            got = _whole(ranks, field, cfg, agent, like)
            w = torch.utils._pytree.tree_leaves(like)
            assert [a.shape for a in got] == [tuple(b.shape) for b in w]
            gap = max(float(np.max(np.abs(a - b.numpy())))
                      / max(float(b.abs().max()), 1e-30)
                      for a, b in zip(got, w))
            gaps[field] = max(gaps.get(field, 0.0), gap)
    return gaps


def _case_ranks(pods, name: str) -> list:
    return [dict(agent=r["agent"], data=r["data"], **r[name])
            for r in pods["ranks"]]


@pytest.mark.parametrize("case", list(PW.CASES))
def test_pods_interact_matches_composed_reference(pods, case):
    ranks = _case_ranks(pods, case)
    ref_states, ref_metrics = pods["refs"][case]
    gaps = _gaps(ranks, ref_states[-1], PW.config(case))
    print(f"{case} pods INTERACT: largest gaps {gaps} (x, y bound "
          f"{XY_TOL}; u, v bound {UV_TOL})")
    assert gaps["x"] < XY_TOL and gaps["y"] < XY_TOL, gaps
    assert gaps["u"] < UV_TOL and gaps["v"] < UV_TOL, gaps
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["state"]["t"] == PW.INTERACT_STEPS
    for got, want in zip(ranks[0]["metrics"], ref_metrics):
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=CE_RTOL), (
                key, got, want)


def test_pods_svr_matches_composed_reference(pods):
    ranks = _case_ranks(pods, "svr")
    ref_states, ref_metrics = pods["refs"]["svr"]
    gaps = _gaps(ranks, ref_states[-1], PW.config("smollm"))
    print(f"smollm pods SVR-INTERACT: largest gaps {gaps} (x, y bound "
          f"{XY_TOL}; u, v bound {UV_TOL})")
    assert gaps["x"] < XY_TOL and gaps["y"] < XY_TOL, gaps
    assert gaps["u"] < UV_TOL and gaps["v"] < UV_TOL, gaps
    got = ranks[0]["metrics"]
    assert all(r["metrics"] == got for r in ranks)
    # from t = 2 with q = 3: a refresh, then two recursive steps
    assert [m["refresh"] for m in got] == [1.0, 0.0, 0.0]
    assert [m["outer_ce"] for m in got] == pytest.approx(
        [m["outer_ce"] for m in ref_metrics], rel=CE_RTOL)


class _DispatchRecorder:
    """Stands in for ``jax.numpy`` inside ``repro.models.moe``: records
    the dispatch tensor (n, k, E, C) of each ``moe_ffn`` call."""

    def __init__(self):
        self.dispatch = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kw):
        if spec == "nkec,nd->ecd":
            self.dispatch.append(np.asarray(operands[0]))
        return jnp.einsum(spec, *operands, **kw)


@pytest.mark.parametrize("case", MOE_CASES)
def test_pods_capacity_route_keeps_the_jax_set(pods, case, monkeypatch):
    cfg = PW.config(case)
    recorder = _DispatchRecorder()
    monkeypatch.setattr(JMoe, "jnp", recorder)
    dropped = 0
    for agent in range(M):
        mine = sorted((r for r in pods["ranks"] if r["agent"] == agent),
                      key=lambda r: r["data"])
        calls = [r[case]["routes"] for r in mine]
        assert len({len(c) for c in calls}) == 1 and calls[0]
        for parts in zip(*calls):
            router = parts[0]["router"]
            assert all(np.array_equal(p["router"], router) for p in parts)
            tokens = np.concatenate([p["tokens"] for p in parts])
            e, dm = cfg.num_experts, cfg.d_model
            params = {"router": jnp.asarray(router),
                      "w_gate": jnp.zeros((e, dm, 1)),
                      "w_up": jnp.zeros((e, dm, 1)),
                      "w_down": jnp.zeros((e, 1, dm))}
            JMoe.moe_ffn(params, jnp.asarray(tokens)[None],
                         num_experts=e, top_k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor)
            want = set(map(tuple, np.argwhere(recorder.dispatch.pop() != 0)
                           .tolist()))
            got = {tuple(row) for p in parts for row in p["kept"].tolist()}
            assert got == want
            assert len({p["capacity"] for p in parts}) == 1
            dropped += sum(p["slots"] for p in parts) - len(got)
    print(f"{case}: {dropped} slots dropped over the pods' capacity routes")
    assert dropped > 0


@pytest.mark.parametrize("name", list(PW.CHUNKS))
def test_pod_token_chunks_route_as_the_jax_batch(pods, name):
    ch = _chunk_inputs()
    want, want_aux = JMoe.moe_ffn(
        {k: jnp.asarray(v) for k, v in ch["params"].items()},
        jnp.asarray(ch["x"]), num_experts=ch["num_experts"],
        top_k=ch["top_k"], capacity_factor=1.0,
        token_chunk=PW.CHUNKS[name])
    ranks = [r[f"chunk_{name}"] for r in pods["ranks"]]
    got = np.concatenate([r["out"] for r in ranks])
    want = np.asarray(want)
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    aux = float(np.mean([r["aux"] for r in ranks]))
    print(f"token chunks {name}: output gap {gap} of scale, aux {aux} "
          f"against {float(want_aux)} (bounds {XY_TOL}, {CE_RTOL})")
    assert gap < XY_TOL
    assert aux == pytest.approx(float(want_aux), rel=CE_RTOL)


@pytest.mark.parametrize("name", list(PW.WIRE))
def test_wire_options_match_rows_layout(pods, name):
    gap = 0.0
    for r in pods["ranks"]:
        rec = r[f"wire_{name}"]
        for field in FIELDS:
            for a, b in zip(torch.utils._pytree.tree_leaves(
                    rec["pods"][field]), torch.utils._pytree.tree_leaves(
                    rec["rows"][field]), strict=True):
                gap = max(gap, float(np.max(np.abs(a - b)))
                          / max(float(np.max(np.abs(b))), 1e-30))
    print(f"{name} wire: pods against rows, largest gap {gap} (bound "
          f"{WIRE_TOL})")
    assert gap < WIRE_TOL


def test_init_shards_are_the_whole_state_slices(pods):
    assert all(r["init_bitwise"] for r in pods["ranks"])


def test_state_bytes_per_process_follow_the_rule(pods):
    cfg = PW.config("smollm")
    x, y = P.x_shapes(cfg)
    dims = P.x_shard_dims(x, K)
    per_x = sum(l.numel() // (K if d is not None else 1)
                for l, d in zip(torch.utils._pytree.tree_leaves(x), dims))
    per_y = y.numel() // (K if P.head_shard_dim(y, K) is not None else 1)
    want = 4 * (3 * per_x + 2 * per_y)          # float32 x, u, p_prev; y, v
    assert all(r["init_bytes"] == want for r in pods["ranks"])
    assert per_x < sum(l.numel() for l in torch.utils._pytree.tree_leaves(x))


def _jax_data_dim(shape, k: int):
    spec = tuple(j_leaf_spec(tuple(shape), 1, ("pod",), agent_leading=True,
                             extra_axes=(("data", k),)))
    return spec.index("data") if "data" in spec else None


@pytest.mark.parametrize("arch", sorted(_MODULES))
def test_split_dims_match_jax_leaf_spec(arch):
    x, y = P.x_shapes(get_config(arch))
    for k in (2, 4, 16):
        dims = P.x_shard_dims(x, k)
        for key, sub in x.items():
            leaves = torch.utils._pytree.tree_leaves(sub)
            at = list(x).index(key)
            start = sum(len(torch.utils._pytree.tree_leaves(x[kk]))
                        for kk in list(x)[:at])
            for i, leaf in enumerate(leaves):
                want = (_jax_data_dim(leaf.shape, k) if key == "layers"
                        else None)
                assert dims[start + i] == want, (arch, key, i, leaf.shape)
        assert P.head_shard_dim(y, k) == _jax_data_dim(y.shape, k)


@settings(max_examples=40, deadline=None)
@given(rank=st.integers(1, 4), a=st.integers(1, 64), b=st.integers(1, 64),
       c=st.integers(1, 64), d=st.integers(1, 64),
       k=st.sampled_from([1, 2, 3, 4, 16]))
def test_split_dim_property(rank, a, b, c, d, k):
    shape = (1,) + (a, b, c, d)[:rank]
    dim = P.tree_shard_dims(torch.empty(shape), k)[0]
    assert dim == _jax_data_dim(shape, k)
    if dim is not None:
        assert dim > 0 and shape[dim] % k == 0
        leaf = torch.arange(int(np.prod(shape)), dtype=torch.float32
                            ).reshape(shape)
        parts = [P.shard_leaf(leaf, dim, k, i) for i in range(k)]
        assert torch.equal(torch.cat(parts, dim=dim), leaf)


def test_smollm_360m_sizes_at_pods_of_2_and_16():
    x, y = P.x_shapes(get_config("smollm-360m"))
    leaves = torch.utils._pytree.tree_leaves(x)
    assert sum(l.numel() for l in leaves) == 361_821_120
    for k in (2, 16):
        dims = P.x_shard_dims(x, k)
        split = sum(l.numel() for l, d in zip(leaves, dims) if d is not None)
        layer_mats = sum(l.numel() for l in torch.utils._pytree.tree_leaves(
            x["layers"]) if l.dim() > 2)
        assert split == layer_mats == 314_572_800
        assert P.head_shard_dim(y, k) == 1 and y.numel() == 47_185_920
    dims = P.x_shard_dims(x, 2)
    per = sum(l.numel() // (2 if d is not None else 1)
              for l, d in zip(leaves, dims))
    assert per == 204_534_720


BAD_MESHES = [
    dict(shape=(2, 2), multi_pod=True),
    dict(shape=(0, 2)),
    dict(shape=()),
    dict(shape=(1, 1, 1, 1)),
    dict(shape=(1, 1), axis_names=("data",)),
    dict(axis_names=("data", "model")),
]


@pytest.mark.parametrize("kw", BAD_MESHES, ids=[str(i) for i in range(6)])
def test_mesh_checks_match_jax(kw):
    with pytest.raises(ValueError) as want:
        j_mesh(**kw)
    with pytest.raises(ValueError) as got:
        pmesh.make_production_mesh(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{}, dict(multi_pod=True), dict(shape=(64,))])
def test_mesh_shortfall_fails_hard_as_jax(kw):
    # the JAX mesh on one device more than this process has (how many it
    # has depends on the XLA flags a test process started with)
    with pytest.raises(RuntimeError, match="needs"):
        j_mesh(shape=(len(jax.devices()) + 1,))
    need = 64 if "shape" in kw else 512 if kw else 256
    for world in (1, need - 1):
        with pytest.raises(RuntimeError, match=f"needs {need} processes"):
            pmesh.make_production_mesh(**kw, world_size=world)
    assert pmesh.make_production_mesh(**kw, world_size=need).size == need


def test_mesh_layout_and_axes():
    one = pmesh.make_production_mesh(shape=(1, 1, 1))
    jone = j_mesh(shape=(1, 1, 1))
    assert one.axis_names == tuple(jone.axis_names)
    assert one.shape == dict(jone.shape)
    assert pmesh.agent_axes(one) == ("pod", "data")
    for fn in ("agent_axes", "agent_count", "model_axis"):
        assert getattr(pmesh, fn)(one) == getattr(
            __import__("repro.launch.mesh", fromlist=[fn]), fn)(jone)
    mesh = pmesh.make_production_mesh(shape=(2, 2, 1), world_size=4)
    assert mesh.rank_of(pod=1, data=0, model=0) == 2
    assert mesh.coords(3) == {"pod": 1, "data": 1, "model": 0}
    assert [mesh.rank_of(pod=p, data=d, model=0) for p in range(2)
            for d in range(2)] == [0, 1, 2, 3]


def _pods_mesh():
    # a pods mesh as rank 0 sees it; nothing here reaches a collective
    cpu = torch.device("cpu")
    return PodsMesh(ring=AgentMesh(2, 2, 0, cpu, "gloo"),
                    pod=AgentMesh(2, 2, 0, cpu, "gloo"))


def test_pods_layout_refusals():
    cfg = PW.config("smollm")
    icfg = InteractConfig()
    with pytest.raises(ValueError, match="PodsMesh"):
        make_train_step(cfg, AgentMesh(2, 2, 0, torch.device("cpu"), "gloo"),
                        icfg, agent_mode="pods")
    with pytest.raises(ValueError, match="agent_mode='pods'"):
        make_train_step(cfg, _pods_mesh(), icfg)
    with pytest.raises(ValueError, match="PodsMesh"):
        make_eval_step(cfg, _pods_mesh(), icfg)
    step = make_svr_train_step(cfg, _pods_mesh(), icfg, q=2,
                               agent_mode="pods")
    with pytest.raises(ValueError, match="divide by 4"):
        step(None, torch.zeros((2, 6, 8), dtype=torch.int64))
    # batch_shard is the pods layout's (it always splits the batch)
    make_train_step(cfg, _pods_mesh(), InteractConfig(
        hyper=BilevelHyper(batch_shard=True)), agent_mode="pods")
    with pytest.raises(NotImplementedError, match="item 10"):
        make_train_step(cfg, _pods_mesh(), InteractConfig(
            hyper=BilevelHyper(seq_shard=True)), agent_mode="pods")


def test_model_axis_is_refused(monkeypatch):
    from repro_torch.launch import distributed as D
    monkeypatch.setitem(D._STATE, "device", torch.device("cpu"))
    monkeypatch.setitem(D._STATE, "wire", "gloo")
    mesh = pmesh.make_production_mesh(shape=(1, 1, 2), world_size=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        D.pods_mesh(mesh)


def test_phase_4m_run_keeps_published_config():
    import dataclasses
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    run = smoke.LM_RUNS["smollm-360m-pods"]
    assert smoke.LM_PHASE_RUNS["lm_pods"] == ("smollm-360m-pods",)
    assert any("lm_pods" in group for group in smoke.PHASE_GROUPS)
    assert run["cut"] == {} and (run["agents"], run["pod"]) == (M, K)
    cfg, published = get_config(run["arch"]), j_get_config(run["arch"])
    for field in dataclasses.fields(published):
        assert getattr(cfg, field.name) == getattr(published, field.name)
    assert smoke.LM_BATCH % (2 * run["pod"]) == 0
    want = smoke.pods_state_bytes_want(cfg, run["pod"])
    assert (want["backbone_values"], want["head_values"]) == (
        204_534_720, 23_592_960)
    assert (want["bytes"], want["rows_bytes"]) == (1_321_580_160,
                                                   2_359_670_400)
