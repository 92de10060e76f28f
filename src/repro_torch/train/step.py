"""The INTERACT train step across a process group.

Counterpart of ``repro.train.step``.  The paper's m agents are the ranks
of a ``torch.distributed`` group, one agent a process, held by an
``AgentMesh`` (``repro_torch.sharding.collectives``): the JAX package's
``shard_map`` gives each agent row a local slice of 1, and here every
leaf of a process's state carries a leading agent dim of 1 too.  Each
agent keeps a *distinct* backbone x_i, exactly Problem (1).

Consensus (eqs. 6 / 10) goes through the ``ppermute`` engine
(``InteractConfig.consensus_engine``), which decomposes the configured
topology's mixing matrix (ring, Erdős–Rényi or torus) into per-offset
neighbour exchanges; int8 wire compression and local-DP noise are engine
options.  As in the JAX package, any other consensus backend raises.

One call is one INTERACT iteration (Algorithm 1), through the shared
``consensus_descent_and_track`` step-core:
  Step 1: x <- mix(x) - alpha u ;  y <- y - beta v
  Step 2: (p, v) local hypergradient / inner gradient at the new iterate
  Step 3: u <- mix(u) + p - p_prev

The metrics are averaged over the group (one all-reduce), as ``pmean``
averages them over the agent axis.  Stepping is eager.  With a frontend
(``with_prefix=True``) the step takes each agent's prefix embeddings
beside its tokens and splits them into inner and outer halves as it
splits the tokens.

The pods layout (``agent_mode="pods"``, on a ``PodsMesh`` from
``repro_torch.launch.distributed.pods_mesh``): an agent is a pod of k
processes, its whole INTERACT state (x, y, u, v, p_prev) sharded over
the pod by ``repro_torch.sharding.partition`` (``init_train_state(...,
mesh=)`` gives each rank its shards, bit for bit the whole state's
slices).  A step runs Step 1 on the shards, mixing each shard with the
like shards of the other pods over the rank's ring (mixing is
elementwise); gathers the agent's x and y over the pod once; runs Step 2
on this rank's share of the agent's batch (rank d of the pod takes the
d-th of k equal parts of each split, so the per-agent batch must divide
by 2k), with the pod's means (``bilevel_lm``); reduce-scatters p and v
to the shards; and runs Step 3 on the shards.  It computes what the rows
layout computes for the same m agents on the same tokens, up to the
order of the reductions.  ``grad_norm`` counts a leaf kept whole on
every rank once.  This slice gathers whole trees, not a layer at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.consensus import consensus_descent_and_track, make_engine
from repro_torch.core.consensus import MixingSpec
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.base import ArchConfig
from repro_torch.sharding import partition as P
from repro_torch.sharding.collectives import AgentMesh, PodShards, PodsMesh
from repro_torch.train.bilevel_lm import (BilevelHyper, check_hyper,
                                          local_grads, outer_loss)

__all__ = ["TrainState", "InteractConfig", "PodLayout", "init_train_state",
           "make_train_step", "make_eval_step"]


class TrainState(NamedTuple):
    x: Any            # backbone params, leaves (1, ...): this process's agent
    y: torch.Tensor   # the agent's head (1, d_model, vocab)
    u: Any            # tracked gradient, like x
    v: torch.Tensor   # inner gradient, like y
    p_prev: Any       # previous hypergradient, like x
    t: int            # step counter


@dataclasses.dataclass(frozen=True)
class InteractConfig:
    alpha: float = 1e-2          # outer step size (Theorem 1 bound applies)
    beta: float = 0.5            # inner step size
    self_weight: float = 1.0 / 3.0  # ring mixing w0
    hyper: BilevelHyper = BilevelHyper()
    # consensus engine selection (repro_torch/consensus):
    consensus_backend: str = "ppermute"    # the only mesh-native backend
    topology: str = "ring"                 # ring | erdos-renyi | torus
    p_connect: float = 0.5                 # ER edge probability
    topology_seed: int = 0                 # ER graph sample seed
    # paper future-work extensions (conclusion, both opt-in):
    consensus_compress: str | None = None  # "int8" compressed consensus
    dp_sigma: float = 0.0                  # local-DP noise on shared x
    # SVR refresh period (make_svr_train_step's when q is not given)
    q: int | None = None

    def topology_config(self):
        """The declarative graph shared with ``repro_torch.solvers``."""
        from repro_torch.solvers.config import TopologyConfig
        return TopologyConfig(kind=self.topology, p_connect=self.p_connect,
                              seed=self.topology_seed,
                              self_weight=self.self_weight)

    def mixing_spec(self, m: int) -> MixingSpec:
        """The configured topology's mixing matrix for m agents."""
        return self.topology_config().mixing_spec(m)

    def solver_config(self, algo: str = "interact"):
        """The equivalent ``repro_torch.solvers.SolverConfig``.

        The LM path's hypergradient is the head-space Neumann series on
        cached features, the linearize-once replay of eq. (22), so the
        exported ``HypergradConfig`` records it as the
        ``neumann-linearized`` backend with BilevelHyper's K and L_g
        (round-tripped back by ``from_solver_config``).
        """
        from repro_torch.hypergrad import HypergradConfig
        from repro_torch.solvers.config import SolverConfig
        opts = {}
        if self.consensus_compress is not None:
            opts["compress"] = self.consensus_compress
        if self.dp_sigma:
            opts["dp_sigma"] = self.dp_sigma
        hg = HypergradConfig(method="neumann", backend="neumann-linearized",
                             neumann_k=self.hyper.neumann_k,
                             lipschitz_g=self.hyper.lipschitz_g)
        return SolverConfig(algo=algo, alpha=self.alpha, beta=self.beta,
                            q=self.q, topology=self.topology_config(),
                            backend=self.consensus_backend,
                            backend_opts=opts, hypergrad=hg)

    @classmethod
    def from_solver_config(cls, scfg, hyper: BilevelHyper | None = None):
        """Build the LM-runtime config from a ``SolverConfig``.

        ``hyper`` defaults to ``BilevelHyper()``, with the Neumann
        settings (K, L_g) imported from ``scfg.hypergrad`` when it
        selects a Neumann estimator.  ``scfg.seed`` plays no role on the
        LM path (deterministic token streams).
        """
        if scfg.mixing is not None:
            raise ValueError(
                "SolverConfig.mixing (an explicit MixingSpec) cannot drive "
                "the distributed runtime: the mesh realises the graph from "
                "the declarative topology; set SolverConfig.topology instead")
        opts = dict(scfg.backend_opts)
        if hyper is None:
            hyper = BilevelHyper()
            if scfg.hypergrad.resolve_backend().startswith("neumann"):
                hyper = dataclasses.replace(
                    hyper, neumann_k=scfg.hypergrad.neumann_k,
                    lipschitz_g=scfg.hypergrad.lipschitz_g)
        return cls(alpha=scfg.alpha, beta=scfg.beta,
                   self_weight=scfg.topology.self_weight,
                   hyper=hyper,
                   consensus_backend=scfg.backend,
                   topology=scfg.topology.kind,
                   p_connect=scfg.topology.p_connect,
                   topology_seed=scfg.topology.seed,
                   consensus_compress=opts.get("compress"),
                   dp_sigma=opts.get("dp_sigma", 0.0),
                   q=scfg.q)

    @classmethod
    def coerce(cls, cfg, hyper: BilevelHyper | None = None):
        """Accept either an InteractConfig or a ``SolverConfig``."""
        if isinstance(cfg, cls):
            return cfg
        return cls.from_solver_config(cfg, hyper=hyper)

    def consensus_engine(self, m: int, mesh: AgentMesh,
                         shards: PodShards | None = None):
        """The ``ppermute`` engine of this config on ``mesh``, its
        per-offset permute rounds (``shards``: the leaves are a pod's
        shards).  The JAX package falls back to its psum realisation only
        where an old JAX cannot lower permutes beside an auto model axis;
        an ``AgentMesh`` has no model axis.
        """
        if self.consensus_backend != "ppermute":
            raise ValueError(
                f"backend {self.consensus_backend!r} cannot run the LM train "
                "step; the distributed runtime requires 'ppermute' (dense, "
                "cuda and allgather serve the solvers)")
        return make_engine("ppermute", self.mixing_spec(m), mesh.device,
                           mesh=mesh, compress=self.consensus_compress,
                           dp_sigma=self.dp_sigma, shards=shards)


def _zeros_like_tree(tree):
    return pytree.tree_map(torch.zeros_like, tree)


def _squeeze(tree):
    return pytree.tree_map(lambda l: l[0], tree)


def _unsqueeze(tree):
    return pytree.tree_map(lambda l: l[None], tree)


def init_train_state(cfg: ArchConfig, seed: int = 0,
                     device: str | torch.device | None = None,
                     mesh: PodsMesh | None = None) -> TrainState:
    """This process's initial state, every leaf with a leading agent dim
    of 1: every agent starts from the same (x0, y0), drawn from ``seed``
    (every process of a run passes the same one), as in Algorithm 1; u,
    v and p_prev start at zero (the first step's tracking difference
    makes u_1 = p_1).  On the card unless ``device="cpu"``.  With a
    ``PodsMesh`` (the pods layout), this rank's shards of that state (on
    the mesh's device unless ``device`` is given)."""
    if mesh is not None and device is None:
        device = mesh.device
    params = M.init_params(cfg, seed, with_head=True,
                           device=resolve_device(device))
    y = params.pop("head")[None]
    x = _unsqueeze(params)
    if mesh is not None:
        k, d = mesh.pod_size, mesh.data_index
        x = P.shard_tree(x, P.x_shard_dims(x, k), k, d)
        y = P.shard_leaf(y, P.head_shard_dim(y, k), k, d)
    return TrainState(x=x, y=y, u=_zeros_like_tree(x),
                      v=torch.zeros_like(y), p_prev=_zeros_like_tree(x), t=0)


def _local_tokens(mesh: AgentMesh, tokens: torch.Tensor, ndim: int = 3
                  ) -> torch.Tensor:
    """This process's row of a global (m, b, ...) batch or its own (1, b,
    ...) row: the tokens (``ndim`` 3, (b, s)) or a frontend's prefix
    embeddings (``ndim`` 4, (b, prefix, frontend_dim))."""
    if tokens.dim() != ndim:
        raise ValueError(f"expected an (m, b, ...) or (1, b, ...) batch of "
                         f"{ndim} dims, got {tuple(tokens.shape)}")
    if tokens.shape[0] == mesh.num_agents:
        tokens = tokens[mesh.row0:mesh.row0 + 1]
    elif tokens.shape[0] != 1:
        raise ValueError(f"the batch carries {tokens.shape[0]} agent rows; "
                         f"the mesh holds {mesh.num_agents}")
    return tokens[0].to(mesh.device)


def _split(tokens: torch.Tensor | None, pod: AgentMesh | None = None):
    """The first half of the batch is the inner split, the second the
    outer split (``(None, None)`` for no prefix).  ``pod``: this rank's
    share of each, the d-th of k equal parts; raises unless the batch
    divides by 2k."""
    if tokens is None:
        return None, None
    half = tokens.shape[0] // 2
    if pod is None:
        return tokens[:half], tokens[half:]
    k, d = pod.world_size, pod.rank
    if tokens.shape[0] % (2 * k):
        raise ValueError(
            f"a per-agent batch of {tokens.shape[0]} does not split into "
            f"inner and outer halves over a pod of {k}: it must divide by "
            f"{2 * k}")
    c = half // k
    return (tokens[d * c:(d + 1) * c],
            tokens[half + d * c:half + (d + 1) * c])


class PodLayout:
    """The pods layout of a config on a ``PodsMesh``: the split dim of
    each backbone leaf, by key path, and of the head
    (``repro_torch.sharding.partition``, from a shape-only init), and the
    pod's gathers and reduce-scatters of the state's trees."""

    def __init__(self, cfg: ArchConfig, mesh: PodsMesh):
        x, y = P.x_shapes(cfg)
        k = mesh.pod_size
        paths = P.leaf_paths(x)
        self.pod = mesh.pod
        self.x_shards = PodShards(
            mesh.pod, dict(zip(paths, P.x_shard_dims(x, k))),
            {p: tuple(l.shape) for p, l in zip(paths,
                                                pytree.tree_leaves(x))})
        self.y_dims = (P.head_shard_dim(y, k),)

    def x_dims(self, tree) -> tuple:
        return tuple(self.x_shards.dims[p] for p in P.leaf_paths(tree))

    def gather(self, x, y):
        """The agent's whole (x, y) from this rank's shards."""
        return (P.gather_tree(x, self.x_dims(x), self.pod),
                P.gather_tree(y, self.y_dims, self.pod))

    def scatter(self, p, v):
        """This rank's shards of the pod's mean of the ranks' (p, v)."""
        return (P.reduce_scatter_tree(p, self.x_dims(p), self.pod),
                P.reduce_scatter_tree(v, self.y_dims, self.pod))

    def sq_norm(self, tree) -> torch.Tensor:
        """The agent's squared norm of a backbone tree of shards: the
        shards' sums over the pod, each whole leaf once."""
        leaves = pytree.tree_leaves(tree)
        dims = self.x_dims(tree)
        sq = lambda ls: sum((torch.sum(torch.square(l.to(torch.float32)))
                             for l in ls), torch.zeros(
            (), dtype=torch.float32, device=leaves[0].device))
        split = sq([l for l, d in zip(leaves, dims) if d is not None])
        whole = sq([l for l, d in zip(leaves, dims) if d is None])
        return self.pod.all_reduce(split.reshape(1))[0] + whole


def pmean(mesh: AgentMesh, *values: torch.Tensor) -> torch.Tensor:
    """The group means of the 0-dim ``values``, in one all-reduce."""
    stacked = torch.stack([v.to(torch.float32) for v in values])
    return mesh.all_reduce(stacked) / mesh.world_size


def _check_layout(mesh, agent_mode: str) -> AgentMesh:
    """The mesh of the agents' ring: ``mesh`` itself (rows, one agent a
    process) or a ``PodsMesh``'s ring (pods); raises on a mismatch."""
    if agent_mode == "pods":
        if not isinstance(mesh, PodsMesh):
            raise ValueError(
                "agent_mode='pods' runs on a PodsMesh (repro_torch.launch."
                "distributed.pods_mesh over a (pod, data, model) process "
                f"mesh), not on a {type(mesh).__name__}")
        return mesh.ring
    if agent_mode != "rows":
        raise ValueError(f"unknown agent_mode {agent_mode!r}")
    if isinstance(mesh, PodsMesh):
        raise ValueError("a PodsMesh holds an agent on a pod of processes: "
                         "pass agent_mode='pods'")
    if mesh.local_agents != 1:
        raise ValueError(
            f"the train step runs one agent a process, but the mesh puts "
            f"{mesh.local_agents} agents on each of its {mesh.world_size} "
            f"processes: launch {mesh.num_agents} processes")
    return mesh


def make_train_step(cfg: ArchConfig, mesh: AgentMesh, icfg: InteractConfig,
                    *, with_prefix: bool = False, agent_mode: str = "rows"):
    """Returns ``step(state, tokens, prefix=None) -> (state, metrics)``.

    ``icfg`` may be an ``InteractConfig`` or a ``SolverConfig`` (coerced
    via ``from_solver_config``).  ``mesh`` is this process's
    ``AgentMesh`` (one agent a process), or with ``agent_mode="pods"``
    its ``PodsMesh`` (the module docstring).  ``tokens``: the global (m,
    per_agent_batch, seq) batch or this agent's (1, b, s) row; the
    first half of the agent's batch is the inner split, the second the
    outer split.  ``prefix``: a frontend's embeddings, the global (m, b,
    prefix, frontend_dim) batch or this agent's row, split as the
    tokens are (``with_prefix`` mirrors the JAX signature: the step takes
    a prefix either way).  ``metrics``: ``outer_ce`` and ``grad_norm``
    (of the tracked gradient u), 0-dim float32 tensors averaged over the
    agents.
    """
    icfg = InteractConfig.coerce(icfg)
    ring = _check_layout(mesh, agent_mode)
    hyper = icfg.hyper
    check_hyper(hyper, differentiate=True, pods=agent_mode == "pods")
    lay = PodLayout(cfg, mesh) if agent_mode == "pods" else None
    pod = None if lay is None else lay.pod
    engine = icfg.consensus_engine(ring.num_agents, ring,
                                   None if lay is None else lay.x_shards)

    def step(state: TrainState, tokens, prefix=None):
        inner_t, outer_t = _split(_local_tokens(ring, tokens), pod)
        pre_in, pre_out = _split(None if prefix is None
                                 else _local_tokens(ring, prefix, ndim=4),
                                 pod)
        dp_key = (0, state.t) if icfg.dp_sigma > 0 else None

        def grads_fn(x_new, y_new):
            # ---- Step 2: local gradients at the new iterate -------------
            if lay is not None:
                x_new, y_new = lay.gather(x_new, y_new)
            p_new, v_new, outer_ce = local_grads(
                cfg, hyper, _squeeze(x_new), y_new[0], inner_t, outer_t,
                prefix_inner=pre_in, prefix_outer=pre_out, pod=pod)
            if lay is not None:
                return (*lay.scatter(_unsqueeze(p_new), v_new[None]),
                        outer_ce)
            return _unsqueeze(p_new), v_new[None], outer_ce

        # Steps 1-3 through the shared step-core on the ppermute engine.
        # First iteration: p_prev and u are zero, so Step 3 sets u_1 = p_1.
        x_new, y_new, u_new, v_new, p_new, _, outer_ce = (
            consensus_descent_and_track(
                engine, state.x, state.y, state.u, state.v, state.p_prev,
                icfg.alpha, icfg.beta, grads_fn, t=state.t, dp_key=dp_key))

        gsq = (sum(torch.sum(torch.square(l.to(torch.float32)))
                   for l in pytree.tree_leaves(u_new))
               if lay is None else lay.sq_norm(u_new))
        mean_ce, mean_gsq = pmean(ring, outer_ce, gsq)
        new_state = TrainState(x=x_new, y=y_new, u=u_new, v=v_new,
                               p_prev=p_new, t=state.t + 1)
        return new_state, {"outer_ce": mean_ce,
                           "grad_norm": torch.sqrt(mean_gsq)}

    return step


def make_eval_step(cfg: ArchConfig, mesh: AgentMesh, icfg: InteractConfig):
    """``step(state, tokens) -> outer CE`` averaged over the agents at the
    current iterate (no update), a 0-dim float32 tensor.

    A forward-only call under ``torch.no_grad``: with
    ``hyper.attn_impl="cuda"`` it runs the flash attention (or WKV6)
    kernel on the card, once a layer.
    """
    icfg = InteractConfig.coerce(icfg)
    _check_layout(mesh, "rows")
    hyper = icfg.hyper
    check_hyper(hyper, differentiate=False)

    def step(state, tokens):
        toks = _local_tokens(mesh, tokens)
        with torch.no_grad():
            ce = outer_loss(cfg, hyper, _squeeze(state.x), state.y[0], toks)
        return pmean(mesh, ce)[0]

    return step
