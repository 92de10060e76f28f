"""Mixture-of-Experts FFN: top-k softmax router with capacity dispatch.

Counterpart of ``repro.models.moe``.  Each token picks its ``top_k``
experts; ``moe_ffn`` gives each expert a buffer of ``capacity`` token
slots and drops what overflows (Mesh-TF style), ``moe_ffn_exact``
evaluates every expert on every token and drops nothing (decode).

The capacity route keeps exactly the JAX package's set of kept (token,
slot, expert, position) entries:

- ``capacity = max(1, int(capacity_factor * n * top_k / num_experts))``
  in Python floats;
- the router's softmax and top-k in float32, the top-k gates
  renormalised to sum to one;
- a token's position in its expert's buffer counts the earlier entries
  of the k-major flattening (every token's first choice comes before any
  token's second choice), and an entry is kept when its position is
  below the capacity.

The JAX package builds that as one-hot dispatch and combine tensors of
(n, k, E, C) and contracts them with einsums; the port indexes instead
(``capacity_routing``): the kept tokens are copied into the (E, C, d)
buffers, the experts run as batched matmuls over those buffers, and each
token gathers its slots' outputs back.  The one-hot contractions have
one nonzero term, so the buffers hold the same values.

Compute is E * capacity * (3 d_model d_ff): the active experts' FLOPs
(up to the capacity factor), not a dense all-experts evaluation.

The pods layout (``pod``, an ``AgentMesh`` of the agent's pod).  Each
rank of a pod holds a contiguous share of the agent's batch, and the
route is the agent's whole batch's: the ranks exchange their
per-(slot, expert) counts (a small int tensor, one all-gather a call),
take n and the capacity over the pod, and shift each entry's position
by the earlier slots' pod-wide counts and the earlier ranks' counts of
its slot, so that the kept (token, slot, expert, position) set is the
one the whole batch's route keeps.  The aux takes the pod's fraction of
tokens an expert (no gradient) times this rank's mean probabilities:
the pod's mean of the ranks' aux is the whole batch's.  With
``token_chunk``, a chunk lies in one rank's share (routed there alone)
or spans whole shares (routed over their ranks), as the chunks of the
JAX package's logical batch do; other splits raise.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_normal

__all__ = ["Routing", "capacity_routing", "init_moe", "moe_ffn",
           "moe_ffn_exact", "router_load_balance_loss"]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype, device) -> dict:
    si, so = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)

    def normal(shape, scale):
        return init_normal(gen, shape, scale, dtype, device)

    return {
        "router": normal((d_model, num_experts), si),
        "w_gate": normal((num_experts, d_model, d_ff), si),
        "w_up": normal((num_experts, d_model, d_ff), si),
        "w_down": normal((num_experts, d_ff, d_model), so),
    }


def router_load_balance_loss(router_probs: torch.Tensor,
                             expert_mask: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss: E * <fraction routed, mean prob>."""
    num_experts = router_probs.shape[-1]
    density = expert_mask.mean(dim=0)           # fraction of tokens/expert
    density_proxy = router_probs.mean(dim=0)    # mean router prob/expert
    return num_experts * torch.sum(density * density_proxy)


def _router(params: dict, tokens: torch.Tensor, top_k: int):
    """(probs (n, E), renormalised top-k gates (n, k), experts (n, k)),
    in float32 as the JAX package's router."""
    probs = torch.softmax((tokens @ params["router"]).float(), dim=-1)
    gates, experts = torch.topk(probs, top_k, dim=-1)
    return probs, gates / gates.sum(dim=-1, keepdim=True), experts


def _aux(probs: torch.Tensor, experts: torch.Tensor, dtype) -> torch.Tensor:
    # the mask of chosen experts, before any drop
    mask = torch.zeros_like(probs).scatter_(1, experts, 1.0)
    return router_load_balance_loss(probs, mask).to(dtype)


class Routing(NamedTuple):
    """The capacity route of n tokens: each (token, slot) entry's expert,
    gate and position in that expert's buffer, and whether it is kept."""
    probs: torch.Tensor      # (n, E) float32 router probabilities
    gates: torch.Tensor      # (n, k) float32, renormalised over the top k
    experts: torch.Tensor    # (n, k) int64
    positions: torch.Tensor  # (n, k) int64, earlier entries of the expert
    keep: torch.Tensor       # (n, k) bool: positions < capacity
    capacity: int
    # on a pod: (E,) float32, the pod's share of tokens routed to each
    # expert (the aux's fraction); None on one rank
    density: torch.Tensor | None = None


def capacity_routing(params: dict, tokens: torch.Tensor, *,
                     num_experts: int, top_k: int,
                     capacity_factor: float = 1.25, pod=None,
                     pod_ranks: tuple[int, int] | None = None) -> Routing:
    """Route ``tokens`` (n, d_model) as ``moe_ffn`` does (see the module
    docstring for the rules).  ``pod``: this rank's tokens are its share
    of the batch of the pod's ranks ``pod_ranks = (lo, hi)`` (default
    all), in rank order; positions and capacity are that batch's."""
    n = tokens.shape[0]
    probs, gates, experts = _router(params, tokens, top_k)
    # k-major: entry j = slot * n + token; an entry's position is the
    # number of earlier entries that chose the same expert, its rank
    # among them in a stable sort by expert
    flat = experts.T.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=num_experts)
    starts = torch.cumsum(counts, dim=0) - counts
    ranks = (torch.arange(flat.numel(), device=flat.device)
             - starts[flat[order]])
    positions = torch.empty_like(flat).scatter_(0, order, ranks)
    positions = positions.reshape(top_k, n).T
    density = None
    if pod is None:
        capacity = max(1, int(capacity_factor * n * top_k / num_experts))
    else:
        lo, hi = pod_ranks or (0, pod.world_size)
        slots = torch.zeros(top_k, num_experts, dtype=torch.int64,
                            device=experts.device).scatter_add_(
            1, experts.T, torch.ones_like(experts.T))
        table = pod.all_gather(slots[None])[lo:hi]    # (ranks, k, E)
        total = table.sum(0)
        n_pod = int(total[0].sum())
        capacity = max(1, int(capacity_factor * n_pod * top_k
                              / num_experts))
        # an entry's position: the earlier slots' entries of its expert
        # over the pod, the earlier ranks' of its slot, then this rank's
        shift = (torch.cumsum(total, 0) - total
                 + table[:pod.rank - lo].sum(0)
                 - (torch.cumsum(slots, 0) - slots))
        slot_of = torch.arange(top_k, device=experts.device)[None]
        positions = positions + shift[slot_of.expand(n, -1), experts]
        density = total.sum(0).to(torch.float32) / n_pod
    return Routing(probs, gates, experts, positions, positions < capacity,
                   capacity, density)


def _pod_chunks(pod, n_local: int, token_chunk: int):
    """On a pod, where the chunks of ``token_chunk`` tokens of the pod's
    batch fall: ``None`` (each in one rank's share: route them there
    alone) or the ranks ``(lo, hi)`` whose shares make this rank's
    chunk.  Raises where a chunk would cut a share."""
    if n_local % token_chunk == 0:
        return None
    if token_chunk % n_local == 0:
        g = token_chunk // n_local
        lo = pod.rank // g * g
        return lo, lo + g
    raise NotImplementedError(
        f"moe token_chunk {token_chunk} neither divides nor is a multiple "
        f"of a pod rank's {n_local} tokens: a chunk would cut a rank's "
        "share of the batch")


def moe_ffn(params: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, token_chunk: int | None = None,
            expert_parallel: bool = False, pod=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (batch, seq, d_model) -> (output, aux_loss), the capacity route.

    ``token_chunk``: route chunks of this many tokens, each with its own
    capacity, and average the aux over the chunks (as the JAX package's
    scan; used when it divides the token count and is smaller).
    ``expert_parallel`` is accepted and changes nothing on one card: the
    JAX package pins the expert buffers to the ``model`` mesh axis with it.
    ``pod``: x is this rank's share of its pod's batch (module docstring).
    """
    b, s, d = x.shape
    n_total = b * s
    k = 1 if pod is None else pod.world_size
    pod_ranks = None
    if (token_chunk is not None and n_total * k > token_chunk
            and n_total * k % token_chunk == 0):
        if pod is not None:
            pod_ranks = _pod_chunks(pod, n_total, token_chunk)
        if pod_ranks is None:
            n_chunks = n_total // token_chunk
            aux = torch.zeros((), dtype=x.dtype, device=x.device)
            outs = []
            for xc in x.reshape(n_chunks, 1, token_chunk, d):
                out, a = moe_ffn(params, xc, num_experts=num_experts,
                                 top_k=top_k,
                                 capacity_factor=capacity_factor)
                aux = aux + a
                outs.append(out)
            return torch.stack(outs).reshape(b, s, d), aux / n_chunks
    tokens = x.reshape(n_total, d)
    r = capacity_routing(params, tokens, num_experts=num_experts,
                         top_k=top_k, capacity_factor=capacity_factor,
                         pod=pod, pod_ranks=pod_ranks)

    # dispatch: each kept entry's token into its expert's buffer slot
    token_of = torch.arange(n_total, device=x.device)[:, None].expand(
        -1, top_k)
    xe = tokens.new_zeros(num_experts, r.capacity, d).index_put(
        (r.experts[r.keep], r.positions[r.keep]), tokens[token_of[r.keep]])
    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe,
                                                            params["w_up"])
    ye = torch.bmm(h, params["w_down"])                     # (E, C, d)
    # combine: each token's kept slots, weighted by their gates (cast to
    # the model dtype, as the JAX combine tensor is); a dropped slot
    # weighs 0
    picked = ye[r.experts, r.positions.clamp(max=r.capacity - 1)]
    weights = torch.where(r.keep, r.gates, 0.0).to(x.dtype)
    out = torch.sum(picked * weights[..., None], dim=1)
    if r.density is None:
        return out.reshape(b, s, d), _aux(r.probs, r.experts, x.dtype)
    aux = num_experts * torch.sum(r.density * r.probs.mean(dim=0))
    return out.reshape(b, s, d), aux.to(x.dtype)


def moe_ffn_exact(params: dict, x: torch.Tensor, *, num_experts: int,
                  top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-free routing: every selected expert computes its token.

    Exact (no drops), at the cost of evaluating *all* experts densely and
    masking: the right trade for decode, where the batch is small and the
    step reads every expert's weights anyway.
    """
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    probs, gates, experts = _router(params, tokens, top_k)
    h = F.silu(torch.matmul(tokens, params["w_gate"]))      # (E, n, f)
    h = h * torch.matmul(tokens, params["w_up"])
    y_all = torch.bmm(h, params["w_down"])                  # (E, n, d)
    weights = torch.zeros_like(probs).scatter(1, experts, gates).to(x.dtype)
    out = torch.einsum("ne,end->nd", weights, y_all)
    return out.reshape(b, s, d), _aux(probs, experts, x.dtype)
