"""The paper's bilevel problem instantiated on the LM architectures.

Counterpart of ``repro.train.bilevel_lm``.  Per agent i (the Section-3.2
meta-learning form, scaled up):

  outer  f_i(x, y_i) = CE(head y_i on backbone_x(outer split)) + router aux
  inner  g_i(x, y_i) = CE(head y_i on backbone_x(inner split)) + (mu/2)||y_i||^2

x = backbone parameters (the consensus variable), y_i = the agent's LM
head (d_model, vocab); the ridge makes the inner problem strongly
convex.

Hypergradient (eq. 5 / 22) exploits the readout structure: H_yy(g)
touches x only through the backbone features, so the K-term Neumann
series runs in *head space* on cached features (``_neumann_head``: the
head gradient linearized once in closed form, ``_linearize_head``, K - 1
applications of its tangent map), and the single cross term H_xy z is
one extra backward through the backbone.

The cross term.  H_xy(g) z = grad_x d/de g(x, y + e z), and the tangent
touches only the head: per chunk of tokens the directional derivative
of the CE is ``(softmax(l) . dl - dl[gold]) / n`` with ``l`` the chunk's
logits and ``dl`` their tangent (``f z``, through the final softcap
where the config has one), plus ``mu <y, z>``.  The port writes that
closed form and takes one plain backward of it through the backbone
(``_inner_directional``), so ``remat``'s checkpoints hold there too;
the JAX package differentiates a ``jax.jvp`` of the inner loss.

Gradients are ``torch.autograd`` on detached copies of the leaves
(``_value_and_grad``), so ``features(..., remat=True)``'s per-layer
checkpoints recompute the backbone in the backward pass.  The LM-head
cross entropy runs in sequence chunks (``chunked_ce``): the forward
holds one chunk's (tokens, vocab) logits at a time; the backward keeps
what each chunk's softmax needs, as the JAX package's scan keeps its
residuals.

A frontend's prefix embeddings (``prefix``, ``prefix_inner``,
``prefix_outer``) go before the tokens in the backbone, and their
features are dropped from the CE by aligning on the label length; as in
the JAX package, ``local_grads`` accumulates no microbatches when a
prefix is given.  ``attn_impl="blockwise"`` runs the streaming-softmax
attention, which recomputes each kv block in the backward pass.

The pods layout (``pod``, an ``AgentMesh`` of the agent's pod: the
train steps' ``agent_mode="pods"``).  Each rank of the pod holds the
whole backbone and head (gathered by the step) and a contiguous share
of each split, and computes the gradients of its share's losses; what
is linear in the batch is the pod's mean of the ranks' values: the CE
values, grad_x f and the cross term (the step reduce-scatters p), and
v = grad_y g (each rank's carries the ridge's mu y once, so the mean
keeps it once).  What is not linear is made pod-wide here: grad_y f is
all-reduced before the Neumann series, and each head-space HVP
all-reduces its CE part and adds mu T once; the moe ffns route the
pod's batch (``models/moe.py``).  Microbatches with a moe ffn on a pod
raise: a rank's microbatches are not the pod's.

Refused, each naming what it waits for: ``attn_impl="cuda"`` on a
gradient path (neither package has a backward kernel for flash attention
or WKV6; forward-only calls under ``torch.no_grad`` run it, as the eval
step does), ``seq_shard`` (the model axis: tensor parallelism) and
``batch_shard`` outside the pods layout, which always splits an agent's
batch over its pod.
``unroll_scans`` is accepted and changes nothing: the port's loops are
Python loops.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from repro_torch.hypergrad.neumann import neumann_truncated_apply
from repro_torch.models import model as M
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import IMPLS

__all__ = ["BilevelHyper", "check_hyper", "chunked_ce", "inner_loss",
           "local_grads", "outer_loss", "ridge"]

DEFAULT_CE_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class BilevelHyper:
    """Hyper-parameters of the bilevel LM problem and its estimator."""

    mu_g: float = 0.1            # inner strong convexity (ridge)
    neumann_k: int = 4           # K of eq. (22)
    lipschitz_g: float = 2.0     # L_g scale of the Neumann series
    ce_chunk: int = DEFAULT_CE_CHUNK
    remat: bool = True
    attn_impl: str = "reference"  # or "blockwise"; "cuda" forward only
    seq_shard: bool = False   # the model axis: refused
    batch_shard: bool = False  # agent_mode="pods" only (it always is)
    microbatch: int = 1        # gradient-accumulation microbatches
    unroll_scans: bool = False  # accepted; the port's loops are Python


def check_hyper(hyper: BilevelHyper, differentiate: bool,
                pods: bool = False) -> None:
    """Raise for what the port cannot run; ``differentiate`` marks a
    gradient path, which refuses the forward-only kernels, ``pods`` the
    pods layout, the only one that takes ``batch_shard``."""
    if hyper.seq_shard:
        raise NotImplementedError(
            "BilevelHyper.seq_shard shards the residual stream over the "
            "model axis (tensor parallelism), which the port does not run: "
            "it waits for ROADMAP Queue A item 10")
    if hyper.batch_shard and not pods:
        raise ValueError(
            "BilevelHyper.batch_shard splits an agent's batch over its "
            "pod's data axis: it needs agent_mode='pods' (make_train_step "
            "on a PodsMesh); the rows layout holds one agent a process")
    if hyper.attn_impl not in IMPLS:
        raise ValueError(f"unknown attn_impl {hyper.attn_impl!r}; the port "
                         f"has {IMPLS}")
    if differentiate and hyper.attn_impl == "cuda":
        raise NotImplementedError(
            "attn_impl='cuda' on a gradient path: the flash attention and "
            "WKV6 kernels have no backward kernel in either package.  Use "
            "attn_impl='reference' for training; the cuda kernels run in "
            "forward-only calls under torch.no_grad() (make_eval_step)")


def ridge(y: torch.Tensor, mu: float) -> torch.Tensor:
    return 0.5 * mu * torch.sum(torch.square(y.float()))


def _next_token_pairs(feats: torch.Tensor, labels: torch.Tensor):
    """Each position's features and the token after it, flattened:
    ``(ft (n, d), lt (n,))``; a prefix's features are dropped by aligning
    on the label length."""
    n_pre = feats.shape[1] - labels.shape[1]
    f = feats[:, n_pre:][:, :-1]
    return f.reshape(-1, f.shape[-1]), labels[:, 1:].reshape(-1)


def _chunk_bounds(n: int, chunk: int):
    chunk = min(chunk, n)
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def chunked_ce(cfg: ArchConfig, head: torch.Tensor, feats: torch.Tensor,
               labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Next-token CE with the head applied chunk by chunk over tokens.

    feats: (b, s, d) backbone outputs; labels: (b, s) token ids (the
    sequence itself: the shift happens here).  A float32 scalar.
    """
    ft, lt = _next_token_pairs(feats, labels)
    n = ft.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=ft.device)
    for lo, hi in _chunk_bounds(n, chunk):
        logits = M.head_logits(cfg, head, ft[lo:hi]).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, lt[lo:hi, None])[:, 0]
        total = total + torch.sum(logz - gold)
    return total / n


def _backbone(cfg: ArchConfig, x, tokens, prefix, hyper: BilevelHyper,
              pod=None):
    check_hyper(hyper, differentiate=torch.is_grad_enabled(),
                pods=pod is not None)
    return M.features(cfg, x, tokens, prefix_embed=prefix,
                      impl=hyper.attn_impl, remat=hyper.remat, pod=pod)


def _pod_mean(pod, t: torch.Tensor) -> torch.Tensor:
    """The pod's mean of ``t``, summed in float32, in ``t``'s dtype."""
    return (pod.all_reduce(t.to(torch.float32).reshape(-1))
            .div_(pod.world_size).reshape(t.shape).to(t.dtype))


def inner_loss(cfg: ArchConfig, hyper: BilevelHyper, x, y, tokens,
               prefix=None, pod=None) -> torch.Tensor:
    feats, _aux = _backbone(cfg, x, tokens, prefix, hyper, pod)
    return (chunked_ce(cfg, y, feats, tokens, hyper.ce_chunk)
            + ridge(y, hyper.mu_g))


def outer_loss(cfg: ArchConfig, hyper: BilevelHyper, x, y, tokens,
               prefix=None, pod=None) -> torch.Tensor:
    feats, aux = _backbone(cfg, x, tokens, prefix, hyper, pod)
    ce = chunked_ce(cfg, y, feats, tokens, hyper.ce_chunk)
    return ce + cfg.router_aux_weight * aux


def _linearize_head(cfg: ArchConfig, hyper: BilevelHyper, y, feats,
                    labels, pod=None):
    """``(v, hvp)``: v = grad_y g at the cached features, and ``hvp(T) =
    H_yy(g) T``, the head gradient linearized once at y in closed form.

    Per chunk of tokens (features f, n tokens in all) the linearization
    keeps the softmax p of the logits and, with a final softcap, tau =
    tanh(raw / cap) of the raw logits f y, all float32 (chunk, vocab).
    The CE's gradient with respect to the logits is g = (p - onehot) / n,
    with respect to the raw logits g (1 - tau^2).  Along T the raw logits
    move by dr = f T and the logits by dl = (1 - tau^2) dr, so

      d g = p (dl - <p, dl>) / n,
      d (g (1 - tau^2)) = d g (1 - tau^2) - 2 g tau (1 - tau^2) dr / cap,

    and H_yy T is the sum over chunks of f^T times that, plus mu T; the
    products with f^T run in float32.  ``torch.func.linearize`` gives the
    same map, but its folded constants hold tens of head-sized tensors,
    more than an 80 GB card has left beside jamba-1.5-large's training
    state at its 8192 x 65,536 head, and outlive the call until a garbage
    collection; this one holds the chunks' residuals and two float32
    heads.  ``pod``: the features are this rank's share of its pod's;
    v is this rank's (the step takes the pod's mean), and ``hvp`` is the
    pod's: its CE part all-reduced, mu T added once.
    """
    ft, lt = _next_token_pairs(feats, labels)
    n = ft.shape[0]
    cap = cfg.final_logit_softcap
    chunks = []
    v = y.to(torch.float32, copy=True).mul_(hyper.mu_g)
    for lo, hi in _chunk_bounds(n, hyper.ce_chunk):
        fc = ft[lo:hi]
        raw = (fc @ y).float()
        tau = None if cap is None else torch.tanh(raw / cap)
        p = torch.softmax(raw if cap is None else cap * tau, dim=-1)
        g = p.clone()
        g[torch.arange(hi - lo, device=g.device), lt[lo:hi]] -= 1.0
        g = g / n
        v.addmm_(fc.float().T, g if cap is None else g * (1 - tau * tau))
        chunks.append((fc, p, tau, g))

    def hvp(t: torch.Tensor) -> torch.Tensor:
        out = (t.to(torch.float32, copy=True).mul_(hyper.mu_g)
               if pod is None else
               torch.zeros(t.shape, dtype=torch.float32, device=t.device))
        for fc, p, tau, g in chunks:
            dr = (fc @ t).float()
            dl = dr if cap is None else (1 - tau * tau) * dr
            dg = p * (dl - torch.sum(p * dl, dim=-1, keepdim=True)) / n
            if cap is not None:
                dg = (dg * (1 - tau * tau)
                      - 2 * g * tau * (1 - tau * tau) * dr / cap)
            out.addmm_(fc.float().T, dg)
        if pod is not None:
            out = pod.all_reduce(out).div_(pod.world_size).add_(
                t.to(torch.float32), alpha=hyper.mu_g)
        return out.to(t.dtype)

    return v.to(y.dtype), hvp


def _neumann_head(cfg, hyper: BilevelHyper, y, feats, labels, b, pod=None):
    """``(z, v)``: z = [H_yy g]^{-1} b by the K-term Neumann series in
    head space, v = grad_y g at the cached features.

    The head gradient is linearized once (``_linearize_head`` at y; its
    value is v) and the K-term chain of eq. (22) applies its tangent map
    through ``neumann_truncated_apply(skip_last=True)``: K - 1
    head-space HVPs.
    """
    v, hvp = _linearize_head(cfg, hyper, y, feats, labels, pod)
    z, _count = neumann_truncated_apply(hvp, b, hyper.neumann_k,
                                        hyper.lipschitz_g, skip_last=True)
    return z, v


def _head_logits_and_tangent(cfg: ArchConfig, y, z, fc):
    """A chunk's logits at head y and their tangent along z, in float32."""
    raw, draw = fc @ y, fc @ z
    cap = cfg.final_logit_softcap
    if cap is None:
        return raw.float(), draw.float()
    t = torch.tanh(raw / cap)
    return (cap * t).float(), (draw * (1 - t * t)).float()


def _inner_directional(cfg: ArchConfig, hyper: BilevelHyper, x, y, z,
                       tokens, prefix=None, pod=None) -> torch.Tensor:
    """d/de g(x, y + e z) at e = 0, differentiable in x: per chunk
    ``softmax(l) . dl - dl[gold]``, summed over tokens over n, plus
    ``mu <y, z>``."""
    feats, _ = _backbone(cfg, x, tokens, prefix, hyper, pod)
    ft, lt = _next_token_pairs(feats, tokens)
    n = ft.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=ft.device)
    for lo, hi in _chunk_bounds(n, hyper.ce_chunk):
        logits, dlogits = _head_logits_and_tangent(cfg, y, z, ft[lo:hi])
        probs = torch.softmax(logits, dim=-1)
        gold = torch.gather(dlogits, 1, lt[lo:hi, None])[:, 0]
        total = total + torch.sum(torch.sum(probs * dlogits, dim=-1) - gold)
    return total / n + hyper.mu_g * torch.sum(y.float() * z.float())


def _value_and_grad(fn, args: tuple, argnums: tuple):
    """``(fn(*args), grads)``: the gradients of the scalar ``fn`` with
    respect to the pytrees ``args[i]`` for i in ``argnums``, by one
    ``torch.autograd`` backward on detached copies of their leaves."""
    call = list(args)
    specs, leaves = [], []
    for i in argnums:
        flat, spec = pytree.tree_flatten(args[i])
        flat = [leaf.detach().requires_grad_(True) for leaf in flat]
        call[i] = pytree.tree_unflatten(flat, spec)
        specs.append((spec, len(flat)))
        leaves += flat
    with torch.enable_grad():
        val = fn(*call)
        grads = torch.autograd.grad(val, leaves)
    out, at = [], 0
    for spec, count in specs:
        out.append(pytree.tree_unflatten(grads[at:at + count], spec))
        at += count
    return val.detach(), tuple(out)


def _accum_grads(loss_of_tokens, args, tokens, k, argnums):
    """Gradient accumulation over k microbatches: peak activation memory
    of the pass drops by about k; values and grads are exact means."""
    b = tokens.shape[0]
    tb = tokens.reshape(k, b // k, *tokens.shape[1:])
    val = torch.zeros((), dtype=torch.float32, device=tokens.device)
    grads = tuple(pytree.tree_map(torch.zeros_like, args[i])
                  for i in argnums)
    for toks in tb:
        v, g = _value_and_grad(loss_of_tokens, (*args, toks), argnums)
        grads = pytree.tree_map(lambda a, gi: a + gi / k, grads, g)
        val = val + v / k
    return val, grads


def local_grads(cfg: ArchConfig, hyper: BilevelHyper, x, y,
                inner_tokens, outer_tokens, prefix_inner=None,
                prefix_outer=None, pod=None):
    """(p, v, outer_ce): the paper's eqs. (8)-(9) for the LM problem.

    p = grad_x f - H_xy(g) [H_yy(g)]^{-1} grad_y f     (hypergradient)
    v = grad_y g                                        (inner gradient)

    ``x`` is the backbone's parameter dict, ``y`` the (d_model, vocab)
    head, the token splits (b, s), the prefixes their splits' frontend
    embeddings (b, prefix, frontend_dim) or None.  Microbatches are
    accumulated only where no prefix is given, as in the JAX package.
    ``pod``: the token splits are this rank's shares of its pod's (module
    docstring); p and v are then this rank's, outer_ce the pod's.
    Raises before it computes anything on what ``check_hyper`` refuses.
    """
    check_hyper(hyper, differentiate=True, pods=pod is not None)
    k = hyper.microbatch
    use_mb = (k > 1 and prefix_outer is None and prefix_inner is None
              and outer_tokens.shape[0] % k == 0
              and inner_tokens.shape[0] % k == 0)
    if (use_mb and pod is not None
            and any(s.ffn == "moe" for s in cfg.layer_pattern())):
        raise NotImplementedError(
            "microbatches of a moe model on a pod: each rank's microbatch "
            "would route its own tokens, not the pod's microbatch")

    # --- outer: grad wrt both x and y (one fwd+bwd through the backbone).
    if use_mb:
        outer_val, (gx_f, gy_f) = _accum_grads(
            lambda xp, yh, toks: outer_loss(cfg, hyper, xp, yh, toks,
                                            pod=pod),
            (x, y), outer_tokens, k, (0, 1))
    else:
        outer_val, (gx_f, gy_f) = _value_and_grad(
            lambda xp, yh: outer_loss(cfg, hyper, xp, yh, outer_tokens,
                                      prefix_outer, pod),
            (x, y), (0, 1))
    if pod is not None:
        gy_f = _pod_mean(pod, gy_f)
        outer_val = _pod_mean(pod, outer_val)

    # --- inner features, computed once and reused by the head-space HVPs.
    y = y.detach()
    with torch.no_grad():
        feats_in, _ = _backbone(cfg, x, inner_tokens, prefix_inner,
                                hyper, pod)
    z, v = _neumann_head(cfg, hyper, y, feats_in, inner_tokens, gy_f, pod)

    # --- cross term H_xy(g) z = grad_x d/de g(x, y + e z)  (one fwd+bwd).
    if use_mb:
        _, (gx_cross,) = _accum_grads(
            lambda xp, toks: _inner_directional(cfg, hyper, xp, y, z, toks,
                                                pod=pod),
            (x,), inner_tokens, k, (0,))
    else:
        _, (gx_cross,) = _value_and_grad(
            lambda xp: _inner_directional(cfg, hyper, xp, y, z,
                                          inner_tokens, prefix_inner, pod),
            (x,), (0,))

    # p in grad_x f's own buffers: no third backbone-sized tree at the peak
    p = pytree.tree_map(lambda a, b: a.sub_(b), gx_f, gx_cross)
    return p, v, outer_val
