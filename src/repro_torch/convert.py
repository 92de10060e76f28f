"""Carry parameters, data and solver state from numpy into the port.

The JAX package's pytrees, turned into numpy arrays by the caller (for
example ``jax.tree_util.tree_map(np.asarray, tree)``), become the port's
tensors here with their structure kept: a backbone ``[(W0, b0), (W1,
b1)]`` stays a list of tuples in the same leaf order.  The parity tests
feed both packages the same x0, y0, data and mid-run states this way.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.bilevel import AgentData
from repro_torch.core.interact import InteractState

__all__ = ["agent_data_from_numpy", "lm_params_from_numpy",
           "state_from_numpy", "train_state_from_numpy", "tree_from_numpy"]


def tree_from_numpy(tree, device: torch.device | str):
    """Every numpy leaf of ``tree`` as a tensor on ``device`` (a copy);
    ``None`` stays ``None``."""
    return pytree.tree_map(
        lambda a: None if a is None else torch.tensor(np.asarray(a),
                                                      device=device), tree)


def agent_data_from_numpy(data, device: torch.device | str) -> AgentData:
    """``AgentData`` from any object with ``inner_x``/``inner_y``/
    ``outer_x``/``outer_y`` arrays; labels become int64."""
    to = lambda a, dtype: torch.tensor(np.asarray(a), dtype=dtype,
                                       device=device)
    return AgentData(inner_x=to(data.inner_x, torch.float32),
                     inner_y=to(data.inner_y, torch.int64),
                     outer_x=to(data.outer_x, torch.float32),
                     outer_y=to(data.outer_y, torch.int64))


def state_from_numpy(state, device: torch.device | str,
                     kind: type = InteractState):
    """A port state of class ``kind`` (``InteractState``, ``SvrState``,
    ``GtDsgdState``, ``DsgdState``) from any object with its fields:
    numpy pytrees, and ``t``.  The wire state ``ef`` comes across as its
    nested dicts, the guard counters ``guard`` as a dict of 0-dim int32
    tensors with its keys sorted (``{"last_good", "tripped"}``), each or
    ``None``."""
    fields = {f: tree_from_numpy(getattr(state, f), device)
              for f in kind._fields if f != "t"}
    if fields.get("guard") is not None:
        fields["guard"] = {k: fields["guard"][k]
                           for k in sorted(fields["guard"])}
    return kind(**fields, t=int(np.asarray(state.t)))


def lm_params_from_numpy(tree, cfg, device: torch.device | str) -> dict:
    """The JAX package's ``init_params`` pytree (numpy leaves) as the
    port's LM parameters.

    ``tree["layers"]`` is a list over the period's pattern of dicts whose
    leaves carry a leading period axis; the port's ``params["layers"]``
    holds one dict per layer, layer ``period * len(pattern) + i`` taken
    from ``tree["layers"][i]`` at index ``period``.  ``embed``,
    ``final_norm`` and ``head`` (when present) carry over as they are.
    """
    pattern_len = len(cfg.layer_pattern())
    if len(tree["layers"]) != pattern_len:
        raise ValueError(f"{len(tree['layers'])} period entries, but "
                         f"{cfg.name}'s pattern has {pattern_len}")
    layers = [
        pytree.tree_map(lambda a, period=period: torch.tensor(
            np.asarray(a)[period], device=device), tree["layers"][i])
        for period in range(cfg.num_periods()) for i in range(pattern_len)]
    params = {key: tree_from_numpy(value, device)
              for key, value in tree.items() if key != "layers"}
    params["layers"] = layers
    return params


def train_state_from_numpy(state, cfg, device: torch.device | str,
                           agent: int, pod: tuple[int, int] | None = None):
    """Agent ``agent``'s row of the JAX package's ``TrainState`` or
    ``SvrTrainState`` (numpy leaves, a leading agent axis, stacked layers)
    as the port's state of the same name, every leaf with a leading
    agent dim of 1 (one agent a process).

    The backbone fields (x, u, p_prev, x_prev) go through
    ``lm_params_from_numpy``; the heads (y, v, y_prev) carry over; ``t``
    becomes an int.  ``pod = (k, d)``: the pods layout's shards of rank d
    of the agent's pod of k (``sharding.partition.train_state_shards``).
    """
    from repro_torch.train.step import TrainState
    from repro_torch.train.svr_step import SvrTrainState
    kind = SvrTrainState if "x_prev" in state._fields else TrainState
    fields = {}
    for name in kind._fields:
        value = getattr(state, name)
        if name == "t":
            fields[name] = int(np.asarray(value))
            continue
        if isinstance(value, dict):
            row = lm_params_from_numpy(
                pytree.tree_map(lambda a: np.asarray(a)[agent], value),
                cfg, device)
        else:
            row = torch.tensor(np.asarray(value)[agent], device=device)
        fields[name] = pytree.tree_map(lambda l: l[None], row)
    if pod is not None:
        from repro_torch.sharding.partition import train_state_shards
        return train_state_shards(kind(**fields), *pod)
    return kind(**fields)
