"""The port's mamba mixer against the JAX package's.

Reduced jamba-1.5-large's mixer widths (d_model 128, d_state 8, d_conv
4, expand 2), float32.  The JAX ``init_mamba`` draws the weights, which
carry over as numpy; the same numpy inputs (from a seed) go through both
packages:

- ``mamba_block`` over 64 tokens, whole and with ``seq_chunk`` 16 (four
  chunks, the state carried across them), and the gradients of a
  weighted sum of its output in every parameter;
- ``mamba_prefill``: y and both state leaves (h after the last token,
  the conv tail), also for a sequence shorter than the tail;
- ``mamba_decode_step``: 4 steps from the JAX prefill's state, outputs
  and states;
- ``_ssm_apply`` over 2048 steps at strong decay (A down to -16, dt about
  0.018, with and without an incoming state): the port's doubling scan
  against the JAX associative scan, where a scan that divides out
  exp(cumsum(log decay)) would overflow.

All within ``TOL`` = 1e-5 of the JAX values' max-abs scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import mamba as JMb  # noqa: E402
from repro_torch.convert import tree_from_numpy  # noqa: E402
from repro_torch.models import mamba as Mb  # noqa: E402

TOL = 1e-5
BATCH, SEQ, CHUNK, DECODE = 2, 64, 16, 4


@pytest.fixture(scope="module")
def setup():
    cfg = j_get_config("jamba-1.5-large-398b").reduced()
    jparams = JMb.init_mamba(jax.random.PRNGKey(0), cfg.d_model,
                             cfg.mamba_d_state, cfg.mamba_d_conv,
                             cfg.mamba_expand, jnp.float32)
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    x = np.random.default_rng(1).standard_normal(
        (BATCH, SEQ + DECODE, cfg.d_model)).astype(np.float32)
    return cfg, jparams, params, x


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    gap = float(np.abs(got.detach().numpy() - want).max())
    assert gap <= TOL * float(np.abs(want).max()), (gap, TOL)


def test_params_have_the_jax_shapes_and_constants(setup):
    cfg, jparams, _, _ = setup
    params = Mb.init_mamba(torch.Generator().manual_seed(0), cfg.d_model,
                           cfg.mamba_d_state, cfg.mamba_d_conv,
                           cfg.mamba_expand, torch.float32, "cpu")
    assert sorted(params) == sorted(jparams)
    for name, leaf in params.items():
        assert tuple(leaf.shape) == jparams[name].shape, name
    for name in ("conv_b", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(params[name].numpy(),
                                      np.asarray(jparams[name]))
    # log(n) for n = 1 .. d_state: the two libraries' logs may differ in
    # the last bit
    np.testing.assert_allclose(params["a_log"].numpy(),
                               np.asarray(jparams["a_log"]), rtol=2e-7)


@pytest.mark.parametrize("seq_chunk", [None, CHUNK])
def test_mamba_block_matches_jax(setup, seq_chunk):
    _, jparams, params, x = setup
    x = x[:, :SEQ]
    want = JMb.mamba_block(jparams, jnp.asarray(x), seq_chunk=seq_chunk)
    _close(Mb.mamba_block(params, torch.tensor(x), seq_chunk=seq_chunk),
           want)


@pytest.mark.parametrize("seq", [SEQ, 2])
def test_mamba_prefill_matches_jax(setup, seq):
    _, jparams, params, x = setup
    x = x[:, :seq]
    jout, jstate = JMb.mamba_prefill(jparams, jnp.asarray(x))
    out, state = Mb.mamba_prefill(params, torch.tensor(x))
    _close(out, jout)
    _close(state["h"], jstate["h"])
    _close(state["conv"], jstate["conv"])


def test_mamba_decode_steps_match_jax(setup):
    _, jparams, params, x = setup
    _, jstate = JMb.mamba_prefill(jparams, jnp.asarray(x[:, :SEQ]))
    state = {k: torch.tensor(np.asarray(v)) for k, v in jstate.items()}
    for t in range(SEQ, SEQ + DECODE):
        jout, jstate = JMb.mamba_decode_step(jparams, jnp.asarray(
            x[:, t:t + 1]), jstate)
        out, state = Mb.mamba_decode_step(params, torch.tensor(
            x[:, t:t + 1]), state)
        _close(out, jout)
        _close(state["h"], jstate["h"])
        _close(state["conv"], jstate["conv"])


def test_decode_state_starts_at_zero():
    state = Mb.init_mamba_state(3, 16, 4, 4, 2, torch.bfloat16, "cpu")
    jstate = JMb.init_mamba_state(3, 16, 4, 4, 2, jnp.bfloat16)
    for name in ("h", "conv"):
        assert tuple(state[name].shape) == jstate[name].shape
        assert not state[name].any()
    assert state["h"].dtype == torch.float32
    assert state["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("with_h0", [False, True])
def test_long_scan_at_strong_decay_matches_jax(with_h0):
    rng = np.random.default_rng(2)
    b, s, d_inner, n = 1, 2048, 4, 16
    params = {"d_skip": np.ones(d_inner, np.float32)}
    u = rng.standard_normal((b, s, d_inner)).astype(np.float32)
    dt = np.full((b, s, d_inner), 0.018, np.float32) * rng.uniform(
        0.5, 1.5, (b, s, d_inner)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    A = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d_inner, 1))
    h0 = (rng.standard_normal((b, d_inner, n)).astype(np.float32)
          if with_h0 else None)
    args = (u, dt, B, C, A)
    jy, jh = JMb._ssm_apply({k: jnp.asarray(v) for k, v in params.items()},
                            *map(jnp.asarray, args),
                            h0=None if h0 is None else jnp.asarray(h0))
    y, h = Mb._ssm_apply({k: torch.tensor(v) for k, v in params.items()},
                         *map(torch.tensor, args),
                         h0=None if h0 is None else torch.tensor(h0))
    assert bool(torch.isfinite(y).all())
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("seq_chunk", [None, CHUNK])
def test_mamba_block_gradients_match_jax(setup, seq_chunk):
    """Gradients of a weighted sum of the block's output in every
    parameter; with ``seq_chunk`` each chunk is recomputed in the backward
    pass (a checkpoint, as the JAX package's scan body)."""
    _, jparams, params, x = setup
    x = x[:, :SEQ]
    w = np.random.default_rng(3).standard_normal(
        (BATCH, SEQ, x.shape[-1])).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(JMb.mamba_block(
        p, jnp.asarray(x), seq_chunk=seq_chunk) * w))(jparams)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = torch.sum(Mb.mamba_block(leaves, torch.tensor(x),
                                    seq_chunk=seq_chunk) * torch.tensor(w))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for name, got in zip(leaves, grads):
        _close(got, jgrads[name])
