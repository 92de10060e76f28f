"""The port's flash attention against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
(interpret mode, as tests/test_kernels.py runs it), the JAX oracle
``ref.attention_ref``, and the port's wrapper ``ops.flash_attention``,
which on CPU tensors runs its plain version (``ref.py``).  The CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py and by tests/test_torch_kernels_cuda.py.

Tolerances, as in tests/test_kernels.py: float32 2e-5 (one softmax and
two products summed in another order), bfloat16 2e-2 (the output rounded
to 8 bits of mantissa).

On the card, bfloat16 runs a tensor-core kernel whose rounding points
differ from the plain version's.  ``_tc_emulation`` below repeats them
in float32 on the CPU, and the tests of it size the per-row gate that
chip_smoke.py and tests/test_torch_kernels_cuda.py hold that kernel to.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as j_ops  # noqa: E402
from repro.kernels.flash_attention import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# tests/test_kernels.py's FLASH_CASES:
# (batch, seq, heads, kv_heads, head_dim, causal, window, softcap, dtype)
FLASH_CASES = [
    (2, 256, 4, 2, 64, True, None, None, "float32"),
    (1, 256, 8, 1, 128, True, None, None, "float32"),     # MQA
    (1, 256, 4, 4, 64, True, 128, None, "float32"),       # SWA
    (1, 192, 4, 2, 64, True, None, 50.0, "float32"),      # softcap
    (1, 256, 4, 2, 64, True, 64, 30.0, "float32"),        # SWA+softcap
    (2, 128, 4, 2, 64, False, None, None, "float32"),     # bidirectional
    (1, 200, 4, 2, 64, True, None, None, "float32"),      # padded seq
    (1, 256, 2, 2, 256, True, None, None, "bfloat16"),    # bf16, hd=256
    (1, 128, 4, 2, 32, True, None, None, "bfloat16"),
]


def _inputs(b, sq, skv, nh, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, nh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,nh,nkv,hd,causal,win,cap,dtype", FLASH_CASES)
def test_flash_attention_matches_jax_kernel_and_ref(b, s, nh, nkv, hd, causal,
                                                     win, cap, dtype):
    arrays = _inputs(b, s, s, nh, nkv, hd)
    kw = dict(causal=causal, window=win, logit_softcap=cap)
    got = ops.flash_attention(*_torch(arrays, dtype), **kw)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (b, s, nh, hd)
    _close(got, j_ops.flash_attention(*_jax(arrays, dtype), **kw),
           TOL[dtype])
    _close(got, j_ref.attention_ref(*_jax(arrays, dtype), **kw), TOL[dtype])


@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (1, 256, 255, None),     # one decode query against its prefix
    (7, 300, 293, 64),       # a suffix of queries, sliding window
])
def test_flash_attention_q_offset_matches_jax_kernel_and_ref(sq, skv,
                                                             q_offset, window):
    arrays = _inputs(1, sq, skv, 4, 2, 64, seed=1)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = ops.flash_attention(*_torch(arrays, "float32"), **kw)
    _close(got, j_ops.flash_attention(*_jax(arrays, "float32"), **kw), 2e-5)
    _close(got, j_ref.attention_ref(*_jax(arrays, "float32"), **kw), 2e-5)


@pytest.mark.parametrize("causal,q_offset", [
    (False, 0),      # bidirectional over a ragged length
    (True, 110),     # queries past the last key
])
def test_flash_attention_edge_cases_match_jax_ref(causal, q_offset):
    # Held against the JAX oracle only: the JAX wrapper pads k and v with
    # zero rows up to a block multiple and relies on the causal mask to
    # hide them, which neither case gives, so where it pads (s = 100 with
    # blocks of 64 -> 128, off by 0.10 here) its output differs from
    # ref.py.  The port masks columns past the keys itself.
    arrays = _inputs(1, 100, 100, 4, 2, 64, seed=2)
    kw = dict(causal=causal, q_offset=q_offset)
    got = ops.flash_attention(*_torch(arrays, "float32"), **kw)
    _close(got, j_ref.attention_ref(*_jax(arrays, "float32"), **kw), 2e-5)


@pytest.mark.parametrize("window,q_offset", [(2, 40), (6, 16)])
def test_flash_attention_row_without_visible_key_is_zero(window, q_offset):
    # 16 keys; with window 2 and q_offset 40 no row sees a key, with window
    # 6 and q_offset 16 rows 5-7 (positions 21-23) see none.  Held against
    # the JAX oracle only: the JAX kernel gives such rows, in a tile it
    # visits, the mean of that tile's values.
    arrays = _inputs(1, 8, 16, 2, 1, 32, seed=3)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = ops.flash_attention(*_torch(arrays, "float32"), **kw)
    _close(got, j_ref.attention_ref(*_jax(arrays, "float32"), **kw), 2e-5)
    blind = [i for i in range(8) if i + q_offset - window + 1 >= 16]
    assert blind and torch.count_nonzero(got[:, blind]) == 0


def test_cpu_tensors_run_the_plain_version_and_launch_nothing(monkeypatch):
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return ref.attention_ref(*args, **kwargs)

    monkeypatch.setattr(ops, "attention_ref", spy)
    monkeypatch.setitem(ops.LAUNCHES, "flash_attention", 0)
    monkeypatch.setitem(ops.LAUNCHES, "flash_attention_tc", 0)
    for dtype in ("float32", "bfloat16"):
        calls.clear()
        q, k, v = _torch(_inputs(1, 64, 64, 4, 2, 32), dtype)
        out = ops.flash_attention(q, k, v, window=16, logit_softcap=30.0)
        assert calls == [dict(causal=True, window=16, logit_softcap=30.0,
                              q_offset=0)]
        assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0}
        torch.testing.assert_close(
            out, ref.attention_ref(q, k, v, window=16, logit_softcap=30.0),
            atol=0, rtol=0)


@pytest.mark.parametrize("shapes,kw,error", [
    (((1, 8, 3, 32), (1, 8, 2, 32)), {}, ValueError),          # 3 over 2
    (((1, 8, 4, 32), (2, 8, 2, 32)), {}, ValueError),          # batch
    (((1, 8, 4, 32), (1, 8, 2, 16)), {}, ValueError),          # head size
    (((1, 8, 4, 32), (1, 8, 2, 32)), {"window": 0}, ValueError),
    (((1, 8, 4, 32), (1, 8, 2, 32)), {"q_offset": -1}, ValueError),
    (((1, 8, 4, 32), (1, 8, 2, 32)), {"logit_softcap": 0.0}, ValueError),
])
def test_flash_attention_rejects_bad_arguments(shapes, kw, error):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(error):
        ops.flash_attention(q, k, k.clone(), **kw)


def test_flash_attention_rejects_mixed_dtypes():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention(q, k, k)


def test_tc_alignment_check_accepts_contiguous_and_aligned_views():
    q = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 8, 2, 128, dtype=torch.bfloat16)
    ops.check_tc_alignment(q, k, k)
    ops.check_tc_alignment(q[:, :, ::2], k[..., :64], k[..., 64:])
    # a stride of a length-1 axis is never used
    ops.check_tc_alignment(q[:1], k[:1, :1], k[:1, :1])


@pytest.mark.parametrize("view,match", [
    (lambda t: t[..., 4:68], "16-byte aligned"),      # pointer + 8 bytes
    (lambda t: t.as_strided((1, 8, 2, 64), (1020, 136, 68, 1)), "16 bytes"),
])
def test_tc_alignment_check_rejects_misaligned_views(view, match):
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    k = view(torch.zeros(1, 8, 2, 80, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=match):
        ops.check_tc_alignment(q, k, k)


# -- the bfloat16 tensor-core kernel's rounding, emulated -------------------

# The per-row gate of the bfloat16 kernel on the card (chip_smoke.py,
# tests/test_torch_kernels_cuda.py): ``ops.row_errors`` at most
# ``ops.TC_ROW_RTOL``, ||got - want||_2 <= 1e-2 ||want||_2 for every
# (batch, query, head) row, want the plain version in float32 on the same
# bf16 inputs.  It must be at least 3x the largest row error of the
# emulation below, so that a right kernel passes with room and a wrong one
# (a dropped tile, a wrong mask, a transposed fragment: errors of order 1)
# fails.
TC_TILE = 64


def _tc_emulation(q, k, v, *, causal=True, window=None, logit_softcap=None,
                  q_offset=0, p_terms=2):
    """The tensor-core kernel's arithmetic on bf16 inputs, in float32:
    query tiles and kv tiles of 64, only the kv tiles a query tile can
    see, float32 scores of the bf16 inputs, softcap, mask, online softmax
    (running max and sum, rescale of the sum and the output at every
    tile), P as two bf16 terms hi = bf16(p), lo = bf16(p - hi) and P . V
    as hi . V + lo . V, float32 sums, the sum taken over the unrounded P,
    the output divided by it and rounded to bf16.  ``p_terms=1`` keeps
    only hi: the kernel built with REPRO_FLASH_P_TERMS=1, which
    ``repro_torch.kernels.flash_attention.bench_p_terms`` times."""
    b, sq, nh, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    out = torch.zeros(b, sq, nh, hd)
    for q0 in range(0, sq, TC_TILE):
        rows = torch.arange(q0, min(q0 + TC_TILE, sq))
        pos = rows + q_offset
        kv_lo, kv_hi = 0, skv
        if causal:
            kv_hi = min(kv_hi, int(pos[-1]) + 1)
        if window is not None:
            kv_lo = max(0, int(pos[0]) - window + 1)
        m = torch.full((b, nh, len(rows)), -torch.inf)
        l = torch.zeros(b, nh, len(rows))
        o = torch.zeros(b, nh, len(rows), hd)
        for k0 in range(kv_lo // TC_TILE * TC_TILE, kv_hi, TC_TILE):
            cols = torch.arange(k0, min(k0 + TC_TILE, skv))
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kf[:, cols])
            s = s / np.sqrt(hd)
            if logit_softcap is not None:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            mask = cols[None, :] < skv
            if causal:
                mask = mask & (pos[:, None] >= cols[None, :])
            if window is not None:
                mask = mask & (pos[:, None] - cols[None, :] < window)
            s = torch.where(mask, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
            corr = torch.exp(m - m_use)
            p = torch.exp(s - m_use[..., None])
            l = l * corr + p.sum(dim=-1)
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float()
            o = o * corr[..., None]
            for term in (hi, lo)[:p_terms]:
                o = o + torch.einsum("bhqk,bkhd->bhqd", term, vf[:, cols])
            m = m_new
        res = torch.where(l[..., None] > 0, o / l[..., None].clamp_min(
            torch.finfo(torch.float32).tiny), 0.0)
        out[:, rows] = res.permute(0, 2, 1, 3)
    return out.to(torch.bfloat16)


def _row_errors(got, want):
    """``ops.row_errors`` against a JAX or numpy ``want``."""
    return ops.row_errors(got, torch.tensor(np.asarray(want, np.float32)))


def test_row_errors_are_relative_per_row_and_hold_blind_rows_to_zero():
    want = torch.zeros(1, 3, 1, 4)
    want[0, 0, 0] = torch.tensor([3.0, 0.0, 4.0, 0.0])    # norm 5
    want[0, 1, 0] = torch.tensor([0.0, 1.0, 0.0, 0.0])
    got = want.clone()
    got[0, 0, 0, 1] = 0.5
    torch.testing.assert_close(ops.row_errors(got, want),
                               torch.tensor([[[0.1], [0.0], [0.0]]]))
    got[0, 2, 0, 3] = 1e-30    # row 2 sees no key: any nonzero value fails
    assert float(ops.row_errors(got, want)[0, 2, 0]) == float("inf")
    assert float(ops.row_errors(got, want).max()) > ops.TC_ROW_RTOL


# (batch, sq, skv, heads, kv_heads, head_dim, causal, window, softcap,
# q_offset): every head size, several tiles, windows and softcaps,
# q_offset, ragged lengths, rows that see no key.
TC_CASES = [
    (2, 256, 256, 4, 2, 64, True, 100, 50.0, 0),
    (1, 130, 300, 4, 2, 128, True, 64, 30.0, 170),
    (1, 200, 200, 2, 1, 256, True, None, 50.0, 0),
    (1, 100, 100, 4, 2, 32, False, None, None, 0),
    (1, 8, 16, 2, 1, 32, True, 6, None, 16),
    (1, 7, 300, 4, 2, 256, True, 64, 50.0, 293),
]


@pytest.mark.parametrize("b,sq,skv,nh,nkv,hd,causal,win,cap,q_off", TC_CASES)
def test_tc_emulation_error_leaves_the_bf16_gate_three_times_its_size(
        b, sq, skv, nh, nkv, hd, causal, win, cap, q_off):
    arrays = _inputs(b, sq, skv, nh, nkv, hd, seed=4)
    q, k, v = _torch(arrays, "bfloat16")
    kw = dict(causal=causal, window=win, logit_softcap=cap, q_offset=q_off)
    got = _tc_emulation(q, k, v, **kw)
    # the JAX oracle in float32 on the same bf16-rounded inputs
    want = j_ref.attention_ref(
        *[jnp.asarray(t.float().numpy()) for t in (q, k, v)], **kw)
    err = float(_row_errors(got, want).max())
    print(f"tc emulation {(b, sq, skv, nh, nkv, hd)}: largest row error "
          f"{err:.3e}")
    assert 0 < err <= ops.TC_ROW_RTOL / 3


def test_tc_emulation_second_bf16_term_of_p_removes_its_rounding():
    # Why the kernel carries P as two bf16 terms: with one, rounding P
    # adds an error of the order of the bf16 output's own rounding and
    # eats into the gate's room; with two, P . V is the output rounding's.
    worst = {1: 0.0, 2: 0.0, "out": 0.0}
    for b, sq, skv, nh, nkv, hd, causal, win, cap, q_off in TC_CASES:
        q, k, v = _torch(_inputs(b, sq, skv, nh, nkv, hd, seed=4),
                         "bfloat16")
        kw = dict(causal=causal, window=win, logit_softcap=cap,
                  q_offset=q_off)
        want = np.asarray(j_ref.attention_ref(
            *[jnp.asarray(t.float().numpy()) for t in (q, k, v)], **kw))
        rounded = torch.tensor(want).to(torch.bfloat16)
        worst["out"] = max(worst["out"],
                           float(_row_errors(rounded, want).max()))
        for terms in (1, 2):
            got = _tc_emulation(q, k, v, p_terms=terms, **kw)
            worst[terms] = max(worst[terms],
                               float(_row_errors(got, want).max()))
    print(f"largest row error: one term {worst[1]:.3e}, two terms "
          f"{worst[2]:.3e}, output rounding alone {worst['out']:.3e}")
    assert worst[2] < worst[1]
    assert worst[2] <= 1.05 * worst["out"]


def test_tc_emulation_gate_sees_a_dropped_kv_tile():
    # The gate is not so loose that a kernel skipping a kv tile passes.
    arrays = _inputs(1, 128, 128, 2, 1, 64, seed=5)
    q, k, v = _torch(arrays, "bfloat16")
    want = j_ref.attention_ref(
        *[jnp.asarray(t.float().numpy()) for t in (q, k, v)], causal=False)
    k_cut = k[:, :TC_TILE]
    got = _tc_emulation(q, k_cut, v[:, :TC_TILE], causal=False)
    assert float(_row_errors(got, want).max()) > 10 * ops.TC_ROW_RTOL
