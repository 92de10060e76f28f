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

On the card, both dtypes run tensor-core kernels whose rounding points
differ from the plain version's.  ``_tc_emulation`` (bfloat16) and
``_f32_emulation`` (float32: operands as two scaled float16 terms) below
repeat them in float32 on the CPU; the tests of the first size the
per-row gate that chip_smoke.py and tests/test_torch_kernels_cuda.py
hold the bfloat16 kernel to, those of the second show the float32
kernel's arithmetic inside a third of float32's 2e-5 gate.
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
    for name in list(ops.LAUNCHES):
        monkeypatch.setitem(ops.LAUNCHES, name, 0)
    for dtype in ("float32", "bfloat16"):
        calls.clear()
        q, k, v = _torch(_inputs(1, 64, 64, 4, 2, 32), dtype)
        out = ops.flash_attention(q, k, v, window=16, logit_softcap=30.0)
        assert calls == [dict(causal=True, window=16, logit_softcap=30.0,
                              q_offset=0)]
        assert set(ops.LAUNCHES.values()) == {0}
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


# -- the float32 kernel's arithmetic, emulated ------------------------------

# float32's gate on the card (chip_smoke.py, tests/test_torch_kernels_cuda.py)
# is allclose(atol=2e-5, rtol=2e-5) against the plain version, as in
# tests/test_kernels.py.  The emulation's largest error must be at most a
# third of it.
F32_TOL = 2e-5
P_SHIFT = 14
LOG2E = np.float32(1.4426950408889634)


def _gate_ratio(got, want):
    """Largest |got - want| / (atol + rtol |want|) at F32_TOL: allclose
    passes at most 1."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float((np.abs(got - want)
                  / (F32_TOL + F32_TOL * np.abs(want))).max())


def _split_terms(x, rows, terms):
    """(hi, lo, e) of x (b, s, h, hd) in (b, h, s, hd) layout, as floats:
    ``"f16"`` the kernel's split pass (``ref.split_f32_ref``); ``"bf16"``
    two unscaled bf16 terms; ``"bf16_one"`` bf16(x) alone."""
    if terms == "f16":
        hi, lo, e = ref.split_f32_ref(x, rows)
        return hi.float(), lo.float(), e
    xt = x.permute(0, 2, 1, 3)
    hi = xt.to(torch.bfloat16).float()
    lo = (xt - hi).to(torch.bfloat16).float()
    if terms == "bf16_one":
        lo = torch.zeros_like(lo)
    b, s, h, _ = x.shape
    return hi, lo, torch.zeros(b, h, -(-s // rows), dtype=torch.int32)


def _f32_emulation(q, k, v, *, causal=True, window=None, logit_softcap=None,
                   q_offset=0, qk_terms="f16", vp_terms="f16"):
    """The float32 kernel's arithmetic in float32 on the CPU: the split
    pass's tiles (``ops.CPU_F32_TILES``) and terms, S as
    Qhi Khi + Qhi Klo + Qlo Khi times scale 2^(e_q + e_k), softcap with
    tanh, scores in log2 units, online softmax with exp2, P times
    2^(14 + e_v - e_run) as two f16 terms, O += Phi Vhi + Phi Vlo + Plo Vhi
    rescaled when e_run grows, the two warpgroups' alternate kv tiles
    merged at the end.  ``qk_terms`` and ``vp_terms`` ("f16", "bf16",
    "bf16_one") put other terms in place of q and k, and of v and P."""
    b, sq, nh, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    bq, bk = ops.CPU_F32_TILES[hd]
    qh, ql, eq = _split_terms(q, bq, qk_terms)
    kh, kl, ek = (t.repeat_interleave(group, dim=1)
                  for t in _split_terms(k, bk, qk_terms))
    vh, vl, ev = (t.repeat_interleave(group, dim=1)
                  for t in _split_terms(v, bk, vp_terms))
    scale = np.float32(1 / np.sqrt(hd))
    out = torch.zeros(b, nh, sq, hd)
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, min(q0 + bq, sq))
        pos = rows + q_offset
        kv_lo, kv_hi = 0, skv
        if causal:
            kv_hi = min(kv_hi, int(pos[-1]) + 1)
        if window is not None:
            kv_lo = max(0, int(pos[0]) - window + 1)
        n = len(rows)
        wgs = [dict(m=torch.full((b, nh, n), -torch.inf),
                    l=torch.zeros(b, nh, n), o=torch.zeros(b, nh, n, hd),
                    e=torch.full((b, nh), -1000, dtype=torch.int32))
               for _ in range(2)]
        e_q = eq[:, :, q0 // bq]
        for it, k0 in enumerate(range(kv_lo // bk * bk, kv_hi, bk)):
            st = wgs[it % 2]
            cols = torch.arange(k0, min(k0 + bk, skv))
            t = k0 // bk

            def mm(x, y):
                return torch.einsum("bhqd,bhkd->bhqk", x[:, :, rows],
                                    y[:, :, cols])
            s = mm(qh, kh) + mm(qh, kl) + mm(ql, kh)
            mul = (scale * torch.exp2((e_q + ek[:, :, t]).double()).float()
                   )[..., None, None]
            if logit_softcap is not None:
                y = (torch.tanh(s * (mul * np.float32(1 / logit_softcap)))
                     * np.float32(logit_softcap * LOG2E))
            else:
                y = s * (mul * LOG2E)
            mask = cols[None, :] < skv
            if causal:
                mask = mask & (pos[:, None] >= cols[None, :])
            if window is not None:
                mask = mask & (pos[:, None] - cols[None, :] < window)
            y = torch.where(mask, y, -torch.inf)
            m_new = torch.maximum(st["m"], y.amax(dim=-1))
            m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
            corr = torch.exp2(st["m"] - m_use)
            p = torch.exp2(y - m_use[..., None])
            st["l"] = st["l"] * corr + p.sum(dim=-1)
            e_t = ev[:, :, t]
            e_new = torch.maximum(st["e"], e_t)
            corr = corr * torch.exp2((st["e"] - e_new).float())[..., None]
            p = p * torch.exp2((P_SHIFT + e_t - e_new).float())[..., None,
                                                                 None]
            if vp_terms == "f16":
                p_hi = p.to(torch.float16).float()
                p_lo = (p - p_hi).to(torch.float16).float()
            else:
                p_hi = p.to(torch.bfloat16).float()
                p_lo = (p - p_hi).to(torch.bfloat16).float()

            def pv(x, y):
                return torch.einsum("bhqk,bhkd->bhqd", x, y[:, :, cols])
            st["o"] = (st["o"] * corr[..., None] + pv(p_hi, vh)
                       + pv(p_hi, vl) + pv(p_lo, vh))
            st["m"], st["e"] = m_new, e_new
        m = torch.maximum(wgs[0]["m"], wgs[1]["m"])
        m_use = torch.where(m == -torch.inf, 0.0, m)
        e_m = torch.maximum(wgs[0]["e"], wgs[1]["e"])
        c = [torch.exp2(st["m"] - m_use) for st in wgs]
        l = wgs[0]["l"] * c[0] + wgs[1]["l"] * c[1]
        inv = torch.where(
            l > 0, torch.ldexp(1 / l.clamp_min(1e-30),
                               (e_m - P_SHIFT)[..., None].float()), 0.0)
        o = sum(st["o"] * (ci * torch.exp2((st["e"] - e_m).float())[..., None]
                           * inv)[..., None] for st, ci in zip(wgs, c))
        out[:, :, rows] = o
    return out.permute(0, 2, 1, 3)


def _f32_case(b, sq, skv, nh, nkv, hd, causal, win, cap, q_off, seed=6):
    q, k, v = _torch(_inputs(b, sq, skv, nh, nkv, hd, seed=seed), "float32")
    kw = dict(causal=causal, window=win, logit_softcap=cap, q_offset=q_off)
    want = j_ref.attention_ref(*_jax([q.numpy(), k.numpy(), v.numpy()],
                                     "float32"), **kw)
    return q, k, v, kw, np.asarray(want)


# TC_CASES, and gemma2-2b's head size, softcap and a window at a length
# the CPU runs in seconds
F32_CASES = TC_CASES + [(1, 640, 640, 2, 1, 256, True, 512, 50.0, 0)]


@pytest.mark.parametrize("b,sq,skv,nh,nkv,hd,causal,win,cap,q_off",
                         F32_CASES)
def test_f32_emulation_error_leaves_the_f32_gate_three_times_its_size(
        b, sq, skv, nh, nkv, hd, causal, win, cap, q_off):
    q, k, v, kw, want = _f32_case(b, sq, skv, nh, nkv, hd, causal, win, cap,
                                  q_off)
    ratio = _gate_ratio(_f32_emulation(q, k, v, **kw), want)
    print(f"f32 emulation {(b, sq, skv, nh, nkv, hd)}: largest error "
          f"{ratio:.3f} of the 2e-5 gate")
    assert 0 < ratio <= 1 / 3


@pytest.mark.parametrize("case", [F32_CASES[0], F32_CASES[-1]],
                         ids=["hd64", "hd256"])
def test_f32_emulation_one_bf16_term_of_q_and_k_fails_the_gate(case):
    # Why q and k are split at all: as bf16(x) alone (v and P as the
    # kernel carries them) the scores keep 8 bits, far outside the gate.
    q, k, v, kw, want = _f32_case(*case)
    assert _gate_ratio(_f32_emulation(q, k, v, qk_terms="bf16_one", **kw),
                       want) > 1


def test_f32_emulation_two_bf16_terms_leave_less_than_three_times_the_gate():
    # Why the terms are scaled float16 and not bfloat16: two bf16 terms
    # of q, k, v and P carry 16 bits, and at gemma2-2b's head size their
    # error comes within less than 3x of the gate; two f16 terms, 22 bits.
    worst = {"bf16": 0.0, "f16": 0.0}
    for case in (F32_CASES[2], F32_CASES[-1]):
        q, k, v, kw, want = _f32_case(*case)
        for terms in worst:
            got = _f32_emulation(q, k, v, qk_terms=terms, vp_terms=terms,
                                 **kw)
            worst[terms] = max(worst[terms], _gate_ratio(got, want))
    print(f"largest error over the gate: two bf16 terms {worst['bf16']:.3f}"
          f", two scaled f16 terms {worst['f16']:.3f}")
    assert worst["bf16"] > 1 / 3 >= worst["f16"]


def test_f32_emulation_is_exact_under_powers_of_two():
    # The per-tile scales take out any power of two: q 2^-60, k 2^60 and
    # v 2^100 (far outside float16's range) give the same output times
    # 2^100, bit for bit.
    q, k, v, kw, _ = _f32_case(1, 130, 130, 4, 2, 64, True, 100, 30.0, 0)
    base = _f32_emulation(q, k, v, **kw)
    scaled = _f32_emulation(q * 2.0 ** -60, k * 2.0 ** 60, v * 2.0 ** 100,
                            **kw)
    assert torch.isfinite(scaled).all()
    assert torch.equal(scaled, base * 2.0 ** 100)


def test_split_f32_ref_scales_each_tile_into_f16_range():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 100, 3, 32)).astype(np.float32)
    # tiles of 32 rows, each of its own magnitude, one all zero
    mags = np.array([1e-30, 3.0, 1e30, 0.0])[:, None, None]
    x = torch.tensor(x * np.repeat(mags, 32, axis=0)[:100][None])
    hi, lo, e = ref.split_f32_ref(x, 32)
    assert hi.dtype == lo.dtype == torch.float16
    assert tuple(hi.shape) == (2, 3, 100, 32) and tuple(e.shape) == (2, 3, 4)
    assert e.dtype == torch.int32 and (e[..., 3] == 0).all()
    scaled = x.permute(0, 2, 1, 3).double() * torch.exp2(
        -e.double()).repeat_interleave(32, dim=2)[:, :, :100, None]
    for t in range(3):
        tile = scaled[:, :, 32 * t:32 * t + 32]
        peak = tile.abs().amax(dim=(2, 3))
        assert ((peak >= 2.0 ** 14) & (peak < 2.0 ** 15)).all()
        err = (hi[:, :, 32 * t:32 * t + 32].double()
               + lo[:, :, 32 * t:32 * t + 32].double() - tile).abs()
        assert (err.amax(dim=(2, 3)) <= 2.0 ** -22 * peak).all()
    assert (hi[:, :, 96:] == 0).all() and (lo[:, :, 96:] == 0).all()


def test_f32_kv_tile_matches_the_kernel_layout():
    # 64-key tiles, except at hd = 256, where two f16 terms of q (64 KB)
    # and two warpgroups' k and v buffers of 32 keys (128 KB) fill the
    # 227 KB a block may have.
    assert set(ops.CPU_F32_TILES) == set(ops.HEAD_DIMS)
    assert {hd: kv for hd, (_, kv) in ops.CPU_F32_TILES.items()} == {
        32: 64, 64: 64, 128: 64, 256: 32}
    for hd, (bq, bk) in ops.CPU_F32_TILES.items():
        assert bq == 64
        tile = bq * hd * 2
        kv = bk * hd * 2
        assert 2 * tile + 2 * 4 * kv + 1024 <= 232448
