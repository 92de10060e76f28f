"""The port's consensus, flash attention and WKV6 kernels against their
plain versions, and its captured solver steps against its eager ones,
on the card.

Every test here needs an NVIDIA Hopper card and skips elsewhere.  The
file imports neither JAX nor the JAX package, so it runs on a machine
with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py imports JAX).  The cases are the JAX
package's kernel test cases (tests/test_kernels.py) and the port's own
edge cases.  Flash attention: float32 goes to the split pass and the
split-operand tensor-core kernel, held to the plain version at 2e-5 as
in tests/test_kernels.py (tests/test_torch_flash_attention.py emulates
its arithmetic at under a third of that), on strided and misaligned
views too, with the split pass bit-equal to its plain version; each of
FLASH_SHAPES runs in bfloat16 too, which goes to the bf16 tensor-core
kernel and is held row by row to the wrapper module's gate,
``ops.row_errors`` at most ``ops.TC_ROW_RTOL`` (||got - want||_2 <= 1e-2
||want||_2) against the plain version in float32 on the same bf16
inputs, with rows that see no key exactly 0
(tests/test_torch_flash_attention.py sizes that gate).
WKV6: float32 2e-3, bfloat16 5e-2, as in tests/test_kernels.py, on
every head size, lengths that are not a multiple of the kernel's
16-token chunk, and a strong-decay draw (w exactly 0, below 1e-4 and
above 0.999).  consensus_mix and consensus_step: float32 1e-5,
bfloat16 3e-2, as in tests/test_torch_consensus_step.py, over the
16-byte and the element path (a row that is not a multiple of 16 bytes,
or streams whose storage offset misaligns them), one and two passes of
16 rows of the mix and each of the step's three stagings (1-8, 9-16 and
more agents), and a symmetric and a non-symmetric mixing matrix; the
step's two paths give the same bits in its square, row-block and
batched forms.  The row-block forms of both consensus kernels (one
process's rows of the allgather backend) at the same tolerances, blocks
at the start, middle and end of M, both kernels down the path each case
names, in both dtypes; a block of all m rows is the square launch bit
for bit.
chip_smoke.py runs these and the serving shapes.

Captured stepping: each algorithm's steps replayed from CUDA graphs
(``run_recorded(scan=True)``, ``run_traced``) against the eager loop from
the same seed, on the Section-6 instance at full width (m = 5, n = 100,
q = 3 so that SVR-INTERACT refreshes twice in 6 steps), with each
hypergradient backend: ``cg``, truncated and stochastic-k ``neumann``,
and ``cholesky`` from the closed-form H_yy and from HVPs on the identity
basis.  The graphs hold
the eager step's kernels in its order, so the states must agree to
``CAPTURE_RTOL`` = 1e-6 of each field's scale (expected: bit for bit).
A capture that cannot happen (a host read in the step or the metric)
raises; nothing runs eagerly in its place.

The wire and time-varying topologies, captured against eager at the
same ``CAPTURE_RTOL``: a link-failure stream whose matrix changes every
step (period 3: a graph that baked one slice of it in would replay that
matrix), compression with a warm-up and a communication interval both
active (three graphs: warm-up, silent and compressed rounds; a graph key
without the schedule would replay the first), and the other rows of
chip_smoke.py's ``wire`` phase.  Both consensus kernels take a per-call
matrix whose contents change between replays of one graph.

Batched consensus kernels (the sweeps' form): B experiments' (B, m, D)
streams in one launch, one matrix shared by the batch or one each, a
distinct alpha per experiment, both dtypes, the 16-byte and the element
path, one and two passes of 16 rows, against the batched plain versions
at the consensus_mix tolerances, both kernels down the path each case
names; every call adds one launch to its wrapper's count.  A sweep group (``repro_torch.solvers.sweep``) replays
its captured batched step bit-equal to the same group stepped eagerly:
each algorithm on ``cuda`` (one consensus kernel launch a step for the
whole group), an adaptive topology (a matrix per experiment), a padded
``dense`` group with and without an attack, and a group of link-failure
streams.

The Byzantine layer, captured against eager bit for bit (guard counters
included) on each row of chip_smoke.py's ``byzantine`` phase: attacks
before a weighted or a robust combine, gaussian noise refilled before
each replay, and the guard.  A guarded run that never trips must end
with ``last_good`` at its last step, and one that trips must count the
trips and keep the last good step as eager does: a graph that baked the
host's t in would hold the capture's step.

Resilience: a captured checkpointed run (a snapshot every 3 of 9 steps)
killed at 4 (the boundary at 6 lost) and resumed in a fresh solver from
t = 3, captured or eagerly (``repro_torch.resilience.resume_run``), gives
the uninterrupted captured ``run_traced`` trace and state bit for bit:
each algorithm (the resumed SVR-INTERACT graphs start mid q-period), the
compressed wire with a warm-up and an interval (t = 3 is a silent round)
and the guarded sign-flip row.

The linearize-once backends: ``cg-linearized`` and ``neumann-linearized``
join the captured-against-eager cases above (under the solvers' ``vmap``
over agents their tangent map is a fresh jvp each application), and one
solve of each outside ``vmap`` (``torch.func.linearize`` traced once) is
captured and replayed against the eager solve at ``CAPTURE_RTOL``, its
device counters equal.  LM training: the train step (reduced smollm-360m,
float32, ``remat`` on, one agent) two INTERACT and two SVR-INTERACT
steps on the card against the CPU within ``LM_CARD_CPU_TOL`` = 1e-5 of
each leaf's scale, and the eval step with ``attn_impl="cuda"`` (the
float32 flash kernels, once a layer) against plain attention at
``FLASH_TOL``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.consensus_step import ops as mix_ops  # noqa: E402
from repro_torch.kernels.consensus_step import ref as mix_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.core import convergence_metric_fn  # noqa: E402
from repro_torch.consensus import CompressionConfig  # noqa: E402
from repro_torch.hypergrad import HypergradConfig  # noqa: E402
from repro_torch.resilience import (FaultPlan, SimulatedKill,  # noqa: E402
                                    make_fault, resume_run, run_resumable)
from repro_torch.solvers import (ByzantineConfig,  # noqa: E402
                                 GuardConfig, SolverConfig, default_setup,
                                 make_solver, run_recorded)
from repro_torch.solvers.config import TopologyConfig  # noqa: E402
from repro_torch.solvers.sweep import (_GroupSolver,  # noqa: E402
                                       _padded_parts, _plain_parts)
from repro_torch.topology import TopologyProcessConfig  # noqa: E402

FLASH_TOL = 2e-5             # float32
WKV_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
MIX_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
CAPTURE_RTOL = 1e-6
ALGOS = ("interact", "svr-interact", "gt-dsgd", "d-sgd")
# the hypergradient backends a captured step runs: (config, whether the
# problem keeps its closed-form H_yy; without it cholesky builds H_yy from
# HVPs on the identity basis)
HG_CASES = {
    "cg": (HypergradConfig(), True),
    "neumann": (HypergradConfig(backend="neumann"), True),
    "neumann-stochastic": (HypergradConfig(backend="neumann",
                                           stochastic_k=True), True),
    "cholesky": (HypergradConfig(backend="cholesky"), True),
    "cholesky-hvp-basis": (HypergradConfig(backend="cholesky"), False),
    "cg-linearized": (HypergradConfig(backend="cg-linearized"), True),
    "neumann-linearized": (HypergradConfig(backend="neumann-linearized"),
                           True),
}
# INTERACT takes no draws, so it has no stochastic-k Neumann
CAPTURE_CASES = [(algo, hg) for algo in ALGOS for hg in HG_CASES
                 if not (algo == "interact" and hg == "neumann-stochastic")]

# consensus_mix: agents (17 takes two passes of 16 rows) and row lengths
# (760 and 4096 take the 16-byte path in both dtypes, 1, 3, 123 and 761
# in neither)
MIX_M = (1, 3, 5, 16, 17)
MIX_D = (1, 3, 123, 760, 761, 4096)

# (batch, sq, skv, heads, kv_heads, head_dim, causal, window, softcap,
# q_offset): the first seven are tests/test_kernels.py's float32 cases.
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, True, None, None, 0),
    (1, 256, 256, 8, 1, 128, True, None, None, 0),     # MQA
    (1, 256, 256, 4, 4, 64, True, 128, None, 0),       # SWA
    (1, 192, 192, 4, 2, 64, True, None, 50.0, 0),      # softcap
    (1, 256, 256, 4, 2, 64, True, 64, 30.0, 0),        # SWA+softcap
    (2, 128, 128, 4, 2, 64, False, None, None, 0),     # bidirectional
    (1, 200, 200, 4, 2, 64, True, None, None, 0),      # ragged
    (1, 1, 256, 4, 2, 64, True, None, None, 255),      # decode
    (2, 7, 300, 8, 4, 256, True, 64, 50.0, 293),       # suffix, SWA
    (1, 100, 100, 4, 2, 64, False, None, None, 0),     # non-causal ragged
    (1, 100, 100, 4, 2, 64, True, None, None, 110),    # offset past keys
    (1, 8, 16, 2, 1, 32, True, 6, None, 16),           # rows that see no key
]
FLASH_CASES = (
    [c + (torch.float32,) for c in FLASH_SHAPES]
    + [c + (torch.bfloat16,) for c in FLASH_SHAPES]
    + [(1, 256, 256, 2, 2, 256, True, None, None, 0, torch.bfloat16),
       (1, 128, 128, 4, 2, 32, True, None, None, 0, torch.bfloat16),
       # smollm-360m's eval step: 15 q and 5 kv heads of 64
       (4, 256, 256, 15, 5, 64, True, None, None, 0, torch.bfloat16),
       (4, 256, 256, 15, 5, 64, True, None, None, 0, torch.float32),
       # gemma2-2b's heads, softcap and local window over several hundred
       # tokens (32-key tiles), and a window that binds
       (1, 600, 600, 8, 4, 256, True, 4096, 50.0, 0, torch.float32),
       (2, 520, 520, 8, 4, 256, True, 200, 50.0, 0, torch.float32)])


# (batch, seq, heads, N, with_state, dtype)
WKV_CASES = [
    (2, 128, 2, 16, False, torch.float32),
    (1, 96, 4, 32, False, torch.float32),
    (2, 64, 2, 16, True, torch.float32),
    (1, 100, 2, 16, False, torch.float32),
    (1, 1, 2, 16, True, torch.float32),
    (1, 128, 2, 64, False, torch.float32),
    (1, 64, 2, 16, False, torch.bfloat16),
]
# every head size, lengths that are not a multiple of the 16-token chunk
WKV_EDGE_CASES = [
    (2, 37, 3, n, with_state, dtype)
    for n in (8, 16, 32, 64) for with_state in (False, True)
    for dtype in (torch.float32, torch.bfloat16)]


def wkv_inputs(b, s, h, n, with_state, dtype, device, strong=False,
               seed=0):
    """r, k, v, w, u, state as tests/test_kernels.py draws them; with
    ``strong``, a quarter of w each exactly 0, in (0, 1e-4) and in
    (0.999, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    rand = lambda *shape: torch.rand(*shape, generator=gen, device=device)
    r, k, v = (randn(b, s, h, n).to(dtype) for _ in range(3))
    w = torch.sigmoid(randn(b, s, h, n) * 2.0 - 1.0) * 0.6 + 0.35
    if strong:
        pick = torch.randint(0, 4, w.shape, generator=gen, device=device)
        w = torch.where(pick == 0, 0.0, w)
        w = torch.where(pick == 1, 1e-4 * rand(*w.shape), w)
        w = torch.where(pick == 2, 0.999 + 1e-3 * rand(*w.shape), w)
    u = (0.3 * randn(h, n)).to(dtype)
    state = 0.5 * randn(b, h, n, n) if with_state else None
    return r, k, v, w.to(dtype), u, state


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels only run on the "
                    "card (chip_smoke.py runs these cases there)")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,nh,nkv,hd,causal,win,cap,q_off,dtype",
                         FLASH_CASES)
def test_flash_kernel_matches_plain_version(hopper, b, sq, skv, nh, nkv, hd,
                                            causal, win, cap, q_off, dtype):
    gen = torch.Generator(device=hopper).manual_seed(0)
    q = torch.randn(b, sq, nh, hd, generator=gen, device=hopper).to(dtype)
    k = torch.randn(b, skv, nkv, hd, generator=gen, device=hopper).to(dtype)
    v = torch.randn(b, skv, nkv, hd, generator=gen, device=hopper).to(dtype)
    kw = dict(causal=causal, window=win, logit_softcap=cap, q_offset=q_off)
    before = dict(fa_ops.LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, **kw)
    tc = dtype == torch.bfloat16
    assert fa_ops.LAUNCHES == {
        "flash_attention": before["flash_attention"] + 1,
        "flash_attention_tc": before["flash_attention_tc"] + int(tc),
        "flash_attention_f32_split":
            before["flash_attention_f32_split"] + int(not tc),
        "flash_attention_f32": before["flash_attention_f32"] + int(not tc)}
    assert got.dtype == dtype
    want = fa_ref.attention_ref(q.float(), k.float(), v.float(), **kw)
    if tc:
        assert float(fa_ops.row_errors(got, want).max()) <= fa_ops.TC_ROW_RTOL
    else:
        torch.testing.assert_close(got, want, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(hopper, dtype):
    # every other query head; keys and values cut from wider rows
    gen = torch.Generator(device=hopper).manual_seed(1)
    q = torch.randn(2, 130, 8, 64, generator=gen, device=hopper)[:, :, ::2]
    k, v = (torch.randn(2, 130, 2, 128, generator=gen,
                        device=hopper)[..., :64] for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    kw = dict(causal=True, window=50, logit_softcap=30.0)
    got = fa_ops.flash_attention(q, k, v, **kw)
    want = fa_ref.attention_ref(q.float(), k.float(), v.float(), **kw)
    if dtype == torch.bfloat16:
        assert float(fa_ops.row_errors(got, want).max()) <= fa_ops.TC_ROW_RTOL
    else:
        torch.testing.assert_close(got, want, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.cuda
def test_flash_f32_kernel_takes_misaligned_views(hopper):
    # float32 views whose pointers and strides are not multiples of 16
    # bytes: the split pass reads them as they are
    gen = torch.Generator(device=hopper).manual_seed(2)
    q = torch.randn(1, 130, 4, 64, generator=gen, device=hopper)
    k = torch.randn(1, 130, 2, 69, generator=gen, device=hopper)[..., 1:65]
    flat = torch.randn(130 * 2 * 64 + 1, generator=gen, device=hopper)
    v = flat[1:].view(1, 130, 2, 64)
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    assert (k.stride(2) * 4) % 16
    kw = dict(causal=True, window=50, logit_softcap=30.0)
    got = fa_ops.flash_attention(q, k, v, **kw)
    want = fa_ref.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_f32_split_pass_matches_plain_version_bitwise(hopper, hd):
    gen = torch.Generator(device=hopper).manual_seed(hd)
    # a strided q, and tiles of very different magnitudes, one all zero
    q = torch.randn(2, 70, 6, hd, generator=gen, device=hopper)[:, :, ::2]
    k = torch.randn(2, 100, 1, hd, generator=gen, device=hopper)
    k = k * torch.logspace(-30, 30, 100, device=hopper)[None, :, None, None]
    v = torch.randn(2, 100, 1, hd, generator=gen, device=hopper)
    v[:, :32] = 0.0
    lib = fa_ops.load()
    scratch = fa_ops.f32_scratch(lib, q, k)
    fa_ops.launch_split_f32(lib, q, k, v, scratch)
    torch.cuda.synchronize()
    halves, exps = scratch
    q_rows, kv_rows = fa_ops.f32_tiles(lib, hd)
    assert (q_rows, kv_rows) == fa_ops.CPU_F32_TILES[hd]
    for x, rows in ((q, q_rows), (k, kv_rows), (v, kv_rows)):
        hi, lo, e = fa_ref.split_f32_ref(x, rows)
        n = hi.numel()
        assert torch.equal(halves[:n].view(hi.shape), hi)
        assert torch.equal(halves[n:2 * n].view(hi.shape), lo)
        assert torch.equal(exps[:e.numel()].view(e.shape), e)
        halves, exps = halves[2 * n:], exps[e.numel():]
    assert halves.numel() == 0 and exps.numel() == 0


@pytest.mark.cuda
def test_flash_f32_kernel_is_exact_under_powers_of_two(hopper):
    # q 2^-60, k 2^60 and v 2^100, far outside float16's range: the
    # split pass's per-tile scales take the powers of two out exactly
    gen = torch.Generator(device=hopper).manual_seed(3)
    q = torch.randn(1, 300, 4, 128, generator=gen, device=hopper)
    k = torch.randn(1, 300, 2, 128, generator=gen, device=hopper)
    v = torch.randn(1, 300, 2, 128, generator=gen, device=hopper)
    kw = dict(causal=True, logit_softcap=30.0)
    base = fa_ops.flash_attention(q, k, v, **kw)
    scaled = fa_ops.flash_attention(q * 2.0 ** -60, k * 2.0 ** 60,
                                    v * 2.0 ** 100, **kw)
    assert torch.isfinite(scaled).all()
    assert torch.equal(scaled, base * 2.0 ** 100)


@pytest.mark.cuda
def test_flash_tc_kernel_rejects_misaligned_views(hopper):
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=hopper)
    wide = torch.zeros(1, 8, 2, 80, dtype=torch.bfloat16, device=hopper)
    odd = torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16, device=hopper)
    before = dict(fa_ops.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):    # pointer + 8 bytes
        fa_ops.flash_attention(q, wide[..., 4:68], wide[..., :64])
    with pytest.raises(ValueError, match="16 bytes"):   # head stride 136 B
        fa_ops.flash_attention(q, odd[..., :64], odd[..., :64])
    assert fa_ops.LAUNCHES == before


def _check_wkv6(r, k, v, w, u, state, dtype):
    before = wkv_ops.LAUNCHES["wkv6"]
    out, final = wkv_ops.wkv6(r, k, v, w, u, state)
    assert wkv_ops.LAUNCHES["wkv6"] == before + 1
    assert out.dtype == dtype and final.dtype == torch.float32
    want, want_final = wkv_ref.wkv6_ref(r, k, v, w, u, state)
    tol = WKV_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(final, want_final, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,n,with_state,dtype", WKV_CASES)
def test_wkv6_kernel_matches_plain_version(hopper, b, s, h, n, with_state,
                                           dtype):
    _check_wkv6(*wkv_inputs(b, s, h, n, with_state, dtype, hopper), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("b,s,h,n,with_state,dtype", WKV_EDGE_CASES)
def test_wkv6_kernel_edges(hopper, b, s, h, n, with_state, dtype, strong):
    _check_wkv6(*wkv_inputs(b, s, h, n, with_state, dtype, hopper,
                            strong=strong, seed=1), dtype)


@pytest.mark.cuda
def test_wkv6_kernel_takes_misaligned_views(hopper):
    # contiguous views one element into their storage: the wrapper hands
    # the kernel 16-byte aligned copies
    r, k, v, w, u, state = wkv_inputs(1, 20, 2, 64, True, torch.bfloat16,
                                      hopper)
    views = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
             for t in (r, k, v, w)]
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in views)
    _check_wkv6(*views, u, state, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", ["symmetric", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", MIX_D)
@pytest.mark.parametrize("m", MIX_M)
def test_consensus_mix_kernel_matches_plain_version(hopper, m, d, dtype,
                                                    matrix):
    gen = torch.Generator(device=hopper).manual_seed(m * 10007 + d)
    if matrix == "symmetric":
        M = torch.full((m, m), 1.0 / m, device=hopper)
    else:
        M = torch.rand(m, m, generator=gen, device=hopper) + 0.05
        M = (M / M.sum(dim=1, keepdim=True)).contiguous()
    # aligned, and one element into its storage (a misaligned base)
    for offset in (0, 1):
        buf = torch.randn(m * d + offset, generator=gen, device=hopper)
        x = buf.to(dtype)[offset:].view(m, d)
        assert x.is_contiguous()
        before = mix_ops.LAUNCHES["consensus_mix"]
        got = mix_ops.consensus_mix_kernel(M, x)
        assert mix_ops.LAUNCHES["consensus_mix"] == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        want = mix_ref.consensus_mix_ref(M, x)
        tol = MIX_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def _step_operands(m, d, dtype, offset, gen, device):
    """x, u, p, p_prev as (m, d) views ``offset`` elements into their
    storage (1: a misaligned base, the element path)."""
    streams = []
    for _ in range(4):
        buf = torch.randn(m * d + offset, generator=gen, device=device)
        streams.append(buf.to(dtype)[offset:].view(m, d))
    return streams


def _offset_copy(t, offset):
    """``t``'s values in a contiguous view ``offset`` elements into a new
    storage."""
    view = t.new_empty(t.numel() + offset)[offset:].view(t.shape)
    return view.copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", ["symmetric", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", MIX_D)
@pytest.mark.parametrize("m", MIX_M)
def test_consensus_step_kernel_matches_plain_version(hopper, m, d, dtype,
                                                     matrix):
    gen = torch.Generator(device=hopper).manual_seed(m * 10007 + d + 1)
    if matrix == "symmetric":
        M = torch.full((m, m), 1.0 / m, device=hopper)
    else:
        M = torch.rand(m, m, generator=gen, device=hopper) + 0.05
        M = (M / M.sum(dim=1, keepdim=True)).contiguous()
    # aligned, and one element into its storage (a misaligned base)
    for offset in (0, 1):
        x, u, p, pp = _step_operands(m, d, dtype, offset, gen, hopper)
        assert mix_ops.takes_16_byte_path(x, u, p, pp) == (
            offset == 0 and d in (760, 4096))
        before = mix_ops.LAUNCHES["consensus_step"]
        got = mix_ops.consensus_step_kernel(M, x, u, p, pp, alpha=0.3)
        assert mix_ops.LAUNCHES["consensus_step"] == before + 1
        want = mix_ref.consensus_step_ref(M, x, u, p, pp, alpha=0.3)
        tol = MIX_TOL[dtype]
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == x.shape
            torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["square", "rows", "batched"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 5, 8, 9, 16, 17])
def test_consensus_step_paths_give_the_same_bits(hopper, m, dtype, form):
    # the same values aligned (the 16-byte path) and one element into their
    # storage (the element path): each staging of the step, each form
    gen = torch.Generator(device=hopper).manual_seed(m * 7 + 1)
    d, b, row0, rows = 760, 3, m // 3, m - m // 3
    M = torch.rand(m, m, generator=gen, device=hopper) + 0.05
    M = (M / M.sum(dim=1, keepdim=True)).contiguous()
    n = b * m if form == "batched" else m
    aligned = _step_operands(n, d, dtype, 0, gen, hopper)
    results = []
    for offset in (0, 1):
        x, u, p, pp = (_offset_copy(t, offset) for t in aligned)
        assert mix_ops.takes_16_byte_path(x, u, p, pp) == (offset == 0)
        if form == "square":
            got = mix_ops.consensus_step_kernel(M, x, u, p, pp, alpha=0.3)
        elif form == "rows":
            got = mix_ops.consensus_step_kernel(
                M, x, u, p[row0:row0 + rows], pp[row0:row0 + rows],
                alpha=0.3, row0=row0)
        else:
            got = mix_ops.consensus_step_batched_kernel(
                M[None], *(t.view(b, m, d) for t in (x, u, p, pp)),
                torch.linspace(0.05, 0.4, b, device=hopper))
        results.append(got)
    assert all(torch.equal(a, c) for a, c in zip(*results))


# row blocks of both consensus kernels (one process of the allgather
# backend): (m, row0, rows) at the start, the middle and the end of M, a
# single row, and 17 agents (two passes of 16 rows)
ROW_CASES = [(5, 0, 1), (5, 2, 2), (5, 4, 1), (8, 0, 4), (8, 2, 4),
             (8, 4, 4), (16, 0, 4), (16, 6, 4), (16, 12, 4), (17, 1, 16),
             (17, 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["16-byte", "element"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,row0,rows", ROW_CASES)
def test_row_block_consensus_kernels_match_plain_versions(hopper, m, row0,
                                                          rows, dtype, path):
    gen = torch.Generator(device=hopper).manual_seed(m * 131 + row0)
    d, offset = 760, (0 if path == "16-byte" else 1)
    M = torch.rand(m, m, generator=gen, device=hopper) + 0.05
    M = (M / M.sum(dim=1, keepdim=True)).contiguous()
    tables, blocks = [], []
    for n, out in ((m, tables), (m, tables), (rows, blocks), (rows, blocks)):
        buf = torch.randn(n * d + offset, generator=gen, device=hopper)
        out.append(buf.to(dtype)[offset:].view(n, d))
    (x, u), (p, pp) = tables, blocks
    assert mix_ops.takes_16_byte_path(x, u, p, pp) == (path == "16-byte")
    before = (dict(mix_ops.LAUNCHES), dict(mix_ops.ROW_LAUNCHES))
    got = mix_ops.consensus_step_kernel(M, x, u, p, pp, alpha=0.3, row0=row0)
    mixed = mix_ops.consensus_mix_kernel(M, x, row0=row0, rows=rows)
    torch.cuda.synchronize()
    for name in ("consensus_step", "consensus_mix"):
        assert mix_ops.LAUNCHES[name] == before[0][name] + 1
        assert mix_ops.ROW_LAUNCHES[name] == before[1][name] + 1
    want = mix_ref.consensus_step_rows_ref(M, x, u, p, pp, row0=row0,
                                           alpha=0.3)
    want += (mix_ref.consensus_mix_rows_ref(M, x, row0=row0, rows=rows),)
    tol = MIX_TOL[dtype]
    for g, w in zip(got + (mixed,), want):
        assert g.dtype == dtype and g.shape == (rows, d)
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 5, 16, 17])
def test_full_row_block_is_the_square_launch_bitwise(hopper, m, dtype):
    gen = torch.Generator(device=hopper).manual_seed(m)
    M = torch.rand(m, m, generator=gen, device=hopper) + 0.05
    M = (M / M.sum(dim=1, keepdim=True)).contiguous()
    x, u, p, pp = (torch.randn(m, 760, generator=gen, device=hopper)
                   .to(dtype) for _ in range(4))
    square = mix_ops.consensus_step_kernel(M, x, u, p, pp, alpha=0.3)
    block = mix_ops.consensus_step_kernel(M, x, u, p, pp, alpha=0.3, row0=0)
    assert all(torch.equal(a, b) for a, b in zip(square, block))
    assert torch.equal(mix_ops.consensus_mix_kernel(M, x),
                       mix_ops.consensus_mix_kernel(M, x, row0=0, rows=m))


@pytest.mark.cuda
def test_row_block_launches_refuse_bad_blocks(hopper):
    M = torch.full((4, 4), 0.25, device=hopper)
    x = torch.zeros(4, 32, device=hopper)
    with pytest.raises(ValueError, match="not inside"):
        mix_ops.consensus_mix_kernel(M, x, row0=3, rows=2)
    with pytest.raises(ValueError, match=r"must be \(3, 32\)"):
        mix_ops.consensus_step_kernel(M, x, x, x[:3], x[:2], alpha=0.1,
                                      row0=1)


# batched consensus kernels: (experiments, agents); 17 takes two passes
BATCH_CASES = [(b, m) for b in (1, 3, 8) for m in (4, 5, 16, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["16-byte", "element"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared-M", "per-experiment-M"])
@pytest.mark.parametrize("b,m", BATCH_CASES)
def test_batched_consensus_kernels_match_plain_versions(hopper, b, m,
                                                        shared, dtype,
                                                        path):
    gen = torch.Generator(device=hopper).manual_seed(b * 101 + m)
    d, offset = 760, (0 if path == "16-byte" else 1)
    M = torch.rand(1 if shared else b, m, m, generator=gen,
                   device=hopper) + 0.05
    M = (M / M.sum(dim=-1, keepdim=True)).contiguous()
    streams = []
    for _ in range(4):
        buf = torch.randn(b * m * d + offset, generator=gen, device=hopper)
        streams.append(buf.to(dtype)[offset:].view(b, m, d))
    x, u, p, pp = streams
    assert mix_ops.mix_takes_16_byte_path(x, torch.empty_like(x)) == (
        path == "16-byte")
    assert mix_ops.takes_16_byte_path(x, u, p, pp) == (path == "16-byte")
    alpha = torch.linspace(0.05, 0.4, b, device=hopper)
    before = dict(mix_ops.LAUNCHES)
    got = mix_ops.consensus_step_batched_kernel(M, x, u, p, pp, alpha)
    mixed = mix_ops.consensus_mix_batched_kernel(M, x)
    assert mix_ops.LAUNCHES["consensus_step"] == before["consensus_step"] + 1
    assert mix_ops.LAUNCHES["consensus_mix"] == before["consensus_mix"] + 1
    tol = MIX_TOL[dtype]
    want = mix_ref.consensus_step_batched_ref(M, x, u, p, pp, alpha)
    for g, w in zip(got + (mixed,),
                    want + (mix_ref.consensus_mix_batched_ref(M, x),)):
        assert g.dtype == dtype and g.shape == (b, m, d)
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


# sweep groups stepped captured and eagerly: (algo, backend, options,
# padded)
GROUP_CASES = {
    "interact": ("interact", "cuda", {}, False),
    "svr-interact": ("svr-interact", "cuda", {}, False),
    "gt-dsgd": ("gt-dsgd", "cuda", {}, False),
    "d-sgd": ("d-sgd", "cuda", {}, False),
    "adaptive": ("interact", "cuda", dict(
        topology_process=TopologyProcessConfig("adaptive")), False),
    "link-failure-streams": ("gt-dsgd", "dense", dict(
        topology_process=TopologyProcessConfig("link-failure", p=0.3,
                                               period=3)), False),
    "padded": ("interact", "dense", {}, True),
    "padded-gaussian": ("gt-dsgd", "dense", dict(
        byzantine=ByzantineConfig("gaussian", num_byzantine=1, scale=2.0)),
        True),
}


def _group_parts(device, algo, backend, opts, padded, steps):
    problem, x0, y0, data = default_setup(0, n_per_agent=100, device=device)
    start = lambda i: (x0, y0)
    if padded:
        datas = {5: data, 3: default_setup(0, num_agents=3, n_per_agent=100,
                                           device=device)[3]}
        configs = [SolverConfig(algo=algo, backend=backend, q=3, seed=s,
                                num_agents=m, topology=TopologyConfig(kind),
                                **opts)
                   for m, kind, s in ((3, "ring", 0), (5, "erdos-renyi", 1))]
        return _padded_parts(configs, [0, 1], [3, 5], 5, problem,
                             lambda m, idx: datas[m], start, None, 3, steps,
                             device)
    configs = [SolverConfig(algo=algo, backend=backend, q=3, seed=s,
                            alpha=a, **opts)
               for s, a in ((0, 0.3), (1, 0.1), (2, 0.2))]
    return _plain_parts(configs, [0, 1, 2], 5, problem,
                        lambda m, idx: data, start, None, 3, steps, device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_captured_group_steps_equal_eager_group_steps(hopper, case):
    algo, backend, opts, padded = GROUP_CASES[case]
    parts, data = _group_parts(hopper, algo, backend, opts, padded, 6)
    captured = _GroupSolver(parts, None, hopper)
    state_c, trace_c = captured.run_traced(captured.initial_state(), data,
                                           6, 3, captured.metric)
    assert captured.stepper.replays == 6
    assert len(captured.stepper.graphs) == (2 if algo == "svr-interact"
                                            else 1)
    eager = _GroupSolver(parts, None, hopper)
    for name in mix_ops.LAUNCHES:
        mix_ops.LAUNCHES[name] = 0
    state_e, trace_e, _ = run_recorded(eager, eager.initial_state(), data,
                                       6, 3, eager.metric, scan=False)
    if backend == "cuda":   # the warm-up step and 6 steps, one launch each
        kernel = "consensus_mix" if algo == "d-sgd" else "consensus_step"
        assert mix_ops.LAUNCHES[kernel] == 7
        assert sum(mix_ops.LAUNCHES.values()) == 7
    assert state_c.t == state_e.t == 6
    assert _bitwise(state_c, state_e)
    assert torch.equal(trace_c, torch.stack(trace_e))


@pytest.mark.cuda
def test_kernels_reject_cpu_and_cuda_mixes(hopper):
    q = torch.zeros(1, 8, 4, 32, device=hopper)
    with pytest.raises(ValueError, match="one device"):
        fa_ops.flash_attention(q, q[:, :, :2].cpu(), q[:, :, :2].cpu())
    r = torch.zeros(1, 8, 2, 16, device=hopper)
    with pytest.raises(ValueError, match="one device"):
        wkv_ops.wkv6(r, r, r, r, torch.zeros(2, 16))


def _section6(device, algo, hg="cg"):
    problem, x0, y0, data = default_setup(0, n_per_agent=100, device=device)
    hg_cfg, closed_form = HG_CASES[hg]
    if not closed_form:
        problem = dataclasses.replace(problem, inner_hess_yy=None)
    config = SolverConfig(algo=algo, backend="cuda", q=3, seed=1,
                          hypergrad=hg_cfg)
    return problem, x0, y0, data, config


def _max_rel_gap(a, b) -> float:
    gap = 0.0
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            gap = max(gap, float((x - y).abs().max() / y.abs().max()))
        else:
            assert x == y
    return gap


@pytest.mark.cuda
@pytest.mark.parametrize("algo,hg", CAPTURE_CASES)
def test_captured_steps_equal_eager_steps(hopper, algo, hg):
    problem, x0, y0, data, config = _section6(hopper, algo, hg)
    # the eq.-11 metric takes no draws: a stochastic-k config is measured
    # with its truncated form
    metric = convergence_metric_fn(
        problem, dataclasses.replace(config.hypergrad, stochastic_k=False),
        data, inner_steps=30)
    runs = {}
    for scan in (False, True):
        solver = make_solver(config)
        state = solver.init(problem, None, x0, y0, data)
        runs[scan] = run_recorded(solver, state, data, 6, 3,
                                  lambda st: float(metric(st)), scan=scan)
        if scan:
            assert solver.stepper.replays == 6
            assert len(solver.stepper.graphs) == (
                2 if algo == "svr-interact" else 1)
    assert runs[True][0].t == runs[False][0].t == 6
    assert _max_rel_gap(runs[True][0], runs[False][0]) <= CAPTURE_RTOL
    traced = make_solver(config)
    state, trace = traced.run_traced(
        traced.init(problem, None, x0, y0, data), data, 6, 3, metric)
    assert trace.device.type == "cuda" and trace.shape == (3,)
    assert _max_rel_gap(state, runs[False][0]) <= CAPTURE_RTOL
    for got, want in zip(trace.tolist(), runs[False][1]):
        assert got == pytest.approx(want, rel=CAPTURE_RTOL)


@pytest.mark.cuda
def test_failed_capture_raises_and_runs_nothing_eagerly(hopper):
    problem, x0, y0, data, config = _section6(hopper, "gt-dsgd")
    solver = make_solver(config)
    state = solver.init(problem, None, x0, y0, data)
    reads = lambda st: torch.tensor(float(st.x[0][0].sum()), device=hopper)
    with pytest.raises(RuntimeError):
        solver.run_traced(state, data, 2, 1, reads)
    again = make_solver(config)
    state = again.init(problem, None, x0, y0, data)
    step = again._step_fn

    def reading_step(st, d, draws):
        float(st.y[1].sum())          # a host read inside the step
        return step(st, d, draws)

    again._step_fn = reading_step
    with pytest.raises(RuntimeError):
        run_recorded(again, state, data, 2, scan=True)
    assert again.stepper.graphs == {}
    assert state.t == 0


# (algo, wire and topology options, graphs captured over 6 steps)
WIRE_CASES = {
    "link-failure-period3": ("gt-dsgd", dict(
        topology_process=TopologyProcessConfig("link-failure", p=0.3,
                                               period=3)), 1),
    "sign1bit-warm2-k2": ("interact", dict(
        compression=CompressionConfig("sign1bit", compress_after=2),
        communication_interval=2), 3),
    "topk-gamma0.5": ("interact", dict(
        compression=CompressionConfig("topk", gamma=0.5)), 1),
    "int8-svr-interact": ("svr-interact", dict(
        compression=CompressionConfig("int8")), 2),
    "int8-d-sgd": ("d-sgd", dict(compression=CompressionConfig("int8")), 1),
    "adaptive": ("interact", dict(
        topology_process=TopologyProcessConfig("adaptive")), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_captured_wire_steps_equal_eager_steps(hopper, case):
    algo, opts, graphs = WIRE_CASES[case]
    problem, x0, y0, data, config = _section6(hopper, algo)
    config = dataclasses.replace(config, **opts)
    runs = {}
    for scan in (False, True):
        solver = make_solver(config)
        state = solver.init(problem, None, x0, y0, data)
        runs[scan] = run_recorded(solver, state, data, 6, scan=scan)[0]
        if scan:
            assert solver.stepper.replays == 6
            assert len(solver.stepper.graphs) == graphs
    assert runs[True].t == runs[False].t == 6
    assert _max_rel_gap(runs[True], runs[False]) <= CAPTURE_RTOL


@pytest.mark.cuda
def test_kernels_read_a_matrix_that_changes_between_replays(hopper):
    gen = torch.Generator(device=hopper).manual_seed(0)
    rand = lambda *shape: torch.rand(*shape, generator=gen, device=hopper)
    m, d = 5, 760
    buf = torch.empty(m, m, device=hopper)
    x, u, p, pp = (rand(m, d) for _ in range(4))
    mats = [rand(m, m) for _ in range(3)]
    buf.copy_(mats[0])
    side = torch.cuda.Stream(hopper)
    side.wait_stream(torch.cuda.current_stream(hopper))
    with torch.cuda.stream(side):
        mix_ops.consensus_mix_kernel(buf, x)
        mix_ops.consensus_step_kernel(buf, x, u, p, pp, alpha=0.3)
    torch.cuda.current_stream(hopper).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mixed = mix_ops.consensus_mix_kernel(buf, x)
        x_out, u_out = mix_ops.consensus_step_kernel(buf, x, u, p, pp,
                                                     alpha=0.3)
    for mat in mats[1:] + mats[:1]:
        buf.copy_(mat)
        graph.replay()
        torch.cuda.synchronize(hopper)
        tol = MIX_TOL[torch.float32]
        torch.testing.assert_close(mixed, mix_ref.consensus_mix_ref(mat, x),
                                   atol=tol, rtol=tol)
        want = mix_ref.consensus_step_ref(mat, x, u, p, pp, alpha=0.3)
        torch.testing.assert_close(x_out, want[0], atol=tol, rtol=tol)
        torch.testing.assert_close(u_out, want[1], atol=tol, rtol=tol)


# chip_smoke.py's byzantine rows: (algo, ER edge probability, options)
SIGNFLIP1 = dict(kind="sign-flip", num_byzantine=1, scale=25.0)
BYZANTINE_CASES = {
    "signflip1-weighted": ("interact", 1.0, dict(
        byzantine=ByzantineConfig(**SIGNFLIP1))),
    "signflip0-weighted": ("interact", 1.0, dict(
        byzantine=ByzantineConfig("sign-flip", 0, 25.0))),
    "signflip1-trimmed1": ("interact", 1.0, dict(
        byzantine=ByzantineConfig(**SIGNFLIP1, combine="trimmed-mean",
                                  trim=1))),
    "signflip1-median-gt-dsgd": ("gt-dsgd", 0.5, dict(
        byzantine=ByzantineConfig(**SIGNFLIP1,
                                  combine="coordinate-median"))),
    "gaussian2-krum-svr": ("svr-interact", 1.0, dict(
        byzantine=ByzantineConfig("gaussian", 2, 25.0,
                                  combine="krum-like"))),
    "signflip1-weighted-guard": ("interact", 1.0, dict(
        byzantine=ByzantineConfig(**SIGNFLIP1),
        guard=GuardConfig(nan=True, max_norm=1e3))),
}


def _bitwise(a, b) -> bool:
    """Every tensor of two states equal bit for bit (NaN where NaN), and
    every other leaf equal."""
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
        elif not bool(((x == y) | (x.isnan() & y.isnan())).all()):
            return False
    return True


def _byzantine_runs(hopper, algo, p, opts, steps):
    problem, x0, y0, data, config = _section6(hopper, algo)
    config = dataclasses.replace(
        config, topology=TopologyConfig(p_connect=p), **opts)
    runs = {}
    for scan in (False, True):
        solver = make_solver(config)
        state = solver.init(problem, None, x0, y0, data)
        runs[scan] = run_recorded(solver, state, data, steps, scan=scan)[0]
        if scan:
            assert solver.stepper.replays == steps
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BYZANTINE_CASES))
def test_captured_byzantine_steps_equal_eager_steps(hopper, case):
    runs = _byzantine_runs(hopper, *BYZANTINE_CASES[case], steps=6)
    assert runs[True].t == runs[False].t == 6
    assert _bitwise(runs[True], runs[False])


@pytest.mark.cuda
@pytest.mark.parametrize("max_norm,tripped", [(1e9, False), (1e3, True)])
def test_guard_counters_follow_the_replays(hopper, max_norm, tripped):
    opts = dict(byzantine=ByzantineConfig(**SIGNFLIP1),
                guard=GuardConfig(nan=True, max_norm=max_norm))
    runs = _byzantine_runs(hopper, "interact", 1.0, opts, steps=6)
    guard = {k: int(v) for k, v in runs[True].guard.items()}
    assert guard == {k: int(v) for k, v in runs[False].guard.items()}
    if tripped:
        assert guard["tripped"] > 0 and guard["last_good"] < 6
        assert guard["tripped"] + guard["last_good"] == 6
    else:
        assert guard == {"last_good": 6, "tripped": 0}


# (algo, options) of the killed-and-resumed captured runs
RESUME_CASES = {
    "interact": ("interact", {}),
    "svr-interact": ("svr-interact", {}),
    "gt-dsgd": ("gt-dsgd", {}),
    "d-sgd": ("d-sgd", {}),
    "sign1bit-warm2-k2": ("interact", dict(
        compression=CompressionConfig("sign1bit", compress_after=2),
        communication_interval=2)),
    "signflip1-guard": ("interact", dict(
        topology=TopologyConfig(p_connect=1.0),
        byzantine=ByzantineConfig(**SIGNFLIP1),
        guard=GuardConfig(nan=True, max_norm=1e3))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("resume_scan", [True, False],
                         ids=["captured", "eager"])
@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_killed_captured_run_resumes_bitwise(hopper, tmp_path, case,
                                             resume_scan):
    algo, opts = RESUME_CASES[case]
    problem, x0, y0, data, config = _section6(hopper, algo)
    config = dataclasses.replace(config, **opts)
    metric = convergence_metric_fn(problem, config.hypergrad, data,
                                   inner_steps=30)
    solver = make_solver(config)
    want_state, want = solver.run_traced(
        solver.init(problem, None, x0, y0, data), data, 9, 3, metric)
    killed = make_solver(config)
    with pytest.raises(SimulatedKill):
        run_resumable(killed, killed.init(problem, None, x0, y0, data), data,
                      9, 3, metric, checkpoint_every=3, ckpt_dir=tmp_path,
                      hooks=FaultPlan([make_fault("kill", step=4)]))
    assert killed.stepper.replays == 6
    resumed, state, trace = resume_run(
        config, tmp_path, metric_fn=metric, checkpoint_every=3,
        problem=problem, x0=x0, y0=y0, data=data, scan=resume_scan,
        device=hopper)
    if resume_scan:
        assert resumed.stepper.replays == 6
    assert state.t == 9
    assert trace.tobytes() == want.cpu().numpy().tobytes()
    assert _bitwise(state, want_state)


# ---------------------------------------------------------------------------
# The linearize-once backends outside vmap, captured
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cg-linearized", "neumann-linearized"])
def test_linearized_solve_captures_its_tangent(hopper, backend):
    from repro_torch.hypergrad import get_backend
    problem, x0, y0, data = default_setup(0, n_per_agent=100, device=hopper)
    cfg = HypergradConfig(backend=backend, cg_iters=16, neumann_k=6,
                          lipschitz_g=4.0)
    batch = (data.inner_x[0], data.inner_y[0])
    b = torch.func.grad(problem.outer, argnums=1)(
        x0, y0, (data.outer_x[0], data.outer_y[0]))
    engine = get_backend(backend)
    z_eager, stats_eager = engine.solve(problem.inner, x0, y0, b, cfg,
                                        (batch,))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        engine.solve(problem.inner, x0, y0, b, cfg, (batch,))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        z, stats = engine.solve(problem.inner, x0, y0, b, cfg, (batch,))
    graph.replay()
    torch.cuda.synchronize()
    assert _max_rel_gap(z, z_eager) <= CAPTURE_RTOL
    assert [int(c) for c in stats] == [int(c) for c in stats_eager]


# ---------------------------------------------------------------------------
# LM training on the card against the CPU
# ---------------------------------------------------------------------------

LM_CARD_CPU_TOL = 1e-5


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(hopper):
    from repro_torch.configs import get_config
    from repro_torch.sharding.collectives import AgentMesh
    from repro_torch.train.bilevel_lm import BilevelHyper
    from repro_torch.train.step import (InteractConfig, init_train_state,
                                        make_eval_step, make_train_step)
    from repro_torch.train.svr_step import SvrTrainState, make_svr_train_step
    cfg = get_config("smollm-360m").reduced(vocab_size=128, num_layers=2,
                                            dtype="float32")
    hyper = BilevelHyper(mu_g=0.5, neumann_k=2, lipschitz_g=4.0,
                         ce_chunk=16, remat=True)
    icfg = InteractConfig(alpha=0.05, beta=0.3, hyper=hyper)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 4, 32)))
    host = init_train_state(cfg, 0, device="cpu")
    tree = torch.utils._pytree
    finals, evals = {}, {}
    for dev in (hopper, torch.device("cpu")):
        mesh = AgentMesh.local(1, dev)
        state = tree.tree_map(lambda l: l.to(dev) if isinstance(
            l, torch.Tensor) else l, host)
        step = make_train_step(cfg, mesh, icfg)
        for _ in range(2):
            state, metrics = step(state, tokens)
        svr = make_svr_train_step(cfg, mesh, icfg, q=2)
        state = SvrTrainState(*state[:5], x_prev=host.x if dev.type == "cpu"
                              else tree.tree_map(lambda l: l.to(dev),
                                                 host.x),
                              y_prev=host.y.to(dev), t=state.t)
        for _ in range(2):
            state, _ = svr(state, tokens)
        finals[dev.type] = tree.tree_map(lambda l: l.cpu(),
                                         (state.x, state.y, state.u))
        for name in fa_ops.LAUNCHES:
            fa_ops.LAUNCHES[name] = 0
        evals[dev.type] = {impl: float(make_eval_step(
            cfg, mesh, dataclasses.replace(icfg, hyper=dataclasses.replace(
                hyper, attn_impl=impl)))(state, tokens))
            for impl in ("reference", "cuda")}
        launches = dict(fa_ops.LAUNCHES)
        if dev.type == "cuda":
            assert launches["flash_attention"] == cfg.num_layers
            assert launches["flash_attention_f32"] == cfg.num_layers
        else:
            assert sum(launches.values()) == 0
    assert _max_rel_gap(finals["cuda"], finals["cpu"]) <= LM_CARD_CPU_TOL
    assert evals["cuda"]["cuda"] == pytest.approx(evals["cuda"]["reference"],
                                                  rel=FLASH_TOL)
    assert evals["cuda"]["reference"] == pytest.approx(
        evals["cpu"]["reference"], rel=LM_CARD_CPU_TOL)
