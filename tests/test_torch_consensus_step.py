"""The port's consensus kernels against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
(interpret mode, as tests/test_kernels.py runs it), the JAX plain
reference, and the port's wrappers.  On CPU tensors the port's wrappers
run their plain PyTorch version; the CUDA kernels themselves are held
against that version on the card by chip_smoke.py.

Every case runs with the (symmetric, circulant) ring matrix and with a
random row-normalised matrix that is not symmetric, so a kernel that
read M transposed, or with the wrong stride, would disagree.

Tolerances: float32 1e-5 (one (m x m) by (m x D) product summed in
another order), bfloat16 3e-2 (one rounding of the output to 8 bits of
mantissa), as for the JAX kernel in tests/test_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import laplacian_mixing as j_laplacian  # noqa: E402
from repro.core import erdos_renyi_adjacency as j_er  # noqa: E402
from repro.core import ring_mixing as j_ring  # noqa: E402
from repro.kernels.consensus_step import ops as j_ops  # noqa: E402
from repro.kernels.consensus_step import ref as j_ref  # noqa: E402
from repro_torch.consensus import make_engine  # noqa: E402
from repro_torch.core import (erdos_renyi_adjacency,  # noqa: E402
                              laplacian_mixing, ring_mixing)
from repro_torch.kernels.consensus_step import ops  # noqa: E402

ALPHA = 0.3
F32_TOL = 1e-5
BF16_TOL = 3e-2

CASES = ([(m, d, "float32") for m in (4, 5, 8, 16)
          for d in (123, 512, 700, 2048)]
         + [(8, 512, "bfloat16"), (5, 760, "float32")])
MATRICES = ["ring", "random"]


def _random_mixing(m, rng):
    """A row-stochastic (m, m) matrix that is not symmetric."""
    mix = rng.uniform(0.05, 1.0, (m, m))
    return (mix / mix.sum(axis=1, keepdims=True)).astype(np.float32)


def _inputs(m, d, seed=0, matrix="ring"):
    rng = np.random.default_rng(seed)
    if matrix == "ring":
        mix = ring_mixing(m).matrix.astype(np.float32)
    else:
        mix = _random_mixing(m, rng)
        assert not np.allclose(mix, mix.T)
    streams = [rng.standard_normal((m, d)).astype(np.float32)
               for _ in range(4)]
    return mix, streams


def _jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _torch(a, dtype):
    return torch.tensor(a).to(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("m,d,dtype", CASES)
def test_consensus_step_matches_jax_kernel_and_ref(m, d, dtype, matrix):
    mix, streams = _inputs(m, d, matrix=matrix)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [_jax(s, jd) for s in streams]
    tx = [_torch(s, td) for s in streams]
    j_kernel = j_ops.consensus_step(jnp.asarray(mix), *jx, alpha=ALPHA)
    j_oracle = j_ref.consensus_step_ref(jnp.asarray(mix), *jx, alpha=ALPHA)
    port = ops.consensus_step_kernel(torch.tensor(mix), *tx, alpha=ALPHA)
    assert port[0].dtype == td and port[1].dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for k in range(2):
        np.testing.assert_allclose(_np(port[k]), _np(j_kernel[k]),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(port[k]), _np(j_oracle[k]),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("m,d,dtype", CASES)
def test_consensus_mix_matches_jax_kernel(m, d, dtype, matrix):
    from repro.kernels.consensus_step.kernel import consensus_mix_kernel
    mix, streams = _inputs(m, d, seed=1, matrix=matrix)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j_out = consensus_mix_kernel(jnp.asarray(mix), _jax(streams[0], jd))
    port = ops.consensus_mix_kernel(torch.tensor(mix),
                                    _torch(streams[0], td))
    assert port.dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(port), _np(j_out), atol=tol, rtol=tol)


# consensus_mix's edges: agents (17: two passes of 16 rows in the CUDA
# kernel) by row lengths (760 and 4096 take its 16-byte path in both
# dtypes; 1, 3, 123 and 761 the element path in both)
MIX_EDGES = [(m, d) for m in (1, 3, 5, 16, 17) for d in (1, 3, 123, 760,
                                                         761, 4096)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", MIX_EDGES)
def test_consensus_mix_edges_match_jax_kernel(m, d, dtype):
    """Random non-symmetric M; x one element into its storage (contiguous,
    a misaligned base) and aligned: the same values either way."""
    from repro.kernels.consensus_step.kernel import consensus_mix_kernel
    rng = np.random.default_rng(m * 10007 + d)
    mix = _random_mixing(m, rng) if m > 1 else np.ones((1, 1), np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j_out = consensus_mix_kernel(jnp.asarray(mix), _jax(x, jd))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    buf = torch.cat([torch.zeros(1, dtype=td), _torch(x, td).flatten()])
    for tx in (_torch(x, td), buf[1:].view(m, d)):
        assert tx.is_contiguous()
        port = ops.consensus_mix_kernel(torch.tensor(mix), tx)
        assert port.dtype == td
        np.testing.assert_allclose(_np(port), _np(j_out), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", MIX_EDGES)
def test_consensus_step_edges_match_jax_kernel(m, d, dtype):
    """consensus_step on the mix's edges (17 agents: the CUDA kernel's
    passes; 1 to 16 its two stagings), random non-symmetric M; every
    stream aligned and every stream one element into its storage
    (contiguous, a misaligned base: the CUDA kernel's element path), the
    same values either way."""
    from repro.kernels.consensus_step.kernel import consensus_step_kernel
    rng = np.random.default_rng(m * 10007 + d + 1)
    mix = _random_mixing(m, rng) if m > 1 else np.ones((1, 1), np.float32)
    streams = [rng.standard_normal((m, d)).astype(np.float32)
               for _ in range(4)]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j_out = consensus_step_kernel(jnp.asarray(mix),
                                  *(_jax(s, jd) for s in streams),
                                  alpha=ALPHA)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    aligned = [_torch(s, td) for s in streams]
    shifted = []
    for t in aligned:
        buf = torch.cat([torch.zeros(1, dtype=td), t.flatten()])
        shifted.append(buf[1:].view(m, d))
    for operands in (aligned, shifted):
        assert all(t.is_contiguous() for t in operands)
        port = ops.consensus_step_kernel(torch.tensor(mix), *operands,
                                         alpha=ALPHA)
        for k in range(2):
            assert port[k].dtype == td and port[k].shape == (m, d)
            np.testing.assert_allclose(_np(port[k]), _np(j_out[k]),
                                       atol=tol, rtol=tol)


# the six stream operands of a consensus_step launch, as
# takes_16_byte_path receives them
STEP_OPERANDS = ("x", "u", "p", "p_prev", "x_out", "u_out")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("misaligned", (None,) + STEP_OPERANDS)
def test_step_takes_16_byte_path_only_when_all_six_operands_are_aligned(
        dtype, misaligned):
    m, d = 5, 760

    def view(offset):
        """(m, d) contiguous, ``offset`` elements into a fresh storage: 8
        is 16 or 32 bytes (aligned), 1 is 2 or 4 (misaligned)."""
        return torch.zeros(m * d + offset, dtype=dtype)[offset:].view(m, d)
    operands = [view(1 if name == misaligned else 8)
                for name in STEP_OPERANDS]
    assert ops.takes_16_byte_path(*operands) is (misaligned is None)
    # rows that are not a multiple of 16 bytes take the element path with
    # every base aligned
    rows = [torch.zeros(m, 761, dtype=dtype) for _ in STEP_OPERANDS]
    assert not ops.takes_16_byte_path(*rows)
    # the mix's predicate is the two-operand case
    x, out = operands[0], operands[4]
    assert ops.mix_takes_16_byte_path(x, out) is ops.takes_16_byte_path(
        x, out)


@pytest.mark.parametrize("dtype,d,offset,expect", [
    (torch.float32, 760, 0, True), (torch.float32, 4096, 0, True),
    (torch.bfloat16, 760, 0, True), (torch.bfloat16, 4096, 0, True),
    (torch.float32, 761, 0, False),    # a row of 3044 bytes
    (torch.float32, 123, 0, False),
    (torch.bfloat16, 3, 0, False),
    (torch.float32, 760, 1, False),    # base 4 bytes into its storage
    (torch.bfloat16, 760, 1, False),   # base 2 bytes in
    (torch.bfloat16, 760, 8, True),    # base 16 bytes in
    (torch.float32, 760, 4, True),
])
def test_mix_takes_16_byte_path_only_when_every_row_is_aligned(
        dtype, d, offset, expect):
    m = 5
    x = torch.zeros(m * d + offset, dtype=dtype)[offset:].view(m, d)
    out = torch.empty_like(x)
    assert x.data_ptr() % 16 == (offset * x.element_size()) % 16
    assert ops.mix_takes_16_byte_path(x, out) is expect
    misaligned_out = torch.zeros(m * d + 1, dtype=dtype)[1:].view(m, d)
    assert not ops.mix_takes_16_byte_path(x, misaligned_out)


def _mixed_tree(m, rng, scale=1.0):
    """A backbone-shaped list of (W, b) with one bfloat16 leaf."""
    w0 = scale * rng.standard_normal((m, 13, 7)).astype(np.float32)
    b0 = scale * rng.standard_normal((m, 7)).astype(np.float32)
    w1 = scale * rng.standard_normal((m, 7, 3)).astype(np.float32)
    b1 = scale * rng.standard_normal((m, 3)).astype(np.float32)
    j = [(jnp.asarray(w0), jnp.asarray(b0).astype(jnp.bfloat16)),
         (jnp.asarray(w1), jnp.asarray(b1))]
    t = [(torch.tensor(w0), torch.tensor(b0).to(torch.bfloat16)),
         (torch.tensor(w1), torch.tensor(b1))]
    return j, t


def test_flatten_agents_matches_ravel_pytree_with_mixed_dtypes():
    rng = np.random.default_rng(3)
    j_tree, t_tree = _mixed_tree(6, rng)
    j_flat, j_unravel = j_ops.flatten_agents(j_tree)
    t_flat, t_unravel = ops.flatten_agents(t_tree)
    assert t_flat.dtype == torch.float32 and t_flat.shape == (6, 13 * 7 + 7
                                                              + 7 * 3 + 3)
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
    back = t_unravel(t_flat)
    for got, want in zip(torch.utils._pytree.tree_leaves(back),
                         torch.utils._pytree.tree_leaves(t_tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("matrix", MATRICES)
def test_pytree_consensus_step_matches_jax_with_mixed_dtypes(matrix):
    m = 6
    rng = np.random.default_rng(4)
    mix = (ring_mixing(m).matrix.astype(np.float32) if matrix == "ring"
           else _random_mixing(m, rng))
    trees = [_mixed_tree(m, rng, scale=s) for s in (1.0, 0.1, 0.2, 0.3)]
    jx, ju, jp, jpp = (t[0] for t in trees)
    tx, tu, tp, tpp = (t[1] for t in trees)
    j_x, j_u = j_ops.consensus_step(jnp.asarray(mix), jx, ju, jp, jpp,
                                    alpha=0.25)
    t_x, t_u = ops.consensus_step(torch.tensor(mix), tx, tu, tp, tpp,
                                  alpha=0.25)
    for got_tree, want_tree in ((t_x, j_x), (t_u, j_u)):
        got = torch.utils._pytree.tree_leaves(got_tree)
        want = jax.tree_util.tree_leaves(want_tree)
        for g, w in zip(got, want):
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            tol = F32_TOL if g.dtype == torch.float32 else BF16_TOL
            np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)
    t_mix = ops.consensus_mix(torch.tensor(mix), tx)
    j_mix = j_ops.consensus_mix(jnp.asarray(mix), jx)
    for g, w in zip(torch.utils._pytree.tree_leaves(t_mix),
                    jax.tree_util.tree_leaves(j_mix)):
        tol = F32_TOL if g.dtype == torch.float32 else BF16_TOL
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)


def _model_trees(m, rng):
    """x, u, p, p_prev shaped like the Section-6 backbone."""
    def tree(scale):
        f32 = lambda shape: torch.tensor(scale * rng.standard_normal(shape),
                                         dtype=torch.float32)
        return [(f32((m, a, b)), f32((m, b))) for a, b in ((16, 20), (20, 20))]

    return tree(1.0), tree(0.1), tree(0.1), tree(0.1)


@pytest.mark.parametrize("matrix", ["er_laplacian", "random"])
def test_cuda_engine_equals_dense_engine_on_cpu(matrix):
    m = 5
    spec = (laplacian_mixing(erdos_renyi_adjacency(m, 0.5, 0))
            if matrix == "er_laplacian"
            else _random_mixing(m, np.random.default_rng(6)))
    dense = make_engine("dense", spec, "cpu")
    cuda = make_engine("cuda", spec, "cpu")
    assert cuda.matrix.dtype == torch.float32
    torch.testing.assert_close(cuda.matrix, dense.matrix, atol=0, rtol=0)
    x, u, p, pp = _model_trees(m, np.random.default_rng(5))
    leaves = torch.utils._pytree.tree_leaves
    for a, b in zip(leaves(cuda.step1_step3(x, u, p, pp, ALPHA)),
                    leaves(dense.step1_step3(x, u, p, pp, ALPHA))):
        torch.testing.assert_close(a, b, atol=F32_TOL, rtol=F32_TOL)
    # with p is p_prev the tracker comes back as mix(u), as in the step-core
    _, u_mixed = cuda.step1_step3(x, u, pp, pp, ALPHA)
    for a, b in zip(leaves(u_mixed), leaves(cuda.mix(u))):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for a, b in zip(leaves(cuda.mix(x)), leaves(dense.mix(x))):
        torch.testing.assert_close(a, b, atol=F32_TOL, rtol=F32_TOL)


def test_cuda_engine_matrix_matches_pallas_engine_matrix():
    from repro.consensus import make_engine as j_make_engine
    spec_j = j_laplacian(j_er(5, 0.5, 0))
    spec_t = laplacian_mixing(erdos_renyi_adjacency(5, 0.5, 0))
    j_mat = np.asarray(j_make_engine("pallas", spec_j).matrix)
    np.testing.assert_array_equal(
        make_engine("cuda", spec_t, "cpu").matrix.numpy(), j_mat)
    np.testing.assert_array_equal(j_ring(7).matrix, ring_mixing(7).matrix)


@pytest.mark.parametrize("bad", ["shape", "dtype", "matrix_dtype",
                                 "contiguous", "matrix_shape"])
def test_wrapper_rejects_bad_operands(bad):
    mix, streams = _inputs(4, 64)
    M = torch.tensor(mix)
    x, u, p, pp = (torch.tensor(s) for s in streams)
    if bad == "shape":
        u = u[:, :32].contiguous()
    elif bad == "dtype":
        p = p.double()
    elif bad == "matrix_dtype":
        M = M.double()
    elif bad == "contiguous":
        x = torch.tensor(streams[0].T.copy()).T
    elif bad == "matrix_shape":
        M = M[:3]
    with pytest.raises((ValueError, TypeError)):
        ops.consensus_step_kernel(M, x, u, p, pp, alpha=ALPHA)


def test_cpu_path_counts_no_launch():
    before = dict(ops.LAUNCHES)
    mix, streams = _inputs(5, 100)
    ops.consensus_step_kernel(torch.tensor(mix),
                              *(torch.tensor(s) for s in streams), alpha=0.1)
    ops.consensus_mix_kernel(torch.tensor(mix), torch.tensor(streams[0]))
    assert ops.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels only run on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_wrapper_rejects_cpu_matrix_with_cuda_streams(cuda_device):
    mix, streams = _inputs(5, 100)
    x, u, p, pp = (torch.tensor(s, device=cuda_device) for s in streams)
    with pytest.raises(ValueError):
        ops.consensus_step_kernel(torch.tensor(mix), x, u, p, pp, alpha=0.1)
    with pytest.raises(ValueError):
        ops.consensus_mix_kernel(torch.tensor(mix), x)
