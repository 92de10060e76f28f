"""Package hygiene of the port: imports, devices, registries, the build.

The port imports neither JAX nor the JAX package; its entry points (the
INTERACT solver's, the LM serving path's and the LM training path's) run
on the CUDA card unless told otherwise and raise where there is none; a missing CUDA compiler is
an error, never a fallback.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serving import (make_prefill_step,  # noqa: E402
                                        make_serve_step)
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.solvers import (SolverConfig, available_solvers,  # noqa: E402
                                 default_setup, make_solver, solve)

SRC = Path(__file__).resolve().parents[1] / "src"

_WALK = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n in ("jax", "repro") or n.startswith(("jax.", "repro.")))
mesh = {"repro_torch.consensus.allgather", "repro_torch.consensus.ppermute",
        "repro_torch.sharding.collectives", "repro_torch.launch.distributed",
        "repro_torch.launch.launch_local"}
train = {"repro_torch.train.bilevel_lm", "repro_torch.train.step",
         "repro_torch.train.svr_step", "repro_torch.data.synthetic",
         "repro_torch.optim.optimizers", "repro_torch.launch.train"}
models = {"repro_torch.models.mamba", "repro_torch.models.moe"}
print(len(names), bad, "repro_torch.solvers.sweep" in names,
      mesh <= set(names), train <= set(names), models <= set(names))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _WALK], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert int(out[0]) >= 59          # every module was imported
    assert out[1] == "[]", out
    assert out[2] == "True", out      # the sweeps among them
    assert out[3] == "True", out      # the multi-process path too
    assert out[4] == "True", out      # and the LM training path
    assert out[5] == "True", out      # and the mamba and moe modules


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA card")


def test_default_setup_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_setup(n_per_agent=20)


def test_solve_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(SolverConfig(backend="cuda"), 1, n_per_agent=20)


@pytest.mark.parametrize("entry", [
    lambda cfg: make_prefill_step(cfg, attn_impl="cuda"),
    lambda cfg: make_serve_step(cfg),
    lambda cfg: lm.init_params(cfg),
    lambda cfg: lm.init_cache(cfg, batch=1, max_len=8),
], ids=["make_prefill_step", "make_serve_step", "init_params", "init_cache"])
def test_serving_entry_points_without_device_raise_without_cuda(no_cuda,
                                                                 entry):
    cfg = get_config("gemma2-2b").reduced(num_prefix_tokens=0,
                                          frontend="none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(cfg)


@pytest.mark.parametrize("entry", [
    lambda: core.init_mlp_backbone(torch.Generator().manual_seed(0), 4),
    lambda: core.init_head(torch.Generator().manual_seed(0), 4, 3),
    lambda: core.make_synthetic_agents(0, 2, n_per_agent=10, d_in=4),
], ids=["init_mlp_backbone", "init_head", "make_synthetic_agents"])
def test_problem_builders_without_device_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


@pytest.mark.parametrize("entry", [
    lambda: core.init_mlp_backbone(torch.Generator().manual_seed(0), 4,
                                   device="cpu")[0][0],
    lambda: core.init_head(torch.Generator().manual_seed(0), 4, 3,
                           device="cpu")[0],
    lambda: core.make_synthetic_agents(0, 2, n_per_agent=10, d_in=4,
                                       device="cpu").inner_x,
], ids=["init_mlp_backbone", "init_head", "make_synthetic_agents"])
def test_problem_builders_run_on_the_cpu_when_asked(entry):
    assert entry().device == torch.device("cpu")


def test_initialize_defaults_to_the_card_and_raises_without_one(no_cuda):
    from repro_torch.launch.distributed import (DistributedConfig,
                                                initialize)
    config = DistributedConfig()
    assert (config.wire, config.device) == ("nccl", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize(config)


def test_launcher_defaults_to_the_card_and_raises_without_one(no_cuda):
    from repro_torch.launch import launch_local
    args = launch_local.parse_args([])
    assert (args.device, args.wire) == ("cuda", "nccl")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_local.main(["--processes", "1", "--agents", "2"])


def test_train_driver_defaults_to_the_card_and_raises_without_one(no_cuda):
    from repro_torch.launch import train
    args = train.parse_args([])
    assert (args.device, args.wire, args.arch) == ("cuda", "nccl",
                                                   "smollm-360m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--agents", "2", "--reduced"])


def test_train_state_and_tokens_without_device_raise_without_cuda(no_cuda):
    from repro_torch.data.synthetic import TokenTaskStream
    from repro_torch.train.step import init_train_state
    cfg = get_config("smollm-360m").reduced(vocab_size=64, num_layers=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenTaskStream(64, 2).global_batch(0, 2, 8)


def test_serve_cli_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "rwkv6-3b", "--prompt-len", "4",
                    "--new-tokens", "2"])


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_library_path_is_keyed_on_source(tmp_path):
    source = tmp_path / "k.cu"
    source.write_text("// one")
    first = build.library_path(source)
    assert build.library_path(source) == first
    assert first.parent == build.BUILD_DIR
    source.write_text("// two")
    assert build.library_path(source) != first


def test_library_path_is_keyed_on_defines(tmp_path):
    source = tmp_path / "k.cu"
    source.write_text("// one")
    plain = build.library_path(source)
    assert build.library_path(source, ()) == plain
    one = build.library_path(source, ("REPRO_FLASH_P_TERMS=1",))
    assert one != plain
    assert one == build.library_path(source, ("REPRO_FLASH_P_TERMS=1",))
    assert one != build.library_path(source, ("REPRO_FLASH_P_TERMS=2",))


def test_registries():
    assert available_solvers() == ("d-sgd", "gt-dsgd", "interact",
                                   "svr-interact")
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_solver(SolverConfig(algo="fedavg"))
    from repro_torch.hypergrad import HypergradConfig, available_backends
    assert available_backends() == ("cg", "cg-linearized", "cholesky",
                                    "neumann", "neumann-linearized")
    assert HypergradConfig(
        backend="cg-linearized").resolve_backend() == "cg-linearized"
    with pytest.raises(ValueError, match="not available in the port"):
        HypergradConfig(backend="lbfgs").resolve_backend()
    from repro_torch.byzantine import attack_names, combine_rule_names
    assert attack_names() == ("gaussian", "inner-outer-split", "same-value",
                              "sign-flip")
    assert combine_rule_names() == ("coordinate-median", "krum-like",
                                    "trimmed-mean", "weighted")
    from repro_torch.consensus import BACKENDS, make_engine
    assert sorted(BACKENDS) == ["allgather", "cuda", "dense", "ppermute"]
    with pytest.raises(ValueError, match="unknown consensus backend"):
        make_engine("pallas", np.eye(3), "cpu")


def test_solver_rejects_network_data_mismatch():
    problem, x0, y0, data = default_setup(num_agents=4, n_per_agent=20,
                                          device="cpu")
    solver = make_solver(SolverConfig(num_agents=5))
    with pytest.raises(ValueError, match="5-agent network"):
        solver.init(problem, None, x0, y0, data)


def test_default_setup_shapes_and_seeding():
    problem, x0, y0, data = default_setup(seed=3, device="cpu")
    assert [tuple(w.shape) for layer in x0 for w in layer] == [
        (16, 20), (20,), (20, 20), (20,)]
    assert sum(w.numel() for layer in x0 for w in layer) == 760
    assert [tuple(w.shape) for w in y0] == [(20, 5), (5,)]
    assert tuple(data.inner_x.shape) == (5, 420, 16)
    assert tuple(data.outer_x.shape) == (5, 180, 16)
    assert data.inner_y.dtype == torch.int64
    assert int(data.inner_y.max()) < 5
    again = default_setup(seed=3, device="cpu")
    torch.testing.assert_close(again[1][0][0], x0[0][0], atol=0, rtol=0)
    torch.testing.assert_close(again[3].inner_x, data.inner_x, atol=0, rtol=0)
