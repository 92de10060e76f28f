"""Core: the paper's decentralized bilevel optimization, in PyTorch."""
from repro_torch.core.baselines import (
    DsgdState,
    GtDsgdState,
    dsgd_step,
    gt_dsgd_step,
    init_dsgd_state,
    init_gt_dsgd_state,
)
from repro_torch.core.bilevel import (
    AgentData,
    BilevelProblem,
    MLPMetaProblem,
    init_head,
    init_mlp_backbone,
    make_synthetic_agents,
    pad_agent_data,
)
from repro_torch.core.consensus import (
    MixingSpec,
    erdos_renyi_adjacency,
    laplacian_mixing,
    metropolis_mixing,
    mix_pytree,
    pad_mixing,
    ring_mixing,
    second_eigenvalue,
    torus_adjacency,
    torus_mixing,
    validate_mixing,
)
from repro_torch.core.interact import (
    InteractState,
    init_state,
    interact_step,
    theorem1_step_sizes,
)
from repro_torch.core.svr_interact import (
    Draws,
    Sampler,
    SvrState,
    init_svr_state,
    svr_interact_step,
)
from repro_torch.core.metrics import (
    MetricReport,
    convergence_metric,
    convergence_metric_fn,
    masked_convergence_metric,
    masked_convergence_metric_fn,
    solve_inner,
)

__all__ = [name for name in dir() if not name.startswith("_")]
