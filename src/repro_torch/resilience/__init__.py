"""The fault-tolerant resumable runtime (counterpart of ``repro.resilience``).

Three layers on the crash-safe ``repro_torch.checkpoint`` store:

* ``snapshot`` / ``resume``: the complete solver state (and a stochastic
  solver's host generator) on disk, with a config fingerprint, so a
  snapshot only continues the experiment it came from.
* ``run_resumable`` / ``resume_run``: the checkpoint-chunked runner
  behind ``SolverBase.run`` and ``run_traced(..., checkpoint_every=...)``,
  eager or replaying CUDA graphs; killed at any step and resumed, the
  trace equals the uninterrupted run's bit for bit.
* ``FaultPlan`` / ``chaos_run``: seeded fault injection (process kills,
  NaN payloads, corrupt or deleted checkpoints, transient write failures)
  and the recovery loop that survives it.
"""
from repro_torch.resilience.chaos import ChaosReport, chaos_run
from repro_torch.resilience.faults import (Fault, FaultPlan,
                                           available_faults, make_fault,
                                           register_fault)
from repro_torch.resilience.runner import (GuardTripFault,
                                           NonFiniteStateError,
                                           SimulatedKill, resume_run,
                                           run_resumable)
from repro_torch.resilience.snapshot import (Resumed, config_fingerprint,
                                             resume, snapshot)

__all__ = [
    "ChaosReport",
    "Fault",
    "FaultPlan",
    "GuardTripFault",
    "NonFiniteStateError",
    "Resumed",
    "SimulatedKill",
    "available_faults",
    "chaos_run",
    "config_fingerprint",
    "make_fault",
    "register_fault",
    "resume",
    "resume_run",
    "run_resumable",
    "snapshot",
]
