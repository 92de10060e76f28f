"""One rank of the port's ``run_section6`` in tests/test_torch_distributed.py.

    python tests/_torch_section6_worker.py WORLD RANK PORT RUNS OUT

Joins a gloo group of WORLD processes on the CPU and makes each run of
the JSON list in RUNS (``{"name", "backend", "algo", "setup",
"num_agents"}``): the port's ``run_section6`` with ``SETTINGS``, on the
host instance pickled at ``setup`` (``(x0, y0, data)`` as numpy, the JAX
package's; a run waits until the file is there) or, where it is null,
on the port's ``default_setup``.  Each result goes to
``OUT/<name>.rank<RANK>.json``.
"""
from __future__ import annotations

import json
import pickle
import sys
import time
from pathlib import Path

# the run both packages make: tests/test_distributed.py's small settings
SETTINGS = dict(num_agents=8, num_steps=4, record_every=2, n_per_agent=24,
                metric_inner_steps=20, alpha=0.1, beta=0.1, seed=0)


def main(world: int, rank: int, port: int, runs: str, out: str) -> None:
    import torch

    from repro_torch.launch import distributed as D

    torch.set_num_threads(1)
    D.initialize(D.DistributedConfig(
        coordinator=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, wire="gloo", device="cpu", timeout_s=120))
    for run in json.loads(Path(runs).read_text()):
        setup = None
        if run["setup"] is not None:
            deadline = time.monotonic() + 300
            while not Path(run["setup"]).exists():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{run['setup']} was not written")
                time.sleep(0.05)
            with open(run["setup"], "rb") as f:
                setup = pickle.load(f)
        settings = dict(SETTINGS, num_agents=run["num_agents"])
        result = D.run_section6(backend=run["backend"], algo=run["algo"],
                                setup=setup, **settings)
        Path(out, f"{run['name']}.rank{rank}.json").write_text(
            json.dumps(result))
    D.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
