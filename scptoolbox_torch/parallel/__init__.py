"""Scenario batches over `torch.distributed` ranks: sharded solves with a
final gather, and the collective solve whose fleet stops on an all-reduced
convergence vote, on 1-D (batch) or 2-D (host x batch) device meshes."""

from scptoolbox_torch.parallel.batch import (BatchResult, make_mesh,
                                             make_mesh_2d, scenario_sweep,
                                             shard_batch,
                                             solve_batched_sharded)
from scptoolbox_torch.parallel.collective import (CollectiveResult,
                                                  solve_batched_collective)

__all__ = ["BatchResult", "make_mesh", "make_mesh_2d", "scenario_sweep",
           "shard_batch", "solve_batched_sharded", "CollectiveResult",
           "solve_batched_collective"]
