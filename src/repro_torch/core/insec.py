"""INSEC baseline — plain insecure aggregation (paper's control condition).

Learners post raw vectors and the controller averages them: a sum over
the learner dim of [n, V]. No masks, no privacy, no kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chain import host_alive, pod_rounds
from repro_torch.core.types import ChainConfig
from repro_torch.dist import collectives
from repro_torch.kernels.build import upload


def insec_aggregate(values: torch.Tensor, cfg: ChainConfig, alive=None,
                    weights=None) -> torch.Tensor:
    """Plain (weighted) mean over alive learners. values: f32[n, V]
    (f32[P, n, V] with ``cfg.pod_axis``: the mean over pods of each pod's)."""
    if cfg.pod_axis is not None:
        return pod_rounds(lambda v, c, w: insec_aggregate(v, c, alive, w),
                          values, cfg, weights)
    n = cfg.num_learners
    alive = upload(host_alive(alive, n), values.device)
    if weights is None:
        w = alive
    else:
        if not isinstance(weights, torch.Tensor):
            weights = upload(np.asarray(weights, np.float32), values.device)
        w = weights.to(values.device, torch.float32) * alive
    num = (values * w[:, None]).sum(dim=0)
    return num / torch.clamp_min(w.sum(), 1e-12)


def insec_rank(values: torch.Tensor, cfg: ChainConfig, world, alive=None,
               weight=None) -> torch.Tensor:
    """``insec_aggregate`` with one learner per rank: the ``psum``s of v·w
    and w, each the one-card sum over the learner dim of the same
    products, so the mean is the one-card mean bit for bit."""
    a = host_alive(alive, cfg.num_learners)[world.rank]
    w = torch.full((), float(a), dtype=torch.float32, device=values.device)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32).to(values.device).reshape(()) * w
    num = collectives.psum(values * w, world)
    return num / torch.clamp_min(collectives.psum(w, world), 1e-12)
