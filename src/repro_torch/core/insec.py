"""INSEC baseline — plain insecure aggregation (paper's control condition).

Learners post raw vectors and the controller averages them: a sum over
the learner dim of [n, V]. No masks, no privacy, no kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chain import host_alive, pod_rounds
from repro_torch.core.types import ChainConfig
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
