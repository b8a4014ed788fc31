"""The multi-lane sparse decoder's latency model (the port's own copy of
``repro.sim.decoder_sim.DecoderConfig`` and ``simulate_latency``, the
part the serving chunk policy needs).

``P_Wo`` out-of-order workers, each with an ``M``-lane decoder, pull
``P_Ci``-bit bitmap words released one per cycle; a word with popcount
``pc`` occupies a worker for ``max(1, ceil(pc / M))`` cycles.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DecoderConfig:
    p_ci: int          # input bit-width per word (channel-in parallelism)
    m_lanes: int       # decoder lanes per worker
    p_wo: int          # workers per grid point

    @property
    def throughput(self) -> int:
        return self.m_lanes * self.p_wo


def simulate_latency(popcounts: np.ndarray, cfg: DecoderConfig) -> int:
    """Makespan in cycles: words released one per cycle, list-scheduled
    onto the P_Wo workers."""
    durations = np.maximum(1, -(-popcounts // cfg.m_lanes))
    workers = [0] * cfg.p_wo
    heapq.heapify(workers)
    t_done = 0
    for release, dur in enumerate(durations):
        free = heapq.heappop(workers)
        end = max(free, release) + int(dur)
        heapq.heappush(workers, end)
        t_done = max(t_done, end)
    return t_done
