"""request_p95_ms: the 95th percentile (nearest rank) of every request's
latency in an open-loop window, from its due time to the host's seeing it
complete; a request that never completed counts as infinitely late. Host
clock."""
from portbench.lib.loadgen import nearest_rank


def read(rec: dict) -> float | None:
    if rec["due"] is None:
        return None
    lat = [float("inf") if d is None else d - t
           for t, d in zip(rec["due"], rec["done"])]
    return nearest_rank(lat, 0.95) * 1e3
