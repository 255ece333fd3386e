"""gen_lag_p95_ms.load: the 95th percentile (nearest rank) of how late the
open-loop generator dispatched a request after it fell due: the load
generator's own share of the latency. Host clock."""
from portbench.lib.loadgen import nearest_rank


def read(rec: dict) -> float | None:
    if rec["due"] is None:
        return None
    lag = [s - t for t, s in zip(rec["due"], rec["dispatch_start"])]
    return nearest_rank(lag, 0.95) * 1e3
