"""device_idle_share.sat: the share of the traced closed-loop window in
which nothing ran on the card, in percent. Device trace."""


def read(rec: dict) -> float | None:
    t = rec["trace"]
    if t is None or rec["loop"] != "closed" or not t["device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
