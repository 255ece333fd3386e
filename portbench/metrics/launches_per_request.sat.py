"""launches_per_request.sat: device activities (kernels, copies, sets) in
the traced window of a closed loop, per request. Device trace."""


def read(rec: dict) -> float | None:
    t = rec["trace"]
    if t is None or rec["loop"] != "closed" or not t["device_events"]:
        return None
    return t["device_events"] / rec["requests"]
