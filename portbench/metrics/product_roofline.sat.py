"""product_roofline.sat: the least time the window's products need (each
operand byte read once and each result byte written once, at the card's
published HBM rate; portbench/roofline/<kind>.py and peaks.json) over the
device time of every activity those requests put on the card, in percent.
Closed-loop cells, traced. Device trace."""


def read(rec: dict) -> float | None:
    t = rec["trace"]
    if (t is None or rec["loop"] != "closed" or not t["device_s"]
            or not rec["peak_bytes_per_s"]):
        return None
    least = rec["products"] * rec["bytes_per_product"] / rec["peak_bytes_per_s"]
    return 100.0 * least / t["device_s"]
