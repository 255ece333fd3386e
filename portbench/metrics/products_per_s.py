"""products_per_s: every product the closed loop completed, over the
window's whole length (its first dispatch to the host's seeing the last
request complete). Host clock."""


def read(rec: dict) -> float | None:
    if rec["loop"] != "closed":
        return None
    return rec["products"] / rec["window_s"]
