"""dispatch_us.load: the mean host time of one call into the bound entry
(registry route, planner's plan, wrapper glue, the launch), which returns
before the card has run it: the enqueue. Open-loop cells. Host clock."""


def read(rec: dict) -> float | None:
    if rec["due"] is None:
        return None
    spans = [e - s for s, e in zip(rec["dispatch_start"], rec["dispatch_end"])]
    return sum(spans) / len(spans) * 1e6
