"""Mean time the train loop waited on the prefetch thread for its next
batch (the benchmark's own span ``pb.wait_batch`` around each ``next()``,
read from the traced window), ms a step."""


def read(run: dict):
    t, steps = run.get("trace"), run["stats"].get("steps")
    if t is None or not steps:
        return None
    waits = [dur for name, _, dur in t.spans if name == "wait_batch"]
    return sum(waits) * 1e-3 / steps if waits else None
