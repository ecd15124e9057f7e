"""Mean time the predict loop waited on the prefetch thread for its next
batch (the benchmark's own span around each ``next()``), ms a batch."""


def read(run: dict):
    if not run["stats"].get("batches"):
        return None
    return run["stats"]["assembly_wait_ms"]
