"""inflight_hold_ms: the median, over the window call's blocks, of the
time a block is held in the drain's queue, in milliseconds: the
program's ``sdr.inflight`` interval, from the end of the block's fetch
start to the start of its drain, from the call's measure.RUNS record.
None where the record has no spans (the recorder was off)."""


def read(run):
    s = (run.measure_run.get("spans") or {}).get("sdr.inflight")
    return None if s is None else 1e3 * s["p50_seconds"]
