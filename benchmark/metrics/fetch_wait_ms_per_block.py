"""fetch_wait_ms_per_block: the mean, over the window call's blocks, of
the host's wait for a block's device-to-host copy, in milliseconds: the
program's ``sdr.drain.wait`` span, from the call's measure.RUNS record.
None where the record has no spans (the recorder was off)."""


def read(run):
    s = (run.measure_run.get("spans") or {}).get("sdr.drain.wait")
    return None if s is None else 1e3 * s["seconds"] / s["count"]
