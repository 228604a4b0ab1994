"""host_loop_ms_per_block: the median, over the window call's blocks, of
one iteration of the host's loop, in milliseconds: the program's
``sdr.loop.block`` span (a step, a fetch start, an earlier block's
drain), from the call's measure.RUNS record.  None where the record has
no spans (the recorder was off)."""


def read(run):
    s = (run.measure_run.get("spans") or {}).get("sdr.loop.block")
    return None if s is None else 1e3 * s["p50_seconds"]
