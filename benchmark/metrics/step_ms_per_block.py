"""step_ms_per_block: the median, over the window call's blocks, of the
host's time in a block's step (its Python and its launches), in
milliseconds: the program's ``sdr.loop.step`` span, from the call's
measure.RUNS record.  None where the record has no spans (the recorder
was off)."""


def read(run):
    s = (run.measure_run.get("spans") or {}).get("sdr.loop.step")
    return None if s is None else 1e3 * s["p50_seconds"]
