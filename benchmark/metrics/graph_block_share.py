"""graph_block_share: the share of the window call's packets whose
block a CUDA graph replay issued, in percent: the program's
``graph_blocks`` counter (engine/replay._GraphGroups) over its
``sdr.inflight`` count (one interval a packet), from the call's
measure.RUNS record.  None where the record has no spans, or no such
counter (a program without the graphs)."""


def read(run):
    rec = run.measure_run
    c, packets = rec.get("counters"), \
        (rec.get("spans") or {}).get("sdr.inflight")
    if not c or packets is None or "graph_blocks" not in c:
        return None
    return 100.0 * c["graph_blocks"] / packets["count"]
