"""allocs_per_kblock: the caching allocators' new blocks while the
window call streamed, per 1000 blocks: the card's segments (cudaMalloc
calls) and new pinned host blocks, the program's counters, over its
``sdr.loop.block`` count, from the call's measure.RUNS record.  None
where the record has no counters (the recorder was off)."""


def read(run):
    rec = run.measure_run
    c, blocks = rec.get("counters"), \
        (rec.get("spans") or {}).get("sdr.loop.block")
    if not c or blocks is None or "device_segments" not in c:
        return None
    return 1e3 * (c["device_segments"] + c["pinned_allocs"]) / \
        blocks["count"]
