"""measure_setup_s: the window call's set-up inside the program, from
its measure.RUNS record: the call's seconds less its streaming seconds
(validation, the plan, the demodulator's state, a chirp table, a
replay's upload)."""


def read(run):
    rec = run.measure_run
    return rec["seconds"] - rec["stream_seconds"]
