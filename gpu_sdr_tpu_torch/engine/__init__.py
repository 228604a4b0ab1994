"""Streaming engine (port of gpu_sdr_tpu/engine): a host loop over
fixed-size IQ blocks driving per-block steps whose carried state (PFB
spares, comb phases) is explicit:

    state, out = step(state, block)

Sources synthesize or serve IQ on the host, HostFeed stages it onto the
device, sinks receive numpy packets; FusedLoopback keeps a synthetic
loopback entirely on the device, and replay.DeviceReplay a recording;
dual runs two or more front ends in lock-step, dispatch predicts the
path run_measurement takes, and checkpoint saves and restores a state.
"""

from .planner import BlockPlan, plan_blocks  # noqa: F401
from .demodulator import make_demodulator, Demodulator  # noqa: F401
from .generator import make_generator, Generator  # noqa: F401
from .pipeline import run_pipeline, PipelineResult  # noqa: F401
from .checkpoint import save_state, load_state  # noqa: F401
from .fused import FusedLoopback, can_fuse  # noqa: F401
from .ingest import HostFeed  # noqa: F401
