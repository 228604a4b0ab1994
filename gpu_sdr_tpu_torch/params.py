"""Measurement parameters: the JAX package's parameter structs, which
import no JAX, shared as they are (gpu_sdr_tpu/params.py)."""

from gpu_sdr_tpu.params import (  # noqa: F401
    AntMode, AntennaParams, ParamError, UsrpParams, WaveType)
