"""Carry state from the JAX package into the port.

The JAX package keeps complex state as float32 (re, im) pairs (its
``ops.cplx.C``, a NamedTuple, or any (re, im) pair of arrays) and the
fused channelizer's spare in the transposed (n1, avg-1, n2) kernel
layout.  These functions take such state as array-likes (numpy, or
anything numpy can read) and return the port's tensors, so a stream
started by the JAX package continues in the port where it stopped.
"""

from __future__ import annotations

import numpy as np
import torch


def complex_from_pair(pair, device) -> torch.Tensor:
    """A (re, im) float pair -> complex64 tensor of the same shape."""
    re, im = pair
    re = np.asarray(re, dtype=np.float32)
    im = np.asarray(im, dtype=np.float32)
    if re.shape != im.shape:
        raise ValueError(f"pair shapes differ: {re.shape} vs {im.shape}")
    out = np.empty(re.shape, dtype=np.complex64)
    out.real, out.imag = re, im
    return torch.from_numpy(out).to(device)


def host_spare(pair, avg: int, nfft: int, device) -> torch.Tensor:
    """The host-fed PFB demodulator's flat ((avg-1)*nfft,) spare
    (gpu_sdr_tpu/ops/pfb.pfb_spare_init), or the one
    pallas_channelizer.channelizer_frames carries -> the port's, same
    layout (ops/channelizer.channelizer_frames_scrambled takes it)."""
    s = complex_from_pair(pair, device)
    if tuple(s.shape) != ((avg - 1) * nfft,):
        raise ValueError(f"host spare shape {tuple(s.shape)}, expected "
                         f"({(avg - 1) * nfft},)")
    return s


def channelizer_spare(pair_t, device) -> torch.Tensor:
    """The fused chain's transposed (n1, avg-1, n2) spare_t (the layout
    of gpu_sdr_tpu/ops/pallas_channelizer.transpose_block) -> the port's
    (avg-1, nfft) spare frames, the inverse of transpose_block."""
    s = complex_from_pair(pair_t, device)
    if s.ndim != 3:
        raise ValueError(f"spare_t must be (n1, avg-1, n2), got "
                         f"{tuple(s.shape)}")
    n1, lead, n2 = s.shape
    return s.permute(1, 0, 2).reshape(lead, n1 * n2).contiguous()


def window(w, device) -> torch.Tensor:
    """A PFB prototype window (float, (nfft*avg,)) -> float32 tensor."""
    return torch.from_numpy(np.asarray(w, dtype=np.float32).copy()).to(
        device)


def tone_phase(phase, device) -> torch.Tensor:
    """An int32 phase vector (ToneCombConfig's per-channel phase, the
    DIRECT carrier phases) -> the port's int64."""
    return torch.from_numpy(np.asarray(phase).astype(np.int64)).to(device)


def ddc_state(state, device):
    """The host-fed DIRECT demodulator's state (int32 phase (C,), history
    pair ((f-1)*M,)) (gpu_sdr_tpu/engine/demodulator._build_direct) ->
    the port's (int64 phase, complex64 history)."""
    phase, hist = state
    return tone_phase(phase, device), complex_from_pair(hist, device)


def replay_state(state, device):
    """A ReplayDDC / ReplayDDCT state (int32 block index, int32 phase
    (C,), int32 started flag) (gpu_sdr_tpu/ops/pallas_replay.py) -> the
    port's (int, int64 phase, int)."""
    idx, phase, started = state
    return int(idx), tone_phase(phase, device), int(started)


def fold_state(state, device):
    """The fold chains' state (int32 synthesis phases (Ct,), int32 DDC
    phases (Cp,), float32 prev_valid) (gpu_sdr_tpu/ops/pallas_chain.
    TonesDirectFoldKernel, ops/fold_chain.py) -> the port's (int64,
    int64, float)."""
    sph, dph, pv = state
    return tone_phase(sph, device), tone_phase(dph, device), float(pv)


def replay_at_state(state):
    """The JAX DeviceReplay's channelizer_at / pfb_at state (int32
    started flag, int32 block index) -> the port's (block index, started
    flag), Python ints."""
    started, idx = state
    return int(np.asarray(idx)), int(np.asarray(started))


def replay_chirp_at_state(state):
    """The JAX DeviceReplay's chirp_at state (uint32 stream position,
    int32 block index) -> the port's (position, block index)."""
    last, idx = state
    return int(np.asarray(last)), int(np.asarray(idx))


def replay_chirp_table_state(state):
    """The JAX DeviceReplay's chirp_table state ((uint32 stream position,
    int32 oscillator block, C table), int32 recording block) -> the
    port's (position, oscillator block, recording block); the table is
    dropped, as chirp_state drops it: the port's chain holds its own."""
    (last, o, _table), idx = state
    return int(np.asarray(last)), int(np.asarray(o)), int(np.asarray(idx))


def replay_scan_state(state, demod_state):
    """The JAX DeviceReplay's scan state (demodulator state, int32 block
    index) -> the port's, the demodulator's state through `demod_state`,
    the converter of its mode (host_spare, ddc_state or chirp_state)."""
    st, idx = state
    return demod_state(st), int(np.asarray(idx))


def chirp_state(state):
    """A CHIRP state of the JAX package -> the port's Python ints:

    * the fused chain's (uint32 stream position, int32 period block,
      C wavetable) (gpu_sdr_tpu/engine/fused._ChirpWavetableChain)
      -> (position, block); the port's chain holds its own table;
    * the host-fed table step's (uint32 position, int32 oscillator
      block) (engine/demodulator._try_chirp_table_step) -> (position,
      block);
    * the plain step's uint32 position -> position."""
    if isinstance(state, (tuple, list)):
        if len(state) not in (2, 3):
            raise ValueError(f"CHIRP state of {len(state)} parts; expected "
                             "(last, idx[, table]) or a scalar")
        return int(np.asarray(state[0])), int(np.asarray(state[1]))
    return int(np.asarray(state))


# ---------------------------------------------------------------------
# The sharded layer (gpu_sdr_tpu/parallel): JAX keeps a sharded state as
# one global array; the port keeps a grid of per-shard parts, each on
# its shard's device (parallel/mesh.Mesh.grid).


def _scalar(a) -> int:
    """An int from a scalar or a one-element array (a uint32 (1,) `last`)."""
    return int(np.asarray(a).reshape(-1)[0])


def _carry_grid(pair, mesh, H: int):
    """A (T*H,) halo carry pair, sharded over time and replicated over
    channels -> the carry grid [t][c] of (H,) tensors."""
    carry = complex_from_pair(pair, "cpu")
    if tuple(carry.shape) != (mesh.T * H,):
        raise ValueError(f"sharded carry shape {tuple(carry.shape)}, "
                         f"expected ({mesh.T * H},)")
    return mesh.grid(lambda t, c, d: carry[t * H:(t + 1) * H].to(d))


def sharded_ddc_state(state, sd):
    """A ShardedDDC state (int32 phase (C,) over channels, the (T*H,)
    carry pair over time) (gpu_sdr_tpu/parallel/sharded.py) -> the port's
    ShardedDDC `sd`'s (phase grid, carry grid)."""
    phase, carry = state
    ph = tone_phase(phase, "cpu")
    Cl = sd.Cl
    return (sd.mesh.grid(lambda t, c, d: ph[c * Cl:(c + 1) * Cl].to(d)),
            _carry_grid(carry, sd.mesh, sd.H))


def sharded_pfb_state(carry, sp):
    """A ShardedPFB carry ((T*H,) pair) (gpu_sdr_tpu/parallel/
    sharded_pfb.py) -> the port's ShardedPFB `sp`'s carry grid."""
    return _carry_grid(carry, sp.mesh, sp.H)


def sharded_chirp_state(last) -> int:
    """A ShardedChirpLockin's uint32 (1,) `last` -> the stream position."""
    return _scalar(last)


def sharded_fused_state(state, sf):
    """A sharded fused chain's state (gpu_sdr_tpu/parallel/fused_sharded.
    py) -> the port's chain `sf`'s, by its sub-path:

    * channelizer_wavetable: (started,) -> started;
    * pfb_scan: (halo,) or (int32 TX phases (T*Ct,), halo) -> (carry
      grid,) or (phase grid, carry grid);
    * chirp_table: (uint32 last (1,), int32 block) -> block (the
      accumulator is never read, and not ported); chirp_lockin: (last,)
      -> last;
    * fold_kernel / g_chain: (sph, dph, pv) -> fold_state's, on the
      mesh's first device."""
    path = sf.path
    if path == "channelizer_wavetable":
        return _scalar(state[0])
    if path == "pfb_scan":
        halo = _carry_grid(state[-1], sf.mesh, sf.H)
        if len(state) == 1:
            return (halo,)
        ph = tone_phase(state[0], "cpu").reshape(sf.T, -1)
        return (sf.mesh.grid(lambda t, c, d: ph[t].to(d)), halo)
    if path == "chirp_table":
        return _scalar(state[1])
    if path == "chirp_lockin":
        return _scalar(state[0])
    return fold_state(state, sf.mesh.first)


def sharded_replay_state(state, sr, demod_state=None):
    """A ShardedDeviceReplay state (gpu_sdr_tpu/parallel/sharded_replay.
    py) -> the port's replay `sr`'s, by its sub-path: replay_kernel
    ((idx, int32 phase, started), idx) -> replay_state's; channelizer_at
    (started, idx) -> (idx, started); scan (demodulator state, idx) ->
    (demod_state(it), idx), `demod_state` the converter of the sharded
    demodulator's mode (e.g. lambda s: sharded_ddc_state(s, sd))."""
    if sr.path == "replay_kernel":
        return replay_state(state[0], sr.mesh.first)
    if sr.path == "channelizer_at":
        return replay_at_state(state)
    st, idx = state
    return demod_state(st), _scalar(idx)
