"""The TCP protocol across the two packages, on the CPU: the port's wire
bytes and JSON commands are the JAX package's, byte for byte, and a
client of either package against a server of the other writes the file
that the JAX client writes against the JAX server (users' existing
clients depend on the protocol).  Every server binds port 0; every wait
has a deadline.
"""

import threading

import numpy as np
import pytest
import torch

from gpu_sdr_tpu import params as jparams
from gpu_sdr_tpu.client import connections as jconn
from gpu_sdr_tpu.server import wire as jwire
from gpu_sdr_tpu.server.main import Server as JServer
from gpu_sdr_tpu_torch import params as tparams
from gpu_sdr_tpu_torch.client import connections as tconn
from gpu_sdr_tpu_torch.client import h5
from gpu_sdr_tpu_torch.server import wire as twire
from gpu_sdr_tpu_torch.server.main import Server as TServer
from test_torch_files import assert_same_file

torch.set_num_threads(2)

WAIT_S = 60.0


@pytest.mark.parametrize("case", range(6))
def test_sync_packet_bytes_match_jax(case):
    """encode_sync_packet: the same bytes for every front-end code,
    shapes (flat, rows x channels), dtypes cast to complex64, counters
    up to int32's range; decode_sync_header the same dict."""
    rng = np.random.default_rng(case)
    codes = list(twire.FRONT_END_CODES.values())
    shape = [(7,), (5, 3), (1, 1000), (0,), (64, 8), (3,)][case]
    data = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    if case % 2:
        data = data.astype(np.complex64)
    args = (case, codes[case % 4], [0, 1, 7, 2**31 - 1, 12, 5][case],
            [0, 3, 0, 1, 2**31 - 1, 0][case], max(1, shape[-1]))
    tb = twire.encode_sync_packet(*args, data)
    assert tb == jwire.encode_sync_packet(*args, data)
    assert twire.decode_sync_header(tb[:twire.HEADER_SIZE]) == \
        jwire.decode_sync_header(tb[:jwire.HEADER_SIZE])


@pytest.mark.parametrize("payload", ['{"a": 1}', b'{"b": [1, 2]}', "",
                                     '{"name": "résonateur"}'])
def test_async_message_bytes_match_jax(payload):
    tb = twire.encode_async_message(payload)
    assert tb == jwire.encode_async_message(payload)
    assert twire.decode_async_header(tb[:8]) == \
        jwire.decode_async_header(tb[:8])


def test_async_header_refuses_the_same_malformed_bytes():
    bad = b"\x01\x00\x00\x00\x08\x00\x00\x00"
    assert twire.decode_async_header(bad) == \
        jwire.decode_async_header(bad) == 0
    assert twire.header_dtype == jwire.header_dtype
    assert twire.FRONT_END_CODES == jwire.FRONT_END_CODES
    assert (twire.SYNC_PORT, twire.ASYNC_PORT, twire.INGEST_PORT) == \
        (jwire.SYNC_PORT, jwire.ASYNC_PORT, jwire.INGEST_PORT)


def command(P, kind):
    cmd = P.UsrpParams()
    if kind == "DIRECT":
        freqs = [100_000, -200_000]
        cmd.A_TXRX = P.AntennaParams(
            mode=P.AntMode.TX, rate=1_000_000, buffer_len=100_000,
            samples=200_000, freq=freqs, ampl=[0.4, 0.3],
            wave_type=[P.WaveType.TONES] * 2, delay=1.0)
        cmd.A_RX2 = P.AntennaParams(
            mode=P.AntMode.RX, rate=1_000_000, buffer_len=100_000,
            samples=200_000, decim=100, pf_average=4, freq=freqs,
            wave_type=[P.WaveType.DIRECT] * 2, delay=1.0)
    else:
        freqs = [20_000, -50_000, 130_000]
        cmd.A_TXRX = P.AntennaParams(
            mode=P.AntMode.TX, rate=1_000_000, buffer_len=100_000,
            samples=200_000, freq=freqs, ampl=[0.2, 0.3, 0.1],
            wave_type=[P.WaveType.TONES] * 3)
        cmd.A_RX2 = P.AntennaParams(
            mode=P.AntMode.RX, rate=1_000_000, buffer_len=100_000,
            samples=200_000, fft_tones=100, pf_average=4, freq=freqs,
            wave_type=[P.WaveType.TONES] * 3)
    return cmd


@pytest.mark.parametrize("kind", ["DIRECT", "TONES"])
def test_json_command_matches_jax(kind):
    """to_json: the same string in both packages; from_json of either
    gives the other's parameters."""
    j, t = command(jparams, kind), command(tparams, kind)
    assert t.to_json() == j.to_json()
    assert tparams.UsrpParams.from_json(j.to_json()) == t
    assert jparams.UsrpParams.from_json(t.to_json()) == j


def measure_over_tcp(server, conn_mod, P, kind, path):
    """One measurement: `server` serving once, a `conn_mod` Connection
    sending `kind`'s command and writing the packets to `path`."""
    server.start()
    th = threading.Thread(target=lambda: server.serve_one(timeout=WAIT_S),
                          daemon=True)
    th.start()
    try:
        conn = conn_mod.Connection(host="127.0.0.1",
                                   async_port=server.ports[0],
                                   sync_port=server.ports[1])
        try:
            cmd = command(P, kind)
            conn.send_params(cmd)
            fn = conn_mod.Packets_to_file(conn, cmd, filename=str(path),
                                          progress=False, timeout=WAIT_S)
        finally:
            conn.close()
        th.join(timeout=WAIT_S)
        assert not th.is_alive()
    finally:
        server.close()
    return fn


def data_of(fn):
    with h5.File(fn, "r") as f:
        return f["raw_data0"]["A_RX2"]["data"][()]


@pytest.mark.parametrize("kind", ["DIRECT", "TONES"])
def test_cross_client_and_server_write_jaxs_file(tmp_path, kind):
    """A JAX Connection against the port's Server(device="cpu"), and the
    port's Connection against JAX's Server, each write the file of JAX
    against JAX: the same groups, attributes, dataset properties; the
    data bit for bit where JAX's server computed it, >= 90 dB where the
    port's did."""
    def jserver():
        return JServer(async_port=0, data_port=0, host="127.0.0.1")

    def tserver():
        return TServer(async_port=0, data_port=0, host="127.0.0.1",
                       device="cpu")
    ref = measure_over_tcp(jserver(), jconn, jparams, kind,
                           tmp_path / "jax_jax")
    j_on_t = measure_over_tcp(tserver(), jconn, jparams, kind,
                              tmp_path / "jax_client_port_server")
    t_on_j = measure_over_tcp(jserver(), tconn, tparams, kind,
                              tmp_path / "port_client_jax_server")
    assert_same_file(ref, j_on_t)
    assert_same_file(ref, t_on_j)
    assert np.array_equal(data_of(ref), data_of(t_on_j))
    # 200,000 samples at decim 100 (DIRECT) or 100 bins (TONES)
    assert data_of(ref).shape == (len(command(tparams, kind).A_RX2.freq),
                                  2000)
