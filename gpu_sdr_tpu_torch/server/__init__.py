"""The server layer the port needs: the native TCP ingest receiver's
loader (native.py).  The TCP control server and the streaming server of
gpu_sdr_tpu/server are not ported."""
