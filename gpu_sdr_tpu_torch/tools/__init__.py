"""The port's user tools (its copies of tools/read_filter_window.py,
read_server_log.py, make_test_recording.py and science_producer.py) and
the reference-scale evidence runs: ``array_loop`` (the 50-resonator
closed loop) and ``phase_coherence`` (long-stream phase coherence of
the TONES->DIRECT chain and of the periodic-comb replay kernel).  Each
runs as ``python -m gpu_sdr_tpu_torch.tools.<name>`` or by file path
and imports nothing of jax, the JAX package or h5py."""
