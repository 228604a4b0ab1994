"""The measurement workflows users run, on the port: one module per
script of the JAX package's ``scripts/`` folder, with its file name,
its flags and defaults and its printed lines, run as

    python -m gpu_sdr_tpu_torch.scripts.get_VNA --device cuda ...

or by file path.  Each also takes ``--device`` (``cuda`` by default,
``cpu`` or ``cuda:N``), passed to every measurement and analysis call,
and each that plots takes ``--backend {matplotlib,html}``.  None
imports jax, the JAX package, h5py or matplotlib at import."""
