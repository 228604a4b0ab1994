"""The client layer the port needs (a copy of part of gpu_sdr_tpu/client):

  files     <- pyUSRP/USRP_files.py     (HDF5 schema, parameter mirror,
                                         the streaming H5Sink, readers)
  triggers  <- pyUSRP/USRP_triggers.py  (client-side triggers)

The analysis modules (vna, noise, fitting, delay, ...) are ROADMAP
Queue 1 item 3b.
"""
