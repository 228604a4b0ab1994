"""The client layer (a copy of gpu_sdr_tpu/client, on the port's engine,
params and HDF5 module), the pyUSRP-equivalent surface:

  h5            (HDF5 in numpy: the port needs no h5py)
  files         <- pyUSRP/USRP_files.py      (HDF5 schema, parameter
                                              mirror, the streaming
                                              H5Sink, readers)
  vna           <- pyUSRP/USRP_VNA.py        (S21 sweeps + analysis)
  noise         <- pyUSRP/USRP_noise.py      (multi-tone noise + PSD, on
                                              the device or with scipy)
  fitting       <- pyUSRP/USRP_fitting.py    (resonator fits)
  delay         <- pyUSRP/USRP_delay.py      (line-delay calibration)
  full_spec     <- pyUSRP/USRP_full_spec.py  (raw and full-PFB captures)
  triggers      <- pyUSRP/USRP_triggers.py   (client-side triggers)
  data_analysis <- pyUSRP/USRP_data_analysis.py
  connections   <- pyUSRP/USRP_connections.py (the TCP client: command
                                              and data sockets,
                                              Packets_to_file)
  plotting      <- pyUSRP/USRP_plotting.py   (and the plot functions of
                                              the other modules;
                                              matplotlib imported when a
                                              plot draws)
  htmlplot      (the interactive HTML backend)

The facade over all of it is gpu_sdr_tpu_torch/pyusrp.py.
"""
