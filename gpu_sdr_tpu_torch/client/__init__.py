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

The TCP client (connections), the plotting and the pyusrp facade are
ROADMAP Queue 1 item 3b step 3.
"""
