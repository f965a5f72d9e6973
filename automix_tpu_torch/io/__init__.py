"""Reference-format I/O of the port: ``_mix.data``, reports, checkpoints."""
