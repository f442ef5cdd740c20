"""Channel-, time-block- and fold-parallel receive, and the multi-process
runtime: the port's counterpart of `xritdemod_tpu/parallel/`."""
