"""Probes and measurement tools of the port (run as modules: `python -m xritdemod_tpu_torch.tools.<name>`)."""
