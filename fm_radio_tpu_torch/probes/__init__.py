"""Probes of the port's kernels on the card (run as modules, ``python -m
fm_radio_tpu_torch.probes.<name>``; nothing runs at import)."""
