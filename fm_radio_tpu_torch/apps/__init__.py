"""User entry points (``python -m fm_radio_tpu_torch.apps.cli``)."""
