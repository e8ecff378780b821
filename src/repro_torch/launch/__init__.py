"""Entry points: `python -m repro_torch.launch.train_dlrm_criteo`."""
