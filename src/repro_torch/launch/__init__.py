"""Entry points: `python -m repro_torch.launch.train_dlrm_criteo` (the
closed loop) and `python -m repro_torch.launch.train` (the generic
driver)."""
