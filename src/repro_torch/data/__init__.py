"""Data plane: stage graphs, the analytic simulator, the process
executor with real featurization, and the host->device feed."""
