"""The benchmark of qasr_ijcnlp_tpu_torch (see README.md and run.py)."""
