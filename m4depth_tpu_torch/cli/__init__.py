"""Command line of the port: ``python -m m4depth_tpu_torch.cli.main``."""
