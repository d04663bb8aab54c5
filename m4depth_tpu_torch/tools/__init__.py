"""Command-line tools of the port, each run as
``python -m m4depth_tpu_torch.tools.<name>``."""
