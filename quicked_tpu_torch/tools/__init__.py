"""Command-line tools of the port: align_benchmark, generate_dataset and
quicked_harness, each run as `python -m quicked_tpu_torch.tools.<name>`."""
