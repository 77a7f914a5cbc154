"""Command-line entry points of the port (`python -m
tpu_diffusion_torch.cli.main`)."""
