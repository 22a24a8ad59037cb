"""Entry points of the port, run as ``python -m neuraloperator_tpu_torch.scripts.<name>``."""
