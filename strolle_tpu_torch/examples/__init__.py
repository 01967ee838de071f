"""The examples, on the port: each runs as
``python -m strolle_tpu_torch.examples.<name>`` (``--cpu`` for the CPU)
and has ``main(argv=None)``. Output goes under ``out/<name>/``."""
