"""Command-line tools of the port (`python -m mxnet_tpu_torch.tools.<name>`)."""
