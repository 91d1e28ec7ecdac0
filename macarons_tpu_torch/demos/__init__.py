"""macarons_tpu_torch.demos: the exploration demo, the SCONE object demo
and the interactive browser demo, each run as
``python -m macarons_tpu_torch.demos.<name>``."""
