"""Plugin files for `python -m maua_tpu_torch.pipeline.cli --audioreactive_file ...`,
written in torch against maua_tpu_torch.audio and maua_tpu_torch.reactive."""
