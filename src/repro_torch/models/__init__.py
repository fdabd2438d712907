"""Model zoo of the port: the dense, MoE and VLM decoder families (with the
int8 KV cache as an option) and the xLSTM stack, with their serving entry
points.  ``build(cfg)`` returns the family's ``ModelApi``; the hybrid and
encoder-decoder families wait for ROADMAP Queue 1 items 9.4 and 9.6."""

from repro_torch.models.model_zoo import ModelApi, build, extend_cache

__all__ = ["ModelApi", "build", "extend_cache"]
