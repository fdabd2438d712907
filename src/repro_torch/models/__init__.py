"""Model zoo of the port: the dense, MoE and VLM decoder families (with the
int8 KV cache as an option), the Zamba2 hybrid, the xLSTM stack and the
encoder-decoder, with their serving entry points and training losses.  ``build(cfg)`` returns
the family's ``ModelApi`` for every registered architecture."""

from repro_torch.models.model_zoo import ModelApi, build, extend_cache

__all__ = ["ModelApi", "build", "extend_cache"]
