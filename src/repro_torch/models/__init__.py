"""Model zoo of the port: the dense, MoE and VLM decoder families (with the
int8 KV cache as an option), the Zamba2 hybrid, the xLSTM stack and the
encoder-decoder, with their serving entry points and training losses.  ``build(cfg)`` returns
the family's ``ModelApi`` for every registered architecture."""

from repro_torch.models.model_zoo import ModelApi, TensorSpec, build, extend_cache, model_flops

__all__ = ["ModelApi", "TensorSpec", "build", "extend_cache", "model_flops"]
