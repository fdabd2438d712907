"""Model zoo of the port: the dense GQA decoder family (internlm2 and the
other dense configs) with its serving entry points.  ``build(cfg)`` returns
the family's ``ModelApi``; the other families wait for ROADMAP Queue 1
item 9."""

from repro_torch.models.model_zoo import ModelApi, build, extend_cache

__all__ = ["ModelApi", "build", "extend_cache"]
