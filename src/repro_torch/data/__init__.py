from .synthetic import TokenPipeline, batch_shapes, make_batch

__all__ = ["TokenPipeline", "batch_shapes", "make_batch"]
