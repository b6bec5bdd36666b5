from .synthetic import TokenPipeline, batch_shapes, input_specs, make_batch

__all__ = ["TokenPipeline", "batch_shapes", "input_specs", "make_batch"]
