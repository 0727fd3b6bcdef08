from repro_torch.models.api import SHAPES, Model, ShapeSpec, build_model

__all__ = ["Model", "SHAPES", "ShapeSpec", "build_model"]
