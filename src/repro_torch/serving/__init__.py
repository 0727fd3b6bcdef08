from repro_torch.serving.decode_pool import DecodePool, ServeLaneState, ServeStats

__all__ = ["DecodePool", "ServeLaneState", "ServeStats"]
