"""Serving artifacts: ``torch.export`` of the detect graph, and its loader."""

from .export import ServingDetector, export_detector

__all__ = ["ServingDetector", "export_detector"]
