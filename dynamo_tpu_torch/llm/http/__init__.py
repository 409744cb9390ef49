from .service import HttpService, ModelManager

__all__ = ["HttpService", "ModelManager"]
