from .serve import Server, ServeConfig

__all__ = ["Server", "ServeConfig"]
