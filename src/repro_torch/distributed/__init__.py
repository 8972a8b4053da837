from .serve import Server, ServeConfig
from .async_trainer import AsyncConfig, AsyncTrainer

__all__ = ["Server", "ServeConfig", "AsyncConfig", "AsyncTrainer"]
