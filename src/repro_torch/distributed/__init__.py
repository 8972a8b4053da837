"""Serving and training on one device.  ``admission`` is a verbatim copy of
the JAX package's framework-free module (numpy only)."""
from .serve import Server, ServeConfig
from .async_trainer import AsyncConfig, AsyncTrainer
from .slot_serve import (SlotServer, SlotConfig, ServeResult,
                         OverloadPolicy, SHED_POLICIES)
from .admission import (AdmissionPolicy, AdmissionTrace, draw_arrivals,
                        parse_admission)

__all__ = ["Server", "ServeConfig", "AsyncConfig", "AsyncTrainer",
           "SlotServer", "SlotConfig", "ServeResult", "OverloadPolicy",
           "SHED_POLICIES",
           "AdmissionPolicy", "AdmissionTrace", "draw_arrivals",
           "parse_admission"]
